"""ToMe token merging: between the attention and MLP halves of every
block, merge the r most similar patch-token pairs, so layer l runs on
about T - l*r tokens.

Counterpart of vit_cpp_tpu/ops/tome.py (Bolya et al., "Token Merging:
Your ViT But Faster", ICLR 2023), with the same numerics:

- the merge is size-weighted and expressed as one merge MATRIX M of
  shape (B, T-r, T): x' = M @ x is one batched product (M cast to the
  activation dtype, f32 accumulation), and M's row layout is
  [prefix identity | kept A tokens (original order) | size-weighted B
  rows];
- the matching (bipartite soft matching: A = even patch tokens, B = odd
  ones; each A token picks its most similar B token by cosine similarity
  and the r most similar A tokens merge into their picks) runs on
  detached `metric` and `sizes`, as the JAX package's stop_gradient and
  the official implementation's no_grad: gradients flow through the
  product's x only;
- every prefix token (CLS, distillation token, registers) is protected:
  never merged, never a merge target.

Ties break as in JAX: `jax.lax.top_k` puts the lower index first among
equal values, so the r sources are the first r of a stable descending
sort (`torch.topk` promises no tie order); argmax takes the first
maximum in both. The similarity products run with TF32 off, so the card
matches on the same f32 scores as the CPU up to summation order.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from vit_cpp_tpu_torch.ops.precision import highest_product


def tome_schedule(n_patches: int, num_layers: int, r: int) -> List[int]:
    """Per-layer merge counts: layer l merges min(r, remaining // 2)
    pairs (the official implementation's clamp: at most half the
    remaining patch tokens per layer, so at least one patch survives)."""
    if r < 1:
        raise ValueError(f"tome r must be >= 1, got {r}")
    rs = []
    t = n_patches
    for _ in range(num_layers):
        rl = min(r, t // 2)
        rs.append(rl)
        t -= rl
    return rs


def bipartite_match(
    metric: torch.Tensor, r: int, n_prefix: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The matching of one merge: (node_max (B, Ta) f32, each A token's
    best cosine score; node_idx (B, Ta), its best B partner; src (B, r),
    the A tokens that merge, most similar first). Indices count within
    the A and B sets of the patch tokens."""
    m = metric.detach()[:, n_prefix:].float()
    m = m / torch.clamp(torch.linalg.vector_norm(m, dim=-1, keepdim=True), min=1e-6)
    scores = highest_product(m[:, 0::2], m[:, 1::2], "bad,bcd->bac")  # (B, Ta, Tb)
    node_max = scores.amax(dim=-1)
    node_idx = scores.argmax(dim=-1)
    src = torch.sort(node_max, dim=-1, descending=True, stable=True).indices[:, :r]
    return node_max, node_idx, src


def _merge_matrix(
    metric: torch.Tensor, sizes: torch.Tensor, r: int, n_prefix: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched bipartite soft matching as a merge matrix: (M, sizes'),
    M (B, T-r, T) f32 row-normalized merge weights, sizes' = S @ sizes
    the new per-token counts, S the 0/1 structure of M."""
    bsz, t = sizes.shape
    tp = t - n_prefix
    ta, tb = (tp + 1) // 2, tp // 2
    sizes = sizes.detach()
    dev = sizes.device
    _, node_idx, src = bipartite_match(metric, r, n_prefix)
    merged = torch.zeros((bsz, ta), dtype=torch.float32, device=dev).scatter_(1, src, 1.0)

    # the unmerged A tokens in their original relative order
    ar = torch.arange(ta, device=dev)
    order = torch.argsort(torch.where(merged > 0, ta + ar, ar), dim=-1, stable=True)
    keep = order[:, : ta - r]  # (B, Ta - r)

    def one_hot(idx, n):
        return F.one_hot(idx, n).to(torch.float32)

    # the original column of A_i is n_prefix + 2i, of B_j n_prefix + 2j + 1
    rows_prefix = one_hot(torch.arange(n_prefix, device=dev), t)[None].expand(bsz, n_prefix, t)
    rows_keep = one_hot(n_prefix + 2 * keep, t)
    assign = one_hot(node_idx, tb) * merged[..., None]  # (B, Ta, Tb), sources only
    e_a = one_hot(n_prefix + 2 * ar, t)  # (Ta, T) source -> column
    scatter = torch.einsum("xab,at->xbt", assign, e_a)  # (B, Tb, T), exact 0/1 sums
    rows_b = one_hot(n_prefix + 2 * torch.arange(tb, device=dev) + 1, t)[None] + scatter
    s_mat = torch.cat([rows_prefix, rows_keep, rows_b], dim=1)

    sizes_new = torch.einsum("bqt,bt->bq", s_mat, sizes)  # sums of integer counts: exact
    return s_mat * sizes[:, None, :] / sizes_new[..., None], sizes_new


def tome_merge(
    x: torch.Tensor, metric: torch.Tensor, sizes: torch.Tensor, r: int, n_prefix: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the r most similar patch-token pairs of every batch element.

    x: (B, T, h) tokens, metric: (B, T, d) similarity features, sizes:
    (B, T) f32 merged-token counts. The first `n_prefix` tokens are
    protected. Returns (x', sizes') with T - r tokens."""
    if r == 0:
        return x, sizes
    tp = x.shape[1] - n_prefix
    if r > tp // 2:
        raise ValueError(
            f"tome r={r} exceeds the {tp} patch tokens' smaller "
            "bipartite set"
        )
    mm, sizes_new = _merge_matrix(metric, sizes, r, n_prefix)
    # the one op on the activations: M cast to the activation dtype (the
    # 0/1 weights of the prefix and kept rows stay exact), f32 accumulation
    return torch.matmul(mm.to(x.dtype), x), sizes_new
