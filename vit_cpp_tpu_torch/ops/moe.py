"""Mixture-of-experts MLP (V-MoE): routed expert MLPs as batched products.

Counterpart of vit_cpp_tpu/ops/moe.py, with the same semantics:

- the router runs in true f32 (TF32 off): its top-k decisions are
  argmax-fragile and the product is tiny, (T, h) x (h, E);
- the top-k is a stable descending sort plus a gather, so ties go to the
  lower expert index as in `jax.lax.top_k` (ops/tome.py relies on the same
  rule; `torch.topk` promises no order); the gates are the softmax over
  the k selected logits;
- capacity is static: C = ceil(k*T*capacity/E) rounded up to 8, capped at
  k*T. Assignments claim capacity in slot-major, token order (GShard:
  every token's first choice before any token's second choice); the ones
  that overflow are dropped and add nothing, so the caller's residual
  passes the token through;
- positions inside an expert are an exclusive integer cumsum over the
  slot-major one-hot, equal to the JAX package's triangular product;
- dispatch and combine are k-summed (B, T, E*C) 0/1 matrices in the
  activation dtype, one batched product each way; the expert MLPs are
  batched over E (`torch.bmm` over (E, B*C, h)); empty capacity slots
  compute bias garbage that the combine zeroes.

Expert parallelism (`mesh=`): under the dp x tp layout a data group's
tokens are already replicated over "model", so no all-to-all is needed.
The router runs replicated; each model rank runs its E/tp experts (its
slice of dimension 0 of the layer's (E, ...) kernels) on the tokens
dispatched to them, combines only those, and the combine is all-reduced
over "model": the unsharded result up to summation order. In training
the dispatched tokens and the gates enter the region through
`copy_to_model`, so their gradients sum over the ranks' experts.

Routing groups are per image. No kernel is written for the layer: the JAX
package's is XLA einsums too. `route` exposes the integer routing (expert
index, position, keep, destination slot) that `moe_mlp` applies.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from vit_cpp_tpu_torch.ops.precision import highest_product
from vit_cpp_tpu_torch.parallel.mesh import (
    axis_rank,
    copy_to_model,
    mean_over_data,
    reduce_from_model,
)
from vit_cpp_tpu_torch.quant.int8 import Int8Linear
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear


def moe_capacity(n_tokens: int, num_experts: int, top_k: int, factor: float) -> int:
    """Static per-image expert capacity: ceil(k*T*factor/E), rounded up to
    a multiple of 8, capped at k*T (a larger buffer could never fill)."""
    c = math.ceil(top_k * n_tokens * factor / num_experts)
    c = -(-c // 8) * 8
    return min(c, top_k * n_tokens)


class Routing(NamedTuple):
    """One MoE layer's routing of a (B, T, h) input.

    logits (B, T, E) f32; idx (B, T, k) experts in descending logit order;
    gates (B, T, k) f32; and in slot-major order (B, k*T): posn, the
    position inside the chosen expert, keep (posn < cap) and dest
    (idx * cap + posn, the flat expert slot)."""

    logits: torch.Tensor
    idx: torch.Tensor
    gates: torch.Tensor
    posn: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    cap: int


def route(y: torch.Tensor, router: torch.Tensor, hp) -> Routing:
    """Top-k routing of `y` (B, T, h) by the (h, E) router kernel."""
    b, t, _ = y.shape
    e, k = hp.num_experts, hp.moe_top_k
    cap = moe_capacity(t, e, k, hp.moe_capacity)
    logits = highest_product(y.float(), router.float())
    idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]
    gates = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
    idx_sm = idx.transpose(1, 2).reshape(b, k * t)
    oh = F.one_hot(idx_sm, e)  # (B, kT, E) int64
    posn = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(dim=-1)
    keep = posn < cap
    return Routing(logits, idx, gates, posn, keep, idx_sm * cap + posn, cap)


def moe_mlp(
    y: torch.Tensor,
    mp: Dict[str, Any],
    hp,
    act: Callable[[torch.Tensor], torch.Tensor],
    mesh=None,
    aux: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One MoE MLP layer. `y` is the LN'd block input (B, T, h); `mp` one
    layer's parameters: router.kernel (h, E), fc1.kernel (E, h, m),
    fc1.bias (E, m), fc2.kernel (E, m, h), fc2.bias (E, h).

    Returns (out (B, T, h), aux): out is the gate-weighted sum of the
    selected experts' outputs (zero for dropped assignments); aux holds f32
    diagnostics: load_balance (the Switch balance loss E * sum_e f_e P_e
    over top-1 fractions f and mean router probabilities P; 1 when
    balanced), router_z (the mean squared logsumexp of the logits) and
    dropped_frac (the share of assignments over capacity). Under a mesh
    `mp` holds this rank's experts when their count is below E, and y is
    this rank's rows of the batch: the two batch means of load_balance
    are averaged over "data" before their product (mean_over_data), so
    that the term is the global batch's, as JAX's is on a sharded batch;
    router_z and dropped_frac stay this rank's means, which the ranks'
    shares of the loss average. `aux=False` (serving) returns an empty
    dict and runs no collective for it."""
    b, t, h = y.shape
    e, k = hp.num_experts, hp.moe_top_k
    r = route(y, mp["router"]["kernel"], hp)
    ec = e * r.cap
    el = mp["fc1"]["kernel"].shape[0]  # experts on this rank
    gates, ye, first = r.gates, y, 0
    if el != e:  # sharded experts (replicated when tp does not divide E)
        gates, ye = copy_to_model(gates, mesh), copy_to_model(y, mesh)
        first = axis_rank(mesh, "model") * el * r.cap  # this rank's experts' slots
    cols = slice(first, first + el * r.cap)

    # k-summed dispatch: a dropped assignment's dest can point into the
    # next expert's slots (or past E*C), so it is sent one past the last
    # slot and that column cut off
    slot = torch.where(r.keep, r.dest, ec)
    disp4 = F.one_hot(slot, ec + 1)[..., :ec].to(y.dtype).reshape(b, k, t, ec)[..., cols]
    xe = torch.matmul(disp4.sum(dim=1).transpose(1, 2), ye)  # (B, El*C, h)

    def experts(x, lin):  # rounded, then the bias added: ops/core.py::linear's order
        return torch.bmm(x, lin["kernel"].to(x.dtype)) + lin["bias"].to(x.dtype)[:, None, :]

    xe = xe.reshape(b, el, r.cap, h).transpose(0, 1).reshape(el, b * r.cap, h)
    f2 = experts(act(experts(xe, mp["fc1"])), mp["fc2"])  # (El, B*C, h)
    f2 = f2.reshape(el, b, r.cap, h).transpose(0, 1).reshape(b, el * r.cap, h)

    gates_sm = gates.transpose(1, 2).reshape(b, k, t)
    comb = (disp4 * gates_sm[..., None].to(y.dtype)).sum(dim=1)  # (B, T, El*C)
    out = torch.matmul(comb, f2)
    if el != e:
        out = reduce_from_model(out, mesh)

    if not aux:
        return out, {}
    f_top1 = mean_over_data(F.one_hot(r.idx[..., 0], e).float().mean(dim=(0, 1)), mesh)
    p_mean = mean_over_data(torch.softmax(r.logits, dim=-1).mean(dim=(0, 1)), mesh)
    return out, {
        "load_balance": e * (f_top1 * p_mean).sum(),
        "router_z": (torch.logsumexp(r.logits, dim=-1) ** 2).mean(),
        "dropped_frac": 1.0 - r.keep.float().mean(),
    }


def _subtrees(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _subtrees(v)
    else:
        yield tree


def upcycle_params(
    params: Dict[str, Any],
    hp,
    num_experts: int,
    moe_layers: Tuple[int, ...],
    seed: int = 0,
    router_std: float = 1e-3,
) -> Dict[str, Any]:
    """Sparse upcycling (Komatsuzaki et al., ICLR 2023): a dense tree ->
    an MoE tree whose MoE layers replicate their fc1/fc2 into
    `num_experts` identical experts behind a near-zero router
    (router_std * normal, drawn from a torch.Generator seeded with
    `seed`; JAX's PRNG stream is not reproduced). With renormalized top-k
    gates the upcycled model computes the dense function whenever
    capacity drops nothing. blocks.fc1/fc2 are restacked over the
    remaining dense layers; a "moe" subtree is stacked over `moe_layers`
    (in ascending order)."""
    for leaf in _subtrees(params["blocks"]):
        if isinstance(leaf, (QuantLinear, Int8Linear)):
            raise ValueError(
                "upcycling needs dense kernels — load the checkpoint "
                "unquantized (f16/f32) to fine-tune into an MoE"
            )
    n_layers = hp.num_hidden_layers
    bad = [l for l in moe_layers if not 0 <= l < n_layers]
    if bad:
        raise ValueError(f"moe layers {bad} out of range [0, {n_layers})")
    if len(set(moe_layers)) != len(moe_layers):
        raise ValueError(f"duplicate moe layers: {moe_layers}")
    if len(moe_layers) >= n_layers:
        raise ValueError(
            "at least one dense-MLP layer is required (every-layer MoE "
            "is not a V-MoE configuration)"
        )
    moe_order = sorted(moe_layers)
    dense_layers = [l for l in range(n_layers) if l not in set(moe_layers)]
    blocks = dict(params["blocks"])
    device = params["pos_embed"].device

    def rows(node, layers, experts=0):
        if isinstance(node, dict):
            return {key: rows(v, layers, experts) for key, v in node.items()}
        sel = node[torch.tensor(layers, dtype=torch.long, device=node.device)]
        if not experts:
            return sel
        # (Lm, in, out) -> (Lm, E, in, out): identical experts at init
        return sel[:, None].expand(sel.shape[0], experts, *sel.shape[1:]).clone()

    gen = torch.Generator().manual_seed(seed)
    router = router_std * torch.randn(
        (len(moe_order), hp.hidden_size, num_experts), generator=gen, dtype=torch.float32
    )
    moe = {
        "router": {"kernel": router.to(device)},
        "fc1": rows(blocks["fc1"], moe_order, num_experts),
        "fc2": rows(blocks["fc2"], moe_order, num_experts),
    }
    blocks["fc1"] = rows(blocks["fc1"], dense_layers)
    blocks["fc2"] = rows(blocks["fc2"], dense_layers)
    out = dict(params)
    out["blocks"] = blocks
    out["moe"] = moe
    return out
