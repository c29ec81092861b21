"""The ViT forward pass over a parameter tree of torch tensors.

Counterpart of vit_cpp_tpu/models/vit.py, with the same numerics:

- patch embedding is a reshape + one (c*p*p, h) matmul, not a conv;
- per block: LN -> fused QKV matmul -> attention -> proj -> residual;
  LN -> fc1 -> GELU -> fc2 -> residual;
- head: the CLS token (or the mean of the patch tokens for avg-pool
  models; the mean of two heads for DeiT-distilled ones; the first
  seq_len tokens for ViTSTR's sequence head) -> LN -> linear; SigLIP's
  attention pooling norms every token first, then a learned probe
  cross-attends over them (`attention_pool`); `features=True` stops
  before the linear (the embedding readout).

A Python loop over the L stacked blocks takes the place of `lax.scan`;
each stacked leaf is taken apart once per forward (`torch.unbind`), so
the backward of a training step writes each leaf's gradient once instead
of a full (L, ...) zero tensor per layer (the JAX package unrolls the
scan for the same reason). `attn_impl` keeps the JAX flag values:
"pallas" / "pallas-fast" run the fused-QKV attention kernel
(ops/flash_attention.py), "pallas-train" the differentiable fused
attention of the training path (safe-softmax kernel forward, the
backward kernel backward), "xla" the composed split-head attention.
`mm_impl` goes to every linear of the blocks and the head: "pallas" runs
block-quantized (QuantLinear) weights through the dequantizing-matmul
kernel (ops/qmatmul.py); "qat" fake-quantizes the inputs of dense ones
(quant/qat.py; the attention pooling stays float, and a V-MoE tree
refuses it); other dense and Int8Linear weights ignore it.

`pad_tokens=True` pads the token axis to a multiple of 8 after the
embedding; the attention kernel's key mask (`kv`, the real token count)
keeps the pad rows out of every softmax and the readouts skip them.
`tome=r` merges r patch-token pairs per layer (ops/tome.py) between the
attention and MLP halves of each block (`tome_block`): attention is
proportional to the merged-token counts `sizes` on every attention path,
and the readouts weight by them. A V-MoE tree (a "moe" subtree,
models/params.py) runs `moe_block`, routed expert MLPs (ops/moe.py), in
its MoE layers and `transformer_block` in the others; `moe_aux=True`
also returns the router diagnostics averaged over the MoE layers.

`mesh` (a ('data', 'model') DeviceMesh, parallel/mesh.py) runs the tree
that parallel/sharding.py::shard_params placed on this rank: the caller
gives this rank's batch rows, and tensor parallelism follows the Megatron
pattern with explicit collectives. Column-parallel linears (qkv, fc1, the
head) run on their output shard behind `copy_to_model` (identity forward,
all-reduce backward); row-parallel ones (proj, fc2) on their input shard,
their f32 partial products all-reduced over "model" (`reduce_from_model`,
identity backward) and rounded once before their bias is added once;
W8A8 reduces its int32 accumulator and quantizes against the global
per-token absmax; the dequantizing kernel (`mm_impl="pallas"`) writes
its f32 partials by its f32-output instantiation.
The attention kernels get the rank's nh/tp heads from a (B, T, 3h/tp)
qkv, the head's logits are all-gathered over "model", ToMe's key sum
over heads is all-reduced before the merge, and a V-MoE layer runs the
rank's E/tp experts and all-reduces their combine. Each linear reads
from its kernel's shape whether it was sharded, so a leaf that
shard_params replicated runs whole.

`remat` takes the JAX package's values and meaning. While autograd
records, each block (of all three layer loops) runs under a non-reentrant
torch.utils.checkpoint with a selective policy, and the backward
recomputes what the policy does not save: `True` saves nothing, "dots"
the outputs of the products without batch dimensions (aten.mm /
aten.addmm, JAX's dots_with_no_batch_dims_saveable; every bmm, as the
composed attention's, ToMe's merge and V-MoE's dispatch, experts and
combine, runs again), "dots+attn" also the fused attention's output (the
attention_qkv operator, JAX's "attn_out") and QAT's quantize-dequantized
GEMM inputs (the act_q operator, "act_q"); in the ToMe and V-MoE loops
only on the "pallas-train" path, as in JAX. Every policy saves the mesh's
collectives, so the backward issues none of them again. Without autograd
(serving, export, no_grad) the blocks run as they are.

`forward_debug` runs the same layers eagerly and keeps each stage's
output (embed, every block, the pooled readout, logits, probabilities)
for stage-by-stage comparison; `print_t` prints one in the reference's
print_t_f32 format.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.ops.core import attention, gelu_tanh, layernorm, linear, mlp_act
from vit_cpp_tpu_torch.ops.flash_attention import attention_qkv, attention_qkv_train
from vit_cpp_tpu_torch.ops.moe import moe_mlp
from vit_cpp_tpu_torch.ops.precision import highest_product
from vit_cpp_tpu_torch.ops.tome import tome_merge, tome_schedule
from vit_cpp_tpu_torch.parallel.mesh import (
    axis_rank,
    axis_size,
    copy_to_model,
    gather_from_model,
    sum_over,
)
from vit_cpp_tpu_torch.quant.qat import act_q_saved

ATTN_IMPLS = ("xla", "pallas", "pallas-fast", "pallas-train")
REMAT_MODES = (False, True, "dots", "dots+attn")

_OPS = torch.ops.vit_cpp_tpu_torch
_DOTS = frozenset({torch.ops.aten.mm, torch.ops.aten.addmm})
_NAMED = frozenset({_OPS.attention_qkv, _OPS.act_q})  # "attn_out", "act_q"
_COLLECTIVES = frozenset({_OPS.all_reduce_over, _OPS.all_gather_over})


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, n_patches, C*p*p), row-major over the patch grid
    with [c, py, px] feature order (the flattened conv weight's order)."""
    b, c, hh, ww = images.shape
    gh, gw = hh // patch, ww // patch
    x = images.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # (B, gh, gw, c, p, p)
    return x.reshape(b, gh * gw, c * patch * patch)


def embed(params: Dict[str, Any], images: torch.Tensor, hp: VitHParams) -> torch.Tensor:
    """Patch-embed + prefix token(s) + positional embeddings -> (B, T, h)."""
    dtype = params["patch_embed"]["kernel"].dtype
    patches = patchify(images.to(dtype), hp.patch_size)
    x = linear(patches, params["patch_embed"]["kernel"], params["patch_embed"]["bias"])
    b, h = x.shape[0], hp.hidden_size
    prefix = [
        params[k].to(dtype).expand(b, 1, h)
        for k in ("cls_token", "dist_token")
        if k in params
    ]
    if "reg_token" in params:
        reg = params["reg_token"].to(dtype)
        prefix.append(reg[None].expand(b, reg.shape[0], h))
    pos = params["pos_embed"].to(dtype)[None]
    if hp.no_embed_class:
        x = torch.cat(prefix + [x + pos], dim=1)
    else:
        x = torch.cat(prefix + [x], dim=1) + pos
    if "norm_pre" in params:
        x = layernorm(x, params["norm_pre"]["scale"], params["norm_pre"]["bias"], hp.eps)
    return x


def _linear(x: torch.Tensor, leaf: Dict[str, Any], mm_impl: str) -> torch.Tensor:
    """A block or head linear: its kernel and bias, and the static
    activation scale that quantization-aware training attaches beside
    them (quant/qat.py::inject_act_scales)."""
    return linear(x, leaf["kernel"], leaf["bias"], impl=mm_impl, act_scale=leaf.get("act_scale"))


def _shape(kernel) -> Tuple[int, int]:
    """(in, out) of one layer's dense, QuantLinear or Int8Linear kernel."""
    return tuple(kernel.codes.shape[-2:] if hasattr(kernel, "codes") else kernel.shape[-2:])


def _col_linear(x, leaf, mm_impl: str, mesh, full_out: int, gather: bool = False):
    """A column-parallel linear on replicated x: this rank's output
    columns, all-gathered over "model" when `gather` (the head)."""
    if axis_size(mesh, "model") == 1 or _shape(leaf["kernel"])[1] == full_out:
        return _linear(x, leaf, mm_impl)
    y = _linear(copy_to_model(x, mesh), leaf, mm_impl)
    return gather_from_model(y, mesh) if gather else y


def _row_linear(x, leaf, mm_impl: str, mesh, full_in: int):
    """A row-parallel linear: this rank's input rows, the partial products
    summed over "model" (ops/core.py::linear), then the bias once. x is
    this rank's input shard, or whole when the column-parallel linear
    before it was replicated; a replicated kernel gathers a sharded x
    instead. On a mesh whose "model" axis is 1 the product takes the same
    path: its f32 partial, summed over one rank, is rounded once, as the
    unsharded product is (bit-equal for W8A8 and the dequantizing kernel,
    whose bf16 body rounds the same f32 accumulators)."""
    if mesh is None:
        return _linear(x, leaf, mm_impl)
    kernel, k_in = leaf["kernel"], _shape(leaf["kernel"])[0]
    if k_in == full_in and axis_size(mesh, "model") > 1:
        if x.shape[-1] != full_in:
            x = gather_from_model(x, mesh)
        return _linear(x, leaf, mm_impl)
    if x.shape[-1] != k_in:
        x = copy_to_model(x, mesh).narrow(-1, axis_rank(mesh, "model") * k_in, k_in)
    y = linear(x, kernel, None, impl=mm_impl, act_scale=leaf.get("act_scale"), mesh=mesh)
    return y + leaf["bias"].to(y.dtype)


def _attn_half(
    x: torch.Tensor, bp: Dict[str, Any], hp: VitHParams, *, attn_impl: str, mm_impl: str,
    tap=None, kv: Optional[int] = None, sizes: Optional[torch.Tensor] = None, mesh=None,
):
    """LN1 -> QKV -> attention -> proj -> residual; returns (x', qkv).
    `kv` is the real token count of a padded input (the fused kernel's
    key mask), `sizes` (B, T) f32 ToMe's merged-token counts. Under a
    mesh qkv holds this rank's heads."""
    b, t, _ = x.shape
    hd = hp.head_dim
    y = layernorm(x, bp["ln1"]["scale"], bp["ln1"]["bias"], hp.eps)
    if tap is not None:
        tap("qkv_in", y)
    qkv = _col_linear(y, bp["qkv"], mm_impl, mesh, 3 * hp.hidden_size)
    h = qkv.shape[-1] // 3
    nh = h // hd
    if attn_impl in ("pallas", "pallas-fast"):
        o = attention_qkv(qkv, nh, fast=attn_impl == "pallas-fast", kv=kv, sizes=sizes)
    elif attn_impl == "pallas-train":
        o = attention_qkv_train(qkv, nh, sizes)
    elif attn_impl == "xla":
        q, k, v = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        o = attention(q, k, v, sizes=sizes).permute(0, 2, 1, 3).reshape(b, t, h)
    else:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    if tap is not None:
        tap("proj_in", o)
    return x + _row_linear(o, bp["proj"], mm_impl, mesh, hp.hidden_size), qkv


def _mlp_half(
    x: torch.Tensor, bp: Dict[str, Any], hp: VitHParams, *, mm_impl: str, tap=None, mesh=None
) -> torch.Tensor:
    """LN2 -> fc1 -> activation -> fc2 -> residual."""
    y = layernorm(x, bp["ln2"]["scale"], bp["ln2"]["bias"], hp.eps)
    if tap is not None:
        tap("fc1_in", y)
    y = _col_linear(y, bp["fc1"], mm_impl, mesh, hp.mlp_dim)
    y = mlp_act(hp.hidden_act)(y)
    if tap is not None:
        tap("fc2_in", y)
    y = _row_linear(y, bp["fc2"], mm_impl, mesh, hp.mlp_dim)
    return x + y


def transformer_block(
    x: torch.Tensor, bp: Dict[str, Any], hp: VitHParams, *, attn_impl: str, mm_impl: str,
    tap=None, kv: Optional[int] = None, mesh=None,
) -> torch.Tensor:
    """One encoder block. `tap(name, tensor)`, when given, observes every
    matmul input ("qkv_in", "proj_in", "fc1_in", "fc2_in"): the static
    activation-scale calibrator (quant/calibrate.py) reads them (under a
    mesh, this rank's shard of the row-parallel inputs)."""
    x, _ = _attn_half(x, bp, hp, attn_impl=attn_impl, mm_impl=mm_impl, tap=tap, kv=kv,
                      mesh=mesh)
    return _mlp_half(x, bp, hp, mm_impl=mm_impl, tap=tap, mesh=mesh)


def moe_block(
    x: torch.Tensor, bp: Dict[str, Any], mp: Dict[str, Any], hp: VitHParams, *,
    attn_impl: str, mm_impl: str, mesh=None, aux: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One V-MoE encoder block: the attention half of `transformer_block`,
    then LN2 and a routed expert MLP (ops/moe.py::moe_mlp, one layer's
    parameters `mp`) in place of fc1/fc2. Returns (x', the layer's router
    diagnostics, empty with `aux=False`)."""
    x, _ = _attn_half(x, bp, hp, attn_impl=attn_impl, mm_impl=mm_impl, mesh=mesh)
    y = layernorm(x, bp["ln2"]["scale"], bp["ln2"]["bias"], hp.eps)
    out, aux = moe_mlp(y, mp, hp, mlp_act(hp.hidden_act), mesh=mesh, aux=aux)
    return x + out, aux


def tome_block(
    x: torch.Tensor, sizes: torch.Tensor, bp: Dict[str, Any], hp: VitHParams, r: int, *,
    attn_impl: str, mm_impl: str, mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One encoder block with ToMe token merging: `transformer_block`'s
    ops with attention proportional to `sizes`, and the size-weighted
    merge of the r most similar token pairs between the two halves.
    The similarity metric is the attention key summed over heads (the
    paper's mean key; cosine similarity ignores the 1/nh), one f32
    product over the k third of qkv. Returns (x', sizes') with r fewer
    tokens. Under a mesh each rank sums its own heads and the sums are
    all-reduced over "model" before the merge."""
    x, qkv = _attn_half(x, bp, hp, attn_impl=attn_impl, mm_impl=mm_impl, sizes=sizes,
                        mesh=mesh)
    if r:
        h, hd = qkv.shape[-1] // 3, hp.head_dim
        head_sum = torch.eye(hd, dtype=torch.float32, device=qkv.device).repeat(
            h // hd, 1
        )  # (h, hd)
        metric = highest_product(qkv[:, :, h : 2 * h].detach().float(), head_sum)
        if h != hp.hidden_size:
            metric = sum_over(metric, mesh, "model")
        x, sizes = tome_merge(x, metric, sizes, r, hp.n_prefix)
    return _mlp_half(x, bp, hp, mm_impl=mm_impl, mesh=mesh), sizes


def remat_block(fn, remat, named: bool = True):
    """`fn` (one block) under `remat`'s policy while autograd records;
    `named`: whether "dots+attn" saves the named outputs too (the ToMe and
    V-MoE loops pass attn_impl == "pallas-train")."""
    if not remat:
        return fn
    saved = _COLLECTIVES
    if remat in ("dots", "dots+attn"):
        saved = saved | _DOTS
    act_q = remat == "dots+attn" and named
    if act_q:
        saved = saved | _NAMED

    def policy(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if func.overloadpacket in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def body(*args):
        with act_q_saved(act_q):
            return fn(*args)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the blocks draw no random numbers
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=partial(create_selective_checkpoint_contexts, policy))

    return run


def unstack_blocks(tree, n: int) -> list:
    """The stacked blocks subtree -> n per-layer subtrees. A tensor leaf is
    taken apart by one `torch.unbind`; QuantLinear and Int8Linear leaves
    (never trained) are indexed per layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack_blocks(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if tree is None:
        return [None] * n
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree))
    return [tree[i] for i in range(n)]


def attention_pool(
    ap: Dict[str, Any], x: torch.Tensor, hp: VitHParams, mm_impl: str = "xla",
    sizes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SigLIP attention pooling (HF SiglipMultiheadAttentionPoolingHead):
    a learned probe cross-attends over the already normed tokens, then a
    residual MLP with a tanh GELU. x: (B, T, h) -> (B, h). Under ToMe
    `sizes` (B, T) the cross-attention is proportional. The packed
    in_proj [q; k; v] runs whole on the probe (q) and on the tokens (k,
    v), since a QuantLinear kernel cannot be column-sliced; the
    one-query attention is the composed one, as in the JAX package. Its
    leaves are never quantized at load, so quantization-aware training
    (mm_impl "qat") leaves it float too."""
    if mm_impl == "qat":
        mm_impl = "xla"
    b, t, h = x.shape
    nh, hd = hp.num_attention_heads, hp.head_dim
    kern, bias = ap["qkv"]["kernel"], ap["qkv"]["bias"]
    probe = ap["probe"].to(x.dtype).expand(b, 1, h)
    q = linear(probe, kern, bias, impl=mm_impl)[:, :, :h]
    kv = linear(x, kern, bias, impl=mm_impl)
    k, v = kv[:, :, h : 2 * h], kv[:, :, 2 * h :]
    q = q.reshape(b, 1, nh, hd).transpose(1, 2)
    k = k.reshape(b, t, nh, hd).transpose(1, 2)
    v = v.reshape(b, t, nh, hd).transpose(1, 2)
    o = attention(q, k, v, sizes=sizes).transpose(1, 2).reshape(b, 1, h)
    o = linear(o, ap["proj"]["kernel"], ap["proj"]["bias"], impl=mm_impl)
    y = layernorm(o, ap["norm"]["scale"], ap["norm"]["bias"], hp.eps)
    y = linear(y, ap["fc1"]["kernel"], ap["fc1"]["bias"], impl=mm_impl)
    y = gelu_tanh(y)
    y = linear(y, ap["fc2"]["kernel"], ap["fc2"]["bias"], impl=mm_impl)
    return (o + y)[:, 0]


def _head(
    params: Dict[str, Any], x: torch.Tensor, hp: VitHParams, mm_impl: str, features: bool,
    tap=None, *, kv: Optional[int] = None, sizes: Optional[torch.Tensor] = None, mesh=None,
) -> torch.Tensor:
    """Pooling readout + classifier head; features=True returns the
    final-LN pooled readout (the embedding) instead of the logits:
    (B, hidden), or (B, seq_len, hidden) and (B, seq_len, classes) for a
    sequence head. A folded tree (models/fold.py) keeps the final norm's
    affine for that readout in `features_norm`, since its `norm` carries
    none. `tap` observes the head's input as "head_in" (both prefix
    tokens of a distilled tree, the pooled output of attention
    pooling). Under token padding the pooled readouts stop at `kv`, the
    real token count; ToMe's `sizes` weight them (the prefix tokens that
    the CLS and distilled readouts take are never merged)."""
    end = x.shape[1] if kv is None else kv
    norm = params["features_norm"] if features and "features_norm" in params else params["norm"]
    if hp.global_pool == "map":
        # the final norm applies to every token (HF post_layernorm), then
        # the probe pools: the reverse of every other head's order
        y = layernorm(x[:, :end], norm["scale"], norm["bias"], hp.eps)
        pooled = attention_pool(params["attn_pool"], y, hp, mm_impl,
                                sizes=None if sizes is None else sizes[:, :end])
    elif "head_dist" in params:
        # DeiT distilled: LN over both prefix tokens; the embedding is the
        # mean of the two normed tokens, the logits the mean of two heads
        pooled = layernorm(x[:, :2], norm["scale"], norm["bias"], hp.eps)
        if tap is not None:
            tap("head_in", pooled)
        if features:
            return (pooled[:, 0] + pooled[:, 1]) * 0.5
        c = hp.num_classes
        return (_col_linear(pooled[:, 0], params["head"], mm_impl, mesh, c, gather=True)
                + _col_linear(pooled[:, 1], params["head_dist"], mm_impl, mesh, c,
                              gather=True)) * 0.5
    elif hp.seq_len is not None:
        pooled = layernorm(x[:, : hp.seq_len], norm["scale"], norm["bias"], hp.eps)
    elif hp.global_pool == "avg":
        # mean over the patch tokens, prefix and registers excluded; under
        # ToMe each token counts as the `sizes` originals it stands for
        if sizes is None:
            mean = x[:, hp.n_prefix : end].mean(dim=1)
        else:
            s = sizes[:, hp.n_prefix : end]
            mean = ((x[:, hp.n_prefix : end].float() * s[..., None]).sum(dim=1)
                    / s.sum(dim=1, keepdim=True)).to(x.dtype)
        pooled = layernorm(mean, norm["scale"], norm["bias"], hp.eps)
    else:
        pooled = layernorm(x[:, 0], norm["scale"], norm["bias"], hp.eps)
    if tap is not None:
        tap("head_in", pooled)
    if features:
        return pooled
    if "head" not in params:
        raise ValueError(
            "checkpoint is a headless encoder (no classifier head) — "
            "serve embeddings (features=True / embed surfaces) or "
            "fine-tune to attach a head"
        )
    return _col_linear(pooled, params["head"], mm_impl, mesh, hp.num_classes, gather=True)


def forward(
    params: Dict[str, Any],
    images: torch.Tensor,
    hp: VitHParams,
    *,
    attn_impl: str = "xla",
    mm_impl: str = "xla",
    features: bool = False,
    pad_tokens: bool = False,
    tome: int = 0,
    moe_aux: bool = False,
    tap=None,
    mesh=None,
    remat=False,
):
    """Preprocessed images (B, C, H, W) -> logits (B, num_classes), or
    with features=True the final-LN pooled readout (B, hidden); a
    sequence head (ViTSTR) gives (B, seq_len, ...) of either. `tap`
    observes every GEMM input (transformer_block, _head) of a dense tree.

    `pad_tokens=True` (serving; a fused attention only) zero-pads T to a
    multiple of 8; the pad rows carry values nothing reads. `tome=r`
    merges tokens in every layer by `tome_schedule` (layer l merges
    min(r, remaining // 2) pairs); the two are exclusive. A V-MoE model
    takes neither; with `moe_aux=True` it returns (out, aux), aux the
    mean over its MoE layers of ops/moe.py's diagnostics. `mesh` runs
    this rank's shards of a tree placed by parallel/sharding.py on this
    rank's batch rows (FSDP leaves are all-gathered here, once). `remat`
    (False / None, True, "dots", "dots+attn") checkpoints each block
    while autograd records (the module's docstring)."""
    if mesh is not None:
        from vit_cpp_tpu_torch.parallel.sharding import local_params

        params = local_params(params, mesh)
    if pad_tokens and attn_impl not in ("pallas", "pallas-fast"):
        raise ValueError(
            "pad_tokens requires a fused pallas attention (the XLA "
            "and training paths run unpadded)"
        )
    if tome:
        if hp.num_experts:
            raise ValueError("tome + MoE is not supported (both re-plan the layer loop)")
        if hp.seq_len is not None:
            raise ValueError(
                "tome is incompatible with sequence heads (ViTSTR reads "
                "every token position)"
            )
        if pad_tokens:
            raise ValueError("tome and pad_tokens are exclusive")
    if hp.num_experts:
        if pad_tokens:
            raise ValueError(
                "pad_tokens + MoE is not supported (pad rows would claim "
                "expert capacity)"
            )
        if mm_impl == "qat":
            raise ValueError(
                "QAT through MoE experts is not implemented (the expert "
                "einsum path has no fake-quant leaves)"
            )
        return _moe_forward(params, images, hp, attn_impl=attn_impl, mm_impl=mm_impl,
                            features=features, moe_aux=moe_aux, mesh=mesh, remat=remat)
    x = embed(params, images, hp)
    blocks = unstack_blocks(params["blocks"], hp.num_hidden_layers)
    if tome:
        def tome_layer(x, sizes, bp, rl):
            return tome_block(x, sizes, bp, hp, rl, attn_impl=attn_impl, mm_impl=mm_impl,
                              mesh=mesh)

        layer = remat_block(tome_layer, remat, attn_impl == "pallas-train")
        rs = tome_schedule(hp.n_patches, hp.num_hidden_layers, tome)
        sizes = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
        for bp, rl in zip(blocks, rs):
            x, sizes = layer(x, sizes, bp, rl)
        return _head(params, x, hp, mm_impl, features, tap, sizes=sizes, mesh=mesh)
    if moe_aux:
        raise ValueError("moe_aux requires an MoE model (hp.num_experts)")
    kv = None
    if pad_tokens:
        b, t, h = x.shape
        if t % 8:
            kv = t
            x = torch.cat([x, x.new_zeros(b, -(-t // 8) * 8 - t, h)], dim=1)

    def dense_layer(x, bp):
        return transformer_block(x, bp, hp, attn_impl=attn_impl, mm_impl=mm_impl, tap=tap,
                                 kv=kv, mesh=mesh)

    layer = remat_block(dense_layer, remat)
    for bp in blocks:
        x = layer(x, bp)
    return _head(params, x, hp, mm_impl, features, tap, kv=kv, mesh=mesh)


def predict_probs(params: Dict[str, Any], images: torch.Tensor, hp: VitHParams,
                  **kw) -> torch.Tensor:
    """`forward` (its keywords) + an f32 softmax, the reference's graph
    output (vit_cpp_tpu/models/vit.py::predict_probs)."""
    return torch.softmax(forward(params, images, hp, **kw).float(), dim=-1)


def moe_layer_params(params: Dict[str, Any], hp: VitHParams) -> list:
    """A V-MoE tree -> one (bp, mp) per layer: bp that layer's ln1, qkv,
    proj and ln2, plus fc1/fc2 in a dense layer; mp its "moe" parameters
    in an MoE layer, else None. The dense fc1/fc2 and the experts stack
    over their own layers (models/params.py), so each is unstacked by its
    own counter."""
    n, moe_set = hp.num_hidden_layers, set(hp.moe_layers)
    shared = unstack_blocks(
        {k: v for k, v in params["blocks"].items() if k not in ("fc1", "fc2")}, n
    )
    mlps = iter(unstack_blocks({k: params["blocks"][k] for k in ("fc1", "fc2")},
                               n - len(moe_set)))
    moes = iter(unstack_blocks(params["moe"], len(moe_set)))
    return [(bp, next(moes)) if l in moe_set else ({**bp, **next(mlps)}, None)
            for l, bp in enumerate(shared)]


def _moe_forward(params, images, hp: VitHParams, *, attn_impl: str, mm_impl: str,
                 features: bool, moe_aux: bool, mesh=None, remat=False):
    """The V-MoE branch of `forward` (vit_cpp_tpu/models/vit.py:518-591)."""

    def dense_layer(x, bp):
        return transformer_block(x, bp, hp, attn_impl=attn_impl, mm_impl=mm_impl, mesh=mesh)

    def moe_layer(x, bp, mp):
        return moe_block(x, bp, mp, hp, attn_impl=attn_impl, mm_impl=mm_impl, mesh=mesh,
                         aux=moe_aux)

    named = attn_impl == "pallas-train"
    dense_layer, moe_layer = (remat_block(f, remat, named) for f in (dense_layer, moe_layer))
    x = embed(params, images, hp)
    aux_sum: Dict[str, torch.Tensor] = {}
    for bp, mp in moe_layer_params(params, hp):
        if mp is None:
            x = dense_layer(x, bp)
            continue
        x, aux = moe_layer(x, bp, mp)
        for k, v in aux.items():
            aux_sum[k] = aux_sum.get(k, 0.0) + v
    out = _head(params, x, hp, mm_impl, features, mesh=mesh)
    if moe_aux:
        return out, {k: v / len(hp.moe_layers) for k, v in aux_sum.items()}
    return out


def forward_debug(
    params: Dict[str, Any], images: torch.Tensor, hp: VitHParams, **kw
) -> Dict[str, torch.Tensor]:
    """Forward pass that keeps every stage's activations, for stage-by-stage
    diffing against a reference (vit_cpp_tpu/models/vit.py::forward_debug,
    the analogue of the reference's print_t_f32 hook): {"embed",
    "block_0", ..., "pooled", "logits", "probs"}; a headless encoder stops
    after "pooled". `attn_impl` and `mm_impl` (default "xla") are
    `forward`'s. "pooled" is the final-LN readout that the head reads, the
    attention-pooled output of a SigLIP map-pooled tree; a V-MoE tree runs
    its routed layers (moe_block), as `forward` does (the JAX function
    pools a map-pooled tree from x[:, 0] and runs every layer dense)."""
    attn_impl, mm_impl = kw.get("attn_impl", "xla"), kw.get("mm_impl", "xla")
    acts: Dict[str, torch.Tensor] = {}
    x = embed(params, images, hp)
    acts["embed"] = x
    if hp.num_experts:
        layers = moe_layer_params(params, hp)
    else:
        layers = [(bp, None) for bp in unstack_blocks(params["blocks"], hp.num_hidden_layers)]
    for i, (bp, mp) in enumerate(layers):
        if mp is None:
            x = transformer_block(x, bp, hp, attn_impl=attn_impl, mm_impl=mm_impl)
        else:
            x, _ = moe_block(x, bp, mp, hp, attn_impl=attn_impl, mm_impl=mm_impl, aux=False)
        acts[f"block_{i}"] = x
    if "head_dist" in params and hp.seq_len is None:
        # both normed prefix tokens, as the JAX function keeps them
        norm = params["norm"]
        pooled = layernorm(x[:, :2], norm["scale"], norm["bias"], hp.eps)
        logits = (_linear(pooled[:, 0], params["head"], mm_impl)
                  + _linear(pooled[:, 1], params["head_dist"], mm_impl)) * 0.5
    else:
        # the readout the head reads: a folded tree's `features_norm` is
        # the embeddings' norm, not the head's
        tree = {k: v for k, v in params.items() if k != "features_norm"}
        pooled = _head(tree, x, hp, mm_impl, features=True)
        if "head" not in params:  # a headless encoder stops at the features
            acts["pooled"] = pooled
            return acts
        logits = _linear(pooled, params["head"], mm_impl)
    acts["pooled"] = pooled
    acts["logits"] = logits
    acts["probs"] = torch.softmax(logits.float(), dim=-1)
    return acts


def print_t(name: str, t, n: int = 10) -> None:
    """Console dump in the reference's print_t_f32 shape: the first and
    last n values and the whole tensor's sum, as
    vit_cpp_tpu/models/vit.py::print_t prints them."""
    import numpy as np

    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu().numpy()
    a = np.asarray(t, dtype=np.float32).reshape(-1)
    head = " ".join(f"{v:.5f}" for v in a[:n])
    tail = " ".join(f"{v:.5f}" for v in a[-n:])
    print(f"{name}: [{head} ... {tail}], sum = {a.sum():.5f}")
