"""Attention maps and attention rollout, for interpretability.

Counterpart of vit_cpp_tpu/models/attention_maps.py. The serving forward
never materializes attention probabilities (the fused kernel keeps them
on chip), so this module runs the encoder again with composed attention,
keeping every layer's softmax weights as a (B, L, H, T, T) f32 tensor,
and computes the attention-rollout saliency (Abnar & Zuidema,
"Quantifying Attention Flow in Transformers", 2020): per layer
A = normalize(0.5 * mean_heads(P) + 0.5 * I), rolled out as
R = A_L @ ... @ A_1; the readout row's patch columns, on the patch grid,
are the heatmap. An analysis path in plain PyTorch: no kernel runs here,
as the JAX path is XLA. A V-MoE tree runs its routed MLPs (ops/moe.py)
in its MoE layers. Under a mesh (`mesh=`, a tree placed by
parallel/sharding.py::shard_params) the linears run on this rank's
Megatron shards as models/vit.py's do, each layer's probabilities are
those of this rank's heads, and they are all-gathered over "model"
(heads are contiguous per rank) before they are returned.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.models.vit import (
    _col_linear,
    _head,
    _row_linear,
    embed,
    moe_layer_params,
    unstack_blocks,
)
from vit_cpp_tpu_torch.ops.core import layernorm, mlp_act
from vit_cpp_tpu_torch.ops.moe import moe_mlp
from vit_cpp_tpu_torch.parallel.mesh import gather_from_model


def _block_with_probs(
    x: torch.Tensor, bp: Dict[str, Any], mp, hp: VitHParams, mesh=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """models/vit.py::transformer_block (moe_block where the layer's MoE
    parameters `mp` are given) with composed attention, returning its f32
    softmax weights (B, H, T, T) beside the block output (under a mesh,
    this rank's H/tp heads)."""
    b, t, _ = x.shape
    hd = hp.head_dim
    y = layernorm(x, bp["ln1"]["scale"], bp["ln1"]["bias"], hp.eps)
    qkv = _col_linear(y, bp["qkv"], "xla", mesh, 3 * hp.hidden_size)
    h = qkv.shape[-1] // 3
    q, k, v = qkv.reshape(b, t, 3, h // hd, hd).permute(2, 0, 3, 1, 4)
    # f32 scores, as ops/core.attention: bf16 ones would round before the
    # softmax
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores * (1.0 / np.sqrt(hd)), dim=-1)
    o = torch.matmul(probs.to(v.dtype).float(), v.float()).to(x.dtype)
    o = o.permute(0, 2, 1, 3).reshape(b, t, h)
    x = x + _row_linear(o, bp["proj"], "xla", mesh, hp.hidden_size)
    y = layernorm(x, bp["ln2"]["scale"], bp["ln2"]["bias"], hp.eps)
    if mp is not None:
        return x + moe_mlp(y, mp, hp, mlp_act(hp.hidden_act), mesh=mesh, aux=False)[0], probs
    y = _col_linear(y, bp["fc1"], "xla", mesh, hp.mlp_dim)
    y = mlp_act(hp.hidden_act)(y)
    y = _row_linear(y, bp["fc2"], "xla", mesh, hp.mlp_dim)
    return x + y, probs


def attention_maps(
    params: Dict[str, Any], images: torch.Tensor, hp: VitHParams, mesh=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, S, S) images -> ((B, L, H, T, T) f32 attention
    probabilities, (B, T, h) last block output). With `mesh`, this rank's
    shards of the tree on the rows given, every head gathered."""
    x = embed(params, images, hp)
    probs_all = []
    layers = (moe_layer_params(params, hp) if "moe" in params else
              [(bp, None) for bp in unstack_blocks(params["blocks"], hp.num_hidden_layers)])
    for bp, mp in layers:
        x, probs = _block_with_probs(x, bp, mp, hp, mesh)
        probs_all.append(probs)
    maps = torch.stack(probs_all, dim=1)  # (B, L, H/tp, T, T)
    if maps.shape[2] != hp.num_attention_heads:  # a qkv that shard_params split
        maps = gather_from_model(maps, mesh, dim=2)
    return maps, x


def head_logits(
    params: Dict[str, Any], final: torch.Tensor, hp: VitHParams, mm_impl: str = "xla",
    mesh=None,
) -> torch.Tensor:
    """The classifier head of models/vit.py::forward (its _head, with the
    engine's mm_impl; under a mesh the column-parallel head, its logits
    all-gathered) applied to a last block output, so that one maps
    forward serves both the rollout and the top-k."""
    if "head" not in params:
        raise ValueError(
            "checkpoint is a headless encoder — no classifier to explain; "
            "the rollout saliency is still available (attention_rollout)"
        )
    return _head(params, final, hp, mm_impl, False, mesh=mesh)


def attention_rollout(probs, hp: VitHParams, head_fuse: str = "mean") -> np.ndarray:
    """(B, L, H, T, T) attention probabilities -> (B, side, side) f32
    saliency over the patch grid, scaled to a maximum of 1 per image.

    The heads are fused (mean, max or min), each layer mixed half and
    half with the residual identity and its rows renormalized, and the
    layers multiplied out. The readout row is the CLS query (the mean of
    the CLS and distillation rows for a distilled model; never a
    register), or the mean of the patch rows for a CLS-less model."""
    p = np.asarray(probs, dtype=np.float32)
    if head_fuse == "mean":
        a = p.mean(axis=2)
    elif head_fuse == "max":
        a = p.max(axis=2)
    elif head_fuse == "min":
        a = p.min(axis=2)
    else:
        raise ValueError(f"head_fuse must be mean|max|min, got {head_fuse!r}")
    b, n_layers, t, _ = a.shape
    eye = np.eye(t, dtype=np.float32)
    a = 0.5 * a + 0.5 * eye
    a = a / a.sum(axis=-1, keepdims=True)
    roll = np.broadcast_to(eye, (b, t, t)).copy()
    for layer in range(n_layers):
        roll = a[:, layer] @ roll
    n_readout, total_prefix = hp.num_prefix_tokens, hp.n_prefix
    if n_readout:
        readout = roll[:, :n_readout].mean(axis=1)
    else:
        readout = roll[:, total_prefix:].mean(axis=1)
    side = hp.n_patches_side
    grid = readout[:, total_prefix:].reshape(b, side, side)
    peak = grid.max(axis=(1, 2), keepdims=True)
    return grid / np.maximum(peak, 1e-12)


def saliency_to_png(grid: np.ndarray, path: str, upscale_to: "int | None" = None) -> None:
    """One (side, side) [0, 1] saliency -> grayscale PNG, optionally
    upscaled (nearest) to the input resolution for overlaying."""
    from PIL import Image

    img = Image.fromarray(np.clip(np.asarray(grid) * 255.0, 0, 255).astype(np.uint8), mode="L")
    if upscale_to:
        img = img.resize((upscale_to, upscale_to), Image.NEAREST)
    img.save(path)
