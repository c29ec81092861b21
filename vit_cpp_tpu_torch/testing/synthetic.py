"""Synthetic checkpoint generation in the reference tensor-name schema.

Generates a random state dict with the exact tensor names, shapes and dtype
rules of the reference converter (SURVEY.md §2.4; convert-pth-to-ggml.py:
141-156), so file-format, loader and forward-parity tests can run without
downloading pretrained timm weights (the environment has no network egress).

The port's own copy of the checkpoint writer of
vit_cpp_tpu/testing/synthetic.py: the same seed writes the same bytes.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType
from vit_cpp_tpu_torch.gguf.writer import write_model
from vit_cpp_tpu_torch.hparams import VitHParams

# Reference converter dtype rule (convert-pth-to-ggml.py:141-148): at ftype=1
# every tensor with ndim != 1 is f16 except pos_embed/cls_token (kept f32);
# dist_token (our DeiT-distilled extension) follows the cls_token rule.
_KEEP_F32 = ("pos_embed", "cls_token", "dist_token", "reg_token", "attn_pool.probe")


def state_dict_shapes(hp: VitHParams) -> Dict[str, tuple]:
    """Torch-order shapes for every tensor of a ViT checkpoint (§2.4)."""
    h, L, c = hp.hidden_size, hp.num_hidden_layers, hp.num_classes
    # NOTE: insertion order is load-bearing — random_state_dict draws
    # values sequentially from one rng, so reordering entries silently
    # changes every seed-keyed synthetic checkpoint (committed
    # quick-example transcripts, bf16 goldens, w8a8 thresholds). New
    # optional tensors must append AFTER the standard fields they
    # interleave with, never displace them.
    shapes = {
        "pos_embed": (1, hp.n_pos_tokens, h),
    }
    if hp.num_prefix_tokens >= 1:
        shapes["cls_token"] = (1, 1, h)
    shapes.update(
        {
            "patch_embed.proj.weight": (
                h,
                hp.in_chans,
                hp.patch_size,
                hp.patch_size,
            ),
            # The converter reshapes the conv bias to (1, C, 1, 1)
            # (convert-pth-to-ggml.py:150-151).
            "patch_embed.proj.bias": (1, h, 1, 1),
        }
    )
    if hp.num_prefix_tokens == 2:
        shapes["dist_token"] = (1, 1, h)
    if hp.num_reg_tokens:
        shapes["reg_token"] = (1, hp.num_reg_tokens, h)
    if hp.norm_pre:
        shapes["norm_pre.weight"] = (h,)
        shapes["norm_pre.bias"] = (h,)
    moe_set = set(hp.moe_layers) if hp.num_experts else set()
    for i in range(L):
        p = f"blocks.{i}."
        shapes.update(
            {
                p + "norm1.weight": (h,),
                p + "norm1.bias": (h,),
                p + "attn.qkv.weight": (3 * h, h),
                p + "attn.qkv.bias": (3 * h,),
                p + "attn.proj.weight": (h, h),
                p + "attn.proj.bias": (h,),
                p + "norm2.weight": (h,),
                p + "norm2.bias": (h,),
            }
        )
        if i in moe_set:
            # V-MoE layer (ops/moe.py): router + per-expert MLP tensors
            # replace the dense mlp.* pair (dense configs are unchanged,
            # so the draw order of every committed seed is preserved)
            shapes[p + "moe.router.weight"] = (hp.num_experts, h)
            for ex in range(hp.num_experts):
                ep = f"{p}moe.experts.{ex}."
                shapes[ep + "fc1.weight"] = (hp.mlp_dim, h)
                shapes[ep + "fc1.bias"] = (hp.mlp_dim,)
                shapes[ep + "fc2.weight"] = (h, hp.mlp_dim)
                shapes[ep + "fc2.bias"] = (h,)
        else:
            shapes.update(
                {
                    p + "mlp.fc1.weight": (hp.mlp_dim, h),
                    p + "mlp.fc1.bias": (hp.mlp_dim,),
                    p + "mlp.fc2.weight": (h, hp.mlp_dim),
                    p + "mlp.fc2.bias": (h,),
                }
            )
    norm_name = "fc_norm" if hp.global_pool == "avg" else "norm"
    shapes[norm_name + ".weight"] = (h,)
    shapes[norm_name + ".bias"] = (h,)
    if hp.global_pool == "map":  # SigLIP attention-pooling head
        shapes.update(
            {
                "attn_pool.probe": (1, 1, h),
                "attn_pool.qkv.weight": (3 * h, h),
                "attn_pool.qkv.bias": (3 * h,),
                "attn_pool.proj.weight": (h, h),
                "attn_pool.proj.bias": (h,),
                "attn_pool.norm.weight": (h,),
                "attn_pool.norm.bias": (h,),
                "attn_pool.mlp.fc1.weight": (hp.mlp_dim, h),
                "attn_pool.mlp.fc1.bias": (hp.mlp_dim,),
                "attn_pool.mlp.fc2.weight": (h, hp.mlp_dim),
                "attn_pool.mlp.fc2.bias": (h,),
            }
        )
    if c:  # headless encoders (num_classes=0) carry no classifier
        shapes["head.weight"] = (c, h)
        shapes["head.bias"] = (c,)
    if hp.num_prefix_tokens == 2:
        shapes["head_dist.weight"] = (c, h)
        shapes["head_dist.bias"] = (c,)
    if hp.hidden_act == "quick_gelu":
        shapes["meta.clip"] = (1,)  # CLIP family marker (hparams.py)
    if hp.num_experts:
        shapes["meta.moe"] = (2,)  # V-MoE marker: [top_k, capacity] values
    return shapes


def random_state_dict(hp: VitHParams, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random f32 state dict, scaled so activations stay well-conditioned."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, shape in state_dict_shapes(hp).items():
        if name == "meta.clip":
            out[name] = np.ones(shape, np.float32)  # constant marker
            continue
        if name == "meta.moe":
            # value-carrying marker (models/params.infer_moe_hparams
            # reads top_k/capacity back from it) — never random
            out[name] = np.asarray(
                [hp.moe_top_k, hp.moe_capacity], np.float32
            )
            continue
        if name.endswith("norm1.weight") or name.endswith("norm2.weight") or name in ("norm.weight", "norm_pre.weight", "fc_norm.weight", "attn_pool.norm.weight"):
            v = 1.0 + 0.02 * rng.standard_normal(shape)
        elif name.endswith(".bias"):
            v = 0.02 * rng.standard_normal(shape)
        elif name in ("pos_embed", "cls_token", "dist_token", "reg_token", "attn_pool.probe"):
            v = 0.02 * rng.standard_normal(shape)
        else:
            fan_in = shape[-1] if len(shape) >= 2 else shape[0]
            if name == "patch_embed.proj.weight":
                fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        out[name] = v.astype(np.float32)
    return out


def record_dtype(name: str, ndim: int, ftype: int) -> GGMLDType:
    """Per-tensor dtype rule of the reference converter (py:141-148).

    MoE routers stay f32 even at ftype=1, matching the quantizer's rule
    (cli/quantize.py): their top-k decision boundaries pick WHICH expert
    compute runs, they are sub-0.1% of the file, and every consumer
    routes in f32 (ops/moe.py)."""
    if (
        ftype == 1
        and ndim != 1
        and name not in _KEEP_F32
        and ".moe.router." not in name
    ):
        return GGMLDType.F16
    return GGMLDType.F32


def state_dict_records(
    state: Dict[str, np.ndarray], ftype: int
) -> Iterator[Tuple[str, tuple, GGMLDType, np.ndarray]]:
    for name, arr in state.items():
        dt = record_dtype(name, arr.ndim, ftype)
        payload = arr.astype(np.float16 if dt == GGMLDType.F16 else np.float32)
        yield name, arr.shape, dt, payload


def write_synthetic_model(
    path: str,
    hp: VitHParams,
    ftype: int = 1,
    seed: int = 0,
    id2label: Dict[int, str] | None = None,
) -> Dict[str, np.ndarray]:
    """Write a random checkpoint file; returns the f32 state dict used."""
    state = random_state_dict(hp, seed=seed)
    if id2label is None:
        id2label = {i: f"LABEL_{i}" for i in range(hp.num_classes)}
    write_model(path, hp, id2label, state_dict_records(state, ftype), ftype)
    return state
