"""The ViT forward pass over a parameter tree of torch tensors.

Counterpart of vit_cpp_tpu/models/vit.py, with the same numerics:

- patch embedding is a reshape + one (c*p*p, h) matmul, not a conv;
- per block: LN -> fused QKV matmul -> attention -> proj -> residual;
  LN -> fc1 -> GELU -> fc2 -> residual;
- head: the CLS token (or the mean of the patch tokens for avg-pool
  models; the mean of two heads for DeiT-distilled ones) -> LN -> linear.

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
kernel (ops/qmatmul.py); dense and Int8Linear weights ignore it. ToMe, token padding, V-MoE, attention pooling and sequence
heads are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.ops.core import attention, layernorm, linear, mlp_act
from vit_cpp_tpu_torch.ops.flash_attention import attention_qkv, attention_qkv_train

ATTN_IMPLS = ("xla", "pallas", "pallas-fast", "pallas-train")


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


def _attn_half(
    x: torch.Tensor, bp: Dict[str, Any], hp: VitHParams, *, attn_impl: str, mm_impl: str
) -> torch.Tensor:
    """LN1 -> QKV -> attention -> proj -> residual."""
    b, t, h = x.shape
    nh, hd = hp.num_attention_heads, hp.head_dim
    y = layernorm(x, bp["ln1"]["scale"], bp["ln1"]["bias"], hp.eps)
    qkv = linear(y, bp["qkv"]["kernel"], bp["qkv"]["bias"], impl=mm_impl)
    if attn_impl in ("pallas", "pallas-fast"):
        o = attention_qkv(qkv, nh, fast=attn_impl == "pallas-fast")
    elif attn_impl == "pallas-train":
        o = attention_qkv_train(qkv, nh)
    elif attn_impl == "xla":
        q, k, v = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        o = attention(q, k, v).permute(0, 2, 1, 3).reshape(b, t, h)
    else:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
    return x + linear(o, bp["proj"]["kernel"], bp["proj"]["bias"], impl=mm_impl)


def transformer_block(
    x: torch.Tensor, bp: Dict[str, Any], hp: VitHParams, *, attn_impl: str, mm_impl: str
) -> torch.Tensor:
    """One encoder block."""
    x = _attn_half(x, bp, hp, attn_impl=attn_impl, mm_impl=mm_impl)
    y = layernorm(x, bp["ln2"]["scale"], bp["ln2"]["bias"], hp.eps)
    y = linear(y, bp["fc1"]["kernel"], bp["fc1"]["bias"], impl=mm_impl)
    y = mlp_act(hp.hidden_act)(y)
    y = linear(y, bp["fc2"]["kernel"], bp["fc2"]["bias"], impl=mm_impl)
    return x + y


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


def _head(params: Dict[str, Any], x: torch.Tensor, hp: VitHParams, mm_impl: str) -> torch.Tensor:
    """Pooling readout + classifier head."""
    norm = params["norm"]
    if "head" not in params:
        raise NotImplementedError(
            "headless encoders serve embeddings, which vit_cpp_tpu_torch "
            "does not port yet; they come with the features/embed slice "
            "(features_batch and the /v1/embed route)"
        )
    if "head_dist" in params:
        # DeiT distilled: LN over both prefix tokens, mean of the two heads
        pooled = layernorm(x[:, :2], norm["scale"], norm["bias"], hp.eps)
        return (
            linear(pooled[:, 0], params["head"]["kernel"], params["head"]["bias"], impl=mm_impl)
            + linear(
                pooled[:, 1], params["head_dist"]["kernel"], params["head_dist"]["bias"],
                impl=mm_impl,
            )
        ) * 0.5
    if hp.global_pool == "avg":
        pooled = x[:, hp.n_prefix:].mean(dim=1)
    else:
        pooled = x[:, 0]
    pooled = layernorm(pooled, norm["scale"], norm["bias"], hp.eps)
    return linear(pooled, params["head"]["kernel"], params["head"]["bias"], impl=mm_impl)


def forward(
    params: Dict[str, Any],
    images: torch.Tensor,
    hp: VitHParams,
    *,
    attn_impl: str = "xla",
    mm_impl: str = "xla",
    pad_tokens: bool = False,
    tome: int = 0,
) -> torch.Tensor:
    """Preprocessed images (B, C, H, W) -> logits (B, num_classes)."""
    if pad_tokens or tome:
        raise NotImplementedError(
            "token padding and ToMe merging are not ported to "
            "vit_cpp_tpu_torch yet; they come with the ToMe and "
            "token-padding slices (the attention kernel already takes "
            "their kv / sizes inputs)"
        )
    if hp.seq_len is not None or hp.global_pool == "map" or hp.num_experts:
        raise NotImplementedError(
            "sequence heads (ViTSTR), attention pooling and V-MoE are not "
            "ported to vit_cpp_tpu_torch yet; they come with the "
            "model-families and V-MoE slices"
        )
    x = embed(params, images, hp)
    for bp in unstack_blocks(params["blocks"], hp.num_hidden_layers):
        x = transformer_block(x, bp, hp, attn_impl=attn_impl, mm_impl=mm_impl)
    return _head(params, x, hp, mm_impl)


def predict_probs(params, images, hp, **kw) -> torch.Tensor:
    """Forward + f32 softmax over the classes."""
    return torch.softmax(forward(params, images, hp, **kw).float(), dim=-1)
