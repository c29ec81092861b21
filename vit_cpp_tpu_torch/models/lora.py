"""LoRA fine-tuning: low-rank adapters on the block GEMMs.

Counterpart of vit_cpp_tpu/models/lora.py. The pretrained weights stay
frozen; rank-r deltas train on the kernels that serving quantizes:

    kernel_eff = kernel + (alpha / r) * a @ b      a: (in, r), b: (r, out)

`b` starts at zero, so step 0 is exactly the pretrained model. Only the
adapters and the head carry optimizer state and are updated. The backward
still propagates dx through every layer, and since a merged kernel
depends on `a` and `b`, autograd forms each site's full (in, out) weight
gradient before the bmm backward reduces it to rank r: what LoRA saves
is the backbone's AdamW state, gradients and update. The adapters stay
stacked (L, in, r) / (L, r, out) like every block parameter, and the
merge is one batched product per site in f32 with TF32 off; the merged
tree feeds the unchanged forward, so the training attention, QAT and the
export compose. Export folds the adapters into the dense kernels
(`merge_lora`): the served gguf is a plain dense checkpoint.

Under a mesh (`merge_lora(..., mesh=)`) the adapters replicate while the
base kernels are this rank's shards: a column-parallel site (qkv, fc1)
merges the matching columns of a @ b (qkv's head-aligned ones), a
row-parallel site (proj, fc2) the matching rows. Each rank's merge then
sees only its columns or rows, so at a sharded site both adapters enter
through `copy_to_model`: their gradients, each rank's share, are
all-reduced over "model" and every model rank takes the same update.

`init_lora` draws `a` from a seeded torch.Generator: the JAX package's
jax.random stream cannot be reproduced here, so the two packages start
from different adapters for the same seed (models/params.py::
params_from_jax carries the JAX package's trainable tree over where a
test needs the same start).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from vit_cpp_tpu_torch.ops.precision import matmul_precision
from vit_cpp_tpu_torch.parallel.mesh import copy_to_model
from vit_cpp_tpu_torch.parallel.sharding import model_shard

LORA_SITES = ("qkv", "proj", "fc1", "fc2")


def init_lora(params: Dict[str, Any], rank: int, seed: int = 0) -> Dict[str, Any]:
    """Zero-effect adapters for every block GEMM: a ~ N(0, 1) / r, b = 0,
    on the kernels' device."""
    if rank <= 0:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    out: Dict[str, Any] = {"blocks": {}}
    for i, name in enumerate(LORA_SITES):
        k = params["blocks"][name]["kernel"]
        if k.ndim != 3:
            raise ValueError(
                f"init_lora expects stacked (L, in, out) kernels, got "
                f"{tuple(k.shape)} for blocks.{name}"
            )
        layers, in_f, out_f = k.shape
        gen = torch.Generator().manual_seed(seed * len(LORA_SITES) + i)
        a = torch.randn((layers, in_f, rank), generator=gen) * (1.0 / rank)
        b = torch.zeros((layers, rank, out_f))
        out["blocks"][name] = {"a": a.to(k.device), "b": b.to(k.device)}
    return out


def lora_trainable(params: Dict[str, Any], rank: int, seed: int = 0) -> Dict[str, Any]:
    """The tree the optimizer sees: fresh adapters and the classifier
    head(s); everything else stays frozen in `params`."""
    out: Dict[str, Any] = {"lora": init_lora(params, rank, seed)}
    for name in ("head", "head_dist"):
        if name in params:
            out[name] = params[name]
    return out


def merge_lora(params: Dict[str, Any], trainable: Dict[str, Any], alpha: float,
               mesh=None) -> Dict[str, Any]:
    """Fold the adapters (and the trained head) into a full parameter
    tree: kernel + (a @ b) * (alpha / rank) per site, the product one
    torch.bmm in f32 with TF32 off (the JAX package's f32 einsum).
    Differentiable in `trainable`; used in every LoRA loss and once at
    export."""
    out = dict(params)
    blocks = dict(params["blocks"])
    with matmul_precision("highest"):
        for name in LORA_SITES:
            ab = trainable["lora"]["blocks"][name]
            a, b = ab["a"], ab["b"]
            kernel = blocks[name]["kernel"]
            col = kernel.shape[-1] != b.shape[-1]  # column-parallel shard
            row = kernel.shape[-2] != a.shape[-2]  # row-parallel shard
            if col or row:  # each rank's product covers only its shard
                a, b = copy_to_model(a, mesh), copy_to_model(b, mesh)
            if col:
                b = model_shard(b, -1, mesh, qkv=name == "qkv")
            if row:
                a = model_shard(a, -2, mesh)
            delta = torch.bmm(a.float(), b.float()) * (alpha / a.shape[-1])
            leaf = dict(blocks[name])
            leaf["kernel"] = leaf["kernel"] + delta.to(leaf["kernel"].dtype)
            blocks[name] = leaf
    out["blocks"] = blocks
    for name in ("head", "head_dist"):
        if name in trainable:
            out[name] = trainable[name]
    return out


def lora_state_bytes(tree) -> int:
    """Bytes of a tree's tensors (the AdamW state is about 3x this in f32
    for the trainable tree)."""
    if isinstance(tree, dict):
        return sum(lora_state_bytes(v) for v in tree.values())
    return 0 if tree is None else tree.numel() * tree.element_size()
