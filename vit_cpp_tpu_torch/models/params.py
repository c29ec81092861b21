"""Parameter trees from model-file records, as dicts of torch tensors.

Counterpart of vit_cpp_tpu/models/params.py, in the same layout:

- linear kernels are (in, out), so the forward computes `x @ kernel`;
- the L transformer blocks are stacked on a leading axis: blocks.qkv.kernel
  is (L, h, 3h), blocks.ln1.scale is (L, h), and so on;
- the patch embedding is the flattened (c*p*p, h) conv kernel;
- a block-quantized 2-D linear weight stays packed as a QuantLinear
  (codes + per-block scales), stacked field by field across the blocks.

Quantized records are decoded by the port's own codec (quant/blocks.py),
through its TensorRecord.as_f32. `params_from_jax`
turns the JAX package's tree (dense arrays, QuantLinear and Int8Linear
leaves) into this one, so the tests can run both packages on the same
weights.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from vit_cpp_tpu_torch.gguf.reader import ModelFile, TensorRecord
from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.quant import qlinear
from vit_cpp_tpu_torch.quant.int8 import Int8Linear
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear


def infer_family_hparams(hp: VitHParams, tensors) -> VitHParams:
    """Family extensions declared by tensor presence rather than by the
    file's hparam block (vit_cpp_tpu/engine.py::detect_hparams and
    models/params.py::load_params infer them the same way). MoE and
    attention-pooled checkpoints raise: this package does not run them."""
    h = hp.hidden_size
    if any(re.fullmatch(r"blocks\.\d+\.moe\.router\.weight", n) for n in tensors):
        raise NotImplementedError(
            "V-MoE checkpoints are not ported to vit_cpp_tpu_torch yet; "
            "they come with the V-MoE slice (ops/moe.py)"
        )
    if "attn_pool.probe" in tensors:
        raise NotImplementedError(
            "attention-pooled (SigLIP, global_pool='map') checkpoints are "
            "not ported to vit_cpp_tpu_torch yet; they come with the "
            "model-families slice (attention_pool)"
        )
    fc1 = tensors.get("blocks.0.mlp.fc1.weight")
    if (
        hp.num_hidden_layers > 0
        and hp.mlp_hidden is None
        and fc1 is not None
        and len(fc1.shape) == 2
        and fc1.shape[1] == h
        and fc1.shape[0] != hp.mlp_dim
    ):
        hp = dataclasses.replace(hp, mlp_hidden=int(fc1.shape[0]))
    if "dist_token" in tensors and hp.num_prefix_tokens == 1:
        hp = dataclasses.replace(hp, num_prefix_tokens=2)
    if "cls_token" not in tensors and hp.num_prefix_tokens == 1:
        hp = dataclasses.replace(hp, num_prefix_tokens=0)
    if "norm_pre.weight" in tensors and not hp.norm_pre:
        hp = dataclasses.replace(hp, norm_pre=True)
    reg = tensors.get("reg_token")
    if reg is not None and not hp.num_reg_tokens:
        hp = dataclasses.replace(hp, num_reg_tokens=int(np.prod(reg.shape)) // h)
    if "head.weight" not in tensors and hp.num_classes:
        raise ValueError(
            f"header declares {hp.num_classes} classes but head.weight "
            "is missing — truncated or mis-converted checkpoint "
            "(headless encoders are written with num_classes=0)"
        )
    if "fc_norm.weight" in tensors:
        if "norm.weight" in tensors:
            raise ValueError(
                "checkpoint has both norm.weight and fc_norm.weight — "
                "timm ViTs carry exactly one (the other is Identity)"
            )
        hp = dataclasses.replace(hp, global_pool="avg")
    if "meta.clip" in tensors and hp.hidden_act != "quick_gelu":
        hp = dataclasses.replace(
            hp, hidden_act="quick_gelu", pixel_norm="clip", eps=1e-5
        )
    pos = tensors.get("pos_embed")
    if pos is not None and hp.n_prefix and not hp.no_embed_class:
        if int(np.prod(pos.shape)) // h == hp.n_patches:
            hp = dataclasses.replace(hp, no_embed_class=True)
    if hp.global_pool == "avg" and hp.num_prefix_tokens == 2:
        raise ValueError(
            "distilled checkpoints are token-pooled; fc_norm + dist_token "
            "is not a timm configuration"
        )
    if hp.num_prefix_tokens == 0 and hp.global_pool != "avg":
        raise ValueError(
            "checkpoint has no cls_token and no fc_norm — nothing to pool"
        )
    return hp


class _RecordSet:
    """Name- and shape-checked access to the file's records; every record
    must be used."""

    def __init__(self, tensors: Dict[str, TensorRecord], dtype, device):
        self.tensors = dict(tensors)
        self.used = set()
        self.dtype = dtype
        self.device = device

    def rec(self, name: str) -> TensorRecord:
        if name not in self.tensors:
            raise ValueError(f"checkpoint missing tensor '{name}'")
        self.used.add(name)
        return self.tensors[name]

    def f32(self, name: str) -> np.ndarray:
        """A record as f32 in torch order (a quantized one decoded by the
        port's codec)."""
        return self.rec(name).as_f32()

    def tensor(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        return t.to(device=self.device, dtype=dtype or self.dtype)

    def dense(self, name: str, shape: tuple, dtype=None) -> torch.Tensor:
        return self.tensor(self.f32(name).reshape(shape), dtype)

    def kernel(self, name: str, out_f: int, in_f: int):
        """2-D linear weight -> (in, out) dense kernel or QuantLinear."""
        r = self.rec(name)
        if r.shape != (out_f, in_f):
            raise ValueError(
                f"tensor '{name}': shape {r.shape} != expected {(out_f, in_f)}"
            )
        if r.dtype.is_quantized:
            return qlinear.quant_linear_from_record(r, device=self.device)
        return self.tensor(r.as_f32().T)

    def check_all_used(self):
        unused = set(self.tensors) - self.used
        if unused:
            raise ValueError(f"unexpected tensors in checkpoint: {sorted(unused)}")


def load_params(
    mf: ModelFile,
    dtype=torch.float32,
    hparams: Optional[VitHParams] = None,
    device="cpu",
) -> Dict[str, Any]:
    """Build the forward pass's parameter tree from a parsed model file.
    `dtype` is the storage dtype of the weights (f32 for parity, bf16 for
    serving)."""
    hp = infer_family_hparams(hparams or mf.hparams, mf.tensors)
    h, L = hp.hidden_size, hp.num_hidden_layers
    rs = _RecordSet(mf.tensors, dtype, device)
    if "meta.clip" in mf.tensors:
        rs.rec("meta.clip")  # the marker's value is unused

    pe = rs.rec("patch_embed.proj.weight")
    expect_pe = (h, hp.in_chans, hp.patch_size, hp.patch_size)
    if pe.shape != expect_pe:
        raise ValueError(f"patch_embed.proj.weight: shape {pe.shape} != {expect_pe}")
    params: Dict[str, Any] = {
        "pos_embed": rs.dense("pos_embed", (hp.n_pos_tokens, h)),
        "patch_embed": {
            "kernel": rs.tensor(rs.f32(pe.name).reshape(h, -1).T),
            "bias": rs.dense("patch_embed.proj.bias", (h,)),
        },
    }
    if hp.num_prefix_tokens >= 1:
        params["cls_token"] = rs.dense("cls_token", (h,))
    if hp.num_prefix_tokens == 2:
        params["dist_token"] = rs.dense("dist_token", (h,))
    if hp.num_reg_tokens:
        params["reg_token"] = rs.dense("reg_token", (hp.num_reg_tokens, h))
    if hp.norm_pre:
        params["norm_pre"] = {
            "scale": rs.dense("norm_pre.weight", (h,)),
            "bias": rs.dense("norm_pre.bias", (h,)),
        }

    def stacked(fn):
        leaves = [fn(f"blocks.{i}.") for i in range(L)]
        if isinstance(leaves[0], QuantLinear):
            return qlinear.stack(leaves)
        return torch.stack(leaves)

    m = hp.mlp_dim
    params["blocks"] = {
        "ln1": {
            "scale": stacked(lambda p: rs.dense(p + "norm1.weight", (h,))),
            "bias": stacked(lambda p: rs.dense(p + "norm1.bias", (h,))),
        },
        "qkv": {
            "kernel": stacked(lambda p: rs.kernel(p + "attn.qkv.weight", 3 * h, h)),
            "bias": stacked(lambda p: rs.dense(p + "attn.qkv.bias", (3 * h,))),
        },
        "proj": {
            "kernel": stacked(lambda p: rs.kernel(p + "attn.proj.weight", h, h)),
            "bias": stacked(lambda p: rs.dense(p + "attn.proj.bias", (h,))),
        },
        "ln2": {
            "scale": stacked(lambda p: rs.dense(p + "norm2.weight", (h,))),
            "bias": stacked(lambda p: rs.dense(p + "norm2.bias", (h,))),
        },
        "fc1": {
            "kernel": stacked(lambda p: rs.kernel(p + "mlp.fc1.weight", m, h)),
            "bias": stacked(lambda p: rs.dense(p + "mlp.fc1.bias", (m,))),
        },
        "fc2": {
            "kernel": stacked(lambda p: rs.kernel(p + "mlp.fc2.weight", h, m)),
            "bias": stacked(lambda p: rs.dense(p + "mlp.fc2.bias", (h,))),
        },
    }
    norm_name = "fc_norm" if hp.global_pool == "avg" else "norm"
    params["norm"] = {
        "scale": rs.dense(norm_name + ".weight", (h,)),
        "bias": rs.dense(norm_name + ".bias", (h,)),
    }
    for name in ("head", "head_dist") if hp.num_prefix_tokens == 2 else ("head",):
        if hp.num_classes:
            params[name] = {
                "kernel": rs.kernel(name + ".weight", hp.num_classes, h),
                "bias": rs.dense(name + ".bias", (hp.num_classes,)),
            }
    rs.check_all_used()
    return params


def _leaf_tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: widen exactly, narrow back
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def params_from_jax(tree, device="cpu"):
    """The JAX package's parameter tree (arrays, numpy arrays, QuantLinear
    and Int8Linear leaves; dicts and None) -> this package's tree on
    `device`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if hasattr(tree, "qtype"):  # QuantLinear
        return QuantLinear(
            codes=_leaf_tensor(tree.codes, device),
            scales=_leaf_tensor(tree.scales, device),
            mins=None if tree.mins is None else _leaf_tensor(tree.mins, device),
            qtype=int(tree.qtype),
        )
    if hasattr(tree, "codes") and hasattr(tree, "scale"):  # Int8Linear
        return Int8Linear(
            codes=_leaf_tensor(tree.codes, device),
            scale=_leaf_tensor(tree.scale, device),
            act_scale=(
                None if tree.act_scale is None
                else _leaf_tensor(tree.act_scale, device)
            ),
        )
    return _leaf_tensor(tree, device)
