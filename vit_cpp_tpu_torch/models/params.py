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

from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType
from vit_cpp_tpu_torch.gguf.reader import ModelFile, TensorRecord
from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.quant import qlinear
from vit_cpp_tpu_torch.quant.int8 import Int8Linear
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear


def infer_family_hparams(hp: VitHParams, tensors) -> VitHParams:
    """Family extensions declared by tensor presence rather than by the
    file's hparam block (vit_cpp_tpu/engine.py::detect_hparams and
    models/params.py::load_params infer them the same way), with the JAX
    loader's checks of the combinations no checkpoint family has. An
    `attn_pool.probe` declares SigLIP attention pooling with [-1, 1]
    pixels; `blocks.{i}.moe.*` tensors declare V-MoE layers
    (`infer_moe_hparams`)."""
    h = hp.hidden_size
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
    if "attn_pool.probe" in tensors and hp.global_pool != "map":
        hp = dataclasses.replace(hp, global_pool="map", pixel_norm="unit")
    if "meta.clip" in tensors and hp.hidden_act != "quick_gelu":
        hp = dataclasses.replace(
            hp, hidden_act="quick_gelu", pixel_norm="clip", eps=1e-5
        )
    pos = tensors.get("pos_embed")
    if pos is not None and hp.n_prefix and not hp.no_embed_class:
        if int(np.prod(pos.shape)) // h == hp.n_patches:
            hp = dataclasses.replace(hp, no_embed_class=True)
    for bad, msg in (
        (hp.num_prefix_tokens == 2 and hp.seq_len is not None,
         "distilled checkpoints (dist_token) cannot carry a ViTSTR sequence "
         "head — the distillation token would shift the seq_len readout window"),
        (hp.global_pool == "avg" and hp.seq_len is not None,
         "avg-pool checkpoints (fc_norm) cannot carry a ViTSTR sequence head "
         "— the readout needs per-token rows"),
        (hp.global_pool == "avg" and hp.num_prefix_tokens == 2,
         "distilled checkpoints are token-pooled; fc_norm + dist_token is "
         "not a timm configuration"),
        (hp.num_prefix_tokens == 0 and hp.global_pool not in ("avg", "map"),
         "checkpoint has no cls_token and no fc_norm — nothing to pool"),
        (hp.global_pool == "map" and hp.seq_len is not None,
         "attention-pooled checkpoints (attn_pool) cannot carry a ViTSTR "
         "sequence head — the probe collapses the token axis"),
        (hp.global_pool == "map" and hp.num_prefix_tokens == 2,
         "distilled checkpoints are token-pooled; attn_pool + dist_token is "
         "not a supported configuration"),
        (hp.num_reg_tokens and hp.num_prefix_tokens == 2,
         "reg_token + dist_token is not a timm configuration (registers "
         "pair with plain or avg-pool ViTs)"),
        (hp.num_reg_tokens and hp.seq_len is not None,
         "register tokens would shift the ViTSTR seq_len readout window — "
         "not a supported combination"),
        (hp.num_classes == 0 and hp.seq_len is not None,
         "sequence-head checkpoints cannot be headless (the head IS the decoder)"),
    ):
        if bad:
            raise ValueError(msg)
    return infer_moe_hparams(hp, tensors)


def infer_moe_hparams(hp: VitHParams, tensors) -> VitHParams:
    """V-MoE family inference (vit_cpp_tpu/models/params.py::
    infer_moe_hparams): the MoE layers are those with a
    blocks.{i}.moe.router.weight, the expert count comes from the
    per-expert tensor names, and top_k/capacity from the VALUES of the
    `meta.moe` marker. An hp that already declares experts is kept."""
    moe_layers = sorted(
        int(m.group(1))
        for name in tensors
        if (m := re.fullmatch(r"blocks\.(\d+)\.moe\.router\.weight", name))
    )
    if not moe_layers or hp.num_experts:
        return hp
    l0 = moe_layers[0]
    n_exp = sum(
        1 for n in tensors if re.fullmatch(rf"blocks\.{l0}\.moe\.experts\.\d+\.fc1\.weight", n)
    )
    if n_exp < 2:
        raise ValueError(f"MoE layer {l0} declares {n_exp} experts — need >= 2")
    meta = tensors.get("meta.moe")
    if meta is None:
        raise ValueError(
            "checkpoint has blocks.*.moe tensors but no meta.moe "
            "marker (top_k/capacity) — truncated or mis-converted"
        )
    mv = meta.as_f32().reshape(-1)
    if mv.size != 2:
        raise ValueError(f"meta.moe must hold [top_k, capacity], got {mv.size} values")
    hp = dataclasses.replace(
        hp, num_experts=n_exp, moe_layers=tuple(moe_layers),
        moe_top_k=int(mv[0]), moe_capacity=float(mv[1]),
    )
    if not 1 <= hp.moe_top_k <= n_exp:
        raise ValueError(f"meta.moe top_k {hp.moe_top_k} not in [1, {n_exp}]")
    if hp.moe_capacity <= 0:
        raise ValueError(f"meta.moe capacity {hp.moe_capacity} <= 0")
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
    serving).

    A V-MoE file adds a "moe" subtree stacked over its MoE layers: the
    router (h, E) in f32 whatever the file stores, the experts' fc1/fc2
    dense in `dtype` (a block-quantized expert is dequantized here, as the
    JAX loader does). blocks.fc1/fc2 then stack over the dense-MLP layers
    only (leading dimension L - Lm)."""
    hp = infer_family_hparams(hparams or mf.hparams, mf.tensors)
    h, L = hp.hidden_size, hp.num_hidden_layers
    if hp.num_experts and len(hp.moe_layers) >= L:
        raise ValueError(
            "every-layer MoE is not supported — at least one dense-MLP "
            "layer is required (V-MoE places experts in alternate blocks)"
        )
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

    moe_layers = sorted(hp.moe_layers) if hp.num_experts else []
    dense_layers = [i for i in range(L) if i not in moe_layers]

    def stacked(fn, layers=range(L)):
        leaves = [fn(f"blocks.{i}.") for i in layers]
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
            "kernel": stacked(lambda p: rs.kernel(p + "mlp.fc1.weight", m, h), dense_layers),
            "bias": stacked(lambda p: rs.dense(p + "mlp.fc1.bias", (m,)), dense_layers),
        },
        "fc2": {
            "kernel": stacked(lambda p: rs.kernel(p + "mlp.fc2.weight", h, m), dense_layers),
            "bias": stacked(lambda p: rs.dense(p + "mlp.fc2.bias", (h,)), dense_layers),
        },
    }
    if moe_layers:
        e = hp.num_experts

        def expert_kernels(p, name, shape):
            """(E, in, out) dense, from E torch-order (out, in) records."""
            per = []
            for ex in range(e):
                r = rs.rec(f"{p}moe.experts.{ex}.{name}.weight")
                if r.shape != shape:
                    raise ValueError(f"tensor '{r.name}': shape {r.shape} != {shape}")
                per.append(rs.tensor(r.as_f32().T))
            return torch.stack(per)

        def expert_biases(p, name, n):
            return torch.stack([rs.dense(f"{p}moe.experts.{ex}.{name}.bias", (n,))
                                for ex in range(e)])

        def router(p):
            r = rs.rec(p + "moe.router.weight")
            if r.shape != (e, h):
                raise ValueError(f"tensor '{r.name}': shape {r.shape} != {(e, h)}")
            # f32 whatever the file stores (the top-k is argmax-fragile)
            return rs.tensor(r.as_f32().T, torch.float32)

        params["moe"] = {
            "router": {"kernel": stacked(router, moe_layers)},
            "fc1": {
                "kernel": stacked(lambda p: expert_kernels(p, "fc1", (m, h)), moe_layers),
                "bias": stacked(lambda p: expert_biases(p, "fc1", m), moe_layers),
            },
            "fc2": {
                "kernel": stacked(lambda p: expert_kernels(p, "fc2", (h, m)), moe_layers),
                "bias": stacked(lambda p: expert_biases(p, "fc2", h), moe_layers),
            },
        }
        if "meta.moe" in rs.tensors:
            rs.rec("meta.moe")  # its values are in hp already
    norm_name = "fc_norm" if hp.global_pool == "avg" else "norm"
    params["norm"] = {
        "scale": rs.dense(norm_name + ".weight", (h,)),
        "bias": rs.dense(norm_name + ".bias", (h,)),
    }
    if hp.global_pool == "map":
        # SigLIP's attention-pooling head (models/vit.py::attention_pool);
        # its kernels load like block kernels (dense or QuantLinear)
        params["attn_pool"] = {
            "probe": rs.dense("attn_pool.probe", (h,)),
            "qkv": {
                "kernel": rs.kernel("attn_pool.qkv.weight", 3 * h, h),
                "bias": rs.dense("attn_pool.qkv.bias", (3 * h,)),
            },
            "proj": {
                "kernel": rs.kernel("attn_pool.proj.weight", h, h),
                "bias": rs.dense("attn_pool.proj.bias", (h,)),
            },
            "norm": {
                "scale": rs.dense("attn_pool.norm.weight", (h,)),
                "bias": rs.dense("attn_pool.norm.bias", (h,)),
            },
            "fc1": {
                "kernel": rs.kernel("attn_pool.mlp.fc1.weight", m, h),
                "bias": rs.dense("attn_pool.mlp.fc1.bias", (m,)),
            },
            "fc2": {
                "kernel": rs.kernel("attn_pool.mlp.fc2.weight", h, m),
                "bias": rs.dense("attn_pool.mlp.fc2.bias", (h,)),
            },
        }
    for name in ("head", "head_dist") if hp.num_prefix_tokens == 2 else ("head",):
        if hp.num_classes:
            params[name] = {
                "kernel": rs.kernel(name + ".weight", hp.num_classes, h),
                "bias": rs.dense(name + ".bias", (hp.num_classes,)),
            }
    rs.check_all_used()
    return params


def params_from_state_dict(
    state: Dict[str, np.ndarray], hp: VitHParams, dtype=torch.float32, device="cpu"
) -> Dict[str, Any]:
    """Build params directly from an f32 state dict, with no file between
    (testing/synthetic.py::random_state_dict; vit_cpp_tpu/models/params.py::
    params_from_state_dict), on `device`."""
    tensors = {
        name: TensorRecord(name, arr.shape, GGMLDType.F32, arr.astype(np.float32))
        for name, arr in state.items()
    }
    mf = ModelFile(hparams=hp, id2label={}, tensors=tensors)
    return load_params(mf, dtype=dtype, hparams=hp, device=device)


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
