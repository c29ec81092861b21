"""Export a parameter tree back to the model file format.

Counterpart of vit_cpp_tpu/models/export.py for this package's trees: the
(possibly fine-tuned) forward-pass tree goes back to the reference
tensor-name schema and is written through the port's copies of
`testing.synthetic.state_dict_records` and `gguf.writer.write_model`, so
the same weights give the same file bytes as the JAX package's
`save_params`. QuantLinear leaves are
dequantized to f32 by this package's codec (re-quantize the output with
cli/quantize.py). The families this package loads are covered: plain,
distilled (dist_token + head_dist), registers, norm_pre, avg pooling,
CLIP, SigLIP's attention pooling (attn_pool) and V-MoE (router and
experts per MoE layer, the `meta.moe` marker; the writer keeps routers
f32 at ftype 1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from vit_cpp_tpu_torch.gguf.writer import write_model
from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.testing.synthetic import state_dict_records
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear


def _np(x) -> np.ndarray:
    if isinstance(x, QuantLinear):
        x = x.dequantize()
    return x.detach().to("cpu", torch.float32).numpy()


def _kernel_to_torch(kernel) -> np.ndarray:
    """(in, out) tree kernel -> torch-order (out, in) f32."""
    return _np(kernel).T


def params_to_state_dict(params: Dict[str, Any], hp: VitHParams) -> Dict[str, np.ndarray]:
    """Forward-pass tree -> reference-schema torch-order state dict, in the
    JAX package's tensor order."""
    h = hp.hidden_size
    pos = _np(params["pos_embed"])
    out: Dict[str, np.ndarray] = {
        "pos_embed": pos.reshape(1, pos.shape[-2], h),
        # the tree stores the flattened (c*p*p, h) matmul kernel; the file
        # the conv layout (h, c, p, p)
        "patch_embed.proj.weight": _np(params["patch_embed"]["kernel"])
        .T.reshape(h, hp.in_chans, hp.patch_size, hp.patch_size),
        "patch_embed.proj.bias": _np(params["patch_embed"]["bias"]).reshape(1, h, 1, 1),
    }
    if "head" in params:
        out["head.weight"] = _kernel_to_torch(params["head"]["kernel"])
        out["head.bias"] = _np(params["head"]["bias"])
    if "cls_token" in params:
        out["cls_token"] = _np(params["cls_token"]).reshape(1, 1, h)
    if "reg_token" in params:
        reg = _np(params["reg_token"])
        out["reg_token"] = reg.reshape(1, reg.shape[-2], h)
    # avg-pool trees hold fc_norm in the 'norm' slot (models/params.py)
    norm_name = "fc_norm" if hp.global_pool == "avg" else "norm"
    out[norm_name + ".weight"] = _np(params["norm"]["scale"])
    out[norm_name + ".bias"] = _np(params["norm"]["bias"])
    if "norm_pre" in params:
        out["norm_pre.weight"] = _np(params["norm_pre"]["scale"])
        out["norm_pre.bias"] = _np(params["norm_pre"]["bias"])
    if "dist_token" in params:
        out["dist_token"] = _np(params["dist_token"]).reshape(1, 1, h)
    if "head_dist" in params:
        out["head_dist.weight"] = _kernel_to_torch(params["head_dist"]["kernel"])
        out["head_dist.bias"] = _np(params["head_dist"]["bias"])
    if hp.hidden_act == "quick_gelu":
        # CLIP family marker: hparams no tensor's presence can declare
        out["meta.clip"] = np.ones((1,), np.float32)
    if "attn_pool" in params:  # SigLIP attention pooling
        ap = params["attn_pool"]
        out["attn_pool.probe"] = _np(ap["probe"]).reshape(1, 1, h)
        for file_name, leaf in (("qkv", ap["qkv"]), ("proj", ap["proj"]), ("norm", ap["norm"]),
                                ("mlp.fc1", ap["fc1"]), ("mlp.fc2", ap["fc2"])):
            out[f"attn_pool.{file_name}.weight"] = (
                _np(leaf["scale"]) if file_name == "norm" else _kernel_to_torch(leaf["kernel"]))
            out[f"attn_pool.{file_name}.bias"] = _np(leaf["bias"])
    if "moe" in params:
        from vit_cpp_tpu_torch.models.vit import moe_layer_params

        layers = moe_layer_params(params, hp)
    else:
        blocks = params["blocks"]
        layers = [({k: {n: leaf[i] for n, leaf in blocks[k].items()} for k in blocks}, None)
                  for i in range(hp.num_hidden_layers)]
    for i, (bp, mp) in enumerate(layers):
        p = f"blocks.{i}."
        out.update(
            {
                p + "norm1.weight": _np(bp["ln1"]["scale"]),
                p + "norm1.bias": _np(bp["ln1"]["bias"]),
                p + "attn.qkv.weight": _kernel_to_torch(bp["qkv"]["kernel"]),
                p + "attn.qkv.bias": _np(bp["qkv"]["bias"]),
                p + "attn.proj.weight": _kernel_to_torch(bp["proj"]["kernel"]),
                p + "attn.proj.bias": _np(bp["proj"]["bias"]),
                p + "norm2.weight": _np(bp["ln2"]["scale"]),
                p + "norm2.bias": _np(bp["ln2"]["bias"]),
            }
        )
        if mp is not None:
            # the router torch-order (E, h) like every linear weight
            out[p + "moe.router.weight"] = _kernel_to_torch(mp["router"]["kernel"])
            for ex in range(hp.num_experts):
                ep = f"{p}moe.experts.{ex}."
                out[ep + "fc1.weight"] = _kernel_to_torch(mp["fc1"]["kernel"][ex])
                out[ep + "fc1.bias"] = _np(mp["fc1"]["bias"][ex])
                out[ep + "fc2.weight"] = _kernel_to_torch(mp["fc2"]["kernel"][ex])
                out[ep + "fc2.bias"] = _np(mp["fc2"]["bias"][ex])
            continue
        out.update(
            {
                p + "mlp.fc1.weight": _kernel_to_torch(bp["fc1"]["kernel"]),
                p + "mlp.fc1.bias": _np(bp["fc1"]["bias"]),
                p + "mlp.fc2.weight": _kernel_to_torch(bp["fc2"]["kernel"]),
                p + "mlp.fc2.bias": _np(bp["fc2"]["bias"]),
            }
        )
    if "moe" in params:
        # the V-MoE marker: top_k and capacity by value (models/params.py
        # reads them back; the layers are declared by tensor presence)
        out["meta.moe"] = np.asarray([hp.moe_top_k, hp.moe_capacity], np.float32)
    return out


def save_params(
    path: str,
    params: Dict[str, Any],
    hp: VitHParams,
    id2label: Optional[Dict[int, str]] = None,
    ftype: int = 1,
) -> None:
    """Write the tree as a model file (ftype 0=f32, 1=f16 dtype rules)."""
    state = params_to_state_dict(params, hp)
    if id2label is None:
        id2label = {i: f"LABEL_{i}" for i in range(hp.num_classes)}
    write_model(path, hp, id2label, state_dict_records(state, ftype), ftype)
