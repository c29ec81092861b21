"""Channelwise int8 weights for the W8A8 serving path.

Counterpart of vit_cpp_tpu/quant/int8.py. A dense (in, out) weight is
requantized once at load to per-output-channel scales,

    w[k, n] ~= codes[k, n] * scale[n]        codes int8, scale f32

so each linear runs as one int8 x int8 -> int32 product with a rank-1
epilogue (ops/int8_matmul.py). Block-quantized (QuantLinear) leaves are
requantized the same way, from their dequantized f32 weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from vit_cpp_tpu_torch.quant.qlinear import QuantLinear


@dataclasses.dataclass
class Int8Linear:
    """codes: ([L,] in, out) int8; scale: ([L,] out) f32; w = codes * scale.

    act_scale: a static ([L,] 1, 1) f32 activation scale from calibration
    (quant/calibrate.py) or a sidecar (quant/qat.py::load_act_scales):
    the input quantizes as round(clip(x / act_scale, -127, 127)) with no
    per-token absmax. None: dynamic per-token scales."""

    codes: torch.Tensor
    scale: torch.Tensor
    act_scale: Optional[torch.Tensor] = None

    @property
    def in_features(self) -> int:
        return self.codes.shape[-2]

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.codes.float() * self.scale[..., None, :]).to(dtype)

    def __getitem__(self, i) -> "Int8Linear":
        """Layer i of a stacked ([L,] ...) leaf."""
        return Int8Linear(
            codes=self.codes[i],
            scale=self.scale[i],
            act_scale=None if self.act_scale is None else self.act_scale[i],
        )


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, a true division on every device: PyTorch's CUDA kernels
    divide by a Python scalar through its reciprocal, which can round one
    ulp away from the quotient the CPU and the JAX package compute (and a
    scale an ulp off moves the codes that lie on a rounding boundary)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def channelwise_int8(w: torch.Tensor, mesh=None) -> Int8Linear:
    """Quantize a dense ([L,] in, out) weight to per-output-channel int8;
    with `mesh`, w is this rank's rows and the channel absmax the maximum
    over the mesh's "model" axis."""
    from vit_cpp_tpu_torch.parallel.mesh import max_over

    wf = w.float()
    absmax = max_over(wf.abs().amax(dim=-2, keepdim=True), mesh)
    scale = true_div(absmax, 127.0)
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    codes = torch.clamp(torch.round(wf * inv), -127, 127).to(torch.int8)
    return Int8Linear(codes=codes, scale=scale[..., 0, :])


def from_quant_linear(ql: QuantLinear) -> Int8Linear:
    """Requantize block-scaled codes to channelwise int8 (once, at load)."""
    return channelwise_int8(ql.dequantize(torch.float32))


def _to_int8(k):
    if isinstance(k, Int8Linear):
        return k
    if isinstance(k, QuantLinear):
        return from_quant_linear(k)
    return channelwise_int8(k)


def convert_params_to_int8(params: Dict[str, Any]) -> Dict[str, Any]:
    """Rewrite a parameter tree for W8A8 serving: the block linears
    (qkv, proj, fc1, fc2) and the head(s), dense or QuantLinear, become
    Int8Linear; the patch embedding, biases and norms stay in the float
    path, and so do a V-MoE tree's router and experts (the "moe" subtree,
    dense in the activation dtype, as in the JAX package)."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name in ("qkv", "proj", "fc1", "fc2"):
        leaf = dict(blocks[name])
        leaf["kernel"] = _to_int8(leaf["kernel"])
        blocks[name] = leaf
    out["blocks"] = blocks
    for name in ("head", "head_dist"):
        if name in params:
            head = dict(params[name])
            head["kernel"] = _to_int8(head["kernel"])
            out[name] = head
    return out


def params_have_static_scales(params: Dict[str, Any]) -> bool:
    """True when any Int8Linear leaf carries a static activation scale:
    the tree serves the static W8A8 path (vit_cpp_tpu/quant/int8.py:114)."""
    if isinstance(params, Int8Linear):
        return params.act_scale is not None
    if isinstance(params, dict):
        return any(params_have_static_scales(v) for v in params.values())
    return False
