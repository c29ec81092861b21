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

    act_scale: a static activation scale from calibration, or None for
    dynamic per-token scales (the only form this package serves yet)."""

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


def channelwise_int8(w: torch.Tensor) -> Int8Linear:
    """Quantize a dense ([L,] in, out) weight to per-output-channel int8."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = absmax / 127.0
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
    Int8Linear; the patch
    embedding, biases and norms stay in the float path."""
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
