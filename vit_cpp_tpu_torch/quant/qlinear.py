"""QuantLinear: a packed block-quantized weight matrix, as torch tensors.

Counterpart of vit_cpp_tpu/quant/qlinear.py. The params loader builds one
for every 2-D `.*weight` record stored in a ggml block format; the linears
consume it through ops/qmatmul.py (dequantize-inside-matmul) or requantize
it to channelwise int8 (quant/int8.py::from_quant_linear).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vit_cpp_tpu_torch.gguf.dtypes import QK, GGMLDType
from vit_cpp_tpu_torch.gguf.reader import TensorRecord
from vit_cpp_tpu_torch.quant.blocks import CODE_OFFSET, unpack_soa


@dataclasses.dataclass
class QuantLinear:
    """A block-quantized weight in matmul orientation, as the JAX pytree
    keeps it (the on-disk blocks run along the torch (out, in) contiguous
    axis; here everything is (in, out) so the forward computes `x @ w`):

      codes:  ([L,] in, out)        int8  (Q8_0 signed; Q4/Q5 codes 0..15/0..31)
      scales: ([L,] in // 32, out)  f32
      mins:   ([L,] in // 32, out)  f32   (Q4_1/Q5_1 only, else None)

    w = (codes - offset) * scale [+ min], with offset 8 for Q4_0, 16 for
    Q5_0 and 0 otherwise."""

    codes: torch.Tensor
    scales: torch.Tensor
    mins: Optional[torch.Tensor] = None
    qtype: int = int(GGMLDType.Q8_0)

    @property
    def offset(self) -> int:
        return CODE_OFFSET[GGMLDType(self.qtype)]

    @property
    def out_features(self) -> int:
        return self.codes.shape[-1]

    @property
    def in_features(self) -> int:
        return self.codes.shape[-2]

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """The dense ([L,] in, out) kernel: f32 arithmetic, then `dtype`."""
        c = self.codes.float()
        if self.offset:
            c = c - self.offset
        w = c * self.scales.repeat_interleave(QK, dim=-2)
        if self.mins is not None:
            w = w + self.mins.repeat_interleave(QK, dim=-2)
        return w.to(dtype)

    def __getitem__(self, i) -> "QuantLinear":
        """Layer i of a stacked ([L,] ...) leaf."""
        return QuantLinear(
            codes=self.codes[i],
            scales=self.scales[i],
            mins=None if self.mins is None else self.mins[i],
            qtype=self.qtype,
        )


def stack(leaves) -> QuantLinear:
    """L per-layer QuantLinears -> one stacked ([L,] ...) leaf."""
    first = leaves[0]
    return QuantLinear(
        codes=torch.stack([l.codes for l in leaves]),
        scales=torch.stack([l.scales for l in leaves]),
        mins=None if first.mins is None else torch.stack([l.mins for l in leaves]),
        qtype=first.qtype,
    )


def quant_linear_from_record(rec: TensorRecord, device="cpu") -> QuantLinear:
    """A quantized 2-D (out, in) record -> QuantLinear on `device`, with
    the blocks transposed to (in, out) as the JAX loader does."""
    out_f, in_f = rec.shape
    want = rec.dtype.row_bytes(rec.n_elements)
    if rec.data.nbytes != want:
        raise ValueError(
            f"tensor '{rec.name}': {rec.data.nbytes} bytes of {rec.dtype.name} "
            f"data, expected {want} for shape {rec.shape}"
        )
    soa = unpack_soa(rec.data, rec.n_elements, rec.dtype)

    def put(a: np.ndarray, shape) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a.reshape(shape).T)).to(device)

    mins = soa.get("m")
    return QuantLinear(
        codes=put(soa["codes"].astype(np.int8), (out_f, in_f)),
        scales=put(soa["d"], (out_f, in_f // QK)),
        mins=None if mins is None else put(mins, (out_f, in_f // QK)),
        qtype=int(rec.dtype),
    )
