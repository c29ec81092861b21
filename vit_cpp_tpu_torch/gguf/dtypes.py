"""ggml dtype / ftype enumeration for the legacy ggml model file format
(the port's own copy of vit_cpp_tpu/gguf/dtypes.py).

The reference stores a file-level ``ftype`` and a per-tensor-record type int
with the same numbering (SURVEY.md §2.2; reference vit.cpp:384-414,
quantize.cpp:36-58):

    0 = F32, 1 = F16, 2 = Q4_0, 3 = Q4_1, 6 = Q5_0, 7 = Q5_1, 8 = Q8_0

Quantized types are block formats over QK=32 contiguous elements of the
fastest-moving (input-feature) dimension. Byte sizes per block follow the
public ggml block layouts (f16 scale [+ f16 min] [+ 4B high bits] + packed
quants).
"""

from __future__ import annotations

import enum

GGML_FILE_MAGIC = 0x67676D6C  # 'ggml' (convert-pth-to-ggml.py:33, vit.cpp:320)
GGML_QNT_VERSION = 2
GGML_QNT_VERSION_FACTOR = 1000  # vit.cpp:343-354

QK = 32  # quantization block size (elements per block)


class GGMLDType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8

    @property
    def is_quantized(self) -> bool:
        return self not in (GGMLDType.F32, GGMLDType.F16)

    @property
    def block_size(self) -> int:
        """Elements per block (1 for float types)."""
        return QK if self.is_quantized else 1

    @property
    def type_size(self) -> int:
        """Bytes per block (per element for float types)."""
        return _TYPE_SIZES[self]

    def row_bytes(self, n_elements: int) -> int:
        """Bytes for `n_elements` contiguous elements of this dtype."""
        bs = self.block_size
        if n_elements % bs != 0:
            raise ValueError(
                f"{self.name}: element count {n_elements} not a multiple of "
                f"block size {bs}"
            )
        return (n_elements // bs) * self.type_size


_TYPE_SIZES = {
    GGMLDType.F32: 4,
    GGMLDType.F16: 2,
    GGMLDType.Q4_0: 2 + QK // 2,           # f16 d + 16B nibbles        = 18
    GGMLDType.Q4_1: 2 + 2 + QK // 2,       # f16 d + f16 m + nibbles    = 20
    GGMLDType.Q5_0: 2 + 4 + QK // 2,       # f16 d + u32 qh + nibbles   = 22
    GGMLDType.Q5_1: 2 + 2 + 4 + QK // 2,   # f16 d + f16 m + qh + qs    = 24
    GGMLDType.Q8_0: 2 + QK,                # f16 d + 32 x i8            = 34
}

# itype CLI values accepted by the quantize tool (quantize.cpp:36-58).
QUANT_ITYPES = {
    2: GGMLDType.Q4_0,
    3: GGMLDType.Q4_1,
    6: GGMLDType.Q5_0,
    7: GGMLDType.Q5_1,
    8: GGMLDType.Q8_0,
}

FTYPE_NAMES = {
    GGMLDType.F32: "f32",
    GGMLDType.F16: "f16",
    GGMLDType.Q4_0: "q4_0",
    GGMLDType.Q4_1: "q4_1",
    GGMLDType.Q5_0: "q5_0",
    GGMLDType.Q5_1: "q5_1",
    GGMLDType.Q8_0: "q8_0",
}
