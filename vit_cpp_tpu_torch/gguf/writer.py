"""Writer for the legacy-ggml model file format.

Byte-exact producer of the format described in SURVEY.md §2.3 (reference
producers: convert-pth-to-ggml.py:106-158 for f32/f16 files, quantize.cpp for
quantized rewrites). The port's own copy of vit_cpp_tpu/gguf/writer.py,
used by its exporter, its synthetic checkpoints and its quantize tool.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, Tuple, Union

import numpy as np

from vit_cpp_tpu_torch.gguf.dtypes import GGML_FILE_MAGIC, GGMLDType
from vit_cpp_tpu_torch.hparams import VitHParams

_I32 = struct.Struct("<i")

# (name, torch-order shape, dtype, payload). Payload is an f32/f16 ndarray for
# float dtypes or a packed block byte buffer for quantized dtypes.
TensorItem = Tuple[str, tuple, GGMLDType, Union[np.ndarray, bytes]]


def write_header(f, hparams: VitHParams, id2label: Dict[int, str], ftype: int):
    f.write(_I32.pack(GGML_FILE_MAGIC))
    for v in (
        hparams.hidden_size,
        hparams.num_hidden_layers,
        hparams.num_attention_heads,
        hparams.num_classes,
        hparams.patch_size,
        hparams.img_size,
        ftype,
    ):
        f.write(_I32.pack(int(v)))
    f.write(_I32.pack(len(id2label)))
    for key, value in id2label.items():
        enc = value.encode("utf-8")
        f.write(_I32.pack(int(key)))
        f.write(_I32.pack(len(enc)))
        f.write(enc)


def write_tensor(f, name: str, shape: tuple, dtype: GGMLDType, payload):
    str_name = name.encode("utf-8")
    f.write(struct.pack("<iii", len(shape), len(str_name), int(dtype)))
    for dim in reversed(shape):  # ne[0] = fastest dim (py converter :155-156)
        f.write(_I32.pack(int(dim)))
    f.write(str_name)
    if dtype == GGMLDType.F32:
        f.write(np.ascontiguousarray(payload, dtype="<f4").tobytes())
    elif dtype == GGMLDType.F16:
        f.write(np.ascontiguousarray(payload, dtype="<f2").tobytes())
    else:
        raw = payload.tobytes() if isinstance(payload, np.ndarray) else payload
        n = int(np.prod(shape))
        expect = dtype.row_bytes(n)
        if len(raw) != expect:
            raise ValueError(
                f"tensor '{name}': payload {len(raw)}B != expected {expect}B"
            )
        f.write(raw)


def write_model(
    path: str,
    hparams: VitHParams,
    id2label: Dict[int, str],
    tensors: Iterable[TensorItem],
    ftype: int,
):
    with open(path, "wb") as f:
        write_header(f, hparams, id2label, ftype)
        for name, shape, dtype, payload in tensors:
            write_tensor(f, name, shape, dtype, payload)
