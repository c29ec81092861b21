"""Reader for the legacy-ggml model file format.

Byte-exact consumer of the format produced by the reference's converter and
quantizer (SURVEY.md §2.3; reference producers convert-pth-to-ggml.py:106-158
and quantize.cpp:110-325; reference consumer vit_model_load, vit.cpp:308-712):

    i32 magic 'ggml'
    i32 hidden_size, num_hidden_layers, num_attention_heads,
        num_classes, patch_size, img_size
    i32 ftype                       (qntvr packed: ftype = qntvr*1000 + ftype)
    i32 num_labels
      num_labels x { i32 key; i32 len; utf8[len] }
    until EOF:
      i32 n_dims; i32 name_len; i32 dtype
      i32 ne[n_dims]               (reversed torch shape: ne[0] = fastest dim)
      utf8 name[name_len]
      raw row-major tensor bytes

Unlike the reference loader, which allocates tensors into a ggml arena and
validates against a pre-built name map, this reader is schema-agnostic: it
returns every record with its torch-order shape and dtype, and leaves
model-schema validation to the params loader (models/params.py).

The port's own copy of vit_cpp_tpu/gguf/reader.py: the same records and
hparams; a quantized record's `as_f32` decodes with the port's codec
(quant/blocks.py).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Optional

import numpy as np

from vit_cpp_tpu_torch.gguf.dtypes import (
    GGML_FILE_MAGIC,
    GGML_QNT_VERSION_FACTOR,
    GGMLDType,
)
from vit_cpp_tpu_torch.hparams import VitHParams

_I32 = struct.Struct("<i")


@dataclasses.dataclass
class TensorRecord:
    """One tensor from a model file.

    shape is in torch order (slowest-first), i.e. the on-disk ne[] reversed —
    the reference writes dims reversed (convert-pth-to-ggml.py:155-156) so
    that ne[0] is the contiguous dimension.
    """

    name: str
    shape: tuple
    dtype: GGMLDType
    data: np.ndarray  # f32/f16 ndarray in `shape`, or packed uint8 bytes

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def as_f32(self) -> np.ndarray:
        """Materialize as float32 in torch order (dequantizing if needed)."""
        if self.dtype in (GGMLDType.F32, GGMLDType.F16):
            return self.data.astype(np.float32)
        from vit_cpp_tpu_torch.quant.blocks import dequantize

        return dequantize(self.data, self.n_elements, self.dtype).reshape(self.shape)


@dataclasses.dataclass
class ModelFile:
    hparams: VitHParams
    id2label: Dict[int, str]
    tensors: Dict[str, TensorRecord]
    qntvr: int = 0


def _read_i32(f) -> Optional[int]:
    b = f.read(4)
    if len(b) < 4:
        return None
    return _I32.unpack(b)[0]


def _read_real_gguf(path: str, verbose: bool) -> ModelFile:
    """Real-GGUF container (magic 'GGUF') -> ModelFile. Superset path; the
    reference's own files use the legacy layout below (SURVEY.md §1 L3)."""
    from vit_cpp_tpu_torch.gguf.gguf_real import hparams_from_metadata, read_gguf_raw

    meta, raw_tensors = read_gguf_raw(path)
    hp = hparams_from_metadata(meta)
    id2label = {
        i: s for i, s in enumerate(meta.get("vit.id2label", []))
    }
    tensors: Dict[str, TensorRecord] = {}
    for name, shape, dtype, raw in raw_tensors:
        if dtype == GGMLDType.F32:
            data = np.frombuffer(raw, dtype="<f4").reshape(shape).copy()
        elif dtype == GGMLDType.F16:
            data = np.frombuffer(raw, dtype="<f2").reshape(shape).copy()
        else:
            data = np.frombuffer(raw, dtype=np.uint8).copy()
        tensors[name] = TensorRecord(name, shape, dtype, data)
        if verbose:
            print(f"  {name:<48s} {shape} {dtype.name}")
    return ModelFile(hparams=hp, id2label=id2label, tensors=tensors)


def read_model(path: str, verbose: bool = False) -> ModelFile:
    """Parse a model file into hparams, labels and tensor records.

    Accepts both containers: the legacy ggml layout the reference writes
    (magic 'ggml') and real GGUF v2/v3 (magic 'GGUF', gguf_real.py).
    """
    with open(path, "rb") as probe:
        head = probe.read(4)
    if head == b"GGUF":
        return _read_real_gguf(path, verbose)

    with open(path, "rb") as f:
        magic = _read_i32(f)
        if magic != GGML_FILE_MAGIC:
            raise ValueError(f"{path}: invalid model file (bad magic {magic!r})")

        vals = [_read_i32(f) for _ in range(7)]
        if any(v is None for v in vals):
            raise ValueError(f"{path}: truncated hparams")
        hidden, layers, heads, classes, patch, img, ftype = vals
        qntvr = ftype // GGML_QNT_VERSION_FACTOR  # vit.cpp:343-354
        ftype = ftype % GGML_QNT_VERSION_FACTOR
        hp = VitHParams(
            hidden_size=hidden,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            num_classes=classes,
            patch_size=patch,
            img_size=img,
            ftype=ftype,
        )

        num_labels = _read_i32(f)
        if num_labels is None:
            raise ValueError(f"{path}: truncated label table")
        id2label: Dict[int, str] = {}
        for _ in range(num_labels):
            key = _read_i32(f)
            slen = _read_i32(f)
            if key is None or slen is None:
                raise ValueError(f"{path}: truncated label record")
            id2label[key] = f.read(slen).decode("utf-8")

        tensors: Dict[str, TensorRecord] = {}
        while True:
            n_dims = _read_i32(f)
            if n_dims is None:
                break  # EOF terminates the tensor stream (vit.cpp:590-604)
            name_len = _read_i32(f)
            dtype_i = _read_i32(f)
            if name_len is None or dtype_i is None:
                raise ValueError(f"{path}: truncated tensor header")
            ne = [_read_i32(f) for _ in range(n_dims)]
            if any(v is None for v in ne):
                raise ValueError(f"{path}: truncated tensor dims")
            name = f.read(name_len).decode("utf-8")
            dtype = GGMLDType(dtype_i)
            shape = tuple(reversed(ne))
            n_elements = int(np.prod(ne))
            if dtype.is_quantized and ne[0] % 64 != 0:
                # The reference loader requires ne[0] % 64 == 0 for quantized
                # tensors (vit.cpp:655-671) — stricter than the 32-elem block.
                raise ValueError(
                    f"{path}: tensor '{name}' ne[0]={ne[0]} not 64-aligned "
                    f"for {dtype.name}"
                )
            nbytes = dtype.row_bytes(n_elements)
            raw = f.read(nbytes)
            if len(raw) != nbytes:
                raise ValueError(
                    f"{path}: tensor '{name}' truncated "
                    f"({len(raw)}/{nbytes} bytes)"
                )
            if dtype == GGMLDType.F32:
                data = np.frombuffer(raw, dtype="<f4").reshape(shape).copy()
            elif dtype == GGMLDType.F16:
                data = np.frombuffer(raw, dtype="<f2").reshape(shape).copy()
            else:
                data = np.frombuffer(raw, dtype=np.uint8).copy()
            if name in tensors:
                raise ValueError(f"{path}: duplicate tensor '{name}'")
            tensors[name] = TensorRecord(name, shape, dtype, data)
            if verbose:
                print(f"  {name:<48s} {shape} {dtype.name}")

    return ModelFile(hparams=hp, id2label=id2label, tensors=tensors, qntvr=qntvr)
