"""Real GGUF (v3) reader — superset of the legacy format.

The reference names its files `*.gguf` but writes the legacy ggml layout
(SURVEY.md §1 L3 note; magic 0x67676d6c, convert-pth-to-ggml.py:33). This
module adds the actual GGUF container per the public ggml spec — magic
'GGUF', little-endian, u64 counts, typed metadata KVs, aligned tensor-data
section — so checkpoints interoperate with the wider gguf ecosystem.
`gguf.read_model` dispatches on the magic, so every consumer (engine,
quantizer, CLIs) accepts either container transparently.

ViT metadata convention (this repo's schema, mirroring §2.3's hparams):
  vit.hidden_size, vit.num_hidden_layers, vit.num_attention_heads,
  vit.num_classes, vit.patch_size, vit.img_size  — u32
  general.ftype                                   — u32
  vit.id2label                                    — array[string], index = id
Tensor names/shapes/dtypes are identical to the legacy records (§2.4);
GGML dtype ids coincide with GGUF's for F32/F16/Q4_0/Q4_1/Q5_0/Q5_1/Q8_0.

The port's own copy of vit_cpp_tpu/gguf/gguf_real.py: the reader, and
`write_gguf`, which writes the same bytes as the JAX package's (the
converter's `--gguf`).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, List, Tuple, Union

import numpy as np

from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType
from vit_cpp_tpu_torch.hparams import VitHParams

GGUF_MAGIC = 0x46554747  # 'GGUF' little-endian
GGUF_VERSION = 3
DEFAULT_ALIGNMENT = 32

# GGUF metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = range(13)

_SCALAR_FMT = {
    _U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h",
    _U32: "<I", _I32: "<i", _F32: "<f", _BOOL: "<?",
    _U64: "<Q", _I64: "<q", _F64: "<d",
}


class _Reader:
    """Corruption-hardened parser: every length/count read from the file
    is validated against the bytes that actually remain, so a bit-flipped
    u64 cannot trigger a multi-GB allocation, and array nesting is capped
    so a malicious file cannot blow the recursion limit. Failure mode is
    always ValueError (the loader convention, gguf/reader.py)."""

    def __init__(self, f):
        self.f = f
        f.seek(0, 2)
        self.size = f.tell()
        f.seek(0)

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        b = self.f.read(size)
        if len(b) != size:
            raise ValueError("gguf: truncated file")
        return struct.unpack(fmt, b)[0]

    def read_str(self) -> str:
        n = self.read("<Q")
        if n > self.size - self.f.tell():
            raise ValueError(
                f"gguf: string length {n} exceeds remaining file bytes"
            )
        return self.f.read(n).decode("utf-8")

    def read_value(self, vtype: int, depth: int = 0):
        if vtype in _SCALAR_FMT:
            return self.read(_SCALAR_FMT[vtype])
        if vtype == _STR:
            return self.read_str()
        if vtype == _ARR:
            if depth >= 8:
                raise ValueError("gguf: metadata arrays nested too deeply")
            etype = self.read("<I")
            count = self.read("<Q")
            # each element is >= 1 byte on disk; a count beyond the
            # remaining bytes is corruption, not a huge valid array
            if count > self.size - self.f.tell():
                raise ValueError(
                    f"gguf: array count {count} exceeds remaining file bytes"
                )
            return [self.read_value(etype, depth + 1) for _ in range(count)]
        raise ValueError(f"gguf: unknown metadata value type {vtype}")


class _Writer:
    def __init__(self, f):
        self.f = f

    def write(self, fmt: str, v):
        self.f.write(struct.pack(fmt, v))

    def write_str(self, s: str):
        b = s.encode("utf-8")
        self.write("<Q", len(b))
        self.f.write(b)

    def write_kv(self, key: str, vtype: int, value):
        self.write_str(key)
        self.write("<I", vtype)
        self.write_value(vtype, value)

    def write_value(self, vtype: int, value):
        if vtype in _SCALAR_FMT:
            self.write(_SCALAR_FMT[vtype], value)
        elif vtype == _STR:
            self.write_str(value)
        elif vtype == _ARR:
            etype, items = value
            self.write("<I", etype)
            self.write("<Q", len(items))
            for it in items:
                self.write_value(etype, it)
        else:
            raise ValueError(f"gguf: unknown metadata value type {vtype}")


def read_gguf_raw(path: str):
    """Parse a real-GGUF file -> (metadata dict, [(name, shape, dtype, raw)]).

    Shapes are returned in torch order (slowest first) — GGUF stores dims
    fastest-first like the legacy records.
    """
    with open(path, "rb") as f:
        r = _Reader(f)
        if r.read("<I") != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        version = r.read("<I")
        if version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        n_tensors = r.read("<Q")
        n_kv = r.read("<Q")
        meta: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = r.read_str()
            vtype = r.read("<I")
            meta[key] = r.read_value(vtype)
        infos: List[Tuple[str, tuple, GGMLDType, int]] = []
        for _ in range(n_tensors):
            name = r.read_str()
            n_dims = r.read("<I")
            ne = [r.read("<Q") for _ in range(n_dims)]
            dtype = GGMLDType(r.read("<I"))
            offset = r.read("<Q")
            infos.append((name, tuple(reversed(ne)), dtype, offset))
        align_v = meta.get("general.alignment", DEFAULT_ALIGNMENT)
        if not isinstance(align_v, int) or not (1 <= align_v <= 1 << 20):
            raise ValueError(f"gguf: bad general.alignment {align_v!r}")
        align = align_v
        pos = f.tell()
        data_start = (pos + align - 1) // align * align
        tensors = []
        for name, shape, dtype, offset in infos:
            n = 1
            for dim in shape:  # python ints: no int64 overflow on corrupt dims
                n *= int(dim)
            nbytes = dtype.row_bytes(n)
            if nbytes > r.size or offset > r.size:
                raise ValueError(
                    f"{path}: tensor '{name}' claims {nbytes}B at offset "
                    f"{offset} in a {r.size}B file"
                )
            f.seek(data_start + offset)
            raw = f.read(nbytes)
            if len(raw) != nbytes:
                raise ValueError(f"{path}: tensor '{name}' truncated")
            tensors.append((name, shape, dtype, raw))
        return meta, tensors


def hparams_from_metadata(meta: Dict[str, Any]) -> VitHParams:
    def need(key):
        if key not in meta:
            raise ValueError(f"gguf: missing metadata key '{key}'")
        return int(meta[key])

    return VitHParams(
        hidden_size=need("vit.hidden_size"),
        num_hidden_layers=need("vit.num_hidden_layers"),
        num_attention_heads=need("vit.num_attention_heads"),
        num_classes=need("vit.num_classes"),
        patch_size=need("vit.patch_size"),
        img_size=need("vit.img_size"),
        ftype=int(meta.get("general.ftype", 1)),
    )


def write_gguf(
    path: str,
    hparams: VitHParams,
    id2label: Dict[int, str],
    tensors: Iterable[Tuple[str, tuple, GGMLDType, Union[np.ndarray, bytes]]],
    ftype: int,
    alignment: int = DEFAULT_ALIGNMENT,
    extra_metadata: Dict[str, Any] | None = None,
) -> None:
    """Write a real-GGUF v3 container with the ViT metadata convention."""
    items = []
    for name, shape, dtype, payload in tensors:
        if isinstance(payload, np.ndarray):
            if dtype == GGMLDType.F32:
                raw = np.ascontiguousarray(payload, dtype="<f4").tobytes()
            elif dtype == GGMLDType.F16:
                raw = np.ascontiguousarray(payload, dtype="<f2").tobytes()
            else:
                raw = payload.tobytes()
        else:
            raw = payload
        n = int(np.prod(shape)) if shape else 1
        if len(raw) != dtype.row_bytes(n):
            raise ValueError(
                f"tensor '{name}': payload {len(raw)}B != "
                f"{dtype.row_bytes(n)}B for {dtype.name} {shape}"
            )
        items.append((name, shape, dtype, raw))

    labels = [
        id2label.get(i, f"LABEL_{i}")
        for i in range(max(id2label) + 1 if id2label else 0)
    ]
    with open(path, "wb") as f:
        w = _Writer(f)
        w.write("<I", GGUF_MAGIC)
        w.write("<I", GGUF_VERSION)
        w.write("<Q", len(items))
        kvs = [
            ("general.architecture", _STR, "vit"),
            ("general.alignment", _U32, alignment),
            ("general.ftype", _U32, int(ftype)),
            ("vit.hidden_size", _U32, hparams.hidden_size),
            ("vit.num_hidden_layers", _U32, hparams.num_hidden_layers),
            ("vit.num_attention_heads", _U32, hparams.num_attention_heads),
            ("vit.num_classes", _U32, hparams.num_classes),
            ("vit.patch_size", _U32, hparams.patch_size),
            ("vit.img_size", _U32, hparams.img_size),
            ("vit.id2label", _ARR, (_STR, labels)),
        ]
        for key, value in (extra_metadata or {}).items():
            if isinstance(value, bool):
                kvs.append((key, _BOOL, value))
            elif isinstance(value, int):
                kvs.append((key, _I64, value))
            elif isinstance(value, float):
                kvs.append((key, _F64, value))
            else:
                kvs.append((key, _STR, str(value)))
        w.write("<Q", len(kvs))
        for key, vtype, value in kvs:
            w.write_kv(key, vtype, value)

        offset = 0
        offsets = []
        for name, shape, dtype, raw in items:
            w.write_str(name)
            w.write("<I", len(shape))
            for dim in reversed(shape):
                w.write("<Q", int(dim))
            w.write("<I", int(dtype))
            w.write("<Q", offset)
            offsets.append(offset)
            offset += (len(raw) + alignment - 1) // alignment * alignment

        pos = f.tell()
        f.write(b"\x00" * ((pos + alignment - 1) // alignment * alignment - pos))
        for (name, shape, dtype, raw), off in zip(items, offsets):
            f.write(raw)
            pad = (len(raw) + alignment - 1) // alignment * alignment - len(raw)
            f.write(b"\x00" * pad)
