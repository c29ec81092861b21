"""Block-quantization codecs for the ggml Q4_0/Q4_1/Q5_0/Q5_1/Q8_0 formats.

Counterpart of vit_cpp_tpu/quant/blocks.py. The arithmetic is the same
numpy, so the encoded bytes, the unpacked codes and the
dequantized values are bit-equal to that module's. Each block covers
QK=32 contiguous elements of the fastest-moving dimension:

    Q4_0: { f16 d;           u8 qs[16] }  x = (q - 8) * d
    Q4_1: { f16 d; f16 m;    u8 qs[16] }  x = q * d + m
    Q5_0: { f16 d; u32 qh;   u8 qs[16] }  x = (q - 16) * d   (5th bit in qh)
    Q5_1: { f16 d; f16 m; u32 qh; u8 qs[16] }  x = q * d + m
    Q8_0: { f16 d;           i8 qs[32] }  x = q * d

Nibble packing: byte j holds element j in its low nibble and element j+16
in its high nibble. For Q5 formats, bit j of qh is the 5th bit of element
j and bit j+16 that of element j+16.

Rounding, on which byte equality depends: scales are computed in f32 and
stored as f16; 4/5-bit codes are trunc(x*id + levels/2 + 0.5) (Q4_0/Q5_0)
or trunc((x - min)*id + 0.5) (Q4_1/Q5_1), clamped at the top code; Q8_0
rounds half away from zero (not half to even, as np.round and
torch.round do); argmax ties take the first index; a zero block has d = 0
and inverse 0. Dequantization uses the f16-rounded scale.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from vit_cpp_tpu_torch.gguf.dtypes import QK, GGMLDType

# Structured numpy dtypes of the on-disk block layouts (packed,
# little-endian: numpy structured dtypes have no padding by default).
BLOCK_DTYPES = {
    GGMLDType.Q4_0: np.dtype([("d", "<f2"), ("qs", "u1", (QK // 2,))]),
    GGMLDType.Q4_1: np.dtype(
        [("d", "<f2"), ("m", "<f2"), ("qs", "u1", (QK // 2,))]
    ),
    GGMLDType.Q5_0: np.dtype(
        [("d", "<f2"), ("qh", "<u4"), ("qs", "u1", (QK // 2,))]
    ),
    GGMLDType.Q5_1: np.dtype(
        [("d", "<f2"), ("m", "<f2"), ("qh", "<u4"), ("qs", "u1", (QK // 2,))]
    ),
    GGMLDType.Q8_0: np.dtype([("d", "<f2"), ("qs", "i1", (QK,))]),
}

# Offset subtracted from the integer code at dequantization for the
# symmetric formats: x = (code - offset) * d.
CODE_OFFSET = {
    GGMLDType.Q4_0: 8,
    GGMLDType.Q5_0: 16,
    GGMLDType.Q4_1: 0,
    GGMLDType.Q5_1: 0,
    GGMLDType.Q8_0: 0,
}


def _blocks_of(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % QK != 0:
        raise ValueError(f"element count {x.size} not a multiple of QK={QK}")
    return x.reshape(-1, QK)


def _inverse(d: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(d != 0.0, 1.0 / d, 0.0).astype(np.float32)


def _codes_absmax(xb: np.ndarray, levels: int) -> Tuple[np.ndarray, np.ndarray]:
    """Q4_0/Q5_0: d = signed_absmax / -(levels/2);
    code = trunc(x/d + levels/2 + 0.5) clamped to levels-1."""
    amax_idx = np.argmax(np.abs(xb), axis=1)
    signed_max = xb[np.arange(xb.shape[0]), amax_idx]
    d = signed_max / -(levels / 2)
    scaled = xb * _inverse(d)[:, None] + (levels / 2 + 0.5)
    codes = np.minimum(np.trunc(scaled).astype(np.int32), levels - 1)
    return codes.astype(np.uint8), d.astype(np.float32)


def _codes_minmax(
    xb: np.ndarray, levels: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Q4_1/Q5_1: d = (max-min)/(levels-1); code = trunc((x-min)/d + 0.5)
    clamped."""
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / (levels - 1)
    scaled = (xb - mn[:, None]) * _inverse(d)[:, None] + 0.5
    codes = np.minimum(np.trunc(scaled).astype(np.int32), levels - 1)
    return codes.astype(np.uint8), d.astype(np.float32), mn.astype(np.float32)


def _pack_nibbles(codes: np.ndarray) -> np.ndarray:
    """(nb, 32) codes -> (nb, 16) bytes: low nibble = elem j, high = j+16."""
    lo = codes[:, : QK // 2] & 0x0F
    hi = codes[:, QK // 2 :] & 0x0F
    return (lo | (hi << 4)).astype(np.uint8)


def _pack_high_bits(codes: np.ndarray) -> np.ndarray:
    """5th bit of each code -> little-endian u32 per block."""
    bits = (codes >> 4).astype(np.uint32)  # (nb, 32) in {0, 1}
    shifts = np.arange(QK, dtype=np.uint32)
    return (bits << shifts[None, :]).sum(axis=1, dtype=np.uint64).astype(np.uint32)


def quantize(x: np.ndarray, dtype: GGMLDType) -> np.ndarray:
    """Quantize a float array to packed blocks: a structured array of
    BLOCK_DTYPES[dtype], one entry per 32-element block, whose
    `.tobytes()` is the on-disk byte stream."""
    xb = _blocks_of(x)
    out = np.empty(xb.shape[0], dtype=BLOCK_DTYPES[dtype])
    if dtype in (GGMLDType.Q4_0, GGMLDType.Q5_0):
        codes, d = _codes_absmax(xb, 16 if dtype == GGMLDType.Q4_0 else 32)
    elif dtype in (GGMLDType.Q4_1, GGMLDType.Q5_1):
        codes, d, m = _codes_minmax(xb, 16 if dtype == GGMLDType.Q4_1 else 32)
        out["m"] = m.astype(np.float16)
    elif dtype == GGMLDType.Q8_0:
        d = (np.abs(xb).max(axis=1) / 127.0).astype(np.float32)
        scaled = xb * _inverse(d)[:, None]
        # roundf: half away from zero
        codes = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
        out["d"] = d.astype(np.float16)
        out["qs"] = codes.astype(np.int8)
        return out
    else:
        raise ValueError(f"not a quantized dtype: {dtype}")
    out["d"] = d.astype(np.float16)
    if dtype in (GGMLDType.Q5_0, GGMLDType.Q5_1):
        out["qh"] = _pack_high_bits(codes)
    out["qs"] = _pack_nibbles(codes)
    return out


def parse_blocks(raw: bytes | np.ndarray, n: int, dtype: GGMLDType) -> np.ndarray:
    """View a raw byte buffer as the structured block array for `n` elements."""
    nb = n // QK
    if isinstance(raw, np.ndarray) and raw.dtype == BLOCK_DTYPES[dtype]:
        blocks = raw
    else:
        buf = raw.tobytes() if isinstance(raw, np.ndarray) else raw
        blocks = np.frombuffer(buf, dtype=BLOCK_DTYPES[dtype], count=nb)
    if blocks.shape[0] != nb:
        raise ValueError(f"expected {nb} blocks, got {blocks.shape[0]}")
    return blocks


def unpack_soa(
    raw: bytes | np.ndarray, n: int, dtype: GGMLDType
) -> Dict[str, np.ndarray]:
    """Unpack blocks to structure-of-arrays form:

      'codes' — integer codes, (nb, 32): uint8 in [0,16) / [0,32), or int8
                for Q8_0 (already centered);
      'd'     — f32 scale (nb,), widened from the stored f16;
      'm'     — f32 min (nb,), only for the _1 formats.
    """
    blocks = parse_blocks(raw, n, dtype)
    out: Dict[str, np.ndarray] = {"d": blocks["d"].astype(np.float32)}
    if dtype == GGMLDType.Q8_0:
        out["codes"] = blocks["qs"].copy()
        return out
    qs = blocks["qs"]
    codes = np.concatenate([qs & 0x0F, qs >> 4], axis=1)
    if dtype in (GGMLDType.Q5_0, GGMLDType.Q5_1):
        shifts = np.arange(QK, dtype=np.uint32)
        high = ((blocks["qh"][:, None] >> shifts[None, :]) & 1).astype(np.uint8)
        codes = codes | (high << 4)
    out["codes"] = codes
    if dtype in (GGMLDType.Q4_1, GGMLDType.Q5_1):
        out["m"] = blocks["m"].astype(np.float32)
    return out


def dequantize(raw: bytes | np.ndarray, n: int, dtype: GGMLDType) -> np.ndarray:
    """Dequantize a packed byte stream back to f32, shape (n,)."""
    soa = unpack_soa(raw, n, dtype)
    codes = soa["codes"].astype(np.float32) - CODE_OFFSET[dtype]
    x = codes * soa["d"][:, None]
    if "m" in soa:
        x = x + soa["m"][:, None]
    return x.reshape(-1)[:n]


def quantize_with_hist(
    x: np.ndarray, dtype: GGMLDType
) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize and return a 16-bucket code histogram: the 4-bit code for
    Q4, code>>1 for Q5, and (code>>4)+8 for Q8_0's signed bytes."""
    blocks = quantize(x, dtype)
    codes = unpack_soa(blocks, x.size, dtype)["codes"]
    if dtype in (GGMLDType.Q4_0, GGMLDType.Q4_1):
        bucket = codes.astype(np.int64)
    elif dtype in (GGMLDType.Q5_0, GGMLDType.Q5_1):
        bucket = (codes >> 1).astype(np.int64)
    else:
        bucket = (codes.astype(np.int64) >> 4) + 8
    hist = np.bincount(bucket.reshape(-1), minlength=16)[:16]
    return blocks, hist
