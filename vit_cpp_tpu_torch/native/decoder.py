"""ctypes bindings for the native image decoder (libvitnative.so).

The TPU-native counterpart of the reference's stb_image usage
(load_image_from_file, vit.cpp:109-127): JPEG/PNG -> (H, W, 3) uint8 RGB,
single files or threaded batches. The port's own copy of
vit_cpp_tpu/native/decoder.py. Importing this module builds the shared
library on first use (native/build.py); vit_cpp_tpu_torch/decode.py
imports it once per process and falls back to PIL when it fails.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence

import numpy as np

from vit_cpp_tpu_torch.native.build import build

_lib = ctypes.CDLL(build())

_u8p = ctypes.POINTER(ctypes.c_ubyte)

_lib.vn_version.restype = ctypes.c_int
_lib.vn_decode_file.restype = _u8p
_lib.vn_decode_file.argtypes = [
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int),
]
_lib.vn_decode_mem.restype = _u8p
_lib.vn_decode_mem.argtypes = [
    ctypes.c_char_p,
    ctypes.c_size_t,
    ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int),
]
_lib.vn_decode_batch.restype = ctypes.c_int
_lib.vn_decode_batch.argtypes = [
    ctypes.POINTER(ctypes.c_char_p),
    ctypes.c_int,
    ctypes.c_int,
    ctypes.POINTER(_u8p),
    ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int),
]
_lib.vn_free.restype = None
_lib.vn_free.argtypes = [_u8p]

ABI_VERSION = int(_lib.vn_version())


def _to_array(ptr, w: int, h: int) -> np.ndarray:
    try:
        buf = ctypes.cast(
            ptr, ctypes.POINTER(ctypes.c_ubyte * (w * h * 3))
        ).contents
        return np.frombuffer(buf, dtype=np.uint8).reshape(h, w, 3).copy()
    finally:
        _lib.vn_free(ptr)


def decode_rgb(path: str) -> Optional[np.ndarray]:
    """Decode one file -> (H, W, 3) uint8, or None on failure."""
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    ptr = _lib.vn_decode_file(os.fsencode(path), ctypes.byref(w), ctypes.byref(h))
    if not ptr:
        return None
    return _to_array(ptr, w.value, h.value)


def decode_rgb_bytes(data: bytes) -> Optional[np.ndarray]:
    """Decode an in-memory JPEG/PNG -> (H, W, 3) uint8, or None."""
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    ptr = _lib.vn_decode_mem(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if not ptr:
        return None
    return _to_array(ptr, w.value, h.value)


def decode_batch(
    paths: Sequence[str], n_threads: int = 0
) -> List[Optional[np.ndarray]]:
    """Decode many files on a native thread pool (the throughput path for
    the serving pipeline and the ImageNet harness). Failed decodes come
    back as None — callers skip them like the reference harness
    (tests/benchmark.cpp:108-125)."""
    n = len(paths)
    if n == 0:
        return []
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 1)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    outs = (_u8p * n)()
    ws = (ctypes.c_int * n)()
    hs = (ctypes.c_int * n)()
    _lib.vn_decode_batch(c_paths, n, n_threads, outs, ws, hs)
    result: List[Optional[np.ndarray]] = []
    for i in range(n):
        if outs[i]:
            result.append(_to_array(outs[i], ws[i], hs[i]))
        else:
            result.append(None)
    return result
