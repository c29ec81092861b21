"""Host-side image decode that tries the native decoder once per process.

Importing vit_cpp_tpu_torch.native.decoder builds libvitnative.so with g++
when no fresh build exists. Where the build cannot succeed (no
libjpeg/libpng headers), the failed import is not cached by Python, so a
decode that imported it on every call would re-run g++ (about half a
second) before falling back to PIL. Here the first failure is remembered
and every later image goes straight to PIL.
"""

from __future__ import annotations

import io
import threading
from typing import List, Optional, Sequence

import numpy as np

_lock = threading.Lock()
_native = None  # the decoder module, or False once loading it failed


def native_decoder():
    """vit_cpp_tpu_torch.native.decoder, or None if it cannot be loaded;
    the load (and the build behind it) is attempted once per process."""
    global _native
    with _lock:
        if _native is None:
            try:
                from vit_cpp_tpu_torch.native import decoder

                _native = decoder
            except Exception:
                _native = False
        return _native or None


def _pil(src) -> Optional[np.ndarray]:
    from PIL import Image

    try:
        with Image.open(src) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except OSError:
        return None


def decode_file(path: str) -> Optional[np.ndarray]:
    """One file -> (H, W, 3) uint8 RGB, or None if no decoder reads it."""
    dec = native_decoder()
    img = dec.decode_rgb(path) if dec else None
    return img if img is not None else _pil(path)


def decode_bytes(data: bytes) -> Optional[np.ndarray]:
    """An in-memory image file -> (H, W, 3) uint8 RGB, or None."""
    dec = native_decoder()
    img = dec.decode_rgb_bytes(data) if dec else None
    return img if img is not None else _pil(io.BytesIO(data))


def decode_many(paths: Sequence[str], n_threads: int = 0) -> List[Optional[np.ndarray]]:
    """Files -> (H, W, 3) uint8 RGB each, or None for a file no decoder
    reads: the native threaded batch decode where it loads, then PIL for
    whatever it rejected."""
    paths = list(paths)
    dec = native_decoder()
    images = dec.decode_batch(paths, n_threads=n_threads) if dec else [None] * len(paths)
    return [im if im is not None else _pil(p) for p, im in zip(paths, images)]
