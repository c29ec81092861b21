"""Host-side image decode that tries the native decoder once per process.

vit_cpp_tpu/io/image.py imports vit_cpp_tpu.native.decoder on every call,
and that import builds libvitnative.so with g++ when no fresh build
exists. Where the build cannot succeed (no libjpeg/libpng headers), the
failed import is not cached by Python, so every decode re-runs g++ (about
half a second) before falling back to PIL. Here the first failure is
remembered and every later file goes straight to PIL.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

_lock = threading.Lock()
_native = None  # the decoder module, or False once loading it failed


def native_decoder():
    """vit_cpp_tpu.native.decoder, or None if it cannot be loaded; the
    load (and the build behind it) is attempted once per process."""
    global _native
    with _lock:
        if _native is None:
            try:
                from vit_cpp_tpu.native import decoder

                _native = decoder
            except Exception:
                _native = False
        return _native or None


def _pil(path: str) -> Optional[np.ndarray]:
    from PIL import Image

    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except OSError:
        return None


def decode_many(paths: Sequence[str], n_threads: int = 0) -> List[Optional[np.ndarray]]:
    """Files -> (H, W, 3) uint8 RGB each, or None for a file no decoder
    reads: the native threaded batch decode where it loads, then PIL for
    whatever it rejected."""
    paths = list(paths)
    dec = native_decoder()
    images = dec.decode_batch(paths, n_threads=n_threads) if dec else [None] * len(paths)
    return [im if im is not None else _pil(p) for p, im in zip(paths, images)]
