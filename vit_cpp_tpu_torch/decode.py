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
import os
import threading
from concurrent.futures import ThreadPoolExecutor
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


def decode_pil(src) -> Optional[np.ndarray]:
    """A file path or file object -> (H, W, 3) uint8 RGB by PIL, or None.
    The array is the caller's own (writable), as the native decoder's
    are: torch.from_numpy takes it without a copy or a warning."""
    from PIL import Image

    try:
        with Image.open(src) as im:
            return np.array(im.convert("RGB"), dtype=np.uint8)
    except OSError:
        return None


def decode_file(path: str) -> Optional[np.ndarray]:
    """One file -> (H, W, 3) uint8 RGB, or None if no decoder reads it."""
    dec = native_decoder()
    img = dec.decode_rgb(path) if dec else None
    return img if img is not None else decode_pil(path)


def decode_bytes(data: bytes) -> Optional[np.ndarray]:
    """An in-memory image file -> (H, W, 3) uint8 RGB, or None."""
    dec = native_decoder()
    img = dec.decode_rgb_bytes(data) if dec else None
    return img if img is not None else decode_pil(io.BytesIO(data))


def decode_many(paths: Sequence[str], n_threads: int = 0) -> List[Optional[np.ndarray]]:
    """Files -> (H, W, 3) uint8 RGB each, or None for a file no decoder
    reads: the native threaded batch decode where it loads, then PIL for
    whatever it rejected, on `n_threads` threads (0: one per core). PIL
    releases the GIL while it decodes, and where the native decoder cannot
    be built every file takes the PIL path."""
    paths = list(paths)
    dec = native_decoder()
    images = dec.decode_batch(paths, n_threads=n_threads) if dec else [None] * len(paths)
    retry = [i for i, im in enumerate(images) if im is None]
    if retry:
        workers = min(len(retry), n_threads if n_threads > 0 else os.cpu_count() or 1)
        with ThreadPoolExecutor(workers) as ex:
            for i, im in zip(retry, ex.map(decode_pil, [paths[i] for i in retry])):
                images[i] = im
    return images
