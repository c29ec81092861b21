"""Build libvitnative.so from vit_cpp_tpu_torch/native/src.

The port's own copy of vit_cpp_tpu/native/build.py (the AddressSanitizer
build is left to that package's tools/asan_check.py). The library is the
host-side image decoder; it is built beside this file on first import of
vit_cpp_tpu_torch.native.decoder and rebuilt when the source is newer.
Also runnable directly: python -m vit_cpp_tpu_torch.native.build
"""

from __future__ import annotations

import os
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "src", "vitnative.cpp")
LIB = os.path.join(_DIR, "libvitnative.so")

CXX = os.environ.get("CXX", "g++")
CXXFLAGS = [
    "-O3",
    "-march=native",
    "-std=c++17",
    "-fPIC",
    "-shared",
    "-Wall",
]
LIBS = ["-ljpeg", "-lpng", "-lz", "-lpthread"]


def build(force: bool = False, quiet: bool = True) -> str:
    """Compile if stale; returns the shared-library path."""
    if (
        not force
        and os.path.exists(LIB)
        and os.path.getmtime(LIB) >= os.path.getmtime(SRC)
    ):
        return LIB
    cmd = [CXX, *CXXFLAGS, SRC, "-o", LIB, *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"vitnative build failed: {' '.join(cmd)}\n{proc.stderr}"
        )
    if not quiet:
        print(f"built {LIB}")
    return LIB


if __name__ == "__main__":
    build(force="--force" in sys.argv, quiet=False)
