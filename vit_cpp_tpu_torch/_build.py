"""Build and load the port's CUDA kernels: the counterpart of
vit_cpp_tpu/native/build.py for the device code.

Every `csrc/*.cu` file is compiled by its own `nvcc` for Hopper (sm_90a),
all of them at once, and the objects are linked into one shared library
with a plain C interface, which `ctypes` loads. No PyTorch header is
included, so a build takes seconds. The library is
built on first use, into `_kernels/` beside this file (listed in
.gitignore), and is cached under the hash of the sources and flags: an
edited source builds anew, an unchanged one loads the cached file.

    python -m vit_cpp_tpu_torch._build      # build now, print ptxas's report

Each kernel's Python wrapper holds a `Kernel`, whose `launches` count is
advanced once for every launch: a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process ran ("" if cached)
build_seconds = 0.0


def sources() -> list:
    return sorted(
        os.path.join(CSRC, f)
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of vit_cpp_tpu_torch are built from csrc/ on the GPU machine"
    )


def library_path() -> str:
    """Build the library if no build of these sources exists; its path."""
    global build_log, build_seconds
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    lib = os.path.join(BUILD_DIR, f"libvitkernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (s for s in sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", tmp, *objs]
    if all(rc == 0 for _, _, rc in logs):
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append((link, proc.stdout, proc.returncode))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(out for _, out, _ in logs)
    for cmd, out, rc in logs:
        if rc != 0:
            raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent builder loads a whole file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(library_path())
            lib.vit_attention_qkv.restype = ctypes.c_int
            lib.vit_attention_qkv.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.vit_flash_attention.restype = ctypes.c_int
            lib.vit_flash_attention.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.vit_dequant_matmul.restype = ctypes.c_int
            lib.vit_dequant_matmul.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.vit_attention_qkv_grad.restype = ctypes.c_int
            lib.vit_attention_qkv_grad.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p,
            ]
            lib.vit_attn_anatomy.restype = ctypes.c_int
            lib.vit_attn_anatomy.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p,
            ]
            lib.vit_attn_grad_anatomy.restype = ctypes.c_int
            lib.vit_attn_grad_anatomy.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p,
            ]
            lib.vit_probe_dot.restype = ctypes.c_int
            lib.vit_probe_dot.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            lib.vit_cuda_error_string.restype = ctypes.c_char_p
            lib.vit_cuda_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if rc != 0:
        msg = library().vit_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


class Kernel:
    """A hand-written kernel's identity and its launch count."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source  # path in the repository
        self.replaces = replaces  # file:line of the TPU kernel
        self.launches = 0
        self._count_lock = threading.Lock()

    def counted(self) -> None:
        with self._count_lock:
            self.launches += 1

    def reset(self) -> None:
        with self._count_lock:
            self.launches = 0


if __name__ == "__main__":
    path = library_path()
    print(path)
    print(build_log or "(cached build)", file=sys.stderr)
