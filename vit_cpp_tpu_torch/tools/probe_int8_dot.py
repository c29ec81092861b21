"""Probe: int8 x int8 -> int32 against bf16 x bf16 -> f32 tensor-core
products inside a hand-written kernel, on the card.

Counterpart of tools/probe_int8_dot.py (a whole-array int8 dot inside a
Pallas kernel). Here the product runs in csrc/probe_int8_dot.cu on
Hopper's asynchronous tensor cores, wgmma (m64n128k32 s8, m64n128k16
bf16), fed by TMA. It checks that the int8 product is exact, then times
a chain of 2000 launches of each at M = K = N = 1024 with CUDA events and
prints the int8 TOP/s, the bf16 TFLOP/s and their ratio: whether a W8A8
kernel can expect twice the bf16 rate. Run on the card:

    python -m vit_cpp_tpu_torch.tools.probe_int8_dot

`dot(a, b)` launches the kernel on CUDA tensors (int8 -> int32 with
K % 64 == 0, bf16 -> f32 with K % 32 == 0; M, N % 64 == 0) or raises; on
CPU tensors it runs the plain version below (int8, bf16 or f32).
`dot_nk(a, b_nk)` is the int8 product with B given K-major, (N, K), the
layout a W8A8 kernel keeps its weights in: the kernel then skips the
transpose that s8 wgmma needs for a (K, N) B.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vit_cpp_tpu_torch._build import Kernel, check, library
from vit_cpp_tpu_torch.tools import require_card, time_ms

KERNEL = Kernel(
    "probe_int8_dot",
    source="vit_cpp_tpu_torch/csrc/probe_int8_dot.cu",
    replaces="tools/probe_int8_dot.py:36",
)

M = K = N = 1024
ITERS = 2000
_DTYPES = {torch.int8: 0, torch.bfloat16: 1}
_NK = 2  # int8, B given (N, K)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"dot takes (M, K) @ (K, N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.int8, torch.bfloat16, torch.float32):
        raise ValueError(f"dot takes two int8, bf16 or f32 operands, got {a.dtype}, {b.dtype}")


def dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product in plain PyTorch (any device): int8 -> int32 through an
    f64 product (exact while K * 128^2 < 2^53), bf16 / f32 -> f32 with f32
    accumulation."""
    _check(a, b)
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N): int8 -> int32, bf16 -> f32."""
    if a.device.type == "cpu":
        return dot_plain(a, b)
    _check(a, b)
    if a.dtype not in _DTYPES:
        raise ValueError(f"probe_int8_dot kernel takes int8 or bf16, got {a.dtype}")
    return _launch(a, b, b.shape[1], _DTYPES[a.dtype])


def dot_nk(a: torch.Tensor, b_nk: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (N, K)^T, int8 -> int32: B given K-major."""
    if b_nk.ndim != 2:
        raise ValueError(f"dot_nk takes (M, K) @ (N, K)^T, got {tuple(b_nk.shape)}")
    if a.device.type == "cpu":
        return dot_plain(a, b_nk.t())
    _check(a, b_nk.t())
    if a.dtype != torch.int8:
        raise ValueError(f"probe_int8_dot kernel takes int8 for a K-major B, got {a.dtype}")
    return _launch(a, b_nk, b_nk.shape[0], _NK)


def _launch(a: torch.Tensor, b: torch.Tensor, n: int, code: int) -> torch.Tensor:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"probe_int8_dot: operands on {a.device} and {b.device}")
    m, k = a.shape
    step = 64 if a.dtype == torch.int8 else 32
    if m % 64 or n % 64 or k % step or not m or not n or not k:
        raise ValueError(f"probe_int8_dot kernel takes M, N % 64 == 0 and K % {step} == 0; "
                         f"got M={m} K={k} N={n}")
    if not (a.is_contiguous() and b.is_contiguous()) or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("probe_int8_dot kernel needs contiguous, 16-byte aligned operands")
    out = torch.empty((m, n), dtype=torch.int32 if a.dtype == torch.int8 else torch.float32,
                      device=a.device)
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.vit_probe_dot(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, code,
                               stream)
    check(rc, "probe_int8_dot kernel launch")
    KERNEL.counted()
    return out


def main(argv=None) -> int:
    require_card("probe_int8_dot")
    print("devices:", [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())])
    rng = np.random.default_rng(0)
    a8 = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8)).cuda()
    b8 = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8)).cuda()
    out = dot(a8, b8).cpu().numpy()
    want = a8.cpu().numpy().astype(np.int64) @ b8.cpu().numpy().astype(np.int64)
    print(f"int8 wgmma dot: exact={np.array_equal(out, want)}")
    ab, bb = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
    ms8 = time_ms(lambda: dot(a8, b8), ITERS)
    msb = time_ms(lambda: dot(ab, bb), ITERS)
    ops = 2 * M * K * N
    print(f"in-kernel rates: int8 {ops / (ms8 / 1e3) / 1e12:.0f} TOP/s | "
          f"bf16 {ops / (msb / 1e3) / 1e12:.0f} TFLOP/s | ratio {msb / ms8:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
