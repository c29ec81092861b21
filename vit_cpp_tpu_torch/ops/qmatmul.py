"""Dequantize-inside-matmul for block-quantized weights: the hand-written
CUDA kernel and its plain version.

Counterpart of vit_cpp_tpu/ops/qmatmul.py::quant_matmul and of the TPU
kernel behind vit_cpp_tpu/ops/pallas_qmatmul.py::pallas_quant_matmul:

    y = x @ ((codes - offset) * scale [+ min])

with one scale (and min) per 32 rows of K per output column.

- `impl="xla"` dequantizes the weight and runs `torch.matmul`, as the JAX
  package leaves this path to XLA outside any kernel.
- `impl="pallas"` calls `dequant_matmul`: on a CUDA tensor it launches
  csrc/dequant_matmul.cu (built by _build.py) or raises; on a CPU tensor
  it runs `dequant_matmul_plain`, which chip_smoke.py also holds the
  kernel against on the card. `tile_rows` picks the bf16 kernel's output
  rows per block for the shape and the card.

Numerics of both: the weight is dequantized in f32 as (c - offset) *
scale, then + min, rounded to x's dtype, and multiplied with f32
accumulation; y is written in x's dtype. The bias is added by the caller
(ops/core.py::linear).
"""

from __future__ import annotations

import functools

import torch

from vit_cpp_tpu_torch.gguf.dtypes import QK
from vit_cpp_tpu_torch._build import Kernel, check, library
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear

KERNEL = Kernel(
    "dequant_matmul",
    source="vit_cpp_tpu_torch/csrc/dequant_matmul.cu",
    replaces="vit_cpp_tpu/ops/pallas_qmatmul.py:38",
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_N = 128  # output columns per block of the bf16 kernel


def tile_rows(m: int, n: int, sms: int) -> int:
    """Output rows per block of the bf16 kernel for an (m, n) output on a
    card with `sms` SMs: 256 (one block per SM), which dequantizes each
    weight tile once per 256 rows of x, where that grid still covers half
    of the SMs; else 128 (two blocks per SM). ViT-B/16 at B=8: 256 for qkv
    (126 blocks) and fc1, 128 for proj and fc2 (42 blocks of 256 rows)."""
    blocks = -(-m // 256) * -(-n // _TILE_N)
    return 256 if 2 * blocks >= sms else 128


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _flatten(x: torch.Tensor, w: QuantLinear) -> torch.Tensor:
    k = x.shape[-1]
    if w.codes.ndim != 2:
        raise ValueError(
            f"quant matmul takes one layer's weight, got codes {tuple(w.codes.shape)}"
        )
    if w.in_features != k:
        raise ValueError(
            f"quant matmul: x K={k} != weight in_features={w.in_features}"
        )
    return x.reshape(-1, k)


def dequant_matmul_plain(x: torch.Tensor, w: QuantLinear) -> torch.Tensor:
    """The plain PyTorch version of the kernel (any device); x (..., K)."""
    y = torch.matmul(_flatten(x, w), w.dequantize(x.dtype))
    return y.reshape(*x.shape[:-1], w.out_features)


def dequant_matmul(x: torch.Tensor, w: QuantLinear) -> torch.Tensor:
    """x (..., K) @ dequant(w) -> (..., N) in x's dtype.

    The kernel reads the QuantLinear's own layout: codes (K, N) int8,
    scales and mins (K/32, N) f32, all row-major; x is (M, K) row-major."""
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul: unsupported device {x.device}")
    x2 = _flatten(x, w)
    m, k = x2.shape
    n = w.out_features
    if x.dtype not in _DTYPES:
        raise ValueError(f"dequant_matmul kernel takes f32/bf16 x, got {x.dtype}")
    if k % QK:
        raise ValueError(f"dequant_matmul kernel needs K % {QK} == 0, got K={k}")
    tensors = [w.codes, w.scales] + ([] if w.mins is None else [w.mins])
    for t, dt in zip(tensors, (torch.int8, torch.float32, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                "dequant_matmul kernel needs contiguous int8 codes and f32 "
                f"scales/mins on {x.device}, got {t.dtype} on {t.device}"
            )
    if tuple(w.scales.shape) != (k // QK, n):
        raise ValueError(f"scales {tuple(w.scales.shape)} != {(k // QK, n)}")
    if w.mins is not None and w.mins.shape != w.scales.shape:
        raise ValueError("mins and scales differ in shape")
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # the kernel loads x in 16-byte vectors
        x2 = x2.clone(memory_format=torch.contiguous_format)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vit_dequant_matmul(
            x2.data_ptr(), w.codes.data_ptr(), w.scales.data_ptr(),
            None if w.mins is None else w.mins.data_ptr(), out.data_ptr(),
            m, n, k, w.offset, _DTYPES[x.dtype],
            tile_rows(m, n, _sm_count(x.device.index)), stream,
        )
    check(rc, "dequant_matmul kernel launch")
    KERNEL.counted()
    return out.reshape(*x.shape[:-1], n)


def quant_matmul(x: torch.Tensor, w: QuantLinear, *, impl: str = "xla") -> torch.Tensor:
    """y = x @ dequant(w) for x (..., K): "pallas" runs the kernel wrapper,
    any other impl the plain dequantize + matmul (the JAX xla path)."""
    if impl == "pallas":
        return dequant_matmul(x, w)
    return dequant_matmul_plain(x, w)
