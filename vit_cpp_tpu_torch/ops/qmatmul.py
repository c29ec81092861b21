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
  kernel against on the card. bf16 x runs the bf16 body (`tile_rows`
  picks its output rows per block for the shape and the card), f32 x the
  f32 body (3xTF32 on the tensor cores, 128 x 128 blocks).

Numerics of both: the weight is dequantized in f32 as (c - offset) *
scale, then + min, rounded to x's dtype, and multiplied with f32
accumulation; y is written in x's dtype, or in f32 with `f32_out=True`
(the partial product of a row-parallel shard, ops/core.py::linear, which
rounds it only after the sum over "model"; the kernel's bf16 body writes
its accumulators unrounded). The bias is added by the caller
(ops/core.py::linear).

`dequant_matmul` goes through a PyTorch operator (_build.py::operator),
`torch.ops.vit_cpp_tpu_torch.dequant_matmul(x, codes, scales, mins,
offset, out_features, f32_out)`, whose CPU implementation is the plain version and
whose CUDA implementation launches the kernel; its fake implementation
gives the (..., N) output, so `torch.export` keeps each call as one node
of the exported program (aot.py).
"""

from __future__ import annotations

import functools

import torch

from vit_cpp_tpu_torch.gguf.dtypes import QK
from vit_cpp_tpu_torch._build import Kernel, check, library, operator
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


def _dequantize(codes, scales, mins, offset: int, dtype) -> torch.Tensor:
    """QuantLinear.dequantize from the leaf's tensors and code offset."""
    c = codes.float()
    if offset:
        c = c - offset
    w = c * scales.repeat_interleave(QK, dim=-2)
    if mins is not None:
        w = w + mins.repeat_interleave(QK, dim=-2)
    return w.to(dtype)


def _product(x2: torch.Tensor, w: torch.Tensor, f32_out: bool) -> torch.Tensor:
    """x2 @ w, rounded to x's dtype or, with f32_out, left in f32 (bf16
    products are exact in f32, so the f32 matmul is the kernel's sum)."""
    if f32_out:
        return torch.matmul(x2.float(), w.float())
    return torch.matmul(x2, w)


def dequant_matmul_plain(x: torch.Tensor, w: QuantLinear, f32_out: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel (any device); x (..., K)."""
    y = _product(_flatten(x, w), w.dequantize(x.dtype), f32_out)
    return y.reshape(*x.shape[:-1], w.out_features)


def dequant_matmul(x: torch.Tensor, w: QuantLinear, f32_out: bool = False) -> torch.Tensor:
    """x (..., K) @ dequant(w) -> (..., N) in x's dtype, or in f32 with
    `f32_out` (bf16 x: the bf16 body's f32-output instantiation).

    The kernel reads the QuantLinear's own layout: codes (K, N) int8,
    scales and mins (K/32, N) f32, all row-major; x is (M, K) row-major."""
    _flatten(x, w)
    return _DEQUANT_MATMUL(x, w.codes, w.scales, w.mins, w.offset, w.out_features, f32_out)


def _dequant_matmul_cpu(x, codes, scales, mins, offset, out_features, f32_out=False):
    k = x.shape[-1]
    y = _product(x.reshape(-1, k), _dequantize(codes, scales, mins, offset, x.dtype), f32_out)
    return y.reshape(*x.shape[:-1], out_features)


def _dequant_matmul_cuda(x, codes, scales, mins, offset, out_features, f32_out=False):
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    m, n = x2.shape[0], out_features
    if x.dtype not in _DTYPES:
        raise ValueError(f"dequant_matmul kernel takes f32/bf16 x, got {x.dtype}")
    if k % QK:
        raise ValueError(f"dequant_matmul kernel needs K % {QK} == 0, got K={k}")
    tensors = [codes, scales] + ([] if mins is None else [mins])
    for t, dt in zip(tensors, (torch.int8, torch.float32, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                "dequant_matmul kernel needs contiguous int8 codes and f32 "
                f"scales/mins on {x.device}, got {t.dtype} on {t.device}"
            )
    if tuple(scales.shape) != (k // QK, n):
        raise ValueError(f"scales {tuple(scales.shape)} != {(k // QK, n)}")
    if mins is not None and mins.shape != scales.shape:
        raise ValueError("mins and scales differ in shape")
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # both bodies read x by TMA, from a 16-byte-aligned base
        x2 = x2.clone(memory_format=torch.contiguous_format)
    # the f32 body's output is f32 already; bf16 x writes f32 by dtype code 2
    out_dtype = torch.float32 if f32_out else x.dtype
    code = 2 if f32_out and x.dtype == torch.bfloat16 else _DTYPES[x.dtype]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vit_dequant_matmul(
            x2.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            None if mins is None else mins.data_ptr(), out.data_ptr(),
            m, n, k, offset, code,
            tile_rows(m, n, _sm_count(x.device.index)), stream,
        )
    check(rc, "dequant_matmul kernel launch")
    KERNEL.counted()
    return out.reshape(*x.shape[:-1], n)


def _dequant_matmul_fake(x, codes, scales, mins, offset, out_features, f32_out=False):
    return x.new_empty((*x.shape[:-1], out_features),
                       dtype=torch.float32 if f32_out else x.dtype)


_DEQUANT_MATMUL = operator(
    "dequant_matmul(Tensor x, Tensor codes, Tensor scales, Tensor? mins, int offset, "
    "int out_features, bool f32_out=False) -> Tensor",
    cpu=_dequant_matmul_cpu, cuda=_dequant_matmul_cuda, fake=_dequant_matmul_fake,
)


def quant_matmul(x: torch.Tensor, w: QuantLinear, *, impl: str = "xla") -> torch.Tensor:
    """y = x @ dequant(w) for x (..., K): "pallas" runs the kernel wrapper,
    any other impl the plain dequantize + matmul (the JAX xla path)."""
    if impl == "pallas":
        return dequant_matmul(x, w)
    return dequant_matmul_plain(x, w)
