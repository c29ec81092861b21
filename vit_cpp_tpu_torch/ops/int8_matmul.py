"""W8A8 matmul: per-token activation quantization, an int8 x int8 -> int32
product, and a rank-1 f32 epilogue.

Counterpart of vit_cpp_tpu/ops/pallas_int8_matmul.py (`_w8a8_xla`,
`w8a8_matmul`), which the JAX package leaves to an XLA fusion rather than
a Pallas kernel:

    dynamic:  sx[m] = absmax(x[m, :]) / 127
              xq    = round(x * where(sx > 0, 1 / sx, 0))
    static:   xq    = round(clip(x / act_scale, -127, 127))
    acc = xq @ codes                      (int32, exact)
    y   = acc * sx * scale                (f32, then the input dtype)

On a K-sharded x (a row-parallel linear under a mesh, `mesh=`), the
per-token absmax is all-reduced with MAX over "model" before the codes
are formed and the int32 accumulator is all-reduced (exact) before the
epilogue runs once, so the result equals the unsharded product.

The operation order is the JAX one (multiply by the reciprocal in the
dynamic form, divide in the static form; both round half to even), so the
codes and accumulators are bit-equal to the JAX package's. The int8
product is `torch._int_mm`; a hand-written Hopper W8A8 kernel that fuses
the quantization and the epilogue is later work (ROADMAP.md).
"""

from __future__ import annotations

import torch

from vit_cpp_tpu_torch.parallel.mesh import max_over, sum_over
from vit_cpp_tpu_torch.quant.int8 import Int8Linear


def quantize_activations(x: torch.Tensor, w: Int8Linear, mesh=None):
    """x (..., K) -> (xq int8 (..., K), sx f32 (..., 1) or the static scale);
    with `mesh`, x is a K-shard and the absmax the global one."""
    xf = x.float()
    if w.act_scale is not None:
        sx = w.act_scale
        xq = torch.round(torch.clamp(xf / sx, -127.0, 127.0)).to(torch.int8)
    else:
        absmax = max_over(xf.abs().amax(dim=-1, keepdim=True), mesh)
        sx = absmax * (1.0 / 127.0)
        inv = torch.where(sx > 0, 1.0 / sx, torch.zeros_like(sx))
        xq = torch.round(xf * inv).to(torch.int8)
    return xq, sx


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_mm(xq: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 through torch._int_mm.

    On CUDA, _int_mm needs M > 16 and K, N multiples of 8, and its
    cuBLASLt int8 path on an H100 refuses K < 128 at small M (K = 64 and
    96 with N >= 32 at M = 24 and 272 raised CUBLAS_STATUS_NOT_SUPPORTED;
    K >= 128 ran every shape tried): the operands are zero-padded to
    that (the head linear has M = batch), which leaves the exact int32
    result of the real rows and columns unchanged."""
    m, k = xq.shape
    n = codes.shape[1]
    if xq.device.type != "cuda":
        return torch._int_mm(xq, codes)
    mp, kp, np_ = max(_pad_to(m, 8), 24), max(_pad_to(k, 8), 128), _pad_to(n, 8)
    if (mp, kp) != (m, k):
        xq = torch.nn.functional.pad(xq, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        codes = torch.nn.functional.pad(codes, (0, np_ - n, 0, kp - k))
    return torch._int_mm(xq, codes)[:m, :n]


def w8a8_matmul(x: torch.Tensor, w: Int8Linear, mesh=None) -> torch.Tensor:
    """y = x @ (codes * scale) with int8 arithmetic; x: (..., K), this
    rank's K-shard of a row-parallel linear with `mesh`."""
    k = x.shape[-1]
    if w.in_features != k:
        raise ValueError(
            f"w8a8 matmul: x K={k} != weight in_features={w.in_features}"
        )
    xq, sx = quantize_activations(x, w, mesh)
    acc = int8_mm(xq.reshape(-1, k), w.codes).reshape(*x.shape[:-1], -1)
    acc = sum_over(acc, mesh, "model")
    return (acc.float() * sx * w.scale).to(x.dtype)
