"""Attention kernels: the hand-written CUDA kernel and its plain versions.

Counterpart of two TPU kernels of vit_cpp_tpu/ops/flash_attention.py,
both served by csrc/attention_qkv.cu (built by _build.py), each through
its own C entry point and launch counter:

- `attention_qkv` (KERNEL), the one on the serving path: the (B, T, 3h)
  output of the fused QKV projection goes in, [q | k | v] on the feature
  axis with heads contiguous inside each third (timm order); (B, T, h)
  comes out, softmax(Q K^T / sqrt(d)) V per head.
- `flash_attention` (FLASH_KERNEL): the same attention in safe mode over
  pre-split (B, H, T, D) q, k, v; reached through
  ops/core.py::attention(impl="pallas"), as in the JAX package, where no
  model entry point calls it.

Which body of the kernel a call runs, at both entry points:

    bf16, d = 64, 80, 88  wgmma + TMA (csrc/attention_wgmma.cuh; at 80 and
                          88, ViT-H/14's and ViT-g/14's heads, each tile a
                          64-column box and a tail box)
    bf16, any other d     mma.sync (csrc/attention_body.cuh)
    f32, d = 64, 80, 88   3xTF32 on wgmma + TMA (csrc/attention_tf32_wgmma.cuh;
                          at 88, ViT-g/14's heads, each tile five 64-byte
                          boxes and a 32-byte tail box)
    f32, any other d      3xTF32 on mma.sync (attention_tf32, attention_qkv.cu)

`attention_qkv_mma` and `flash_attention_mma` (MMA_KERNEL) run the
mma.sync bodies at any d, in bf16 and in f32, d = 64, 80 and 88
included: for the checks only (the forward anatomy's `full`
and the wgmma body are the bf16 body bit for bit; chip_smoke.py times
each beside the wgmma body that replaced it). No path of the port calls
them.

and of the backward kernel, csrc/attention_qkv_grad.cu:

- `attention_qkv_grad` (GRAD_KERNEL): (B, T, 3h) qkv and the (B, T, h)
  output cotangent in, the (B, T, 3h) cotangent [dq | dk | dv] out, the
  softmax recomputed from qkv (no (B, nh, T, T) tensor is stored).
  `attention_qkv_train` is the differentiable attention of the training
  path: `attention_qkv` in safe mode forward, `attention_qkv_grad`
  backward.

Which body of the backward kernel a call runs:

    f32, d = 64, 80, 88  3xTF32 on wgmma + TMA (csrc/attention_grad_wgmma.cuh;
                         every training path's head: ViT-Ti/S/B/L at 64,
                         ViT-H/14 at 80, ViT-g/14 at 88)
    bf16, d = 64         bf16 wgmma + TMA (csrc/attention_grad_bf16_wgmma.cuh)
    any other call       mma.sync (csrc/attention_grad_body.cuh)

`attention_qkv_grad_mma` (GRAD_MMA_KERNEL) runs the mma.sync bodies at
any d, f32 d = 64, 80 and 88 and bf16 d = 64 included: for the checks only
(chip_smoke.py times them beside the wgmma bodies). No path of the port
calls it.

On a CUDA tensor each launches its kernel or raises; it never falls back.
On a CPU tensor each runs its plain version: the same arithmetic in plain
PyTorch (the TPU kernel's `_sdpa` math, batched over heads). The tests
hold the plain versions against the JAX functions; chip_smoke.py holds
the kernel against them on the card.

The two forward entry points are PyTorch operators (_build.py::operator):
`torch.ops.vit_cpp_tpu_torch.attention_qkv` and `...flash_attention`,
with the plain version as the CPU implementation, the kernel launch as
the CUDA one, and a fake implementation that gives the output's shape
and dtype. `torch.export` therefore records each call as one node of the
exported program (aot.py) and the loaded program launches the kernel, as
the eager forward does.

Both keep the TPU kernel's numerics: Q scaled by log2(e)/sqrt(d) in f32
and rounded to the input dtype, f32 scores, exp2 softmax (fast: scores
clamped at 120 with no row max; safe: the row max over the real keys is
subtracted), the key mask and ToMe `sizes` applied to p, an f32 row sum,
p rounded to the input dtype for P V with f32 accumulation, and the
division after P V. With `kv`, keys >= kv get zero weight and query rows
>= kv come out as zeros (the JAX kernels leave them unread garbage).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vit_cpp_tpu_torch._build import Kernel, check, library, operator

KERNEL = Kernel(
    "attention_qkv",
    source="vit_cpp_tpu_torch/csrc/attention_qkv.cu",
    replaces="vit_cpp_tpu/ops/flash_attention.py:669",
)

FLASH_KERNEL = Kernel(
    "flash_attention",
    source="vit_cpp_tpu_torch/csrc/attention_qkv.cu",
    replaces="vit_cpp_tpu/ops/flash_attention.py:1298",
)

MMA_KERNEL = Kernel(
    "attention_mma",
    source="vit_cpp_tpu_torch/csrc/attention_qkv.cu",
    replaces="vit_cpp_tpu/ops/flash_attention.py:669",
)

GRAD_KERNEL = Kernel(
    "attention_qkv_grad",
    source="vit_cpp_tpu_torch/csrc/attention_qkv_grad.cu",
    replaces="vit_cpp_tpu/ops/flash_attention.py:857",
)

GRAD_MMA_KERNEL = Kernel(
    "attention_qkv_grad_mma",
    source="vit_cpp_tpu_torch/csrc/attention_qkv_grad.cu",
    replaces="vit_cpp_tpu/ops/flash_attention.py:857",
)

_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(qkv: torch.Tensor, num_heads: int, kv, sizes):
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, T, 3h), got {tuple(qkv.shape)}")
    b, t, three_h = qkv.shape
    h = three_h // 3
    if num_heads < 1 or h % num_heads:
        raise ValueError(f"hidden {h} is not a multiple of {num_heads} heads")
    if sizes is not None and kv is not None:
        raise ValueError("sizes (tome) and kv (pad_tokens) are exclusive")
    if kv is not None and not 1 <= kv <= t:
        raise ValueError(f"kv={kv} must lie in [1, T={t}]")
    if sizes is not None and tuple(sizes.shape) != (b, t):
        raise ValueError(f"sizes must be (B, T)={(b, t)}, got {tuple(sizes.shape)}")
    return b, t, h, h // num_heads


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address, copied if it is not:
    the kernels copy their operands in 16-byte chunks."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _acc(dtype) -> torch.dtype:
    """Accumulation type of the plain versions: f32, or f64 for f64 inputs
    (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _sdpa_plain(q, k, v, *, fast: bool, sizes=None) -> torch.Tensor:
    """The kernels' arithmetic over (B, nh, n, d) q, k, v in plain PyTorch."""
    acc = _acc(q.dtype)
    scale = _LOG2E / math.sqrt(q.shape[-1])
    qs = (q.to(acc) * scale).to(q.dtype)
    s = torch.matmul(qs.to(acc), k.to(acc).transpose(-1, -2))
    if fast:
        s = torch.clamp(s, max=120.0)
    else:
        s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s)
    if sizes is not None:
        p = p * sizes.to(acc)[:, None, None, :]
    l = p.sum(dim=-1, keepdim=True)
    return (torch.matmul(p.to(q.dtype).to(acc), v.to(acc)) / l).to(q.dtype)


def attention_qkv_plain(
    qkv: torch.Tensor,
    num_heads: int,
    *,
    fast: bool = False,
    kv: Optional[int] = None,
    sizes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (any device)."""
    b, t, h, d = _check_args(qkv, num_heads, kv, sizes)
    n = t if kv is None else kv
    x = qkv[:, :n].reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    o = _sdpa_plain(x[0], x[1], x[2], fast=fast, sizes=sizes)  # (B, nh, n, d)
    o = o.permute(0, 2, 1, 3).reshape(b, n, h)
    if n < t:
        o = torch.cat([o, o.new_zeros(b, t - n, h)], dim=1)
    return o


def attention_qkv(
    qkv: torch.Tensor,
    num_heads: int,
    *,
    fast: bool = False,
    kv: Optional[int] = None,
    sizes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T, 3h) fused-projection output -> (B, T, h) attention output.

    `fast` clamps the scores at 120 instead of subtracting the row max
    (attn_impl="pallas-fast"). `kv` is the number of real tokens of a
    token-padded input. `sizes` (B, T) are ToMe merged-token counts
    (proportional attention); exclusive with `kv`."""
    _check_args(qkv, num_heads, kv, sizes)
    return _ATTENTION_QKV(qkv, num_heads, fast, kv, sizes)


def _attention_qkv_cpu(qkv, num_heads, fast, kv, sizes):
    return attention_qkv_plain(qkv, num_heads, fast=fast, kv=kv, sizes=sizes)


def _attention_qkv_cuda(qkv, num_heads, fast, kv, sizes):
    b, t, h, d = _check_args(qkv, num_heads, kv, sizes)
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"attention_qkv kernel takes f32/bf16, got {qkv.dtype}")
    if d % 8 or d > 128:
        raise ValueError(f"attention_qkv kernel takes d % 8 == 0, d <= 128; got d={d}")
    qkv = _aligned(qkv)
    if sizes is not None:
        if sizes.device != qkv.device or sizes.dtype != torch.float32:
            raise ValueError("sizes must be float32 on the qkv's device")
        if not sizes.is_contiguous():
            raise ValueError("attention_qkv kernel needs contiguous sizes")
    out = torch.empty((b, t, h), dtype=qkv.dtype, device=qkv.device)
    lib = library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.vit_attention_qkv(
            qkv.data_ptr(),
            None if sizes is None else sizes.data_ptr(),
            out.data_ptr(),
            b, t, num_heads, d, t if kv is None else kv,
            _LOG2E / math.sqrt(d), int(fast), _DTYPES[qkv.dtype],
            stream,
        )
    check(rc, "attention_qkv kernel launch")
    KERNEL.counted()
    return out


def _attention_qkv_fake(qkv, num_heads, fast, kv, sizes):
    b, t, three_h = qkv.shape
    return qkv.new_empty((b, t, three_h // 3))


_ATTENTION_QKV = operator(
    "attention_qkv(Tensor qkv, int num_heads, bool fast, int? kv, Tensor? sizes) -> Tensor",
    cpu=_attention_qkv_cpu, cuda=_attention_qkv_cuda, fake=_attention_qkv_fake,
)


def _launch_mma(q, k, v, sizes, out, geometry, fast, split) -> torch.Tensor:
    """vit_attention_mma on bf16 or f32 CUDA tensors: (B, T, nh, d, kv)."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"the mma.sync bodies take f32/bf16, got {q.dtype}")
    b, t, nh, d, kv = geometry
    if d % 8 or d > 128:
        raise ValueError(f"the mma.sync body takes d % 8 == 0, d <= 128; got d={d}")
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vit_attention_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if sizes is None else sizes.data_ptr(), out.data_ptr(),
            b, t, nh, d, kv, _LOG2E / math.sqrt(d), int(fast), int(split),
            _DTYPES[q.dtype], stream,
        )
    check(rc, "attention_mma kernel launch")
    MMA_KERNEL.counted()
    return out


def attention_qkv_mma(
    qkv: torch.Tensor,
    num_heads: int,
    *,
    fast: bool = False,
    kv: Optional[int] = None,
    sizes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`attention_qkv` through the kernel's mma.sync bodies at any d (bf16:
    attention_mma; f32: the 3xTF32 attention_tf32): for the checks only,
    never on a path. On a CPU tensor, the plain version."""
    b, t, h, d = _check_args(qkv, num_heads, kv, sizes)
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, fast=fast, kv=kv, sizes=sizes)
    qkv = _aligned(qkv)
    if sizes is not None and (sizes.dtype != torch.float32 or not sizes.is_contiguous()):
        raise ValueError("sizes must be contiguous float32")
    out = torch.empty((b, t, h), dtype=qkv.dtype, device=qkv.device)
    return _launch_mma(qkv, qkv, qkv, sizes, out, (b, t, num_heads, d, t if kv is None else kv),
                       fast, split=False)


def _check_bhtd(q, k, v):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "q, k, v must be (B, H, T, D) of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share a dtype")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the split-head kernel (any device)."""
    _check_bhtd(q, k, v)
    return _sdpa_plain(q, k, v, fast=False)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full (unmasked) attention over (B, H, T, D) q, k, v -> (B, H, T, D),
    with the safe (row-max) softmax."""
    _check_bhtd(q, k, v)
    return _FLASH_ATTENTION(q, k, v)


def _flash_attention_cuda(q, k, v):
    b, nh, t, d = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes f32/bf16, got {q.dtype}")
    if d % 8 or d > 128:
        raise ValueError(f"flash_attention kernel takes d % 8 == 0, d <= 128; got d={d}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    q, k, v = (_aligned(a) for a in (q, k, v))
    out = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vit_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, nh, t, d, _LOG2E / math.sqrt(d), _DTYPES[q.dtype], stream,
        )
    check(rc, "flash_attention kernel launch")
    FLASH_KERNEL.counted()
    return out


def flash_attention_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """`flash_attention` through the kernel's mma.sync bodies at any d
    (bf16 or f32): for the checks only, never on a path. On CPU tensors,
    the plain version."""
    _check_bhtd(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    q, k, v = (_aligned(a) for a in (q, k, v))
    b, nh, t, d = q.shape
    return _launch_mma(q, k, v, None, torch.empty_like(q), (b, t, nh, d, t), False, split=True)


_FLASH_ATTENTION = operator(
    "flash_attention(Tensor q, Tensor k, Tensor v) -> Tensor",
    cpu=flash_attention_plain, cuda=_flash_attention_cuda,
    fake=lambda q, k, v: torch.empty_like(q),
)


def attention_qkv_grad_plain(
    qkv: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    *,
    sizes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the backward kernel (any device): the
    TPU kernel's per-head math (_qkv_grad_head) batched over (B, nh)."""
    b, t, h, d = _check_args(qkv, num_heads, None, sizes)
    if tuple(do.shape) != (b, t, h):
        raise ValueError(f"do must be (B, T, h)={(b, t, h)}, got {tuple(do.shape)}")
    dt, acc = qkv.dtype, _acc(qkv.dtype)
    x = qkv.reshape(b, t, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = x[0].to(acc), x[1].to(acc), x[2].to(acc)  # (B, nh, T, d)
    g = do.to(dt).reshape(b, t, num_heads, d).permute(0, 2, 1, 3).to(acc)
    qs = (q * (_LOG2E / math.sqrt(d))).to(dt).to(acc)
    s = torch.matmul(qs, k.transpose(-1, -2))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    if sizes is not None:
        p = p * sizes.to(acc)[:, None, None, :]
    pn = p / p.sum(dim=-1, keepdim=True)
    dv = torch.matmul(pn.to(dt).to(acc).transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    r = (dp * pn).sum(dim=-1, keepdim=True)
    ds = (pn * (dp - r)).to(dt).to(acc)
    nat = 1.0 / math.sqrt(d)
    dq = torch.matmul(ds, k) * nat
    dk = torch.matmul(ds.transpose(-1, -2), q) * nat
    out = torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)])  # (3, B, nh, T, d)
    return out.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h)


def attention_qkv_grad(
    qkv: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    *,
    sizes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backward of `attention_qkv` in safe mode: (B, T, 3h) qkv and the
    (B, T, h) output cotangent `do` -> (B, T, 3h) [dq | dk | dv]. `sizes`
    (B, T) are the ToMe key weights of the forward."""
    if qkv.device.type == "cpu":
        return attention_qkv_grad_plain(qkv, do, num_heads, sizes=sizes)
    return _launch_grad(qkv, do, num_heads, sizes, mma=False)


def attention_qkv_grad_mma(
    qkv: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    *,
    sizes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`attention_qkv_grad` through the kernel's mma.sync bodies at any
    (dtype, d): for the checks only, never on a path. On a CPU tensor, the
    plain version."""
    if qkv.device.type == "cpu":
        return attention_qkv_grad_plain(qkv, do, num_heads, sizes=sizes)
    return _launch_grad(qkv, do, num_heads, sizes, mma=True)


def _launch_grad(qkv, do, num_heads, sizes, *, mma: bool) -> torch.Tensor:
    """vit_attention_qkv_grad (or, with `mma`, vit_attention_qkv_grad_mma)
    on CUDA tensors, counted on GRAD_KERNEL (GRAD_MMA_KERNEL)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_qkv_grad: unsupported device {qkv.device}")
    b, t, h, d = _check_args(qkv, num_heads, None, sizes)
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"attention_qkv_grad kernel takes f32/bf16, got {qkv.dtype}")
    if d % 8 or d > 128:
        raise ValueError(f"attention_qkv_grad kernel takes d % 8 == 0, d <= 128; got d={d}")
    if tuple(do.shape) != (b, t, h) or do.dtype != qkv.dtype or do.device != qkv.device:
        raise ValueError(
            f"do must be (B, T, h)={(b, t, h)} {qkv.dtype} on {qkv.device}, got "
            f"{tuple(do.shape)} {do.dtype} on {do.device}"
        )
    qkv, do = _aligned(qkv), _aligned(do)
    if sizes is not None:
        if sizes.device != qkv.device or sizes.dtype != torch.float32:
            raise ValueError("sizes must be float32 on the qkv's device")
        if not sizes.is_contiguous():
            raise ValueError("attention_qkv_grad kernel needs contiguous sizes")
    dqkv = torch.empty_like(qkv)
    # per query row: max, 1 / sum p and r, from the first launch to the second
    stats = torch.empty((b, num_heads, t, 3), dtype=torch.float32, device=qkv.device)
    lib = library()
    entry = lib.vit_attention_qkv_grad_mma if mma else lib.vit_attention_qkv_grad
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = entry(
            qkv.data_ptr(), do.data_ptr(),
            None if sizes is None else sizes.data_ptr(),
            dqkv.data_ptr(), stats.data_ptr(),
            b, t, num_heads, d, _LOG2E / math.sqrt(d), 1.0 / math.sqrt(d),
            _DTYPES[qkv.dtype], stream,
        )
    kernel = GRAD_MMA_KERNEL if mma else GRAD_KERNEL
    check(rc, f"{kernel.name} kernel launch")
    kernel.counted()
    return dqkv


class _AttentionQKVTrain(torch.autograd.Function):
    """Forward: `attention_qkv` in safe mode; backward: `attention_qkv_grad`.
    Only qkv is saved: the backward recomputes the softmax from it."""

    @staticmethod
    def forward(ctx, qkv, num_heads, sizes):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, sizes)
        return attention_qkv(qkv, num_heads, fast=False, sizes=sizes)

    @staticmethod
    def backward(ctx, do):
        qkv, sizes = ctx.saved_tensors
        dqkv = attention_qkv_grad(qkv, do.contiguous(), ctx.num_heads, sizes=sizes)
        # sizes come from the stop-gradient ToMe matching: no cotangent
        return dqkv, None, None


def attention_qkv_train(
    qkv: torch.Tensor, num_heads: int, sizes: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Differentiable fused attention for the training path (the JAX
    package's custom-VJP `attention_qkv_train`): safe softmax forward
    through the attention kernel, backward through the backward kernel.
    Neither direction stores a (B, nh, T, T) tensor. `sizes` (B, T) f32
    are ToMe key weights and get no gradient."""
    return _AttentionQKVTrain.apply(qkv, num_heads, sizes)
