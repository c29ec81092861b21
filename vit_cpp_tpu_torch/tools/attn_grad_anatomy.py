"""Split the attention backward's time by stage, on the card.

Counterpart of tools/attn_grad_anatomy.py, whose Pallas kernel replicates
the TPU's head-pair attention backward (safe softmax) with stages
switched off one at a time. Here the replica (csrc/attn_grad_anatomy.cu)
is that design on the card's FMA units, in two launches as the port's
backward kernel csrc/attention_qkv_grad.cu has them, whose products run
on the tensor cores; one variant per call:

    full       s dot + softmax + dv/dp dots + dsoftmax + dq/dk dots
    pipe       full, two heads per block, stages interleaved across them
    pipe2      full, four heads per block (nh % 4 == 0)
    bf16exp    softmax exp2 on bf16-rounded scores, in bf16 (f32 row sum)
    nosoftmax  pn := s                  (no exp / max / sum / div)
    nodsoft    ds := dp                 (no r row sum, no pn (dp - r))
    dotsonly   both chains off
    onedot     s dot only, over each pair's lanes, stored in dq, dk, dv

pipe and pipe2 give full's output; on the card they ask whether
independent work per warp hides the latency of shared-memory operands.
Run on the card (the flagship training shape):

    python -m vit_cpp_tpu_torch.tools.attn_grad_anatomy --t 197 --h 768 --b 64

Each line gives a variant's ms per call over a chain of 400 calls (CUDA
events) and its dot rate: the FLOPs of the five products over each
head's d lanes (10 B T^2 h; onedot one fifth of it) per second.

On a CUDA tensor `grad_variant` launches the kernel (bf16, even nh,
d % 8 == 0, d <= 128; pipe and pipe2 d <= 64) or raises; on a CPU tensor
it runs the plain PyTorch version below (any float type).
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from vit_cpp_tpu_torch._build import Kernel, check, library
from vit_cpp_tpu_torch.tools import require_card, time_ms
from vit_cpp_tpu_torch.tools.attn_anatomy import exp2_bf16

VARIANTS = ("full", "pipe", "pipe2", "bf16exp", "nosoftmax", "nodsoft", "dotsonly", "onedot")

KERNEL = Kernel(
    "attn_grad_anatomy",
    source="vit_cpp_tpu_torch/csrc/attn_grad_anatomy.cu",
    replaces="tools/attn_grad_anatomy.py:184",
)

_LOG2E = 1.4426950408889634
ITERS = 400


def _geometry(qkv: torch.Tensor, do: torch.Tensor, variant: str, nh: int):
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, T, 3h), got {tuple(qkv.shape)}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    b, t, three_h = qkv.shape
    h = three_h // 3
    if nh < 2 or nh % 2 or h % nh:
        raise ValueError(f"hidden {h} must split into head pairs; got {nh} heads")
    if variant == "pipe2" and nh % 4:
        raise ValueError(f"pipe2 interleaves two head pairs: needs nh % 4 == 0, got {nh}")
    if tuple(do.shape) != (b, t, h):
        raise ValueError(f"do must be (B, T, h)={(b, t, h)}, got {tuple(do.shape)}")
    d = h // nh
    if variant == "onedot" and t < 2 * d:
        raise ValueError(f"onedot stores {2 * d} key columns: needs T >= {2 * d}, got {t}")
    return b, t, h, d


def grad_variant_plain(qkv: torch.Tensor, do: torch.Tensor, variant: str, nh: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (any device): (B, T, 3h)
    qkv and (B, T, h) dO -> (B, T, 3h) [dq | dk | dv]."""
    b, t, h, d = _geometry(qkv, do, variant, nh)
    dt = qkv.dtype
    acc = torch.promote_types(dt, torch.float32)

    def rnd(z):  # round to the input type, as the kernels cast
        return z.to(dt).to(acc)

    x = qkv.reshape(b, t, 3, nh, d).permute(2, 0, 3, 1, 4).to(acc)  # (3, B, nh, T, d)
    q, k, v = x[0], x[1], x[2]
    g = do.reshape(b, t, nh, d).permute(0, 2, 1, 3).to(acc)
    qs = rnd(q * (_LOG2E / math.sqrt(d)))
    if variant == "onedot":  # s_lo + s_hi: the scores over each pair's lanes
        def lanes(z):
            return z.reshape(b, nh // 2, 2, t, d).permute(0, 1, 3, 2, 4).reshape(b, nh // 2, t, 2 * d)

        src = (lanes(qs) @ lanes(k).transpose(-1, -2))[..., : 2 * d]
        o = src.permute(0, 2, 1, 3).reshape(b, t, h).to(dt)
        return torch.cat([o, o, o], dim=-1)
    s = qs @ k.transpose(-1, -2)  # (B, nh, T, T)
    if variant in ("nosoftmax", "dotsonly"):
        pn = s
    elif variant == "bf16exp":
        p = exp2_bf16(s - s.amax(dim=-1, keepdim=True))
        pn = p / p.sum(dim=-1, keepdim=True)
    else:
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        pn = p / p.sum(dim=-1, keepdim=True)
    dv = rnd(pn).transpose(-1, -2) @ g
    dp = g @ v.transpose(-1, -2)
    if variant in ("nodsoft", "dotsonly"):
        ds = rnd(dp)
    else:
        r = (dp * pn).sum(dim=-1, keepdim=True)
        ds = rnd(pn * (dp - r))
    nat = 1.0 / math.sqrt(d)
    dq = (ds @ k) * nat
    dk = (ds.transpose(-1, -2) @ q) * nat
    out = torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)])  # (3, B, nh, T, d)
    return out.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h)


def grad_variant(qkv: torch.Tensor, do: torch.Tensor, variant: str, nh: int) -> torch.Tensor:
    """(B, T, 3h) qkv and (B, T, h) output cotangent -> (B, T, 3h)."""
    if qkv.device.type == "cpu":
        return grad_variant_plain(qkv, do, variant, nh)
    if qkv.device.type != "cuda":
        raise ValueError(f"attn_grad_anatomy: unsupported device {qkv.device}")
    b, t, h, d = _geometry(qkv, do, variant, nh)
    if qkv.dtype != torch.bfloat16 or do.dtype != qkv.dtype or do.device != qkv.device:
        raise ValueError(f"attn_grad_anatomy kernel takes bf16 qkv and do on one card; "
                         f"got {qkv.dtype} on {qkv.device}, {do.dtype} on {do.device}")
    if d % 8 or d > 128 or (variant in ("pipe", "pipe2") and d > 64):
        raise ValueError(f"attn_grad_anatomy kernel takes d % 8 == 0, d <= 128 "
                         f"(pipe, pipe2: d <= 64); got d={d}")
    if not (qkv.is_contiguous() and do.is_contiguous()):
        raise ValueError("attn_grad_anatomy kernel needs contiguous qkv and do")
    if qkv.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("attn_grad_anatomy kernel needs 16-byte aligned qkv and do")
    dqkv = torch.empty_like(qkv)
    # per query row: max, sum p and r, from the first launch to the second
    stats = torch.empty((b, nh, t, 3), dtype=torch.float32, device=qkv.device)
    lib = library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.vit_attn_grad_anatomy(
            qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            b, t, nh, d, VARIANTS.index(variant), _LOG2E / math.sqrt(d),
            1.0 / math.sqrt(d), stream,
        )
    check(rc, "attn_grad_anatomy kernel launch")
    KERNEL.counted()
    return dqkv


def dot_flops(variant: str, b: int, t: int, h: int) -> float:
    """FLOPs of a variant's five products over each head's d lanes
    (10 B T^2 h); onedot one of them."""
    return (2.0 if variant == "onedot" else 10.0) * b * t * t * h


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=197)
    ap.add_argument("--h", type=int, default=768)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--b", type=int, default=64)
    args = ap.parse_args(argv)
    require_card("attn_grad_anatomy")
    nh = args.h // args.d
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(
        rng.standard_normal((args.b, args.t, 3 * args.h), dtype=np.float32)
    ).to("cuda", torch.bfloat16)
    do = torch.from_numpy(
        rng.standard_normal((args.b, args.t, args.h), dtype=np.float32)
    ).to("cuda", torch.bfloat16)
    for v in VARIANTS:
        ms = time_ms(lambda: grad_variant(qkv, do, v, nh), ITERS)
        rate = dot_flops(v, args.b, args.t, args.h) / (ms / 1e3) / 1e12
        print(f"{v:10s} {ms:7.3f} ms/call   dot rate {rate:6.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
