#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: needs a CUDA card (exits nonzero without one); prints its name,
   compute capability and `nvidia-smi` name/power limit.
2. Build: compiles the port's CUDA kernels from vit_cpp_tpu_torch/csrc
   with nvcc (sm_90a, one nvcc per source, all at once) and prints the
   build time and ptxas's report.
3. Kernels, each against its plain PyTorch version on the card, with each
   case's largest error beside its stated tolerance:
   - attention_qkv (fused-QKV attention) at the repo's geometries (ViT-B/16,
     B/8, H/14, g/14; fast and safe softmax, key mask, ToMe sizes, bf16
     and f32) and at the edges of both bodies' tiling (T=1, 65, 128, 129;
     kv at a 64-key tile's edge and one past it; d=72 and 128; bf16 and
     f32);
   - dequant_matmul (block-dequantizing matmul) at the ViT-B/16 serving
     shapes in bf16 over all five block formats, one f32 case, one with
     leading dims and one with N=1001 (no vector loads on a row), then in
     every format at the edges of the bf16 body's tiling (M=1, 129, 1577;
     K=3072 and 800; N=768, 1000, 1001, 3072);
   - flash_attention (split-head attention) at (8, 12, 197, 64) in bf16
     and f32, at d=80, T=257, and at T=1, 65, 128 with d=64, 72, 128;
   - attention_qkv_grad (the attention backward) at the ViT-B/16 training
     shape B=32 in f32 (the training path's) and bf16, both with ToMe
     sizes too, ViT-Ti (3 heads), ViT-H/14 (d=80, T=257) and ViT-B/8
     (T=785), and at the edges of its tiling in f32 and bf16 (T=1, 63,
     64, 65, 129; d=72 and 128; sizes at T=65), each error relative to
     max|plain|.
   Then times kernel and plain version with CUDA events at the ViT-B/16
   serving shapes (B=8 and 64) and training shape (B=32, f32 for the
   forward, f32 and bf16 for the backward), and the attention kernels at
   T=785 too (the shape of the JAX package's lane paths).
4. Paths, each driven through the entry points a user calls, with every
   kernel's launch count set to 0 just before and read just after:
   a. the f16 W8A8 daemon: a synthetic ViT-B/16 @224 f16 checkpoint
      (random weights from a seed) served with the defaults (bf16, W8A8
      int8 linears, fused-QKV attention with the fast softmax, LayerNorm
      folded), batch 8; 12 attention launches per device batch;
   b. the block-quantized daemon: the same checkpoint quantized to Q8_0
      by vit_cpp_tpu_torch.cli.quantize and served with --mm pallas (bf16,
      fold off); 49 dequant_matmul and 12 attention launches per device
      batch;
   c. the forward of the Q8_0 file's VitEngine (bf16, fast fused
      attention, fold off) at B=8 and B=64 with --mm pallas and --mm xla:
      the median of 20 forwards each, in turns, on the host clock, and one
      profiled --mm pallas forward at B=64 (the two kernels' share of
      device time);
      then the flagship configuration on the Q8_0 file (int8, fold on),
      forward only, against the f32 reference;
   d. the split-head attention entry point, ops.core.attention(impl=
      "pallas"), over the 12 layers' worth of ViT-B/16 q, k, v (no model
      path of the JAX package reaches it);
   e. slice parity: the ViT-B/16 training loss and every parameter's
      gradient at B=2 in f32 on the card (attention_qkv forward,
      attention_qkv_grad backward) against the card machine's CPU (the
      plain versions);
   f. fine-tuning through the CLI (vit_cpp_tpu_torch.cli.finetune) on the
      f16 checkpoint of (a): 2 classes x 32 generated 224 px images (dark
      vs bright), batch 32, 3 epochs, augmentation, label smoothing, EMA
      and a checkpoint directory; 12 attention_qkv and 12
      attention_qkv_grad launches per update, finite and falling losses,
      ms per update, images/s, peak device memory and the attention
      kernels' share of device time in one profiled update; the written
      gguf is then served by VitEngine on the card.
   The daemons get the ten images of assets/ concurrently; every answer
   must be 200 with a top-5 that agrees with an f32 engine (mm=xla,
   attn=xla) on the same file and card, and /stats must count them all.
5. Diagnostics, the card-side tools of vit_cpp_tpu_torch.tools:
   every variant of attn_anatomy (head-pair form at ViT-B/16 B=128,
   lane form at B=8 T=785 w=3), of attn_grad_anatomy (B=64) and the
   probe_int8_dot product (1024^3; int8 exact) against its plain version
   on the card, each timed; then each tool's entry point, as a user runs
   it, with the launch counts set to 0 just before and read just after.
Every kernel's line gives its bound (the larger of its bytes over 3.35
TB/s and its operations over the data sheet's peak for their type: 989
TFLOP/s bf16, 1,979 TOP/s int8, and f32 at a third of TF32's 494.7
TFLOP/s, the rate of 3xTF32 products) and the time of one PyTorch call
that computes the same function, where there is one (library_ms; the
port never calls it).

Every phase raises on failure, so the script exits nonzero and prints no
result. On success the last lines are a JSON line with each kernel's
numbers, the card's name and power limit, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import sys

sys.modules["jax"] = None  # the port runs without JAX: any import raises
sys.modules["vit_cpp_tpu"] = None  # and without the JAX package

import contextlib
import glob
import io
import json
import os
import re
import subprocess
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# attention_qkv / flash_attention vs their plain versions, absolute
# (outputs are O(1)). f32: 3xTF32 products drop ~2^-22 of each product,
# the size of f32 rounding; an H100 measured <= 6e-6.
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# dequant_matmul vs its plain version (the same bf16-rounded weights, then
# torch.matmul), relative to max|plain|: the two sum in different orders
# in f32 (~1e-6 relative at K <= 3072), and a bf16 output can then round
# one step apart, which is at most 2^-7 = 7.8e-3 of max|plain|. f32
# output: summation order only.
QMM_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
# Served top-5 probabilities vs the f32 dense engine (dtype=f32, mm=xla,
# attn=xla) on the same pixels: bf16 activations + W8A8 int8 linears move
# the probabilities of this synthetic ViT-B/16 (1000 classes, each ~0.01)
# by at most 0.00142 absolute, measured with the port's plain PyTorch path
# on the CPU over the ten assets; the limit leaves 3.5x margin.
PROB_TOL = 5e-3
# Q8_0 file served with --mm pallas (bf16 activations, the dequantizing
# kernel, fused attention) vs the f32 engine (mm=xla, attn=xla) on the
# same file: only bf16 rounding of activations and weights differs. An
# H100 measured at most 3.97e-4 over the ten assets; the limit leaves
# 12x margin.
Q8_PROB_TOL = 5e-3
# The flagship configuration (int8 W8A8 requantized from Q8_0, LayerNorm
# folded, bf16) vs the same f32 engine, over all 1000 probabilities of the
# ten images: W8A8 adds a second int8 rounding of weights and per-token
# activation codes. An H100 measured at most 1.77e-3; the limit leaves
# 2.8x margin.
FLAGSHIP_TOL = 5e-3

# attention_qkv_grad vs its plain version, relative to max|plain|: f32
# differs in summation order and by 3xTF32's ~2^-22 per product (an H100
# measured <= 5e-6); bf16 can round pn and ds to a neighbouring bf16
# value (2^-8 relative) where the two sum in another order (an H100
# measured <= 2.4e-3).
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# The diagnostics' kernels vs their plain versions, relative to
# max|plain|: bf16 outputs of the same f32 arithmetic summed in another
# order round up to one bf16 step (2^-8) apart; the products of rounded
# p can add another. The int8 product must be exact.
ANATOMY_TOL = 2e-2
# The probe's bf16 product (exact products, f32 sums in another order).
PROBE_BF16_TOL = 1e-5
# The card's data-sheet rates (H100 SXM, dense), for the bounds. The
# attention kernels compute f32 products on the tensor cores as 3xTF32,
# three TF32 products each: their f32 rate is a third of TF32's.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 494.7e12 / 3, "int8": 1979e12}
# Slice parity, card vs CPU, f32 with TF32 off in cuBLAS: summation order
# and the attention kernels' 3xTF32 products (~2^-22 each).
PARITY_LOSS_RTOL = 1e-5
PARITY_GRAD_TOL = 1e-3  # max|g_card - g_cpu| / max|g_cpu| for every leaf

VIT_B16 = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    num_classes=1000, patch_size=16, img_size=224,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(what: str, card: str, kern, plain, iters: int = 50):
    """Kernel and plain version in turns (plain, kernel, kernel, plain);
    (mean kernel ms, mean plain ms)."""
    p1, k1, k2, p2 = (cuda_ms(plain, iters), cuda_ms(kern, iters), cuda_ms(kern, iters),
                      cuda_ms(plain, iters))
    log(f"timing {what} on {card}: kernel {k1:.4f} / {k2:.4f} ms, "
        f"plain {p1:.4f} / {p2:.4f} ms per call")
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(ops: float, nbytes: float, kind: str):
    """(least ms the card could take, what bounds it): each input byte
    read once and each output byte written once at the memory rate, or
    the operations at the peak rate for their type, whichever is longer."""
    t_ops, t_bytes = ops / PEAK_OPS_PER_S[kind], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _split_heads(qkv: torch.Tensor, nh: int):
    """q, k, v (B, nh, T, d) views of a (B, T, 3h) tensor."""
    b, t, three_h = qkv.shape
    return qkv.view(b, t, 3, nh, three_h // 3 // nh).permute(2, 0, 3, 1, 4)


def sdpa_ms(qkv: torch.Tensor, nh: int) -> float:
    """One scaled_dot_product_attention call on the split views (the
    library yardstick of the attention kernels)."""
    q, k, v = _split_heads(qkv, nh)
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))


def sdpa_grad_ms(qkv: torch.Tensor, do: torch.Tensor, nh: int) -> float:
    """The backward of one scaled_dot_product_attention call alone,
    torch.autograd.grad on a recorded graph."""
    q, k, v = (x.detach().contiguous().requires_grad_() for x in _split_heads(qkv, nh))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    b, t, h = do.shape
    g = do.view(b, t, nh, h // nh).permute(0, 2, 1, 3)
    return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True))


def attention_bound(b: int, t: int, h: int, esize: int):
    """K1 / K3: 4 B T^2 h operations; (B, T, 3h) in, (B, T, h) out."""
    return bound(4.0 * b * t * t * h, (3 + 1) * b * t * h * esize, "bf16" if esize == 2 else "f32")


def check_kernels(card: str):
    from vit_cpp_tpu_torch.ops.flash_attention import attention_qkv, attention_qkv_plain

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv_of(b, t, h, dtype):
        return torch.randn((b, t, 3 * h), generator=gen, device="cuda").to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, B, T, h, heads, dtype, kwargs
        ("vit-b16 fast", 8, 197, 768, 12, bf16, {"fast": True}),
        ("vit-b16 safe", 8, 197, 768, 12, bf16, {"fast": False}),
        ("kv=197 T=200 safe, garbage pad rows", 8, 200, 768, 12, bf16, {"fast": False, "kv": 197}),
        ("kv=197 T=200 fast, garbage pad rows", 8, 200, 768, 12, bf16, {"fast": True, "kv": 197}),
        ("tome sizes safe", 8, 197, 768, 12, bf16, {"fast": False, "sizes": True}),
        ("tome sizes fast", 8, 197, 768, 12, bf16, {"fast": True, "sizes": True}),
        ("vit-b8 T=785 fast", 4, 785, 768, 12, bf16, {"fast": True}),
        ("vit-h14 d=80 T=257 fast", 4, 257, 1280, 16, bf16, {"fast": True}),
        ("vit-g14 d=88 T=257 safe", 4, 257, 1408, 16, bf16, {"fast": False}),
        ("f32 vit-b16 safe", 8, 197, 768, 12, f32, {"fast": False}),
        ("f32 vit-b16 fast", 8, 197, 768, 12, f32, {"fast": True}),
        # the edges of the bf16 body's tiling: 128-query blocks of 16-row
        # warps, 64-key tiles of 16-key chunks, d padded to a multiple of 16
        ("T=1 fast", 4, 1, 768, 12, bf16, {"fast": True}),
        ("T=1 safe", 4, 1, 768, 12, bf16, {"fast": False}),
        ("T=65 safe", 4, 65, 768, 12, bf16, {"fast": False}),
        ("T=65 fast sizes", 4, 65, 768, 12, bf16, {"fast": True, "sizes": True}),
        ("T=128 fast", 4, 128, 768, 12, bf16, {"fast": True}),
        ("T=128 safe sizes", 4, 128, 768, 12, bf16, {"fast": False, "sizes": True}),
        ("T=129 safe (one past a query block)", 4, 129, 768, 12, bf16, {"fast": False}),
        ("kv=128 T=131 safe (key-tile edge)", 4, 131, 768, 12, bf16, {"fast": False, "kv": 128}),
        ("kv=129 T=131 fast (one past)", 4, 131, 768, 12, bf16, {"fast": True, "kv": 129}),
        ("kv=64 T=70 fast (key-tile edge)", 4, 70, 768, 12, bf16, {"fast": True, "kv": 64}),
        ("kv=65 T=70 safe (one past)", 4, 70, 768, 12, bf16, {"fast": False, "kv": 65}),
        ("d=72 safe (padded contraction)", 4, 197, 864, 12, bf16, {"fast": False}),
        ("d=72 fast sizes", 4, 197, 864, 12, bf16, {"fast": True, "sizes": True}),
        ("d=128 fast", 4, 197, 1536, 12, bf16, {"fast": True}),
        ("d=128 safe kv=190", 4, 197, 1536, 12, bf16, {"fast": False, "kv": 190}),
        # the edges of the f32 (3xTF32) body's tiling: the bf16 body's
        # blocks and warps, 64-key tiles of 8-key steps
        ("f32 T=1 fast", 4, 1, 768, 12, f32, {"fast": True}),
        ("f32 T=1 safe", 4, 1, 768, 12, f32, {"fast": False}),
        ("f32 T=65 safe", 4, 65, 768, 12, f32, {"fast": False}),
        ("f32 T=129 safe sizes", 4, 129, 768, 12, f32, {"fast": False, "sizes": True}),
        ("f32 kv=64 T=70 fast (key-tile edge)", 4, 70, 768, 12, f32, {"fast": True, "kv": 64}),
        ("f32 kv=65 T=70 safe (one past)", 4, 70, 768, 12, f32, {"fast": False, "kv": 65}),
        ("f32 d=72 safe (padded contraction)", 4, 197, 864, 12, f32, {"fast": False}),
        ("f32 d=128 fast sizes", 4, 197, 1536, 12, f32, {"fast": True, "sizes": True}),
        ("f32 d=128 safe kv=190", 4, 197, 1536, 12, f32, {"fast": False, "kv": 190}),
    ]
    main_err = None
    for name, b, t, h, nh, dtype, kw in cases:
        kw = dict(kw)
        qkv = qkv_of(b, t, h, dtype)
        if kw.get("kv"):
            qkv[:, kw["kv"]:] = 1e4  # adversarial pad rows
        if kw.get("sizes"):
            kw["sizes"] = torch.randint(
                1, 5, (b, t), generator=gen, device="cuda"
            ).float()
        got = attention_qkv(qkv, nh, **kw)
        ref = attention_qkv_plain(qkv, nh, **kw)
        torch.cuda.synchronize()
        if got.shape != (b, t, h) or got.dtype != dtype:
            raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = (got.float() - ref.float()).abs().max().item()
        tol = TOL[dtype]
        log(f"kernel case {name:<38} B={b} T={t} h={h} nh={nh} {str(dtype)[6:]}: "
            f"max|kernel - plain| = {err:.3e} (tolerance {tol:.0e})")
        if not err <= tol:
            raise AssertionError(f"{name}: error {err} > {tol}")
        if main_err is None:
            main_err = err

    times = {}
    # ViT-B/16 serving at B=8 and 64; T=785 is the shape of the JAX
    # package's lane path (K1')
    for b, t in ((8, 197), (64, 197), (8, 785)):
        qkv = qkv_of(b, t, 768, bf16)
        k_ms, p_ms = time_pair(
            f"attention_qkv B={b} T={t} h=768 bf16 fast", card,
            lambda: attention_qkv(qkv, 12, fast=True),
            lambda: attention_qkv_plain(qkv, 12, fast=True),
        )
        lib = sdpa_ms(qkv, 12)
        b_ms, b_by = attention_bound(b, t, 768, 2)
        log(f"attention_qkv B={b} T={t}: bound {b_ms:.4f} ms ({b_by}), library "
            f"scaled_dot_product_attention {lib:.4f} ms on {card}")
        times[(b, t)] = (k_ms, p_ms, b_ms, b_by, lib)
    # the training forward: f32, safe softmax, ViT-B/16 at B=32
    qkv = qkv_of(32, 197, 768, f32)
    k_ms, p_ms = time_pair(
        "attention_qkv B=32 T=197 h=768 f32 safe", card,
        lambda: attention_qkv(qkv, 12), lambda: attention_qkv_plain(qkv, 12),
    )
    lib = sdpa_ms(qkv, 12)
    b_ms, b_by = attention_bound(32, 197, 768, 4)
    log(f"attention_qkv B=32 T=197 f32: bound {b_ms:.4f} ms ({b_by}), library "
        f"scaled_dot_product_attention {lib:.4f} ms on {card}")
    times["f32 B=32"] = (k_ms, p_ms, b_ms, b_by, lib)
    return main_err, times


def _quant_linear(rng, k: int, n: int, qtype):
    """A random (n, k) weight quantized to `qtype` and loaded as the
    params loader loads it: a QuantLinear on the card."""
    from vit_cpp_tpu_torch.gguf.reader import TensorRecord
    from vit_cpp_tpu_torch.quant.blocks import quantize
    from vit_cpp_tpu_torch.quant.qlinear import quant_linear_from_record

    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    raw = np.frombuffer(quantize(w, qtype).tobytes(), np.uint8)
    return quant_linear_from_record(TensorRecord("w", (n, k), qtype, raw), device="cuda")


def check_dequant_matmul(card: str):
    from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType as G
    from vit_cpp_tpu_torch.ops.qmatmul import dequant_matmul, dequant_matmul_plain

    rng = np.random.default_rng(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, x shape, K, N, format, dtype
        ("qkv", (1576,), 768, 2304, G.Q8_0, bf16),
        ("proj", (1576,), 768, 768, G.Q5_0, bf16),
        ("fc1", (1576,), 768, 3072, G.Q4_1, bf16),
        ("fc2", (1576,), 3072, 768, G.Q4_0, bf16),
        ("head", (8,), 768, 1000, G.Q5_1, bf16),
        ("head N=1001 (scalar loads)", (8,), 768, 1001, G.Q8_0, bf16),
        ("f32 qkv", (1576,), 768, 2304, G.Q4_1, f32),
        ("leading dims (8, 197)", (8, 197), 768, 768, G.Q8_0, bf16),
    ]
    # the edges of the bf16 body's tiling (256- or 128-row tiles of 128
    # columns, 64-row K steps) in every block format
    for qt in (G.Q4_0, G.Q4_1, G.Q5_0, G.Q5_1, G.Q8_0):
        cases += [
            ("M=1 N=768", (1,), 768, 768, qt, bf16),
            ("M=129 fc2 K=3072", (129,), 3072, 768, qt, bf16),
            ("M=1577 N=3072", (1577,), 768, 3072, qt, bf16),
            ("M=1577 N=1000", (1577,), 768, 1000, qt, bf16),
            ("M=129 N=1001", (129,), 768, 1001, qt, bf16),
            ("M=129 K=800 (K % 64 = 32)", (129,), 800, 768, qt, bf16),
        ]
    worst = 0.0
    for name, lead, k, n, qt, dtype in cases:
        w = _quant_linear(rng, k, n, qt)
        x = torch.from_numpy(rng.standard_normal((*lead, k)).astype(np.float32)).to("cuda", dtype)
        got = dequant_matmul(x, w)
        ref = dequant_matmul_plain(x, w)
        torch.cuda.synchronize()
        if got.shape != (*lead, n) or got.dtype != dtype:
            raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = QMM_TOL[dtype] * scale
        log(f"kernel case dequant_matmul {name:<26} M={int(np.prod(lead))} K={k} N={n} "
            f"{qt.name} {str(dtype)[6:]}: max|kernel - plain| = {err:.3e} "
            f"(tolerance {tol:.3e} = {QMM_TOL[dtype]:.0e} x max|plain|)")
        if not err <= tol:
            raise AssertionError(f"dequant_matmul {name}: error {err} > {tol}")
        worst = max(worst, err)

    times = {}
    for name, m, k, n in (("qkv", 1576, 768, 2304), ("proj", 1576, 768, 768),
                          ("fc1", 1576, 768, 3072), ("fc2", 1576, 3072, 768),
                          ("qkv B=64", 12608, 768, 2304)):
        w = _quant_linear(rng, k, n, G.Q8_0)
        x = torch.randn((m, k), device="cuda").to(bf16)
        k_ms, p_ms = time_pair(
            f"dequant_matmul ViT-B/16 {name} M={m} K={k} N={n} Q8_0 bf16", card,
            lambda: dequant_matmul(x, w), lambda: dequant_matmul_plain(x, w),
        )
        dense = w.dequantize(bf16)  # once, outside the timed loop
        lib = cuda_ms(lambda: torch.matmul(x, dense))
        # x and y in bf16, the weight as Q8_0 blocks (34 bytes per 32)
        b_ms, b_by = bound(2.0 * m * k * n, 2 * m * k + k * n // 32 * 34 + 2 * m * n, "bf16")
        log(f"dequant_matmul {name}: bound {b_ms:.4f} ms ({b_by}), library torch.matmul on "
            f"the weight dequantized once {lib:.4f} ms on {card}")
        times[name] = (k_ms, p_ms, b_ms, b_by, lib)
    return worst, times


def check_flash_attention(card: str):
    from vit_cpp_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for b, nh, t, d, dtype in ((8, 12, 197, 64, torch.bfloat16),
                               (8, 12, 197, 64, torch.float32),
                               (4, 16, 257, 80, torch.bfloat16),
                               (4, 12, 1, 64, torch.bfloat16),
                               (4, 12, 65, 72, torch.bfloat16),
                               (4, 12, 128, 128, torch.bfloat16)):
        q, k, v = (torch.randn((b, nh, t, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got = flash_attention(q, k, v)
        ref = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        if got.shape != q.shape or got.dtype != dtype or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {(b, nh, t, d)}: bad output")
        err = (got.float() - ref.float()).abs().max().item()
        tol = TOL[dtype]
        log(f"kernel case flash_attention B={b} H={nh} T={t} D={d} {str(dtype)[6:]}: "
            f"max|kernel - plain| = {err:.3e} (tolerance {tol:.0e})")
        if not err <= tol:
            raise AssertionError(f"flash_attention {(b, nh, t, d)}: error {err} > {tol}")
        worst = max(worst, err)
    q, k, v = (torch.randn((8, 12, 197, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    k_ms, p_ms = time_pair(
        "flash_attention ViT-B/16 B=8 H=12 T=197 D=64 bf16", card,
        lambda: flash_attention(q, k, v), lambda: flash_attention_plain(q, k, v),
    )
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    b_ms, b_by = attention_bound(8, 197, 768, 2)
    log(f"flash_attention: bound {b_ms:.4f} ms ({b_by}), library "
        f"scaled_dot_product_attention {lib:.4f} ms on {card}")
    return worst, (k_ms, p_ms, b_ms, b_by, lib)


def check_attention_grad(card: str):
    from vit_cpp_tpu_torch.ops.flash_attention import attention_qkv_grad, attention_qkv_grad_plain

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, B, T, h, heads, dtype, ToMe sizes
        ("vit-b16 training f32", 32, 197, 768, 12, f32, False),
        ("vit-b16 training bf16", 32, 197, 768, 12, bf16, False),
        ("vit-b16 tome sizes f32", 32, 197, 768, 12, f32, True),
        ("vit-b16 tome sizes bf16", 32, 197, 768, 12, bf16, True),
        ("vit-ti nh=3 d=64", 32, 197, 192, 3, f32, False),
        ("vit-h14 d=80 T=257", 4, 257, 1280, 16, f32, False),
        ("vit-b8 T=785", 4, 785, 768, 12, f32, False),
    ]
    # the edges of the tiling (64-row blocks of 16-row warps, chunks of 32
    # (bf16 16) keys or queries, 8-wide steps, d padded to 16), both dtypes
    for dtype in (f32, bf16):
        cases += [
            (f"T=1 {str(dtype)[6:]}", 4, 1, 256, 4, dtype, False),
            (f"T=63 {str(dtype)[6:]}", 4, 63, 256, 4, dtype, False),
            (f"T=64 {str(dtype)[6:]}", 4, 64, 256, 4, dtype, False),
            (f"T=65 sizes {str(dtype)[6:]}", 4, 65, 256, 4, dtype, True),
            (f"T=129 {str(dtype)[6:]}", 4, 129, 256, 4, dtype, False),
            (f"d=72 {str(dtype)[6:]}", 4, 197, 288, 4, dtype, False),
            (f"d=128 {str(dtype)[6:]}", 4, 197, 512, 4, dtype, False),
            (f"d=128 T=65 sizes {str(dtype)[6:]}", 4, 65, 512, 4, dtype, True),
        ]
    main_err = None
    for name, b, t, h, nh, dtype, sized in cases:
        qkv = torch.randn((b, t, 3 * h), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, t, h), generator=gen, device="cuda").to(dtype)
        sizes = (torch.randint(1, 5, (b, t), generator=gen, device="cuda").float()
                 if sized else None)
        got = attention_qkv_grad(qkv, do, nh, sizes=sizes)
        ref = attention_qkv_grad_plain(qkv, do, nh, sizes=sizes)
        torch.cuda.synchronize()
        if got.shape != (b, t, 3 * h) or got.dtype != dtype or not torch.isfinite(got).all():
            raise AssertionError(f"attention_qkv_grad {name}: bad output")
        err = (got.float() - ref.float()).abs().max().item()
        tol = GRAD_TOL[dtype] * ref.float().abs().max().item()
        log(f"kernel case attention_qkv_grad {name:<24} B={b} T={t} h={h} nh={nh}: "
            f"max|kernel - plain| = {err:.3e} (tolerance {tol:.3e} = "
            f"{GRAD_TOL[dtype]:.0e} x max|plain|)")
        if not err <= tol:
            raise AssertionError(f"attention_qkv_grad {name}: error {err} > {tol}")
        if main_err is None:
            main_err = err
    times = {}
    # ViT-B/16 training at B=32; T=785 is the shape of the JAX package's
    # lane path (K2')
    for dtype, b, t in ((f32, 32, 197), (bf16, 32, 197), (f32, 4, 785)):
        qkv = torch.randn((b, t, 2304), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, t, 768), generator=gen, device="cuda").to(dtype)
        k_ms, p_ms = time_pair(
            f"attention_qkv_grad B={b} T={t} h=768 {str(dtype)[6:]}", card,
            lambda: attention_qkv_grad(qkv, do, 12),
            lambda: attention_qkv_grad_plain(qkv, do, 12),
        )
        lib = sdpa_grad_ms(qkv, do, 12)
        esize = qkv.element_size()
        # five T x T x d products per head; qkv and dO in, dqkv out
        b_ms, b_by = bound(10.0 * b * t * t * 768, (3 + 1 + 3) * b * t * 768 * esize,
                           "f32" if dtype == f32 else "bf16")
        log(f"attention_qkv_grad B={b} T={t} {str(dtype)[6:]}: bound {b_ms:.4f} ms ({b_by}), "
            f"library scaled_dot_product_attention backward {lib:.4f} ms on {card}")
        times[(dtype, t)] = (k_ms, p_ms, b_ms, b_by, lib)
    return main_err, times


def slice_parity(f32_path: str) -> None:
    """The training loss and its gradients on the card (the kernels)
    against the card machine's CPU (the plain versions), full ViT-B/16
    width, B=2, f32."""
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.parallel.train import cross_entropy_loss, tree_leaves

    hp = VitHParams(**VIT_B16)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, (2,)))
    mf = read_model(f32_path)
    out = {}
    for dev in ("cuda", "cpu"):
        params = load_params(mf, torch.float32, device=dev)
        names = _named_leaves(params)
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        KERNEL.reset()
        GRAD_KERNEL.reset()
        t0 = time.perf_counter()
        loss = cross_entropy_loss(params, x.to(dev), y.to(dev), hp)
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (loss.item(), [g.cpu() for g in grads])
        log(f"slice parity: loss and gradients on {dev} in {time.perf_counter() - t0:.2f} s, "
            f"{KERNEL.launches} attention_qkv + {GRAD_KERNEL.launches} attention_qkv_grad launches")
        if dev == "cuda" and (KERNEL.launches, GRAD_KERNEL.launches) != (12, 12):
            raise AssertionError("slice parity: the card's step did not run the kernels")
    (l_card, g_card), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    worst, worst_name = 0.0, None
    for name, a, b in zip(names, g_card, g_cpu):
        scale = b.abs().max().item()
        r = (a - b).abs().max().item() / scale if scale else (a - b).abs().max().item()
        if not np.isfinite(r) or r > PARITY_GRAD_TOL:
            raise AssertionError(f"slice parity: {name} gradient off by {r} of max|g_cpu|")
        if r >= worst:
            worst, worst_name = r, name
        log(f"slice parity: grad {name:<24} max|g_card - g_cpu| / max|g_cpu| = {r:.3e}")
    log(f"slice parity: loss card {l_card:.7f} cpu {l_cpu:.7f} (relative {rel_loss:.2e}, "
        f"bound {PARITY_LOSS_RTOL:.0e}); worst gradient {worst_name} {worst:.3e} "
        f"(bound {PARITY_GRAD_TOL:.0e}) over {len(g_cpu)} leaves")
    if not rel_loss <= PARITY_LOSS_RTOL:
        raise AssertionError(f"slice parity: loss off by {rel_loss}")


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _named_leaves(v, f"{prefix}{k}.")]
    return [] if tree is None else [prefix[:-1]]


def write_dark_bright(root: str, n_per_class: int = 32, size: int = 224) -> str:
    """Two separable classes of generated images: dark vs bright noise."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for cls, lo, hi in (("aa_dark", 0, 40), ("bb_bright", 210, 255)):
        os.makedirs(os.path.join(root, cls))
        for i in range(n_per_class):
            img = rng.integers(lo, hi, (size, size, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(root, cls, f"{i}.png"))
    return root


def kernel_functions(kernel) -> tuple:
    """The names of the __global__ functions in a kernel's source, which
    the profiler's event names contain: read from the source, so that a
    renamed function is still found."""
    with open(os.path.join(HERE, kernel.source)) as f:
        src = f.read()
    names = []
    for m in re.finditer(r"__global__\s+void\s+", src):
        rest = src[m.end():]
        if rest.startswith("__launch_bounds__"):  # skip its (nested) parentheses
            i, depth = rest.index("("), 0
            while True:
                depth += {"(": 1, ")": -1}.get(rest[i], 0)
                i += 1
                if depth == 0:
                    break
            rest = rest[i:]
        names.append(re.match(r"\s*(\w+)", rest).group(1))
    if not names:
        raise AssertionError(f"no __global__ function found in {kernel.source}")
    return tuple(names)


def device_us(prof, *kernels) -> tuple:
    """(all device us, the device us of each kernel's functions) in a
    torch.profiler run."""
    names = [kernel_functions(k) for k in kernels]
    total, each = 0.0, [0.0] * len(kernels)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        total += us
        for i, fns in enumerate(names):
            if any(fn in e.key for fn in fns):
                each[i] += us
                break
    return total, each


def profile_update(f16: str, data: str) -> None:
    """One ViT-B/16 update at B=32 (the CLI's configuration) under
    torch.profiler: the attention kernels' share of device time."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.finetune import load_dataset
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.finetune import _preprocess_all, _reinit_head
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.parallel.train import create_train_state, train_step

    mf = read_model(f16)
    params, hp = _reinit_head(load_params(mf, torch.float32, device="cuda"), mf.hparams, 2)
    state = create_train_state(params)
    paths, labels, _ = load_dataset(data)
    x = _preprocess_all(paths[:32], hp, 0, "cuda").cuda()
    y = torch.from_numpy(labels[:32]).cuda()
    train_step(state, x, y, hp, smooth=0.1)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, x, y, hp, smooth=0.1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us, (fwd_us, bwd_us) = device_us(prof, KERNEL, GRAD_KERNEL)
    attn_us = fwd_us + bwd_us
    if dev_us <= 0:
        log("profiled update: torch.profiler saw no device time (shares not measured)")
        return
    if fwd_us <= 0 or bwd_us <= 0:
        raise AssertionError(
            f"profiled update: no device time under {kernel_functions(KERNEL)} "
            f"({fwd_us} us) or {kernel_functions(GRAD_KERNEL)} ({bwd_us} us)"
        )
    log(f"profiled update (ViT-B/16 f32 B=32, torch.profiler): {dev_us / 1e3:.2f} ms of device "
        f"time in {wall_us / 1e3:.2f} ms wall (idle share {1 - dev_us / wall_us:.3f}); "
        f"attention_qkv {fwd_us / 1e3:.2f} ms + attention_qkv_grad {bwd_us / 1e3:.2f} ms = "
        f"{attn_us / dev_us:.3f} of device time")
    top = sorted(
        ((getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0), e.key)
         for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True,
    )[:8]
    for us, key in top:
        log(f"  device {us / 1e3:8.3f} ms  {key[:100]}")


def finetune_path(f16: str, tmp: str, images_per_class: int = 32):
    """vit_cpp_tpu_torch.cli.finetune on the f16 ViT-B/16 file, then the
    written gguf served by VitEngine. Returns attention_qkv_grad's
    launches in the run."""
    from vit_cpp_tpu_torch.cli import finetune as cli_finetune
    from vit_cpp_tpu_torch.decode import decode_many
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL

    data = write_dark_bright(os.path.join(tmp, "train"), images_per_class)
    out = os.path.join(tmp, "ft.gguf")
    epochs, batch = 3, 32
    updates = epochs * (2 * images_per_class // batch)
    err = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.reset()
    GRAD_KERNEL.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_finetune.main([
            "-m", f16, "-d", data, "-o", out, "-b", str(batch), "--epochs", str(epochs),
            "--augment", "all", "--label-smooth", "0.1", "--ema", "0.99",
            "--ckpt-dir", os.path.join(tmp, "ckpt"), "--device", "cuda",
        ])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (KERNEL.launches, GRAD_KERNEL.launches)
    peak = torch.cuda.max_memory_allocated()
    for line in err.getvalue().splitlines():
        log(f"cli.finetune: {line}")
    if rc != 0:
        raise AssertionError(f"cli.finetune exited {rc}")
    losses = [float(v) for v in re.findall(r"^epoch \d+/\d+: loss (\S+)", err.getvalue(), re.M)]
    timing = re.search(r"([\d.]+) ms per update after the first, ([\d.]+) training images/s",
                       err.getvalue())
    if len(losses) != epochs or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"cli.finetune losses {losses}: not finite and falling")
    if launches != (12 * updates, 12 * updates):
        raise AssertionError(
            f"cli.finetune: {launches[0]} attention_qkv and {launches[1]} attention_qkv_grad "
            f"launches for {updates} updates (want 12 each per update)"
        )
    log(f"fine-tune ViT-B/16 f32 via cli.finetune: {updates} updates of batch {batch} in "
        f"{seconds:.1f} s (load, preprocess, checkpoints and export included); "
        f"{timing.group(1)} ms per update after the first, {timing.group(2)} training "
        f"images/s; losses per epoch {losses}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches[0]} attention_qkv + {launches[1]} "
        f"attention_qkv_grad = 12 + 12 per update")
    profile_update(f16, data)

    engine = VitEngine(out, device="cuda")
    if engine.id2label != {0: "aa_dark", 1: "bb_bright"}:
        raise AssertionError(f"ft.gguf labels {engine.id2label}")
    from vit_cpp_tpu_torch.finetune import load_dataset

    paths, labels, _ = load_dataset(data)
    pixels = torch.stack([engine.preprocess_image(im) for im in decode_many(paths)])
    probs = engine.predict_probs_batch(pixels).cpu().numpy()
    if probs.shape != (len(paths), 2) or not np.isfinite(probs).all():
        raise AssertionError(f"ft.gguf: bad probabilities {probs.shape}")
    top1 = float((probs.argmax(1) == labels).mean())
    log(f"ft.gguf served by VitEngine on the card: labels {engine.id2label}, "
        f"top-1 over the {len(paths)} training images {top1:.3f}")
    return launches[1]


def post(url: str, body: bytes):
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, out = e.code, {"error": e.read().decode(errors="replace")}
    return status, out, (time.perf_counter() - t0) * 1000.0


def asset_bodies():
    paths = sorted(
        p for p in glob.glob(os.path.join(HERE, "assets", "*"))
        if p.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if len(paths) != 10:
        raise AssertionError(f"expected the 10 images of assets/, found {len(paths)}")
    return paths, [open(p, "rb").read() for p in paths]


def serve(what: str, model: str, mm: str, per_batch: dict, tol: float, images):
    """Serve the ten assets from `model` through the daemon built with
    build_engine(mm=mm) and its defaults otherwise; check every answer
    against the f32 engine on the same file (on `images`, the assets
    decoded once) and each kernel's launches (per_batch: Kernel ->
    launches per device batch). Returns {name: launches}."""
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.server import create_server

    paths, bodies = asset_bodies()
    t0 = time.perf_counter()
    engine, _ = build_engine(model, mm=mm, device="cuda")
    log(f"{what}: engine dtype={engine.dtype} mm={engine.mm_impl} "
        f"attn={engine.attn_impl} fold={engine.params['norm']['scale'] is None} "
        f"on {engine.device}, load {engine.load_ms:.0f} ms")
    httpd, batcher = create_server(engine, port=0, batch=8, max_wait_ms=5.0)
    log(f"{what}: daemon warmed up and bound in {time.perf_counter() - t0:.1f} s "
        f"(port {httpd.server_port}, micro-batch 8)")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        for kernel in per_batch:
            kernel.reset()
        with ThreadPoolExecutor(len(bodies)) as ex:
            results = list(ex.map(lambda b: post(base + "/v1/classify?topk=5", b), bodies))
        torch.cuda.synchronize()
        launches = {kernel.name: kernel.launches for kernel in per_batch}
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        server.join(timeout=30)
    del engine

    ref = VitEngine(model, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda")
    worst = 0.0
    for path, img, (status, out, ms) in zip(paths, images, results):
        if status != 200:
            raise AssertionError(f"{os.path.basename(path)}: HTTP {status} {out}")
        top = out["topk"]
        if len(top) != 5:
            raise AssertionError(f"{path}: top-5 has {len(top)} entries")
        probs = np.array([e["prob"] for e in top])
        if not (np.isfinite(probs).all() and (np.diff(probs) <= 0).all()):
            raise AssertionError(f"{path}: bad top-5 {probs}")
        pixels = ref.preprocess_image(img)
        want = ref.predict_probs_batch(pixels[None])[0].cpu().numpy()
        err = float(np.abs(probs - want[[e["id"] for e in top]]).max())
        worst = max(worst, err)
        log(f"{what}: request {os.path.basename(path):<14} 200 in {ms:8.1f} ms  "
            f"top-5 {[e['id'] for e in top]}  max|p - p_f32| = {err:.2e}")
    log(f"{what}: top-5 vs f32 engine on the same file: worst {worst:.2e} "
        f"(tolerance {tol:.0e})")
    if worst > tol:
        raise AssertionError(f"{what}: served probabilities off by {worst} > {tol}")
    log(f"{what}: /stats: {json.dumps(stats)}")
    if stats["requests"] != len(bodies):
        raise AssertionError(f"/stats counts {stats['requests']} requests, sent {len(bodies)}")
    for kernel, each in per_batch.items():
        n = launches[kernel.name]
        if n != each * stats["batches"] or n == 0:
            raise AssertionError(
                f"{what}: {kernel.name} launched {n} times for "
                f"{stats['batches']} device batches (want {each} per batch)"
            )
        log(f"{what}: {kernel.name} launches in the served run: {n} "
            f"= {each} x {stats['batches']} device batches")
    lat = sorted(ms for _, _, ms in results)
    log(f"{what}: request latency ms: min {lat[0]:.1f} median "
        f"{lat[len(lat) // 2]:.1f} max {lat[-1]:.1f}")
    return launches


def flagship_forward(q8: str, images) -> None:
    """The serving defaults (int8 W8A8 requantized from Q8_0, LayerNorm
    folded, bf16, fast fused attention) on the Q8_0 file, forward only,
    against the f32 engine on the same file."""
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine

    engine, _ = build_engine(q8, device="cuda")
    pixels = torch.stack([engine.preprocess_image(img) for img in images])
    got = engine.predict_probs_batch(pixels).cpu().numpy()
    del engine
    ref = VitEngine(q8, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda")
    want = ref.predict_probs_batch(pixels).cpu().numpy()
    if got.shape != (10, 1000) or not np.isfinite(got).all():
        raise AssertionError(f"flagship: bad probabilities {got.shape}")
    err = float(np.abs(got - want).max())
    agree = int((got.argmax(1) == want.argmax(1)).sum())
    log(f"flagship Q8_0 int8+fold forward: max|p - p_f32| over 10 x 1000 = "
        f"{err:.2e} (tolerance {FLAGSHIP_TOL:.0e}); top-1 agrees on {agree}/10")
    if err > FLAGSHIP_TOL:
        raise AssertionError(f"flagship: probabilities off by {err} > {FLAGSHIP_TOL}")


def split_head_path() -> int:
    """ops.core.attention(impl="pallas") over 12 layers' worth of ViT-B/16
    q, k, v at B=8: the split-head kernel's own entry point."""
    from vit_cpp_tpu_torch.ops.core import attention
    from vit_cpp_tpu_torch.ops.flash_attention import FLASH_KERNEL

    gen = torch.Generator(device="cuda").manual_seed(2)
    layers = [
        [torch.randn((8, 12, 197, 64), generator=gen, device="cuda").to(torch.bfloat16)
         for _ in range(3)]
        for _ in range(12)
    ]
    FLASH_KERNEL.reset()
    outs = [attention(q, k, v, impl="pallas") for q, k, v in layers]
    torch.cuda.synchronize()
    launches = FLASH_KERNEL.launches
    for (q, k, v), o in zip(layers, outs):
        ref = attention(q, k, v)  # the composed path
        err = (o.float() - ref.float()).abs().max().item()
        if not err <= TOL[torch.bfloat16]:
            raise AssertionError(f"attention(impl='pallas') vs composed: {err}")
    if launches != 12:
        raise AssertionError(f"flash_attention launched {launches} times for 12 calls")
    log(f"split-head attention entry point: 12 calls, {launches} flash_attention "
        "launches, each within 2e-2 of the composed attention")
    return launches


def check_diagnostics(card: str) -> dict:
    """Every variant of the three tools' kernels against its plain version
    at the tools' flagship shapes, timed. Returns {kernel name: (err of
    the main variant, kernel ms, plain ms, bound ms, bound by, library ms)}."""
    from vit_cpp_tpu_torch.tools import attn_anatomy as ta
    from vit_cpp_tpu_torch.tools import attn_grad_anatomy as tg
    from vit_cpp_tpu_torch.tools import probe_int8_dot as tp
    from vit_cpp_tpu_torch.tools import time_ms

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    out = {}

    def variants(kernel, shape, names, fn, plain, flops, nbytes, lib):
        """Check and time each variant; the first is the kernel's line."""
        for v in names:
            got, ref = fn(v), plain(v)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != bf16 or not torch.isfinite(got).all():
                raise AssertionError(f"{kernel.name} {v}: bad output {tuple(got.shape)} {got.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            tol = ANATOMY_TOL * ref.float().abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{kernel.name} {v}: error {err} > {tol}")
            k_ms, p_ms = time_pair(f"{kernel.name} {v} {shape} bf16", card,
                                   lambda: fn(v), lambda: plain(v), iters=10)
            b_ms, b_by = bound(flops(v), nbytes, "bf16")
            log(f"diagnostic {kernel.name} {v:<9} {shape}: max|kernel - plain| = {err:.3e} "
                f"(tolerance {tol:.3e} = {ANATOMY_TOL:.0e} x max|plain|); kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            if v == names[0]:
                out[kernel.name] = (err, k_ms, p_ms, b_ms, b_by, lib)

    for kernel, b, t, h, fn in (
        (ta.PAIR_KERNEL, 128, 197, 768, lambda x, v: ta.pair_variant(x, v, 12)),
        (ta.LANE_KERNEL, 8, 785, 768, lambda x, v: ta.lane_variant(x, v, 64)),
    ):
        qkv = torch.randn((b, t, 3 * h), generator=gen, device="cuda").to(bf16)
        plain = {ta.PAIR_KERNEL: lambda v: ta.pair_variant_plain(qkv, v, 12),
                 ta.LANE_KERNEL: lambda v: ta.lane_variant_plain(qkv, v, 64)}[kernel]
        lib = sdpa_ms(qkv, 12)
        log(f"{kernel.name} full: library scaled_dot_product_attention {lib:.4f} ms on {card}")
        variants(kernel, f"B={b} T={t} h={h}", ta.VARIANTS, lambda v: fn(qkv, v), plain,
                 lambda v: ta.dot_flops(v, b, t, h), 4 * b * t * h * 2, lib)
        del qkv

    b, t, h = 64, 197, 768
    qkv = torch.randn((b, t, 3 * h), generator=gen, device="cuda").to(bf16)
    do = torch.randn((b, t, h), generator=gen, device="cuda").to(bf16)
    lib = sdpa_grad_ms(qkv, do, 12)
    log(f"{tg.KERNEL.name} full: library scaled_dot_product_attention backward {lib:.4f} ms "
        f"on {card}")
    variants(tg.KERNEL, f"B={b} T={t} h={h}", tg.VARIANTS,
             lambda v: tg.grad_variant(qkv, do, v, 12),
             lambda v: tg.grad_variant_plain(qkv, do, v, 12),
             lambda v: tg.dot_flops(v, b, t, h), 7 * b * t * h * 2, lib)
    del qkv, do

    n = tp.M
    a8 = torch.randint(-127, 128, (n, n), generator=gen, device="cuda").to(torch.int8)
    b8 = torch.randint(-127, 128, (n, n), generator=gen, device="cuda").to(torch.int8)
    got = tp.dot(a8, b8)
    if not torch.equal(got, tp.dot_plain(a8, b8)):
        raise AssertionError("probe_int8_dot: the int8 product is not exact")
    ab, bb = a8.to(bf16), b8.to(bf16)
    got, ref = tp.dot(ab, bb), tp.dot_plain(ab, bb)
    err = (got - ref).abs().max().item()
    if not err <= PROBE_BF16_TOL * ref.abs().max().item():
        raise AssertionError(f"probe_int8_dot bf16: error {err}")
    rows = {}
    for kind, x, y, lib_fn, nbytes in (
        ("int8", a8, b8, lambda: torch._int_mm(a8, b8), (1 + 1 + 4) * n * n),
        ("bf16", ab, bb, lambda: torch.matmul(ab, bb), (2 + 2 + 4) * n * n),
    ):
        # a ~30 us call: timed as the tool times it, a CUDA graph of the
        # chain (an eager chain measures the wrapper's launch cost); in
        # turns: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (time_ms(f, 200) for f in (
            lambda: tp.dot_plain(x, y), lambda: tp.dot(x, y),
            lambda: tp.dot(x, y), lambda: tp.dot_plain(x, y)))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"timing probe_int8_dot {kind} {n}^3 (CUDA graph of 200 calls) on {card}: "
            f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms per call")
        lib = time_ms(lib_fn, 200)
        b_ms, b_by = bound(2.0 * n ** 3, nbytes, kind)
        rate = 2.0 * n ** 3 / (k_ms / 1e3) / 1e12
        log(f"diagnostic probe_int8_dot {kind} {n}^3: {rate:.1f} T{'OP' if kind == 'int8' else 'FLOP'}/s "
            f"in the kernel ({k_ms:.4f} ms), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"library {'torch._int_mm' if kind == 'int8' else 'torch.matmul'} {lib:.4f} ms")
        rows[kind] = (k_ms, p_ms, b_ms, b_by, lib)
    log(f"diagnostic probe_int8_dot: int8 exact; bf16 max|kernel - plain| = {err:.3e}; "
        f"int8 : bf16 kernel rate {rows['bf16'][0] / rows['int8'][0]:.2f}x on {card}")
    out[tp.KERNEL.name] = (0.0, *rows["int8"])
    return out


def diagnostics_path() -> dict:
    """The three tools' entry points as a user runs them, at their
    flagship flags; {kernel name: launches}."""
    from vit_cpp_tpu_torch.tools import attn_anatomy as ta
    from vit_cpp_tpu_torch.tools import attn_grad_anatomy as tg
    from vit_cpp_tpu_torch.tools import probe_int8_dot as tp

    runs = [
        ("attn_anatomy --kernel pair", ta.main,
         ["--kernel", "pair", "--t", "197", "--h", "768", "--b", "128"], ta.VARIANTS),
        ("attn_anatomy --kernel lane", ta.main,
         ["--t", "785", "--h", "768", "--b", "8", "--w", "3"], ta.VARIANTS),
        ("attn_grad_anatomy", tg.main, ["--t", "197", "--h", "768", "--b", "64"], tg.VARIANTS),
        ("probe_int8_dot", tp.main, [], ("exact=True", "in-kernel rates")),
    ]
    kernels = (ta.PAIR_KERNEL, ta.LANE_KERNEL, tg.KERNEL, tp.KERNEL)
    for kernel in kernels:
        kernel.reset()
    for label, tool_main, argv, expect in runs:
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = tool_main(argv)
        lines = text.getvalue().splitlines()
        for line in lines:
            log(f"tool {label}: {line}")
        log(f"tool {label}: {time.perf_counter() - t0:.1f} s")
        if rc != 0 or not all(any(e in line for line in lines) for e in expect):
            raise AssertionError(f"tool {label}: exit {rc}, output {lines}")
    torch.cuda.synchronize()
    launches = {kernel.name: kernel.launches for kernel in kernels}
    chain = ta.ITERS + 3  # each timing: three warm-up calls, then the chain
    want = {ta.PAIR_KERNEL.name: len(ta.VARIANTS) * chain,
            ta.LANE_KERNEL.name: len(ta.VARIANTS) * chain,
            tg.KERNEL.name: len(tg.VARIANTS) * (tg.ITERS + 3),
            tp.KERNEL.name: 1 + 2 * (tp.ITERS + 3)}
    if launches != want:
        raise AssertionError(f"tools: launches {launches}, want {want}")
    log(f"tools: launches {launches}")
    return launches


def forward_phase(q8: str, card: str) -> None:
    """The Q8_0 file's VitEngine (bf16, fused fast attention, fold off) at
    B=8 and B=64 with --mm pallas (the dequantizing kernel) and --mm xla
    (dequantize, then cuBLAS): the median of 20 forwards on the host clock,
    each ended by a synchronize, taken in turns with the other. Then one --mm pallas forward at B=64 under
    torch.profiler: the two kernels' share of its device time."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL

    engines = {mm: VitEngine(q8, dtype="bf16", attn_impl="pallas-fast", mm_impl=mm,
                             device="cuda") for mm in ("pallas", "xla")}
    gen = torch.Generator(device="cuda").manual_seed(6)
    batches = {b: torch.randn((b, 3, 224, 224), generator=gen, device="cuda") for b in (8, 64)}
    for b, pixels in batches.items():
        probs = {mm: engine.predict_probs_batch(pixels) for mm, engine in engines.items()}
        times = {mm: [] for mm in engines}
        # in turns (pallas, xla, xla, pallas), 5 forwards each: the host's
        # share of a B=8 forward drifts between calls
        for mm in ("pallas", "xla", "xla", "pallas") * 2:
            engine = engines[mm]
            engine.predict_probs_batch(pixels)
            torch.cuda.synchronize()
            for _ in range(5):
                t0 = time.perf_counter()
                engine.predict_probs_batch(pixels)
                torch.cuda.synchronize()
                times[mm].append((time.perf_counter() - t0) * 1e3)
        ms = {mm: float(np.median(t)) for mm, t in times.items()}
        err = (probs["pallas"] - probs["xla"]).abs().max().item()
        log(f"forward Q8_0 ViT-B/16 bf16 fold off B={b} (median of 20 in turns, host clock "
            f"with sync): --mm pallas {ms['pallas']:.3f} ms ({b / ms['pallas'] * 1e3:.0f} img/s, "
            f"range {min(times['pallas']):.3f}-{max(times['pallas']):.3f}), --mm xla "
            f"{ms['xla']:.3f} ms ({b / ms['xla'] * 1e3:.0f} img/s, range "
            f"{min(times['xla']):.3f}-{max(times['xla']):.3f}); "
            f"max|p_pallas - p_xla| = {err:.2e} on {card}")
        if not (torch.isfinite(probs["pallas"]).all() and err <= Q8_PROB_TOL):
            raise AssertionError(f"forward B={b}: --mm pallas vs xla probabilities off by {err}")

    engine, pixels = engines["pallas"], batches[64]
    engine.predict_probs_batch(pixels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict_probs_batch(pixels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us, (k4_us, k1_us) = device_us(prof, QMM_KERNEL, KERNEL)
    if dev_us <= 0:
        log("profiled forward: torch.profiler saw no device time (shares not measured)")
        return
    log(f"profiled --mm pallas forward B=64 (torch.profiler): {dev_us / 1e3:.2f} ms of device "
        f"time in {wall_us / 1e3:.2f} ms wall (idle share {1 - dev_us / wall_us:.3f}); "
        f"dequant_matmul {k4_us / 1e3:.2f} ms ({k4_us / dev_us:.3f}), attention_qkv "
        f"{k1_us / 1e3:.2f} ms ({k1_us / dev_us:.3f}) of device time")


def run_paths(card: str):
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.testing.synthetic import write_synthetic_model
    from vit_cpp_tpu_torch.cli import quantize
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL

    from vit_cpp_tpu_torch.server import decode_rgb_from_bytes

    images = [decode_rgb_from_bytes(b) for b in asset_bodies()[1]]
    with tempfile.TemporaryDirectory() as tmp:
        f16 = os.path.join(tmp, "vit-b16-synthetic-f16.gguf")
        q8 = os.path.join(tmp, "vit-b16-synthetic-q8_0.gguf")
        t0 = time.perf_counter()
        write_synthetic_model(f16, VitHParams(**VIT_B16), ftype=1, seed=0)
        log(f"checkpoint: ViT-B/16 @224 synthetic f16 written in {time.perf_counter() - t0:.1f} s")
        f16_launches = serve(
            "f16 W8A8 daemon", f16, "int8", {KERNEL: 12}, PROB_TOL, images
        )

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = quantize.main([f16, q8, "8"])
        lines = out.getvalue().splitlines()
        if rc != 0:
            raise AssertionError("cli.quantize failed:\n" + "\n".join(lines))
        for line in lines:
            if re.match(r"quantize_model_file: (model|quant) size|main: +quantize time", line):
                log(f"cli.quantize: {line.strip()}")
        q8_launches = serve(
            "Q8_0 --mm pallas daemon", q8, "pallas", {QMM_KERNEL: 49, KERNEL: 12},
            Q8_PROB_TOL, images,
        )
        forward_phase(q8, card)
        flagship_forward(q8, images)
        f32 = os.path.join(tmp, "vit-b16-synthetic-f32.gguf")
        write_synthetic_model(f32, VitHParams(**VIT_B16), ftype=0, seed=0)
        slice_parity(f32)
        grad_launches = finetune_path(f16, tmp)
    flash_launches = split_head_path()
    return f16_launches, q8_launches, flash_launches, grad_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from vit_cpp_tpu_torch import _build
    from vit_cpp_tpu_torch.ops.flash_attention import FLASH_KERNEL, GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the plain versions' bf16 products accumulate in f32 throughout
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    log(f"device: {kind}, compute capability {cap[0]}.{cap[1]}, "
        f"{torch.cuda.device_count()} visible; nvidia-smi: {smi}")
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.library()
    log(f"build: {os.path.relpath(lib, HERE)} from {len(_build.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", _build.build_log)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", _build.build_log))
    if regs:
        log(f"  ptxas: {len(regs)} kernel instantiations, {min(regs)}-{max(regs)} "
            f"registers per thread, {spills} bytes of spills")

    card = f"{kind} ({smi})"
    k1_err, k1_times = check_kernels(card)
    k4_err, k4_times = check_dequant_matmul(card)
    k3_err, k3_times = check_flash_attention(card)
    k2_err, k2_times = check_attention_grad(card)
    _, q8_launches, flash_launches, grad_launches = run_paths(card)
    diag = check_diagnostics(card)
    tool_launches = diagnostics_path()
    for name in ("jax", "vit_cpp_tpu"):
        if sys.modules.get(name) is not None:
            raise AssertionError(f"{name} was imported")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(kernel, launches, err, times, **more):
        """A kernel's numbers; `more`: the same numbers at other shapes or
        types, each under its own key."""
        out = {
            "name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": launches, "max_abs_err": err,
            **dict(zip(keys, times)),
        }
        for key, other in more.items():
            out[key] = dict(zip(keys, other))
        return out

    from vit_cpp_tpu_torch.tools import attn_anatomy as ta
    from vit_cpp_tpu_torch.tools import attn_grad_anatomy as tg
    from vit_cpp_tpu_torch.tools import probe_int8_dot as tp

    log(json.dumps({"kernels": [
        # K1: bf16 fast at ViT-B/16 B=8; B=64 and the training forward
        # (f32 safe, B=32) beside it
        entry(KERNEL, q8_launches[KERNEL.name], k1_err, k1_times[(8, 197)],
              b64=k1_times[(64, 197)], f32_b32=k1_times["f32 B=32"]),
        entry(QMM_KERNEL, q8_launches[QMM_KERNEL.name], k4_err, k4_times["qkv"],
              b64=k4_times["qkv B=64"]),
        entry(FLASH_KERNEL, flash_launches, k3_err, k3_times),
        # K2: f32 at ViT-B/16 B=32 (the training path's); bf16 and T=785
        # beside it
        entry(GRAD_KERNEL, grad_launches, k2_err, k2_times[(torch.float32, 197)],
              bf16=k2_times[(torch.bfloat16, 197)], t785=k2_times[(torch.float32, 785)]),
        *(entry(k, tool_launches[k.name], diag[k.name][0], diag[k.name][1:])
          for k in (ta.PAIR_KERNEL, ta.LANE_KERNEL, tg.KERNEL, tp.KERNEL)),
    ]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
