"""Time variants of K2's or K1's CUDA source against one another on the card.

    python -m vit_cpp_tpu_torch.tools.grad_variants DIR [DIR ...] [--shapes 32x197 64x197 8x785]
    python -m vit_cpp_tpu_torch.tools.grad_variants --entry k1 DIR [DIR ...] [--shapes 80x8x257]
    python -m vit_cpp_tpu_torch.tools.grad_variants [--entry k1] --dtype f32 DIR [DIR ...]

Each DIR is a copy of vit_cpp_tpu_torch/csrc with a change to try (other
constants in a header, another schedule). The tool compiles each DIR's
C entry into a library of its own, all at once with the build's flags
(_build.NVCC_FLAGS): attention_qkv_grad.cu (K2's, vit_attention_qkv_grad;
the default) or, with --entry k1, attention_qkv.cu (K1's,
vit_attention_qkv). It prints for each: ptxas's wgmma performance notes
(C75xx: serialized wgmmas, an injected wait) by kernel, and the registers
and spill bytes of its kernels whose name holds "wgmma" (K1: "wgmma_d",
the bf16 body at d = 80 and 88). It holds every variant to the plain
version at bf16 edges and says whether its output equals the first
variant's bit for bit. K2: five d=64 shapes (T = 1, 65 with ToMe sizes,
197, 257 with sizes, 785; within 2e-2 x max|plain|). K1: d = 80 and 88 at
T = 1, 65 with ToMe sizes, 257, 257 with kv = 256 and pad rows of 1e4,
577 safe (within 2e-2). With --dtype f32 both take the f32 bodies at
d = 88 (ViT-g/14's heads; kernels whose name holds "tf32_wgmma" (K1) or
"wgmma88" (K2)): K1 the same cases in f32 (within 2e-5), K2 the five
shapes with heads of 88 (within 1e-4 x max|plain|). Then it times the
variants in turns at each shape (K2: B x T, ViT-B/16's 12 heads of 64,
bf16; K1, and K2 in f32: d x B x T, 16 heads, K1 fast in bf16 and safe
in f32): device ms per call of a CUDA graph of a chain of calls
(tools.time_ms), in the order given and then in reverse, the mean of the
two; and, at the first shape, each launch's device us per call from
torch.profiler.

No JAX counterpart: it measures the port's own design choices (PERF.md
section 6 names the variants each finding compared). On the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from vit_cpp_tpu_torch._build import NVCC_FLAGS, _nvcc
from vit_cpp_tpu_torch.tools import require_card, time_ms
from vit_cpp_tpu_torch.tools.sass_census import demangle, short_name

_LOG2E = 1.4426950408889634
ITERS = 100
CASES = ((2, 1, 3, False), (2, 65, 3, True), (2, 197, 12, False), (2, 257, 3, True),
         (2, 785, 3, False))  # (B, T, heads, ToMe sizes)
K1_HEADS = 16
# (d, T, fast, ToMe sizes, kv)
K1_CASES = [(d, t, fast, sized, kv) for d in (80, 88) for t, fast, sized, kv in (
    (1, True, False, None), (65, False, True, None), (257, True, False, None),
    (257, False, False, 256), (577, False, False, None))]
# (C entry's source, key of its kernels' names, default timed shapes) by
# (entry, dtype)
ENTRIES = {("k2", "bf16"): ("attention_qkv_grad.cu", "wgmma", ["32x197", "64x197", "8x785"]),
           ("k1", "bf16"): ("attention_qkv.cu", "wgmma_d",
                            ["80x8x257", "80x64x257", "88x8x257", "88x32x257"]),
           ("k2", "f32"): ("attention_qkv_grad.cu", "wgmma88", ["88x8x257", "88x64x257"]),
           ("k1", "f32"): ("attention_qkv.cu", "tf32_wgmma", ["88x8x257", "88x64x257"])}
F32_D = 88


def parse_report(log: str) -> tuple:
    """ptxas's report of one build: ({mangled kernel: (registers, spill
    store bytes)}, [(note code, mangled kernel)] of its C75xx notes)."""
    usage, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name] = (int(m.group(1)), spill)
            name = None
    notes = sorted(set(re.findall(r"\((C75\d\d)\)[^']*'(\w+)'", log)))
    return usage, notes


def build(directory: str, source: str = "attention_qkv_grad.cu") -> tuple:
    """(library path, nvcc's output, return code) of one variant's
    `source` (K2's by default)."""
    out = os.path.join(directory, f"lib{source.split('.')[0]}_variant.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", out, os.path.join(directory, source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc.stdout, proc.returncode


def describe(name: str, log: str, key: str) -> str:
    """One variant's line from its build's ptxas report: the registers and
    spill bytes of its kernels whose name holds `key`, and its C75xx
    notes."""
    usage, notes = parse_report(log)
    names_of = demangle(sorted({k for k in usage if key in k} | {k for _, k in notes}))
    kernels = ", ".join(f"{short_name(names_of[k])} {r} registers, {s} bytes spilled"
                        for k, (r, s) in sorted(usage.items()) if key in k)
    return f"variant {name}: {kernels}; notes {[(c, short_name(names_of[k])) for c, k in notes]}"


def entry(path: str, k1: bool = False):
    """A variant library's C entry: K2's, or with `k1` K1's."""
    if k1:
        fn = ctypes.CDLL(path).vit_attention_qkv
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    else:
        fn = ctypes.CDLL(path).vit_attention_qkv_grad
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _dtype_code(x: torch.Tensor) -> int:
    return 0 if x.dtype == torch.float32 else 1


def call(fn, qkv: torch.Tensor, do: torch.Tensor, nh: int, sizes=None) -> torch.Tensor:
    """One call of a variant's K2 entry: (B, T, 3h) -> (B, T, 3h)."""
    b, t, three_h = qkv.shape
    d = three_h // 3 // nh
    out = torch.empty_like(qkv)
    stats = torch.empty((b, nh, t, 3), dtype=torch.float32, device=qkv.device)
    rc = fn(qkv.data_ptr(), do.data_ptr(), None if sizes is None else sizes.data_ptr(),
            out.data_ptr(), stats.data_ptr(), b, t, nh, d, _LOG2E / math.sqrt(d),
            1.0 / math.sqrt(d), _dtype_code(qkv), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed: CUDA error {rc}")
    return out


def call_k1(fn, qkv: torch.Tensor, nh: int, fast: bool, sizes=None, kv=None) -> torch.Tensor:
    """One call of a variant's K1 entry: (B, T, 3h) -> (B, T, h)."""
    b, t, three_h = qkv.shape
    d = three_h // 3 // nh
    out = torch.empty((b, t, three_h // 3), dtype=qkv.dtype, device=qkv.device)
    rc = fn(qkv.data_ptr(), None if sizes is None else sizes.data_ptr(), out.data_ptr(), b, t,
            nh, d, t if kv is None else kv, _LOG2E / math.sqrt(d), int(fast), _dtype_code(qkv),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed: CUDA error {rc}")
    return out


def edges(gen, k1: bool, f32: bool):
    """The checked cases: (label, call of a variant's entry, plain output,
    the scale its error is divided by, the tolerance)."""
    from vit_cpp_tpu_torch.ops.flash_attention import (attention_qkv_grad_plain,
                                                       attention_qkv_plain)

    dtype = torch.float32 if f32 else torch.bfloat16
    if k1:
        for d, t, fast, sized, kv in K1_CASES:
            if f32 and d != F32_D:
                continue
            qkv = torch.randn((2, t, 3 * K1_HEADS * d), generator=gen, device="cuda").to(dtype)
            if kv is not None:
                qkv[:, kv:] = 1e4
            sizes = (torch.randint(1, 5, (2, t), generator=gen, device="cuda").float()
                     if sized else None)
            ref = attention_qkv_plain(qkv, K1_HEADS, fast=fast, sizes=sizes, kv=kv).float()
            yield (f"d={d} T={t} {'fast' if fast else 'safe'}{' sizes' if sized else ''}"
                   f"{f' kv={kv}' if kv else ''}: max|variant - plain|",
                   lambda f, qkv=qkv, fast=fast, sizes=sizes, kv=kv:
                   call_k1(f, qkv, K1_HEADS, fast, sizes, kv), ref, 1.0, 2e-5 if f32 else 2e-2)
        return
    d = F32_D if f32 else 64
    for b, t, nh, sized in CASES:
        qkv = torch.randn((b, t, 3 * d * nh), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, t, d * nh), generator=gen, device="cuda").to(dtype)
        sizes = (torch.randint(1, 5, (b, t), generator=gen, device="cuda").float()
                 if sized else None)
        ref = attention_qkv_grad_plain(qkv, do, nh, sizes=sizes).float()
        yield (f"B={b} T={t} nh={nh}{' sizes' if sized else ''}: max|variant - plain| / "
               "max|plain|", lambda f, qkv=qkv, do=do, nh=nh, sizes=sizes:
               call(f, qkv, do, nh, sizes), ref, ref.abs().max().item(), 1e-4 if f32 else 2e-2)


def timed(shape: str, gen, k1: bool, f32: bool) -> tuple:
    """A timed shape's (label, call of a variant's entry)."""
    if f32:
        d, b, t = (int(x) for x in shape.split("x"))
        qkv = torch.randn((b, t, 3 * K1_HEADS * d), generator=gen, device="cuda")
        if k1:
            return f"d={d} B={b} T={t} f32 safe", lambda f: call_k1(f, qkv, K1_HEADS, False)
        do = torch.randn((b, t, K1_HEADS * d), generator=gen, device="cuda")
        return f"d={d} B={b} T={t} f32", lambda f: call(f, qkv, do, K1_HEADS)
    if k1:
        d, b, t = (int(x) for x in shape.split("x"))
        qkv = torch.randn((b, t, 3 * K1_HEADS * d), generator=gen, device="cuda").bfloat16()
        return f"d={d} B={b} T={t} bf16 fast", lambda f: call_k1(f, qkv, K1_HEADS, True)
    b, t = (int(x) for x in shape.split("x"))
    qkv = torch.randn((b, t, 2304), generator=gen, device="cuda").bfloat16()
    do = torch.randn((b, t, 768), generator=gen, device="cuda").bfloat16()
    return f"B={b} T={t} bf16", lambda f: call(f, qkv, do, 12)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", help="copies of csrc/, one per variant")
    ap.add_argument("--entry", choices=("k1", "k2"), default="k2",
                    help="the C entry built and timed: K2's (bf16 d=64) or K1's (bf16 d=80, 88)")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                    help="f32: the entry's f32 body at d=88")
    ap.add_argument("--shapes", nargs="*",
                    help="timed calls: B x T (k2; default 32x197 64x197 8x785) or d x B x T "
                         "(k1; default 80x8x257 80x64x257 88x8x257 88x32x257; f32: "
                         "88x8x257 88x64x257)")
    args = ap.parse_args(argv)
    require_card("grad_variants")
    source, key, shapes = ENTRIES[(args.entry, args.dtype)]
    k1, f32 = args.entry == "k1", args.dtype == "f32"
    names = [os.path.basename(os.path.normpath(d)) for d in args.dirs]
    with ThreadPoolExecutor(len(args.dirs)) as pool:
        built = list(pool.map(lambda d: build(d, source), args.dirs))
    fns = {}
    for name, (path, log, rc) in zip(names, built):
        if rc != 0:
            print(f"variant {name}: nvcc failed\n{log}", flush=True)
            return 1
        print(describe(name, log, key), flush=True)
        fns[name] = entry(path, k1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, run, ref, scale, tol in edges(gen, k1, f32):
        outs = {n: run(f) for n, f in fns.items()}
        errs = {n: (o.float() - ref).abs().max().item() / scale for n, o in outs.items()}
        same = [n for n, o in outs.items() if torch.equal(o, outs[names[0]])]
        print(f"case {label} " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f"; equal to {names[0]} bit for bit: {same}", flush=True)
        if not all(e <= tol for e in errs.values()):
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi.splitlines()[0] if smi else 'no nvidia-smi'})"
    for i, shape in enumerate(args.shapes or shapes):
        label, run = timed(shape, gen, k1, f32)
        first = {n: time_ms(lambda f=f: run(f), ITERS) for n, f in fns.items()}
        second = {n: time_ms(lambda f=fns[n]: run(f), ITERS) for n in reversed(names)}
        print(f"time {label} on {card} (device ms per call, in turns): "
              + ", ".join(f"{n} {(first[n] + second[n]) / 2:.4f}" for n in names), flush=True)
        if i == 0:
            from torch.profiler import ProfilerActivity, profile

            for n, f in fns.items():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        run(f)
                    torch.cuda.synchronize()
                rows = [(e.key, e.device_time_total / e.count) for e in prof.key_averages()
                        if "wgmma" in e.key]
                print(f"launches {n} {label}: " + ", ".join(
                    f"{short_name(k)} {us:.1f} us" for k, us in rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
