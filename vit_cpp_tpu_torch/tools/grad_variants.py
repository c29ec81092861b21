"""Time variants of K2's CUDA source against one another on the card.

    python -m vit_cpp_tpu_torch.tools.grad_variants DIR [DIR ...] [--shapes 32x197 64x197 8x785]

Each DIR is a copy of vit_cpp_tpu_torch/csrc with a change to try (other
constants in a header, another schedule). The tool compiles each DIR's
attention_qkv_grad.cu (K2's C entry, vit_attention_qkv_grad) into a
library of its own, all at once with the build's flags (_build.NVCC_FLAGS),
and prints for each: ptxas's wgmma performance notes (C75xx: serialized
wgmmas, an injected wait) by kernel, and the registers and spill bytes of
its kernels whose name holds "wgmma". It holds every variant to the plain
version at five bf16 d=64 shapes (T = 1, 65 with ToMe sizes, 197, 257
with sizes, 785; within 2e-2 x max|plain|) and says whether its output
equals the first variant's bit for bit, then times the variants in turns
at each shape (B x T, ViT-B/16's 12 heads of 64, bf16): device ms per
call of a CUDA graph of a chain of calls (tools.time_ms), in the order
given and then in reverse, the mean of the two; and, at the first shape,
each launch's device us per call from torch.profiler.

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


def build(directory: str) -> tuple:
    """(library path, nvcc's output, return code) of one variant."""
    out = os.path.join(directory, "libk2variant.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", out,
           os.path.join(directory, "attention_qkv_grad.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc.stdout, proc.returncode


def entry(path: str):
    fn = ctypes.CDLL(path).vit_attention_qkv_grad
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    return fn


def call(fn, qkv: torch.Tensor, do: torch.Tensor, nh: int, sizes=None) -> torch.Tensor:
    """One bf16 call of a variant's C entry: (B, T, 3h) -> (B, T, 3h)."""
    b, t, three_h = qkv.shape
    d = three_h // 3 // nh
    out = torch.empty_like(qkv)
    stats = torch.empty((b, nh, t, 3), dtype=torch.float32, device=qkv.device)
    rc = fn(qkv.data_ptr(), do.data_ptr(), None if sizes is None else sizes.data_ptr(),
            out.data_ptr(), stats.data_ptr(), b, t, nh, d, _LOG2E / math.sqrt(d),
            1.0 / math.sqrt(d), 1, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed: CUDA error {rc}")
    return out


def main(argv=None) -> int:
    from vit_cpp_tpu_torch.ops.flash_attention import attention_qkv_grad_plain

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", help="copies of csrc/, one per variant")
    ap.add_argument("--shapes", nargs="*", default=["32x197", "64x197", "8x785"],
                    help="B x T of the timed calls")
    args = ap.parse_args(argv)
    require_card("grad_variants")
    names = [os.path.basename(os.path.normpath(d)) for d in args.dirs]
    with ThreadPoolExecutor(len(args.dirs)) as pool:
        built = list(pool.map(build, args.dirs))
    fns = {}
    for name, (path, log, rc) in zip(names, built):
        if rc != 0:
            print(f"variant {name}: nvcc failed\n{log}", flush=True)
            return 1
        usage, notes = parse_report(log)
        names_of = demangle(sorted({k for k in usage if "wgmma" in k} | {k for _, k in notes}))
        kernels = ", ".join(f"{short_name(names_of[k])} {r} registers, {s} bytes spilled"
                            for k, (r, s) in sorted(usage.items()) if "wgmma" in k)
        print(f"variant {name}: {kernels}; notes "
              f"{[(c, short_name(names_of[k])) for c, k in notes]}", flush=True)
        fns[name] = entry(path)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, t, nh, sized in CASES:
        qkv = torch.randn((b, t, 192 * nh), generator=gen, device="cuda").bfloat16()
        do = torch.randn((b, t, 64 * nh), generator=gen, device="cuda").bfloat16()
        sizes = (torch.randint(1, 5, (b, t), generator=gen, device="cuda").float()
                 if sized else None)
        ref = attention_qkv_grad_plain(qkv, do, nh, sizes=sizes).float()
        outs = {n: call(f, qkv, do, nh, sizes) for n, f in fns.items()}
        errs = {n: (o.float() - ref).abs().max().item() / ref.abs().max().item()
                for n, o in outs.items()}
        same = [n for n, o in outs.items() if torch.equal(o, outs[names[0]])]
        print(f"case B={b} T={t} nh={nh}{' sizes' if sized else ''}: max|variant - plain| / "
              f"max|plain| " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f"; equal to {names[0]} bit for bit: {same}", flush=True)
        if not all(e <= 2e-2 for e in errs.values()):
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi.splitlines()[0] if smi else 'no nvidia-smi'})"
    for i, shape in enumerate(args.shapes):
        b, t = (int(x) for x in shape.split("x"))
        qkv = torch.randn((b, t, 2304), generator=gen, device="cuda").bfloat16()
        do = torch.randn((b, t, 768), generator=gen, device="cuda").bfloat16()
        first = {n: time_ms(lambda f=f: call(f, qkv, do, 12), ITERS) for n, f in fns.items()}
        second = {n: time_ms(lambda f=fns[n]: call(f, qkv, do, 12), ITERS)
                  for n in reversed(names)}
        print(f"time B={b} T={t} bf16 on {card} (device ms per call, in turns): "
              + ", ".join(f"{n} {(first[n] + second[n]) / 2:.4f}" for n in names), flush=True)
        if i == 0:
            from torch.profiler import ProfilerActivity, profile

            for n, f in fns.items():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        call(f, qkv, do, 12)
                    torch.cuda.synchronize()
                rows = [(e.key, e.device_time_total / e.count) for e in prof.key_averages()
                        if "wgmma" in e.key]
                print(f"launches {n} B={b} T={t}: " + ", ".join(
                    f"{short_name(k)} {us:.1f} us" for k, us in rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
