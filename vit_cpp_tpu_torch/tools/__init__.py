"""Card-side diagnostics: the port's counterparts of the JAX package's
measurement tools that run a kernel of their own.

- attn_anatomy: the attention forward split by stage
  (tools/attn_anatomy.py), head-pair and lane-panel forms: each variant
  is K1's own tensor-core body (csrc/attention_body.cuh) with stages
  switched off;
- attn_grad_anatomy: the same for the attention backward
  (tools/attn_grad_anatomy.py) on K2's bf16 bodies (at d = 64
  csrc/attention_grad_bf16_wgmma.cuh, else csrc/attention_grad_body.cuh);
- probe_int8_dot: the int8 vs bf16 tensor-core product rate
  (tools/probe_int8_dot.py), on wgmma fed by TMA;
- sass_census: no JAX counterpart; each kernel's SASS instructions,
  tensor-core instructions by kind (HGMMA, IGMMA, HMMA, IMMA), registers
  and spills, beside another tree's (nvcc and cuobjdump only, no card).
- mesh_vitx: no JAX counterpart; a sharded .vitx artifact exported and
  served by vit-server across dp x tp cards under the launcher, against
  the sharded engine, with the forward's times beside one card's.
- grad_variants: no JAX counterpart; copies of csrc/ with a change each,
  K2's C entry (bf16 at d = 64) or with --entry k1 K1's (bf16 at d = 80
  and 88), with --dtype f32 either entry's f32 body at d = 88, built from
  every copy and the copies timed in turns, with ptxas's registers,
  spills and wgmma notes.

Each runs as `python -m vit_cpp_tpu_torch.tools.<name>` with the JAX
tool's flags, the first three and grad_variants on the card only: a
device timing never
falls back to the CPU. Their functions run the kernel on a CUDA tensor and the plain
PyTorch version on a CPU tensor, as every kernel wrapper of the port does.
"""

from __future__ import annotations

import sys

import torch


def require_card(tool: str) -> None:
    """Exit nonzero when there is no CUDA card: a tool's timings are device
    timings."""
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device (torch.cuda.is_available() is False); "
              "its timings are taken on the card only", file=sys.stderr)
        raise SystemExit(1)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call of `fn` over a chain of `iters` calls:
    captured once into a CUDA graph and replayed once between two CUDA
    events, so that the host's cost of each launch (tens of us through
    the Python wrapper) does not hide a short kernel, as the JAX tools
    time one compiled scan. Each call launches its kernels once: `warmup`
    direct calls, then `iters` captured ones."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
