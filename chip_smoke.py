#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: needs a CUDA card (exits nonzero without one); prints its name,
   compute capability and `nvidia-smi` name/power limit.
2. Build: compiles the port's CUDA kernels from vit_cpp_tpu_torch/csrc
   with nvcc (sm_90a) and prints the build time and ptxas's report.
3. Kernels: runs the fused-QKV attention kernel against its plain PyTorch
   version on the card at the repo's geometries (ViT-B/16, B/8, H/14,
   g/14; fast and safe softmax, key mask, ToMe sizes, bf16 and f32),
   prints each case's largest error and tolerance, and times kernel and
   plain version with CUDA events at the ViT-B/16 serving shape.
4. Slice: writes a synthetic ViT-B/16 @224 f16 checkpoint (random weights
   from a seed), builds the engine with the serving defaults (bf16, W8A8
   int8 linears, fused-QKV attention with the fast softmax, LayerNorm
   folded), starts the HTTP daemon (batch 8, warm-up), POSTs the ten
   images of assets/ concurrently, and checks every answer: status 200, a
   top-5 whose probabilities agree with an f32 dense engine on the same
   card, /stats counting every request, and 12 attention-kernel launches
   per device batch.

Every phase raises on failure, so the script exits nonzero and prints no
result. On success the last lines are a JSON line with each kernel's
numbers, the card's name and power limit, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import sys

sys.modules["jax"] = None  # the port runs without JAX: any import raises

import glob
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
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# Served top-5 probabilities vs the f32 dense engine (dtype=f32, mm=xla,
# attn=xla) on the same pixels: bf16 activations + W8A8 int8 linears move
# the probabilities of this synthetic ViT-B/16 (1000 classes, each ~0.01)
# by at most 0.00142 absolute, measured with the port's plain PyTorch path
# on the CPU over the ten assets; the limit leaves 3.5x margin.
PROB_TOL = 5e-3


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

    torch.backends.cuda.matmul.allow_tf32 = False
    times = {}
    for b in (8, 64):
        qkv = qkv_of(b, 197, 768, bf16)

        def kern():
            attention_qkv(qkv, 12, fast=True)

        def plain():
            attention_qkv_plain(qkv, 12, fast=True)

        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        times[b] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"timing attention_qkv ViT-B/16 B={b} T=197 h=768 bf16 fast on {card}: "
            f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms per call")
    return main_err, times


def post(url: str, body: bytes):
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, out = e.code, {"error": e.read().decode(errors="replace")}
    return status, out, (time.perf_counter() - t0) * 1000.0


def run_slice():
    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.server import decode_rgb_from_bytes
    from vit_cpp_tpu.testing.synthetic import write_synthetic_model
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.server import create_server

    paths = sorted(
        p for p in glob.glob(os.path.join(HERE, "assets", "*"))
        if p.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if len(paths) != 10:
        raise AssertionError(f"expected the 10 images of assets/, found {len(paths)}")
    bodies = [open(p, "rb").read() for p in paths]
    hp = VitHParams(
        hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
        num_classes=1000, patch_size=16, img_size=224,
    )
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "vit-b16-synthetic-f16.gguf")
        write_synthetic_model(model, hp, ftype=1, seed=0)
        t0 = time.perf_counter()
        engine, _ = build_engine(model, device="cuda")
        log(f"engine: ViT-B/16 @224 synthetic f16, dtype={engine.dtype} "
            f"mm={engine.mm_impl} attn={engine.attn_impl} on {engine.device}, "
            f"load {engine.load_ms:.0f} ms")
        httpd, batcher = create_server(engine, port=0, batch=8, max_wait_ms=5.0)
        log(f"daemon: warmed up and bound in {time.perf_counter() - t0:.1f} s "
            f"(port {httpd.server_port}, micro-batch 8)")
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        base = f"http://127.0.0.1:{httpd.server_port}"
        try:
            KERNEL.reset()
            with ThreadPoolExecutor(len(bodies)) as ex:
                results = list(ex.map(lambda b: post(base + "/v1/classify?topk=5", b), bodies))
            torch.cuda.synchronize()
            launches = KERNEL.launches
            with urllib.request.urlopen(base + "/stats", timeout=60) as r:
                stats = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()
            server.join(timeout=30)

        ref = VitEngine(
            model, dtype="f32", mm_impl="xla", attn_impl="xla",
            device="cuda",
        )
        worst = 0.0
        for path, body, (status, out, ms) in zip(paths, bodies, results):
            if status != 200:
                raise AssertionError(f"{os.path.basename(path)}: HTTP {status} {out}")
            top = out["topk"]
            if len(top) != 5:
                raise AssertionError(f"{path}: top-5 has {len(top)} entries")
            probs = np.array([e["prob"] for e in top])
            if not (np.isfinite(probs).all() and (np.diff(probs) <= 0).all()):
                raise AssertionError(f"{path}: bad top-5 {probs}")
            pixels = ref.preprocess_image(decode_rgb_from_bytes(body))
            want = ref.predict_probs_batch(pixels[None])[0].cpu().numpy()
            err = float(np.abs(probs - want[[e["id"] for e in top]]).max())
            worst = max(worst, err)
            log(f"request {os.path.basename(path):<14} 200 in {ms:8.1f} ms  "
                f"top-5 {[e['id'] for e in top]}  max|p - p_f32| = {err:.2e}")
        log(f"top-5 vs f32 dense engine: worst {worst:.2e} (tolerance {PROB_TOL:.0e})")
        if worst > PROB_TOL:
            raise AssertionError(f"served probabilities off by {worst} > {PROB_TOL}")
        log(f"/stats: {json.dumps(stats)}")
        if stats["requests"] != len(bodies):
            raise AssertionError(f"/stats counts {stats['requests']} requests, sent {len(bodies)}")
        if launches != 12 * stats["batches"] or launches == 0:
            raise AssertionError(
                f"attention kernel launched {launches} times for "
                f"{stats['batches']} device batches (want 12 per batch)"
            )
        log(f"attention_qkv kernel launches in the served run: {launches} "
            f"= 12 layers x {stats['batches']} device batches")
        lat = sorted(ms for _, _, ms in results)
        log(f"request latency ms: min {lat[0]:.1f} median {lat[len(lat) // 2]:.1f} "
            f"max {lat[-1]:.1f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from vit_cpp_tpu_torch import _build
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    log(f"device: {kind}, compute capability {cap[0]}.{cap[1]}, "
        f"{torch.cuda.device_count()} visible; nvidia-smi: {smi}")
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.library()
    log(f"build: {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", _build.build_log)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", _build.build_log))
    if regs:
        log(f"  ptxas: {len(regs)} kernel instantiations, {min(regs)}-{max(regs)} "
            f"registers per thread, {spills} bytes of spills")

    main_err, times = check_kernels(f"{kind} ({smi})")
    launches = run_slice()
    if "jax" in sys.modules and sys.modules["jax"] is not None:
        raise AssertionError("jax was imported")

    log(json.dumps({"kernels": [{
        "name": KERNEL.name,
        "route": "cuda",
        "source": KERNEL.source,
        "replaces": KERNEL.replaces,
        "launches": launches,
        "max_abs_err": main_err,
        "ms": times[8][0],
        "plain_ms": times[8][1],
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
