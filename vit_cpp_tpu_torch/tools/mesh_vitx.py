"""A sharded .vitx artifact served across several cards, against the
sharded engine it was exported from.

    python -m vit_cpp_tpu_torch.tools.mesh_vitx --mesh 2x2 [--mm int8|pallas] [--out DIR]
        [--depth 12] [--device cuda|cpu]

No JAX counterpart: the JAX package serves a sharded artifact in one
process, the port with one process per card under PyTorch's launcher.
This process starts the launcher twice, with dp x tp ranks each time:

1. `export` ranks build the synthetic ViT-B/16 engine (random weights,
   seed 0; `--mm pallas` serves its Q8_0 file through the dequantizing
   kernel, fold off, as vit-server does), shard it on the mesh, record
   its probabilities on the ten assets as a `--bucket` daemon serves a
   lone request (the image repeated to 8 rows), export it
   (aot.save_engine, -b 8,64), and time forwards at B=64 on the card
   clock (CUDA events around 20 calls after 3, on rank 0): the sharded
   engine, the artifact loaded in the same ranks, and the unsharded
   engine on rank 0's card alone;
2. `vit-server -m x.vitx --bucket` ranks serve it; this process posts the
   ten assets one at a time (client clock), compares the answered
   probabilities with the sharded engine's and stops rank 0 with
   SIGTERM, whose exit code must be 0.

The last line is one JSON object with the card's name and power limit,
the mesh and every number. Exits 1 without dp x tp CUDA cards.
`--device cpu` runs the same steps on gloo ranks (host clock), a
rehearsal at a cut `--depth`, not a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VIT_B16 = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, num_classes=1000,
               patch_size=16, img_size=224)


def _assets() -> list:
    d = os.path.join(REPO, "assets")
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith((".jpg", ".jpeg", ".png")))


def _launch(n: int, *args: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(n), "-m", *args], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))


def _events_ms(fn, device, iters: int = 20) -> float:
    """Mean ms per call of `fn` over `iters` calls after 3: CUDA events on
    a card, the host clock on the CPU."""
    for _ in range(3):
        fn()
    if device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def export_rank(model: str, mm: str, dp: int, tp: int, stem: str, device: str) -> None:
    """Step 1 on one rank of the launcher's world."""
    import torch.distributed as dist

    from vit_cpp_tpu_torch.aot import AotEngine, save_engine
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.parallel.mesh import is_leader, make_mesh, rank_device
    from vit_cpp_tpu_torch.server import decode_rgb_from_bytes

    device = rank_device(device)
    engine, _ = build_engine(model, mm=mm, device=device)
    engine.shard(make_mesh(dp * tp, dp=dp, tp=tp, device_type=device.type))
    rows = []
    for path in _assets():
        with open(path, "rb") as f:
            px = engine.preprocess_image(decode_rgb_from_bytes(f.read()))
        rows.append(engine.predict_probs_batch(torch.stack([px] * 8))[0].cpu().numpy())
    t0 = time.perf_counter()
    save_engine(engine, stem + ".vitx", [8, 64])
    res = {"export_s": time.perf_counter() - t0}
    x = torch.randn((64, 3, 224, 224), generator=torch.Generator().manual_seed(1)).to(device)
    res["engine_b64_ms"] = _events_ms(lambda: engine.predict_probs_batch(x), device)
    want = engine.predict_probs_batch(x)
    del engine
    art = AotEngine(stem + ".vitx", device=device.type)
    res["load_ms"] = art.load_ms
    res["artifact_b64_ms"] = _events_ms(lambda: art.predict_probs_batch(x), device)
    res["artifact_vs_engine_b64"] = (art.predict_probs_batch(x) - want).abs().max().item()
    del art
    if is_leader():
        one, _ = build_engine(model, mm=mm, device=device)
        res["unsharded_b64_ms"] = _events_ms(lambda: one.predict_probs_batch(x), device)
        np.save(stem + ".npy", np.stack(rows))
        with open(stem + ".json", "w") as f:
            json.dump(res, f)
    dist.barrier()


def _descendants(pid: int) -> list:
    """The pids under `pid`, depth first."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            kids = [int(c) for c in f.read().split()]
    except OSError:
        return []
    return [k for c in kids for k in (c, *_descendants(c))]


def _rank0_worker(pid: int) -> int:
    """The pid of the process under `pid` (the launcher) with LOCAL_RANK=0."""
    for child in _descendants(pid):
        with open(f"/proc/{child}/environ", "rb") as e:
            if b"LOCAL_RANK=0\0" in e.read():
                return child
    raise RuntimeError("no LOCAL_RANK=0 worker under the launcher")


def _post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def serve_artifact(stem: str, n: int, want: np.ndarray, device: str) -> dict:
    """Step 2: the daemon on the artifact, the ten assets one at a time."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = _launch(n, "vit_cpp_tpu_torch.cli.server", "-m", stem + ".vitx", "--bucket",
                   "--port", str(port), "--device", device)
    try:
        banner = ""
        while "http://" not in banner:
            banner = proc.stderr.readline()
            if not banner and proc.poll() is not None:
                raise RuntimeError(f"vit-server exited {proc.returncode}: {proc.stderr.read()}")
        url = f"http://127.0.0.1:{port}/v1/classify?topk=1000"
        got, ms = [], []
        for path in _assets():
            with open(path, "rb") as f:
                body = f.read()
            t0 = time.perf_counter()
            out = _post(url, body)
            ms.append((time.perf_counter() - t0) * 1e3)
            row = np.zeros(1000)
            for t in out["topk"]:
                row[t["id"]] = t["prob"]
            got.append(row)
        os.kill(_rank0_worker(proc.pid), signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            for pid in _descendants(proc.pid):
                os.kill(pid, signal.SIGKILL)
            proc.kill()
    got = np.stack(got)
    return {"banner": banner.strip(), "request_ms": ms, "server_exit": rc,
            "max_diff": float(np.abs(got - want).max()),
            "bit_equal": bool(np.array_equal(got, want.astype(np.float64)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="2x2", metavar="DPxTP")
    ap.add_argument("--mm", default="int8", choices=("int8", "pallas"))
    ap.add_argument("--out", default=None,
                    help="directory for the model files and the artifact (default: a "
                    "temporary one, removed at the end)")
    ap.add_argument("--depth", type=int, default=12, help="transformer blocks (ViT-B/16: 12)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--export-rank", nargs=2, metavar=("MODEL", "STEM"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from vit_cpp_tpu_torch.parallel.mesh import parse_mesh

    dp, tp = parse_mesh(args.mesh)
    if args.export_rank:
        export_rank(args.export_rank[0], args.mm, dp, tp, args.export_rank[1], args.device)
        return 0
    if args.device == "cuda" and torch.cuda.device_count() < dp * tp:
        print(f"mesh_vitx: --mesh {args.mesh} needs {dp * tp} CUDA cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if args.device == "cuda":
        from vit_cpp_tpu_torch import _build

        _build.library()  # one build here, which the ranks then load
    if args.out is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run(args, dp, tp, tmp)
    os.makedirs(args.out, exist_ok=True)
    return run(args, dp, tp, args.out)


def run(args, dp: int, tp: int, out: str) -> int:
    """Steps 1 and 2 with the files in `out`; the JSON line."""
    from vit_cpp_tpu_torch.cli import quantize
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.testing.synthetic import write_synthetic_model

    model = os.path.join(out, "vit-b16-f16.gguf")
    write_synthetic_model(model, VitHParams(**{**VIT_B16, "num_hidden_layers": args.depth}),
                          ftype=1, seed=0)
    if args.mm == "pallas":
        q8 = os.path.join(out, "vit-b16-q8_0.gguf")
        if quantize.main([model, q8, "8"]) != 0:
            raise RuntimeError("cli.quantize failed")
        model = q8
    stem = os.path.join(out, f"vit-b16-{args.mm}-{args.mesh}")
    t0 = time.perf_counter()
    proc = _launch(dp * tp, "vit_cpp_tpu_torch.tools.mesh_vitx", "--mesh", args.mesh, "--mm",
                   args.mm, "--device", args.device, "--export-rank", model, stem)
    _, err = proc.communicate(timeout=1800)
    if proc.returncode:
        print(err, file=sys.stderr)
        return 1
    with open(stem + ".json") as f:
        res = json.load(f)
    res["export_step_s"] = time.perf_counter() - t0
    res.update(serve_artifact(stem, dp * tp, np.load(stem + ".npy"), args.device))
    smi = "" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout
    res.update(mesh=args.mesh, mm=args.mm, depth=args.depth, device=args.device,
               cards=[ln.strip() for ln in smi.splitlines()][: dp * tp],
               artifact_mb=os.path.getsize(stem + ".vitx") / 1e6)
    ok = res["max_diff"] <= 1e-6 and res["server_exit"] == 0
    print(json.dumps({"ok": ok, **res}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
