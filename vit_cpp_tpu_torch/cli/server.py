"""HTTP inference daemon on the PyTorch port.

Counterpart of `vit-server` (vit_cpp_tpu/cli/server.py), with the same
flags and defaults plus --device. It serves f16/f32 and block-quantized
(Q4_0/Q4_1/Q5_0/Q5_1/Q8_0, written by vit_cpp_tpu_torch.cli.quantize)
checkpoints: `--mm int8` (the default) requantizes the weights to W8A8
at load, `--mm pallas` runs them through the dequantizing-matmul kernel;
`--act static` serves W8A8 with static activation scales, calibrated on
--calib-dir or read from --act-scales (the daemon warms up on a dummy
batch, so one of the two is required). A headless encoder
(num_classes=0) serves POST /v1/embed only; a classifier serves
/v1/classify and /v1/embed, a ViTSTR checkpoint /v1/recognize and
/v1/embed. `-m name=path`, repeated, serves several models from one
daemon under /v1/<name>/classify (or /recognize) and /v1/<name>/embed.
`--img-size` / `--patch-size` serve every gguf model at another geometry
(models/resample.py), `--tome R` with R token pairs merged per layer
(ops/tome.py). `-m model.vitx` (or name=model.vitx) serves a port-made
AOT artifact (aot.py) at its baked batch, `--bucket` over its baked sizes.
`--mesh DPxTP` (one model, under a launcher) shards the engine over the
launcher's ranks: rank 0 runs the daemon and broadcasts each batch, the
other ranks follow it (server.py::MeshLeader, follow) until it shuts
down; a rank that fails makes the daemon exit 1. A sharded .vitx artifact
(aot.save_engine of a sharded engine) brings its own mesh and is served
the same way under the launcher, as the only model; `--mesh` with a
.vitx is refused, as in the JAX tool. `--compile-cache` raises (PyTorch
has no compile cache).

Usage:
  python -m vit_cpp_tpu_torch.cli.server -m model-q8_0.gguf [--mm pallas] [--device cuda] --port 8000
  curl -s -X POST --data-binary @magpie.jpeg localhost:8000/v1/classify?topk=5
  python -m vit_cpp_tpu_torch.cli.server -m a=model-f16.gguf -m b=model-q8_0.gguf --act static --calib-dir calib/
  curl -s -X POST --data-binary @magpie.jpeg localhost:8000/v1/b/classify
  python -m vit_cpp_tpu_torch.cli.server -m cls=model.gguf -m ocr=vitstr.gguf
  curl -s -X POST --data-binary @demo_1.png localhost:8000/v1/ocr/recognize
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m vit_cpp_tpu_torch.cli.server -m model.gguf --mesh 2x2 [--device cpu]
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m vit_cpp_tpu_torch.cli.server -m sharded_2x2.vitx [--device cpu]
"""

from __future__ import annotations

import argparse
import signal
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", required=True, action="append",
                    help="gguf checkpoint; repeat with name=path to serve several "
                    "models from one daemon (routes /v1/<name>/classify|"
                    "recognize|embed): -m cls=model.gguf -m ocr=vitstr.gguf")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("-b", "--batch", type=int, default=8,
                    help="micro-batch size (requests coalesced per device step)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="max time the batcher waits to fill a batch")
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="bf16")
    ap.add_argument("--mm", choices=["xla", "pallas", "int8"], default="int8")
    ap.add_argument("--attn", choices=["xla", "pallas", "pallas-fast"],
                    default="pallas-fast")
    ap.add_argument("--fold-ln", action=argparse.BooleanOptionalAction, default=None)
    ap.add_argument("--act", choices=["dynamic", "static"], default="dynamic",
                    help="int8 activation quantization: 'static' serves with "
                    "calibrated per-site scales and needs --calib-dir or "
                    "--act-scales; a guardrail rejection falls back to dynamic")
    ap.add_argument("--calib-dir", metavar="DIR",
                    help="representative images for --act static (up to 16 used)")
    ap.add_argument("--act-scales", metavar="FILE",
                    help="pre-measured static scales (a sidecar JSON) for --act static")
    ap.add_argument("--img-size", type=int, default=None, metavar="PX",
                    help="serve at another resolution: the pos_embed grid is "
                    "resampled bicubically and inputs resized to PX x PX (a "
                    "multiple of the patch size; gguf classifiers only)")
    ap.add_argument("--patch-size", type=int, default=None, metavar="P",
                    help="serve at another patch size: the patch-embedding kernel "
                    "is PI-resized and the pos_embed grid follows (gguf "
                    "classifiers only)")
    ap.add_argument("--tome", type=int, default=0, metavar="R",
                    help="ToMe token merging (ops/tome.py) on every gguf classifier "
                    "served: merge R most-similar patch-token pairs per layer")
    ap.add_argument("--mesh", metavar="DPxTP", default=None)
    ap.add_argument("--request-timeout", type=float, default=30.0,
                    help="per-request wait on the device queue, seconds")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="reject with 503 beyond this many queued requests (0 = unbounded)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the pre-bind warmup batch")
    ap.add_argument("--bucket", action="store_true",
                    help="pad coalesced requests to the next power-of-2 bucket")
    ap.add_argument("--compile-cache", nargs="?", const="", default=None, metavar="DIR")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                    "the plain PyTorch versions of the kernels)")
    return ap


def _engine(args, path: str, who: str, multi: bool = False):
    """build_engine with the flags, then static calibration on --calib-dir
    when asked; None after printing the error on a bad model or set. In a
    multi-model daemon a .vitx artifact skips the geometry flags and
    --tome with a notice, as the JAX daemon does (its graph was baked at
    export)."""
    from vit_cpp_tpu_torch.cli.common import (
        build_engine,
        calibrate_engine_from_paths,
        is_vitx,
    )

    img_size, patch_size, tome = args.img_size, args.patch_size, args.tome
    if multi and is_vitx(path) and (img_size is not None or patch_size is not None):
        skipped = [f"{flag} {v}" for flag, v in (("--img-size", img_size),
                                                 ("--patch-size", patch_size)) if v is not None]
        print(f"{who}.vitx geometry is baked at export; ignoring {' '.join(skipped)}",
              file=sys.stderr)
        img_size = patch_size = None
    if multi and is_vitx(path) and tome:
        print(f"{who}.vitx graph is baked at export; ignoring --tome {tome} (use "
              "vit-export --tome)", file=sys.stderr)
        tome = 0
    try:
        engine, _ = build_engine(
            path, dtype=args.dtype, mm=args.mm, attn=args.attn,
            fold_ln=args.fold_ln, act=args.act, act_scales=args.act_scales,
            img_size=img_size, patch_size=patch_size,
            tome=tome, device=args.device,
        )
        if args.act == "static" and not args.act_scales:
            if not calibrate_engine_from_paths(engine, args.calib_dir):
                print(f"{who}static calibration rejected by the guardrail; "
                      "serving dynamic", file=sys.stderr)
    except ValueError as e:
        print(f"{who}{e}", file=sys.stderr)
        return None
    return engine


def _mesh_devices(path: str) -> int:
    """The devices of a .vitx artifact's mesh: 1 unless it is sharded."""
    from vit_cpp_tpu_torch.cli.common import read_meta

    try:
        sizes = read_meta(path).get("mesh", {}).get("axis_sizes", [1])
    except ValueError:  # a bad header: the engine's load reports it
        return 1
    n = 1
    for size in sizes:
        n *= int(size)
    return n


def _artifact_buckets(args, engine, notice: str):
    """--bucket on a .vitx artifact: its baked batch sizes, or off with
    `notice` when it bakes one."""
    if not args.bucket:
        return False
    if len(engine.batches) > 1:
        return engine.batches
    print(notice, file=sys.stderr)
    return False


def _artifact(args, path: str):
    """The single-model daemon on a .vitx artifact (vit_cpp_tpu/cli/
    server.py): the knobs and batch sizes were baked at export, so the
    micro-batcher takes the artifact's batch and --bucket its baked
    sizes; --act static exits 1. None after printing an error. A sharded
    artifact's engine runs on every rank of the launcher's world; only the
    leader prints its notices."""
    from vit_cpp_tpu_torch.aot import AotEngine
    from vit_cpp_tpu_torch.parallel.mesh import is_leader

    if args.act == "static":
        print("--act static does not apply to a .vitx artifact — its "
              "scales were baked at export (vit-export --act static)", file=sys.stderr)
        return None
    try:
        engine = AotEngine(path, device=args.device)
    except ValueError as e:  # a JAX-made artifact, another device's, too few ranks
        print(f"vit-server: {e}", file=sys.stderr)
        return None
    if engine.mesh is not None and not is_leader():
        args.batch, args.bucket = engine.batch, False  # a follower serves no HTTP
        return engine
    if args.batch != engine.batch:
        print(f"vit-server: .vitx artifact is compiled for batch {engine.batch}; "
              f"using it (ignoring -b {args.batch})", file=sys.stderr)
        args.batch = engine.batch
    args.bucket = _artifact_buckets(
        args, engine, "vit-server: .vitx artifact bakes a single batch; "
        "ignoring --bucket (export with -b 1,.. to bucket)")
    return engine


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from vit_cpp_tpu_torch.cli.common import is_vitx, model_spec

    # multi-model when -m repeats or names its model (name=path)
    multi = len(args.model) > 1 or model_spec(args.model[0]) is not None
    if args.mesh and multi:
        print("--mesh is not supported with multiple models", file=sys.stderr)
        return 1
    if args.mesh and not multi and is_vitx(args.model[0]):
        print("--mesh is not supported for .vitx artifacts (the exported "
              "program is compiled single-chip); serve the gguf instead", file=sys.stderr)
        return 1
    from vit_cpp_tpu_torch.cli.common import mesh_from_args, refuse_compile_cache

    refuse_compile_cache(args)
    if args.act == "static":
        # the warmup batch is zeros: lazy calibration would fix the scales
        # on it, so the daemon needs explicit calibration data
        if args.mm != "int8":
            print("--act static requires --mm int8", file=sys.stderr)
            return 1
        if not args.calib_dir and not args.act_scales:
            print(
                "--act static needs --calib-dir DIR (the daemon warms up "
                "on a dummy batch, which must not become the calibration "
                "set) or --act-scales FILE (QAT-measured scales)",
                file=sys.stderr,
            )
            return 1

    from vit_cpp_tpu_torch.server import create_multi_server, create_server

    if multi:
        engines, batches, bucket_map = {}, {}, {}
        for spec in args.model:
            parsed = model_spec(spec)
            if parsed is None:
                print(f"bad -m {spec!r}: multi-model mode needs name=path "
                      "(names must not contain '/')", file=sys.stderr)
                return 1
            name, path = parsed
            if name in engines:
                print(f"duplicate model name {name!r}", file=sys.stderr)
                return 1
            if is_vitx(path) and _mesh_devices(path) > 1:
                print(f"vit-server: {name}: a sharded .vitx artifact serves as the only "
                      "model (-m path) under the launcher", file=sys.stderr)
                return 1
            engines[name] = _engine(args, path, f"vit-server: {name}: ", multi=True)
            if engines[name] is None:
                return 1
            batches[name], bucket_map[name] = args.batch, args.bucket
            if is_vitx(path):
                batches[name] = engines[name].batch
                bucket_map[name] = _artifact_buckets(
                    args, engines[name], f"vit-server: {name}: .vitx artifact bakes a "
                    "single batch; ignoring --bucket")
        httpd, batchers = create_multi_server(
            engines,
            host=args.host,
            port=args.port,
            batch=batches,
            max_wait_ms=args.max_wait_ms,
            warmup=not args.no_warmup,
            request_timeout_s=args.request_timeout,
            max_queue=args.max_queue,
            buckets=bucket_map,
        )
        banner = (f"vit-server: {len(engines)} models on http://{args.host}:"
                  f"{httpd.server_port} ({', '.join(sorted(engines))})")
    elif is_vitx(args.model[0]):
        engine = _artifact(args, args.model[0])
        if engine is None:
            return 1
        if engine.mesh is not None:  # a sharded artifact brings its mesh
            return _serve_on_mesh(args, engine)
    else:
        mesh, rc = mesh_from_args(args, "server")
        if rc is not None:
            return rc
        if mesh is not None:
            from vit_cpp_tpu_torch.parallel.mesh import rank_device

            args.device = str(rank_device(args.device))
        engine = _engine(args, args.model[0], "vit-server: ")
        if engine is None:
            return 1
        if mesh is not None:
            try:
                engine.shard(mesh)
            except ValueError as e:  # tp does not divide the head count
                print(f"--mesh {args.mesh}: {e}", file=sys.stderr)
                return 1
            return _serve_on_mesh(args, engine)
    if not multi:
        httpd, batcher = create_server(
            engine,
            host=args.host,
            port=args.port,
            batch=args.batch,
            max_wait_ms=args.max_wait_ms,
            warmup=not args.no_warmup,
            request_timeout_s=args.request_timeout,
            max_queue=args.max_queue,
            buckets=args.bucket,
        )
        batchers = {None: batcher}
        kind = "vitstr" if engine.hp.seq_len is not None else "vit"
        banner = (f"vit-server: {kind} model on http://{args.host}:{httpd.server_port} "
                  f"(micro-batch {args.batch}, wait {args.max_wait_ms} ms, "
                  f"device {engine.device})")

    def _sigterm(signum, frame):  # docker/systemd stop: the Ctrl-C path
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    print(banner, file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        for b in batchers.values():
            b.close()
    return 0


def _serve_on_mesh(args, engine) -> int:
    """The single-model daemon of a sharded engine or artifact: rank 0
    serves HTTP behind a MeshLeader, the other ranks follow its
    dispatches. Exit code 0 after a clean shutdown, 1 when a rank
    failed."""
    import threading

    from vit_cpp_tpu_torch.parallel.mesh import is_leader
    from vit_cpp_tpu_torch.server import MeshLeader, create_server, follow

    if not is_leader():
        # the launcher's SIGTERM is rank 0's to handle: it broadcasts stop
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        follow(engine)
        return 0
    leader = MeshLeader(engine)
    httpd = batcher = None
    try:
        httpd, batcher = create_server(
            leader, host=args.host, port=args.port, batch=args.batch,
            max_wait_ms=args.max_wait_ms, warmup=not args.no_warmup,
            request_timeout_s=args.request_timeout, max_queue=args.max_queue,
            buckets=args.bucket,
        )
        if args.bucket and batcher.bucket_sizes() == [args.batch]:
            print("vit-server: no usable bucket below the full batch (sharded "
                  "engines need dp-divisible sizes); serving unbucketed", file=sys.stderr)
        leader.on_failure = lambda e: threading.Thread(target=httpd.shutdown, daemon=True).start()

        def _sigterm(signum, frame):
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _sigterm)
        kind = "vitstr" if engine.hp.seq_len is not None else "vit"
        print(f"vit-server: {kind} model on http://{args.host}:{httpd.server_port} "
              f"(micro-batch {args.batch}, wait {args.max_wait_ms} ms, device "
              f"{engine.device}, mesh {'x'.join(map(str, engine.mesh.shape))})",
              file=sys.stderr)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
    finally:
        if httpd is not None:
            httpd.server_close()
        if batcher is not None:
            batcher.close()
        leader.stop()
    if leader.failed is not None:
        print(f"vit-server: a mesh rank failed: {leader.failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
