"""HTTP inference daemon on the PyTorch port.

Counterpart of `vit-server` (vit_cpp_tpu/cli/server.py), with the same
flags and defaults plus --device. It serves f16/f32 and block-quantized
(Q4_0/Q4_1/Q5_0/Q5_1/Q8_0, written by vit_cpp_tpu_torch.cli.quantize)
checkpoints: `--mm int8` (the default) requantizes the weights to W8A8
at load, `--mm pallas` runs them through the dequantizing-matmul kernel.
Flags whose slice is not ported yet raise and name that slice.

Usage:
  python -m vit_cpp_tpu_torch.cli.server -m model-q8_0.gguf [--mm pallas] [--device cuda] --port 8000
  curl -s -X POST --data-binary @magpie.jpeg localhost:8000/v1/classify?topk=5
"""

from __future__ import annotations

import argparse
import signal
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", required=True, action="append",
                    help="gguf checkpoint (one model per daemon in this port)")
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
    ap.add_argument("--act", choices=["dynamic", "static"], default="dynamic")
    ap.add_argument("--calib-dir", metavar="DIR")
    ap.add_argument("--act-scales", metavar="FILE")
    ap.add_argument("--img-size", type=int, default=None, metavar="PX")
    ap.add_argument("--patch-size", type=int, default=None, metavar="P")
    ap.add_argument("--tome", type=int, default=0, metavar="R")
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


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from vit_cpp_tpu_torch.cli.common import model_spec

    if len(args.model) > 1 or model_spec(args.model[0]) is not None:
        raise NotImplementedError(
            "multi-model daemons (-m name=path) are not ported yet; they "
            "come with the serve.py / cli/serve.py slice"
        )
    if args.mesh:
        raise NotImplementedError(
            "--mesh is not ported yet; it comes with the multi-device slice"
        )
    if args.calib_dir:
        raise NotImplementedError(
            "--calib-dir is not ported yet; it comes with the static-scale "
            "slice (quant/calibrate.py)"
        )
    if args.compile_cache is not None:
        raise NotImplementedError(
            "--compile-cache is the XLA compile cache; PyTorch runs eagerly "
            "and has no such cache"
        )

    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.server import create_server

    try:
        engine, _ = build_engine(
            args.model[0], dtype=args.dtype, mm=args.mm, attn=args.attn,
            fold_ln=args.fold_ln, act=args.act, act_scales=args.act_scales,
            img_size=args.img_size, patch_size=args.patch_size,
            tome=args.tome, device=args.device,
        )
    except ValueError as e:
        print(f"vit-server: {e}", file=sys.stderr)
        return 1
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
    def _sigterm(signum, frame):  # docker/systemd stop: the Ctrl-C path
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    print(
        f"vit-server: vit model on http://{args.host}:{httpd.server_port} "
        f"(micro-batch {args.batch}, wait {args.max_wait_ms} ms, "
        f"device {engine.device})",
        file=sys.stderr,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
