"""`vit-export` on the PyTorch port: build a single-file AOT serving artifact (.vitx).

    python -m vit_cpp_tpu_torch.cli.export_aot model-q8_0.gguf model.vitx --batch 64
    python -m vit_cpp_tpu_torch.cli.export_aot model.gguf model.vitx -b 1,64 --device cuda
    python -m vit_cpp_tpu_torch.cli.export_aot --info model.vitx

Counterpart of vit_cpp_tpu/cli/export_aot.py, with its flags, defaults
(`-b 64 --dtype bf16 --mm int8 --attn pallas-fast`, LayerNorm folded for
int8 without --act-scales), refusals and exit codes, plus --device
(default cuda; cpu exports a program for the CPU). The artifact holds one
`torch.export` program per batch size with the weights inside
(vit_cpp_tpu_torch/aot.py); serve it with AotEngine, or `-m model.vitx` in
the port's vit, vitstr, vit-serve, vit-server and vit-benchmark, on the
device it was exported on. `--platforms` may only name that device: the
port cannot lower for another.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", help="input .gguf checkpoint")
    ap.add_argument("out", nargs="?", help="output .vitx artifact")
    ap.add_argument("--info", metavar="VITX", help="print an artifact's metadata")
    ap.add_argument(
        "-b", "--batch", default="64", metavar="N[,N...]",
        help="batch size(s) to export — a comma list (e.g. 1,64) embeds "
        "one program per size in one artifact: the single-image CLIs use "
        "the smallest (latency), serving uses the largest (throughput). "
        "Weights are kept in each program (~N x model size on disk).",
    )
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="bf16")
    ap.add_argument("--mm", choices=["xla", "pallas", "int8"], default="int8")
    ap.add_argument(
        "--attn", choices=["xla", "pallas", "pallas-fast"], default="pallas-fast"
    )
    ap.add_argument("--fold-ln", action=argparse.BooleanOptionalAction, default=None)
    ap.add_argument(
        "--act", choices=["dynamic", "static"], default="dynamic",
        help="int8 activation quantization: 'static' bakes calibrated "
        "per-site scales into the artifact (needs --calib-dir or --act-scales)",
    )
    ap.add_argument(
        "--act-scales", metavar="FILE",
        help="pre-measured static scales (a QAT run's OUT.act_scales.json): "
        "bake them instead of calibrating",
    )
    ap.add_argument(
        "--calib-dir", metavar="DIR",
        help="representative images for --act static calibration (up to "
        "16 used; the agreement guardrail rejects saturating scales and "
        "fails the export)",
    )
    ap.add_argument(
        "--img-size", type=int, default=None, metavar="PX",
        help="bake a non-native serving resolution into the artifact (the "
        "pos_embed grid is resampled bicubically; a multiple of the patch size)",
    )
    ap.add_argument(
        "--patch-size", type=int, default=None, metavar="P",
        help="bake a non-native patch size into the artifact (the patch "
        "embedding is PI-resized; must divide the image size)",
    )
    ap.add_argument(
        "--tome", type=int, default=0, metavar="R",
        help="bake ToMe token merging (ops/tome.py) into the program: R "
        "most-similar patch-token pairs merge per layer",
    )
    ap.add_argument(
        "--platforms", metavar="P1,P2",
        help="lowering targets; the port exports only for the device it runs "
        "on (torch-cuda or torch-cpu, as --device picks), so this may only "
        "name that device",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to export on and for (default cuda; "
                    "cpu exports a CPU program)")
    args = ap.parse_args(argv)

    from vit_cpp_tpu_torch.aot import check_platforms, is_vitx, read_meta, save_engine

    if args.info:
        try:
            meta = read_meta(args.info)
        except (OSError, ValueError) as e:
            print(f"vit-export: {args.info}: {e}", file=sys.stderr)
            return 1
        print(json.dumps(meta, indent=2))
        return 0
    if not args.model or not args.out:
        print("need MODEL and OUT (or --info VITX)", file=sys.stderr)
        return 1
    platforms = args.platforms.split(",") if args.platforms else None
    if platforms is not None:
        try:
            check_platforms(platforms, args.device)
        except ValueError as e:
            ap.error(f"--platforms {args.platforms}: {e}")

    from vit_cpp_tpu_torch.cli.common import build_engine, calibrate_engine_from_paths

    if is_vitx(args.model):
        print(
            f"vit-export: {args.model} is already a .vitx artifact "
            "(export takes a gguf checkpoint)",
            file=sys.stderr,
        )
        return 1
    try:
        batches = [int(b) for b in str(args.batch).split(",")]
    except ValueError:
        print(f"bad --batch {args.batch!r}: want N or N,N,...", file=sys.stderr)
        return 1
    if args.act == "static" and args.mm != "int8":
        print("vit-export: --act static requires --mm int8", file=sys.stderr)
        return 1
    if args.act == "static" and not args.calib_dir and not args.act_scales:
        print(
            "vit-export: --act static needs --calib-dir DIR "
            "(representative images to calibrate on) or --act-scales "
            "FILE (QAT-measured scales)",
            file=sys.stderr,
        )
        return 1
    try:
        engine, _ = build_engine(
            args.model, dtype=args.dtype, mm=args.mm, attn=args.attn,
            fold_ln=args.fold_ln, act=args.act, act_scales=args.act_scales,
            img_size=args.img_size, patch_size=args.patch_size, tome=args.tome,
            device=args.device,
        )
        if args.act == "static" and not args.act_scales:
            if not calibrate_engine_from_paths(engine, args.calib_dir):
                # a deploy artifact must not carry the dynamic fallback
                # that the engine's guardrail downgraded to
                print(
                    "vit-export: static calibration rejected by the "
                    "agreement guardrail (scales would clip activations); "
                    "use different calibration images or export --act "
                    "dynamic",
                    file=sys.stderr,
                )
                return 1
        meta = save_engine(engine, args.out, batch=batches, platforms=platforms)
    except (OSError, ValueError) as e:
        print(f"vit-export: {e}", file=sys.stderr)
        return 1
    print(
        f"vit-export: {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, "
        f"batch{'es' if len(meta['batches']) > 1 else ''} "
        f"{','.join(map(str, meta['batches']))}, "
        f"platforms {meta['platforms']})",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
