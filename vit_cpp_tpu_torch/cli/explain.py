"""`vit-explain` on the PyTorch port: attention-rollout saliency for one
image.

Counterpart of vit_cpp_tpu/cli/explain.py, with its flags and output:
the top-k ` > label : prob` lines on stdout, then the rollout heatmap
(Abnar & Zuidema 2020; models/attention_maps.py) as a grayscale PNG
upscaled to the input size and/or the raw (side, side) f32 grid as .npy.
One encoder pass, on composed attention (no custom kernel), serves both.
One flag is added: --device (default cuda; cpu runs the same pass on the
CPU). Sequence-head (ViTSTR) checkpoints have no single readout to
explain and exit 1.

Usage:
  python -m vit_cpp_tpu_torch.cli.explain -m model.gguf -i image.jpg -o heat.png [--npy heat.npy]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", required=True, help="gguf checkpoint")
    ap.add_argument("-i", "--inp", required=True, help="input image")
    ap.add_argument("-o", "--out", help="saliency PNG (grayscale, upscaled to img_size)")
    ap.add_argument("--npy", help="also save the raw (side, side) f32 grid")
    ap.add_argument("--fuse", choices=["mean", "max", "min"], default="mean",
                    help="head fusion before the rollout (mean is the paper's)")
    ap.add_argument("-k", "--topk", type=int, default=5)
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the same pass on the CPU)")
    args = ap.parse_args(argv)
    if not args.out and not args.npy:
        print("need -o PNG and/or --npy NPY", file=sys.stderr)
        return 1

    import numpy as np

    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.models.attention_maps import saliency_to_png

    try:
        engine = VitEngine(args.model, dtype=args.dtype, verbose=False, device=args.device)
        if engine.hp.seq_len is not None:
            print("vit-explain: sequence-head (ViTSTR) checkpoints have no single "
                  "classification readout to explain", file=sys.stderr)
            return 1
        top, grid = engine.explain_file(args.inp, topk=args.topk, head_fuse=args.fuse)
        if engine.hp.num_classes == 0:
            print("vit-explain: headless encoder — rollout only (no classifier to print)",
                  file=sys.stderr)
        for _cid, prob, label in top:
            print(f" > {label} : {prob:.2f}")
    except (OSError, ValueError) as e:
        print(f"vit-explain: {e}", file=sys.stderr)
        return 1
    if args.npy:
        np.save(args.npy, grid)
        print(f"vit-explain: wrote {args.npy} {grid.shape}", file=sys.stderr)
    if args.out:
        saliency_to_png(grid, args.out, upscale_to=engine.hp.img_size)
        print(f"vit-explain: wrote {args.out} ({grid.shape[0]}x{grid.shape[1]} grid upscaled "
              f"to {engine.hp.img_size})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
