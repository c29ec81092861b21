"""Fine-tune a checkpoint on an image folder, on the PyTorch port.

Counterpart of `vit-finetune` (vit_cpp_tpu/cli/finetune.py), with the same
flags plus --device (default cuda; cpu runs the plain PyTorch versions of
the kernels). Classifier checkpoints train on one subdirectory per class;
the head transfers to the folder's class count; --ckpt-dir makes the run
resumable. The output gguf serves through the port's engine and daemon.
Flags whose slice is not ported yet raise (in `finetune`) and name that
slice.

Usage:
  python -m vit_cpp_tpu_torch.cli.finetune -m model.gguf -d train/ -o ft.gguf -b 32 \\
      [--epochs 3] [--augment all] [--label-smooth 0.1] [--ema 0.999] [--ckpt-dir ckpt/]
"""

from __future__ import annotations

import argparse
import sys

from vit_cpp_tpu_torch.cli.common import _not_ported


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", required=True, help="input .gguf checkpoint")
    ap.add_argument("-d", "--data-dir", required=True, help="train images: <dir>/<class>/*")
    ap.add_argument("-o", "--out", required=True, help="output .gguf")
    ap.add_argument("--val-dir", help="held-out tree for per-epoch top-1")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("-b", "--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight-decay", type=float, default=0.05)
    ap.add_argument("--schedule", choices=["const", "cosine"], default="const",
                    help="learning-rate schedule (cosine decays to 0 over the run)")
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="linear LR warmup over this many optimizer updates")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="accumulate N micro-batches per optimizer update")
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help="clip the global gradient norm before each update (0 = off)")
    ap.add_argument("--freeze-backbone", action="store_true",
                    help="train the head only (linear probe)")
    ap.add_argument("--augment", choices=["none", "flip", "crop", "all"], default="none",
                    help="train-batch augmentation: random horizontal flip and/or "
                    "random resized crop, keyed by the global step")
    ap.add_argument("--label-smooth", type=float, default=0.0, metavar="EPS")
    ap.add_argument("--mixup", type=float, default=0.0, metavar="ALPHA")
    ap.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                    help="keep an EMA of the weights and write THAT to the output")
    ap.add_argument("--mu-dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--mesh", metavar="DPxTP", default=None)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint dir: saved every epoch, resumed when present")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-threads", type=int, default=0)
    ap.add_argument("--stream", action="store_true",
                    help="decode + preprocess per batch on a prefetch thread")
    ap.add_argument("--img-size", type=int, default=None, metavar="PX")
    ap.add_argument("--patch-size", type=int, default=None, metavar="P")
    ap.add_argument("--tome", type=int, default=0, metavar="R")
    ap.add_argument("--moe", type=int, default=0, metavar="E")
    ap.add_argument("--moe-every", type=int, default=2, metavar="N")
    ap.add_argument("--moe-top-k", type=int, default=1, metavar="K")
    ap.add_argument("--moe-capacity", type=float, default=1.25, metavar="F")
    ap.add_argument("--lora", type=int, default=0, metavar="R")
    ap.add_argument("--lora-alpha", type=float, default=0.0, metavar="A")
    ap.add_argument("--distill", default="", metavar="TEACHER.gguf")
    ap.add_argument("--distill-mode", default="soft", choices=["soft", "hard"])
    ap.add_argument("--distill-alpha", type=float, default=0.5, metavar="A")
    ap.add_argument("--distill-tau", type=float, default=3.0, metavar="T")
    ap.add_argument("--qat", default="", metavar="FMT",
                    choices=["", "w8a8", "q8_0", "q4_0", "q4_1", "q5_0", "q5_1"])
    ap.add_argument("--qat-act", default="dynamic", choices=["dynamic", "static"])
    ap.add_argument("--ftype", type=int, choices=[0, 1], default=1,
                    help="output dtype rule: 0=f32, 1=f16")
    ap.add_argument("--compile-cache", nargs="?", const="", default=None, metavar="DIR")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs "
                    "the plain PyTorch versions of the kernels)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.compile_cache is not None:
        raise _not_ported(
            "--compile-cache", "no slice: it is the XLA compile cache, and PyTorch runs eagerly"
        )

    from vit_cpp_tpu_torch.finetune import finetune
    from vit_cpp_tpu_torch.models.export import save_params

    try:
        params, hp, classes, _ = finetune(
            args.model,
            args.data_dir,
            epochs=args.epochs,
            batch=args.batch,
            lr=args.lr,
            weight_decay=args.weight_decay,
            schedule=args.schedule,
            warmup_steps=args.warmup_steps,
            grad_accum=args.grad_accum,
            clip_norm=args.clip_norm,
            mu_dtype=args.mu_dtype,
            freeze_backbone=args.freeze_backbone,
            augment=args.augment,
            label_smoothing=args.label_smooth,
            mixup=args.mixup,
            ema=args.ema,
            mesh=args.mesh,
            fsdp=args.fsdp,
            ckpt_dir=args.ckpt_dir,
            seed=args.seed,
            decode_threads=args.decode_threads,
            val_dir=args.val_dir,
            img_size=args.img_size,
            patch_size=args.patch_size,
            tome=args.tome,
            moe=args.moe,
            moe_every=args.moe_every,
            moe_top_k=args.moe_top_k,
            moe_capacity=args.moe_capacity,
            lora=args.lora,
            lora_alpha=args.lora_alpha,
            distill=args.distill,
            distill_mode=args.distill_mode,
            distill_alpha=args.distill_alpha,
            distill_tau=args.distill_tau,
            qat=args.qat,
            qat_act=args.qat_act,
            stream=args.stream,
            log=lambda m: print(m, file=sys.stderr),
            device=args.device,
        )
    except ValueError as e:
        print(f"finetune: {e}", file=sys.stderr)
        return 1
    save_params(args.out, params, hp, id2label=dict(enumerate(classes)), ftype=args.ftype)
    print(f"vit-finetune: wrote {args.out} ({len(classes)} classes)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
