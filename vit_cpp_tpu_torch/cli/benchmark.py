"""`vit-benchmark` on the PyTorch port: the ImageNet-1k accuracy harness.

Counterpart of vit_cpp_tpu/cli/benchmark.py, with the same contract: the
dataset is laid out as `dataset_dir/<class_name>/*.JPEG` with the ground
truth the directory name, display names come from
`<dataset_dir>/../classnames.json` (else the bundled copy,
vit_cpp_tpu_torch/data/classnames.json, byte-identical to the JAX
package's, 998 entries included), each image gets a CSV row
`filename,truth,prediction`, and the run ends with a `Top-1 Accuracy:`
line. Files decode on the native thread pool (or PIL) a batch at a time;
the tail batch is padded to the full batch; failed decodes are skipped.
The engine runs on the card unless --device cpu is given; a port-made
.vitx artifact (aot.py) runs at its baked batch.

Usage:
  python -m vit_cpp_tpu_torch.cli.benchmark <model> <dataset_dir> \\
      <num_images_per_class> [output_file] [--batch N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Tuple

import torch


def read_class_names(path: str) -> List[str]:
    """classnames.json: a JSON array of the class directory names in label
    order."""
    try:
        with open(path) as f:
            return list(json.load(f))
    except OSError as exc:
        print(f"Cannot open file: {path} ({exc})", file=sys.stderr)
        return []


def collect_images(dataset_dir: str, per_class: int, ext: str = ".JPEG") -> List[Tuple[str, str]]:
    """[(path, class_dir_name)] over dataset_dir/<class>/*<ext>, at most
    per_class per class (all when per_class <= 0)."""
    out: List[Tuple[str, str]] = []
    for entry in sorted(os.scandir(dataset_dir), key=lambda e: e.name):
        if not entry.is_dir():
            continue
        n = 0
        for img in sorted(os.scandir(entry.path), key=lambda e: e.name):
            if per_class > 0 and n >= per_class:
                break
            if not img.name.endswith(ext):
                continue
            out.append((img.path, entry.name))
            n += 1
    return out


def run_eval(
    model_path: str,
    dataset_dir: str,
    per_class: int,
    output_file: str = "predictions.txt",
    *,
    batch: int = 32,
    dtype: str = "f32",
    attn_impl: str = "xla",
    mm_impl: str = "xla",
    ext: str = ".JPEG",
    classnames: Optional[List[str]] = None,
    verbose: bool = True,
    device: str = "cuda",
) -> float:
    """Classify the tree, write the CSV, print and return the top-1
    accuracy. A .vitx artifact serves at its baked batch, which wins over
    `batch`."""
    from vit_cpp_tpu_torch.aot import is_vitx
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch

    if classnames is None:
        path = os.path.join(os.path.dirname(os.path.abspath(dataset_dir)), "classnames.json")
        if not os.path.exists(path):
            path = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "data",
                "classnames.json",
            )
        classnames = read_class_names(path)

    if is_vitx(model_path):
        # an AOT artifact: engine knobs baked at export; its batch wins (the
        # loop below pads every chunk to `batch`)
        from vit_cpp_tpu_torch.aot import AotEngine

        engine = AotEngine(model_path, device=device)
        if batch != engine.batch:
            print(f"benchmark: .vitx artifact is compiled for batch {engine.batch}; "
                  f"using it (ignoring --batch {batch})", file=sys.stderr)
            batch = engine.batch
    else:
        from vit_cpp_tpu_torch.engine import VitEngine

        engine = VitEngine(
            model_path, dtype=dtype, attn_impl=attn_impl, mm_impl=mm_impl,
            verbose=verbose, device=device,
        )
    items = collect_images(dataset_dir, per_class, ext)
    if not items:
        print(f"no *{ext} images under {dataset_dir}", file=sys.stderr)
        return 0.0

    correct = total = 0
    t0 = time.perf_counter()
    with open(output_file, "w") as out:
        for start in range(0, len(items), batch):
            chunk = items[start : start + batch]
            images = load_images_rgb_batch([p for p, _ in chunk])
            pixels, kept = [], []
            for (path, cls), img in zip(chunk, images):
                if img is None:
                    print(f"Failed to load image from {path}", file=sys.stderr)
                    continue
                pixels.append(engine.preprocess_image(img))
                kept.append((path, cls))
            if not pixels:
                continue
            # pad the tail chunk to the full batch: every forward has one shape
            n_real = len(pixels)
            pixels += [pixels[0]] * (batch - n_real)
            probs = engine.predict_probs_batch(torch.stack(pixels))[:n_real].cpu().numpy()
            preds = probs.argmax(axis=-1)
            for (path, cls), idx in zip(kept, preds):
                pred_name = classnames[idx] if idx < len(classnames) else f"LABEL_{idx}"
                if pred_name == cls:
                    correct += 1
                total += 1
                out.write(f"{os.path.basename(path)},{cls},{pred_name}\n")
            if verbose and (start // batch) % 10 == 0:
                el = time.perf_counter() - t0
                print(f"  {total}/{len(items)} images, {total / max(el, 1e-9):.1f} img/s",
                      file=sys.stderr)

    accuracy = correct / max(total, 1)
    print(f"Top-1 Accuracy: {accuracy * 100.0}%")
    return accuracy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ImageNet top-1 accuracy eval")
    ap.add_argument("model_path")
    ap.add_argument("dataset_dir")
    ap.add_argument("num_images_per_class", type=int, help="cap per class; <= 0 means all images")
    ap.add_argument("output_file", nargs="?", default="predictions.txt")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--attn", choices=["xla", "pallas", "pallas-fast"], default="xla")
    ap.add_argument("--mm", choices=["xla", "pallas", "int8"], default="xla")
    ap.add_argument("--ext", default=".JPEG")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch "
                    "versions of the kernels)")
    args = ap.parse_args(argv)
    run_eval(
        args.model_path, args.dataset_dir, args.num_images_per_class, args.output_file,
        batch=args.batch, dtype=args.dtype, attn_impl=args.attn, mm_impl=args.mm,
        ext=args.ext, device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
