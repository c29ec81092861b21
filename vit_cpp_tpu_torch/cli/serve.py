"""`vit-serve` on the PyTorch port: classify a directory or file list at
throughput, or extract embeddings.

Counterpart of vit_cpp_tpu/cli/serve.py, with its flags and defaults
(`-b 64 -k 1 --dtype bf16 --mm int8 --attn pallas-fast`, LayerNorm folded
for int8 without --act-scales) plus --device. `--act static` serves W8A8
with static activation scales: calibrated on --calib-dir before the run,
read from --act-scales, or else calibrated on the first batch. Drives
vit_cpp_tpu_torch.serve: the decode of batch k+1 overlaps the forward of
batch k on the card. Prints one
`path<TAB>label<TAB>prob` line per image (`path<TAB>label:prob ...` for
-k > 1; `path<TAB>text<TAB>confidence` for a ViTSTR checkpoint, through
recognize_files) and an images/sec summary on stderr; `--embed OUT.npy`
writes the (N, hidden) f32 features and OUT.paths.txt instead.
`--img-size` / `--patch-size` serve the checkpoint at another geometry
(models/resample.py); `--tome R` merges R token pairs per layer
(ops/tome.py). `--mesh DPxTP` shards the engine over a mesh of
launcher ranks (one process per device; parallel/mesh.py): every rank
decodes the same files and runs its part of each batch, and only rank 0
prints and writes. `--compile-cache` raises (PyTorch has no compile
cache). `-m model.vitx` serves a port-made AOT artifact (aot.py) at its
baked batch, with the JAX tool's notices and refusals (`--mesh` among
them). A sharded artifact (aot.save_engine of a sharded engine) brings its
mesh: it serves under the launcher with one process per device of that
mesh, and only rank 0 prints and writes.

Usage:
  python -m vit_cpp_tpu_torch.cli.serve -m model.gguf -d images_dir [-b 64] [--device cuda|cpu]
  python -m vit_cpp_tpu_torch.cli.serve -m model.gguf img1.jpg img2.png ...
  python -m vit_cpp_tpu_torch.cli.serve -m model.gguf -d images_dir --embed feats.npy
  python -m vit_cpp_tpu_torch.cli.serve -m model.gguf -d images_dir --act static --calib-dir calib/
  python -m torch.distributed.run --standalone --nproc-per-node 8 \
      -m vit_cpp_tpu_torch.cli.serve -m model.gguf -d images_dir --mesh 4x2 [--device cpu]
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m vit_cpp_tpu_torch.cli.serve -m sharded_2x2.vitx -d images_dir [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from vit_cpp_tpu_torch.io.image import IMAGE_EXTS


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-d", "--dir", help="classify every image under this dir")
    ap.add_argument("files", nargs="*", help="explicit image files")
    ap.add_argument("-b", "--batch", type=int, default=64)
    ap.add_argument("-k", "--topk", type=int, default=1)
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="bf16")
    ap.add_argument("--mm", choices=["xla", "pallas", "int8"], default="int8",
                    help="matmul path: int8 = W8A8 (the default), pallas = the "
                    "dequantizing-matmul kernel on block-quantized files, xla = dense")
    ap.add_argument("--attn", choices=["xla", "pallas", "pallas-fast"], default="pallas-fast",
                    help="attention: the fused-QKV kernel with the fast (default) "
                    "or safe softmax, or composed attention")
    ap.add_argument("--fold-ln", action=argparse.BooleanOptionalAction, default=None,
                    help="fold LN affines into adjacent matmuls (default: on for "
                    "--mm int8, off otherwise)")
    ap.add_argument("--act", choices=["dynamic", "static"], default="dynamic",
                    help="int8 activation quantization: 'static' serves with "
                    "calibrated per-site scales (guardrailed: falls back to "
                    "dynamic on rejection); calibrates on --calib-dir when "
                    "given, else on the first served batch")
    ap.add_argument("--calib-dir", metavar="DIR",
                    help="representative images for --act static (up to 16 used)")
    ap.add_argument("--act-scales", metavar="FILE",
                    help="pre-measured static scales (a sidecar JSON): --act "
                    "static serves with them, no calibration pass")
    ap.add_argument("--embed", metavar="OUT.npy", default=None,
                    help="extract embeddings instead of classifying: write an "
                    "(N, hidden) f32 .npy of final-LN pooled features plus "
                    "OUT.paths.txt (one kept path per line)")
    ap.add_argument("--decode-threads", type=int, default=0)
    ap.add_argument("--img-size", type=int, default=None, metavar="PX",
                    help="serve at another resolution: the pos_embed grid is "
                    "resampled bicubically and inputs resized to PX x PX (a "
                    "multiple of the patch size; gguf classifiers only)")
    ap.add_argument("--patch-size", type=int, default=None, metavar="P",
                    help="serve at another patch size: the patch-embedding kernel "
                    "is PI-resized and the pos_embed grid follows (gguf "
                    "classifiers only)")
    ap.add_argument("--mesh", metavar="DPxTP", default=None)
    ap.add_argument("--tome", type=int, default=0, metavar="R",
                    help="ToMe token merging (ops/tome.py): merge R most-similar "
                    "patch-token pairs per layer (classifier gguf engines only)")
    ap.add_argument("--compile-cache", nargs="?", const="", default=None, metavar="DIR")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch "
                    "versions of the kernels)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from vit_cpp_tpu_torch.aot import is_vitx
    from vit_cpp_tpu_torch.cli.common import refuse_compile_cache

    vitx = is_vitx(args.model)
    if not (vitx and args.mesh):  # an artifact refuses --mesh as the JAX tool does
        refuse_compile_cache(args)
    paths = list(args.files)
    if args.dir:
        for root, _, files in os.walk(args.dir):
            paths.extend(
                os.path.join(root, f)
                for f in sorted(files)
                if os.path.splitext(f)[1] in IMAGE_EXTS
            )
    if not paths:
        print("no input images", file=sys.stderr)
        return 1

    if vitx:
        return _serve_artifact(args, paths)
    from vit_cpp_tpu_torch.cli.common import (
        build_engine,
        calibrate_engine_from_paths,
        mesh_from_args,
    )
    from vit_cpp_tpu_torch.parallel.mesh import is_leader, rank_device

    mesh, rc = mesh_from_args(args, "serve")
    if rc is not None:
        return rc
    if args.act == "static" and args.mm != "int8":
        print("--act static requires --mm int8", file=sys.stderr)
        return 1
    try:
        engine, is_vitstr = build_engine(
            args.model, dtype=args.dtype, mm=args.mm, attn=args.attn,
            fold_ln=args.fold_ln, act=args.act, act_scales=args.act_scales,
            img_size=args.img_size, patch_size=args.patch_size, tome=args.tome,
            device=args.device if mesh is None else rank_device(args.device),
        )
    except ValueError as e:  # a .vitx artifact, a geometry that does not fit, ViTSTR + --tome
        print(f"serve: {e}", file=sys.stderr)
        return 1
    if engine.hp.num_classes == 0 and not args.embed:
        print(
            "serve: checkpoint is a headless encoder (no classifier) — "
            "use --embed OUT.npy for bulk feature extraction, or "
            "vit-finetune to attach a head",
            file=sys.stderr,
        )
        return 1
    if mesh is not None:
        try:
            engine.shard(mesh)
        except ValueError as e:  # tp does not divide the head count
            print(f"--mesh {args.mesh}: {e}", file=sys.stderr)
            return 1
    if args.act == "static" and args.calib_dir:
        try:
            ok = calibrate_engine_from_paths(engine, args.calib_dir)
        except ValueError as e:  # an empty or undecodable --calib-dir
            print(f"serve: {e}", file=sys.stderr)
            return 1
        if not ok:
            print("serve: static calibration rejected by the guardrail; "
                  "serving with dynamic activation scales", file=sys.stderr)
    leader = is_leader()
    if args.embed:
        return _embed_loop(engine, paths, out=args.embed, batch=args.batch,
                           decode_threads=args.decode_threads, leader=leader)
    return _serve_loop(engine, is_vitstr, paths, batch=args.batch, topk=args.topk,
                       decode_threads=args.decode_threads, leader=leader)


def _serve_artifact(args, paths) -> int:
    """A .vitx artifact: the engine knobs, the batch size and a sharded
    artifact's mesh were baked at export; the JAX tool's refusals and
    notices (vit_cpp_tpu/cli/serve.py). A sharded artifact runs on every
    rank of the launcher's world (aot.py::AotEngine), and only the leader
    (rank 0) prints and writes."""
    from vit_cpp_tpu_torch.aot import AotEngine, read_meta
    from vit_cpp_tpu_torch.parallel.mesh import is_leader

    try:
        headless = read_meta(args.model).get("program") == "features"
    except ValueError as e:
        print(f"serve: {args.model}: {e}", file=sys.stderr)
        return 1
    if args.embed and not headless:
        print(
            "--embed is not supported for classifier .vitx artifacts "
            "(the exported program is the classifier); serve the gguf "
            "or export a headless-encoder artifact",
            file=sys.stderr,
        )
        return 1
    if headless and not args.embed:
        print("this artifact is a headless encoder (features program) — "
              "use --embed OUT.npy", file=sys.stderr)
        return 1
    if args.act == "static":
        print("--act static does not apply to a .vitx artifact — its "
              "scales were baked at export (vit-export --act static)", file=sys.stderr)
        return 1
    if args.mesh:
        print("--mesh is not supported for .vitx artifacts (the exported "
              "program is compiled single-chip); serve the gguf instead", file=sys.stderr)
        return 1
    if args.img_size is not None or args.patch_size is not None:
        print("--img-size/--patch-size do not apply to a .vitx artifact "
              "— its geometry was baked at export (vit-export "
              "--img-size/--patch-size)", file=sys.stderr)
        return 1
    if args.tome:
        print("--tome does not apply to a .vitx artifact — the graph "
              "was baked at export (vit-export --tome R)", file=sys.stderr)
        return 1
    try:
        aot = AotEngine(args.model, device=args.device)
    except ValueError as e:  # a JAX-made artifact, another device's, too few ranks
        print(f"serve: {e}", file=sys.stderr)
        return 1
    leader = is_leader()
    if leader and args.batch != aot.batch:
        print(f"serve: .vitx artifact is compiled for batch {aot.batch}; "
              f"using it (ignoring -b {args.batch})", file=sys.stderr)
    if leader:
        print(f"serve: AOT artifact (mm={aot.meta['mm_impl']}, attn={aot.meta['attn_impl']}, "
              f"batch {aot.batch}) — engine flags baked at export", file=sys.stderr)
    if headless:
        return _embed_loop(aot, paths, out=args.embed, batch=aot.batch,
                           decode_threads=args.decode_threads, leader=leader)
    return _serve_loop(aot, aot.hp.seq_len is not None, paths, batch=aot.batch,
                       topk=args.topk, decode_threads=args.decode_threads, leader=leader)


def _embed_loop(engine, paths, *, out: str, batch: int, decode_threads: int,
                leader: bool = True) -> int:
    """Bulk feature extraction -> OUT.npy (N, hidden) + OUT.paths.txt;
    on a mesh only the leader (rank 0) prints and writes."""
    from vit_cpp_tpu_torch.serve import embed_files

    t0 = time.perf_counter()
    kept, vecs = [], []
    for e in embed_files(engine, paths, batch=batch, decode_threads=decode_threads):
        if e.vector is None:
            if leader:
                print(f"{e.path}\t<decode failed>", file=sys.stderr)
            continue
        kept.append(e.path)
        vecs.append(e.vector)
    if not vecs:
        if leader:
            print("no decodable images", file=sys.stderr)
        return 1
    if not leader:
        return 0
    np.save(out, np.stack(vecs))
    paths_txt = out[: -len(".npy")] + ".paths.txt" if out.endswith(".npy") else out + ".paths.txt"
    with open(paths_txt, "w", encoding="utf-8") as f:
        f.write("\n".join(kept) + "\n")
    dt = time.perf_counter() - t0
    print(
        f"serve: embedded {len(kept)}/{len(paths)} images in {dt:.2f}s "
        f"= {len(kept) / max(dt, 1e-9):.1f} images/sec -> {out} "
        f"({len(kept)} x {vecs[0].shape[-1]}) + {paths_txt}",
        file=sys.stderr,
    )
    return 0


def _serve_loop(engine, is_vitstr: bool, paths, *, batch: int, topk: int,
                decode_threads: int, leader: bool = True) -> int:
    """Stream every path through the serving pipeline and print results
    (on a mesh only the leader, rank 0, prints)."""
    from vit_cpp_tpu_torch.serve import recognize_files, serve_files

    say = print if leader else _silent  # the other ranks compute and stay quiet
    t0 = time.perf_counter()
    n_ok = 0
    if is_vitstr:
        for r in recognize_files(engine, paths, batch=batch, decode_threads=decode_threads):
            if r.confidence < 0:
                say(f"{r.path}\t<decode failed>", file=sys.stderr)
                continue
            n_ok += 1
            say(f"{r.path}\t{r.text}\t{r.confidence:.2f}")
    else:
        for r in serve_files(engine, paths, batch=batch, decode_threads=decode_threads,
                             keep_probs=topk > 1):
            if r.top1 < 0:
                say(f"{r.path}\t<decode failed>", file=sys.stderr)
                continue
            n_ok += 1
            if topk > 1:
                order = np.argsort(-r.probs, kind="stable")[:topk]
                tags = " ".join(
                    f"{engine.id2label.get(int(i), f'LABEL_{i}')}:{r.probs[i]:.2f}"
                    for i in order
                )
                say(f"{r.path}\t{tags}")
            else:
                label = engine.id2label.get(r.top1, f"LABEL_{r.top1}")
                say(f"{r.path}\t{label}\t{r.prob:.2f}")
    dt = time.perf_counter() - t0
    say(
        f"serve: {n_ok}/{len(paths)} images in {dt:.2f}s "
        f"= {n_ok / max(dt, 1e-9):.1f} images/sec",
        file=sys.stderr,
    )
    return 0


def _silent(*args, **kwargs) -> None:
    pass


if __name__ == "__main__":
    sys.exit(main())
