"""`vit-inspect` on the PyTorch port: dump a checkpoint's hparams, labels
and tensor table.

Counterpart of vit_cpp_tpu/cli/inspect.py, with the same text and
`--json [--tensors]` output: legacy-ggml or real GGUF v2/v3 files (the
port's reader dispatches by magic) and the metadata header of a `.vitx`
artifact, the port's or the JAX package's (aot.py::read_meta), printed
whole as JSON: a sharded artifact's "mesh" (axis names and sizes) and
per-model-rank "blob_lengths" among its keys. It prints
the family traits that the legacy hparam block cannot carry, as the
loader infers them, a V-MoE file's experts among them. It reads files
only: no card is needed.

Usage:
  python -m vit_cpp_tpu_torch.cli.inspect model.gguf            # hparams + family + tensor table
  python -m vit_cpp_tpu_torch.cli.inspect model.gguf --json     # machine-readable summary
"""

from __future__ import annotations

import argparse
import json
import sys


def _family_traits(hp) -> list:
    traits = []
    if hp.seq_len is not None:
        traits.append(f"vitstr (seq_len={hp.seq_len})")
    if hp.num_prefix_tokens == 2:
        traits.append("deit-distilled (dist_token + head_dist)")
    if hp.num_prefix_tokens == 0:
        traits.append("cls-less")
    if hp.norm_pre:
        traits.append("pre-norm (norm_pre)")
    if hp.global_pool == "avg":
        traits.append("avg-pool (fc_norm)")
    if hp.global_pool == "map":
        traits.append("attention-pool (SigLIP attn_pool)")
    if hp.hidden_act == "quick_gelu":
        traits.append("CLIP (quick_gelu, clip pixel norm)")
    if hp.no_embed_class:
        traits.append("no_embed_class (grid-only pos_embed)")
    if hp.num_reg_tokens:
        traits.append(f"registers (reg_token x{hp.num_reg_tokens})")
    if hp.num_classes == 0:
        traits.append("headless encoder (embeddings only)")
    if hp.num_experts:
        traits.append(
            f"v-moe ({hp.num_experts} experts top-{hp.moe_top_k} x"
            f"{len(hp.moe_layers)} layers, capacity {hp.moe_capacity:g})"
        )
    return traits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", help="gguf checkpoint or .vitx artifact")
    ap.add_argument("--json", action="store_true", help="JSON summary")
    ap.add_argument(
        "--tensors", action="store_true",
        help="include the per-tensor table in --json output",
    )
    args = ap.parse_args(argv)

    from vit_cpp_tpu_torch.aot import is_vitx, read_meta

    try:
        if is_vitx(args.model):
            meta = read_meta(args.model)
            print(json.dumps(meta, indent=2))
            return 0
        from vit_cpp_tpu_torch.engine import detect_hparams
        from vit_cpp_tpu_torch.gguf.reader import read_model

        mf = read_model(args.model)
    except (OSError, ValueError) as e:
        print(f"vit-inspect: {args.model}: {e}", file=sys.stderr)
        return 1
    hp = detect_hparams(mf)
    total = sum(r.dtype.row_bytes(r.n_elements) for r in mf.tensors.values())
    by_dtype: dict = {}
    for r in mf.tensors.values():
        d = by_dtype.setdefault(r.dtype.name, [0, 0])
        d[0] += 1
        d[1] += r.dtype.row_bytes(r.n_elements)
    summary = {
        "file": args.model,
        "hparams": {
            "hidden_size": hp.hidden_size,
            "num_hidden_layers": hp.num_hidden_layers,
            "num_attention_heads": hp.num_attention_heads,
            "num_classes": hp.num_classes,
            "patch_size": hp.patch_size,
            "img_size": hp.img_size,
            "ftype": hp.ftype,
            "in_chans": hp.in_chans,
            "mlp_hidden": hp.mlp_hidden or 4 * hp.hidden_size,
        },
        "family": _family_traits(hp),
        "qntvr": mf.qntvr,
        "n_tensors": len(mf.tensors),
        "n_labels": len(mf.id2label),
        "total_bytes": total,
        "bytes_by_dtype": {
            k: {"tensors": v[0], "bytes": v[1]}
            for k, v in sorted(by_dtype.items())
        },
    }
    if args.json:
        if args.tensors:
            summary["tensors"] = [
                {
                    "name": name,
                    "shape": list(r.shape),
                    "dtype": r.dtype.name,
                    "bytes": r.dtype.row_bytes(r.n_elements),
                }
                for name, r in mf.tensors.items()
            ]
        print(json.dumps(summary, indent=2))
        return 0
    h = summary["hparams"]
    print(f"vit-inspect: {args.model}")
    for k, v in h.items():
        print(f"  {k:<22} = {v}")
    print(f"  {'qntvr':<22} = {mf.qntvr}")
    if summary["family"]:
        print(f"  family: {', '.join(summary['family'])}")
    print(
        f"  {len(mf.tensors)} tensors, {len(mf.id2label)} labels, "
        f"{total / 1024 / 1024:.2f} MB"
    )
    for k, (n, b) in sorted(by_dtype.items()):
        print(f"    {k:<8} {n:>4} tensors  {b / 1024 / 1024:9.2f} MB")
    print(f"  {'name':<28} {'shape':<22} {'dtype':<6} {'MB':>9}")
    for name, r in mf.tensors.items():
        print(
            f"  {name:<28} {str(tuple(r.shape)):<22} {r.dtype.name:<6} "
            f"{r.dtype.row_bytes(r.n_elements) / 1024 / 1024:9.3f}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
