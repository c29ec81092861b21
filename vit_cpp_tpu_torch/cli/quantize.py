"""`quantize` tool: rewrite an f16/f32 model file with block-quantized
2-D weight matrices.

Counterpart of `vit-quantize` (vit_cpp_tpu/cli/quantize.py), on the port's
own block codec (quant/blocks.py), so it runs without JAX; its output file
is byte-identical to that tool's:
- itype 2/3/6/7/8 -> Q4_0/Q4_1/Q5_0/Q5_1/Q8_0;
- only 2-D f16/f32 tensors whose name matches `.*weight` are quantized,
  except MoE routers; everything else passes through byte-identical;
- the file-level ftype becomes the itype;
- prints per-tensor sizes and 16-bucket code histograms plus a total
  histogram.

Usage: python -m vit_cpp_tpu_torch.cli.quantize model-f16.gguf model-q8_0.gguf 8
"""

from __future__ import annotations

import re
import sys
import time

import numpy as np

from vit_cpp_tpu_torch.gguf.dtypes import FTYPE_NAMES, QUANT_ITYPES, GGMLDType
from vit_cpp_tpu_torch.gguf.reader import read_model
from vit_cpp_tpu_torch.gguf.writer import write_header, write_tensor
from vit_cpp_tpu_torch.quant.blocks import quantize_with_hist

# Tensor-name patterns eligible for quantization.
K_NAMES = [r".*weight"]


def quantize_model_file(
    fname_inp: str, fname_out: str, itype: int, verbose: bool = True
) -> bool:
    if itype not in QUANT_ITYPES:
        print(f"quantize_model_file: invalid quantization type {itype}", file=sys.stderr)
        return False
    qtype = QUANT_ITYPES[itype]
    say = print if verbose else (lambda *a, **k: None)

    say(f"quantize_model_file: loading model from '{fname_inp}'")
    mf = read_model(fname_inp)
    hp = mf.hparams
    say(f"quantize_model_file: hidden_size            = {hp.hidden_size}")
    say(f"quantize_model_file: num_hidden_layers      = {hp.num_hidden_layers}")
    say(f"quantize_model_file: num_attention_heads    = {hp.num_attention_heads}")
    say(f"quantize_model_file: patch_size             = {hp.patch_size}")
    say(f"quantize_model_file: img_size               = {hp.img_size}")
    say(f"quantize_model_file: num_classes            = {hp.num_classes}")
    say(f"quantize_model_file: ftype                  = {hp.ftype}")
    say(f"quantize_model_file: itype                  = {itype}")

    total_org = 0
    total_new = 0
    hist_all = np.zeros(16, dtype=np.int64)

    with open(fname_out, "wb") as f:
        write_header(f, hp, mf.id2label, ftype=itype)
        for name, rec in mf.tensors.items():
            do_quant = (
                any(re.fullmatch(p, name) for p in K_NAMES)
                and len(rec.shape) == 2
                and rec.dtype in (GGMLDType.F32, GGMLDType.F16)
                # MoE routers stay float: their top-k decisions choose
                # which compute runs
                and ".moe.router." not in name
            )
            ne0 = rec.shape[-1] if rec.shape else 1
            ne1 = rec.shape[0] if len(rec.shape) >= 2 else 1
            line = f"{name:>48s} - [{ne0:5d}, {ne1:5d}], type = {FTYPE_NAMES[rec.dtype]:>6s} "
            if do_quant:
                data = rec.as_f32()  # an f16/f32 record: no dequantizing
                packed, hist = quantize_with_hist(data, qtype)
                raw = packed.tobytes()
                write_tensor(f, name, rec.shape, qtype, raw)
                hist_all += hist
                total_new += len(raw)
                hist_str = " ".join(f"{v / data.size:5.3f}" for v in hist)
                say(
                    line
                    + f"quantizing .. size = {data.nbytes / 1024 / 1024:8.2f} MB -> "
                    + f"{len(raw) / 1024 / 1024:8.2f} MB | hist: {hist_str}"
                )
            else:
                write_tensor(f, name, rec.shape, rec.dtype, rec.data)
                nbytes = rec.dtype.row_bytes(rec.n_elements)
                total_new += nbytes
                say(line + f"size = {nbytes / 1024 / 1024:8.3f} MB")
            total_org += rec.n_elements * 4

    say(f"quantize_model_file: model size  = {total_org / 1024 / 1024:8.2f} MB")
    say(f"quantize_model_file: quant size  = {total_new / 1024 / 1024:8.2f} MB")
    if hist_all.sum() > 0:
        hist_str = " ".join(f"{v / hist_all.sum():5.3f}" for v in hist_all)
        say(f"quantize_model_file: hist: {hist_str}")
    return True


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        prog = "python -m vit_cpp_tpu_torch.cli.quantize"
        print(f"usage: {prog} model-f32.gguf model-quant.gguf type")
        print("  type = 2 - q4_0")
        print("  type = 3 - q4_1")
        print("  type = 6 - q5_0")
        print("  type = 7 - q5_1")
        print("  type = 8 - q8_0")
        return 1
    fname_inp, fname_out, itype = argv[0], argv[1], int(argv[2])

    t_main0 = time.perf_counter()
    t0 = time.perf_counter()
    if not quantize_model_file(fname_inp, fname_out, itype):
        print(f"main: failed to quantize model from '{fname_inp}'", file=sys.stderr)
        return 1
    t_quantize = (time.perf_counter() - t0) * 1000.0
    t_main = (time.perf_counter() - t_main0) * 1000.0
    print()
    print(f"main:    quantize time = {t_quantize:8.2f} ms")
    print(f"main:    total time    = {t_main:8.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
