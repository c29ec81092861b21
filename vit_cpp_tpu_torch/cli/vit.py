"""`vit` CLI on the PyTorch port: classify one image, print the top-k labels.

Counterpart of vit_cpp_tpu/cli/vit.py, with its hand parser, usage text,
exit codes and console surface: the `vit_model_load:` echo and the image
lines on stdout, then the ` > label : prob` top-k lines; `main: seed`,
`main: n_threads`, the resampler's scale and the three timing lines on
stderr. The engine is the f32 parity rung: f32 weights and activations,
composed attention, dense matmuls with TF32 off (ops/precision.py), no
custom kernel. `-t` (threads) and `-s` (seed) are echoed and unused, as in
the JAX CLI. One flag is added: `--device` (default cuda; cpu runs the
same forward on the CPU). A .vitx artifact made by the port's vit-export
(vit_cpp_tpu_torch/aot.py) runs its smallest baked batch, with the knobs
it was exported with, on the device it was exported on; a sharded one runs
under the launcher on every rank of its mesh, and only rank 0 prints.

Usage: python -m vit_cpp_tpu_torch.cli.vit -m model.gguf -i image.jpg -k 5 [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys
import time


class VitParams:
    """The JAX CLI's defaults (the reference's vit_params), plus the device."""

    def __init__(self):
        self.seed = -1
        self.n_threads = os.cpu_count() or 1
        self.model = "../ggml-model-f16.gguf"
        self.fname_inp = "../assets/tench.jpg"
        self.eps = 1e-6
        self.topk = 5
        self.device = "cuda"


def print_usage(argv, params: VitParams):
    prog = argv[0] if argv else "vit"
    e = sys.stderr
    print(f"usage: {prog} [options]", file=e)
    print("", file=e)
    print("options:", file=e)
    print("  -h, --help              show this help message and exit", file=e)
    print(f"  -m FNAME, --model       model path (default: {params.model})", file=e)
    print(f"  -i FNAME, --inp         input file (default: {params.fname_inp})", file=e)
    print(
        f"  -t N, --threads         number of threads to use during computation (default: {params.n_threads})",
        file=e,
    )
    print(f"  -k N, --topk            top k classes to print (default: {params.topk})", file=e)
    print("  -s SEED, --seed         RNG seed (default: -1)", file=e)
    print(
        f"  -e FLOAT, --epsilon     epsilon constant in Layer Norm layers (default: {params.eps:f})",
        file=e,
    )
    print(f"  --device DEVICE         torch device (default: {params.device})", file=e)
    print("", file=e)


def vit_params_parse(argv, params: VitParams) -> bool:
    i = 1
    while i < len(argv):
        arg = argv[i]
        try:
            if arg in ("-s", "--seed"):
                i += 1
                params.seed = int(argv[i])
            elif arg in ("-t", "--threads"):
                i += 1
                params.n_threads = int(argv[i])
            elif arg in ("-m", "--model"):
                i += 1
                params.model = argv[i]
            elif arg in ("-i", "--inp"):
                i += 1
                params.fname_inp = argv[i]
            elif arg in ("-k", "--topk"):
                i += 1
                params.topk = int(argv[i])
            elif arg in ("-e", "--epsilon"):
                i += 1
                params.eps = float(argv[i])
            elif arg == "--device":
                i += 1
                params.device = argv[i]
            elif arg in ("-h", "--help"):
                print_usage(argv, params)
                sys.exit(0)
            else:
                print(f"error: unknown argument: {arg}", file=sys.stderr)
                print_usage(argv, params)
                sys.exit(0)
        except (IndexError, ValueError):
            print(f"error: invalid value for argument: {arg}", file=sys.stderr)
            print_usage(argv, params)
            return False
        i += 1
    return True


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    t_main_start = time.perf_counter()
    params = VitParams()
    if not vit_params_parse(argv, params):
        return 1

    if params.seed < 0:
        params.seed = int(time.time())
    print(f"main: seed = {params.seed}", file=sys.stderr)
    print(f"main: n_threads = {params.n_threads} / {os.cpu_count()}", file=sys.stderr)

    from vit_cpp_tpu_torch.aot import is_vitx

    try:
        if is_vitx(params.model):
            # an AOT artifact: eps and every engine knob baked at export
            from vit_cpp_tpu_torch.aot import AotEngine

            engine = AotEngine(params.model, device=params.device)
        else:
            from vit_cpp_tpu_torch.engine import VitEngine

            engine = VitEngine(params.model, eps=params.eps, device=params.device)
    except (OSError, ValueError) as exc:
        print(f"main: failed to load model from '{params.model}': {exc}", file=sys.stderr)
        return 1
    t_load = engine.load_ms
    from vit_cpp_tpu_torch.parallel.mesh import is_leader

    leader = getattr(engine, "mesh", None) is None or is_leader()
    try:
        if leader:
            results = engine.classify_file(params.fname_inp, topk=params.topk)
        else:  # a sharded artifact's other ranks: the same collectives, no output
            engine.classify_file(params.fname_inp, topk=params.topk, verbose=False)
            return 0
    except OSError as exc:
        print(f"main: failed to load image from '{params.fname_inp}': {exc}", file=sys.stderr)
        return 1
    except ValueError as exc:  # a headless encoder
        print(f"main: {exc}", file=sys.stderr)
        return 1

    print("", file=sys.stderr)
    for _idx, prob, label in results:
        print(f" > {label} : {prob:.2f}")

    t_total = (time.perf_counter() - t_main_start) * 1000.0
    print("\n", file=sys.stderr)
    print(f"main:    model load time = {t_load:8.2f} ms", file=sys.stderr)
    print(f"main:    processing time = {t_total - t_load:8.2f} ms", file=sys.stderr)
    print(f"main:    total time      = {t_total:8.2f} ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
