"""`vitstr` CLI on the PyTorch port: recognize scene text in one image.

Counterpart of vit_cpp_tpu/cli/vitstr.py, with the `vit` CLI's hand
parser (-m/-i/-t/-k/-s/-e, plus --device) and the reference console
surface: the `vit_model_load:` echo and the image lines, then the decoded
string between `------------------` rules with its `score :` line on
stdout; `main: seed`, `main: n_threads` and the load / processing / total
timing lines on stderr. The engine is VitstrEngine in f32 with composed
attention and dense matmuls (TF32 off), the parity rung. A port-made .vitx
artifact (vit_cpp_tpu_torch/aot.py) runs its smallest baked batch.

Usage: python -m vit_cpp_tpu_torch.cli.vitstr -m vitstr-model.gguf -i demo.png [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys
import time

from vit_cpp_tpu_torch.cli.vit import VitParams, vit_params_parse


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    t_main_start = time.perf_counter()
    params = VitParams()
    params.model = "../ggml-model-f16.gguf"
    params.fname_inp = "../images/demo_1.jpg"
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
            from vit_cpp_tpu_torch.engine import VitstrEngine

            engine = VitstrEngine(params.model, eps=params.eps, device=params.device)
    except (OSError, ValueError) as exc:
        print(f"main: failed to load model from '{params.model}': {exc}", file=sys.stderr)
        return 1
    t_load = engine.load_ms

    try:
        text, score = engine.recognize_file(params.fname_inp)
    except OSError as exc:
        print(f"main: failed to load image from '{params.fname_inp}': {exc}", file=sys.stderr)
        return 1

    print("------------------ ")
    print(text)
    print(f"score : {score:.2f} ")
    print("------------------ ")

    t_total = (time.perf_counter() - t_main_start) * 1000.0
    print("\n", file=sys.stderr)
    print(f"main:    model load time = {t_load:8.2f} ms", file=sys.stderr)
    print(f"main:    processing time = {t_total - t_load:8.2f} ms", file=sys.stderr)
    print(f"main:    total time      = {t_total:8.2f} ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
