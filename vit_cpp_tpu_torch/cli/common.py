"""Engine construction shared by the command-line tools.

Counterpart of vit_cpp_tpu/cli/common.py::build_engine, for gguf
checkpoints (f16/f32 or block-quantized): a sequence-head (ViTSTR) file
gets a VitstrEngine, any other a VitEngine, and `img_size`/`patch_size`
resample the geometry at load (models/resample.py). The defaults are the serving
ones: bf16 activations, W8A8 int8 linears, the fused-QKV attention kernel
with the fast softmax, and LayerNorm folded into the matmuls when serving
int8 without a scales sidecar. `mm="pallas"` leaves fold off by default,
as the JAX tool does, so every linear of a block-quantized file runs the
dequantizing-matmul kernel. `act="static"` serves W8A8 with calibrated
activation scales: from `act_scales` (a sidecar JSON), from
`calibrate_engine_from_paths`, or from the first served batch. `tome=r`
merges r token pairs per layer (ops/tome.py); a ViTSTR file refuses it.
A port-made .vitx artifact (aot.py) gets an AotEngine on `device`, with
the JAX tool's refusals of the flags that were baked at export.

`mesh_from_args` turns `--mesh DPxTP` into a DeviceMesh over the
launcher's ranks (parallel/mesh.py) with the JAX tools' messages and exit
codes; `refuse_compile_cache` is the one refusal of `--compile-cache`.
"""

from __future__ import annotations

from typing import Tuple

# one copy of the artifact header readers, the port's aot.py
from vit_cpp_tpu_torch.aot import is_vitx, read_meta  # noqa: F401


def model_spec(s: str) -> Tuple[str, str] | None:
    """Parse a multi-model `name=path` spec; None when `s` is a plain
    path (names must be '/'-free, so an '=' inside a directory name does
    not hijack a single-model invocation, and `./name=x.gguf` is the
    escape hatch for a file that genuinely contains '=');
    vit_cpp_tpu/cli/common.py::model_spec."""
    name, sep, path = s.partition("=")
    if sep and name and path and "/" not in name:
        return name, path
    return None


def refuse_compile_cache(args) -> None:
    """Raise for --compile-cache: it persists XLA compiles, and PyTorch
    runs eagerly, so the port has no such cache."""
    if args.compile_cache is not None:
        raise NotImplementedError(
            "--compile-cache is not ported to vit_cpp_tpu_torch: it is the XLA "
            "compile cache, and PyTorch runs eagerly and has no such cache"
        )


def mesh_from_args(args, tool: str):
    """--mesh DPxTP -> (DeviceMesh, None), or (None, exit code) after the
    JAX tool's message on stderr (vit_cpp_tpu/cli/serve.py:237-252): a bad
    spec, dp not dividing --batch, or a mesh the world cannot hold, which
    also names the launcher. (None, None) without --mesh. The mesh's
    ranks run NCCL on `--device cuda`, gloo on `--device cpu`."""
    import sys

    import torch

    from vit_cpp_tpu_torch.parallel.mesh import (
        available_ranks,
        launcher_hint,
        make_mesh,
        parse_mesh,
    )

    if not args.mesh:
        return None, None
    try:
        dp, tp = parse_mesh(args.mesh)
    except ValueError:
        print(f"bad --mesh {args.mesh!r}: want DPxTP, e.g. 4x2", file=sys.stderr)
        return None, 1
    if args.batch % dp:
        print(f"dp={dp} must divide --batch {args.batch}", file=sys.stderr)
        return None, 1
    try:
        mesh = make_mesh(dp * tp, dp=dp, tp=tp, device_type=torch.device(args.device).type)
    except ValueError as e:  # dp * tp != the ranks the launcher started
        print(f"--mesh {args.mesh}: {e}", file=sys.stderr)
        if dp * tp != available_ranks():
            print(launcher_hint(tool, dp * tp), file=sys.stderr)
        return None, 1
    return mesh, None


def build_engine(
    path: str,
    *,
    dtype: str = "bf16",
    mm: str = "int8",
    attn: str = "pallas-fast",
    fold_ln=None,
    act: str = "dynamic",
    act_scales=None,
    img_size=None,
    patch_size=None,
    tome: int = 0,
    device: str = "cuda",
):
    """gguf checkpoint or .vitx artifact -> (engine, is_vitstr): a
    VitstrEngine when the file has a sequence head, an AotEngine for an
    artifact (its knobs were baked at export)."""
    if is_vitx(path):
        from vit_cpp_tpu_torch.aot import AotEngine

        if act == "static":
            raise ValueError(
                "--act static does not apply to a .vitx artifact — its "
                "activation scales were baked at export (vit-export "
                "--act static --calib-dir ...)"
            )
        if img_size is not None or patch_size is not None:
            raise ValueError(
                "--img-size/--patch-size do not apply to a .vitx artifact "
                "— its geometry was baked at export (vit-export "
                "--img-size/--patch-size ...)"
            )
        if tome:
            raise ValueError(
                "--tome does not apply to a .vitx artifact — the graph "
                "was baked at export (vit-export --tome R)"
            )
        engine = AotEngine(path, device=device)
        return engine, engine.hp.seq_len is not None
    from vit_cpp_tpu_torch.engine import VitEngine, VitstrEngine, detect_hparams
    from vit_cpp_tpu_torch.gguf.reader import read_model

    if fold_ln is None:
        # a sidecar's scales describe the unfolded graph (the engine
        # refuses the pair): fold stays off for them by default
        fold_ln = mm == "int8" and act_scales is None
    mf = read_model(path)  # read once: the engine takes the parsed file
    is_vitstr = detect_hparams(mf).seq_len is not None
    engine = (VitstrEngine if is_vitstr else VitEngine)(
        path,
        dtype=dtype,
        attn_impl=attn,
        mm_impl=mm,
        fold_ln=fold_ln,
        act_quant=act,
        act_scales=act_scales,
        img_size=img_size,
        patch_size=patch_size,
        tome=tome,
        verbose=False,
        device=device,
        model_file=mf,
    )
    return engine, is_vitstr


def calibrate_engine_from_paths(engine, calib: str, n: int = 16) -> bool:
    """Calibrate static activation scales on up to `n` images from a
    directory (walked in sorted order) or one file; True when the engine
    now serves static scales, False when the guardrail rejected them and
    the engine stays on dynamic ones (vit_cpp_tpu/cli/common.py:83-125).
    Raises ValueError when the set holds no image or none decodes."""
    import os

    import torch

    from vit_cpp_tpu_torch.io.image import IMAGE_EXTS, load_image_rgb
    from vit_cpp_tpu_torch.quant.int8 import params_have_static_scales

    paths = []
    if os.path.isdir(calib):
        for root, _, files in os.walk(calib):
            paths.extend(
                os.path.join(root, f)
                for f in sorted(files)
                if os.path.splitext(f)[1] in IMAGE_EXTS
            )
    else:
        paths = [calib]
    if not paths:
        raise ValueError(f"no calibration images under {calib}")
    pix = []
    for p in paths:
        if len(pix) >= n:
            break
        try:
            pix.append(engine.preprocess_image(load_image_rgb(p)))
        except (OSError, ValueError):  # an undecodable file in the set
            continue
    if not pix:
        raise ValueError(f"no decodable calibration images under {calib}")
    engine.calibrate(torch.stack(pix))
    return params_have_static_scales(engine.params)
