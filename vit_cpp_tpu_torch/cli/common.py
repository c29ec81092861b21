"""Engine construction shared by the command-line tools.

Counterpart of vit_cpp_tpu/cli/common.py::build_engine, for gguf
checkpoints (f16/f32 or block-quantized). The defaults are the serving
ones: bf16 activations, W8A8 int8 linears, the fused-QKV attention kernel
with the fast softmax, and LayerNorm folded into the matmuls when serving
int8. `mm="pallas"` leaves fold off by default, as the JAX tool does, so
every linear of a block-quantized file runs the dequantizing-matmul
kernel.
"""

from __future__ import annotations

from typing import Tuple

# The leading bytes of a .vitx artifact (vit_cpp_tpu/aot.py's MAGIC).
VITX_MAGIC = b"VITX\x01"


def is_vitx(path: str) -> bool:
    """True when `path` is a .vitx artifact (by magic, not extension);
    vit_cpp_tpu/aot.py::is_vitx."""
    try:
        with open(path, "rb") as f:
            return f.read(len(VITX_MAGIC)) == VITX_MAGIC
    except OSError:
        return False


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


def _not_ported(flag: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} is not ported to vit_cpp_tpu_torch yet; it comes with {slice_}"
    )


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
    """gguf checkpoint -> (engine, is_vitstr). is_vitstr is always False:
    ViTSTR checkpoints raise in detect_hparams."""
    if is_vitx(path):
        raise ValueError(
            f"{path} is a .vitx artifact: it carries StableHLO for the JAX "
            "package and cannot run under vit_cpp_tpu_torch; serve the gguf "
            "checkpoint it was exported from"
        )
    if act == "static" or act_scales is not None:
        raise _not_ported("--act static / --act-scales",
                          "the static-scale slice (quant/calibrate.py)")
    if img_size is not None or patch_size is not None:
        raise _not_ported("--img-size / --patch-size",
                          "the model-families slice (models/resample.py)")
    if tome:
        raise _not_ported("--tome", "the ToMe slice (ops/tome.py)")
    from vit_cpp_tpu_torch.engine import VitEngine

    if fold_ln is None:
        fold_ln = mm == "int8"
    engine = VitEngine(
        path,
        dtype=dtype,
        attn_impl=attn,
        mm_impl=mm,
        fold_ln=fold_ln,
        act_quant=act,
        device=device,
    )
    return engine, False
