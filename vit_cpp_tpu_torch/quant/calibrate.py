"""Calibration of static activation scales for W8A8 serving.

Counterpart of vit_cpp_tpu/quant/calibrate.py. The dynamic W8A8 path
(ops/int8_matmul.py) reduces an absmax over every GEMM input per token
before each of the four block linears; static serving replaces it with a
per-site scale measured once on representative images, so the input
quantizes as round(clip(x / act_scale, -127, 127)):

    params_i8 = convert_params_to_int8(load_params(...))
    params_st = calibrate_act_scales(params_i8, sample_images, hp)
    forward(params_st, images, hp, mm_impl="int8")   # no absmax passes

Static per-tensor scales are coarser than per-token ones and clip
out-of-range activations at +-127 codes; `margin` leaves headroom above
the calibration batch's maxima, and `validate_act_scales` is the
guardrail that rejects scales which move the predictions.

A folded tree (models/fold.py) keeps the final norm's affine in
`features_norm` for the embedding readout; the head's maximum is read
after the affine-free `norm` the folded head consumes, where the JAX
package reads it, so a folded engine's head scale equals the JAX one's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.parallel.mesh import max_over
from vit_cpp_tpu_torch.quant.int8 import Int8Linear, true_div

_GEMMS = ("qkv", "proj", "fc1", "fc2")
# V-MoE trees take no static scales (the JAX engine's refusal,
# vit_cpp_tpu/engine.py:193-197): the taps walk the dense block stack, and
# the experts have no int8 leaves
MOE_REFUSAL = (
    "static act scales are unsupported for MoE checkpoints "
    "(the calibrator walks the dense block stack, "
    "quant/calibrate.py — serve MoE with dynamic W8A8)"
)


def _heads(params: Dict[str, Any]):
    """The classifier heads present: both share the pooled readout."""
    names = ("head", "head_dist") if "head_dist" in params else ("head",)
    return [n for n in names if n in params]


def _require_int8(params: Dict[str, Any], who: str) -> None:
    for name in _GEMMS:
        kernel = params["blocks"][name]["kernel"]
        if not isinstance(kernel, Int8Linear):
            raise ValueError(
                f"{who} needs an int8-converted tree (convert_params_to_int8) "
                f"— blocks.{name}.kernel is {type(kernel).__name__}"
            )


def collect_act_maxima(
    params: Dict[str, Any],
    images: torch.Tensor,
    hp: VitHParams,
    *,
    attn_impl: str = "xla",
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """The absmax of every GEMM input over the calibration batch:
    {"qkv"|"proj"|"fc1"|"fc2": (L,) f32, "head": () f32}.

    Walks the blocks with the int8 forward (dynamic quantization), so the
    observed activations are those static serving will see; the head's
    maximum covers the pooled readout (CLS, the mean of the patch tokens,
    both prefix tokens of a distilled tree, the 25 rows of a ViTSTR
    sequence head, or the output of SigLIP's attention pooling). Under a
    mesh every rank runs the whole batch on its shards, and each site's
    maximum is taken over "model" too: the taps of the row-parallel
    inputs (proj, fc2) see only a K-shard."""
    from vit_cpp_tpu_torch.models.vit import forward

    if hp.num_experts:
        raise ValueError(MOE_REFUSAL)
    maxima = {name: [] for name in (*_GEMMS, "head")}

    def tap(name, v):
        maxima[name[: -len("_in")]].append(v.float().abs().amax())

    # the head's input is the affine-free folded norm of a classifier; a
    # headless encoder's readout is its features
    forward(
        params, images, hp, attn_impl=attn_impl, mm_impl="int8",
        features="head" not in params, tap=tap, mesh=mesh,
    )
    out = {name: max_over(torch.stack(v), mesh) for name, v in maxima.items()}
    out["head"] = out["head"][0]
    return out


def _with_scale(leaf: Int8Linear, scale: torch.Tensor) -> Int8Linear:
    return dataclasses.replace(leaf, act_scale=scale.to(leaf.codes.device, torch.float32))


def _attach(params: Dict[str, Any], scales: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A new tree whose block Int8Linear leaves carry scales[site] and
    whose int8 head(s) carry scales["head"], when given."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name in _GEMMS:
        leaf = dict(blocks[name])
        leaf["kernel"] = _with_scale(leaf["kernel"], scales[name])
        blocks[name] = leaf
    out["blocks"] = blocks
    if "head" in scales:
        for name in _heads(params):
            head = dict(params[name])
            if isinstance(head["kernel"], Int8Linear):
                head["kernel"] = _with_scale(head["kernel"], scales["head"])
            out[name] = head
    return out


def calibrate_act_scales(
    params: Dict[str, Any],
    images: torch.Tensor,
    hp: VitHParams,
    *,
    margin: float = 1.05,
    attn_impl: str = "xla",
    mesh=None,
) -> Dict[str, Any]:
    """A new tree whose Int8Linear leaves carry the static scale
    absmax * margin / 127 measured on `images`, at least 1e-12: (L, 1, 1)
    per block site, (1, 1) for the head(s), which share one scale."""
    _require_int8(params, "calibrate_act_scales")
    maxima = collect_act_maxima(params, images, hp, attn_impl=attn_impl, mesh=mesh)
    return _attach(params, act_scales_from_maxima(maxima, margin))


def act_scales_from_maxima(
    maxima: Dict[str, torch.Tensor], margin: float
) -> Dict[str, torch.Tensor]:
    """collect_act_maxima's output -> static scales absmax * margin / 127,
    at least 1e-12: (L, 1, 1) per block site, (1, 1) for the head. The
    division is a true one on every device (quant/int8.py::true_div)."""
    return {
        name: torch.clamp(true_div(m.float() * margin, 127.0), min=1e-12)[..., None, None]
        for name, m in maxima.items()
    }


def attach_act_scales(params: Dict[str, Any], scales: Dict[str, Any]) -> Dict[str, Any]:
    """Attach pre-measured static scales (a sidecar read by
    quant/qat.py::load_act_scales) to an int8-converted tree, with no
    calibration pass."""
    _require_int8(params, "attach_act_scales")
    return _attach(params, {k: torch.as_tensor(v, dtype=torch.float32)
                            for k, v in scales.items()})


def validate_act_scales(
    static_params: Dict[str, Any],
    dynamic_params: Dict[str, Any],
    images: torch.Tensor,
    hp: VitHParams,
    *,
    min_agreement: float = 0.90,
    attn_impl: str = "xla",
    mesh=None,
) -> float:
    """The guardrail before serving static scales: top-1 agreement of the
    static and dynamic int8 forwards on `images` (a headless encoder's
    by the argmax of its features). Raises ValueError below
    `min_agreement`; returns the agreement otherwise.

    Scales that clip (a calibration set that under-represents the served
    images) move the predictions; a held-out probe batch catches that
    better than the calibration batch itself."""
    from vit_cpp_tpu_torch.models.vit import forward

    feats = "head" not in dynamic_params
    dyn = forward(dynamic_params, images, hp, mm_impl="int8", attn_impl=attn_impl,
                  features=feats, mesh=mesh)
    st = forward(static_params, images, hp, mm_impl="int8", attn_impl=attn_impl,
                 features=feats, mesh=mesh)
    agreement = float((dyn.argmax(-1) == st.argmax(-1)).float().mean())
    if agreement < min_agreement:
        raise ValueError(
            f"static activation scales disagree with the dynamic path on "
            f"{(1 - agreement) * 100:.1f}% of probe predictions "
            f"(agreement {agreement:.3f} < required {min_agreement}); the "
            "calibration set likely under-represents the serving "
            "distribution — recalibrate on representative data or serve "
            "with act_quant='dynamic'"
        )
    return agreement
