"""Quantization-aware training: fake quantization with straight-through
gradients, and the static-scale sidecar.

Counterpart of vit_cpp_tpu/quant/qat.py. The serving paths add
quantization noise the dense fine-tune never sees: the block codecs on
disk (quant/blocks.py), the load-time channelwise int8 of the W8A8 path
(quant/int8.py) and the per-token activation quantization inside the
int8 matmul (ops/int8_matmul.py). QAT trains through the same noise:

  fake_quant_params(p, "q4_0")   == dequant(channelwise_int8(dequant(
                                      Q4_0_blocks(w))))  per targeted leaf
  fake_quant_act(x)              == sx * round(x / sx), sx per-token absmax/127

each rounding wrapped in a straight-through estimator (identity gradient;
the rounded value is computed without autograd) so the f32 master weights
keep training. The values are the JAX package's bit for bit, on the CPU
and on the card:

- the STE is `(x - x.detach()) + q.detach()`, exactly q for finite x
  (`x + (q - x).detach()` adds one f32 rounding);
- Q8_0 codes round half away from zero, activations and channelwise int8
  half to even (torch.round, as jnp.round);
- every division by a constant divides by a tensor (quant/int8.py::
  true_div): on the card PyTorch turns a division by a Python scalar
  into a product with its reciprocal, which rounds differently;
- block scales and minima round-trip through f16 (`_f16`); the codes use
  the f32 scale, the dequantization the f16-stored one.

The quantize-dequantized GEMM input is what the JAX package names "act_q"
for its "dots+attn" rematerialisation policy. Inside `act_q_saved()` (a
block that models/vit.py checkpoints under that policy) it comes from one
operator, `torch.ops.vit_cpp_tpu_torch.act_q`, whose output the policy
saves, so that the backward's recompute neither reruns the absmax and
rounding chain nor its collective; elsewhere the same ops run inline.

`save_act_scales` / `load_act_scales` (:301-331 there) write and read the
sidecar JSON that `VitEngine(act_scales=...)` and `--act-scales` take.
"""

from __future__ import annotations

import contextlib
import json
import threading
from typing import Any, Dict, Optional

import torch

from vit_cpp_tpu_torch._build import operator
from vit_cpp_tpu_torch.parallel.mesh import axis_size
from vit_cpp_tpu_torch.quant.calibrate import act_scales_from_maxima, collect_act_maxima
from vit_cpp_tpu_torch.quant.int8 import channelwise_int8, true_div

QK = 32  # ggml block size (gguf/dtypes.py)

QAT_FORMATS = ("w8a8", "q8_0", "q4_0", "q4_1", "q5_0", "q5_1")

_GEMMS = ("qkv", "proj", "fc1", "fc2")


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through: the value is exactly q, the gradient that of the
    identity on x ((x - x.detach()) is +0.0 for finite x)."""
    return (x - x.detach()) + q.detach()


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C roundf: half away from zero (torch.round is half to even), the
    Q8_0 codes' rule (quant/blocks.py)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _inverse(d: torch.Tensor, nonzero: torch.Tensor) -> torch.Tensor:
    return torch.where(nonzero, 1.0 / d, torch.zeros_like(d))


def _qdq_act(xf: torch.Tensor, act_scale: Optional[torch.Tensor], tp: int) -> torch.Tensor:
    """The int8 quantize-dequantized value of f32 x, the W8A8 matmul's:
    with a static per-tensor `act_scale`, codes = round(clip(x / sx,
    +-127)); else per token, sx = absmax(token) * (1/127) (the absmax taken
    over the "model" axis of `tp` ranks when x is a K-shard), codes =
    round(x * (1/sx)); value = codes * sx."""
    if act_scale is not None:
        sx = act_scale.float()
        return torch.round(torch.clamp(xf / sx, -127.0, 127.0)) * sx
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    if tp > 1:
        absmax = torch.ops.vit_cpp_tpu_torch.all_reduce_over(absmax, "model", tp, "max")
    sx = absmax * (1.0 / 127.0)
    return torch.round(xf * _inverse(sx, sx > 0)) * sx


_ACT_Q = operator(
    "act_q(Tensor xf, Tensor? act_scale, int tp) -> Tensor",
    cpu=_qdq_act, cuda=_qdq_act, fake=lambda xf, act_scale, tp: torch.empty_like(xf),
)
# per thread: the backward's recompute runs on autograd's device thread
_SAVED = threading.local()


@contextlib.contextmanager
def act_q_saved(on: bool):
    """Within it (on), the fake-quantized activations come from the act_q
    operator."""
    prev = getattr(_SAVED, "on", False)
    _SAVED.on = on
    try:
        yield
    finally:
        _SAVED.on = prev


def _fake_quant_act(x: torch.Tensor, act_scale: Optional[torch.Tensor], tp: int) -> torch.Tensor:
    xf = x.float()
    with torch.no_grad():
        q = (_ACT_Q if getattr(_SAVED, "on", False) else _qdq_act)(xf, act_scale, tp)
    return _ste(xf, q).to(x.dtype)


def fake_quant_act_static(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """Per-tensor static-scale int8 quantize-dequantize with STE, the W8A8
    matmul's static branch: codes = round(clip(x / sx, +-127)), value =
    codes * sx, clipping included. `act_scale` ([1,] 1) is frozen."""
    return _fake_quant_act(x, act_scale, 1)


def fake_quant_act(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-token dynamic int8 quantize-dequantize with STE, the W8A8
    matmul's activation quantization: sx = absmax(token) * (1/127) in f32,
    codes = round(x * (1/sx)), value = codes * sx."""
    return _fake_quant_act(x, None, axis_size(mesh, "model"))


def _block_view(w: torch.Tensor) -> torch.Tensor:
    """([L,] in, out) -> ([L,] in/QK, QK, out): blocks run along the
    contraction axis in groups of 32, QuantLinear's layout."""
    if w.shape[-2] % QK:
        raise ValueError(f"in_features {w.shape[-2]} not a multiple of QK={QK}")
    return w.reshape(*w.shape[:-2], w.shape[-2] // QK, QK, w.shape[-1])


def _f16(x: torch.Tensor) -> torch.Tensor:
    """Round-trip through f16: block scales and minima are stored as f16."""
    return x.to(torch.float16).float()


def _block_qdq(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """Quantize-dequantize a dense ([L,] in, out) kernel through a ggml
    block codec, bit for bit quant/blocks.py's quantize + dequantize:

      q8_0      d = absmax/127 (f16), codes = roundf(x/d)
      q4_0/q5_0 d = signed_absmax / -(levels/2) (f16),
                codes = min(trunc(x/d + levels/2 + 0.5), levels-1)
      q4_1/q5_1 d = (max-min)/(levels-1), m = min (both f16),
                codes = min(trunc((x-min)/d + 0.5), levels-1)
    """
    xb = _block_view(w.float())
    if fmt == "q8_0":
        amax = torch.amax(torch.abs(xb), dim=-2, keepdim=True)
        d = true_div(amax, 127.0)
        codes = _round_half_away(xb * _inverse(d, d != 0.0))
        q = codes * _f16(d)
    elif fmt in ("q4_0", "q5_0"):
        levels = 16 if fmt == "q4_0" else 32
        half = levels // 2
        # the signed value at the absmax position, by the JAX package's
        # where(|max| >= |min|) rule
        mx = torch.amax(xb, dim=-2, keepdim=True)
        mn = torch.amin(xb, dim=-2, keepdim=True)
        signed_max = torch.where(torch.abs(mx) >= torch.abs(mn), mx, mn)
        d = true_div(signed_max, -float(half))
        codes = torch.clamp(torch.trunc(xb * _inverse(d, d != 0.0) + (half + 0.5)),
                            max=float(levels - 1))
        q = (codes - half) * _f16(d)
    elif fmt in ("q4_1", "q5_1"):
        levels = 16 if fmt == "q4_1" else 32
        mn = torch.amin(xb, dim=-2, keepdim=True)
        mx = torch.amax(xb, dim=-2, keepdim=True)
        d = true_div(mx - mn, float(levels - 1))
        codes = torch.clamp(torch.trunc((xb - mn) * _inverse(d, d != 0.0) + 0.5),
                            max=float(levels - 1))
        q = codes * _f16(d) + _f16(mn)
    else:
        raise ValueError(f"unknown block format {fmt!r}")
    return q.reshape(w.shape)


def fake_quant_weight(w: torch.Tensor, fmt: str, mesh=None) -> torch.Tensor:
    """STE quantize-dequantize of one dense kernel through the whole
    serving chain: "w8a8" is f16 storage then the load-time channelwise
    int8; a block format is its on-disk codec, then the same channelwise
    requantization. `mesh`: w is this rank's rows of a row-parallel
    kernel, whose channel absmax is the maximum over "model" (its 32-row
    blocks lie inside a shard when K/tp is a multiple of 32)."""
    wf = w.float()
    with torch.no_grad():
        q = channelwise_int8(_f16(wf) if fmt == "w8a8" else _block_qdq(wf, fmt),
                             mesh=mesh).dequantize()
    return _ste(wf, q).to(w.dtype)


def fake_quant_params(params: Dict[str, Any], fmt: str, mesh=None, hp=None) -> Dict[str, Any]:
    """Fake-quantize the leaves the serving quantizer targets:
    blocks.{qkv,proj,fc1,fc2}.kernel and the head(s); the patch
    embedding, attention pooling, norms and biases stay float. Under a
    mesh (with the model's `hp`) the row-parallel shards of proj and fc2
    take their channel absmax over "model"."""
    if fmt not in QAT_FORMATS:
        raise ValueError(f"qat format must be one of {QAT_FORMATS}, got {fmt!r}")
    out = dict(params)
    blocks = dict(params["blocks"])
    rows = {}
    if axis_size(mesh, "model") > 1:
        rows = {"proj": hp.hidden_size, "fc2": hp.mlp_dim}
    for name in _GEMMS:
        k = blocks[name]["kernel"]
        row = name in rows and k.shape[-2] != rows[name]
        blocks[name] = {**blocks[name],
                        "kernel": fake_quant_weight(k, fmt, mesh if row else None)}
    out["blocks"] = blocks
    for name in ("head", "head_dist"):
        if name in params:
            out[name] = {**params[name], "kernel": fake_quant_weight(params[name]["kernel"], fmt)}
    return out


def measure_act_scales(
    params: Dict[str, Any], images: torch.Tensor, hp, fmt: str, *, margin: float = 1.05,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Per-site static activation scales for `--qat-act static`: the
    serving calibrator's maxima and rule (quant/calibrate.py::
    collect_act_maxima, act_scales_from_maxima) on the fake-quantized
    model with the composed attention and dense matmuls:
    {"qkv"|"proj"|"fc1"|"fc2": (L, 1, 1), "head": (1, 1)} f32. The head's
    input is the pooled readout (the output of SigLIP's attention
    pooling, both prefix tokens of a distilled tree, the seq_len rows of
    a sequence head)."""
    if mesh is not None:
        from vit_cpp_tpu_torch.parallel.sharding import local_params

        params = local_params(params, mesh)
    with torch.no_grad():
        maxima = collect_act_maxima(fake_quant_params(params, fmt, mesh, hp), images, hp,
                                    mesh=mesh)
    return act_scales_from_maxima(maxima, margin)


def inject_act_scales(params: Dict[str, Any], scales: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Attach "act_scale" entries beside the targeted kernels so that
    forward(mm_impl="qat") runs the static fake quantization. Call it on
    the output of fake_quant_params, inside the loss: the scales are
    never differentiated."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for name in _GEMMS:
        blocks[name] = {**blocks[name], "act_scale": scales[name]}
    out["blocks"] = blocks
    for name in ("head", "head_dist"):
        if name in params:
            out[name] = {**params[name], "act_scale": scales["head"]}
    return out


def save_act_scales(path: str, scales: Dict[str, torch.Tensor], margin: float) -> None:
    """Write per-site scales (absmax * margin / 127) as the sidecar JSON:
    {"margin", "rule", <site>: [floats]}."""
    payload = {"margin": margin, "rule": "absmax*margin/127"}
    for k, v in scales.items():
        payload[k] = torch.as_tensor(v).detach().float().cpu().reshape(-1).tolist()
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def load_act_scales(path: str) -> Dict[str, torch.Tensor]:
    """Read a sidecar back to the calibrator's shapes: (L, 1, 1) f32 per
    block site, (1, 1) for the head when present."""
    with open(path) as f:
        payload = json.load(f)
    out: Dict[str, torch.Tensor] = {}
    for name in _GEMMS:
        if name not in payload:
            raise ValueError(f"act-scales file {path} is missing {name!r}")
        v = torch.tensor(payload[name], dtype=torch.float32)
        out[name] = v.reshape(v.shape[0], 1, 1)
    if "head" in payload:
        out["head"] = torch.tensor(payload["head"], dtype=torch.float32).reshape(1, 1)
    return out
