"""Core forward-pass ops: layernorm, activations, linear, attention.

Counterpart of vit_cpp_tpu/ops/core.py, with the same numerics:

- layernorm: f32 mean/var with eps inside the rsqrt, whatever the
  activation dtype; scale=None means the affine was folded into the next
  matmul (models/fold.py) and only the normalization runs;
- GELU is the tanh approximation; CLIP models use QuickGELU;
- linear accumulates in f32 and returns the activation dtype; an
  Int8Linear kernel runs the W8A8 path (ops/int8_matmul.py), a
  QuantLinear the dequantizing matmul (ops/qmatmul.py) selected by `impl`;
- attention is the full softmax(Q K^T / sqrt(d)) V with an f32 softmax,
  proportional (softmax(z + log s)) under ToMe sizes; impl="pallas" runs
  the split-head kernel (ops/flash_attention.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vit_cpp_tpu_torch.ops.flash_attention import flash_attention
from vit_cpp_tpu_torch.ops.int8_matmul import w8a8_matmul
from vit_cpp_tpu_torch.ops.qmatmul import dequant_matmul, quant_matmul
from vit_cpp_tpu_torch.parallel.mesh import reduce_from_model
from vit_cpp_tpu_torch.quant.int8 import Int8Linear
from vit_cpp_tpu_torch.quant.qat import fake_quant_act, fake_quant_act_static
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear


def layernorm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def mlp_act(hidden_act: str):
    """Block-MLP activation for an hparams.hidden_act value."""
    if hidden_act == "quick_gelu":
        return quick_gelu
    if hidden_act == "gelu_tanh":
        return gelu_tanh
    raise ValueError(
        f"hidden_act must be gelu_tanh|quick_gelu, got {hidden_act!r}"
    )


def linear(
    x: torch.Tensor,
    kernel,
    bias: Optional[torch.Tensor] = None,
    *,
    impl: str = "xla",
    act_scale: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """y = x @ kernel (+ bias). kernel is a dense (in, out) tensor, a
    QuantLinear dequantized inside the matmul (`impl` "pallas" runs the
    kernel, any other value the plain dequantize + matmul), or an
    Int8Linear running W8A8. A dense kernel ignores `impl` but "qat":
    quantization-aware training (quant/qat.py), whose kernel was already
    fake-quantized, then fake-quantizes x as the W8A8 matmul quantizes
    its activations, per token, or per tensor with the static
    `act_scale` that rides the block dict (--qat-act static).

    `mesh` says that x is this rank's K-shard over the mesh's "model" axis
    (a row-parallel linear): the per-token absmax of W8A8 and of QAT is
    then the global one, and the product is summed over "model" before it
    is rounded to x's dtype: W8A8 sums its int32 accumulator, a dense or
    dequantized kernel (the dequantizing kernel too, by its f32-output
    instantiation) its f32 partial products."""
    if isinstance(kernel, Int8Linear):
        y = w8a8_matmul(x, kernel, mesh=mesh)
    elif isinstance(kernel, QuantLinear):
        if mesh is None:
            y = quant_matmul(x, kernel, impl=impl)
        elif impl == "pallas":
            y = dequant_matmul(x, kernel, f32_out=True)
        else:
            y = _matmul_f32(x, kernel.dequantize(x.dtype))
    else:
        if impl == "qat":
            x = (fake_quant_act(x, mesh) if act_scale is None
                 else fake_quant_act_static(x, act_scale))
        # bf16 operands accumulate in f32 and round once, as the JAX
        # dot(preferred_element_type=f32).astype(x.dtype)
        w = kernel.to(x.dtype)
        y = torch.matmul(x, w) if mesh is None else _matmul_f32(x, w)
    if mesh is not None and not isinstance(kernel, Int8Linear):
        y = reduce_from_model(y.float(), mesh).to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation and an f32 result: a row-parallel
    partial product, rounded to x's dtype only after its sum."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())  # bf16 products are exact in f32


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, impl: str = "xla",
    sizes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full (unmasked) multi-head attention over (B, heads, Tq, d) queries
    and (B, heads, Tk, d) keys and values; the softmax runs in f32.
    `sizes` (B, Tk) are ToMe merged-token counts: proportional attention,
    softmax(z + log s) (vit_cpp_tpu/ops/flash_attention.py::
    _attention_qkv_xla). impl="pallas" runs the split-head kernel, which
    takes no sizes."""
    if impl == "pallas":
        if sizes is not None:
            raise ValueError("the split-head attention kernel takes no ToMe sizes")
        return flash_attention(q, k, v)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if sizes is not None:
        logits = logits + torch.log(sizes.float())[:, None, None, :]
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)
