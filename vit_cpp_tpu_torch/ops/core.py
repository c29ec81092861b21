"""Core forward-pass ops: layernorm, activations, linear, attention.

Counterpart of vit_cpp_tpu/ops/core.py, with the same numerics:

- layernorm: f32 mean/var with eps inside the rsqrt, whatever the
  activation dtype; scale=None means the affine was folded into the next
  matmul (models/fold.py) and only the normalization runs;
- GELU is the tanh approximation; CLIP models use QuickGELU;
- linear accumulates in f32 and returns the activation dtype; an
  Int8Linear kernel runs the W8A8 path (ops/int8_matmul.py), a
  QuantLinear the dequantizing matmul (ops/qmatmul.py) selected by `impl`;
- attention is the full softmax(Q K^T / sqrt(d)) V with an f32 softmax;
  impl="pallas" runs the split-head kernel (ops/flash_attention.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vit_cpp_tpu_torch.ops.flash_attention import flash_attention
from vit_cpp_tpu_torch.ops.int8_matmul import w8a8_matmul
from vit_cpp_tpu_torch.ops.qmatmul import quant_matmul
from vit_cpp_tpu_torch.quant.int8 import Int8Linear
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
) -> torch.Tensor:
    """y = x @ kernel (+ bias). kernel is a dense (in, out) tensor, a
    QuantLinear dequantized inside the matmul (`impl` "pallas" runs the
    kernel, any other value the plain dequantize + matmul), or an
    Int8Linear running W8A8. A dense kernel ignores `impl`."""
    if isinstance(kernel, Int8Linear):
        y = w8a8_matmul(x, kernel)
    elif isinstance(kernel, QuantLinear):
        y = quant_matmul(x, kernel, impl=impl)
    else:
        # bf16 operands accumulate in f32 and round once, as the JAX
        # dot(preferred_element_type=f32).astype(x.dtype)
        y = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, impl: str = "xla"
) -> torch.Tensor:
    """Full (unmasked) multi-head attention over (B, heads, T, d) tensors;
    the softmax runs in f32. impl="pallas" runs the split-head kernel."""
    if impl == "pallas":
        return flash_attention(q, k, v)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    weights = torch.softmax(logits * scale, dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)
