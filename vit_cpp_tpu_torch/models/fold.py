"""Load-time folding of LayerNorm affines into the following matmuls.

Counterpart of vit_cpp_tpu/models/fold.py:

    LN(x) @ W + b  ==  n(x) @ (gamma[:, None] * W)  +  (beta @ W + b)

where n(x) is the pure normalization. Applies to ln1 -> qkv, ln2 -> fc1
and the final norm -> head(s). A folded Int8Linear is requantized
channelwise; a dense kernel stays dense in its dtype. A folded QuantLinear
no longer matches its block codes: it becomes a channelwise Int8Linear
when the caller serves with mm_impl="int8", and a dense kernel in the
bias dtype otherwise, never a silent change of matmul path.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from vit_cpp_tpu_torch.quant.int8 import (
    Int8Linear,
    channelwise_int8,
    from_quant_linear,
)
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear


def _fold_into(kernel, bias, gamma, beta, *, int8: bool):
    """(kernel', bias') with the LN affine absorbed."""
    g = gamma.float()
    bt = beta.float()
    if isinstance(kernel, QuantLinear):
        kernel = from_quant_linear(kernel) if int8 else kernel.dequantize(bias.dtype)
    if isinstance(kernel, Int8Linear):
        w = kernel.dequantize(torch.float32)
        new_kernel = channelwise_int8(w * g[..., :, None])
    else:
        w = kernel.float()
        new_kernel = (w * g[..., :, None]).to(kernel.dtype)
    new_bias = (
        torch.einsum("...k,...kn->...n", bt, w) + bias.float()
    ).to(bias.dtype)
    return new_kernel, new_bias


def fold_layernorms(params: Dict[str, Any], mm_impl: str = "int8") -> Dict[str, Any]:
    """A new parameter tree with the LN affines folded; folded LN nodes
    carry scale=None/bias=None, which ops.core.layernorm runs as pure
    normalization. norm_pre stays a real LN (its output is the residual
    stream), as does the final norm of a headless encoder. `mm_impl` is
    the matmul path the caller serves with: it decides how a folded
    QuantLinear is re-represented."""
    int8 = mm_impl == "int8"
    p = dict(params)
    blocks = dict(params["blocks"])
    for ln_key, lin_key in (("ln1", "qkv"), ("ln2", "fc1")):
        ln = blocks[ln_key]
        lin = dict(blocks[lin_key])
        lin["kernel"], lin["bias"] = _fold_into(
            lin["kernel"], lin["bias"], ln["scale"], ln["bias"], int8=int8
        )
        blocks[lin_key] = lin
        blocks[ln_key] = {"scale": None, "bias": None}
    p["blocks"] = blocks
    if "head" in params:
        for hk in ("head", "head_dist") if "head_dist" in params else ("head",):
            head = dict(params[hk])
            head["kernel"], head["bias"] = _fold_into(
                head["kernel"], head["bias"],
                params["norm"]["scale"], params["norm"]["bias"], int8=int8,
            )
            p[hk] = head
        p["norm"] = {"scale": None, "bias": None}
    return p
