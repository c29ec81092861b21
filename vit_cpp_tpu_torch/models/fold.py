"""Load-time folding of LayerNorm affines into the following matmuls.

Counterpart of vit_cpp_tpu/models/fold.py:

    LN(x) @ W + b  ==  n(x) @ (gamma[:, None] * W)  +  (beta @ W + b)

where n(x) is the pure normalization. Applies to ln1 -> qkv, ln2 -> fc1
and the final norm -> head(s). A folded Int8Linear is requantized
channelwise; a dense kernel stays dense in its dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from vit_cpp_tpu_torch.quant.int8 import (
    Int8Linear,
    channelwise_int8,
    quant_linear_unsupported,
)


def _fold_into(kernel, bias, gamma, beta):
    """(kernel', bias') with the LN affine absorbed."""
    g = gamma.float()
    bt = beta.float()
    if isinstance(kernel, Int8Linear):
        w = kernel.dequantize(torch.float32)
        new_kernel = channelwise_int8(w * g[..., :, None])
    elif isinstance(kernel, torch.Tensor):
        w = kernel.float()
        new_kernel = (w * g[..., :, None]).to(kernel.dtype)
    else:
        raise quant_linear_unsupported("fold_layernorms")
    new_bias = (
        torch.einsum("...k,...kn->...n", bt, w) + bias.float()
    ).to(bias.dtype)
    return new_kernel, new_bias


def fold_layernorms(params: Dict[str, Any]) -> Dict[str, Any]:
    """A new parameter tree with the LN affines folded; folded LN nodes
    carry scale=None/bias=None, which ops.core.layernorm runs as pure
    normalization. norm_pre stays a real LN (its output is the residual
    stream), as does the final norm of a headless encoder."""
    p = dict(params)
    blocks = dict(params["blocks"])
    for ln_key, lin_key in (("ln1", "qkv"), ("ln2", "fc1")):
        ln = blocks[ln_key]
        lin = dict(blocks[lin_key])
        lin["kernel"], lin["bias"] = _fold_into(
            lin["kernel"], lin["bias"], ln["scale"], ln["bias"]
        )
        blocks[lin_key] = lin
        blocks[ln_key] = {"scale": None, "bias": None}
    p["blocks"] = blocks
    if "head" in params:
        for hk in ("head", "head_dist") if "head_dist" in params else ("head",):
            head = dict(params[hk])
            head["kernel"], head["bias"] = _fold_into(
                head["kernel"], head["bias"],
                params["norm"]["scale"], params["norm"]["bias"],
            )
            p[hk] = head
        p["norm"] = {"scale": None, "bias": None}
    return p
