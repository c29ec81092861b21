"""Checkpoint geometry resampling: resolution and patch size.

Counterpart of vit_cpp_tpu/models/resample.py, computed the same way on
the host in numpy at load time. Serving a checkpoint at another image
size interpolates the (side, side, h) grid of `pos_embed` bicubically to
the new patch grid, with timm `resample_abs_pos_embed` semantics
(`F.interpolate`, align_corners=False, antialias; prefix rows pass
through; `no_embed_class` embeddings are all grid). Serving it at another
patch size (FlexiViT, Beyer et al. 2023) pseudo-inverse-resizes the
patch-embedding kernel (`pi_resize_factor`) so that patch-token inner
products survive the input resize, with timm `resample_patch_embed`
semantics, and the grid follows.

The interpolation matrices reproduce `torch.nn.functional.interpolate`
(its antialiased and plain bicubic and bilinear paths), which the tests
use as the oracle. They are not the image resamplers of
ops/preprocess.py, which keep the reference's truncating-index variants.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from vit_cpp_tpu_torch.hparams import VitHParams


def _cubic_kernel_a(x: np.ndarray, a: float) -> np.ndarray:
    """Cubic convolution kernel (aten cubic_convolution1/2)."""
    ax = np.abs(x)
    inner = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    outer = ((a * ax - 5.0 * a) * ax + 8.0 * a) * ax - 4.0 * a
    return np.where(ax <= 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Non-AA torch bicubic: a=-0.75 (upsample_bicubic2d)."""
    return _cubic_kernel_a(x, -0.75)


def _cubic_kernel_aa(x: np.ndarray) -> np.ndarray:
    """AA torch bicubic: the PIL-style a=-0.5 filter
    (_upsample_bicubic2d_aa)."""
    return _cubic_kernel_a(x, -0.5)


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"bicubic": (_cubic_kernel, 2.0), "bilinear": (_linear_kernel, 1.0)}


def torch_resize_matrix(
    n_in: int, n_out: int, mode: str = "bicubic", antialias: bool = True
) -> np.ndarray:
    """(n_out, n_in) 1-D resampling weights matching
    `torch.nn.functional.interpolate(align_corners=False)`.

    antialias=True selects torch's separate AA implementation
    (aten _upsample_bicubic2d_aa / _upsample_bilinear2d_aa): PIL-style
    windowed-normalized weights, kernel widened by the scale factor on
    downscale, and — for bicubic — the a=-0.5 filter instead of the
    non-AA path's a=-0.75 (so AA changes bicubic results even on
    UPSCALE). timm's `resample_abs_pos_embed` default is antialias=True.
    """
    if mode not in _KERNELS:
        raise ValueError(f"mode must be bicubic|bilinear, got {mode!r}")
    kernel, support = _KERNELS[mode]
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), dtype=np.float64)
    if antialias:
        if mode == "bicubic":
            kernel = _cubic_kernel_aa
        kscale = max(scale, 1.0)
        span = support * kscale
        for j in range(n_out):
            center = (j + 0.5) * scale  # torch AA keeps the +0.5 inside
            lo = max(0, int(center - span + 0.5))
            hi = min(n_in, int(center + span + 0.5))
            idx = np.arange(lo, hi)
            ws = kernel((idx - center + 0.5) / kscale)
            w[j, lo:hi] = ws / ws.sum()
    else:
        for j in range(n_out):
            center = (j + 0.5) * scale - 0.5
            x0 = math.floor(center)
            t = center - x0
            offs = np.arange(-int(support) + 1, int(support) + 1)
            ws = kernel(t - offs)
            cols = np.clip(x0 + offs, 0, n_in - 1)
            np.add.at(w[j], cols, ws)
    return w.astype(np.float32)


def resample_pos_embed(pos: np.ndarray, hp: VitHParams, new_side: int) -> np.ndarray:
    """Interpolate the grid portion of a (n_pos_tokens, h) pos_embed to a
    (new_side**2 [+ prefix], h) one, bicubic with antialias (the timm
    default). Prefix rows (CLS/dist) carry over unchanged (timm
    resample_abs_pos_embed: num_prefix_tokens split)."""
    pos = np.asarray(pos, dtype=np.float32)
    if pos.ndim != 2:
        raise ValueError(f"pos_embed must be (tokens, hidden), got {pos.shape}")
    # prefix rows in pos_embed: all leading tokens incl. registers
    # (no_embed_class embeds the bare grid, so zero prefix rows there)
    n_prefix = 0 if hp.no_embed_class else hp.n_prefix
    prefix, grid = pos[:n_prefix], pos[n_prefix:]
    side = math.isqrt(grid.shape[0])
    if side * side != grid.shape[0]:
        raise ValueError(
            f"pos_embed grid rows {grid.shape[0]} are not square "
            f"(prefix={n_prefix})"
        )
    if new_side == side:
        return pos
    wy = torch_resize_matrix(side, new_side)
    # resample in f32 like timm (interpolate runs in the tensor dtype;
    # pos_embed is stored f32 by the converter rule)
    g = grid.reshape(side, side, -1)
    g = np.einsum("Oi,ijh,Pj->OPh", wy, g, wy, optimize=True)
    return np.concatenate([prefix, g.reshape(new_side * new_side, -1)], axis=0)


def pi_resize_factor(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) one-axis pseudo-inverse patch-resize factor (B+)^T.

    FlexiViT (Beyer et al., 2023): resizing the INPUT patches by the
    linear map B changes every patch-embedding inner product; the weight
    that preserves them is w' = (B+)^T w (exactly, for upsampling — B has
    full column rank; least-squares optimal for downsampling). timm's
    `resample_patch_embed` builds the full 2-D resize matrix by probing
    with one-hot images and pinv's it; that matrix is kron(By, Bx), and
    pinv(kron(A, B)) == kron(pinv(A), pinv(B)), so the per-axis factor
    below applied to both spatial dims is the same operator (pinned
    numerically in tests/test_resample.py). B itself is the torch
    `F.interpolate` weight matrix (`torch_resize_matrix`), matching the
    timm default (bicubic, antialias=True)."""
    b = torch_resize_matrix(n_in, n_out)
    return np.linalg.pinv(b.astype(np.float64)).T


def resample_patch_embed(kernel: np.ndarray, hp: VitHParams, new_patch: int) -> np.ndarray:
    """PI-resize a flattened (c*p*p, h) patch-embedding kernel (the
    [c, py, px] matmul layout of models/params.py) to (c*p'*p', h)."""
    p = hp.patch_size
    c = hp.in_chans
    kernel = np.asarray(kernel, dtype=np.float32)
    if kernel.shape[0] != c * p * p:
        raise ValueError(
            f"patch_embed kernel rows {kernel.shape[0]} != "
            f"in_chans*p*p = {c * p * p}"
        )
    if new_patch == p:
        return kernel
    f = pi_resize_factor(p, new_patch)
    k = kernel.reshape(c, p, p, -1).astype(np.float64)
    k = np.einsum("Oi,cijh,Pj->cOPh", f, k, f, optimize=True)
    return k.reshape(c * new_patch * new_patch, -1).astype(np.float32)


def resample_params(
    params: Dict[str, Any],
    hp: VitHParams,
    img_size: "int | None",
    patch_size: "int | None" = None,
) -> Tuple[Dict[str, Any], VitHParams]:
    """New (params, hparams) serving `img_size` and/or `patch_size`: the
    pos_embed grid interpolated, the patch_embed kernel PI-resized when
    the patch size changes (back in its dtype, on its device), everything
    else shared. The new pos_embed is f32, as the JAX package stores it;
    the forward casts it to the activation dtype. ViTSTR checkpoints
    raise: their decoder reads the trained grid's first rows."""
    if hp.seq_len is not None:
        raise ValueError(
            "img-size/patch-size overrides are not supported for ViTSTR "
            "checkpoints: the sequence head reads the first seq_len token "
            "rows, so the decoder is coupled to the trained grid layout"
        )
    new_img = hp.img_size if img_size is None else img_size
    new_p = hp.patch_size if patch_size is None else patch_size
    if new_p < 1:
        raise ValueError(f"patch_size must be >= 1, got {new_p}")
    if new_img % new_p:
        raise ValueError(f"img_size {new_img} is not a multiple of patch_size {new_p}")
    if new_img == hp.img_size and new_p == hp.patch_size:
        return params, hp
    out = dict(params)
    if new_p != hp.patch_size:
        old = params["patch_embed"]["kernel"]
        kernel = resample_patch_embed(old.float().cpu().numpy(), hp, new_p)
        out["patch_embed"] = {
            **params["patch_embed"],
            "kernel": torch.from_numpy(kernel).to(old.device, old.dtype),
        }
    pos = params["pos_embed"]
    new_pos = resample_pos_embed(pos.float().cpu().numpy(), hp, new_img // new_p)
    out["pos_embed"] = torch.from_numpy(np.ascontiguousarray(new_pos)).to(pos.device)
    return out, dataclasses.replace(hp, img_size=new_img, patch_size=new_p)
