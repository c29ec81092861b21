"""Image preprocessing: resize + normalize as one batched einsum.

Counterpart of vit_cpp_tpu/ops/preprocess.py. Both resamplers are
separable linear maps of the source pixels, so a batch is resized as
`W_y @ img @ W_x^T` per image and channel, with the reference's quirks:
bilinear uses half-pixel centres with the floor clamped at 0; bicubic a
truncating source index with taps clipped to the image; the interpolated
value is rounded back to u8 (half up, clamped to 0..255) before the
mean/std normalization.

Images are zero-padded onto a square canvas whose side is a multiple of
256, and the per-image resampling matrices are zero past each
image's extent, so images of any size share one batched einsum. The numpy
matrix builders are carried over from the JAX module (which imports JAX).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

IMAGENET_MEAN = (123.675, 116.280, 103.530)
IMAGENET_STD = (58.395, 57.120, 57.375)
UNIT_MEAN = (127.5, 127.5, 127.5)
UNIT_STD = (127.5, 127.5, 127.5)
CLIP_MEAN = (255 * 0.48145466, 255 * 0.4578275, 255 * 0.40821073)
CLIP_STD = (255 * 0.26862954, 255 * 0.26130258, 255 * 0.27577711)


def norm_constants(pixel_norm: str):
    """(mean, std) for an hparams.pixel_norm value."""
    if pixel_norm == "imagenet":
        return IMAGENET_MEAN, IMAGENET_STD
    if pixel_norm == "unit":
        return UNIT_MEAN, UNIT_STD
    if pixel_norm == "clip":
        return CLIP_MEAN, CLIP_STD
    raise ValueError(
        f"pixel_norm must be imagenet|unit|clip, got {pixel_norm!r}"
    )


def bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights with the reference's bilinear semantics,
    including the un-clamped fractional part (weights can leave [0, 1]
    when sx < 0)."""
    w = np.zeros((n_out, n_in), dtype=np.float32)
    scale = n_in / n_out
    for j in range(n_out):
        sx = (j + 0.5) * scale - 0.5
        x0 = max(0, int(np.floor(sx)))
        x1 = min(x0 + 1, n_in - 1)
        dx = sx - x0
        w[j, x0] += 1.0 - dx
        w[j, x1] += dx
    return w


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """Per-tap weights of the reference's finite-difference cubic: taps
    p0..p3 at source offsets -1..+2."""
    t2, t3 = t * t, t * t * t
    w0 = -t / 3.0 + t2 / 2.0 - t3 / 6.0
    w2 = t + t2 / 2.0 - t3 / 2.0
    w3 = -t / 6.0 + t3 / 6.0
    w1 = 1.0 - w0 - w2 - w3
    return np.stack([w0, w1, w2, w3], axis=-1)


def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights with the reference's bicubic semantics:
    truncating index, taps clipped to [0, n_in - 1]."""
    w = np.zeros((n_out, n_in), dtype=np.float32)
    tx = n_in / n_out
    j = np.arange(n_out)
    x = (tx * j).astype(np.int64)  # C truncation of a non-negative float
    t = tx * j - x
    taps = _cubic_weights(t.astype(np.float64)).astype(np.float32)
    for s in range(4):
        cols = np.clip(x - 1 + s, 0, n_in - 1)
        np.add.at(w, (j, cols), taps[:, s])
    return w


def canvas_bucket(h: int, w: int, step: int = 256) -> int:
    """Smallest multiple of `step` covering both extents."""
    m = max(h, w, 1)
    return (m + step - 1) // step * step


@lru_cache(maxsize=512)
def _padded_resize_matrix(n_in: int, out_size: int, canvas: int, mode: str):
    """(out, canvas) weights: the true matrix in the first n_in columns,
    zeros beyond (padded canvas pixels contribute nothing)."""
    if mode == "bilinear":
        w = bilinear_matrix(n_in, out_size)
    elif mode == "bicubic":
        w = bicubic_matrix(n_in, out_size)
    else:
        raise ValueError(f"interpolation mode '{mode}' is not supported")
    out = np.zeros((out_size, canvas), dtype=np.float32)
    out[:, :n_in] = w
    out.flags.writeable = False  # shared by every caller of the cache
    return out


def preprocess_batch(
    images,
    out_size: int,
    mode: str = "bicubic",
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
    device="cpu",
) -> torch.Tensor:
    """List of (H, W, 3) u8 host images -> (B, 3, S, S) f32 on `device`."""
    if not images:
        raise ValueError("empty batch")
    for img in images:
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) u8 image, got {img.shape}")
    canvas = max(canvas_bucket(i.shape[0], i.shape[1]) for i in images)
    b = len(images)
    canv = np.zeros((b, canvas, canvas, 3), dtype=np.uint8)
    wy = np.empty((b, out_size, canvas), dtype=np.float32)
    wx = np.empty((b, out_size, canvas), dtype=np.float32)
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        canv[i, :h, :w] = img
        wy[i] = _padded_resize_matrix(h, out_size, canvas, mode)
        wx[i] = _padded_resize_matrix(w, out_size, canvas, mode)
    x = torch.from_numpy(canv).to(device).float()
    y = torch.einsum(
        "boh,bhwc,bpw->bcop",
        torch.from_numpy(wy).to(device),
        x,
        torch.from_numpy(wx).to(device),
    )
    y = torch.clamp(torch.floor(y + 0.5), 0.0, 255.0)  # u8 re-rounding
    m = torch.tensor(mean, dtype=torch.float32, device=y.device)
    s = torch.tensor(std, dtype=torch.float32, device=y.device)
    return (y - m[None, :, None, None]) / s[None, :, None, None]
