"""Image preprocessing: resize + normalize on the engine's device.

Counterpart of vit_cpp_tpu/ops/preprocess.py. Both resamplers are
separable linear maps of the source pixels, so an image is resized as
`W_y @ img @ W_x^T` per channel, with the reference's quirks:
bilinear uses half-pixel centres with the floor clamped at 0; bicubic a
truncating source index with taps clipped to the image; the interpolated
value is rounded back to u8 (half up, clamped to 0..255) before the
mean/std normalization.

The JAX module pads every image of a batch onto one square canvas (a
multiple of 256 px) with zero-extended matrices, so that XLA compiles
one program per canvas size. Eager PyTorch compiles nothing: each image
is resized at its own size with its exact matrices, the same nonzero
terms, so a large photo does not make every image of its batch fill and
copy its canvas. The u8 pixels and matrices reach a card through pinned
memory without waiting for the stream's earlier work (a forward running
there). The numpy matrix builders are carried over from the JAX module
(which imports JAX). The einsum runs with TF32 off whatever the process
has set (ops/precision.py): the u8 re-rounding would turn TF32's errors
into whole pixel steps.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from vit_cpp_tpu_torch.ops.precision import matmul_precision

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


@lru_cache(maxsize=512)
def resize_matrix(n_in: int, out_size: int, mode: str) -> torch.Tensor:
    """(out, n_in) f32 resampling weights on the host, shared by every
    caller of the cache: read them, never write them."""
    if mode == "bilinear":
        return torch.from_numpy(bilinear_matrix(n_in, out_size))
    if mode == "bicubic":
        return torch.from_numpy(bicubic_matrix(n_in, out_size))
    raise ValueError(f"interpolation mode '{mode}' is not supported")


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device`; to a card through pinned memory, so the
    copy queues behind the stream's work instead of waiting for it."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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
    device = torch.device(device)
    for img in images:
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) u8 image, got {img.shape}")
    with matmul_precision("highest"):
        y = torch.stack([
            torch.einsum(
                "oh,hwc,pw->cop",
                _to_device(resize_matrix(img.shape[0], out_size, mode), device),
                _to_device(torch.from_numpy(np.require(img, requirements="CW")), device).float(),
                _to_device(resize_matrix(img.shape[1], out_size, mode), device),
            )
            for img in images
        ])
    y = torch.clamp(torch.floor(y + 0.5), 0.0, 255.0)  # u8 re-rounding
    m = torch.tensor(mean, dtype=torch.float32, device=y.device)
    s = torch.tensor(std, dtype=torch.float32, device=y.device)
    return (y - m[None, :, None, None]) / s[None, :, None, None]
