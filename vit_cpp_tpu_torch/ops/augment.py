"""Training-data augmentation for classifier fine-tuning.

Counterpart of vit_cpp_tpu/ops/augment.py, with the same transforms on
the already-preprocessed (B, C, S, S) batch, on the batch's device:

- a random resized crop is a per-image separable bilinear resample
  (half-pixel centres, clamped at the edge) back to the input size; the
  box follows torchvision's RandomResizedCrop (area fraction uniform in
  `scale`, aspect ratio log-uniform in `ratio`), clipped to the image
  instead of rejection-sampled, as in the JAX module;
- a horizontal flip with probability 1/2 per image;
- mixup with one lam ~ Beta(alpha, alpha) per batch, folded to
  max(lam, 1 - lam), and a random partner permutation.

Augmenting normalized pixels is exact: normalization is a per-channel
affine map and the resample is linear, so the two commute.

Randomness: every draw (box parameters, flip bits, lam, permutation)
comes from an explicit CPU `torch.Generator`, and only the drawn values
move to the batch's device, so a CPU run and a card run see the same
stream. `step_generator(seed, update)` seeds one from the run's seed and
the global update index, so a resumed run replays the stream. The
numbers differ from the JAX package's threefry stream; the deterministic
parts (resample, flip, box geometry, mixing) are what the tests compare.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

AUGMENT_MODES = ("none", "flip", "crop", "all")


def step_generator(seed: int, update: int) -> torch.Generator:
    """A CPU generator for one update of a run: a function of (seed,
    global update index) only."""
    state = np.random.SeedSequence([seed, update]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & 0x7FFF_FFFF_FFFF_FFFF)


def _uniform(gen: torch.Generator, n: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen)


def resample_axis(
    x: torch.Tensor, start: torch.Tensor, step: torch.Tensor, axis: int
) -> torch.Tensor:
    """Per-image 1-D bilinear resample of `x` along `axis`.

    x is (B, ...); `start`/`step` are (B,) in source-pixel units. Output
    index i (same length as the source axis) samples the source at
    `start + (i + 0.5) * step - 0.5`, clamped to the edge."""
    b, s = x.shape[0], x.shape[axis]
    i = torch.arange(s, dtype=torch.float32, device=x.device)
    src = start.to(x.device, torch.float32)[:, None] + (i[None, :] + 0.5) * step.to(
        x.device, torch.float32
    )[:, None] - 0.5
    src = torch.clamp(src, 0.0, float(s - 1))
    lo = torch.floor(src)
    frac = src - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=s - 1)
    shape = [b] + [1] * (x.ndim - 1)
    shape[axis] = s
    full = list(x.shape)
    a = torch.gather(x, axis, lo.reshape(shape).expand(full))
    c = torch.gather(x, axis, hi.reshape(shape).expand(full))
    return a + frac.reshape(shape).to(x.dtype) * (c - a)


def crop_boxes(
    gen: torch.Generator,
    batch: int,
    scale: Tuple[float, float],
    ratio: Tuple[float, float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample (y0, x0, h, w) crop boxes in [0, 1] image fractions (CPU)."""
    area = _uniform(gen, batch, scale[0], scale[1])
    r = torch.exp(_uniform(gen, batch, math.log(ratio[0]), math.log(ratio[1])))
    w = torch.clamp(torch.sqrt(area * r), 0.0, 1.0)
    h = torch.clamp(torch.sqrt(area / r), 0.0, 1.0)
    y0 = _uniform(gen, batch) * (1.0 - h)
    x0 = _uniform(gen, batch) * (1.0 - w)
    return y0, x0, h, w


def random_resized_crop(
    gen: torch.Generator,
    x: torch.Tensor,
    scale: Tuple[float, float] = (0.67, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> torch.Tensor:
    """Per-image random crop of a (B, C, S, S) batch resampled back to S.
    With scale == ratio == (1, 1) the box is the whole image and the
    resample is an exact identity."""
    b, _, s, _ = x.shape
    y0, x0, h, w = crop_boxes(gen, b, scale, ratio)
    out = resample_axis(x, y0 * s, h, axis=2)
    return resample_axis(out, x0 * s, w, axis=3)


def random_hflip(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """Mirror each image left-right with probability 1/2."""
    flip = (torch.rand(x.shape[0], generator=gen) < 0.5).to(x.device)
    return torch.where(flip[:, None, None, None], x.flip(-1), x)


def augment_batch(
    gen: torch.Generator,
    x: torch.Tensor,
    *,
    flip: bool = True,
    crop: bool = True,
    scale: Tuple[float, float] = (0.67, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> torch.Tensor:
    """Apply the enabled augmentations to a (B, C, S, S) batch: the crop,
    then the flip."""
    if crop:
        x = random_resized_crop(gen, x, scale=scale, ratio=ratio)
    if flip:
        x = random_hflip(gen, x)
    return x


def mixup_batch(gen: torch.Generator, x: torch.Tensor, alpha: float):
    """Per-batch mixup (Zhang et al. 2017): lam ~ Beta(alpha, alpha) folded
    to max(lam, 1 - lam), each image mixed with a permuted partner,
    `lam * x + (1 - lam) * x[perm]`. Returns (mixed, perm, lam); perm is
    on x's device, lam a Python float."""
    g = torch._standard_gamma(torch.full((2,), float(alpha), dtype=torch.float64), generator=gen)
    lam = float(g[0] / (g[0] + g[1]))
    lam = max(lam, 1.0 - lam)
    perm = torch.randperm(x.shape[0], generator=gen).to(x.device)
    mixed = lam * x + (1.0 - lam) * x[perm]
    return mixed.to(x.dtype), perm, lam


def augment_flags(mode: str) -> Tuple[bool, bool]:
    """CLI mode string -> (flip, crop) booleans."""
    if mode not in AUGMENT_MODES:
        raise ValueError(f"augment must be one of {AUGMENT_MODES}, got {mode!r}")
    return mode in ("flip", "all"), mode in ("crop", "all")
