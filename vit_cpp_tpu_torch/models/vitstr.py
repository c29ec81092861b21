"""ViTSTR scene-text recognition: vocabulary, preprocessing and greedy
decoding.

Counterpart of vit_cpp_tpu/models/vitstr.py. ViTSTR is the shared ViT
forward with a sequence head (`VitHParams.seq_len`: the first 25 token
rows, normed, through the head; models/vit.py::_head) plus three pieces:

- the 96-token vocabulary ['[GO]', '[s]'] + string.printable[:-6] that a
  converted ViTSTR file carries as its labels;
- grayscale preprocessing: Rec.601 luma truncated to u8 (float64 on the
  host), a bilinear resize with a truncating source index and the left
  tap clamped to n-2, then (v/255 - 0.5) * 2 into [-1, 1]. The resize is
  two matrices, `W_y @ gray @ W_x^T`, on the engine's device with TF32
  off; each image is resized at its own size (as ops/preprocess.py does),
  so no padding enters the sum;
- greedy decoding from position 1, stopping at '[s]' (id 1) without
  counting it; the confidence is the product of the accepted maxima.
  `greedy_decode` is the host parity path, `greedy_decode_device` the
  batched one on the card (torch.argmax returns the first maximum, as
  jnp.argmax does).
"""

from __future__ import annotations

import string
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from vit_cpp_tpu_torch.ops.precision import matmul_precision
from vit_cpp_tpu_torch.ops.preprocess import _to_device

# id 0 = '[GO]' (start padding), id 1 = '[s]' (end of sequence).
VITSTR_VOCAB: List[str] = ["[GO]", "[s]"] + list(string.printable[:-6])
VITSTR_SEQ_LEN = 25
GO_ID, EOS_ID = 0, 1


def vitstr_id2label() -> Dict[int, str]:
    return dict(enumerate(VITSTR_VOCAB))


def grayscale_bilinear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ViTSTR's bilinear resampler: source index
    g = j * (n_in / n_out) truncated, left tap clamped to [0, n_in - 2]."""
    w = np.zeros((n_out, n_in), dtype=np.float32)
    scale = n_in / n_out
    for j in range(n_out):
        g = j * scale
        gi = int(g)  # C truncation, g >= 0
        u = g - gi
        p0 = max(0, min(gi, n_in - 2))
        w[j, p0] += 1.0 - u
        w[j, p0 + 1] += u
    return w


@lru_cache(maxsize=512)
def _resize_matrix(n_in: int, out_size: int) -> torch.Tensor:
    """The host matrix, shared by every caller of the cache: read it,
    never write it."""
    return torch.from_numpy(grayscale_bilinear_matrix(n_in, out_size))


def rgb_to_grayscale(img_u8: np.ndarray) -> np.ndarray:
    """Rec.601 luma truncated to u8, in float64 on the host: an f32
    product on the card truncates differently at integer boundaries."""
    x = img_u8.astype(np.float64)
    return (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]).astype(np.uint8)


def preprocess_grayscale_batch(images: Sequence[np.ndarray], out_size: int,
                               device="cpu") -> torch.Tensor:
    """List of (H, W, 3) u8 host images -> (B, 1, S, S) f32 in [-1, 1] on
    `device`, each image resized at its own size."""
    if not images:
        raise ValueError("empty batch")
    device = torch.device(device)
    for img in images:
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) u8 image, got {img.shape}")
    with matmul_precision("highest"):
        y = torch.stack([
            torch.einsum(
                "oh,hw,pw->op",
                _to_device(_resize_matrix(img.shape[0], out_size), device),
                _to_device(torch.from_numpy(rgb_to_grayscale(img)), device).float(),
                _to_device(_resize_matrix(img.shape[1], out_size), device),
            )
            for img in images
        ])
    return ((y / 255.0 - 0.5) * 2.0)[:, None]


def preprocess_grayscale(img_u8: np.ndarray, out_size: int, device="cpu") -> torch.Tensor:
    """One (H, W, 3) u8 host image -> (1, S, S) f32 ViTSTR input."""
    return preprocess_grayscale_batch([img_u8], out_size, device)[0]


def greedy_decode(probs: np.ndarray, id2label: Dict[int, str]) -> Tuple[str, float]:
    """(seq_len, n_tokens) probabilities -> (text, confidence): positions
    1.. take their argmax token until '[s]'; the confidence is the product
    of the accepted maxima."""
    probs = np.asarray(probs)
    text, conf = [], 1.0
    for col in range(1, probs.shape[0]):
        tok = int(np.argmax(probs[col]))
        if tok == EOS_ID:
            break
        conf *= float(probs[col, tok])
        text.append(id2label.get(tok, ""))
    return "".join(text), conf


def greedy_decode_device(probs: torch.Tensor):
    """(B, seq_len, V) probabilities on any device -> (tokens (B, seq_len)
    int64, valid (B, seq_len) bool, confidence (B,) f32) there: valid marks
    the positions from 1 up to the first '[s]'. Only these small tensors
    go back to the host."""
    toks = torch.argmax(probs, dim=-1)
    pmax = torch.amax(probs, dim=-1)
    toks[:, 0] = GO_ID  # position 0 is never read
    seen_eos = torch.cumsum((toks == EOS_ID).to(torch.int32), dim=1) > 0
    valid = ~seen_eos
    valid[:, 0] = False
    conf = torch.prod(torch.where(valid, pmax, torch.ones_like(pmax)), dim=1)
    return toks, valid, conf


def decode_tokens(toks: np.ndarray, valid: np.ndarray, id2label: Dict[int, str]) -> str:
    return "".join(id2label.get(int(t), "") for t, v in zip(toks, valid) if v)
