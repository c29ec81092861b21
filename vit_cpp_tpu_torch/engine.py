"""Inference engine: load once, classify many.

Counterpart of vit_cpp_tpu/engine.py::VitEngine. The engine reads a gguf
checkpoint (f32, f16, or block-quantized Q4_0/Q4_1/Q5_0/Q5_1/Q8_0) onto
one `device`, applies the serving rewrites the flags select (W8A8 int8
linears, LayerNorm folding), and runs the forward pass eagerly under
`torch.inference_mode`. The flag values are the JAX package's, so a
command line carries over:

    attn_impl  "xla" (composed attention) | "pallas" | "pallas-fast"
               (the fused-QKV kernel, safe or fast softmax)
    mm_impl    "xla" (dense; block-quantized weights dequantized before
               each matmul) | "int8" (W8A8, block-quantized weights
               requantized channelwise at load) | "pallas" (block-quantized
               weights through the dequantizing-matmul kernel)
    act_quant  "dynamic" (per-token scales); "static" is not ported yet
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import numpy as np
import torch

from vit_cpp_tpu_torch.gguf.reader import read_model
from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.io.image import load_image_rgb
from vit_cpp_tpu_torch.models.params import infer_family_hparams, load_params
from vit_cpp_tpu_torch.models.vit import ATTN_IMPLS, predict_probs
from vit_cpp_tpu_torch.ops.preprocess import norm_constants, preprocess_batch

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device with no usable GPU raises
    instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def detect_hparams(mf) -> VitHParams:
    """Hparams the file's header block cannot carry, inferred from its
    tensors: in_chans from the patch conv, and the family extensions
    (models/params.py::infer_family_hparams). ViTSTR (1-channel) and
    V-MoE checkpoints raise: this package does not run them yet."""
    hp = mf.hparams
    pe = mf.tensors.get("patch_embed.proj.weight")
    if pe is not None and len(pe.shape) == 4 and pe.shape[1] != hp.in_chans:
        hp = dataclasses.replace(hp, in_chans=int(pe.shape[1]))
    if hp.in_chans == 1:
        raise NotImplementedError(
            "ViTSTR (1-channel, sequence-head) checkpoints are not ported "
            "to vit_cpp_tpu_torch yet; they come with the model-families "
            "slice (models/vitstr.py)"
        )
    return infer_family_hparams(hp, mf.tensors)


class VitEngine:
    def __init__(
        self,
        model_path: str,
        *,
        dtype: str = "f32",
        attn_impl: str = "xla",
        mm_impl: str = "xla",
        fold_ln: bool = False,
        act_quant: str = "dynamic",
        device="cuda",
    ):
        t0 = time.perf_counter()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be f32|bf16, got {dtype!r}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        if mm_impl not in ("xla", "int8", "pallas"):
            raise ValueError(f"mm_impl must be xla|int8|pallas, got {mm_impl!r}")
        if act_quant == "static":
            raise NotImplementedError(
                "act_quant='static' is not ported yet: it comes with the "
                "slice that ports quant/calibrate.py"
            )
        if act_quant != "dynamic":
            raise ValueError(f"act_quant must be dynamic|static, got {act_quant!r}")
        self.device = resolve_device(device)
        mf = read_model(model_path)
        hp = detect_hparams(mf)
        if hp.num_classes == 0:
            raise NotImplementedError(
                "headless encoders serve embeddings, which vit_cpp_tpu_torch "
                "does not port yet; they come with the features/embed slice "
                "(features_batch and the /v1/embed route)"
            )
        self.hp = hp
        self.id2label = mf.id2label
        self.dtype = _DTYPES[dtype]
        params = load_params(mf, dtype=self.dtype, hparams=hp, device=self.device)
        if mm_impl == "int8":
            from vit_cpp_tpu_torch.quant.int8 import convert_params_to_int8

            params = convert_params_to_int8(params)
        if fold_ln:
            from vit_cpp_tpu_torch.models.fold import fold_layernorms

            params = fold_layernorms(params, mm_impl=mm_impl)
        self.params = params
        self.attn_impl = attn_impl
        self.mm_impl = mm_impl
        self.load_ms = (time.perf_counter() - t0) * 1000.0

    def preprocess_image(self, img_u8: np.ndarray) -> torch.Tensor:
        """(H, W, 3) u8 host image -> (3, S, S) f32 on the engine's device."""
        mean, std = norm_constants(self.hp.pixel_norm)
        return preprocess_batch(
            [img_u8], self.hp.img_size, mode=self.hp.interpolation,
            mean=mean, std=std, device=self.device,
        )[0]

    def predict_probs_batch(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, C, S, S) preprocessed -> (B, classes) f32 probabilities
        on the engine's device."""
        with torch.inference_mode():
            return predict_probs(
                self.params, images.to(self.device), self.hp,
                attn_impl=self.attn_impl, mm_impl=self.mm_impl,
            )

    def classify_file(self, path: str, topk: int = 5) -> List[Tuple[int, float, str]]:
        """Decode, preprocess, predict, return [(class_id, prob, label)]."""
        pixels = self.preprocess_image(load_image_rgb(path))
        probs = self.predict_probs_batch(pixels[None])[0].cpu().numpy()
        order = np.argsort(-probs, kind="stable")[:topk]
        return [
            (int(i), float(probs[i]), self.id2label.get(int(i), f"LABEL_{i}"))
            for i in order
        ]
