"""Inference engine: load once, classify many.

Counterpart of vit_cpp_tpu/engine.py::VitEngine. The engine reads a gguf
checkpoint (f32, f16, or block-quantized Q4_0/Q4_1/Q5_0/Q5_1/Q8_0) onto
one `device`, applies the serving rewrites the flags select (W8A8 int8
linears, LayerNorm folding), and runs the forward pass eagerly under
`torch.inference_mode`, with the f32 matmul precision it was built with
(ops/precision.py: "highest", TF32 off, for f32 engines; "default" for
bf16 ones). The flag values are the JAX package's, so a command line
carries over:

    attn_impl  "xla" (composed attention) | "pallas" | "pallas-fast"
               (the fused-QKV kernel, safe or fast softmax)
    mm_impl    "xla" (dense; block-quantized weights dequantized before
               each matmul) | "int8" (W8A8, block-quantized weights
               requantized channelwise at load) | "pallas" (block-quantized
               weights through the dequantizing-matmul kernel)
    act_quant  "dynamic" (per-token scales) | "static" (calibrated
               per-site scales, mm_impl="int8" only): from `act_scales`
               (a sidecar JSON, quant/qat.py; refused with fold_ln, as
               its scales describe the unfolded graph), from an explicit
               `calibrate(images)`, or else from the first served batch.
               A calibration the guardrail rejects (quant/calibrate.py)
               prints a warning and leaves the engine on dynamic scales.

`img_size` / `patch_size` serve the checkpoint at another resolution or
patch size: the positional grid is resampled and the patch embedding
PI-resized on the host at load time (models/resample.py).
`tome=r` serves with ToMe token merging (ops/tome.py; classifiers and
encoders, not ViTSTR): r patch-token pairs merge per layer in every
served forward; static-scale calibration still measures the unmerged
graph, as the JAX package's does.

`shard(mesh)` distributes the engine over a ('data', 'model') mesh
(parallel/mesh.py): each rank keeps its tensor-parallel shards
(parallel/sharding.py), `predict_probs_batch` and `features_batch` run
the rank's rows of a batch split over "data" and return the whole batch,
all-gathered, on every rank; every rank calls them with the same batch.
Calibration runs the whole batch on each rank and takes every site's
maximum over "model" too. `attention_maps_batch` splits its batch over
"data" as the serving calls do; `explain_file` runs its one image on
every rank's shards. Both gather every layer's heads over "model".

`verbose` prints the JAX engine's `vit_model_load:` echo on stdout.
`model_file` is `model_path` already parsed by gguf/reader.py, which
the engine then does not read again.
Headless encoders (num_classes == 0) load and serve `features_batch`;
their classifier calls raise ValueError, as the JAX package's do.
`VitstrEngine` is the scene-text engine: grayscale input, the 25-row
sequence readout and greedy decoding (models/vitstr.py).
`attention_maps_batch` and `explain_file` run one composed-attention
encoder pass that keeps every layer's attention probabilities
(models/attention_maps.py), for vit-explain.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vit_cpp_tpu_torch.gguf.reader import ModelFile, read_model
from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.io.image import load_image_rgb
from vit_cpp_tpu_torch.models.params import infer_family_hparams, load_params
from vit_cpp_tpu_torch.models.vit import ATTN_IMPLS, forward
from vit_cpp_tpu_torch.models.vitstr import VITSTR_SEQ_LEN
from vit_cpp_tpu_torch.ops.precision import PRECISIONS, matmul_precision
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
    tensors: in_chans from the patch conv (a 1-channel file is ViTSTR,
    whose sequence head reads seq_len=25 rows), and the family extensions
    (models/params.py::infer_family_hparams), V-MoE's expert layout
    among them."""
    hp = mf.hparams
    pe = mf.tensors.get("patch_embed.proj.weight")
    if pe is not None and len(pe.shape) == 4 and pe.shape[1] != hp.in_chans:
        hp = dataclasses.replace(hp, in_chans=int(pe.shape[1]))
    if hp.in_chans == 1 and hp.seq_len is None:
        hp = dataclasses.replace(hp, seq_len=VITSTR_SEQ_LEN)
    return infer_family_hparams(hp, mf.tensors)


class VitEngine:
    def __init__(
        self,
        model_path: str,
        *,
        dtype: str = "f32",
        eps: Optional[float] = None,
        interpolation: Optional[str] = None,
        matmul_precision: Optional[str] = None,
        attn_impl: str = "xla",
        mm_impl: str = "xla",
        fold_ln: bool = False,
        act_quant: str = "dynamic",
        act_scales: Optional[str] = None,
        img_size: Optional[int] = None,
        patch_size: Optional[int] = None,
        tome: int = 0,
        verbose: bool = True,
        device="cuda",
        model_file: Optional[ModelFile] = None,
    ):
        t0 = time.perf_counter()
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be f32|bf16, got {dtype!r}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        if mm_impl not in ("xla", "int8", "pallas"):
            raise ValueError(f"mm_impl must be xla|int8|pallas, got {mm_impl!r}")
        if act_quant not in ("dynamic", "static"):
            raise ValueError(f"act_quant must be dynamic|static, got {act_quant!r}")
        if act_quant == "static" and mm_impl != "int8":
            raise ValueError("act_quant='static' requires mm_impl='int8'")
        if act_scales is not None:
            if act_quant != "static":
                raise ValueError("act_scales requires act_quant='static'")
            if fold_ln:
                # folding changes every pre-GEMM activation distribution:
                # scales measured on the unfolded graph would mis-clip
                raise ValueError(
                    "act_scales (training-measured, unfolded graph) is "
                    "incompatible with fold_ln — drop one"
                )
        if matmul_precision is None:
            # f32 engines are the parity path: exact f32 products
            matmul_precision = "highest" if dtype == "f32" else "default"
        if matmul_precision not in PRECISIONS:
            raise ValueError(
                f"matmul_precision must be one of {tuple(PRECISIONS)}, got {matmul_precision!r}"
            )
        self.device = resolve_device(device)
        if verbose:
            print(f"vit_model_load: loading model from '{model_path}' - please wait")
        mf = read_model(model_path) if model_file is None else model_file
        hp = detect_hparams(mf)
        if act_quant == "static" and hp.num_experts:
            from vit_cpp_tpu_torch.quant.calibrate import MOE_REFUSAL

            raise ValueError(MOE_REFUSAL)
        if eps is not None:
            hp = dataclasses.replace(hp, eps=eps)
        if interpolation is not None:
            hp = dataclasses.replace(hp, interpolation=interpolation)
        if verbose:
            print(f"vit_model_load: hidden_size            = {hp.hidden_size}")
            print(f"vit_model_load: num_hidden_layers      = {hp.num_hidden_layers}")
            print(f"vit_model_load: num_attention_heads    = {hp.num_attention_heads}")
            print(f"vit_model_load: patch_size             = {hp.patch_size}")
            print(f"vit_model_load: img_size               = {hp.img_size}")
            print(f"vit_model_load: num_classes            = {hp.num_classes}")
            print(f"vit_model_load: ftype                  = {hp.ftype}")
            print(f"vit_model_load: qntvr                  = {mf.qntvr}")
            total_bytes = sum(r.dtype.row_bytes(r.n_elements) for r in mf.tensors.values())
            print(
                f"vit_model_load: model size = {total_bytes / 1024 / 1024:8.2f} MB "
                f"/ num tensors = {len(mf.tensors)}"
            )
        self.id2label = mf.id2label
        self.dtype = _DTYPES[dtype]
        self.matmul_precision = matmul_precision
        params = load_params(mf, dtype=self.dtype, hparams=hp, device=self.device)
        if (img_size is not None and img_size != hp.img_size) or (
            patch_size is not None and patch_size != hp.patch_size
        ):
            from vit_cpp_tpu_torch.models.resample import resample_params

            patch_changed = patch_size is not None and patch_size != hp.patch_size
            params, hp = resample_params(params, hp, img_size, patch_size=patch_size)
            if verbose:
                print(
                    f"vit_model_load: geometry override      = {hp.img_size} px / patch "
                    f"{hp.patch_size} (pos_embed resampled"
                    + (", patch_embed PI-resized)" if patch_changed else ")")
                )
        self.hp = hp
        if mm_impl == "int8":
            from vit_cpp_tpu_torch.quant.int8 import convert_params_to_int8

            params = convert_params_to_int8(params)
        if fold_ln:
            from vit_cpp_tpu_torch.models.fold import fold_layernorms

            params = fold_layernorms(params, mm_impl=mm_impl)
        if act_scales is not None:
            from vit_cpp_tpu_torch.quant.calibrate import attach_act_scales
            from vit_cpp_tpu_torch.quant.qat import load_act_scales

            params = attach_act_scales(params, load_act_scales(act_scales))
            if verbose:
                print(f"vit_model_load: static act scales      = {act_scales}")
        if tome and hp.seq_len is not None:
            raise ValueError(
                "tome token merging is incompatible with sequence-head "
                "(ViTSTR) checkpoints"
            )
        if tome and hp.num_experts:
            raise ValueError("tome + MoE is not supported (both re-plan the layer loop)")
        self.tome = tome
        if tome and verbose:
            from vit_cpp_tpu_torch.ops.tome import tome_schedule

            rs = tome_schedule(hp.n_patches, hp.num_hidden_layers, tome)
            print(
                f"vit_model_load: tome r={tome} — patch tokens "
                f"{hp.n_patches} -> {hp.n_patches - sum(rs)} over "
                f"{hp.num_hidden_layers} layers"
            )
        self.params = params
        self.attn_impl = attn_impl
        self.mm_impl = mm_impl
        # static scales without a sidecar are measured on the first served
        # batch unless the caller calls calibrate() with a sample first
        self._needs_calibration = act_quant == "static" and act_scales is None
        self._calibration_lock = threading.Lock()  # a daemon's two batchers
        self.calibration_agreement = None  # the guardrail's, once accepted
        self.mesh = None
        self.load_ms = (time.perf_counter() - t0) * 1000.0

    def shard(self, mesh) -> "VitEngine":
        """Distribute the engine over a ('data', 'model') DeviceMesh: the
        parameters become this rank's Megatron shards (replicated when the
        model axis is 1), and the serving calls split each batch over
        "data", whose size must divide it (vit_cpp_tpu/engine.py::shard)."""
        from vit_cpp_tpu_torch.parallel.mesh import axis_size
        from vit_cpp_tpu_torch.parallel.sharding import shard_params

        tp = axis_size(mesh, "model")
        if tp > 1 and self.hp.num_attention_heads % tp:
            # the qkv column split must land on head boundaries
            raise ValueError(
                f"tensor-parallel size {tp} does not divide "
                f"num_attention_heads {self.hp.num_attention_heads}; "
                f"choose a 'model' axis that divides the head count "
                f"(or tp=1 for pure data parallelism)"
            )
        self.mesh = mesh
        self.params = shard_params(self.params, mesh)
        return self

    def preprocess_image(self, img_u8: np.ndarray) -> torch.Tensor:
        """(H, W, 3) u8 host image -> (C, S, S) f32 on the engine's device."""
        return self.preprocess_images([img_u8])[0]

    def preprocess_images(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """(H, W, 3) u8 host images -> (B, 3, S, S) f32 on the engine's
        device, each resized at its own size (ops/preprocess.py)."""
        mean, std = norm_constants(self.hp.pixel_norm)
        return preprocess_batch(
            list(images), self.hp.img_size, mode=self.hp.interpolation,
            mean=mean, std=std, device=self.device,
        )

    def _print_preprocess_scale(self, img_u8: np.ndarray) -> None:
        """The resampler's scale report on stderr: bicubic prints
        `scale = max(tx, ty)`, bilinear the per-axis scales
        (vit_cpp_tpu/engine.py:307-325)."""
        ny, nx = img_u8.shape[:2]
        t = self.hp.img_size
        if self.hp.interpolation == "bilinear":
            print(f"vit_image_preprocess: x_scale = {nx / t:f}, y_scale = {ny / t:f}",
                  file=sys.stderr)
        else:
            print(f"vit_image_preprocess: scale = {max(nx / t, ny / t):f}", file=sys.stderr)

    def calibrate(
        self,
        images: torch.Tensor,
        *,
        probe: Optional[torch.Tensor] = None,
        min_agreement: float = 0.90,
    ) -> None:
        """Fix static activation scales from a representative batch
        (quant/calibrate.py); a no-op unless the engine was built with
        act_quant="static" and has no scales yet.

        The guardrail then checks static against dynamic top-1 agreement
        on `probe` (default: the calibration batch, which only catches
        gross saturation). Below `min_agreement` the engine warns on
        stderr and keeps serving with dynamic scales. Calibration runs
        the engine's own attention path (the fused kernel at the serving
        defaults; the JAX engine calibrates through its XLA attention)."""
        if not self._needs_calibration:
            return
        from vit_cpp_tpu_torch.quant.calibrate import calibrate_act_scales, validate_act_scales

        images = images.to(self.device)
        with torch.inference_mode(), matmul_precision(self.matmul_precision):
            static = calibrate_act_scales(self.params, images, self.hp,
                                          attn_impl=self.attn_impl, mesh=self.mesh)
            try:
                self.calibration_agreement = validate_act_scales(
                    static, self.params,
                    images if probe is None else probe.to(self.device), self.hp,
                    min_agreement=min_agreement, attn_impl=self.attn_impl, mesh=self.mesh,
                )
            except ValueError as e:
                print(f"vit: static calibration rejected — {e}", file=sys.stderr)
                print("vit: serving with dynamic activation scales", file=sys.stderr)
                self._needs_calibration = False
                return
        self.params = static
        self._needs_calibration = False

    def _forward(self, images: torch.Tensor, **kw) -> torch.Tensor:
        if self._needs_calibration:
            with self._calibration_lock:
                self.calibrate(images)
        with torch.inference_mode(), matmul_precision(self.matmul_precision):
            if self.mesh is None:
                return forward(
                    self.params, images.to(self.device), self.hp,
                    attn_impl=self.attn_impl, mm_impl=self.mm_impl, tome=self.tome, **kw,
                )
            from vit_cpp_tpu_torch.parallel.mesh import data_slice, gather_over_data

            rows = data_slice(images.to(self.device), self.mesh)
            out = forward(self.params, rows, self.hp, attn_impl=self.attn_impl,
                          mm_impl=self.mm_impl, tome=self.tome, mesh=self.mesh, **kw)
            return gather_over_data(out, self.mesh)

    def predict_probs_batch(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, C, S, S) preprocessed -> (B, classes) f32 probabilities
        on the engine's device. A headless encoder raises ValueError."""
        return torch.softmax(self._forward(images).float(), dim=-1)

    def features_batch(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, C, S, S) preprocessed -> (B, hidden) final-LN pooled
        features on the engine's device, in the engine's dtype: the encoder
        output without the classifier head. Every serving knob (attention
        and matmul paths, W8A8, LayerNorm folding) applies."""
        return self._forward(images, features=True)

    def embed_file(self, path: str) -> np.ndarray:
        """Decode, preprocess, encode: one image -> (hidden,) f32 feature
        vector. Callers L2-normalise it if their similarity needs it."""
        pixels = self.preprocess_image(load_image_rgb(path))
        return self.features_batch(pixels[None])[0].float().cpu().numpy()

    def attention_maps_batch(self, images: torch.Tensor) -> np.ndarray:
        """images: (B, C, S, S) preprocessed -> (B, L, H, T, T) f32
        attention probabilities on the host (models/attention_maps.py):
        an analysis path on composed attention, with the engine's weights
        (quantized, folded) as they are. A sharded engine runs this rank's
        rows and returns the whole batch, as predict_probs_batch does."""
        from vit_cpp_tpu_torch.models.attention_maps import attention_maps
        from vit_cpp_tpu_torch.parallel.mesh import data_slice, gather_over_data

        with torch.inference_mode(), matmul_precision(self.matmul_precision):
            rows = data_slice(images.to(self.device), self.mesh)
            maps, _ = attention_maps(self.params, rows, self.hp, mesh=self.mesh)
            maps = gather_over_data(maps, self.mesh)
        return maps.cpu().numpy()

    def explain_file(
        self, path: str, topk: int = 5, head_fuse: str = "mean"
    ) -> Tuple[List[Tuple[int, float, str]], np.ndarray]:
        """One encoder pass -> ([(class_id, prob, label)] top-k, the
        (side, side) attention-rollout saliency). The maps forward's last
        block output goes through the production head (head_logits), so
        vit-explain runs the encoder once. A headless encoder gives no
        top-k."""
        from vit_cpp_tpu_torch.models.attention_maps import (
            attention_maps,
            attention_rollout,
            head_logits,
        )

        pixels = self.preprocess_image(load_image_rgb(path))[None]
        with torch.inference_mode(), matmul_precision(self.matmul_precision):
            maps, final = attention_maps(self.params, pixels, self.hp, mesh=self.mesh)
            probs = None
            if self.hp.num_classes:
                logits = head_logits(self.params, final, self.hp, self.mm_impl, mesh=self.mesh)
                probs = torch.softmax(logits.float(), dim=-1)[0].cpu().numpy()
        grid = attention_rollout(maps.cpu().numpy(), self.hp, head_fuse=head_fuse)[0]
        if probs is None:
            return [], grid
        order = np.argsort(-probs, kind="stable")[:topk]
        return [
            (int(i), float(probs[i]), self.id2label.get(int(i), f"LABEL_{i}"))
            for i in order
        ], grid

    def attention_rollout_file(self, path: str, head_fuse: str = "mean") -> np.ndarray:
        """One image -> (side, side) [0, 1] attention-rollout saliency."""
        return self.explain_file(path, head_fuse=head_fuse)[1]

    def classify_file(
        self, path: str, topk: int = 5, verbose: bool = True
    ) -> List[Tuple[int, float, str]]:
        """Decode, preprocess, predict, return [(class_id, prob, label)];
        verbose prints the image lines (stdout) and the resampler's scale
        (stderr) as the JAX engine does. A sequence-head (ViTSTR) file
        raises ValueError: VitstrEngine recognizes it."""
        if self.hp.seq_len is not None and type(self) is VitEngine:
            raise ValueError(
                "this checkpoint has a sequence head (ViTSTR); use "
                "VitstrEngine / the vitstr CLI instead of the classifier"
            )
        img = load_image_rgb(path)
        if verbose:
            print(f"load_image_from_file: loaded image '{path}' ({img.shape[1]} x {img.shape[0]})")
        pixels = self.preprocess_image(img)
        if verbose:
            self._print_preprocess_scale(img)
            print(f"processed, out dims : ({self.hp.img_size} x {self.hp.img_size})")
        probs = self.predict_probs_batch(pixels[None])[0].cpu().numpy()
        order = np.argsort(-probs, kind="stable")[:topk]
        return [
            (int(i), float(probs[i]), self.id2label.get(int(i), f"LABEL_{i}"))
            for i in order
        ]


class VitstrEngine(VitEngine):
    """The scene-text engine (vit_cpp_tpu/engine.py::VitstrEngine): the
    same transformer, grayscale (1, S, S) input and a greedy decode of the
    (seq_len, n_tokens) probabilities instead of a top-k."""

    def preprocess_images(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """(H, W, 3) u8 host images -> (B, 1, S, S) f32 in [-1, 1] on the
        engine's device (models/vitstr.py)."""
        from vit_cpp_tpu_torch.models.vitstr import preprocess_grayscale_batch

        return preprocess_grayscale_batch(list(images), self.hp.img_size, self.device)

    def recognize_file(self, path: str, verbose: bool = True) -> Tuple[str, float]:
        """Decode, preprocess, predict, greedy-decode -> (text, confidence);
        verbose prints the image lines on stdout as the JAX engine does."""
        from vit_cpp_tpu_torch.models.vitstr import greedy_decode

        img = load_image_rgb(path)
        if verbose:
            print(f"load_image_from_file: loaded image '{path}' ({img.shape[1]} x {img.shape[0]})")
        pixels = self.preprocess_image(img)
        if verbose:
            print(f"processed, out dims : ({self.hp.img_size} x {self.hp.img_size})")
        probs = self.predict_probs_batch(pixels[None])[0].cpu().numpy()
        return greedy_decode(probs, self.id2label)
