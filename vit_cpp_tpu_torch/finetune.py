"""Fine-tune a checkpoint on an image-folder dataset.

Counterpart of vit_cpp_tpu/finetune.py: gguf checkpoint -> dense f32
parameter tree on `device` -> AdamW train steps through the training
forward (parallel/train.py: fused attention forward, the hand-written
backward kernel) -> checkpoint / resume (parallel/checkpoint.py) ->
servable gguf (models/export.py). The dataset layout is the JAX
package's: one subdirectory per class, any decodable
image inside (`load_dataset` and `_prefetch_batches` are the port's own
copies of that module's); a sequence-head (ViTSTR) checkpoint trains on
scene-text pairs instead (`load_vitstr_dataset`: a gt.txt, or the file
names).

Head transfer: when the dataset's class count differs from the
checkpoint's, the head is zero-initialized for the new count and the
hparams rewritten; a headless encoder (SigLIP's attention-pooled tower)
gets its first head so.

Every option of the JAX package's `finetune` runs here: `mesh` (a
('data', 'model') DeviceMesh over the launcher's ranks, parallel/mesh.py)
and `fsdp` (ZeRO-3 over "data"), the optimizer and schedule, grad_accum,
clip_norm, mu_dtype (a bf16 first moment), freeze_backbone, augment,
label_smoothing, mixup, ema, ckpt_dir (resume with the JAX package's
settings checks), seed, decode_threads, val_dir, stream, img_size /
patch_size (training at a resampled geometry, models/resample.py), tome
(ToMe merging, ops/tome.py), moe and its options (sparse upcycling,
ops/moe.py), lora / lora_alpha (models/lora.py; the export folds the
adapters in), distill and its options (a frozen teacher's logits), qat /
qat_act / qat_scales_out (quant/qat.py), and device. On a mesh every rank reads the whole dataset in the same
order, augments and mixes the whole batch, and trains on its rows of it
(parallel/train.py::shard_batch); the distillation teacher and LoRA's
frozen base are TP-sharded like the student, the checkpoint is sharded
(torch.distributed.checkpoint), and the returned tree is the whole one,
gathered from the shards, on every rank; only rank 0 logs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vit_cpp_tpu_torch.decode import decode_many
from vit_cpp_tpu_torch.io.image import IMAGE_EXTS
from vit_cpp_tpu_torch.ops.preprocess import norm_constants, preprocess_batch
from vit_cpp_tpu_torch.parallel.train import qat_params
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear


def load_dataset(data_dir: str) -> Tuple[List[str], np.ndarray, List[str]]:
    """Walk `data_dir/<class>/*` -> (paths, int labels, sorted class names);
    vit_cpp_tpu/finetune.py::load_dataset."""
    classes = sorted(
        d
        for d in os.listdir(data_dir)
        if os.path.isdir(os.path.join(data_dir, d))
    )
    if not classes:
        raise ValueError(f"{data_dir}: no class subdirectories")
    paths: List[str] = []
    labels: List[int] = []
    for ci, cls in enumerate(classes):
        sub = os.path.join(data_dir, cls)
        for f in sorted(os.listdir(sub)):
            if os.path.splitext(f)[1] in IMAGE_EXTS:
                paths.append(os.path.join(sub, f))
                labels.append(ci)
    if not paths:
        raise ValueError(f"{data_dir}: no images under class directories")
    return paths, np.asarray(labels, np.int32), classes


def load_vitstr_dataset(data_dir: str) -> Tuple[List[str], List[str]]:
    """Scene-text training pairs from `data_dir`
    (vit_cpp_tpu/finetune.py::load_vitstr_dataset): a `gt.txt` with one
    `relative/path<TAB>text` line per sample, or else every image's file
    stem, a trailing `_<digits>` dedup suffix stripped (`hello_2.png` ->
    "hello")."""
    gt = os.path.join(data_dir, "gt.txt")
    paths: List[str] = []
    texts: List[str] = []
    if os.path.exists(gt):
        with open(gt, encoding="utf-8") as f:
            for ln, line in enumerate(f, 1):
                line = line.rstrip("\n")
                if not line:
                    continue
                rel, sep, text = line.partition("\t")
                if not sep:
                    raise ValueError(f"{gt}:{ln}: want 'path<TAB>text'")
                paths.append(os.path.join(data_dir, rel))
                texts.append(text)
    else:
        for f in sorted(os.listdir(data_dir)):
            stem, ext = os.path.splitext(f)
            if ext not in IMAGE_EXTS:
                continue
            head, _, tail = stem.rpartition("_")
            if head and tail.isdigit():
                stem = head
            paths.append(os.path.join(data_dir, f))
            texts.append(stem)
    if not paths:
        raise ValueError(f"{data_dir}: no training samples (gt.txt or images)")
    return paths, texts


def encode_texts(texts: List[str], seq_len: int) -> np.ndarray:
    """Texts -> (N, seq_len) int32 targets for the sequence loss: position
    0 ([GO]) and the tail after the [s] stop token are -1 (masked),
    positions 1..n the character ids and n+1 the stop token, the read
    pattern of the greedy decoder (models/vitstr.py)."""
    from vit_cpp_tpu_torch.models.vitstr import EOS_ID, VITSTR_VOCAB

    char2id = {c: i for i, c in enumerate(VITSTR_VOCAB) if len(c) == 1}
    out = np.full((len(texts), seq_len), -1, np.int32)
    for i, text in enumerate(texts):
        if len(text) > seq_len - 2:
            raise ValueError(
                f"label {text!r} is {len(text)} chars > seq_len-2 = {seq_len - 2}"
            )
        for j, c in enumerate(text):
            if c not in char2id:
                raise ValueError(f"label {text!r}: char {c!r} not in the vocab")
            out[i, 1 + j] = char2id[c]
        out[i, 1 + len(text)] = EOS_ID
    return out


def _prefetch_batches(fetch, idx_seq, depth: int = 2):
    """Run `fetch(idx)` for each index array on a background thread,
    `depth` batches ahead of the consumer, so decode + preprocess of batch
    s+1 overlaps the step on batch s (vit_cpp_tpu/finetune.py::
    _prefetch_batches). Worker exceptions re-raise at the consuming
    iteration. If the consumer abandons the generator (a train step
    raised, KeyboardInterrupt), the finally block signals the worker to
    stop and drains the queue so it cannot stay blocked in put()."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def worker():
        try:
            for idx in idx_seq:
                if stop.is_set():
                    return
                q.put(fetch(idx))
        except BaseException as e:  # surface decode errors to the loop
            q.put(e)
            return
        q.put(_END)

    threading.Thread(
        target=worker, name="vit-finetune-prefetch", daemon=True
    ).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # unblock a worker waiting in put(); it checks `stop` before the
        # next fetch and exits (at most one more item lands and is dropped)
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


def _dense_f32(params):
    """Dequantize every QuantLinear leaf -> trainable dense f32 tree."""
    if isinstance(params, dict):
        return {k: _dense_f32(v) for k, v in params.items()}
    if params is None:
        return None
    if isinstance(params, QuantLinear):
        return params.dequantize(torch.float32)
    return params.to(torch.float32)


def _reinit_head(params, hp, num_classes: int):
    """Zero-init a fresh (h, num_classes) head for transfer learning; a
    distilled checkpoint's second head too (inference averages them)."""
    params = dict(params)
    dev = params["pos_embed"].device

    def fresh():
        return {
            "kernel": torch.zeros((hp.hidden_size, num_classes), device=dev),
            "bias": torch.zeros((num_classes,), device=dev),
        }

    params["head"] = fresh()
    if "head_dist" in params:
        params["head_dist"] = fresh()
    return params, dataclasses.replace(hp, num_classes=num_classes)


def _preprocess_chunk(paths, hp, decode_threads: int, device) -> torch.Tensor:
    """Decode + preprocess files on `device` -> (n, C, S, S) f32 on the
    CPU, through the grayscale pipeline for a sequence-head model. A
    failed decode raises (training data must be clean)."""
    imgs = decode_many(paths, decode_threads or (os.cpu_count() or 1))
    for p, im in zip(paths, imgs):
        if im is None:
            raise ValueError(f"undecodable training image: {p}")
    if hp.seq_len is not None:
        from vit_cpp_tpu_torch.models.vitstr import preprocess_grayscale_batch

        return preprocess_grayscale_batch(imgs, hp.img_size, device=device).cpu()
    mean, std = norm_constants(hp.pixel_norm)
    return preprocess_batch(
        imgs, hp.img_size, mode=hp.interpolation, mean=mean, std=std, device=device
    ).cpu()


def _preprocess_all(paths, hp, decode_threads: int, device) -> torch.Tensor:
    chunk = 64
    return torch.cat(
        [
            _preprocess_chunk(paths[i : i + chunk], hp, decode_threads, device)
            for i in range(0, len(paths), chunk)
        ]
    )


def evaluate(
    params, hp, pixels: torch.Tensor, labels: np.ndarray, batch: int, tome: int = 0,
    qat: str = "", qat_scales=None, mesh=None,
) -> float:
    """Top-1 accuracy of `params` on preprocessed pixels, on the params'
    device (the default, composed attention, as the JAX package's eval).
    `tome` evaluates through the merged graph and `qat` the
    fake-quantized model: a fine-tune validates what it will serve. On a
    mesh every rank scores every batch with its shards."""
    from vit_cpp_tpu_torch.models.vit import forward

    dev = params["pos_embed"].device
    correct = 0
    with torch.no_grad():
        p = qat_params(params, qat, qat_scales, mesh, hp)
        for i in range(0, len(pixels), batch):
            pred = forward(p, pixels[i : i + batch].to(dev), hp, tome=tome,
                           mm_impl="qat" if qat else "xla", mesh=mesh).argmax(dim=-1)
            correct += int((pred.cpu().numpy() == labels[i : i + len(pred)]).sum())
    return correct / len(pixels)


def evaluate_vitstr(
    params, hp, pixels: torch.Tensor, texts: List[str], batch: int, qat: str = "",
    qat_scales=None, mesh=None,
) -> float:
    """Word-level exact-match accuracy through the device greedy decoder."""
    from vit_cpp_tpu_torch.models.vit import forward
    from vit_cpp_tpu_torch.models.vitstr import decode_tokens, greedy_decode_device, vitstr_id2label

    dev = params["pos_embed"].device
    id2label = vitstr_id2label()
    correct = 0
    with torch.no_grad():
        p = qat_params(params, qat, qat_scales, mesh, hp)
        for i in range(0, len(pixels), batch):
            logits = forward(p, pixels[i : i + batch].to(dev), hp,
                             mm_impl="qat" if qat else "xla", mesh=mesh)
            toks, valid, _ = greedy_decode_device(torch.softmax(logits.float(), dim=-1))
            toks, valid = toks.cpu().numpy(), valid.cpu().numpy()
            correct += sum(decode_tokens(t, v, id2label) == texts[i + j]
                           for j, (t, v) in enumerate(zip(toks, valid)))
    return correct / len(pixels)


def _ema_update(ema_leaves, param_leaves, decay: float) -> None:
    """e := d * e + (1 - d) * p on every leaf, in place."""
    with torch.no_grad():
        torch._foreach_mul_(ema_leaves, decay)
        torch._foreach_add_(ema_leaves, param_leaves, alpha=1.0 - decay)


def finetune(
    model: str,
    data_dir: str,
    *,
    epochs: int = 3,
    batch: int = 32,
    lr: float = 1e-4,
    weight_decay: float = 0.05,
    schedule: str = "const",
    warmup_steps: int = 0,
    grad_accum: int = 1,
    clip_norm: float = 0.0,
    mu_dtype: str = "f32",
    freeze_backbone: bool = False,
    augment: str = "none",
    label_smoothing: float = 0.0,
    mixup: float = 0.0,
    ema: float = 0.0,
    mesh=None,
    fsdp: bool = False,
    ckpt_dir: Optional[str] = None,
    seed: int = 0,
    decode_threads: int = 0,
    val_dir: Optional[str] = None,
    img_size: Optional[int] = None,
    patch_size: Optional[int] = None,
    tome: int = 0,
    moe: int = 0,
    moe_every: int = 2,
    moe_top_k: int = 1,
    moe_capacity: float = 1.25,
    lora: int = 0,
    lora_alpha: float = 0.0,
    distill: str = "",
    distill_mode: str = "soft",
    distill_alpha: float = 0.5,
    distill_tau: float = 3.0,
    qat: str = "",
    qat_act: str = "dynamic",
    qat_scales_out: Optional[str] = None,
    stream: bool = False,
    log=print,
    device="cuda",
) -> Tuple[Dict[str, Any], Any, List[str], List[float]]:
    """Run the fine-tune loop; returns (params, hp, classnames, epoch_losses).

    Resumable: when `ckpt_dir` holds a previous run's state, training
    continues from its update count (epochs already covered are skipped).
    `augment`, `mixup` and the shuffle key off (seed, global update index),
    so a resumed run replays the exact stream; every setting is recorded
    in the sibling `<ckpt_dir>.meta.json` and validated on resume.

    `ema` > 0 keeps an exponential moving average of the weights (init =
    the starting params, e := d*e + (1-d)*p after every update) and
    RETURNS it: that is what you serve, and what validation scores.

    `lora` > 0 trains rank-r adapters and the head over the frozen
    weights and returns them folded in. `distill` names a frozen teacher
    gguf (a classifier of the dataset's taxonomy at the student's
    geometry). `qat` trains through a serving format's quantization;
    with `qat_act="static"` the activation scales are measured on the
    first `batch` files at the top of every epoch, and `qat_scales_out`
    writes those of the returned weights as the serving sidecar.

    The log's last line before the return gives the updates' host-clock
    time (each update ends with its loss read, which waits for the
    device), the run's first update left out."""
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.engine import detect_hparams, resolve_device
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.ops.augment import augment_batch, augment_flags, mixup_batch, step_generator
    from vit_cpp_tpu_torch.parallel import train as T
    from vit_cpp_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from vit_cpp_tpu_torch.parallel.mesh import data_slice, is_leader, rank_device

    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if fsdp and mesh is None:
        raise ValueError("--fsdp needs a device mesh (--mesh DPxTP)")
    if mesh is not None:
        device = rank_device(device)
        if not is_leader():
            log = _quiet
    aug_flip, aug_crop = augment_flags(augment)  # validates the mode
    if mixup < 0:
        raise ValueError(f"mixup alpha must be >= 0, got {mixup}")
    if not 0.0 <= ema < 1.0:
        raise ValueError(f"ema decay must be in [0, 1), got {ema}")
    if mixup and grad_accum > 1:
        raise ValueError("--mixup is incompatible with --grad-accum > 1")
    if tome < 0:
        raise ValueError(f"tome must be >= 0, got {tome}")
    dev = resolve_device(device)

    mf = read_model(model)
    hp = detect_hparams(mf)
    _check_moe(hp, moe, moe_every, moe_top_k, moe_capacity, tome=tome, qat=qat, lora=lora,
               distill=distill, mixup=mixup, grad_accum=grad_accum,
               freeze_backbone=freeze_backbone)
    _check_extras(hp, lora=lora, freeze_backbone=freeze_backbone, fsdp=fsdp,
                  grad_accum=grad_accum,
                  mixup=mixup, distill=distill, distill_mode=distill_mode,
                  distill_alpha=distill_alpha, distill_tau=distill_tau, qat=qat,
                  qat_act=qat_act, qat_scales_out=qat_scales_out, tome=tome, augment=augment,
                  label_smoothing=label_smoothing)
    lora_alpha = lora_alpha or float(2 * lora)
    is_vitstr = hp.seq_len is not None
    vtexts = None
    if is_vitstr:
        # scene text: gt.txt / file-stem labels, (B, seq_len) targets
        from vit_cpp_tpu_torch.models.vitstr import VITSTR_VOCAB

        if hp.num_classes != len(VITSTR_VOCAB):
            raise ValueError(
                f"sequence checkpoint has {hp.num_classes} classes; "
                f"ViTSTR training needs the {len(VITSTR_VOCAB)}-token vocab"
            )
        paths, texts = load_vitstr_dataset(data_dir)
        labels = encode_texts(texts, hp.seq_len)
        classes = list(VITSTR_VOCAB)
    else:
        paths, labels, classes = load_dataset(data_dir)
    samples_per_update = batch * grad_accum
    if len(paths) < samples_per_update:
        raise ValueError(
            f"dataset has {len(paths)} images < batch*grad_accum "
            f"{samples_per_update}; lower --batch/--grad-accum"
        )

    params = _dense_f32(load_params(mf, torch.float32, hparams=hp, device=dev))
    native_img_size, native_patch_size = hp.img_size, hp.patch_size
    if (img_size is not None and img_size != hp.img_size) or (
        patch_size is not None and patch_size != hp.patch_size
    ):
        # fine-tune at a new resolution and/or patch size (resampled
        # pos_embed, PI-resized patch_embed): the export serves it natively
        from vit_cpp_tpu_torch.models.resample import resample_params

        params, hp = resample_params(params, hp, img_size, patch_size=patch_size)
        log(
            f"finetune: geometry {hp.img_size} px / patch {hp.patch_size} "
            "(resampled from the checkpoint's native grid)"
        )
    if not is_vitstr and len(classes) != hp.num_classes:
        log(f"finetune: re-initializing head {hp.num_classes} -> {len(classes)} classes")
        params, hp = _reinit_head(params, hp, len(classes))
    if moe:
        # sparse upcycling (ops/moe.py): experts in every moe_every'th
        # block from block 1 (V-MoE's odd blocks at the default 2)
        from vit_cpp_tpu_torch.ops.moe import upcycle_params

        moe_layers = tuple(range(1, hp.num_hidden_layers, moe_every))
        if not moe_layers or len(moe_layers) >= hp.num_hidden_layers:
            raise ValueError(
                f"--moe-every {moe_every} places experts in no layer or "
                f"every layer of a {hp.num_hidden_layers}-block model"
            )
        params = upcycle_params(params, hp, moe, moe_layers, seed=seed)
        hp = dataclasses.replace(hp, num_experts=moe, moe_layers=moe_layers,
                                 moe_top_k=moe_top_k, moe_capacity=moe_capacity)
        log(
            f"finetune: upcycling to {moe} experts (top-{moe_top_k}, "
            f"capacity {moe_capacity:g}) in blocks "
            f"{','.join(map(str, moe_layers))}"
        )

    teacher_params = teacher_hp = None
    if distill:
        teacher_params, teacher_hp = _load_teacher(distill, hp, len(classes), dev)
        if mesh is not None:
            # TP-sharded like a served model: its forward rides the same collectives
            from vit_cpp_tpu_torch.parallel.sharding import shard_params

            teacher_params = shard_params(teacher_params, mesh)
        log(
            f"finetune: distilling from {distill} "
            f"({distill_mode}, alpha {distill_alpha:g}, tau {distill_tau:g})"
        )

    updates_per_epoch = len(paths) // samples_per_update
    optimizer_kw = dict(
        lr=lr, weight_decay=weight_decay, schedule=schedule,
        total_steps=updates_per_epoch * epochs, warmup_steps=warmup_steps,
        clip_norm=clip_norm, mu_dtype=mu_dtype,
    )
    base_params = None
    export_specs = None  # the placement of the exported tree on the mesh
    if lora:
        from vit_cpp_tpu_torch.models.lora import lora_state_bytes, lora_trainable

        base_params = params
        trainable = lora_trainable(params, lora, seed)
        log(
            f"finetune: LoRA rank {lora} (alpha {lora_alpha:g}) — "
            f"{lora_state_bytes(trainable) / 1e6:.1f} MB trainable vs "
            f"{lora_state_bytes(params) / 1e6:.1f} MB full"
        )
        if mesh is not None:
            from vit_cpp_tpu_torch.parallel.sharding import placement_specs, shard_params

            export_specs = placement_specs(params, mesh)
            base_params = shard_params(params, mesh, specs=export_specs)
            state = T.create_lora_train_state(trainable, optimizer_kw, mesh=mesh)
            # the merged tree carries the trained, replicated head(s)
            export_specs = {**export_specs, **{k: state.specs[k] for k in ("head", "head_dist")
                                               if k in state.specs}}
        else:
            state = T.create_train_state(trainable, optimizer_kw)
    else:
        state = T.create_train_state(
            params, optimizer_kw, trainable=("head", "head_dist") if freeze_backbone else None,
            mesh=mesh, fsdp=fsdp,
        )
        export_specs = state.specs
    # the EMA starts as a copy of the initial trainable tree
    ema_params = _clone(state.params) if ema else None

    vpaths = vlabels = None
    if val_dir:
        if is_vitstr:
            vpaths, vtexts = load_vitstr_dataset(val_dir)
            encode_texts(vtexts, hp.seq_len)  # validate vocab / length early
        else:
            vpaths, vlabels, vclasses = load_dataset(val_dir)
            if vclasses != classes:
                raise ValueError(f"val classes {vclasses} != train classes {classes}")

    # sibling file, as in the JAX package (the checkpoint directory holds
    # only the state)
    meta_path = os.path.abspath(ckpt_dir).rstrip("/") + ".meta.json" if ckpt_dir else None
    # everything that changes what a resumed run replays, under the JAX
    # package's keys
    run_meta = {
        "batch": batch,
        "n_images": len(paths),
        "grad_accum": grad_accum,
        "seed": seed,
        "epochs": epochs,
        "lr": lr,
        "weight_decay": weight_decay,
        "schedule": schedule,
        "warmup_steps": warmup_steps,
        "clip_norm": clip_norm,
        "mu_dtype": mu_dtype,
        "freeze_backbone": freeze_backbone,
        "augment": augment,
        "label_smoothing": label_smoothing,
        "mixup": mixup,
        "ema": ema,
        "img_size": hp.img_size,
        "patch_size": hp.patch_size,
        "tome": tome,
        "qat": qat,
        "qat_act": qat_act,
        "lora": lora,
        "lora_alpha": lora_alpha,
        "moe": hp.num_experts,
        "moe_layers": list(hp.moe_layers),
        "moe_top_k": hp.moe_top_k,
        "moe_capacity": hp.moe_capacity,
        "distill": os.path.abspath(distill) if distill else "",
        "distill_mode": distill_mode if distill else "",
        "distill_alpha": distill_alpha if distill else 0.0,
        "distill_tau": distill_tau if distill else 0.0,
    }
    if ckpt_dir and os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        _check_resume(ckpt_dir, meta_path, run_meta, log,
                      native=(native_img_size, native_patch_size))
        ema_params = restore_train_state(ckpt_dir, state, ema_params)
        log(f"finetune: resumed from {ckpt_dir} at step {state.step}")

    pixels = None
    if stream:
        log(f"finetune: streaming {len(paths)} images per epoch")
    else:
        log(f"finetune: preprocessing {len(paths)} images ...")
        pixels = _preprocess_all(paths, hp, decode_threads, dev)
    val = None
    if val_dir:
        val = (_preprocess_all(vpaths, hp, decode_threads, dev), vtexts if is_vitstr else vlabels)

    def merged(trained):
        """The full tree of trained leaves: the LoRA adapters folded in."""
        if not lora:
            return trained
        from vit_cpp_tpu_torch.models.lora import merge_lora

        with torch.no_grad():
            return merge_lora(base_params, trained, lora_alpha, mesh)

    calib_px = None
    if qat_act == "static":
        # the fixed calibration batch: the first `batch` files in dataset
        # order, the same on resume, streamed or preloaded
        from vit_cpp_tpu_torch.quant.qat import measure_act_scales

        calib_px = _preprocess_chunk(paths[:batch], hp, decode_threads, dev).to(dev)
    qat_scales = None

    def batch_loss(bx, by):
        """The update's loss on one batch, by the run's kind; QAT with
        this epoch's static scales."""
        qkw = dict(qat=qat, qat_scales=qat_scales, mesh=mesh)
        if lora:
            return T.lora_cross_entropy_loss(state.params, base_params, bx, by, hp, lora_alpha,
                                             label_smoothing, tome, seq=is_vitstr, **qkw)
        if distill:
            return T.distill_cross_entropy_loss(state.params, teacher_params, bx, by, hp,
                                                teacher_hp, distill_alpha, distill_tau,
                                                distill_mode, label_smoothing, tome, **qkw)
        if is_vitstr:
            return T.vitstr_cross_entropy_loss(state.params, bx, by, hp, **qkw)
        return T.cross_entropy_loss(state.params, bx, by, hp, label_smoothing, tome, **qkw)

    start_epoch = state.step // updates_per_epoch
    ema_leaves = [T.local_tensor(t) for t in T.tree_leaves(ema_params)] if ema else None
    param_leaves = [T.local_tensor(t) for t in T.tree_leaves(state.params)]
    losses: List[float] = []
    update_ms: List[float] = []
    for epoch in range(start_epoch, epochs):
        if calib_px is not None:
            # frozen for the epoch, measured on the current weights
            qat_scales = measure_act_scales(merged(state.params), calib_px, hp, qat, mesh=mesh)
        # deterministic per-epoch shuffle: the same order replays on resume
        order = np.random.default_rng(seed + epoch).permutation(len(paths))
        idx_seq = [
            order[s * samples_per_update : (s + 1) * samples_per_update]
            for s in range(updates_per_epoch)
        ]
        if stream:
            fetch = lambda idx: _preprocess_chunk(  # noqa: E731
                [paths[i] for i in idx], hp, decode_threads, dev
            )
            batch_iter = _prefetch_batches(fetch, idx_seq)
        else:
            batch_iter = (pixels[torch.from_numpy(idx)] for idx in idx_seq)
        epoch_losses = []
        t0 = time.perf_counter()
        for s, bx_host in enumerate(batch_iter):
            idx = idx_seq[s]
            bx = bx_host.to(dev)
            by = torch.from_numpy(labels[idx]).to(dev)
            mix = None
            if augment != "none" or mixup:
                # keyed by the GLOBAL update index: a resumed run replays
                gen = step_generator(seed, epoch * updates_per_epoch + s)
                if augment != "none":
                    bx = augment_batch(gen, bx, flip=aug_flip, crop=aug_crop)
                if mixup:
                    bx, perm, lam = mixup_batch(gen, bx, mixup)
                    mix = (by[perm], lam)
            if mesh is not None:  # this rank's rows of the (augmented, mixed) batch
                bx, by = T.shard_batch(bx, by, mesh)
                if mix is not None:
                    mix = (data_slice(mix[0], mesh), mix[1])
            qkw = dict(qat=qat, qat_scales=qat_scales)
            if mix is not None:
                loss = T.train_step_mixup(state, bx, by, mix[0], mix[1], hp,
                                          smooth=label_smoothing, tome=tome, **qkw)
            elif grad_accum > 1:
                loss = T.train_step_accum(state, bx, by, hp, grad_accum, smooth=label_smoothing,
                                          tome=tome, seq=is_vitstr, **qkw)
            else:
                loss = T.update(state, batch_loss(bx, by))
            if ema:
                _ema_update(ema_leaves, param_leaves, ema)
            epoch_losses.append(float(loss))  # waits for the device
            t1 = time.perf_counter()
            update_ms.append((t1 - t0) * 1000.0)
            t0 = t1
        mean_loss = float(np.mean(epoch_losses))
        losses.append(mean_loss)
        msg = f"epoch {epoch + 1}/{epochs}: loss {mean_loss:.4f}"
        if val is not None:
            # score what will be served: the EMA weights when enabled,
            # merged into the frozen base under LoRA
            eval_params = merged(ema_params if ema else state.params)
            if is_vitstr:
                acc = evaluate_vitstr(eval_params, hp, val[0], val[1], batch, qat=qat,
                                      qat_scales=qat_scales, mesh=mesh)
                msg += f", val word-acc{' (ema)' if ema else ''} {acc:.3f}"
            else:
                acc = evaluate(eval_params, hp, val[0], val[1], batch, tome=tome, qat=qat,
                               qat_scales=qat_scales, mesh=mesh)
                msg += f", val top-1{' (ema)' if ema else ''} {acc:.3f}"
        log(msg)
        if ckpt_dir:
            save_train_state(ckpt_dir, state, ema_params)
            if is_leader():
                with open(meta_path, "w") as f:
                    json.dump(run_meta, f)
    if len(update_ms) > 1:
        ms = float(np.mean(update_ms[1:]))
        log(
            f"finetune: {len(update_ms)} updates on {dev}, {ms:.2f} ms per "
            f"update after the first, {samples_per_update * 1000.0 / ms:.1f} "
            "training images/s"
        )
    # a LoRA run exports the adapters folded into dense kernels: the gguf
    # serves through the unchanged engine
    final_params = merged(ema_params if ema else state.params)
    if mesh is not None:
        from vit_cpp_tpu_torch.parallel.sharding import gather_params

        final_params = gather_params(final_params, export_specs, mesh)
    if qat_scales_out:
        # the sidecar for zero-calibration static serving, measured on the
        # exported weights
        from vit_cpp_tpu_torch.quant.qat import save_act_scales

        scales = measure_act_scales(final_params, calib_px, hp, qat)
        if is_leader():
            save_act_scales(qat_scales_out, scales, margin=1.05)
        log(f"finetune: wrote static activation scales to {qat_scales_out}")
    return final_params, hp, classes, losses


def _check_extras(hp, *, lora: int, freeze_backbone: bool, fsdp: bool, grad_accum: int,
                  mixup: float,
                  distill: str, distill_mode: str, distill_alpha: float, distill_tau: float,
                  qat: str, qat_act: str, qat_scales_out, tome: int, augment: str,
                  label_smoothing: float) -> None:
    """The JAX package's checks of LoRA, distillation, QAT and sequence
    (ViTSTR) training (vit_cpp_tpu/finetune.py:535-598), in its order and
    with its messages."""
    from vit_cpp_tpu_torch.quant.qat import QAT_FORMATS

    if qat and qat not in QAT_FORMATS:
        raise ValueError(f"qat format must be one of {QAT_FORMATS}, got {qat!r}")
    if lora < 0:
        raise ValueError(f"lora rank must be >= 0, got {lora}")
    if lora:
        if freeze_backbone:
            raise ValueError("--lora already freezes the backbone — drop --freeze-backbone")
        if fsdp:
            raise ValueError(
                "--lora optimizer state is already tiny (rank-r adapters "
                "+ head); --fsdp is unnecessary — drop one"
            )
        if grad_accum > 1:
            raise ValueError("--lora with --grad-accum is not supported")
        if mixup:
            raise ValueError("--lora with --mixup is not supported")
    if distill:
        if distill_mode not in ("soft", "hard"):
            raise ValueError(f"distill mode must be soft|hard, got {distill_mode!r}")
        if not 0.0 <= distill_alpha <= 1.0:
            raise ValueError(f"distill alpha must be in [0, 1], got {distill_alpha}")
        if distill_tau <= 0:
            raise ValueError(f"distill tau must be > 0, got {distill_tau}")
        if mixup:
            raise ValueError("--distill with --mixup is not supported")
        if grad_accum > 1:
            raise ValueError("--distill with --grad-accum is not supported")
        if lora:
            raise ValueError("--distill with --lora is not supported")
    if qat_act not in ("dynamic", "static"):
        raise ValueError(f"qat_act must be dynamic|static, got {qat_act!r}")
    if qat_act == "static" and not qat:
        raise ValueError("--qat-act static requires --qat FMT")
    if qat_scales_out and qat_act != "static":
        raise ValueError("an act-scales sidecar needs --qat-act static")
    if hp.seq_len is not None:
        if tome:
            raise ValueError(
                "tome is incompatible with sequence checkpoints (ViTSTR "
                "reads every token position)"
            )
        if augment != "none" or label_smoothing or mixup:
            # mirrored glyphs and cropped-away characters change the truth
            raise ValueError(
                "augmentation / label smoothing are classifier-only "
                "(scene-text labels are orientation- and crop-sensitive)"
            )


def _load_teacher(path: str, hp, n_classes: int, dev):
    """The frozen distillation teacher's dense f32 tree and hparams, which
    must speak the dataset's taxonomy at the student's input geometry."""
    from vit_cpp_tpu_torch.engine import detect_hparams
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.models.params import load_params

    if hp.seq_len is not None:
        raise ValueError(
            "--distill supports classifier students only (sequence "
            "heads have no logit-distillation recipe here)"
        )
    tmf = read_model(path)
    teacher_hp = detect_hparams(tmf)
    if teacher_hp.seq_len is not None:
        raise ValueError("--distill teacher must be a classifier")
    if teacher_hp.num_classes != n_classes:
        raise ValueError(
            f"--distill teacher has {teacher_hp.num_classes} classes "
            f"but the dataset has {n_classes} — fine-tune the "
            "teacher on this taxonomy first"
        )
    if teacher_hp.img_size != hp.img_size or teacher_hp.in_chans != hp.in_chans:
        raise ValueError(
            f"--distill teacher geometry ({teacher_hp.img_size} px, "
            f"{teacher_hp.in_chans} ch) != student "
            f"({hp.img_size} px, {hp.in_chans} ch)"
        )
    return _dense_f32(load_params(tmf, torch.float32, hparams=teacher_hp, device=dev)), teacher_hp


# a run-meta key missing from an older meta file -> (the value that file's
# run trained with, its flag, how it trained, what a resume departing from
# it would resume with, the fix), the JAX package's refusals
_PREDATES = {
    "tome": (0, "--tome", "trained unmerged", "--tome", "drop --tome"),
    "lora": (0, "--lora", "trained full-weight", "--lora", "drop --lora"),
    "moe": (0, "--moe", "trained dense", "experts", "drop --moe"),
    "distill": ("", "--distill", "trained without a teacher", "--distill", "drop it"),
    "qat_act": ("dynamic", "--qat-act", "trained with dynamic activation qdq",
                "--qat-act static", "drop it"),
    "qat": ("", "--qat", "trained dense", "--qat", "drop --qat"),
}


def _check_resume(ckpt_dir: str, meta_path: str, run_meta: dict, log, native) -> None:
    """The JAX package's resume checks (vit_cpp_tpu/finetune.py:865-971):
    the saved run's meta must exist and match the requested settings; a
    meta that predates a recorded key is accepted with a warning unless
    the request departs from what such a run trained with."""
    # a checkpoint without its sibling meta cannot be validated
    if not os.path.exists(meta_path):
        raise ValueError(
            f"checkpoint at {ckpt_dir} has no {meta_path}; its "
            "batching cannot be validated — use a fresh --ckpt-dir"
        )
    with open(meta_path) as f:
        saved = json.load(f)
    # `epochs` may grow on resume unless the schedule has a horizon (the
    # cosine length derives from the total)
    strict = dict(run_meta)
    if run_meta["schedule"] == "const":
        strict.pop("epochs")
    missing = [k for k in strict if k not in saved]
    native_img, native_patch = native
    if "img_size" in missing and run_meta["img_size"] != native_img:
        raise ValueError(
            f"checkpoint at {ckpt_dir} predates --img-size recording "
            f"(trained at the native {native_img}); resuming at "
            f"{run_meta['img_size']} would not replay the original run — drop "
            "--img-size or use a fresh --ckpt-dir"
        )
    if "patch_size" in missing and run_meta["patch_size"] != native_patch:
        raise ValueError(
            f"checkpoint at {ckpt_dir} predates --patch-size "
            f"recording (trained at the native patch "
            f"{native_patch}); resuming at patch {run_meta['patch_size']} "
            "would not replay the original run — drop --patch-size "
            "or use a fresh --ckpt-dir"
        )
    for key, (off, flag, trained, resuming, fix) in _PREDATES.items():
        if key in missing and run_meta[key] != off:
            raise ValueError(
                f"checkpoint at {ckpt_dir} predates {flag} recording ({trained}); "
                f"resuming with {resuming} would not replay the original run — "
                f"{fix} or use a fresh --ckpt-dir"
            )
    if missing:
        log(
            f"finetune: warning — {meta_path} predates recording of "
            f"{missing}; those settings cannot be validated against "
            "the original run"
        )
    theirs = {k: saved.get(k, strict[k]) for k in strict}
    if theirs != strict:
        diff = {k: (theirs[k], strict[k]) for k in strict if theirs[k] != strict[k]}
        raise ValueError(
            f"checkpoint at {ckpt_dir} was written with different "
            f"settings (saved, requested): {diff}; resuming would not "
            "replay the original run — rerun with the original "
            "settings or use a fresh --ckpt-dir"
        )


def _check_moe(hp, moe: int, moe_every: int, moe_top_k: int, moe_capacity: float, *,
               tome: int, qat: str, lora: int, distill: str, mixup: float, grad_accum: int,
               freeze_backbone: bool) -> None:
    """The JAX package's V-MoE checks (vit_cpp_tpu/finetune.py:483-535):
    the upcycling flags, and what an MoE run (upcycled, or continued from
    an MoE checkpoint) does not train with, each with its message."""
    if moe:
        if moe < 2:
            raise ValueError(f"--moe needs >= 2 experts, got {moe}")
        if moe_every < 1:
            raise ValueError(f"--moe-every must be >= 1, got {moe_every}")
        if not 1 <= moe_top_k <= moe:
            raise ValueError(f"--moe-top-k must be in [1, {moe}], got {moe_top_k}")
        if moe_capacity <= 0:
            raise ValueError(f"--moe-capacity must be > 0, got {moe_capacity}")
        if hp.num_experts:
            raise ValueError(
                "checkpoint is already MoE — drop --moe (continue-"
                "training reuses the file's expert configuration)"
            )
    if not (moe or hp.num_experts):
        return
    if hp.seq_len is not None:
        raise ValueError(
            "MoE training supports classifier checkpoints only (the "
            "sequence loss has no router-aux term)"
        )
    for bad, msg in (
        (tome, "MoE training with --tome is not supported"),
        (qat, "MoE training with --qat is not supported (the expert "
              "einsum path has no fake-quant leaves)"),
        (lora, "MoE training with --lora is not supported"),
        (distill, "MoE training with --distill is not supported"),
        (mixup, "MoE training with --mixup is not supported"),
        (grad_accum > 1, "MoE training with --grad-accum is not supported"),
        (freeze_backbone, "MoE training updates the experts and router — "
                          "--freeze-backbone is not supported"),
    ):
        if bad:
            raise ValueError(msg)


def _quiet(msg) -> None:
    """The log of a rank other than 0."""


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().clone()
