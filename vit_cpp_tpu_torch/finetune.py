"""Fine-tune a classifier checkpoint on an image-folder dataset.

Counterpart of vit_cpp_tpu/finetune.py on one device: gguf checkpoint ->
dense f32 parameter tree on `device` -> AdamW train steps through the
training forward (parallel/train.py: fused attention forward, the
hand-written backward kernel) -> torch.save checkpoint / resume
(parallel/checkpoint.py) -> servable gguf (models/export.py). The dataset
layout is the JAX package's: one subdirectory per class, any decodable
image inside (`load_dataset` and `_prefetch_batches` are the port's own
copies of that module's).

Head transfer: when the dataset's class count differs from the
checkpoint's, the head is zero-initialized for the new count and the
hparams rewritten.

Ported options: epochs, batch, lr, weight_decay, schedule, warmup_steps,
grad_accum, clip_norm, freeze_backbone, augment, label_smoothing, mixup,
ema, ckpt_dir (resume with the JAX package's settings checks), seed,
decode_threads, val_dir, stream, tome (training and validation through
ToMe merging, ops/tome.py), moe / moe_every / moe_top_k / moe_capacity
(sparse upcycling into a V-MoE, ops/moe.py; an MoE checkpoint also
continues training without them: its router and experts train with the
auxiliary losses of parallel/train.py), device. The others raise and name
the slice they come with.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vit_cpp_tpu_torch.cli.common import _not_ported
from vit_cpp_tpu_torch.decode import decode_many
from vit_cpp_tpu_torch.io.image import IMAGE_EXTS
from vit_cpp_tpu_torch.ops.preprocess import norm_constants, preprocess_batch
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
    CPU. A failed decode raises (training data must be clean)."""
    imgs = decode_many(paths, decode_threads or (os.cpu_count() or 1))
    for p, im in zip(paths, imgs):
        if im is None:
            raise ValueError(f"undecodable training image: {p}")
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
    params, hp, pixels: torch.Tensor, labels: np.ndarray, batch: int, tome: int = 0
) -> float:
    """Top-1 accuracy of `params` on preprocessed pixels, on the params'
    device (the default, composed attention, as the JAX package's eval).
    `tome` evaluates through the merged graph: a --tome fine-tune
    validates what it will serve."""
    from vit_cpp_tpu_torch.models.vit import forward

    dev = params["pos_embed"].device
    correct = 0
    with torch.no_grad():
        for i in range(0, len(pixels), batch):
            pred = forward(params, pixels[i : i + batch].to(dev), hp, tome=tome).argmax(dim=-1)
            correct += int((pred.cpu().numpy() == labels[i : i + len(pred)]).sum())
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

    The log's last line before the return gives the updates' host-clock
    time (each update ends with its loss read, which waits for the
    device), the run's first update left out."""
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.engine import detect_hparams, resolve_device
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.ops.augment import augment_batch, augment_flags, mixup_batch, step_generator
    from vit_cpp_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from vit_cpp_tpu_torch.parallel.train import (
        create_train_state,
        train_step,
        train_step_accum,
        train_step_mixup,
        tree_leaves,
    )

    if mesh or fsdp:
        raise _not_ported("--mesh / --fsdp", "the multi-device slice")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
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
    # V-MoE's checks come first, with the JAX package's messages, so an
    # MoE run names the flag it refuses even where the flag is unported
    _check_moe(hp, moe, moe_every, moe_top_k, moe_capacity, tome=tome, qat=qat, lora=lora,
               distill=distill, mixup=mixup, grad_accum=grad_accum,
               freeze_backbone=freeze_backbone)
    if lora:
        raise _not_ported("--lora", "the training-extras slice (models/lora.py)")
    if distill:
        raise _not_ported("--distill", "the training-extras slice")
    if qat or qat_act != "dynamic" or qat_scales_out:
        raise _not_ported("--qat / --qat-act", "the training-extras slice (quant/qat.py)")
    if img_size is not None or patch_size is not None:
        raise _not_ported("--img-size / --patch-size training",
                          "the training-extras slice (ROADMAP A.10)")
    if mu_dtype not in ("f32", "bf16"):
        raise ValueError(f"mu_dtype must be f32|bf16, got {mu_dtype!r}")
    if mu_dtype == "bf16":
        raise _not_ported("--mu-dtype bf16", "the training-extras slice")
    if tome and hp.seq_len is not None:
        raise ValueError(
            "tome is incompatible with sequence checkpoints (ViTSTR "
            "reads every token position)"
        )
    if hp.seq_len is not None:
        raise _not_ported("ViTSTR fine-tuning", "the training-extras slice (ROADMAP A.10)")
    if hp.global_pool == "map":
        raise _not_ported("fine-tuning an attention-pooled (SigLIP) checkpoint",
                          "the training-extras slice (ROADMAP A.10)")
    paths, labels, classes = load_dataset(data_dir)
    samples_per_update = batch * grad_accum
    if len(paths) < samples_per_update:
        raise ValueError(
            f"dataset has {len(paths)} images < batch*grad_accum "
            f"{samples_per_update}; lower --batch/--grad-accum"
        )

    params = _dense_f32(load_params(mf, torch.float32, hparams=hp, device=dev))
    if len(classes) != hp.num_classes:
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

    updates_per_epoch = len(paths) // samples_per_update
    state = create_train_state(
        params,
        dict(
            lr=lr, weight_decay=weight_decay, schedule=schedule,
            total_steps=updates_per_epoch * epochs, warmup_steps=warmup_steps,
            clip_norm=clip_norm,
        ),
        trainable=("head", "head_dist") if freeze_backbone else None,
    )
    # the EMA starts as a copy of the initial params
    ema_params = _clone(params) if ema else None

    vpaths = vlabels = None
    if val_dir:
        vpaths, vlabels, vclasses = load_dataset(val_dir)
        if vclasses != classes:
            raise ValueError(f"val classes {vclasses} != train classes {classes}")

    # sibling file, as in the JAX package (the checkpoint directory holds
    # only the state)
    meta_path = os.path.abspath(ckpt_dir).rstrip("/") + ".meta.json" if ckpt_dir else None
    # everything that changes what a resumed run replays, under the JAX
    # package's keys (the unported options at their off values)
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
        "lora_alpha": lora_alpha or float(2 * lora),
        "moe": hp.num_experts,
        "moe_layers": list(hp.moe_layers),
        "moe_top_k": hp.moe_top_k,
        "moe_capacity": hp.moe_capacity,
        "distill": "",
        "distill_mode": "",
        "distill_alpha": 0.0,
        "distill_tau": 0.0,
    }
    if ckpt_dir and os.path.isdir(ckpt_dir) and os.listdir(ckpt_dir):
        # a checkpoint without its sibling meta cannot be validated
        if not os.path.exists(meta_path):
            raise ValueError(
                f"checkpoint at {ckpt_dir} has no {meta_path}; its "
                "batching cannot be validated — use a fresh --ckpt-dir"
            )
        with open(meta_path) as f:
            saved = json.load(f)
        # `epochs` may grow on resume unless the schedule has a horizon
        # (the cosine length derives from the total)
        strict = dict(run_meta)
        if schedule == "const":
            strict.pop("epochs")
        missing = [k for k in strict if k not in saved]
        if "tome" in missing and tome:
            # a meta that predates 'tome' was trained on the unmerged
            # graph; adopting r > 0 would change the objective
            raise ValueError(
                f"checkpoint at {ckpt_dir} predates --tome recording "
                "(trained unmerged); resuming with --tome would not "
                "replay the original run — drop --tome or use a fresh "
                "--ckpt-dir"
            )
        if "moe" in missing and hp.num_experts:
            raise ValueError(
                f"checkpoint at {ckpt_dir} predates --moe recording "
                "(trained dense); resuming with experts would not replay "
                "the original run — drop --moe or use a fresh --ckpt-dir"
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
        val = (_preprocess_all(vpaths, hp, decode_threads, dev), vlabels)

    start_epoch = state.step // updates_per_epoch
    ema_leaves = tree_leaves(ema_params) if ema else None
    param_leaves = tree_leaves(state.params)
    losses: List[float] = []
    update_ms: List[float] = []
    for epoch in range(start_epoch, epochs):
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
            if mix is not None:
                loss = train_step_mixup(
                    state, bx, by, mix[0], mix[1], hp, smooth=label_smoothing, tome=tome
                )
            elif grad_accum > 1:
                loss = train_step_accum(
                    state, bx, by, hp, grad_accum, smooth=label_smoothing, tome=tome
                )
            else:
                loss = train_step(state, bx, by, hp, smooth=label_smoothing, tome=tome)
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
            eval_params = ema_params if ema else state.params
            acc = evaluate(eval_params, hp, val[0], val[1], batch, tome=tome)
            msg += f", val top-1{' (ema)' if ema else ''} {acc:.3f}"
        log(msg)
        if ckpt_dir:
            save_train_state(ckpt_dir, state, ema_params)
            with open(meta_path, "w") as f:
                json.dump(run_meta, f)
    if len(update_ms) > 1:
        ms = float(np.mean(update_ms[1:]))
        log(
            f"finetune: {len(update_ms)} updates on {dev}, {ms:.2f} ms per "
            f"update after the first, {samples_per_update * 1000.0 / ms:.1f} "
            "training images/s"
        )
    final_params = ema_params if ema else state.params
    return final_params, hp, classes, losses


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


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().clone()
