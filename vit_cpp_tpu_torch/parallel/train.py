"""Fine-tuning step on one device.

Counterpart of vit_cpp_tpu/parallel/train.py for a single device (no
mesh): the classifier loss through the training forward (fused attention
whose backward is the hand-written kernel, ops/flash_attention.py), an
AdamW update that reproduces the JAX package's optax chain, gradient
accumulation and mixup. PyTorch runs eagerly, so a step is plain Python
over the parameter tree; the parameters are updated in place.

The optimizer equals `optax.adamw(lr, weight_decay)` (b1 0.9, b2 0.999,
eps 1e-8, decay on every leaf) behind an optional
`optax.clip_by_global_norm`, with the learning rate of the first update
at the schedule's value for count 0 (0 under warmup), as optax evaluates
it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.models.vit import forward


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in key order (dicts nest)."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def lr_factor(schedule: str, total_steps: int, warmup_steps: int):
    """Update index t (from 0) -> multiplier of the peak learning rate, as
    optax's linear_schedule(0, lr, warmup) (const) and
    warmup_cosine_decay_schedule(0, lr, warmup, total) (cosine) give it."""
    if schedule == "const":
        if not warmup_steps:
            return lambda t: 1.0
        return lambda t: min(t, warmup_steps) / warmup_steps
    if schedule != "cosine":
        raise ValueError(f"schedule must be const|cosine, got {schedule!r}")
    if total_steps <= 0:
        raise ValueError("schedule='cosine' needs total_steps > 0")
    decay = total_steps - warmup_steps
    if decay <= 0:
        raise ValueError(
            f"cosine decay needs total_steps {total_steps} > warmup_steps {warmup_steps}"
        )

    def factor(t: int) -> float:
        if t < warmup_steps:
            return t / warmup_steps
        return 0.5 * (1.0 + math.cos(math.pi * min(t - warmup_steps, decay) / decay))

    return factor


@dataclasses.dataclass
class Optimizer:
    """AdamW + learning-rate schedule + global-norm clipping over a list
    of parameters (the trainable leaves; frozen leaves are not in it)."""

    adamw: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    clip_norm: float = 0.0

    @property
    def params(self) -> List[torch.Tensor]:
        return self.adamw.param_groups[0]["params"]

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the gradients in each parameter's `.grad`."""
        if self.clip_norm > 0:
            clip_by_global_norm([p.grad for p in self.params], self.clip_norm)
        self.adamw.step()
        self.scheduler.step()

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["scheduler"])


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: when the global norm n is at
    least max_norm, g := (g / n) * max_norm."""
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    if norm < max_norm:
        return
    for g in grads:
        g.copy_((g / norm.to(g.dtype)) * max_norm)


def make_optimizer(
    params: List[torch.Tensor],
    lr: float = 1e-4,
    weight_decay: float = 0.05,
    schedule: str = "const",
    total_steps: int = 0,
    warmup_steps: int = 0,
    clip_norm: float = 0.0,
) -> Optimizer:
    """AdamW over `params` with an optional cosine decay + linear warmup
    (`total_steps`: optimizer updates over the whole run) and global-norm
    clipping before the update (`clip_norm` > 0)."""
    factor = lr_factor(schedule, total_steps, warmup_steps)
    adamw = torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )
    scheduler = torch.optim.lr_scheduler.LambdaLR(adamw, factor)
    return Optimizer(adamw, scheduler, clip_norm)


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]
    optimizer: Optimizer
    step: int = 0


def create_train_state(
    params: Dict[str, Any], optimizer_kw: Optional[Dict[str, Any]] = None,
    trainable=None,
) -> TrainState:
    """A TrainState over `params` (updated in place from now on). Every
    leaf trains unless `trainable` (top-level keys) names the ones that do;
    the others get requires_grad False, so they get neither an update nor
    weight decay (optax.set_to_zero in the JAX package)."""
    train_leaves = []
    for key, sub in params.items():
        on = trainable is None or key in trainable
        for leaf in tree_leaves(sub):
            leaf.requires_grad_(on)
            if on:
                train_leaves.append(leaf)
    return TrainState(params, make_optimizer(train_leaves, **(optimizer_kw or {})))


def _log_probs(params, images, hp: VitHParams) -> torch.Tensor:
    logits = forward(params, images, hp, attn_impl="pallas-train")
    return torch.log_softmax(logits.float(), dim=-1)


def _nll(logp: torch.Tensor, labels: torch.Tensor, smooth: float) -> torch.Tensor:
    nll = -torch.gather(logp, 1, labels[:, None].long())
    if smooth:
        # label smoothing: target (1-eps) on the true class, eps spread
        # uniformly: CE = (1-eps)*nll + eps * mean_c(-logp_c)
        uniform = -logp.mean(dim=-1, keepdim=True)
        nll = (1.0 - smooth) * nll + smooth * uniform
    return nll.mean()


def cross_entropy_loss(
    params, images, labels, hp: VitHParams, smooth: float = 0.0
) -> torch.Tensor:
    """Mean cross entropy of the training forward (f32 log-softmax)."""
    return _nll(_log_probs(params, images, hp), labels, smooth)


def _mixed_cross_entropy_loss(
    params, images, labels, labels2, lam, hp: VitHParams, smooth: float = 0.0
) -> torch.Tensor:
    """Mixup loss: one forward on the pre-mixed batch, CE against both
    label sets weighted by the mixing coefficient."""
    logp = _log_probs(params, images, hp)
    return lam * _nll(logp, labels, smooth) + (1.0 - lam) * _nll(logp, labels2, smooth)


def _update(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def train_step(
    state: TrainState, images, labels, hp: VitHParams, smooth: float = 0.0
) -> torch.Tensor:
    """One update; returns the loss of the batch (before the update)."""
    return _update(state, cross_entropy_loss(state.params, images, labels, hp, smooth))


def train_step_mixup(
    state: TrainState, images, labels, labels2, lam, hp: VitHParams,
    smooth: float = 0.0,
) -> torch.Tensor:
    """One update on a mixup batch (ops/augment.mixup_batch): images are
    already mixed; `labels2 = labels[perm]`."""
    return _update(
        state, _mixed_cross_entropy_loss(state.params, images, labels, labels2, lam, hp, smooth)
    )


def train_step_accum(
    state: TrainState, images, labels, hp: VitHParams, accum: int,
    smooth: float = 0.0,
) -> torch.Tensor:
    """One update from `accum` sequential micro-batches of (accum * B, ...)
    images: each runs its own forward and backward, so peak memory is one
    micro-batch's activations. Every micro-batch has B targets, so the JAX
    package's token weighting gives each the weight 1/accum, and the update
    equals the one on the big batch."""
    micro = images.shape[0] // accum
    if micro * accum != images.shape[0]:
        raise ValueError(f"batch {images.shape[0]} is not a multiple of accum {accum}")
    state.optimizer.zero_grad()
    loss_sum = torch.zeros((), device=images.device)
    for i in range(accum):
        sl = slice(i * micro, (i + 1) * micro)
        loss = cross_entropy_loss(state.params, images[sl], labels[sl], hp, smooth)
        (loss / accum).backward()
        loss_sum += loss.detach()
    state.optimizer.step()
    state.step += 1
    return loss_sum / accum
