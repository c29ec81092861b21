"""Fine-tuning steps on one device or over a ('data', 'model') mesh.

Counterpart of vit_cpp_tpu/parallel/train.py: the classifier loss
through the training forward (fused attention whose backward is the
hand-written kernel, ops/flash_attention.py), an
AdamW update that reproduces the JAX package's optax chain, gradient
accumulation and mixup; the scene-text sequence loss (ViTSTR),
knowledge distillation from a frozen teacher, LoRA adapters
(models/lora.py) and quantization-aware training (`qat=`, quant/qat.py)
on every loss. PyTorch runs eagerly, so a step is plain Python over the
parameter tree; the parameters are updated in place.

The optimizer equals `optax.adamw(lr, weight_decay)` (b1 0.9, b2 0.999,
eps 1e-8, decay on every leaf) behind an optional
`optax.clip_by_global_norm`, with the learning rate of the first update
at the schedule's value for count 0 (0 under warmup), as optax evaluates
it. `mu_dtype="bf16"` stores the first moment in bf16 as
`optax.adamw(mu_dtype=jnp.bfloat16)` does (`AdamWBf16Mu`); f32 runs keep
torch.optim.AdamW.

On a mesh (parallel/mesh.py; `create_train_state(..., mesh=, fsdp=)`)
each rank holds the Megatron shards of the parameters (with `fsdp`,
DTensors sharded over "data" as well, all-gathered inside the forward)
and runs the rows `shard_batch` gives it. The optimizer state is laid out
like the parameters, leaf for leaf, since AdamW builds its moments from
them. Each loss returns this rank's share of the global batch's loss
(its mean over dp, or the masked sum over the global count of valid
positions, all-reduced over "data"), so the backward gives each rank its
share of the gradient: the optimizer sums the replicated leaves' shares
over "data" (FSDP leaves are reduce-scattered by their DTensor) and the
global-norm clip reduces the squared norms over the world, each leaf
counted once. `update` returns the global loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.models.vit import forward
from vit_cpp_tpu_torch.parallel.mesh import axis_group, axis_size, data_slice, sum_over
from vit_cpp_tpu_torch.quant.qat import fake_quant_params, inject_act_scales


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in key order (dicts nest)."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage), any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


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


class AdamWBf16Mu(torch.optim.Optimizer):
    """AdamW with its first moment stored in bf16, in optax's order
    (scale_by_adam(mu_dtype=bf16), add_decayed_weights, the learning
    rate), step for step:

        mu32 = (1 - b1) * g + bf16(bf16(b1) * mu)   (the JAX package's
               weakly typed b1 * mu is a bf16 product)
        nu   = (1 - b2) * g * g + b2 * nu
        u    = (mu32 / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        p   += -lr * (u + wd * p)
        mu   = bf16(mu32)

    The update reads the f32 sum; only the stored moment is rounded.
    Multi-tensor (torch._foreach_*) ops; `load_state_dict` keeps the
    moment in bf16 (torch.optim casts state to the parameter's dtype)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            b1, b2 = group["betas"]
            for p in ps:
                if not self.state[p]:
                    self.state[p].update(
                        step=0,
                        exp_avg=torch.zeros_like(p, dtype=torch.bfloat16),
                        exp_avg_sq=torch.zeros_like(p),
                    )
                self.state[p]["step"] += 1
            t = self.state[ps[0]]["step"]
            grads = [p.grad for p in ps]
            mus = [self.state[p]["exp_avg"] for p in ps]
            nus = [self.state[p]["exp_avg_sq"] for p in ps]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            decayed = torch._foreach_mul(mus, b1_bf16)  # bf16 products
            mu32 = torch._foreach_mul(grads, 1.0 - b1)
            for m32, d in zip(mu32, decayed):
                m32.add_(d.float())
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, g2)
            for m, m32 in zip(mus, mu32):
                m.copy_(m32)
            # optax's bias corrections: 1 - b^t in f32
            bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
            bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
            torch._foreach_div_(mu32, bc1)
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(mu32, den)
            if group["weight_decay"]:
                torch._foreach_add_(mu32, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_mul_(mu32, -group["lr"])
            torch._foreach_add_(ps, mu32)

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)


@dataclasses.dataclass
class Optimizer:
    """AdamW + learning-rate schedule + global-norm clipping over a list
    of parameters (the trainable leaves; frozen leaves are not in it)."""

    adamw: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    clip_norm: float = 0.0
    mesh: Any = None
    replicas: Optional[List[int]] = None  # per parameter: ranks holding a copy

    @property
    def params(self) -> List[torch.Tensor]:
        return self.adamw.param_groups[0]["params"]

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the gradients in each parameter's `.grad`; on a
        mesh, the ranks' shares are summed over "data" first."""
        if axis_size(self.mesh, "data") > 1:
            import torch.distributed as dist
            from torch.distributed.tensor import DTensor

            group = axis_group(self.mesh, "data")
            for p in self.params:  # FSDP DTensors were reduce-scattered
                if p.grad is not None and not isinstance(p, DTensor):
                    dist.all_reduce(p.grad, group=group)
        if self.clip_norm > 0:
            clip_by_global_norm([p.grad for p in self.params], self.clip_norm,
                                mesh=self.mesh, replicas=self.replicas)
        self.adamw.step()
        self.scheduler.step()

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["scheduler"])


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float, *, mesh=None,
                        replicas: Optional[List[int]] = None) -> None:
    """optax.clip_by_global_norm in place: when the global norm n is at
    least max_norm, g := (g / n) * max_norm. On a mesh each gradient is
    this rank's shard, held by `replicas[i]` ranks: the squared norms are
    summed over the world with each shard counted once."""
    grads = [local_tensor(g) for g in grads]
    if mesh is None:
        sq = sum((g.float() * g.float()).sum() for g in grads)
    else:
        import torch.distributed as dist

        sq = sum((g.float() * g.float()).sum() / n for g, n in zip(grads, replicas))
        dist.all_reduce(sq)
    norm = torch.sqrt(sq)
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
    mu_dtype: str = "f32",
    mesh=None,
    replicas: Optional[List[int]] = None,
) -> Optimizer:
    """AdamW over `params` with an optional cosine decay + linear warmup
    (`total_steps`: optimizer updates over the whole run) and global-norm
    clipping before the update (`clip_norm` > 0). `mu_dtype="bf16"` stores
    the first moment in bf16 (AdamWBf16Mu): one bf16 moment read and
    write per step instead of f32 ones."""
    factor = lr_factor(schedule, total_steps, warmup_steps)
    if mu_dtype not in ("f32", "bf16"):
        raise ValueError(f"mu_dtype must be f32|bf16, got {mu_dtype!r}")
    opt = torch.optim.AdamW if mu_dtype == "f32" else AdamWBf16Mu
    adamw = opt(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(adamw, factor)
    return Optimizer(adamw, scheduler, clip_norm, mesh, replicas)


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]
    optimizer: Optimizer
    step: int = 0
    mesh: Any = None
    specs: Optional[Dict[str, Any]] = None  # the placement of params on the mesh


def create_train_state(
    params: Dict[str, Any], optimizer_kw: Optional[Dict[str, Any]] = None,
    trainable=None, *, mesh=None, fsdp: bool = False,
) -> TrainState:
    """A TrainState over `params` (updated in place from now on). Every
    leaf trains unless `trainable` (top-level keys) names the ones that do;
    the others get requires_grad False, so they get neither an update nor
    weight decay (optax.set_to_zero in the JAX package).

    With a mesh the state holds this rank's copies of its shards
    (parallel/sharding.py::shard_params; `fsdp` shards every large dense
    leaf over "data" too, ZeRO-3), and AdamW's moments follow them leaf
    for leaf."""
    specs = None
    if mesh is not None:
        from vit_cpp_tpu_torch.parallel.sharding import placement_specs, shard_params

        specs = placement_specs(params, mesh, fsdp)
        params = shard_params({k: _copy(v) for k, v in params.items()}, mesh, fsdp,
                              specs=specs)
    train_leaves, replicas = [], []
    for key, sub in params.items():
        on = trainable is None or key in trainable
        spec_leaves = _spec_leaves(specs[key]) if specs is not None else None
        for i, leaf in enumerate(tree_leaves(sub)):
            leaf.requires_grad_(on)
            if on:
                train_leaves.append(leaf)
                if specs is not None:
                    from vit_cpp_tpu_torch.parallel.sharding import replicas as _replicas

                    replicas.append(_replicas(spec_leaves[i], mesh))
    optimizer = make_optimizer(train_leaves, **(optimizer_kw or {}), mesh=mesh,
                               replicas=replicas if mesh is not None else None)
    return TrainState(params, optimizer, mesh=mesh, specs=specs)


def create_lora_train_state(
    trainable: Dict[str, Any], optimizer_kw: Optional[Dict[str, Any]] = None, *, mesh=None,
) -> TrainState:
    """The state of a LoRA trainable tree (models/lora.py::lora_trainable)
    on a mesh: adapters and head are tiny, so every leaf replicates (the
    frozen base keeps its TP shards, parallel/sharding.py::shard_params,
    and merge_lora slices each adapter product to them)."""
    from vit_cpp_tpu_torch.parallel.mesh import axis_size as size

    trainable = {k: _copy(v) for k, v in trainable.items()}
    leaves = tree_leaves(trainable)
    for leaf in leaves:
        leaf.requires_grad_(True)
    world = size(mesh, "data") * size(mesh, "model")
    optimizer = make_optimizer(leaves, **(optimizer_kw or {}), mesh=mesh,
                               replicas=[world] * len(leaves))
    specs = _map(lambda t: None if t is None else (), trainable)
    return TrainState(trainable, optimizer, mesh=mesh, specs=specs)


def shard_batch(images: torch.Tensor, labels: torch.Tensor, mesh):
    """This rank's rows of a batch split over "data" (dp divides it)."""
    return data_slice(images, mesh), data_slice(labels, mesh)


def _copy(tree):
    """A copy the state owns: its leaves are updated in place."""
    return _map(lambda t: None if t is None else t.detach().clone(), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _spec_leaves(spec_tree) -> list:
    """The specs of tree_leaves' tensors, in the same order."""
    if isinstance(spec_tree, dict):
        return [s for k in spec_tree for s in _spec_leaves(spec_tree[k])]
    return [] if spec_tree is None else [spec_tree]


# The rematerialisation policy of every training loss's forward
# (models/vit.py::forward's `remat`), as the JAX package's losses run it
TRAIN_REMAT = "dots+attn"

# V-MoE auxiliary-loss coefficients (vit_cpp_tpu/parallel/train.py:71-75):
# the Switch balance loss (Fedus et al. 2022) and the ST-MoE router z-loss
MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3


def qat_params(params, qat: str, qat_scales=None, mesh=None, hp=None):
    """The tree the QAT forward runs: the served kernels fake-quantized
    (straight-through), the frozen static activation scales beside them
    with --qat-act static. The dense tree when `qat` is empty. On a mesh
    the FSDP leaves are gathered first and the row-parallel shards take
    their channel absmax over "model"."""
    if not qat:
        return params
    if mesh is not None:
        from vit_cpp_tpu_torch.parallel.sharding import local_params

        params = local_params(params, mesh)
    params = fake_quant_params(params, qat, mesh, hp)
    return params if qat_scales is None else inject_act_scales(params, qat_scales)


def _share(loss: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of the global batch's mean: its mean over dp."""
    dp = axis_size(mesh, "data")
    return loss if dp == 1 else loss / dp


def _logits(params, images, hp: VitHParams, tome: int = 0, qat: str = "", qat_scales=None,
            mesh=None):
    """(the training forward's logits, under TRAIN_REMAT, the V-MoE auxiliary term: 0.01
    load_balance + 1e-3 router_z averaged over the MoE layers, 0 for a
    dense model). On a mesh, the logits of this rank's rows, and the
    auxiliary term of its rows (the load balance of each rank's tokens)."""
    out = forward(qat_params(params, qat, qat_scales, mesh, hp), images, hp,
                  attn_impl="pallas-train", mm_impl="qat" if qat else "xla", tome=tome,
                  moe_aux=bool(hp.num_experts), mesh=mesh, remat=TRAIN_REMAT)
    if hp.num_experts:
        out, aux = out
        return out, MOE_LB_COEF * aux["load_balance"] + MOE_Z_COEF * aux["router_z"]
    return out, 0.0


def _nll(logp: torch.Tensor, labels: torch.Tensor, smooth: float) -> torch.Tensor:
    nll = -torch.gather(logp, 1, labels[:, None].long())
    if smooth:
        # label smoothing: target (1-eps) on the true class, eps spread
        # uniformly: CE = (1-eps)*nll + eps * mean_c(-logp_c)
        uniform = -logp.mean(dim=-1, keepdim=True)
        nll = (1.0 - smooth) * nll + smooth * uniform
    return nll.mean()


def cross_entropy_loss(
    params, images, labels, hp: VitHParams, smooth: float = 0.0, tome: int = 0,
    qat: str = "", qat_scales=None, mesh=None,
) -> torch.Tensor:
    """Mean cross entropy of the training forward (f32 log-softmax), plus
    the router's auxiliary losses for a V-MoE model; `tome=r` trains
    through ToMe merging (the matching gets no gradient, the attention
    kernels take the merged-token sizes both ways); `qat=FMT` through
    FMT's serving quantization, with the static activation scales
    `qat_scales` (quant/qat.py::measure_act_scales) when given. On a mesh,
    this rank's share of the global mean."""
    logits, moe_term = _logits(params, images, hp, tome, qat, qat_scales, mesh)
    return _share(_nll(torch.log_softmax(logits.float(), dim=-1), labels, smooth) + moe_term,
                  mesh)


def vitstr_cross_entropy_loss(
    params, images, targets, hp: VitHParams, qat: str = "", qat_scales=None, mesh=None,
) -> torch.Tensor:
    """Scene-text sequence loss: targets (B, seq_len) int, -1 masked
    (position 0, [GO], and everything after the stop token); the mean
    over the valid positions. On a mesh, this rank's masked sum over the
    global count of valid positions, all-reduced over "data"."""
    logits, _ = _logits(params, images, hp, qat=qat, qat_scales=qat_scales, mesh=mesh)
    logp = torch.log_softmax(logits.float(), dim=-1)  # (B, S, V)
    mask = targets >= 0
    safe = torch.where(mask, targets, torch.zeros_like(targets)).long()
    nll = -torch.gather(logp, 2, safe[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(sum_over(mask.sum(), mesh, "data"), min=1)


def distill_cross_entropy_loss(
    params, teacher_params, images, labels, hp: VitHParams, teacher_hp: VitHParams,
    alpha: float, tau: float, mode: str, smooth: float = 0.0, tome: int = 0,
    qat: str = "", qat_scales=None, mesh=None,
) -> torch.Tensor:
    """Knowledge distillation (Hinton et al. 2015): the student trains
    against the labels and a frozen teacher's logits on the same batch,

      soft: (1-alpha)*CE(s, y) + alpha * tau^2 * KL(T(t/tau) || T(s/tau))
      hard: (1-alpha)*CE(s, y) + alpha * CE(s, argmax(t))

    (the KL up to the teacher's entropy). The teacher runs the plain
    inference graph (composed attention, no gradient); the student the
    training forward, with ToMe and QAT as cross_entropy_loss. On a mesh
    the teacher is TP-sharded like the student, and the loss is this
    rank's share."""
    if mode not in ("soft", "hard"):
        raise ValueError(f"distill mode must be soft|hard, got {mode!r}")
    with torch.no_grad():
        t_logits = forward(teacher_params, images, teacher_hp, mesh=mesh).float()
    logits, _ = _logits(params, images, hp, tome, qat, qat_scales, mesh)
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    ce = _nll(logp, labels, smooth)
    if mode == "soft":
        t_prob = torch.softmax(t_logits / tau, dim=-1)
        s_logp = torch.log_softmax(logits / tau, dim=-1)
        kd = -(tau * tau) * (t_prob * s_logp).sum(dim=-1).mean()
    else:
        kd = -torch.gather(logp, 1, t_logits.argmax(dim=-1)[:, None]).mean()
    return _share((1.0 - alpha) * ce + alpha * kd, mesh)


def lora_cross_entropy_loss(
    trainable, base_params, images, labels, hp: VitHParams, alpha: float,
    smooth: float = 0.0, tome: int = 0, qat: str = "", qat_scales=None, seq: bool = False,
    mesh=None,
) -> torch.Tensor:
    """LoRA loss: the rank-r adapters and the head merged into the frozen
    base (models/lora.py::merge_lora), then the classifier loss, or the
    sequence loss with `seq` (ViTSTR targets). QAT applies to the merged
    kernels, the weights a fold-then-quantize export serves."""
    from vit_cpp_tpu_torch.models.lora import merge_lora

    merged = merge_lora(base_params, trainable, alpha, mesh)
    if seq:
        return vitstr_cross_entropy_loss(merged, images, labels, hp, qat, qat_scales, mesh)
    return cross_entropy_loss(merged, images, labels, hp, smooth, tome, qat, qat_scales, mesh)


def _mixed_cross_entropy_loss(
    params, images, labels, labels2, lam, hp: VitHParams, smooth: float = 0.0,
    tome: int = 0, qat: str = "", qat_scales=None, mesh=None,
) -> torch.Tensor:
    """Mixup loss: one forward on the pre-mixed batch, CE against both
    label sets weighted by the mixing coefficient."""
    logits, moe_term = _logits(params, images, hp, tome, qat, qat_scales, mesh)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _share(lam * _nll(logp, labels, smooth) + (1.0 - lam) * _nll(logp, labels2, smooth)
                  + moe_term, mesh)


def update(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """Backpropagate `loss` (on a mesh, this rank's share), step the
    optimizer; returns the (global) loss."""
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return sum_over(loss.detach(), state.mesh, "data")


def train_step(
    state: TrainState, images, labels, hp: VitHParams, smooth: float = 0.0, tome: int = 0,
    qat: str = "", qat_scales=None,
) -> torch.Tensor:
    """One update; returns the loss of the batch (before the update). On a
    mesh `images` and `labels` are this rank's rows (shard_batch)."""
    return update(state, cross_entropy_loss(state.params, images, labels, hp, smooth, tome,
                                             qat, qat_scales, state.mesh))


def train_step_lora(
    state: TrainState, base_params, images, labels, hp: VitHParams, alpha: float,
    smooth: float = 0.0, tome: int = 0, qat: str = "", qat_scales=None, seq: bool = False,
) -> torch.Tensor:
    """One LoRA update: state.params is the {lora, head(, head_dist)}
    tree (models/lora.py::lora_trainable); base_params stays frozen."""
    return update(state, lora_cross_entropy_loss(
        state.params, base_params, images, labels, hp, alpha, smooth, tome, qat, qat_scales,
        seq, state.mesh))


def train_step_mixup(
    state: TrainState, images, labels, labels2, lam, hp: VitHParams,
    smooth: float = 0.0, tome: int = 0, qat: str = "", qat_scales=None,
) -> torch.Tensor:
    """One update on a mixup batch (ops/augment.mixup_batch): images are
    already mixed; `labels2 = labels[perm]`."""
    return update(state, _mixed_cross_entropy_loss(
        state.params, images, labels, labels2, lam, hp, smooth, tome, qat, qat_scales,
        state.mesh))


def train_step_accum(
    state: TrainState, images, labels, hp: VitHParams, accum: int,
    smooth: float = 0.0, tome: int = 0, qat: str = "", qat_scales=None, seq: bool = False,
) -> torch.Tensor:
    """One update from `accum` sequential micro-batches of (accum * B, ...)
    images: each runs its own forward and backward, so peak memory is one
    micro-batch's activations. Micro-batches weigh by their targets, as
    in the JAX package: every classifier micro-batch has B (1/accum
    each, the update of the big batch); with `seq` ((B, seq_len) ViTSTR
    targets) each weighs by its valid positions, which gives the masked
    mean over the whole batch; on a mesh the counts are the global ones,
    all-reduced over "data"."""
    micro = images.shape[0] // accum
    if micro * accum != images.shape[0]:
        raise ValueError(f"batch {images.shape[0]} is not a multiple of accum {accum}")
    state.optimizer.zero_grad()
    mesh = state.mesh
    loss_sum = torch.zeros((), device=images.device)
    if seq:
        counts = [max(int(sum_over((labels[i * micro:(i + 1) * micro] >= 0).sum(), mesh,
                                   "data")), 1)
                  for i in range(accum)]
        weights = [c / sum(counts) for c in counts]
    for i in range(accum):
        sl = slice(i * micro, (i + 1) * micro)
        if seq:
            loss = vitstr_cross_entropy_loss(state.params, images[sl], labels[sl], hp, qat,
                                             qat_scales, mesh) * weights[i]
            loss.backward()
        else:
            loss = cross_entropy_loss(state.params, images[sl], labels[sl], hp, smooth, tome,
                                      qat, qat_scales, mesh)
            (loss / accum).backward()
        loss_sum += loss.detach()
    state.optimizer.step()
    state.step += 1
    loss_sum = sum_over(loss_sum, mesh, "data")
    return loss_sum if seq else loss_sum / accum
