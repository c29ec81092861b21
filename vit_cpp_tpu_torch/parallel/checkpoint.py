"""Training checkpoint / resume: torch.save on one device,
torch.distributed.checkpoint on a mesh.

Counterpart of vit_cpp_tpu/parallel/checkpoint.py (orbax there; the two
formats are not shared). One file, `train_state.pt` under the checkpoint
directory, holds the parameter tree, the AdamW and scheduler state, the
update count and the EMA tree. It is written to a temporary name and
renamed, so a run that dies mid-save leaves the previous checkpoint
whole. models/export.py stays the path from a finished run to a servable
model file.

    save_train_state(dir, state, ema)
    ema = restore_train_state(dir, state, ema_like)   # state filled in place

A state on a mesh (parallel/train.py::create_train_state(mesh=...)) is
saved with torch.distributed.checkpoint under `<dir>/sharded/`: every
parameter, AdamW moment and EMA leaf as a DTensor laid out as the run
holds it (its TP shard, and its FSDP shard), each rank writing its own
part; the update count, the moments' step counts, the optimizer's
parameter groups and the scheduler go beside it in `meta.pt`, written by
rank 0. A resume on the same mesh loads every rank's parts in place and
continues exactly. An unsharded run keeps the one-file format.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from vit_cpp_tpu_torch.parallel.train import TrainState, tree_leaves

FILE = "train_state.pt"
SHARDED = "sharded"


def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().to("cpu", copy=True)


def save_train_state(path: str, state: TrainState, ema: Optional[Any] = None) -> None:
    """Write `state` (and the EMA tree, if any) under directory `path`."""
    if state.mesh is not None:
        return _save_sharded(path, state, ema)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(
        {
            "params": _cpu_tree(state.params),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "ema": None if ema is None else _cpu_tree(ema),
        },
        tmp,
    )
    os.replace(tmp, target)


def restore_train_state(path: str, state: TrainState, ema: Optional[Any] = None):
    """Load a checkpoint written by save_train_state into `state` (its
    parameters are copied in place, so the optimizer keeps pointing at
    them) and into `ema` the same way. Returns `ema`."""
    if state.mesh is not None:
        return _restore_sharded(path, state, ema)
    if not os.path.exists(os.path.join(path, FILE)):
        raise ValueError(f"checkpoint at {path} holds no {FILE} (a run on a mesh writes "
                         f"{SHARDED}/): resume it with the same --mesh")
    saved = torch.load(os.path.join(path, FILE), map_location="cpu", weights_only=True)

    def fill(dst, src, what):
        dst_leaves, src_leaves = tree_leaves(dst), tree_leaves(src)
        if len(dst_leaves) != len(src_leaves):
            raise ValueError(
                f"checkpoint at {path} has {len(src_leaves)} {what} leaves, "
                f"the run has {len(dst_leaves)}"
            )
        with torch.no_grad():
            for d, s in zip(dst_leaves, src_leaves):
                if d.shape != s.shape:
                    raise ValueError(
                        f"checkpoint at {path}: {what} leaf of shape "
                        f"{tuple(s.shape)}, the run has {tuple(d.shape)}"
                    )
                d.copy_(s)

    fill(state.params, saved["params"], "parameter")
    if (ema is None) != (saved["ema"] is None):
        raise ValueError(f"checkpoint at {path}: EMA presence differs from the run's")
    if ema is not None:
        fill(ema, saved["ema"], "EMA")
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return ema


def _dtensor(t: torch.Tensor, spec, mesh):
    """`t` as a DTensor of the run's placement: an FSDP leaf already is
    one; a TP shard or a replicated leaf is wrapped (sharing storage)."""
    from torch.distributed.tensor import DTensor

    from vit_cpp_tpu_torch.parallel.sharding import as_dtensor

    return t if isinstance(t, DTensor) else as_dtensor(t, spec, mesh)


def _tensors(state: TrainState, ema) -> dict:
    """{key: DTensor} of every parameter, moment and EMA leaf."""
    from vit_cpp_tpu_torch.parallel.train import _spec_leaves

    specs = {id(p): s for p, s in zip(tree_leaves(state.params),
                                      _spec_leaves(state.specs))}
    leaves = tree_leaves(state.params)
    out = {f"param.{i}": _dtensor(p, specs[id(p)], state.mesh) for i, p in enumerate(leaves)}
    opt = state.optimizer.adamw.state
    for i, p in enumerate(state.optimizer.params):
        for k, v in opt.get(p, {}).items():
            if isinstance(v, torch.Tensor) and v.ndim:
                out[f"opt.{i}.{k}"] = _dtensor(v, specs[id(p)], state.mesh)
    if ema is not None:
        out.update({f"ema.{i}": _dtensor(e, specs[id(p)], state.mesh)
                    for i, (e, p) in enumerate(zip(tree_leaves(ema), leaves))})
    return out


def _save_sharded(path: str, state: TrainState, ema) -> None:
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    target = os.path.join(path, SHARDED)
    opt_sd = state.optimizer.state_dict()
    meta = {
        "step": state.step,
        "ema": ema is not None,
        "param_groups": opt_sd["adamw"]["param_groups"],
        "scheduler": opt_sd["scheduler"],
        # per parameter: its step count and the moments' keys and dtypes
        "moments": {i: {k: (v if not (isinstance(v, torch.Tensor) and v.ndim) else str(v.dtype))
                        for k, v in opt_sd["adamw"]["state"].get(i, {}).items()}
                    for i in range(len(state.optimizer.params))},
    }
    if dist.get_rank() == 0:
        os.makedirs(target, exist_ok=True)
        torch.save(meta, os.path.join(target, "meta.pt.tmp"))
        os.replace(os.path.join(target, "meta.pt.tmp"), os.path.join(target, "meta.pt"))
    dist.barrier()
    dcp.save(_tensors(state, ema), checkpoint_id=target)


def _restore_sharded(path: str, state: TrainState, ema):
    import torch.distributed.checkpoint as dcp

    target = os.path.join(path, SHARDED)
    if not os.path.exists(os.path.join(target, "meta.pt")):
        raise ValueError(f"checkpoint at {path} holds no {SHARDED}/ state (a run without "
                         "a mesh writes train_state.pt): resume it without --mesh")
    meta = torch.load(os.path.join(target, "meta.pt"), map_location="cpu", weights_only=False)
    if meta["ema"] != (ema is not None):
        raise ValueError(f"checkpoint at {path}: EMA presence differs from the run's")
    params = state.optimizer.params
    # allocate the moments in the run's layout, then load every part in place
    moments = {}
    for i, p in enumerate(params):
        for k, v in meta["moments"].get(i, {}).items():
            if isinstance(v, str):
                moments[(i, k)] = torch.zeros_like(p, dtype=getattr(torch, v.split(".")[-1]),
                                                   requires_grad=False)
    from vit_cpp_tpu_torch.parallel.train import _spec_leaves

    specs = {id(p): s for p, s in zip(tree_leaves(state.params), _spec_leaves(state.specs))}
    st = {k: v for k, v in _tensors(state, ema).items() if not k.startswith("opt.")}
    for (i, k), v in moments.items():
        st[f"opt.{i}.{k}"] = _dtensor(v, specs[id(params[i])], state.mesh)
    with torch.no_grad():
        dcp.load(st, checkpoint_id=target)
    opt_state = {}
    for i in range(len(params)):
        entry = {}
        for k, v in meta["moments"].get(i, {}).items():
            entry[k] = moments[(i, k)] if isinstance(v, str) else v
        if entry:
            opt_state[i] = entry
    state.optimizer.load_state_dict({
        "adamw": {"state": opt_state, "param_groups": meta["param_groups"]},
        "scheduler": meta["scheduler"],
    })
    state.step = int(meta["step"])
    return ema
