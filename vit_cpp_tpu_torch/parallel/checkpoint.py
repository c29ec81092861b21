"""Training checkpoint / resume with torch.save.

Counterpart of vit_cpp_tpu/parallel/checkpoint.py (orbax there; the two
formats are not shared). One file, `train_state.pt` under the checkpoint
directory, holds the parameter tree, the AdamW and scheduler state, the
update count and the EMA tree. It is written to a temporary name and
renamed, so a run that dies mid-save leaves the previous checkpoint
whole. models/export.py stays the path from a finished run to a servable
model file.

    save_train_state(dir, state, ema)
    ema = restore_train_state(dir, state, ema_like)   # state filled in place
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from vit_cpp_tpu_torch.parallel.train import TrainState, tree_leaves

FILE = "train_state.pt"


def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().to("cpu", copy=True)


def save_train_state(path: str, state: TrainState, ema: Optional[Any] = None) -> None:
    """Write `state` (and the EMA tree, if any) under directory `path`."""
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
