"""Per-engine f32 matmul precision on a process-global switch.

The JAX engine picks its matmul precision per jitted program
(`jax.default_matmul_precision`, vit_cpp_tpu/engine.py:181-185): "highest"
(exact f32) for the f32 parity path, "default" for bf16 serving. PyTorch
has no per-call precision: whether cuBLAS and cuDNN may round f32 operands
to TF32 is one process-wide pair of flags
(`torch.backends.cuda.matmul.allow_tf32`, `torch.backends.cudnn.allow_tf32`),
read on the host when an operation is dispatched.

`matmul_precision(mode)` sets both flags for the work dispatched inside it
and restores the caller's values after. One re-entrant lock serialises
every such region, so two engines of different precision on two threads
(a daemon and a CLI engine, an f32 and a bf16 engine) never dispatch with
each other's setting, and code outside any region sees the process's own
setting once the region ends. The lock covers the host's dispatch only:
the launched kernels run on the card after it is released, each with the
math mode it was dispatched with.

    "highest"  TF32 off: f32 products in f32 (the parity rung)
    "high"     TF32 on
    "default"  TF32 on: the card's nearest counterpart of JAX's single
               reduced-precision pass (bf16 engines; their own products
               are bf16 and do not read the flags)
"""

from __future__ import annotations

import contextlib
import threading

import torch

PRECISIONS = {"highest": False, "high": True, "default": True}

_lock = threading.RLock()


@contextlib.contextmanager
def matmul_precision(mode: str):
    """Dispatch the body's f32 matmuls and convolutions with TF32 off
    ("highest") or on ("high", "default"); the flags are restored after."""
    if mode not in PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {tuple(PRECISIONS)}, got {mode!r}")
    tf32 = PRECISIONS[mode]
    with _lock:
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
