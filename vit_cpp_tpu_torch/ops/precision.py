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

`highest_product(a, b, equation)` is a product that the forward always
wants in exact f32 (the ToMe similarity, the V-MoE router), whatever the
engine's precision. Eagerly it runs inside matmul_precision("highest").
An exported program (aot.py) keeps no flags, so under `torch.export` the
product is recorded as one operator,
`torch.ops.vit_cpp_tpu_torch.highest_product`, which sets them when the
loaded program runs.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from vit_cpp_tpu_torch._build import operator

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


def _product(a: torch.Tensor, b: torch.Tensor, equation: str) -> torch.Tensor:
    with matmul_precision("highest"):
        return torch.einsum(equation, a, b) if equation else torch.matmul(a, b)


def highest_product(a: torch.Tensor, b: torch.Tensor, equation: str = "") -> torch.Tensor:
    """torch.matmul(a, b), or torch.einsum(equation, a, b), with TF32 off."""
    if torch.compiler.is_exporting():
        return _HIGHEST_PRODUCT(a, b, equation)
    return _product(a, b, equation)


_HIGHEST_PRODUCT = operator(
    "highest_product(Tensor a, Tensor b, str equation) -> Tensor",
    cpu=_product, cuda=_product,
    fake=lambda a, b, equation: torch.einsum(equation, a, b) if equation else torch.matmul(a, b),
)
