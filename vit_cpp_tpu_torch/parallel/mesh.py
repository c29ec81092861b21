"""The ('data', 'model') device mesh over torch.distributed, and the
collectives that tensor parallelism runs on it.

Counterpart of vit_cpp_tpu/parallel/mesh.py. JAX has one controller that
sees every device; PyTorch runs one process per device, so here the
devices available are the ranks of the world that a launcher started
(`python -m torch.distributed.run --nproc-per-node N ...`):

- axis "data": the batch is split over it, replicated weights are
  averaged over it in training, outputs are all-gathered over it;
- axis "model": Megatron tensor parallelism over attention heads and MLP
  features. Tokens are replicated over it inside a data group, so each
  column-parallel linear (qkv, fc1, the head) runs on its output shard
  and each row-parallel one (proj, fc2) on its input shard, with an
  explicit all-reduce after it (`reduce_from_model`).

In training the two sides of every tensor-parallel region are the
differentiable pair f / g: `copy_to_model` is the identity forward and an
all-reduce backward (a column-parallel input), `reduce_from_model` an
all-reduce forward and the identity backward (a row-parallel output).
`torch.distributed.nn.functional.all_reduce` is not g: its backward is an
all-reduce too, which would multiply every gradient by tp.

Each rank runs on `cuda:{LOCAL_RANK}` with NCCL, or on the CPU with gloo.
Without a launcher the world is one rank, and a 1x1 mesh starts its own
1-rank group. Every group has a fixed timeout (`TIMEOUT_S`, 600 s), so
a rank that dies makes the others' next collective fail instead of
hanging. Nothing falls back: a failed rank fails the run.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vit_cpp_tpu_torch._build import operator

AXES = ("data", "model")
TIMEOUT_S = 600.0


def available_ranks() -> int:
    """The devices a mesh can use: the ranks of the world (one process
    per device), 1 without a launcher."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def launched() -> bool:
    """True under a torch.distributed launcher (torchrun sets WORLD_SIZE)."""
    return "WORLD_SIZE" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device) -> torch.device:
    """This rank's device: `cuda` becomes cuda:{LOCAL_RANK}, a CPU stays."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def init_world(device_type: str) -> None:
    """Start the default process group once per process: NCCL for CUDA
    ranks, gloo for CPU ones; env:// under a launcher, else a 1-rank group
    over an in-process store."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    timeout = timedelta(seconds=TIMEOUT_S)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False; "
                "pass --device cpu to run the ranks on the CPU (gloo)"
            )
        torch.cuda.set_device(local_rank())
    if launched():
        dist.init_process_group(backend, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    *,
    device_type: str = "cpu",
):
    """Build a ('data', 'model') DeviceMesh over the ranks of the world.

    Defaults as in the JAX package: every device, all data-parallel
    (tp=1). `devices` lists the ranks to use (default: the world). The
    mesh covers the whole world: a launcher starts exactly dp * tp ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    if devices is None:
        devices = list(range(available_ranks()))
    n = n_devices if n_devices is not None else len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, only {len(devices)} available")
    devices = list(devices)[:n]
    if tp is None and dp is None:
        dp, tp = n, 1
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != n_devices({n})")
    init_world(device_type)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices on a world of {world} ranks: launch "
            f"--nproc-per-node {n}"
        )
    grid = torch.tensor(devices, dtype=torch.int64).reshape(dp, tp)
    mesh = DeviceMesh(device_type, grid, mesh_dim_names=AXES)
    _register(mesh)
    return mesh


def launcher_hint(tool: str, n: int, what: str = "--mesh") -> str:
    """The stderr line that names the launcher a multi-rank mesh needs."""
    return (
        f"{what} needs one process per device: python -m torch.distributed.run "
        f"--nproc-per-node {n} -m vit_cpp_tpu_torch.cli.{tool} ..."
    )


def parse_mesh(spec: str):
    """'DPxTP' -> (dp, tp); ValueError for anything else."""
    dp, tp = (int(x) for x in spec.lower().split("x"))
    return dp, tp


# -- axis accessors (a None mesh is one device) --------------------------------


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def is_leader() -> bool:
    """Rank 0 of the world (or no world): the rank that prints and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


# -- collectives as operators ------------------------------------------------
#
# Every collective of a forward runs through one of two PyTorch operators,
# `torch.ops.vit_cpp_tpu_torch.all_reduce_over(x, axis, size, op)` and
# `.all_gather_over(x, axis, size, dim)`. Each resolves its process group
# when it runs, from the mesh that this process built with `make_mesh`:
# the group of this rank along `axis`, whose size is `size`. Under a
# launcher every mesh covers the whole world, so (axis, size) names one
# group. `torch.export` keeps each call as one node of a program (aot.py),
# and a program loaded in a fresh process binds to the mesh that process
# builds. With no such mesh the operator raises.

_GROUPS: Dict[Tuple[str, int], Any] = {}
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _register(mesh) -> None:
    for axis in AXES:
        _GROUPS[(axis, axis_size(mesh, axis))] = mesh.get_group(axis)


def _group(axis: str, size: int):
    group = _GROUPS.get((axis, size))
    if group is None:
        raise RuntimeError(
            f"no mesh with a {axis!r} axis of {size} ranks was built in this process: "
            "a sharded program's collectives run on the mesh of "
            "vit_cpp_tpu_torch.parallel.mesh.make_mesh"
        )
    return group


def _all_reduce_impl(x, axis, size, op):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=_REDUCE_OPS[op], group=_group(axis, size))
    return y


def _all_gather_impl(x, axis, size, dim):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=_group(axis, size))
    return torch.cat(parts, dim=dim)


def _all_gather_fake(x, axis, size, dim):
    shape = list(x.shape)
    shape[dim] *= size
    return x.new_empty(shape)


_ALL_REDUCE = operator(
    "all_reduce_over(Tensor x, str axis, int size, str op) -> Tensor",
    cpu=_all_reduce_impl, cuda=_all_reduce_impl,
    fake=lambda x, axis, size, op: x.new_empty(x.shape),
)
_ALL_GATHER = operator(
    "all_gather_over(Tensor x, str axis, int size, int dim) -> Tensor",
    cpu=_all_gather_impl, cuda=_all_gather_impl, fake=_all_gather_fake,
)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToModel(torch.autograd.Function):
    """f: identity forward, all-reduce (sum) backward over "model"."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ALL_REDUCE(g, "model", ctx.size, "sum"), None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce (sum) forward, identity backward over "model"."""

    @staticmethod
    def forward(ctx, x, size):
        return _ALL_REDUCE(x, "model", size, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along the last dim forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, size, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        return _ALL_GATHER(x, "model", size, -1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.width, ctx.width), None, None


class _MeanOverData(torch.autograd.Function):
    """The mean over "data" forward, the mean of the gradients backward:
    a term that every data rank computes from the global batch, added to
    each rank's share of the loss (parallel/train.py), gets each rank's
    share of its gradient."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return _ALL_REDUCE(x, "data", size, "sum") / size

    @staticmethod
    def backward(ctx, g):
        return _ALL_REDUCE(g, "data", ctx.size, "sum") / ctx.size, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    tp = axis_size(mesh, "model")
    if tp == 1 or not _needs_grad(x):
        return x
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    tp = axis_size(mesh, "model")
    if tp == 1:
        return x
    if _needs_grad(x):
        return _ReduceFromModel.apply(x, tp)
    return _ALL_REDUCE(x, "model", tp, "sum")


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """All-gather over "model" along the last dim (differentiable), or
    along `dim` with no gradient (attention maps' heads)."""
    tp = axis_size(mesh, "model")
    if tp == 1:
        return x
    if _needs_grad(x):
        if dim != -1:
            raise ValueError("gather_from_model differentiates along the last dim only")
        return _GatherFromModel.apply(x, tp, axis_rank(mesh, "model"))
    return _ALL_GATHER(x, "model", tp, dim)


def mean_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over "data" of a per-rank batch statistic (differentiable,
    _MeanOverData)."""
    dp = axis_size(mesh, "data")
    if dp == 1:
        return x
    if _needs_grad(x):
        return _MeanOverData.apply(x, dp)
    return _ALL_REDUCE(x, "data", dp, "sum") / dp


def max_over(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Elementwise maximum over an axis (no gradient): the global absmax
    of a K-sharded activation, a calibration site's maximum."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _ALL_REDUCE(x.detach(), axis, n, "max")


def sum_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over an axis with no gradient (int32 accumulators, counts)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _ALL_REDUCE(x.detach(), axis, n, "sum")


def gather_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-gather the per-rank batch rows over "data" (dim 0, no
    gradient): every rank returns the whole batch, as np.asarray does on a
    JAX array sharded over the batch."""
    n = axis_size(mesh, "data")
    if n == 1:
        return x
    return _ALL_GATHER(x.detach(), "data", n, 0)


def data_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a batch split over "data" (B % dp == 0)."""
    n = axis_size(mesh, "data")
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide the mesh data axis (dp={n})")
    rows = x.shape[0] // n
    return x[axis_rank(mesh, "data") * rows:(axis_rank(mesh, "data") + 1) * rows]
