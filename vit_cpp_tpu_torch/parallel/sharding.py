"""Partition specs for the ViT parameter tree, and their placement.

Counterpart of vit_cpp_tpu/parallel/sharding.py. A spec is a plain tuple
with one entry per dimension, "data", "model" or None (JAX's
PartitionSpec; () replicates), and the spec trees equal the JAX
package's entry for entry:

- qkv / fc1 kernels are column-parallel (output features over "model"),
  proj / fc2 row-parallel (input features over "model"); embeddings,
  norms, the row-parallel biases, SigLIP's attention pooling and the
  V-MoE router replicate; the classifier head(s) are column-parallel over
  classes; V-MoE expert kernels shard the expert axis;
- QuantLinear and Int8Linear nodes take the dense kernel's spec for their
  codes (and block scales / mins); an Int8Linear's per-output-channel
  scale shards only under column parallelism, a static act_scale
  replicates; folded norms (None leaves) keep None;
- `fsdp_pspecs` adds "data" to the largest free dimension of every dense
  leaf of two or more dimensions that dp divides (ZeRO-3).

`shard_params` places a full tree on this rank: each leaf becomes its
local shard, a plain contiguous tensor (the kernel wrappers need
contiguous codes), or under FSDP a DTensor over the mesh whose local part
is that (every leaf of an FSDP tree is one, the replicated ones too, so
that the optimizer's multi-tensor kernels see one kind of tensor). The
fused qkv's output columns are laid out (3, nh, hd), so its "model"
split takes the nh axis of every column tensor (codes, scales, mins,
bias): rank r holds heads [r*nh/tp, (r+1)*nh/tp) of q, k and v, which
the attention kernel reads as a (B, T, 3h/tp) qkv. A leaf whose
dimension does not divide its axes is replicated with the JAX package's
warning; a QuantLinear or Int8Linear node replicates as a whole when any
of its tensors does not divide (a row-parallel Q8_0/Q4/Q5 kernel needs
K/tp a multiple of 32).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict

import torch

from vit_cpp_tpu_torch.parallel.mesh import AXES, axis_group, axis_rank, axis_size
from vit_cpp_tpu_torch.quant.int8 import Int8Linear
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear

def _kernel_spec(kernel, col_parallel: bool, stacked: bool = True):
    if col_parallel:
        spec = (None, None, "model") if stacked else (None, "model")
        scale_spec = (None, "model") if stacked else ("model",)
    else:
        spec = (None, "model", None) if stacked else ("model", None)
        scale_spec = ()  # per-output-channel scale: replicated here
    if isinstance(kernel, QuantLinear):
        return QuantLinear(codes=spec, scales=spec,
                           mins=None if kernel.mins is None else spec, qtype=0)
    if isinstance(kernel, Int8Linear):
        return Int8Linear(codes=spec, scale=scale_spec,
                          act_scale=None if kernel.act_scale is None else ())
    return spec


def _rep_kernel(kernel):
    if isinstance(kernel, QuantLinear):
        return QuantLinear(codes=(), scales=(), mins=None if kernel.mins is None else (),
                           qtype=0)
    if isinstance(kernel, Int8Linear):
        return Int8Linear(codes=(), scale=(),
                          act_scale=None if kernel.act_scale is None else ())
    return ()


def param_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The spec tree of a load_params() tree (vit_cpp_tpu/parallel/
    sharding.py::param_pspecs). A folded engine's `features_norm` (the
    port keeps the final norm's affine there) replicates."""
    b = params["blocks"]

    def _ln(node):
        return {k: None if node[k] is None else () for k in ("scale", "bias")}

    specs: Dict[str, Any] = {
        "pos_embed": (),
        "patch_embed": {"kernel": (), "bias": ()},
        "blocks": {
            "ln1": _ln(b["ln1"]),
            "qkv": {"kernel": _kernel_spec(b["qkv"]["kernel"], True), "bias": (None, "model")},
            "proj": {"kernel": _kernel_spec(b["proj"]["kernel"], False), "bias": ()},
            "ln2": _ln(b["ln2"]),
            "fc1": {"kernel": _kernel_spec(b["fc1"]["kernel"], True), "bias": (None, "model")},
            "fc2": {"kernel": _kernel_spec(b["fc2"]["kernel"], False), "bias": ()},
        },
        "norm": _ln(params["norm"]),
    }
    if "head" in params:
        specs["head"] = {"kernel": _kernel_spec(params["head"]["kernel"], True, stacked=False),
                         "bias": ("model",)}
    for k in ("cls_token", "dist_token", "reg_token"):
        if k in params:
            specs[k] = ()
    if "attn_pool" in params:
        ap = params["attn_pool"]
        specs["attn_pool"] = {
            "probe": (),
            **{k: {"kernel": _rep_kernel(ap[k]["kernel"]), "bias": ()}
               for k in ("qkv", "proj", "fc1", "fc2")},
            "norm": _ln(ap["norm"]),
        }
    if "moe" in params:
        # expert parallelism: each model rank holds E/tp experts
        specs["moe"] = {
            "router": {"kernel": ()},
            "fc1": {"kernel": (None, "model", None, None), "bias": (None, "model", None)},
            "fc2": {"kernel": (None, "model", None, None), "bias": (None, "model", None)},
        }
    if "norm_pre" in params:
        specs["norm_pre"] = _ln(params["norm_pre"])
    if "head_dist" in params:
        specs["head_dist"] = {
            "kernel": _kernel_spec(params["head_dist"]["kernel"], True, stacked=False),
            "bias": ("model",),
        }
    if "features_norm" in params:
        specs["features_norm"] = _ln(params["features_norm"])
    return specs


def _is_node(x) -> bool:
    return isinstance(x, (QuantLinear, Int8Linear))


def tree_map(fn, tree, *rest, path=()):
    """fn(path, leaf, *matching) over a nested dict whose leaves are
    tensors, QuantLinear / Int8Linear nodes or None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def fsdp_pspecs(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """ZeRO-3 specs: the TP specs plus "data" on the largest dimension of
    each dense leaf of rank >= 2 that is free and that dp divides
    (vit_cpp_tpu/parallel/sharding.py::fsdp_pspecs); quantized nodes and
    leaves where no dimension divides keep their TP spec. `mesh` is a
    DeviceMesh or an {axis: size} dict."""
    dp = axis_size(mesh, "data")
    base = param_pspecs(params)

    def widen(path, leaf, spec):
        if _is_node(leaf) or not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
            return spec
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        free = [i for i, e in enumerate(entries) if e is None and leaf.shape[i] % dp == 0]
        if not free:
            return spec
        pick = max(free, key=lambda i: leaf.shape[i])
        entries[pick] = "data"
        return tuple(entries)

    return tree_map(widen, params, base)


def batch_pspec() -> tuple:
    return ("data",)


# -- placement -----------------------------------------------------------------


def _is_qkv(path) -> bool:
    return len(path) >= 2 and path[0] == "blocks" and path[1] == "qkv"


def model_shard(t: torch.Tensor, dim: int, mesh, qkv: bool = False) -> torch.Tensor:
    """This model rank's part of `t` along `dim`, a contiguous copy that
    owns its storage. A qkv column
    tensor splits its nh axis: (..., 3, tp, h/tp) -> rank's (..., 3h/tp)."""
    tp, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    if tp == 1:
        return t
    dim = dim % t.ndim
    if qkv and dim == t.ndim - 1:
        v = t.reshape(*t.shape[:-1], 3, tp, t.shape[-1] // (3 * tp))
        return v[..., r, :].reshape(*t.shape[:-1], t.shape[-1] // tp).contiguous()
    n = t.shape[dim] // tp
    # a copy: a slice along the first dim is contiguous already and would
    # keep the whole tensor's storage (an exported program saves it whole)
    return t.narrow(dim, r * n, n).clone(memory_format=torch.contiguous_format)


def _gather_model(t: torch.Tensor, dim: int, mesh, qkv: bool) -> torch.Tensor:
    """Inverse of model_shard (no gradient)."""
    import torch.distributed as dist

    tp = axis_size(mesh, "model")
    if tp == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(tp)]
    dist.all_gather(parts, t, group=axis_group(mesh, "model"))
    dim = dim % t.ndim
    if qkv and dim == t.ndim - 1:
        parts = [p.reshape(*p.shape[:-1], 3, p.shape[-1] // 3) for p in parts]
        full = torch.stack(parts, dim=-2)  # (..., 3, tp, h/tp)
        return full.reshape(*t.shape[:-1], t.shape[-1] * tp)
    return torch.cat(parts, dim=dim)


def _divisible(shape, spec, mesh) -> bool:
    return all(e is None or shape[d] % axis_size(mesh, e) == 0 for d, e in enumerate(spec))


def _warn(leaf, spec) -> None:
    warnings.warn(
        f"shard_params: leaf shape {tuple(leaf.shape)} does not divide mesh axes "
        f"in spec {spec}; replicating this leaf"
    )


def _node_parts(node):
    if isinstance(node, QuantLinear):
        return ("codes", "scales", "mins")
    return ("codes", "scale", "act_scale")


def placement_specs(params: Dict[str, Any], mesh, fsdp: bool = False) -> Dict[str, Any]:
    """The specs `shard_params` places the tree with: fsdp_pspecs or
    param_pspecs, with () for each leaf (and each quantized node) whose
    dimensions do not divide the mesh axes, warned once per leaf."""
    specs = fsdp_pspecs(params, mesh) if fsdp else param_pspecs(params)

    def settle(path, leaf, spec):
        if leaf is None:
            return None
        if _is_node(leaf):
            bad = [(getattr(leaf, f), getattr(spec, f)) for f in _node_parts(leaf)
                   if getattr(leaf, f) is not None
                   and not _divisible(getattr(leaf, f).shape, getattr(spec, f), mesh)]
            for t, s in bad:
                _warn(t, s)
            return _rep_kernel(leaf) if bad else spec
        if not _divisible(leaf.shape, spec, mesh):
            _warn(leaf, spec)
            return ()
        return tuple(spec)

    return tree_map(settle, params, specs)


def _place(path, t: torch.Tensor, spec, mesh, dtensor: bool = False):
    if t is None:
        return None
    qkv = _is_qkv(path)
    model_dim = next((d for d, e in enumerate(spec) if e == "model"), None)
    data_dim = next((d for d, e in enumerate(spec) if e == "data"), None)
    if model_dim is not None:
        t = model_shard(t, model_dim, mesh, qkv)
    if data_dim is None and not dtensor:
        return t.contiguous()
    local = t.contiguous()
    if data_dim is not None:
        n = t.shape[data_dim] // axis_size(mesh, "data")
        local = t.narrow(data_dim, axis_rank(mesh, "data") * n, n).clone(
            memory_format=torch.contiguous_format)
    return as_dtensor(local, spec, mesh)


def as_dtensor(local: torch.Tensor, spec, mesh):
    """This rank's part of a leaf placed by `spec`, as a DTensor over the
    mesh (sharing its storage)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(spec.index(axis)) if axis in spec else Replicate() for axis in AXES]
    return DTensor.from_local(local, mesh, placements, run_check=False)


def shard_params(params: Dict[str, Any], mesh, fsdp: bool = False, specs=None) -> Dict[str, Any]:
    """This rank's part of a full tree: TP shards (with `fsdp`, DTensors,
    sharded over "data" as well where the spec says so), laid out by
    `specs` (default: placement_specs). Quantized nodes keep their
    dataclass."""

    def put(path, leaf, spec):
        if _is_node(leaf):
            return dataclasses.replace(leaf, **{
                f: _place(path, getattr(leaf, f), getattr(spec, f), mesh)
                for f in _node_parts(leaf)})
        return _place(path, leaf, spec, mesh, fsdp)

    return tree_map(put, params, placement_specs(params, mesh, fsdp) if specs is None else specs)


def _to_local(t, mesh):
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(t, DTensor):
        return t
    model = t.placements[1]
    return t.redistribute(mesh, [Replicate(), model]).to_local(grad_placements=[Partial(), model])


def local_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The tree the forward runs: each FSDP DTensor all-gathered over
    "data" into its local TP shard (differentiable: the backward
    reduce-scatters the gradient of a leaf sharded over "data", and
    all-reduces that of a replicated one, summed over the data ranks);
    other leaves as they are."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(l, DTensor) for l in _leaves(params)):
        return params
    return tree_map(lambda path, leaf: _to_local(leaf, mesh), params)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif _is_node(tree):
        yield from (getattr(tree, f) for f in _node_parts(tree))
    else:
        yield tree


def gather_params(params: Dict[str, Any], specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The full tree from every rank's shards (collective, no gradient):
    what an export writes."""

    def full(path, t, spec):
        if t is None:
            return None
        t = _to_local(t.detach(), mesh)
        model_dim = next((d for d, e in enumerate(spec) if e == "model"), None)
        if model_dim is None:
            return t
        return _gather_model(t, model_dim, mesh, _is_qkv(path))

    def node(path, leaf, spec):
        if _is_node(leaf):
            return dataclasses.replace(leaf, **{
                f: full(path, getattr(leaf, f), getattr(spec, f)) for f in _node_parts(leaf)})
        return full(path, leaf, spec)

    with torch.no_grad():
        return tree_map(node, params, specs)


def replicas(spec, mesh) -> int:
    """How many ranks hold an identical copy of a leaf placed by `spec`."""
    n = axis_size(mesh, "data") * axis_size(mesh, "model")
    for e in spec:
        if e is not None:
            n //= axis_size(mesh, e)
    return n
