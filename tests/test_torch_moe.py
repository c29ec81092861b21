"""The port's V-MoE (routed expert MLPs) against the JAX package's.

ops/moe.py (moe_capacity, the routing, moe_mlp, upcycle_params), the MoE
branch of models/vit.py::forward, the loader and exporter of MoE files,
the engine, the front ends, training with the router's auxiliary losses
and `finetune --moe` upcycling, on tiny synthetic models (hidden 64, 4
layers, 4 heads, E=4 experts in layers 1 and 3, 32 px, patch 8: T=17),
with the same numpy-made inputs through both packages on the CPU (the
port's kernels run their plain versions, the JAX package's Pallas kernels
interpret mode). Tolerances: f32 outputs 1e-5 (summation order only),
router diagnostics 1e-6 of max(1, |aux|) (router_z reaches ~100 here,
where one f32 step is 7.6e-6), bf16 outputs 2e-2 of max|out| (bf16 rounding at
other places); the routing integers (expert, position, keep, slot) must
be equal, ties included.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models import forward as jax_forward
from vit_cpp_tpu.models import params_from_state_dict
from vit_cpp_tpu.ops import moe as jax_moe
from vit_cpp_tpu.testing.synthetic import random_state_dict, write_synthetic_model
from vit_cpp_tpu_torch.models.params import params_from_jax
from vit_cpp_tpu_torch.models.vit import forward
from vit_cpp_tpu_torch.ops import moe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
AUX_TOL = 1e-6
BF16_TOL = 2e-2
TINY = VitHParams(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, num_classes=16,
                  patch_size=8, img_size=32)
LAYERS = (1, 3)


def _moe_hp(hp=TINY, e=4, layers=LAYERS, k=2, cap=1.25):
    return dataclasses.replace(hp, num_experts=e, moe_layers=layers, moe_top_k=k,
                               moe_capacity=cap)


def _upcycled(hp=TINY, k=2, cap=1.25, seed=0):
    """The JAX package's upcycled tree, the port's copy of it, the MoE hp."""
    dense = params_from_state_dict(random_state_dict(hp, seed=seed), hp)
    up = jax_moe.upcycle_params(dense, hp, 4, LAYERS, seed=seed)
    return up, params_from_jax(up), _moe_hp(hp, k=k, cap=cap)


def _trained_like(tree, seed=1):
    """An upcycled tree with its experts and router perturbed, so that the
    experts differ and the router decides: what training makes of it."""
    rng = np.random.default_rng(seed)
    moe_sub = jax.tree.map(
        lambda a: a + 0.5 * np.abs(a).mean() * rng.standard_normal(a.shape).astype(np.float32),
        tree["moe"])
    moe_sub["router"]["kernel"] = rng.standard_normal(
        tree["moe"]["router"]["kernel"].shape).astype(np.float32)
    return {**tree, "moe": moe_sub}


def _images(n=2, seed=0, size=32):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(np.float32)


def _aux_close(got, want) -> bool:
    return abs(got.item() - float(want)) <= AUX_TOL * max(1.0, abs(float(want)))


def _same_error(ours, theirs, exc=ValueError):
    with pytest.raises(exc) as a:
        ours()
    with pytest.raises(exc) as b:
        theirs()
    assert str(a.value) == str(b.value)
    return str(a.value)


@pytest.mark.parametrize("t", [1, 17, 67, 197])
def test_moe_capacity_matches_jax(t):
    for e in (2, 4, 8):
        for k in (1, 2):
            for f in (0.5, 1.0, 1.25, 2.0, 8.0, 100.0):
                assert moe.moe_capacity(t, e, k, f) == jax_moe.moe_capacity(t, e, k, f)
    assert moe.moe_capacity(197, 8, 2, 1.25) == 64 and moe.moe_capacity(197, 8, 1, 1.25) == 32


def _layer(rng, h, m, e, scale_router=1.0):
    return {
        "router": {"kernel": (scale_router * rng.standard_normal((h, e))).astype(np.float32)},
        "fc1": {"kernel": (rng.standard_normal((e, h, m)) / np.sqrt(h)).astype(np.float32),
                "bias": rng.standard_normal((e, m)).astype(np.float32)},
        "fc2": {"kernel": (rng.standard_normal((e, m, h)) / np.sqrt(m)).astype(np.float32),
                "bias": rng.standard_normal((e, h)).astype(np.float32)},
    }


def _jax_routing(y, router, hp):
    """vit_cpp_tpu/ops/moe.py:87-112, the JAX routing integers: top_k, the
    slot-major order, positions from the strictly-lower-triangular
    product."""
    b, t, _ = y.shape
    e, k = hp.num_experts, hp.moe_top_k
    cap = jax_moe.moe_capacity(t, e, k, hp.moe_capacity)
    logits = jnp.einsum("bth,he->bte", jnp.asarray(y, jnp.float32), jnp.asarray(router),
                        precision=jax.lax.Precision.HIGHEST)
    _, idx = jax.lax.top_k(logits, k)
    idx_sm = jnp.swapaxes(idx, 1, 2).reshape(b, k * t)
    oh = jax.nn.one_hot(idx_sm, e, dtype=jnp.float32)
    tri = jnp.tril(jnp.ones((k * t, k * t), jnp.float32), k=-1)
    pos_before = jnp.einsum("st,bte->bse", tri, oh, precision=jax.lax.Precision.HIGHEST)
    posn = jnp.sum(pos_before * oh, axis=-1).astype(jnp.int32)
    return {"idx": np.asarray(idx), "posn": np.asarray(posn), "keep": np.asarray(posn < cap),
            "dest": np.asarray(idx_sm * cap + posn)}


def _assert_routing_equal(r, want):
    for name in ("idx", "posn", "keep", "dest"):
        np.testing.assert_array_equal(getattr(r, name).numpy(), want[name], err_msg=name)


@pytest.mark.parametrize("cap", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_matches_jax(k, cap):
    """out, aux and the routing integers in f32; then bf16 activations and
    experts on the same (bf16-rounded) input: the same routing (the router
    is f32 either way) and out within 2e-2 of max|out|."""
    rng = np.random.default_rng(3)
    b, t, h, m, e = 2, 67, 64, 128, 4
    hp = dataclasses.replace(_moe_hp(k=k, cap=cap), hidden_size=h, mlp_hidden=m)
    y = rng.standard_normal((b, t, h)).astype(np.float32)
    mp = _layer(rng, h, m, e)
    out, aux = moe.moe_mlp(torch.from_numpy(y), params_from_jax(mp), hp,
                           lambda v: torch.nn.functional.gelu(v, approximate="tanh"))
    jout, jaux = jax_moe.moe_mlp(jnp.asarray(y), jax.tree.map(jnp.asarray, mp), hp,
                                 lambda v: jax.nn.gelu(v, approximate=True))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_TOL, rtol=0)
    assert aux.keys() == jaux.keys()
    for name in aux:
        assert aux[name].dtype == torch.float32
        assert _aux_close(aux[name], jaux[name]), name
    want = _jax_routing(y, mp["router"]["kernel"], hp)
    _assert_routing_equal(moe.route(torch.from_numpy(y), torch.from_numpy(mp["router"]["kernel"]),
                                    hp), want)
    if cap == 0.5:
        assert aux["dropped_frac"].item() > 0  # the pressure case drops
    if cap == 8.0:
        assert aux["dropped_frac"].item() == 0.0

    # bf16: the same input rounded once, experts in bf16, router f32
    yb = torch.from_numpy(y).to(torch.bfloat16)
    mpb = params_from_jax(mp)
    for lin in ("fc1", "fc2"):
        mpb[lin] = {n: v.to(torch.bfloat16) for n, v in mpb[lin].items()}
    out_b, _ = moe.moe_mlp(yb, mpb, hp, lambda v: torch.nn.functional.gelu(v, approximate="tanh"))
    jmp = jax.tree.map(jnp.asarray, mp)
    for lin in ("fc1", "fc2"):
        jmp[lin] = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jmp[lin])
    jout_b, _ = jax_moe.moe_mlp(jnp.asarray(yb.float().numpy(), jnp.bfloat16), jmp, hp,
                                lambda v: jax.nn.gelu(v, approximate=True))
    assert out_b.dtype == torch.bfloat16
    jb = np.asarray(jout_b, np.float32)
    assert np.abs(out_b.float().numpy() - jb).max() <= BF16_TOL * np.abs(jb).max()
    _assert_routing_equal(moe.route(yb, torch.from_numpy(mp["router"]["kernel"]), hp),
                          _jax_routing(yb.float().numpy(), mp["router"]["kernel"], hp))


def test_tied_experts_route_as_jax_top_k():
    """Duplicated router columns tie every token's logits for experts 0/2
    and 1/3, so each token's top-2 is one tied pair: the lower index comes
    first, as in jax.lax.top_k (torch.topk promises no order), and the
    outputs agree."""
    rng = np.random.default_rng(8)
    b, t, h, m = 2, 17, 64, 96
    hp = dataclasses.replace(_moe_hp(k=2, cap=1.25), hidden_size=h, mlp_hidden=m)
    mp = _layer(rng, h, m, 4)
    r = mp["router"]["kernel"]
    r[:, 2], r[:, 3] = r[:, 0], r[:, 1]
    y = rng.standard_normal((b, t, h)).astype(np.float32)
    got = moe.route(torch.from_numpy(y), torch.from_numpy(r), hp)
    want = _jax_routing(y, r, hp)
    _assert_routing_equal(got, want)
    # each token's two choices are one tied pair, the lower index first
    pairs = {tuple(p) for p in got.idx.numpy().reshape(-1, 2).tolist()}
    assert pairs <= {(0, 2), (1, 3)}
    act = lambda v: torch.nn.functional.gelu(v, approximate="tanh")  # noqa: E731
    out, _ = moe.moe_mlp(torch.from_numpy(y), params_from_jax(mp), hp, act)
    jout, _ = jax_moe.moe_mlp(jnp.asarray(y), jax.tree.map(jnp.asarray, mp), hp,
                              lambda v: jax.nn.gelu(v, approximate=True))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("variant", ["logits", "features", "avg-pool", "moe_aux", "capacity-drops"])
def test_upcycled_forward_matches_jax(variant):
    """JAX's upcycle_params tree (its experts perturbed so that routing
    matters), carried across by params_from_jax unchanged, gives JAX's
    forward: logits, features=True, an avg-pool (CLS-less) model, the aux
    diagnostics, and capacity 0.5 where tokens drop."""
    hp = TINY
    if variant == "avg-pool":
        hp = dataclasses.replace(TINY, num_prefix_tokens=0, global_pool="avg")
    jtree, _, hp_moe = _upcycled(hp, cap=0.5 if variant == "capacity-drops" else 1.25)
    jtree = _trained_like(jtree)
    tree = params_from_jax(jtree)
    assert tree["moe"]["fc1"]["kernel"].shape == (2, 4, 64, 256)
    assert tree["blocks"]["fc1"]["kernel"].shape == (2, 64, 256)
    x = _images(3)
    kw = {"features": True} if variant == "features" else {}
    if variant == "moe_aux":
        kw = {"moe_aux": True}
    got = forward(tree, torch.from_numpy(x), hp_moe, **kw)
    want = jax_forward(jtree, jnp.asarray(x), hp_moe, **kw)
    if variant == "moe_aux":
        (got, aux), (want, jaux) = got, want
        for name in jaux:
            assert _aux_close(aux[name], jaux[name]), name
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=0)


def test_forward_refuses_what_jax_refuses():
    """ToMe, pad_tokens and QAT on an MoE model, moe_aux on a dense one:
    the JAX package's errors, message for message."""
    jtree, tree, hp_moe = _upcycled()
    x = _images(1)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    assert "tome + MoE" in _same_error(lambda: forward(tree, tx, hp_moe, tome=2),
                                       lambda: jax_forward(jtree, jx, hp_moe, tome=2))
    assert "pad_tokens + MoE" in _same_error(
        lambda: forward(tree, tx, hp_moe, pad_tokens=True, attn_impl="pallas"),
        lambda: jax_forward(jtree, jx, hp_moe, pad_tokens=True, attn_impl="pallas"))
    assert "QAT through MoE" in _same_error(
        lambda: forward(tree, tx, hp_moe, mm_impl="qat"),
        lambda: jax_forward(jtree, jx, hp_moe, mm_impl="qat"))
    dense = params_from_state_dict(random_state_dict(TINY, seed=0), TINY)
    assert _same_error(lambda: forward(params_from_jax(dense), tx, TINY, moe_aux=True),
                       lambda: jax_forward(dense, jx, TINY, moe_aux=True)) == (
        "moe_aux requires an MoE model (hp.num_experts)")


def test_port_upcycling_preserves_the_dense_function():
    """The port's upcycle_params at capacity 8.0 (nothing drops): the
    routed forward is the dense forward, logits and features; the dense
    fc1/fc2 restack over layers 0 and 2, the router is 1e-3 * normal."""
    dense = params_from_jax(params_from_state_dict(random_state_dict(TINY, seed=2), TINY))
    up = moe.upcycle_params(dense, TINY, 4, LAYERS, seed=2)
    hp = _moe_hp(cap=8.0)
    x = torch.from_numpy(_images(2, seed=4))
    for kw in ({}, {"features": True}):
        np.testing.assert_allclose(forward(up, x, hp, **kw).numpy(),
                                   forward(dense, x, TINY, **kw).numpy(), atol=F32_TOL, rtol=0)
    _, aux = forward(up, x, hp, moe_aux=True)
    assert aux["dropped_frac"].item() == 0.0
    assert torch.equal(up["blocks"]["fc1"]["kernel"], dense["blocks"]["fc1"]["kernel"][[0, 2]])
    assert torch.equal(up["moe"]["fc2"]["kernel"][1, 3], dense["blocks"]["fc2"]["kernel"][3])
    router = up["moe"]["router"]["kernel"]
    assert router.shape == (2, 64, 4) and router.dtype == torch.float32
    assert 0.5e-3 < router.std().item() < 2e-3
    assert torch.equal(router, moe.upcycle_params(dense, TINY, 4, LAYERS, seed=2)["moe"]
                       ["router"]["kernel"])


@pytest.mark.parametrize("layers", [(1, 99), (1, 1), (0, 1, 2, 3), "int8"])
def test_port_upcycling_refuses_what_jax_refuses(layers):
    from vit_cpp_tpu.quant.int8 import convert_params_to_int8 as jax_int8
    from vit_cpp_tpu_torch.quant.int8 import convert_params_to_int8

    dense = params_from_state_dict(random_state_dict(TINY, seed=0), TINY)
    ours, theirs = params_from_jax(dense), dense
    if layers == "int8":
        ours, theirs, layers = convert_params_to_int8(ours), jax_int8(theirs), (1,)
    _same_error(lambda: moe.upcycle_params(ours, TINY, 4, layers),
                lambda: jax_moe.upcycle_params(theirs, TINY, 4, layers))


def _save_jax(path, jtree, hp, ftype):
    from vit_cpp_tpu.models.export import save_params as jax_save

    jax_save(path, jtree, hp, id2label={i: f"class_{i}" for i in range(hp.num_classes)},
             ftype=ftype)


@pytest.mark.parametrize("ftype", [0, 1])
def test_jax_written_file_loads_in_the_port(tmp_path, ftype):
    """JAX's save_params -> the port's detect_hparams equals JAX's (the
    layout from the tensors, top_k/capacity from meta.moe), load_params
    puts the router f32 and the experts dense, and the forwards agree."""
    from vit_cpp_tpu.engine import detect_hparams as jax_detect
    from vit_cpp_tpu.gguf.reader import read_model as jax_read
    from vit_cpp_tpu.models import load_params as jax_load
    from vit_cpp_tpu_torch.engine import detect_hparams
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.models.params import infer_moe_hparams, load_params

    jtree, _, hp = _upcycled(cap=2.0)
    path = str(tmp_path / "moe.gguf")
    _save_jax(path, _trained_like(jtree), hp, ftype)
    mf, jmf = read_model(path), jax_read(path)
    got, want = detect_hparams(mf), jax_detect(jmf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.num_experts, got.moe_layers, got.moe_top_k, got.moe_capacity) == (4, LAYERS, 2, 2.0)
    from vit_cpp_tpu.models.params import infer_moe_hparams as jax_infer

    assert dataclasses.asdict(infer_moe_hparams(mf.hparams, mf.tensors)) == dataclasses.asdict(
        jax_infer(jmf.hparams, jmf.tensors))
    params = load_params(mf, hparams=got)
    assert params["moe"]["router"]["kernel"].dtype == torch.float32
    assert params["moe"]["fc1"]["kernel"].shape == (2, 4, 64, 256)
    assert params["blocks"]["fc1"]["kernel"].shape == (2, 64, 256)
    x = _images(2)
    np.testing.assert_allclose(
        forward(params, torch.from_numpy(x), got).numpy(),
        np.asarray(jax_forward(jax_load(jmf, hparams=want), jnp.asarray(x), want)),
        atol=F32_TOL, rtol=0)


def test_meta_moe_is_required_and_validated_as_jax(tmp_path):
    """A missing marker, a top_k above the expert count, a capacity <= 0,
    a marker of the wrong size, and every-layer MoE: JAX's errors."""
    from vit_cpp_tpu.gguf.reader import read_model as jax_read
    from vit_cpp_tpu.models import load_params as jax_load
    from vit_cpp_tpu.models.params import infer_moe_hparams as jax_infer
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.models.params import infer_moe_hparams, load_params

    jtree, _, hp = _upcycled()
    path = str(tmp_path / "moe.gguf")
    _save_jax(path, jtree, hp, 0)
    mf, jmf = read_model(path), jax_read(path)
    ours, theirs = dict(mf.tensors), dict(jmf.tensors)
    del ours["meta.moe"], theirs["meta.moe"]
    assert "no meta.moe" in _same_error(lambda: infer_moe_hparams(TINY, ours),
                                        lambda: jax_infer(TINY, theirs))
    for values, what in (([9.0, 1.25], "top_k 9"), ([1.0, -1.0], "capacity -1.0"),
                         ([2.0, 1.25, 3.0], "got 3 values")):
        for m in (mf, jmf):
            m.tensors["meta.moe"].data = np.asarray(values, np.float32)
        assert what in _same_error(lambda: infer_moe_hparams(TINY, mf.tensors),
                                   lambda: jax_infer(TINY, jmf.tensors))
    for m in (mf, jmf):
        m.tensors["meta.moe"].data = np.asarray([2.0, 1.25], np.float32)
    every = _moe_hp(layers=(0, 1, 2, 3))
    assert "every-layer MoE" in _same_error(lambda: load_params(mf, hparams=every),
                                            lambda: jax_load(jmf, hparams=every))


@pytest.mark.parametrize("ftype", [0, 1])
def test_port_written_file_is_jax_bytes_and_loads_in_jax(tmp_path, ftype):
    """The port's save_params of the port's tree writes the JAX package's
    bytes (router and experts per MoE layer, meta.moe; the router f32 at
    ftype 1), and JAX's loader runs it to the port's logits."""
    from vit_cpp_tpu.engine import detect_hparams as jax_detect
    from vit_cpp_tpu.gguf.reader import read_model as jax_read
    from vit_cpp_tpu.models import load_params as jax_load
    from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.models.export import save_params

    jtree, _, hp = _upcycled()
    jtree = _trained_like(jtree)
    tree = params_from_jax(jtree)
    ours, theirs = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    save_params(ours, tree, hp, id2label={i: f"class_{i}" for i in range(16)}, ftype=ftype)
    _save_jax(theirs, jtree, hp, ftype)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    mf = read_model(ours)
    assert mf.tensors["blocks.1.moe.router.weight"].dtype == GGMLDType.F32
    assert mf.tensors["blocks.3.moe.experts.2.fc1.weight"].dtype == (
        GGMLDType.F16 if ftype else GGMLDType.F32)
    assert len(mf.tensors) == hp.expected_tensor_count()
    jmf = jax_read(ours)
    jhp = jax_detect(jmf)
    x = _images(2, seed=3)
    np.testing.assert_allclose(
        np.asarray(jax_forward(jax_load(jmf, hparams=jhp), jnp.asarray(x), jhp)),
        forward(tree, torch.from_numpy(x), hp).numpy(),
        atol=F32_TOL if ftype == 0 else 2e-2, rtol=0)


def test_f16_router_file_routes_on_the_widened_router(tmp_path):
    """A file whose routers are stored f16 (what the JAX package's
    vit-convert writes, ROADMAP C) loads with the f16 values widened to
    f32 and routes on them, in both packages."""
    from vit_cpp_tpu.engine import detect_hparams as jax_detect
    from vit_cpp_tpu.gguf.reader import read_model as jax_read
    from vit_cpp_tpu.models import load_params as jax_load
    from vit_cpp_tpu.models.export import params_to_state_dict
    from vit_cpp_tpu_torch.engine import detect_hparams
    from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.gguf.writer import write_model
    from vit_cpp_tpu_torch.models.params import load_params

    jtree, _, hp = _upcycled()
    state = params_to_state_dict(_trained_like(jtree), hp)

    def records():
        for name, arr in state.items():
            f16 = arr.ndim == 2 and name.startswith("blocks.")  # routers included
            dt = GGMLDType.F16 if f16 else GGMLDType.F32
            yield name, arr.shape, dt, arr.astype(np.float16 if f16 else np.float32)

    path = str(tmp_path / "f16-router.gguf")
    write_model(path, hp, {i: f"class_{i}" for i in range(16)}, records(), 1)
    mf = read_model(path)
    assert mf.tensors["blocks.1.moe.router.weight"].dtype == GGMLDType.F16
    got_hp = detect_hparams(mf)
    params = load_params(mf, hparams=got_hp)
    router = params["moe"]["router"]["kernel"]
    assert router.dtype == torch.float32
    want_router = state["blocks.1.moe.router.weight"].astype(np.float16).astype(np.float32).T
    np.testing.assert_array_equal(router[0].numpy(), want_router)
    jmf = jax_read(path)
    jhp = jax_detect(jmf)
    x = _images(2, seed=6)
    np.testing.assert_allclose(
        forward(params, torch.from_numpy(x), got_hp).numpy(),
        np.asarray(jax_forward(jax_load(jmf, hparams=jhp), jnp.asarray(x), jhp)),
        atol=F32_TOL, rtol=0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A synthetic MoE file (f16, routers f32) and its Q8_0 rewrite by the
    port's quantizer; a dense file of the same geometry; a ViTSTR file."""
    from vit_cpp_tpu_torch.cli.quantize import quantize_model_file

    d = tmp_path_factory.mktemp("moe")
    out = {"f16": str(d / "moe.gguf"), "q8": str(d / "moe-q8_0.gguf"),
           "dense": str(d / "dense.gguf"), "vitstr": str(d / "vitstr.gguf"),
           "dir": str(d / "imgs"), "tmp": d}
    labels = {i: f"class_{i}" for i in range(16)}
    write_synthetic_model(out["f16"], _moe_hp(), ftype=1, seed=0, id2label=labels)
    assert quantize_model_file(out["f16"], out["q8"], 8, verbose=False)
    write_synthetic_model(out["dense"], dataclasses.replace(TINY, num_classes=5), ftype=1, seed=4)
    write_synthetic_model(out["vitstr"], dataclasses.replace(TINY, in_chans=1, seq_len=25,
                                                             num_classes=96), ftype=1, seed=2)
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(out["dir"])
    for i in range(5):
        h, w = rng.integers(24, 64, 2)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(out["dir"], f"{i}.png"))
    return out


def test_quantized_file_keeps_its_routers_f32(files):
    """cli.quantize to Q8_0: the experts and dense linears quantize, the
    routers stay f32; the loader dequantizes the experts to dense and
    keeps the dense fc1/fc2 packed."""
    from vit_cpp_tpu_torch.engine import detect_hparams
    from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.quant.qlinear import QuantLinear

    mf = read_model(files["q8"])
    assert mf.tensors["blocks.1.moe.router.weight"].dtype == GGMLDType.F32
    assert mf.tensors["blocks.1.moe.experts.0.fc1.weight"].dtype == GGMLDType.Q8_0
    assert mf.tensors["blocks.0.mlp.fc1.weight"].dtype == GGMLDType.Q8_0
    params = load_params(mf, torch.bfloat16, hparams=detect_hparams(mf))
    assert isinstance(params["blocks"]["fc1"]["kernel"], QuantLinear)
    assert params["moe"]["fc1"]["kernel"].dtype == torch.bfloat16
    assert params["moe"]["router"]["kernel"].dtype == torch.float32


def _engines(path, **kw):
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
    from vit_cpp_tpu_torch.engine import VitEngine

    return (VitEngine(path, device="cpu", verbose=False, **kw),
            JaxVitEngine(path, verbose=False, **kw))


@pytest.mark.parametrize(
    "which,kw,tol",
    [
        # the serving defaults' matmul and attention paths in f32: W8A8 with
        # LayerNorm folded (ln2 kept real); an int8 activation code can flip
        # where the two packages' f32 sums straddle a rounding boundary
        ("f16", dict(mm_impl="int8", fold_ln=True, attn_impl="pallas-fast"), 1e-4),
        # Q8_0 dense linears through the dequantizing matmul's plain version
        # vs JAX's Pallas kernel, experts dequantized at load
        ("q8", dict(mm_impl="pallas", attn_impl="pallas"), F32_TOL),
        ("f16", dict(), F32_TOL),
    ],
    ids=["int8-fold", "q8_0-pallas", "f32"],
)
def test_engine_matches_jax(files, which, kw, tol):
    from tests.test_torch_calibrate import structured_images

    engine, jax_engine = _engines(files[which], **kw)
    assert engine.hp.num_experts == 4 and engine.hp.moe_layers == LAYERS
    if kw.get("fold_ln"):
        assert engine.params["blocks"]["ln2"]["scale"] is not None  # kept real
        assert engine.params["blocks"]["ln1"]["scale"] is None
    x = structured_images(4)
    got = engine.predict_probs_batch(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_engine.predict_probs_batch(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    if not kw.get("fold_ln"):  # a folded JAX engine drops the final norm's affine
        feats = engine.features_batch(torch.from_numpy(x)).numpy()
        jax_feats = np.asarray(jax_engine.features_batch(jnp.asarray(x)))
        np.testing.assert_allclose(feats, jax_feats, atol=tol * max(1.0, np.abs(jax_feats).max()),
                                   rtol=0)


def test_engine_refuses_static_scales_and_tome_as_jax(files):
    """Both refusals at construction, with JAX's messages; the calibrator
    itself refuses an MoE tree with the engine's reason."""
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.quant import calibrate

    assert "static act scales" in _same_error(
        lambda: VitEngine(files["f16"], mm_impl="int8", act_quant="static", device="cpu",
                          verbose=False),
        lambda: JaxVitEngine(files["f16"], mm_impl="int8", act_quant="static", verbose=False))
    assert "tome + MoE" in _same_error(
        lambda: VitEngine(files["f16"], tome=2, device="cpu", verbose=False),
        lambda: JaxVitEngine(files["f16"], tome=2, verbose=False))
    engine = VitEngine(files["f16"], mm_impl="int8", device="cpu", verbose=False)
    with pytest.raises(ValueError) as e:
        calibrate.calibrate_act_scales(engine.params, torch.from_numpy(_images(2)), engine.hp)
    assert str(e.value) == calibrate.MOE_REFUSAL


def test_training_loss_and_gradients_match_jax():
    """cross_entropy_loss with the router's auxiliary losses (0.01
    load_balance + 1e-3 router_z) through the training attention, and
    every leaf's gradient, router and experts included, against JAX's
    value_and_grad: loss 1e-6 relative, gradients 1e-4 of max|g|."""
    from vit_cpp_tpu.parallel.train import cross_entropy_loss as jax_loss
    from vit_cpp_tpu_torch.parallel.train import MOE_LB_COEF, MOE_Z_COEF, cross_entropy_loss

    jtree, _, hp = _upcycled(cap=1.25)
    jtree = _trained_like(jtree)
    tree = params_from_jax(jtree)
    x, y = _images(4, seed=8), np.array([1, 2, 3, 4])
    jl, jg = jax.value_and_grad(jax_loss)(jtree, jnp.asarray(x), jnp.asarray(y), hp)

    def named(t, prefix=""):
        if isinstance(t, dict):
            return {k: v for key, sub in t.items() for k, v in named(sub, f"{prefix}.{key}").items()}
        return {prefix: t}

    leaves = named(tree)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss = cross_entropy_loss(tree, torch.from_numpy(x), torch.from_numpy(y), hp)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    theirs = named(params_from_jax(jg))
    assert leaves.keys() == theirs.keys() and ".moe.router.kernel" in leaves
    for name, leaf in leaves.items():
        want = theirs[name].numpy()
        np.testing.assert_allclose(leaf.grad.numpy(), want,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-12), rtol=0,
                                   err_msg=name)
    assert tree["moe"]["router"]["kernel"].grad.abs().max() > 0
    assert tree["moe"]["fc1"]["kernel"].grad.abs().max() > 0
    # the objective is the cross entropy plus the two auxiliary terms
    with torch.no_grad():
        logits, aux = forward(tree, torch.from_numpy(x), hp, attn_impl="pallas-train",
                              moe_aux=True)
        nll = torch.nn.functional.cross_entropy(logits.float(), torch.from_numpy(y))
        total = nll + MOE_LB_COEF * aux["load_balance"] + MOE_Z_COEF * aux["router_z"]
    assert abs(total.item() - loss.item()) <= 1e-6 * abs(loss.item())


def test_cli_finetune_moe_writes_a_file_both_packages_run(files, tmp_path, capsys):
    """cli.finetune --moe 4 --moe-top-k 2: upcycled, trained, written; the
    JAX and the port's engines run the output to the same logits; it
    continues training without --moe (the file's layout), and refuses
    --moe on top of it with JAX's message."""
    from tests.test_torch_finetune import _make_dataset
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
    from vit_cpp_tpu_torch.cli.finetune import main
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.finetune import finetune

    data = _make_dataset(tmp_path / "train")
    out = str(tmp_path / "moe-ft.gguf")
    ckpt = str(tmp_path / "ckpt")
    assert main(["-m", files["dense"], "-d", data, "-o", out, "-b", "4", "--epochs", "2",
                 "--lr", "1e-3", "--moe", "4", "--moe-top-k", "2", "--moe-capacity", "2.0",
                 "--ckpt-dir", ckpt, "--val-dir", data, "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "finetune: upcycling to 4 experts (top-2, capacity 2) in blocks 1,3" in err
    with open(ckpt + ".meta.json") as f:
        meta = json.load(f)
    assert (meta["moe"], meta["moe_layers"], meta["moe_top_k"], meta["moe_capacity"]) == (
        4, [1, 3], 2, 2.0)
    engine, jax_engine = VitEngine(out, device="cpu", verbose=False), JaxVitEngine(out,
                                                                                   verbose=False)
    assert engine.hp.num_experts == jax_engine.hp.num_experts == 4
    assert engine.id2label == {0: "aa_dark", 1: "bb_bright"}
    x = _images(4, seed=9)
    np.testing.assert_allclose(
        engine.predict_probs_batch(torch.from_numpy(x)).numpy(),
        np.asarray(jax_engine.predict_probs_batch(jnp.asarray(x))), atol=F32_TOL, rtol=0)
    dark = os.path.join(data, "aa_dark", "0.png")
    bright = os.path.join(data, "bb_bright", "0.png")
    assert engine.classify_file(dark, topk=1, verbose=False)[0][0] != engine.classify_file(
        bright, topk=1, verbose=False)[0][0]
    params, hp, _, losses = finetune(out, data, epochs=1, batch=4, lr=1e-4,
                                     log=lambda m: None, device="cpu")
    assert hp.num_experts == 4 and hp.moe_layers == LAYERS and np.isfinite(losses).all()
    assert "moe" in params
    with pytest.raises(ValueError, match="already MoE"):
        finetune(out, data, epochs=1, batch=4, moe=2, log=lambda m: None, device="cpu")


REFUSALS = {
    "one-expert": ("dense", dict(moe=1)),
    "moe-every": ("dense", dict(moe=2, moe_every=0)),
    "top-k": ("dense", dict(moe=2, moe_top_k=3)),
    "capacity": ("dense", dict(moe=2, moe_capacity=0.0)),
    "already-moe": ("f16", dict(moe=2)),
    "sequence-head": ("vitstr", dict(moe=2)),
    "tome": ("dense", dict(moe=2, tome=2)),
    "qat": ("dense", dict(moe=2, qat="q8_0")),
    "lora": ("dense", dict(moe=2, lora=4)),
    "distill": ("dense", dict(moe=2, distill="teacher.gguf")),
    "mixup": ("dense", dict(moe=2, mixup=0.4)),
    "grad-accum": ("dense", dict(moe=2, grad_accum=2)),
    "freeze-backbone": ("dense", dict(moe=2, freeze_backbone=True)),
    "continued-moe-tome": ("f16", dict(tome=2)),
    "placement": ("one-layer", dict(moe=2)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_finetune_moe_refusals_match_jax(files, tmp_path, case):
    from tests.test_torch_finetune import _make_dataset
    from vit_cpp_tpu.finetune import finetune as jax_finetune
    from vit_cpp_tpu_torch.finetune import finetune

    which, kw = REFUSALS[case]
    if which == "one-layer":  # --moe-every places experts in no layer
        model = str(tmp_path / "one.gguf")
        write_synthetic_model(model, dataclasses.replace(TINY, num_hidden_layers=1,
                                                         num_classes=2), ftype=1, seed=1)
    else:
        model = files[which]
    data = _make_dataset(tmp_path / "d", n_per_class=4)
    quiet = dict(epochs=1, batch=4, log=lambda m: None)
    msg = _same_error(lambda: finetune(model, data, device="cpu", **quiet, **kw),
                      lambda: jax_finetune(model, data, **quiet, **kw))
    assert ("moe" in msg.lower()) or ("experts" in msg)


def test_resume_with_experts_from_a_meta_without_moe_is_refused(files, tmp_path):
    """A dense run's --ckpt-dir whose meta predates the moe keys: resuming
    it with experts (the upcycled file, no --moe) raises JAX's message."""
    from tests.test_torch_finetune import _make_dataset
    from vit_cpp_tpu_torch.finetune import finetune

    data = _make_dataset(tmp_path / "d", n_per_class=4)
    ckpt = str(tmp_path / "ckpt")
    quiet = dict(batch=4, lr=1e-3, log=lambda m: None, device="cpu")
    finetune(files["dense"], data, epochs=1, ckpt_dir=ckpt, **quiet)
    with open(ckpt + ".meta.json") as f:
        meta = json.load(f)
    for key in ("moe", "moe_layers", "moe_top_k", "moe_capacity"):
        del meta[key]
    with open(ckpt + ".meta.json", "w") as f:
        json.dump(meta, f)
    up = str(tmp_path / "up.gguf")
    write_synthetic_model(up, _moe_hp(dataclasses.replace(TINY, num_classes=2)), ftype=1, seed=4)
    with pytest.raises(ValueError) as e:
        finetune(up, data, epochs=2, ckpt_dir=ckpt, **quiet)
    assert str(e.value) == (
        f"checkpoint at {ckpt} predates --moe recording (trained dense); resuming with "
        "experts would not replay the original run — drop --moe or use a fresh --ckpt-dir")
    with pytest.raises(ValueError, match="predates --moe recording"):
        finetune(files["dense"], data, epochs=2, ckpt_dir=ckpt, moe=4, **quiet)


def _run_main(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def test_front_ends_on_an_moe_file_print_the_jax_tools_lines(files, capsys):
    """cli.inspect (the `v-moe (...)` trait), cli.vit and cli.serve at f32
    on the MoE file: the JAX tools' stdout."""
    from vit_cpp_tpu.cli import inspect as jax_inspect
    from vit_cpp_tpu.cli import serve as jax_serve
    from vit_cpp_tpu.cli import vit as jax_vit
    from vit_cpp_tpu_torch.cli import inspect as port_inspect
    from vit_cpp_tpu_torch.cli import serve as port_serve
    from vit_cpp_tpu_torch.cli import vit as port_vit

    for flags in ([], ["--json"]):
        got = _run_main(port_inspect.main, [files["f16"], *flags], capsys)
        assert got == _run_main(jax_inspect.main, [files["f16"], *flags], capsys)
    assert "v-moe (4 experts top-2 x2 layers, capacity 1.25)" in got[1]
    img = os.path.join(files["dir"], "0.png")
    argv = ["vit", "-m", files["f16"], "-i", img, "-k", "3"]
    rc_j, out_j, _ = _run_main(jax_vit.main, argv, capsys)
    rc_p, out_p, _ = _run_main(port_vit.main, argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_p == 0 and out_p.splitlines() == out_j.splitlines()
    argv = ["-m", files["q8"], "-d", files["dir"], "-b", "2", "-k", "3", "--dtype", "f32",
            "--mm", "pallas", "--attn", "xla"]
    rc_j, out_j, _ = _run_main(jax_serve.main, argv, capsys)
    rc_p, out_p, _ = _run_main(port_serve.main, argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_p == 0 and out_p.splitlines() == out_j.splitlines()
    assert len(out_p.splitlines()) == 5
    # at the serving defaults (bf16, W8A8, folded, fast fused attention)
    rc, out, _ = _run_main(port_serve.main, ["-m", files["f16"], "-d", files["dir"],
                                             "--device", "cpu"], capsys)
    assert rc == 0 and len(out.splitlines()) == 5


def test_daemon_serves_an_moe_file_as_the_jax_daemon(files):
    """cli.server on the MoE file, /v1/classify and /v1/embed: the JAX
    daemon's answers (f32, composed attention)."""
    from tests.test_torch_tome import _daemon_answers
    from vit_cpp_tpu import server as jax_server_mod
    from vit_cpp_tpu.cli.server import main as jax_main
    from vit_cpp_tpu_torch import server as server_mod
    from vit_cpp_tpu_torch.cli.server import main

    with open(os.path.join(REPO, "assets", "magpie.jpeg"), "rb") as f:
        body = f.read()
    argv = ["-m", files["f16"], "--dtype", "f32", "--mm", "xla", "--attn", "xla", "-b", "2",
            "--no-warmup"]
    routes = ["/v1/classify?topk=5", "/v1/embed"]
    got, engines = _daemon_answers(server_mod, main, argv + ["--device", "cpu"], routes, body)
    want, _ = _daemon_answers(jax_server_mod, jax_main, argv, routes, body)
    assert engines[None].hp.num_experts == 4
    top, jtop = got[routes[0]]["topk"], want[routes[0]]["topk"]
    assert [c["id"] for c in top] == [c["id"] for c in jtop]
    np.testing.assert_allclose([c["prob"] for c in top], [c["prob"] for c in jtop], atol=F32_TOL)
    np.testing.assert_allclose(got[routes[1]]["embedding"], want[routes[1]]["embedding"],
                               atol=F32_TOL * 10)


def test_run_eval_on_an_moe_file_matches_jax(files, tmp_path, capsys):
    """vit-benchmark's run_eval: the same CSV and accuracy."""
    from vit_cpp_tpu.cli import benchmark as jax_benchmark
    from vit_cpp_tpu_torch.cli import benchmark

    val = tmp_path / "val"
    for c in ("class_1", "class_4"):
        os.makedirs(val / c)
        for i in range(2):
            os.link(os.path.join(files["dir"], f"{i + (c == 'class_4') * 2}.png"),
                    val / c / f"{i}.png")
    outs = {}
    for name, run_eval, kw in (("jax", jax_benchmark.run_eval, {}),
                               ("port", benchmark.run_eval, {"device": "cpu"})):
        csv = str(tmp_path / f"{name}.csv")
        acc = run_eval(files["f16"], str(val), 0, csv, batch=2, verbose=False, ext=".png", **kw)
        capsys.readouterr()
        with open(csv) as f:
            outs[name] = (acc, f.read())
    assert outs["port"] == outs["jax"] and len(outs["port"][1].splitlines()) == 4


def test_explain_maps_run_the_routed_layers(files):
    """vit-explain's one maps forward on an MoE file: its head gives the
    engine's logits (the routed MLPs ran in layers 1 and 3), so its top-k
    is classify_file's. The JAX package's maps forward runs every layer's
    MLP dense from the stacked fc1/fc2 by layer index, which for an MoE
    tree holds the dense layers only: its top-k is not its own
    classify_file's (ROADMAP C)."""
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.models.attention_maps import attention_maps, head_logits

    engine = VitEngine(files["f16"], device="cpu", verbose=False)
    x = torch.from_numpy(_images(2, seed=2))
    maps, final = attention_maps(engine.params, x, engine.hp)
    assert maps.shape == (2, 4, 4, 17, 17)
    np.testing.assert_allclose(head_logits(engine.params, final, engine.hp).numpy(),
                               forward(engine.params, x, engine.hp).numpy(), atol=F32_TOL, rtol=0)
    img = os.path.join(REPO, "assets", "magpie.jpeg")
    top = engine.explain_file(img, topk=3)[0]
    want = engine.classify_file(img, topk=3, verbose=False)
    assert [c for c, _, _ in top] == [c for c, _, _ in want]
    np.testing.assert_allclose([p for _, p, _ in top], [p for _, p, _ in want], atol=F32_TOL)
    jax_engine = JaxVitEngine(files["f16"], verbose=False)
    jax_top = jax_engine.explain_file(img, topk=3)[0]
    jax_want = jax_engine.classify_file(img, topk=3, verbose=False)
    np.testing.assert_allclose([p for _, p, _ in jax_want], [p for _, p, _ in want], atol=F32_TOL)
    assert abs(jax_top[0][1] - jax_want[0][1]) > 1e-3
