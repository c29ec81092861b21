"""The port's card-side diagnostics against the JAX tools' kernels.

For every variant of the attention-forward anatomy (head-pair and
lane-panel forms) and the attention-backward anatomy, the port's plain
PyTorch version (what its functions run on CPU tensors) equals the JAX
tool's kernel body run through pl.pallas_call(..., interpret=True) with
the tool's own BlockSpecs; the int8 probe's plain product equals the
integer product and the JAX probe kernel. Inputs are f32, made with numpy
from a seed and handed to both. The CUDA kernels are held against the
plain versions on the card (the `cuda` tests below, and chip_smoke.py).

Tolerances, relative to max|JAX|: 1e-5 for f32 summation order (the two
sum the same products in another order; about 5e-7 is seen). bf16exp
rounds scores and exponents to bf16: where the two orders put a value on
either side of a bf16 rounding boundary, that weight moves by one bf16
step, 2^-8 of itself, so its tolerance is 2^-8 (about 1.5e-3 is seen).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vit_cpp_tpu_torch.ops import flash_attention as fa
from vit_cpp_tpu_torch.tools import attn_anatomy as ta
from vit_cpp_tpu_torch.tools import attn_grad_anatomy as tg
from vit_cpp_tpu_torch.tools import grad_variants as gv
from vit_cpp_tpu_torch.tools import probe_int8_dot as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
BF16EXP_TOL = 2.0 ** -8


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JA, JG, JP = _jax_tool("attn_anatomy"), _jax_tool("attn_grad_anatomy"), _jax_tool("probe_int8_dot")


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


def _jax_pair(qkv, variant, nh):
    """tools/attn_anatomy.py::run_pair_variant's call, in interpret mode."""
    b, t, three_h = qkv.shape
    h = three_h // 3
    f = pl.pallas_call(
        functools.partial(JA._pair_kernel, nh=nh, variant=variant), grid=(b,),
        in_specs=[_vmem((1, t, three_h), lambda i: (i, 0, 0))],
        out_specs=_vmem((1, t, h), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, t, h), jnp.float32), interpret=True,
    )
    return np.asarray(f(jnp.asarray(qkv)))


def _jax_lane(qkv, variant, d, width=1):
    """tools/attn_anatomy.py::run_variant's call, in interpret mode."""
    b, t, three_h = qkv.shape
    h = three_h // 3
    wb = h // 128 // width

    def sec_spec(section):
        return _vmem((1, t, 128 * width), lambda i, j, s=section: (i, 0, s * wb + j))

    f = pl.pallas_call(
        functools.partial(JA._kernel, d=d, variant=variant), grid=(b, wb),
        in_specs=[sec_spec(0), sec_spec(1), sec_spec(2)],
        out_specs=_vmem((1, t, 128 * width), lambda i, j: (i, 0, j)),
        out_shape=jax.ShapeDtypeStruct((b, t, h), jnp.float32), interpret=True,
    )
    x = jnp.asarray(qkv)
    return np.asarray(f(x, x, x))


def _jax_grad(qkv, do, variant, nh):
    """tools/attn_grad_anatomy.py::run_variant's call, in interpret mode."""
    b, t, three_h = qkv.shape
    h = three_h // 3
    f = pl.pallas_call(
        functools.partial(JG._grad_pair_kernel, nh=nh, variant=variant), grid=(b,),
        in_specs=[_vmem((1, t, three_h), lambda i: (i, 0, 0)),
                  _vmem((1, t, h), lambda i: (i, 0, 0))],
        out_specs=_vmem((1, t, three_h), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, t, three_h), jnp.float32), interpret=True,
    )
    return np.asarray(f(jnp.asarray(qkv), jnp.asarray(do)))


def _close(got, want, variant):
    tol = (BF16EXP_TOL if variant == "bf16exp" else F32_TOL) * np.abs(want).max()
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= tol, f"{variant}: max|port - jax| = {err} > {tol}"


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("variant", ta.VARIANTS)
def test_pair_plain_matches_jax_kernel(variant):
    qkv = _normal(1, 2, 37, 3 * 64)  # h=64, nh=4: d=16, onedot needs T >= 32
    got = ta.pair_variant(torch.from_numpy(qkv), variant, 4).numpy()
    _close(got, _jax_pair(qkv, variant, 4), variant)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("variant", ta.VARIANTS)
def test_lane_plain_matches_jax_kernel(variant, d):
    qkv = _normal(d, 2, 130, 3 * 128)  # one 128-lane panel of 128/d heads
    got = ta.lane_variant(torch.from_numpy(qkv), variant, d).numpy()
    _close(got, _jax_lane(qkv, variant, d), variant)


def test_lane_plain_matches_jax_kernel_over_wide_panels():
    qkv = _normal(7, 1, 128, 3 * 256)  # two panels, w=2 in one grid step
    got = ta.lane_variant(torch.from_numpy(qkv), "full", 64).numpy()
    _close(got, _jax_lane(qkv, "full", 64, width=2), "full")


@pytest.mark.parametrize("variant", tg.VARIANTS)
def test_grad_plain_matches_jax_kernel(variant):
    qkv, do = _normal(2, 2, 37, 3 * 64), _normal(3, 2, 37, 64)  # nh=4: pipe2 runs
    got = tg.grad_variant(torch.from_numpy(qkv), torch.from_numpy(do), variant, 4).numpy()
    _close(got, _jax_grad(qkv, do, variant, 4), variant)


def _jax_dot(a, b, acc):
    m, n = a.shape[0], b.shape[1]
    f = pl.pallas_call(
        functools.partial(JP._dot_kernel, acc=acc),
        out_shape=jax.ShapeDtypeStruct((m, n), acc),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True,
    )
    return np.asarray(f(jnp.asarray(a), jnp.asarray(b)))


def test_int8_plain_product_is_exact():
    rng = np.random.default_rng(4)
    a = rng.integers(-128, 128, (64, 256), dtype=np.int8)
    b = rng.integers(-128, 128, (256, 128), dtype=np.int8)
    got = tp.dot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, a.astype(np.int64) @ b.astype(np.int64))
    np.testing.assert_array_equal(got, _jax_dot(a, b, jnp.int32))


def test_bf16_plain_product_matches_jax_kernel():
    rng = np.random.default_rng(5)
    a = jnp.asarray(rng.standard_normal((64, 96)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((96, 64)), jnp.bfloat16)
    pa, pb = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (a, b))
    got = tp.dot(pa, pb).numpy()
    want = _jax_dot(a, b, jnp.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


# the W8A8 linears' K and N at a short M: fc2 (3072 -> 768) and qkv (768 -> 2304)
W8A8_SHAPES = {"fc2": (64, 3072, 768), "qkv": (64, 768, 2304)}


@pytest.mark.parametrize("shape", W8A8_SHAPES.values(), ids=W8A8_SHAPES.keys())
def test_int8_plain_product_is_exact_at_w8a8_shapes(shape):
    m, k, n = shape
    rng = np.random.default_rng(12)
    a = rng.integers(-128, 128, (m, k), dtype=np.int8)
    b = rng.integers(-128, 128, (k, n), dtype=np.int8)
    got = tp.dot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, a.astype(np.int64) @ b.astype(np.int64))
    np.testing.assert_array_equal(got, _jax_dot(a, b, jnp.int32))
    nk = tp.dot_nk(torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b.T))).numpy()
    np.testing.assert_array_equal(nk, got)


@pytest.mark.parametrize("shape", W8A8_SHAPES.values(), ids=W8A8_SHAPES.keys())
def test_bf16_plain_product_matches_jax_kernel_at_w8a8_shapes(shape):
    m, k, n = shape
    rng = np.random.default_rng(13)
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    pa, pb = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (a, b))
    got = tp.dot(pa, pb).numpy()
    want = _jax_dot(a, b, jnp.float32)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())


# `full` is K1's fast path and K2's path: the plain versions are the same
# arithmetic, so they agree bit for bit (qkv (2, 37, 384): h=128, 4 heads
# of d=32, one 128-lane panel)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("form", ["pair", "lane"])
def test_forward_full_plain_is_k1_fast_plain(form, dtype):
    qkv = torch.from_numpy(_normal(9, 2, 37, 384)).to(dtype)
    got = ta.pair_variant(qkv, "full", 4) if form == "pair" else ta.lane_variant(qkv, "full", 32)
    assert got.dtype == dtype
    assert torch.equal(got, fa.attention_qkv_plain(qkv, 4, fast=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_backward_full_plain_is_k2_plain(dtype):
    qkv = torch.from_numpy(_normal(10, 2, 37, 384)).to(dtype)
    do = torch.from_numpy(_normal(11, 2, 37, 128)).to(dtype)
    got = tg.grad_variant(qkv, do, "full", 4)
    assert got.dtype == dtype
    assert torch.equal(got, fa.attention_qkv_grad_plain(qkv, do, 4))


@pytest.mark.parametrize("call", [
    lambda x, g: ta.pair_variant(x, "full", 3),          # odd head count
    lambda x, g: ta.pair_variant(x, "bogus", 4),
    lambda x, g: ta.pair_variant(x[:, :20], "onedot", 2),  # T < 2d
    lambda x, g: ta.lane_variant(x, "full", 48),          # 48 does not divide 128
    lambda x, g: tg.grad_variant(x, g, "pipe2", 2),       # pipe2 needs nh % 4 == 0
    lambda x, g: tg.grad_variant(x, g[:, :, :8], "full", 4),
    lambda x, g: tp.dot(x[0], x[0]),
    lambda x, g: tp.dot_nk(x[0], x[0].t()),
    lambda x, g: tp.dot_nk(x[0], x[0, 0]),
], ids=["odd-nh", "variant", "onedot-short", "lane-d", "pipe2-nh", "do-shape", "dot-shape",
        "dot-nk-shape", "dot-nk-1d"])
def test_bad_arguments_raise(call):
    x, g = torch.from_numpy(_normal(6, 2, 37, 3 * 64)), torch.from_numpy(_normal(7, 2, 37, 64))
    with pytest.raises(ValueError):
        call(x, g)


# At d=64 both forms group two heads (the pair form always, the lane form
# 128/d), so they are one computation in every variant but onedot, which
# stores the group's first head's scores (pair) or the group's summed
# scores (lane); the d=64 kernels lean on this.
@pytest.mark.parametrize("variant", ta.VARIANTS)
def test_forms_agree_at_d64_but_onedot(variant):
    qkv = torch.from_numpy(_normal(14, 2, 130, 3 * 256))  # 4 heads of d=64
    pair = ta.pair_variant(qkv, variant, 4)
    lane = ta.lane_variant(qkv, variant, 64)
    assert torch.equal(pair, lane) == (variant != "onedot")


def test_lane_mxusum_needs_two_heads_per_panel():
    with pytest.raises(ValueError, match="two heads"):
        ta.lane_variant(torch.zeros(1, 128, 3 * 128), "mxusum", 128)


def test_cpu_tensors_launch_no_kernel():
    kernels = (ta.PAIR_KERNEL, ta.LANE_KERNEL, tg.KERNEL, tp.KERNEL)
    before = [k.launches for k in kernels]
    x = torch.from_numpy(_normal(8, 1, 128, 3 * 128))
    ta.pair_variant(x, "full", 2)
    ta.lane_variant(x, "full", 64)
    tg.grad_variant(x, x[:, :, :128].contiguous(), "full", 2)
    tp.dot(torch.ones(64, 64, dtype=torch.int8), torch.ones(64, 64, dtype=torch.int8))
    tp.dot_nk(torch.ones(64, 64, dtype=torch.int8), torch.ones(64, 64, dtype=torch.int8))
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("tool,argv", [
    ("attn_anatomy", ["--kernel", "pair", "--t", "8", "--h", "128", "--b", "1"]),
    ("attn_grad_anatomy", ["--t", "8", "--h", "128", "--b", "1"]),
    ("probe_int8_dot", []),
    ("grad_variants", ["no-such-csrc-copy"]),
    ("grad_variants", ["--entry", "k1", "no-such-csrc-copy"]),
    ("grad_variants", ["--entry", "k1", "--dtype", "f32", "no-such-csrc-copy"]),
])
def test_tools_exit_nonzero_without_a_card(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    mod = {"attn_anatomy": ta, "attn_grad_anatomy": tg, "probe_int8_dot": tp,
           "grad_variants": gv}[tool]
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code not in (0, None)


# kernel vs plain on the card, relative to max|plain|: bf16 outputs of
# the same f32 arithmetic, summed in another order, round up to one bf16
# step apart (2^-8); 2e-2 leaves margin for the products of rounded p.
CARD_TOL = 2e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ta.VARIANTS)
def test_forward_kernels_match_plain_on_card(variant):
    gen = _card()
    qkv = torch.randn((2, 197, 3 * 768), generator=gen, device="cuda").to(torch.bfloat16)
    for kernel, fn, plain, arg in (
        (ta.PAIR_KERNEL, ta.pair_variant, ta.pair_variant_plain, 12),
        (ta.LANE_KERNEL, ta.lane_variant, ta.lane_variant_plain, 64),
    ):
        before = kernel.launches
        got, ref = fn(qkv, variant, arg).float(), plain(qkv, variant, arg).float()
        assert kernel.launches == before + 1
        assert (got - ref).abs().max().item() <= CARD_TOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", tg.VARIANTS)
def test_backward_kernel_matches_plain_on_card(variant):
    gen = _card()
    qkv = torch.randn((2, 197, 3 * 768), generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn((2, 197, 768), generator=gen, device="cuda").to(torch.bfloat16)
    got = tg.grad_variant(qkv, do, variant, 12).float()
    ref = tg.grad_variant_plain(qkv, do, variant, 12).float()
    assert (got - ref).abs().max().item() <= CARD_TOL * ref.abs().max().item()


@pytest.mark.cuda
def test_probe_kernel_on_card():
    gen = _card()
    a = torch.randint(-127, 128, (256, 512), generator=gen, device="cuda").to(torch.int8)
    b = torch.randint(-127, 128, (512, 128), generator=gen, device="cuda").to(torch.int8)
    assert torch.equal(tp.dot(a, b), tp.dot_plain(a, b))
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    got, ref = tp.dot(ab, bb), tp.dot_plain(ab, bb)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# The wgmma probe at 1024^3 (64 x 128 tiles), at the W8A8 linears' long
# K and wide N with M % 128 != 0 (128 x 128 tiles, several a block: a
# wrong lbo shows in the columns, a ring that wraps wrongly in the long K,
# the last row tile is partial), and at K short of the 128-byte step
# (TMA's zero fill, also past the whole of a short K) with N % 128 != 0:
# int8 exact, both B layouts; bf16 within the probe's 1e-5 of max|plain|.
PROBE_CARD_CASES = [
    pytest.param((1024, 1024, 1024), torch.int8, id="1024^3-int8"),
    pytest.param((1024, 1024, 1024), torch.bfloat16, id="1024^3-bf16"),
    pytest.param((1088, 3072, 2304), torch.int8, id="k3072-n2304-int8"),
    pytest.param((1088, 3072, 2304), torch.bfloat16, id="k3072-n2304-bf16"),
    pytest.param((128, 64, 192), torch.int8, id="k64-int8"),
    pytest.param((128, 96, 192), torch.bfloat16, id="k96-bf16"),
    pytest.param((64, 32, 64), torch.bfloat16, id="k32-bf16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", PROBE_CARD_CASES)
def test_probe_kernel_on_card_at_shapes(shape, dtype):
    gen = _card()
    m, k, n = shape
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda").to(dtype)
    b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(dtype)
    if dtype == torch.bfloat16:
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
    before = tp.KERNEL.launches
    got, ref = tp.dot(a, b), tp.dot_plain(a, b)
    assert tp.KERNEL.launches == before + 1
    if dtype == torch.int8:
        assert torch.equal(got, ref)
        assert torch.equal(tp.dot_nk(a, b.t().contiguous()), ref)
    else:
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# The anatomies' `full` against K1 (fast, bf16) and K2 (bf16) on the same
# tensors, bit for bit: the same bodies at the default stages. T1 and T2
# take K1's and K2's own bodies at every d: at d=64 their bf16 wgmma
# bodies (T1's `full` is then also K1's mma.sync body, reached through the
# check-only `attention_qkv_mma`: the two bodies are bit-equal at d=64),
# at d=72, 32 and 128 the mma.sync bodies. d=72 and d=32 run the
# anatomy's widths rounded up to 64 (zero columns add exactly 0); d=128
# the pair form's 256-lane groups and the lane form's one-head panels.
@pytest.mark.cuda
@pytest.mark.parametrize("form,nh,d", [
    ("pair", 12, 64), ("pair", 2, 72), ("pair", 4, 128),
    ("lane", 12, 64), ("lane", 4, 32), ("lane", 2, 128),
])
def test_forward_full_kernel_is_k1_on_card(form, nh, d):
    gen = _card()
    qkv = torch.randn((2, 197, 3 * nh * d), generator=gen, device="cuda").to(torch.bfloat16)
    got = ta.pair_variant(qkv, "full", nh) if form == "pair" else ta.lane_variant(qkv, "full", d)
    assert torch.equal(got, fa.attention_qkv(qkv, nh, fast=True))
    if d == 64:
        assert torch.equal(got, fa.attention_qkv_mma(qkv, nh, fast=True))


# T1 at d=64 on the edges of K1's wgmma body: one 64-query tile and its
# neighbours (T=1, 63, 64, 65), ViT-B/16's T, the last length whose keys
# stay resident and one past it (256, 257: the ring of 4 chunks), the lane
# shape (785); 2 and 12 heads (at d=64 both forms group two heads). Every
# variant of both forms against plain (onedot stores 2d key columns: T >=
# 128), `full` bit-equal to K1.
@pytest.mark.cuda
@pytest.mark.parametrize("nh", [2, 12])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 197, 256, 257, 785])
def test_forward_kernels_match_plain_on_card_at_wgmma_edges(t, nh):
    gen = _card()
    qkv = torch.randn((2, t, 3 * 64 * nh), generator=gen, device="cuda").to(torch.bfloat16)
    k1 = fa.attention_qkv(qkv, nh, fast=True)
    for kernel, fn, plain, arg in (
        (ta.PAIR_KERNEL, ta.pair_variant, ta.pair_variant_plain, nh),
        (ta.LANE_KERNEL, ta.lane_variant, ta.lane_variant_plain, 64),
    ):
        for variant in ta.VARIANTS:
            if variant == "onedot" and t < 128:
                continue
            before = kernel.launches
            got = fn(qkv, variant, arg)
            assert kernel.launches == before + 1
            if variant == "full":
                assert torch.equal(got, k1)
            got, ref = got.float(), plain(qkv, variant, arg).float()
            assert torch.isfinite(got).all()
            assert (got - ref).abs().max().item() <= CARD_TOL * ref.abs().max().item(), variant


@pytest.mark.cuda
@pytest.mark.parametrize("nh,d", [(12, 64), (4, 72), (4, 128)])
def test_backward_full_kernel_is_k2_on_card(nh, d):
    gen = _card()
    qkv = torch.randn((2, 197, 3 * nh * d), generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn((2, 197, nh * d), generator=gen, device="cuda").to(torch.bfloat16)
    assert torch.equal(tg.grad_variant(qkv, do, "full", nh), fa.attention_qkv_grad(qkv, do, nh))


# every variant at the widths the flagship shape does not reach: d=128
# (the pair form's nomask and T2's onedot over 256 lanes) and d=32
@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("variant", ta.VARIANTS)
def test_forward_kernels_match_plain_on_card_at_other_widths(variant, d):
    gen = _card()
    nh = 512 // d
    qkv = torch.randn((2, 300, 3 * 512), generator=gen, device="cuda").to(torch.bfloat16)
    for fn, plain, arg in ((ta.pair_variant, ta.pair_variant_plain, nh),
                           (ta.lane_variant, ta.lane_variant_plain, d)):
        if fn is ta.lane_variant and variant == "mxusum" and d == 128:
            continue  # the lane form refuses it (test_lane_mxusum_needs_two_heads_per_panel)
        got, ref = fn(qkv, variant, arg).float(), plain(qkv, variant, arg).float()
        assert (got - ref).abs().max().item() <= CARD_TOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("variant", [v for v in tg.VARIANTS if v not in ("pipe", "pipe2")])
def test_backward_kernel_matches_plain_on_card_at_other_widths(variant, d):
    gen = _card()
    nh = 512 // d
    qkv = torch.randn((2, 300, 3 * 512), generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn((2, 300, 512), generator=gen, device="cuda").to(torch.bfloat16)
    got = tg.grad_variant(qkv, do, variant, nh).float()
    ref = tg.grad_variant_plain(qkv, do, variant, nh).float()
    assert (got - ref).abs().max().item() <= CARD_TOL * ref.abs().max().item()
