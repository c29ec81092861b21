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

from vit_cpp_tpu_torch.tools import attn_anatomy as ta
from vit_cpp_tpu_torch.tools import attn_grad_anatomy as tg
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


@pytest.mark.parametrize("call", [
    lambda x, g: ta.pair_variant(x, "full", 3),          # odd head count
    lambda x, g: ta.pair_variant(x, "bogus", 4),
    lambda x, g: ta.pair_variant(x[:, :20], "onedot", 2),  # T < 2d
    lambda x, g: ta.lane_variant(x, "full", 48),          # 48 does not divide 128
    lambda x, g: tg.grad_variant(x, g, "pipe2", 2),       # pipe2 needs nh % 4 == 0
    lambda x, g: tg.grad_variant(x, g[:, :, :8], "full", 4),
    lambda x, g: tp.dot(x[0], x[0]),
], ids=["odd-nh", "variant", "onedot-short", "lane-d", "pipe2-nh", "do-shape", "dot-shape"])
def test_bad_arguments_raise(call):
    x, g = torch.from_numpy(_normal(6, 2, 37, 3 * 64)), torch.from_numpy(_normal(7, 2, 37, 64))
    with pytest.raises(ValueError):
        call(x, g)


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
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("tool,argv", [
    ("attn_anatomy", ["--kernel", "pair", "--t", "8", "--h", "128", "--b", "1"]),
    ("attn_grad_anatomy", ["--t", "8", "--h", "128", "--b", "1"]),
    ("probe_int8_dot", []),
])
def test_tools_exit_nonzero_without_a_card(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    mod = {"attn_anatomy": ta, "attn_grad_anatomy": tg, "probe_int8_dot": tp}[tool]
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
