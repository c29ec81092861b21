"""The port's attention backward against the JAX package's.

On the CPU the port's `attention_qkv_grad` runs its plain PyTorch version
and `attention_qkv_train` runs the plain forward and backward; the JAX
backward kernels run in Pallas interpret mode, as the JAX package's own
tests run them. Inputs are made with numpy from a seed and handed to
both. The CUDA kernel is held against the plain version on the card (the
`cuda` test below, and chip_smoke.py).

Tolerances: f32 on both sides, differing only in summation order:
1e-5 absolute and relative on the cotangents (O(1) values) of the kernel
bodies; through the autograd function, where the cotangent of sum(o * w)
passes one more product, 3e-5 absolute and 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.ops import flash_attention as jfa
from vit_cpp_tpu_torch.ops import flash_attention as port

TOL = dict(atol=1e-5, rtol=1e-5)
GEOMETRIES = [(2, 64, 29), (3, 64, 29), (2, 32, 37), (2, 80, 23)]  # (nh, d, T)


def _inputs(b, t, nh, d, seed, sizes=False):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, t, 3 * nh * d)).astype(np.float32)
    do = rng.standard_normal((b, t, nh * d)).astype(np.float32)
    sz = rng.integers(1, 5, (b, t)).astype(np.float32) if sizes else None
    return qkv, do, sz


def _port_grad(qkv, do, nh, sz):
    return port.attention_qkv_grad(
        torch.from_numpy(qkv), torch.from_numpy(do), nh,
        sizes=None if sz is None else torch.from_numpy(sz),
    ).numpy()


@pytest.mark.parametrize("nh,d,t", GEOMETRIES)
@pytest.mark.parametrize("sizes", [False, True], ids=["nosizes", "sizes"])
@pytest.mark.parametrize("pair", [True, False], ids=["pair", "carve"])
def test_plain_matches_jax_kernel(nh, d, t, sizes, pair):
    qkv, do, sz = _inputs(2, t, nh, d, seed=t + nh + d, sizes=sizes)
    ref = jfa._attention_qkv_grad(
        jnp.asarray(qkv), jnp.asarray(do), nh, interpret=True, pair=pair,
        sizes=None if sz is None else jnp.asarray(sz),
    )
    got = _port_grad(qkv, do, nh, sz)
    assert got.shape == (2, t, 3 * nh * d)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("nh,d", [(2, 64), (1, 128)])
@pytest.mark.parametrize("sizes", [False, True], ids=["nosizes", "sizes"])
def test_plain_matches_jax_lane_kernel(nh, d, sizes):
    qkv, do, sz = _inputs(2, 29, nh, d, seed=d, sizes=sizes)
    ref = jfa._attention_qkv_grad_lane(
        jnp.asarray(qkv), jnp.asarray(do), nh, True,
        sizes=None if sz is None else jnp.asarray(sz),
    )
    np.testing.assert_allclose(_port_grad(qkv, do, nh, sz), np.asarray(ref), **TOL)


@pytest.mark.parametrize("sizes", [False, True], ids=["nosizes", "sizes"])
def test_train_value_and_grad_match_jax(sizes):
    nh, d, t = 2, 64, 23
    qkv, w, sz = _inputs(2, t, nh, d, seed=3, sizes=sizes)
    jsz = None if sz is None else jnp.asarray(sz)

    def jloss(x):
        o = jfa.attention_qkv_train(x, nh, jsz)
        return jnp.sum(o * jnp.asarray(w)), o

    (_, o_ref), g_ref = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(qkv))

    x = torch.from_numpy(qkv).requires_grad_(True)
    tsz = None if sz is None else torch.from_numpy(sz).requires_grad_(True)
    o = port.attention_qkv_train(x, nh, tsz)
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), atol=3e-5, rtol=1e-4)
    if tsz is not None:
        assert tsz.grad is None  # ToMe sizes get no cotangent


def test_gradcheck_plain_path_float64():
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((1, 5, 3 * 2 * 8))).requires_grad_(True)
    sizes = torch.from_numpy(rng.integers(1, 4, (1, 5)).astype(np.float64))
    assert torch.autograd.gradcheck(lambda x: port.attention_qkv_train(x, 2), (qkv,))
    assert torch.autograd.gradcheck(lambda x: port.attention_qkv_train(x, 2, sizes), (qkv,))


def test_cpu_runs_plain_version_and_counts_no_launch():
    qkv, do, _ = _inputs(1, 7, 2, 8, seed=1)
    x, g = torch.from_numpy(qkv), torch.from_numpy(do)
    got = port.attention_qkv_grad(x, g, 2)
    torch.testing.assert_close(got, port.attention_qkv_grad_plain(x, g, 2), rtol=0, atol=0)
    # a non-contiguous cotangent (as autograd may hand it over) gives the same
    g_t = torch.from_numpy(np.ascontiguousarray(do.transpose(0, 2, 1))).transpose(1, 2)
    assert not g_t.is_contiguous()
    torch.testing.assert_close(port.attention_qkv_grad(x, g_t, 2), got, rtol=0, atol=0)
    assert port.GRAD_KERNEL.launches == 0
    with pytest.raises(ValueError):
        port.attention_qkv_grad(x, g[:, :, :8], 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    before = port.GRAD_KERNEL.launches
    cases = [(2, 197, 12, 64, False), (2, 197, 12, 64, True), (1, 257, 3, 80, False),
             (1, 130, 3, 64, True)]
    for b, t, nh, d, sizes in cases:
        qkv, do, sz = _inputs(b, t, nh, d, seed=t, sizes=sizes)
        x, g = (torch.from_numpy(a).to("cuda", dt) for a in (qkv, do))
        s = None if sz is None else torch.from_numpy(sz).to("cuda")
        got = port.attention_qkv_grad(x, g, nh, sizes=s).float()
        ref = port.attention_qkv_grad_plain(x, g, nh, sizes=s).float()
        scale = ref.abs().max().item()
        tol = (1e-4 if dt == torch.float32 else 2e-2) * scale
        assert (got - ref).abs().max().item() <= tol
    assert port.GRAD_KERNEL.launches == before + len(cases)
