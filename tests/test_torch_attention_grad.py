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

The kernel's f32 body computes its products as 3xTF32 on the tensor
cores; a test below emulates TF32 rounding on the CPU and holds 3xTF32
products, and not single TF32 ones, within the card's tolerance (1e-4 of
max|plain|) of the plain version.
"""

import math

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
    # the edges of the tiling: 64-row blocks of 16-row warps, chunks of 32
    # (bf16: 16) keys or queries, 8-wide steps, d padded to 16
    cases += [(2, t, 4, d, sizes) for t, d, sizes in (
        (1, 64, False), (63, 64, False), (64, 64, False), (65, 64, True), (129, 64, False),
        (197, 72, False), (197, 128, False), (65, 128, True))]
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


def test_aligned_copies_a_misaligned_tensor():
    # a view 4 bytes past a 16-byte boundary comes back aligned and equal;
    # an aligned contiguous tensor comes back as it is
    flat = torch.arange(65, dtype=torch.float32)
    view = flat[1:]
    assert view.data_ptr() % 16 and view.is_contiguous()
    got = port._aligned(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    torch.testing.assert_close(got, view, rtol=0, atol=0)
    aligned = torch.zeros(2, 8)
    assert port._aligned(aligned) is aligned
    strided = torch.arange(12.0).reshape(3, 4).t()
    got = port._aligned(strided)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    torch.testing.assert_close(got, strided, rtol=0, atol=0)


_LOG2E = 1.4426950408889634


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero) by bit masking, in f32: what the card's tensor cores take."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """The kernel's f32 product: hi = tf32(x), lo = tf32(x - hi), and
    lo*hi + hi*lo + hi*hi in f32."""
    ah, bh = _tf32(a), _tf32(b)
    return torch.matmul(_tf32(a - ah), bh) + torch.matmul(ah, _tf32(b - bh)) + torch.matmul(ah, bh)


def _mm_1xtf32(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


def _grad_with(mm, qkv, do, nh):
    """attention_qkv_grad_plain's f32 math with each of its five products
    through `mm`."""
    b, t, three_h = qkv.shape
    h = three_h // 3
    d = h // nh
    x = qkv.reshape(b, t, 3, nh, d).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]
    g = do.reshape(b, t, nh, d).permute(0, 2, 1, 3)
    s = mm(q * (_LOG2E / math.sqrt(d)), k.transpose(-1, -2))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    pn = p / p.sum(dim=-1, keepdim=True)
    dv = mm(pn.transpose(-1, -2), g)
    dp = mm(g, v.transpose(-1, -2))
    ds = pn * (dp - (dp * pn).sum(dim=-1, keepdim=True))
    nat = 1.0 / math.sqrt(d)
    out = torch.stack([mm(ds, k) * nat, mm(ds.transpose(-1, -2), q) * nat, dv])
    return out.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h)


def test_3xtf32_products_hold_the_f32_tolerance_and_1xtf32_do_not():
    # one ViT-B/16 head pair: nh=2, d=64, T=197, B=1
    qkv, do, _ = _inputs(1, 197, 2, 64, seed=0)
    x, g = torch.from_numpy(qkv), torch.from_numpy(do)
    plain = port.attention_qkv_grad_plain(x, g, 2)
    # the emulation is the plain math: exact with full f32 products
    torch.testing.assert_close(_grad_with(torch.matmul, x, g, 2), plain, rtol=0, atol=0)
    tol = 1e-4 * plain.abs().max().item()  # chip_smoke.GRAD_TOL[f32]
    err3 = (_grad_with(_mm_3xtf32, x, g, 2) - plain).abs().max().item()
    err1 = (_grad_with(_mm_1xtf32, x, g, 2) - plain).abs().max().item()
    assert err3 <= tol / 10
    assert err1 > 2 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_takes_a_misaligned_qkv_and_do_on_card(dtype):
    # views 4 (f32) or 2 (bf16) bytes past a 16-byte boundary: the wrapper
    # copies them first
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    qkv, do, _ = _inputs(2, 197, 12, 64, seed=5)
    x, g = (torch.from_numpy(a).to("cuda", dt) for a in (qkv, do))
    shifted = []
    for a in (x, g):
        flat = torch.empty(a.numel() + 1, dtype=dt, device="cuda")
        view = flat[1:].view(a.shape)
        view.copy_(a)
        assert view.data_ptr() % 16 and view.is_contiguous()
        shifted.append(view)
    before = port.GRAD_KERNEL.launches
    got = port.attention_qkv_grad(*shifted, 12)
    torch.testing.assert_close(got, port.attention_qkv_grad(x, g, 12), rtol=0, atol=0)
    ref = port.attention_qkv_grad_plain(x, g, 12).float()
    tol = (1e-4 if dt == torch.float32 else 2e-2) * ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() <= tol
    assert port.GRAD_KERNEL.launches == before + 2
