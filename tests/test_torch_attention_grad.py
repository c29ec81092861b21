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

The kernel's f32 bodies compute their products as 3xTF32 on the tensor
cores; a test below emulates TF32 rounding on the CPU and holds 3xTF32
products, and not single TF32 ones, within the card's tolerance (1e-4 of
max|plain|) of the plain version. Another emulates the arithmetic of the
f32 body at d = 64, 80 and 88 (csrc/attention_grad_wgmma.cuh): its split,
its three TF32 terms per 8-deep step with each wgmma's sum truncated toward
zero, and its per-chunk drains and two warpgroups' partial sums, against
the plain version and the JAX kernel. A third emulates the bf16 body at d = 64
(csrc/attention_grad_bf16_wgmma.cuh): its rounding points (qs, pn, ds and
the packed bf16 A operands) and its chains of 16-deep wgmma sums, against
the plain version and the JAX kernel in bf16 (2e-2 of the largest value,
chip_smoke.GRAD_TOL[bf16]). The `cuda` tests hold the wgmma bodies, the
mma.sync bodies behind the check-only `attention_qkv_grad_mma` and the
plain version to one another on the card.
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
GEOMETRIES = [(2, 64, 29), (3, 64, 29), (2, 32, 37), (2, 80, 23), (2, 88, 23)]  # (nh, d, T)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [False, True], ids=["nosizes", "sizes"])
def test_mma_entry_on_cpu_is_the_plain_version_and_counts_no_launch(dtype, sizes):
    qkv, do, sz = _inputs(2, 29, 2, 64, seed=7, sizes=sizes)
    dt = getattr(torch, dtype)
    x, g = (torch.from_numpy(a).to(dt) for a in (qkv, do))
    s = None if sz is None else torch.from_numpy(sz)
    before = (port.GRAD_KERNEL.launches, port.GRAD_MMA_KERNEL.launches)
    got = port.attention_qkv_grad_mma(x, g, 2, sizes=s)
    assert got.dtype == dt
    torch.testing.assert_close(got, port.attention_qkv_grad_plain(x, g, 2, sizes=s), rtol=0, atol=0)
    assert (port.GRAD_KERNEL.launches, port.GRAD_MMA_KERNEL.launches) == before


# ---- the f32 body at d = 64 (csrc/attention_grad_wgmma.cuh), emulated


def _tensor_core_tf32(x):
    """What the tensor cores read of an f32 operand: its top 19 bits (TF32
    by truncation)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split_trunc(x):
    """The body's operands: hi = x as the tensor cores truncate it, lo =
    x - hi (exact in f32) rounded to TF32."""
    hi = _tensor_core_tf32(x)
    return hi, _tf32(x - hi)


def _to_f32_toward_zero(x):
    """f64 -> f32 rounded toward zero (a wgmma's sum, as the tensor cores
    leave it)."""
    r = x.to(torch.float32)
    over = r.to(torch.float64).abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _wgmma_chain(acc, terms):
    """acc (None: a chain started with scale-d 0) += a @ b for each 8-deep
    (a, b) term, each sum exact (f64) and then truncated to f32."""
    for a, b in terms:
        s = torch.matmul(a.double(), b.double())
        acc = _to_f32_toward_zero(s if acc is None else acc.double() + s)
    return acc


def _score_chain(a, b):
    """a b^T over the last axis (d = 64) as the body's S and dP: per 8-deep
    step the terms lo hi, hi lo, hi hi."""
    (ah, al), (bh, bl) = _split_trunc(a), _split_trunc(b)
    terms = []
    for k in range(0, a.shape[-1], 8):
        sl = slice(k, k + 8)
        at = lambda x: x[..., sl]  # noqa: E731
        bt = lambda x: x[..., sl].transpose(-1, -2)  # noqa: E731
        terms += [(at(al), bt(bh)), (at(ah), bt(bl)), (at(ah), bt(bh))]
    return _wgmma_chain(None, terms)


def _token_chain(a, b, chunk=32, warpgroups=2, drain=True):
    """a b over the token axis (a: (.., M, T), b: (.., T, N)) as the body's
    dQ, dV and dK: chunks of `chunk` tokens taken by the two warpgroups in turn,
    each chunk's 8-token steps (lo hi, hi lo, hi hi) summed into a part
    that a rounded f32 addition drains into the warpgroup's accumulator;
    then warpgroup 0's sum plus warpgroup 1's. Without `drain`, one
    truncated chain per warpgroup."""
    (ah, al), (bh, bl) = _split_trunc(a), _split_trunc(b)
    t = a.shape[-1]
    acc = [torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
           for _ in range(warpgroups)]
    for c, c0 in enumerate(range(0, t, chunk)):
        terms = []
        for k in range(c0, min(c0 + chunk, t), 8):
            sl = slice(k, k + 8)
            terms += [(al[..., sl], bh[..., sl, :]), (ah[..., sl], bl[..., sl, :]),
                      (ah[..., sl], bh[..., sl, :])]
        w = c % warpgroups
        if drain:
            acc[w] = acc[w] + _wgmma_chain(None, terms)
        else:
            acc[w] = _wgmma_chain(acc[w], terms)
    return sum(acc[1:], acc[0])


def _wgmma_body_emulated(qkv, do, nh, drain=True):
    """attention_qkv_grad's f32 body (d = 64, 80 and 88) on the CPU: its
    operands and products as above, the token products in each launch's
    chunks (d = 64: 32 tokens; d = 80 and 88: launch A's dQ 32, launch B's
    dK and dV 16), the softmax and dsoftmax chains as the plain version's
    f32 math."""
    b, t, three_h = qkv.shape
    h = three_h // 3
    d = h // nh
    x = qkv.reshape(b, t, 3, nh, d).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]
    g = do.reshape(b, t, nh, d).permute(0, 2, 1, 3)
    qs = q * (_LOG2E / math.sqrt(d))
    s = _score_chain(qs, k)
    dp = _score_chain(g, v)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    pn = p * (1.0 / p.sum(dim=-1, keepdim=True))
    ds = pn * (dp - (dp * pn).sum(dim=-1, keepdim=True))
    nat = 1.0 / math.sqrt(d)
    chunk_b = 32 if d == 64 else 16
    dq = _token_chain(ds, k, drain=drain) * nat
    dk = _token_chain(ds.transpose(-1, -2), q, chunk=chunk_b, drain=drain) * nat
    dv = _token_chain(pn.transpose(-1, -2), g, chunk=chunk_b, drain=drain)
    out = torch.stack([dq, dk, dv])
    return out.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h)


@pytest.mark.parametrize("t,d", [(197, 64), (785, 64), (257, 80), (257, 88)])
def test_wgmma_body_arithmetic_holds_the_f32_tolerance(t, d):
    # ViT-B/16 (T=197), ViT-B/8 (T=785), ViT-H/14 (T=257, d=80) and
    # ViT-g/14 (T=257, d=88) head pairs: nh=2, B=1
    qkv, do, _ = _inputs(1, t, 2, d, seed=t)
    x, g = torch.from_numpy(qkv), torch.from_numpy(do)
    plain = port.attention_qkv_grad_plain(x, g, 2)
    ref = np.asarray(jfa._attention_qkv_grad(jnp.asarray(qkv), jnp.asarray(do), 2, interpret=True))
    got = _wgmma_body_emulated(x, g, 2)
    assert got.shape == plain.shape and torch.isfinite(got).all()
    tol = 1e-4 * plain.abs().max().item()  # chip_smoke.GRAD_TOL[f32]
    err = (got - plain).abs().max().item()
    assert err <= tol / 10
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    # the drains keep the truncation of the token sums small; one chain
    # per warpgroup truncates each of its 3 T / 8 / 2 sums
    undrained = (_wgmma_body_emulated(x, g, 2, drain=False) - plain).abs().max().item()
    assert err <= undrained


@pytest.mark.cuda
def test_wgmma_body_matches_plain_and_mma_body_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(2, t, 3, False, 64) for t in (1, 8, 63, 64, 65, 127, 128, 129, 196, 197, 200, 256,
                                            257, 577, 785)]
    cases += [(2, t, 3, True, 64) for t in (65, 197, 785)]
    cases += [(2, 197, nh, False, 64) for nh in (1, 12)]
    # d = 80 (ViT-H/14): launch A's 32-token chunks in a ring of one,
    # launch B's 16-token chunks, the 257 = 4 x 64 + 1 tail
    cases += [(2, t, 3, False, 80) for t in (1, 8, 63, 64, 65, 129, 256, 257, 258, 785)]
    cases += [(2, t, 3, True, 80) for t in (65, 257)]
    cases += [(2, 257, nh, False, 80) for nh in (1, 16)]
    # d = 88 (ViT-g/14): d = 80's plan on rows of eleven 32-byte boxes
    cases += [(2, t, 3, False, 88) for t in (1, 8, 63, 64, 65, 129, 256, 257, 258, 785)]
    cases += [(2, t, 3, True, 88) for t in (65, 257)]
    cases += [(2, 257, nh, False, 88) for nh in (1, 16)]
    before = (port.GRAD_KERNEL.launches, port.GRAD_MMA_KERNEL.launches)
    for b, t, nh, sized, d in cases:
        qkv, do, sz = _inputs(b, t, nh, d, seed=t + nh, sizes=sized)
        x, g = (torch.from_numpy(a).cuda() for a in (qkv, do))
        s = None if sz is None else torch.from_numpy(sz).cuda()
        got = port.attention_qkv_grad(x, g, nh, sizes=s)
        again = port.attention_qkv_grad(x, g, nh, sizes=s)
        mma = port.attention_qkv_grad_mma(x, g, nh, sizes=s)
        ref = port.attention_qkv_grad_plain(x, g, nh, sizes=s)
        tol = 1e-4 * ref.abs().max().item()
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= tol, (t, nh, sized, d)
        assert (got - mma).abs().max().item() <= tol, (t, nh, sized, d)
        assert torch.equal(got, again)
    n = len(cases)
    assert (port.GRAD_KERNEL.launches, port.GRAD_MMA_KERNEL.launches) == (
        before[0] + 2 * n, before[1] + n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 72), ("bfloat16", 80), ("float32", 72),
                                     ("float32", 128)])
def test_other_calls_keep_the_mma_body_on_card(dtype, d):
    # everything but f32 at d = 64, 80 and 88 and bf16 at d = 64 still runs
    # the mma.sync bodies: equal to the check-only entry bit for bit
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    qkv, do, sz = _inputs(2, 197, 4, d, seed=d, sizes=True)
    x, g = (torch.from_numpy(a).to("cuda", dt) for a in (qkv, do))
    s = torch.from_numpy(sz).cuda()
    for sizes in (None, s):
        assert torch.equal(port.attention_qkv_grad(x, g, 4, sizes=sizes),
                           port.attention_qkv_grad_mma(x, g, 4, sizes=sizes))


# ---- the bf16 body at d = 64 (csrc/attention_grad_bf16_wgmma.cuh), emulated


def _bf16(x):
    """x rounded to the nearest bf16, in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _steps16(a, b):
    """a b over the last axis of a (b's first) in 16-deep steps, the k steps
    of the body's wgmma.m64n64k16."""
    return [(a[..., k:k + 16], b[..., k:k + 16, :]) for k in range(0, a.shape[-1], 16)]


def _bf16_body_emulated(qkv, do, nh, sizes=None):
    """attention_qkv_grad's bf16 body at d = 64 on the CPU, at its rounding
    points: qs = bf16(q log2(e)/sqrt(d)); S, dP (launch A) and S^T, dP^T
    (launch B) as chains of four 16-deep wgmmas, each sum truncated toward
    zero to f32; p = exp2(s - max) times sizes; pn = p * (1 / sum p); r =
    sum dp p / sum p; ds = bf16(pn (dp - r)); dQ = ds K and dK = dS^T q
    (q unscaled), dV = bf16(pn)^T dO, each one chain of 16-token steps
    over the whole sequence (the body's 64-token chunks add into one
    accumulator, never drained); dq and dk times 1/sqrt(d), every output
    rounded to bf16. The softmax's f32 sums are taken in torch's order,
    not the body's per-lane order."""
    b, t, three_h = qkv.shape
    h = three_h // 3
    d = h // nh
    x = qkv.float().reshape(b, t, 3, nh, d).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]
    g = do.float().reshape(b, t, nh, d).permute(0, 2, 1, 3)
    qs = _bf16(q * (_LOG2E / math.sqrt(d)))
    s = _wgmma_chain(None, _steps16(qs, k.transpose(-1, -2)))  # launch A: (B, nh, Tq, Tk)
    dp = _wgmma_chain(None, _steps16(g, v.transpose(-1, -2)))
    w = torch.ones((b, 1, 1, t)) if sizes is None else sizes.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) * w
    total = p.sum(dim=-1, keepdim=True)
    inv = 1.0 / total
    r = (dp * p).sum(dim=-1, keepdim=True) / total
    ds = _bf16(p * inv * (dp - r))
    nat = 1.0 / math.sqrt(d)
    dq = _bf16(_wgmma_chain(torch.zeros_like(q), _steps16(ds, k)) * nat)
    # launch B: the keys as rows, the same statistics per query column
    st = _wgmma_chain(None, _steps16(k, qs.transpose(-1, -2)))  # (B, nh, Tk, Tq)
    dpt = _wgmma_chain(None, _steps16(v, g.transpose(-1, -2)))
    pnt = torch.exp2(st - m.transpose(-1, -2)) * w.transpose(-1, -2) * inv.transpose(-1, -2)
    dst = _bf16(pnt * (dpt - r.transpose(-1, -2)))
    dk = _bf16(_wgmma_chain(torch.zeros_like(k), _steps16(dst, q)) * nat)
    dv = _bf16(_wgmma_chain(torch.zeros_like(v), _steps16(_bf16(pnt), g)))
    out = torch.stack([dq, dk, dv])  # (3, B, nh, T, d)
    return out.permute(1, 3, 0, 2, 4).reshape(b, t, 3 * h).to(torch.bfloat16)


def _bf16_case(b, t, nh, sized, seed):
    qkv, do, sz = _inputs(b, t, nh, 64, seed=seed, sizes=sized)
    x, g = (torch.from_numpy(a).to(torch.bfloat16) for a in (qkv, do))
    return x, g, None if sz is None else torch.from_numpy(sz)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("t", [1, 63, 65, 197, 257])
@pytest.mark.parametrize("nh", [1, 2])
@pytest.mark.parametrize("sizes", [False, True], ids=["nosizes", "sizes"])
def test_bf16_wgmma_body_arithmetic_holds_the_bf16_tolerance(t, nh, sizes):
    # the pair form's shapes: T at the 64-token chunks' edges (one token,
    # 63 / 65, ViT-B/16's 197 with 5 real rows in its last chunk, 257 with
    # one), one head (the carve kernel) and a head pair
    x, g, sz = _bf16_case(2, t, nh, sizes, seed=t + nh)
    got = _bf16_body_emulated(x, g, nh, sz)
    plain = port.attention_qkv_grad_plain(x, g, nh, sizes=sz)
    assert got.shape == plain.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    ref = jfa._attention_qkv_grad(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(g.float().numpy(), jnp.bfloat16),
        nh, interpret=True, sizes=None if sz is None else jnp.asarray(sz.numpy()))
    # chip_smoke.GRAD_TOL[bf16], relative to the largest value
    assert _rel(got.float(), plain.float()) <= 2e-2
    assert _rel(got.float(), np.asarray(ref.astype(jnp.float32))) <= 2e-2


@pytest.mark.parametrize("sizes", [False, True], ids=["nosizes", "sizes"])
def test_bf16_wgmma_body_arithmetic_holds_at_the_lane_shape(sizes):
    # ViT-B/8's T = 785 (13 chunks, one real row in the last), one image of
    # a head pair: the JAX package runs its lane kernel there
    x, g, sz = _bf16_case(1, 785, 2, sizes, seed=785)
    got = _bf16_body_emulated(x, g, 2, sz)
    plain = port.attention_qkv_grad_plain(x, g, 2, sizes=sz)
    ref = jfa._attention_qkv_grad_lane(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(g.float().numpy(), jnp.bfloat16),
        2, True, sizes=None if sz is None else jnp.asarray(sz.numpy()))
    assert _rel(got.float(), plain.float()) <= 2e-2
    assert _rel(got.float(), np.asarray(ref.astype(jnp.float32))) <= 2e-2


def test_bf16_wgmma_body_rounds_where_the_contract_does():
    # without the bf16 roundings of qs, pn and ds the emulation drifts from
    # the plain version by more than their rounding does: the points
    # matter at the bf16 tolerance's scale
    x, g, _ = _bf16_case(1, 197, 2, False, seed=11)
    plain = port.attention_qkv_grad_plain(x, g, 2).float()
    err = _rel(_bf16_body_emulated(x, g, 2).float(), plain)
    f32 = port.attention_qkv_grad_plain(x.float(), g.float(), 2)
    assert err < 2e-2
    assert err <= _rel(_bf16(f32), plain)


@pytest.mark.cuda
def test_bf16_wgmma_body_matches_plain_and_mma_body_on_card():
    # the bf16 body at d = 64: 64-token chunks (T = 1, 63, 65, 129), ViT-B/16
    # (197), the 256-key edge (256, 257), the lane shape (785), ToMe sizes,
    # 1 and 12 heads; bit-equal call to call, within 2e-2 x max|plain| of
    # the plain version and of the mma.sync body (the check-only entry)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cases = [(2, t, 3, False) for t in (1, 63, 65, 129, 197, 256, 257, 785)]
    cases += [(2, t, 3, True) for t in (65, 197, 785)]
    cases += [(2, 197, nh, False) for nh in (1, 12)]
    before = (port.GRAD_KERNEL.launches, port.GRAD_MMA_KERNEL.launches)
    for b, t, nh, sized in cases:
        x, g, sz = _bf16_case(b, t, nh, sized, seed=t + nh)
        x, g = x.cuda(), g.cuda()
        s = None if sz is None else sz.cuda()
        got = port.attention_qkv_grad(x, g, nh, sizes=s)
        again = port.attention_qkv_grad(x, g, nh, sizes=s)
        mma = port.attention_qkv_grad_mma(x, g, nh, sizes=s).float()
        ref = port.attention_qkv_grad_plain(x, g, nh, sizes=s).float()
        tol = 2e-2 * ref.abs().max().item()
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
        assert (got.float() - ref).abs().max().item() <= tol, (t, nh, sized)
        assert (got.float() - mma).abs().max().item() <= tol, (t, nh, sized)
        assert torch.equal(got, again)
    n = len(cases)
    assert (port.GRAD_KERNEL.launches, port.GRAD_MMA_KERNEL.launches) == (
        before[0] + 2 * n, before[1] + n)
