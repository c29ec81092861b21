"""The port's fused-QKV attention against the JAX package's.

On the CPU the port's `attention_qkv` runs its plain PyTorch version; the
JAX `attention_qkv` runs its Pallas kernels in interpret mode, as the JAX
package's own tests run them. Inputs are made with numpy from a seed and
handed to both. The CUDA kernel itself is held against the plain version
on the card (the `cuda` tests below, and chip_smoke.py): in bf16 at d=64,
80 and 88 its wgmma body, elsewhere its mma.sync and 3xTF32 bodies, and
the mma.sync body at those d too through the check-only
`attention_qkv_mma` / `flash_attention_mma`. The bf16 tolerance on the card (2e-2 absolute)
is a few bf16 steps of O(1) outputs: both sides round p to bf16 for P V
and the output to bf16, in another order of f32 sums.

Tolerances: f32 on both sides, differing only in summation order, so
2e-5 absolute (outputs are O(1)).

The kernel's f32 body computes its products as 3xTF32 on the tensor
cores; a test below emulates TF32 rounding on the CPU and holds 3xTF32
products, and not single TF32 ones, within the card's tolerance (2e-5
absolute) of the plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.ops.flash_attention import attention_qkv as jax_attention_qkv
from vit_cpp_tpu_torch.ops import flash_attention as port

ATOL = 2e-5


def _qkv(b, t, nh, d, seed):
    return np.random.default_rng(seed).standard_normal((b, t, 3 * nh * d)).astype(np.float32)


def _both(qkv, nh, **kw):
    sizes = kw.pop("sizes", None)
    ref = jax_attention_qkv(
        jnp.asarray(qkv), nh, sizes=None if sizes is None else jnp.asarray(sizes), **kw
    )
    got = port.attention_qkv(
        torch.from_numpy(qkv), nh,
        sizes=None if sizes is None else torch.from_numpy(sizes), **kw,
    )
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize(
    "b,t,nh,d",
    [
        (2, 37, 2, 64),  # d=64: the TPU pair kernel
        (1, 29, 3, 64),  # odd head count: pair kernel + the _sdpa tail
        (2, 21, 2, 80),  # d=80 (ViT-H): the full-block carve kernel
        (1, 257, 2, 80),  # ViT-H/14's T=257: one real row in the last 64-row tile
        (2, 23, 2, 88),  # d=88 (ViT-g/14): 128 % d != 0, the same kernel
    ],
)
@pytest.mark.parametrize("fast", [False, True])
def test_plain_matches_jax(b, t, nh, d, fast):
    ref, got = _both(_qkv(b, t, nh, d, seed=t + nh), nh, fast=fast)
    assert got.shape == (b, t, nh * d)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fast", [False, True])
def test_key_mask_ignores_garbage_pad_rows(fast):
    # token-padded input: rows >= kv hold adversarial garbage (scores far
    # above the real maximum); the real rows must match the unpadded
    # attention, and the port writes zeros into the pad rows
    t, kv, nh, d = 24, 19, 2, 64
    qkv = _qkv(1, t, nh, d, seed=5)
    qkv[:, kv:] = 1e4
    ref, got = _both(qkv, nh, fast=fast, kv=kv)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, :kv], ref[:, :kv], atol=ATOL, rtol=0)
    unpadded = port.attention_qkv(torch.from_numpy(qkv[:, :kv].copy()), nh, fast=fast)
    np.testing.assert_allclose(got[:, :kv], unpadded.numpy(), atol=ATOL, rtol=0)
    assert not got[:, kv:].any()


@pytest.mark.parametrize("fast", [False, True])
def test_tome_sizes(fast):
    b, t, nh, d = 2, 17, 2, 64
    sizes = np.random.default_rng(9).integers(1, 5, (b, t)).astype(np.float32)
    ref, got = _both(_qkv(b, t, nh, d, seed=11), nh, fast=fast, sizes=sizes)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_fast_clamp_saturates_like_jax():
    # scores * log2(e) above 120: the fast softmax ties them at the clamp
    # instead of overflowing, in both packages
    qkv = _qkv(1, 9, 2, 64, seed=2) * 6.0
    ref, got = _both(qkv, 2, fast=True)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_cpu_runs_plain_version_and_counts_no_launch():
    before = port.KERNEL.launches
    qkv = torch.from_numpy(_qkv(1, 5, 2, 8, seed=0))
    out = port.attention_qkv(qkv, 2, fast=True)
    torch.testing.assert_close(
        out, port.attention_qkv_plain(qkv, 2, fast=True), rtol=0, atol=0
    )
    assert port.KERNEL.launches == before == 0


@pytest.mark.parametrize("kw", [{"fast": True}, {"fast": False, "kv": 4}, {"sizes": True}])
def test_mma_entry_runs_plain_version_on_cpu(kw):
    # the check-only entry to the mma.sync bodies (f32's 3xTF32 one here;
    # bf16's too): the plain version on CPU tensors, no launch counted
    before = port.MMA_KERNEL.launches
    qkv = torch.from_numpy(_qkv(2, 6, 2, 64, seed=4))
    kw = dict(kw)
    if kw.pop("sizes", False):
        kw["sizes"] = torch.from_numpy(np.random.default_rng(4).integers(1, 5, (2, 6)).astype(np.float32))
    got = port.attention_qkv_mma(qkv, 2, **kw)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, port.attention_qkv_plain(qkv, 2, **kw), rtol=0, atol=0)
    q, k, v = (torch.from_numpy(a) for a in _bhtd(2, 2, 6, 64, seed=5))
    got = port.flash_attention_mma(q, k, v)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, port.flash_attention_plain(q, k, v), rtol=0, atol=0)
    assert port.MMA_KERNEL.launches == before == 0


def test_rejects_bad_arguments():
    qkv = torch.zeros(1, 4, 12)
    with pytest.raises(ValueError):
        port.attention_qkv(qkv, 3, kv=2, sizes=torch.ones(1, 4))
    with pytest.raises(ValueError):
        port.attention_qkv(qkv, 3, kv=5)
    with pytest.raises(ValueError):
        port.attention_qkv(torch.zeros(1, 4, 10), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    qkv = torch.from_numpy(_qkv(2, 197, 12, 64, seed=1)).to("cuda", dt)
    for kw in ({"fast": True}, {"fast": False}, {"fast": False, "kv": 190}):
        got = port.attention_qkv(qkv, 12, **kw).float()
        ref = port.attention_qkv_plain(qkv, 12, **kw).float()
        tol = 1e-4 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(got, ref, atol=tol, rtol=0)


def _bhtd(b, h, t, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize(
    "b,h,t,d,dtype,atol",
    [
        (2, 3, 37, 64, "float32", ATOL),  # d=64
        (1, 2, 29, 80, "float32", ATOL),  # d=80 (ViT-H)
        (1, 2, 29, 88, "float32", ATOL),  # d=88 (ViT-g)
        # bf16 on both sides: Q, p and the output round to bf16 at the
        # same places; one output step is 2^-8 of values up to ~2
        (2, 2, 33, 64, "bfloat16", 2e-2),
        (1, 2, 65, 88, "bfloat16", 2e-2),
    ],
    ids=["f32-d64", "f32-d80", "f32-d88", "bf16-d64", "bf16-d88"],
)
def test_flash_attention_plain_matches_jax(b, h, t, d, dtype, atol):
    from vit_cpp_tpu.ops.flash_attention import flash_attention as jax_flash_attention

    q, k, v = _bhtd(b, h, t, d, seed=t)
    ref = jax_flash_attention(*(jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in (q, k, v)))
    got = port.flash_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    )
    assert got.shape == (b, h, t, d) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=atol, rtol=0
    )


def test_core_attention_pallas_runs_the_split_head_path():
    from vit_cpp_tpu_torch.ops.core import attention

    q, k, v = (torch.from_numpy(a) for a in _bhtd(1, 2, 11, 64, seed=4))
    before = port.FLASH_KERNEL.launches
    got = attention(q, k, v, impl="pallas")
    torch.testing.assert_close(got, port.flash_attention_plain(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(got, attention(q, k, v), atol=ATOL, rtol=0)
    assert port.FLASH_KERNEL.launches == before == 0
    with pytest.raises(ValueError):
        port.flash_attention(q, k[:, :, :5], v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    before = port.FLASH_KERNEL.launches
    for shape in ((2, 12, 197, 64), (1, 16, 257, 80)):
        q, k, v = (torch.from_numpy(a).to("cuda", dt) for a in _bhtd(*shape, seed=7))
        got = port.flash_attention(q, k, v).float()
        ref = port.flash_attention_plain(q, k, v).float()
        tol = 1e-4 if dt == torch.float32 else 2e-2
        torch.testing.assert_close(got, ref, atol=tol, rtol=0)
    assert port.FLASH_KERNEL.launches == before + 2


# The edges of the bodies' tiling: 128-query blocks of 8 warps x 16
# rows, 64-key tiles of 16-key (bf16) or 8-key (f32) steps, d padded to a
# multiple of 16; at d=64 in bf16 the wgmma body's 64-query tiles, one
# tile of 64-key boxes up to T=256, a ring of 128- or 64-key tiles past it
# (257, 577, 785), kv at 197 of 200, 256 of 257 and 64 of 70.
TILE_EDGES = [
    (2, 1, {"fast": True}, 64),
    (2, 1, {"fast": False}, 64),
    (2, 65, {"fast": False}, 64),
    (2, 128, {"fast": True, "sizes": True}, 64),
    (2, 129, {"fast": False}, 64),
    (2, 131, {"fast": False, "kv": 128}, 64),
    (2, 131, {"fast": True, "kv": 129}, 64),
    (2, 70, {"fast": True, "kv": 64}, 64),
    (2, 70, {"fast": False, "kv": 65}, 64),
    (2, 197, {"fast": False}, 72),
    (2, 197, {"fast": True, "sizes": True}, 72),
    (2, 197, {"fast": True}, 128),
    (2, 197, {"fast": False, "kv": 190}, 128),
    *[(2, t, {"fast": fast}, 64) for t in (63, 64, 196, 197, 255, 256, 257, 577, 785)
      for fast in (True, False)],
    (2, 65, {"fast": True}, 64),
    (2, 128, {"fast": False}, 64),
    (2, 129, {"fast": True}, 64),
    (2, 197, {"fast": False, "sizes": True}, 64),
    (2, 257, {"fast": True, "sizes": True}, 64),
    (1, 785, {"fast": False, "sizes": True}, 64),
    (2, 200, {"fast": True, "kv": 197}, 64),
    (2, 200, {"fast": False, "kv": 197}, 64),
    (2, 257, {"fast": True, "kv": 256}, 64),
    (2, 257, {"fast": False, "kv": 256}, 64),
    (2, 70, {"fast": False, "kv": 64}, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("bfloat16", 2e-2), ("float32", ATOL)])
@pytest.mark.parametrize(
    "b,t,kw,d", TILE_EDGES,
    ids=[f"T{t}-d{d}-" + "-".join(f"{k}{v}" for k, v in kw.items()) for _, t, kw, d in TILE_EDGES],
)
def test_kernel_tile_edges_on_card(b, t, kw, d, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    nh = 4
    qkv = torch.from_numpy(_qkv(b, t, nh, d, seed=t + d)).to("cuda", getattr(torch, dtype))
    kw = dict(kw)
    if kw.get("kv"):
        qkv[:, kw["kv"]:] = 1e4  # adversarial pad rows
    if kw.get("sizes"):
        sizes = np.random.default_rng(t).integers(1, 5, (b, t)).astype(np.float32)
        kw["sizes"] = torch.from_numpy(sizes).cuda()
    before = port.KERNEL.launches
    got = port.attention_qkv(qkv, nh, **kw).float()
    ref = port.attention_qkv_plain(qkv, nh, **kw).float()
    assert port.KERNEL.launches == before + 1
    torch.testing.assert_close(got, ref, atol=atol, rtol=0)


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


def _attention_with(mm, qkv, nh):
    """attention_qkv_plain's f32 safe-mode math with both products
    through `mm`."""
    b, t, three_h = qkv.shape
    h = three_h // 3
    d = h // nh
    x = qkv.reshape(b, t, 3, nh, d).permute(2, 0, 3, 1, 4)
    s = mm(x[0] * (_LOG2E / math.sqrt(d)), x[1].transpose(-1, -2))
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = mm(p, x[2]) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3).reshape(b, t, h)


def test_3xtf32_products_hold_the_f32_tolerance_and_1xtf32_do_not():
    # one ViT-B/16 head pair: nh=2, d=64, T=197, B=1
    qkv = torch.from_numpy(_qkv(1, 197, 2, 64, seed=0))
    plain = port.attention_qkv_plain(qkv, 2)
    # the emulation is the plain math: exact with full f32 products
    torch.testing.assert_close(_attention_with(torch.matmul, qkv, 2), plain, rtol=0, atol=0)
    err3 = (_attention_with(_mm_3xtf32, qkv, 2) - plain).abs().max().item()
    err1 = (_attention_with(_mm_1xtf32, qkv, 2) - plain).abs().max().item()
    assert err3 <= ATOL / 10
    assert err1 > 2 * ATOL


# ---- the f32 body at d = 64 and 80 (csrc/attention_tf32_wgmma.cuh), emulated


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


def _three_terms(a, b):
    """a @ b over an 8-deep step in 3xTF32: the terms lo hi, hi lo, hi hi."""
    (ah, al), (bh, bl) = _split_trunc(a), _split_trunc(b)
    return [(al, bh), (ah, bl), (ah, bh)]


def _k1_wgmma_emulated(qkv, nh, *, fast, sizes=None, drain=True, chunk=16):
    """attention_qkv's f32 wgmma body on the CPU: S = qs K^T in three
    terms per 8-deep step, the hi hi terms in one truncated chain and the
    cross terms in another, added in f32; keys in chunks of 16
    taken by two warpgroups in turn, each with its own softmax state (safe:
    an online row max, o and l rescaled by exp2(m_old - m_new) when it
    grows); each chunk's P V (three terms per 8-key step) summed into a
    part that a rounded f32 addition drains into o (without `drain`, one
    truncated chain per warpgroup); then the two states combined and o / l
    rounded once."""
    b, t, three_h = qkv.shape
    h = three_h // 3
    d = h // nh
    x = qkv.reshape(b, t, 3, nh, d).permute(2, 0, 3, 1, 4)
    qs, k, v = x[0] * (_LOG2E / math.sqrt(d)), x[1], x[2]
    terms = [_three_terms(qs[..., c:c + 8], k[..., c:c + 8].transpose(-1, -2))
             for c in range(0, d, 8)]
    s = (_wgmma_chain(None, [tm[2] for tm in terms])
         + _wgmma_chain(None, [x for tm in terms for x in tm[:2]]))
    states = []
    for w in range(2):
        m = torch.full((b, nh, t, 1), -math.inf)
        l = torch.zeros((b, nh, t, 1))
        o = torch.zeros((b, nh, t, d))
        for c0 in range(chunk * w, t, 2 * chunk):
            sc = s[..., c0:c0 + chunk]
            if fast:
                p = torch.exp2(torch.clamp(sc, max=120.0))
            else:
                mt = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
                alpha = torch.exp2(m - mt)
                l, o, m = l * alpha, o * alpha, mt
                p = torch.exp2(sc - m)
            if sizes is not None:
                p = p * sizes[:, None, None, c0:c0 + chunk]
            l = l + p.sum(dim=-1, keepdim=True)
            terms = [tm for c in range(0, p.shape[-1], 8)
                     for tm in _three_terms(p[..., c:c + 8], v[..., c0 + c:c0 + c + 8, :])]
            o = o + _wgmma_chain(None, terms) if drain else _wgmma_chain(o, terms)
        states.append((m, l, o))
    (m0, l0, o0), (m1, l1, o1) = states
    if fast:
        o, l = o0 + o1, l0 + l1
    else:
        mx = torch.maximum(m0, m1)
        s0, s1 = torch.exp2(m0 - mx), torch.exp2(m1 - mx)
        o, l = o0 * s0 + o1 * s1, l0 * s0 + l1 * s1
    return (o / l).permute(0, 2, 1, 3).reshape(b, t, h)


@pytest.mark.parametrize("t,d,fast,sized", [
    (197, 64, False, False), (197, 64, True, True), (257, 80, False, False),
    (257, 80, True, False), (257, 80, False, True), (257, 88, False, False),
    (257, 88, True, False), (257, 88, False, True),
], ids=["d64-T197-safe", "d64-T197-fast-sizes", "d80-T257-safe", "d80-T257-fast",
        "d80-T257-safe-sizes", "d88-T257-safe", "d88-T257-fast", "d88-T257-safe-sizes"])
def test_f32_wgmma_body_arithmetic_holds_the_f32_tolerance(t, d, fast, sized):
    # ViT-B/16 (d=64, T=197), ViT-H/14 (d=80, T=257) and ViT-g/14 (d=88,
    # T=257) head pairs, B=1
    qkv = _qkv(1, t, 2, d, seed=t + d)
    sizes = (np.random.default_rng(t).integers(1, 5, (1, t)).astype(np.float32)
             if sized else None)
    x = torch.from_numpy(qkv)
    sz = None if sizes is None else torch.from_numpy(sizes)
    plain = port.attention_qkv_plain(x, 2, fast=fast, sizes=sz)
    ref = np.asarray(jax_attention_qkv(
        jnp.asarray(qkv), 2, fast=fast, sizes=None if sizes is None else jnp.asarray(sizes),
        interpret=True))
    got = _k1_wgmma_emulated(x, 2, fast=fast, sizes=sz)
    assert got.shape == plain.shape and torch.isfinite(got).all()
    err = (got - plain).abs().max().item()
    assert err <= ATOL / 10
    assert np.abs(got.numpy() - ref).max() <= ATOL
    # the drains keep the truncation of the key sums small; one chain per
    # warpgroup truncates each of its sums
    undrained = (_k1_wgmma_emulated(x, 2, fast=fast, sizes=sz, drain=False) - plain).abs().max()
    assert err <= undrained.item()


@pytest.mark.cuda
def test_bf16_kernel_takes_an_unaligned_qkv_on_card():
    # a view 2 bytes past a 16-byte boundary: the wrapper copies it first
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    qkv = torch.from_numpy(_qkv(2, 197, 12, 64, seed=3)).to("cuda", torch.bfloat16)
    flat = torch.empty(qkv.numel() + 1, dtype=qkv.dtype, device="cuda")
    shifted = flat[1:].view(qkv.shape)
    shifted.copy_(qkv)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    torch.testing.assert_close(
        port.attention_qkv(shifted, 12, fast=True), port.attention_qkv(qkv, 12, fast=True),
        rtol=0, atol=0,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 4, 1, 64), (2, 4, 65, 72), (2, 4, 128, 128), (2, 4, 129, 64),
    (2, 4, 63, 64), (2, 4, 64, 64), (2, 12, 197, 64), (2, 4, 256, 64), (2, 4, 257, 64),
    (2, 4, 577, 64), (1, 4, 785, 64),
])
def test_flash_attention_bf16_tile_edges_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in _bhtd(*shape, seed=8))
    got = port.flash_attention(q, k, v).float()
    ref = port.flash_attention_plain(q, k, v).float()
    torch.testing.assert_close(got, ref, atol=2e-2, rtol=0)


# The wgmma body (bf16, d=64) computes the mma.sync body's products in the
# same order and divides by l to the correctly rounded quotient, so the
# two agree bit for bit: held at each edge of the wgmma body's tiling.
WGMMA_EDGES = [(t, {"fast": fast}) for t in (1, 65, 197, 256, 257, 785) for fast in (True, False)] + [
    (197, {"fast": True, "sizes": True}), (785, {"fast": False, "sizes": True}),
    (200, {"fast": True, "kv": 197}), (257, {"fast": False, "kv": 256}),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "t,kw", WGMMA_EDGES,
    ids=[f"T{t}-" + "-".join(f"{k}{v}" for k, v in kw.items()) for t, kw in WGMMA_EDGES],
)
def test_wgmma_body_is_the_mma_body_bit_for_bit_on_card(t, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    qkv = torch.from_numpy(_qkv(2, t, 4, 64, seed=t + 7)).to("cuda", torch.bfloat16)
    kw = dict(kw)
    if kw.get("kv"):
        qkv[:, kw["kv"]:] = 1e4
    if kw.pop("sizes", False):
        kw["sizes"] = torch.from_numpy(np.random.default_rng(t).integers(1, 5, (2, t)).astype(np.float32)).cuda()
    assert torch.equal(port.attention_qkv(qkv, 4, **kw), port.attention_qkv_mma(qkv, 4, **kw))
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in _bhtd(1, 4, t, 64, seed=t))
    assert torch.equal(port.flash_attention(q, k, v), port.flash_attention_mma(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("t,kw", [(197, {"fast": True}), (785, {"fast": False}),
                                  (200, {"fast": True, "kv": 197}), (257, {"sizes": True})])
def test_mma_body_at_d64_matches_plain_on_card(t, kw):
    # the body the wgmma one replaced, through its check-only entry: still
    # right at d=64, counted on MMA_KERNEL and not on KERNEL
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    qkv = torch.from_numpy(_qkv(2, t, 4, 64, seed=t)).to("cuda", torch.bfloat16)
    kw = dict(kw)
    if kw.get("kv"):
        qkv[:, kw["kv"]:] = 1e4
    if kw.pop("sizes", False):
        kw["sizes"] = torch.from_numpy(np.random.default_rng(t).integers(1, 5, (2, t)).astype(np.float32)).cuda()
    before, mma_before = port.KERNEL.launches, port.MMA_KERNEL.launches
    got = port.attention_qkv_mma(qkv, 4, **kw).float()
    assert (port.KERNEL.launches, port.MMA_KERNEL.launches) == (before, mma_before + 1)
    torch.testing.assert_close(got, port.attention_qkv_plain(qkv, 4, **kw).float(), atol=2e-2, rtol=0)
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in _bhtd(1, 4, t, 64, seed=t))
    torch.testing.assert_close(port.flash_attention_mma(q, k, v).float(),
                               port.flash_attention_plain(q, k, v).float(), atol=2e-2, rtol=0)


# The bf16 body at d = 80 and 88 (wgmma + TMA, each 64-row tile a 64-column
# box and a tail box): 64-query tiles and 64-key chunks (T = 1, 63, 64, 65,
# 128, 129), the ring (d = 80: 3 chunks, 256 and 257 stream; d = 88: 4),
# T = 257's one real row in the last tile, T = 577; ToMe sizes; kv at 256
# of 257 and 64 of 70 with pad rows of 1e4; 1, 3 and 16 heads. Held to the
# plain version, to the mma.sync body it replaced (the check-only entry)
# bit for bit, and to itself from one call to the next.
WIDE_EDGES = [(t, d, 4, {"fast": fast}) for d in (80, 88)
              for t in (1, 63, 64, 65, 128, 129, 256, 257, 577) for fast in (True, False)] + [
    (t, d, 4, {"fast": t == 257, "sizes": True}) for d in (80, 88) for t in (65, 257)] + [
    (t, d, 4, {"fast": fast, "kv": kv}) for d in (80, 88) for t, kv in ((257, 256), (70, 64))
    for fast in (True, False)] + [
    (197, d, nh, {"fast": True}) for d in (80, 88) for nh in (1, 3, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "t,d,nh,kw", WIDE_EDGES,
    ids=[f"T{t}-d{d}-h{nh}-" + "-".join(f"{k}{v}" for k, v in kw.items())
         for t, d, nh, kw in WIDE_EDGES],
)
def test_wide_wgmma_body_matches_plain_and_mma_body_on_card(t, d, nh, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    qkv = torch.from_numpy(_qkv(2, t, nh, d, seed=t + d + nh)).to("cuda", torch.bfloat16)
    kw = dict(kw)
    if kw.get("kv"):
        qkv[:, kw["kv"]:] = 1e4
    if kw.pop("sizes", False):
        kw["sizes"] = torch.from_numpy(np.random.default_rng(t).integers(1, 5, (2, t)).astype(np.float32)).cuda()
    before = (port.KERNEL.launches, port.MMA_KERNEL.launches)
    got, again = port.attention_qkv(qkv, nh, **kw), port.attention_qkv(qkv, nh, **kw)
    mma = port.attention_qkv_mma(qkv, nh, **kw)
    assert (port.KERNEL.launches, port.MMA_KERNEL.launches) == (before[0] + 2, before[1] + 1)
    torch.testing.assert_close(got.float(), port.attention_qkv_plain(qkv, nh, **kw).float(),
                               atol=2e-2, rtol=0)
    assert torch.equal(got, mma) and torch.equal(got, again)
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in _bhtd(1, nh, t, d, seed=t))
    got, again = port.flash_attention(q, k, v), port.flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), port.flash_attention_plain(q, k, v).float(),
                               atol=2e-2, rtol=0)
    assert torch.equal(got, port.flash_attention_mma(q, k, v)) and torch.equal(got, again)


# The f32 body at d = 64, 80 and 88 (wgmma + TMA): 64-query tiles, 16-key
# chunks taken by two warpgroups in turn, the 257 = 4 x 64 + 1 tail; held
# to the plain version and to the 3xTF32 mma.sync body it replaced (the
# check-only entry), and bit-equal from one call to the next. d = 88
# (ViT-g/14) lands in eleven 32-byte boxes a row.
F32_WGMMA_EDGES = [(t, d, {"fast": fast}) for d in (64, 80)
                   for t in (1, 8, 65, 197, 256, 257, 785) for fast in (True, False)] + [
    (197, 64, {"fast": False, "sizes": True}), (257, 80, {"fast": True, "sizes": True}),
    (200, 64, {"fast": True, "kv": 197}), (257, 80, {"fast": False, "kv": 256}),
] + [(t, 88, {"fast": fast}) for t in (1, 8, 63, 64, 65, 129, 256, 257, 258)
     for fast in (True, False)] + [
    (257, 88, {"fast": False, "sizes": True}), (65, 88, {"fast": True, "sizes": True}),
    (257, 88, {"fast": False, "kv": 256}), (70, 88, {"fast": True, "kv": 64}),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "t,d,kw", F32_WGMMA_EDGES,
    ids=[f"T{t}-d{d}-" + "-".join(f"{k}{v}" for k, v in kw.items()) for t, d, kw in F32_WGMMA_EDGES],
)
def test_f32_wgmma_body_matches_plain_and_mma_body_on_card(t, d, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv = torch.from_numpy(_qkv(2, t, 4, d, seed=t + d)).cuda()
    kw = dict(kw)
    if kw.get("kv"):
        qkv[:, kw["kv"]:] = 1e4
    if kw.pop("sizes", False):
        kw["sizes"] = torch.from_numpy(np.random.default_rng(t).integers(1, 5, (2, t)).astype(np.float32)).cuda()
    before = (port.KERNEL.launches, port.MMA_KERNEL.launches)
    got, again = port.attention_qkv(qkv, 4, **kw), port.attention_qkv(qkv, 4, **kw)
    mma = port.attention_qkv_mma(qkv, 4, **kw)
    assert (port.KERNEL.launches, port.MMA_KERNEL.launches) == (before[0] + 2, before[1] + 1)
    torch.testing.assert_close(got, port.attention_qkv_plain(qkv, 4, **kw), atol=ATOL, rtol=0)
    torch.testing.assert_close(got, mma, atol=ATOL, rtol=0)
    assert torch.equal(got, again)
    q, k, v = (torch.from_numpy(a).cuda() for a in _bhtd(1, 4, t, d, seed=t))
    got, again = port.flash_attention(q, k, v), port.flash_attention(q, k, v)
    torch.testing.assert_close(got, port.flash_attention_plain(q, k, v), atol=ATOL, rtol=0)
    torch.testing.assert_close(got, port.flash_attention_mma(q, k, v), atol=ATOL, rtol=0)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [72, 128])
def test_f32_other_d_keep_the_mma_body_on_card(d):
    # f32 at d other than 64, 80 and 88 still runs the 3xTF32 mma.sync
    # body: equal to the check-only entry bit for bit
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    qkv = torch.from_numpy(_qkv(2, 197, 4, d, seed=d)).cuda()
    sizes = torch.from_numpy(np.random.default_rng(d).integers(1, 5, (2, 197)).astype(np.float32)).cuda()
    for kw in ({"fast": True}, {"fast": False, "sizes": sizes}, {"fast": False, "kv": 190}):
        assert torch.equal(port.attention_qkv(qkv, 4, **kw), port.attention_qkv_mma(qkv, 4, **kw))
    q, k, v = (torch.from_numpy(a).cuda() for a in _bhtd(1, 4, 65, d, seed=d))
    assert torch.equal(port.flash_attention(q, k, v), port.flash_attention_mma(q, k, v))
