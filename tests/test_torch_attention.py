"""The port's fused-QKV attention against the JAX package's.

On the CPU the port's `attention_qkv` runs its plain PyTorch version; the
JAX `attention_qkv` runs its Pallas kernels in interpret mode, as the JAX
package's own tests run them. Inputs are made with numpy from a seed and
handed to both. The CUDA kernel itself is held against the plain version
on the card (the `cuda` test below, and chip_smoke.py).

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
        # bf16 on both sides: Q, p and the output round to bf16 at the
        # same places; one output step is 2^-8 of values up to ~2
        (2, 2, 33, 64, "bfloat16", 2e-2),
    ],
    ids=["f32-d64", "f32-d80", "bf16-d64"],
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


# The edges of both bodies' tiling: 128-query blocks of 8 warps x 16
# rows, 64-key tiles of 16-key (bf16) or 8-key (f32) steps, d padded to a
# multiple of 16.
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
@pytest.mark.parametrize("shape", [(2, 4, 1, 64), (2, 4, 65, 72), (2, 4, 128, 128), (2, 4, 129, 64)])
def test_flash_attention_bf16_tile_edges_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in _bhtd(*shape, seed=8))
    got = port.flash_attention(q, k, v).float()
    ref = port.flash_attention_plain(q, k, v).float()
    torch.testing.assert_close(got, ref, atol=2e-2, rtol=0)
