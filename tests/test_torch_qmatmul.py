"""The port's dequantizing matmul against the JAX package's.

On the CPU the port's `dequant_matmul` runs its plain PyTorch version; the
JAX side runs `pallas_quant_matmul` (the TPU kernel, in interpret mode, as
the JAX package's own tests run it) and `quant_matmul(impl="xla")`. Inputs
are made with numpy from a seed and handed to both. The CUDA kernel itself
is held against the plain version on the card (the `cuda` tests below,
and chip_smoke.py).

Tolerances: f32 on both sides, differing in summation order only:
atol/rtol 1e-4, the JAX package's own tolerance for this kernel. bf16:
5e-2, for one bf16 rounding of the output computed from sums in another
order (and the JAX kernel's own bf16 test tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.gguf.dtypes import GGMLDType
from vit_cpp_tpu.gguf.reader import TensorRecord
from vit_cpp_tpu.ops.pallas_qmatmul import pallas_quant_matmul
from vit_cpp_tpu.ops.qmatmul import quant_matmul as jax_quant_matmul
from vit_cpp_tpu.quant.blocks import quantize
from vit_cpp_tpu.quant.qlinear import _quant_linear_from_record as jax_from_record
from vit_cpp_tpu_torch.ops import qmatmul
from vit_cpp_tpu_torch.ops.core import linear
from vit_cpp_tpu_torch.quant.qlinear import quant_linear_from_record

FORMATS = [GGMLDType.Q4_0, GGMLDType.Q4_1, GGMLDType.Q5_0, GGMLDType.Q5_1, GGMLDType.Q8_0]
IDS = [f.name for f in FORMATS]


def _record(n, k, fmt, seed=0):
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.2).astype(np.float32)
    raw = np.frombuffer(quantize(w, fmt).tobytes(), np.uint8)
    return TensorRecord("w", (n, k), fmt, raw)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
@pytest.mark.parametrize(
    "lead,k,n",
    [
        ((7,), 160, 96),  # ragged M
        ((2, 5), 96, 200),  # leading dims; N not a multiple of any tile
        ((130,), 64, 300),  # M and N past one 128-wide tile
    ],
    ids=["ragged-m", "leading-dims", "ragged-mn"],
)
def test_plain_matches_jax_f32(fmt, lead, k, n):
    rec = _record(n, k, fmt, seed=k + n)
    x = _x((*lead, k), seed=n)
    jw = jax_from_record(rec)
    ref_kernel = np.asarray(pallas_quant_matmul(jnp.asarray(x), jw))
    ref_xla = np.asarray(jax_quant_matmul(jnp.asarray(x), jw, impl="xla"))
    w = quant_linear_from_record(rec)
    got = qmatmul.dequant_matmul(torch.from_numpy(x), w).numpy()
    assert got.shape == (*lead, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref_kernel, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref_xla, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
def test_plain_matches_jax_bf16(fmt):
    rec = _record(96, 128, fmt, seed=9)
    x = _x((19, 128), seed=10)
    ref = pallas_quant_matmul(jnp.asarray(x, dtype=jnp.bfloat16), jax_from_record(rec))
    got = qmatmul.dequant_matmul(
        torch.from_numpy(x).to(torch.bfloat16), quant_linear_from_record(rec)
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=5e-2, rtol=5e-2
    )


def test_impls_and_linear_dispatch_on_cpu():
    rec = _record(64, 96, GGMLDType.Q4_1, seed=1)
    w = quant_linear_from_record(rec)
    x = torch.from_numpy(_x((3, 4, 96), seed=2))
    bias = torch.from_numpy(_x((64,), seed=3))
    plain = qmatmul.dequant_matmul_plain(x, w)
    # on a CPU tensor every impl is the plain version, bit for bit
    for impl in ("xla", "pallas", "int8"):
        torch.testing.assert_close(qmatmul.quant_matmul(x, w, impl=impl), plain, rtol=0, atol=0)
    torch.testing.assert_close(linear(x, w, bias, impl="pallas"), plain + bias, rtol=0, atol=0)
    # a dense kernel ignores impl, as in the JAX package
    dense = w.dequantize()
    torch.testing.assert_close(
        linear(x, dense, bias, impl="pallas"), linear(x, dense, bias), rtol=0, atol=0
    )


def test_cpu_runs_plain_version_and_counts_no_launch():
    w = quant_linear_from_record(_record(32, 64, GGMLDType.Q8_0))
    x = torch.from_numpy(_x((5, 64), seed=4))
    before = qmatmul.KERNEL.launches
    out = qmatmul.dequant_matmul(x, w)
    torch.testing.assert_close(out, qmatmul.dequant_matmul_plain(x, w), rtol=0, atol=0)
    assert qmatmul.KERNEL.launches == before == 0
    assert qmatmul.KERNEL.replaces == "vit_cpp_tpu/ops/pallas_qmatmul.py:38"


def test_rejects_bad_arguments():
    w = quant_linear_from_record(_record(32, 64, GGMLDType.Q8_0))
    with pytest.raises(ValueError, match="in_features"):
        qmatmul.dequant_matmul(torch.zeros(2, 32), w)
    stacked = type(w)(w.codes[None], w.scales[None], None, w.qtype)
    with pytest.raises(ValueError, match="one layer"):
        qmatmul.dequant_matmul(torch.zeros(2, 64), stacked)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1000, 1001])  # 1001: no vector loads on a row
def test_kernel_matches_plain_on_card(fmt, dtype, n):
    _card()
    dt = getattr(torch, dtype)
    w = quant_linear_from_record(_record(n, 768, fmt, seed=5), device="cuda")
    before = qmatmul.KERNEL.launches
    for lead in ((8,), (2, 197)):
        x = torch.from_numpy(_x((*lead, 768), seed=6)).to("cuda", dt)
        got = qmatmul.dequant_matmul(x, w).float()
        ref = qmatmul.dequant_matmul_plain(x, w).float()
        # relative to max|plain|: one bf16 output step is at most 2^-7 of it
        tol = (1e-2 if dt == torch.bfloat16 else 2e-5) * ref.abs().max().item()
        torch.testing.assert_close(got, ref, atol=tol, rtol=0)
    assert qmatmul.KERNEL.launches == before + 2
    with pytest.raises(ValueError, match="K % 32"):
        odd = type(w)(w.codes[:48].contiguous(), w.scales[:2].contiguous(), None, w.qtype)
        qmatmul.dequant_matmul(torch.zeros(2, 48, device="cuda", dtype=dt), odd)


@pytest.mark.parametrize(
    "m,n,sms,want",
    [
        (1576, 2304, 132, 256),  # ViT-B/16 qkv at B=8: 7 x 18 = 126 blocks of 256 rows
        (1576, 3072, 132, 256),  # fc1 at B=8
        (1576, 768, 132, 128),  # proj and fc2 at B=8: 42 blocks of 256 rows, 78 of 128
        (3152, 768, 132, 256),  # proj and fc2 at B=16: 78 blocks of 256 rows
        (12608, 768, 132, 256),  # proj and fc2 at B=64
        (8, 1000, 132, 128),  # the head
        (1, 768, 132, 128),
        (1576, 768, 78, 256),  # a card of 78 SMs is half full at 256 rows
    ],
    ids=["qkv-b8", "fc1-b8", "proj-b8", "proj-b16", "proj-b64", "head", "m1", "78sms"],
)
def test_tile_rows_keeps_the_card_full(m, n, sms, want):
    assert qmatmul.tile_rows(m, n, sms) == want


# The edges of the bf16 body's tiling (256- or 128-row blocks of 128
# columns, 64-row K steps): ragged M and N, fc2's K, K % 64 == 32, rows of
# codes that are not 16-byte (N=1000) or 8-byte (N=1001) aligned.
TILE_EDGES = [(1, 768, 768), (129, 3072, 768), (1577, 768, 3072), (1577, 768, 1000),
              (129, 768, 1001), (129, 800, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
@pytest.mark.parametrize("m,k,n", TILE_EDGES, ids=[f"M{m}-K{k}-N{n}" for m, k, n in TILE_EDGES])
def test_bf16_kernel_tile_edges_on_card(fmt, m, k, n):
    _card()
    w = quant_linear_from_record(_record(n, k, fmt, seed=m + n), device="cuda")
    x = torch.from_numpy(_x((m, k), seed=k)).to("cuda", torch.bfloat16)
    before = qmatmul.KERNEL.launches
    got = qmatmul.dequant_matmul(x, w).float()
    ref = qmatmul.dequant_matmul_plain(x, w).float()
    assert qmatmul.KERNEL.launches == before + 1
    torch.testing.assert_close(got, ref, atol=1e-2 * ref.abs().max().item(), rtol=0)


# The edges of the f32 (3xTF32) body's tiling (128-row x 128-column
# blocks, 32-row K steps): M = 1, 8, one past a block, B=8 plus one and
# ViT-B/16's B=64; fc2's K and K % 64 == 32; N = 96 (under one block),
# 1000 and 1001 (rows of codes 8-byte aligned, and not at all), 2304,
# 3072. The tolerance is chip_smoke.py's QMM_TOL for f32: 2e-5 of
# max|plain| (3xTF32 and cuBLAS's f32 GEMM differ in summation order).
F32_TILE_EDGES = [(1, 768, 768), (8, 768, 1000), (129, 3072, 768), (129, 800, 1001),
                  (1577, 768, 3072), (1577, 768, 96), (12608, 768, 2304)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
@pytest.mark.parametrize("m,k,n", F32_TILE_EDGES,
                         ids=[f"M{m}-K{k}-N{n}" for m, k, n in F32_TILE_EDGES])
def test_f32_kernel_tile_edges_on_card(fmt, m, k, n):
    _card()
    w = quant_linear_from_record(_record(n, k, fmt, seed=m + n), device="cuda")
    x = torch.from_numpy(_x((m, k), seed=k)).to("cuda")
    before = qmatmul.KERNEL.launches
    got = qmatmul.dequant_matmul(x, w)
    ref = qmatmul.dequant_matmul_plain(x, w)
    assert qmatmul.KERNEL.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, atol=2e-5 * ref.abs().max().item(), rtol=0)


@pytest.mark.cuda
def test_f32_kernel_copies_a_misaligned_view():
    # TMA reads x from a 16-byte-aligned base: the wrapper copies a view
    # that starts 4 bytes in, and the kernel still launches
    _card()
    w = quant_linear_from_record(_record(768, 768, GGMLDType.Q4_1, seed=3), device="cuda")
    flat = torch.from_numpy(_x((129 * 768 + 1,), seed=4)).to("cuda")
    x = flat[1:].view(129, 768)
    assert x.data_ptr() % 16
    before = qmatmul.KERNEL.launches
    got = qmatmul.dequant_matmul(x, w)
    ref = qmatmul.dequant_matmul_plain(x.contiguous(), w)
    assert qmatmul.KERNEL.launches == before + 1
    torch.testing.assert_close(got, ref, atol=2e-5 * ref.abs().max().item(), rtol=0)
