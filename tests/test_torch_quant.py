"""The port's block codec, QuantLinear loading, requantization, folding and
quantize tool against the JAX package's.

Inputs are made with numpy from a seed. The codec is the same numpy
arithmetic in both packages, so bytes, codes, scales and dequantized
values must be bit-equal, edge cases included: a zero block, blocks whose
absolute maximum is tied between +a and -a, and values exactly on the
half-steps where rounding decides. Folded biases are f32 sums taken in
another order, compared with the tolerance stated at the test.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.cli.quantize import quantize_model_file as jax_quantize_model_file
from vit_cpp_tpu.gguf.dtypes import QK, QUANT_ITYPES, GGMLDType
from vit_cpp_tpu.gguf.reader import TensorRecord, read_model
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models.fold import fold_layernorms as jax_fold
from vit_cpp_tpu.models.params import load_params as jax_load_params
from vit_cpp_tpu.quant import blocks as jax_blocks
from vit_cpp_tpu.quant import int8 as jax_int8
from vit_cpp_tpu.quant.qlinear import _quant_linear_from_record as jax_from_record
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.cli.quantize import quantize_model_file
from vit_cpp_tpu_torch.engine import detect_hparams
from vit_cpp_tpu_torch.models.fold import fold_layernorms
from vit_cpp_tpu_torch.models.params import load_params, params_from_jax
from vit_cpp_tpu_torch.quant import blocks, int8
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear, quant_linear_from_record

FORMATS = [GGMLDType.Q4_0, GGMLDType.Q4_1, GGMLDType.Q5_0, GGMLDType.Q5_1, GGMLDType.Q8_0]
IDS = [f.name for f in FORMATS]


def _values(seed=0) -> np.ndarray:
    """16 blocks: random ones plus the rounding edge cases."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, QK)).astype(np.float32)
    x[1] = 0.0  # zero block: d = 0 and inverse 0
    x[2, 3], x[2, 17] = 2.5, -2.5  # tied +/- absmax: argmax takes the first
    x[3, 5], x[3, 30] = -1.75, 1.75  # tied, negative first
    x[4] = np.arange(QK, dtype=np.float32) / 4.0 - 4.0  # half steps of Q8_0/Q4
    x[5] = (np.arange(QK) % 4 - 1.5).astype(np.float32)  # min/max on .5 steps
    x[6] = 1e-3 * rng.standard_normal(QK).astype(np.float32)  # f16-subnormal-ish d
    x[7] = 7.0  # a constant block: max == min for the _1 formats
    return x.reshape(-1)


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
def test_quantize_bytes_equal_to_jax(fmt):
    x = _values()
    assert blocks.quantize(x, fmt).tobytes() == jax_blocks.quantize(x, fmt).tobytes()


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
def test_unpack_and_dequantize_equal_to_jax(fmt):
    x = _values(1)
    raw = jax_blocks.quantize(x, fmt).tobytes()
    got, ref = blocks.unpack_soa(raw, x.size, fmt), jax_blocks.unpack_soa(raw, x.size, fmt)
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_array_equal(
        blocks.dequantize(raw, x.size, fmt), jax_blocks.dequantize(raw, x.size, fmt)
    )
    assert blocks.CODE_OFFSET[fmt] == jax_blocks.CODE_OFFSET[fmt]


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
def test_quantize_with_hist_equal_to_jax(fmt):
    x = _values(2)
    got_blocks, got_hist = blocks.quantize_with_hist(x, fmt)
    ref_blocks, ref_hist = jax_blocks.quantize_with_hist(x, fmt)
    assert got_blocks.tobytes() == ref_blocks.tobytes()
    np.testing.assert_array_equal(got_hist, ref_hist)
    assert got_hist.sum() == x.size


def _record(fmt, out_f=96, in_f=128, seed=3):
    w = (np.random.default_rng(seed).standard_normal((out_f, in_f)) * 0.2).astype(np.float32)
    w[5, :QK] = 0.0  # one zero block
    raw = np.frombuffer(jax_blocks.quantize(w, fmt).tobytes(), np.uint8)
    return TensorRecord("w", (out_f, in_f), fmt, raw)


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
def test_quant_linear_from_record_bit_equal_to_jax(fmt):
    rec = _record(fmt)
    got, ref = quant_linear_from_record(rec), jax_from_record(rec)
    assert got.qtype == ref.qtype == int(fmt) and got.offset == ref.offset
    assert (got.in_features, got.out_features) == (128, 96)
    assert got.codes.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    assert (got.mins is None) == (ref.mins is None)
    if ref.mins is not None:
        np.testing.assert_array_equal(got.mins.numpy(), np.asarray(ref.mins))
    # the dense weight: (c - offset) * scale [+ min] in f32, as in JAX
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(ref.dequantize()))
    np.testing.assert_array_equal(
        got.dequantize(torch.float32).numpy().T.reshape(-1),
        blocks.dequantize(rec.data, rec.n_elements, fmt),
    )


def test_quant_linear_rejects_a_record_of_the_wrong_size():
    rec = _record(GGMLDType.Q8_0)
    short = TensorRecord("w", rec.shape, rec.dtype, rec.data[:-34])
    with pytest.raises(ValueError, match="bytes of Q8_0"):
        quant_linear_from_record(short)


@pytest.mark.parametrize("fmt", FORMATS, ids=IDS)
def test_from_quant_linear_bit_equal_to_jax(fmt):
    rec = _record(fmt, seed=4)
    got = int8.from_quant_linear(quant_linear_from_record(rec))
    ref = jax_int8.from_quant_linear(jax_from_record(rec))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


def test_stacked_quant_linear_indexes_by_layer():
    from vit_cpp_tpu_torch.quant.qlinear import stack

    layers = [quant_linear_from_record(_record(GGMLDType.Q5_1, seed=s)) for s in (5, 6)]
    both = stack(layers)
    assert both.codes.shape == (2, 128, 96) and both.mins.shape == (2, 4, 96)
    for i, ql in enumerate(layers):
        one = both[i]
        assert isinstance(one, QuantLinear) and one.qtype == ql.qtype
        torch.testing.assert_close(one.codes, ql.codes, rtol=0, atol=0)
        torch.testing.assert_close(one.dequantize(), ql.dequantize(), rtol=0, atol=0)
    torch.testing.assert_close(
        both.dequantize()[1], layers[1].dequantize(), rtol=0, atol=0
    )


HP = VitHParams(
    hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
    num_classes=5, patch_size=8, img_size=16,
)


@pytest.fixture(scope="module")
def f16_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("quant") / "m-f16.gguf")
    write_synthetic_model(path, HP, ftype=1, seed=7)
    return path


@pytest.mark.parametrize("itype", sorted(QUANT_ITYPES))
def test_quantize_tool_writes_the_jax_tools_bytes(f16_file, tmp_path, capsys, itype):
    ref, got = str(tmp_path / "ref.gguf"), str(tmp_path / "got.gguf")
    assert jax_quantize_model_file(f16_file, ref, itype)
    ref_out = capsys.readouterr().out
    assert quantize_model_file(f16_file, got, itype)
    got_out = capsys.readouterr().out
    with open(ref, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    assert got_out == ref_out  # the same console lines
    assert "quantizing .." in got_out and "hist:" in got_out


def test_quantize_tool_main_rejects_bad_itype(f16_file, tmp_path, capsys):
    from vit_cpp_tpu_torch.cli.quantize import main

    assert main([f16_file, str(tmp_path / "x.gguf"), "5"]) == 1
    assert "invalid quantization type 5" in capsys.readouterr().err
    assert main([]) == 1
    assert "type = 8 - q8_0" in capsys.readouterr().out


def _quantized(f16_file, tmp_path, itype):
    path = str(tmp_path / f"m-{itype}.gguf")
    assert jax_quantize_model_file(f16_file, path, itype, verbose=False)
    return path


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        elif isinstance(v, QuantLinear):
            out[f"{prefix}{k}.codes"] = v.codes
            out[f"{prefix}{k}.scales"] = v.scales
            if v.mins is not None:
                out[f"{prefix}{k}.mins"] = v.mins
        elif isinstance(v, int8.Int8Linear):
            out[f"{prefix}{k}.codes"] = v.codes
            out[f"{prefix}{k}.scale"] = v.scale
        elif v is not None:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("itype", [8, 3], ids=["Q8_0", "Q4_1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_params_matches_jax_on_quantized_files(f16_file, tmp_path, itype, dtype):
    path = _quantized(f16_file, tmp_path, itype)
    mf = read_model(path)
    ref_tree = params_from_jax(jax_load_params(mf, dtype=getattr(jnp, dtype)))
    got_tree = load_params(mf, dtype=getattr(torch, dtype), hparams=detect_hparams(mf))
    qkv = got_tree["blocks"]["qkv"]["kernel"]
    assert isinstance(qkv, QuantLinear) and qkv.qtype == int(QUANT_ITYPES[itype])
    assert qkv.codes.shape == (2, 64, 192) and qkv.scales.shape == (2, 2, 192)
    assert isinstance(got_tree["head"]["kernel"], QuantLinear)
    got, ref = _flatten(got_tree), _flatten(ref_tree)
    assert got.keys() == ref.keys()
    for name, t in got.items():
        assert t.dtype == ref[name].dtype, name
        torch.testing.assert_close(t, ref[name], rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("mm", ["int8", "pallas"])
def test_fold_layernorms_with_quant_linear_matches_jax(f16_file, tmp_path, mm):
    jparams = jax_load_params(read_model(_quantized(f16_file, tmp_path, 7)))  # Q5_1
    ref = _flatten(params_from_jax(jax_fold(jparams, mm_impl=mm)))
    folded = fold_layernorms(params_from_jax(jparams), mm_impl=mm)
    got = _flatten(folded)
    assert got.keys() == ref.keys()
    # int8: the folded qkv/fc1/head become Int8Linear; pallas: dense f32;
    # proj and fc2 are not folded and stay QuantLinear either way
    want = int8.Int8Linear if mm == "int8" else torch.Tensor
    assert isinstance(folded["blocks"]["qkv"]["kernel"], want)
    assert isinstance(folded["head"]["kernel"], want)
    assert isinstance(folded["blocks"]["proj"]["kernel"], QuantLinear)
    for name in got:
        if name.endswith((".codes", ".scale", ".scales", ".mins")) or "kernel" in name:
            # codes, scales and gamma * w: elementwise, bit-equal
            torch.testing.assert_close(got[name], ref[name], rtol=0, atol=0, msg=name)
        else:  # folded biases: beta @ W summed in another order
            torch.testing.assert_close(got[name], ref[name], rtol=1e-5, atol=1e-6, msg=name)


def test_quantized_file_size_matches_block_bytes(f16_file, tmp_path):
    # the Q4_0 file stores 18 bytes per 32 weights of every 2-D .weight
    path = str(tmp_path / "q4.gguf")
    assert quantize_model_file(f16_file, path, 2, verbose=False)
    mf = read_model(path)
    quantized = {n: r for n, r in mf.tensors.items() if r.dtype.is_quantized}
    assert set(quantized) == {
        n for n, r in read_model(f16_file).tensors.items()
        if n.endswith("weight") and len(r.shape) == 2
    }
    for r in quantized.values():
        assert r.dtype == GGMLDType.Q4_0 and r.data.nbytes == r.n_elements // QK * 18
    assert mf.hparams.ftype == 2
    assert os.path.getsize(path) < os.path.getsize(f16_file)
