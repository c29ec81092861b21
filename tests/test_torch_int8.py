"""The port's W8A8 path and LayerNorm folding against the JAX package's.

The int8 codes and the int32 accumulators are exact integer results of the
same operation order, so they must be bit-equal; the f32 epilogue and the
folded weights compare with tolerances stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.gguf.reader import read_model
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models.fold import fold_layernorms as jax_fold
from vit_cpp_tpu.models.params import load_params as jax_load_params
from vit_cpp_tpu.ops.pallas_int8_matmul import w8a8_matmul as jax_w8a8
from vit_cpp_tpu.quant import int8 as jax_int8
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.models.fold import fold_layernorms
from vit_cpp_tpu_torch.models.params import params_from_jax
from vit_cpp_tpu_torch.ops import int8_matmul
from vit_cpp_tpu_torch.quant import int8


def _weight(seed, shape=(48, 40)):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero output channel: scale 0, codes 0
    return w


def test_channelwise_codes_bit_equal():
    w = _weight(0, (2, 48, 40))  # stacked ([L,] in, out)
    ref = jax_int8.channelwise_int8(jnp.asarray(w))
    got = int8.channelwise_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


def _act(seed, shape=(3, 7, 48)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    x[0, 2] = 0.0  # a zero token: sx = 0 must give codes 0, not NaN
    return x


@pytest.mark.parametrize("static", [False, True])
def test_w8a8_codes_and_accumulators_bit_equal(static):
    w = jax_int8.channelwise_int8(jnp.asarray(_weight(1)))
    if static:
        w = jax_int8.Int8Linear(w.codes, w.scale, act_scale=jnp.float32(0.021))
    x = _act(2)
    pw = params_from_jax(w)
    xq, sx = int8_matmul.quantize_activations(torch.from_numpy(x), pw)

    xf = jnp.asarray(x)
    if static:
        ref_xq = jnp.round(jnp.clip(xf / w.act_scale, -127.0, 127.0)).astype(jnp.int8)
    else:
        ref_sx = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) * (1.0 / 127.0)
        ref_xq = jnp.round(xf * jnp.where(ref_sx > 0, 1.0 / ref_sx, 0.0)).astype(jnp.int8)
        np.testing.assert_array_equal(sx.numpy(), np.asarray(ref_sx))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(ref_xq))

    acc = int8_matmul.int8_mm(xq.reshape(-1, 48), pw.codes).numpy()
    ref_acc = np.asarray(ref_xq, np.int64).reshape(-1, 48) @ np.asarray(w.codes, np.int64)
    assert acc.dtype == np.int32
    np.testing.assert_array_equal(acc, ref_acc)

    # the f32 epilogue: same operations in the same order
    got = int8_matmul.w8a8_matmul(torch.from_numpy(x), pw).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_w8a8(xf, w)), rtol=1e-6, atol=1e-6)


def test_w8a8_bf16_activations():
    w = jax_int8.channelwise_int8(jnp.asarray(_weight(3)))
    x = _act(4)
    ref = jax_w8a8(jnp.asarray(x, jnp.bfloat16), w)
    got = int8_matmul.w8a8_matmul(torch.from_numpy(x).bfloat16(), params_from_jax(w))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the same f32 value: equal, or one bf16 ulp apart
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), rtol=2 ** -7, atol=1e-6
    )


@pytest.fixture(scope="module")
def tiny_file(tmp_path_factory):
    hp = VitHParams(
        hidden_size=48, num_hidden_layers=2, num_attention_heads=2,
        num_classes=10, patch_size=8, img_size=16,
    )
    path = str(tmp_path_factory.mktemp("int8") / "m.gguf")
    write_synthetic_model(path, hp, ftype=1, seed=4)
    return path


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        elif isinstance(v, int8.Int8Linear):
            out[f"{prefix}{k}.codes"] = v.codes.numpy()
            out[f"{prefix}{k}.scale"] = v.scale.numpy()
        elif v is not None:
            out[prefix + k] = v.float().numpy()
    return out


@pytest.mark.parametrize("mm", ["xla", "int8"])
def test_fold_layernorms_matches_jax(tiny_file, mm):
    jparams = jax_load_params(read_model(tiny_file))
    params = params_from_jax(jparams)
    if mm == "int8":
        jparams = jax_int8.convert_params_to_int8(jparams)
        params = int8.convert_params_to_int8(params)
    ref = _flatten(params_from_jax(jax_fold(jparams, mm_impl=mm)))
    got = _flatten(fold_layernorms(params))
    assert got.keys() == ref.keys()
    for name in got:
        if name.endswith((".codes", ".scale")):
            # requantized elementwise from gamma * w: bit-equal
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
        else:  # folded biases: beta @ W summed in another order
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-5, atol=1e-6, err_msg=name)
    assert fold_layernorms(params)["norm"]["scale"] is None
