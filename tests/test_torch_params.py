"""The port's checkpoint loading and preprocessing against the JAX package's.

Both packages read the same synthetic f16 checkpoint; f16 -> f32 is exact,
so the loaded weights must be equal, as must the bf16 storage (one
round-to-nearest-even from the same f32 value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.gguf.reader import read_model
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models.params import load_params as jax_load_params
from vit_cpp_tpu.ops.preprocess import preprocess_batch as jax_preprocess_batch
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.engine import detect_hparams
from vit_cpp_tpu_torch.models.params import load_params, params_from_jax
from vit_cpp_tpu_torch.ops.preprocess import preprocess_batch


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize(
    "extra",
    [
        {},
        {"num_prefix_tokens": 2, "norm_pre": True},  # DeiT-distilled + pre-norm
        {"global_pool": "avg", "num_reg_tokens": 2},  # fc_norm + registers
    ],
    ids=["cls", "distilled", "avg"],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_params_matches_jax(tmp_path, extra, dtype):
    hp = VitHParams(
        hidden_size=48, num_hidden_layers=2, num_attention_heads=2,
        num_classes=7, patch_size=8, img_size=16, **extra,
    )
    path = str(tmp_path / "m.gguf")
    write_synthetic_model(path, hp, ftype=1, seed=1)
    mf = read_model(path)
    ref = _flatten(
        params_from_jax(jax_load_params(mf, dtype=getattr(jnp, dtype)))
    )
    got = _flatten(load_params(mf, dtype=getattr(torch, dtype), hparams=detect_hparams(mf)))
    assert got.keys() == ref.keys()
    for name, t in got.items():
        assert t.dtype == getattr(torch, dtype), name
        assert t.shape == ref[name].shape, name
        torch.testing.assert_close(t, ref[name], rtol=0, atol=0, msg=name)


def test_params_from_jax_keeps_int8_leaves(tmp_path):
    from vit_cpp_tpu.quant.int8 import convert_params_to_int8
    from vit_cpp_tpu_torch.quant.int8 import Int8Linear

    hp = VitHParams(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
        num_classes=4, patch_size=8, img_size=16,
    )
    path = str(tmp_path / "m.gguf")
    write_synthetic_model(path, hp, ftype=1, seed=2)
    jparams = convert_params_to_int8(jax_load_params(read_model(path)))
    qkv = params_from_jax(jparams)["blocks"]["qkv"]["kernel"]
    assert isinstance(qkv, Int8Linear)
    assert qkv.codes.dtype == torch.int8 and qkv.codes.shape == (1, 32, 96)
    np.testing.assert_array_equal(
        qkv.codes.numpy(), np.asarray(jparams["blocks"]["qkv"]["kernel"].codes)
    )


def test_load_params_rejects_quantized_records(tmp_path):
    from vit_cpp_tpu.gguf.dtypes import GGMLDType
    from vit_cpp_tpu.gguf.reader import TensorRecord

    hp = VitHParams(
        hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
        num_classes=4, patch_size=8, img_size=16,
    )
    path = str(tmp_path / "m.gguf")
    write_synthetic_model(path, hp, ftype=1, seed=2)
    mf = read_model(path)
    r = mf.tensors["blocks.0.attn.qkv.weight"]
    # f16 bytes under a Q8_0 tag: the block count does not match the data
    mf.tensors[r.name] = TensorRecord(r.name, r.shape, GGMLDType.Q8_0, r.data)
    with pytest.raises(ValueError, match="bytes of Q8_0"):
        load_params(mf)


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_preprocess_batch_matches_jax(mode):
    rng = np.random.default_rng(3)
    images = [
        rng.integers(0, 256, (40, 57, 3), dtype=np.uint8),
        rng.integers(0, 256, (300, 23, 3), dtype=np.uint8),  # two canvases
    ]
    ref = np.asarray(jax_preprocess_batch(images, 24, mode=mode))
    got = preprocess_batch(images, 24, mode=mode).numpy()
    assert got.shape == ref.shape == (2, 3, 24, 24)
    # the u8 re-rounding can flip where the two einsums' f32 sums straddle
    # a half-integer: allow one u8 step (1/57.1 after normalization) there
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0 / 57.0 + 1e-5
    assert (diff > 1e-5).mean() < 1e-3
