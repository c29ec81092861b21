"""The port's training augmentation (vit_cpp_tpu_torch.ops.augment) against
the JAX package's (vit_cpp_tpu.ops.augment).

The two draw their random numbers from different generators (a CPU
torch.Generator here, threefry there), so what is compared is the
deterministic part: the bilinear resample for given boxes, the flip for
given bits, box geometry, replay from a seed, and the mixup arithmetic
and loss for a given mix. Values are O(1) f32: 1e-6 absolute for the
resample (the same few f32 operations), exact where no arithmetic runs.
"""

import dataclasses
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.ops import augment as jaug
from vit_cpp_tpu_torch.ops import augment as taug


def _batch(seed=0, b=3, c=2, s=8):
    return np.random.default_rng(seed).standard_normal((b, c, s, s)).astype(np.float32)


@pytest.mark.parametrize("axis", [2, 3])
def test_resample_axis_matches_jax(axis):
    x = _batch()
    rng = np.random.default_rng(1)
    start = rng.uniform(0.0, 3.0, 3).astype(np.float32)
    step = rng.uniform(0.4, 1.0, 3).astype(np.float32)
    ref = jaug.resample_axis(jnp.asarray(x), jnp.asarray(start), jnp.asarray(step), axis)
    got = taug.resample_axis(torch.from_numpy(x), torch.from_numpy(start), torch.from_numpy(step), axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_identity_crop_is_exact():
    x = torch.from_numpy(_batch())
    got = taug.random_resized_crop(taug.step_generator(0, 0), x, scale=(1.0, 1.0), ratio=(1.0, 1.0))
    assert torch.equal(got, x)


def test_flip_with_given_bits_matches_jax():
    x = _batch(b=6)
    gen = taug.step_generator(4, 2)
    bits = (torch.rand(6, generator=taug.step_generator(4, 2)) < 0.5).numpy()
    assert 0 < bits.sum() < 6  # both outcomes occur in this draw
    ref = jnp.where(jnp.asarray(bits)[:, None, None, None], jnp.asarray(x)[..., ::-1], jnp.asarray(x))
    got = taug.random_hflip(gen, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_boxes_stay_inside_the_image():
    y0, x0, h, w = taug.crop_boxes(taug.step_generator(1, 1), 4096, (0.08, 1.0), (0.5, 2.0))
    for lo, ext in ((y0, h), (x0, w)):
        assert (lo >= 0).all() and (ext > 0).all() and (lo + ext <= 1.0 + 1e-6).all()
    area = (h * w).numpy()
    assert area.min() >= 0.08 * 0.99 and area.max() <= 1.0


def test_same_seed_and_update_replay_the_batch():
    x = torch.from_numpy(_batch(b=4, s=16))
    a = taug.augment_batch(taug.step_generator(7, 3), x)
    b = taug.augment_batch(taug.step_generator(7, 3), x)
    c = taug.augment_batch(taug.step_generator(7, 4), x)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == x.shape and torch.isfinite(a).all()


def test_mixup_is_a_convex_combination_and_its_loss_matches_jax():
    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.models import params_from_state_dict
    from vit_cpp_tpu.parallel.train import _mixed_cross_entropy_loss as jmixed
    from vit_cpp_tpu.testing.synthetic import random_state_dict
    from vit_cpp_tpu_torch.hparams import VitHParams as PortHParams
    from vit_cpp_tpu_torch.models.params import params_from_jax
    from vit_cpp_tpu_torch.parallel.train import _mixed_cross_entropy_loss as tmixed

    hp = VitHParams(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                    num_classes=4, patch_size=8, img_size=16)
    x = torch.from_numpy(_batch(b=4, c=3, s=16))
    mixed, perm, lam = taug.mixup_batch(taug.step_generator(0, 5), x, 0.4)
    assert 0.5 <= lam <= 1.0
    assert sorted(perm.tolist()) == [0, 1, 2, 3]
    torch.testing.assert_close(mixed, lam * x + (1.0 - lam) * x[perm], rtol=0, atol=0)

    jparams = params_from_state_dict(random_state_dict(hp, seed=1), hp)
    y = np.array([0, 1, 2, 3], np.int32)
    y2 = y[perm.numpy()]
    ref = jmixed(jparams, jnp.asarray(mixed.numpy()), jnp.asarray(y), jnp.asarray(y2),
                 jnp.float32(lam), hp, 0.1)
    got = tmixed(params_from_jax(jparams), mixed, torch.from_numpy(y),
                 torch.from_numpy(y2), lam, PortHParams(**dataclasses.asdict(hp)), 0.1)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


@pytest.mark.parametrize("mode", ["none", "flip", "crop", "all", "bogus"])
def test_augment_flags_modes(mode):
    if mode == "bogus":
        with pytest.raises(ValueError):
            taug.augment_flags(mode)
        return
    assert taug.augment_flags(mode) == jaug.augment_flags(mode)
    assert taug.AUGMENT_MODES == jaug.AUGMENT_MODES
