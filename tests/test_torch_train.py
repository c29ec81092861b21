"""The port's training step (vit_cpp_tpu_torch.parallel.train) against the
JAX package's (vit_cpp_tpu.parallel.train).

The same weights (the JAX tree carried over by `params_from_jax`) and the
same numpy inputs go through both. On the CPU the port's training
attention runs its plain forward and backward; the JAX one runs its
Pallas kernels in interpret mode.

Tolerances: the loss to rtol 1e-5 and the gradients to atol 5e-5 / rtol
1e-3, the JAX package's own bound between its fused and composed
training graphs (tests/test_pallas_kernels.py); the optimizer, fed the
same gradients, to rtol 1e-6 on parameters of magnitude 0.5 or more
(optax rounds its Adam constants to f32, torch.optim keeps them in f64);
three train_step losses to rtol 1e-4.
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models import params_from_state_dict
from vit_cpp_tpu.parallel import train as jtrain
from vit_cpp_tpu.testing.synthetic import random_state_dict
from vit_cpp_tpu_torch.hparams import VitHParams as PortHParams
from vit_cpp_tpu_torch.models.params import params_from_jax
from vit_cpp_tpu_torch.parallel import train as ttrain

HP = VitHParams(
    hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
    num_classes=5, patch_size=8, img_size=32,
)
PORT_HP = PortHParams(**dataclasses.asdict(HP))  # the port's own, same fields


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def setup():
    jparams = params_from_state_dict(random_state_dict(HP, seed=2), HP)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 5, (2,)).astype(np.int32)
    return jparams, x, y


def _port_params(jparams, requires_grad=True):
    params = params_from_jax(jparams)
    for leaf in ttrain.tree_leaves(params):
        leaf.requires_grad_(requires_grad)
    return params


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_loss_and_grads_match_jax(setup, smooth):
    jparams, x, y = setup
    l_ref, g_ref = jax.value_and_grad(jtrain.cross_entropy_loss)(
        jparams, jnp.asarray(x), jnp.asarray(y), HP, smooth
    )
    params = _port_params(jparams)
    loss = ttrain.cross_entropy_loss(params, torch.from_numpy(x), torch.from_numpy(y), PORT_HP, smooth)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(l_ref), rtol=1e-5)
    ref, got = _flat(g_ref), {k: v.grad for k, v in _flat(params).items()}
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(ref[k]), atol=5e-5, rtol=1e-3, err_msg=k
        )


OPT_CASES = {
    "const": dict(lr=1e-3, weight_decay=0.05),
    "const-warmup": dict(lr=1e-3, weight_decay=0.05, warmup_steps=2),
    "cosine-warmup": dict(lr=1e-3, weight_decay=0.1, schedule="cosine", total_steps=5, warmup_steps=1),
    "clip": dict(lr=1e-3, weight_decay=0.05, clip_norm=0.5),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    kw = OPT_CASES[case]
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 5)}
    # optax takes 1 - b2**t in f32 and torch in f64: an update differs by up
    # to ~3e-5 of itself (~3e-8 at lr 1e-3), so parameters are drawn away
    # from zero, where rtol 1e-6 is 5e-7 or more
    p0 = {
        k: (np.sign(rng.standard_normal(s)) * (0.5 + np.abs(rng.standard_normal(s))))
        .astype(np.float32)
        for k, s in shapes.items()
    }
    grads = [
        {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in shapes.items()}
        for _ in range(3)
    ]
    opt = jtrain.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    ostate = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = ttrain.make_optimizer(list(tp.values()), **kw)
    for g in grads:
        updates, ostate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, ostate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)
    assert not np.allclose(tp["a"].numpy(), p0["a"])  # the updates did move them


def test_first_warmup_update_is_zero():
    p = torch.ones(3, requires_grad=True)
    opt = ttrain.make_optimizer([p], lr=1e-2, warmup_steps=4)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3))  # optax's count-0 lr is 0
    assert opt.scheduler.get_last_lr()[0] == pytest.approx(2.5e-3)


def test_train_step_losses_match_jax(setup):
    jparams, x, y = setup
    kw = dict(lr=1e-3, weight_decay=0.05)
    opt = jtrain.make_optimizer(**kw)
    jstate = jtrain.TrainState(
        jax.tree.map(jnp.array, jparams), opt.init(jparams), jnp.zeros((), jnp.int32)
    )
    tstate = ttrain.create_train_state(params_from_jax(jparams), kw)
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(3):
        jstate, l_ref = jtrain.train_step(jstate, xj, yj, HP, opt)
        loss = ttrain.train_step(tstate, xt, yt, PORT_HP)
        np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-4)
    assert tstate.step == 3


def test_train_step_accum_equals_big_batch(setup):
    jparams, _, _ = setup
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 3, 32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, (4,)))
    big = ttrain.create_train_state(params_from_jax(jparams))
    acc = ttrain.create_train_state(params_from_jax(jparams))
    l_big = ttrain.train_step(big, x, y, PORT_HP, smooth=0.1)
    l_acc = ttrain.train_step_accum(acc, x, y, PORT_HP, 2, smooth=0.1)
    np.testing.assert_allclose(float(l_acc), float(l_big), rtol=1e-6)
    # the gradients of the update (compared before Adam, where a gradient
    # near zero could flip the sign of an update)
    for a, b in zip(ttrain.tree_leaves(acc.params), ttrain.tree_leaves(big.params)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        ttrain.train_step_accum(acc, x[:3], y[:3], PORT_HP, 2)


def test_freeze_backbone_leaves_non_head_bit_equal(setup):
    jparams, x, y = setup
    before = params_from_jax(jparams)
    state = ttrain.create_train_state(
        params_from_jax(jparams), dict(lr=1e-2), trainable=("head",)
    )
    for _ in range(2):
        ttrain.train_step(state, torch.from_numpy(x), torch.from_numpy(y), PORT_HP)
    for k, v in _flat(state.params).items():
        if k.startswith("head/"):
            assert not torch.equal(v.detach(), _flat(before)[k]), k
        else:
            assert torch.equal(v.detach(), _flat(before)[k]), k
            assert v.grad is None and not v.requires_grad, k
