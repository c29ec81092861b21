"""The port's LoRA fine-tuning (vit_cpp_tpu_torch.models.lora +
parallel/train.py::train_step_lora + finetune(lora=)) against the JAX
package's (vit_cpp_tpu.models.lora).

The port draws its adapters from a torch.Generator, which cannot replay
jax.random's stream, so the parity cases carry the JAX package's
adapters over (`params_from_jax`), with `b` set to a nonzero seeded draw so
that `a`'s gradient is not zero.

Tolerances: the merged kernels to 1e-6 of an f64 product (a rank-3 f32
product summed in another order); the loss to rtol 1e-5 and the
gradients to atol 5e-5 / rtol 1e-3, the bounds of test_torch_train.py;
three train_step_lora losses to rtol 1e-4, as train_step's there (under
QAT the second and third to rel 1e-2, the JAX package's bound for a
fake-quantized loss whose weights moved: an ulp can flip a code).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models import lora as jlora
from vit_cpp_tpu.models import params_from_state_dict
from vit_cpp_tpu.parallel import train as jtrain
from vit_cpp_tpu.testing.synthetic import random_state_dict, write_synthetic_model
from vit_cpp_tpu_torch.hparams import VitHParams as PortHParams
from vit_cpp_tpu_torch.models import lora as tlora
from vit_cpp_tpu_torch.models.params import params_from_jax
from vit_cpp_tpu_torch.parallel import train as ttrain

TINY = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_classes=16,
                  patch_size=8, img_size=32)
PORT_TINY = PortHParams(**dataclasses.asdict(TINY))
QUIET = dict(log=lambda m: None, device="cpu")


def _tiny_params(seed=0):
    return params_from_state_dict(random_state_dict(TINY, seed=seed), TINY)


def _jax_trainable(params, rank, seed, b_seed):
    """The JAX package's adapters with `b` drawn nonzero from `b_seed`."""
    tr = jlora.lora_trainable(params, rank, seed)
    rng = np.random.default_rng(b_seed)
    for name in jlora.LORA_SITES:
        ab = tr["lora"]["blocks"][name]
        ab["b"] = jnp.asarray(rng.standard_normal(ab["b"].shape).astype(np.float32) * 0.1)
    return tr


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


def test_sites_are_the_jax_packages():
    assert tlora.LORA_SITES == jlora.LORA_SITES


def test_init_is_zero_effect_and_shapes():
    params = params_from_jax(_tiny_params())
    tr = tlora.lora_trainable(params, rank=4, seed=1)
    for name in tlora.LORA_SITES:
        a, b = tr["lora"]["blocks"][name]["a"], tr["lora"]["blocks"][name]["b"]
        k = params["blocks"][name]["kernel"]
        assert a.shape == (k.shape[0], k.shape[1], 4) and b.shape == (k.shape[0], 4, k.shape[2])
        assert torch.equal(b, torch.zeros_like(b)) and a.abs().max() > 0
    assert tr["head"] is params["head"]
    merged = tlora.merge_lora(params, tr, alpha=8.0)
    for name in tlora.LORA_SITES:
        assert torch.equal(merged["blocks"][name]["kernel"], params["blocks"][name]["kernel"])
    again = tlora.init_lora(params, 4, seed=1)
    other = tlora.init_lora(params, 4, seed=2)
    assert torch.equal(again["blocks"]["qkv"]["a"], tr["lora"]["blocks"]["qkv"]["a"])
    assert not torch.equal(other["blocks"]["qkv"]["a"], tr["lora"]["blocks"]["qkv"]["a"])
    with pytest.raises(ValueError, match="rank"):
        tlora.init_lora(params, 0)
    assert tlora.lora_state_bytes(tr) < 0.15 * tlora.lora_state_bytes(params)


def test_merge_matches_jax_and_the_f64_delta():
    jparams = _tiny_params(seed=2)
    jtr = _jax_trainable(jparams, 3, 3, 4)
    want = jlora.merge_lora(jparams, jtr, 6.0)
    got = tlora.merge_lora(params_from_jax(jparams), params_from_jax(jtr), 6.0)
    for name in tlora.LORA_SITES:
        a = np.asarray(jtr["lora"]["blocks"][name]["a"], np.float64)
        b = np.asarray(jtr["lora"]["blocks"][name]["b"], np.float64)
        exact = (np.asarray(jparams["blocks"][name]["kernel"], np.float64)
                 + (6.0 / 3.0) * np.einsum("lir,lro->lio", a, b))
        k = got["blocks"][name]["kernel"].numpy()
        np.testing.assert_allclose(k, exact, rtol=1e-6, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(k, np.asarray(want["blocks"][name]["kernel"]), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 16, (4,)).astype(np.int32))


def test_lora_loss_and_grads_match_jax_and_leave_the_base(batch):
    x, y = batch
    jparams = _tiny_params(seed=5)
    jtr = _jax_trainable(jparams, 2, 6, 8)
    l_ref, g_ref = jax.value_and_grad(jtrain.lora_cross_entropy_loss)(
        jtr, jparams, jnp.asarray(x), jnp.asarray(y), TINY, 4.0)
    base = params_from_jax(jparams)
    tr = params_from_jax(jtr)
    for leaf in ttrain.tree_leaves(tr):
        leaf.requires_grad_(True)
    loss = ttrain.lora_cross_entropy_loss(tr, base, torch.from_numpy(x), torch.from_numpy(y),
                                          PORT_TINY, 4.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(l_ref), rtol=1e-5)
    ref, got = _flat(g_ref), {k: v.grad for k, v in _flat(tr).items()}
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=5e-5, rtol=1e-3,
                                   err_msg=k)
    assert got["lora/blocks/qkv/a"].abs().max() > 0 and got["head/kernel"].abs().max() > 0
    assert all(v.grad is None for k, v in _flat(base).items() if not k.startswith("head/"))


@pytest.mark.parametrize("qat", ["", "q8_0"])
def test_train_step_lora_losses_match_jax(batch, qat):
    x, y = batch
    jparams = _tiny_params(seed=8)
    jtr = _jax_trainable(jparams, 4, 9, 10)
    opt = jtrain.make_optimizer(lr=1e-2)
    jstate = jtrain.TrainState(jax.tree.map(jnp.array, jtr), opt.init(jtr),
                               jnp.zeros((), jnp.int32))
    base = params_from_jax(jparams)
    kernel0 = base["blocks"]["qkv"]["kernel"].clone()
    tstate = ttrain.create_train_state(params_from_jax(jtr), dict(lr=1e-2))
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(3):
        jstate, l_ref = jtrain.train_step_lora(jstate, jparams, xj, yj, TINY, opt, alpha=8.0,
                                               qat=qat)
        loss = ttrain.train_step_lora(tstate, base, xt, yt, PORT_TINY, 8.0, qat=qat)
        # under QAT, updated weights an ulp apart can land a fake-quant code
        # a whole quantum apart: after the first update the losses are held
        # to the JAX package's own bound for that (rel 1e-2, test_qat.py)
        rtol = 1e-2 if qat and losses else 1e-4
        np.testing.assert_allclose(float(loss), float(l_ref), rtol=rtol)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert torch.equal(base["blocks"]["qkv"]["kernel"], kernel0)  # the frozen base


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    from tests.test_torch_finetune import _make_dataset

    d = tmp_path_factory.mktemp("lora")
    base = str(d / "m.gguf")
    write_synthetic_model(base, VitHParams(hidden_size=64, num_hidden_layers=2,
                                           num_attention_heads=2, num_classes=7, patch_size=8,
                                           img_size=32), ftype=1, seed=4)
    return base, _make_dataset(d / "train")


def test_finetune_lora_learns_and_serves_folded(task, tmp_path):
    from vit_cpp_tpu.finetune import finetune as jax_finetune
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.finetune import _preprocess_all, evaluate, finetune, load_dataset
    from vit_cpp_tpu_torch.models.export import save_params

    base, data = task
    params, hp, classes, losses = finetune(base, data, epochs=6, batch=4, lr=1e-2, lora=4,
                                           **QUIET)
    assert losses[-1] < losses[0]
    assert "lora" not in params and params["blocks"]["qkv"]["kernel"].shape == (2, 64, 192)
    paths, labels, _ = load_dataset(data)
    pixels = _preprocess_all(paths, hp, 1, "cpu")
    assert evaluate(params, hp, pixels, labels, batch=4) >= 0.9
    out = str(tmp_path / "ft.gguf")
    save_params(out, params, hp, id2label=dict(enumerate(classes)))
    engine = VitEngine(out, device="cpu")
    assert engine.classify_file(paths[0], topk=1)[0][0] == 0
    # invalid combinations refuse with the JAX package's messages
    for kw, match in ((dict(freeze_backbone=True), "freeze-backbone"),
                      (dict(grad_accum=2), "grad-accum"), (dict(mixup=0.2), "mixup")):
        msgs = []
        for run, extra in ((finetune, QUIET), (jax_finetune, dict(log=lambda m: None))):
            with pytest.raises(ValueError, match=match) as e:
                run(base, data, epochs=1, batch=4, lora=4, **kw, **extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_finetune_lora_resume_is_bit_identical_and_guarded(task, tmp_path):
    from vit_cpp_tpu_torch.finetune import finetune

    base, data = task
    kw = dict(batch=4, lr=1e-2, lora=4, **QUIET)
    full, _, _, losses_full = finetune(base, data, epochs=2, ckpt_dir=str(tmp_path / "a"), **kw)
    finetune(base, data, epochs=1, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed, _, _, losses_resumed = finetune(base, data, epochs=2,
                                             ckpt_dir=str(tmp_path / "b"), **kw)
    assert losses_resumed == losses_full[1:]
    for a, b in zip(ttrain.tree_leaves(full), ttrain.tree_leaves(resumed)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="different settings"):
        finetune(base, data, epochs=3, ckpt_dir=str(tmp_path / "b"), **dict(kw, lora=8))
