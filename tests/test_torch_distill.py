"""The port's knowledge distillation (parallel/train.py::
distill_cross_entropy_loss, finetune(distill=))
against the JAX package's.

Tolerances: the loss to rtol 1e-5 and the student's gradients to atol
5e-5 / rtol 1e-3 (test_torch_train.py's bounds); alpha=0 equals the plain
cross entropy to rtol 1e-6, as in tests/test_distill.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models import params_from_state_dict
from vit_cpp_tpu.parallel import train as jtrain
from vit_cpp_tpu.testing.synthetic import random_state_dict, write_synthetic_model
from vit_cpp_tpu_torch.hparams import VitHParams as PortHParams
from vit_cpp_tpu_torch.models.params import params_from_jax
from vit_cpp_tpu_torch.parallel import train as ttrain

HP16 = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_classes=16,
                  patch_size=8, img_size=32)
PORT_HP16 = PortHParams(**dataclasses.asdict(HP16))
HP = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, num_classes=7,
                patch_size=8, img_size=32)
QUIET = dict(log=lambda m: None, device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def pair():
    student = params_from_state_dict(random_state_dict(HP16, seed=0), HP16)
    teacher = params_from_state_dict(random_state_dict(HP16, seed=1), HP16)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 16, (4,)).astype(np.int32)
    return student, teacher, x, y


@pytest.mark.parametrize("mode,alpha", [("soft", 0.5), ("soft", 1.0), ("hard", 0.7)])
def test_distill_loss_and_grads_match_jax(pair, mode, alpha):
    student, teacher, x, y = pair
    l_ref, g_ref = jax.value_and_grad(jtrain.distill_cross_entropy_loss)(
        student, teacher, jnp.asarray(x), jnp.asarray(y), HP16, HP16, alpha, 3.0, mode, 0.1)
    params = params_from_jax(student)
    for leaf in ttrain.tree_leaves(params):
        leaf.requires_grad_(True)
    t_params = params_from_jax(teacher)
    loss = ttrain.distill_cross_entropy_loss(params, t_params, torch.from_numpy(x),
                                             torch.from_numpy(y), PORT_HP16, PORT_HP16, alpha,
                                             3.0, mode, 0.1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(l_ref), rtol=1e-5)
    ref, got = _flat(g_ref), {k: v.grad for k, v in _flat(params).items()}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=5e-5, rtol=1e-3,
                                   err_msg=k)
    assert all(v.grad is None for v in ttrain.tree_leaves(t_params))  # the frozen teacher


def test_alpha_zero_is_plain_ce(pair):
    student, teacher, x, y = pair
    params, t_params = params_from_jax(student), params_from_jax(teacher)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    plain = float(ttrain.cross_entropy_loss(params, xt, yt, PORT_HP16))
    kd0 = float(ttrain.distill_cross_entropy_loss(params, t_params, xt, yt, PORT_HP16,
                                                  PORT_HP16, 0.0, 3.0, "soft"))
    assert kd0 == pytest.approx(plain, rel=1e-6)
    with pytest.raises(ValueError, match="soft|hard"):
        ttrain.distill_cross_entropy_loss(params, t_params, xt, yt, PORT_HP16, PORT_HP16, 0.5,
                                          1.0, "x")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A teacher fine-tuned by the port on the two-class task, and the
    base checkpoint."""
    from tests.test_torch_finetune import _make_dataset
    from vit_cpp_tpu_torch.finetune import finetune
    from vit_cpp_tpu_torch.models.export import save_params

    d = tmp_path_factory.mktemp("distill")
    base = str(d / "base.gguf")
    write_synthetic_model(base, HP, ftype=1, seed=4)
    data = _make_dataset(d / "train")
    t_params, t_hp, classes, _ = finetune(base, data, epochs=4, batch=4, lr=1e-3, **QUIET)
    teacher = str(d / "teacher.gguf")
    save_params(teacher, t_params, t_hp, id2label=dict(enumerate(classes)))
    return base, teacher, data


@pytest.mark.parametrize("mode", ["soft", "hard"])
def test_pure_kd_student_learns_from_teacher(setup, mode):
    """alpha=1: the distillation channel alone carries the task."""
    from vit_cpp_tpu_torch.finetune import _preprocess_all, evaluate, finetune, load_dataset

    base, teacher, data = setup
    params, hp, _, losses = finetune(base, data, epochs=4, batch=4, lr=1e-3, seed=1,
                                     distill=teacher, distill_alpha=1.0, distill_mode=mode,
                                     **QUIET)
    assert losses[-1] < losses[0]
    paths, labels, _ = load_dataset(data)
    assert evaluate(params, hp, _preprocess_all(paths, hp, 1, "cpu"), labels, batch=4) >= 0.9


def test_distill_validation_and_meta_guard(setup, tmp_path):
    from vit_cpp_tpu.finetune import finetune as jax_finetune
    from vit_cpp_tpu_torch.finetune import finetune

    base, teacher, data = setup
    for kw, match in ((dict(distill=base), "classes"), (dict(mixup=0.2), "mixup"),
                      (dict(lora=4), "lora"), (dict(distill_alpha=1.5), "alpha"),
                      (dict(distill_tau=0.0), "tau"), (dict(distill_mode="x"), "soft|hard"),
                      (dict(grad_accum=2), "grad-accum")):
        kw = {"distill": teacher, **kw}
        msgs = []
        for run, extra in ((finetune, QUIET), (jax_finetune, dict(log=lambda m: None))):
            with pytest.raises(ValueError, match=match) as e:
                run(base, data, epochs=1, batch=4, **kw, **extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    ck = str(tmp_path / "ck")
    finetune(base, data, epochs=1, batch=4, lr=1e-3, distill=teacher, ckpt_dir=ck, **QUIET)
    with pytest.raises(ValueError, match="different settings"):
        finetune(base, data, epochs=2, batch=4, lr=1e-3, distill=teacher, distill_alpha=0.9,
                 ckpt_dir=ck, **QUIET)
