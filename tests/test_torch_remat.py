"""Rematerialisation in the port's forward (`forward(remat=)`, the
training losses' TRAIN_REMAT) on the CPU, at tiny sizes.

- Every training loss's gradients under each of the four modes are bit
  for bit those of remat=False: the recompute runs the same operations on
  the same inputs, and autograd's graph is the same.
- Operator dispatch counts (a TorchDispatchMode over forward and
  backward): the fused attention runs L times under False and
  "dots+attn" (its output is saved) and 2L under "dots" and True; under
  "dots" and "dots+attn" no aten.mm is dispatched again (saved), under
  True some are.
- Under no_grad the outputs are bit-equal and the dispatched operations
  the same as without remat.
- The port's gradients under each mode against jax.grad of the JAX
  package's forward under the same mode, on the "xla" and
  "pallas-train" paths (JAX's Pallas kernels in interpret mode), at
  tests/test_torch_train.py's tolerance (atol 5e-5, rtol 1e-3).
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.models import lora as tlora
from vit_cpp_tpu_torch.models.params import params_from_state_dict
from vit_cpp_tpu_torch.models.vit import REMAT_MODES, forward
from vit_cpp_tpu_torch.parallel import train as T
from vit_cpp_tpu_torch.quant.qat import measure_act_scales
from vit_cpp_tpu_torch.testing.synthetic import random_state_dict

HP = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, num_classes=5,
                patch_size=8, img_size=32)
MOE_HP = dataclasses.replace(HP, num_experts=4, moe_layers=(1,), moe_top_k=2)
SEQ_HP = dataclasses.replace(HP, seq_len=5)
MODES = list(REMAT_MODES)
MODE_IDS = [str(m) for m in MODES]
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)


class Dispatches(TorchDispatchMode):
    """Counts each operator (by its packet's name) dispatched inside."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _params(hp, seed=2):
    params = params_from_state_dict(random_state_dict(hp, seed), hp)
    for leaf in T.tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _batch(hp, b=2, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 3, hp.img_size, hp.img_size))
                         .astype(np.float32))
    return x, torch.from_numpy(rng.integers(0, hp.num_classes, (b,)))


def _dense():
    params, (x, y) = _params(HP), _batch(HP)
    return params, lambda: T.cross_entropy_loss(params, x, y, HP, smooth=0.1)


def _tome():
    params, (x, y) = _params(HP), _batch(HP)
    return params, lambda: T.cross_entropy_loss(params, x, y, HP, tome=3)


def _moe():
    params, (x, y) = _params(MOE_HP, seed=6), _batch(MOE_HP)
    return params, lambda: T.cross_entropy_loss(params, x, y, MOE_HP)


def _qat_dynamic():
    params, (x, y) = _params(HP), _batch(HP)
    return params, lambda: T.cross_entropy_loss(params, x, y, HP, qat="w8a8")


def _qat_static():
    params, (x, y) = _params(HP), _batch(HP)
    scales = measure_act_scales(params, x, HP, "q8_0")
    return params, lambda: T.cross_entropy_loss(params, x, y, HP, qat="q8_0",
                                                qat_scales=scales)


def _vitstr():
    params, (x, _) = _params(SEQ_HP), _batch(SEQ_HP)
    rng = np.random.default_rng(3)
    targets = rng.integers(2, SEQ_HP.num_classes, (2, 5))
    targets[:, 0] = -1
    targets[1, 3:] = -1
    targets = torch.from_numpy(targets)
    return params, lambda: T.vitstr_cross_entropy_loss(params, x, targets, SEQ_HP)


def _lora():
    base = params_from_state_dict(random_state_dict(HP, 2), HP)
    trainable = tlora.lora_trainable(base, rank=4, seed=1)
    gen = torch.Generator().manual_seed(9)
    for ab in trainable["lora"]["blocks"].values():  # b nonzero, so that a has a gradient
        ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.1
    for leaf in T.tree_leaves(trainable):
        leaf.requires_grad_(True)
    x, y = _batch(HP)
    return trainable, lambda: T.lora_cross_entropy_loss(trainable, base, x, y, HP, 8.0)


def _mixup():
    params, (x, y) = _params(HP), _batch(HP)
    return params, lambda: T._mixed_cross_entropy_loss(params, x, y, y.flip(0), 0.7, HP)


def _distill():
    params, (x, y) = _params(HP), _batch(HP)
    teacher = params_from_state_dict(random_state_dict(HP, 8), HP)
    return params, lambda: T.distill_cross_entropy_loss(params, teacher, x, y, HP, HP,
                                                        0.5, 2.0, "soft")


LOSSES = {"dense": _dense, "tome": _tome, "moe": _moe, "qat-dynamic": _qat_dynamic,
          "qat-static": _qat_static, "vitstr": _vitstr, "lora": _lora, "mixup": _mixup,
          "distill": _distill}


def _loss_and_grads(build, mode, monkeypatch):
    """One loss and its gradients over the tree `build` makes, with every
    training forward under `mode`; and the operators dispatched."""
    monkeypatch.setattr(T, "TRAIN_REMAT", mode)
    tree, loss_fn = build()
    leaves = T.tree_leaves(tree)
    with Dispatches() as seen:
        loss = loss_fn()
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, seen.counts


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("loss", list(LOSSES))
def test_gradients_are_bit_equal_to_no_remat(monkeypatch, loss, mode):
    ref_loss, ref, _ = _loss_and_grads(LOSSES[loss], False, monkeypatch)
    got_loss, got, _ = _loss_and_grads(LOSSES[loss], mode, monkeypatch)
    assert torch.equal(got_loss, ref_loss)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), f"leaf {i}: max diff {(a - b).abs().max().item()}"
    assert any(g.abs().max() > 0 for g in got)


@pytest.mark.parametrize("loss", ["qat-static", "distill"])
def test_training_losses_run_dots_attn(loss):
    """As the JAX package's losses, the port's run "dots+attn" by default:
    the attention's and the quantize-dequantized inputs' outputs are saved
    (the distillation student's too; its teacher runs the composed
    attention under no_grad)."""
    assert T.TRAIN_REMAT == "dots+attn"
    tree, loss_fn = LOSSES[loss]()
    with Dispatches() as mode:
        torch.autograd.grad(loss_fn(), T.tree_leaves(tree))
    seen, layers = mode.counts, HP.num_hidden_layers
    assert seen["vit_cpp_tpu_torch.attention_qkv"] == layers
    assert seen["vit_cpp_tpu_torch.act_q"] == (4 * layers if loss.startswith("qat") else 0)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("loss", ["dense", "tome", "moe", "qat-dynamic"])
def test_dispatch_counts(monkeypatch, loss, mode):
    """The fused attention runs once per block, twice where its output is
    not saved; no product is dispatched again where products are saved.
    QAT's quantize-dequantized inputs come from the act_q operator only
    under "dots+attn", once per block GEMM."""
    layers = HP.num_hidden_layers
    _, _, ref = _loss_and_grads(LOSSES[loss], False, monkeypatch)
    _, _, got = _loss_and_grads(LOSSES[loss], mode, monkeypatch)
    attn = got["vit_cpp_tpu_torch.attention_qkv"]
    assert ref["vit_cpp_tpu_torch.attention_qkv"] == layers
    assert attn == (layers if mode in (False, "dots+attn") else 2 * layers)
    if mode in (False, "dots", "dots+attn"):
        assert got["aten.mm"] == ref["aten.mm"]
        assert got["aten.addmm"] == ref["aten.addmm"]
    else:
        assert got["aten.mm"] > ref["aten.mm"]
    if mode:
        # the blocks' elementwise chain runs again in every mode
        assert got["aten.native_layer_norm"] + got["aten.add"] > (
            ref["aten.native_layer_norm"] + ref["aten.add"])
    gemms = 4 * layers if loss.startswith("qat") and mode == "dots+attn" else 0
    assert got["vit_cpp_tpu_torch.act_q"] == gemms


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("kw", [dict(attn_impl="pallas-train"), dict(attn_impl="xla", tome=3),
                                dict(attn_impl="pallas", mm_impl="qat")],
                         ids=["pallas-train", "xla-tome", "pallas-qat"])
def test_no_grad_runs_as_without_remat(mode, kw):
    params = _params(HP)
    x, _ = _batch(HP)
    out = {}
    for m in (False, mode):
        with torch.no_grad(), Dispatches() as seen:
            out[m] = (forward(params, x, HP, remat=m, **kw), seen.counts)
    assert torch.equal(out[mode][0], out[False][0])
    assert out[mode][1] == out[False][1]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("attn_impl", ["xla", "pallas-train"])
def test_gradients_match_jax_under_the_same_mode(attn_impl, mode):
    import jax
    import jax.numpy as jnp

    from vit_cpp_tpu.hparams import VitHParams as JaxHParams
    from vit_cpp_tpu.models import params_from_state_dict as jax_params
    from vit_cpp_tpu.models.vit import forward as jax_forward
    from vit_cpp_tpu_torch.models.params import params_from_jax

    jhp = JaxHParams(**dataclasses.asdict(HP))
    jparams = jax_params(random_state_dict(HP, 2), jhp)
    x, y = _batch(HP)

    def jax_loss(p):
        logits = jax_forward(p, jnp.asarray(x.numpy()), jhp, attn_impl=attn_impl, remat=mode)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(y.numpy())[:, None], axis=1).mean()

    ref_loss, ref = jax.value_and_grad(jax_loss)(jparams)
    params = _flat(params_from_jax(jparams))
    for leaf in params.values():
        leaf.requires_grad_(True)
    logits = forward(_tree(params), x, HP, attn_impl=attn_impl, remat=mode)
    loss = -torch.log_softmax(logits.float(), dim=-1).gather(1, y[:, None]).mean()
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    want = _flat(ref)
    assert want.keys() == grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), **GRAD_TOL, err_msg=k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


def _tree(flat):
    out = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out
