"""The port's per-stage debug forward (models/vit.py::forward_debug,
print_t) against the JAX package's, on the CPU.

Both packages load the same synthetic gguf (h=64, 2 layers) in f32 and
run the same numpy-made pixels; every stage (embed, each block, the
pooled readout, logits, probabilities) must agree within STAGE_RTOL of
the stage's largest magnitude: the f32 parity bound of the engines
(tests/test_torch_engine.py, 1e-5; summation order only). For SigLIP's
map-pooled and V-MoE trees the JAX function does not compute its own
forward (it pools x[:, 0] and runs every layer dense: ROADMAP C), so the
port's stages end in the port's `forward` output there, and a test pins
the JAX divergence.
"""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models import vit as jax_vit
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.engine import VitEngine
from vit_cpp_tpu_torch.models import vit

TINY = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=7, patch_size=8, img_size=32)
STAGE_RTOL = 1e-5
FAMILIES = {
    "cls": {},
    "avg-pool": {"global_pool": "avg", "num_prefix_tokens": 0},
    "distilled": {"num_prefix_tokens": 2},
    "vitstr": {"in_chans": 1, "seq_len": 25, "num_classes": 96, "img_size": 48},
    "headless": {"num_classes": 0},
    "siglip": {"num_prefix_tokens": 0, "global_pool": "map", "pixel_norm": "unit"},
    "moe": {"num_experts": 4, "moe_layers": (1,), "moe_top_k": 2, "moe_capacity": 1.25},
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("debug")
    out = {}
    for name, extra in FAMILIES.items():
        out[name] = str(d / f"{name}.gguf")
        write_synthetic_model(out[name], dataclasses.replace(TINY, **extra), ftype=1, seed=7)
    return out


def _engines(path, **kw):
    return (VitEngine(path, device="cpu", verbose=False, **kw),
            JaxVitEngine(path, verbose=False, **kw))


def _pixels(hp, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, hp.in_chans, hp.img_size, hp.img_size)).astype(np.float32)


def _assert_stage(name, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=STAGE_RTOL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("attn", ["xla", "pallas-fast"])
@pytest.mark.parametrize("family", ["cls", "avg-pool", "distilled", "vitstr", "headless"])
def test_stages_match_jax(files, family, attn):
    """Every stage the JAX forward_debug returns, the port's returns, at
    the same keys and within STAGE_RTOL; a headless tree stops at
    "pooled"; the last stage is the engine's output."""
    engine, jax_engine = _engines(files[family], attn_impl=attn)
    x = _pixels(engine.hp)
    with torch.inference_mode():
        got = vit.forward_debug(engine.params, torch.from_numpy(x), engine.hp, attn_impl=attn)
    want = jax_vit.forward_debug(jax_engine.params, jnp.asarray(x), jax_engine.hp,
                                 attn_impl=attn)
    want_keys = ["embed", "block_0", "block_1", "pooled"]
    if family != "headless":
        want_keys += ["logits", "probs"]
    assert list(got) == list(want) == want_keys
    for key in want:
        _assert_stage(key, got[key].numpy(), want[key])
    if family == "headless":
        ref = engine.features_batch(torch.from_numpy(x))
        np.testing.assert_allclose(got["pooled"].numpy(), ref.numpy(), atol=1e-6, rtol=0)
    else:
        ref = engine.predict_probs_batch(torch.from_numpy(x))
        np.testing.assert_allclose(got["probs"].numpy(), ref.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("family", ["siglip", "moe"])
def test_map_pooled_and_moe_trees_end_in_forward(files, family):
    """SigLIP's map-pooled tree and a V-MoE tree: the port's stages end in
    its forward's features and logits (the routed layer runs, the probe
    pools), and those equal the JAX engine's forward. The JAX
    forward_debug does neither: it pools x[:, 0] of a map-pooled tree and
    runs a V-MoE tree's layer 1 through the dense MLP stack, whose second
    layer it reads past the end (clamped to layer 0), so its logits are
    not its own forward's (ROADMAP C, known defects in the reference)."""
    engine, jax_engine = _engines(files[family])
    x = _pixels(engine.hp)
    t = torch.from_numpy(x)
    with torch.inference_mode():
        got = vit.forward_debug(engine.params, t, engine.hp)
        logits = vit.forward(engine.params, t, engine.hp)
        feats = vit.forward(engine.params, t, engine.hp, features=True)
    np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["pooled"].numpy(), feats.numpy(), atol=1e-6, rtol=0)
    jax_logits = np.asarray(jax_vit.forward(jax_engine.params, jnp.asarray(x), jax_engine.hp))
    _assert_stage("logits", logits.numpy(), jax_logits)
    want = jax_vit.forward_debug(jax_engine.params, jnp.asarray(x), jax_engine.hp)
    # the stages before the defect agree: every block of the SigLIP tree,
    # the dense layer before the routed one of the V-MoE tree
    for key in ("embed", "block_0") + (("block_1",) if family == "siglip" else ()):
        _assert_stage(key, got[key].numpy(), want[key])
    assert np.abs(np.asarray(want["logits"]) - jax_logits).max() > 1e-3


def test_print_t_prints_the_jax_line(files):
    """print_t's line, byte for byte, on f32 stages, a bf16 stage and a
    tensor shorter than 2n."""
    engine, _ = _engines(files["cls"])
    with torch.inference_mode():
        acts = vit.forward_debug(engine.params, torch.from_numpy(_pixels(engine.hp)), engine.hp)
    cases = [(k, v) for k, v in acts.items()] + [
        ("bf16", acts["block_1"].to(torch.bfloat16)), ("short", torch.arange(5.0) / 3)]
    for name, t in cases:
        for n in (10, 3):
            ours, theirs = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(ours):
                vit.print_t(name, t, n=n)
            with contextlib.redirect_stdout(theirs):
                jax_vit.print_t(name, t.float().numpy(), n=n)
            assert ours.getvalue() == theirs.getvalue() and ours.getvalue().startswith(name)
