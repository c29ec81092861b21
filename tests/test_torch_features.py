"""The port's embeddings (forward(..., features=True), features_batch,
embed_file, /v1/embed) against the JAX package's unfolded engine.

Each family the port loads gets a synthetic checkpoint (h=64, L=2, 32 px):
CLS pooling, avg pooling with registers (prefix and registers excluded
from the mean), DeiT-distilled (the mean of the two normed prefix
tokens) and a headless encoder (num_classes=0). Both engines embed the
same numpy-made pixels, f32, within 1e-5.

The JAX package's LayerNorm folding drops the final norm's scale and
bias (vit_cpp_tpu/models/fold.py:110 sets params["norm"] to None/None
after folding them into the head), so its folded engines embed without
them. The port keeps that affine for the features readout: its folded
engine embeds as its unfolded one does, and these tests pin that.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.engine import VitEngine
from vit_cpp_tpu_torch.server import create_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGPIE = os.path.join(REPO, "assets", "magpie.jpeg")
FAMILIES = {
    "cls": ({}, 10),
    "avg-registers": ({"global_pool": "avg", "num_reg_tokens": 2}, 10),
    "deit-distilled": ({"num_prefix_tokens": 2, "norm_pre": True}, 10),
    "headless": ({}, 0),
}
TOL = 1e-5


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("features")
    out = {}
    for name, (extra, classes) in FAMILIES.items():
        hp = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                        num_classes=classes, patch_size=8, img_size=32, **extra)
        out[name] = str(d / f"{name}.gguf")
        write_synthetic_model(out[name], hp, ftype=1, seed=0)
    return out


PIXELS = np.random.default_rng(0).standard_normal((3, 3, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_features_match_the_jax_unfolded_engine(checkpoints, family):
    jax_engine = JaxVitEngine(checkpoints[family], verbose=False)
    engine = VitEngine(checkpoints[family], device="cpu", verbose=False)
    want = np.asarray(jax_engine.features_batch(jnp.asarray(PIXELS)))
    got = engine.features_batch(torch.from_numpy(PIXELS))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_folded_engine_embeds_as_the_unfolded_one(checkpoints, family):
    """Folded and unfolded f32 engines agree within 1e-5: the port does
    not drop the final norm's affine as vit_cpp_tpu/models/fold.py:110
    does. The JAX package's own folded engine is off by far more on every
    classifier (it keeps the affine of a headless encoder, which has no
    head to fold it into)."""
    x = torch.from_numpy(PIXELS)
    unfolded = VitEngine(checkpoints[family], device="cpu", verbose=False)
    folded = VitEngine(checkpoints[family], fold_ln=True, device="cpu", verbose=False)
    want = unfolded.features_batch(x).numpy()
    np.testing.assert_allclose(folded.features_batch(x).numpy(), want, atol=TOL, rtol=0)
    if FAMILIES[family][1]:
        assert folded.params["norm"]["scale"] is None  # the head did absorb it
        # classification is unchanged by folding in both packages
        np.testing.assert_allclose(folded.predict_probs_batch(x).numpy(),
                                   unfolded.predict_probs_batch(x).numpy(), atol=TOL, rtol=0)
        jax_folded = JaxVitEngine(checkpoints[family], fold_ln=True, verbose=False)
        jax_err = np.abs(np.asarray(jax_folded.features_batch(jnp.asarray(PIXELS))) - want).max()
        assert jax_err > 1e3 * TOL


def test_headless_encoder_classifier_calls_raise_the_jax_error(checkpoints):
    engine = VitEngine(checkpoints["headless"], device="cpu", verbose=False)
    jax_engine = JaxVitEngine(checkpoints["headless"], verbose=False)
    with pytest.raises(ValueError) as ours:
        engine.predict_probs_batch(torch.from_numpy(PIXELS))
    with pytest.raises(ValueError) as theirs:
        jax_engine.predict_probs_batch(jnp.asarray(PIXELS))
    assert str(ours.value) == str(theirs.value)
    assert "headless encoder" in str(ours.value)


@pytest.mark.parametrize("family", ["cls", "headless"])
def test_embed_file_matches_jax(checkpoints, family):
    jax_engine = JaxVitEngine(checkpoints[family], verbose=False)
    engine = VitEngine(checkpoints[family], device="cpu", verbose=False)
    got = engine.embed_file(MAGPIE)
    assert got.dtype == np.float32 and got.shape == (64,)
    np.testing.assert_allclose(got, jax_engine.embed_file(MAGPIE), atol=TOL, rtol=0)


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def _serving(engine, **kw):
    httpd, batcher = create_server(engine, port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, batcher, f"http://127.0.0.1:{httpd.server_port}"


def test_daemon_embed_route_and_its_batcher(checkpoints):
    """A classifier's daemon serves /v1/embed through its own batcher,
    closed with the main one: the folded f32 engine's answer equals
    embed_file on the same bytes, and /stats and /metrics count the
    route as the JAX daemon does."""
    from types import SimpleNamespace

    from vit_cpp_tpu.server import _prometheus_metrics as jax_metrics

    engine = VitEngine(checkpoints["cls"], fold_ln=True, device="cpu", verbose=False)
    httpd, batcher, base = _serving(engine, batch=2, max_wait_ms=5.0)
    try:
        with open(MAGPIE, "rb") as f:
            body = f.read()
        status, out = _post(base + "/v1/embed", body)
        status_c, top = _post(base + "/v1/classify?topk=2", body)
        stats = json.loads(_get(base + "/stats"))
        metrics = _get(base + "/metrics")
        embed_batcher = batcher.child
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    assert (status, status_c) == (200, 200) and len(top["topk"]) == 2
    assert out["shape"] == [64]
    np.testing.assert_allclose(out["embedding"], engine.embed_file(MAGPIE), atol=TOL, rtol=0)
    unfolded = VitEngine(checkpoints["cls"], device="cpu", verbose=False)
    np.testing.assert_allclose(out["embedding"], unfolded.embed_file(MAGPIE), atol=TOL, rtol=0)
    assert stats["requests"] == 1 and stats["embed"]["requests"] == 1
    assert stats["embed"]["padded_rows"] == 1  # one request in a batch of 2
    jax_model = SimpleNamespace(name=None, is_vitstr=False, is_headless=False,
                                batcher=batcher, embed_batcher=embed_batcher)
    assert metrics == jax_metrics([jax_model]).encode()
    assert b'vit_requests_total{model="default",route="embed"} 1' in metrics
    assert embed_batcher._closed  # closed with the main batcher


def test_headless_daemon_serves_embed_only(checkpoints):
    from types import SimpleNamespace

    from vit_cpp_tpu.server import _prometheus_metrics as jax_metrics

    engine = VitEngine(checkpoints["headless"], device="cpu", verbose=False)
    httpd, batcher, base = _serving(engine, batch=2, max_wait_ms=5.0)
    try:
        with open(MAGPIE, "rb") as f:
            body = f.read()
        status, out = _post(base + "/v1/embed", body)
        missing = _post(base + "/v1/classify", body)
        health = json.loads(_get(base + "/healthz"))
        metrics = _get(base + "/metrics")
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    assert status == 200 and out["shape"] == [64]
    np.testing.assert_allclose(out["embedding"], engine.embed_file(MAGPIE), atol=TOL, rtol=0)
    assert missing == (404, {"error": "no route /v1/classify (use /v1/embed)"})
    assert health == {"ok": True, "model": "vit-encoder", "hidden_size": 64,
                      "img_size": 32, "batch": 2}
    jax_model = SimpleNamespace(name=None, is_vitstr=False, is_headless=True,
                                batcher=batcher, embed_batcher=None)
    assert metrics == jax_metrics([jax_model]).encode()
