"""The port's multi-model daemon against the JAX package's.

Two synthetic checkpoints (h=64, L=2, 32 px; a 5-class and a 7-class
classifier) and a headless encoder, served from one daemon over a real
socket on the CPU: the per-model routes, /healthz, /stats and /metrics
(the JAX daemon's Prometheus text for the same counters), the CLI's
spec errors beside the JAX CLI's, and two engines of different precision
behind one daemon on concurrent threads.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch import engine as engine_mod
from vit_cpp_tpu_torch.cli.common import build_engine
from vit_cpp_tpu_torch.engine import VitEngine
from vit_cpp_tpu_torch.server import create_multi_server, create_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")


def _hp(classes):
    return VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                      num_classes=classes, patch_size=8, img_size=32)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("multi")
    out = {}
    for name, classes, seed in (("a", 5, 1), ("b", 7, 2), ("enc", 0, 3)):
        out[name] = str(d / f"{name}.gguf")
        write_synthetic_model(out[name], _hp(classes), ftype=1, seed=seed)
    return out


def _png(seed, size=(40, 30)):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _request(url, data=None):
    """(status, body bytes) of a GET, or of a POST when data is given."""
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _Daemon:
    """create_multi_server on a free port, served on a thread."""

    def __init__(self, engines, **kw):
        self.httpd, self.batchers = create_multi_server(engines, port=0, **kw)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        for b in self.batchers.values():
            b.close()


def _classify(engine, png, topk):
    img = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
    probs = engine.predict_probs_batch(engine.preprocess_image(img)[None])[0].numpy()
    order = np.argsort(-probs, kind="stable")[:topk]
    return [int(i) for i in order], probs[order]


def test_multi_model_routes_health_stats_and_metrics(models):
    from vit_cpp_tpu.server import _prometheus_metrics as jax_metrics

    engines = {"a": VitEngine(models["a"], device="cpu", verbose=False),
               "b": build_engine(models["b"], device="cpu")[0]}
    daemon = _Daemon(engines, batch={"a": 3, "b": 2}, max_wait_ms=5.0,
                     buckets={"a": True, "b": False})
    try:
        health = _request(daemon.base + "/healthz")
        results = {}
        for name, seed in (("a", 11), ("b", 12), ("b", 13)):
            png = _png(seed)
            status, body = _request(f"{daemon.base}/v1/{name}/classify?topk=3", png)
            results.setdefault(name, []).append((status, json.loads(body), png))
        embed = _request(daemon.base + "/v1/a/embed", _png(14))
        missing = _request(daemon.base + "/v1/c/classify", _png(11))
        legacy = _request(daemon.base + "/v1/classify", _png(11))
        stats = json.loads(_request(daemon.base + "/stats")[1])
        metrics = _request(daemon.base + "/metrics")
    finally:
        daemon.close()
    assert health[0] == 200 and json.loads(health[1]) == {"ok": True, "models": {
        "a": {"model": "vit", "hidden_size": 64, "img_size": 32, "batch": 3,
              "buckets": [1, 2, 3]},
        "b": {"model": "vit", "hidden_size": 64, "img_size": 32, "batch": 2},
    }}
    for name, rows in results.items():
        for status, body, png in rows:
            ids, probs = _classify(engines[name], png, 3)
            assert status == 200 and [e["id"] for e in body["topk"]] == ids
            np.testing.assert_allclose([e["prob"] for e in body["topk"]], probs, atol=1e-6)
            assert body["topk"][0]["label"] == f"LABEL_{ids[0]}"
    img = np.asarray(Image.open(io.BytesIO(_png(14))).convert("RGB"))
    want = engines["a"].features_batch(engines["a"].preprocess_image(img)[None])[0].numpy()
    body = json.loads(embed[1])
    assert embed[0] == 200 and body["shape"] == [64]
    np.testing.assert_allclose(body["embedding"], want, atol=1e-6)
    for status, raw in (missing, legacy):
        assert status == 404
        error = json.loads(raw)["error"]
        assert "/v1/a/classify" in error and "/v1/b/embed" in error
    assert stats["a"]["requests"] == 1 and stats["b"]["requests"] == 2
    assert stats["a"]["embed"]["requests"] == 1 and stats["b"]["embed"]["requests"] == 0
    ns = [SimpleNamespace(name=n, is_vitstr=False, is_headless=False, batcher=daemon.batchers[n],
                          embed_batcher=daemon.batchers[n].child) for n in ("a", "b")]
    assert metrics == (200, jax_metrics(ns).encode())
    text = metrics[1].decode()
    assert 'vit_requests_total{model="a",route="classify"} 1' in text
    assert 'vit_requests_total{model="b",route="classify"} 2' in text
    assert 'vit_requests_total{model="a",route="embed"} 1' in text


def test_headless_model_in_a_multi_daemon_serves_embed_only(models):
    from vit_cpp_tpu.server import _prometheus_metrics as jax_metrics

    engines = {"cls": VitEngine(models["a"], device="cpu", verbose=False),
               "enc": VitEngine(models["enc"], device="cpu", verbose=False)}
    daemon = _Daemon(engines, batch=2)
    try:
        embed = _request(daemon.base + "/v1/enc/embed", _png(5))
        classify = _request(daemon.base + "/v1/enc/classify", _png(5))
        health = json.loads(_request(daemon.base + "/healthz")[1])
        metrics = _request(daemon.base + "/metrics")[1]
    finally:
        daemon.close()
    assert embed[0] == 200 and json.loads(embed[1])["shape"] == [64]
    assert classify[0] == 404
    assert health["models"]["enc"]["model"] == "vit-encoder"
    ns = [SimpleNamespace(name="cls", is_vitstr=False, is_headless=False,
                          batcher=daemon.batchers["cls"],
                          embed_batcher=daemon.batchers["cls"].child),
          SimpleNamespace(name="enc", is_vitstr=False, is_headless=True,
                          batcher=daemon.batchers["enc"], embed_batcher=None)]
    assert metrics == jax_metrics(ns).encode()


def test_metrics_text_matches_the_jax_daemon_for_the_same_requests(models):
    """Both daemons, the same two models and the same requests: the
    /metrics text is the same, the wall-clock counter aside."""
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
    from vit_cpp_tpu.server import create_multi_server as jax_create

    texts = []
    for make, create in ((lambda p: VitEngine(p, device="cpu", verbose=False), create_multi_server),
                         (lambda p: JaxVitEngine(p, verbose=False), jax_create)):
        httpd, batchers = create({"x": make(models["a"]), "y_z": make(models["b"])},
                                 port=0, batch=2, max_wait_ms=1.0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{httpd.server_port}"
        try:
            for path, seed in (("/v1/x/classify", 1), ("/v1/y_z/classify", 2),
                               ("/v1/y_z/classify", 3), ("/v1/x/embed", 4)):
                assert _request(base + path, _png(seed))[0] == 200
            text = _request(base + "/metrics")[1].decode()
        finally:
            httpd.shutdown()
            httpd.server_close()
            for b in batchers.values():
                b.close()
        texts.append([ln for ln in text.splitlines()
                      if not ln.startswith("vit_predict_seconds_total{")])
    assert texts[0] == texts[1]


@pytest.mark.parametrize("names", [{}, {"": 1}, {"a/b": 1}])
def test_create_multi_server_rejects_bad_names(models, names):
    from vit_cpp_tpu.server import create_multi_server as jax_create

    engine = VitEngine(models["a"], device="cpu", verbose=False)
    engines = {k: engine for k in names}
    messages = []
    for create in (create_multi_server, jax_create):
        with pytest.raises(ValueError) as e:
            create(engines, port=0, warmup=False)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_closing_a_model_batcher_closes_its_embed_batcher(models):
    engine = VitEngine(models["a"], device="cpu", verbose=False)
    httpd, batchers = create_multi_server({"a": engine}, port=0, batch=2, warmup=False)
    httpd.server_close()
    child = batchers["a"].child
    assert child is not None
    batchers["a"].close()
    fut = child.submit(torch.zeros(3, 32, 32))
    with pytest.raises(RuntimeError, match="shutting down"):
        fut.result(timeout=5)


@pytest.mark.parametrize("size", [64 << 10, 4 << 20])
def test_unknown_route_answers_404_after_the_body(models, size):
    """A POST to no route gets its 404 whatever its body's size: the
    daemon reads the body before it answers, so closing the connection
    does not reset it under the answer."""
    engine = VitEngine(models["a"], device="cpu", verbose=False)
    httpd, batcher = create_server(engine, port=0, batch=2)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        answers = [_request(base + "/v1/nope/classify", bytes(size)) for _ in range(5)]
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    for status, raw in answers:
        assert status == 404 and "no route /v1/nope/classify" in json.loads(raw)["error"]


def test_single_model_daemon_keeps_its_routes(models):
    """create_server is unchanged: /v1/classify and /v1/embed, a flat
    /healthz and /stats, the model labelled "default" in /metrics."""
    engine = VitEngine(models["a"], device="cpu", verbose=False)
    httpd, batcher = create_server(engine, port=0, batch=2)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        assert _request(base + "/v1/classify", _png(1))[0] == 200
        assert _request(base + "/v1/a/classify", _png(1))[0] == 404
        health = json.loads(_request(base + "/healthz")[1])
        stats = json.loads(_request(base + "/stats")[1])
        metrics = _request(base + "/metrics")[1].decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    assert health == {"ok": True, "model": "vit", "hidden_size": 64, "img_size": 32, "batch": 2}
    assert stats["requests"] == 1 and "embed" in stats
    assert 'vit_requests_total{model="default",route="classify"} 1' in metrics


# -- two precisions behind one daemon ------------------------------------------


def test_f32_and_bf16_models_keep_their_precision_under_concurrency(models, monkeypatch):
    """An f32 and a bf16 engine behind one daemon, hammered from many
    client threads at once: every f32 forward dispatches with TF32 off and
    every bf16 one with it on (the process-global flags, set per forward
    under one lock), and every answer equals the engine's own answer for
    the same image."""
    seen = []
    real = engine_mod.forward

    def recording(params, images, hp, **kw):
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        time.sleep(0.002)  # widen the window in which another thread could switch them
        out = real(params, images, hp, **kw)
        seen.append((params["cls_token"].dtype, flags))
        return out

    monkeypatch.setattr(engine_mod, "forward", recording)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    engines = {"f32": VitEngine(models["a"], device="cpu", verbose=False),
               "bf16": build_engine(models["a"], device="cpu")[0]}
    daemon = _Daemon(engines, batch=4, max_wait_ms=2.0)
    pngs = [_png(100 + i) for i in range(6)]
    want = {name: [_classify(e, p, 3)[0] for p in pngs] for name, e in engines.items()}
    errors = []

    def client(name, k):
        for i in range(6):
            j = (i + k) % len(pngs)
            status, body = _request(f"{daemon.base}/v1/{name}/classify?topk=3", pngs[j])
            ids = [e["id"] for e in json.loads(body)["topk"]] if status == 200 else None
            if ids != want[name][j]:
                errors.append((name, j, status, ids))

    try:
        threads = [threading.Thread(target=client, args=(name, k))
                   for name in engines for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        daemon.close()
    assert not errors
    assert {dtype for dtype, _ in seen} == {torch.float32, torch.bfloat16}
    for dtype, flags in seen:
        assert flags == ((False, False) if dtype == torch.float32 else (True, True))
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved


# -- the CLI -------------------------------------------------------------------


def _cli(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, err


@pytest.mark.parametrize("case", ["bare-path", "duplicate", "mesh", "unknown-file"])
def test_cli_spec_errors_match_jax(models, capsys, case):
    from vit_cpp_tpu.cli.server import main as jax_main
    from vit_cpp_tpu_torch.cli.server import main

    model = models["a"]
    argv = {
        "bare-path": ["-m", model, "-m", model],
        "duplicate": ["-m", f"a={model}", "-m", f"a={model}", "--no-warmup"],
        "mesh": ["-m", f"a={model}", "-m", f"b={model}", "--mesh", "2x1"],
        "unknown-file": ["-m", f"a={model}", "-m", f"b={model}.missing"],
    }[case]
    if case == "unknown-file":  # neither CLI catches it
        with pytest.raises(FileNotFoundError):
            main(argv + ["--device", "cpu"])
        with pytest.raises(FileNotFoundError):
            jax_main(argv)
        return
    rc_p, err_p = _cli(main, argv + ["--device", "cpu"], capsys)
    rc_j, err_j = _cli(jax_main, argv, capsys)
    assert rc_p == rc_j == 1 and err_p == err_j
    assert {"bare-path": "name=path", "duplicate": "duplicate model name 'a'",
            "mesh": "--mesh is not supported with multiple models"}[case] in err_p


def test_single_model_mesh_still_raises(models, capsys):
    """A single-model --mesh serves since the multi-device slice; without a
    launcher the world is one rank, so --mesh 2x1 exits 1 with the JAX
    tool's message and names the launcher, a bad spec and a dp that does
    not divide --batch with the JAX daemon's own lines."""
    from vit_cpp_tpu.cli.server import main as jax_main
    from vit_cpp_tpu_torch.cli.server import main

    assert main(["-m", models["a"], "--mesh", "2x1", "--device", "cpu"]) == 1
    assert "--mesh 2x1: requested 2 devices, only 1 available" in capsys.readouterr().err
    for flags in (["--mesh", "wat"], ["--mesh", "3x1", "-b", "4"]):
        rc_p, err_p = _cli(main, ["-m", models["a"], *flags, "--device", "cpu",
                                  "--no-warmup"], capsys)
        rc_j, err_j = _cli(jax_main, ["-m", models["a"], *flags, "--no-warmup"], capsys)
        assert rc_p == rc_j == 1 and err_p.splitlines()[-1] == err_j.splitlines()[-1]


class _FakeHttpd:
    server_port = 0

    def serve_forever(self):
        raise KeyboardInterrupt  # leave main's serve loop at once

    def server_close(self):
        pass


def test_cli_calibrates_each_model_and_reports_rejections(models, monkeypatch, capsys):
    """-m a=... -m b=... --act static --calib-dir DIR: each model is
    calibrated in turn (here b's guardrail is made to reject), the
    engines reach create_multi_server with their own scales."""
    from vit_cpp_tpu_torch import server as server_mod
    from vit_cpp_tpu_torch.cli import common
    from vit_cpp_tpu_torch.cli.server import main
    from vit_cpp_tpu_torch.quant.int8 import params_have_static_scales

    captured, calls = {}, []
    real = common.calibrate_engine_from_paths

    def calibrate(engine, calib, n=16):
        calls.append(calib)
        if len(calls) == 2:
            engine._needs_calibration = False  # as after a rejection
            return False
        return real(engine, calib, n)

    def create(engines, **kw):
        captured.update(engines=engines, **kw)
        return _FakeHttpd(), {}

    monkeypatch.setattr(common, "calibrate_engine_from_paths", calibrate)
    monkeypatch.setattr(server_mod, "create_multi_server", create)
    rc = main(["-m", f"a={models['a']}", "-m", f"b={models['b']}", "--act", "static",
               "--calib-dir", ASSETS, "--device", "cpu", "-b", "3", "--bucket"])
    err = capsys.readouterr().err
    assert rc == 0 and calls == [ASSETS, ASSETS]
    assert "vit-server: b: static calibration rejected by the guardrail; serving dynamic" in err
    assert "vit-server: 2 models on http://127.0.0.1:0 (a, b)" in err
    engines = captured["engines"]
    assert params_have_static_scales(engines["a"].params)
    assert not params_have_static_scales(engines["b"].params)
    # per-model maps, as the JAX daemon passes them (a .vitx model takes
    # its baked batch and sizes there)
    assert (captured["batch"], captured["buckets"]) == ({"a": 3, "b": 3}, {"a": True, "b": True})


def test_cli_single_model_static_calibrates_before_serving(models, monkeypatch, capsys):
    from vit_cpp_tpu_torch import server as server_mod
    from vit_cpp_tpu_torch.cli.server import main
    from vit_cpp_tpu_torch.quant.int8 import params_have_static_scales

    captured = {}

    def create(engine, **kw):
        captured["engine"] = engine
        batcher = SimpleNamespace(close=lambda: None)
        return _FakeHttpd(), batcher

    monkeypatch.setattr(server_mod, "create_server", create)
    assert main(["-m", models["a"], "--act", "static", "--calib-dir", ASSETS,
                 "--device", "cpu"]) == 0
    assert params_have_static_scales(captured["engine"].params)
    assert "vit-server: vit model on" in capsys.readouterr().err


def test_cli_multi_model_daemon_serves_and_stops_on_sigterm(models):
    proc = subprocess.Popen(
        [sys.executable, "-m", "vit_cpp_tpu_torch.cli.server", "-m", f"a={models['a']}",
         "-m", f"b={models['b']}", "--act", "static", "--calib-dir", ASSETS,
         "--device", "cpu", "--port", "0", "-b", "2"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stderr.readline()  # printed once the port is bound
        assert "vit-server: 2 models on http://" in line and "(a, b)" in line, line
        base = line.split(" on ")[1].split()[0]
        with open(os.path.join(ASSETS, "magpie.jpeg"), "rb") as f:
            body = f.read()
        for name, classes in (("a", 5), ("b", 7)):
            status, raw = _request(f"{base}/v1/{name}/classify?topk=9", body)
            assert status == 200 and len(json.loads(raw)["topk"]) == classes
        stats = json.loads(_request(base + "/stats")[1])
        assert stats["a"]["requests"] == stats["b"]["requests"] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_multi_daemon_on_the_card_launches_the_attention_kernel_per_model(models):
    """Two static-scale models at the serving defaults on the card: 2
    attention_qkv launches per device batch per model (L=2). Calibrated
    on the assets with the guardrail off (min_agreement=0): the random
    2-layer weights have near-tied logits, which the guardrail may reject
    (chip_smoke.py holds the full-depth ViT-B/16 to it)."""
    from vit_cpp_tpu_torch.io.image import IMAGE_EXTS, load_images_rgb_batch
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.quant.int8 import params_have_static_scales

    paths = sorted(os.path.join(ASSETS, f) for f in os.listdir(ASSETS)
                   if os.path.splitext(f)[1] in IMAGE_EXTS)
    engines = {}
    for name in ("a", "b"):
        engines[name] = build_engine(models[name], act="static")[0]
        pixels = engines[name].preprocess_images(load_images_rgb_batch(paths))
        engines[name].calibrate(pixels, min_agreement=0.0)
        assert params_have_static_scales(engines[name].params)
    daemon = _Daemon(engines, batch=2, max_wait_ms=1.0)
    try:
        KERNEL.reset()
        for name in ("a", "b"):
            assert _request(f"{daemon.base}/v1/{name}/classify", _png(1))[0] == 200
        torch.cuda.synchronize()
        stats = json.loads(_request(daemon.base + "/stats")[1])
    finally:
        daemon.close()
    batches = stats["a"]["batches"] + stats["b"]["batches"]
    assert KERNEL.launches == 2 * batches and batches == 2
