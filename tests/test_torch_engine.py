"""The port's whole slice against the JAX package's: engine, daemon, imports.

Both engines load the same synthetic f16 checkpoint (d=64 heads, the
flagship head width), or its Q8_0 quantization, and classify the same
numpy-made pixel batch. On the CPU the port's kernels run their plain
versions and the JAX package's Pallas kernels run in interpret mode.
"""

import json
import os
import subprocess
import sys
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
from vit_cpp_tpu_torch.cli.common import build_engine
from vit_cpp_tpu_torch.engine import VitEngine
from vit_cpp_tpu_torch.server import create_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGPIE = os.path.join(REPO, "assets", "magpie.jpeg")
HP = VitHParams(
    hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
    num_classes=10, patch_size=8, img_size=32,
)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("engine") / "m.gguf")
    write_synthetic_model(path, HP, ftype=1, seed=0)
    return path


@pytest.fixture(scope="module")
def q8_model(model, tmp_path_factory):
    from vit_cpp_tpu_torch.cli.quantize import quantize_model_file

    path = str(tmp_path_factory.mktemp("engine-q8") / "m-q8_0.gguf")
    assert quantize_model_file(model, path, 8, verbose=False)
    return path


def _assert_engines_agree(path, dtype, mm, attn, fold, atol):
    x = np.random.default_rng(0).standard_normal((6, 3, 32, 32)).astype(np.float32)
    jax_engine = JaxVitEngine(
        path, dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16,
        mm_impl=mm, attn_impl=attn, fold_ln=fold, verbose=False,
    )
    engine = VitEngine(
        path, dtype=dtype, mm_impl=mm, attn_impl=attn, fold_ln=fold,
        device="cpu",
    )
    ref = np.asarray(jax_engine.predict_probs_batch(jnp.asarray(x)))
    got = engine.predict_probs_batch(torch.from_numpy(x)).numpy()
    assert got.shape == (6, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    # top-1 agrees wherever the reference's top-1 margin exceeds twice
    # the tolerance (closer calls are within the stated tolerance anyway)
    top2 = np.sort(ref, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * atol
    assert clear.sum() >= 4
    np.testing.assert_array_equal(got.argmax(1)[clear], ref.argmax(1)[clear])


@pytest.mark.parametrize(
    "dtype,mm,attn,fold,atol",
    [
        # (a) the f32 parity config: summation order only
        ("f32", "xla", "xla", False, 1e-5),
        # (b) the serving config in f32: an int8 activation code can flip
        # where the two packages' f32 sums straddle a rounding boundary
        ("f32", "int8", "pallas-fast", True, 1e-4),
        # (c) the serving config in bf16: the packages round bf16
        # intermediates (GELU, LN outputs) at different places
        ("bf16", "int8", "pallas-fast", True, 2e-2),
    ],
    ids=["parity-f32", "serving-f32", "serving-bf16"],
)
def test_engine_matches_jax(model, dtype, mm, attn, fold, atol):
    _assert_engines_agree(model, dtype, mm, attn, fold, atol)


@pytest.mark.parametrize(
    "dtype,mm,attn,fold,atol",
    [
        # (a) f32, weights dequantized before each matmul: summation order
        ("f32", "xla", "xla", False, 1e-5),
        # (b) f32 through the dequantizing kernel's and the fused
        # attention's plain versions vs the JAX Pallas kernels
        ("f32", "pallas", "pallas-fast", False, 1e-5),
        # (c) bf16 --mm pallas: bf16 intermediates round at other places
        ("bf16", "pallas", "pallas-fast", False, 2e-2),
        # (d) the flagship: W8A8 requantized from Q8_0, LayerNorm folded
        ("bf16", "int8", "pallas-fast", True, 2e-2),
    ],
    ids=["q8-f32-xla", "q8-f32-pallas", "q8-bf16-pallas", "q8-bf16-int8-fold"],
)
def test_engine_matches_jax_on_q8_0(q8_model, dtype, mm, attn, fold, atol):
    _assert_engines_agree(q8_model, dtype, mm, attn, fold, atol)


def test_build_engine_serving_defaults_and_unported_flags(model):
    engine, is_vitstr = build_engine(model, device="cpu")
    assert not is_vitstr
    assert (engine.dtype, engine.mm_impl, engine.attn_impl) == (
        torch.bfloat16, "int8", "pallas-fast"
    )
    assert engine.params["blocks"]["ln1"]["scale"] is None  # fold_ln on
    with pytest.raises(NotImplementedError, match="static"):
        build_engine(model, act="static", device="cpu")
    with pytest.raises(NotImplementedError, match="ToMe"):
        build_engine(model, tome=2, device="cpu")
    with pytest.raises(NotImplementedError, match="model-families"):
        build_engine(model, img_size=64, device="cpu")
    # --mm pallas serves (block-quantized files through the dequantizing
    # kernel) and, as in the JAX tool, leaves fold off
    engine, _ = build_engine(model, mm="pallas", device="cpu")
    assert engine.mm_impl == "pallas"
    assert engine.params["blocks"]["ln1"]["scale"] is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_engine(model)  # --device cuda without a GPU never runs on the CPU


@pytest.mark.parametrize(
    "argv,match",
    [
        (["-m", "cls=MODEL"], "multi-model"),
        (["-m", "MODEL", "--mesh", "2x1"], "multi-device"),
        (["-m", "MODEL", "--act", "static", "--calib-dir", "d"], "static-scale"),
        (["-m", "MODEL", "--compile-cache"], "XLA compile cache"),
        (["-m", "MODEL", "--tome", "4", "--device", "cpu"], "ToMe"),
        (["-m", "MODEL", "--img-size", "64", "--device", "cpu"], "model-families"),
    ],
)
def test_cli_server_unported_flags_raise(model, argv, match):
    from vit_cpp_tpu_torch.cli.server import main

    argv = [a.replace("MODEL", model) for a in argv]
    with pytest.raises(NotImplementedError, match=match):
        main(argv)


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_daemon_classifies_like_the_engine(model):
    engine, _ = build_engine(model, device="cpu")
    httpd, batcher = create_server(engine, port=0, batch=4, max_wait_ms=20.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        with open(MAGPIE, "rb") as f:
            status, body = _post(base + "/v1/classify?topk=3", f.read())
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    assert status == 200
    want = engine.classify_file(MAGPIE, topk=3)
    assert [e["id"] for e in body["topk"]] == [i for i, _, _ in want]
    np.testing.assert_allclose(
        [e["prob"] for e in body["topk"]], [p for _, p, _ in want], atol=1e-6
    )
    assert stats["requests"] == 1 and stats["batches"] == 1


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_status(url, data):
    try:
        return _post(url, data)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_daemon_routes_match_the_jax_daemon(model):
    """The port's own HTTP handler: /healthz, /metrics (the JAX daemon's
    Prometheus text for the same counters), and its 404 / 400 answers."""
    from types import SimpleNamespace

    from vit_cpp_tpu.server import _prometheus_metrics as jax_metrics

    engine, _ = build_engine(model, device="cpu")
    httpd, batcher = create_server(engine, port=0, batch=2, max_wait_ms=5.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        with open(MAGPIE, "rb") as f:
            assert _post(base + "/v1/classify", f.read())[0] == 200
        health = _get(base + "/healthz")
        metrics = _get(base + "/metrics")
        missing_get = _get(base + "/nope")
        missing_post = _post_status(base + "/v1/nope", b"x")
        garbage = _post_status(base + "/v1/classify", b"not an image")
        with open(MAGPIE, "rb") as f:
            bad_query = _post_status(base + "/v1/classify?topk=x", f.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    assert health[0] == 200 and json.loads(health[1]) == {
        "ok": True, "model": "vit", "hidden_size": HP.hidden_size,
        "img_size": HP.img_size, "batch": 2,
    }
    jax_model = SimpleNamespace(name=None, is_vitstr=False, is_headless=False,
                                batcher=batcher, embed_batcher=None)
    assert metrics == (200, jax_metrics([jax_model]).encode())
    assert b'vit_requests_total{model="default",route="classify"} 1' in metrics[1]
    assert missing_get[0] == 404 and missing_post[0] == 404
    assert garbage == (400, {"error": "undecodable image"})
    assert bad_query[0] == 400


def test_daemon_serves_q8_0_with_mm_pallas(q8_model):
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL
    from vit_cpp_tpu_torch.quant.qlinear import QuantLinear

    engine, _ = build_engine(q8_model, mm="pallas", device="cpu")
    assert isinstance(engine.params["blocks"]["fc2"]["kernel"], QuantLinear)
    httpd, batcher = create_server(engine, port=0, batch=2, max_wait_ms=20.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        with open(MAGPIE, "rb") as f:
            status, body = _post(base + "/v1/classify?topk=3", f.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    assert status == 200
    want = engine.classify_file(MAGPIE, topk=3)
    assert [e["id"] for e in body["topk"]] == [i for i, _, _ in want]
    assert KERNEL.launches == 0  # CPU tensors run the plain version


def test_cli_server_serves_and_stops_on_sigterm(model):
    import signal

    proc = subprocess.Popen(
        [sys.executable, "-m", "vit_cpp_tpu_torch.cli.server", "-m", model,
         "--device", "cpu", "--port", "0", "-b", "2"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stderr.readline()  # printed once the port is bound
        assert "vit-server: vit model on http://" in line, line
        base = line.split(" on ")[1].split()[0]
        with open(MAGPIE, "rb") as f:
            status, body = _post(base + "/v1/classify?topk=2", f.read())
        assert status == 200 and len(body["topk"]) == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()


_NO_JAX = r"""
import json, os, sys, tempfile, threading, urllib.request
sys.modules["jax"] = None  # any import of jax now raises ImportError
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.cli.common import build_engine
from vit_cpp_tpu_torch.server import create_server
import vit_cpp_tpu_torch.cli.server

hp = VitHParams(hidden_size=64, num_hidden_layers=1, num_attention_heads=1,
                num_classes=5, patch_size=8, img_size=16)
path = os.path.join(tempfile.mkdtemp(), "m.gguf")
write_synthetic_model(path, hp, ftype=1, seed=0)
engine, _ = build_engine(path, device="cpu")
httpd, batcher = create_server(engine, port=0, batch=2)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
req = urllib.request.Request(
    f"http://127.0.0.1:{httpd.server_port}/v1/classify",
    data=open(sys.argv[1], "rb").read(), method="POST")
with urllib.request.urlopen(req, timeout=60) as r:
    body = json.loads(r.read())
httpd.shutdown(); httpd.server_close(); batcher.close()
assert len(body["topk"]) == 5, body
print("served without jax")
"""


def test_main_path_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, MAGPIE],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "served without jax" in proc.stdout


_NO_JAX_QUANT = r"""
import json, os, sys, tempfile, threading, urllib.request
sys.modules["jax"] = None  # any import of jax now raises ImportError
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.cli import quantize
from vit_cpp_tpu_torch.cli.common import build_engine
from vit_cpp_tpu_torch.cli.server import _parser
from vit_cpp_tpu_torch.server import create_server

hp = VitHParams(hidden_size=64, num_hidden_layers=1, num_attention_heads=1,
                num_classes=5, patch_size=8, img_size=16)
tmp = tempfile.mkdtemp()
f16, q8 = os.path.join(tmp, "m.gguf"), os.path.join(tmp, "m-q8_0.gguf")
write_synthetic_model(f16, hp, ftype=1, seed=0)
assert quantize.main([f16, q8, "8"]) == 0
args = _parser().parse_args(["-m", q8, "--mm", "pallas", "--device", "cpu"])
engine, _ = build_engine(args.model[0], mm=args.mm, device=args.device)
httpd, batcher = create_server(engine, port=0, batch=2)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
req = urllib.request.Request(
    f"http://127.0.0.1:{httpd.server_port}/v1/classify",
    data=open(sys.argv[1], "rb").read(), method="POST")
with urllib.request.urlopen(req, timeout=60) as r:
    body = json.loads(r.read())
httpd.shutdown(); httpd.server_close(); batcher.close()
assert len(body["topk"]) == 5, body
print("quantized, loaded and served without jax")
"""


def test_quantized_path_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_QUANT, MAGPIE],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "quantized, loaded and served without jax" in proc.stdout
