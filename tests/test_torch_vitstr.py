"""The port's ViTSTR (scene-text recognition) against the JAX package's.

A synthetic ViTSTR checkpoint (in_chans=1, 25-row sequence head over the
96-token vocabulary; h=64, L=2, 48 px, patch 8, so T=37 tokens) and the
six demo images of assets/vitstr plus numpy-made ones go through both
packages on the CPU: the grayscale conversion (bit-equal), the resize
matrices (equal), the preprocessed batch (1e-6), greedy decoding on the
host and on the device (equal tokens, flags and texts; confidences
1e-6), the f32 engine's (B, 25, 96) probabilities (1e-5), recognize_files,
the `vitstr` CLI (the docs/QUICK_EXAMPLE.md transcript and the JAX CLI's
lines), `vit-serve` and the daemons' /v1/recognize.
"""

import dataclasses
import glob
import io
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models import vitstr as jax_vitstr
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.models import vitstr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = sorted(glob.glob(os.path.join(REPO, "assets", "vitstr", "*")))
HP = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, num_classes=96,
                patch_size=8, img_size=48, in_chans=1, seq_len=25)
PROB_TOL = 1e-5  # f32 on both sides: summation order only
PIXEL_TOL = 1e-6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("vitstr")
    model = str(d / "vitstr.gguf")
    write_synthetic_model(model, HP, ftype=1, seed=7, id2label=jax_vitstr.vitstr_id2label())
    bad = d / "broken.png"
    bad.write_bytes(b"not an image")
    paths = list(DEMOS)
    paths.insert(2, str(bad))
    return {"model": model, "paths": paths, "dir": d}


def _load(path):
    from vit_cpp_tpu_torch.io.image import load_image_rgb

    return load_image_rgb(path)


def _random_images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((40, 120), (64, 64), (200, 90), (7, 300))]


def test_grayscale_conversion_is_bit_equal():
    for img in _random_images() + [_load(p) for p in DEMOS]:
        ours, theirs = vitstr.rgb_to_grayscale(img), jax_vitstr.rgb_to_grayscale(img)
        assert ours.dtype == np.uint8 and np.array_equal(ours, theirs)


@pytest.mark.parametrize("n_in,n_out", [(72, 224), (184, 224), (560, 224), (2, 48), (48, 48),
                                        (300, 7)])
def test_resize_matrices_are_equal(n_in, n_out):
    assert np.array_equal(vitstr.grayscale_bilinear_matrix(n_in, n_out),
                          jax_vitstr.grayscale_bilinear_matrix(n_in, n_out))


def test_preprocessed_batch_matches_the_jax_preprocess():
    """Each image resized at its own size: within 1e-6 of the JAX
    package's single-image preprocess, and of its canvas-padded batch
    within that batch's own agreement with the single path."""
    images = _random_images(1) + [_load(p) for p in DEMOS]
    got = vitstr.preprocess_grayscale_batch(images, 48).numpy()
    assert got.shape == (len(images), 1, 48, 48) and got.dtype == np.float32
    want = np.stack([np.asarray(jax_vitstr.preprocess_grayscale(im, 48)) for im in images])
    np.testing.assert_allclose(got, want, atol=PIXEL_TOL, rtol=0)
    assert got.min() >= -1.0 and got.max() <= 1.0
    canvas = np.asarray(jax_vitstr.preprocess_grayscale_batch(images, 48))
    np.testing.assert_allclose(got, canvas, atol=np.abs(canvas - want).max() + PIXEL_TOL, rtol=0)
    one = vitstr.preprocess_grayscale(images[0], 48).numpy()
    assert one.shape == (1, 48, 48) and np.array_equal(one, got[0])


def _decode_cases():
    rng = np.random.default_rng(3)
    probs = rng.random((4, 25, 96)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    tie = probs[0].copy()
    tie[3, [17, 40]] = tie[3].max() + 0.01  # two maxima at position 3: the first wins
    eos_at_1 = probs[1].copy()
    eos_at_1[1, 1] = 1.0
    eos_at_0 = probs[2].copy()
    eos_at_0[0, 1] = 1.0  # position 0 is never read
    eos_mid = probs[3].copy()
    eos_mid[9, 1] = 1.0
    return {"random": probs[0], "argmax-tie": tie, "eos-at-1": eos_at_1,
            "eos-at-0": eos_at_0, "eos-at-9": eos_mid}


@pytest.mark.parametrize("case", list(_decode_cases()))
def test_greedy_decode_host_and_device_match_jax(case):
    probs = _decode_cases()[case]
    id2label = vitstr.vitstr_id2label()
    text, conf = vitstr.greedy_decode(probs, id2label)
    want_text, want_conf = jax_vitstr.greedy_decode(probs, id2label)
    assert text == want_text
    np.testing.assert_allclose(conf, want_conf, rtol=1e-12)
    toks, valid, dconf = vitstr.greedy_decode_device(torch.from_numpy(probs[None]))
    jt, jv, jc = jax_vitstr.greedy_decode_device(jnp.asarray(probs[None]))
    assert np.array_equal(toks.numpy(), np.asarray(jt)) and np.array_equal(valid.numpy(),
                                                                            np.asarray(jv))
    # XLA flushes f32 subnormals to zero, torch keeps them: a product of
    # 24 probabilities near 1/96 lies below the smallest normal f32
    np.testing.assert_allclose(dconf.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=np.finfo(np.float32).tiny)
    assert vitstr.decode_tokens(toks[0].numpy(), valid[0].numpy(), id2label) == text
    if case == "argmax-tie":
        assert toks[0, 3] == 17 and text[2] == id2label[17]
    if case == "eos-at-1":
        assert text == "" and conf == 1.0 and not valid.any()


def test_argmax_returns_the_first_maximum_like_jnp():
    x = np.array([[0.1, 0.7, 0.7, 0.2], [0.5, 0.5, 0.5, 0.5]], np.float32)
    assert torch.argmax(torch.from_numpy(x), dim=-1).tolist() == np.asarray(
        jnp.argmax(jnp.asarray(x), axis=-1)).tolist() == [1, 0]


def test_detect_hparams_reads_a_one_channel_file_as_vitstr(files):
    from vit_cpp_tpu.engine import detect_hparams as jax_detect
    from vit_cpp_tpu.gguf.reader import read_model as jax_read
    from vit_cpp_tpu_torch.engine import detect_hparams
    from vit_cpp_tpu_torch.gguf.reader import read_model

    hp = detect_hparams(read_model(files["model"]))
    want = jax_detect(jax_read(files["model"]))
    assert (hp.in_chans, hp.seq_len, hp.num_classes) == (1, 25, 96)
    assert (hp.in_chans, hp.seq_len, hp.global_pool) == (want.in_chans, want.seq_len,
                                                         want.global_pool)


def test_vitstr_engine_probabilities_match_jax(files):
    from vit_cpp_tpu.engine import VitstrEngine as JaxVitstrEngine
    from vit_cpp_tpu_torch.engine import VitstrEngine

    engine = VitstrEngine(files["model"], device="cpu", verbose=False)
    jax_engine = JaxVitstrEngine(files["model"], verbose=False)
    images = [_load(p) for p in DEMOS]
    pixels = engine.preprocess_images(images)
    assert pixels.shape == (6, 1, 48, 48)
    got = engine.predict_probs_batch(pixels).numpy()
    want = np.asarray(jax_engine.predict_probs_batch(jnp.asarray(pixels.numpy())))
    assert got.shape == want.shape == (6, 25, 96)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    feats = engine.features_batch(pixels).numpy()
    np.testing.assert_allclose(feats, np.asarray(jax_engine.features_batch(
        jnp.asarray(pixels.numpy()))), atol=PROB_TOL, rtol=0)
    assert feats.shape == (6, 25, 64)
    for path in DEMOS:
        assert engine.recognize_file(path, verbose=False)[0] == \
            jax_engine.recognize_file(path, verbose=False)[0]


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-4), ("bf16", 2e-2)],
                         ids=["serving-f32", "serving-bf16"])
def test_vitstr_serving_engine_matches_jax(files, dtype, atol):
    """The serving configuration (W8A8, fused attention, the final norm
    folded into the sequence head) against the JAX package's, at
    test_torch_engine.py's tolerances for that configuration: the port
    reproduces the reference's W8A8 design over all 25 positions, so
    their distance from an f32 engine is that design's."""
    from vit_cpp_tpu.engine import VitstrEngine as JaxVitstrEngine
    from vit_cpp_tpu_torch.engine import VitstrEngine

    kw = dict(mm_impl="int8", attn_impl="pallas-fast", fold_ln=True)
    engine = VitstrEngine(files["model"], dtype=dtype, device="cpu", verbose=False, **kw)
    jax_engine = JaxVitstrEngine(files["model"], verbose=False,
                                 dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16, **kw)
    pixels = engine.preprocess_images([_load(p) for p in DEMOS])
    got = engine.predict_probs_batch(pixels).float().numpy()
    want = np.asarray(jax_engine.predict_probs_batch(jnp.asarray(pixels.numpy())), np.float32)
    assert got.shape == want.shape == (6, 25, 96) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_classify_file_refuses_a_sequence_head(files):
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine, VitstrEngine

    with pytest.raises(ValueError, match="VitstrEngine"):
        VitEngine(files["model"], device="cpu", verbose=False).classify_file(DEMOS[0])
    engine, is_vitstr = build_engine(files["model"], device="cpu")
    assert is_vitstr and isinstance(engine, VitstrEngine)
    assert (engine.dtype, engine.mm_impl, engine.attn_impl) == (torch.bfloat16, "int8",
                                                                "pallas-fast")
    assert engine.params["norm"]["scale"] is None  # the final norm folds into the head
    with pytest.raises(ValueError, match="ViTSTR"):
        build_engine(files["model"], img_size=64, device="cpu")


@pytest.mark.parametrize("serving", [False, True], ids=["f32", "serving-defaults"])
def test_recognize_files_matches_jax(files, serving):
    """The texts of recognize_files equal the JAX package's (f32 engines),
    and a failed decode yields '' / -1.0. At the serving defaults (bf16,
    W8A8, fused attention, fold) the port recognizes each image as its own
    engine does one at a time."""
    from vit_cpp_tpu.engine import VitstrEngine as JaxVitstrEngine
    from vit_cpp_tpu.serve import recognize_files as jax_recognize
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitstrEngine
    from vit_cpp_tpu_torch.serve import recognize_files

    if serving:
        engine, _ = build_engine(files["model"], device="cpu")
    else:
        engine = VitstrEngine(files["model"], device="cpu", verbose=False)
    got = list(recognize_files(engine, files["paths"], batch=4, decode_threads=2))
    assert [r.path for r in got] == files["paths"]
    assert (got[2].text, got[2].confidence) == ("", -1.0)
    if serving:
        for r in got:
            if r.confidence >= 0:
                text, conf = engine.recognize_file(r.path, verbose=False)
                assert r.text == text
                np.testing.assert_allclose(r.confidence, conf, rtol=1e-4)
        return
    want = list(jax_recognize(JaxVitstrEngine(files["model"], verbose=False),
                              files["paths"], batch=4))
    assert [r.text for r in got] == [r.text for r in want]
    np.testing.assert_allclose([r.confidence for r in got], [r.confidence for r in want],
                               rtol=1e-4, atol=0)


def _run_main(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


def test_vitstr_cli_prints_the_jax_clis_lines(files, capsys):
    from vit_cpp_tpu.cli import vitstr as jax_cli
    from vit_cpp_tpu_torch.cli import vitstr as port_cli

    argv = ["vitstr", "-m", files["model"], "-i", DEMOS[0], "-s", "5"]
    rc_j, out_j, err_j = _run_main(jax_cli.main, argv, capsys)
    rc_p, out_p, err_p = _run_main(port_cli.main, argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_p == 0, err_p
    assert out_p.splitlines() == out_j.splitlines()
    assert out_p.splitlines()[-4] == "------------------ "
    assert out_p.splitlines()[-2].startswith("score : ")
    surface = [line.split("=")[0].rstrip() for line in err_p.splitlines()]
    assert surface == [line.split("=")[0].rstrip() for line in err_j.splitlines()]
    assert "main: seed = 5" in err_p


@pytest.mark.parametrize("case", ["missing-model", "missing-image", "vitx"])
def test_vitstr_cli_failures_exit_1(files, capsys, tmp_path, case):
    from vit_cpp_tpu.aot import MAGIC
    from vit_cpp_tpu_torch.cli import vitstr as port_cli

    art = tmp_path / "m.vitx"
    art.write_bytes(MAGIC + b"\x02\0\0\0{}")
    model, image = {
        "missing-model": (str(tmp_path / "none.gguf"), DEMOS[0]),
        "missing-image": (files["model"], str(tmp_path / "none.png")),
        "vitx": (str(art), DEMOS[0]),
    }[case]
    rc, _, err = _run_main(port_cli.main, ["vitstr", "-m", model, "-i", image, "--device", "cpu"],
                           capsys)
    assert rc == 1
    what = "image" if case == "missing-image" else "model"
    assert f"main: failed to load {what} from" in err
    if case == "vitx":
        assert "is a .vitx artifact" in err


def test_quick_example_vitstr_transcript_from_the_ports_own_writer(tmp_path):
    """The ViTSTR stdout block of docs/QUICK_EXAMPLE.md, line for line,
    from `python -m vit_cpp_tpu_torch.cli.vitstr` on the port's own
    quick-example ViTSTR checkpoint."""
    from vit_cpp_tpu_torch.testing.synthetic import write_quick_example_vitstr_model

    doc = open(os.path.join(REPO, "docs", "QUICK_EXAMPLE.md")).read()
    want = doc.split("```text\n")[3].split("```", 1)[0].rstrip("\n").splitlines()
    model = str(tmp_path / "vitstr-tiny-quick.gguf")
    write_quick_example_vitstr_model(model)
    demo = os.path.join(REPO, "assets", "vitstr", "demo_1.png")
    r = subprocess.run(
        [sys.executable, "-m", "vit_cpp_tpu_torch.cli.vitstr", "-m", model, "-i", demo,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr
    got = (r.stdout.replace(str(tmp_path), "<tmp>").replace(demo, "assets/vitstr/demo_1.png")
           .rstrip("\n").splitlines())
    assert got == want, "\n".join(f"- {w}\n+ {g}" for w, g in zip(want, got) if w != g)
    for line in ("main: seed = ", "main: n_threads = ", "main:    model load time = ",
                 "main:    processing time = ", "main:    total time      = "):
        assert line in r.stderr, line


def test_cli_serve_recognizes_as_the_jax_cli_does(files, capsys):
    from vit_cpp_tpu.cli import serve as jax_serve
    from vit_cpp_tpu_torch.cli import serve as port_serve

    argv = ["-m", files["model"], *files["paths"], "-b", "4", "--dtype", "f32", "--mm", "xla",
            "--attn", "xla"]
    rc_j, out_j, err_j = _run_main(jax_serve.main, argv, capsys)
    rc_p, out_p, err_p = _run_main(port_serve.main, argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_p == 0, err_p
    rows = [line.split("\t") for line in out_p.splitlines()]
    want = [line.split("\t") for line in out_j.splitlines()]
    assert len(rows) == len(DEMOS) and [r[:2] for r in rows] == [w[:2] for w in want]
    assert all(abs(float(r[2]) - float(w[2])) <= 0.01 for r, w in zip(rows, want))
    assert "<decode failed>" in err_p and "serve: 6/7 images" in err_p


class _Daemon:
    def __init__(self, create, engines, **kw):
        self.httpd, self.batchers = create(engines, port=0, max_wait_ms=1.0, **kw)
        if not isinstance(self.batchers, dict):
            self.batchers = {None: self.batchers}
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        for b in self.batchers.values():
            b.close()
        self.thread.join(timeout=30)


def _request(url, data=None):
    req = urllib.request.Request(url, data=data, method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _png(path):
    buf = io.BytesIO()
    Image.open(path).convert("RGB").save(buf, format="PNG")
    return buf.getvalue()


def test_single_model_daemon_serves_v1_recognize(files):
    """POST /v1/recognize returns the JAX daemon's text and confidence on
    the same bytes; /v1/classify is 404; /healthz says vitstr."""
    from vit_cpp_tpu.engine import VitstrEngine as JaxVitstrEngine
    from vit_cpp_tpu.server import create_server as jax_create
    from vit_cpp_tpu_torch.engine import VitstrEngine
    from vit_cpp_tpu_torch.server import create_server

    answers = []
    for create, engine in ((create_server, VitstrEngine(files["model"], device="cpu",
                                                          verbose=False)),
                           (jax_create, JaxVitstrEngine(files["model"], verbose=False))):
        daemon = _Daemon(create, engine, batch=2)
        try:
            got = [_request(daemon.base + "/v1/recognize", _png(p)) for p in DEMOS[:3]]
            other = _request(daemon.base + "/v1/classify", _png(DEMOS[0]))
            health = json.loads(_request(daemon.base + "/healthz")[1])
            embed = _request(daemon.base + "/v1/embed", _png(DEMOS[0]))
        finally:
            daemon.close()
        assert other[0] == 404 and health["model"] == "vitstr" and embed[0] == 200
        assert json.loads(embed[1])["shape"] == [25, 64]
        answers.append([(s, json.loads(b)) for s, b in got])
    for (status, ours), (_, theirs) in zip(*answers):
        assert status == 200 and set(ours) == {"text", "confidence"}
        assert ours["text"] == theirs["text"]
        np.testing.assert_allclose(ours["confidence"], theirs["confidence"], rtol=1e-4)


def test_multi_model_daemon_serves_recognize_beside_classify(files, tmp_path):
    """-m cls=... -m ocr=...: /v1/ocr/recognize beside /v1/cls/classify,
    the recognize route label in /stats and /metrics (the JAX daemon's
    text for the same counters)."""
    from types import SimpleNamespace

    from vit_cpp_tpu.server import _prometheus_metrics as jax_metrics
    from vit_cpp_tpu_torch.engine import VitEngine, VitstrEngine
    from vit_cpp_tpu_torch.server import create_multi_server

    cls_path = str(tmp_path / "cls.gguf")
    write_synthetic_model(cls_path, VitHParams(hidden_size=64, num_hidden_layers=2,
                                               num_attention_heads=2, num_classes=5,
                                               patch_size=8, img_size=32), ftype=1, seed=1)
    ocr = VitstrEngine(files["model"], device="cpu", verbose=False)
    daemon = _Daemon(create_multi_server,
                     {"cls": VitEngine(cls_path, device="cpu", verbose=False), "ocr": ocr},
                     batch=2)
    try:
        text = _request(daemon.base + "/v1/ocr/recognize", _png(DEMOS[1]))
        top = _request(daemon.base + "/v1/cls/classify", _png(DEMOS[1]))
        wrong = _request(daemon.base + "/v1/ocr/classify", _png(DEMOS[1]))
        health = json.loads(_request(daemon.base + "/healthz")[1])
        stats = json.loads(_request(daemon.base + "/stats")[1])
        metrics = _request(daemon.base + "/metrics")[1].decode()
    finally:
        daemon.close()
    assert text[0] == 200 and top[0] == 200 and wrong[0] == 404
    assert "/v1/ocr/recognize" in json.loads(wrong[1])["error"]
    assert json.loads(text[1])["text"] == ocr.recognize_file(DEMOS[1], verbose=False)[0]
    assert [health["models"][n]["model"] for n in ("cls", "ocr")] == ["vit", "vitstr"]
    assert stats["ocr"]["requests"] == stats["cls"]["requests"] == 1
    assert 'vit_requests_total{model="ocr",route="recognize"} 1' in metrics
    ns = [SimpleNamespace(name=n, is_vitstr=n == "ocr", is_headless=False,
                          batcher=daemon.batchers[n], embed_batcher=daemon.batchers[n].child)
          for n in ("cls", "ocr")]
    assert metrics == jax_metrics(ns)


def test_cli_server_banner_names_a_vitstr_model(files, tmp_path):
    """`python -m vit_cpp_tpu_torch.cli.server -m ocr.gguf` says it serves
    a vitstr model and answers /v1/recognize; SIGTERM stops it."""
    import signal

    proc = subprocess.Popen(
        [sys.executable, "-m", "vit_cpp_tpu_torch.cli.server", "-m", files["model"], "--port", "0",
         "--device", "cpu", "--dtype", "f32", "--mm", "xla", "--attn", "xla"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stderr.readline()
        assert line.startswith("vit-server: vitstr model on http://"), line
        base = line.split(" on ")[1].split()[0]
        status, body = _request(base + "/v1/recognize", _png(DEMOS[0]))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
    assert status == 200 and "text" in json.loads(body)


def _q8_head(k, n, seed):
    """A random (n, k) head weight in Q8_0, as the loader holds it."""
    from vit_cpp_tpu.gguf.dtypes import GGMLDType
    from vit_cpp_tpu.gguf.reader import TensorRecord
    from vit_cpp_tpu.quant.blocks import quantize

    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.05).astype(np.float32)
    raw = np.frombuffer(quantize(w, GGMLDType.Q8_0).tobytes(), np.uint8)
    return TensorRecord("head.weight", (n, k), GGMLDType.Q8_0, raw)


def test_sequence_head_dequant_matmul_matches_jax():
    """The ViTSTR head's product in a Q8_0 file, (B, 25, h) @ (h, 96): the
    port's dequant_matmul (its plain version here) within 1e-4 of the JAX
    package's kernel in interpret mode, in f32."""
    from vit_cpp_tpu.ops.pallas_qmatmul import pallas_quant_matmul
    from vit_cpp_tpu.quant.qlinear import _quant_linear_from_record as jax_from_record
    from vit_cpp_tpu_torch.ops.qmatmul import dequant_matmul
    from vit_cpp_tpu_torch.quant.qlinear import quant_linear_from_record

    rec = _q8_head(64, 96, seed=2)
    x = np.random.default_rng(3).standard_normal((2, 25, 64)).astype(np.float32)
    got = dequant_matmul(torch.from_numpy(x), quant_linear_from_record(rec)).numpy()
    want = np.asarray(pallas_quant_matmul(jnp.asarray(x), jax_from_record(rec)))
    assert got.shape == (2, 25, 96)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_sequence_head_dequant_matmul_on_the_card():
    """K4 at ViTSTR-Base's head, M=25*64, K=768, N=96 (one 128-wide tile
    covers 96 columns), Q8_0, bf16: one launch, within 1e-2 of max|plain|
    (one bf16 rounding of sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from vit_cpp_tpu_torch.ops import qmatmul
    from vit_cpp_tpu_torch.quant.qlinear import quant_linear_from_record

    w = quant_linear_from_record(_q8_head(768, 96, seed=4), device="cuda")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 25, 768))
                         .astype(np.float32)).to("cuda", torch.bfloat16)
    before = qmatmul.KERNEL.launches
    got = qmatmul.dequant_matmul(x, w).float()
    ref = qmatmul.dequant_matmul_plain(x, w).float()
    assert qmatmul.KERNEL.launches == before + 1 and got.shape == (64, 25, 96)
    torch.testing.assert_close(got, ref, atol=1e-2 * ref.abs().max().item(), rtol=0)


def test_vitstr_cli_runs_on_the_card_by_default(files):
    from vit_cpp_tpu_torch.cli import vitstr as port_cli

    if torch.cuda.is_available():  # decided here, not at import
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main(["vitstr", "-m", files["model"], "-i", DEMOS[0]])


# ---- training (vit-finetune on a sequence-head checkpoint) ----


def _words(root, n_per=6):
    from tests.test_finetune import _make_vitstr_dataset

    return _make_vitstr_dataset(root, n_per=n_per)


def test_vitstr_dataset_and_targets_equal_jax(tmp_path):
    from vit_cpp_tpu import finetune as jft
    from vit_cpp_tpu_torch import finetune as tft
    from vit_cpp_tpu_torch.hparams import VitHParams as PortHParams

    d = tmp_path / "ds"
    _words(d, n_per=2)
    (d / "hello_12.png").write_bytes((d / "aa_0.png").read_bytes())
    assert tft.load_vitstr_dataset(str(d)) == jft.load_vitstr_dataset(str(d))
    paths, texts = tft.load_vitstr_dataset(str(d))
    assert "hello" in texts and "aa" in texts
    np.testing.assert_array_equal(tft.encode_texts(texts + ["a$B~"], 25),
                                  jft.encode_texts(texts + ["a$B~"], 25))
    # the grayscale training pixels are the JAX package's
    port_hp = PortHParams(**{f.name: getattr(HP, f.name) for f in dataclasses.fields(HP)})
    np.testing.assert_allclose(tft._preprocess_chunk(paths, port_hp, 1, "cpu").numpy(),
                               jft._preprocess_chunk(paths, HP, 1), atol=PIXEL_TOL)
    (d / "gt.txt").write_text("aa_0.png\thello\nbb_0.png\tworld\n")
    assert tft.load_vitstr_dataset(str(d)) == jft.load_vitstr_dataset(str(d))
    for bad, match in ((["é"], "not in the vocab"), (["x" * 24], "chars > seq_len")):
        with pytest.raises(ValueError, match=match):
            tft.encode_texts(bad, 25)
    (d / "gt.txt").write_text("missing-tab-line\n")
    with pytest.raises(ValueError, match="path<TAB>text"):
        tft.load_vitstr_dataset(str(d))


def _seq_batch(seed=0, n=3):
    from vit_cpp_tpu.finetune import encode_texts

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 1, 48, 48)).astype(np.float32)
    return x, encode_texts(["ab", "hello", "x"][:n], 25)


def _seq_params(seed=7):
    from vit_cpp_tpu.models import params_from_state_dict
    from vit_cpp_tpu.testing.synthetic import random_state_dict

    return params_from_state_dict(random_state_dict(HP, seed=seed), HP)


def _port_hp():
    from vit_cpp_tpu_torch.hparams import VitHParams as PortHParams

    return PortHParams(**{f.name: getattr(HP, f.name) for f in dataclasses.fields(HP)})


@pytest.mark.parametrize("qat", ["", "q8_0"])
def test_vitstr_loss_and_grads_match_jax(qat):
    """The masked sequence loss and its gradients (test_torch_train.py's
    bounds: loss rtol 1e-5, gradients atol 5e-5 / rtol 1e-3)."""
    import jax

    from vit_cpp_tpu.parallel import train as jtrain
    from vit_cpp_tpu_torch.models.params import params_from_jax
    from vit_cpp_tpu_torch.parallel import train as ttrain

    jparams = _seq_params()
    x, t = _seq_batch()
    l_ref, g_ref = jax.value_and_grad(jtrain.vitstr_cross_entropy_loss)(
        jparams, jnp.asarray(x), jnp.asarray(t), HP, qat)
    params = params_from_jax(jparams)
    for leaf in ttrain.tree_leaves(params):
        leaf.requires_grad_(True)
    loss = ttrain.vitstr_cross_entropy_loss(params, torch.from_numpy(x), torch.from_numpy(t),
                                            _port_hp(), qat)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(l_ref), rtol=1e-5)
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda p: p.grad, params))}
    ref = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(g_ref)}
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=5e-5, rtol=1e-3,
                                   err_msg=k)


def test_vitstr_lora_loss_matches_jax():
    from vit_cpp_tpu.models.lora import lora_trainable
    from vit_cpp_tpu.parallel import train as jtrain
    from vit_cpp_tpu_torch.models.params import params_from_jax
    from vit_cpp_tpu_torch.parallel import train as ttrain

    jparams = _seq_params(8)
    jtr = lora_trainable(jparams, 4, 1)
    x, t = _seq_batch(1)
    want = float(jtrain.lora_cross_entropy_loss(jtr, jparams, jnp.asarray(x), jnp.asarray(t), HP,
                                                8.0, seq=True))
    got = ttrain.lora_cross_entropy_loss(params_from_jax(jtr), params_from_jax(jparams),
                                         torch.from_numpy(x), torch.from_numpy(t), _port_hp(),
                                         8.0, seq=True)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_vitstr_accum_weighs_micro_batches_by_their_targets():
    """Micro-batches of 1 and 2 words: the accumulated update's loss and
    gradients are the whole batch's masked mean (the JAX package's token
    weighting), not the mean of the micro-batch means."""
    from vit_cpp_tpu_torch.models.params import params_from_jax
    from vit_cpp_tpu_torch.parallel import train as ttrain

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 1, 48, 48)).astype(np.float32))
    from vit_cpp_tpu.finetune import encode_texts

    t = torch.from_numpy(encode_texts(["a", "longerword"], 25))
    big = ttrain.create_train_state(params_from_jax(_seq_params(9)))
    acc = ttrain.create_train_state(params_from_jax(_seq_params(9)))
    l_big = ttrain.update(big, ttrain.vitstr_cross_entropy_loss(big.params, x, t, _port_hp()))
    l_acc = ttrain.train_step_accum(acc, x, t, _port_hp(), 2, seq=True)
    np.testing.assert_allclose(float(l_acc), float(l_big), rtol=1e-6)
    for a, b in zip(ttrain.tree_leaves(acc.params), ttrain.tree_leaves(big.params)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6, rtol=1e-5)


def test_vitstr_finetune_learns_and_serves(files, tmp_path):
    """Scene-text fine-tuning on file-stem labels: the loss falls, the
    position-1 character is learned for every word, validation reports a
    word accuracy, and the export recognizes through VitstrEngine; the
    classifier-only options refuse with the JAX package's messages."""
    from vit_cpp_tpu.finetune import finetune as jax_finetune
    from vit_cpp_tpu_torch.engine import VitstrEngine
    from vit_cpp_tpu_torch.finetune import _preprocess_all, finetune, load_vitstr_dataset
    from vit_cpp_tpu_torch.models.export import save_params
    from vit_cpp_tpu_torch.models.vit import forward

    data = _words(tmp_path / "words")
    logs = []
    params, hp, classes, losses = finetune(files["model"], data, epochs=8, batch=4, lr=5e-3,
                                           val_dir=data, log=logs.append, device="cpu")
    assert hp.seq_len == 25 and len(classes) == 96 and losses[-1] < 1.2 < losses[0]
    assert any("val word-acc" in m for m in logs)
    paths, texts = load_vitstr_dataset(data)
    with torch.no_grad():
        probs = forward(params, _preprocess_all(paths, hp, 1, "cpu"), hp).softmax(-1)
    for text, pr in zip(texts, probs):
        assert classes[int(pr[1].argmax())] == text[0]
    out = str(tmp_path / "ft.gguf")
    save_params(out, params, hp, id2label=dict(enumerate(classes)))
    text, conf = VitstrEngine(out, device="cpu").recognize_file(paths[0], verbose=False)
    assert text.startswith("a") and 0.0 <= conf <= 1.0
    for kw in (dict(augment="flip"), dict(label_smoothing=0.1), dict(tome=2),
               dict(distill=files["model"])):
        msgs = []
        for run, extra in ((finetune, dict(device="cpu")), (jax_finetune, {})):
            with pytest.raises(ValueError) as e:
                run(files["model"], data, epochs=1, batch=4, log=lambda m: None, **kw, **extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
