"""The port's batch pipeline (serve.py) and `vit-serve` against the JAX
package's.

Both read the same synthetic checkpoint (h=64, L=2, 10 classes, 32 px)
and the same files: seven numpy-made PNGs and one file no decoder reads,
served in batches of 4, so the tail chunk is padded and a failed decode
sits inside a chunk. The port runs on the CPU (the kernels' plain
versions), the JAX package with its Pallas kernels in interpret mode.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_cpp_tpu import serve as jax_serve
from vit_cpp_tpu.cli import serve as jax_cli_serve
from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch import serve
from vit_cpp_tpu_torch.cli import serve as cli_serve
from vit_cpp_tpu_torch.cli.common import build_engine
from vit_cpp_tpu_torch.engine import VitEngine

TINY = VitHParams(
    hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
    num_classes=10, patch_size=8, img_size=32,
)
F32_TOL = 1e-5
# bf16 serving features (W8A8 int8 linears, fast fused attention) vs the
# JAX package's unfolded engine at the same dtype and paths, relative to
# max|f|, with the port's LayerNorms unfolded and folded (the serving
# default): the two packages round bf16 intermediates at different places
# and an int8 activation code flips where their sums straddle a rounding
# boundary (measured 1.27e-2 unfolded); folding moves the LN affine into
# the weights before their int8 rounding (the JAX package's own f32 W8A8
# engine moves by 2.7e-2 of max|f| when folded; measured 2.08e-2 here).
BF16_FEATURE_TOL = {False: 2e-2, True: 5e-2}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch-serve")
    model = str(d / "m.gguf")
    write_synthetic_model(model, TINY, ftype=1, seed=0,
                          id2label={i: f"class_{i}" for i in range(10)})
    rng = np.random.default_rng(0)
    paths = []
    for i in range(7):
        p = str(d / "imgs" / f"{i}.png")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        h, w = rng.integers(16, 80, 2)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    bad = str(d / "imgs" / "broken.png")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    paths.insert(2, bad)
    return {"model": model, "paths": paths, "dir": str(d / "imgs"), "tmp": d}


@pytest.fixture(scope="module")
def engines(files):
    return (
        VitEngine(files["model"], device="cpu", verbose=False),
        JaxVitEngine(files["model"], verbose=False),
    )


def _record_batches(engine, monkeypatch, name):
    shapes = []
    real = getattr(engine, name)

    def fn(pixels):
        shapes.append(tuple(pixels.shape))
        return real(pixels)

    monkeypatch.setattr(engine, name, fn)
    return shapes


def test_serve_files_matches_jax(files, engines, monkeypatch):
    engine, jax_engine = engines
    shapes = _record_batches(engine, monkeypatch, "predict_probs_batch")
    got = list(serve.serve_files(engine, files["paths"], batch=4, keep_probs=True))
    want = list(jax_serve.serve_files(jax_engine, files["paths"], batch=4, keep_probs=True))
    assert [r.path for r in got] == [r.path for r in want] == files["paths"]
    assert [r.top1 for r in got] == [r.top1 for r in want]
    assert got[2].top1 == -1 and got[2].probs is None  # the failed decode, in place
    for g, w in zip(got, want):
        if w.top1 >= 0:
            np.testing.assert_allclose(g.probs, w.probs, atol=F32_TOL, rtol=0)
            assert abs(g.prob - w.prob) <= F32_TOL
    # two chunks of 4 files; the failed decode and the tail are padded:
    # every forward sees the full batch
    assert shapes == [(4, 3, 32, 32), (4, 3, 32, 32)]


def test_embed_files_matches_jax_in_f32(files, engines, monkeypatch):
    engine, jax_engine = engines
    shapes = _record_batches(engine, monkeypatch, "features_batch")
    got = list(serve.embed_files(engine, files["paths"], batch=4))
    want = list(jax_serve.embed_files(jax_engine, files["paths"], batch=4))
    assert [e.path for e in got] == [e.path for e in want]
    assert got[2].vector is None and want[2].vector is None
    for g, w in zip(got, want):
        if w.vector is not None:
            assert g.vector.dtype == np.float32 and g.vector.shape == (64,)
            np.testing.assert_allclose(g.vector, w.vector, atol=F32_TOL, rtol=0)
    assert shapes == [(4, 3, 32, 32), (4, 3, 32, 32)]


@pytest.mark.parametrize("fold", [True, False])
def test_embed_files_at_the_serving_defaults_vs_unfolded_jax(files, fold):
    engine, _ = build_engine(files["model"], fold_ln=None if fold else False,
                             device="cpu")  # bf16, int8, fold on by default
    assert (engine.params["norm"]["scale"] is None) == fold
    jax_engine = JaxVitEngine(files["model"], dtype=jnp.bfloat16, mm_impl="int8",
                              attn_impl="pallas-fast", fold_ln=False, verbose=False)
    got = [e.vector for e in serve.embed_files(engine, files["paths"], batch=4)]
    want = [e.vector for e in jax_serve.embed_files(jax_engine, files["paths"], batch=4)]
    got = np.stack([v for v in got if v is not None])
    want = np.stack([v for v in want if v is not None])
    assert got.shape == want.shape == (7, 64) and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BF16_FEATURE_TOL[fold], err


def test_preprocess_resizes_each_image_at_its_own_size():
    """A batch of images of many sizes gives each image what it gets
    alone, in input order, and agrees with the JAX package, which pads
    the batch onto its largest image's canvas, up to a u8 step where the
    two sums straddle a half-integer."""
    from vit_cpp_tpu.ops.preprocess import preprocess_batch as jax_preprocess_batch
    from vit_cpp_tpu_torch.ops.preprocess import preprocess_batch

    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, shape, dtype=np.uint8)
              for shape in ((40, 57, 3), (300, 23, 3), (90, 200, 3), (700, 20, 3), (10, 10, 3))]
    images[1].flags.writeable = False  # as np.asarray of a PIL image is
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # torch warns on a read-only array
        got = preprocess_batch(images, 24)
    alone = torch.cat([preprocess_batch([im], 24) for im in images])
    assert torch.equal(got, alone)
    ref = np.asarray(jax_preprocess_batch(images, 24))
    diff = np.abs(got.numpy() - ref)
    assert diff.max() <= 1.0 / 57.0 + 1e-5 and (diff > 1e-5).mean() < 1e-3


def test_producer_exception_reaches_the_consumer(files, engines, monkeypatch):
    engine, _ = engines

    def broken(images):
        raise RuntimeError("preprocess failed")

    monkeypatch.setattr(engine, "preprocess_images", broken)
    with pytest.raises(RuntimeError, match="preprocess failed"):
        list(serve.serve_files(engine, files["paths"], batch=4))
    with pytest.raises(RuntimeError, match="preprocess failed"):
        list(serve.embed_files(engine, files["paths"], batch=4))


def test_closing_the_stream_early_stops_the_producer(files, engines):
    import threading

    engine, _ = engines
    before = set(threading.enumerate())
    # prefetch 1: the producer blocks on the full queue until it is stopped
    it = serve.serve_files(engine, files["paths"] * 4, batch=2, prefetch=1)
    assert next(it).path == files["paths"][0]
    started = set(threading.enumerate()) - before  # the producer and its decode pool
    assert any("producer" in t.name for t in started)
    it.close()
    assert not any(t.is_alive() for t in started)


def test_throughput_counts_the_decoded_images(files, engines, monkeypatch):
    engine, _ = engines
    clock = iter([100.0, 102.0])
    monkeypatch.setattr(serve.time, "perf_counter", lambda: next(clock))
    assert serve.throughput(engine, files["paths"], batch=4) == pytest.approx(7 / 2.0)


def _cli(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("k", [1, 3])
def test_cli_serve_prints_the_jax_tools_lines(files, capsys, k):
    argv = ["-m", files["model"], "-d", files["dir"], "-b", "4", "-k", str(k),
            "--dtype", "f32", "--mm", "xla", "--attn", "xla"]
    rc_j, out_j, err_j = _cli(jax_cli_serve.main, argv, capsys)
    rc_p, out_p, err_p = _cli(cli_serve.main, argv + ["--device", "cpu"], capsys)
    assert rc_p == rc_j == 0
    assert out_p.splitlines() == out_j.splitlines() and len(out_p.splitlines()) == 7
    fails = lambda err: [line for line in err.splitlines() if "<decode failed>" in line]  # noqa: E731
    assert fails(err_p) == fails(err_j) == [f"{files['paths'][2]}\t<decode failed>"]
    summary = err_p.splitlines()[-1]
    assert summary.startswith("serve: 7/8 images in ") and summary.endswith(" images/sec")


@pytest.fixture(scope="module")
def q8_model(files):
    from vit_cpp_tpu_torch.cli.quantize import quantize_model_file

    q8 = str(files["tmp"] / "m-q8_0.gguf")
    assert quantize_model_file(files["model"], q8, 8, verbose=False)
    return q8


# f32 activations through the dequantizing matmul on every linear (the
# port's plain version here, the JAX Pallas kernel in interpret mode):
# the printed top-3 lines equal, the --embed features within F32_TOL.
@pytest.mark.parametrize("mode", ["top3", "embed"])
def test_cli_serve_f32_pallas_matches_jax(files, q8_model, capsys, mode):
    outs = {}
    for name, main, extra in (("jax", jax_cli_serve.main, []),
                              ("port", cli_serve.main, ["--device", "cpu"])):
        out = str(files["tmp"] / f"f32-pallas-{name}.npy")
        flags = ["-k", "3"] if mode == "top3" else ["--embed", out]
        rc, stdout, err = _cli(main, ["-m", q8_model, "-d", files["dir"], "-b", "4",
                                      "--dtype", "f32", "--mm", "pallas", *flags, *extra],
                               capsys)
        assert rc == 0, err
        outs[name] = stdout.splitlines() if mode == "top3" else np.load(out)
    if mode == "top3":
        assert outs["port"] == outs["jax"] and len(outs["port"]) == 7
        assert all(line.count(":") == 3 for line in outs["port"])
    else:
        assert outs["port"].dtype == np.float32 and outs["port"].shape == (7, 64)
        np.testing.assert_allclose(outs["port"], outs["jax"], atol=F32_TOL, rtol=0)


def test_cli_serve_at_its_defaults(files, capsys):
    rc, out, err = _cli(cli_serve.main, ["-m", files["model"], *files["paths"], "-b", "4",
                                         "--device", "cpu"], capsys)
    assert rc == 0
    lines = [line.split("\t") for line in out.splitlines()]
    assert [p for p, _, _ in lines] == [p for p in files["paths"] if "broken" not in p]
    assert all(label.startswith("class_") and 0 <= float(prob) <= 1 for _, label, prob in lines)


def test_cli_serve_embed_writes_the_jax_tools_files(files, capsys):
    outs = {}
    for name, main, extra in (("jax", jax_cli_serve.main, []),
                              ("port", cli_serve.main, ["--device", "cpu"])):
        out = str(files["tmp"] / f"{name}.npy")
        rc, _, err = _cli(main, ["-m", files["model"], "-d", files["dir"], "-b", "4",
                                 "--dtype", "f32", "--mm", "xla", "--attn", "xla",
                                 "--embed", out, *extra], capsys)
        assert rc == 0
        assert "serve: embedded 7/8 images in " in err and f"-> {out} (7 x 64)" in err
        with open(out[:-4] + ".paths.txt") as f:
            outs[name] = (np.load(out), f.read())
    (feats, paths), (jax_feats, jax_paths) = outs["port"], outs["jax"]
    assert paths == jax_paths and paths.splitlines() == [
        p for p in files["paths"] if "broken" not in p]
    assert feats.dtype == np.float32 and feats.shape == (7, 64)
    np.testing.assert_allclose(feats, jax_feats, atol=F32_TOL, rtol=0)


def test_cli_serve_headless_encoder_needs_embed(files, capsys, tmp_path):
    model = str(tmp_path / "encoder.gguf")
    write_synthetic_model(model, VitHParams(**{**TINY.__dict__, "num_classes": 0}),
                          ftype=1, seed=0)
    rc, _, err = _cli(cli_serve.main, ["-m", model, *files["paths"], "--device", "cpu"], capsys)
    assert rc == 1 and "headless encoder" in err
    out = str(tmp_path / "e.npy")
    rc, _, _ = _cli(cli_serve.main, ["-m", model, *files["paths"], "--embed", out,
                                     "--device", "cpu"], capsys)
    assert rc == 0 and np.load(out).shape == (7, 64)


MESH_2X1 = ("--mesh 2x1: requested 2 devices, only 1 available\n--mesh needs one process "
            "per device: python -m torch.distributed.run --nproc-per-node 2 -m "
            "vit_cpp_tpu_torch.cli.serve ...\n")


@pytest.mark.parametrize(
    "flags,match",
    [
        # every flag but --compile-cache serves now: --act static,
        # --calib-dir and --act-scales since the static-scale slice,
        # --img-size and --patch-size since the model-families slice,
        # --tome since the ToMe slice, --mesh since the multi-device one.
        # Without a launcher the world is one rank: --mesh 2x1 exits 1
        # with the JAX tool's message and names the launcher (MESH_2X1),
        # before any other flag is looked at; a 1x1 mesh serves.
        pytest.param(["--act", "static", "--mesh", "2x1"], MESH_2X1,
                     id=r"flags0---act static .* static-scale slice"),
        pytest.param(["--calib-dir", "d", "--mesh", "2x1"], MESH_2X1,
                     id=r"flags1---calib-dir .* static-scale slice"),
        pytest.param(["--act-scales", "s.json", "--img-size", "64", "--mesh", "2x1"],
                     MESH_2X1, id=r"flags2---act-scales .* static-scale slice"),
        pytest.param(["--img-size", "64", "--mesh", "2x1"], MESH_2X1,
                     id=r"flags3---img-size .* model-families slice"),
        pytest.param(["--patch-size", "4", "--mesh", "2x1"], MESH_2X1,
                     id=r"flags4---patch-size .* model-families slice"),
        # the bare --tome case (match None): the flag serves now
        pytest.param(["--tome", "2"], None, id=r"flags5---tome .* ToMe slice"),
        (["--mesh", "2x1"], MESH_2X1),
        (["--compile-cache"], "XLA compile cache"),
        pytest.param(["--mesh", "wat"], "bad --mesh 'wat': want DPxTP, e.g. 4x2\n",
                     id="bad-spec"),
        pytest.param(["--mesh", "3x1", "-b", "4"], "dp=3 must divide --batch 4\n",
                     id="dp-not-dividing-batch"),
        pytest.param(["--mesh", "1x1", "--tome", "2"], None, id="mesh-1x1"),
    ],
)
def test_cli_serve_unported_flags_raise_and_name_their_slice(files, flags, match, capsys):
    """--compile-cache raises (PyTorch has no compile cache); a bad --mesh
    exits 1 with the JAX tool's message, in JAX's order."""
    argv = ["-m", files["model"], *files["paths"], "--device", "cpu", *flags]
    if match is None:
        rc, out, _ = _cli(cli_serve.main, argv, capsys)
        assert rc == 0 and len(out.splitlines()) == 7
        return
    if "--compile-cache" in flags:
        with pytest.raises(NotImplementedError, match=match):
            cli_serve.main(argv)
        return
    rc, _, err = _cli(cli_serve.main, argv, capsys)
    assert rc == 1 and err == match
    if "1 available" not in match:  # the JAX tool's own run prints the same
        from vit_cpp_tpu.cli.serve import main as jax_main

        assert jax_main(argv[:-len(flags) - 2] + flags) == 1
        assert capsys.readouterr().err == match


def test_cli_serve_rejects_a_vitx_artifact(files, capsys, tmp_path):
    """A JAX-made artifact is refused by name; a port-made one of the f32
    parity engine serves the files as the gguf does, at its baked batch."""
    from vit_cpp_tpu.aot import MAGIC
    from vit_cpp_tpu_torch.aot import save_engine

    art = tmp_path / "m.vitx"
    art.write_bytes(MAGIC + b"\x02\0\0\0{}")
    rc, _, err = _cli(cli_serve.main, ["-m", str(art), *files["paths"], "--device", "cpu"],
                      capsys)
    assert rc == 1 and err.startswith(f"serve: {art} is a .vitx artifact of the JAX package")
    port = str(tmp_path / "port.vitx")
    save_engine(VitEngine(files["model"], device="cpu", verbose=False), port, batch=4)
    flags = ["-b", "4", "--dtype", "f32", "--mm", "xla", "--attn", "xla", "--device", "cpu"]
    rc, out, err = _cli(cli_serve.main, ["-m", port, *files["paths"], *flags], capsys)
    rc_g, out_g, _ = _cli(cli_serve.main, ["-m", files["model"], *files["paths"], *flags],
                          capsys)
    assert rc == rc_g == 0 and out == out_g and len(out.splitlines()) == len(files["paths"]) - 1
    assert "serve: AOT artifact (mm=xla, attn=xla, batch 4) — engine flags baked at export" in err


def test_cli_serve_runs_on_the_card_by_default(files):
    if torch.cuda.is_available():  # decided here, not at import
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        cli_serve.main(["-m", files["model"], *files["paths"]])
