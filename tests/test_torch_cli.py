"""The port's `vit` and `vit-inspect` command lines against the JAX package's.

Both CLIs read the same synthetic checkpoint (h=64, L=2, 10 classes,
32 px) and the same numpy-made image. The port runs with --device cpu,
where its kernels are their plain versions; the JAX CLI runs on the CPU.
The stdout lines must be equal, and the engines' probabilities within
1e-5 (summation order only).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_cpp_tpu.cli import inspect as jax_inspect
from vit_cpp_tpu.cli import vit as jax_vit
from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.cli import inspect as port_inspect
from vit_cpp_tpu_torch.cli import vit as port_vit
from vit_cpp_tpu_torch.engine import VitEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGPIE = os.path.join(REPO, "assets", "magpie.jpeg")
TINY = VitHParams(
    hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
    num_classes=10, patch_size=8, img_size=32,
)
PROB_TOL = 1e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from vit_cpp_tpu_torch.cli.quantize import quantize_model_file

    d = tmp_path_factory.mktemp("torch-cli")
    model, q8 = str(d / "model-f16.gguf"), str(d / "model-q8_0.gguf")
    write_synthetic_model(model, TINY, ftype=1, seed=0,
                          id2label={i: f"class_{i}" for i in range(10)})
    assert quantize_model_file(model, q8, 8, verbose=False)
    img = str(d / "img.png")
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(img)
    return {"f16": model, "q8_0": q8, "img": img, "dir": d}


def _run_main(main, argv, capsys):
    """(exit code, stdout, stderr) of an in-process CLI main; a
    sys.exit inside it gives its code."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


def _stderr_surface(err: str):
    """The stderr lines without the run's numbers (seed, threads, times)."""
    return [line.split("=")[0].rstrip() for line in err.splitlines()]


@pytest.mark.parametrize("k", [3, 10])
def test_vit_cli_prints_the_jax_clis_lines(files, capsys, k):
    argv = ["vit", "-m", files["f16"], "-i", files["img"], "-k", str(k), "-s", "7"]
    rc_j, out_j, err_j = _run_main(jax_vit.main, argv, capsys)
    rc_p, out_p, err_p = _run_main(port_vit.main, argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_p == 0, err_p
    assert out_p.splitlines() == out_j.splitlines()
    assert sum(line.startswith(" > ") for line in out_p.splitlines()) == k
    # the same stderr surface: seed, threads, the resampler's scale, timings
    assert _stderr_surface(err_p) == _stderr_surface(err_j)
    assert "main: seed = 7" in err_p and "vit_image_preprocess: scale = " in err_p


def _probs(engine_probs, pixels):
    return np.asarray(engine_probs(pixels))[0]


@pytest.mark.parametrize("eps", [None, 0.5])
def test_vit_engine_probabilities_and_eps_match_jax(files, eps):
    """-e reaches the engine as the JAX engine's eps= does: the two
    engines agree within 1e-5 at the default and at eps=0.5, and eps=0.5
    moves the probabilities by far more than that."""
    from vit_cpp_tpu_torch.io.image import load_image_rgb

    kw = {} if eps is None else {"eps": eps}
    jax_engine = JaxVitEngine(files["f16"], verbose=False, **kw)
    engine = VitEngine(files["f16"], device="cpu", verbose=False, **kw)
    img = load_image_rgb(files["img"])
    pixels = engine.preprocess_image(img)[None]
    got = engine.predict_probs_batch(pixels)[0].numpy()
    want = np.asarray(jax_engine.predict_probs_batch(jnp.asarray(pixels.numpy())))[0]
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
    if eps is not None:
        default = VitEngine(files["f16"], device="cpu", verbose=False)
        moved = np.abs(default.predict_probs_batch(pixels)[0].numpy() - got).max()
        assert moved > 100 * PROB_TOL
        assert engine.hp.eps == jax_engine.hp.eps == eps


def test_vit_cli_eps_flag_matches_jax(files, capsys):
    argv = ["vit", "-m", files["f16"], "-i", files["img"], "-k", "10", "-e", "0.5"]
    rc_j, out_j, _ = _run_main(jax_vit.main, argv, capsys)
    rc_p, out_p, _ = _run_main(port_vit.main, argv + ["--device", "cpu"], capsys)
    _, out_default, _ = _run_main(port_vit.main, argv[:-2] + ["--device", "cpu"], capsys)
    assert rc_j == rc_p == 0
    top = [line for line in out_p.splitlines() if line.startswith(" > ")]
    assert top == [line for line in out_j.splitlines() if line.startswith(" > ")]
    assert top != [line for line in out_default.splitlines() if line.startswith(" > ")]


@pytest.mark.parametrize(
    "case",
    ["unknown-argument", "help", "bad-value", "missing-value", "missing-model",
     "missing-image"],
)
def test_vit_cli_exit_codes_match_jax(files, capsys, case):
    argv, device = {
        "unknown-argument": (["vit", "--bogus"], []),
        "help": (["vit", "-h"], []),
        "bad-value": (["vit", "-k", "many"], []),
        "missing-value": (["vit", "-m"], []),
        "missing-model": (["vit", "-m", "/nonexistent.gguf", "-i", files["img"]],
                          ["--device", "cpu"]),
        "missing-image": (["vit", "-m", files["f16"], "-i", "/nonexistent.png"],
                          ["--device", "cpu"]),
    }[case]
    rc_j, out_j, err_j = _run_main(jax_vit.main, argv, capsys)
    rc_p, out_p, err_p = _run_main(port_vit.main, argv + device, capsys)
    assert rc_p == rc_j == (0 if case in ("unknown-argument", "help") else 1)
    if device:  # the failure line, up to the reader's own wording
        fail = lambda err: [line.split("':")[0] for line in err.splitlines()  # noqa: E731
                            if line.startswith("main: failed")]
        assert fail(err_p) == fail(err_j) and len(fail(err_p)) == 1
    else:  # the JAX usage text, plus the port's one flag
        assert [line for line in err_p.splitlines() if "--device" not in line] == \
            err_j.splitlines()


def test_vit_cli_vitx_and_headless_fail_as_the_jax_cli_does(files, tmp_path, capsys):
    from vit_cpp_tpu.aot import MAGIC

    art = tmp_path / "m.vitx"
    art.write_bytes(MAGIC + b"\x02\0\0\0{}")
    rc, _, err = _run_main(port_vit.main, ["vit", "-m", str(art), "-i", files["img"],
                                           "--device", "cpu"], capsys)
    assert rc == 1
    assert f"main: failed to load model from '{art}':" in err
    assert ".vitx artifact of the JAX package" in err
    # a port-made artifact of the f32 parity engine prints the gguf's lines
    from vit_cpp_tpu_torch.aot import save_engine

    port = str(tmp_path / "port.vitx")
    save_engine(VitEngine(files["f16"], device="cpu", verbose=False), port, batch=[1, 2])
    argv = ["vit", "-m", None, "-i", files["img"], "-k", "3", "--device", "cpu"]
    results = []
    for model in (port, files["f16"]):
        argv[2] = model
        rc, out, _ = _run_main(port_vit.main, argv, capsys)
        results.append((rc, [line for line in out.splitlines() if line.startswith(" > ")]))
    assert results[0] == results[1] and results[0][0] == 0 and len(results[0][1]) == 3

    headless = str(tmp_path / "encoder.gguf")
    write_synthetic_model(headless, VitHParams(**{**TINY.__dict__, "num_classes": 0}),
                          ftype=1, seed=0)
    argv = ["vit", "-m", headless, "-i", files["img"]]
    rc_j, _, err_j = _run_main(jax_vit.main, argv, capsys)
    rc_p, _, err_p = _run_main(port_vit.main, argv + ["--device", "cpu"], capsys)
    assert rc_j == rc_p == 1
    msg = lambda err: [line for line in err.splitlines() if "headless" in line]  # noqa: E731
    assert msg(err_p) == msg(err_j) and len(msg(err_p)) == 1


def test_vit_cli_runs_on_the_card_by_default(files):
    if torch.cuda.is_available():  # decided here, not at import
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        port_vit.main(["vit", "-m", files["f16"], "-i", files["img"]])


def test_quick_example_transcript_from_the_ports_own_writer(tmp_path):
    """The stdout block of docs/QUICK_EXAMPLE.md, line for line, from
    `python -m vit_cpp_tpu_torch.cli.vit` on the port's own quick-example
    checkpoint. The committed top-5 probabilities are 4e-4 or more apart
    (0.00961, 0.00920, 0.00877, 0.00807, 0.00729), far beyond the port's
    f32 error, so the lines are compared as they are."""
    from vit_cpp_tpu_torch.testing.synthetic import write_quick_example_model

    doc = open(os.path.join(REPO, "docs", "QUICK_EXAMPLE.md")).read()
    want = doc.split("```text\n")[1].split("```", 1)[0].rstrip("\n").splitlines()
    model = str(tmp_path / "vit-tiny-quick.gguf")
    write_quick_example_model(model)
    r = subprocess.run(
        [sys.executable, "-m", "vit_cpp_tpu_torch.cli.vit", "-m", model, "-i", MAGPIE,
         "-k", "5", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr
    got = (r.stdout.replace(str(tmp_path), "<tmp>").replace(MAGPIE, "assets/magpie.jpeg")
           .rstrip("\n").splitlines())
    assert got == want, "\n".join(f"- {w}\n+ {g}" for w, g in zip(want, got) if w != g)
    for line in ("main: seed = ", "main: n_threads = ", "vit_image_preprocess: scale = 2.232143",
                 "main:    model load time = ", "main:    processing time = ",
                 "main:    total time      = "):
        assert line in r.stderr, line


def _vitx(path, meta: bytes):
    from vit_cpp_tpu.aot import MAGIC

    with open(path, "wb") as f:
        f.write(MAGIC + len(meta).to_bytes(4, "little") + meta + b"\0" * 64)
    return str(path)


@pytest.mark.parametrize(
    "which,flags",
    [
        ("f16", []), ("f16", ["--json"]), ("f16", ["--json", "--tensors"]),
        ("q8_0", []), ("q8_0", ["--json", "--tensors"]),
        ("vitx", []), ("vitx", ["--json"]),
        ("missing", []), ("bad-vitx", []),
    ],
)
def test_inspect_prints_what_the_jax_tool_prints(files, capsys, which, flags):
    d = files["dir"]
    path = {
        "f16": files["f16"], "q8_0": files["q8_0"], "missing": str(d / "missing.gguf"),
        "vitx": _vitx(d / "m.vitx", json.dumps(
            {"format": 1, "batch": 8, "mm_impl": "int8", "program": "classify"}).encode()),
        "bad-vitx": _vitx(d / "bad.vitx", b"{not json"),
    }[which]
    rc_j, out_j, err_j = _run_main(jax_inspect.main, [path, *flags], capsys)
    rc_p, out_p, err_p = _run_main(port_inspect.main, [path, *flags], capsys)
    assert (rc_p, out_p, err_p) == (rc_j, out_j, err_j)
    assert rc_p == (1 if which in ("missing", "bad-vitx") else 0)
    if "--json" in flags and which != "vitx":
        summary = json.loads(out_p)
        if "--tensors" in flags:
            assert summary["total_bytes"] == sum(t["bytes"] for t in summary["tensors"])


def test_inspect_runs_as_a_module(files):
    r = subprocess.run(
        [sys.executable, "-m", "vit_cpp_tpu_torch.cli.inspect", files["q8_0"], "--json"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout)
    assert summary["hparams"]["hidden_size"] == 64 and "Q8_0" in summary["bytes_by_dtype"]
