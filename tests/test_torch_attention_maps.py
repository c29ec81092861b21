"""The port's attention maps, rollout and vit-explain against the JAX
package's.

Synthetic checkpoints (h=64, L=3, 4 heads, 32 px, patch 8) of four
families: a CLS classifier, a DeiT-distilled one, a CLS-less avg-pool one
with registers and a SigLIP-style attention-pooled one. On the CPU, with
the same parameter trees and numpy-made inputs: the (B, L, H, T, T)
probabilities and last block output within 1e-5 of the JAX function,
head_logits within 1e-5 of it and of the production forward, the rollout
within 1e-6 on the same probabilities, explain_file's top-k and grid
beside the JAX engine's, and `cli.explain`'s output (the quick-example
transcript and the JAX CLI's lines, the PNG and the .npy). No kernel
runs on this path, in either package.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models import attention_maps as jax_maps
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.engine import VitEngine
from vit_cpp_tpu_torch.models import attention_maps
from vit_cpp_tpu_torch.models.params import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGPIE = os.path.join(REPO, "assets", "magpie.jpeg")
HP = VitHParams(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_classes=10,
                patch_size=8, img_size=32)
FAMILIES = {
    "cls": HP,
    "distilled": dataclasses.replace(HP, num_prefix_tokens=2),
    "avg-registers": dataclasses.replace(HP, num_prefix_tokens=0, global_pool="avg",
                                         num_reg_tokens=2),
    "map": dataclasses.replace(HP, num_prefix_tokens=0, global_pool="map", pixel_norm="unit"),
}
TOL = 1e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    out = {}
    for i, (name, hp) in enumerate(FAMILIES.items()):
        out[name] = str(d / f"{name}.gguf")
        write_synthetic_model(out[name], hp, ftype=1, seed=20 + i)
    out["headless"] = str(d / "headless.gguf")
    write_synthetic_model(out["headless"], dataclasses.replace(HP, num_classes=0), ftype=1,
                          seed=30)
    img = str(d / "x.png")
    Image.fromarray(np.random.default_rng(7).integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(img)
    out["img"] = img
    return out


def _engines(path):
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine

    return VitEngine(path, device="cpu", verbose=False), JaxVitEngine(path, verbose=False)


def _images(n=2, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 3, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_maps_final_and_head_logits_match_jax(files, family):
    from vit_cpp_tpu.models.vit import forward as jax_forward

    ours_engine, jax_engine = _engines(files[family])
    hp = jax_engine.hp
    x = _images()
    probs, final = attention_maps.attention_maps(params_from_jax(jax_engine.params),
                                                 torch.from_numpy(x), hp)
    want_probs, want_final = jax_maps.attention_maps(jax_engine.params, jnp.asarray(x), hp)
    t = hp.n_tokens
    assert probs.shape == (2, 3, 4, t, t) and probs.dtype == torch.float32
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), atol=TOL, rtol=0)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final), atol=TOL, rtol=0)
    logits = attention_maps.head_logits(params_from_jax(jax_engine.params), final, hp).numpy()
    np.testing.assert_allclose(
        logits, np.asarray(jax_maps.head_logits(jax_engine.params, want_final, hp)),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(
        logits, np.asarray(jax_forward(jax_engine.params, jnp.asarray(x), hp)), atol=TOL, rtol=0)
    assert np.array_equal(ours_engine.attention_maps_batch(torch.from_numpy(x)), probs.numpy())


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("fuse", ["mean", "max", "min"])
def test_rollout_matches_jax(family, fuse):
    hp = FAMILIES[family]
    t = hp.n_tokens
    raw = np.random.default_rng(t).random((2, 3, 4, t, t)).astype(np.float32)
    probs = raw / raw.sum(-1, keepdims=True)
    got = attention_maps.attention_rollout(probs, hp, head_fuse=fuse)
    assert got.shape == (2, 4, 4) and got.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(got, jax_maps.attention_rollout(probs, hp, head_fuse=fuse),
                               atol=1e-6, rtol=0)


def test_rollout_rejects_an_unknown_fusion():
    probs = np.full((1, 1, 1, 17, 17), 1 / 17, np.float32)
    with pytest.raises(ValueError, match="head_fuse"):
        attention_maps.attention_rollout(probs, HP, head_fuse="sum")


@pytest.mark.parametrize("family", ["cls", "map", "headless"])
def test_explain_file_matches_jax(files, family):
    """One pass: the top-5 of explain_file equals classify_file's and the
    JAX engine's (ids, probabilities within 1e-5), the grid is the JAX
    engine's within 1e-5; a headless encoder gives the grid alone."""
    ours, theirs = _engines(files[family])
    top, grid = ours.explain_file(files["img"], topk=5)
    want_top, want_grid = theirs.explain_file(files["img"], topk=5)
    assert grid.shape == (4, 4) and grid.dtype == np.float32
    np.testing.assert_allclose(grid, want_grid, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours.attention_rollout_file(files["img"], head_fuse="max"),
                               theirs.attention_rollout_file(files["img"], head_fuse="max"),
                               atol=TOL, rtol=0)
    if family == "headless":
        assert top == want_top == []
        return
    assert [t[0] for t in top] == [t[0] for t in want_top]
    assert [t[2] for t in top] == [t[2] for t in want_top]
    np.testing.assert_allclose([t[1] for t in top], [t[1] for t in want_top], atol=TOL)
    classified = ours.classify_file(files["img"], topk=5, verbose=False)
    assert [t[0] for t in classified] == [t[0] for t in top]
    np.testing.assert_allclose([t[1] for t in classified], [t[1] for t in top], atol=TOL)


def test_maps_run_on_quantized_and_folded_engines(files):
    """The maps path reads the engine's leaves as they are: W8A8 with the
    norms folded gives the same shape and nearby probabilities."""
    x = torch.from_numpy(_images())
    ref = VitEngine(files["cls"], device="cpu", verbose=False).attention_maps_batch(x)
    w8 = VitEngine(files["cls"], device="cpu", verbose=False, mm_impl="int8",
                   fold_ln=True).attention_maps_batch(x)
    assert ref.shape == w8.shape == (2, 3, 4, 17, 17)
    assert np.abs(ref - w8).max() < 0.2


def _run_main(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("fuse", ["mean", "min"])
def test_cli_explain_writes_what_the_jax_cli_writes(files, tmp_path, capsys, fuse):
    from vit_cpp_tpu.cli.explain import main as jax_main
    from vit_cpp_tpu_torch.cli.explain import main

    outs = {}
    for who, fn, extra in (("jax", jax_main, []), ("port", main, ["--device", "cpu"])):
        png, npy = str(tmp_path / f"{who}.png"), str(tmp_path / f"{who}.npy")
        rc, out, err = _run_main(fn, ["-m", files["cls"], "-i", files["img"], "-o", png,
                                      "--npy", npy, "--fuse", fuse, *extra], capsys)
        assert rc == 0, err
        outs[who] = (out.splitlines(), np.load(npy), np.asarray(Image.open(png)),
                     err.replace(who, "X").splitlines())
    (out, grid, heat, err), (want_out, want_grid, want_heat, want_err) = outs["port"], outs["jax"]
    assert out == want_out and len(out) == 5 and out[0].startswith(" > LABEL_")
    np.testing.assert_allclose(grid, want_grid, atol=TOL, rtol=0)
    assert heat.shape == (32, 32) and np.abs(heat.astype(int) - want_heat).max() <= 1
    assert err == want_err


@pytest.mark.parametrize("case", ["no-output", "vitstr", "headless"])
def test_cli_explain_refusals_match_the_jax_cli(files, tmp_path, capsys, case):
    from vit_cpp_tpu.cli.explain import main as jax_main
    from vit_cpp_tpu.models.vitstr import vitstr_id2label
    from vit_cpp_tpu_torch.cli.explain import main

    model = files["headless"]
    argv = ["-i", files["img"], "--npy", str(tmp_path / "g.npy")]
    if case == "no-output":
        argv = ["-i", files["img"]]
    if case == "vitstr":
        model = str(tmp_path / "vitstr.gguf")
        write_synthetic_model(model, VitHParams(hidden_size=64, num_hidden_layers=1,
                                                num_attention_heads=2, num_classes=96,
                                                patch_size=8, img_size=48, in_chans=1,
                                                seq_len=25), ftype=1, seed=1,
                              id2label=vitstr_id2label())
    rc_j, out_j, err_j = _run_main(jax_main, ["-m", model, *argv], capsys)
    rc_p, out_p, err_p = _run_main(main, ["-m", model, *argv, "--device", "cpu"], capsys)
    assert (rc_p, out_p, err_p) == (rc_j, out_j, err_j)
    assert rc_p == (0 if case == "headless" else 1)


def test_quick_example_explain_transcript_from_the_ports_own_writer(tmp_path):
    """The vit-explain stdout block of docs/QUICK_EXAMPLE.md, line for
    line, and its stderr line, from `python -m
    vit_cpp_tpu_torch.cli.explain` on the port's own quick-example
    checkpoint."""
    from vit_cpp_tpu_torch.testing.synthetic import write_quick_example_model

    fences = open(os.path.join(REPO, "docs", "QUICK_EXAMPLE.md")).read().split("```text\n")
    want = fences[5].split("```", 1)[0].rstrip("\n").splitlines()
    want_err = fences[6].split("```", 1)[0].rstrip("\n").splitlines()
    model = str(tmp_path / "vit-tiny-quick.gguf")
    write_quick_example_model(model)
    heat = str(tmp_path / "heat.png")
    r = subprocess.run(
        [sys.executable, "-m", "vit_cpp_tpu_torch.cli.explain", "-m", model, "-i", MAGPIE,
         "-o", heat, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.rstrip("\n").splitlines() == want
    assert r.stderr.replace(str(tmp_path), "<tmp>").rstrip("\n").splitlines() == want_err
    assert np.asarray(Image.open(heat)).shape == (224, 224)


def test_cli_explain_runs_on_the_card_by_default(files, tmp_path):
    from vit_cpp_tpu_torch.cli.explain import main

    if torch.cuda.is_available():  # decided here, not at import
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["-m", files["cls"], "-i", files["img"], "--npy", str(tmp_path / "g.npy")])
