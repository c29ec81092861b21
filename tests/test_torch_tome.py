"""The port's ToMe token merging and token padding against the JAX
package's.

ToMe (ops/tome.py, models/vit.py::tome_block, forward(tome=r)) and
forward(pad_tokens=True) on tiny synthetic models (h=64, 3 layers, 4
heads, 32 px, patch 8: 16 patches, r=2 merges 2+2+2), with the same
numpy-made inputs through both packages. On the CPU the port's kernels
run their plain versions and the JAX package's Pallas kernels run in
interpret mode. Tolerances: 1e-5 in f32 (summation order only), 2e-2 in
bf16 (rounding at other places); merge matrices, sizes and schedules
must be equal, bit for bit, including the tie case of identical tokens.
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models import forward as jax_forward
from vit_cpp_tpu.models import params_from_state_dict
from vit_cpp_tpu.ops import tome as jax_tome
from vit_cpp_tpu.testing.synthetic import random_state_dict, write_synthetic_model
from vit_cpp_tpu_torch.models.params import params_from_jax
from vit_cpp_tpu_torch.models.vit import forward
from vit_cpp_tpu_torch.ops import tome

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
BF16_TOL = 2e-2
TINY = VitHParams(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_classes=16,
                  patch_size=8, img_size=32)
# the readouts ToMe weights: CLS, the size-weighted patch mean, the
# distilled pair, CLS behind four registers, SigLIP's attention pooling
HEADS = {
    "cls": {},
    "avg": dict(global_pool="avg", num_prefix_tokens=0),
    "distilled": dict(num_prefix_tokens=2),
    "registers": dict(num_reg_tokens=4),
    "map": dict(global_pool="map", num_prefix_tokens=0, pixel_norm="unit"),
}


def _model(head, **geometry):
    hp = dataclasses.replace(TINY, **HEADS[head], **geometry)
    jax_params = params_from_state_dict(random_state_dict(hp, seed=7), hp)
    return hp, jax_params, params_from_jax(jax_params)


def _images(n=2, size=32, seed=5):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(np.float32)


def _both(jax_params, params, x, hp, **kw):
    """(port, JAX) outputs of forward on the same pixels, as numpy."""
    got = forward(params, torch.from_numpy(x), hp, **kw)
    want = jax_forward(jax_params, jnp.asarray(x), hp, **kw)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("n,layers,r", [(196, 12, 16), (196, 12, 8), (784, 12, 26), (16, 3, 2),
                                        (16, 12, 8), (5, 4, 3), (1, 3, 1)])
def test_tome_schedule_matches_jax(n, layers, r):
    """Including the clamp: at most half the remaining patches per layer."""
    got = tome.tome_schedule(n, layers, r)
    assert got == jax_tome.tome_schedule(n, layers, r)
    assert all(rl <= r for rl in got) and n - sum(got) >= 1


@pytest.mark.parametrize("r", [0, -1])
def test_tome_schedule_refuses_r_below_one_as_jax(r):
    with pytest.raises(ValueError) as ours:
        tome.tome_schedule(196, 12, r)
    with pytest.raises(ValueError) as theirs:
        jax_tome.tome_schedule(196, 12, r)
    assert str(ours.value) == str(theirs.value) == f"tome r must be >= 1, got {r}"


# prefix layouts: none (avg/map), CLS, CLS + distillation token, CLS + 4 registers
@pytest.mark.parametrize("n_prefix", [0, 1, 2, 5])
@pytest.mark.parametrize("t,r", [(17, 4), (16, 8), (29, 3)])
def test_merge_matrix_matches_jax(n_prefix, t, r):
    """M and sizes' bit for bit, from integer counts as a merge schedule
    makes them; the prefix rows are the identity."""
    t += n_prefix
    rng = np.random.default_rng(t * 10 + n_prefix)
    metric = rng.standard_normal((3, t, 6)).astype(np.float32)
    sizes = rng.integers(1, 9, (3, t)).astype(np.float32)
    mm, sn = tome._merge_matrix(torch.from_numpy(metric), torch.from_numpy(sizes), r, n_prefix)
    jmm, jsn = jax_tome._merge_matrix(jnp.asarray(metric), jnp.asarray(sizes), r, n_prefix)
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jmm))
    np.testing.assert_array_equal(sn.numpy(), np.asarray(jsn))
    assert mm.shape == (3, t - r, t)
    np.testing.assert_array_equal(mm.numpy()[:, :n_prefix, :n_prefix],
                                  np.broadcast_to(np.eye(n_prefix), (3, n_prefix, n_prefix)))
    np.testing.assert_array_equal(sn.numpy().sum(1), sizes.sum(1))  # counts are conserved


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_tome_merge_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 17, 32)).astype(np.float32)
    metric = rng.standard_normal((3, 17, 8)).astype(np.float32)
    sizes = rng.integers(1, 5, (3, 17)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xn, sn = tome.tome_merge(torch.from_numpy(x).to(dtype), torch.from_numpy(metric),
                             torch.from_numpy(sizes), 4, 1)
    jxn, jsn = jax_tome.tome_merge(jnp.asarray(x, jdt), jnp.asarray(metric),
                                   jnp.asarray(sizes), 4, 1)
    assert xn.dtype == dtype and xn.shape == (3, 13, 32)
    np.testing.assert_allclose(xn.float().numpy(), np.asarray(jxn, np.float32), atol=tol, rtol=0)
    np.testing.assert_array_equal(sn.numpy(), np.asarray(jsn))
    with pytest.raises(ValueError, match="smaller bipartite set"):
        tome.tome_merge(torch.from_numpy(x), torch.from_numpy(metric),
                        torch.from_numpy(sizes), 9, 1)


def test_identical_tokens_merge_as_jax_exactly():
    """Every score a tie: the sources are the lowest A indices (top_k's
    order) and each picks B token 0 (argmax's first maximum), in both."""
    row = np.random.default_rng(4).standard_normal(8).astype(np.float32)
    metric = np.broadcast_to(row, (2, 21, 8)).copy()
    sizes = np.ones((2, 21), np.float32)
    node_max, node_idx, src = tome.bipartite_match(torch.from_numpy(metric), 5, 1)
    assert src.tolist() == [[0, 1, 2, 3, 4]] * 2 and node_idx.eq(0).all()
    assert torch.equal(node_max, node_max[:, :1].expand_as(node_max))
    mm, sn = tome._merge_matrix(torch.from_numpy(metric), torch.from_numpy(sizes), 5, 1)
    jmm, jsn = jax_tome._merge_matrix(jnp.asarray(metric), jnp.asarray(sizes), 5, 1)
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jmm))
    np.testing.assert_array_equal(sn.numpy(), np.asarray(jsn))


def test_identical_patches_merge_losslessly_as_in_jax():
    """tests/test_tome.py::test_identical_patches_merge_losslessly on the
    port: tiled patches make every merge exact, so the merged forward
    gives the full forward's logits (the JAX test's 1e-4) and JAX's
    merged logits (1e-5)."""
    hp, jax_params, params = _model("cls")
    one = np.random.default_rng(4).standard_normal((3, 8, 8))
    tile = np.tile(one, (1, 4, 4))
    x = np.stack([tile, tile * 0.5]).astype(np.float32)
    got, want = _both(jax_params, params, x, hp, tome=2)
    base = forward(params, torch.from_numpy(x), hp).numpy()
    np.testing.assert_allclose(got, base, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("attn", ["xla", "pallas", "pallas-fast"])
@pytest.mark.parametrize("head", list(HEADS))
def test_tome_forward_matches_jax(head, attn):
    """Logits and features through the merged layers: proportional
    attention on each attention path, the size-weighted readouts."""
    hp, jax_params, params = _model(head)
    x = _images()
    for features in (False, True):
        got, want = _both(jax_params, params, x, hp, tome=2, attn_impl=attn, features=features)
        assert got.shape == ((2, 64) if features else (2, 16))
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    base = forward(params, torch.from_numpy(x), hp, attn_impl=attn).numpy()
    logits = forward(params, torch.from_numpy(x), hp, tome=2, attn_impl=attn).numpy()
    assert np.abs(logits - base).max() > 1e-3  # random weights: merging moves the logits


def test_tome_block_matches_jax_in_bf16():
    """One merged block in bf16 through the fast fused attention."""
    from vit_cpp_tpu.models.vit import slice_block_params, tome_block as jax_block
    from vit_cpp_tpu_torch.models.vit import tome_block, unstack_blocks

    hp, jax_params, params = _model("cls")
    x = np.random.default_rng(6).standard_normal((2, 17, 64)).astype(np.float32)
    sizes = np.random.default_rng(7).integers(1, 4, (2, 17)).astype(np.float32)
    bp = unstack_blocks(params["blocks"], 3)[1]
    bp = {k: {n: None if v is None else v.to(torch.bfloat16) for n, v in sub.items()}
          for k, sub in bp.items()}
    jbp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                       {k: slice_block_params(v, 1) for k, v in jax_params["blocks"].items()})
    got, gs = tome_block(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(sizes), bp,
                         hp, 3, attn_impl="pallas-fast", mm_impl="xla")
    want, ws = jax_block(jnp.asarray(x, jnp.bfloat16), jnp.asarray(sizes), jbp, hp, 3,
                         attn_impl="pallas-fast", mm_impl="xla")
    assert got.dtype == torch.bfloat16 and got.shape == (2, 14, 64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_TOL * max(1.0, float(np.abs(want).max())), rtol=0)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from vit_cpp_tpu_torch.cli.quantize import quantize_model_file

    d = tmp_path_factory.mktemp("tome")
    out = {"f16": str(d / "m.gguf"), "q8": str(d / "m-q8_0.gguf"), "dir": str(d / "imgs"),
           "vitstr": str(d / "vitstr.gguf"), "b": str(d / "b.gguf"), "tmp": d}
    write_synthetic_model(out["f16"], TINY, ftype=1, seed=0,
                          id2label={i: f"class_{i}" for i in range(16)})
    write_synthetic_model(out["b"], dataclasses.replace(TINY, num_classes=5), ftype=1, seed=1)
    assert quantize_model_file(out["f16"], out["q8"], 8, verbose=False)
    write_synthetic_model(out["vitstr"], dataclasses.replace(TINY, in_chans=1, seq_len=25,
                                                             num_classes=96), ftype=1, seed=2)
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(out["dir"])
    for i in range(5):
        h, w = rng.integers(24, 64, 2)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(out["dir"], f"{i}.png"))
    return out


def _engines(path, **kw):
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
    from vit_cpp_tpu_torch.engine import VitEngine

    return (VitEngine(path, device="cpu", verbose=False, **kw),
            JaxVitEngine(path, verbose=False, **kw))


@pytest.mark.parametrize(
    "which,kw,tol",
    [
        # int8 W8A8 with LayerNorm folded, fused fast attention: an int8
        # activation code can flip where the two packages' f32 sums
        # straddle a rounding boundary (test_torch_engine's serving-f32)
        ("f16", dict(mm_impl="int8", fold_ln=True, attn_impl="pallas-fast"), 1e-4),
        # Q8_0 through the dequantizing matmul's plain version vs the JAX
        # Pallas kernel, fused safe attention: summation order only
        ("q8", dict(mm_impl="pallas", attn_impl="pallas"), F32_TOL),
        # static activation scales calibrated on the same batch
        # (on the unmerged graph in both packages, through the composed
        # attention the JAX engine calibrates with), then served merged
        ("f16", dict(mm_impl="int8", act_quant="static", attn_impl="xla"), 1e-4),
    ],
    ids=["int8-fold", "q8_0-pallas", "static-scales"],
)
def test_tome_serving_paths_match_jax(files, which, kw, tol):
    from tests.test_torch_calibrate import structured_images

    engine, jax_engine = _engines(files[which], tome=2, **kw)
    # correlated token activations, as the calibration tests use: random
    # pixels put many int8 codes at a rounding boundary
    x = structured_images(4)
    if kw.get("act_quant") == "static":
        engine.calibrate(torch.from_numpy(x))
        jax_engine.calibrate(jnp.asarray(x))
    got = engine.predict_probs_batch(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_engine.predict_probs_batch(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    if not kw.get("fold_ln"):  # a folded JAX engine drops the final norm's affine
        feats = engine.features_batch(torch.from_numpy(x)).numpy()
        jax_feats = np.asarray(jax_engine.features_batch(jnp.asarray(x)))
        np.testing.assert_allclose(feats, jax_feats, atol=tol * max(1.0, float(np.abs(jax_feats).max())),
                                   rtol=0)


def test_engine_prints_the_tome_line_and_classifies_as_jax(files, capsys):
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
    from vit_cpp_tpu_torch.engine import VitEngine

    engine = VitEngine(files["f16"], tome=2, device="cpu")
    ours = capsys.readouterr().out.splitlines()
    jax_engine = JaxVitEngine(files["f16"], tome=2)
    theirs = capsys.readouterr().out.splitlines()
    assert ours == theirs
    assert ours[-1] == "vit_model_load: tome r=2 — patch tokens 16 -> 10 over 3 layers"
    x = _images(3)
    np.testing.assert_allclose(engine.predict_probs_batch(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_engine.predict_probs_batch(jnp.asarray(x))),
                               atol=F32_TOL, rtol=0)


def test_tome_refuses_what_jax_refuses(files):
    """The raises of the JAX package, message for message: ToMe with a
    sequence head (forward and engine), with padding, with MoE; padding
    off the fused attention."""
    from vit_cpp_tpu.engine import VitstrEngine as JaxVitstrEngine
    from vit_cpp_tpu_torch.engine import VitstrEngine

    def same_error(ours, theirs):
        with pytest.raises(ValueError) as a:
            ours()
        with pytest.raises(ValueError) as b:
            theirs()
        assert str(a.value) == str(b.value)
        return str(a.value)

    hp, jax_params, params = _model("cls")
    x = _images(1)
    seq = dataclasses.replace(hp, seq_len=4)
    assert "sequence heads" in same_error(
        lambda: forward(params, torch.from_numpy(x), seq, tome=2),
        lambda: jax_forward(jax_params, jnp.asarray(x), seq, tome=2))
    assert same_error(
        lambda: forward(params, torch.from_numpy(x), hp, tome=2, pad_tokens=True,
                        attn_impl="pallas"),
        lambda: jax_forward(jax_params, jnp.asarray(x), hp, tome=2, pad_tokens=True,
                            attn_impl="pallas")) == "tome and pad_tokens are exclusive"
    moe = dataclasses.replace(hp, num_experts=4, moe_layers=(1,))
    assert "MoE" in same_error(
        lambda: forward(params, torch.from_numpy(x), moe, tome=2),
        lambda: jax_forward(jax_params, jnp.asarray(x), moe, tome=2))
    for attn in ("xla", "pallas-train"):
        assert "pad_tokens requires a fused pallas attention" in same_error(
            lambda: forward(params, torch.from_numpy(x), hp, pad_tokens=True, attn_impl=attn),
            lambda: jax_forward(jax_params, jnp.asarray(x), hp, pad_tokens=True,
                                attn_impl=attn))
    assert "sequence-head (ViTSTR)" in same_error(
        lambda: VitstrEngine(files["vitstr"], tome=2, device="cpu", verbose=False),
        lambda: JaxVitstrEngine(files["vitstr"], tome=2, verbose=False))


def test_tome_training_loss_and_gradients_match_jax():
    """The ToMe training loss through pallas-train (the plain backward
    kernel's version vs JAX's interpret-mode custom VJP) and every
    parameter's gradient."""
    from vit_cpp_tpu.parallel.train import cross_entropy_loss as jax_loss
    from vit_cpp_tpu_torch.parallel.train import cross_entropy_loss, tree_leaves

    hp, jax_params, params = _model("cls")
    x = _images(4, seed=8)
    y = np.array([1, 2, 3, 4])
    jl, jg = jax.value_and_grad(jax_loss)(jax_params, jnp.asarray(x), jnp.asarray(y), hp,
                                          0.0, 2)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    loss = cross_entropy_loss(params, torch.from_numpy(x), torch.from_numpy(y), hp, 0.0, 2)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= F32_TOL * abs(float(jl))
    def named(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items() for k, v in named(sub, f"{prefix}.{key}").items()}
        return {} if tree is None else {prefix: tree}

    ours, theirs = named(params), named(params_from_jax(jg))
    assert ours.keys() == theirs.keys()
    for name, leaf in ours.items():
        want = theirs[name].numpy()
        np.testing.assert_allclose(leaf.grad.numpy(), want,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-12), rtol=0,
                                   err_msg=name)
    assert params["blocks"]["qkv"]["kernel"].grad.abs().max() > 0


def test_finetune_with_tome_learns_and_the_meta_pins_r(tmp_path):
    """tests/test_tome.py::test_finetune_with_tome_learns_and_meta_pins_r
    on the port, through the CLI: it learns, validates through the merged
    graph, records tome in the meta; resuming with another r, or with
    --tome from a meta that predates the key, is refused with the JAX
    message."""
    from tests.test_torch_finetune import _make_dataset
    from vit_cpp_tpu_torch.cli.finetune import main
    from vit_cpp_tpu_torch.finetune import _preprocess_all, evaluate, finetune, load_dataset

    model = str(tmp_path / "m.gguf")
    write_synthetic_model(model, dataclasses.replace(TINY, num_classes=5), ftype=1, seed=4)
    data = _make_dataset(tmp_path / "train")
    ckpt = str(tmp_path / "ckpt")
    quiet = dict(log=lambda m: None, device="cpu")
    params, hp, _, losses = finetune(model, data, epochs=2, batch=4, lr=1e-3, tome=2,
                                     ckpt_dir=ckpt, **quiet)
    assert losses[-1] < losses[0]
    paths, labels, _ = load_dataset(data)
    pixels = _preprocess_all(paths, hp, 1, "cpu")
    assert evaluate(params, hp, pixels, labels, batch=4, tome=2) >= 0.9
    with open(ckpt + ".meta.json") as f:
        meta = json.load(f)
    assert meta["tome"] == 2
    with pytest.raises(ValueError, match="tome"):
        finetune(model, data, epochs=3, batch=4, lr=1e-3, tome=4, ckpt_dir=ckpt, **quiet)
    del meta["tome"]
    with open(ckpt + ".meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError) as e:
        finetune(model, data, epochs=3, batch=4, lr=1e-3, tome=2, ckpt_dir=ckpt, **quiet)
    assert str(e.value) == (
        f"checkpoint at {ckpt} predates --tome recording (trained unmerged); resuming "
        "with --tome would not replay the original run — drop --tome or use a fresh "
        "--ckpt-dir")
    out = str(tmp_path / "ft.gguf")
    assert main(["-m", model, "-d", data, "-o", out, "-b", "4", "--epochs", "1",
                 "--tome", "2", "--val-dir", data, "--device", "cpu"]) == 0
    assert main(["-m", model, "-d", data, "-o", out, "--tome", "-1", "--device", "cpu"]) == 1


def test_finetune_refuses_tome_as_jax(files, tmp_path):
    from tests.test_torch_finetune import _make_dataset
    from vit_cpp_tpu.finetune import finetune as jax_finetune
    from vit_cpp_tpu_torch.finetune import finetune

    data = _make_dataset(tmp_path / "d", n_per_class=2)
    for model, r in ((files["f16"], -1), (files["vitstr"], 2)):
        with pytest.raises(ValueError) as ours:
            finetune(model, data, tome=r, log=lambda m: None, device="cpu")
        with pytest.raises(ValueError) as theirs:
            jax_finetune(model, data, tome=r, log=lambda m: None)
        assert str(ours.value) == str(theirs.value)


def _cli(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def test_cli_serve_tome_prints_the_jax_tools_lines(files, capsys):
    from vit_cpp_tpu.cli import serve as jax_cli_serve
    from vit_cpp_tpu_torch.cli import serve as cli_serve

    argv = ["-m", files["f16"], "-d", files["dir"], "-b", "2", "-k", "3", "--dtype", "f32",
            "--mm", "xla", "--attn", "xla", "--tome", "2"]
    rc_j, out_j, _ = _cli(jax_cli_serve.main, argv, capsys)
    rc_p, out_p, _ = _cli(cli_serve.main, argv + ["--device", "cpu"], capsys)
    assert rc_p == rc_j == 0
    assert out_p.splitlines() == out_j.splitlines() and len(out_p.splitlines()) == 5
    # at the serving defaults (bf16, W8A8, folded, fast fused attention)
    rc, out, _ = _cli(cli_serve.main, ["-m", files["f16"], "-d", files["dir"], "--tome", "2",
                                       "--device", "cpu"], capsys)
    assert rc == 0 and len(out.splitlines()) == 5
    argv = ["-m", files["vitstr"], "-d", files["dir"], "--tome", "2"]
    rc_j, _, err_j = _cli(jax_cli_serve.main, argv, capsys)
    rc_p, _, err_p = _cli(cli_serve.main, argv + ["--device", "cpu"], capsys)
    assert rc_p == rc_j == 1
    assert err_p.splitlines()[-1] == err_j.splitlines()[-1] == (
        "serve: tome token merging is incompatible with sequence-head (ViTSTR) checkpoints")


class _FakeHttpd:
    server_port = 0

    def serve_forever(self):
        raise KeyboardInterrupt  # leave main's serve loop at once

    def server_close(self):
        pass


def _daemon_answers(server_mod, main, argv, routes, body):
    """Run a daemon CLI's main with its real server on a free port: the
    JSON answers to POSTing `body` at each route, and its engines."""
    answers, engines = {}, {}

    def serve(httpd):
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{httpd.server_port}"
        try:
            for route in routes:
                req = urllib.request.Request(base + route, data=body, method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    answers[route] = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()

    real_single, real_multi = server_mod.create_server, server_mod.create_multi_server

    def single(engine, **kw):
        engines[None] = engine
        httpd, batcher = real_single(engine, **{**kw, "port": 0})
        serve(httpd)
        return _FakeHttpd(), batcher

    def multi(engs, **kw):
        engines.update(engs)
        httpd, batchers = real_multi(engs, **{**kw, "port": 0})
        serve(httpd)
        return _FakeHttpd(), batchers

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(server_mod, "create_server", single)
        mp.setattr(server_mod, "create_multi_server", multi)
        assert main(argv) == 0
    return answers, engines


def _assert_answers_agree(got, want):
    assert got.keys() == want.keys()
    for route in got:
        assert [c["id"] for c in got[route]["topk"]] == [c["id"] for c in want[route]["topk"]]
        np.testing.assert_allclose([c["prob"] for c in got[route]["topk"]],
                                   [c["prob"] for c in want[route]["topk"]], atol=F32_TOL)


def test_cli_server_tome_answers_as_the_jax_daemon(files):
    """-m a=... -m b=... --tome 2 on both daemons: the same JSON, the
    probabilities within 1e-5 (f32, composed attention). One model: the
    port's daemon merges (the JAX single-model daemon drops --tome, so
    its counterpart is the JAX daemon on an engine built with tome=2)."""
    from vit_cpp_tpu import server as jax_server_mod
    from vit_cpp_tpu.cli.server import main as jax_main
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
    from vit_cpp_tpu_torch import server as server_mod
    from vit_cpp_tpu_torch.cli.server import main

    with open(os.path.join(REPO, "assets", "magpie.jpeg"), "rb") as f:
        body = f.read()
    flags = ["--dtype", "f32", "--mm", "xla", "--attn", "xla", "--tome", "2", "-b", "2",
             "--no-warmup"]
    argv = ["-m", f"a={files['f16']}", "-m", f"b={files['b']}", *flags]
    routes = ["/v1/a/classify?topk=5", "/v1/b/classify?topk=5"]
    got, engines = _daemon_answers(server_mod, main, argv + ["--device", "cpu"],
                                   routes, body)
    want, jax_engines = _daemon_answers(jax_server_mod, jax_main, argv, routes,
                                        body)
    _assert_answers_agree(got, want)
    assert engines["a"].tome == engines["b"].tome == jax_engines["a"]._tome == 2

    got, engines = _daemon_answers(server_mod, main,
                                   ["-m", files["f16"], *flags, "--device", "cpu"],
                                   ["/v1/classify?topk=5"], body)
    assert engines[None].tome == 2
    _, jax_engines = _daemon_answers(jax_server_mod, jax_main,
                                     ["-m", files["f16"], *flags], [], body)
    assert jax_engines[None]._tome == 0  # ROADMAP C: the JAX single-model daemon drops --tome
    from vit_cpp_tpu.server import create_server as jax_create

    httpd, batcher = jax_create(JaxVitEngine(files["f16"], tome=2, verbose=False), port=0,
                                batch=2, warmup=False)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_port}/v1/classify?topk=5",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            want = {"/v1/classify?topk=5": json.loads(r.read())}
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    _assert_answers_agree(got, want)


# token padding: 40 px at patch 8 gives 25 patches, so T = 26 (CLS) and
# 25 (avg, map), neither a multiple of 8: every case pads
@pytest.mark.parametrize("attn", ["pallas", "pallas-fast"])
@pytest.mark.parametrize("head", ["cls", "avg", "map"])
def test_pad_tokens_matches_jax_and_the_unpadded_forward(head, attn):
    hp, jax_params, params = _model(head, img_size=40)
    x = _images(2, size=40)
    for features in (False, True):
        got, want = _both(jax_params, params, x, hp, pad_tokens=True, attn_impl=attn,
                          features=features)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
        unpadded = forward(params, torch.from_numpy(x), hp, attn_impl=attn,
                           features=features).numpy()
        np.testing.assert_allclose(got, unpadded, atol=F32_TOL, rtol=0)


def test_pad_tokens_pads_to_a_multiple_of_eight(monkeypatch):
    """The blocks run at T=32 with kv=26; a T that is a multiple of 8
    runs unpadded (kv None)."""
    from vit_cpp_tpu_torch.models import vit

    seen = []
    real = vit.attention_qkv

    def spy(qkv, nh, **kw):
        seen.append((qkv.shape[1], kw.get("kv")))
        return real(qkv, nh, **kw)

    monkeypatch.setattr(vit, "attention_qkv", spy)
    hp, _, params = _model("cls", img_size=40)
    forward(params, torch.from_numpy(_images(1, size=40)), hp, pad_tokens=True,
            attn_impl="pallas")
    hp, _, params = _model("avg")
    forward(params, torch.from_numpy(_images(1)), hp, pad_tokens=True, attn_impl="pallas")
    assert seen == [(32, 26)] * 3 + [(16, None)] * 3
