"""The port's geometry resampling (--img-size / --patch-size) against the
JAX package's.

models/resample.py computes on the host in numpy at load time, as the
JAX module does: its matrices and its resampled parameter trees must
equal the JAX ones within 1e-6, with `torch.nn.functional.interpolate`
as the oracle of the matrices. Then the engine's overrides (the verbose
echo, the probabilities of the resampled model within 1e-5 of the JAX
engine's), `build_engine` and the CLIs, whose --img-size / --patch-size
no longer raise. A synthetic ViT (h=64, L=2, 4 heads, 32 px, patch 8,
10 classes) on the CPU; one test, marked cuda, runs the resampled
ViT-B/16 geometry at T=785 through the fused attention kernel on the
card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models import resample as jax_resample
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.engine import VitEngine
from vit_cpp_tpu_torch.models import resample
from vit_cpp_tpu_torch.models.params import params_from_jax

HP = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_classes=10,
                patch_size=8, img_size=32)
TOL = 1e-6
PROB_TOL = 1e-5


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("resample") / "m.gguf")
    write_synthetic_model(p, HP, ftype=1, seed=10)
    return p


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("n_in,n_out", [(14, 24), (24, 14), (7, 16), (4, 98)])
def test_resize_matrix_matches_jax_and_interpolate(mode, antialias, n_in, n_out):
    w = resample.torch_resize_matrix(n_in, n_out, mode=mode, antialias=antialias)
    np.testing.assert_allclose(
        w, jax_resample.torch_resize_matrix(n_in, n_out, mode=mode, antialias=antialias),
        atol=TOL, rtol=0)
    x = np.random.default_rng(n_in * n_out).standard_normal((n_in,)).astype(np.float32)
    want = torch.nn.functional.interpolate(
        torch.from_numpy(np.broadcast_to(x, (n_in, n_in)).copy()[None, None]),
        size=(n_out, n_out), mode=mode, align_corners=False, antialias=antialias,
    )[0, 0, 0].numpy()
    np.testing.assert_allclose(w @ x, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("p_old,p_new", [(8, 4), (16, 8), (8, 12), (16, 32)])
def test_pi_resize_factor_matches_jax(p_old, p_new):
    np.testing.assert_allclose(resample.pi_resize_factor(p_old, p_new),
                               jax_resample.pi_resize_factor(p_old, p_new), atol=TOL, rtol=0)


@pytest.mark.parametrize("no_embed_class", [False, True])
@pytest.mark.parametrize("new_side", [6, 3, 4])
def test_pos_embed_and_patch_embed_match_jax(no_embed_class, new_side):
    hp = dataclasses.replace(HP, no_embed_class=no_embed_class)
    rng = np.random.default_rng(new_side)
    rows = hp.n_patches + (0 if no_embed_class else 1)
    pos = rng.standard_normal((rows, 64)).astype(np.float32)
    got = resample.resample_pos_embed(pos, hp, new_side)
    want = jax_resample.resample_pos_embed(pos, hp, new_side)
    assert got.shape == (new_side ** 2 + (0 if no_embed_class else 1), 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    kernel = rng.standard_normal((3 * 8 * 8, 64)).astype(np.float32)
    np.testing.assert_allclose(resample.resample_patch_embed(kernel, hp, new_side),
                               jax_resample.resample_patch_embed(kernel, hp, new_side),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("img_size,patch_size", [(48, None), (32, 4), (24, 4), (64, 16)])
def test_resample_params_matches_jax(model, img_size, patch_size):
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine

    jax_engine = JaxVitEngine(model, verbose=False)
    ours, hp = resample.resample_params(params_from_jax(jax_engine.params), jax_engine.hp,
                                        img_size, patch_size=patch_size)
    theirs, jhp = jax_resample.resample_params(jax_engine.params, jax_engine.hp, img_size,
                                               patch_size=patch_size)
    assert (hp.img_size, hp.patch_size) == (jhp.img_size, jhp.patch_size)
    for key in ("pos_embed",):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]), atol=TOL, rtol=0)
    np.testing.assert_allclose(ours["patch_embed"]["kernel"].numpy(),
                               np.asarray(theirs["patch_embed"]["kernel"]), atol=TOL, rtol=0)
    assert ours["pos_embed"].dtype == torch.float32


def test_resample_params_validation(model):
    engine = VitEngine(model, device="cpu", verbose=False)
    assert resample.resample_params(engine.params, engine.hp, None) == (engine.params, engine.hp)
    with pytest.raises(ValueError, match="multiple of patch_size"):
        resample.resample_params(engine.params, engine.hp, 36)
    with pytest.raises(ValueError, match=">= 1"):
        resample.resample_params(engine.params, engine.hp, 32, patch_size=0)
    with pytest.raises(ValueError, match="ViTSTR"):
        resample.resample_params(engine.params, dataclasses.replace(engine.hp, seq_len=25), 48)


@pytest.mark.parametrize("kw", [{"img_size": 48}, {"patch_size": 4},
                                {"img_size": 48, "patch_size": 16}],
                         ids=["img48", "patch4", "img48-patch16"])
def test_engine_override_matches_jax(model, capsys, kw):
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine

    jax_engine = JaxVitEngine(model, **kw)
    want_echo = capsys.readouterr().out.splitlines()
    engine = VitEngine(model, device="cpu", **kw)
    echo = capsys.readouterr().out.splitlines()
    assert [ln.split("=")[0] for ln in echo] == [ln.split("=")[0] for ln in want_echo]
    assert echo[-1] == want_echo[-1] and "geometry override" in echo[-1]
    assert (engine.hp.img_size, engine.hp.patch_size) == (jax_engine.hp.img_size,
                                                          jax_engine.hp.patch_size)
    rng = np.random.default_rng(11)
    s = engine.hp.img_size
    x = rng.standard_normal((2, 3, s, s)).astype(np.float32)
    got = engine.predict_probs_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_engine.predict_probs_batch(jnp.asarray(x))),
                               atol=PROB_TOL, rtol=0)
    img = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    assert engine.preprocess_image(img).shape == (3, s, s)


def test_build_engine_serves_the_geometry_flags(model):
    """--img-size and --patch-size no longer raise: build_engine resamples
    at the serving defaults (bf16, W8A8, fused attention, fold), whose
    top-1 agrees with the resampled f32 engine."""
    from vit_cpp_tpu_torch.cli.common import build_engine

    engine, _ = build_engine(model, img_size=48, patch_size=4, device="cpu")
    assert (engine.hp.img_size, engine.hp.patch_size, engine.hp.n_patches) == (48, 4, 144)
    assert engine.params["blocks"]["ln1"]["scale"] is None
    ref = VitEngine(model, img_size=48, patch_size=4, device="cpu", verbose=False)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 3, 48, 48))
                         .astype(np.float32))
    got, want = engine.predict_probs_batch(x).numpy(), ref.predict_probs_batch(x).numpy()
    assert np.abs(got - want).max() < 2e-2
    with pytest.raises(ValueError, match="multiple of patch_size"):
        build_engine(model, img_size=50, device="cpu")


def _run_main(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("flags", [["--img-size", "48"], ["--patch-size", "4"],
                                   ["--img-size", "40"]], ids=["img48", "patch4", "img40-bad"])
def test_cli_serve_geometry_flags_match_the_jax_cli(model, tmp_path, capsys, flags):
    from PIL import Image

    from vit_cpp_tpu.cli import serve as jax_serve
    from vit_cpp_tpu_torch.cli import serve as port_serve

    rng = np.random.default_rng(4)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (50, 44 + i, 3), dtype=np.uint8)).save(paths[-1])
    argv = ["-m", model, *paths, "-b", "2", "-k", "3", "--dtype", "f32", "--mm", "xla",
            "--attn", "xla", *flags]
    rc_j, out_j, err_j = _run_main(jax_serve.main, argv, capsys)
    rc_p, out_p, err_p = _run_main(port_serve.main, argv + ["--device", "cpu"], capsys)
    assert rc_p == rc_j
    if rc_j:
        assert err_p.splitlines()[-1] == err_j.splitlines()[-1]
        assert "is not a multiple of patch_size" in err_p
        return
    assert out_p.splitlines() == out_j.splitlines()


def test_cli_server_multi_model_skips_geometry_for_a_vitx(model, tmp_path, capsys,
                                                         monkeypatch):
    """In a multi-model daemon a .vitx artifact gets the JAX daemon's
    notice that its geometry is baked; a JAX-made artifact is then
    refused by name, and a port-made one is served at its own geometry
    while the gguf beside it is resampled."""
    from vit_cpp_tpu.aot import MAGIC
    from vit_cpp_tpu_torch import server as server_mod
    from vit_cpp_tpu_torch.aot import save_engine
    from vit_cpp_tpu_torch.cli.server import main

    art = tmp_path / "m.vitx"
    art.write_bytes(MAGIC + b"\x02\0\0\0{}")
    argv = ["-m", f"a={model}", "-m", f"b={art}", "--img-size", "48", "--patch-size", "4",
            "--device", "cpu", "--no-warmup", "--port", "0"]
    rc = main(argv)
    err = capsys.readouterr().err
    assert rc == 1
    assert "vit-server: b: .vitx geometry is baked at export; ignoring --img-size 48 " \
           "--patch-size 4" in err
    assert "vit-server: b: " in err.splitlines()[-1]
    assert "is a .vitx artifact of the JAX package" in err

    served = {}

    class Stop:
        server_port = 0

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    def fake_multi(engines, **kw):
        served.update(engines)
        return Stop(), {}

    monkeypatch.setattr(server_mod, "create_multi_server", fake_multi)
    save_engine(VitEngine(model, device="cpu", verbose=False), str(art), batch=2)
    assert main(argv) == 0
    assert "vit-server: b: .vitx geometry is baked at export" in capsys.readouterr().err
    assert served["a"].hp.img_size == 48 and served["a"].hp.patch_size == 4
    assert served["b"].hp.img_size == HP.img_size and served["b"].batches == [2]


@pytest.mark.cuda
def test_resampled_forward_at_t785_on_the_card(tmp_path):
    """ViT-B/16's width resampled to patch 8 at 224 px (T=785, the
    ViT-B/8 geometry) at the serving defaults on the card: 12 fused
    attention launches per forward, top-5 probabilities within 5e-3 of
    the resampled f32 engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernel has no CPU mode")
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL

    hp = VitHParams(hidden_size=768, num_hidden_layers=2, num_attention_heads=12,
                    num_classes=1000, patch_size=16, img_size=224)
    p = str(tmp_path / "b16.gguf")
    write_synthetic_model(p, hp, ftype=1, seed=0)
    engine, _ = build_engine(p, patch_size=8)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3, 224, 224))
                         .astype(np.float32)).cuda()
    before = KERNEL.launches
    got = engine.predict_probs_batch(x).cpu().numpy()
    assert KERNEL.launches == before + 2 and engine.hp.n_patches + 1 == 785
    ref = VitEngine(p, dtype="f32", patch_size=8, verbose=False)
    want = ref.predict_probs_batch(x).cpu().numpy()
    top = np.argsort(-want, axis=1)[:, :5]
    assert np.abs(np.take_along_axis(got, top, 1) - np.take_along_axis(want, top, 1)).max() < 5e-3


# ---- fine-tuning at a resampled geometry (--img-size / --patch-size) ----


@pytest.mark.parametrize("geometry", [dict(img_size=48), dict(patch_size=4)],
                         ids=["img-size-48", "patch-size-4"])
def test_finetune_at_a_resampled_geometry(tmp_path, geometry):
    """The 32 px / patch 8 checkpoint trains at 48 px (T=37) or patch 4
    (T=65): the start is resample_params' tree (the JAX package's within
    1e-6, test_resample_params_matches_jax), the loss falls, the export
    serves the new geometry natively, and the resume guards pin it with
    the JAX package's messages."""
    import json

    from tests.test_torch_finetune import _make_dataset
    from vit_cpp_tpu.hparams import VitHParams as JaxHParams
    from vit_cpp_tpu_torch.finetune import finetune
    from vit_cpp_tpu_torch.models.export import save_params

    base = str(tmp_path / "m.gguf")
    write_synthetic_model(base, JaxHParams(hidden_size=64, num_hidden_layers=2,
                                           num_attention_heads=2, num_classes=7, patch_size=8,
                                           img_size=32), ftype=1, seed=4)
    size = geometry.get("img_size", 32)
    data = _make_dataset(tmp_path / "train", size=size)
    ck = str(tmp_path / "ckpt")
    quiet = dict(log=lambda m: None, device="cpu")
    params, hp, classes, losses = finetune(base, data, epochs=3, batch=4, lr=1e-3,
                                           ckpt_dir=ck, **geometry, **quiet)
    side = size // hp.patch_size
    assert (hp.img_size, hp.patch_size) == (size, geometry.get("patch_size", 8))
    assert params["pos_embed"].shape == (side * side + 1, 64) and losses[-1] < losses[0]
    out = str(tmp_path / "ft.gguf")
    save_params(out, params, hp, id2label=dict(enumerate(classes)))
    eng = VitEngine(out, device="cpu")
    assert (eng.hp.img_size, eng.hp.patch_size) == (hp.img_size, hp.patch_size)
    dark = np.random.default_rng(0).integers(0, 40, (2, size, size, 3), dtype=np.uint8)
    probs = eng.predict_probs_batch(torch.stack([eng.preprocess_image(im) for im in dark]))
    assert (probs.argmax(-1) == classes.index("aa_dark")).all()
    other = {"img_size": 56} if "img_size" in geometry else {"patch_size": 16}
    with pytest.raises(ValueError, match="would not replay"):
        finetune(base, data, epochs=4, batch=4, lr=1e-3, ckpt_dir=ck, **other, **quiet)
    key = next(iter(geometry))
    with open(ck + ".meta.json") as f:
        meta = json.load(f)
    meta.pop(key)
    with open(ck + ".meta.json", "w") as f:
        json.dump(meta, f)
    flag = "--" + key.replace("_", "-")
    with pytest.raises(ValueError, match=f"predates {flag}"):
        finetune(base, data, epochs=4, batch=4, lr=1e-3, ckpt_dir=ck, **other, **quiet)


def test_finetune_geometry_start_matches_jax(model, tmp_path):
    """One update at patch 4 from the same file: the port's loss is the
    JAX package's finetune loss on its own resampled tree (rtol 1e-4, the
    bound of a train_step loss in test_torch_train.py)."""
    from tests.test_torch_finetune import _make_dataset
    from vit_cpp_tpu.finetune import finetune as jax_finetune
    from vit_cpp_tpu_torch.finetune import finetune

    data = _make_dataset(tmp_path / "train", n_per_class=2)
    kw = dict(epochs=1, batch=4, lr=1e-3, patch_size=4)
    _, hp, _, ours = finetune(model, data, log=lambda m: None, device="cpu", **kw)
    _, jhp, _, theirs = jax_finetune(model, data, log=lambda m: None, **kw)
    assert (hp.img_size, hp.patch_size) == (jhp.img_size, jhp.patch_size) == (32, 4)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
