"""The port's fine-tune loop (vit_cpp_tpu_torch.finetune + cli.finetune):
the dark/bright task of tests/test_finetune.py learns and the head
transfers, the exported gguf is byte-identical to the JAX package's
export of the same weights and serves through the port's engine, resume
is bit-identical, resume with other settings is refused, the CLI runs
end to end, unported flags raise, and the training modules load no JAX.
All on the CPU (the kernels' plain versions) at hidden 64, two layers.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch import decode
from vit_cpp_tpu_torch.finetune import _preprocess_all, evaluate, finetune
from vit_cpp_tpu_torch.models.export import save_params
from vit_cpp_tpu_torch.parallel.train import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda m: None, device="cpu")


def _make_dataset(root, n_per_class=8, size=32, seed=0):
    """Two trivially separable classes: dark images vs bright images."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for cls, lo, hi in (("aa_dark", 0, 40), ("bb_bright", 210, 255)):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(n_per_class):
            img = rng.integers(lo, hi, (size, size, 3), dtype=np.uint8)
            Image.fromarray(img).save(d / f"{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    hp = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                    num_classes=7, patch_size=8, img_size=32)
    p = tmp_path_factory.mktemp("ft") / "m.gguf"
    write_synthetic_model(str(p), hp, ftype=1, seed=4)
    return str(p)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _make_dataset(tmp_path_factory.mktemp("data") / "train")


@pytest.fixture(scope="module")
def trained(model_path, data):
    return finetune(model_path, data, epochs=4, batch=4, lr=1e-3, **QUIET)


def test_learns_and_transfers_the_head(trained, data):
    from vit_cpp_tpu.finetune import load_dataset

    params, hp, classes, losses = trained
    assert classes == ["aa_dark", "bb_bright"]
    assert hp.num_classes == 2 and params["head"]["kernel"].shape == (64, 2)
    assert losses[-1] < losses[0]
    paths, labels, _ = load_dataset(data)
    pixels = _preprocess_all(paths, hp, 1, "cpu")
    assert evaluate(params, hp, pixels, labels, batch=4) >= 0.9


@pytest.mark.parametrize("ftype", [0, 1])
def test_export_is_byte_identical_to_jax_and_serves(trained, data, tmp_path, ftype):
    from vit_cpp_tpu.models.export import save_params as jax_save_params
    from vit_cpp_tpu_torch.engine import VitEngine

    params, hp, classes, _ = trained
    id2label = dict(enumerate(classes))
    ours, theirs = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    save_params(ours, params, hp, id2label=id2label, ftype=ftype)

    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        return tree.detach().numpy()

    jax_save_params(theirs, to_numpy(params), hp, id2label=id2label, ftype=ftype)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    engine = VitEngine(ours, device="cpu")
    assert engine.id2label == {0: "aa_dark", 1: "bb_bright"}
    dark = os.path.join(data, "aa_dark", "0.png")
    bright = os.path.join(data, "bb_bright", "0.png")
    assert engine.classify_file(dark, topk=1)[0][0] == 0
    assert engine.classify_file(bright, topk=1)[0][0] == 1


def test_resume_is_bit_identical(model_path, data, tmp_path):
    kw = dict(batch=4, lr=1e-3, augment="all", ema=0.9, seed=3, **QUIET)
    full, _, _, losses_full = finetune(
        model_path, data, epochs=2, ckpt_dir=str(tmp_path / "a"), **kw
    )
    finetune(model_path, data, epochs=1, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed, _, _, losses_resumed = finetune(
        model_path, data, epochs=2, ckpt_dir=str(tmp_path / "b"), **kw
    )
    assert losses_resumed == losses_full[1:]
    for a, b in zip(tree_leaves(full), tree_leaves(resumed)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="different settings"):
        finetune(model_path, data, epochs=3, ckpt_dir=str(tmp_path / "b"),
                 **dict(kw, lr=2e-3))
    os.remove(str(tmp_path / "b") + ".meta.json")
    with pytest.raises(ValueError, match="cannot be validated"):
        finetune(model_path, data, epochs=3, ckpt_dir=str(tmp_path / "b"), **kw)


def test_freeze_backbone_trains_head_only(model_path, data):
    from vit_cpp_tpu.gguf.reader import read_model
    from vit_cpp_tpu_torch.models.params import load_params

    before = load_params(read_model(model_path))
    params, _, _, _ = finetune(model_path, data, epochs=1, batch=4, lr=1e-2,
                               freeze_backbone=True, **QUIET)
    assert torch.equal(params["blocks"]["qkv"]["kernel"], before["blocks"]["qkv"]["kernel"])
    assert torch.equal(params["pos_embed"], before["pos_embed"])
    assert params["head"]["kernel"].abs().sum() > 0


def test_cli_end_to_end(model_path, data, tmp_path, capsys):
    from vit_cpp_tpu_torch.cli.finetune import main
    from vit_cpp_tpu_torch.engine import VitEngine

    out = str(tmp_path / "ft.gguf")
    rc = main(["-m", model_path, "-d", data, "-o", out, "-b", "4", "--epochs", "2",
               "--lr", "1e-3", "--label-smooth", "0.1", "--mixup", "0.4",
               "--schedule", "cosine", "--warmup-steps", "1", "--clip-norm", "1.0",
               "--ftype", "0", "--val-dir", data, "--device", "cpu"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "epoch 2/2" in err and "val top-1" in err and "ms per update" in err
    assert VitEngine(out, device="cpu").id2label == {0: "aa_dark", 1: "bb_bright"}
    assert main(["-m", model_path, "-d", data, "-o", out, "-b", "64", "--device", "cpu"]) == 1


UNPORTED = [
    ["--mesh", "2x1"], ["--fsdp"], ["--img-size", "64"], ["--patch-size", "4"],
    ["--tome", "2"], ["--moe", "4"], ["--lora", "4"], ["--distill", "t.gguf"],
    ["--qat", "q8_0"], ["--qat-act", "static"], ["--mu-dtype", "bf16"],
    ["--compile-cache"],
]


@pytest.mark.parametrize("flag", UNPORTED, ids=lambda f: f[0])
def test_unported_flags_raise(model_path, data, tmp_path, flag):
    from vit_cpp_tpu_torch.cli.finetune import main

    with pytest.raises(NotImplementedError, match="not ported"):
        main(["-m", model_path, "-d", data, "-o", str(tmp_path / "x.gguf"),
              "--device", "cpu", *flag])


def test_cuda_device_without_a_card_raises(model_path, data):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        finetune(model_path, data, epochs=1, batch=4, log=lambda m: None)


def test_native_decoder_build_is_tried_once(data, monkeypatch):
    import vit_cpp_tpu_torch.native as native
    import vit_cpp_tpu_torch.native.build as native_build

    calls = []

    def failing_build(*a, **k):
        calls.append(1)
        raise RuntimeError("no libjpeg headers")

    monkeypatch.setattr(native_build, "build", failing_build)
    # as on a machine where the build fails: no decoder module loaded yet
    monkeypatch.delitem(sys.modules, "vit_cpp_tpu_torch.native.decoder", raising=False)
    monkeypatch.delattr(native, "decoder", raising=False)
    monkeypatch.setattr(decode, "_native", None)
    paths = sorted(
        os.path.join(data, c, f) for c in os.listdir(data) for f in os.listdir(os.path.join(data, c))
    )
    images = decode.decode_many(paths) + decode.decode_many(paths[:3])
    assert len(calls) == 1
    assert all(im is not None and im.shape == (32, 32, 3) for im in images)


def test_training_modules_import_no_jax():
    code = (
        "import sys\n"
        "import vit_cpp_tpu_torch.finetune, vit_cpp_tpu_torch.cli.finetune\n"
        "import vit_cpp_tpu_torch.parallel.train, vit_cpp_tpu_torch.parallel.checkpoint\n"
        "import vit_cpp_tpu_torch.ops.augment, vit_cpp_tpu_torch.models.export\n"
        "import vit_cpp_tpu_torch.decode\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
