"""The port stands alone: nothing in vit_cpp_tpu_torch or chip_smoke.py
imports JAX or the JAX package (vit_cpp_tpu), at module level or inside a
function, and the port's own copies of that package's JAX-free modules
give the same results: the synthetic writer writes the same bytes, the
reader returns the same hparams and records, images decode to the same
pixels, and load_dataset, model_spec and is_vitx agree. All on the CPU.
"""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from vit_cpp_tpu.cli.common import model_spec as jax_model_spec
from vit_cpp_tpu.finetune import load_dataset as jax_load_dataset
from vit_cpp_tpu.gguf.reader import read_model as jax_read_model
from vit_cpp_tpu.hparams import VitHParams as JaxHParams
from vit_cpp_tpu.server import decode_rgb_from_bytes as jax_decode
from vit_cpp_tpu.testing.synthetic import write_synthetic_model as jax_write
from vit_cpp_tpu_torch.cli.common import is_vitx, model_spec
from vit_cpp_tpu_torch.finetune import load_dataset
from vit_cpp_tpu_torch.gguf.reader import read_model
from vit_cpp_tpu_torch.hparams import VitHParams
from vit_cpp_tpu_torch.server import decode_rgb_from_bytes
from vit_cpp_tpu_torch.testing.synthetic import write_synthetic_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "vit_cpp_tpu_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]
ASSETS = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(REPO, "assets", "*"))
    if os.path.isfile(p)
)
BLOCKED = ("jax", "vit_cpp_tpu")
GEOMETRY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                num_classes=7, patch_size=8, img_size=32)

_IMPORT_ALL = r"""
import importlib, importlib.machinery, pkgutil, sys
sys.modules["jax"] = None  # any import of either now raises ImportError
sys.modules["vit_cpp_tpu"] = None
import vit_cpp_tpu_torch
# Python modules only: the native decoder's built library is no module
names = [m.name for m in pkgutil.walk_packages(vit_cpp_tpu_torch.__path__, "vit_cpp_tpu_torch.")
         if not isinstance(m.module_finder.find_spec(m.name.rpartition(".")[2]).loader,
                           importlib.machinery.ExtensionFileLoader)]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its main() is not called
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "vit_cpp_tpu") and sys.modules[k] is not None)
assert not loaded, loaded
print(len(names), "modules imported")
"""


def test_every_port_module_and_chip_smoke_import_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "modules imported" in proc.stdout


@pytest.mark.parametrize("source", SOURCES)
def test_source_has_no_import_of_jax_or_the_jax_package(source):
    """Every import statement of the file, inside functions too."""
    with open(os.path.join(REPO, source)) as f:
        tree = ast.parse(f.read(), filename=source)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names if n.split(".")[0] in BLOCKED]
    assert not found, f"{source} imports {found}"


@pytest.mark.parametrize("ftype", [0, 1])
def test_synthetic_writer_is_byte_identical(tmp_path, ftype):
    ours, theirs = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    state = write_synthetic_model(ours, VitHParams(**GEOMETRY), ftype=ftype, seed=3)
    want = jax_write(theirs, JaxHParams(**GEOMETRY), ftype=ftype, seed=3)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    assert state.keys() == want.keys()
    assert all(np.array_equal(state[k], want[k]) for k in state)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """An f16 synthetic file, its Q8_0 rewrite by the port's quantizer and
    the same weights in the real-GGUF container."""
    from vit_cpp_tpu.gguf.gguf_real import write_gguf
    from vit_cpp_tpu.testing.synthetic import random_state_dict, state_dict_records
    from vit_cpp_tpu_torch.cli.quantize import quantize_model_file

    d = tmp_path_factory.mktemp("iso")
    f16, q8, real = str(d / "m.gguf"), str(d / "m-q8_0.gguf"), str(d / "m-real.gguf")
    hp = JaxHParams(**GEOMETRY)
    jax_write(f16, hp, ftype=1, seed=5)
    quantize_model_file(f16, q8, 8, verbose=False)
    labels = {i: f"class {i}" for i in range(hp.num_classes)}
    write_gguf(real, hp, labels, state_dict_records(random_state_dict(hp, seed=5), 1), 1)
    return {"f16": f16, "q8_0": q8, "gguf": real}


@pytest.mark.parametrize("which", ["f16", "q8_0", "gguf"])
def test_reader_returns_the_same_hparams_and_records(checkpoints, which):
    ours, theirs = read_model(checkpoints[which]), jax_read_model(checkpoints[which])
    assert dataclasses.asdict(ours.hparams) == dataclasses.asdict(theirs.hparams)
    assert ours.id2label == theirs.id2label and ours.qntvr == theirs.qntvr
    assert list(ours.tensors) == list(theirs.tensors)
    for name, rec in ours.tensors.items():
        other = theirs.tensors[name]
        assert (rec.shape, int(rec.dtype)) == (other.shape, int(other.dtype)), name
        assert rec.data.dtype == other.data.dtype and np.array_equal(rec.data, other.data), name
        # a quantized record decodes with the port's own codec
        assert np.array_equal(rec.as_f32(), other.as_f32()), name


@pytest.mark.parametrize("asset", ASSETS)
def test_image_decode_gives_equal_pixels(asset):
    with open(os.path.join(REPO, "assets", asset), "rb") as f:
        data = f.read()
    ours, theirs = decode_rgb_from_bytes(data), jax_decode(data)
    assert ours is not None and ours.dtype == np.uint8 and ours.ndim == 3
    assert np.array_equal(ours, theirs)


def test_undecodable_bytes_give_none():
    assert decode_rgb_from_bytes(b"not an image") is None
    assert jax_decode(b"not an image") is None


def test_load_dataset_agrees(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for cls in ("b_cls", "a_cls", "c_empty_of_images"):
        (tmp_path / cls).mkdir()
    for cls, n in (("a_cls", 3), ("b_cls", 2)):
        for i in range(n):
            img = rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
            Image.fromarray(img).save(tmp_path / cls / f"{i}.png")
    (tmp_path / "a_cls" / "notes.txt").write_text("not an image")
    (tmp_path / "c_empty_of_images" / "x.csv").write_text("1,2")
    paths, labels, classes = load_dataset(str(tmp_path))
    want = jax_load_dataset(str(tmp_path))
    assert paths == want[0] and classes == want[2]
    assert labels.dtype == want[1].dtype and np.array_equal(labels, want[1])
    with pytest.raises(ValueError, match="no class subdirectories"):
        load_dataset(str(tmp_path / "a_cls"))


@pytest.mark.parametrize("spec", [
    "model.gguf", "name=path.gguf", "./name=x.gguf", "dir=a/b.gguf", "=x", "name=", "a/b=c",
])
def test_model_spec_agrees(spec):
    assert model_spec(spec) == jax_model_spec(spec)


def test_is_vitx_agrees(tmp_path, checkpoints):
    from vit_cpp_tpu.aot import MAGIC, is_vitx as jax_is_vitx

    art = tmp_path / "a.vitx"
    art.write_bytes(MAGIC + b"\0" * 8)
    for p in (str(art), checkpoints["f16"], str(tmp_path / "missing")):
        assert is_vitx(p) == jax_is_vitx(p)
    assert is_vitx(str(art))
