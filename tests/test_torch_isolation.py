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


# a V-MoE geometry too: E=4 experts in layers 1 and 3, top-2, and the
# meta.moe marker (routers stay f32 at ftype 1)
MOE = dict(GEOMETRY, num_hidden_layers=4, num_experts=4, moe_layers=(1, 3), moe_top_k=2)


@pytest.mark.parametrize("ftype,geometry", [(0, GEOMETRY), (1, GEOMETRY), (0, MOE), (1, MOE)],
                         ids=["0", "1", "moe-0", "moe-1"])
def test_synthetic_writer_is_byte_identical(tmp_path, ftype, geometry):
    ours, theirs = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    state = write_synthetic_model(ours, VitHParams(**geometry), ftype=ftype, seed=3)
    want = jax_write(theirs, JaxHParams(**geometry), ftype=ftype, seed=3)
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
    """One copy of the header readers, the port's aot.py (cli/common.py
    imports them), with the JAX module's magic and answers."""
    from vit_cpp_tpu.aot import MAGIC, is_vitx as jax_is_vitx
    from vit_cpp_tpu_torch import aot
    from vit_cpp_tpu_torch.cli import common

    assert aot.MAGIC == MAGIC
    assert common.is_vitx is aot.is_vitx and common.read_meta is aot.read_meta
    art = tmp_path / "a.vitx"
    art.write_bytes(MAGIC + b"\0" * 8)
    for p in (str(art), checkpoints["f16"], str(tmp_path / "missing")):
        assert is_vitx(p) == jax_is_vitx(p)
    assert is_vitx(str(art))


@pytest.mark.parametrize("module", ["vit_cpp_tpu_torch/aot.py",
                                    "vit_cpp_tpu_torch/cli/export_aot.py"])
def test_the_aot_modules_are_checked(module):
    """The artifact modules are among the sources whose imports are
    checked above and that the isolated process imports."""
    assert module in SOURCES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_state_dict_is_the_ports_own_copy(dtype):
    """models/params.py::params_from_state_dict is the port's own (built on
    the port's reader records and loader) and builds the JAX function's
    tree from the port's copy of random_state_dict."""
    import jax.numpy as jnp
    import torch

    from vit_cpp_tpu.models.params import params_from_state_dict as jax_from_state
    from vit_cpp_tpu_torch.models import params as port_params
    from vit_cpp_tpu_torch.testing.synthetic import random_state_dict

    fn = port_params.params_from_state_dict
    assert fn.__module__ == "vit_cpp_tpu_torch.models.params"
    state = random_state_dict(VitHParams(**GEOMETRY), seed=7)
    got = fn(state, VitHParams(**GEOMETRY), dtype=getattr(torch, dtype))
    want = port_params.params_from_jax(jax_from_state(state, JaxHParams(**GEOMETRY),
                                                      dtype=getattr(jnp, dtype)))

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for n, sub in tree.items() for k, v in flat(sub, f"{prefix}{n}.").items()}
        return {prefix[:-1]: tree}

    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) and got[k].dtype == want[k].dtype for k in got)


def test_bundled_classnames_are_byte_identical():
    ours = os.path.join(REPO, "vit_cpp_tpu_torch", "data", "classnames.json")
    theirs = os.path.join(REPO, "vit_cpp_tpu", "data", "classnames.json")
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_quick_example_writer_is_byte_identical(tmp_path):
    from vit_cpp_tpu.testing.synthetic import write_quick_example_model as jax_quick
    from vit_cpp_tpu_torch.testing.synthetic import write_quick_example_model

    ours, theirs = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    hp, want = write_quick_example_model(ours), jax_quick(theirs)
    assert dataclasses.asdict(hp) == dataclasses.asdict(want)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("case", ["ok", "bad-magic", "short-header", "short-meta", "bad-json"])
def test_read_meta_agrees(tmp_path, case):
    from vit_cpp_tpu.aot import MAGIC, read_meta as jax_read_meta
    from vit_cpp_tpu_torch.aot import read_meta

    meta = b'{"format": 1, "batch": 8, "platforms": ["cpu"]}'
    data = {
        "ok": MAGIC + len(meta).to_bytes(4, "little") + meta + b"\0" * 32,
        "bad-magic": b"GGUF" + b"\0" * 16,
        "short-header": MAGIC + b"\x01",
        "short-meta": MAGIC + (len(meta) + 9).to_bytes(4, "little") + meta,
        "bad-json": MAGIC + (5).to_bytes(4, "little") + b"{not",
    }[case]
    path = tmp_path / "a.vitx"
    path.write_bytes(data)
    results = []
    for fn in (read_meta, jax_read_meta):
        try:
            results.append(("ok", fn(str(path))))
        except ValueError as e:
            results.append(("ValueError", str(e)))
    assert results[0] == results[1]
    assert results[0][0] == ("ok" if case == "ok" else "ValueError")


@pytest.mark.parametrize("native", [True, False], ids=["native", "pil-only"])
def test_batch_image_load_agrees(tmp_path, monkeypatch, native):
    """The threaded batch decode with its PIL retry: equal pixels on the
    images of assets/, and None where neither package reads a file. Where
    the native decoder cannot be built (pil-only), every file takes the
    threaded PIL path and matches the JAX package's PIL decode."""
    from vit_cpp_tpu.io.image import load_image_rgb as jax_load_one
    from vit_cpp_tpu.io.image import load_images_rgb_batch as jax_load
    from vit_cpp_tpu_torch import decode
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch

    bad = tmp_path / "broken.jpg"
    bad.write_bytes(b"\xff\xd8 not a jpeg")
    paths = [os.path.join(REPO, "assets", a) for a in ASSETS]
    paths.insert(1, str(bad))
    theirs = jax_load(paths, n_threads=2)
    if not native:
        monkeypatch.setattr(decode, "_native", False)  # as after a failed build
        theirs = [None if im is None else jax_load_one(p, prefer_native=False)
                  for p, im in zip(paths, theirs)]
    ours = load_images_rgb_batch(paths, n_threads=2)
    assert [im is None for im in ours] == [im is None for im in theirs]
    assert [im is None for im in ours].count(True) == 1 and ours[1] is None
    for a, b in zip(ours, theirs):
        if a is not None:
            assert a.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("asset", ["magpie.jpeg", "image.png"])
def test_single_image_load_agrees(asset):
    from vit_cpp_tpu.io.image import load_image_rgb as jax_load
    from vit_cpp_tpu_torch.io.image import load_image_rgb

    path = os.path.join(REPO, "assets", asset)
    for prefer_native in (True, False):
        assert np.array_equal(load_image_rgb(path, prefer_native=prefer_native),
                              jax_load(path, prefer_native=prefer_native))


def test_import_scan_covers_the_serving_workflow_modules():
    """The scans above reach the converter, the calibrator, the sidecar
    and the ViTSTR vocabulary (pkgutil walks them; the AST scan lists
    them)."""
    for module in ("cli/convert.py", "quant/calibrate.py", "quant/qat.py", "models/vitstr.py",
                   "gguf/gguf_real.py", "server.py", "cli/server.py"):
        assert os.path.join("vit_cpp_tpu_torch", module) in SOURCES


@pytest.mark.parametrize("extra", [None, {"general.name": "vit", "n": 3, "x": 0.5, "ok": True}])
def test_write_gguf_is_byte_identical(tmp_path, extra):
    from vit_cpp_tpu.gguf.gguf_real import write_gguf as jax_write_gguf
    from vit_cpp_tpu.testing.synthetic import random_state_dict, state_dict_records
    from vit_cpp_tpu_torch.gguf.gguf_real import write_gguf

    hp = JaxHParams(**GEOMETRY)
    state = random_state_dict(hp, seed=9)
    labels = {i: f"class {i}" for i in range(hp.num_classes)}
    ours, theirs = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    write_gguf(ours, VitHParams(**GEOMETRY), labels, state_dict_records(state, 1), 1,
               extra_metadata=extra)
    jax_write_gguf(theirs, hp, labels, state_dict_records(state, 1), 1, extra_metadata=extra)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_import_scan_covers_the_model_family_modules():
    """The scans above reach the modules of the model families: ViTSTR,
    the geometry resampler, attention maps and their command lines."""
    for module in ("models/vitstr.py", "models/resample.py", "models/attention_maps.py",
                   "cli/vitstr.py", "cli/explain.py", "serve.py", "engine.py"):
        assert os.path.join("vit_cpp_tpu_torch", module) in SOURCES


def test_import_scan_covers_the_tome_modules():
    """The scans above reach ToMe and token padding: the merge, the
    forward and composed attention that take it, the engine and the front
    ends that pass it on, and the training path."""
    for module in ("ops/tome.py", "ops/core.py", "models/vit.py", "engine.py", "cli/common.py",
                   "cli/serve.py", "cli/server.py", "cli/finetune.py", "parallel/train.py",
                   "finetune.py"):
        assert os.path.join("vit_cpp_tpu_torch", module) in SOURCES


def test_import_scan_covers_the_mesh_modules():
    """The scans above reach the multi-device layer: the mesh, the specs
    and placement, the CPU-rank test harness, and the modules that thread
    the mesh through serving and training."""
    for module in ("parallel/mesh.py", "parallel/sharding.py", "testing/distributed.py",
                   "parallel/checkpoint.py", "server.py", "ops/moe.py", "models/lora.py"):
        assert os.path.join("vit_cpp_tpu_torch", module) in SOURCES


def test_quick_example_vitstr_writer_is_byte_identical(tmp_path):
    from vit_cpp_tpu.testing.synthetic import write_quick_example_vitstr_model as jax_quick
    from vit_cpp_tpu_torch.testing.synthetic import write_quick_example_vitstr_model

    ours, theirs = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    hp, want = write_quick_example_vitstr_model(ours), jax_quick(theirs)
    assert dataclasses.asdict(hp) == dataclasses.asdict(want)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


def test_vitstr_constants_are_the_jax_packages():
    from vit_cpp_tpu.models import vitstr as jax_vitstr
    from vit_cpp_tpu_torch.models import vitstr

    assert (vitstr.VITSTR_SEQ_LEN, vitstr.GO_ID, vitstr.EOS_ID) == (
        jax_vitstr.VITSTR_SEQ_LEN, jax_vitstr.GO_ID, jax_vitstr.EOS_ID) == (25, 0, 1)


def test_vitstr_vocabulary_is_the_jax_packages():
    from vit_cpp_tpu.models.vitstr import VITSTR_VOCAB as JAX_VOCAB
    from vit_cpp_tpu.models.vitstr import vitstr_id2label as jax_id2label
    from vit_cpp_tpu_torch.models.vitstr import VITSTR_VOCAB, vitstr_id2label

    assert VITSTR_VOCAB == JAX_VOCAB and len(VITSTR_VOCAB) == 96
    assert vitstr_id2label() == jax_id2label()


def test_act_scales_sidecar_is_byte_identical(tmp_path):
    import jax.numpy as jnp
    import torch

    from vit_cpp_tpu.quant.qat import save_act_scales as jax_save
    from vit_cpp_tpu_torch.quant.qat import save_act_scales

    rng = np.random.default_rng(4)
    scales = {k: (rng.random((3, 1, 1)) * 0.05).astype(np.float32)
              for k in ("qkv", "proj", "fc1", "fc2")}
    scales["head"] = np.array([[0.0271]], np.float32)
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    save_act_scales(ours, {k: torch.from_numpy(v) for k, v in scales.items()}, 1.05)
    jax_save(theirs, {k: jnp.asarray(v) for k, v in scales.items()}, 1.05)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
