"""The port's `vit-benchmark` harness against the JAX package's.

Both harnesses classify the same tree, `<dataset>/<class>/*.JPEG` with
numpy-made images (one of them unreadable), from the same synthetic
checkpoint (h=64, L=2, 10 classes, 32 px) in f32; the port on the CPU.
The CSV files and the `Top-1 Accuracy:` lines must be equal.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from vit_cpp_tpu.cli import benchmark as jax_benchmark
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.cli import benchmark

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = [f"class_{i}" for i in range(10)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """root/classnames.json beside root/val/<class>/*.JPEG: five class
    folders of 3 images (one of them unreadable), plus a stray file."""
    root = tmp_path_factory.mktemp("bench")
    model = str(root / "m.gguf")
    hp = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                    num_classes=10, patch_size=8, img_size=32)
    write_synthetic_model(model, hp, ftype=1, seed=0,
                          id2label={i: c for i, c in enumerate(CLASSES)})
    (root / "classnames.json").write_text(json.dumps(CLASSES))
    rng = np.random.default_rng(0)
    val = root / "val"
    for c in ("class_1", "class_3", "class_4", "class_7", "class_9"):
        (val / c).mkdir(parents=True)
        for i in range(3):
            img = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
            Image.fromarray(img).save(val / c / f"{i}.JPEG", format="JPEG")
        (val / c / "notes.txt").write_text("not an image")
    (val / "class_3" / "1.JPEG").write_bytes(b"not an image")
    (val / "README").write_text("a stray file")
    return {"model": model, "val": str(val), "root": root}


@pytest.mark.parametrize("per_class,ext", [(0, ".JPEG"), (2, ".JPEG"), (5, ".txt")])
def test_collect_images_matches_jax(tree, per_class, ext):
    got = benchmark.collect_images(tree["val"], per_class, ext)
    assert got == jax_benchmark.collect_images(tree["val"], per_class, ext)
    assert len(got) == {".txt": 5, ".JPEG": 15 if per_class == 0 else 10}[ext]


def test_read_class_names_matches_jax(tree, capsys):
    path = str(tree["root"] / "classnames.json")
    assert benchmark.read_class_names(path) == jax_benchmark.read_class_names(path) == CLASSES
    missing = str(tree["root"] / "missing.json")
    assert benchmark.read_class_names(missing) == jax_benchmark.read_class_names(missing) == []
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1] and err[0].startswith(f"Cannot open file: {missing}")


@pytest.mark.parametrize("batch", [4, 32])
def test_run_eval_matches_jax(tree, capsys, batch):
    """The same CSV and accuracy: the tail batch padded, the unreadable
    file skipped with the JAX harness's message."""
    outs = {}
    for name, run_eval, kw in (("jax", jax_benchmark.run_eval, {}),
                               ("port", benchmark.run_eval, {"device": "cpu"})):
        csv = str(tree["root"] / f"{name}-{batch}.csv")
        acc = run_eval(tree["model"], tree["val"], 0, csv, batch=batch, verbose=False, **kw)
        out, err = capsys.readouterr()
        with open(csv) as f:
            outs[name] = (acc, f.read(), out, [line for line in err.splitlines() if "Failed" in line])
    assert outs["port"] == outs["jax"]
    acc, csv, out, failed = outs["port"]
    rows = [line.split(",") for line in csv.splitlines()]
    assert len(rows) == 14 and all(truth in CLASSES and pred in CLASSES for _, truth, pred in rows)
    assert acc == sum(t == p for _, t, p in rows) / 14
    assert out == f"Top-1 Accuracy: {acc * 100.0}%\n"
    assert failed == [f"Failed to load image from {os.path.join(tree['val'], 'class_3', '1.JPEG')}"]


def test_run_eval_uses_the_bundled_classnames_without_a_sibling(tree, tmp_path, capsys):
    """No classnames.json beside the dataset: both harnesses fall back to
    their bundled copies (byte-identical, 998 entries)."""
    import shutil

    val = tmp_path / "val"
    shutil.copytree(tree["val"], val)
    csvs = []
    for name, run_eval, kw in (("jax", jax_benchmark.run_eval, {}),
                               ("port", benchmark.run_eval, {"device": "cpu"})):
        csv = str(tmp_path / f"{name}.csv")
        run_eval(tree["model"], str(val), 1, csv, batch=4, verbose=False, **kw)
        with open(csv) as f:
            csvs.append(f.read())
    capsys.readouterr()
    assert csvs[0] == csvs[1]
    with open(os.path.join(REPO, "vit_cpp_tpu_torch", "data", "classnames.json")) as f:
        bundled = json.load(f)
    assert len(bundled) == 998
    assert {row.split(",")[2] for row in csvs[1].splitlines()} <= set(bundled[:10])


def test_main_prints_the_jax_tools_accuracy_line(tree, capsys):
    lines = []
    for name, main, extra in (("jax", jax_benchmark.main, []),
                              ("port", benchmark.main, ["--device", "cpu"])):
        csv = str(tree["root"] / f"main-{name}.csv")
        assert main([tree["model"], tree["val"], "2", csv, "--batch", "4", *extra]) == 0
        out, err = capsys.readouterr()
        lines.append(out.splitlines()[-1])
        assert "vit_model_load: hidden_size            = 64" in out
    assert lines[0] == lines[1] and lines[1].startswith("Top-1 Accuracy: ")


def test_run_eval_rejects_a_vitx_artifact(tree, tmp_path, capsys):
    """A JAX-made artifact is refused by name; a port-made one (the f32
    engine exported for the CPU) classifies the tree as the gguf does,
    at its baked batch."""
    from vit_cpp_tpu.aot import MAGIC
    from vit_cpp_tpu_torch.aot import save_engine
    from vit_cpp_tpu_torch.engine import VitEngine

    art = tmp_path / "m.vitx"
    art.write_bytes(MAGIC + b"\x02\0\0\0{}")
    with pytest.raises(ValueError, match="is a .vitx artifact of the JAX package"):
        benchmark.run_eval(str(art), tree["val"], 1, str(tmp_path / "p.csv"), device="cpu")
    port = str(tmp_path / "port.vitx")
    save_engine(VitEngine(tree["model"], device="cpu", verbose=False), port, batch=4)
    got = benchmark.run_eval(port, tree["val"], 0, str(tmp_path / "a.csv"), batch=32,
                             device="cpu", verbose=False)
    want = benchmark.run_eval(tree["model"], tree["val"], 0, str(tmp_path / "g.csv"),
                              batch=4, device="cpu", verbose=False)
    assert got == want
    assert open(tmp_path / "a.csv").read() == open(tmp_path / "g.csv").read()
    assert "compiled for batch 4; using it (ignoring --batch 32)" in capsys.readouterr().err


def test_benchmark_runs_on_the_card_by_default(tree, tmp_path):
    if torch.cuda.is_available():  # decided here, not at import
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        benchmark.main([tree["model"], tree["val"], "1", str(tmp_path / "p.csv")])
