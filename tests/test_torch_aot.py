"""The port's AOT serving artifacts (vit_cpp_tpu_torch/aot.py) against the
JAX package's (vit_cpp_tpu/aot.py), on the CPU.

Each configuration is exported by both packages from the same tiny
synthetic gguf (h=64, 2 layers; inputs from a numpy seed): the port's
artifact with `--device cpu` (torch.export, the kernels as operators
whose CPU implementation is the plain version), the JAX one with
`jax.export` (Pallas in interpret mode). Tolerances, the port engine's
own bounds against the JAX engine (tests/test_torch_engine.py):

    f32, composed or fused attention, dense or Q8_0 matmuls  1e-5
    f32 W8A8 (dynamic or static scales): an int8 activation code can
      flip where the two packages' f32 sums straddle a rounding boundary
                                                             1e-4
    bf16 W8A8 + fold (the serving defaults): bf16 intermediates round at
      other places                                           2e-2

and the port's artifact equals its own VitEngine within 1e-5. The front
ends (vit, vitstr, vit-serve, vit-server, vit-benchmark, vit-inspect,
vit-export --info) run in process beside the JAX ones, as the other
test_torch_* CLI tests do.
"""

import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_cpp_tpu import aot as jax_aot
from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
from vit_cpp_tpu.engine import VitstrEngine as JaxVitstrEngine
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch import aot
from vit_cpp_tpu_torch.engine import VitEngine, VitstrEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  num_classes=7, patch_size=8, img_size=32)
SELF_TOL = 1e-5
F32_TOL = 1e-5
INT8_TOL = 1e-4
BF16_TOL = 2e-2

# name: (file, engine kwargs shared by both packages, tolerance vs JAX)
CONFIGS = {
    "int8-fold-bf16": ("f16", dict(dtype="bf16", mm_impl="int8", attn_impl="pallas-fast",
                                   fold_ln=True), BF16_TOL),
    "xla-f32": ("f16", dict(dtype="f32", mm_impl="xla", attn_impl="xla"), F32_TOL),
    "q8-pallas-f32": ("q8", dict(dtype="f32", mm_impl="pallas", attn_impl="pallas-fast"),
                      F32_TOL),
    "features": ("headless", dict(dtype="f32", mm_impl="xla", attn_impl="pallas"), F32_TOL),
    "vitstr": ("vitstr", dict(dtype="f32", mm_impl="xla", attn_impl="pallas-fast"), F32_TOL),
    "tome": ("f16", dict(dtype="f32", mm_impl="xla", attn_impl="pallas", tome=2), F32_TOL),
    "static": ("f16", dict(dtype="f32", mm_impl="int8", attn_impl="xla",
                           act_quant="static"), INT8_TOL),
    "moe": ("moe", dict(dtype="f32", mm_impl="xla", attn_impl="pallas-fast"), F32_TOL),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from vit_cpp_tpu_torch.cli.quantize import quantize_model_file

    d = tmp_path_factory.mktemp("aot")
    out = {k: str(d / f"{k}.gguf") for k in ("f16", "q8", "headless", "vitstr", "moe")}
    out["dir"] = d
    write_synthetic_model(out["f16"], TINY, ftype=1, seed=11,
                          id2label={i: f"class_{i}" for i in range(7)})
    assert quantize_model_file(out["f16"], out["q8"], 8, verbose=False)
    write_synthetic_model(out["headless"], dataclasses.replace(TINY, num_classes=0),
                          ftype=1, seed=3)
    from vit_cpp_tpu.models.vitstr import vitstr_id2label

    write_synthetic_model(out["vitstr"], dataclasses.replace(
        TINY, in_chans=1, seq_len=25, num_classes=96, img_size=48), ftype=1, seed=5,
        id2label=vitstr_id2label())
    write_synthetic_model(out["moe"], dataclasses.replace(
        TINY, num_experts=4, moe_layers=(1,), moe_top_k=2, moe_capacity=1.25),
        ftype=1, seed=4)
    rng = np.random.default_rng(1)
    imgs = []
    for i in range(3):
        p = str(d / f"i{i}.png")
        Image.fromarray(rng.integers(0, 256, (30 + i, 40, 3), dtype=np.uint8)).save(p)
        imgs.append(p)
    out["imgs"] = imgs
    return out


def _pixels(n, hp, seed=0):
    if hp.in_chans == 3 and hp.seq_len is None:
        from tests.test_torch_calibrate import structured_images

        return structured_images(n, seed=seed, size=hp.img_size)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, hp.in_chans, hp.img_size, hp.img_size)).astype(np.float32)


def _engines(path, kw):
    """(port VitEngine on the CPU, JAX VitEngine) with the same knobs;
    static scales calibrated on the same images."""
    hp = JaxVitEngine(path, verbose=False).hp
    vitstr = hp.seq_len is not None
    jkw = {**kw, "dtype": jnp.float32 if kw["dtype"] == "f32" else jnp.bfloat16}
    port = (VitstrEngine if vitstr else VitEngine)(path, device="cpu", verbose=False, **kw)
    jax_engine = (JaxVitstrEngine if vitstr else JaxVitEngine)(path, verbose=False, **jkw)
    if kw.get("act_quant") == "static":
        x = _pixels(8, hp, seed=21)
        port.calibrate(torch.from_numpy(x))
        jax_engine.calibrate(jnp.asarray(x))
    return port, jax_engine


def _run(engine, x):
    if engine.meta.get("program") == "features":
        return engine.features_batch(x)
    return engine.predict_probs_batch(x)


def _targets(aot_engine, b):
    return [str(n.target) for n in aot_engine._programs[b].graph.nodes
            if n.op == "call_function"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_artifact_matches_jax_and_its_own_engine(files, tmp_path, name):
    which, kw, tol = CONFIGS[name]
    port, jax_engine = _engines(files[which], kw)
    meta = aot.save_engine(port, str(tmp_path / "p.vitx"), batch=[1, 2])
    jax_aot.save_engine(jax_engine, str(tmp_path / "j.vitx"), batch=2)
    got_engine = aot.AotEngine(str(tmp_path / "p.vitx"), device="cpu")
    want_engine = jax_aot.AotEngine(str(tmp_path / "j.vitx"))
    assert got_engine.batches == [1, 2] and got_engine.hp == port.hp
    x = _pixels(2, port.hp, seed=3)
    got = _run(got_engine, torch.from_numpy(x)).float().numpy()
    want = np.asarray(_run(want_engine, jnp.asarray(x)), np.float32)
    own = (port.features_batch if meta.get("program") else port.predict_probs_batch)(
        torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, own, atol=SELF_TOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    # the JAX meta keys, and the port's two
    jax_meta = jax_aot.read_meta(str(tmp_path / "j.vitx"))
    assert set(jax_meta) - {"platforms"} <= set(meta) - {"format", "matmul_precision"}
    assert meta["format"] == "torch.export" and meta["platforms"] == ["torch-cpu"]
    assert meta["matmul_precision"] == port.matmul_precision
    for key in ("attn_impl", "mm_impl", "program", "tome", "act", "id2label"):
        assert meta.get(key) == jax_meta.get(key), key
    want_act = kw.get("act_quant", "dynamic") if kw["mm_impl"] == "int8" else None
    assert meta.get("act") == want_act
    assert {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hparams"].items()} \
        == {k: tuple(v) if isinstance(v, list) else v for k, v in jax_meta["hparams"].items()}


@pytest.mark.parametrize("name,op,plain_op,count", [
    ("int8-fold-bf16", "vit_cpp_tpu_torch.attention_qkv.default", "aten.exp2.default", 2),
    ("q8-pallas-f32", "vit_cpp_tpu_torch.dequant_matmul.default",
     "aten.repeat_interleave.self_Tensor", 2 * 4 + 1),
    ("tome", "vit_cpp_tpu_torch.highest_product.default", None, 2 * 2),
])
def test_the_kernels_are_nodes_of_the_program(files, tmp_path, name, op, plain_op, count):
    """The exported graph calls the kernel operators, one node per call
    (2 layers: 2 attention_qkv; 4 linears per layer and the head through
    dequant_matmul), and none of their plain versions' aten ops; ToMe's
    exact-f32 products are operators too, one each for the metric and
    the matching per layer."""
    which, kw, _ = CONFIGS[name]
    port, _ = _engines(files[which], kw)
    aot.save_engine(port, str(tmp_path / "p.vitx"), batch=2)
    targets = _targets(aot.AotEngine(str(tmp_path / "p.vitx"), device="cpu"), 2)
    assert targets.count(op) == count
    if plain_op is not None:
        assert not any(t.startswith(plain_op.rsplit(".", 1)[0]) for t in targets)
    if kw["attn_impl"].startswith("pallas"):
        assert targets.count("vit_cpp_tpu_torch.attention_qkv.default") == 2


@pytest.fixture(scope="module")
def artifacts(files, tmp_path_factory):
    """The f16 file exported by both packages at their defaults on the
    CPU path (f32, composed attention, dense), -b 1,2 and -b 2; a
    headless and a ViTSTR artifact of each."""
    d = tmp_path_factory.mktemp("arts")
    out = {}
    for which, batches in (("f16", [1, 2]), ("headless", [2]), ("vitstr", [1, 2])):
        port, jax_engine = _engines(files[which], dict(dtype="f32", mm_impl="xla",
                                                       attn_impl="xla"))
        out[f"port-{which}"] = str(d / f"port-{which}.vitx")
        out[f"jax-{which}"] = str(d / f"jax-{which}.vitx")
        aot.save_engine(port, out[f"port-{which}"], batch=batches)
        jax_aot.save_engine(jax_engine, out[f"jax-{which}"], batch=batches)
    port, _ = _engines(files["f16"], dict(dtype="f32", mm_impl="xla", attn_impl="xla"))
    out["port-b2"] = str(d / "port-b2.vitx")
    aot.save_engine(port, out["port-b2"], batch=2)
    return out


def _same_error(port_call, jax_call, match=None):
    with pytest.raises(ValueError) as ours:
        port_call()
    with pytest.raises(ValueError) as theirs:
        jax_call()
    if match is None:
        assert str(ours.value) == str(theirs.value)
    else:
        assert match in str(ours.value) and match in str(theirs.value)
    return str(ours.value)


def _rewrite_meta(src, dst, edit):
    with open(src, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<I", data, len(aot.MAGIC))
    off = len(aot.MAGIC) + 4
    meta = json.loads(data[off : off + n])
    edit(meta)
    mj = json.dumps(meta).encode()
    with open(dst, "wb") as f:
        f.write(aot.MAGIC + struct.pack("<I", len(mj)) + mj + data[off + n :])
    return str(dst)


@pytest.mark.parametrize("case", ["wrong-batch", "multi-batch", "bad-magic", "cut-header",
                                  "cut-meta", "cut-blobs", "features-vs-classifier",
                                  "sequence-head", "classifier-not-vitstr"])
def test_errors_are_the_jax_ones(artifacts, files, tmp_path, case):
    """Each misuse of an artifact fails as the JAX AotEngine fails, with
    the same message."""
    jax_cls = jax_aot.AotEngine

    def load(key):
        return aot.AotEngine(artifacts[f"port-{key}"], device="cpu"), jax_cls(artifacts[f"jax-{key}"])

    if case in ("wrong-batch", "multi-batch"):
        key, n = ("f16", 3) if case == "multi-batch" else ("headless", 3)
        p, j = load(key)
        run = "features_batch" if key == "headless" else "predict_probs_batch"
        msg = _same_error(lambda: getattr(p, run)(torch.zeros(n, 3, 32, 32)),
                          lambda: getattr(j, run)(jnp.zeros((n, 3, 32, 32))))
        assert ("batches 1/2" if case == "multi-batch" else "compiled for batch 2") in msg
    elif case == "bad-magic":
        junk = tmp_path / "junk.vitx"
        junk.write_bytes(b"not an artifact")
        _same_error(lambda: aot.AotEngine(str(junk), device="cpu"), lambda: jax_cls(str(junk)))
        _same_error(lambda: aot.read_meta(str(junk)), lambda: jax_aot.read_meta(str(junk)))
    elif case in ("cut-header", "cut-meta", "cut-blobs"):
        data = open(artifacts["port-f16"], "rb").read()
        cut = tmp_path / "cut.vitx"
        cut.write_bytes({"cut-header": aot.MAGIC + b"\x00",
                         "cut-meta": data[: len(aot.MAGIC) + 4 + 10],
                         "cut-blobs": data[:-100]}[case])
        if case == "cut-blobs":
            with pytest.raises(ValueError, match="do not cover"):
                aot.AotEngine(str(cut), device="cpu")
            return
        _same_error(lambda: aot.AotEngine(str(cut), device="cpu"), lambda: jax_cls(str(cut)))
        _same_error(lambda: aot.read_meta(str(cut)), lambda: jax_aot.read_meta(str(cut)))
    elif case == "features-vs-classifier":
        p, j = load("headless")
        _same_error(lambda: p.predict_probs_batch(torch.zeros(2, 3, 32, 32)),
                    lambda: j.predict_probs_batch(jnp.zeros((2, 3, 32, 32))))
        _same_error(lambda: p.classify_file(files["imgs"][0]),
                    lambda: j.classify_file(files["imgs"][0]))
        p, j = load("f16")
        _same_error(lambda: p.features_batch(torch.zeros(2, 3, 32, 32)),
                    lambda: j.features_batch(jnp.zeros((2, 3, 32, 32))))
    elif case == "sequence-head":
        p, j = load("vitstr")
        _same_error(lambda: p.classify_file(files["imgs"][0]),
                    lambda: j.classify_file(files["imgs"][0]))
    else:
        p, j = load("f16")
        _same_error(lambda: p.recognize_file(files["imgs"][0]),
                    lambda: j.recognize_file(files["imgs"][0]))


def test_hparams_compat_and_platforms(files, artifacts, tmp_path):
    """A standard geometry omits mlp_hidden; a newer writer's unknown
    hparam is dropped; an artifact of another device fails at load with
    the JAX package's "exported for platforms" message; a card artifact
    needs a card; export for a platform the port cannot lower for is
    refused."""
    meta = aot.read_meta(artifacts["port-f16"])
    assert "mlp_hidden" not in meta["hparams"]
    future = _rewrite_meta(artifacts["port-f16"], tmp_path / "future.vitx",
                           lambda m: m["hparams"].update(field_from_the_future=7))
    assert aot.AotEngine(future, device="cpu").hp.hidden_size == 64
    with pytest.raises(ValueError, match="exported for platforms"):
        aot.AotEngine(artifacts["port-f16"], device="meta")
    card = _rewrite_meta(artifacts["port-f16"], tmp_path / "card.vitx",
                         lambda m: m.update(platforms=["torch-cuda"]))
    with pytest.raises(ValueError, match=r"exported for platforms \['torch-cuda'\]"):
        aot.AotEngine(card, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="torch.cuda.is_available"):
            aot.AotEngine(card)
    engine = VitEngine(files["f16"], device="cpu", verbose=False)
    for bad in (["tpu"], ["cpu", "tpu"], ["torch-cuda"]):
        with pytest.raises(ValueError, match="cannot lower"):
            aot.export_engine(engine, 1, platforms=bad)
    out = str(tmp_path / "c.vitx")
    aot.save_engine(engine, out, batch=1, platforms=["cpu"])
    assert aot.read_meta(out)["platforms"] == ["torch-cpu"]


def test_refusals_both_ways(artifacts, tmp_path):
    """The JAX read_meta reads a port header as the port does; the JAX
    AotEngine refuses a port artifact at its platform check (it never
    deserializes torch bytes); the port refuses a JAX artifact, and a
    JAX sharded one, by name."""
    port = artifacts["port-f16"]
    assert jax_aot.read_meta(port) == aot.read_meta(port)
    assert jax_aot.is_vitx(port) and aot.is_vitx(artifacts["jax-f16"])
    with pytest.raises(ValueError, match=r"exported for platforms \['torch-cpu'\]"):
        jax_aot.AotEngine(port)
    sharded = _rewrite_meta(artifacts["jax-f16"], tmp_path / "mesh.vitx", lambda m: m.update(
        mesh={"axis_names": ["data", "model"], "axis_sizes": [2, 1]}))
    for path in (artifacts["jax-f16"], sharded):
        with pytest.raises(ValueError, match=r"of the JAX package \(vit_cpp_tpu\).*"
                                             r"vit_cpp_tpu_torch\.cli\.export_aot"):
            aot.AotEngine(path, device="cpu")


_NO_MODEL_CODE = r"""
import sys
for name in ("jax", "vit_cpp_tpu", "vit_cpp_tpu_torch.models.vit",
             "vit_cpp_tpu_torch.models.params", "vit_cpp_tpu_torch.engine"):
    sys.modules[name] = None
import numpy as np, torch
from vit_cpp_tpu_torch.aot import AotEngine
from vit_cpp_tpu_torch.serve import serve_files
engine = AotEngine(sys.argv[1], device="cpu")
x = torch.from_numpy(np.load(sys.argv[2]))
np.save(sys.argv[3], engine.predict_probs_batch(x).numpy())
print(len(list(serve_files(engine, sys.argv[4:], batch=engine.batch))))
"""


def test_serves_without_model_code_or_gguf(files, tmp_path):
    """A process that cannot import models/vit.py, models/params.py,
    engine.py, jax or the JAX package serves the artifact, the gguf it
    came from moved away, with the live engine's probabilities."""
    gguf = str(tmp_path / "m.gguf")
    with open(files["q8"], "rb") as src, open(gguf, "wb") as dst:
        dst.write(src.read())
    engine = VitEngine(gguf, device="cpu", verbose=False, mm_impl="pallas",
                       attn_impl="pallas-fast")
    art = str(tmp_path / "m.vitx")
    aot.save_engine(engine, art, batch=2)
    os.rename(gguf, gguf + ".moved")
    x = _pixels(2, engine.hp, seed=5)
    np.save(tmp_path / "x.npy", x)
    r = subprocess.run([sys.executable, "-c", _NO_MODEL_CODE, art, str(tmp_path / "x.npy"),
                        str(tmp_path / "p.npy"), *files["imgs"]],
                       capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["3"]
    np.testing.assert_allclose(np.load(tmp_path / "p.npy"),
                               engine.predict_probs_batch(torch.from_numpy(x)).numpy(),
                               atol=SELF_TOL, rtol=0)


def _run_main(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("which", ["f16", "vitstr"])
def test_single_image_clis_on_an_artifact(files, artifacts, capsys, which):
    """`vit -m m.vitx` and `vitstr -m m.vitx` print the JAX CLI's stdout
    on the JAX artifact of the same file, from the smallest baked batch;
    a port artifact in the JAX CLI, a JAX one in the port's and the
    wrong family fail to load as the JAX CLI fails."""
    from vit_cpp_tpu.cli import vit as jax_vit
    from vit_cpp_tpu.cli import vitstr as jax_vitstr
    from vit_cpp_tpu_torch.cli import vit as port_vit
    from vit_cpp_tpu_torch.cli import vitstr as port_vitstr

    jax_main, port_main = (jax_vit.main, port_vit.main) if which == "f16" else \
        (jax_vitstr.main, port_vitstr.main)
    img = files["imgs"][0]
    rc_p, out_p, err_p = _run_main(port_main, ["vit", "-m", artifacts[f"port-{which}"], "-i",
                                               img, "-k", "3", "--device", "cpu"], capsys)
    rc_j, out_j, err_j = _run_main(jax_main, ["vit", "-m", artifacts[f"jax-{which}"], "-i",
                                              img, "-k", "3"], capsys)
    assert rc_p == rc_j == 0, err_p
    assert out_p.splitlines() == out_j.splitlines()
    assert "main:    model load time = " in err_p
    rc, _, err = _run_main(jax_main, ["vit", "-m", artifacts[f"port-{which}"], "-i", img],
                           capsys)
    assert rc == 1 and "exported for platforms ['torch-cpu']" in err
    rc, _, err = _run_main(port_main, ["vit", "-m", artifacts[f"jax-{which}"], "-i", img,
                                       "--device", "cpu"], capsys)
    assert rc == 1 and "main: failed to load model from" in err and "JAX package" in err
    other = "vitstr" if which == "f16" else "f16"
    argv = ["vit", "-m", None, "-i", img]
    if which == "f16":  # the vit CLI names the ViTSTR head and exits 1
        argv[2] = artifacts[f"port-{other}"]
        rc_p, _, err_p = _run_main(port_main, argv + ["--device", "cpu"], capsys)
        argv[2] = artifacts[f"jax-{other}"]
        rc_j, _, err_j = _run_main(jax_main, argv, capsys)
        assert rc_p == rc_j == 1 and err_p.splitlines()[-1] == err_j.splitlines()[-1]
    else:  # the vitstr CLI lets the classifier's refusal raise, as the JAX one does
        argv[2] = artifacts[f"port-{other}"]
        with pytest.raises(ValueError) as ours:
            port_main(argv + ["--device", "cpu"])
        argv[2] = artifacts[f"jax-{other}"]
        with pytest.raises(ValueError) as theirs:
            jax_main(argv)
        assert str(ours.value) == str(theirs.value)


def _serve(main, argv, capsys):
    rc, out, err = _run_main(main, argv, capsys)
    return rc, out.splitlines(), [l for l in err.splitlines() if "images in" not in l
                                  and "images/sec" not in l]


@pytest.mark.parametrize("case", ["classify", "topk", "recognize", "embed", "embed-classifier",
                                  "classify-headless", "static", "mesh", "img-size", "tome",
                                  "jax-artifact"])
def test_vit_serve_on_an_artifact(files, artifacts, tmp_path, capsys, case):
    """`vit-serve -m m.vitx` as the JAX tool: the artifact's batch wins
    over -b with its notice, --embed runs a features artifact, and the
    flags baked at export exit 1 with the JAX messages."""
    from vit_cpp_tpu.cli import serve as jax_serve
    from vit_cpp_tpu_torch.cli import serve as port_serve

    key, flags = {
        "classify": ("f16", []), "topk": ("f16", ["-k", "3"]), "recognize": ("vitstr", []),
        "embed": ("headless", ["--embed", "OUT"]), "embed-classifier": ("f16", ["--embed", "OUT"]),
        "classify-headless": ("headless", []),
        "static": ("f16", ["--act", "static", "--calib-dir", str(files["dir"])]),
        "mesh": ("f16", ["--mesh", "2x1"]), "img-size": ("f16", ["--img-size", "48"]),
        "tome": ("f16", ["--tome", "2"]), "jax-artifact": ("f16", []),
    }[case]
    runs = {}
    for who, main, extra in (("port", port_serve.main, ["--device", "cpu"]),
                             ("jax", jax_serve.main, [])):
        art = artifacts[f"{'jax' if case == 'jax-artifact' else who}-{key}"]
        out = str(tmp_path / f"{who}.npy")
        argv = ["-m", art, "-b", "64", *[out if f == "OUT" else f for f in flags],
                *files["imgs"], *extra]
        runs[who] = _serve(main, argv, capsys) + (out,)
    (rc_p, out_p, err_p, npy_p), (rc_j, out_j, err_j, npy_j) = runs["port"], runs["jax"]
    if case == "jax-artifact":
        assert rc_p == 1 and err_p[-1].startswith(f"serve: {artifacts['jax-f16']} is a .vitx")
        return
    assert rc_p == rc_j, err_p
    assert err_p == err_j
    if rc_p:
        assert len(err_p) == 1
        return
    assert "serve: .vitx artifact is compiled for batch 2; using it (ignoring -b 64)" in err_p
    if case == "embed":
        np.testing.assert_allclose(np.load(npy_p), np.load(npy_j), atol=F32_TOL, rtol=0)
        return
    assert len(out_p) == 3
    if case == "recognize":
        assert [l.split("\t")[:2] for l in out_p] == [l.split("\t")[:2] for l in out_j]
    else:
        assert out_p == out_j


class _FakeHttpd:
    server_port = 0

    def serve_forever(self):
        raise KeyboardInterrupt  # leave main's serve loop at once

    def server_close(self):
        pass


def _daemon(server_mod, main, argv, posts, capsys):
    """Run a daemon CLI's main with its real server on a free port: (rc,
    {route: (status, json)} for each POST of `posts`, the batchers,
    stderr)."""
    answers, batchers = {}, {}

    def serve(httpd):
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{httpd.server_port}"
        try:
            for route, body in posts:
                req = urllib.request.Request(base + route, data=body, method="POST")
                try:
                    with urllib.request.urlopen(req, timeout=120) as r:
                        answers[route] = (r.status, json.loads(r.read()))
                except urllib.error.HTTPError as e:
                    answers[route] = (e.code, None)
        finally:
            httpd.shutdown()
            httpd.server_close()

    real_single, real_multi = server_mod.create_server, server_mod.create_multi_server

    def single(engine, **kw):
        httpd, batcher = real_single(engine, **{**kw, "port": 0})
        batchers[None] = batcher
        serve(httpd)
        return _FakeHttpd(), batcher

    def multi(engs, **kw):
        httpd, bs = real_multi(engs, **{**kw, "port": 0})
        batchers.update(bs)
        serve(httpd)
        return _FakeHttpd(), bs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(server_mod, "create_server", single)
        mp.setattr(server_mod, "create_multi_server", multi)
        rc, _, err = _run_main(main, argv, capsys)
    return rc, answers, batchers, err


def _png(path):
    buf = io.BytesIO()
    Image.open(path).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("case", ["bucket", "single-batch-bucket", "multi", "static"])
def test_vit_server_on_an_artifact(files, artifacts, capsys, case):
    """`vit-server -m m.vitx` as the JAX daemon: the micro-batcher takes
    the artifact's batch, --bucket its baked batches (or a notice when it
    bakes one), a classifier artifact has no /v1/embed (404), the
    multi-model daemon does the same per model, and --act static exits 1
    with the JAX message. The answers equal the JAX daemon's on the JAX
    artifact of the same file."""
    from vit_cpp_tpu import server as jax_server_mod
    from vit_cpp_tpu.cli import server as jax_server
    from vit_cpp_tpu_torch import server as port_server_mod
    from vit_cpp_tpu_torch.cli import server as port_server

    body = _png(files["imgs"][1])
    if case == "static":
        argv = lambda who: ["-m", artifacts[f"{who}-f16"], "--act", "static",  # noqa: E731
                            "--calib-dir", str(files["dir"])]
        posts = []
    elif case == "multi":
        argv = lambda who: ["-m", f"a={artifacts[f'{who}-f16']}", "-m",  # noqa: E731
                            f"b={artifacts[f'{who}-headless']}", "--bucket", "--no-warmup"]
        posts = [("/v1/a/classify?topk=3", body), ("/v1/a/embed", body),
                 ("/v1/b/embed", body)]
    else:
        key = "b2" if case == "single-batch-bucket" else "f16"
        argv = lambda who: ["-m", artifacts[f"{who}-{key}"] if who == "port" or key != "b2"  # noqa: E731
                            else artifacts["jax-f16"], "--bucket", "-b", "8"]
        posts = [("/v1/classify?topk=3", body), ("/v1/embed", body)]
    rc_p, got, batchers, err_p = _daemon(port_server_mod, port_server.main,
                                         argv("port") + ["--device", "cpu"], posts, capsys)
    rc_j, want, jax_batchers, err_j = _daemon(jax_server_mod, jax_server.main, argv("jax"),
                                              posts, capsys)
    assert rc_p == rc_j == (1 if case == "static" else 0), err_p
    if case == "static":
        assert err_p.splitlines()[-1] == err_j.splitlines()[-1]
        assert "does not apply to a .vitx artifact" in err_p
        return
    assert got.keys() == want.keys()
    for route, (status, answer) in got.items():
        assert status == want[route][0], route
        if status != 200:
            continue
        if "topk" in answer:
            assert [t["id"] for t in answer["topk"]] == [t["id"] for t in want[route][1]["topk"]]
            np.testing.assert_allclose([t["prob"] for t in answer["topk"]],
                                       [t["prob"] for t in want[route][1]["topk"]],
                                       atol=F32_TOL, rtol=0)
        else:
            np.testing.assert_allclose(answer["embedding"], want[route][1]["embedding"],
                                       atol=F32_TOL, rtol=0)
    assert got[posts[1][0]][0] == 404  # a classifier artifact serves no embeddings
    if case == "single-batch-bucket":
        assert batchers[None].bucket_sizes() == [2]
        assert ("vit-server: .vitx artifact bakes a single batch; ignoring --bucket "
                "(export with -b 1,.. to bucket)") in err_p
    elif case == "bucket":
        assert batchers[None].batch == 2 and batchers[None].bucket_sizes() == [1, 2]
        assert "vit-server: .vitx artifact is compiled for batch 2; using it (ignoring -b 8)" \
            in err_p
    else:
        assert batchers["a"].bucket_sizes() == jax_batchers["a"].bucket_sizes() == [1, 2]
        assert batchers["b"].bucket_sizes() == [2] and batchers["b"].batch == 2
        notice = "vit-server: b: .vitx artifact bakes a single batch; ignoring --bucket"
        assert notice in err_p.splitlines() and notice in err_j.splitlines()


def test_vit_benchmark_on_an_artifact(files, artifacts, tmp_path, capsys):
    """run_eval on a .vitx: the artifact's batch wins with the JAX notice,
    and the CSV and accuracy line are the JAX tool's."""
    from vit_cpp_tpu.cli import benchmark as jax_benchmark
    from vit_cpp_tpu_torch.cli import benchmark

    val = tmp_path / "val"
    for c, img in zip(("class_0", "class_2"), files["imgs"]):
        (val / c).mkdir(parents=True)
        Image.open(img).convert("RGB").save(val / c / "a.JPEG", format="JPEG")
    (tmp_path / "classnames.json").write_text(json.dumps([f"class_{i}" for i in range(7)]))
    lines = {}
    for who, main, extra in (("port", benchmark.main, ["--device", "cpu"]),
                             ("jax", jax_benchmark.main, [])):
        csv = str(tmp_path / f"{who}.csv")
        rc, out, err = _run_main(main, [artifacts[f"{who}-f16"], str(val), "0", csv,
                                        "--batch", "5", *extra], capsys)
        assert rc == 0, err
        assert "benchmark: .vitx artifact is compiled for batch 2; using it (ignoring " \
               "--batch 5)" in err
        lines[who] = (out.splitlines()[-1], open(csv).read())
    assert lines["port"] == lines["jax"]
    assert lines["port"][0].startswith("Top-1 Accuracy: ")


@pytest.mark.parametrize("case", ["info", "info-missing", "inspect", "inspect-json",
                                  "already-vitx", "bad-batch", "static-no-calib",
                                  "static-not-int8", "no-args", "export"])
def test_vit_export_and_inspect(files, artifacts, tmp_path, capsys, case):
    """`vit-export` and `vit-inspect` print what the JAX tools print, with
    their exit codes: --info and vit-inspect on a port artifact's
    header, the refusals before any export, and a whole export whose
    stderr line names the batches and the torch platform."""
    from vit_cpp_tpu.cli import export_aot as jax_export
    from vit_cpp_tpu.cli import inspect as jax_inspect
    from vit_cpp_tpu_torch.cli import export_aot as port_export
    from vit_cpp_tpu_torch.cli import inspect as port_inspect

    out = str(tmp_path / "o.vitx")
    mains, argv = (port_export.main, jax_export.main), {
        "info": ["--info", artifacts["port-f16"]],
        "info-missing": ["--info", str(tmp_path / "none.vitx")],
        "already-vitx": [artifacts["port-f16"], out],
        "bad-batch": [files["f16"], out, "-b", "1,x"],
        "static-no-calib": [files["f16"], out, "--act", "static"],
        "static-not-int8": [files["f16"], out, "--act", "static", "--mm", "xla"],
        "no-args": [],
        "export": [files["f16"], out, "-b", "2,1", "--dtype", "f32", "--mm", "xla",
                   "--attn", "xla"],
    }.get(case, [artifacts["port-f16"]] + (["--json"] if case == "inspect-json" else []))
    if case.startswith("inspect"):
        mains = (port_inspect.main, jax_inspect.main)
    extra = ["--device", "cpu"] if mains[0] is port_export.main else []
    rc_p, out_p, err_p = _run_main(mains[0], argv + extra, capsys)
    if os.path.exists(out):
        os.rename(out, out + ".port")
    rc_j, out_j, err_j = _run_main(mains[1], argv, capsys)
    assert rc_p == rc_j == (0 if case in ("info", "inspect", "inspect-json", "export") else 1)
    if case == "export":
        assert out_p == out_j == ""
        assert err_p.startswith(f"vit-export: {out} (") and \
            err_p.rstrip().endswith("batches 1,2, platforms ['torch-cpu'])")
        assert aot.AotEngine(out + ".port", device="cpu").batches == [1, 2]
        return
    assert (out_p, err_p) == (out_j, err_j)


def test_vit_export_platforms_and_static_calibration(files, tmp_path, capsys):
    """--platforms naming a target other than the export device is a usage
    error (exit 2); --act static --calib-dir bakes calibrated scales
    (meta act "static") that equal the live engine's after
    calibrate_engine_from_paths on the same directory."""
    from vit_cpp_tpu_torch.cli import export_aot
    from vit_cpp_tpu_torch.cli.common import build_engine, calibrate_engine_from_paths

    out = str(tmp_path / "m.vitx")
    for platforms in ("tpu", "cpu,tpu", "cuda"):
        rc, _, err = _run_main(export_aot.main, [files["f16"], out, "--platforms", platforms,
                                                 "--device", "cpu"], capsys)
        assert rc == 2 and "cannot lower" in err and not os.path.exists(out)
    calib = tmp_path / "calib"
    calib.mkdir()
    for i, x in enumerate(_pixels(6, TINY, seed=21)):
        img = ((x.transpose(1, 2, 0) * 0.25 + 0.5).clip(0, 1) * 255).astype(np.uint8)
        Image.fromarray(img).save(calib / f"c{i}.png")
    rc, _, err = _run_main(export_aot.main, [files["f16"], out, "-b", "2", "--attn", "xla",
                                             "--act", "static", "--calib-dir", str(calib),
                                             "--platforms", "cpu", "--device", "cpu"], capsys)
    assert rc == 0, err
    assert aot.read_meta(out)["act"] == "static"
    live, _ = build_engine(files["f16"], attn="xla", act="static", device="cpu")
    assert calibrate_engine_from_paths(live, str(calib))
    x = torch.from_numpy(_pixels(2, TINY, seed=4))
    np.testing.assert_allclose(aot.AotEngine(out, device="cpu").predict_probs_batch(x).numpy(),
                               live.predict_probs_batch(x).numpy(), atol=SELF_TOL, rtol=0)


@pytest.mark.parametrize("flag", [["--act", "static"], ["--img-size", "48"],
                                  ["--patch-size", "4"], ["--tome", "2"]])
def test_build_engine_refuses_what_the_artifact_baked(artifacts, flag):
    from vit_cpp_tpu.cli.common import build_engine as jax_build
    from vit_cpp_tpu_torch.cli.common import build_engine

    kw = {"--act": ("act", "static"), "--img-size": ("img_size", 48),
          "--patch-size": ("patch_size", 4), "--tome": ("tome", 2)}[flag[0]]
    _same_error(lambda: build_engine(artifacts["port-f16"], device="cpu", **{kw[0]: kw[1]}),
                lambda: jax_build(artifacts["jax-f16"], **{kw[0]: kw[1]}))
    engine, is_vitstr = build_engine(artifacts["port-vitstr"], device="cpu")
    assert isinstance(engine, aot.AotEngine) and is_vitstr
