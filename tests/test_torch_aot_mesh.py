"""Sharded .vitx artifacts on gloo CPU ranks against the sharded engines
they came from, the port's unsharded engine and the JAX package's own
sharded artifacts.

One spawn of 4 ranks shards each case's engine on a 2x2 and a 4x1 mesh,
serves a batch and exports it (aot.save_engine, every rank calling it);
a second spawn of 4 fresh ranks loads every artifact (aot.AotEngine
rebuilds the mesh from meta["mesh"]) and serves the same batch, then runs
`vit-serve -m x.vitx` and `vit -m x.vitx` on a 2x2 artifact. The JAX side exports
`VitEngine.shard(make_mesh(dp, tp))` on the 8 forced CPU devices
(tests/conftest.py) and serves it with its AotEngine. Bounds: 1e-6 of the
sharded engine; against the unsharded port engine and JAX's artifact,
tests/test_torch_mesh_serve.py's per case (atol 2e-5, rtol 1e-4; a W8A8
row on an activation code's rounding boundary is held to the port's
engine alone, ROADMAP's deliberate differences; bf16 Q8_0 `--mm pallas`
1e-3 of the port's single-device engine, which JAX's test file does not
compare). Module-level imports stay JAX-free: the spawned ranks import
this module.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from vit_cpp_tpu_torch.testing.distributed import run_ranks

SELF_TOL = 1e-6
ATOL, RTOL = 2e-5, 1e-4
BF16_TOL = 1e-3
MESHES = [(2, 2), (4, 1)]
# case -> (file, the port engine's flags, the JAX engine's flags or None,
# the exported batch sizes)
CASES = {
    "f32": ("dense", {}, {}, [4, 8]),
    "w8a8": ("dense", dict(mm_impl="int8"), dict(mm_impl="int8"), [8]),
    "q8_0-pallas-bf16": ("q8_0", dict(dtype="bf16", mm_impl="pallas", attn_impl="pallas-fast"),
                         None, [8]),
    "features": ("headless", {}, {}, [8]),
}


def _images(n=8, seed=21, size=32):
    """tests/test_torch_mesh_serve.py's structured images."""
    from tests.test_torch_mesh_serve import _images as images

    return images(n, seed, size)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from PIL import Image

    from vit_cpp_tpu.cli.quantize import quantize_model_file
    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.testing.synthetic import write_synthetic_model

    d = tmp_path_factory.mktemp("aot-mesh")
    base = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_classes=8,
                patch_size=8, img_size=32)
    paths = {k: str(d / f"{k}.gguf") for k in ("dense", "q8_0", "headless")}
    write_synthetic_model(paths["dense"], VitHParams(**base), ftype=1, seed=9)
    quantize_model_file(paths["dense"], paths["q8_0"], 8)
    write_synthetic_model(paths["headless"], VitHParams(**{**base, "num_classes": 0}),
                          ftype=1, seed=3)
    rng = np.random.default_rng(3)
    paths["imgs"] = []
    for i in range(3):
        p = str(d / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (40 + 4 * i, 48, 3), dtype=np.uint8)).save(p)
        paths["imgs"].append(p)
    paths["dir"] = str(d)
    return paths


def _artifact(files, case, mesh):
    return os.path.join(files["dir"], f"{case}-{mesh[0]}x{mesh[1]}.vitx")


def _run(engine, case, x):
    y = engine.features_batch(x) if case == "features" else engine.predict_probs_batch(x)
    return y.float().numpy()


def _export_rank(files, images):
    """Every case's engine, sharded on each mesh: its outputs on the batch
    (and on its first half where 4 is exported too), and the meta that
    save_engine returns on this rank."""
    from vit_cpp_tpu_torch.aot import save_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.parallel.mesh import make_mesh

    x = torch.from_numpy(images)
    out = {}
    for mesh in MESHES:
        m = make_mesh(dp=mesh[0], tp=mesh[1])
        for case, (file, kw, _, batches) in CASES.items():
            engine = VitEngine(files[file], verbose=False, device="cpu", **kw).shard(m)
            meta = save_engine(engine, _artifact(files, case, mesh), batches)
            out[(case, mesh)] = ({b: _run(engine, case, x[:b]) for b in batches}, meta)
    return out


def _serve_rank(files, images):
    """Every artifact loaded in fresh ranks: its outputs on the batch, then
    rank 0's stdout of `vit-serve -m` and `vit -m` on the 2x2 f32
    artifact."""
    from vit_cpp_tpu_torch.aot import AotEngine
    from vit_cpp_tpu_torch.cli.serve import main

    x = torch.from_numpy(images)
    out = {}
    for mesh in MESHES:
        for case, (_, _, _, batches) in CASES.items():
            engine = AotEngine(_artifact(files, case, mesh), device="cpu")
            assert engine.batches == batches and engine.mesh is not None
            out[(case, mesh)] = {b: _run(engine, case, x[:b]) for b in batches}
    from vit_cpp_tpu_torch.cli.vit import main as vit_main

    for key, tool, argv in (
        ("serve", main, ["-m", _artifact(files, "f32", (2, 2)), "-b", "4", "--device", "cpu",
                         *files["imgs"]]),
        ("vit", vit_main, ["vit", "-m", _artifact(files, "f32", (2, 2)), "-i", files["imgs"][0],
                           "-k", "3", "--device", "cpu"]),
    ):
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = tool(argv)
        out[key] = (rc, stdout.getvalue())
    return out


_RUNS = {}


def _runs(files):
    if not _RUNS:
        _RUNS["export"] = run_ranks(_export_rank, 4, files, _images(), timeout=300)
        _RUNS["serve"] = run_ranks(_serve_rank, 4, files, _images(), timeout=300)
    return _RUNS


_JAX = {}


def _jax_artifact(files, case, mesh):
    """JAX's sharded artifact of the case on dp x tp of its CPU devices:
    (meta, outputs by batch)."""
    if (case, mesh) not in _JAX:
        import jax
        import jax.numpy as jnp

        from vit_cpp_tpu.aot import AotEngine as JaxAot
        from vit_cpp_tpu.aot import save_engine as jax_save
        from vit_cpp_tpu.engine import VitEngine as JaxEngine
        from vit_cpp_tpu.parallel.mesh import make_mesh

        file, _, jkw, batches = CASES[case]
        engine = JaxEngine(files[file], verbose=False, **jkw).shard(
            make_mesh(dp=mesh[0], tp=mesh[1], devices=jax.devices()[: mesh[0] * mesh[1]]))
        path = _artifact(files, case, mesh) + ".jax"
        meta = jax_save(engine, path, batches)
        aot = JaxAot(path)
        x = jnp.asarray(_images())
        run = aot.features_batch if case == "features" else aot.predict_probs_batch
        _JAX[(case, mesh)] = (meta, {b: np.asarray(run(x[:b])) for b in batches})
    return _JAX[(case, mesh)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_artifact_serves_as_its_engine(files, case, mesh):
    """The served outputs equal the sharded engine's (1e-6) and, within
    test_torch_mesh_serve.py's bounds, the unsharded port engine's and
    JAX's sharded artifact's; meta["mesh"] equals JAX's."""
    from vit_cpp_tpu_torch.engine import VitEngine

    runs = _runs(files)
    engine_out, meta = runs["export"][(case, mesh)]
    served = runs["serve"][(case, mesh)]
    file, kw, jkw, batches = CASES[case]
    assert meta["mesh"] == {"axis_names": ["data", "model"], "axis_sizes": list(mesh)}
    assert meta["batches"] == batches and len(meta["blob_lengths"]) == len(batches) * mesh[1]
    single = VitEngine(files[file], verbose=False, device="cpu", **kw)
    x = torch.from_numpy(_images())
    if jkw is not None:
        jax_meta, jax_out = _jax_artifact(files, case, mesh)
        assert meta["mesh"] == jax_meta["mesh"]
        assert (meta["batch"], meta["batches"]) == (jax_meta["batch"], jax_meta["batches"])
    for b in batches:
        got = served[b]
        np.testing.assert_allclose(got, engine_out[b], atol=SELF_TOL, rtol=0)
        one = _run(single, case, x[:b])
        if jkw is None:
            np.testing.assert_allclose(got, one, atol=BF16_TOL, rtol=0)
            continue
        np.testing.assert_allclose(got, one, atol=ATOL, rtol=RTOL)
        want = jax_out[b]
        agree = np.isclose(one, want, atol=ATOL, rtol=RTOL).all(axis=1)
        assert agree.all() or (kw.get("mm_impl") == "int8" and agree.sum() >= len(agree) - 1)
        np.testing.assert_allclose(got[agree], want[agree], atol=ATOL, rtol=RTOL)


def test_vit_serve_on_a_sharded_artifact_prints_the_unsharded_lines(files, capsys):
    """`vit-serve -m x.vitx` on four ranks (a 2x2 artifact; rank 0 prints)
    prints the lines of the unsharded command on the gguf."""
    from vit_cpp_tpu_torch.cli.serve import main

    rc, out = _runs(files)["serve"]["serve"]
    assert main(["-m", files["dense"], "--dtype", "f32", "--attn", "xla", "--mm", "xla",
                 "-b", "4", "--device", "cpu", *files["imgs"]]) == 0
    single = capsys.readouterr().out
    assert rc == 0 and out == single and len(out.splitlines()) == 3


def test_vit_cli_on_a_sharded_artifact_prints_the_unsharded_top_k(files, capsys):
    """`vit -m x.vitx` on four ranks (rank 0 prints; the smallest baked
    batch, 4, splits over "data") prints the top-k lines of the unsharded
    command on the gguf (the f32 parity engine the artifact came from)."""
    from vit_cpp_tpu_torch.cli.vit import main

    rc, out = _runs(files)["serve"]["vit"]
    assert main(["vit", "-m", files["dense"], "-i", files["imgs"][0], "-k", "3",
                 "--device", "cpu"]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(" > ")]
    assert rc == 0 and len(want) == 3
    assert [ln for ln in out.splitlines() if ln.startswith(" > ")] == want


def test_too_few_ranks_raise_the_jax_message(files, monkeypatch):
    """A 2x2 artifact in a world of one rank raises the JAX AotEngine's
    message for a host with too few devices, then names the launcher."""
    import jax

    from vit_cpp_tpu.aot import AotEngine as JaxAot
    from vit_cpp_tpu_torch.aot import AotEngine

    _runs(files)
    path = _artifact(files, "f32", (2, 2))
    jax_path = path + ".jax"
    _jax_artifact(files, "f32", (2, 2))
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    with pytest.raises(ValueError) as theirs:
        JaxAot(jax_path)
    with pytest.raises(ValueError) as ours:
        AotEngine(path, device="cpu")
    want = str(theirs.value).replace(jax_path, path)
    assert str(ours.value).startswith(want + "; a sharded artifact needs one process per "
                                      "device: python -m torch.distributed.run "
                                      "--nproc-per-node 4 ")


@pytest.mark.parametrize("tool", ["serve", "server"])
def test_mesh_flag_with_an_artifact_is_refused(files, capsys, tool):
    """--mesh with a .vitx exits 1 with the JAX tool's words (the mesh
    comes from the artifact)."""
    from vit_cpp_tpu.cli import serve as jax_serve
    from vit_cpp_tpu_torch.cli import serve, server

    _runs(files)
    path = _artifact(files, "f32", (2, 2))
    assert jax_serve.main(["-m", path, "--mesh", "2x2", *files["imgs"]]) == 1
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert want.startswith("--mesh is not supported for .vitx artifacts")
    main = serve.main if tool == "serve" else server.main
    argv = ["-m", path, "--mesh", "2x2", "--device", "cpu"]
    assert main(argv + (files["imgs"] if tool == "serve" else [])) == 1
    assert capsys.readouterr().err.strip().splitlines()[-1] == want


def test_inspect_prints_the_mesh(files, capsys):
    """vit-inspect prints a sharded artifact's header with its mesh, as
    the JAX tool prints JAX's."""
    import json

    from vit_cpp_tpu.cli.inspect import main as jax_main
    from vit_cpp_tpu_torch.cli.inspect import main

    _runs(files)
    _jax_artifact(files, "w8a8", (4, 1))
    path = _artifact(files, "w8a8", (4, 1))
    assert main([path]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_main([path + ".jax"]) == 0
    theirs = json.loads(capsys.readouterr().out)
    assert ours["mesh"] == theirs["mesh"] == {"axis_names": ["data", "model"],
                                              "axis_sizes": [4, 1]}
