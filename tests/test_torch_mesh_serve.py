"""Sharded serving on gloo CPU ranks against the JAX package's engine.

The JAX package runs its sharded engine on the 8-device virtual CPU mesh
(tests/conftest.py); the port runs one process per device
(vit_cpp_tpu_torch.testing.distributed.run_ranks, or the torch.distributed
launcher for the command line). Each multi-rank spawn covers many cases:
one spawn of 8 ranks per mesh, dp x tp in {8x1, 4x2}. The bound is the
JAX tests' own between their sharded and single-device engines (atol 2e-5,
rtol 1e-4, tests/test_engine_sharded.py). Random weights make q, k and v
differ, so a qkv split that ignored head boundaries would fail every 4x2
case. bf16 engines are held to the port's single-device engine by the
bounds that test_sharded_bf16_engine_matches_single states. Module-level
imports stay JAX-free: the spawned ranks import this module.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from vit_cpp_tpu_torch.testing.distributed import run_ranks

ATOL, RTOL = 2e-5, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    (4, 2): ["f32", "features", "q8_0", "q8_0-pallas", "w8a8-fold", "w8a8-nofold",
             "static-before", "static-after", "tome", "moe", "moe-replicated"],
    (8, 1): ["f32", "q8_0"],
}
# bf16 engines, run in the 4x2 spawn and held to the port's single-device
# engine by absolute bounds on the probabilities
# (test_sharded_bf16_engine_matches_single)
BF16_TOL = {"bf16": 1e-3, "q8_0-pallas-bf16": 1e-3}
BF16_CASES = list(BF16_TOL)
# case -> (file, the port engine's flags, the JAX reference engine's flags)
ENGINES = {
    "f32": ("dense", {}, {}),
    "features": ("dense", {}, {}),
    "q8_0": ("q8_0", {}, {}),
    "q8_0-pallas": ("q8_0", dict(mm_impl="pallas"), {}),
    "w8a8-fold": ("dense", dict(mm_impl="int8", fold_ln=True), dict(mm_impl="int8", fold_ln=True)),
    "w8a8-nofold": ("dense", dict(mm_impl="int8"), dict(mm_impl="int8")),
    "static-before": ("dense", dict(mm_impl="int8", act_quant="static"),
                      dict(mm_impl="int8", act_quant="static")),
    "static-after": ("dense", dict(mm_impl="int8", act_quant="static"),
                     dict(mm_impl="int8", act_quant="static")),
    "tome": ("dense", dict(tome=2), dict(tome=2)),
    "moe": ("moe", {}, {}),
    "moe-replicated": ("moe3", {}, {}),
    "bf16": ("dense", dict(dtype="bf16"), None),
    "q8_0-pallas-bf16": ("q8_0", dict(dtype="bf16", mm_impl="pallas"), None),
}


def _images(n=8, seed=21, size=32):
    """Smooth gradients plus texture, normalized like preprocessed pixels
    (random pixels put many int8 codes on a rounding boundary)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size))
    out = []
    for _ in range(n):
        fx, fy = rng.uniform(0.5, 6, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        base = np.stack([np.sin(fx * xx * np.pi + p) * np.cos(fy * yy * np.pi) for p in phase])
        out.append((base + 0.3 * rng.standard_normal((3, size, size))).astype(np.float32))
    return np.stack(out)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from vit_cpp_tpu.cli.quantize import quantize_model_file
    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.testing.synthetic import write_synthetic_model

    d = tmp_path_factory.mktemp("mesh-serve")
    base = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_classes=8,
                patch_size=8, img_size=32)
    paths = {k: str(d / f"{k}.gguf") for k in ("dense", "q8_0", "moe", "moe3")}
    write_synthetic_model(paths["dense"], VitHParams(**base), ftype=1, seed=9)
    quantize_model_file(paths["dense"], paths["q8_0"], 8)
    write_synthetic_model(paths["moe"], VitHParams(**base, num_experts=4, moe_layers=(1,),
                                                   moe_top_k=2), ftype=1, seed=4)
    # 3 experts: tp=2 does not divide them, so both packages replicate them
    write_synthetic_model(paths["moe3"], VitHParams(**base, num_experts=3, moe_layers=(1,),
                                                    moe_top_k=2), ftype=1, seed=5)
    return paths


def _serve_rank(paths, dp, tp, cases, images):
    """Every case's sharded engine on this rank -> {case: (B, ...) output}."""
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.parallel.mesh import make_mesh
    from vit_cpp_tpu_torch.quant.int8 import params_have_static_scales

    mesh = make_mesh(dp=dp, tp=tp)
    x = torch.from_numpy(images)
    out = {}
    for case in cases:
        file, kw, _ = ENGINES[case]
        engine = VitEngine(paths[file], verbose=False, device="cpu", **kw)
        if case == "static-before":
            engine.calibrate(x)
        engine.shard(mesh)
        if case == "static-after":
            engine.calibrate(x)
        if case.startswith("static"):
            assert params_have_static_scales(engine.params), case
        y = engine.features_batch(x) if case == "features" else engine.predict_probs_batch(x)
        out[case] = y.float().numpy()
    return out


_RUNS = {}


def _sharded(files, mesh):
    if mesh not in _RUNS:
        cases = CASES[mesh] + (BF16_CASES if mesh == (4, 2) else [])
        _RUNS[mesh] = run_ranks(_serve_rank, mesh[0] * mesh[1], files, mesh[0], mesh[1],
                                cases, _images(), timeout=240)
    return _RUNS[mesh]


@pytest.mark.parametrize(
    "mesh,case", [(m, c) for m, cs in CASES.items() for c in cs],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v,
)
def test_sharded_engine_matches_jax(files, mesh, case):
    """The port's sharded engine on dp x tp gloo ranks vs the JAX engine on
    the same file and inputs (the static cases calibrate on the batch, the
    port's before or after `shard`; V-MoE runs 2 experts per rank), and vs
    the port's single-device engine. An f32 W8A8 row whose activation code
    lies on a rounding boundary differs between the two packages' single
    engines already (ROADMAP C: 3.25e-3 on one of the 8 rows of
    w8a8-nofold); such a row, at most one and only on an int8 path, is
    held to the port's single-device engine alone."""
    import jax.numpy as jnp

    from vit_cpp_tpu.engine import VitEngine as JaxEngine
    from vit_cpp_tpu_torch.engine import VitEngine

    file, kw, jkw = ENGINES[case]
    ref = JaxEngine(files[file], verbose=False, **jkw)
    single = VitEngine(files[file], verbose=False, device="cpu", **kw)
    x = _images()
    if case.startswith("static"):
        ref.calibrate(jnp.asarray(x))
        single.calibrate(torch.from_numpy(x))
    run = (lambda e, a: e.features_batch(a)) if case == "features" else (
        lambda e, a: e.predict_probs_batch(a))
    want = np.asarray(run(ref, jnp.asarray(x)))
    one = run(single, torch.from_numpy(x)).float().numpy()
    got = _sharded(files, mesh)[case]
    np.testing.assert_allclose(got, one, atol=ATOL, rtol=RTOL)
    agree = np.isclose(one, want, atol=ATOL, rtol=RTOL).all(axis=1)
    assert agree.all() or (kw.get("mm_impl") == "int8" and agree.sum() >= len(agree) - 1)
    np.testing.assert_allclose(got[agree], want[agree], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", BF16_CASES)
def test_sharded_bf16_engine_matches_single(files, case):
    """bf16 engines on 4x2 against the port's single-device bf16 engine. A
    row-parallel product (proj, fc2) sums its f32 partials over "model"
    and rounds once, as the single engine rounds its whole product, so
    only the order of an f32 sum differs: bound 1e-3. Dense products
    measured 0 at this size (rounding each partial to bf16 first gave
    4.1e-3); the dequantizing kernel (`--mm pallas`) writes its partials
    in f32 by its f32-output instantiation (rounding them to bf16 first
    gave 4.5e-3, where the single bf16 engine itself lies 6.9e-3 from the
    f32 one)."""
    from vit_cpp_tpu_torch.engine import VitEngine

    file, kw, _ = ENGINES[case]
    one = VitEngine(files[file], verbose=False, device="cpu", **kw).predict_probs_batch(
        torch.from_numpy(_images())).float().numpy()
    got = _sharded(files, (4, 2))[case]
    np.testing.assert_allclose(got, one, atol=BF16_TOL[case], rtol=0)


MAPS_TOL = 1e-5  # tests/test_torch_attention_maps.py's bound
MAPS_CASES = ["f32", "q8_0"]


def _maps_rank(paths, images, img):
    """attention_maps_batch and explain_file of each case's engine on a 2x2
    mesh of this rank."""
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=2, tp=2)
    out = {}
    for case in MAPS_CASES:
        file, kw, _ = ENGINES[case]
        engine = VitEngine(paths[file], verbose=False, device="cpu", **kw).shard(mesh)
        out[case] = (engine.attention_maps_batch(torch.from_numpy(images)),
                     engine.explain_file(img, topk=3))
    return out


_MAPS = {}


@pytest.mark.parametrize("case", MAPS_CASES)
def test_sharded_attention_maps_match_jax(files, tmp_path_factory, case):
    """On a 2x2 mesh (a batch split over "data", every layer's heads
    gathered over "model") the attention maps, explain_file's rollout grid
    and its top-k equal the port's unsharded engine's and the JAX
    engine's, within tests/test_torch_attention_maps.py's 1e-5."""
    import jax.numpy as jnp

    from vit_cpp_tpu.engine import VitEngine as JaxEngine
    from vit_cpp_tpu_torch.engine import VitEngine

    if not _MAPS:
        img = _pngs(tmp_path_factory.mktemp("maps"), n=1)[0]
        _MAPS.update(img=img, runs=run_ranks(_maps_rank, 4, files, _images(), img,
                                             timeout=240))
    maps, (top, grid) = _MAPS["runs"][case]
    file, kw, jkw = ENGINES[case]
    x = _images()
    one = VitEngine(files[file], verbose=False, device="cpu", **kw)
    ref = JaxEngine(files[file], verbose=False, **jkw)
    assert maps.shape == (8, 2, 4, 17, 17)
    for want, (want_top, want_grid) in (
        (one.attention_maps_batch(torch.from_numpy(x)), one.explain_file(_MAPS["img"], topk=3)),
        (ref.attention_maps_batch(jnp.asarray(x)), ref.explain_file(_MAPS["img"], topk=3)),
    ):
        np.testing.assert_allclose(maps, want, atol=MAPS_TOL, rtol=0)
        np.testing.assert_allclose(grid, want_grid, atol=MAPS_TOL, rtol=0)
        assert [t[0] for t in top] == [t[0] for t in want_top]
        np.testing.assert_allclose([t[1] for t in top], [t[1] for t in want_top],
                                   atol=MAPS_TOL)


def _pngs(tmp_path, n=4):
    from PIL import Image

    rng = np.random.default_rng(3)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (40 + 4 * i, 48, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def test_cli_serve_mesh_4x2_under_the_launcher(files, tmp_path, capsys):
    """`python -m torch.distributed.run --nproc-per-node 8 -m
    vit_cpp_tpu_torch.cli.serve ... --mesh 4x2 --device cpu` prints the
    lines of the port's single-device run and of JAX's --mesh 4x2 run."""
    from vit_cpp_tpu.cli.serve import main as jax_main
    from vit_cpp_tpu_torch.cli.serve import main

    imgs = _pngs(tmp_path)
    args = ["-m", files["dense"], "--dtype", "f32", "--attn", "xla", "-b", "4", *imgs]
    assert jax_main([*args, "--mesh", "4x2"]) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    assert main([*args, "--device", "cpu"]) == 0
    single = capsys.readouterr().out.splitlines()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "8",
         "-m", "vit_cpp_tpu_torch.cli.serve", *args, "--mesh", "4x2", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.splitlines() == single == jax_lines
    assert len(single) == 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, body=None, timeout=60):
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _ask(base, bodies):
    return {
        "classify": [_post(f"{base}/v1/classify?topk=3", b)["topk"] for b in bodies],
        "embed": [_post(f"{base}/v1/embed", b)["embedding"] for b in bodies],
    }


def _server_rank(model, bodies, argv):
    """cli.server's main on every rank; rank 0 also asks the daemon, then
    stops it with SIGTERM. Raises unless main returns 0 on this rank."""
    import torch.distributed as dist

    from vit_cpp_tpu_torch.cli.server import main

    answers = {}
    if dist.get_rank() == 0:
        port = _free_port()
        argv = [*argv, "--port", str(port)]

        def client():
            base = f"http://127.0.0.1:{port}"
            deadline = time.monotonic() + 120
            while True:
                try:
                    _post(f"{base}/healthz", timeout=5)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
            try:
                answers.update(_ask(base, bodies))
            finally:
                os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=client, daemon=True).start()
    rc = main(["-m", model, *argv])
    if rc != 0:
        raise RuntimeError(f"rank {dist.get_rank()}: vit-server exited {rc}")
    return answers


def test_cli_server_mesh_2x2_answers_as_the_single_daemon(files, tmp_path):
    """vit-server --mesh 2x2 on four gloo ranks answers /v1/classify and
    /v1/embed as the single-device daemon does, and every rank's main
    returns 0 after the SIGTERM shutdown (the stop opcode)."""
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.server import create_server

    bodies = [open(p, "rb").read() for p in _pngs(tmp_path)]
    flags = ["--device", "cpu", "--dtype", "f32", "--attn", "xla", "--mm", "xla", "-b", "4"]
    got = run_ranks(_server_rank, 4, files["dense"], bodies, ["--mesh", "2x2", *flags],
                    timeout=240)
    engine = VitEngine(files["dense"], verbose=False, device="cpu")
    httpd, batcher = create_server(engine, port=0, batch=4)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        want = _ask(f"http://127.0.0.1:{httpd.server_port}", bodies)
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    for ours, theirs in zip(got["classify"], want["classify"]):
        assert [t["id"] for t in ours] == [t["id"] for t in theirs]
        np.testing.assert_allclose([t["prob"] for t in ours], [t["prob"] for t in theirs],
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.array(got["embed"]), np.array(want["embed"]),
                               atol=ATOL, rtol=RTOL)


def test_cli_serve_mesh_1x1_runs_in_process(files, tmp_path, capsys):
    """Without a launcher a 1x1 mesh starts its own 1-rank group and serves
    the lines of the unsharded run; --embed writes the same features."""
    from vit_cpp_tpu_torch.cli.serve import main

    imgs = _pngs(tmp_path)
    args = ["-m", files["dense"], "--dtype", "f32", "--attn", "xla", "-b", "4",
            "--device", "cpu", *imgs]
    assert main(args) == 0
    single = capsys.readouterr().out
    assert main([*args, "--mesh", "1x1"]) == 0
    assert capsys.readouterr().out == single
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    assert main([*args, "--embed", a]) == 0 and main([*args, "--embed", b, "--mesh", "1x1"]) == 0
    np.testing.assert_array_equal(np.load(a), np.load(b))
