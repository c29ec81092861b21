"""The port's mesh layer (vit_cpp_tpu_torch.parallel.mesh / sharding) against
the JAX package's, with no ranks: the partition-spec trees entry for entry
at (dp, tp) = (8, 1) and (4, 2) for every family tree, make_mesh's checks
and messages, the daemon's bucket constraint, the head-aligned qkv split
and the refusals. The last test spawns two gloo ranks and kills a
follower of the daemon's dispatch loop on purpose: the leader's next
collective fails, and the harness fails the run instead of hanging.
"""

import numpy as np
import pytest
import torch

from vit_cpp_tpu_torch.parallel import sharding as tsh
from vit_cpp_tpu_torch.parallel.mesh import available_ranks, make_mesh
from vit_cpp_tpu_torch.quant.int8 import Int8Linear
from vit_cpp_tpu_torch.quant.qlinear import QuantLinear

MESHES = [(8, 1), (4, 2)]


class SizedMesh:
    """The sizes of a ("data", "model") mesh and this rank's "model"
    coordinate, without a process group."""

    def __init__(self, dp, tp, rank=0):
        self.shape, self.rank = (dp, tp), rank

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, axis):
        return self.rank if axis == "model" else 0
FAMILIES = ["dense", "q8_0", "q4_1", "int8", "int8-static", "folded", "siglip", "moe",
            "norm-pre", "distilled", "registers"]


def _jax_tree(family, tmp_path):
    """The JAX package's parameter tree of one family (load_params of a
    synthetic gguf, then the serving rewrites the family names)."""
    from vit_cpp_tpu.cli.quantize import quantize_model_file
    from vit_cpp_tpu.gguf.reader import read_model
    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.models.params import load_params
    from vit_cpp_tpu.testing.synthetic import write_synthetic_model

    extra = {
        "siglip": dict(global_pool="map", num_classes=0),
        "moe": dict(num_experts=4, moe_layers=(1,), moe_top_k=2),
        "norm-pre": dict(norm_pre=True),
        "distilled": dict(num_prefix_tokens=2),
        "registers": dict(num_reg_tokens=4),
    }.get(family, {})
    hp = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                    num_classes=extra.pop("num_classes", 8), patch_size=8, img_size=32,
                    **extra)
    path = str(tmp_path / f"{family}.gguf")
    write_synthetic_model(path, hp, ftype=1, seed=3)
    if family in ("q8_0", "q4_1"):
        qpath = str(tmp_path / f"{family}-q.gguf")
        quantize_model_file(path, qpath, {"q8_0": 8, "q4_1": 3}[family])
        path = qpath
    params = load_params(read_model(path))
    if family.startswith("int8"):
        from vit_cpp_tpu.quant.int8 import convert_params_to_int8

        params = convert_params_to_int8(params)
        if family == "int8-static":
            from vit_cpp_tpu.quant.calibrate import calibrate_act_scales

            x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
            params = calibrate_act_scales(params, x, hp)
    if family == "folded":
        from vit_cpp_tpu.models.fold import fold_layernorms

        params = fold_layernorms(params, mm_impl="xla")
    return params


def _jax_spec(node):
    """A JAX spec node as the port writes it: plain tuples."""
    from vit_cpp_tpu.quant.int8 import Int8Linear as JInt8
    from vit_cpp_tpu.quant.qlinear import QuantLinear as JQuant

    if isinstance(node, dict):
        return {k: _jax_spec(v) for k, v in node.items()}
    if isinstance(node, JQuant):
        return QuantLinear(codes=_jax_spec(node.codes), scales=_jax_spec(node.scales),
                           mins=_jax_spec(node.mins), qtype=0)
    if isinstance(node, JInt8):
        return Int8Linear(codes=_jax_spec(node.codes), scale=_jax_spec(node.scale),
                          act_scale=_jax_spec(node.act_scale))
    return None if node is None else tuple(node)


@pytest.mark.parametrize("dp,tp", MESHES, ids=lambda v: str(v))
@pytest.mark.parametrize("family", FAMILIES)
def test_specs_equal_jax(family, dp, tp, tmp_path):
    """param_pspecs and fsdp_pspecs equal the JAX package's entry for entry
    (the port's params_from_jax tree of the same weights)."""
    import jax

    from vit_cpp_tpu.parallel import sharding as jsh
    from vit_cpp_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vit_cpp_tpu_torch.models.params import params_from_jax

    jparams = _jax_tree(family, tmp_path)
    ours = params_from_jax(jparams)
    jmesh = jax_make_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])
    assert tsh.param_pspecs(ours) == _jax_spec(jsh.param_pspecs(jparams))
    assert tsh.fsdp_pspecs(ours, SizedMesh(dp, tp)) == _jax_spec(
        jsh.fsdp_pspecs(jparams, jmesh))


def test_folded_engine_features_norm_replicates(tmp_path):
    """The port's folded tree keeps the final norm's affine in
    `features_norm` (the JAX package drops it): it replicates."""
    from vit_cpp_tpu_torch.models.fold import fold_layernorms
    from vit_cpp_tpu_torch.models.params import params_from_jax

    ours = fold_layernorms(params_from_jax(_jax_tree("dense", tmp_path)), mm_impl="xla")
    assert tsh.param_pspecs(ours)["features_norm"] == {"scale": (), "bias": ()}


def test_batch_pspec():
    from vit_cpp_tpu.parallel.sharding import batch_pspec

    assert tsh.batch_pspec() == tuple(batch_pspec()) == ("data",)


def test_make_mesh_checks_and_messages():
    """Without a launcher the world is one rank: JAX's messages for more
    devices than ranks and for dp * tp != n."""
    from vit_cpp_tpu.parallel.mesh import make_mesh as jax_make_mesh

    assert available_ranks() == 1
    for kw in (dict(dp=4, tp=2, n_devices=8), dict(n_devices=2)):
        with pytest.raises(ValueError, match=r"^requested \d devices, only 1 available$"):
            make_mesh(**kw)
    with pytest.raises(ValueError) as ours:
        make_mesh(dp=3, tp=3, devices=list(range(8)))
    with pytest.raises(ValueError) as theirs:
        jax_make_mesh(dp=3, tp=3)
    assert str(ours.value) == str(theirs.value) == "dp(3) * tp(3) != n_devices(8)"


@pytest.mark.parametrize(
    "batch,buckets,dp",
    [(8, True, 2), (8, True, 4), (8, True, 8), (16, True, 3), (8, False, 4),
     (8, [2, 4, 8], 2), (8, [1, 8], 2), (8, True, 1), (12, True, 4)],
)
def test_shardable_buckets_equal_jax(batch, buckets, dp):
    """server._shardable_buckets equals the JAX daemon's over a table of
    (batch, buckets, dp) cases, the ValueError of a list that dp does not
    divide included."""
    from types import SimpleNamespace

    from vit_cpp_tpu.server import _shardable_buckets as jax_buckets
    from vit_cpp_tpu_torch.server import _shardable_buckets

    jax_engine = SimpleNamespace(_batch_sharding=SimpleNamespace(
        mesh=SimpleNamespace(shape={"data": dp, "model": 1})))
    ours = SimpleNamespace(mesh=SizedMesh(dp, 1))
    try:
        want = jax_buckets(jax_engine, batch, buckets)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            _shardable_buckets(ours, batch, buckets)
        assert str(got.value) == str(e)
        return
    assert _shardable_buckets(ours, batch, buckets) == want
    assert _shardable_buckets(SimpleNamespace(mesh=None), batch, buckets) == buckets


def test_qkv_model_shard_lands_on_head_boundaries():
    """Rank r's qkv columns are heads [r*nh/tp, (r+1)*nh/tp) of each of q,
    k and v, for codes-like (in, 3h) tensors and (L, 3h) biases alike."""
    h, nh, tp = 8, 4, 2
    hd = h // nh
    w = torch.arange(5 * 3 * h).reshape(5, 3 * h)
    for r in range(tp):
        mesh = SizedMesh(1, tp, r)
        got = tsh.model_shard(w, -1, mesh, qkv=True)
        heads = range(r * nh // tp, (r + 1) * nh // tp)
        want = torch.cat([w[:, part * h + i * hd: part * h + (i + 1) * hd]
                          for part in range(3) for i in heads], dim=1)
        assert torch.equal(got, want) and got.is_contiguous()
        # a contiguous split would give rank 0 all of q
        assert not torch.equal(got, w[:, r * 3 * h // tp:(r + 1) * 3 * h // tp])




def test_placement_replicates_leaves_that_do_not_divide(tmp_path):
    """A leaf whose dimension does not divide its axis replicates with the
    JAX warning; a Q8_0 row-parallel node replicates whole when K/tp is
    not a multiple of 32 (its block scales do not divide)."""
    from vit_cpp_tpu_torch.models.params import params_from_jax

    ours = params_from_jax(_jax_tree("q8_0", tmp_path))
    with pytest.warns(UserWarning, match="does not divide mesh axes"):
        specs = tsh.placement_specs(ours, SizedMesh(1, 4))
    # h=64, tp=4: proj K/tp = 16, its (L, 2, 64) scales do not divide by 4
    proj = specs["blocks"]["proj"]["kernel"]
    assert isinstance(proj, QuantLinear) and proj.codes == () and proj.scales == ()
    # the column-parallel qkv node keeps its spec
    assert specs["blocks"]["qkv"]["kernel"].codes == (None, None, "model")


def test_shard_rejects_tp_not_dividing_heads(tmp_path):
    """tp=8 on a 4-head model: JAX's message (vit_cpp_tpu/engine.py:280-290)."""
    import jax

    from vit_cpp_tpu.engine import VitEngine as JaxEngine
    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vit_cpp_tpu.testing.synthetic import write_synthetic_model
    from vit_cpp_tpu_torch.engine import VitEngine

    path = str(tmp_path / "m.gguf")
    write_synthetic_model(path, VitHParams(hidden_size=64, num_hidden_layers=1,
                                           num_attention_heads=4, num_classes=8,
                                           patch_size=8, img_size=32), ftype=1, seed=0)
    with pytest.raises(ValueError) as theirs:
        JaxEngine(path, verbose=False).shard(jax_make_mesh(dp=1, tp=8,
                                                           devices=jax.devices()[:8]))
    with pytest.raises(ValueError) as ours:
        VitEngine(path, verbose=False, device="cpu").shard(SizedMesh(1, 8))
    assert str(ours.value) == str(theirs.value)
    assert "does not divide num_attention_heads 4" in str(ours.value)


def test_export_of_a_sharded_engine_raises(tmp_path):
    """A sharded engine's export refuses a batch that the data axis does
    not divide, in the JAX package's words (its jit's in_shardings check),
    before any rank traces; the attention maps refuse such a batch as the
    serving calls do."""
    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.testing.synthetic import write_synthetic_model
    from vit_cpp_tpu_torch.aot import export_engine
    from vit_cpp_tpu_torch.engine import VitEngine

    path = str(tmp_path / "m.gguf")
    write_synthetic_model(path, VitHParams(hidden_size=64, num_hidden_layers=1,
                                           num_attention_heads=4, num_classes=8,
                                           patch_size=8, img_size=32), ftype=1, seed=0)
    engine = VitEngine(path, verbose=False, device="cpu")
    engine.mesh = SizedMesh(2, 1)
    with pytest.raises(ValueError, match=r"which implies that the global size of its "
                       r"dimension 0 should be divisible by 2, but it is equal to 3 "
                       r"\(full shape: \(3, 3, 32, 32\)\)"):
        export_engine(engine, [2, 3])
    with pytest.raises(ValueError, match="does not divide the mesh data axis"):
        engine.attention_maps_batch(torch.zeros(1, 3, 32, 32))


def _follower_dies(model_path):
    """Rank 1 follows the daemon's dispatches and dies on the first one;
    rank 0's broadcast of the batch then fails, and it reports that."""
    import os

    import torch.distributed as dist

    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.server import MeshLeader, _header

    mesh = make_mesh(dp=2, tp=1)
    engine = VitEngine(model_path, verbose=False, device="cpu").shard(mesh)
    if dist.get_rank() == 1:
        dist.broadcast(_header(engine.device), src=0)  # the first dispatch's header
        os._exit(3)
    leader = MeshLeader(engine)
    leader.predict_probs_batch(torch.zeros(2, 3, 32, 32))


def test_a_follower_that_dies_fails_the_run(tmp_path):
    """The leader's next collective fails (gloo sees the peer gone, or the
    group timeout passes) and the harness fails the run: no hang."""
    import time

    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.testing.synthetic import write_synthetic_model
    from vit_cpp_tpu_torch.testing.distributed import run_ranks

    path = str(tmp_path / "m.gguf")
    write_synthetic_model(path, VitHParams(hidden_size=64, num_hidden_layers=1,
                                           num_attention_heads=4, num_classes=8,
                                           patch_size=8, img_size=32), ftype=1, seed=0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank [01] (raised|exited)"):
        run_ranks(_follower_dies, 2, path, timeout=60)
    assert time.monotonic() - t0 < 60


def _row_partial_case(device):
    from vit_cpp_tpu_torch.ops.core import _matmul_f32

    gen = torch.Generator().manual_seed(11)
    x = torch.randn((2, 50, 384), generator=gen).to(torch.bfloat16)
    w = torch.randn((384, 768), generator=gen).to(torch.bfloat16)
    got = _matmul_f32(x.to(device), w.to(device)).cpu()
    ref = torch.matmul(x.double(), w.double())
    assert got.dtype == torch.float32 and got.shape == (2, 50, 768)
    # bf16 products are exact in f32: only the order of the f32 sum differs
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * ref.abs().max().item())


def test_row_partial_product_is_f32():
    """A bf16 row-parallel rank's partial product (what it sums over
    "model" before rounding) keeps f32, within 1e-5 of max|f64 product|."""
    _row_partial_case("cpu")


@pytest.mark.cuda
def test_row_partial_product_is_f32_on_the_card():
    """The same through torch.mm's f32 output on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _row_partial_case("cuda")


def test_a_collective_with_no_mesh_built_raises():
    """The forward's collective operators resolve their group from the
    meshes this process built: with none of that axis and size, they
    raise instead of running unsharded."""
    import vit_cpp_tpu_torch.parallel.mesh  # noqa: F401  (registers the operators)

    ops = torch.ops.vit_cpp_tpu_torch
    for call in (lambda: ops.all_reduce_over(torch.ones(2), "model", 3, "sum"),
                 lambda: ops.all_gather_over(torch.ones(2), "data", 5, 0)):
        with pytest.raises(RuntimeError, match="no mesh with a '(model|data)' axis of [35] "
                                               "ranks was built in this process"):
            call()
