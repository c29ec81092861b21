"""Training on a mesh of gloo CPU ranks against the JAX package's
create_train_state path (tests/test_parallel.py, tests/test_fsdp.py).

One spawn of 4 ranks runs 2x2 with and without FSDP and 4x1, the FSDP
memory check, the sharded checkpoint's resume, ViTSTR's accumulated
masked mean, LoRA over the sharded base, a V-MoE model and a 2x2 update
under "dots+attn" rematerialisation against one without; one spawn of 2
ranks runs the V-MoE model at 2x1; one spawn of 8 ranks runs 4x2 with and
without FSDP; one of 4 ranks runs `cli.finetune --mesh 2x2` with --lora,
--distill and --moe.

Tolerances: the losses of three updates within 1e-5 of JAX's; the first
update's gradient (gathered from the shards) within tests/test_torch_
train.py's gradient bound (atol 5e-5, rtol 1e-3), and so the parameters
after three updates, on the elements whose first-update gradient exceeds
1e-6 in magnitude: AdamW turns the rounding noise of a gradient that is
zero in exact arithmetic (the key bias: softmax ignores a shift common to
all keys) into a step of +-lr, whatever the implementation. tp > 1
matches tp = 1 to rel 1e-4 (tests/test_parallel.py's bound). Module-level
imports stay JAX-free: the spawned ranks import this module.
"""

import os

import numpy as np
import pytest
import torch

from vit_cpp_tpu_torch.testing.distributed import run_ranks

KW = dict(lr=1e-3, weight_decay=0.05)
HP_KW = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_classes=16,
             patch_size=8, img_size=32)
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)
MOE_HP_KW = dict(HP_KW, num_experts=4, moe_layers=(1,), moe_top_k=2)
LORA_KW = dict(lr=1e-3, weight_decay=0.05, clip_norm=0.5)
LORA_ALPHA = 8.0


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().float().numpy()


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return None if tree is None else torch.from_numpy(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: np.asarray(tree)}


def _grads(state):
    """The gathered gradient tree of a state (its last update's)."""
    from vit_cpp_tpu_torch.parallel.sharding import gather_params, tree_map

    grads = tree_map(lambda path, p: None if p is None else p.grad, state.params)
    return _np(gather_params(grads, state.specs, state.mesh))


def _local_bytes(state):
    from vit_cpp_tpu_torch.parallel import train as T

    n = 0
    for p in T.tree_leaves(state.params):
        n += T.local_tensor(p).numel() * 4
        for v in state.optimizer.adamw.state[p].values():
            if isinstance(v, torch.Tensor) and v.ndim:
                n += T.local_tensor(v).numel() * v.element_size()
    return n


def _train_rank(tree, x, y, meshes, extra, hp_kw=HP_KW):
    """3 updates per (dp, tp, fsdp) mesh -> losses, gathered first-update
    gradients and final parameters; `extra` adds the checks of the 2x2
    spawn (FSDP bytes, checkpoint resume, ViTSTR accumulation, LoRA, the
    V-MoE model)."""
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.parallel import train as T
    from vit_cpp_tpu_torch.parallel.checkpoint import restore_train_state, save_train_state
    from vit_cpp_tpu_torch.parallel.mesh import make_mesh
    from vit_cpp_tpu_torch.parallel.sharding import gather_params

    hp = VitHParams(**hp_kw)
    out = {}
    for dp, tp, fsdp in meshes:
        mesh = make_mesh(dp=dp, tp=tp)
        st = T.create_train_state(_torch(tree), KW, mesh=mesh, fsdp=fsdp)
        bx, by = T.shard_batch(torch.from_numpy(x), torch.from_numpy(y), mesh)
        losses = [float(T.train_step(st, bx, by, hp))]
        g1 = _grads(st)
        losses += [float(T.train_step(st, bx, by, hp)) for _ in range(2)]
        out[(dp, tp, fsdp)] = dict(losses=losses, grads=g1,
                                   params=_np(gather_params(st.params, st.specs, mesh)),
                                   bytes=_local_bytes(st))
    if extra:
        out["moe"] = _train_rank(extra["moe_tree"], x, y, [(2, 2, False)], None,
                                 MOE_HP_KW)[(2, 2, False)]
        mesh = make_mesh(dp=2, tp=2)
        bx, by = T.shard_batch(torch.from_numpy(x), torch.from_numpy(y), mesh)
        resumed = {}
        for fsdp in (False, True):
            ckpt = os.path.join(extra["dir"], f"ckpt-{fsdp}")
            a = T.create_train_state(_torch(tree), KW, mesh=mesh, fsdp=fsdp)
            T.train_step(a, bx, by, hp)
            save_train_state(ckpt, a)
            la = float(T.train_step(a, bx, by, hp))
            b = T.create_train_state(_torch(tree), KW, mesh=mesh, fsdp=fsdp)
            restore_train_state(ckpt, b)
            lb = float(T.train_step(b, bx, by, hp))
            pa, pb = (_flat(_np(gather_params(s.params, s.specs, mesh))) for s in (a, b))
            resumed[fsdp] = (la == lb and b.step == 2
                             and all(np.array_equal(pa[k], pb[k]) for k in pa))
        out["resumed"] = resumed
        # ViTSTR: the accumulated masked mean divides by the global count
        shp = VitHParams(**{**HP_KW, "seq_len": 5})
        st = T.create_train_state(_torch(extra["seq_tree"]), KW, mesh=mesh)
        sx, sy = T.shard_batch(torch.from_numpy(extra["seq_x"]),
                               torch.from_numpy(extra["seq_y"]), mesh)
        out["accum_loss"] = float(T.train_step_accum(st, sx, sy, shp, 2, seq=True))
        out["accum_grads"] = _grads(st)
        out["lora"] = _lora_updates(_torch(extra["lora_base"]), _torch(extra["lora_tr"]),
                                    torch.from_numpy(x), torch.from_numpy(y), hp, mesh)
        out["remat"] = _remat_updates(tree, x, y, hp, mesh)
    return out


def _remat_updates(tree, x, y, hp, mesh):
    """One 2x2 update (without and with FSDP, and with QAT's dynamic
    activation quantization, whose per-token absmax is all-reduced over
    "model") under the training losses' "dots+attn" and one with remat off
    -> per case: whether every rank's gradients and updated parameters are
    bit-equal between the two, the collectives rank 0 issued in each
    backward, and whether every rank issued the same sequence."""
    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode

    from vit_cpp_tpu_torch.parallel import train as T

    class Collectives(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            if "all_reduce" in name or "all_gather" in name or "reduce_scatter" in name:
                # the axis and size of the port's operators; a functional
                # collective's group name differs between the groups of a mesh
                kinds = (str, int) if name.startswith("vit_cpp_tpu_torch") else int
                self.calls.append((name, *(a for a in args[1:] if isinstance(a, kinds))))
            return func(*args, **(kwargs or {}))

    bx, by = T.shard_batch(torch.from_numpy(x), torch.from_numpy(y), mesh)
    out = {}
    for case, fsdp, qat in (("tp", False, ""), ("fsdp", True, ""), ("tp-qat", False, "w8a8")):
        runs = {}
        for mode in (False, "dots+attn"):
            T.TRAIN_REMAT = mode
            st = T.create_train_state(_torch(tree), KW, mesh=mesh, fsdp=fsdp)
            loss = T.cross_entropy_loss(st.params, bx, by, hp, qat=qat, mesh=mesh)
            st.optimizer.zero_grad()
            with Collectives() as seen:
                loss.backward()
            grads = [T.local_tensor(p.grad).clone() for p in st.optimizer.params]
            st.optimizer.step()
            runs[mode] = (grads, [T.local_tensor(p).detach().clone()
                                  for p in st.optimizer.params], seen.calls)
        T.TRAIN_REMAT = "dots+attn"
        (g0, p0, c0), (g1, p1, c1) = runs[False], runs["dots+attn"]
        equal = torch.tensor(int(all(torch.equal(a, b) for a, b in zip(g0 + p0, g1 + p1))))
        dist.all_reduce(equal, op=dist.ReduceOp.MIN)
        seqs = [None] * dist.get_world_size()
        dist.all_gather_object(seqs, (c0, c1))
        out[case] = dict(equal=bool(equal), calls=(c0, c1),
                         same_on_every_rank=all(s == seqs[0] for s in seqs))
    return out


def _lora_updates(base, trainable, x, y, hp, mesh=None):
    """Three LoRA updates over the frozen base (TP-sharded on a mesh) ->
    losses, the trained tree and, on a mesh, whether every rank holds the
    same trained tree bit for bit."""
    from vit_cpp_tpu_torch.parallel import train as T

    if mesh is None:
        st = T.create_train_state(trainable, LORA_KW)
    else:
        import torch.distributed as dist

        from vit_cpp_tpu_torch.parallel.sharding import shard_params

        base = shard_params(base, mesh)
        st = T.create_lora_train_state(trainable, LORA_KW, mesh=mesh)
        x, y = T.shard_batch(x, y, mesh)
    losses = [float(T.train_step_lora(st, base, x, y, hp, LORA_ALPHA)) for _ in range(3)]
    same = True
    if mesh is not None:
        flat = torch.cat([p.detach().reshape(-1) for p in T.tree_leaves(st.params)])
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        same = torch.equal(hi, lo)
    return dict(losses=losses, params=_np(st.params), same=same)


def _jax_setup(hp_kw=HP_KW):
    """The JAX package's tree of a dense (or, with MOE_HP_KW, a V-MoE)
    model and one batch."""
    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.models import params_from_state_dict
    from vit_cpp_tpu.testing.synthetic import random_state_dict

    hp = VitHParams(**hp_kw)
    jparams = params_from_state_dict(random_state_dict(hp, seed=0 if hp_kw is HP_KW else 6), hp)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 16, (8,)).astype(np.int32)
    return hp, jparams, x, y


def _seq_setup():
    """tests/test_parallel.py::test_accum_masked_loss_matches_global_mean's
    inputs: micro-batches with different valid-token counts."""
    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.models import params_from_state_dict
    from vit_cpp_tpu.testing.synthetic import random_state_dict
    from vit_cpp_tpu_torch.models.params import params_from_jax

    hp = VitHParams(**{**HP_KW, "seq_len": 5})
    tree = _np(params_from_jax(params_from_state_dict(random_state_dict(hp, seed=2), hp)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = rng.integers(2, 16, (4, 5))
    y[:, 0] = -1
    y[0, 2:] = -1
    y[1, 3:] = -1
    return tree, x, y.astype(np.int64)


def _lora_setup(jparams):
    """The JAX package's rank-4 adapters and head for `jparams`, `b` drawn
    nonzero (tests/test_torch_lora.py) so that `a`'s gradient is not zero."""
    from tests.test_torch_lora import _jax_trainable

    return _jax_trainable(jparams, 4, 9, 10)


_RUNS = {}


def _runs(tmp_path_factory, world):
    if world not in _RUNS:
        from vit_cpp_tpu_torch.models.params import params_from_jax

        _, jparams, x, y = _jax_setup()
        tree = _np(params_from_jax(jparams))
        if world == 4:
            seq_tree, sx, sy = _seq_setup()
            extra = dict(dir=str(tmp_path_factory.mktemp("mesh-ckpt")), seq_tree=seq_tree,
                         seq_x=sx, seq_y=sy, lora_base=tree,
                         lora_tr=_np(params_from_jax(_lora_setup(jparams))),
                         moe_tree=_np(params_from_jax(_jax_setup(MOE_HP_KW)[1])))
            meshes = [(2, 2, False), (2, 2, True), (4, 1, False)]
        else:
            extra, meshes = None, [(4, 2, False), (4, 2, True)]
        _RUNS[world] = run_ranks(_train_rank, world, tree, x, y, meshes, extra, timeout=300)
    return _RUNS[world]


_JAX = {}


def _jax_run(dp, tp, fsdp, hp_kw=HP_KW):
    """JAX's create_train_state path on its virtual mesh: 3 losses, the
    first update's gradient, the final parameters."""
    if (dp, tp, fsdp, hp_kw is HP_KW) not in _JAX:
        import jax
        import jax.numpy as jnp

        from vit_cpp_tpu.parallel import train as jt
        from vit_cpp_tpu.parallel.mesh import make_mesh

        hp, jparams, x, y = _jax_setup(hp_kw)
        mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])
        opt = jt.make_optimizer(**KW)
        g1 = jax.grad(jt.cross_entropy_loss)(jparams, jnp.asarray(x), jnp.asarray(y), hp)
        with mesh:
            st = jt.create_train_state(jparams, mesh, opt, fsdp=fsdp)
            si, sl = jt.shard_batch(jnp.asarray(x), jnp.asarray(y), mesh)
            losses = []
            for _ in range(3):
                st, loss = jt.train_step(st, si, sl, hp, opt)
                losses.append(float(loss))
        _JAX[(dp, tp, fsdp, hp_kw is HP_KW)] = (losses, _flat(g1), _flat(st.params))
    return _JAX[(dp, tp, fsdp, hp_kw is HP_KW)]


def _moe_run(tmp_path_factory, dp, tp):
    """The V-MoE model's three updates at dp x tp: 2x2 in the 4-rank spawn,
    2x1 in a spawn of its own."""
    if (dp, tp) == (2, 2):
        return _runs(tmp_path_factory, 4)["moe"]
    if "moe-2x1" not in _RUNS:
        from vit_cpp_tpu_torch.models.params import params_from_jax

        _, jparams, x, y = _jax_setup(MOE_HP_KW)
        _RUNS["moe-2x1"] = run_ranks(_train_rank, 2, _np(params_from_jax(jparams)), x, y,
                                     [(2, 1, False)], None, MOE_HP_KW,
                                     timeout=300)[(2, 1, False)]
    return _RUNS["moe-2x1"]


MESHES = [(2, 2, False), (2, 2, True), (4, 2, False), (4, 2, True), (2, 1, "moe"),
          (2, 2, "moe")]


@pytest.mark.parametrize("dp,tp,fsdp", MESHES,
                         ids=[f"{d}x{t}{'-' + str(f) if f == 'moe' else '-fsdp' if f else ''}"
                              for d, t, f in MESHES])
def test_train_on_mesh_matches_jax(tmp_path_factory, dp, tp, fsdp):
    """The "moe" cases train a V-MoE model (4 experts, top-2, on block 1)
    with the router's auxiliary losses: its load-balance term multiplies
    two batch means, which are the global batch's on every rank (the
    per-rank means averaged over "data"), as in JAX on a sharded batch."""
    if fsdp == "moe":
        got = _moe_run(tmp_path_factory, dp, tp)
        losses, g1, params = _jax_run(dp, tp, False, MOE_HP_KW)
    else:
        got = _runs(tmp_path_factory, dp * tp)[(dp, tp, fsdp)]
        losses, g1, params = _jax_run(dp, tp, fsdp)
    np.testing.assert_allclose(got["losses"], losses, atol=1e-5, rtol=0)
    ours_g, ours_p = _flat(got["grads"]), _flat(got["params"])
    assert ours_g.keys() == g1.keys() == ours_p.keys()
    for k in g1:
        np.testing.assert_allclose(ours_g[k], g1[k], **GRAD_TOL, err_msg=k)
        live = np.abs(g1[k]) > 1e-6
        np.testing.assert_allclose(ours_p[k][live], params[k][live], **GRAD_TOL, err_msg=k)
    assert got["losses"][2] < got["losses"][0]


def test_tp_matches_dp(tmp_path_factory):
    """TP=2 computes the update of pure data parallelism (the f/g
    collectives are right: an all-reduce backward at the row-parallel
    output would scale every gradient by tp)."""
    runs = _runs(tmp_path_factory, 4)
    np.testing.assert_allclose(runs[(2, 2, False)]["losses"], runs[(4, 1, False)]["losses"],
                               rtol=1e-4)
    a, b = _flat(runs[(2, 2, False)]["grads"]), _flat(runs[(4, 1, False)]["grads"])
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=1e-4, err_msg=k)


def test_fsdp_state_bytes_shrink_dp_fold(tmp_path_factory):
    """FSDP's per-rank parameter and moment bytes are at most 1/dp of the
    whole, plus the leaves that do not divide (here none: each has a dim
    that dp divides)."""
    from tests.test_torch_mesh import SizedMesh
    from vit_cpp_tpu_torch.parallel.sharding import fsdp_pspecs

    runs = _runs(tmp_path_factory, 4)
    whole = sum(v.size * 4 * 3 for v in _flat(runs[(2, 2, False)]["params"]).values())
    _, jparams, _, _ = _jax_setup()
    from vit_cpp_tpu_torch.models.params import params_from_jax

    ours = params_from_jax(jparams)
    specs = _flat_specs(fsdp_pspecs(ours, SizedMesh(2, 2)))
    leaves = _flat(_np(ours))
    undivided = sum(leaves[k].size * 4 * 3 for k, s in specs.items() if "data" not in s)
    assert runs[(2, 2, True)]["bytes"] <= whole / 2 + undivided
    assert runs[(2, 2, True)]["bytes"] < runs[(2, 2, False)]["bytes"]


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
def test_sharded_checkpoint_resumes_bit_equal(tmp_path_factory, fsdp):
    """save_train_state / restore_train_state on the same 2x2 mesh
    (torch.distributed.checkpoint): the resumed run's next update equals
    the uninterrupted one bit for bit."""
    assert _runs(tmp_path_factory, 4)["resumed"][fsdp]


def test_accum_masked_loss_is_the_global_mean(tmp_path_factory):
    """ViTSTR's accumulated masked loss on a 2x2 mesh (each rank's
    micro-batch holds a different count of valid positions) equals the
    unsharded masked mean over the whole batch, gradients included."""
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.parallel import train as T

    runs = _runs(tmp_path_factory, 4)
    tree, x, y = _seq_setup()
    params = _torch(tree)
    for leaf in T.tree_leaves(params):
        leaf.requires_grad_(True)
    loss = T.vitstr_cross_entropy_loss(params, torch.from_numpy(x), torch.from_numpy(y),
                                       VitHParams(**{**HP_KW, "seq_len": 5}))
    loss.backward()
    np.testing.assert_allclose(runs["accum_loss"], float(loss.detach()), rtol=1e-5)
    want = _flat(_np({k: _grad_tree(v) for k, v in params.items()}))
    got = _flat(runs["accum_grads"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", ["tp", "fsdp", "tp-qat"])
def test_remat_on_mesh_is_bit_equal_and_issues_no_collective_again(tmp_path_factory, case):
    """A 2x2 update under "dots+attn" (the training losses' policy) is bit
    for bit the update with remat off on every rank: the policy saves the
    collectives' outputs, so the backward issues exactly the collectives
    of the run without remat (the f / g backward all-reduces, FSDP's
    reduce-scatters), none again for the recompute (QAT's absmax
    all-reduce included), in the same order on every rank."""
    got = _runs(tmp_path_factory, 4)["remat"][case]
    assert got["equal"]
    plain, remat = got["calls"]
    assert plain and remat == plain
    assert got["same_on_every_rank"]


def test_lora_on_mesh_matches_unsharded_and_jax(tmp_path_factory):
    """LoRA on a 2x2 mesh over the TP-sharded base, with a global-norm
    clip: every rank ends with the same adapters and head bit for bit, the
    losses of three updates are within 1e-5 of the JAX package's unsharded
    train_step_lora and of the port's unsharded run, and the trained tree
    is within the gradient bound of the port's unsharded one. An adapter
    whose gradient were left to each model rank's own columns or rows
    would drift apart across the ranks and fail all three."""
    import jax
    import jax.numpy as jnp

    from vit_cpp_tpu.parallel import train as jt
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.models.params import params_from_jax

    got = _runs(tmp_path_factory, 4)["lora"]
    hp, jparams, x, y = _jax_setup()
    jtr = _lora_setup(jparams)
    one = _lora_updates(params_from_jax(jparams), params_from_jax(jtr), torch.from_numpy(x),
                        torch.from_numpy(y), VitHParams(**HP_KW))
    opt = jt.make_optimizer(**LORA_KW)
    jstate = jt.TrainState(jax.tree.map(jnp.array, jtr), opt.init(jtr), jnp.zeros((), jnp.int32))
    want = []
    for _ in range(3):
        jstate, loss = jt.train_step_lora(jstate, jparams, jnp.asarray(x), jnp.asarray(y), hp,
                                          opt, alpha=LORA_ALPHA)
        want.append(float(loss))
    assert got["same"]
    np.testing.assert_allclose(got["losses"], want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["losses"], one["losses"], atol=1e-5, rtol=0)
    ours, ref = _flat(got["params"]), _flat(one["params"])
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], **GRAD_TOL, err_msg=k)
    assert got["losses"][2] < got["losses"][0]


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.grad


def _finetune_rank(model, data, teacher, out_dir):
    """cli.finetune --mesh 2x2 with --lora, --distill and --moe."""
    from vit_cpp_tpu_torch.cli.finetune import main

    base = ["-m", model, "-d", data, "-b", "4", "--epochs", "1", "--device", "cpu",
            "--mesh", "2x2"]
    runs = {"lora": ["--lora", "4"], "distill": ["--distill", teacher],
            "moe": ["--moe", "4", "--moe-top-k", "2"]}
    rcs = {k: main([*base, "-o", os.path.join(out_dir, f"{k}.gguf"), *flags])
           for k, flags in runs.items()}
    if any(rcs.values()):
        raise RuntimeError(f"finetune exit codes {rcs}")
    return rcs


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from PIL import Image

    from vit_cpp_tpu.hparams import VitHParams
    from vit_cpp_tpu.testing.synthetic import write_synthetic_model

    d = tmp_path_factory.mktemp("mesh-ft")
    rng = np.random.default_rng(0)
    for c, lo in (("aa_dark", 0), ("bb_bright", 128)):
        os.makedirs(d / "data" / c)
        for i in range(4):
            Image.fromarray(rng.integers(lo, lo + 128, (32, 32, 3), dtype=np.uint8)).save(
                d / "data" / c / f"{i}.png")
    hp = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                    num_classes=2, patch_size=8, img_size=32)
    write_synthetic_model(str(d / "m.gguf"), hp, ftype=1, seed=1)
    write_synthetic_model(str(d / "t.gguf"), hp, ftype=1, seed=5)
    return d


def test_cli_finetune_mesh_2x2_runs_lora_distill_moe(dataset):
    """Each trains one epoch on four gloo ranks, rank 0 writes the gguf,
    and the output serves."""
    from vit_cpp_tpu_torch.engine import VitEngine

    d = dataset
    run_ranks(_finetune_rank, 4, str(d / "m.gguf"), str(d / "data"), str(d / "t.gguf"),
              str(d), timeout=300)
    x = torch.zeros(2, 3, 32, 32)
    for k in ("lora", "distill", "moe"):
        engine = VitEngine(str(d / f"{k}.gguf"), verbose=False, device="cpu")
        p = engine.predict_probs_batch(x)
        assert p.shape == (2, 2) and torch.isfinite(p).all(), k
    assert VitEngine(str(d / "moe.gguf"), verbose=False, device="cpu").hp.num_experts == 4


def test_finetune_mesh_1x1_fsdp_matches_unsharded(dataset):
    """A 1x1 mesh with FSDP in this process (a 1-rank group, as the card
    runs it under NCCL): the losses of the unsharded run."""
    from vit_cpp_tpu_torch.finetune import finetune
    from vit_cpp_tpu_torch.parallel.mesh import make_mesh

    d = dataset
    kw = dict(epochs=2, batch=4, lr=1e-3, log=lambda m: None, device="cpu")
    _, _, _, plain = finetune(str(d / "m.gguf"), str(d / "data"), **kw)
    _, _, _, sharded = finetune(str(d / "m.gguf"), str(d / "data"), mesh=make_mesh(1, 1, 1),
                                fsdp=True, **kw)
    np.testing.assert_allclose(sharded, plain, atol=1e-5, rtol=0)
