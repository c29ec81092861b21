"""The port's `vit-convert` against the JAX package's.

Both converters read the same torch .pth files, made from numpy state
dicts with a seed (a plain ViT, a pre-norm one, DeiT-distilled,
registers, avg-pool, headless, ViTSTR, HF SigLIP and CLIP vision towers),
and must write the same bytes, in the legacy layout and the real GGUF
container, at ftype 0 and 1. The one deliberate difference: the port
keeps V-MoE routers f32 at ftype 1, as the quantizer does.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from vit_cpp_tpu.cli import convert as jax_convert
from vit_cpp_tpu.hparams import VitHParams as JaxHParams
from vit_cpp_tpu.testing.synthetic import random_state_dict
from vit_cpp_tpu_torch.cli import convert
from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType
from vit_cpp_tpu_torch.gguf.reader import read_model
from vit_cpp_tpu_torch.hparams import VitHParams

BASE = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            num_classes=10, patch_size=8, img_size=32)
FAMILIES = {
    "plain": {},
    "norm-pre": {"norm_pre": True},
    "distilled": {"num_prefix_tokens": 2},
    "registers": {"num_reg_tokens": 4},
    "avg-pool": {"global_pool": "avg"},
    "headless": {"num_classes": 0},
    "vitstr": {"num_classes": 96},
}


def _save(state, path):
    """A timm-style .pth: the unreshaped conv bias."""
    torch.save({k: torch.from_numpy(v.reshape(-1) if k == "patch_embed.proj.bias" else v)
                for k, v in state.items()}, path)
    return str(path)


def _both(tmp_path, ckpt, **kw):
    """Convert with each package into its own directory; the two files."""
    out = []
    for name, mod in (("port", convert), ("jax", jax_convert)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        out.append(mod.convert(checkpoint=ckpt, output_dir=str(d), verbose=False, **kw))
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("gguf", [False, True], ids=["legacy", "gguf"])
@pytest.mark.parametrize("ftype", [0, 1])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_converter_output_is_byte_identical(tmp_path, family, ftype, gguf):
    hp = JaxHParams(**{**BASE, **FAMILIES[family]})
    ckpt = _save(random_state_dict(hp, seed=3), tmp_path / "m.pth")
    ours, theirs = _both(tmp_path, ckpt, ftype=ftype, real_gguf=gguf, heads=2,
                         vitstr=family == "vitstr")
    assert os.path.basename(ours) == os.path.basename(theirs)
    assert _bytes(ours) == _bytes(theirs)


def test_drop_norm_pre_is_byte_identical(tmp_path):
    hp = JaxHParams(**BASE, norm_pre=True)
    ckpt = _save(random_state_dict(hp, seed=4), tmp_path / "m.pth")
    ours, theirs = _both(tmp_path, ckpt, ftype=0, drop_norm_pre=True, heads=2)
    assert _bytes(ours) == _bytes(theirs)
    assert "norm_pre.weight" not in read_model(ours).tensors


def _hf_siglip():
    from transformers import SiglipVisionConfig, SiglipVisionModel

    torch.manual_seed(0)
    return SiglipVisionModel(SiglipVisionConfig(
        hidden_size=64, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, image_size=32, patch_size=8)).eval()


def _hf_clip():
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(0)
    return CLIPVisionModel(CLIPVisionConfig(
        hidden_size=64, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=4, image_size=32, patch_size=8)).eval()


@pytest.mark.parametrize("ftype", [0, 1])
@pytest.mark.parametrize("tower", ["siglip", "clip"])
def test_hf_vision_towers_remap_to_the_same_bytes(tmp_path, tower, ftype):
    model = {"siglip": _hf_siglip, "clip": _hf_clip}[tower]()
    ckpt = str(tmp_path / "hf.pth")
    torch.save(model.state_dict(), ckpt)
    ours, theirs = _both(tmp_path, ckpt, ftype=ftype, heads=4)
    assert _bytes(ours) == _bytes(theirs)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    remap = {"siglip": convert.remap_hf_siglip, "clip": convert.remap_hf_clip}[tower]
    jax_remap = {"siglip": jax_convert.remap_hf_siglip, "clip": jax_convert.remap_hf_clip}[tower]
    got, want = remap(state), jax_remap(state)
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in got)
    assert remap({"not": np.zeros(1)}) is None


def test_moe_router_stays_f32_only_in_the_port(tmp_path):
    """ftype 1: the JAX converter writes a router f16; the port keeps it
    f32 (as vit-quantize does). Every other record is the same."""
    hp = JaxHParams(**BASE)
    state = random_state_dict(hp, seed=5)
    rng = np.random.default_rng(5)
    state["blocks.1.moe.router.weight"] = rng.standard_normal((4, 64)).astype(np.float32)
    ckpt = _save(state, tmp_path / "moe.pth")
    ours, theirs = (read_model(p) for p in _both(tmp_path, ckpt, ftype=1, heads=2))
    router = "blocks.1.moe.router.weight"
    assert ours.tensors[router].dtype == GGMLDType.F32
    assert theirs.tensors[router].dtype == GGMLDType.F16
    np.testing.assert_array_equal(ours.tensors[router].as_f32(), state[router])
    assert list(ours.tensors) == list(theirs.tensors)
    for name, rec in ours.tensors.items():
        if name != router:
            other = theirs.tensors[name]
            assert (rec.shape, rec.dtype) == (other.shape, other.dtype), name
            assert np.array_equal(rec.data, other.data), name
    assert dataclasses.asdict(ours.hparams) == dataclasses.asdict(theirs.hparams)


@pytest.mark.parametrize("ftype", [0, 1])
def test_serialize_state_dict_matches_jax_records(ftype):
    state = random_state_dict(JaxHParams(**BASE, num_prefix_tokens=2), seed=6)
    ours = list(convert.serialize_state_dict(state, ftype))
    theirs = list(jax_convert.serialize_state_dict(state, ftype))
    assert [(n, s, int(d)) for n, s, d, _ in ours] == [(n, s, int(d)) for n, s, d, _ in theirs]
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for (*_, a), (*_, b) in zip(ours, theirs))


# -- the cases of tests/test_convert.py ---------------------------------------


@pytest.fixture()
def torch_ckpt(tmp_path):
    hp = JaxHParams(**{**BASE, "hidden_size": 192, "num_attention_heads": 3,
                       "patch_size": 16, "img_size": 64})
    state = random_state_dict(hp, seed=3)
    return _save(state, tmp_path / "vit.pth"), hp, state


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_infer_hparams_matches_jax(family):
    state = random_state_dict(JaxHParams(**{**BASE, **FAMILIES[family]}), seed=7)
    got = convert.infer_hparams(state, heads=2)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_convert.infer_hparams(state, heads=2))


def test_infer_hparams_reads_heads_from_the_family_table(torch_ckpt):
    _, hp, state = torch_ckpt
    got = convert.infer_hparams(state)
    assert got.num_attention_heads == 3  # the 192 -> 3 family table
    assert (got.hidden_size, got.num_hidden_layers, got.patch_size, got.img_size,
            got.num_classes) == (192, 2, 16, 64, 10)


def test_infer_hparams_non_4x_mlp(torch_ckpt):
    _, hp, state = torch_ckpt
    st = dict(state)
    assert convert.infer_hparams(st).mlp_hidden is None
    wide = hp.hidden_size * 11 // 4
    for i in range(hp.num_hidden_layers):
        st[f"blocks.{i}.mlp.fc1.weight"] = np.zeros((wide, hp.hidden_size), np.float32)
        st[f"blocks.{i}.mlp.fc1.bias"] = np.zeros((wide,), np.float32)
        st[f"blocks.{i}.mlp.fc2.weight"] = np.zeros((hp.hidden_size, wide), np.float32)
    got = convert.infer_hparams(st)
    assert got.mlp_hidden == got.mlp_dim == wide
    assert got == VitHParams(**dataclasses.asdict(jax_convert.infer_hparams(st)))


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", [
    "both-norms", "no-norm", "ambiguous", "bad-embedded", "bad-grid", "dist-no-head",
    "reg-and-dist", "no-pool", "unknown-width",
])
def test_infer_hparams_errors_match_jax(case):
    hp = JaxHParams(**BASE)
    state = random_state_dict(hp, seed=8)
    layout = None
    if case == "both-norms":
        state["fc_norm.weight"] = state["norm.weight"]
    elif case == "no-norm":
        del state["norm.weight"]
    elif case in ("ambiguous", "bad-embedded", "bad-grid"):
        # 5 prefix rows (CLS + 4 registers) over 9 rows: 2x2 + 5 or a bare 3x3
        state = random_state_dict(JaxHParams(**{**BASE, "img_size": 16}, num_reg_tokens=4), 8)
        state["pos_embed"] = np.zeros((1, 9 if case == "ambiguous" else 10, 64), np.float32)
        layout = {"ambiguous": None, "bad-embedded": "embedded", "bad-grid": "grid"}[case]
    elif case == "dist-no-head":
        state = random_state_dict(JaxHParams(**BASE, num_prefix_tokens=2), 8)
        del state["head_dist.weight"]
    elif case == "reg-and-dist":
        state = random_state_dict(JaxHParams(**BASE, num_prefix_tokens=2), 8)
        state["reg_token"] = np.zeros((1, 4, 64), np.float32)
    elif case == "no-pool":
        del state["cls_token"]
        state["pos_embed"] = state["pos_embed"][:, 1:]
    ours = _error(convert.infer_hparams, state, heads=None if case == "unknown-width" else 2,
                  pos_layout=layout)
    if case == "unknown-width":
        state = random_state_dict(JaxHParams(**{**BASE, "hidden_size": 96,
                                                "num_attention_heads": 2}), 8)
        ours = _error(convert.infer_hparams, state)
        theirs = _error(jax_convert.infer_hparams, state)
    else:
        theirs = _error(jax_convert.infer_hparams, state, heads=2, pos_layout=layout)
    assert ours is not None and ours == theirs


def test_normalize_strips_prefixes_and_unwraps_nested():
    for raw in ({"module.vitstr.norm.weight": torch.ones(4)},
                {"state_dict": {"norm.weight": torch.ones(4)}},
                {"net": {"module.norm.weight": torch.ones(4)}}):
        got, want = convert.normalize_state_dict(raw), jax_convert.normalize_state_dict(raw)
        assert list(got) == list(want) == ["norm.weight"]
        assert np.array_equal(got["norm.weight"], want["norm.weight"])


def test_grayscale_collapse():
    pe = np.arange(2 * 3 * 4 * 4, dtype=np.float32).reshape(2, 3, 4, 4)
    out = convert.collapse_to_grayscale({"patch_embed.proj.weight": pe})
    assert out["patch_embed.proj.weight"].shape == (2, 1, 4, 4)
    np.testing.assert_array_equal(
        out["patch_embed.proj.weight"],
        jax_convert.collapse_to_grayscale({"patch_embed.proj.weight": pe})["patch_embed.proj.weight"],
    )


def test_f16_rules_and_forward_parity(torch_ckpt, tmp_path):
    """The converted file: the dtype rule and the conv-bias reshape, and
    the port's f32 engine on it against the JAX package's on the same
    file (summation order only: 1e-5)."""
    import jax.numpy as jnp

    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
    from vit_cpp_tpu_torch.engine import VitEngine

    path, hp, _ = torch_ckpt
    out = convert.convert(checkpoint=path, output_dir=str(tmp_path), ftype=1, verbose=False)
    mf = read_model(out)
    assert mf.tensors["pos_embed"].dtype == GGMLDType.F32
    assert mf.tensors["cls_token"].dtype == GGMLDType.F32
    assert mf.tensors["patch_embed.proj.weight"].dtype == GGMLDType.F16
    assert mf.tensors["blocks.0.attn.qkv.weight"].dtype == GGMLDType.F16
    assert mf.tensors["norm.weight"].dtype == GGMLDType.F32
    assert mf.tensors["patch_embed.proj.bias"].shape == (1, hp.hidden_size, 1, 1)
    assert len(mf.tensors) == mf.hparams.expected_tensor_count()
    x = np.random.default_rng(0).standard_normal((2, 3, 64, 64)).astype(np.float32)
    got = VitEngine(out, device="cpu", verbose=False).predict_probs_batch(torch.from_numpy(x))
    want = JaxVitEngine(out, verbose=False).predict_probs_batch(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_vitstr_conversion_labels_and_refusal(tmp_path):
    """--vitstr writes the 96-token vocabulary and a 1-channel patch conv,
    which the port reads as ViTSTR (seq_len 25); its classifier refuses
    the sequence head by name, as the JAX engine does."""
    from vit_cpp_tpu_torch.engine import VitEngine, detect_hparams

    hp = JaxHParams(**{**BASE, "num_classes": 96})
    ckpt = _save(random_state_dict(hp, seed=5), tmp_path / "vitstr.pth")
    out = convert.convert(checkpoint=ckpt, output_dir=str(tmp_path), ftype=1, vitstr=True,
                          heads=2, verbose=False)
    mf = read_model(out)
    assert mf.tensors["patch_embed.proj.weight"].shape[1] == 1
    assert (mf.id2label[0], mf.id2label[1], len(mf.id2label)) == ("[GO]", "[s]", 96)
    assert (detect_hparams(mf).in_chans, detect_hparams(mf).seq_len) == (1, 25)
    with pytest.raises(ValueError, match="ViTSTR"):
        VitEngine(out, device="cpu", verbose=False).classify_file(
            os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                         "vitstr", "demo_1.png"), verbose=False)


def test_real_gguf_container_reads_back(torch_ckpt, tmp_path):
    path, hp, _ = torch_ckpt
    out = convert.convert(checkpoint=path, output_dir=str(tmp_path), ftype=1, real_gguf=True,
                          verbose=False)
    assert _bytes(out)[:4] == b"GGUF"
    mf = read_model(out)
    assert mf.hparams.hidden_size == hp.hidden_size
    assert len(mf.tensors) == mf.hparams.expected_tensor_count()


def test_timm_name_source_points_to_checkpoint(capsys):
    """A timm name alone (the JAX tool's download source) exits with the
    usage error that asks for --checkpoint."""
    with pytest.raises(SystemExit) as exc:
        convert.main(["vit_tiny_patch16_224"])
    assert exc.value.code == 2
    assert "--checkpoint is required" in capsys.readouterr().err


def test_cli_requires_checkpoint(capsys):
    with pytest.raises(SystemExit) as exc:
        convert.main([])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--checkpoint is required" in err and "torch.save" in err


def test_cli_main_matches_jax(torch_ckpt, tmp_path, capsys):
    """`main` on the same flags: the same console lines, the same file,
    and the same message and exit code for a bad ftype. The JAX tool takes
    a (here unused) model name before the output directory; the port's
    one positional is the output directory."""
    path, _, _ = torch_ckpt
    runs = []
    for name, main, pos in (("port", convert.main, []), ("jax", jax_convert.main, ["vit"])):
        d = tmp_path / name
        d.mkdir()
        rc = main(["--checkpoint", path, "--heads", "3", "--gguf", *pos, str(d)])
        out, err = capsys.readouterr()
        runs.append((rc, out.replace(str(d), "OUT"), _bytes(d / "ggml-model-f16.gguf")))
        rc = main(["--checkpoint", path, "--ftype", "2", *pos, str(d)])
        runs[-1] += (rc, capsys.readouterr().err)
    assert runs[0] == runs[1]
    assert runs[0][0] == 0 and runs[0][3] == 1 and "ftype must be 0" in runs[0][4]
    # --real-gguf names the same container
    d = tmp_path / "alias"
    d.mkdir()
    assert convert.main(["--checkpoint", path, "--heads", "3", "--real-gguf", str(d)]) == 0
    assert _bytes(d / "ggml-model-f16.gguf") == runs[0][2]


def test_module_runs_as_a_command(torch_ckpt, tmp_path):
    """`python -m ...convert --checkpoint X OUT_DIR` (the JAX tool would
    take a lone positional as the timm name and write into the working
    directory)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path, _, _ = torch_ckpt
    proc = subprocess.run(
        [sys.executable, "-m", "vit_cpp_tpu_torch.cli.convert", "--checkpoint", path,
         "--ftype", "0", str(tmp_path)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Done. Output file:" in proc.stdout
    assert read_model(str(tmp_path / "ggml-model-f32.gguf")).hparams.hidden_size == 192
