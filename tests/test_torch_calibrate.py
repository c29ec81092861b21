"""Static W8A8 activation scales in the port against the JAX package's.

Both packages load the same synthetic f16 checkpoint (h=64, L=2, 10
classes, 32 px) and see the same numpy-made, structured pixel batches
(smooth gradients plus texture, as in tests/test_w8a8_accuracy.py). On
the CPU the port runs its kernels' plain versions, the JAX package its
XLA paths. Each tolerance is stated at its assertion.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.engine import VitEngine as JaxVitEngine
from vit_cpp_tpu.gguf.reader import read_model as jax_read_model
from vit_cpp_tpu.hparams import VitHParams as JaxHParams
from vit_cpp_tpu.models.fold import fold_layernorms as jax_fold
from vit_cpp_tpu.models.params import load_params as jax_load_params
from vit_cpp_tpu.models.vit import forward as jax_forward
from vit_cpp_tpu.models.vit import transformer_block as jax_block
from vit_cpp_tpu.quant import calibrate as jax_cal
from vit_cpp_tpu.quant import qat as jax_qat
from vit_cpp_tpu.quant.int8 import convert_params_to_int8 as jax_to_int8
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.engine import VitEngine
from vit_cpp_tpu_torch.gguf.reader import read_model
from vit_cpp_tpu_torch.models.fold import fold_layernorms
from vit_cpp_tpu_torch.models.params import load_params
from vit_cpp_tpu_torch.models.vit import embed, forward, transformer_block, unstack_blocks
from vit_cpp_tpu_torch.ops.int8_matmul import quantize_activations, w8a8_matmul
from vit_cpp_tpu_torch.quant import calibrate, qat
from vit_cpp_tpu_torch.quant.int8 import (
    Int8Linear,
    channelwise_int8,
    convert_params_to_int8,
    params_have_static_scales,
)

BASE = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            num_classes=10, patch_size=8, img_size=32)
FAMILIES = {
    "cls": {},
    "avg-pool": {"global_pool": "avg"},
    "distilled": {"num_prefix_tokens": 2},
    "registers": {"num_reg_tokens": 4},
    "headless": {"num_classes": 0},
}
GEMMS = ("qkv", "proj", "fc1", "fc2")
# The maxima are f32 reductions of activations that the two packages sum
# in another order (LayerNorm, the matmuls): relative 1e-5 (measured at
# most 2.7e-7 over every family, folded and not). Behind a dynamic W8A8
# product an activation code can flip where the two sums straddle a
# rounding boundary, as in the serving-f32 engine test. Of these trees it
# happens at one site only, the fc2 input of the folded distilled tree's
# second block (measured 3.9e-4), held to 1e-3.
MAXIMA_RTOL = 1e-5
CODE_FLIP_RTOL = {("distilled", True, "fc2"): 1e-3}
# static forwards with the same scales: the int8 codes and accumulators
# are exact; the f32 epilogues and the float ops between them differ by
# summation order, and a code can flip where the two sums straddle a
# rounding boundary: the W8A8 bound of tests/test_torch_int8.py
LOGIT_RTOL = 2 ** -7


def structured_images(n, seed=21, size=32):
    """Smooth gradients plus texture, normalized like preprocessed
    pixels: token activations carry correlated structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size))
    imgs = []
    for _ in range(n):
        fx, fy = rng.uniform(0.5, 6, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        base = np.stack([np.sin(fx * xx * np.pi + p) * np.cos(fy * yy * np.pi) for p in phase])
        tex = 0.3 * rng.standard_normal((3, size, size))
        imgs.append((base + tex).astype(np.float32))
    return np.stack(imgs)


def _file(tmp_path_factory, family="cls"):
    path = str(tmp_path_factory.mktemp(f"cal-{family}") / "m.gguf")
    write_synthetic_model(path, JaxHParams(**{**BASE, **FAMILIES[family]}), ftype=1, seed=13)
    return path


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return _file(tmp_path_factory)


def _trees(path, fold=False):
    """(port int8 tree, JAX int8 tree, hparams) of one file, f32."""
    mf = read_model(path)
    hp = VitEngine(path, device="cpu", verbose=False).hp
    ours = convert_params_to_int8(load_params(mf, dtype=torch.float32, hparams=hp, device="cpu"))
    theirs = jax_to_int8(jax_load_params(jax_read_model(path)))
    if fold:
        ours = fold_layernorms(ours, mm_impl="int8")
        theirs = jax_fold(theirs, mm_impl="int8")
    return ours, theirs, hp


def _jax_hp(hp):
    return JaxHParams(**dataclasses.asdict(hp))


def _scales(tree):
    """{site: act_scale as numpy} of an int8 tree."""
    out = {n: np.array(tree["blocks"][n]["kernel"].act_scale) for n in GEMMS}
    if "head" in tree:
        out["head"] = np.array(tree["head"]["kernel"].act_scale)
    return out


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_collect_act_maxima_matches_jax(tmp_path_factory, family, fold):
    """Every site's maximum, the pooled readout's too; folded trees read
    the head's input after the affine-free norm, where the JAX tree reads
    it (the port's features_norm leaf stays out of it)."""
    ours, theirs, hp = _trees(_file(tmp_path_factory, family), fold=fold)
    x = structured_images(8)
    got = calibrate.collect_act_maxima(ours, torch.from_numpy(x), hp)
    want = jax_cal.collect_act_maxima(theirs, jnp.asarray(x), _jax_hp(hp))
    assert set(got) == set(want) == {*GEMMS, "head"}
    for name in got:
        assert got[name].shape == np.shape(want[name]), name
        rtol = CODE_FLIP_RTOL.get((family, fold, name), MAXIMA_RTOL)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=rtol, atol=0, err_msg=name)


def test_attention_pooled_and_sequence_heads_raise(model):
    """Attention-pooled (SigLIP) and sequence (ViTSTR) heads calibrate
    since the model-families slice (test_model_family_maxima_match_jax
    below); on this path a V-MoE model is what still raises: static
    scales are unsupported for MoE, for the JAX engine's reason."""
    ours, _, hp = _trees(model)
    x = torch.from_numpy(structured_images(2))
    with pytest.raises(ValueError, match="static act scales are unsupported for MoE"):
        calibrate.collect_act_maxima(ours, x, dataclasses.replace(hp, num_experts=2))


MODEL_FAMILIES = {
    # ViTSTR: 1 channel, the 25-row sequence head (T=37 at 48 px, patch 8)
    "vitstr": (dict(BASE, num_classes=96, img_size=48, in_chans=1, seq_len=25), 1),
    # SigLIP: no CLS token, attention pooling, a 5-class head on the pool
    "siglip": (dict(BASE, num_classes=5, num_prefix_tokens=0, global_pool="map",
                    pixel_norm="unit"), 3),
}


def _family_trees(path, fold):
    """(port int8 tree, JAX int8 tree, hparams) with each package's
    detected hparams."""
    from vit_cpp_tpu.engine import detect_hparams as jax_detect
    from vit_cpp_tpu_torch.engine import detect_hparams

    mf, jmf = read_model(path), jax_read_model(path)
    hp = detect_hparams(mf)
    ours = convert_params_to_int8(load_params(mf, dtype=torch.float32, hparams=hp, device="cpu"))
    theirs = jax_to_int8(jax_load_params(jmf, hparams=jax_detect(jmf)))
    if fold:
        ours = fold_layernorms(ours, mm_impl="int8")
        theirs = jax_fold(theirs, mm_impl="int8")
    return ours, theirs, hp


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("family", sorted(MODEL_FAMILIES))
def test_model_family_maxima_match_jax(tmp_path_factory, family, fold):
    """Static scales for both families: every site's maximum and the
    head's (the 25 normed rows of the sequence readout, the output of the
    attention pool) equal the JAX maxima within MAXIMA_RTOL, and so do the
    attached scales; a SigLIP tree keeps its final norm when folded."""
    geometry, chans = MODEL_FAMILIES[family]
    path = str(tmp_path_factory.mktemp(f"cal-{family}") / "m.gguf")
    write_synthetic_model(path, JaxHParams(**geometry), ftype=1, seed=17)
    ours, theirs, hp = _family_trees(path, fold)
    x = structured_images(6, size=hp.img_size)[:, :chans]
    got = calibrate.collect_act_maxima(ours, torch.from_numpy(x), hp)
    want = jax_cal.collect_act_maxima(theirs, jnp.asarray(x), _jax_hp(hp))
    assert set(got) == set(want) == {*GEMMS, "head"}
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=MAXIMA_RTOL, atol=0, err_msg=name)
    static = calibrate.calibrate_act_scales(ours, torch.from_numpy(x), hp)
    jax_static = jax_cal.calibrate_act_scales(theirs, jnp.asarray(x), _jax_hp(hp))
    for name, scale in _scales(static).items():
        np.testing.assert_allclose(scale, _scales(jax_static)[name], rtol=MAXIMA_RTOL,
                                   err_msg=name)
    assert (static["norm"]["scale"] is None) == (fold and family == "vitstr")


def test_static_engines_serve_both_families(tmp_path_factory):
    """VitstrEngine and the SigLIP engine with act_quant="static" calibrate
    on a batch, pass the guardrail and serve finite probabilities of the
    dynamic engine's shape. These random 2-layer models have near-tied
    logits, so the guardrail and the top-1 check against the dynamic
    engine ask for half the predictions (per position for ViTSTR), not
    the serving default 0.90."""
    from vit_cpp_tpu_torch.engine import VitstrEngine

    for family, (geometry, chans) in sorted(MODEL_FAMILIES.items()):
        path = str(tmp_path_factory.mktemp(f"static-{family}") / "m.gguf")
        write_synthetic_model(path, JaxHParams(**geometry), ftype=1, seed=19)
        cls = VitstrEngine if family == "vitstr" else VitEngine
        x = torch.from_numpy(structured_images(4, size=geometry["img_size"])[:, :chans])
        engine = cls(path, device="cpu", verbose=False, mm_impl="int8", act_quant="static")
        engine.calibrate(x, min_agreement=0.5)
        assert params_have_static_scales(engine.params), family
        dynamic = cls(path, device="cpu", verbose=False, mm_impl="int8")
        got, want = engine.predict_probs_batch(x), dynamic.predict_probs_batch(x)
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.5


def test_calibrate_needs_an_int8_tree(model):
    mf = read_model(model)
    dense = load_params(mf, dtype=torch.float32, hparams=mf.hparams, device="cpu")
    for fn in (lambda: calibrate.calibrate_act_scales(dense, torch.zeros(1, 3, 32, 32), mf.hparams),
               lambda: calibrate.attach_act_scales(dense, {})):
        with pytest.raises(ValueError, match="int8-converted tree"):
            fn()


def _jax_static(fold=False, path=None, ncal=16, seed=21):
    """A JAX tree calibrated on `ncal` images, and the port tree with the
    same scales attached by the port's attach_act_scales."""
    ours, theirs, hp = _trees(path, fold=fold)
    x = structured_images(ncal, seed=seed)
    static = jax_cal.calibrate_act_scales(theirs, jnp.asarray(x), _jax_hp(hp))
    return ours, theirs, calibrate.attach_act_scales(ours, _scales(static)), static, hp


def test_first_qkv_input_codes_are_bit_equal(model):
    """Identical scales: the static codes of the first block's qkv input,
    each package quantizing its own activations."""
    _, _, ours, theirs, hp = _jax_static(path=model)
    x = structured_images(4, seed=3)
    taps = {}

    def tap(store):
        return lambda name, v: store.setdefault(name, v)

    bp = unstack_blocks(ours["blocks"], hp.num_hidden_layers)[0]
    transformer_block(embed(ours, torch.from_numpy(x), hp), bp, hp, attn_impl="xla",
                      mm_impl="int8", tap=tap(taps.setdefault("port", {})))
    from vit_cpp_tpu.models.vit import embed as jax_embed, slice_block_params

    jbp = {k: slice_block_params(v, 0) for k, v in theirs["blocks"].items()}
    jax_block(jax_embed(theirs, jnp.asarray(x), _jax_hp(hp)), jbp, _jax_hp(hp), attn_impl="xla",
              mm_impl="int8", tap=tap(taps.setdefault("jax", {})))
    leaf = bp["qkv"]["kernel"]
    codes, sx = quantize_activations(taps["port"]["qkv_in"], leaf)
    s = jbp["qkv"]["kernel"].act_scale
    want = jnp.round(jnp.clip(taps["jax"]["qkv_in"].astype(jnp.float32) / s, -127.0, 127.0))
    assert sx.item() == np.asarray(s).item()
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want.astype(jnp.int8)))


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_static_forward_matches_jax(model, fold):
    _, _, ours, theirs, hp = _jax_static(fold=fold, path=model)
    assert params_have_static_scales(ours) and not params_have_static_scales(_trees(model)[0])
    x = structured_images(16, seed=5)
    got = forward(ours, torch.from_numpy(x), hp, mm_impl="int8").numpy()
    want = np.asarray(jax_forward(theirs, jnp.asarray(x), _jax_hp(hp), mm_impl="int8"))
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=1e-6)


def test_port_calibration_equals_jax_calibration(model):
    """calibrate_act_scales itself: the same scales (margin 1.05, floor
    1e-12) at the JAX shapes, (L, 1, 1) per site and (1, 1) for the head."""
    ours, theirs, hp = _trees(model)
    x = structured_images(16)
    got = _scales(calibrate.calibrate_act_scales(ours, torch.from_numpy(x), hp))
    want = _scales(jax_cal.calibrate_act_scales(theirs, jnp.asarray(x), _jax_hp(hp)))
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=MAXIMA_RTOL, atol=0)
    assert got["qkv"].shape == (hp.num_hidden_layers, 1, 1) and got["head"].shape == (1, 1)
    assert all((v > 0).all() for v in got.values())


def test_scale_floor_and_shared_head_scale(tmp_path_factory, monkeypatch):
    """A site whose maximum is 0 gets the 1e-12 floor, not 0; a distilled
    tree's two heads share one scale, read over both prefix tokens."""
    ours, _, hp = _trees(_file(tmp_path_factory, "distilled"))
    x = torch.from_numpy(structured_images(4))
    static = calibrate.calibrate_act_scales(ours, x, hp)
    assert torch.equal(static["head"]["kernel"].act_scale, static["head_dist"]["kernel"].act_scale)
    real = calibrate.collect_act_maxima

    def zero_proj(*args, **kw):
        out = real(*args, **kw)
        out["proj"] = torch.zeros_like(out["proj"])
        return out

    monkeypatch.setattr(calibrate, "collect_act_maxima", zero_proj)
    floored = calibrate.calibrate_act_scales(ours, x, hp)
    assert torch.equal(floored["blocks"]["proj"]["kernel"].act_scale,
                       torch.full((hp.num_hidden_layers, 1, 1), 1e-12))


def test_sidecar_round_trips_both_ways(model, tmp_path):
    """port save -> JAX load and JAX save -> port load give the same
    scales at the same shapes."""
    _, _, ours, static, hp = _jax_static(path=model)
    scales = _scales(static)
    port_file, jax_file = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    qat.save_act_scales(port_file, {k: torch.from_numpy(v) for k, v in scales.items()}, 1.05)
    jax_qat.save_act_scales(jax_file, {k: jnp.asarray(v) for k, v in scales.items()}, 1.05)
    for got, want in ((jax_qat.load_act_scales(port_file), scales),
                      (qat.load_act_scales(jax_file), scales)):
        assert set(got) == set(want)
        for k in want:
            assert np.shape(got[k]) == want[k].shape
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    with open(port_file) as f:
        assert json.load(f)["rule"] == "absmax*margin/127"
    broken = str(tmp_path / "broken.json")
    with open(broken, "w") as f:
        json.dump({"qkv": [1.0]}, f)
    with pytest.raises(ValueError, match="missing 'proj'"):
        qat.load_act_scales(broken)


# -- counterparts of tests/test_w8a8_accuracy.py's static-scale tests ---------


def _agreement(dyn, st):
    return float((dyn.argmax(-1) == st.argmax(-1)).mean())


@pytest.mark.parametrize("case", ["in-distribution", "ncal-4", "noise", "gain-shift"])
def test_static_vs_dynamic_agreement_matches_jax(model, case):
    """Calibrate on one set, serve another: the port's static-vs-dynamic
    top-1 agreement and relative logit MAE equal the JAX package's on the
    same images (within one image of 48, MAE within 1e-3), and the JAX
    test's floors hold (0.90 and 5% in distribution, 0.80-0.85 shifted)."""
    ours, theirs, hp = _trees(model)
    imgs = structured_images(48)
    cal = {
        "in-distribution": imgs[:16],
        "ncal-4": imgs[:4],
        "noise": np.random.default_rng(31).standard_normal((16, 3, 32, 32)).astype(np.float32),
        "gain-shift": imgs[:8] * 0.05,
    }[case]
    served = imgs * 20.0 if case == "gain-shift" else imgs
    st = calibrate.calibrate_act_scales(ours, torch.from_numpy(cal), hp)
    jst = jax_cal.calibrate_act_scales(theirs, jnp.asarray(cal), _jax_hp(hp))
    t = torch.from_numpy(served)
    dyn, sta = (forward(p, t, hp, mm_impl="int8").numpy() for p in (ours, st))
    jdyn, jsta = (np.asarray(jax_forward(p, jnp.asarray(served), _jax_hp(hp), mm_impl="int8"))
                  for p in (theirs, jst))
    agree, jagree = _agreement(dyn, sta), _agreement(jdyn, jsta)
    mae = np.abs(dyn - sta).mean() / np.abs(dyn).mean()
    jmae = np.abs(jdyn - jsta).mean() / np.abs(jdyn).mean()
    assert abs(agree - jagree) <= 1 / 48 + 1e-9
    assert abs(mae - jmae) <= 1e-3
    assert agree >= {"in-distribution": 0.90, "ncal-4": 0.80}.get(case, 0.85)
    if case == "in-distribution":
        assert mae < 0.05


def test_static_w8a8_matmul_unit_and_clipping():
    """One static linear against x @ w (3% of max|y|) and against the JAX
    package's; an out-of-range input clips at 127 codes instead of
    wrapping."""
    from vit_cpp_tpu.ops.pallas_int8_matmul import w8a8_matmul as jax_w8a8
    from vit_cpp_tpu.quant.int8 import channelwise_int8 as jax_channelwise

    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 96)).astype(np.float32) * 0.1
    x = rng.standard_normal((9, 64)).astype(np.float32)
    s = np.float32(np.abs(x).max() / 127.0)
    leaf = dataclasses.replace(channelwise_int8(torch.from_numpy(w)),
                               act_scale=torch.tensor([[s]]))
    jleaf = dataclasses.replace(jax_channelwise(jnp.asarray(w)), act_scale=jnp.asarray([[s]]))
    got = w8a8_matmul(torch.from_numpy(x), leaf).numpy()
    want = x @ w
    assert np.abs(got - want).max() / np.abs(want).max() < 0.03
    np.testing.assert_allclose(got, np.asarray(jax_w8a8(jnp.asarray(x), jleaf)), rtol=1e-6,
                               atol=1e-6)
    hot = x.copy()
    hot[0, 0] = 1e6
    got_hot = w8a8_matmul(torch.from_numpy(hot), leaf).numpy()
    assert np.isfinite(got_hot).all()
    codes, _ = quantize_activations(torch.from_numpy(hot), leaf)
    assert int(codes[0, 0]) == 127


def _engines(path, **kw):
    """The port's and the JAX package's f32 W8A8 engines (composed
    attention, fold off) on one file."""
    return (VitEngine(path, mm_impl="int8", device="cpu", verbose=False, **kw),
            JaxVitEngine(path, mm_impl="int8", verbose=False, **kw))


def test_engine_lazy_calibration_matches_jax(model):
    """act_quant="static" without scales: the first served batch
    calibrates; the scales and the probabilities then match the JAX
    engine's (probabilities within 1e-4: the same scales up to 1e-5
    relative, then the W8A8 forward)."""
    ours, theirs = _engines(model, act_quant="static")
    imgs = structured_images(8)
    assert ours._needs_calibration and not params_have_static_scales(ours.params)
    got = ours.predict_probs_batch(torch.from_numpy(imgs)).numpy()
    want = np.asarray(theirs.predict_probs_batch(jnp.asarray(imgs)))
    assert not ours._needs_calibration and params_have_static_scales(ours.params)
    for name, scale in _scales(theirs.params).items():
        np.testing.assert_allclose(_scales(ours.params)[name], scale, rtol=MAXIMA_RTOL)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # a second batch serves with the fixed scales
    before = _scales(ours.params)
    ours.predict_probs_batch(torch.from_numpy(structured_images(4, seed=9)))
    assert all(np.array_equal(before[k], v) for k, v in _scales(ours.params).items())


def test_explicit_calibration_and_features(model):
    """calibrate() on a sample, then features_batch on the static path:
    within the W8A8 bound of the JAX engine's features with the same
    calibration."""
    ours, theirs = _engines(model, act_quant="static")
    cal = structured_images(16)
    ours.calibrate(torch.from_numpy(cal))
    theirs.calibrate(jnp.asarray(cal))
    x = structured_images(6, seed=4)
    got = ours.features_batch(torch.from_numpy(x)).numpy()
    want = np.asarray(theirs.features_batch(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=1e-4)


def test_saturated_scales_are_caught_by_the_guardrail(model):
    """Scales 30x too small clip at 127 codes: validate_act_scales
    refuses them in both packages; honest scales pass with the JAX
    package's agreement."""
    ours, theirs, hp = _trees(model)
    imgs = structured_images(32)
    good = calibrate.calibrate_act_scales(ours, torch.from_numpy(imgs[:16]), hp)
    jgood = jax_cal.calibrate_act_scales(theirs, jnp.asarray(imgs[:16]), _jax_hp(hp))
    agreement = calibrate.validate_act_scales(good, ours, torch.from_numpy(imgs), hp)
    jagreement = jax_cal.validate_act_scales(jgood, theirs, jnp.asarray(imgs), _jax_hp(hp))
    assert agreement >= 0.90 and abs(agreement - jagreement) <= 1 / 32 + 1e-9
    bad = calibrate.attach_act_scales(ours, {k: v / 30.0 for k, v in _scales(good).items()
                                             if k != "head"})
    jbad = jax_cal.attach_act_scales(theirs, {k: v / 30.0 for k, v in _scales(jgood).items()
                                              if k != "head"})
    with pytest.raises(ValueError, match="under-represents"):
        calibrate.validate_act_scales(bad, ours, torch.from_numpy(imgs), hp)
    with pytest.raises(ValueError, match="under-represents"):
        jax_cal.validate_act_scales(jbad, theirs, jnp.asarray(imgs), _jax_hp(hp))


def test_headless_guardrail_compares_feature_argmax(tmp_path_factory):
    ours, theirs, hp = _trees(_file(tmp_path_factory, "headless"))
    imgs = structured_images(16)
    good = calibrate.calibrate_act_scales(ours, torch.from_numpy(imgs), hp)
    jgood = jax_cal.calibrate_act_scales(theirs, jnp.asarray(imgs), _jax_hp(hp))
    got = calibrate.validate_act_scales(good, ours, torch.from_numpy(imgs), hp, min_agreement=0)
    want = jax_cal.validate_act_scales(jgood, theirs, jnp.asarray(imgs), _jax_hp(hp),
                                       min_agreement=0)
    assert abs(got - want) <= 1 / 16 + 1e-9


def test_engine_falls_back_to_dynamic_on_rejection(model, capsys):
    """A rejected calibration warns on stderr, as the JAX engine does, and
    the engine serves exactly what the dynamic engine serves."""
    ours, theirs = _engines(model, act_quant="static")
    imgs = structured_images(12)
    ours.calibrate(torch.from_numpy(imgs[:8]), probe=torch.from_numpy(imgs[8:]),
                   min_agreement=1.01)
    err = capsys.readouterr().err
    theirs.calibrate(jnp.asarray(imgs[:8]), probe=jnp.asarray(imgs[8:]), min_agreement=1.01)
    assert err == capsys.readouterr().err
    assert "vit: static calibration rejected" in err and "dynamic activation scales" in err
    assert not params_have_static_scales(ours.params) and not ours._needs_calibration
    dynamic = VitEngine(model, mm_impl="int8", device="cpu", verbose=False)
    x = torch.from_numpy(imgs[:4])
    assert torch.equal(ours.predict_probs_batch(x), dynamic.predict_probs_batch(x))


@pytest.mark.parametrize("kw,match", [
    ({"act_quant": "static", "mm_impl": "xla"}, "requires mm_impl='int8'"),
    ({"act_quant": "static", "mm_impl": "pallas"}, "requires mm_impl='int8'"),
    ({"act_quant": "dynamic", "mm_impl": "int8", "act_scales": "S"}, "requires act_quant='static'"),
    ({"act_quant": "static", "mm_impl": "int8", "act_scales": "S", "fold_ln": True},
     "incompatible with fold_ln"),
    ({"act_quant": "int4"}, "dynamic|static"),
])
def test_engine_refusals_match_jax(model, tmp_path, kw, match):
    scales = str(tmp_path / "s.json")
    kw = {k: scales if v == "S" else v for k, v in kw.items()}
    messages = []
    for make in (lambda: VitEngine(model, device="cpu", verbose=False, **kw),
                 lambda: JaxVitEngine(model, verbose=False, **kw)):
        with pytest.raises(ValueError, match=match) as e:
            make()
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_engine_serves_a_sidecar_like_jax(model, tmp_path, capsys):
    """act_scales=FILE (unfolded): the engine attaches the sidecar's
    scales and serves without calibrating; probabilities match the JAX
    engine's on the same sidecar (W8A8 bound on the logits: 1e-4 on
    these probabilities)."""
    _, _, _, static, _ = _jax_static(path=model)
    sidecar = str(tmp_path / "m.act_scales.json")
    jax_qat.save_act_scales(sidecar, {k: jnp.asarray(v) for k, v in _scales(static).items()}, 1.05)
    ours = VitEngine(model, mm_impl="int8", act_quant="static", act_scales=sidecar, device="cpu")
    assert f"vit_model_load: static act scales      = {sidecar}" in capsys.readouterr().out
    theirs = JaxVitEngine(model, mm_impl="int8", act_quant="static", act_scales=sidecar,
                          verbose=False)
    assert not ours._needs_calibration
    for name, scale in _scales(static).items():
        np.testing.assert_array_equal(_scales(ours.params)[name], scale)
    x = structured_images(8, seed=2)
    np.testing.assert_allclose(ours.predict_probs_batch(torch.from_numpy(x)).numpy(),
                               np.asarray(theirs.predict_probs_batch(jnp.asarray(x))),
                               atol=1e-4, rtol=0)


def test_bf16_serving_defaults_with_static_scales(model):
    """The serving defaults (bf16, int8, fused fast attention, fold on)
    calibrated on the same images in both packages: probabilities within
    2e-2, the bound of the dynamic serving config in
    tests/test_torch_engine.py."""
    from vit_cpp_tpu.cli.common import build_engine as jax_build_engine
    from vit_cpp_tpu_torch.cli.common import build_engine

    ours, _ = build_engine(model, act="static", device="cpu")
    theirs, _ = jax_build_engine(model, act="static")
    assert ours.params["blocks"]["ln1"]["scale"] is None  # fold on
    cal = structured_images(16)
    ours.calibrate(torch.from_numpy(cal))
    theirs.calibrate(jnp.asarray(cal))
    assert params_have_static_scales(ours.params)
    x = structured_images(8, seed=6)
    got = ours.predict_probs_batch(torch.from_numpy(x)).float().numpy()
    want = np.asarray(theirs.predict_probs_batch(jnp.asarray(x)), np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_build_engine_fold_default_follows_the_sidecar(model, tmp_path):
    from vit_cpp_tpu_torch.cli.common import build_engine

    _, _, _, static, _ = _jax_static(path=model)
    sidecar = str(tmp_path / "s.json")
    jax_qat.save_act_scales(sidecar, {k: jnp.asarray(v) for k, v in _scales(static).items()}, 1.05)
    engine, _ = build_engine(model, act="static", act_scales=sidecar, device="cpu")
    assert engine.params["blocks"]["ln1"]["scale"] is not None  # fold off for a sidecar
    assert params_have_static_scales(engine.params)
    engine, _ = build_engine(model, act="static", device="cpu")
    assert engine.params["blocks"]["ln1"]["scale"] is None


@pytest.fixture(scope="module")
def calib(tmp_path_factory):
    """A directory of eight PNGs (one subdirectory deep), a text file and
    an undecodable one."""
    from PIL import Image

    d = tmp_path_factory.mktemp("calib")
    (d / "sub").mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        img = rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)
        Image.fromarray(img).save(d / ("sub" if i % 2 else ".") / f"{i}.png")
    (d / "notes.txt").write_text("not an image")
    (d / "broken.png").write_bytes(b"not an image")
    return d


def test_calibrate_engine_from_paths_matches_jax(model, calib):
    """The same files, in the same order, preprocessed by each package:
    scales within the maxima tolerance (the preprocessing differs by
    summation order too)."""
    from vit_cpp_tpu.cli.common import calibrate_engine_from_paths as jax_from_paths
    from vit_cpp_tpu_torch.cli.common import calibrate_engine_from_paths

    ours, theirs = _engines(model, act_quant="static")
    assert calibrate_engine_from_paths(ours, str(calib)) is True
    assert jax_from_paths(theirs, str(calib)) is True
    for name, scale in _scales(theirs.params).items():
        np.testing.assert_allclose(_scales(ours.params)[name], scale, rtol=1e-4)
    one, _ = _engines(model, act_quant="static")
    assert calibrate_engine_from_paths(one, str(calib / "0.png")) is True


@pytest.mark.parametrize("case", ["empty", "undecodable"])
def test_calibrate_engine_from_paths_errors(model, tmp_path, case):
    from vit_cpp_tpu.cli.common import calibrate_engine_from_paths as jax_from_paths
    from vit_cpp_tpu_torch.cli.common import calibrate_engine_from_paths

    if case == "undecodable":
        (tmp_path / "bad.png").write_bytes(b"not an image")
    ours, theirs = _engines(model, act_quant="static")
    messages = []
    for fn, engine in ((calibrate_engine_from_paths, ours), (jax_from_paths, theirs)):
        with pytest.raises(ValueError) as e:
            fn(engine, str(tmp_path))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert ("no decodable" if case == "undecodable" else "no calibration images") in messages[0]


def test_params_have_static_scales():
    leaf = Int8Linear(codes=torch.zeros(2, 2, dtype=torch.int8), scale=torch.ones(2))
    assert not params_have_static_scales({"a": {"kernel": leaf}, "b": None})
    static = dataclasses.replace(leaf, act_scale=torch.ones(1, 1))
    assert params_have_static_scales({"a": {"kernel": leaf}, "head": {"kernel": static}})


# -- the front ends ------------------------------------------------------------


def _cli(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _rows(out):
    """path -> (label, prob) of vit-serve's stdout."""
    rows = {}
    for line in out.splitlines():
        path, label, prob = line.split("\t")
        rows[path] = (label, float(prob))
    return rows


@pytest.mark.parametrize("flags", [["--calib-dir", "CAL"], []], ids=["calib-dir", "lazy"])
def test_cli_serve_static_matches_jax(model, calib, capsys, flags):
    """vit-serve --act static at f32, composed attention (fold on): the
    same labels as the JAX tool and probabilities within 0.01 (printed to
    two places)."""
    from vit_cpp_tpu.cli import serve as jax_cli_serve
    from vit_cpp_tpu_torch.cli import serve as cli_serve

    argv = ["-m", model, "-d", str(calib), "-b", "4", "--dtype", "f32", "--attn", "xla",
            "--act", "static", *[str(calib) if f == "CAL" else f for f in flags]]
    rc_p, out_p, err_p = _cli(cli_serve.main, argv + ["--device", "cpu"], capsys)
    rc_j, out_j, _ = _cli(jax_cli_serve.main, argv, capsys)
    assert rc_p == rc_j == 0, err_p
    ours, theirs = _rows(out_p), _rows(out_j)
    assert ours.keys() == theirs.keys() and len(ours) == 8
    for path, (label, prob) in ours.items():
        assert label == theirs[path][0], path
        assert abs(prob - theirs[path][1]) <= 0.01 + 1e-9, path
    assert "rejected" not in err_p


def test_cli_serve_static_with_a_sidecar(model, calib, tmp_path, capsys):
    from vit_cpp_tpu.cli import serve as jax_cli_serve
    from vit_cpp_tpu_torch.cli import serve as cli_serve

    _, _, _, static, _ = _jax_static(path=model)
    sidecar = str(tmp_path / "s.json")
    jax_qat.save_act_scales(sidecar, {k: jnp.asarray(v) for k, v in _scales(static).items()}, 1.05)
    argv = ["-m", model, "-d", str(calib), "-b", "4", "--dtype", "f32", "--attn", "xla",
            "--act", "static", "--act-scales", sidecar, "-k", "2"]
    rc_p, out_p, _ = _cli(cli_serve.main, argv + ["--device", "cpu"], capsys)
    rc_j, out_j, _ = _cli(jax_cli_serve.main, argv, capsys)
    assert rc_p == rc_j == 0
    assert [ln.split("\t")[0] for ln in out_p.splitlines()] == \
        [ln.split("\t")[0] for ln in out_j.splitlines()]


@pytest.mark.parametrize("flags,message", [
    (["--act", "static", "--mm", "pallas"], "--act static requires --mm int8"),
    (["--act", "static", "--mm", "xla"], "--act static requires --mm int8"),
    (["--act", "static", "--calib-dir", "EMPTY"], "serve: no calibration images under"),
    (["--act-scales", "SIDECAR"], "serve: act_scales requires act_quant='static'"),
])
def test_cli_serve_static_errors_match_jax(model, calib, tmp_path, capsys, flags, message):
    from vit_cpp_tpu.cli import serve as jax_cli_serve
    from vit_cpp_tpu_torch.cli import serve as cli_serve

    (tmp_path / "empty").mkdir()
    (tmp_path / "s.json").write_text("{}")
    flags = [{"EMPTY": str(tmp_path / "empty"), "SIDECAR": str(tmp_path / "s.json")}.get(f, f)
             for f in flags]
    argv = ["-m", model, "-d", str(calib), "--dtype", "f32", *flags]
    rc_p, _, err_p = _cli(cli_serve.main, argv + ["--device", "cpu"], capsys)
    rc_j, _, err_j = _cli(jax_cli_serve.main, argv, capsys)
    assert rc_p == rc_j == 1
    assert err_p == err_j and message in err_p


@pytest.mark.parametrize("flags,message", [
    (["--act", "static"], "--act static needs --calib-dir DIR"),
    (["--act", "static", "--mm", "pallas", "--calib-dir", "d"], "--act static requires --mm int8"),
])
@pytest.mark.parametrize("multi", [False, True], ids=["one-model", "multi-model"])
def test_cli_server_static_needs_calibration_data(model, capsys, flags, message, multi):
    """The daemon warms up on zeros, so static serving needs --calib-dir
    or --act-scales, in single- and multi-model mode alike."""
    from vit_cpp_tpu.cli.server import main as jax_main
    from vit_cpp_tpu_torch.cli.server import main

    models = ["-m", f"a={model}", "-m", f"b={model}"] if multi else ["-m", model]
    rc_p, _, err_p = _cli(main, models + flags + ["--device", "cpu"], capsys)
    rc_j, _, err_j = _cli(jax_main, models + flags, capsys)
    assert rc_p == rc_j == 1
    assert err_p == err_j and message in err_p
