"""The port's quantization-aware training (vit_cpp_tpu_torch.quant.qat,
linear(impl="qat"), forward(mm_impl="qat")) against the JAX package's
(vit_cpp_tpu.quant.qat) and against the port's own serving chain.

Tolerances: the codecs, the straight-through values and gradients and
the fake-quantized tree are bit-equal to the JAX package's
(assert_array_equal), and bit-equal to the port's serving chain
(quant/blocks.py quantize -> dequantize, then quant/int8.py channelwise);
the QAT forward against the JAX package's to 1e-5 (f32 on both sides,
summation order only: the inputs of the fake-quantized activations agree
well inside one quantum, so no code flips); the static scales to rtol
1e-5; the QAT forward against the port's real W8A8 forward to 2e-3, the
JAX package's own bound for the same check (test_qat.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.models import params_from_state_dict
from vit_cpp_tpu.quant import qat as jqat
from vit_cpp_tpu.testing.synthetic import random_state_dict
from vit_cpp_tpu_torch.hparams import VitHParams as PortHParams
from vit_cpp_tpu_torch.models.params import params_from_jax
from vit_cpp_tpu_torch.quant import qat as tqat

TINY = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_classes=16,
                  patch_size=8, img_size=32)
PORT_TINY = PortHParams(**dataclasses.asdict(TINY))
BLOCK_FORMATS = [f for f in tqat.QAT_FORMATS if f != "w8a8"]
TOL = 1e-5


def _tiny_params(seed=0, hp=TINY):
    return params_from_state_dict(random_state_dict(hp, seed=seed), hp)


def _weights(seed, shape=(64, 48)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_formats_are_the_jax_packages():
    assert tqat.QAT_FORMATS == jqat.QAT_FORMATS


@pytest.mark.parametrize("fmt", list(tqat.QAT_FORMATS))
def test_fake_quant_weight_is_jax_bit_for_bit(fmt):
    w = _weights(0)
    # ties at the absmax (q4/q5's signed-absmax rule) and an all-zero block
    w[0, 0], w[1, 0] = 2.5, -2.5
    w[:32, 1] = 0.0
    got = tqat.fake_quant_weight(torch.from_numpy(w), fmt).numpy()
    np.testing.assert_array_equal(got, np.asarray(jqat.fake_quant_weight(jnp.asarray(w), fmt)))


def _port_serving_chain(w: np.ndarray, fmt: str) -> np.ndarray:
    """The port's own serving arithmetic: the on-disk block round trip
    (quant/blocks.py on (out, in) rows) or f16 storage, then the load-time
    channelwise int8 of the W8A8 path, dequantized."""
    from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType
    from vit_cpp_tpu_torch.quant import blocks
    from vit_cpp_tpu_torch.quant.int8 import channelwise_int8

    if fmt == "w8a8":
        stored = torch.from_numpy(w).half()
    else:
        dt = GGMLDType[fmt.upper()]
        packed = blocks.quantize(np.ascontiguousarray(w.T), dt)
        stored = torch.from_numpy(blocks.dequantize(packed, w.size, dt).reshape(w.T.shape).T.copy())
    return channelwise_int8(stored).dequantize().numpy()


@pytest.mark.parametrize("fmt", list(tqat.QAT_FORMATS))
def test_fake_quant_weight_is_the_ports_serving_chain(fmt):
    w = _weights(1)
    got = tqat.fake_quant_weight(torch.from_numpy(w), fmt).numpy()
    np.testing.assert_array_equal(got, _port_serving_chain(w, fmt))


def test_fake_quant_weight_stacked_layers():
    w = _weights(2, (3, 64, 16))
    got = tqat.fake_quant_weight(torch.from_numpy(w), "q8_0").numpy()
    for l in range(3):
        np.testing.assert_array_equal(
            got[l], tqat.fake_quant_weight(torch.from_numpy(w[l]), "q8_0").numpy())
    with pytest.raises(ValueError, match="multiple of QK"):
        tqat.fake_quant_weight(torch.zeros(40, 8), "q8_0")


def test_fake_quant_act_is_jax_bit_for_bit():
    x = np.random.default_rng(3).standard_normal((5, 64)).astype(np.float32) * 3
    x[2] = 0.0  # a zero token: scale 0, codes 0
    got = tqat.fake_quant_act(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jqat.fake_quant_act(jnp.asarray(x))))
    assert np.all(got[2] == 0.0)


def test_fake_quant_act_bf16_keeps_the_dtype():
    x = torch.zeros(2, 32, dtype=torch.bfloat16)
    y = tqat.fake_quant_act(x)
    assert y.dtype == torch.bfloat16 and torch.equal(y.float(), torch.zeros(2, 32))
    xr = torch.from_numpy(_weights(4, (3, 32))).bfloat16()
    want = np.asarray(jqat.fake_quant_act(jnp.asarray(xr.float().numpy()).astype(jnp.bfloat16)),
                      np.float32)
    np.testing.assert_array_equal(tqat.fake_quant_act(xr).float().numpy(), want)


def test_fake_quant_act_static_is_jax_bit_for_bit_and_clips():
    x = np.random.default_rng(11).standard_normal((5, 64)).astype(np.float32) * 3
    sx = np.full((1, 1), 0.01, np.float32)  # tight: some values clip
    got = tqat.fake_quant_act_static(torch.from_numpy(x), torch.from_numpy(sx)).numpy()
    want = np.asarray(jqat.fake_quant_act_static(jnp.asarray(x), jnp.asarray(sx)))
    np.testing.assert_array_equal(got, want)
    assert got.max() <= np.float32(127 * 0.01) and got.min() >= -np.float32(127 * 0.01)


@pytest.mark.parametrize("fmt", list(tqat.QAT_FORMATS))
def test_weight_gradient_is_straight_through(fmt):
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32)).requires_grad_()
    c = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    (tqat.fake_quant_weight(w, fmt) * c).sum().backward()
    assert torch.equal(w.grad, c)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_act_gradient_is_straight_through(static):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32)).requires_grad_()
    c = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    q = (tqat.fake_quant_act_static(x, torch.full((1, 1), 0.01)) if static
         else tqat.fake_quant_act(x))
    (q * c).sum().backward()
    assert torch.equal(x.grad, c)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


@pytest.mark.parametrize("fmt", ["q8_0", "q4_1"])
def test_fake_quant_params_is_jax_bit_for_bit_on_the_serving_leaves(fmt):
    jparams = _tiny_params()
    got = _flat(tqat.fake_quant_params(params_from_jax(jparams), fmt))
    want = _flat(jqat.fake_quant_params(jparams, fmt))
    assert got.keys() == want.keys()
    plain = _flat(params_from_jax(jparams))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        changed = not torch.equal(got[k], plain[k])
        served = k.endswith("kernel") and (k.startswith("blocks/") or k.startswith("head/"))
        assert changed == served, k
    with pytest.raises(ValueError, match="qat format"):
        tqat.fake_quant_params(params_from_jax(jparams), "int3")


def _images(seed, n=2):
    return np.random.default_rng(seed).standard_normal((n, 3, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("fmt", ["w8a8", "q4_0"])
def test_qat_forward_matches_jax(fmt):
    from vit_cpp_tpu.models import forward as jforward
    from vit_cpp_tpu_torch.models.vit import forward

    jparams, x = _tiny_params(seed=7), _images(8)
    want = np.asarray(jforward(jqat.fake_quant_params(jparams, fmt), jnp.asarray(x), TINY,
                               mm_impl="qat"))
    got = forward(tqat.fake_quant_params(params_from_jax(jparams), fmt), torch.from_numpy(x),
                  PORT_TINY, mm_impl="qat").numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _f16_kernels(params):
    out = dict(params)
    out["blocks"] = {k: ({**v, "kernel": v["kernel"].half().float()} if k in
                         ("qkv", "proj", "fc1", "fc2") else v)
                     for k, v in params["blocks"].items()}
    out["head"] = {**params["head"], "kernel": params["head"]["kernel"].half().float()}
    return out


def test_qat_forward_matches_the_ports_w8a8_serving():
    from vit_cpp_tpu_torch.models.vit import forward
    from vit_cpp_tpu_torch.quant.int8 import convert_params_to_int8

    params, x = params_from_jax(_tiny_params(seed=7)), torch.from_numpy(_images(8))
    served = forward(convert_params_to_int8(_f16_kernels(params)), x, PORT_TINY).numpy()
    qat = forward(tqat.fake_quant_params(params, "w8a8"), x, PORT_TINY, mm_impl="qat").numpy()
    np.testing.assert_allclose(qat, served, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(qat.argmax(-1), served.argmax(-1))


def test_measure_act_scales_matches_jax_and_round_trips(tmp_path):
    jparams, x = _tiny_params(seed=12), _images(13, 4)
    want = jqat.measure_act_scales(jparams, jnp.asarray(x), TINY, "q8_0")
    got = tqat.measure_act_scales(params_from_jax(jparams), torch.from_numpy(x), PORT_TINY,
                                  "q8_0")
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL, err_msg=k)
    f = str(tmp_path / "s.json")
    tqat.save_act_scales(f, got, margin=1.05)
    back = tqat.load_act_scales(f)
    for k in got:
        assert torch.equal(back[k], got[k]), k
    inj = tqat.inject_act_scales(params_from_jax(jparams), got)
    for name in ("qkv", "proj", "fc1", "fc2"):
        assert inj["blocks"][name]["act_scale"] is got[name]
    assert inj["head"]["act_scale"] is got["head"] and "act_scale" not in inj["patch_embed"]


def test_qat_static_forward_matches_jax_and_the_ports_static_serving():
    from vit_cpp_tpu.models import forward as jforward
    from vit_cpp_tpu_torch.models.vit import forward
    from vit_cpp_tpu_torch.quant.calibrate import attach_act_scales
    from vit_cpp_tpu_torch.quant.int8 import convert_params_to_int8

    jparams, x = _tiny_params(seed=14), _images(15)
    params, xt = params_from_jax(jparams), torch.from_numpy(x)
    scales = tqat.measure_act_scales(params, xt, PORT_TINY, "w8a8")
    got = forward(tqat.inject_act_scales(tqat.fake_quant_params(params, "w8a8"), scales), xt,
                  PORT_TINY, mm_impl="qat").numpy()
    jscales = {k: jnp.asarray(v.numpy()) for k, v in scales.items()}
    want = np.asarray(jforward(
        jqat.inject_act_scales(jqat.fake_quant_params(jparams, "w8a8"), jscales),
        jnp.asarray(x), TINY, mm_impl="qat"))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    served = forward(attach_act_scales(convert_params_to_int8(_f16_kernels(params)), scales),
                     xt, PORT_TINY).numpy()
    np.testing.assert_allclose(got, served, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(got.argmax(-1), served.argmax(-1))


def test_qat_through_moe_raises_the_jax_message():
    from vit_cpp_tpu_torch.models.vit import forward

    hp = dataclasses.replace(PORT_TINY, num_experts=2, moe_layers=(1,))
    with pytest.raises(ValueError, match="QAT through MoE experts is not implemented"):
        forward({}, torch.zeros(1, 3, 32, 32), hp, mm_impl="qat")


# ---- the fine-tune loop (finetune(qat=...), cli.finetune --qat) ----


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    from tests.test_torch_finetune import _make_dataset
    from vit_cpp_tpu.testing.synthetic import write_synthetic_model

    d = tmp_path_factory.mktemp("qat")
    base = str(d / "m.gguf")
    write_synthetic_model(base, VitHParams(hidden_size=64, num_hidden_layers=2,
                                           num_attention_heads=2, num_classes=7, patch_size=8,
                                           img_size=32), ftype=1, seed=4)
    return base, _make_dataset(d / "train")


QUIET = dict(log=lambda m: None, device="cpu")


def _served_accuracy(engine, data):
    from vit_cpp_tpu_torch.finetune import load_dataset

    paths, labels, _ = load_dataset(data)
    return np.mean([engine.classify_file(p, topk=1)[0][0] == int(l)
                    for p, l in zip(paths, labels)])


def test_finetune_qat_learns_and_serves_quantized(task, tmp_path):
    """Fine-tune through Q8_0 + W8A8 noise, export, quantize to the same
    format, serve on the int8 path."""
    from vit_cpp_tpu_torch.cli.quantize import quantize_model_file
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.finetune import finetune
    from vit_cpp_tpu_torch.models.export import save_params

    base, data = task
    params, hp, classes, losses = finetune(base, data, epochs=4, batch=4, lr=1e-3, qat="q8_0",
                                           val_dir=data, **QUIET)
    assert losses[-1] < losses[0]
    f16, q8 = str(tmp_path / "ft-f16.gguf"), str(tmp_path / "ft-q8_0.gguf")
    save_params(f16, params, hp, id2label=dict(enumerate(classes)))
    assert quantize_model_file(f16, q8, 8, verbose=False)
    assert _served_accuracy(VitEngine(q8, mm_impl="int8", device="cpu"), data) >= 0.9


def test_finetune_qat_static_writes_the_sidecar_static_serving_reads(task, tmp_path):
    """--qat-act static: per-epoch frozen scales, the sidecar measured on
    the exported weights (measure_act_scales of the returned tree),
    served with act_quant="static" and no calibration pass."""
    from vit_cpp_tpu_torch.cli.quantize import quantize_model_file
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.finetune import _preprocess_chunk, finetune, load_dataset
    from vit_cpp_tpu_torch.models.export import save_params

    base, data = task
    scales_out = str(tmp_path / "ft.act_scales.json")
    params, hp, classes, losses = finetune(base, data, epochs=4, batch=4, lr=1e-3, qat="q8_0",
                                           qat_act="static", qat_scales_out=scales_out, **QUIET)
    assert losses[-1] < losses[0]
    paths = load_dataset(data)[0]
    want = tqat.measure_act_scales(params, _preprocess_chunk(paths[:4], hp, 1, "cpu"), hp,
                                   "q8_0")
    saved = tqat.load_act_scales(scales_out)
    for k in want:
        np.testing.assert_array_equal(saved[k].numpy(), want[k].numpy())
    f16, q8 = str(tmp_path / "ft-f16.gguf"), str(tmp_path / "ft-q8_0.gguf")
    save_params(f16, params, hp, id2label=dict(enumerate(classes)))
    assert quantize_model_file(f16, q8, 8, verbose=False)
    engine = VitEngine(q8, mm_impl="int8", act_quant="static", act_scales=scales_out,
                       fold_ln=False, device="cpu")
    assert _served_accuracy(engine, data) >= 0.9
    with pytest.raises(ValueError, match="qat_act"):
        finetune(base, data, epochs=1, batch=4, qat="q8_0", qat_act="bogus", **QUIET)
    with pytest.raises(ValueError, match="needs --qat-act static"):
        finetune(base, data, epochs=1, batch=4, qat="q8_0", qat_scales_out=scales_out, **QUIET)


def test_static_serving_drift_of_a_qat_output_is_the_jax_packages(tmp_path, capsys):
    """Both CLIs train a QAT q8_0 --qat-act static model for 6 epochs (24
    updates) on dark / bright noise, then serve the ten photos of assets/
    with the sidecar's static scales and with the f32 engine. The static
    scales, measured on the noise, move the photos' probabilities by
    more as the head trains, in the JAX package too (~5.5e-3 at 6 epochs
    here, ~2e-4 after 1): the port's move per image agrees with the JAX
    package's to 1.5e-3 (~2x the largest gap measured)."""
    import glob
    import os

    from PIL import Image

    from vit_cpp_tpu.cli.finetune import main as jax_cli
    from vit_cpp_tpu.engine import VitEngine as JaxEngine
    from vit_cpp_tpu.testing.synthetic import write_synthetic_model
    from vit_cpp_tpu_torch.cli.finetune import main as port_cli
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch

    rng = np.random.default_rng(0)
    for cls, lo, hi in (("aa_dark", 0, 40), ("bb_bright", 210, 255)):
        (tmp_path / "train" / cls).mkdir(parents=True)
        for i in range(16):
            Image.fromarray(rng.integers(lo, hi, (32, 32, 3), dtype=np.uint8)).save(
                tmp_path / "train" / cls / f"{i}.png")
    base = str(tmp_path / "m.gguf")
    write_synthetic_model(base, VitHParams(hidden_size=64, num_hidden_layers=2,
                                           num_attention_heads=2, num_classes=10, patch_size=8,
                                           img_size=32), ftype=1, seed=0)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    photos = sorted(p for p in glob.glob(os.path.join(root, "assets", "*"))
                    if p.lower().endswith((".jpg", ".jpeg", ".png")))
    images = load_images_rgb_batch(photos)
    drift = {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        out = str(tmp_path / f"{name}.gguf")
        argv = ["-m", base, "-d", str(tmp_path / "train"), "-o", out, "--epochs", "6",
                "-b", "8", "--qat", "q8_0", "--qat-act", "static"]
        assert cli(argv + (["--device", "cpu"] if name == "port" else [])) in (0, None)
        scales = out + ".act_scales.json"
        if name == "port":
            engines = [VitEngine(out, mm_impl="int8", act_quant="static", act_scales=scales,
                                 device="cpu", verbose=False),
                       VitEngine(out, device="cpu", verbose=False)]
            probs = [e.predict_probs_batch(e.preprocess_images(images)).numpy()
                     for e in engines]
        else:
            engines = [JaxEngine(out, mm_impl="int8", act_quant="static", act_scales=scales,
                                 verbose=False), JaxEngine(out, verbose=False)]
            probs = [np.asarray(e.predict_probs_batch(
                jnp.stack([e.preprocess_image(im) for im in images]))) for e in engines]
        drift[name] = probs[0] - probs[1]
    capsys.readouterr()
    assert len(photos) == 10
    np.testing.assert_allclose(drift["port"], drift["jax"], atol=1.5e-3)


def test_cli_qat_static_writes_the_sidecar_beside_the_output(task, tmp_path, capsys):
    from vit_cpp_tpu_torch.cli.finetune import main

    base, data = task
    out = str(tmp_path / "ft.gguf")
    assert main(["-m", base, "-d", data, "-o", out, "-b", "8", "--epochs", "1", "--qat", "w8a8",
                 "--qat-act", "static", "--device", "cpu"]) == 0
    assert "wrote static activation scales" in capsys.readouterr().err
    scales = tqat.load_act_scales(out + ".act_scales.json")
    assert scales["qkv"].shape == (2, 1, 1) and scales["head"].shape == (1, 1)


def test_finetune_qat_resume_mismatch_rejected(task, tmp_path):
    from vit_cpp_tpu_torch.finetune import finetune

    base, data = task
    ck = str(tmp_path / "ck")
    finetune(base, data, epochs=1, batch=4, lr=1e-3, qat="q8_0", ckpt_dir=ck, **QUIET)
    for kw in (dict(qat="w8a8"), {}, dict(qat="q8_0", qat_act="static")):
        with pytest.raises(ValueError, match="different settings"):
            finetune(base, data, epochs=2, batch=4, lr=1e-3, ckpt_dir=ck, **kw, **QUIET)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", list(tqat.QAT_FORMATS))
def test_fake_quant_on_the_card_is_the_cpus_bit_for_bit(fmt):
    """The codecs on a CUDA tensor: every division is a true division
    (`_div`), so the card rounds as the CPU and the JAX package do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = torch.from_numpy(_weights(20, (3, 768, 256)))
    assert torch.equal(tqat.fake_quant_weight(w.cuda(), fmt).cpu(), tqat.fake_quant_weight(w, fmt))
    x = torch.from_numpy(_weights(21, (64, 197, 96)) * 3)
    assert torch.equal(tqat.fake_quant_act(x.cuda()).cpu(), tqat.fake_quant_act(x))
    sx = torch.full((1, 1), 0.02)
    assert torch.equal(tqat.fake_quant_act_static(x.cuda(), sx.cuda()).cpu(),
                       tqat.fake_quant_act_static(x, sx))
