"""The port's SigLIP attention pooling against the JAX package's.

Synthetic attention-pooled checkpoints (no CLS token, global_pool="map",
pixel_norm="unit"; h=64, L=2, 4 heads, 32 px, patch 8): a headless
encoder and one with a 5-class head, in f16 and Q8_0. On the CPU, with
the same numpy-made inputs: attention_pool on the same tree within 1e-5,
the map head's features and probabilities within 1e-5 of the JAX
engine's, and the three exemptions the JAX package makes for this head,
each beside the JAX behaviour: LayerNorm folding leaves the final norm
alone (it feeds the pool, not the head), W8A8 conversion leaves the
attn_pool leaves alone, and the preprocessing normalizes to [-1, 1].
Then the headless encoder at the serving defaults through embed_files and
/v1/embed.
"""

import dataclasses
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cpp_tpu.gguf.reader import read_model as jax_read_model
from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch.engine import VitEngine
from vit_cpp_tpu_torch.models.params import params_from_jax

HP_MAP = VitHParams(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_classes=0,
                    patch_size=8, img_size=32, num_prefix_tokens=0, global_pool="map",
                    pixel_norm="unit")
TOL = 1e-5  # f32 on both sides: summation order only


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from vit_cpp_tpu_torch.cli.quantize import quantize_model_file

    d = tmp_path_factory.mktemp("siglip")
    out = {}
    for name, classes, seed in (("enc", 0, 3), ("cls", 5, 4)):
        out[name] = str(d / f"{name}.gguf")
        write_synthetic_model(out[name], dataclasses.replace(HP_MAP, num_classes=classes),
                              ftype=1, seed=seed)
    out["q8"] = str(d / "cls-q8_0.gguf")
    assert quantize_model_file(out["cls"], out["q8"], 8, verbose=False)
    return out


def _images(n=3, seed=0):
    return np.random.default_rng(seed).standard_normal((n, 3, 32, 32)).astype(np.float32)


def _jax_engine(path, **kw):
    from vit_cpp_tpu.engine import VitEngine as JaxVitEngine

    return JaxVitEngine(path, verbose=False, **kw)


def test_detect_hparams_reads_attention_pooling(files):
    from vit_cpp_tpu.engine import detect_hparams as jax_detect
    from vit_cpp_tpu_torch.engine import detect_hparams
    from vit_cpp_tpu_torch.gguf.reader import read_model

    hp = detect_hparams(read_model(files["enc"]))
    want = jax_detect(jax_read_model(files["enc"]))
    assert (hp.global_pool, hp.pixel_norm, hp.num_prefix_tokens) == ("map", "unit", 0)
    assert (hp.global_pool, hp.pixel_norm, hp.num_prefix_tokens, hp.num_classes) == (
        want.global_pool, want.pixel_norm, want.num_prefix_tokens, want.num_classes)


def test_attention_pool_matches_jax(files):
    from vit_cpp_tpu.models.vit import attention_pool as jax_pool
    from vit_cpp_tpu_torch.models.vit import attention_pool

    jax_engine = _jax_engine(files["enc"])
    ap = jax_engine.params["attn_pool"]
    x = np.random.default_rng(1).standard_normal((3, 16, 64)).astype(np.float32)
    got = attention_pool(params_from_jax(ap), torch.from_numpy(x), jax_engine.hp).numpy()
    want = np.asarray(jax_pool(ap, jnp.asarray(x), jax_engine.hp))
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("which", ["enc", "cls", "q8"])
def test_map_head_features_and_probabilities_match_jax(files, which):
    engine = VitEngine(files[which], device="cpu", verbose=False)
    jax_engine = _jax_engine(files[which])
    x = _images()
    got = engine.features_batch(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_engine.features_batch(jnp.asarray(x)))
    assert got.shape == (3, 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if which == "enc":
        with pytest.raises(ValueError, match="headless encoder"):
            engine.predict_probs_batch(torch.from_numpy(x))
        return
    probs = engine.predict_probs_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(probs, np.asarray(jax_engine.predict_probs_batch(jnp.asarray(x))),
                               atol=TOL, rtol=0)


def test_fold_leaves_the_final_norm_of_a_map_head(files):
    """The final norm feeds the pool's keys and values, so neither package
    folds it, even with a head: the folded tree keeps its affine and
    classifies as the unfolded one does."""
    from vit_cpp_tpu.models.fold import fold_layernorms as jax_fold
    from vit_cpp_tpu_torch.models.fold import fold_layernorms

    engine = VitEngine(files["cls"], device="cpu", verbose=False)
    folded = fold_layernorms(engine.params, mm_impl="xla")
    jax_folded = jax_fold(_jax_engine(files["cls"]).params, mm_impl="xla")
    assert jax_folded["norm"]["scale"] is not None and folded["norm"]["scale"] is not None
    assert "features_norm" not in folded
    assert torch.equal(folded["norm"]["scale"], engine.params["norm"]["scale"])
    assert torch.equal(folded["head"]["kernel"], engine.params["head"]["kernel"])
    assert folded["blocks"]["ln1"]["scale"] is None  # the block norms still fold
    x = torch.from_numpy(_images())
    want = engine.predict_probs_batch(x)
    engine.params = folded
    np.testing.assert_allclose(engine.predict_probs_batch(x).numpy(), want.numpy(),
                               atol=TOL, rtol=0)


def test_int8_conversion_leaves_the_attn_pool_leaves(files):
    from vit_cpp_tpu.quant.int8 import convert_params_to_int8 as jax_convert
    from vit_cpp_tpu_torch.quant.int8 import Int8Linear, convert_params_to_int8

    for which in ("cls", "q8"):
        engine = VitEngine(files[which], device="cpu", verbose=False)
        out = convert_params_to_int8(engine.params)
        jax_params = _jax_engine(files[which]).params
        theirs = jax_convert(jax_params)
        for name in ("qkv", "proj", "fc1", "fc2"):
            leaf = out["attn_pool"][name]["kernel"]
            assert leaf is engine.params["attn_pool"][name]["kernel"], name
            assert theirs["attn_pool"][name]["kernel"] is jax_params["attn_pool"][name]["kernel"]
        assert isinstance(out["head"]["kernel"], Int8Linear)
        assert isinstance(out["blocks"]["qkv"]["kernel"], Int8Linear)


def test_unit_pixel_norm_reaches_the_preprocess(files):
    """A constant-v image maps to (v/255 - 0.5) / 0.5, as the JAX
    engine's preprocess does."""
    img = np.full((40, 36, 3), 200, dtype=np.uint8)
    engine = VitEngine(files["enc"], device="cpu", verbose=False)
    pix = engine.preprocess_image(img).numpy()
    np.testing.assert_allclose(pix, (200 / 255 - 0.5) / 0.5, atol=1e-6)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (45, 37, 3), dtype=np.uint8)
    np.testing.assert_allclose(engine.preprocess_image(img).numpy(),
                               np.asarray(_jax_engine(files["enc"]).preprocess_image(img)),
                               atol=1e-5, rtol=0)


def test_headless_siglip_serves_embeddings_at_the_serving_defaults(files, tmp_path):
    """build_engine's defaults (bf16, W8A8, fused attention, fold) on the
    headless encoder: embed_files within the bf16 + W8A8 limit of the f32
    engine's features (8e-2 of max|f|, the embedding limit of the port's
    card check), and POST /v1/embed equal to embed_file on the same
    bytes."""
    from PIL import Image

    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.serve import embed_files
    from vit_cpp_tpu_torch.server import create_server

    rng = np.random.default_rng(5)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (30 + 7 * i, 41, 3), dtype=np.uint8)).save(paths[-1])
    engine, is_vitstr = build_engine(files["enc"], device="cpu")
    assert not is_vitstr and engine.params["norm"]["scale"] is not None
    vecs = np.stack([e.vector for e in embed_files(engine, paths, batch=2)])
    ref = VitEngine(files["enc"], device="cpu", verbose=False)
    want = ref.features_batch(ref.preprocess_images(
        [np.asarray(Image.open(p).convert("RGB")) for p in paths])).numpy()
    assert np.abs(vecs - want).max() <= 8e-2 * np.abs(want).max()
    httpd, batcher = create_server(engine, port=0, batch=2, max_wait_ms=1.0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_port}/v1/embed",
                                     data=open(paths[0], "rb").read(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        t.join(timeout=30)
    assert body["shape"] == [64]
    np.testing.assert_allclose(body["embedding"], engine.embed_file(paths[0]), atol=1e-6)


def _dark_bright(root, size=32, n=8, seed=7):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for cls, lo, hi in (("aa_dark", 0, 40), ("bb_bright", 210, 255)):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(lo, hi, (size, size, 3), dtype=np.uint8)).save(
                d / f"{i}.png")
    return str(root)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def test_finetune_attaches_head_to_siglip(files, tmp_path):
    """Fine-tuning the headless tower attaches a classifier on the pooled
    output (the SigLIP-probe recipe); the export is the JAX package's
    bytes for the same weights and serves."""
    from vit_cpp_tpu_torch.finetune import finetune
    from vit_cpp_tpu_torch.models.export import save_params

    data = _dark_bright(tmp_path / "train")
    logs = []
    params, hp, classes, losses = finetune(files["enc"], data, epochs=3, batch=4, lr=1e-3,
                                           log=logs.append, device="cpu")
    assert any("re-initializing head 0 -> 2" in m for m in logs)
    assert hp.num_classes == 2 and losses[-1] < losses[0]
    assert params["head"]["kernel"].shape == (64, 2) and "attn_pool" in params
    out = str(tmp_path / "ft.gguf")
    save_params(out, params, hp, id2label=dict(enumerate(classes)))
    from vit_cpp_tpu.models.export import save_params as jax_save_params

    theirs = str(tmp_path / "jax.gguf")
    jax_save_params(theirs, _to_numpy(params), hp, id2label=dict(enumerate(classes)))
    with open(out, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()  # the attention pool exported as the JAX package does
    eng = VitEngine(out, device="cpu")
    assert eng.hp.global_pool == "map" and eng.hp.num_classes == 2
    dark = np.random.default_rng(7).integers(0, 40, (2, 32, 32, 3), dtype=np.uint8)
    probs = eng.predict_probs_batch(torch.stack([eng.preprocess_image(im) for im in dark]))
    assert (probs.argmax(-1) == classes.index("aa_dark")).all()


def test_map_head_loss_and_grads_match_jax_and_qat_leaves_the_pool_float(files):
    """The training loss through attention pooling and its gradients, the
    pool's included, against the JAX package's (test_torch_train.py's
    bounds); under QAT the pool's leaves and activations stay float, as
    the JAX package's attention_pool exempts them."""
    import jax

    from vit_cpp_tpu.models.params import load_params as jax_load_params
    from vit_cpp_tpu.parallel import train as jtrain
    from vit_cpp_tpu_torch.hparams import VitHParams as PortHParams
    from vit_cpp_tpu_torch.models.vit import attention_pool
    from vit_cpp_tpu_torch.parallel import train as ttrain

    from vit_cpp_tpu.engine import detect_hparams

    mf = jax_read_model(files["cls"])
    hp = detect_hparams(mf)
    assert hp.global_pool == "map"
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                           jax_load_params(mf, jnp.float32, hparams=hp))
    port_hp = PortHParams(**{f.name: getattr(hp, f.name) for f in dataclasses.fields(hp)})
    x = _images(2, seed=3)
    y = np.array([1, 4], np.int32)
    for qat in ("", "q8_0"):
        l_ref, g_ref = jax.value_and_grad(jtrain.cross_entropy_loss)(
            jparams, jnp.asarray(x), jnp.asarray(y), hp, 0.0, 0, qat)
        params = params_from_jax(jparams)
        for leaf in ttrain.tree_leaves(params):
            leaf.requires_grad_(True)
        loss = ttrain.cross_entropy_loss(params, torch.from_numpy(x), torch.from_numpy(y),
                                         port_hp, qat=qat)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(l_ref), rtol=1e-5)
        got = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda p: p.grad, params))}
        ref = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(g_ref)}
        assert got.keys() == ref.keys() and any("attn_pool" in k for k in ref)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=5e-5,
                                       rtol=1e-3, err_msg=f"{qat} {k}")
    params = params_from_jax(jparams)
    tokens = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, 64))
                              .astype(np.float32))
    assert torch.equal(attention_pool(params["attn_pool"], tokens, port_hp, "qat"),
                       attention_pool(params["attn_pool"], tokens, port_hp, "xla"))
