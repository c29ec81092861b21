"""Each engine's f32 matmul precision, on a process-global switch.

PyTorch reads whether cuBLAS and cuDNN may use TF32 from two process-wide
flags. An engine sets them for its own forward only (ops/precision.py):
an f32 engine ("highest") dispatches with TF32 off whatever the process
has set, a bf16 engine ("default") with TF32 on, and the process's own
setting is back once the forward returns. On the CPU the flags are plain
host state, so a stand-in forward records what each engine saw.
"""

import threading
import time

import numpy as np
import pytest
import torch

from vit_cpp_tpu.hparams import VitHParams
from vit_cpp_tpu.testing.synthetic import write_synthetic_model
from vit_cpp_tpu_torch import engine as engine_mod
from vit_cpp_tpu_torch.engine import VitEngine
from vit_cpp_tpu_torch.ops import precision
from vit_cpp_tpu_torch.ops.precision import matmul_precision

HP = VitHParams(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                num_classes=5, patch_size=8, img_size=16)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@pytest.fixture
def process_flags():
    """Restores the process's TF32 flags after the test."""
    saved = _flags()
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("precision") / "m.gguf")
    write_synthetic_model(path, HP, ftype=1, seed=0)
    return path


def _recording_forward(monkeypatch, seen, pause=0.0):
    """Replace the engine's forward by the real one wrapped in a record of
    the flags at its start and at its end, per engine dtype."""
    real = engine_mod.forward

    def forward(params, images, hp, **kw):
        key = params["cls_token"].dtype
        start = _flags()
        time.sleep(pause)
        out = real(params, images, hp, **kw)
        seen.setdefault(key, []).append((start, _flags()))
        return out

    monkeypatch.setattr(engine_mod, "forward", forward)


@pytest.mark.parametrize("process_tf32", [True, False])
def test_f32_engine_dispatches_with_tf32_off_and_leaves_the_process_setting(
    model, monkeypatch, process_flags, process_tf32
):
    seen = {}
    _recording_forward(monkeypatch, seen)
    f32 = VitEngine(model, device="cpu", verbose=False)
    bf16 = VitEngine(model, dtype="bf16", device="cpu", verbose=False)
    assert (f32.matmul_precision, bf16.matmul_precision) == ("highest", "default")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = process_tf32
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 16, 16)).astype(np.float32))
    f32.predict_probs_batch(x)
    f32.features_batch(x)
    assert _flags() == (process_tf32, process_tf32)
    bf16.predict_probs_batch(x)
    assert _flags() == (process_tf32, process_tf32)
    assert seen[torch.float32] == [((False, False), (False, False))] * 2
    assert seen[torch.bfloat16] == [((True, True), (True, True))]


def test_explicit_precision_overrides_the_dtype_default(model, monkeypatch, process_flags):
    seen = {}
    _recording_forward(monkeypatch, seen)
    engine = VitEngine(model, matmul_precision="high", device="cpu", verbose=False)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    engine.predict_probs_batch(torch.zeros((1, 3, 16, 16)))
    assert seen[torch.float32] == [((True, True), (True, True))]
    assert _flags() == (False, False)
    with pytest.raises(ValueError, match="matmul_precision"):
        VitEngine(model, matmul_precision="fastest", device="cpu", verbose=False)


def test_two_engines_of_different_precision_on_two_threads(model, monkeypatch, process_flags):
    """An f32 and a bf16 engine forward at once from two threads, each
    pausing inside its forward: each sees its own setting from start to
    end, and the process's own setting is back after both."""
    seen = {}
    _recording_forward(monkeypatch, seen, pause=0.005)
    engines = [VitEngine(model, device="cpu", verbose=False),
               VitEngine(model, dtype="bf16", device="cpu", verbose=False)]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = False
    x = torch.zeros((2, 3, 16, 16))
    start = threading.Barrier(2)

    def run(engine):
        start.wait()
        for _ in range(10):
            engine.predict_probs_batch(x)

    threads = [threading.Thread(target=run, args=(e,)) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert seen[torch.float32] == [((False, False), (False, False))] * 10
    assert seen[torch.bfloat16] == [((True, True), (True, True))] * 10
    assert _flags() == (True, False)


def test_preprocessing_resizes_with_tf32_off(monkeypatch, process_flags):
    """The resize einsum's output is re-rounded to u8 steps, which TF32's
    errors would move: it runs at "highest" whatever the process has set."""
    from vit_cpp_tpu_torch.ops import preprocess

    seen = []
    real = torch.einsum

    def einsum(*args):
        seen.append(_flags())
        return real(*args)

    monkeypatch.setattr(preprocess.torch, "einsum", einsum)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    preprocess.preprocess_batch([img], 16)
    assert seen == [(False, False)] and _flags() == (True, True)


def test_precision_region_restores_the_flags_when_its_body_raises(process_flags):
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    with pytest.raises(RuntimeError, match="boom"):
        with matmul_precision("highest"):
            assert _flags() == (False, False)
            raise RuntimeError("boom")
    assert _flags() == (True, True)
    with pytest.raises(ValueError, match="matmul_precision"):
        with matmul_precision("medium"):
            pass
    assert set(precision.PRECISIONS) == {"highest", "high", "default"}


def test_precision_regions_under_thread_stress(process_flags):
    """More threads than cores, each entering "highest" or "high" regions
    with a short switch interval: no thread ever sees the other mode
    inside its region, and the process's setting is back at the end."""
    import os
    import sys

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    wrong = []

    def run(mode, want):
        for _ in range(200):
            with matmul_precision(mode):
                for _ in range(20):  # a region long enough to be switched out of
                    if _flags() != (want, want):
                        wrong.append(mode)

    threads = [threading.Thread(target=run, args=(("highest", False), ("high", True))[i % 2])
               for i in range(2 * (os.cpu_count() or 1) + 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrong == [] and _flags() == (True, True)
