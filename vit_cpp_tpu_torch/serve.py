"""Throughput serving: a double-buffered decode -> preprocess -> predict
pipeline over a stream of image files.

Counterpart of vit_cpp_tpu/serve.py. While batch k runs on the card,
batch k+1 decodes on the native thread pool (or PIL on threads) in a
producer thread and is resized on the card there (ops/preprocess.py).
The producer's copies and resize go on the default CUDA stream, which
every host thread shares, so they queue behind the forward already
launched (the copies stage through pinned memory and do not wait for
it): the pixels are ready when the forward that reads them starts, and
the decode, the host's share, overlaps the card's work.

    engine = VitEngine(model, dtype="bf16", attn_impl="pallas-fast")
    for result in serve_files(engine, paths, batch=64):
        ...  # result.path, result.top1, result.probs

serve_files, embed_files and recognize_files (ViTSTR scene text) are
thin wrappers over one pipeline (_stream): the chunking, prefetch queue,
producer-error forwarding, pad-to-batch and ok-mask bookkeeping live
there once.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import TYPE_CHECKING, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from vit_cpp_tpu_torch.io.image import load_images_rgb_batch

if TYPE_CHECKING:  # an AotEngine serves here without the model code
    from vit_cpp_tpu_torch.engine import VitEngine


@dataclasses.dataclass
class Prediction:
    path: str
    top1: int
    prob: float
    probs: Optional[np.ndarray] = None


@dataclasses.dataclass
class Recognition:
    path: str
    text: str
    confidence: float


@dataclasses.dataclass
class Embedding:
    path: str
    vector: Optional[np.ndarray]  # (hidden,) f32, or None on decode failure


class _ProducerError:
    """Queue marker carrying an exception out of the producer thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _stream(
    paths: Iterable[str],
    *,
    batch: int,
    decode_threads: int,
    prefetch: int,
    preprocess: Callable,
    compute: Callable,
):
    """The shared double-buffered pipeline.

    A producer thread decodes each chunk, pads a short chunk to the full
    batch with its first image (so every batch has the same shapes, and
    the kernels the same tile choice) and preprocesses it onto the
    engine's device. The consumer runs `compute(pixels, n_ok)`, which
    returns a per-kept-image indexable, and yields (path, ok, row) in
    input order, row=None for a failed decode.

    Invariants owned here, for every wrapper: a producer failure is
    re-raised in the consumer (a silently dead producer would leave the
    consumer blocked on q.get() forever), and the stop event tears the
    producer down when the consumer is closed early.
    """
    if decode_threads <= 0:
        decode_threads = os.cpu_count() or 1
    paths = list(paths)
    chunks = [paths[i : i + batch] for i in range(0, len(paths), batch)]
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def put(item) -> bool:
        """q.put that gives up once the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for chunk in chunks:
                if stop.is_set():
                    return
                images = load_images_rgb_batch(chunk, n_threads=decode_threads)
                ok = [im is not None for im in images]
                pixels = None
                if any(ok):
                    imgs = [im for im in images if im is not None]
                    while len(imgs) < batch:
                        imgs.append(imgs[0])
                    pixels = preprocess(imgs)
                if not put((chunk, ok, pixels)):
                    return
            put(None)
        except BaseException as e:  # re-raised in the consumer
            put(_ProducerError(e))

    worker = threading.Thread(target=producer, daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, _ProducerError):
                raise item.exc
            chunk, ok, pixels = item
            rows = compute(pixels, sum(ok)) if pixels is not None else None
            j = 0
            for p, good in zip(chunk, ok):
                if not good:
                    yield p, False, None
                else:
                    yield p, True, rows[j]
                    j += 1
    finally:
        stop.set()
        worker.join(timeout=30)


def serve_files(
    engine: VitEngine,
    paths: Iterable[str],
    *,
    batch: int = 64,
    decode_threads: int = 0,
    prefetch: int = 2,
    keep_probs: bool = False,
) -> Iterator[Prediction]:
    """Classify a stream of files; yields Predictions in input order.
    A failed decode yields top1 == -1."""

    def compute(pixels, n):
        return engine.predict_probs_batch(pixels)[:n].cpu().numpy()

    for p, good, pr in _stream(
        paths, batch=batch, decode_threads=decode_threads, prefetch=prefetch,
        preprocess=engine.preprocess_images, compute=compute,
    ):
        if not good:
            yield Prediction(p, -1, 0.0)
            continue
        t1 = int(pr.argmax())
        yield Prediction(p, t1, float(pr[t1]), probs=pr if keep_probs else None)


def recognize_files(
    engine,
    paths: Iterable[str],
    *,
    batch: int = 64,
    decode_threads: int = 0,
    prefetch: int = 2,
) -> Iterator[Recognition]:
    """Batched ViTSTR recognition (a VitstrEngine), the serve_files
    pipeline with the grayscale preprocess: token selection and the
    confidence run on the engine's device (greedy_decode_device), and
    only the (B, seq_len) tokens, flags and confidences come back to the
    host. A failed decode yields text '' and confidence -1.0."""
    from vit_cpp_tpu_torch.models.vitstr import decode_tokens, greedy_decode_device

    def compute(pixels, n):
        toks, valid, conf = greedy_decode_device(engine.predict_probs_batch(pixels))
        return list(zip(toks[:n].cpu().numpy(), valid[:n].cpu().numpy(),
                        conf[:n].cpu().numpy()))

    for p, good, row in _stream(
        paths, batch=batch, decode_threads=decode_threads, prefetch=prefetch,
        preprocess=engine.preprocess_images, compute=compute,
    ):
        if not good:
            yield Recognition(p, "", -1.0)
            continue
        toks, valid, conf = row
        yield Recognition(p, decode_tokens(toks, valid, engine.id2label), float(conf))


def embed_files(
    engine: VitEngine,
    paths: Iterable[str],
    *,
    batch: int = 64,
    decode_threads: int = 0,
    prefetch: int = 2,
) -> Iterator[Embedding]:
    """Bulk feature extraction: the serve_files pipeline with the head
    replaced by the final-LN pooled encoder output (engine.features_batch),
    the index-building counterpart of the daemon's /v1/embed route. Yields
    (path, (hidden,) f32 vector) in input order; a failed decode yields
    vector=None."""

    def compute(pixels, n):
        return engine.features_batch(pixels)[:n].float().cpu().numpy()

    for p, good, vec in _stream(
        paths, batch=batch, decode_threads=decode_threads, prefetch=prefetch,
        preprocess=engine.preprocess_images, compute=compute,
    ):
        yield Embedding(p, vec if good else None)


def throughput(engine: VitEngine, paths: Sequence[str], *, batch: int = 64, **kw) -> float:
    """Images/sec over a full serve_files pass (host clock, end to end:
    each batch's probabilities are on the host before the next is read)."""
    t0 = time.perf_counter()
    n = sum(1 for r in serve_files(engine, paths, batch=batch, **kw) if r.top1 >= 0)
    return n / max(time.perf_counter() - t0, 1e-9)
