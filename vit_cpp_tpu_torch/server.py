"""HTTP serving daemon with micro-batching, on a PyTorch engine.

Counterpart of vit_cpp_tpu/server.py::create_server. The HTTP surface is
the JAX package's own, reused rather than copied: its request handler
(routes /healthz, /stats, /metrics and POST /v1/classify), its image
decode, its ThreadingHTTPServer and its Prometheus text. What changes is
where tensors live: request handlers preprocess onto the engine's device,
and the micro-batcher stacks those tensors with torch.

Endpoints: GET /healthz, /stats, /metrics; POST /v1/classify[?topk=K]
with the raw image bytes as the body. The embed route is not served yet
(the engine has no features_batch).
"""

from __future__ import annotations

import time

import torch

from vit_cpp_tpu import server as _http
from vit_cpp_tpu.server import ThreadingHTTPServer
from vit_cpp_tpu_torch.ops.preprocess import norm_constants, preprocess_batch

MAX_BODY_BYTES = 32 * 1024 * 1024  # the JAX daemon's request-body limit


class MicroBatcher(_http.MicroBatcher):
    """vit_cpp_tpu.server.MicroBatcher with a torch batch: requests are
    coalesced up to `batch`, the tail is padded by repeating the first
    item, and one device call serves the whole batch."""

    def _flush(self, items) -> None:
        pixels = [p for p, _ in items]
        target = self.batch
        if self.buckets:
            target = next(b for b in self.bucket_sizes() if b >= len(pixels))
        pad = target - len(pixels)
        t0 = time.perf_counter()
        try:
            stacked = torch.stack(pixels + [pixels[0]] * pad)
            out = self._predict(stacked).float().cpu().numpy()
        except Exception as e:  # resolve every waiter, don't hang clients
            for _, fut in items:
                fut.set_exception(e)
            return
        dt = time.perf_counter() - t0
        with self._stats_lock:  # handler threads read /stats concurrently
            self.n_requests += len(items)
            self.n_batches += 1
            self.n_padded_rows += pad
            self.predict_seconds += dt
        for i, (_, fut) in enumerate(items):
            fut.set_result(out[i])


class _Model(_http._Model):
    """One served model; preprocessing runs the port's batched resize on
    the engine's device."""

    def preprocess(self, img):
        hp = self.engine.hp
        mean, std = norm_constants(hp.pixel_norm)
        return preprocess_batch(
            [img], hp.img_size, mode=hp.interpolation, mean=mean, std=std,
            device=self.engine.device,
        )[0]


def _warm(engine, batcher: MicroBatcher) -> None:
    """Run one dummy request through the batcher, then every other bucket
    shape directly, and zero the counters."""
    hp = engine.hp
    shape = (hp.in_chans, hp.img_size, hp.img_size)
    batcher.submit(torch.zeros(shape, device=engine.device)).result()
    for b in batcher.bucket_sizes()[1:]:
        batcher._predict(torch.zeros((b, *shape), device=engine.device))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    batcher.n_requests = 0
    batcher.n_batches = 0
    batcher.n_padded_rows = 0
    batcher.predict_seconds = 0.0


def create_server(
    engine,
    host: str = "127.0.0.1",
    port: int = 8000,
    batch: int = 8,
    max_wait_ms: float = 5.0,
    warmup: bool = True,
    request_timeout_s: float = 30.0,
    max_queue: int = 0,
    buckets: bool = False,
):
    """Build (ThreadingHTTPServer, MicroBatcher); the caller runs
    serve_forever() and closes both. warmup=True runs the dummy batch(es)
    before the port is bound."""
    batcher = MicroBatcher(
        engine.predict_probs_batch,
        batch=batch,
        max_wait_ms=max_wait_ms,
        max_queue=max_queue,
        buckets=buckets,
    )
    if warmup:
        _warm(engine, batcher)
    model = _Model(None, engine, batcher)
    handler = _http._make_handler(
        {"/v1/classify": (model, None)},
        single=model,
        timeout_s=request_timeout_s,
        max_body_bytes=MAX_BODY_BYTES,
    )
    return ThreadingHTTPServer((host, port), handler), batcher

