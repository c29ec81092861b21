"""HTTP serving daemon with micro-batching, on a PyTorch engine.

Counterpart of vit_cpp_tpu/server.py::create_server, with the port's own
copy of the single-model parts of that module: the request handler
(routes /healthz, /stats, /metrics and POST /v1/classify), the image
decode, the ThreadingHTTPServer, the admission bound and the Prometheus
text. Request handlers decode and preprocess onto the engine's device,
and the micro-batcher stacks those tensors with torch. Images decode
through decode.py, which tries the native decoder once per process.

Endpoints: GET /healthz, /stats, /metrics; POST /v1/classify[?topk=K]
with the raw image bytes as the body. The embed and recognize routes and
the multi-model daemon are not served yet (the engine has no
features_batch and loads no ViTSTR checkpoint).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler
from http.server import ThreadingHTTPServer as _StdThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from vit_cpp_tpu_torch.decode import decode_bytes
from vit_cpp_tpu_torch.ops.preprocess import norm_constants, preprocess_batch

MAX_BODY_BYTES = 32 * 1024 * 1024  # the JAX daemon's request-body limit


class ThreadingHTTPServer(_StdThreadingHTTPServer):
    """Stdlib server with a production listen backlog: the default
    request_queue_size of 5 resets concurrent connects as soon as more
    than a handful of clients arrive at once; overload is handled by the
    batcher's admission bound (503) instead."""

    request_queue_size = 128


def decode_rgb_from_bytes(data: bytes) -> Optional[np.ndarray]:
    """bytes -> (H, W, 3) uint8 RGB, or None if no decoder reads them;
    native decoder first (loaded once per process), PIL fallback."""
    return decode_bytes(data)


class OverloadedError(RuntimeError):
    """Raised by MicroBatcher.submit when the queue exceeds max_queue;
    the handler maps it to HTTP 503 so clients back off instead of
    timing out inside an unbounded backlog."""


class MicroBatcher:
    """Coalesce concurrent single-image requests into fixed-size batches.

    submit() enqueues preprocessed pixels and returns a Future; one device
    worker drains the queue (it blocks for the first item, then gathers
    up to `batch` more for at most `max_wait_ms`), pads the tail by
    repeating the first item, stacks with torch, runs `predict` and
    resolves each Future with its row.

    `max_queue` > 0 bounds the backlog: a submit() that would exceed it
    fails fast with OverloadedError (-> 503). 0 = unbounded.
    `buckets=True` pads to the next power of two >= the coalesced count
    (capped at `batch`) instead of always the full batch.
    """

    _SENTINEL = object()

    def __init__(
        self,
        predict,
        batch: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: int = 0,
        buckets: bool = False,
    ):
        self._predict = predict
        self.batch = int(batch)
        self.buckets = bool(buckets)
        self.max_queue = int(max_queue)
        self.max_wait = float(max_wait_ms) / 1000.0
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.n_requests = 0
        self.n_batches = 0
        self.n_rejected = 0
        self.n_padded_rows = 0  # rows computed but not requested
        self.predict_seconds = 0.0  # wall time inside the device call
        self._closed = False
        self._stats_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, pixels) -> Future:
        fut: Future = Future()
        if self._closed:  # fail fast instead of waiting out the timeout
            fut.set_exception(RuntimeError("server shutting down"))
            return fut
        if self.max_queue and self._q.qsize() >= self.max_queue:
            # qsize is approximate under concurrency: a soft admission
            # bound, which is all an overload guard needs
            with self._stats_lock:
                self.n_rejected += 1
            fut.set_exception(
                OverloadedError(
                    f"server overloaded (~{self._q.qsize()} requests "
                    f"queued, limit {self.max_queue})"
                )
            )
            return fut
        self._q.put((pixels, fut))
        if self._closed:
            # close() may have finished its final drain between the check
            # above and the put; drain again so THIS future resolves now
            self._drain_failed(preserve_sentinel=True)
        return fut

    def close(self) -> None:
        self._closed = True  # before the sentinel: submit() races close()
        self._q.put(self._SENTINEL)
        self._worker.join(timeout=5.0)
        self._drain_failed()  # anything enqueued after the sentinel

    def _drain_failed(self, preserve_sentinel: bool = False) -> None:
        """Fail every queued Future now, so handler threads get an error
        instead of blocking out their full timeout. A handler-side drain
        (submit() racing close()) re-enqueues the shutdown sentinel and
        stops: the worker may still be waiting for it."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is self._SENTINEL:
                if preserve_sentinel:
                    self._q.put(item)
                    return
            else:
                item[1].set_exception(RuntimeError("server shutting down"))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                self._drain_failed()
                return
            items = [item]
            deadline = time.monotonic() + self.max_wait
            while len(items) < self.batch:
                try:
                    nxt = self._q.get(timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if nxt is self._SENTINEL:
                    self._flush(items)
                    self._drain_failed()
                    return
                items.append(nxt)
            self._flush(items)

    def bucket_sizes(self):
        """The padded batch shapes this batcher can run: powers of two up
        to `batch`, or just `batch` when bucketing is off."""
        if not self.buckets:
            return [self.batch]
        sizes, b = [], 1
        while b < self.batch:
            sizes.append(b)
            b <<= 1
        return sizes + [self.batch]

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


class _Model:
    """The served model: engine + its micro-batcher. Preprocessing runs
    the port's batched resize on the engine's device."""

    def __init__(self, engine, batcher: MicroBatcher):
        self.engine = engine
        self.batcher = batcher

    def preprocess(self, img):
        hp = self.engine.hp
        mean, std = norm_constants(hp.pixel_norm)
        return preprocess_batch(
            [img], hp.img_size, mode=hp.interpolation, mean=mean, std=std,
            device=self.engine.device,
        )[0]

    def health(self):
        hp = self.engine.hp
        h = {
            "model": "vit",
            "hidden_size": hp.hidden_size,
            "img_size": hp.img_size,
            "batch": self.batcher.batch,
        }
        if self.batcher.buckets:
            h["buckets"] = self.batcher.bucket_sizes()
        return h


def _counters(b: MicroBatcher) -> dict:
    return {
        "requests": b.n_requests,
        "batches": b.n_batches,
        "rejected": b.n_rejected,
        "queued": b._q.qsize(),
        "padded_rows": b.n_padded_rows,
        "predict_seconds": round(b.predict_seconds, 6),
    }


def _prometheus_metrics(model: _Model) -> str:
    """The /stats counters in Prometheus text exposition format, labeled
    by model (the one model is "default", as in the JAX daemon) and route."""
    metrics = [
        ("vit_requests_total", "counter", "requests served",
         lambda b: b.n_requests),
        ("vit_batches_total", "counter", "device batches executed",
         lambda b: b.n_batches),
        ("vit_rejected_total", "counter",
         "requests rejected by the admission bound (503)",
         lambda b: b.n_rejected),
        ("vit_padded_rows_total", "counter",
         "batch rows computed as padding", lambda b: b.n_padded_rows),
        ("vit_predict_seconds_total", "counter",
         "wall seconds inside device predict calls",
         lambda b: round(b.predict_seconds, 6)),
        ("vit_queue_depth", "gauge", "requests waiting for the device",
         lambda b: b._q.qsize()),
    ]
    out = []
    for metric, typ, help_, get in metrics:
        out.append(f"# HELP {metric} {help_}")
        out.append(f"# TYPE {metric} {typ}")
        out.append(f'{metric}{{model="default",route="classify"}} {get(model.batcher)}')
    return "\n".join(out) + "\n"


def _make_handler(model: _Model, timeout_s: float, max_body_bytes: int):
    routes = ("/v1/classify",)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, **model.health()})
            elif self.path == "/stats":
                self._json(200, _counters(model.batcher))
            elif self.path == "/metrics":
                body = _prometheus_metrics(model).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path not in routes:
                self._json(404, {"error": f"no route {path} (use {' or '.join(routes)})"})
                return
            n = int(self.headers.get("Content-Length") or 0)
            if n > max_body_bytes:
                self._json(413, {"error": f"body {n} bytes > limit {max_body_bytes}"})
                return
            data = self.rfile.read(n) if n else b""
            img = decode_rgb_from_bytes(data)
            if img is None:
                self._json(400, {"error": "undecodable image"})
                return
            topk = 5
            for kv in query.split("&"):
                if kv.startswith("topk="):
                    try:
                        topk = max(1, int(kv[5:]))
                    except ValueError:
                        self._json(400, {"error": f"bad query {kv!r}"})
                        return
            pixels = model.preprocess(img)
            try:
                probs = model.batcher.submit(pixels).result(timeout=timeout_s)
            except OverloadedError as e:  # bounded queue: tell clients to back off
                self._json(503, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:  # device failure/timeout -> JSON, not a dropped socket
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            order = np.argsort(-probs, kind="stable")[:topk]
            id2label = model.engine.id2label
            self._json(200, {"topk": [
                {"id": int(i), "label": id2label.get(int(i), f"LABEL_{i}"),
                 "prob": float(probs[i])}
                for i in order
            ]})

    return Handler


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
    handler = _make_handler(
        _Model(engine, batcher),
        timeout_s=request_timeout_s,
        max_body_bytes=MAX_BODY_BYTES,
    )
    return ThreadingHTTPServer((host, port), handler), batcher
