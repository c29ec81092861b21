"""HTTP serving daemon with micro-batching, on a PyTorch engine.

Counterpart of vit_cpp_tpu/server.py::create_server and
create_multi_server, with the port's own copy of that module's HTTP
parts: the request handler (routes /healthz, /stats, /metrics, POST
/v1/classify and /v1/embed, per model in a multi-model daemon), the image
decode, the ThreadingHTTPServer, the admission bound and the Prometheus
text. Request handlers decode and preprocess onto the engine's device
(grayscale for a ViTSTR engine),
and the micro-batcher stacks those tensors with torch. Images decode
through decode.py, which tries the native decoder once per process.

Endpoints of one model (create_server; the raw image bytes are the body
of a POST):
  GET  /healthz, /stats, /metrics
  POST /v1/classify[?topk=K]  -> {"topk": [{"id", "label", "prob"}, ...]}
  POST /v1/recognize          -> {"text", "confidence"}  (ViTSTR, in place
                                 of /v1/classify; greedy decoding)
  POST /v1/embed              -> {"shape": [...], "embedding": [floats]}
                                 (the final-LN pooled features, through a
                                 second MicroBatcher over features_batch
                                 with the same admission bound and
                                 timeout, closed with the main one)
A headless encoder (num_classes=0) serves /v1/embed as its only route,
through the main batcher.

A sharded engine (VitEngine.shard, `vit-server --mesh DPxTP` under a
launcher) serves from rank 0: the daemon there runs HTTP and the
micro-batchers behind a `MeshLeader`, whose every dispatch first
broadcasts an opcode, the shape and the padded batch to the world, then
runs the engine call that every rank takes part in; the other ranks run
`follow`, which joins the same calls until the stop opcode that the
leader broadcasts at shutdown. A rank that dies makes the leader's next
collective fail within the group timeout: the leader then fails that
batch, refuses every later one and reports the failure, and the daemon's
exit code is not 0. Bucket sizes of a sharded engine are multiples of
the data axis (`_shardable_buckets`).

Several models (create_multi_server, `vit-server -m name=path` repeated):
each has its own batchers behind POST /v1/<name>/classify (or
/v1/<name>/recognize) and /v1/<name>/embed; /healthz and /stats are
keyed by model name and /metrics labels every counter with it.
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
    (capped at `batch`) instead of always the full batch. A list of sizes
    (a multi-batch .vitx artifact's baked `batches`) buckets over exactly
    those; it must end at `batch`.
    """

    _SENTINEL = object()

    def __init__(
        self,
        predict,
        batch: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: int = 0,
        buckets=False,
    ):
        self._predict = predict
        self.batch = int(batch)
        if isinstance(buckets, (list, tuple)):
            sizes = sorted(int(b) for b in buckets)
            if not sizes or sizes[-1] != self.batch:
                raise ValueError(
                    f"bucket sizes {sizes} must be non-empty and end at "
                    f"batch {self.batch}"
                )
            self.buckets = sizes
        else:
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
        self.child: Optional["MicroBatcher"] = None  # closed with this one
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
        if self.child is not None:
            self.child.close()

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
        to `batch`, the given sizes, or just `batch` when bucketing is off."""
        if isinstance(self.buckets, list):
            return self.buckets
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


def _is_headless(engine) -> bool:
    """A headless encoder serves embeddings only."""
    return engine.hp.num_classes == 0


_STOP, _CLASSIFY, _EMBED = 0, 1, 2


def _header(device, op: int = _STOP, shape=()) -> torch.Tensor:
    """(opcode, ndim, dims...) as one int64 tensor of 6 on `device`."""
    return torch.tensor([op, len(shape), *shape, *[0] * (4 - len(shape))],
                        dtype=torch.int64, device=device)


class MeshLeader:
    """Rank 0's view of a sharded engine for the daemon: the engine's own
    attributes, and `predict_probs_batch` / `features_batch` that
    broadcast the dispatch to the follower ranks first (one at a time:
    the daemon's batchers run on two threads, and the ranks must see the
    same sequence of collectives)."""

    def __init__(self, engine):
        self._engine = engine
        self._lock = threading.Lock()
        self.failed: Optional[BaseException] = None
        self.on_failure = None  # called with the error of a failed dispatch

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _dispatch(self, op: int, images: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        with self._lock:
            if self.failed is not None:
                raise RuntimeError(f"a mesh rank failed: {self.failed}")
            try:
                images = images.to(self._engine.device, torch.float32).contiguous()
                dist.broadcast(_header(images.device, op, images.shape), src=0)
                dist.broadcast(images, src=0)
                if op == _CLASSIFY:
                    return self._engine.predict_probs_batch(images)
                return self._engine.features_batch(images)
            except Exception as e:
                self.failed = e
                if self.on_failure is not None:
                    self.on_failure(e)
                raise

    def predict_probs_batch(self, images: torch.Tensor) -> torch.Tensor:
        return self._dispatch(_CLASSIFY, images)

    def features_batch(self, images: torch.Tensor) -> torch.Tensor:
        return self._dispatch(_EMBED, images)

    def stop(self) -> None:
        """Broadcast the stop opcode: the followers return."""
        import torch.distributed as dist

        with self._lock:
            if self.failed is None:
                dist.broadcast(_header(self._engine.device), src=0)


def follow(engine) -> None:
    """A rank other than 0 of a sharded daemon: take part in every
    dispatch the leader broadcasts, until its stop opcode."""
    import torch.distributed as dist

    while True:
        head = _header(engine.device)
        dist.broadcast(head, src=0)
        op, ndim, *dims = head.tolist()
        if op == _STOP:
            return
        images = torch.empty(dims[:ndim], dtype=torch.float32, device=engine.device)
        dist.broadcast(images, src=0)
        if op == _CLASSIFY:
            engine.predict_probs_batch(images)
        else:
            engine.features_batch(images)


def _shardable_buckets(engine, batch: int, buckets):
    """Constrain bucket sizes to multiples of a sharded engine's data
    axis (vit_cpp_tpu/server.py::_shardable_buckets): a (1, ...) batch
    cannot be split dp ways. No-op for unsharded engines or
    buckets=False."""
    from vit_cpp_tpu_torch.parallel.mesh import axis_size

    mesh = getattr(engine, "mesh", None)
    if not buckets or mesh is None:
        return buckets
    dp = axis_size(mesh, "data")
    if dp <= 1:
        return buckets
    if isinstance(buckets, (list, tuple)):
        bad = [b for b in buckets if int(b) % dp]
        if bad:
            raise ValueError(
                f"bucket sizes {bad} do not divide the mesh data axis "
                f"(dp={dp}) — a sharded engine cannot run them"
            )
        return buckets
    sizes, b = [], 1
    while b < batch:
        if b % dp == 0:
            sizes.append(b)
        b <<= 1
    sizes.append(batch)  # callers validate batch % dp when sharding
    return sizes if len(sizes) > 1 else False


class _Model:
    """A served model: its name (None for the single-model daemon), the
    engine, its micro-batcher (the classifier, or the features of a
    headless encoder) and the embed batcher of a classifier.
    Preprocessing runs the port's batched resize on the engine's device."""

    def __init__(self, name, engine, batcher: MicroBatcher):
        self.name = name
        self.engine = engine
        self.batcher = batcher
        self.is_headless = _is_headless(engine)
        self.is_vitstr = engine.hp.seq_len is not None  # the recognize route
        self.embed_batcher: Optional[MicroBatcher] = None
        # a classifier .vitx artifact holds no features program: no embed
        # route (404), as in the JAX daemon
        meta = getattr(engine, "meta", None)
        can_embed = meta is None or meta.get("program") == "features"
        if not self.is_headless and can_embed:
            self.embed_batcher = MicroBatcher(
                engine.features_batch,
                batch=batcher.batch,
                max_wait_ms=batcher.max_wait * 1000.0,
                max_queue=batcher.max_queue,
            )
            batcher.child = self.embed_batcher

    def preprocess(self, img):
        return self.engine.preprocess_image(img)

    def routes(self, prefix: str) -> dict:
        """{path: (model, kind)} under `prefix` ("/v1" or "/v1/<name>");
        kind "embed" reads the features, None the classifier (or the
        recognizer)."""
        if self.is_headless:
            return {f"{prefix}/embed": (self, "embed")}
        routes = {f"{prefix}/{self.route}": (self, None)}
        if self.embed_batcher is not None:
            routes[f"{prefix}/embed"] = (self, "embed")
        return routes

    @property
    def route(self) -> str:
        """The main batcher's route."""
        if self.is_headless:
            return "embed"
        return "recognize" if self.is_vitstr else "classify"

    def health(self):
        hp = self.engine.hp
        h = {
            "model": "vit-encoder" if self.is_headless else "vitstr" if self.is_vitstr else "vit",
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


def _stats(model: _Model) -> dict:
    s = _counters(model.batcher)
    if model.embed_batcher is not None:
        s["embed"] = _counters(model.embed_batcher)
    return s


def _prometheus_metrics(models) -> str:
    """The /stats counters in Prometheus text exposition format, labelled
    by model (the single-model daemon's is "default", as in the JAX
    daemon) and route (classify, recognize or embed)."""
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

    def esc(label: str) -> str:  # label escaping: backslash, quote, newline
        return label.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

    rows = []
    for m in models:
        name = esc(m.name or "default")
        rows.append((name, m.route, m.batcher))
        if m.embed_batcher is not None:
            rows.append((name, "embed", m.embed_batcher))
    out = []
    for metric, typ, help_, get in metrics:
        out.append(f"# HELP {metric} {help_}")
        out.append(f"# TYPE {metric} {typ}")
        for name, route, b in rows:
            out.append(f'{metric}{{model="{name}",route="{route}"}} {get(b)}')
    return "\n".join(out) + "\n"


def make_handler(model: _Model, timeout_s: float = 30.0):
    """The single-model handler: routes /v1/classify (/v1/recognize for
    ViTSTR) and /v1/embed (a headless encoder's /v1/embed only); /healthz
    and /stats describe the one model."""
    return _make_handler(model.routes("/v1"), [model], single=True, timeout_s=timeout_s)


def make_multi_handler(models, timeout_s: float = 30.0):
    """The multi-model handler: routes /v1/<name>/classify (or
    /v1/<name>/recognize) and /v1/<name>/embed per model; /healthz,
    /stats and /metrics are keyed by model name."""
    routes = {}
    for m in models:
        routes.update(m.routes(f"/v1/{m.name}"))
    return _make_handler(routes, list(models), single=False, timeout_s=timeout_s)


def _make_handler(routes: dict, models: list, *, single: bool, timeout_s: float):

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
                if single:
                    self._json(200, {"ok": True, **models[0].health()})
                else:
                    self._json(200, {"ok": True,
                                     "models": {m.name: m.health() for m in models}})
            elif self.path == "/stats":
                if single:
                    self._json(200, _stats(models[0]))
                else:
                    self._json(200, {m.name: _stats(m) for m in models})
            elif self.path == "/metrics":
                body = _prometheus_metrics(models).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            model, kind = routes.get(path, (None, None))
            n = int(self.headers.get("Content-Length") or 0)
            if model is None:
                if n <= MAX_BODY_BYTES:  # a body left unread resets the connection under the answer
                    self.rfile.read(n)
                self._json(404, {"error": f"no route {path} (use {' or '.join(sorted(routes))})"})
                return
            if n > MAX_BODY_BYTES:
                self._json(413, {"error": f"body {n} bytes > limit {MAX_BODY_BYTES}"})
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
            # a headless encoder embeds through its main batcher
            batcher = (model.embed_batcher or model.batcher) if kind == "embed" else model.batcher
            try:
                out = batcher.submit(pixels).result(timeout=timeout_s)
            except OverloadedError as e:  # bounded queue: tell clients to back off
                self._json(503, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:  # device failure/timeout -> JSON, not a dropped socket
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if kind == "embed":
                feat = np.asarray(out, dtype=np.float32)
                self._json(200, {"shape": list(feat.shape),
                                 "embedding": [float(v) for v in feat.reshape(-1)]})
                return
            if model.is_vitstr:
                from vit_cpp_tpu_torch.models.vitstr import greedy_decode

                text, conf = greedy_decode(out, model.engine.id2label)
                self._json(200, {"text": text, "confidence": float(conf)})
                return
            order = np.argsort(-out, kind="stable")[:topk]
            id2label = model.engine.id2label
            self._json(200, {"topk": [
                {"id": int(i), "label": id2label.get(int(i), f"LABEL_{i}"),
                 "prob": float(out[i])}
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


def _batcher(engine, batch: int, max_wait_ms: float, max_queue: int,
             buckets) -> MicroBatcher:
    """The main batcher of a model: its classifier, or a headless
    encoder's features."""
    return MicroBatcher(
        engine.features_batch if _is_headless(engine) else engine.predict_probs_batch,
        batch=batch,
        max_wait_ms=max_wait_ms,
        max_queue=max_queue,
        buckets=buckets,
    )


def create_server(
    engine,
    host: str = "127.0.0.1",
    port: int = 8000,
    batch: int = 8,
    max_wait_ms: float = 5.0,
    warmup: bool = True,
    request_timeout_s: float = 30.0,
    max_queue: int = 0,
    buckets=False,
):
    """Build (ThreadingHTTPServer, MicroBatcher); the caller runs
    serve_forever() and closes both (closing the batcher closes the embed
    batcher too). warmup=True runs the dummy batch(es) of the main batcher
    before the port is bound. A headless encoder's batcher runs
    features_batch. A sharded engine's buckets are multiples of its data
    axis (_shardable_buckets)."""
    batcher = _batcher(engine, batch, max_wait_ms, max_queue,
                       _shardable_buckets(engine, batch, buckets))
    if warmup:
        _warm(engine, batcher)
    handler = make_handler(_Model(None, engine, batcher), timeout_s=request_timeout_s)
    return ThreadingHTTPServer((host, port), handler), batcher


def create_multi_server(
    engines,
    host: str = "127.0.0.1",
    port: int = 8000,
    batch=8,
    max_wait_ms: float = 5.0,
    warmup: bool = True,
    request_timeout_s: float = 30.0,
    max_queue: int = 0,
    buckets=False,
):
    """Serve several models from one daemon (vit_cpp_tpu/server.py:719-770):
    `engines` is {name: engine}, each with its own MicroBatcher (and
    embed batcher, closed with it) behind the routes /v1/<name>/classify
    (/v1/<name>/recognize for ViTSTR) and /v1/<name>/embed. `batch` and `buckets` are one value or a
    {name: value} map. Names must be non-empty and '/'-free. Returns
    (httpd, {name: batcher}); the caller closes every batcher."""
    if not engines:
        raise ValueError("create_multi_server needs at least one engine")
    models = []
    for name, engine in engines.items():
        if not name or "/" in name:
            raise ValueError(f"bad model name {name!r} (non-empty, no '/')")
        b = batch[name] if isinstance(batch, dict) else batch
        bk = buckets[name] if isinstance(buckets, dict) else buckets
        models.append(_Model(name, engine, _batcher(engine, b, max_wait_ms, max_queue,
                                                    _shardable_buckets(engine, b, bk))))
    if warmup:
        for m in models:
            _warm(m.engine, m.batcher)
    handler = make_multi_handler(models, timeout_s=request_timeout_s)
    return ThreadingHTTPServer((host, port), handler), {m.name: m.batcher for m in models}
