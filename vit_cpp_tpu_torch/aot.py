"""AOT serving artifacts: one file = exported programs + weights + meta.

Counterpart of vit_cpp_tpu/aot.py. `export_engine` captures an engine's
serving forward with `torch.export` for a fixed input batch, the weights
closed over as constants of the program, and writes each program with
`torch.export.save`. `AotEngine` serves the `.vitx` file in a process
that needs no model code (models/vit.py, models/params.py, engine.py),
no gguf file and no engine flags: `torch.export.load(...).module()`
restores each program as it was captured.

File layout, the JAX package's container:

    b"VITX\\x01" | u32 json_len | meta json | torch.export blob(s)

One program per batch size (`vit-export -b 1,64`), concatenated after the
metadata and indexed by meta["batches"] and meta["blob_lengths"]: the
single-image front ends run the smallest batch, serving the largest
(meta["batch"]). Each program holds its own copy of the weights, so N
batch sizes cost ~N x the model size on disk, as in the JAX package.

A sharded engine (VitEngine.shard over a ('data', 'model') mesh of dp x
tp ranks) exports through the same call, made on every rank. Each model
rank's program holds that rank's Megatron shards and its collectives over
"model" as operator nodes (parallel/mesh.py: all_reduce_over,
all_gather_over), and runs B/dp rows of a global batch B. The data ranks
of one model rank run the same program, so the file holds tp programs per
batch size: meta["blob_lengths"] lists them batch by batch, and within a
batch by model rank (index b_i * tp + m). World rank 0 gathers them and
returns the file; meta["mesh"] = {"axis_names": ["data", "model"],
"axis_sizes": [dp, tp]} as the JAX package writes it, and "batch" /
"batches" stay the global sizes, which dp must divide. `AotEngine` on such
a file builds the mesh over the launcher's ranks (one process per device,
`python -m torch.distributed.run --nproc-per-node dp*tp`), loads its model
rank's programs, and serves the global batch as VitEngine.shard does: the
rank's rows through its program, the outputs all-gathered over "data".
With fewer ranks than the mesh it raises the JAX package's message.

The kernels stay in the program: attention_qkv (K1), flash_attention and
dequant_matmul (K4) are PyTorch operators (ops/flash_attention.py,
ops/qmatmul.py), so the capture records each call as one
`vit_cpp_tpu_torch::...` node, and the loaded program launches the kernel
and advances its launch count. The W8A8 linears are aten operators
(`torch._int_mm`).

The meta keeps every key of the JAX package's and adds "format":
"torch.export" and "matmul_precision", the engine's f32 matmul precision,
which AotEngine applies around every call (ops/precision.py: the TF32
flags are process-global and not part of a graph). "platforms" is
["torch-cuda"] or ["torch-cpu"], the device the program was captured on:
the port lowers for no other, a program captured on the card runs only
on the card, and the JAX package's AotEngine refuses the file with its own
"exported for platforms" message. A JAX-made artifact (no "format") is
refused here by name.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

MAGIC = b"VITX\x01"
FORMAT = "torch.export"


def platform_of(device) -> str:
    """The artifact platform name of a torch device: torch-cuda, torch-cpu."""
    return f"torch-{torch.device(device).type}"


def check_platforms(platforms, device) -> None:
    """Raise ValueError unless every entry of `platforms` names `device`
    (as "torch-cuda" or "cuda"): the port exports only for the device it
    runs on."""
    here = platform_of(device)
    other = [p for p in platforms if p not in (here, here[len("torch-"):])]
    if other:
        raise ValueError(
            f"vit_cpp_tpu_torch exports only for the device it runs on ({here}) "
            f"and cannot lower for {other}; export on the serving device "
            "(--device) instead"
        )


class _Program(torch.nn.Module):
    """The serving forward of one engine: pixels (B, C, S, S) f32 ->
    probabilities (softmax in f32), or the pooled features of a headless
    encoder in the engine's dtype; of a sharded engine, this rank's shards
    on its rows of the batch."""

    def __init__(self, engine, headless: bool):
        super().__init__()
        # a plain attribute, not parameters: the export keeps the tensors
        # as constants of the program
        self.tree = engine.params
        self.hp = engine.hp
        self.attn_impl, self.mm_impl = engine.attn_impl, engine.mm_impl
        self.tome = engine.tome
        self.headless = headless
        self.mesh = getattr(engine, "mesh", None)  # this rank's shards, its collectives

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        from vit_cpp_tpu_torch.models.vit import forward

        out = forward(self.tree, images, self.hp, attn_impl=self.attn_impl,
                      mm_impl=self.mm_impl, features=self.headless, tome=self.tome,
                      mesh=self.mesh)
        return out if self.headless else torch.softmax(out.float(), dim=-1)


def export_engine(engine, batch, platforms=None) -> bytes:
    """Serialize a VitEngine's (or VitstrEngine's) serving forward for
    fixed batch size(s): an int or a list of ints, one program each.

    The program is captured on the engine's device under torch.no_grad()
    and the engine's matmul precision; `platforms`, when given, must name
    that device (check_platforms). Headless encoders (num_classes=0)
    export the features program (meta["program"] = "features"); ToMe
    (meta["tome"]), W8A8 with static or dynamic scales (meta["act"]),
    ViTSTR's (B, seq_len, V) probabilities and V-MoE trees go in as the
    engine serves them. Static scales that the engine would calibrate on
    its first batch are not measured here: calibrate first.

    A sharded engine (VitEngine.shard) is exported by every rank of its
    mesh together (module docstring): the file comes back on world rank 0
    and None on the others."""
    from vit_cpp_tpu_torch.ops.precision import matmul_precision
    from vit_cpp_tpu_torch.parallel.mesh import axis_rank, axis_size

    mesh = getattr(engine, "mesh", None)
    dp, tp = axis_size(mesh, "data"), axis_size(mesh, "model")
    hp = engine.hp
    headless = hp.seq_len is None and hp.num_classes == 0
    here = platform_of(engine.device)
    if platforms is not None:
        check_platforms(platforms, engine.device)
    batches = sorted(
        {int(b) for b in (batch if isinstance(batch, (list, tuple)) else [batch])}
    )
    if not batches or batches[0] < 1:
        raise ValueError(f"batch sizes must be >= 1, got {batches}")
    shape = (hp.in_chans, hp.img_size, hp.img_size)
    for b in batches:
        if b % dp:
            raise ValueError(
                f"export_engine: the batch is sharded over the mesh's 'data' axis, which "
                f"implies that the global size of its dimension 0 should be divisible by "
                f"{dp}, but it is equal to {b} (full shape: {(b, *shape)})"
            )
    program = _Program(engine, headless).eval()
    blobs = []
    # the data ranks of a model rank share its program: data rank 0 traces it
    if axis_rank(mesh, "data") == 0:
        for b in batches:
            x = torch.zeros((b // dp, *shape), dtype=torch.float32, device=engine.device)
            with torch.no_grad(), matmul_precision(engine.matmul_precision):
                exported = torch.export.export(program, (x,), strict=False)
            exported.example_inputs = None  # the save would keep the zeros
            buf = io.BytesIO()
            torch.export.save(exported, buf)
            blobs.append(buf.getvalue())
    if mesh is not None:
        blobs = _gather_programs(blobs, len(batches), tp)
        if blobs is None:
            return None
    hp_dict = {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in dataclasses.asdict(hp).items()
        if not (k == "mlp_hidden" and v is None)
    }
    meta = {
        "format": FORMAT,
        "batch": batches[-1],
        "batches": batches,
        "blob_lengths": [len(b) for b in blobs],
        "hparams": hp_dict,
        "id2label": {str(k): v for k, v in engine.id2label.items()},
        "platforms": [here],
        "attn_impl": engine.attn_impl,
        "mm_impl": engine.mm_impl,
        "matmul_precision": engine.matmul_precision,
        **({"program": "features"} if headless else {}),
        **({"tome": engine.tome} if engine.tome else {}),
    }
    if engine.mm_impl == "int8":
        from vit_cpp_tpu_torch.quant.int8 import params_have_static_scales

        meta["act"] = "static" if params_have_static_scales(engine.params) else "dynamic"
    if mesh is not None:
        meta["mesh"] = {"axis_names": ["data", "model"], "axis_sizes": [dp, tp]}
    mj = json.dumps(meta).encode()
    return MAGIC + struct.pack("<I", len(mj)) + mj + b"".join(blobs)


def _gather_programs(blobs, n_batches: int, tp: int):
    """Every model rank's programs on world rank 0, batch by batch and
    within a batch by model rank (ranks 0 .. tp-1 of the world are data
    rank 0 of the mesh grid); None on the other ranks."""
    import torch.distributed as dist

    parts = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(blobs, parts, dst=0)
    if parts is None:
        return None
    return [parts[m][i] for i in range(n_batches) for m in range(tp)]


def save_engine(engine, path: str, batch, platforms=None) -> Dict[str, Any]:
    """Write export_engine's file to `path` and return its meta; a
    sharded engine's ranks call it together, world rank 0 writes, and
    every rank returns the meta."""
    blob = export_engine(engine, batch, platforms=platforms)
    meta = None
    if blob is not None:
        with open(path, "wb") as f:
            f.write(blob)
        meta, _ = _split(blob)
    if getattr(engine, "mesh", None) is not None:
        import torch.distributed as dist

        box = [meta]
        dist.broadcast_object_list(box, src=0)
        meta = box[0]
    return meta


def _split(data: bytes) -> Tuple[Dict[str, Any], bytes]:
    if data[: len(MAGIC)] != MAGIC:
        raise ValueError("not a VITX artifact (bad magic)")
    off = len(MAGIC) + 4
    if len(data) < off:
        raise ValueError("truncated VITX artifact (header)")
    (n,) = struct.unpack_from("<I", data, len(MAGIC))
    if len(data) < off + n:
        raise ValueError("truncated VITX artifact (metadata)")
    try:
        meta = json.loads(data[off : off + n])
    except ValueError as e:
        raise ValueError(f"corrupt VITX metadata: {e}") from None
    return meta, data[off + n :]


def read_meta(path: str) -> Dict[str, Any]:
    """Parse just the metadata header (no full-file read: artifacts embed
    the weights); vit_cpp_tpu/aot.py::read_meta."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC) + 4)
        if head[: len(MAGIC)] != MAGIC:
            raise ValueError("not a VITX artifact (bad magic)")
        if len(head) < len(MAGIC) + 4:
            raise ValueError("truncated VITX artifact (header)")
        (n,) = struct.unpack("<I", head[len(MAGIC) :])
        mj = f.read(n)
    if len(mj) < n:
        raise ValueError("truncated VITX artifact (metadata)")
    try:
        return json.loads(mj)
    except ValueError as e:
        raise ValueError(f"corrupt VITX metadata: {e}") from None


def is_vitx(path: str) -> bool:
    """True when `path` is a .vitx artifact (by magic, not extension), so
    that the serving CLIs take a gguf checkpoint or an artifact through
    the same -m flag; vit_cpp_tpu/aot.py::is_vitx."""
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


def _on_device(program, device: torch.device):
    """`program` with its weights and the devices written into its graph
    on `device` when it was captured on another card of the same kind: a
    sharded artifact's model-rank program is captured on the card of data
    rank 0 and runs on every data rank's card; an artifact captured on
    cuda:0 serves on cuda:1."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    tensors = [*program.state_dict.values(), *program.constants.values()]
    other = {str(t.device) for t in tensors
             if isinstance(t, torch.Tensor) and t.device.type == device.type} - {str(device)}
    if not other:
        return program
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, {d: str(device) for d in other})


def _rebuild_mesh(path: str, spec: Dict[str, Any], device: torch.device):
    """The artifact's ('data', 'model') mesh over this world's ranks; the
    JAX package's message (vit_cpp_tpu/aot.py) and the launcher's command
    when the world has fewer ranks than the mesh has devices."""
    from vit_cpp_tpu_torch.parallel.mesh import available_ranks, launcher_hint, make_mesh

    names, sizes = tuple(spec["axis_names"]), [int(s) for s in spec["axis_sizes"]]
    if names != ("data", "model"):
        raise ValueError(f"{path}: mesh axes {list(names)}, want ['data', 'model']")
    n = sizes[0] * sizes[1]
    have = available_ranks()
    if have < n:
        raise ValueError(
            f"{path} is a sharded artifact for {n} devices "
            f"(mesh {dict(zip(names, sizes))}); this process has "
            f"{have} — re-export single-chip or serve on a "
            f"{n}-device host; " + launcher_hint("serve", n, "a sharded artifact")
        )
    return make_mesh(n, dp=sizes[0], tp=sizes[1], device_type=device.type)


class AotEngine:
    """Serve a port-made .vitx artifact: VitEngine's serving surface (hp,
    id2label, preprocess_image(s), predict_probs_batch, features_batch,
    classify_file, recognize_file) at the artifact's fixed batch size(s),
    on `device` (default cuda), which must be the device the artifact was
    exported on. `.batches` lists every exported size, `.batch` is the
    largest (pair it with serve_files(..., batch=engine.batch) or the
    daemon's micro-batcher) and the single-image front ends run the
    smallest. Outputs stay on the device, as VitEngine's do. A sharded
    artifact (meta["mesh"]) is loaded by every rank of a launcher's world
    of dp x tp processes, each on `cuda:LOCAL_RANK` (or the CPU), and
    `.mesh` is the mesh it built; every rank then calls the serving
    methods with the same global batch (server.py's MeshLeader / follow
    do that for the daemon)."""

    def __init__(self, path: str, device="cuda"):
        t0 = time.perf_counter()
        with open(path, "rb") as f:
            meta, blob = _split(f.read())
        if meta.get("format") != FORMAT:
            raise ValueError(
                f"{path} is a .vitx artifact of the JAX package (vit_cpp_tpu): "
                "it carries StableHLO and cannot run under vit_cpp_tpu_torch; "
                "export the gguf checkpoint with the port's vit-export "
                "(python -m vit_cpp_tpu_torch.cli.export_aot MODEL.gguf OUT.vitx)"
            )
        self.meta = meta
        self.batch = int(meta["batch"])
        self.batches = [int(b) for b in meta.get("batches", [self.batch])]
        blob_lengths = meta.get("blob_lengths", [len(blob)])
        if sum(blob_lengths) != len(blob):
            raise ValueError(
                f"{path}: blob_lengths {blob_lengths} do not cover the "
                f"{len(blob)}-byte program section (truncated artifact?)"
            )
        from vit_cpp_tpu_torch.hparams import VitHParams

        # a newer writer's optional hparams must not brick this reader
        known = {f.name for f in dataclasses.fields(VitHParams)}
        self.hp = VitHParams(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in meta["hparams"].items() if k in known
        })
        self.id2label = {int(k): v for k, v in meta["id2label"].items()}
        self.device = torch.device(device)
        self.mesh, tp, model_rank = None, 1, 0
        if "mesh" in meta:
            from vit_cpp_tpu_torch.parallel.mesh import rank_device

            self.device = rank_device(device)
        here = platform_of(self.device)
        if here not in meta["platforms"]:
            raise ValueError(
                f"{path} was exported for platforms {meta['platforms']} but "
                f"this process runs on {here!r}; re-export with vit-export "
                f"--device {self.device.type} (or export on the serving device)"
            )
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise ValueError(
                f"{path} was exported for platforms {meta['platforms']} but "
                "torch.cuda.is_available() is False in this process"
            )
        self.matmul_precision = meta.get("matmul_precision", "highest")
        if "mesh" in meta:
            self.mesh = _rebuild_mesh(path, meta["mesh"], self.device)
            from vit_cpp_tpu_torch.parallel.mesh import axis_rank, axis_size

            tp, model_rank = axis_size(self.mesh, "model"), axis_rank(self.mesh, "model")
        if len(blob_lengths) != len(self.batches) * tp:
            raise ValueError(
                f"{path}: {len(blob_lengths)} programs for {len(self.batches)} batch "
                f"sizes x {tp} model ranks"
            )
        # the programs' kernel and collective operators must be registered
        # before loading
        import vit_cpp_tpu_torch.ops.flash_attention  # noqa: F401
        import vit_cpp_tpu_torch.ops.precision  # noqa: F401
        import vit_cpp_tpu_torch.ops.qmatmul  # noqa: F401
        import vit_cpp_tpu_torch.parallel.mesh  # noqa: F401

        self._programs = {}
        ends = np.cumsum([0, *blob_lengths])
        for i, b in enumerate(self.batches):
            j = i * tp + model_rank  # batch-major, then model rank
            program = torch.export.load(io.BytesIO(blob[ends[j] : ends[j + 1]]))
            self._programs[b] = _on_device(program, self.device).module()
        self.load_ms = (time.perf_counter() - t0) * 1000.0

    def preprocess_images(self, images) -> torch.Tensor:
        """(H, W, 3) u8 host images -> (B, C, S, S) f32 on the device,
        as the engine the artifact was exported from preprocesses them."""
        if self.hp.seq_len is not None:
            from vit_cpp_tpu_torch.models.vitstr import preprocess_grayscale_batch

            return preprocess_grayscale_batch(list(images), self.hp.img_size, self.device)
        from vit_cpp_tpu_torch.ops.preprocess import norm_constants, preprocess_batch

        mean, std = norm_constants(self.hp.pixel_norm)
        return preprocess_batch(
            list(images), self.hp.img_size, mode=self.hp.interpolation,
            mean=mean, std=std, device=self.device,
        )

    def preprocess_image(self, img_u8: np.ndarray) -> torch.Tensor:
        return self.preprocess_images([img_u8])[0]

    def predict_probs_batch(self, images: torch.Tensor) -> torch.Tensor:
        if self.meta.get("program") == "features":
            raise ValueError(
                "this artifact is a headless encoder (features program) — "
                "call features_batch / serve embeddings"
            )
        return self._run_batch(images)

    def features_batch(self, images: torch.Tensor) -> torch.Tensor:
        """Embeddings of a headless-encoder artifact (its program is the
        features program)."""
        if self.meta.get("program") != "features":
            raise ValueError(
                "this artifact exports the classifier program; embeddings "
                "need a headless-encoder checkpoint (vit-export one, or "
                "serve the gguf)"
            )
        return self._run_batch(images)

    def _run_batch(self, images: torch.Tensor) -> torch.Tensor:
        from vit_cpp_tpu_torch.ops.precision import matmul_precision

        prog = self._programs.get(int(images.shape[0]))
        if prog is None:
            raise ValueError(
                f"artifact is compiled for batch"
                f"{'es' if len(self.batches) > 1 else ''} "
                f"{'/'.join(map(str, self.batches))}, got {images.shape[0]} "
                "(pad at the serving layer)"
            )
        images = images.to(self.device, torch.float32).contiguous()
        with torch.inference_mode(), matmul_precision(self.matmul_precision):
            if self.mesh is None:
                return prog(images)
            from vit_cpp_tpu_torch.parallel.mesh import data_slice, gather_over_data

            return gather_over_data(prog(data_slice(images, self.mesh).contiguous()), self.mesh)

    def _predict_one(self, path: str, verbose: bool) -> np.ndarray:
        from vit_cpp_tpu_torch.io.image import load_image_rgb

        img = load_image_rgb(path)
        if verbose:
            print(f"load_image_from_file: loaded image '{path}' "
                  f"({img.shape[1]} x {img.shape[0]})")
        pixels = self.preprocess_image(img)
        if verbose:
            print(f"processed, out dims : ({self.hp.img_size} x {self.hp.img_size})")
        # the smallest exported batch (the latency program), row 0 read
        b = min(self.batches)
        stacked = pixels[None].expand(b, *pixels.shape)
        return self.predict_probs_batch(stacked)[0].float().cpu().numpy()

    def classify_file(self, path: str, topk: int = 5, verbose: bool = True):
        """[(class_id, prob, label)], VitEngine.classify_file's surface."""
        if self.hp.seq_len is not None:
            raise ValueError(
                "this artifact has a sequence head (ViTSTR); use the "
                "vitstr CLI / recognize_file instead of the classifier"
            )
        if self.meta.get("program") == "features":
            raise ValueError(
                "this artifact is a headless encoder (features program) — "
                "serve embeddings (vit-serve --embed / the daemon's "
                "/v1/embed route)"
            )
        probs = self._predict_one(path, verbose)
        order = np.argsort(-probs, kind="stable")[:topk]
        return [
            (int(i), float(probs[i]), self.id2label.get(int(i), f"LABEL_{i}"))
            for i in order
        ]

    def recognize_file(self, path: str, verbose: bool = True) -> Tuple[str, float]:
        """(text, confidence) by greedy decoding, VitstrEngine's surface."""
        from vit_cpp_tpu_torch.models.vitstr import greedy_decode

        if self.hp.seq_len is None:
            raise ValueError(
                "this artifact is a classifier; use classify_file / the vit CLI"
            )
        return greedy_decode(self._predict_one(path, verbose), self.id2label)

