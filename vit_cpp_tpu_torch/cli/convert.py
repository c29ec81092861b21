"""`vit-convert` on the PyTorch port: a torch .pth state dict -> gguf.

Counterpart of vit_cpp_tpu/cli/convert.py, with its flags and the same
output bytes. The reference converter's serialization rules
(convert-pth-to-ggml.py):

- dtype rule (py:141-148): at ftype=1 every tensor with ndim != 1 is
  written f16 EXCEPT `pos_embed`, `cls_token`, `dist_token`, `reg_token`
  and `attn_pool.probe` (kept f32); ftype=0 writes everything f32. One
  deliberate difference from the JAX converter: V-MoE routers
  (`.moe.router.`) stay f32 at ftype 1, as the quantizer keeps them;
- `patch_embed.proj.bias` is reshaped to (1, C, 1, 1) (py:150-151);
- `norm_pre.*` tensors are written and served (`--drop-norm-pre` skips
  them, as the reference converter does);
- DeiT-distilled, register and avg-pool checkpoints convert by tensor
  presence; HF SigLIP and CLIP vision towers are remapped to this schema;
- labels are `LABEL_{i}`, or ViTSTR's 96-token vocabulary (`--vitstr`,
  which also sums the patch conv's RGB channels into one).

The source is `--checkpoint model.pth` (a torch.save state dict, or a
dict holding one under 'state_dict'/'model'/'net'), with hparams inferred
from the tensor shapes; the one positional is the output directory.
Converting a timm model by name downloads it, so `--checkpoint` is
required. `--gguf` (alias `--real-gguf`) writes the real GGUF v3
container instead of the legacy layout.

Usage:
  python -m vit_cpp_tpu_torch.cli.convert --checkpoint vit.pth --heads 12 out_dir
  python -m vit_cpp_tpu_torch.cli.convert --checkpoint vit.pth --ftype 0 --gguf out_dir
  python -m vit_cpp_tpu_torch.cli.convert --checkpoint vitstr.pth --vitstr out_dir
"""

from __future__ import annotations

import argparse
import math
import os
import re
import sys
from typing import Dict, Iterable, Tuple

import numpy as np

from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType
from vit_cpp_tpu_torch.gguf.writer import write_model
from vit_cpp_tpu_torch.hparams import VitHParams

# Heads for the timm ViT family when only shapes are known
# (vit_{tiny,small,base,large}: hidden 192/384/768/1024 — reference
# README.md model table).
_DEFAULT_HEADS = {192: 3, 384: 6, 768: 12, 1024: 16, 1280: 16, 1408: 16}

_KEEP_F32 = ("pos_embed", "cls_token", "dist_token", "reg_token", "attn_pool.probe")


def serialize_state_dict(
    state: Dict[str, np.ndarray], ftype: int
) -> Iterable[Tuple[str, tuple, GGMLDType, np.ndarray]]:
    """Apply the reference converter's per-tensor rules (py:117-158), and
    keep every V-MoE router f32 at ftype 1, as the quantizer does
    (vit_cpp_tpu/cli/quantize.py:69): its top-k picks which experts run.
    The JAX converter writes routers f16; every other byte is the same."""
    for name, arr in state.items():
        arr = np.asarray(arr, dtype=np.float32)
        if name == "patch_embed.proj.bias":
            arr = arr.reshape(1, -1, 1, 1)  # (py:150-151)
        if (
            ftype == 1
            and arr.ndim != 1
            and name not in _KEEP_F32
            and ".moe.router." not in name
        ):
            yield name, arr.shape, GGMLDType.F16, arr.astype(np.float16)
        else:
            yield name, arr.shape, GGMLDType.F32, arr


def infer_hparams(
    state: Dict[str, np.ndarray],
    heads: int | None = None,
    pos_layout: str | None = None,
) -> VitHParams:
    """Derive hparams from tensor shapes (the file format stores them, the
    state dict does not)."""
    if "norm.weight" in state and "fc_norm.weight" in state:
        # load_params rejects such files; refuse to WRITE one (timm ViTs
        # carry exactly one of the two — the other is Identity)
        raise ValueError(
            "checkpoint has both norm.weight and fc_norm.weight — "
            "timm ViTs carry exactly one (the other is Identity)"
        )
    norm_key = "norm.weight" if "norm.weight" in state else "fc_norm.weight"
    if norm_key not in state or "patch_embed.proj.weight" not in state:
        raise ValueError(
            "state dict missing norm.weight/fc_norm.weight/"
            "patch_embed.proj.weight"
        )
    hidden = int(state[norm_key].shape[0])
    pe = state["patch_embed.proj.weight"]
    patch = int(pe.shape[-1])
    in_chans = int(pe.shape[1])
    n_tokens = int(np.asarray(state["pos_embed"]).shape[-2])
    if "dist_token" in state:
        n_prefix = 2
    elif "cls_token" in state:
        n_prefix = 1
    else:
        n_prefix = 0  # CLS-less avg-pool model (requires fc_norm)
    # DINOv2-style register tokens ride after CLS; they count toward the
    # pos_embed prefix rows (when embedded) and toward nothing else here
    n_reg = (
        int(np.asarray(state["reg_token"]).shape[-2])
        if "reg_token" in state
        else 0
    )
    # pos_embed rows = grid + prefix (embedded layout), or grid alone for
    # timm no_embed_class models (prefix concatenated after the positional
    # add). For prefixes 1-2 this is unambiguous (squares never differ by
    # 1 or 2 above 1); register prefixes can make BOTH readings square
    # (e.g. 9 rows with prefix 5: 2x2+5 or a bare 3x3) — then the caller
    # must disambiguate with --pos-layout (review r3).
    total_prefix = n_prefix + n_reg
    emb_side = int(math.isqrt(n_tokens - total_prefix))
    emb_ok = emb_side * emb_side == n_tokens - total_prefix
    grid_side = int(math.isqrt(n_tokens))
    grid_ok = total_prefix > 0 and grid_side * grid_side == n_tokens
    if pos_layout == "embedded":
        if not emb_ok:
            raise ValueError(
                f"--pos-layout embedded: pos_embed token count {n_tokens} "
                f"is not a square grid + {total_prefix} prefix"
            )
        grid_ok = False
    elif pos_layout == "grid":
        if not grid_ok:
            raise ValueError(
                f"--pos-layout grid: pos_embed token count {n_tokens} is "
                "not a bare square grid (or there is no prefix to defer)"
            )
        emb_ok = False
    elif pos_layout is not None:
        raise ValueError(
            f"pos_layout must be embedded|grid, got {pos_layout!r}"
        )
    elif emb_ok and grid_ok:
        raise ValueError(
            f"pos_embed layout is ambiguous: {n_tokens} rows read as both "
            f"a {emb_side}x{emb_side} grid + {total_prefix} embedded "
            f"prefix and a bare {grid_side}x{grid_side} grid "
            "(no_embed_class) — pass --pos-layout embedded|grid"
        )
    if emb_ok:
        side, no_embed_class = emb_side, False
    elif grid_ok:
        side, no_embed_class = grid_side, True
    else:
        raise ValueError(
            f"pos_embed token count {n_tokens} is not grid+"
            f"{total_prefix} prefix (nor a bare grid)"
        )
    layer_ids = [
        int(m.group(1))
        for m in (re.match(r"blocks\.(\d+)\.", k) for k in state)
        if m
    ]
    num_layers = max(layer_ids) + 1 if layer_ids else 0
    # headless encoders (MAE/DINO pretrained) have no classifier at all
    num_classes = (
        int(state["head.weight"].shape[0]) if "head.weight" in state else 0
    )
    # Non-4x MLP families (ViT-g: 6144 on hidden 1408) declare their width
    # through the fc1 shape; the loader re-infers it the same way at read.
    mlp_hidden = None
    fc1 = state.get("blocks.0.mlp.fc1.weight")
    if fc1 is not None and int(fc1.shape[0]) != 4 * hidden:
        mlp_hidden = int(fc1.shape[0])
    if heads is None:
        heads = _DEFAULT_HEADS.get(hidden)
        if heads is None:
            raise ValueError(
                f"cannot infer num_attention_heads for hidden={hidden}; "
                "pass --heads"
            )
    if "dist_token" in state and "head_dist.weight" not in state:
        raise ValueError(
            "distilled checkpoint has dist_token but no head_dist.weight"
        )
    if "reg_token" in state and "dist_token" in state:
        # load_params rejects such files; refuse to WRITE one
        raise ValueError(
            "reg_token + dist_token is not a timm configuration "
            "(registers pair with plain or avg-pool ViTs)"
        )
    has_map = "attn_pool.probe" in state
    if n_prefix == 0 and "fc_norm.weight" not in state and not has_map:
        raise ValueError(
            "checkpoint has no cls_token and no fc_norm — nothing to pool"
        )
    return VitHParams(
        hidden_size=hidden,
        num_hidden_layers=num_layers,
        num_attention_heads=heads,
        num_classes=num_classes,
        patch_size=patch,
        img_size=side * patch,
        in_chans=in_chans,
        mlp_hidden=mlp_hidden,
        num_prefix_tokens=n_prefix,
        norm_pre="norm_pre.weight" in state,
        global_pool=(
            "map"
            if has_map
            else ("avg" if "fc_norm.weight" in state else "token")
        ),
        no_embed_class=no_embed_class,
        num_reg_tokens=n_reg,
        pixel_norm=(
            "clip"
            if "meta.clip" in state
            else ("unit" if has_map else "imagenet")
        ),
        hidden_act="quick_gelu" if "meta.clip" in state else "gelu_tanh",
        # CLIP's layer_norm_eps is 1e-5 (transformers CLIPVisionConfig);
        # everything else keeps the reference's 1e-6 default
        eps=1e-5 if "meta.clip" in state else 1e-6,
    )


def remap_hf_siglip(state: Dict[str, np.ndarray]):
    """HF SiglipVisionModel/SiglipModel state dict -> this schema, or
    None when the dict is not SigLIP-shaped.

    Maps the vision tower: conv patch embedding, per-token position
    embedding (no CLS), pre-LN encoder layers with separate q/k/v
    projections (packed into the fused qkv layout), post_layernorm into
    the final-norm slot, and the attention-pooling head
    (SiglipMultiheadAttentionPoolingHead: probe, packed in_proj,
    out_proj, LN, MLP) into attn_pool.* — global_pool='map'. Text-tower
    tensors of a full SiglipModel are ignored. The MLP activation is
    gelu_pytorch_tanh (the SigLIP default and this engine's gelu);
    verified against transformers in tests/test_siglip.py."""
    pfx = "vision_model."
    if pfx + "embeddings.patch_embedding.weight" not in state:
        return None
    if pfx + "embeddings.class_embedding" in state:
        return None  # CLIP vision tower (remap_hf_clip), not SigLIP
    g = lambda k: np.asarray(state[pfx + k], dtype=np.float32)  # noqa: E731
    out: Dict[str, np.ndarray] = {
        "patch_embed.proj.weight": g("embeddings.patch_embedding.weight"),
        "patch_embed.proj.bias": g("embeddings.patch_embedding.bias"),
        "pos_embed": g("embeddings.position_embedding.weight")[None],
        "norm.weight": g("post_layernorm.weight"),
        "norm.bias": g("post_layernorm.bias"),
    }
    i = 0
    while pfx + f"encoder.layers.{i}.layer_norm1.weight" in state:
        p, q = f"encoder.layers.{i}.", f"blocks.{i}."
        out[q + "norm1.weight"] = g(p + "layer_norm1.weight")
        out[q + "norm1.bias"] = g(p + "layer_norm1.bias")
        out[q + "attn.qkv.weight"] = np.concatenate(
            [g(p + f"self_attn.{n}_proj.weight") for n in ("q", "k", "v")], 0
        )
        out[q + "attn.qkv.bias"] = np.concatenate(
            [g(p + f"self_attn.{n}_proj.bias") for n in ("q", "k", "v")], 0
        )
        out[q + "attn.proj.weight"] = g(p + "self_attn.out_proj.weight")
        out[q + "attn.proj.bias"] = g(p + "self_attn.out_proj.bias")
        out[q + "norm2.weight"] = g(p + "layer_norm2.weight")
        out[q + "norm2.bias"] = g(p + "layer_norm2.bias")
        out[q + "mlp.fc1.weight"] = g(p + "mlp.fc1.weight")
        out[q + "mlp.fc1.bias"] = g(p + "mlp.fc1.bias")
        out[q + "mlp.fc2.weight"] = g(p + "mlp.fc2.weight")
        out[q + "mlp.fc2.bias"] = g(p + "mlp.fc2.bias")
        i += 1
    if i == 0:
        raise ValueError("SigLIP checkpoint has no encoder layers")
    if pfx + "head.probe" in state:
        out["attn_pool.probe"] = g("head.probe")
        out["attn_pool.qkv.weight"] = g("head.attention.in_proj_weight")
        out["attn_pool.qkv.bias"] = g("head.attention.in_proj_bias")
        out["attn_pool.proj.weight"] = g("head.attention.out_proj.weight")
        out["attn_pool.proj.bias"] = g("head.attention.out_proj.bias")
        out["attn_pool.norm.weight"] = g("head.layernorm.weight")
        out["attn_pool.norm.bias"] = g("head.layernorm.bias")
        out["attn_pool.mlp.fc1.weight"] = g("head.mlp.fc1.weight")
        out["attn_pool.mlp.fc1.bias"] = g("head.mlp.fc1.bias")
        out["attn_pool.mlp.fc2.weight"] = g("head.mlp.fc2.weight")
        out["attn_pool.mlp.fc2.bias"] = g("head.mlp.fc2.bias")
    return out


def remap_hf_clip(state: Dict[str, np.ndarray]):
    """HF CLIPVisionModel/CLIPModel state dict -> this schema, or None.

    CLIP's vision tower maps almost entirely onto existing machinery:
    class_embedding -> cls_token, pre_layrnorm (sic, HF's spelling) ->
    norm_pre, separate q/k/v packed into the fused qkv layout,
    post_layernorm -> the final norm (CLIP pools CLS then norms — the
    same order as the classic head). Two things no tensor's presence
    can declare — QuickGELU block MLPs and CLIP's pixel mean/std — ride
    a scalar `meta.clip` marker tensor. CLIP's patch conv has no bias;
    a zero bias is synthesized. Text-tower tensors and the projection
    heads of a full CLIPModel are ignored. Verified against transformers
    in tests/test_clip.py."""
    pfx = "vision_model."
    if pfx + "embeddings.class_embedding" not in state:
        return None
    g = lambda k: np.asarray(state[pfx + k], dtype=np.float32)  # noqa: E731
    h = int(g("embeddings.class_embedding").shape[-1])
    out: Dict[str, np.ndarray] = {
        "cls_token": g("embeddings.class_embedding").reshape(1, 1, h),
        "patch_embed.proj.weight": g("embeddings.patch_embedding.weight"),
        # CLIP's patch conv is bias-free (Conv2d(..., bias=False))
        "patch_embed.proj.bias": np.zeros((h,), np.float32),
        "pos_embed": g("embeddings.position_embedding.weight")[None],
        "norm_pre.weight": g("pre_layrnorm.weight"),
        "norm_pre.bias": g("pre_layrnorm.bias"),
        "norm.weight": g("post_layernorm.weight"),
        "norm.bias": g("post_layernorm.bias"),
        "meta.clip": np.ones((1,), np.float32),
    }
    i = 0
    while pfx + f"encoder.layers.{i}.layer_norm1.weight" in state:
        p, q = f"encoder.layers.{i}.", f"blocks.{i}."
        out[q + "norm1.weight"] = g(p + "layer_norm1.weight")
        out[q + "norm1.bias"] = g(p + "layer_norm1.bias")
        out[q + "attn.qkv.weight"] = np.concatenate(
            [g(p + f"self_attn.{n}_proj.weight") for n in ("q", "k", "v")], 0
        )
        out[q + "attn.qkv.bias"] = np.concatenate(
            [g(p + f"self_attn.{n}_proj.bias") for n in ("q", "k", "v")], 0
        )
        out[q + "attn.proj.weight"] = g(p + "self_attn.out_proj.weight")
        out[q + "attn.proj.bias"] = g(p + "self_attn.out_proj.bias")
        out[q + "norm2.weight"] = g(p + "layer_norm2.weight")
        out[q + "norm2.bias"] = g(p + "layer_norm2.bias")
        out[q + "mlp.fc1.weight"] = g(p + "mlp.fc1.weight")
        out[q + "mlp.fc1.bias"] = g(p + "mlp.fc1.bias")
        out[q + "mlp.fc2.weight"] = g(p + "mlp.fc2.weight")
        out[q + "mlp.fc2.bias"] = g(p + "mlp.fc2.bias")
        i += 1
    if i == 0:
        raise ValueError("CLIP checkpoint has no encoder layers")
    return out


def normalize_state_dict(raw: Dict[str, "np.ndarray"]) -> Dict[str, np.ndarray]:
    """Unwrap nested checkpoints and strip ViTSTR's DataParallel prefixes
    (`module.vitstr.`, extensions/.../convert-pth-to-ggml.py:225-228)."""
    for key in ("state_dict", "model", "net"):
        if key in raw and isinstance(raw[key], dict):
            raw = raw[key]
            break
    out = {}
    for name, t in raw.items():
        for prefix in ("module.vitstr.", "module.", "vitstr."):
            if name.startswith(prefix):
                name = name[len(prefix) :]
                break
        out[name] = np.asarray(
            t.detach().cpu().numpy() if hasattr(t, "detach") else t,
            dtype=np.float32,
        )
    return out


def collapse_to_grayscale(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Sum the patch conv's RGB channels into one — how the reference builds
    in_chans=1 ViTSTR weights from 3-channel DeiT checkpoints
    (extensions/.../convert-pth-to-ggml.py:100-122)."""
    pe = state.get("patch_embed.proj.weight")
    if pe is not None and pe.ndim == 4 and pe.shape[1] == 3:
        state = dict(state)
        state["patch_embed.proj.weight"] = pe.sum(axis=1, keepdims=True)
    return state


def convert(
    checkpoint: str,
    *,
    output_dir: str = ".",
    ftype: int = 1,
    heads: int | None = None,
    vitstr: bool = False,
    real_gguf: bool = False,
    drop_norm_pre: bool = False,
    pos_layout: str | None = None,
    verbose: bool = True,
) -> str:
    import torch

    raw = torch.load(checkpoint, map_location="cpu", weights_only=False)
    state = normalize_state_dict(raw)
    sig = remap_hf_siglip(state)
    if sig is not None:
        if verbose:
            print(
                "detected HF SigLIP vision tower: remapping "
                f"{len(sig)} tensors (text-tower tensors ignored)"
            )
        state = sig
    else:
        clip = remap_hf_clip(state)
        if clip is not None:
            if verbose:
                print(
                    "detected HF CLIP vision tower: remapping "
                    f"{len(clip)} tensors (QuickGELU + CLIP pixel norm "
                    "recorded via meta.clip; text tower ignored)"
                )
            state = clip
    if vitstr:
        state = collapse_to_grayscale(state)
    if drop_norm_pre:
        # reference-parity mode: reproduce the reference converter's
        # norm_pre skip (convert-pth-to-ggml.py:117-120) byte-for-byte
        state = {
            k: v for k, v in state.items() if not k.startswith("norm_pre")
        }
    hp = infer_hparams(state, heads=heads, pos_layout=pos_layout)

    if vitstr or hp.in_chans == 1:
        from vit_cpp_tpu_torch.models.vitstr import vitstr_id2label

        id2label = vitstr_id2label()
    else:
        id2label = {i: f"LABEL_{i}" for i in range(hp.num_classes)}

    fname = {0: "f32", 1: "f16"}.get(ftype)
    if fname is None:
        raise ValueError(f"ftype must be 0 (f32) or 1 (f16), got {ftype}")
    out_path = os.path.join(output_dir, f"ggml-model-{fname}.gguf")

    if verbose:
        print(f"hparams: {hp}")
        print(f"writing {out_path} (ftype={ftype})")
    if real_gguf:
        # real GGUF v3 container (gguf/gguf_real.py) instead of the legacy
        # layout the reference writes under the same extension
        from vit_cpp_tpu_torch.gguf.gguf_real import write_gguf

        write_gguf(
            out_path, hp, id2label, serialize_state_dict(state, ftype), ftype
        )
    else:
        write_model(
            out_path, hp, id2label, serialize_state_dict(state, ftype), ftype
        )
    if verbose:
        print(f"Done. Output file: {out_path}")
    return out_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert a timm ViT / ViTSTR checkpoint to a model file."
    )
    ap.add_argument(
        "output_dir", nargs="?", default=".",
        help="directory for ggml-model-{f32,f16}.gguf (default .)",
    )
    ap.add_argument(
        "--checkpoint", help="torch .pth state dict for offline conversion"
    )
    ap.add_argument("--ftype", type=int, default=1, help="0=f32, 1=f16")
    ap.add_argument(
        "--heads", type=int, help="override num_attention_heads inference"
    )
    ap.add_argument(
        "--vitstr",
        action="store_true",
        help="ViTSTR scene-text model: grayscale conv + 96-token vocab",
    )
    ap.add_argument(
        "--gguf", "--real-gguf", dest="gguf",
        action="store_true",
        help="write a real GGUF v3 container instead of the legacy layout",
    )
    ap.add_argument(
        "--drop-norm-pre",
        action="store_true",
        help="skip norm_pre tensors like the reference converter does "
        "(byte-parity mode; default is to write and serve them)",
    )
    ap.add_argument(
        "--pos-layout", choices=["embedded", "grid"], default=None,
        help="disambiguate the pos_embed layout when register prefixes "
        "make both readings square: 'embedded' = rows cover prefix+grid, "
        "'grid' = rows cover the patch grid only (timm no_embed_class)",
    )
    args = ap.parse_args(argv)
    if args.checkpoint is None:
        # the JAX tool's timm-name source downloads the weights
        ap.error(
            "--checkpoint is required; converting a timm model by name "
            "downloads it, which this package does not do: save its state "
            "dict (torch.save(model.state_dict(), 'vit.pth')) and pass "
            "--checkpoint vit.pth"
        )
    try:
        convert(
            args.checkpoint,
            output_dir=args.output_dir,
            ftype=args.ftype,
            heads=args.heads,
            vitstr=args.vitstr,
            real_gguf=args.gguf,
            drop_norm_pre=args.drop_norm_pre,
            pos_layout=args.pos_layout,
        )
    except ValueError as e:  # validation errors get a message, not a trace
        print(f"vit-convert: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
