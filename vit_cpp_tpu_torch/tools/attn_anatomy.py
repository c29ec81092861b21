"""Split the attention forward's time by stage, on the card.

Counterpart of tools/attn_anatomy.py, whose Pallas kernels replicate the
TPU's serving attention with stages switched off one at a time. Here each
variant is the port's own forward kernel, K1 (csrc/attention_qkv.cu):
csrc/attn_anatomy.cu instantiates K1's bf16 body with one stage set per
variant, the body K1 itself runs at that d. At d = 64 (every ViT-Ti/S/B/L
head) that is the wgmma body (csrc/attention_wgmma.cuh: one warpgroup per
64 query rows, Q, K and V by TMA, S and P V on wgmma, software-pipelined);
at every other d the mma.sync body (csrc/attention_body.cuh: mma.sync
products, a cp.async ring of K/V tiles). Either way P is taken from the S
accumulators, `full` is K1's fast bf16 path bit for bit and each other
variant differs from it in the named stages only:

    full      score dot + exp2(min(s, 120)) + P V + /sum   (K1 fast)
    mxusum    full, the row sum taken by the tensor cores (P times a
              tile of ones: at d = 64 its own n8 product, else beside V)
    bf16exp   full, exp2 on the clamped scores in bf16, as JAX lowers it
              (exp(ln 2 x)), f32 row sum
    noclamp   exp2 kept, clamp and /sum skipped
    noexp     clamp only, no exp2, no /sum
    nosoftmax P := S: both dots, no softmax
    nomask    nosoftmax with the score dot over the head group's lanes
              (no per-head masks)
    onedot    score dot only (every key tile), a slice of it stored

Two forms, as the JAX tool's: `pair_variant` (head pairs, the flagship
ViT-B/16 shape; its TPU kernel is run_pair_variant) and `lane_variant`
(128-lane panels of 128/d heads; run_variant). They differ only where a
variant mixes the heads of a group (nomask, onedot); at d = 64 both group
two heads. Run on the card:

    python -m vit_cpp_tpu_torch.tools.attn_anatomy --kernel pair --t 197 --h 768 --b 128
    python -m vit_cpp_tpu_torch.tools.attn_anatomy --t 785 --h 768 --b 8 --w 3

Each line gives a variant's ms per call over a chain of 400 launches
(CUDA events) and its dot rate: the FLOPs of the variant's products
(score dot and P V over each head's d lanes; onedot the score dot alone)
per second. full minus a variant is what the variant's stages cost K1.

On a CUDA tensor the functions launch the kernel (bf16, d % 8 == 0,
d <= 128, a 16-byte aligned qkv) or raise, at every d: there is no
fallback. On a CPU tensor they run the plain PyTorch version below (any
float type), which the tests hold against the JAX kernels.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from vit_cpp_tpu_torch._build import Kernel, check, library
from vit_cpp_tpu_torch.tools import require_card, time_ms

VARIANTS = ("full", "mxusum", "bf16exp", "noclamp", "noexp", "nosoftmax", "nomask", "onedot")

PAIR_KERNEL = Kernel(
    "attn_anatomy_pair",
    source="vit_cpp_tpu_torch/csrc/attn_anatomy.cu",
    replaces="tools/attn_anatomy.py:190",
)
LANE_KERNEL = Kernel(
    "attn_anatomy_lane",
    source="vit_cpp_tpu_torch/csrc/attn_anatomy.cu",
    replaces="tools/attn_anatomy.py:213",
)

_LOG2E = 1.4426950408889634
ITERS = 400


def _geometry(qkv: torch.Tensor, variant: str, nh: int, group: int):
    """(B, T, h, d) of a valid call; raises on what no form takes."""
    if qkv.ndim != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, T, 3h), got {tuple(qkv.shape)}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    b, t, three_h = qkv.shape
    h = three_h // 3
    if nh < 1 or h % nh or nh % group:
        raise ValueError(f"hidden {h}: {nh} heads in groups of {group} do not divide it")
    d = h // nh
    if variant == "onedot" and t < group * d:
        raise ValueError(f"onedot stores {group * d} key columns: needs T >= {group * d}, got {t}")
    return b, t, h, d


def _pair_form(nh: int):
    """(nh, group, onedot_sum) of the head-pair form."""
    if nh % 2:
        raise ValueError(f"the pair form takes an even head count, got {nh}")
    return nh, 2, False


def _lane_form(qkv: torch.Tensor, variant: str, d: int):
    """(nh, group, onedot_sum) of the lane-panel form."""
    h = qkv.shape[-1] // 3
    if d < 1 or 128 % d or h % 128:
        raise ValueError(f"the lane form takes d dividing 128 and h % 128 == 0; got d={d}, h={h}")
    if variant == "mxusum" and d == 128:
        raise ValueError("mxusum needs two heads in a 128-lane panel (d <= 64): "
                         "its ones column lies in a neighbouring head's lanes")
    return h // d, 128 // d, True


def exp2_bf16(x: torch.Tensor) -> torch.Tensor:
    """JAX's exp2 of x rounded to bf16, in x's type: lax.exp2 lowers to
    exp(ln 2 * x) in the operand's type, so ln 2, the product and the
    result are each rounded to bf16."""
    bf = torch.bfloat16
    ln2 = torch.tensor(math.log(2.0), dtype=bf).to(x.dtype)
    return torch.exp((x.to(bf).to(x.dtype) * ln2).to(bf).to(x.dtype)).to(bf).to(x.dtype)


def anatomy_plain(qkv: torch.Tensor, variant: str, nh: int, group: int,
                  onedot_sum: bool) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (any device): (B, T, 3h)
    -> (B, T, h) for heads in groups of `group`. onedot stores the scores
    over the group's lanes (onedot_sum, the lane form) or the group's
    first head's scores (the pair form)."""
    b, t, h, d = _geometry(qkv, variant, nh, group)
    dt = qkv.dtype
    acc = torch.promote_types(dt, torch.float32)

    def rnd(z):  # round to the input type, as the kernels cast
        return z.to(dt).to(acc)

    x = qkv.reshape(b, t, 3, nh, d).permute(2, 0, 3, 1, 4).to(acc)  # (3, B, nh, T, d)
    q, k, v = x[0], x[1], x[2]
    qs = rnd(q * (_LOG2E / math.sqrt(d)))
    ng = nh // group

    def lanes(z):  # (B, nh, T, d) -> (B, ng, T, group*d): each group's lanes
        return z.reshape(b, ng, group, t, d).permute(0, 1, 3, 2, 4).reshape(b, ng, t, group * d)

    if variant == "onedot":
        if onedot_sum:
            src = lanes(qs) @ lanes(k).transpose(-1, -2)
        else:
            src = qs[:, ::group] @ k[:, ::group].transpose(-1, -2)
        return src[..., : group * d].permute(0, 2, 1, 3).reshape(b, t, h).to(dt)
    if variant == "nomask":
        s = (lanes(qs) @ lanes(k).transpose(-1, -2)).repeat_interleave(group, dim=1)
    else:
        s = qs @ k.transpose(-1, -2)  # (B, nh, T, T)
    if variant in ("full", "mxusum"):
        p = torch.exp2(torch.clamp(s, max=120.0))
    elif variant == "bf16exp":
        p = exp2_bf16(torch.clamp(s, max=120.0))
    elif variant == "noclamp":
        p = torch.exp2(s)
    elif variant == "noexp":
        p = torch.clamp(s, max=120.0)
    else:  # nosoftmax, nomask
        p = s
    o = rnd(p) @ v
    if variant in ("full", "bf16exp"):
        o = o / p.sum(dim=-1, keepdim=True)
    elif variant == "mxusum":
        o = o / rnd(p).sum(dim=-1, keepdim=True)
    elif variant == "nomask":
        o = o * group
    return o.permute(0, 2, 1, 3).reshape(b, t, h).to(dt)


def pair_variant_plain(qkv: torch.Tensor, variant: str, nh: int) -> torch.Tensor:
    return anatomy_plain(qkv, variant, *_pair_form(nh))


def lane_variant_plain(qkv: torch.Tensor, variant: str, d: int) -> torch.Tensor:
    return anatomy_plain(qkv, variant, *_lane_form(qkv, variant, d))


def _launch(kernel: Kernel, qkv, variant, nh, group, onedot_sum) -> torch.Tensor:
    if qkv.device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {qkv.device}")
    b, t, h, d = _geometry(qkv, variant, nh, group)
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"{kernel.name} kernel takes bf16, got {qkv.dtype}")
    if d % 8 or d > 128 or group * d > 256:
        raise ValueError(f"{kernel.name} kernel takes d % 8 == 0, d <= 128 and "
                         f"group * d <= 256; got d={d}, group={group}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{kernel.name} kernel needs a contiguous, 16-byte aligned qkv")
    out = torch.empty((b, t, h), dtype=qkv.dtype, device=qkv.device)
    lib = library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.vit_attn_anatomy(
            qkv.data_ptr(), out.data_ptr(), b, t, nh, d, group,
            VARIANTS.index(variant), int(onedot_sum), h, 1,
            _LOG2E / math.sqrt(d), stream,
        )
    check(rc, f"{kernel.name} kernel launch")
    kernel.counted()
    return out


def pair_variant(qkv: torch.Tensor, variant: str, nh: int) -> torch.Tensor:
    """Head-pair form: (B, T, 3h) -> (B, T, h), nh heads in pairs."""
    if qkv.device.type == "cpu":
        return pair_variant_plain(qkv, variant, nh)
    return _launch(PAIR_KERNEL, qkv, variant, *_pair_form(nh))


def lane_variant(qkv: torch.Tensor, variant: str, d: int) -> torch.Tensor:
    """Lane-panel form: (B, T, 3h) -> (B, T, h), heads of width d in
    128-lane panels of 128/d heads."""
    if qkv.device.type == "cpu":
        return lane_variant_plain(qkv, variant, d)
    return _launch(LANE_KERNEL, qkv, variant, *_lane_form(qkv, variant, d))


def dot_flops(variant: str, b: int, t: int, h: int) -> float:
    """FLOPs of a variant's products over each head's d lanes: score dot
    and P V (4 B T^2 h), onedot the score dot alone."""
    return (2.0 if variant == "onedot" else 4.0) * b * t * t * h


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=785)
    ap.add_argument("--h", type=int, default=768)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--w", type=int, default=3,
                    help="lane panels per grid step of the TPU kernel; must divide "
                    "h / 128 (one block per head here either way)")
    ap.add_argument("--kernel", choices=["lane", "pair"], default="lane")
    args = ap.parse_args(argv)
    require_card("attn_anatomy")
    if args.kernel == "lane" and (args.h % 128 or (args.h // 128) % args.w):
        ap.error(f"--w {args.w} must divide the {args.h // 128} panels of h={args.h}")
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(
        rng.standard_normal((args.b, args.t, 3 * args.h), dtype=np.float32)
    ).to("cuda", torch.bfloat16)
    for v in VARIANTS:
        if args.kernel == "pair":
            ms = time_ms(lambda: pair_variant(qkv, v, args.h // args.d), ITERS)
        else:
            ms = time_ms(lambda: lane_variant(qkv, v, args.d), ITERS)
        rate = dot_flops(v, args.b, args.t, args.h) / (ms / 1e3) / 1e12
        print(f"{v:10s} {ms:7.3f} ms/call   dot rate {rate:6.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
