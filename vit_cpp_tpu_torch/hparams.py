"""Model hyperparameters.

The port's own copy of vit_cpp_tpu/hparams.py, with the same fields and
methods (the port imports nothing of the JAX package). Mirrors the
reference's ``vit_hparams`` struct (vit.h:20-37) and its
precedence rules (§5 of SURVEY.md): compiled defaults < model-file hparams
< CLI overrides. The defaults below are the reference's ViT-B/8 defaults
(vit.h:22-30).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class VitHParams:
    """Hyperparameters of a ViT checkpoint.

    Field order of the first six ints matches the on-disk hparam block of the
    model file format (SURVEY.md §2.3; reference convert-pth-to-ggml.py:96-109,
    vit.cpp:335-340).
    """

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_classes: int = 1000
    patch_size: int = 8
    img_size: int = 224
    ftype: int = 1
    eps: float = 1e-6
    interpolation: str = "bicubic"
    # ViTSTR extension (reference extensions/vitstr.cpp): sequence-decoding
    # head over the first `seq_len` tokens of a single-channel model.
    in_chans: int = 3
    seq_len: Optional[int] = None  # None => CLS classification head
    # MLP width override for non-4x families (ViT-g/14 uses 6144 on
    # hidden 1408, ratio 48/11 — Zhai et al., "Scaling Vision
    # Transformers"). Not part of the legacy on-disk hparam block; the
    # loader infers it from the fc1 tensor shape (models/params.py).
    mlp_hidden: Optional[int] = None
    # Family extensions the reference cannot represent, inferred from
    # tensor presence like in_chans/mlp_hidden (not in the on-disk hparam
    # block):
    # - num_prefix_tokens=2: DeiT distilled models carry a `dist_token`
    #   next to CLS and a second classifier `head_dist` whose logits are
    #   averaged with the CLS head's at inference (timm
    #   VisionTransformerDistilled.forward_head semantics).
    # - norm_pre=True: CLIP-style pre-norm ViTs apply a LayerNorm between
    #   the embeddings and the first block. The reference converter SKIPS
    #   these tensors (convert-pth-to-ggml.py:117-120) and silently
    #   mis-serves such models; here they are first-class.
    # - global_pool="avg": MAE/DeiT3-style ViTs mean-pool the patch tokens
    #   (excluding any prefix) and normalize with `fc_norm` instead of
    #   pooling CLS through `norm` (timm VisionTransformer global_pool
    #   semantics; fc_norm loads into the same 'norm' pytree slot).
    #   num_prefix_tokens=0 marks CLS-less models (avg-pool only).
    # - no_embed_class=True: pos_embed covers the patch grid only
    #   (n_patches rows); prefix tokens are concatenated after the
    #   positional add (timm no_embed_class, e.g. DeiT3).
    # - num_reg_tokens=R: DINOv2-style register tokens ("Vision
    #   Transformers Need Registers", Darcet et al.) — R learned tokens
    #   concatenated after CLS and excluded from every pooling readout
    #   (timm reg_token semantics). Inferred from the reg_token tensor.
    # - num_classes=0: headless encoder (no head.weight — MAE/DINO
    #   pretrained checkpoints): serves embeddings only; fine-tuning
    #   attaches a fresh head.
    # - global_pool="map": SigLIP-style attention pooling — the final
    #   norm applies to ALL tokens, then a learned probe cross-attends
    #   over them (attn_pool.* tensors: probe, packed qkv, proj, norm,
    #   mlp — HF SiglipMultiheadAttentionPoolingHead semantics, verified
    #   against transformers). CLS-less; usually headless (the pooled
    #   vector IS the embedding); fine-tuning attaches a head on it.
    # - pixel_norm="unit": preprocess normalizes to [-1, 1] instead of
    #   ImageNet mean/std (SigLIP's processor; set for map-pooled models
    #   at detect/infer time — ops/preprocess.norm_constants);
    #   "clip" = OpenAI CLIP's mean/std.
    # - hidden_act="quick_gelu": CLIP ViTs use x*sigmoid(1.702x) in the
    #   block MLPs instead of tanh-GELU. NOT tensor-inferable: the
    #   converter writes a scalar marker tensor `meta.clip` (the one
    #   extension hparam a tensor's mere presence cannot declare), which
    #   sets hidden_act + pixel_norm at detect/load.
    # - num_experts=E (+ moe_layers/moe_top_k/moe_capacity): V-MoE sparse
    #   expert MLPs (Riquelme et al., NeurIPS 2021) — the listed blocks
    #   replace their dense MLP with E experts behind a learned top-k
    #   router (ops/moe.py). Inferred from blocks.{i}.moe.* tensor
    #   presence; top_k/capacity ride the `meta.moe` marker tensor.
    #   Created by sparse upcycling (vit-finetune --moe).
    num_prefix_tokens: int = 1
    norm_pre: bool = False
    global_pool: str = "token"
    no_embed_class: bool = False
    num_reg_tokens: int = 0
    pixel_norm: str = "imagenet"
    hidden_act: str = "gelu_tanh"
    num_experts: int = 0
    moe_layers: tuple = ()
    moe_top_k: int = 1
    moe_capacity: float = 1.25

    @property
    def n_patches_side(self) -> int:
        return self.img_size // self.patch_size

    @property
    def n_patches(self) -> int:
        s = self.n_patches_side
        return s * s

    @property
    def n_prefix(self) -> int:
        """Total non-patch leading tokens: CLS (+ dist) + registers.
        Pooling readouts exclude all of them; num_prefix_tokens alone
        counts only the CLS/dist tokens that carry head semantics."""
        return self.num_prefix_tokens + self.num_reg_tokens

    @property
    def n_tokens(self) -> int:
        """Sequence length including the prefix token(s): CLS
        (vit.cpp:791-797), plus the distillation or register tokens when
        present; CLS-less avg-pool models may have no prefix at all."""
        return self.n_patches + self.n_prefix

    @property
    def n_pos_tokens(self) -> int:
        """Rows in pos_embed: n_tokens, or just the patch grid for
        no_embed_class models (timm adds pos before concatenating the
        prefix there)."""
        return self.n_patches if self.no_embed_class else self.n_tokens

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mlp_dim(self) -> int:
        # The reference family always uses a 4x MLP (vit.cpp:556-560);
        # mlp_hidden overrides for non-4x geometries (ViT-g).
        if self.mlp_hidden is not None:
            return self.mlp_hidden
        return 4 * self.hidden_size

    def expected_tensor_count(self) -> int:
        """Number of tensors in a checkpoint: 8 global + 12 per layer
        (vit.cpp:697-701; README.md:77 cites 152 for 12-layer models);
        +2 for pre-norm models, +3 for distilled (dist_token + head_dist)."""
        n = 8 + 12 * self.num_hidden_layers
        if self.norm_pre:
            n += 2
        if self.num_prefix_tokens == 2:
            n += 3
        if self.num_prefix_tokens == 0:
            n -= 1  # no cls_token (avg-pool models; fc_norm replaces norm)
        if self.num_reg_tokens:
            n += 1  # one (R, h) reg_token tensor
        if self.num_classes == 0:
            n -= 2  # headless encoder: no head.weight/head.bias
        if self.global_pool == "map":
            n += 11  # attn_pool: probe, qkv/proj (w+b), norm, mlp fc1/fc2
        if self.hidden_act == "quick_gelu":
            n += 1  # the scalar meta.clip marker tensor
        if self.num_experts:
            # each MoE layer swaps its 4 dense-MLP tensors for a router
            # weight + 4 per-expert tensors, plus one meta.moe marker
            n += len(self.moe_layers) * (1 + 4 * self.num_experts - 4) + 1
        return n
