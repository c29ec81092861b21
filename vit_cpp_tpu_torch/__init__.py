"""vit_cpp_tpu_torch — the PyTorch / CUDA port of vit_cpp_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. Module
paths and function names mirror vit_cpp_tpu's, so each counterpart is
found under the same name:

- ``ops``     — layernorm/linear/attention (``core``), the W8A8 matmul
                (``int8_matmul``), the attention CUDA kernels (forward and
                backward) and their plain versions (``flash_attention``),
                the dequantizing matmul kernel and its plain version
                (``qmatmul``), preprocessing, training augmentation
                (``augment``);
- ``quant``   — the ggml block codec (``blocks``), block-quantized
                weights (``qlinear``), channelwise int8 weights (``int8``);
- ``models``  — parameter loading (``params``), LayerNorm folding
                (``fold``), the ViT forward (``vit``), gguf export
                (``export``);
- ``parallel`` — the single-device train step and AdamW (``train``),
                training checkpoints (``checkpoint``);
- ``engine``, ``server``, ``cli.server`` — the serving path; ``aot``,
  ``cli.export_aot`` — the .vitx serving artifact (``torch.export``
  programs holding the kernels as operators);
  ``finetune``, ``cli.finetune`` — the fine-tuning path; ``decode``,
  ``io.image``, ``native`` — image decode; ``cli.quantize`` — the
  quantize tool;
- ``hparams``, ``gguf``, ``testing.synthetic`` — hyperparameters, the
  model file reader and writer, synthetic checkpoints;
- ``tools``   — card-side diagnostics: attention stage anatomies and the
                int8 product-rate probe;
- ``csrc``    — CUDA C++ kernels for sm_90a, built by ``_build``.

The package imports torch and never jax, and nothing of vit_cpp_tpu:
where it needs one of that package's JAX-free modules it keeps its own
copy under the same path (tests/test_torch_isolation.py holds both rules
and the copies' results).
"""

__version__ = "0.1.0"
