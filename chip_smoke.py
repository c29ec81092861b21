#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: needs a CUDA card (exits nonzero without one); prints its name,
   compute capability and `nvidia-smi` name/power limit.
2. Build: compiles the port's CUDA kernels from vit_cpp_tpu_torch/csrc
   with nvcc (sm_90a, one nvcc per source, all at once) and prints the
   build time and ptxas's report.
3. Kernels, each against its plain PyTorch version on the card, with each
   case's largest error beside its stated tolerance:
   - attention_qkv (fused-QKV attention) at the repo's geometries (ViT-B/16,
     B/8, H/14, g/14; fast and safe softmax, key mask, ToMe sizes, bf16
     and f32) and at the edges of both bodies' tiling (T=1, 65, 128, 129;
     kv at a 64-key tile's edge and one past it; d=72 and 128; bf16 and
     f32);
   - dequant_matmul (block-dequantizing matmul) at the ViT-B/16 serving
     shapes in bf16 over all five block formats, one f32 case, one with
     leading dims, one with N=1001 (no vector loads on a row) and
     ViTSTR-Base's head at B=64 (M=1600, N=96 in Q8_0), then in
     every format at the edges of the bf16 body's tiling (M=1, 129, 1577;
     K=3072 and 800; N=768, 1000, 1001, 3072) and of the f32 (3xTF32)
     body's (M=1, 8, 129, 1577, 12608; K=768, 800, 3072; N=96, 768, 1000,
     1001, 2304, 3072);
   - flash_attention (split-head attention) at (8, 12, 197, 64) in bf16
     and f32, at d=80, T=257, and at T=1, 65, 128 with d=64, 72, 128;
   - attention_qkv_grad (the attention backward) at the ViT-B/16 training
     shape B=32 in f32 (the training path's) and bf16, both with ToMe
     sizes too, ViT-Ti (3 heads), ViT-H/14 (d=80, T=257) and ViT-B/8
     (T=785), and at the edges of its tiling in f32 and bf16 (T=1, 63,
     64, 65, 129; d=72 and 128; sizes at T=65), each error relative to
     max|plain|; in f32 at d=64 and 80 (every training path's K2) it runs
     the wgmma body, whose own edges (d=64: T=1 to 785, sizes at 65, 197
     and 785, 1, 3 and 12 heads, a misaligned qkv) are held to the plain
     version and to the mma.sync body it replaced (the check-only
     attention_qkv_grad_mma) and are bit-equal from one call to the next.
   Then times kernel and plain version with CUDA events at the ViT-B/16
   serving shapes (B=8 and 64) and training shape (B=32, f32 for the
   forward, f32 and bf16 for the backward), and the attention kernels at
   T=785 too (the shape of the JAX package's lane paths); dequant_matmul
   in f32 at the four block linears of B=8 and B=64 beside its bound and
   torch.matmul on the weight dequantized once in f32.
   `python3 chip_smoke.py --k4-f32` runs only the f32 body's cases and
   times, after the build (from another tree's root it measures that
   tree's body).
   attention_qkv and flash_attention in bf16 at d=64 run the wgmma body;
   its own edges (T=1, 63, 64, 65, 128, 129, 196, 197, 255, 256, 257, 577,
   785 fast and safe, sizes, kv at 197 of 200, 256 of 257 and 64 of 70
   with pad rows of 1e4, a misaligned qkv, the split-head shapes) are held
   to the plain versions and, bit for bit, to the mma.sync body it
   replaced; that body (reached at
   d=64 only through attention_qkv_mma / flash_attention_mma, a check-only
   entry) is held to them too and timed in turns with it and
   scaled_dot_product_attention at B=8 / 64 T=197, B=8 T=577 / 785 and
   K3's (8, 12, 197, 64). `python3 chip_smoke.py --k1-bf16` runs only
   those cases and times, after the build. The backward's f32 wgmma body,
   the mma.sync body and SDPA's backward are timed in turns at B=32
   T=197, B=4 and 8 T=785 and the tp 2 / 4 per-rank shapes (6 and 3
   heads); `python3 chip_smoke.py --k2-f32` runs only its cases and those
   times, after the build.
   attention_qkv and flash_attention in f32 at d=64 and 80 run the f32
   wgmma body (3xTF32), and attention_qkv_grad in f32 at d=80 the
   backward's wgmma body; `python3 chip_smoke.py --attn-f32` runs, after
   the build, the forward body's edges (d=64 and 80; T=1, 8, 63, 64, 65,
   127, 128, 129, 196, 197, 256, 257, 577, 785 fast and safe; sizes at 65,
   197, 257; kv at 197 of 200, 256 of 257, 64 of 70 with pad rows of 1e4;
   1, 3, 12, 16 heads; a misaligned qkv; K3's (8, 12, 197, 64) and (1, 16,
   257, 80)) and the backward's d=80 edges (T=1 to 785, sizes at 65 and
   257, 1, 3, 16 heads, a misaligned qkv), each against the plain version
   and the mma.sync body it replaced (the check-only entries, f32 now
   too) and bit-equal from one call to the next, then times them in turns
   with those bodies, SDPA (its backward) and plain: the forward at
   ViT-B/16 B=32, --patch-size 8 B=8, ViT-H/14 B=8 (T=256 and 257) and
   B=128 (safe) and ViT-B/16 B=64 fast (f32 serving), the backward at
   ViT-H/14 B=8 (T=256 and 257) and B=128.
   attention_qkv_grad in bf16 at d=64 runs the bf16 wgmma body; its edges
   (T=1, 8, 63, 64, 65, 127, 128, 129, 196, 197, 200, 256, 257, 577, 785;
   sizes at 65, 197, 785; 1, 3, 6 and 12 heads; a misaligned qkv) are held
   to the plain version and to the mma.sync body it replaced, bit-equal
   from one call to the next, and it is timed in turns with that body,
   SDPA's backward and plain at B=64 T=197 and B=8 T=785 (B=32 T=197 in
   the backward's cases above). flash_attention in f32 (K3) is timed in
   turns with its mma.sync body, SDPA in f32 and plain at (8, 12, 197, 64)
   and (1, 16, 257, 80). `python3 chip_smoke.py --k2-bf16` runs, after the
   build, the bf16 body's edges and times (B=32 and 64 T=197, B=8 T=785),
   attn_grad_anatomy's variants on it with its stage split, and K3's f32
   times. attention_qkv in bf16 at d=80 and 88 (ViT-H/14 and ViT-g/14,
   B=8 T=257, fast: the mma.sync body) is timed in turns with SDPA and
   plain. `python3 chip_smoke.py --t1` runs, after the build, only
   attn_anatomy's part of 5 below (its d=64 edges, its variants at the
   flagship shapes, its stage split and each d=64 variant's occupancy).
4. Paths, each driven through the entry points a user calls, with every
   kernel's launch count set to 0 just before and read just after:
   a. the f16 W8A8 daemon: a synthetic ViT-B/16 @224 f16 checkpoint
      (random weights from a seed) served with the defaults (bf16, W8A8
      int8 linears, fused-QKV attention with the fast softmax, LayerNorm
      folded), batch 8; 12 attention launches per device batch;
   b. the block-quantized daemon: the same checkpoint quantized to Q8_0
      by vit_cpp_tpu_torch.cli.quantize and served with --mm pallas (bf16,
      fold off); 49 dequant_matmul and 12 attention launches per device
      batch;
   c. the forward of the Q8_0 file's VitEngine (bf16, fast fused
      attention, fold off) at B=8 and B=64 with --mm pallas and --mm xla:
      the median of 20 forwards each, in turns, on the host clock, device
      ms by cuda_ms, and one profiled --mm pallas forward at B=64 (the two
      kernels' share of device time); the same in f32 (median of 10, the
      two within 1e-5), K4's f32 body on every linear;
      then the flagship configuration on the Q8_0 file (int8, fold on),
      forward only, against the f32 reference;
   d. the front ends on the files of (a) and (b), each as a user runs
      it: `python -m vit_cpp_tpu_torch.cli.vit` on magpie.jpeg (f32) in a
      process whose TF32 flags are switched on first, its console surface
      and top-5 against the card engine's, the f32 engine's 1000
      probabilities against the card machine's CPU engine (1e-5) and a
      TF32 engine as the control; `python -m vit_cpp_tpu_torch.cli.serve`
      over the ten assets at -b 8, at its defaults (f16) and with --mm
      pallas (Q8_0) in bf16 and with --dtype f32, against the f32 engine,
      with serve_files counting
      the launches in this process (12 attention_qkv per batch, then 49
      dequant_matmul + 12) and its images/s at batch 64 over 320 files
      on one decode thread and on one per core; embed_files at the
      defaults against the unfolded f32 engine, folded against unfolded
      f32 features, one POST /v1/embed against embed_file; cli.inspect on
      both files (text and --json --tensors);
   e. the split-head attention entry point, ops.core.attention(impl=
      "pallas"), over the 12 layers' worth of ViT-B/16 q, k, v (no model
      path of the JAX package reaches it);
   f. slice parity: the ViT-B/16 training loss and every parameter's
      gradient at B=2 in f32 on the card (attention_qkv forward,
      attention_qkv_grad backward) against the card machine's CPU (the
      plain versions);
   g. fine-tuning through the CLI (vit_cpp_tpu_torch.cli.finetune) on the
      f16 checkpoint of (a): 2 classes x 32 generated 224 px images (dark
      vs bright), batch 32, 3 epochs, augmentation, label smoothing, EMA
      and a checkpoint directory; 12 attention_qkv and 12
      attention_qkv_grad launches per update, finite and falling losses,
      ms per update, images/s, peak device memory and the attention
      kernels' share of device time in one profiled update; the written
      gguf is then served by VitEngine on the card, and
      vit_cpp_tpu_torch.cli.benchmark.run_eval classifies a dark/bright
      tree (8 per class) with it on the card and on the CPU: equal CSVs
      up to near-ties;
   h. the serving workflow: the synthetic ViT-B/16's f32 tensors saved
      under their timm names as a .pth and converted by `python -m
      vit_cpp_tpu_torch.cli.convert` (every record and the hparams equal
      the f16 file's); static W8A8 scales on the converted file at the
      serving defaults, calibrated on the ten assets (the guardrail must
      accept), probabilities within 5e-3 of the f32 engine, the static and
      dynamic W8A8 forwards at B=64 timed in turns (median of 20) and
      profiled (device ms, idle share, kernel launches per forward and per
      linear); then create_multi_server with the converted file and the
      Q8_0 file, both static: the ten assets to each model, then to both
      at once, top-5 within 5e-3 of each model's f32 engine, 12
      attention_qkv launches per device batch, one /v1/<name>/embed each,
      /stats, /metrics and a 404; then `python -m
      vit_cpp_tpu_torch.cli.server -m a=... -m b=... --act static
      --calib-dir assets` as a subprocess, one answer per model;
   i. the model families (phase `model_families`), synthetic weights from
      seed 0 at published widths: ViTSTR-Base (1 channel, 96 tokens, 25
      positions) written f16 and quantized to Q8_0 by cli.quantize, through
      `python -m vit_cpp_tpu_torch.cli.vitstr` on assets/vitstr/demo_1.png
      (the console surface), `cli.serve` over the six assets/vitstr images
      at the defaults (W8A8 + attention_qkv) and with --mm pallas on the
      Q8_0 file (dequant_matmul + attention_qkv), recognize_files at both
      and with static scales calibrated on assets/vitstr, every position's
      token equal to the f32 engine's but near-ties, 12 attention_qkv and
      49 dequant_matmul launches per batch; a two-model daemon (cls = the
      ViT-B/16 f16 file, ocr = ViTSTR) with all images POSTed at once to
      /v1/cls/classify and /v1/ocr/recognize; the SigLIP-B/16 vision tower
      (attention pooling, [-1, 1] pixels, headless) through embed_files and
      one /v1/embed against the unfolded f32 engine; the ViT-B/16 file
      resampled to 384 px (T=577) and to patch 8 (T=785) through
      serve_files and `cli.serve --img-size 384 / --patch-size 8` against
      the f32 engine resampled the same way, each forward at B=64 timed
      (median of 20) and profiled; `cli.explain` on magpie.jpeg, whose
      top-5 equals classify_file's, with its heatmap PNG and no kernel
      launched. The five command lines run as subprocesses beside the
      in-process checks, and the timings wait for them to exit;
   j. ToMe and token padding (phase `tome_paths`) on the files of (a) and
      (b): attention_qkv (fast bf16 at the serving defaults, safe f32) on
      the qkv and merged-token sizes that the r=16 merge gives layers 0, 5
      and 11 (T = 197, 117, 21), attention_qkv_grad (f32) on the inputs
      the r=8 training backward gives layers 1 and 11 (T = 189, 109), and
      attention_qkv at T=200, kv=197 on the padded forward's first layer,
      each against its plain version; every layer's matching on the card
      against the CPU's on the same metric (equal, or a near-tie within
      MATCH_TIE), identical tokens merged losslessly; serve_files at
      --tome 16 at the defaults, --mm pallas and --act static against the
      f32 engine with the same tome (12 attention_qkv and 49
      dequant_matmul launches per batch), embed_files and the in-process
      daemon; `cli.serve --tome 16` at the three configurations and
      `cli.server --tome 16` (the ten assets, /v1/embed) as subprocesses;
      the padded B=64 forward at the defaults and --mm pallas against the
      unpadded one; slice parity through tome 8 and `cli.finetune --tome
      8` (the meta's tome, 12 + 12 launches per update); the B=64 forward
      at r = 0, 8, 16 and padded vs unpadded (median of 20 in turns, CUDA
      events, one profiled run each) and ms per update at tome 8 vs 0;
   k. V-MoE (phase `moe_paths`): a synthetic ViT-B/16 with E=8 experts in
      the odd blocks, top-2, capacity 1.25, written f16 and quantized to
      Q8_0 by cli.quantize (routers f32, experts Q8_0): the in-process
      daemon at the defaults (12 attention_qkv per batch), serve_files
      with --mm pallas on the Q8_0 file (37 dequant_matmul + 12
      attention_qkv per batch), `cli.serve --mm pallas` and `cli.server`
      (ten assets, /v1/embed) as subprocesses, each against the f32
      engine of its file, and the top-1 experts that the served engine
      and the f32 engine choose, per MoE layer; moe_mlp card vs CPU on
      the first MoE layer's input of a card forward in f32 and in bf16
      (the experts chosen equal but at near-ties); the dense f32 ViT-B/16
      upcycled (E=8, top-2, capacity 8.0) against its dense forward; the
      V-MoE and dense forwards at the defaults at B=8 and 64 (median of
      20 in turns) and one B=64 V-MoE forward profiled by family with
      the router diagnostics; `cli.finetune --moe 8 --moe-top-k 2` (2
      updates of B=32: 12 + 12 launches each, ms per update, peak
      memory), its output through `cli.serve`, and slice parity on an
      f32 V-MoE file (the router and experts among the gradients);
   l. the training extras (phase `training_extras`): fake_quant_params
      in all six QAT formats on the ViT-B/16 f32 weights, card against
      CPU bit for bit and against the serving chain (quant/blocks round
      trip, then channelwise int8) on layer 0's kernels and the head;
      fake_quant_act and fake_quant_act_static on a layer-0 qkv input,
      card against CPU bit for bit; the QAT w8a8 linears against the W8A8
      ones on the card, each fed the served forward's own input
      (QAT_LINEAR_TOL), the QAT blocks against the W8A8 ones, each fed the
      W8A8 forward's input to that block (flipped codes within
      QAT_FLIP_SHARE, the block's deviation within QAT_BLOCK_RMS of the
      dense block's), and the two whole forwards (the QAT one closer to
      W8A8 than the dense f32 forward, the same argmax outside QAT_TIE);
      the LoRA (rank 8, b a
      seeded draw) and soft-distillation losses and gradients at B=2
      card against CPU, and two bf16-moment AdamW steps on equal
      gradients (moments bit for bit, parameters within ADAMW_ULPS);
      then `cli.finetune` on the card with --lora 8, --distill (the ft.gguf
      of g), --qat q8_0 --qat-act static, --mu-dtype bf16, --patch-size 8
      at -b 8 (T=785), on the SigLIP-B/16 tower of (i) (a head attached)
      and on the ViTSTR-Base of (i) (a gt.txt over assets/vitstr), each
      on the dark/bright set of (g) (2 updates of B=32, 8 of B=8), and
      once with no extra as the same call's baseline: finite losses, 12
      attention_qkv + 12 attention_qkv_grad launches per update, ms per
      update and peak device memory; the outputs served: LoRA's (folded)
      and SigLIP's at the serving defaults, the QAT output with its
      sidecar (--act static --act-scales) and quantized to Q8_0 by
      cli.quantize with --mm pallas (49 dequant_matmul launches per
      batch), in process and through `cli.serve`, ViTSTR's through
      recognize_files.
   m. the AOT serving artifact (phase `aot_paths`): `cli.export_aot -b
      1,64` at the serving defaults on the f16 file and its --info; the
      .vitx served by AotEngine in a fresh process that cannot import
      models.vit, models.params, engine, JAX or the JAX package, the gguf
      moved away, against the gguf engine's probabilities at B=1 and B=64
      (1e-5) with 12 attention_qkv launches per batch; at ViT-B/16's width
      and 6 blocks (the depth cut that keeps the script's time since the
      mesh phase), a Q8_0 file exported with --mm pallas (25 dequant_matmul
      + 6 attention_qkv per batch) and its f16 file with --act static
      --calib-dir assets, each against its gguf engine; `cli.vit`,
      `cli.serve`, `cli.server --bucket` (over the baked 1 and 64;
      /v1/embed 404 on a classifier artifact) and `cli.benchmark` on the
      .vitx as subprocesses; the
      card artifact refused on the CPU and with no card visible, a CPU
      artifact refused on the card; the artifact's size, load ms and
      B=64 / B=1 forwards beside the gguf engine's (median of 20 in
      turns, one profiled run each);
   m'. the multi-device layer (phase `mesh_paths`), every launch a 1x1
      mesh under `python3 -m torch.distributed.run --standalone
      --nproc-per-node 1` (NCCL, world 1: one card holds no two NCCL
      ranks): `cli.serve --mesh 1x1` at the defaults and with --mm pallas
      on Q8_0 prints what (d)'s unsharded commands printed; `cli.server
      --mesh 1x1` answers the ten assets with an unsharded daemon's
      probabilities (1e-6) and leaves rank 0 with exit code 0 after
      SIGTERM; `cli.finetune --mesh 1x1 --fsdp` (2 updates of B=32) trains
      and its output serves; in this process meanwhile, the finetune API
      with and without the mesh (losses within 1e-5; 12 + 12 launches per
      update) and a 1x1-mesh engine's launches through serve_files (12
      attention_qkv, 49 dequant_matmul + 12 per batch); then, alone on the
      card, the 1x1-mesh B=64 forward against the unsharded one (bit-equal,
      median of 20 in turns) and every kernel at the per-rank shapes of
      tp = 2 and 4 beside tp = 1 (attention_qkv bf16 fast B=64 and f32
      safe B=32 at 6 and 3 heads, attention_qkv_grad f32 B=32,
      dequant_matmul Q8_0 bf16 B=64 at the qkv / fc1 column shards and
      the proj / fc2 row shards, and W8A8's int8_mm there against an
      exact f64 product), held to plain and timed (`mesh_shards` in the
      kernels line), and at the row shards the f32 partial product a
      bf16 rank sums over "model" against an f64 product, dense and by
      dequant_matmul's f32-output instantiation (`f32_out` in its line),
      and an f32 rank's (f32 x, K4's f32 body);
      sharded .vitx artifacts: a 1x1-mesh engine exported by one rank
      under the launcher (aot.save_engine, -b 8) at the serving defaults
      (the full ViT-B/16) and with --mm pallas on the AOT_BLOCKS-block
      Q8_0 file, then served under the launcher by `cli.serve` (stdout
      equal to the sharded engine's) and `cli.server` (the ten assets'
      probabilities within 1e-6 of the sharded engine's; rank 0 exits 0
      after SIGTERM), and in this process with the rebuilt mesh (12
      attention_qkv per batch; 25 dequant_matmul + 6 attention_qkv) and
      load ms beside the unsharded artifacts'. No speed-up across GPUs is
      measured;
   n. stage parity (phase `stage_parity`): models.vit.forward_debug on
      the card, f32 with TF32 off and bf16 W8A8 with the fast fused
      attention, against the card machine's CPU in f32, stage by stage
      (embed, each block, pooled, logits, probabilities), with the first
      stage over its tolerance and print_t's line of the probabilities;
   o. the operators' host cost (phase `op_dispatch`): host us per call
      of attention_qkv and dequant_matmul through torch.ops and through
      their CUDA implementations called directly, and the Q8_0 --mm
      pallas B=8 and ToMe r=16 B=64 forwards each way, in turns;
   p. rematerialisation (phase `remat_paths`, after g): the f32 ViT-B/16
      at B=32 through train_step under each `remat` mode (False, True,
      "dots", "dots+attn"; the training losses run "dots+attn"): one
      step's gradients against remat=False's (bit-equal, else within
      tests/test_torch_train.py's bound), 12 / 24 / 24 / 12 attention_qkv
      and 12 attention_qkv_grad launches per update, peak device memory,
      ms per update by cuda_ms and on the host clock; ViT-H/14 @224 in
      f32 (hidden 1280, 32 layers, d=80, T=257), attention_qkv (safe)
      and attention_qkv_grad at B=8 against their plain versions, each
      timed at B=8 and B=128 in turns with the mma.sync body it replaced,
      SDPA (its backward) and plain, its weights made on the card from
      seed 0 by params_from_state_dict, the peak of a B=32 update in each
      mode, one B=32 "dots+attn" update profiled (K1's and K2's device ms
      and shares), and two B=128 updates through cross_entropy_loss under
      "dots+attn"
      (finite losses, peak under H14_PEAK_GIB; the update does not fit
      without remat, and is not tried).
   The daemons get the ten images of assets/ concurrently; every answer
   must be 200 with a top-5 that agrees with an f32 engine (mm=xla,
   attn=xla) on the same file and card, and /stats must count them all.
5. Diagnostics, the card-side tools of vit_cpp_tpu_torch.tools:
   every variant of attn_anatomy (head-pair form at ViT-B/16 B=128,
   lane form at B=8 T=785 w=3), of attn_grad_anatomy (B=64) and the
   probe_int8_dot product (1024^3; int8 exact) against its plain version
   on the card, each timed, with a one-K-step call, B given (N, K) and C's
   write alone beside it, then at the W8A8 linears of a ViT-B/16 B=64
   batch (qkv, proj, fc1, fc2; int8 also with B given (N, K)), in turns
   with torch._int_mm, torch.matmul and torch.mm with an f32 output, with
   the int8 : bf16 ratio; the anatomies' `full` equal bit for bit to K1
   (fast, bf16; at d=64, 72, 32 and 128) and K2 (bf16; at d=64, 72 and
   128) on the same tensors, `full`, K1 / K2, their mma.sync bodies (at
   d=64 T1 and T2 run K1's and K2's bf16 wgmma bodies) and
   scaled_dot_product_attention (forward / backward) timed in turns, and
   one stage-split line per tool (full - variant, in ms and as a share of
   full, every variant timed in turns); attn_anatomy at d=64 also on its
   edges (T=1, 63, 64, 65, 197, 256, 257, 785; 2 and 12 heads; both forms,
   every variant against plain, `full` bit-equal to K1), and each d=64
   variant's registers, spills and blocks per SM; then
   each tool's entry point, as a user runs it, with the launch counts set
   to 0 just before and read just after.
Every kernel's line gives its bound (the larger of its bytes over 3.35
TB/s and its operations over the data sheet's peak for their type: 989
TFLOP/s bf16, 1,979 TOP/s int8, and f32 at a third of TF32's 494.7
TFLOP/s, the rate of 3xTF32 products) and the time of one PyTorch call
that computes the same function, where there is one (library_ms; the
port never calls it). Every kernel time is device ms per call: a chain
of calls queued behind a kernel that sleeps on the card, between two
events, so that the span holds device work and not the host's.

Every phase raises on failure, so the script exits nonzero and prints no
result. On success the last lines are a JSON line with each kernel's
numbers, the card's name and power limit, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import sys

sys.modules["jax"] = None  # the port runs without JAX: any import raises
sys.modules["vit_cpp_tpu"] = None  # and without the JAX package

import contextlib
import glob
import io
import json
import os
import re
import shutil
import signal
import subprocess
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# attention_qkv / flash_attention vs their plain versions, absolute
# (outputs are O(1)). f32: 3xTF32 products drop ~2^-22 of each product,
# the size of f32 rounding; an H100 measured <= 6e-6.
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# dequant_matmul vs its plain version (the same bf16-rounded weights, then
# torch.matmul), relative to max|plain|: the two sum in different orders
# in f32 (~1e-6 relative at K <= 3072), and a bf16 output can then round
# one step apart, which is at most 2^-7 = 7.8e-3 of max|plain|. f32
# output: summation order only.
QMM_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
# A bf16 row-parallel partial product in f32 vs an f64 product, relative to
# max|f64|: the bf16 products are exact, so only the f32 sum differs
# (~1e-6 relative at K <= 1536 by the estimate of QMM_TOL's note).
ROW_PARTIAL_TOL = 1e-5
# Served top-5 probabilities vs the f32 dense engine (dtype=f32, mm=xla,
# attn=xla) on the same pixels: bf16 activations + W8A8 int8 linears move
# the probabilities of this synthetic ViT-B/16 (1000 classes, each ~0.01)
# by at most 0.00142 absolute, measured with the port's plain PyTorch path
# on the CPU over the ten assets; the limit leaves 3.5x margin.
PROB_TOL = 5e-3
# Q8_0 file served with --mm pallas (bf16 activations, the dequantizing
# kernel, fused attention) vs the f32 engine (mm=xla, attn=xla) on the
# same file: only bf16 rounding of activations and weights differs. An
# H100 measured at most 3.97e-4 over the ten assets; the limit leaves
# 12x margin.
Q8_PROB_TOL = 5e-3
# The flagship configuration (int8 W8A8 requantized from Q8_0, LayerNorm
# folded, bf16) vs the same f32 engine, over all 1000 probabilities of the
# ten images: W8A8 adds a second int8 rounding of weights and per-token
# activation codes. An H100 measured at most 1.77e-3; the limit leaves
# 2.8x margin.
FLAGSHIP_TOL = 5e-3

# attention_qkv_grad vs its plain version, relative to max|plain|: f32
# differs in summation order and by 3xTF32's ~2^-22 per product (an H100
# measured <= 5e-6); bf16 can round pn and ds to a neighbouring bf16
# value (2^-8 relative) where the two sum in another order (an H100
# measured <= 2.4e-3).
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# The diagnostics' kernels vs their plain versions, relative to
# max|plain|: bf16 outputs of the same f32 arithmetic summed in another
# order round up to one bf16 step (2^-8) apart; the products of rounded
# p can add another. The int8 product must be exact.
ANATOMY_TOL = 2e-2
# The probe's bf16 product (exact products, f32 sums in another order).
PROBE_BF16_TOL = 1e-5
# The card's data-sheet rates (H100 SXM, dense), for the bounds. The
# attention kernels compute f32 products on the tensor cores as 3xTF32,
# three TF32 products each: their f32 rate is a third of TF32's.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 494.7e12 / 3, "int8": 1979e12}
# The vit CLI's f32 engine on the card vs the card machine's CPU engine on
# the same pixels, all 1000 probabilities of this synthetic ViT-B/16
# (each ~1e-3): summation order only, TF32 off.
CLI_PROB_TOL = 1e-5
# embed_files at the serving defaults (bf16, W8A8, fast fused attention,
# LayerNorm folded) vs the unfolded f32 engine, relative to max|f|. W8A8's
# int8 rounding of weights and per-token activations dominates: an H100
# measured 2.93e-2 for W8A8 alone in f32, 1.29e-2 for bf16 alone, and
# 4.13e-2 for the defaults over the ten assets (1 - cosine <= 9.5e-4); the
# limit leaves 1.9x margin.
EMBED_TOL = 8e-2
# Folded vs unfolded f32 engines' features, absolute (|f| up to ~4): the
# folded ln1/ln2 affines re-associate f32 products in every block. An H100
# measured 3.6e-6; the JAX package's folded engine drops the final norm's
# affine and is off by ~0.1.
FOLD_FEATURE_TOL = 1e-5
# vit-benchmark card vs CPU: rows whose CPU top-two probabilities lie this
# close may differ.
BENCH_TIE = 1e-5
# Slice parity, card vs CPU, f32 with TF32 off in cuBLAS: summation order
# and the attention kernels' 3xTF32 products (~2^-22 each).
PARITY_LOSS_RTOL = 1e-5
PARITY_GRAD_TOL = 1e-3  # max|g_card - g_cpu| / max|g_cpu| for every leaf

VIT_B16 = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    num_classes=1000, patch_size=16, img_size=224,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50) -> float:
    """Device ms per call of `fn`, the mean of `iters` calls between two
    events. The calls are queued behind a kernel that sleeps on the card
    until the host has enqueued all of them, so that the span holds their
    device work and not the host's work per call (hundreds of us through
    torch.autograd.grad, which would otherwise set the pace). The sleep
    grows until it outlasts the host; a call that waits on the card
    cannot be queued so, and is timed as it runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 10_000_000
    for _ in range(3):
        slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        slept_ms = slept.elapsed_time(start)
        if host_ms < slept_ms:
            break
        cycles = int(cycles * 2 * host_ms / slept_ms) + 1
    else:
        log(f"cuda_ms: the host took {host_ms:.1f} ms to enqueue {iters} calls, longer than "
            f"the card's sleep of {slept_ms:.1f} ms: timed as the calls ran")
    return start.elapsed_time(end) / iters


def time_pair(what: str, card: str, kern, plain, iters: int = 50):
    """Kernel and plain version in turns (plain, kernel, kernel, plain);
    (mean kernel ms, mean plain ms)."""
    p1, k1, k2, p2 = (cuda_ms(plain, iters), cuda_ms(kern, iters), cuda_ms(kern, iters),
                      cuda_ms(plain, iters))
    log(f"timing {what} on {card}: kernel {k1:.4f} / {k2:.4f} ms, "
        f"plain {p1:.4f} / {p2:.4f} ms per call")
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(ops: float, nbytes: float, kind: str):
    """(least ms the card could take, what bounds it): each input byte
    read once and each output byte written once at the memory rate, or
    the operations at the peak rate for their type, whichever is longer."""
    t_ops, t_bytes = ops / PEAK_OPS_PER_S[kind], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _split_heads(qkv: torch.Tensor, nh: int):
    """q, k, v (B, nh, T, d) views of a (B, T, 3h) tensor."""
    b, t, three_h = qkv.shape
    return qkv.view(b, t, 3, nh, three_h // 3 // nh).permute(2, 0, 3, 1, 4)


def sdpa_fn(qkv: torch.Tensor, nh: int):
    """One scaled_dot_product_attention call on the split views (the
    library yardstick of the attention kernels)."""
    q, k, v = _split_heads(qkv, nh)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)


def sdpa_ms(qkv: torch.Tensor, nh: int) -> float:
    return cuda_ms(sdpa_fn(qkv, nh))


def sdpa_grad_fn(qkv: torch.Tensor, do: torch.Tensor, nh: int):
    """The backward of one scaled_dot_product_attention call alone,
    torch.autograd.grad on a recorded graph."""
    q, k, v = (x.detach().contiguous().requires_grad_() for x in _split_heads(qkv, nh))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    b, t, h = do.shape
    g = do.view(b, t, nh, h // nh).permute(0, 2, 1, 3)
    return lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)


def sdpa_grad_ms(qkv: torch.Tensor, do: torch.Tensor, nh: int) -> float:
    return cuda_ms(sdpa_grad_fn(qkv, do, nh))


def attention_bound(b: int, t: int, h: int, esize: int):
    """K1 / K3: 4 B T^2 h operations; (B, T, 3h) in, (B, T, h) out."""
    return bound(4.0 * b * t * t * h, (3 + 1) * b * t * h * esize, "bf16" if esize == 2 else "f32")


# The wgmma body's (bf16, d=64) own edges, ViT-B/16's heads at B=2: one
# 256-key tile up to T=256 (64-key boxes: T=63/64/65, 128/129, 196/197,
# 255/256), a ring of 128-key tiles past it (257, 577) or of 64-key ones
# (785); 64-row query tiles; kv at 197 of 200, 256 of 257 and 64 of 70
# with pad rows of 1e4; ToMe sizes on either side of 256 keys.
K1_D64_EDGES = (
    [(f"d=64 T={t} {mode}", 2, t, {"fast": mode == "fast"})
     for t in (1, 63, 64, 65, 128, 129, 196, 197, 255, 256, 257, 577, 785)
     for mode in ("fast", "safe")]
    + [(f"d=64 T={t} {mode} sizes", 2, t, {"fast": mode == "fast", "sizes": True})
       for t, mode in ((197, "safe"), (197, "fast"), (257, "fast"), (785, "safe"))]
    + [(f"d=64 kv={kv} T={t} {mode}, pad rows 1e4", 2, t, {"fast": mode == "fast", "kv": kv})
       for kv, t in ((197, 200), (256, 257), (64, 70)) for mode in ("fast", "safe")]
)

# The split-head entry's (K3's) shapes through the wgmma body: (B, H, T, D)
K3_D64_EDGES = [(2, 12, t, 64) for t in (1, 63, 64, 65, 128, 197, 256, 257, 577, 785)]

# K1's timed shapes in bf16 fast (B, T): ViT-B/16 serving at B=8 and 64,
# --img-size 384 and --patch-size 8 (K1', the JAX lane path's shape)
K1_TIMED = ((8, 197), (64, 197), (8, 577), (8, 785))


def _misaligned(a: torch.Tensor) -> torch.Tensor:
    """A copy of `a` one element (2 or 4 bytes) past a 16-byte boundary:
    the wrapper copies it."""
    flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    view = flat[1:].view(a.shape)
    view.copy_(a)
    return view


def check_attention_case(name, qkv, nh, kw, fn, plain, gen, same_as=None) -> float:
    """One attention_qkv case against its plain version (pad rows of 1e4
    past kv, random sizes in [1, 5)); its error, logged beside TOL. With
    `same_as`, another kernel entry whose output must equal this one's bit
    for bit on the same call."""
    b, t, three_h = qkv.shape
    kw = dict(kw)
    if kw.get("kv"):
        qkv[:, kw["kv"]:] = 1e4  # adversarial pad rows
    if kw.get("sizes"):
        kw["sizes"] = torch.randint(1, 5, (b, t), generator=gen, device="cuda").float()
    if same_as is not None and not torch.equal(fn(qkv, nh, **kw), same_as(qkv, nh, **kw)):
        raise AssertionError(f"{name}: the two bodies differ")
    got = fn(qkv, nh, **kw)
    ref = plain(qkv, nh, **kw)
    torch.cuda.synchronize()
    if got.shape != (b, t, three_h // 3) or got.dtype != qkv.dtype:
        raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got.float() - ref.float()).abs().max().item()
    tol = TOL[qkv.dtype]
    log(f"kernel case {name:<38} B={b} T={t} h={three_h // 3} nh={nh} {str(qkv.dtype)[6:]}: "
        f"max|kernel - plain| = {err:.3e} (tolerance {tol:.0e})"
        + ("; equal to the mma.sync body bit for bit" if same_as is not None else ""))
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} > {tol}")
    return err


def check_k1_d64(gen) -> float:
    """The wgmma body's edges (K1_D64_EDGES, K3_D64_EDGES, a misaligned
    qkv) and the mma.sync body at d=64 (the check-only entry), each
    against the plain version, and the two bodies' outputs equal bit for
    bit at every edge; the worst error."""
    from vit_cpp_tpu_torch.ops import flash_attention as fa

    bf16, worst = torch.bfloat16, 0.0
    for name, b, t, kw in K1_D64_EDGES:
        qkv = torch.randn((b, t, 3 * 768), generator=gen, device="cuda").to(bf16)
        worst = max(worst, check_attention_case(
            name, qkv, 12, kw, fa.attention_qkv, fa.attention_qkv_plain, gen,
            same_as=fa.attention_qkv_mma))
    qkv = torch.randn((2, 197, 3 * 768), generator=gen, device="cuda").to(bf16)
    worst = max(worst, check_attention_case(
        "d=64 misaligned qkv (copied)", _misaligned(qkv), 12, {"fast": True}, fa.attention_qkv,
        fa.attention_qkv_plain, gen))
    for name, t, kw in (("mma.sync body d=64 T=197 fast", 197, {"fast": True}),
                        ("mma.sync body d=64 T=785 safe", 785, {"fast": False}),
                        ("mma.sync body d=64 kv=197 T=200", 200, {"fast": True, "kv": 197})):
        qkv = torch.randn((2, t, 3 * 768), generator=gen, device="cuda").to(bf16)
        check_attention_case(name, qkv, 12, kw, fa.attention_qkv_mma, fa.attention_qkv_plain, gen)
    for shape in K3_D64_EDGES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(bf16) for _ in range(3))
        if not torch.equal(fa.flash_attention(q, k, v), fa.flash_attention_mma(q, k, v)):
            raise AssertionError(f"flash_attention {shape}: the two bodies differ")
        for what, fn in (("flash_attention", fa.flash_attention),
                         ("flash_attention mma.sync body", fa.flash_attention_mma)):
            if what != "flash_attention" and shape[2] not in (197, 785):
                continue
            got, ref = fn(q, k, v), fa.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            if got.shape != q.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{what} {shape}: bad output")
            err = (got.float() - ref.float()).abs().max().item()
            log(f"kernel case {what} B={shape[0]} H={shape[1]} T={shape[2]} D={shape[3]} "
                f"bfloat16: max|kernel - plain| = {err:.3e} (tolerance {TOL[bf16]:.0e})")
            if not err <= TOL[bf16]:
                raise AssertionError(f"{what} {shape}: error {err}")
            if what == "flash_attention":
                worst = max(worst, err)
    return worst


def time_k1_bodies(card: str, gen) -> dict:
    """The wgmma body, the mma.sync body it replaced and
    scaled_dot_product_attention in turns (queued device ms) at K1's timed
    shapes (bf16 fast) and K3's (8, 12, 197, 64) (safe), each beside its
    bound; {(B, T) or "K3": (wgmma ms, mma.sync ms, SDPA ms)}."""
    from vit_cpp_tpu_torch.ops import flash_attention as fa

    out = {}
    for b, t in K1_TIMED:
        qkv = torch.randn((b, t, 3 * 768), generator=gen, device="cuda").to(torch.bfloat16)
        r = turns({"wgmma": lambda: fa.attention_qkv(qkv, 12, fast=True),
                   "mma.sync": lambda: fa.attention_qkv_mma(qkv, 12, fast=True),
                   "sdpa": sdpa_fn(qkv, 12)})
        b_ms, b_by = attention_bound(b, t, 768, 2)
        log(f"attention_qkv bodies B={b} T={t} h=768 bf16 fast (device ms, in turns) on {card}: "
            f"wgmma {r['wgmma']:.4f}, mma.sync {r['mma.sync']:.4f} "
            f"({r['mma.sync'] / r['wgmma']:.2f}x), scaled_dot_product_attention "
            f"{r['sdpa']:.4f} ({r['sdpa'] / r['wgmma']:.2f}x); bound {b_ms:.4f} ms ({b_by})")
        out[(b, t)] = (r["wgmma"], r["mma.sync"], r["sdpa"])
        del qkv
    q, k, v = (torch.randn((8, 12, 197, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    r = turns({"wgmma": lambda: fa.flash_attention(q, k, v),
               "mma.sync": lambda: fa.flash_attention_mma(q, k, v),
               "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)})
    b_ms, b_by = attention_bound(8, 197, 768, 2)
    log(f"flash_attention bodies (8, 12, 197, 64) bf16 (device ms, in turns) on {card}: wgmma "
        f"{r['wgmma']:.4f}, mma.sync {r['mma.sync']:.4f} ({r['mma.sync'] / r['wgmma']:.2f}x), "
        f"scaled_dot_product_attention {r['sdpa']:.4f} ({r['sdpa'] / r['wgmma']:.2f}x); bound "
        f"{b_ms:.4f} ms ({b_by})")
    out["K3"] = (r["wgmma"], r["mma.sync"], r["sdpa"])
    return out


# The bf16 wgmma body at d=80 and 88 (each 64-row tile a 64-column box and
# a tail box; ViT-H/14's and ViT-g/14's 16 heads at B=2): 64-query tiles
# and 64-key chunks (T=1, 63/64/65, 128/129), the ring (d=80: 3 chunks, so
# 256 and 257 stream; d=88: 4), T=257's one real row in the last tile,
# T=577; ToMe sizes at T=65 and 257; kv at 256 of 257 and 64 of 70 with pad
# rows of 1e4; 1, 3 and 16 heads. (name, B, T, heads, kwargs)
K1_WIDE_EDGES = (
    [(f"T={t} {mode}", 2, t, 16, {"fast": mode == "fast"})
     for t in (1, 63, 64, 65, 128, 129, 256, 257, 577) for mode in ("fast", "safe")]
    + [(f"T={t} {mode} sizes", 2, t, 16, {"fast": mode == "fast", "sizes": True})
       for t, mode in ((65, "safe"), (257, "fast"))]
    + [(f"kv={kv} T={t} {mode}, pad rows 1e4", 2, t, 16, {"fast": mode == "fast", "kv": kv})
       for kv, t in ((256, 257), (64, 70)) for mode in ("fast", "safe")]
    + [(f"T=197 fast {nh} heads", 2, 197, nh, {"fast": True}) for nh in (1, 3)]
)
# K3 (split heads, safe) through it: (B, H, T, D)
K3_WIDE_EDGES = ((1, 16, 257, 80), (1, 16, 257, 88), (4, 16, 257, 88))
# Its timed shapes (key, d, B, T), bf16 fast: ViT-H/14 at B=8 (T=256 beside
# 257: the cost of the last tile's one real row) and its BENCH_DETAILS
# batch 64; ViT-g/14 at B=8 and its batch 32
K1_WIDE_TIMED = (("h14_bf16_b8_t256", 80, 8, 256), ("h14_bf16_b8", 80, 8, 257),
                 ("h14_bf16_b64", 80, 64, 257), ("g14_bf16_b8", 88, 8, 257),
                 ("g14_bf16_b32", 88, 32, 257))


def held_wide(name: str, got, again, mma, ref, apart: list) -> float:
    """One bf16 case of the wgmma body at d=80 / 88: its error to plain
    (ref); raises if it is not finite, past TOL, or if two calls (got,
    again) differ; a difference from the mma.sync body (mma) is logged
    and appended to `apart` as (case, largest difference)."""
    tol = TOL[torch.bfloat16]
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two calls of the wgmma body differ")
    err = (got.float() - ref.float()).abs().max().item()
    same = torch.equal(got, mma)
    if not same:
        apart.append((name, (got.float() - mma.float()).abs().max().item()))
    log(f"kernel case {name:<44} bfloat16: max|kernel - plain| = {err:.3e} (tolerance "
        f"{tol:.0e}); " + ("equal to the mma.sync body bit for bit" if same else
                          f"differs from the mma.sync body by up to {apart[-1][1]:.3e}")
        + ", each call equal to the next")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} > {tol}")
    return err


def check_k1_wide(gen) -> tuple:
    """The wgmma body at d=80 and 88 (K1_WIDE_EDGES, K3_WIDE_EDGES and a
    misaligned qkv): each case against the plain version within TOL,
    against the mma.sync body it replaced (the check-only entry) and
    against itself from one call to the next, both bit for bit. A case
    that differs from the mma.sync body is logged with its largest
    difference; a call that differs from the last raises. (worst error to
    plain, [(case, largest difference to the mma.sync body)])."""
    from vit_cpp_tpu_torch.ops import flash_attention as fa

    bf16, tol, worst, apart, n = torch.bfloat16, TOL[torch.bfloat16], 0.0, [], 0
    for d in (80, 88):
        cases = [(f"d={d} {name}", b, t, nh, kw) for name, b, t, nh, kw in K1_WIDE_EDGES]
        cases.append((f"d={d} misaligned qkv (copied)", 2, 197, 16, {"fast": True}))
        for name, b, t, nh, kw in cases:
            qkv = torch.randn((b, t, 3 * nh * d), generator=gen, device="cuda").to(bf16)
            if "misaligned" in name:
                qkv = _misaligned(qkv)
            kw = dict(kw)
            if kw.get("kv"):
                qkv[:, kw["kv"]:] = 1e4  # adversarial pad rows
            if kw.get("sizes"):
                kw["sizes"] = torch.randint(1, 5, (b, t), generator=gen, device="cuda").float()
            got, again = fa.attention_qkv(qkv, nh, **kw), fa.attention_qkv(qkv, nh, **kw)
            if got.shape != (b, t, nh * d) or got.dtype != bf16:
                raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}")
            worst = max(worst, held_wide(f"{name} B={b} T={t} nh={nh}", got, again,
                                         fa.attention_qkv_mma(qkv, nh, **kw),
                                         fa.attention_qkv_plain(qkv, nh, **kw), apart))
            n += 1
            del qkv
    for shape in K3_WIDE_EDGES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(bf16) for _ in range(3))
        name = "flash_attention B={} H={} T={} D={}".format(*shape)
        got, again = fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)
        if got.shape != q.shape or got.dtype != bf16:
            raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}")
        worst = max(worst, held_wide(name, got, again, fa.flash_attention_mma(q, k, v),
                                     fa.flash_attention_plain(q, k, v), apart))
        n += 1
    log(f"K1 / K3 bf16 at d=80 and 88: {n} cases, worst error to plain {worst:.3e} (tolerance "
        f"{tol:.0e}); equal to the mma.sync body bit for bit in {n - len(apart)} of {n}, each "
        "call equal to the next")
    return worst, apart


def time_k1_wide(card: str, gen, apart: list) -> tuple:
    """The wgmma body at d=80 and 88 (K1_WIDE_TIMED, bf16 fast; K3 at (8,
    16, 257, d), safe) in turns with the mma.sync body it replaced,
    scaled_dot_product_attention and the plain version (queued device ms),
    each beside its bound. Before its timing each shape's inputs are held
    as check_k1_wide holds its cases (held_wide: within TOL of plain, the
    mma.sync body and the next call bit for bit; differences from the
    mma.sync body appended to `apart`). ({key: (ms, plain ms, bound ms,
    bound by, SDPA ms, mma.sync ms)}, worst error to plain)."""
    from vit_cpp_tpu_torch.ops import flash_attention as fa

    out, worst = {}, 0.0
    for key, d, b, t in K1_WIDE_TIMED:
        nh = 16
        qkv = torch.randn((b, t, 3 * nh * d), generator=gen, device="cuda").to(torch.bfloat16)
        worst = max(worst, held_wide(
            f"timed d={d} B={b} T={t} nh={nh} fast", fa.attention_qkv(qkv, nh, fast=True),
            fa.attention_qkv(qkv, nh, fast=True), fa.attention_qkv_mma(qkv, nh, fast=True),
            fa.attention_qkv_plain(qkv, nh, fast=True), apart))
        r = turns({"wgmma": lambda: fa.attention_qkv(qkv, nh, fast=True),
                   "mma.sync": lambda: fa.attention_qkv_mma(qkv, nh, fast=True),
                   "sdpa": sdpa_fn(qkv, nh),
                   "plain": lambda: fa.attention_qkv_plain(qkv, nh, fast=True)})
        b_ms, b_by = attention_bound(b, t, nh * d, 2)
        log(f"attention_qkv bodies B={b} T={t} h={nh * d} d={d} bf16 fast (device ms, in turns) "
            f"on {card}: wgmma {r['wgmma']:.4f}, mma.sync {r['mma.sync']:.4f} "
            f"({r['mma.sync'] / r['wgmma']:.2f}x), scaled_dot_product_attention {r['sdpa']:.4f} "
            f"({r['wgmma'] / r['sdpa']:.2f}x of it), plain {r['plain']:.4f}; bound {b_ms:.4f} ms "
            f"({b_by}, {r['wgmma'] / b_ms:.1f}x)")
        out[key] = (r["wgmma"], r["plain"], b_ms, b_by, r["sdpa"], r["mma.sync"])
        del qkv
    t256, t257 = out["h14_bf16_b8_t256"][0], out["h14_bf16_b8"][0]
    log(f"attention_qkv d=80 B=8: T=257 takes {t257 / t256 - 1:+.1%} over T=256 (the fifth "
        "64-row tile and 64-key chunk hold one real row and one real key)")
    for d in (80, 88):
        q, k, v = (torch.randn((8, 16, 257, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        worst = max(worst, held_wide(
            f"timed flash_attention (8, 16, 257, {d})", fa.flash_attention(q, k, v),
            fa.flash_attention(q, k, v), fa.flash_attention_mma(q, k, v),
            fa.flash_attention_plain(q, k, v), apart))
        r = turns({"wgmma": lambda: fa.flash_attention(q, k, v),
                   "mma.sync": lambda: fa.flash_attention_mma(q, k, v),
                   "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                   "plain": lambda: fa.flash_attention_plain(q, k, v)})
        b_ms, b_by = attention_bound(8, 257, 16 * d, 2)
        log(f"flash_attention bodies (8, 16, 257, {d}) bf16 (device ms, in turns) on {card}: "
            f"wgmma {r['wgmma']:.4f}, mma.sync {r['mma.sync']:.4f} "
            f"({r['mma.sync'] / r['wgmma']:.2f}x), scaled_dot_product_attention "
            f"{r['sdpa']:.4f}, plain {r['plain']:.4f}; bound {b_ms:.4f} ms ({b_by})")
        out[f"K3 d={d}"] = (r["wgmma"], r["plain"], b_ms, b_by, r["sdpa"], r["mma.sync"])
    log(f"K1 / K3 bf16 at d=80 and 88, the {len(K1_WIDE_TIMED) + 2} timed shapes: worst error "
        f"to plain {worst:.3e} (tolerance {TOL[torch.bfloat16]:.0e}); apart from the mma.sync "
        f"body in all cases so far: {len(apart)}")
    return out, worst


# The backward's f32 body at d=64 (wgmma + TMA): 64-row blocks of two
# warpgroups, 32-token chunks with 8-token tails (T=1, 8, 63, 64, 65, 127,
# 128, 129), the 256-key edge (196, 197, 200, 256, 257), the lane shapes
# (577, 785); ToMe sizes on either side; 1, 3 and 12 heads. (B, T, heads,
# sizes)
K2_F32_EDGES = (
    [(2, t, 3, False) for t in (1, 8, 63, 64, 65, 127, 128, 129, 196, 197, 200, 256, 257,
                                577, 785)]
    + [(2, t, 3, True) for t in (65, 197, 785)]
    + [(2, 197, nh, False) for nh in (1, 12)]
)

# The backward's bf16 body at d=64 (wgmma + TMA): 64-row warpgroups,
# 64-token chunks (T=1, 8, 63, 64, 65, 127, 128, 129), ViT-B/16's and
# ToMe's lengths (196, 197, 200), the 256-key edge (256, 257: one real row
# in the last tile), the lane shapes (577, 785); ToMe sizes on either side;
# 1, 3, 6 and 12 heads. (B, T, heads, sizes)
K2_BF16_EDGES = (
    [(2, t, 3, False) for t in (1, 8, 63, 64, 65, 127, 128, 129, 196, 197, 200, 256, 257,
                                577, 785)]
    + [(2, t, 3, True) for t in (65, 197, 785)]
    + [(2, 197, nh, False) for nh in (1, 6, 12)]
)

# Its timed shapes (B, T, heads): ViT-B/16 training at B=32 and its tp 2 /
# 4 per-rank shapes, ViT-B/8 (--patch-size 8) at B=4 and at the training
# path's B=8; bf16: ViT-B/16 at B=32 and 64 (T2's shape) and ViT-B/8 at B=8
K2_TIMED = ((32, 197, 12), (4, 785, 12), (8, 785, 12), (32, 197, 6), (32, 197, 3))
K2_BF16_TIMED = ((32, 197, 12), (64, 197, 12), (8, 785, 12))


def check_k2_wgmma(gen, d: int = 64, edges=K2_F32_EDGES, dtype=torch.float32) -> float:
    """The backward's wgmma body (f32 at d = 64 and 80, bf16 at d = 64) at
    d and its edges (B, T, heads, sizes) and on a misaligned qkv and dO:
    each against the plain version and against the mma.sync body (the
    check-only entry) within GRAD_TOL, two calls bit-equal; the worst
    error relative to max|plain|."""
    from vit_cpp_tpu_torch.ops import flash_attention as fa

    worst, tol, kind = 0.0, GRAD_TOL[dtype], str(dtype)[6:]
    before = (fa.GRAD_KERNEL.launches, fa.GRAD_MMA_KERNEL.launches)
    cases = [(b, t, nh, sized, False) for b, t, nh, sized in edges]
    cases.append((2, 197, 12, False, True))
    for b, t, nh, sized, shift in cases:
        qkv = torch.randn((b, t, 3 * d * nh), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, t, d * nh), generator=gen, device="cuda").to(dtype)
        sizes = (torch.randint(1, 5, (b, t), generator=gen, device="cuda").float()
                 if sized else None)
        args = (_misaligned(qkv), _misaligned(do)) if shift else (qkv, do)
        got = fa.attention_qkv_grad(*args, nh, sizes=sizes)
        again = fa.attention_qkv_grad(*args, nh, sizes=sizes)
        mma = fa.attention_qkv_grad_mma(qkv, do, nh, sizes=sizes).float()
        ref = fa.attention_qkv_grad_plain(qkv, do, nh, sizes=sizes).float()
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != dtype or not torch.isfinite(got).all():
            raise AssertionError(f"attention_qkv_grad {kind} d={d} T={t}: bad output")
        scale = ref.abs().max().item()
        err = (got.float() - ref).abs().max().item() / scale
        err_mma = (got.float() - mma).abs().max().item() / scale
        same = torch.equal(got, again)
        what = f"B={b} T={t} nh={nh}{' sizes' if sized else ''}{' misaligned' if shift else ''}"
        log(f"kernel case attention_qkv_grad wgmma body {kind} d={d} {what}: max|kernel - plain| "
            f"= {err:.3e} x max|plain|, max|kernel - mma.sync body| = {err_mma:.3e} (tolerance "
            f"{tol:.0e}); two calls bit-equal: {same}")
        if not (err <= tol and err_mma <= tol and same):
            raise AssertionError(f"attention_qkv_grad wgmma body {kind} d={d} {what}: error "
                                 f"{err}, {err_mma} to the mma.sync body, bit-equal {same}")
        worst = max(worst, err)
    got = (fa.GRAD_KERNEL.launches - before[0], fa.GRAD_MMA_KERNEL.launches - before[1])
    if got != (2 * len(cases), len(cases)):
        raise AssertionError(f"attention_qkv_grad launches {got}, expected "
                             f"{(2 * len(cases), len(cases))}")
    return worst


def k2_bound(b: int, t: int, h: int, esize: int):
    """K2: five T x T x d products per head; qkv and dO in, dqkv out."""
    return bound(10.0 * b * t * t * h, (3 + 1 + 3) * b * t * h * esize,
                 "f32" if esize == 4 else "bf16")


def hold_timed(name: str, kern, mma, plain, tol: float, held: dict) -> None:
    """A timed f32 shape held before its timing, on the input it is timed
    on: the kernel's output finite, within tol of the plain version's and
    of the check-only mma.sync entry's, and equal to its next call bit for
    bit; the error to plain (over max|plain| where `tol` is relative, the
    backward's) is logged and kept as held[name]'s worst."""
    got, again, ref, m = kern(), kern(), plain(), mma()
    torch.cuda.synchronize()
    scale = ref.abs().max().item() if name == "attention_qkv_grad" else 1.0
    err = (got - ref).abs().max().item() / scale
    err_mma = (got - m).abs().max().item() / scale
    same = torch.equal(got, again)
    log(f"  held before timing: max|kernel - plain| = {err:.3e}"
        + (" x max|plain|" if scale != 1.0 else "")
        + f", max|kernel - mma.sync body| = {err_mma:.3e} (tolerance {tol:.0e}); two calls "
        f"bit-equal: {same}")
    if not (torch.isfinite(got).all() and err <= tol and err_mma <= tol and same):
        raise AssertionError(f"{name} timed shape: error {err}, {err_mma} to the mma.sync body, "
                             f"bit-equal {same}")
    held[name] = max(held.get(name, 0.0), err)


def time_k2_bodies(card: str, gen, shapes=K2_TIMED, d: int = 64, dtype=torch.float32,
                   held: dict = None) -> dict:
    """The backward's wgmma body, the mma.sync body it replaced (the
    check-only entry), SDPA's backward and the plain version in turns
    (queued device ms) at `shapes` (B, T, heads) of heads of d in `dtype`,
    each beside its bound; {(B, T, heads): (wgmma, plain, bound ms, bound
    by, SDPA, mma.sync ms)}, the kernels line's order. With `held` (f32),
    each shape's input is first held by hold_timed."""
    from vit_cpp_tpu_torch.ops import flash_attention as fa

    out = {}
    for b, t, nh in shapes:
        h = d * nh
        qkv = torch.randn((b, t, 3 * h), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, t, h), generator=gen, device="cuda").to(dtype)
        if held is not None:
            log(f"attention_qkv_grad timed shape B={b} T={t} nh={nh} d={d} {str(dtype)[6:]}:")
            hold_timed("attention_qkv_grad", lambda: fa.attention_qkv_grad(qkv, do, nh),
                       lambda: fa.attention_qkv_grad_mma(qkv, do, nh),
                       lambda: fa.attention_qkv_grad_plain(qkv, do, nh), GRAD_TOL[dtype], held)
        r = turns({"wgmma": lambda: fa.attention_qkv_grad(qkv, do, nh),
                   "mma.sync": lambda: fa.attention_qkv_grad_mma(qkv, do, nh),
                   "sdpa": sdpa_grad_fn(qkv, do, nh),
                   "plain": lambda: fa.attention_qkv_grad_plain(qkv, do, nh)},
                  iters=50 if b <= 32 else 10)
        b_ms, b_by = k2_bound(b, t, h, qkv.element_size())
        log(f"attention_qkv_grad bodies B={b} T={t} nh={nh} d={d} {str(dtype)[6:]} (device ms, "
            f"in turns) on "
            f"{card}: wgmma {r['wgmma']:.4f}, mma.sync {r['mma.sync']:.4f} "
            f"({r['mma.sync'] / r['wgmma']:.2f}x), scaled_dot_product_attention backward "
            f"{r['sdpa']:.4f} ({r['sdpa'] / r['wgmma']:.2f}x), plain {r['plain']:.4f}; bound "
            f"{b_ms:.4f} ms ({b_by})")
        out[(b, t, nh)] = (r["wgmma"], r["plain"], b_ms, b_by, r["sdpa"], r["mma.sync"])
        del qkv, do
    return out


# K1's f32 body (wgmma + TMA) at d=64, 80 and 88: 64-row query tiles,
# 16-key chunks taken by two warpgroups in turn with 8-key tails (T=1, 8,
# 63, 64, 65, 127, 128, 129), ToMe's and ViT-B/16's lengths (196, 197),
# ViT-H/14's and ViT-g/14's (256, 257: one real row in the last tile; 258)
# and the lane shapes (577, 785); fast and safe; sizes at 65, 197 and 257;
# kv at 197 of 200, 256 of 257 and 64 of 70 with pad rows of 1e4; 1, 3,
# 12 and 16 heads. (name, d, B, T, heads, kwargs)
K1_F32_D = (64, 80, 88)
K1_F32_EDGES = (
    [(f"d={d} T={t} {mode}", d, 2, t, 3, {"fast": mode == "fast"})
     for d in K1_F32_D
     for t in (1, 8, 63, 64, 65, 127, 128, 129, 196, 197, 256, 257, 258, 577, 785)
     for mode in ("fast", "safe")]
    + [(f"d={d} T={t} {mode} sizes", d, 2, t, 3, {"fast": mode == "fast", "sizes": True})
       for d in K1_F32_D for t, mode in ((65, "safe"), (197, "fast"), (257, "safe"))]
    + [(f"d={d} kv={kv} T={t} {mode}, pad rows 1e4", d, 2, t, 3,
        {"fast": mode == "fast", "kv": kv})
       for d in K1_F32_D for kv, t in ((197, 200), (256, 257), (64, 70))
       for mode in ("fast", "safe")]
    + [(f"d={d} T=197 safe nh={nh}", d, 2, 197, nh, {"fast": False})
       for d in K1_F32_D for nh in (1, 12, 16)]
)

# The split-head entry's (K3's) f32 shapes (B, H, T, D)
K3_F32_EDGES = ((8, 12, 197, 64), (1, 16, 257, 80), (1, 16, 257, 88))

# K1's f32 timed shapes: (label, B, T, d, heads, fast). ViT-B/16 training
# at B=32 and --patch-size 8 (T=785, K1') at B=8, ViT-H/14 at B=8 and 128
# (and T=256 beside 257: what the last tile's one real row costs), f32
# serving (vit-serve --dtype f32) at B=64
K1_F32_TIMED = (("vit-b16", 32, 197, 64, 12, False), ("vit-b8", 8, 785, 64, 12, False),
                ("vit-h14", 8, 257, 80, 16, False), ("vit-h14 T=256", 8, 256, 80, 16, False),
                ("vit-h14 B=128", 128, 257, 80, 16, False),
                ("vit-b16 fast", 64, 197, 64, 12, True))

# K2's d=80 and d=88 edges (B, T, heads, sizes): launch B's 16-token
# chunks, 64-row blocks; and its timed shapes, ViT-H/14 at B=8 (T=256
# beside 257) and B=128
K2_WIDE_EDGES = (
    [(2, t, 3, False) for t in (1, 8, 63, 64, 65, 129, 256, 257, 258, 785)]
    + [(2, t, 3, True) for t in (65, 257)]
    + [(2, 257, nh, False) for nh in (1, 16)]
)
K2_D80_TIMED = ((8, 257, 16), (8, 256, 16), (128, 257, 16))


def check_k1_f32(gen, dims=K1_F32_D) -> float:
    """K1's f32 wgmma body at its edges at head dimensions `dims`
    (K1_F32_EDGES, a misaligned qkv, K3_F32_EDGES): each against the plain
    version and against the 3xTF32 mma.sync body it replaced (the
    check-only entry) within TOL[f32], two calls bit-equal, with their
    launch counts; the worst error."""
    from vit_cpp_tpu_torch.ops import flash_attention as fa

    f32, tol, worst = torch.float32, TOL[torch.float32], 0.0
    before = (fa.KERNEL.launches, fa.MMA_KERNEL.launches, fa.FLASH_KERNEL.launches)
    cases = [(*c, False) for c in K1_F32_EDGES if c[1] in dims]
    cases += [(f"d={d} T={t} safe misaligned qkv", d, 2, t, nh, {"fast": False}, True)
              for d, t, nh in ((64, 197, 12), (80, 257, 16), (88, 257, 16)) if d in dims]
    k3_edges = [shape for shape in K3_F32_EDGES if shape[3] in dims]
    for name, d, b, t, nh, kw, shift in cases:
        qkv = torch.randn((b, t, 3 * d * nh), generator=gen, device="cuda")
        kw = dict(kw)
        if kw.get("kv"):
            qkv[:, kw["kv"]:] = 1e4  # adversarial pad rows
        if kw.get("sizes"):
            kw["sizes"] = torch.randint(1, 5, (b, t), generator=gen, device="cuda").float()
        x = _misaligned(qkv) if shift else qkv
        got = fa.attention_qkv(x, nh, **kw)
        again = fa.attention_qkv(x, nh, **kw)
        mma = fa.attention_qkv_mma(qkv, nh, **kw)
        ref = fa.attention_qkv_plain(qkv, nh, **kw)
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != f32 or not torch.isfinite(got).all():
            raise AssertionError(f"attention_qkv f32 {name}: bad output")
        err = (got - ref).abs().max().item()
        err_mma = (got - mma).abs().max().item()
        same = torch.equal(got, again)
        log(f"kernel case attention_qkv wgmma body f32 {name} B={b} nh={nh}: max|kernel - plain| "
            f"= {err:.3e}, max|kernel - mma.sync body| = {err_mma:.3e} (tolerance {tol:.0e}); "
            f"two calls bit-equal: {same}")
        if not (err <= tol and err_mma <= tol and same):
            raise AssertionError(f"attention_qkv f32 wgmma body {name}: error {err}, {err_mma} "
                                 f"to the mma.sync body, bit-equal {same}")
        worst = max(worst, err)
    for shape in k3_edges:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        got, again = fa.flash_attention(q, k, v), fa.flash_attention(q, k, v)
        mma, ref = fa.flash_attention_mma(q, k, v), fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        if got.shape != q.shape or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention f32 {shape}: bad output")
        err, err_mma = (got - ref).abs().max().item(), (got - mma).abs().max().item()
        same = torch.equal(got, again)
        log(f"kernel case flash_attention wgmma body f32 B={shape[0]} H={shape[1]} T={shape[2]} "
            f"D={shape[3]}: max|kernel - plain| = {err:.3e}, max|kernel - mma.sync body| = "
            f"{err_mma:.3e} (tolerance {tol:.0e}); two calls bit-equal: {same}")
        if not (err <= tol and err_mma <= tol and same):
            raise AssertionError(f"flash_attention f32 {shape}: error {err}, {err_mma}, {same}")
        worst = max(worst, err)
    n, n3 = len(cases), len(k3_edges)
    got = (fa.KERNEL.launches - before[0], fa.MMA_KERNEL.launches - before[1],
           fa.FLASH_KERNEL.launches - before[2])
    if got != (2 * n, n + n3, 2 * n3):
        raise AssertionError(f"attention launches {got}, expected {(2 * n, n + n3, 2 * n3)}")
    return worst


def time_k1_f32(card: str, gen, label: str, b: int, t: int, d: int, nh: int,
                fast: bool, held: dict = None) -> tuple:
    """K1's f32 wgmma body, the mma.sync body it replaced (the check-only
    entry), scaled_dot_product_attention and the plain version in turns
    (queued device ms) at one shape, beside its bound: (wgmma, plain, bound
    ms, bound by, SDPA, mma.sync ms), the kernels line's order. With
    `held`, the input is first held by hold_timed."""
    from vit_cpp_tpu_torch.ops import flash_attention as fa

    qkv = torch.randn((b, t, 3 * d * nh), generator=gen, device="cuda")
    if held is not None:
        log(f"attention_qkv timed shape {label} B={b} T={t} nh={nh} d={d} f32 "
            f"{'fast' if fast else 'safe'}:")
        hold_timed("attention_qkv", lambda: fa.attention_qkv(qkv, nh, fast=fast),
                   lambda: fa.attention_qkv_mma(qkv, nh, fast=fast),
                   lambda: fa.attention_qkv_plain(qkv, nh, fast=fast), TOL[torch.float32], held)
    r = turns({"wgmma": lambda: fa.attention_qkv(qkv, nh, fast=fast),
               "mma.sync": lambda: fa.attention_qkv_mma(qkv, nh, fast=fast),
               "sdpa": sdpa_fn(qkv, nh),
               "plain": lambda: fa.attention_qkv_plain(qkv, nh, fast=fast)},
              iters=50 if b <= 64 else 10)
    b_ms, b_by = attention_bound(b, t, d * nh, 4)
    log(f"attention_qkv bodies {label} B={b} T={t} nh={nh} d={d} f32 "
        f"{'fast' if fast else 'safe'} (device ms, in turns) on {card}: wgmma {r['wgmma']:.4f}, "
        f"mma.sync {r['mma.sync']:.4f} ({r['mma.sync'] / r['wgmma']:.2f}x), "
        f"scaled_dot_product_attention {r['sdpa']:.4f} ({r['sdpa'] / r['wgmma']:.2f}x), plain "
        f"{r['plain']:.4f}; bound {b_ms:.4f} ms ({b_by})")
    return r["wgmma"], r["plain"], b_ms, b_by, r["sdpa"], r["mma.sync"]


def time_k1_f32_bodies(card: str, gen) -> dict:
    """time_k1_f32 at K1_F32_TIMED; {label: its tuple}."""
    return {label: time_k1_f32(card, gen, label, *shape) for label, *shape in K1_F32_TIMED}


def time_k3_f32(card: str, gen) -> dict:
    """K3 in f32 (flash_attention on split heads, safe: the f32 wgmma body),
    the mma.sync body it replaced (the check-only entry),
    scaled_dot_product_attention in f32 and the plain version in turns
    (queued device ms) at K3_F32_EDGES, each beside its bound; {(B, H, T,
    D): (wgmma, plain, bound ms, bound by, SDPA, mma.sync ms)}, the kernels
    line's order."""
    from vit_cpp_tpu_torch.ops import flash_attention as fa

    out = {}
    for shape in K3_F32_EDGES:
        b, nh, t, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        r = turns({"wgmma": lambda: fa.flash_attention(q, k, v),
                   "mma.sync": lambda: fa.flash_attention_mma(q, k, v),
                   "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                   "plain": lambda: fa.flash_attention_plain(q, k, v)})
        b_ms, b_by = attention_bound(b, t, d * nh, 4)
        log(f"flash_attention bodies {shape} f32 (device ms, in turns) on {card}: wgmma "
            f"{r['wgmma']:.4f}, mma.sync {r['mma.sync']:.4f} ({r['mma.sync'] / r['wgmma']:.2f}x), "
            f"scaled_dot_product_attention f32 {r['sdpa']:.4f} ({r['sdpa'] / r['wgmma']:.2f}x), "
            f"plain {r['plain']:.4f}; bound {b_ms:.4f} ms ({b_by})")
        out[shape] = (r["wgmma"], r["plain"], b_ms, b_by, r["sdpa"], r["mma.sync"])
        del q, k, v
    return out


def encode_cost(card: str) -> None:
    """Host us per call of the wgmma body's C entry (two tensor maps
    encoded per call) and of the mma.sync body's (none) on one small bf16
    d=64 input, each called straight through ctypes with the same
    arguments: 500 calls enqueued behind a kernel that sleeps on the card
    (so that the host's time is its own, not the card's), min of 3 runs.
    The difference is what the tensor maps cost the host."""
    import math

    from vit_cpp_tpu_torch._build import library

    lib = library()
    gen = torch.Generator(device="cuda").manual_seed(18)
    qkv = torch.randn((1, 16, 192), generator=gen, device="cuda").bfloat16()
    out = torch.empty((1, 16, 64), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.4426950408889634 / math.sqrt(64)
    q, o = qkv.data_ptr(), out.data_ptr()
    calls = {"wgmma": lambda: lib.vit_attention_qkv(q, None, o, 1, 16, 1, 64, 16, scale, 1, 1,
                                                    stream),
             "mma.sync": lambda: lib.vit_attention_mma(q, q, q, None, o, 1, 16, 1, 64, 16, scale, 1,
                                                       0, 1, stream)}
    per_call = {k: [] for k in calls}
    for _ in range(3):
        for name, fn in calls.items():
            if fn() != 0:
                raise AssertionError(f"encode_cost: the {name} launch failed")
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            per_call[name].append((time.perf_counter() - t0) / 500 * 1e6)
            torch.cuda.synchronize()
    us = {k: min(v) for k, v in per_call.items()}
    log(f"host us per C call, attention (1, 16, 192) bf16 d=64 through ctypes, enqueued behind a "
        f"sleeping kernel (min of 3 runs of 500): wgmma body {us['wgmma']:.2f}, mma.sync body "
        f"{us['mma.sync']:.2f}; the tensor maps' encode and larger launch "
        f"{us['wgmma'] - us['mma.sync']:+.2f} us on {card}")


def check_kernels(card: str):
    from vit_cpp_tpu_torch.ops.flash_attention import attention_qkv, attention_qkv_plain

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv_of(b, t, h, dtype):
        return torch.randn((b, t, 3 * h), generator=gen, device="cuda").to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, B, T, h, heads, dtype, kwargs
        ("vit-b16 fast", 8, 197, 768, 12, bf16, {"fast": True}),
        ("vit-b16 safe", 8, 197, 768, 12, bf16, {"fast": False}),
        ("kv=197 T=200 safe, garbage pad rows", 8, 200, 768, 12, bf16, {"fast": False, "kv": 197}),
        ("kv=197 T=200 fast, garbage pad rows", 8, 200, 768, 12, bf16, {"fast": True, "kv": 197}),
        ("tome sizes safe", 8, 197, 768, 12, bf16, {"fast": False, "sizes": True}),
        ("tome sizes fast", 8, 197, 768, 12, bf16, {"fast": True, "sizes": True}),
        ("vit-b8 T=785 fast", 4, 785, 768, 12, bf16, {"fast": True}),
        # the model families' serving shapes: --img-size 384 and
        # --patch-size 8 at B=8, SigLIP's tower with no prefix token
        ("vit-b16@384 T=577 fast", 8, 577, 768, 12, bf16, {"fast": True}),
        ("vit-b8 T=785 fast B=8", 8, 785, 768, 12, bf16, {"fast": True}),
        ("siglip-b16 T=196 fast", 8, 196, 768, 12, bf16, {"fast": True}),
        ("vit-h14 d=80 T=257 fast", 4, 257, 1280, 16, bf16, {"fast": True}),
        ("vit-g14 d=88 T=257 safe", 4, 257, 1408, 16, bf16, {"fast": False}),
        ("f32 vit-b16 safe", 8, 197, 768, 12, f32, {"fast": False}),
        ("f32 vit-b16 fast", 8, 197, 768, 12, f32, {"fast": True}),
        # the training forward of cli.finetune --patch-size 8 -b 8
        ("f32 vit-b8 T=785 safe B=8", 8, 785, 768, 12, f32, {"fast": False}),
        # the edges of the bf16 body's tiling: 128-query blocks of 16-row
        # warps, 64-key tiles of 16-key chunks, d padded to a multiple of 16
        ("T=1 fast", 4, 1, 768, 12, bf16, {"fast": True}),
        ("T=1 safe", 4, 1, 768, 12, bf16, {"fast": False}),
        ("T=65 safe", 4, 65, 768, 12, bf16, {"fast": False}),
        ("T=65 fast sizes", 4, 65, 768, 12, bf16, {"fast": True, "sizes": True}),
        ("T=128 fast", 4, 128, 768, 12, bf16, {"fast": True}),
        ("T=128 safe sizes", 4, 128, 768, 12, bf16, {"fast": False, "sizes": True}),
        ("T=129 safe (one past a query block)", 4, 129, 768, 12, bf16, {"fast": False}),
        ("kv=128 T=131 safe (key-tile edge)", 4, 131, 768, 12, bf16, {"fast": False, "kv": 128}),
        ("kv=129 T=131 fast (one past)", 4, 131, 768, 12, bf16, {"fast": True, "kv": 129}),
        ("kv=64 T=70 fast (key-tile edge)", 4, 70, 768, 12, bf16, {"fast": True, "kv": 64}),
        ("kv=65 T=70 safe (one past)", 4, 70, 768, 12, bf16, {"fast": False, "kv": 65}),
        ("d=72 safe (padded contraction)", 4, 197, 864, 12, bf16, {"fast": False}),
        ("d=72 fast sizes", 4, 197, 864, 12, bf16, {"fast": True, "sizes": True}),
        ("d=128 fast", 4, 197, 1536, 12, bf16, {"fast": True}),
        ("d=128 safe kv=190", 4, 197, 1536, 12, bf16, {"fast": False, "kv": 190}),
        # the edges of the f32 (3xTF32) body's tiling: the bf16 body's
        # blocks and warps, 64-key tiles of 8-key steps
        ("f32 T=1 fast", 4, 1, 768, 12, f32, {"fast": True}),
        ("f32 T=1 safe", 4, 1, 768, 12, f32, {"fast": False}),
        ("f32 T=65 safe", 4, 65, 768, 12, f32, {"fast": False}),
        ("f32 T=129 safe sizes", 4, 129, 768, 12, f32, {"fast": False, "sizes": True}),
        ("f32 kv=64 T=70 fast (key-tile edge)", 4, 70, 768, 12, f32, {"fast": True, "kv": 64}),
        ("f32 kv=65 T=70 safe (one past)", 4, 70, 768, 12, f32, {"fast": False, "kv": 65}),
        ("f32 d=72 safe (padded contraction)", 4, 197, 864, 12, f32, {"fast": False}),
        ("f32 d=128 fast sizes", 4, 197, 1536, 12, f32, {"fast": True, "sizes": True}),
        ("f32 d=128 safe kv=190", 4, 197, 1536, 12, f32, {"fast": False, "kv": 190}),
    ]
    main_err = None
    for name, b, t, h, nh, dtype, kw in cases:
        err = check_attention_case(name, qkv_of(b, t, h, dtype), nh, kw, attention_qkv,
                                   attention_qkv_plain, gen)
        if main_err is None:
            main_err = err
    check_k1_d64(gen)
    wide = check_k1_wide(gen)

    times = {}
    # ViT-B/16 serving at B=8 and 64; T=577 and 785 are --img-size 384 and
    # --patch-size 8 (785: the shape of the JAX package's lane path, K1');
    # each beside the mma.sync body it replaced and SDPA, in turns
    bodies = time_k1_bodies(card, gen)
    for b, t in K1_TIMED:
        qkv = qkv_of(b, t, 768, bf16)
        k_ms, p_ms = time_pair(
            f"attention_qkv B={b} T={t} h=768 bf16 fast", card,
            lambda: attention_qkv(qkv, 12, fast=True),
            lambda: attention_qkv_plain(qkv, 12, fast=True),
        )
        _, mma, lib = bodies[(b, t)]
        b_ms, b_by = attention_bound(b, t, 768, 2)
        log(f"attention_qkv B={b} T={t}: bound {b_ms:.4f} ms ({b_by}), library "
            f"scaled_dot_product_attention {lib:.4f} ms, mma.sync body {mma:.4f} ms on {card}")
        times[(b, t)] = (k_ms, p_ms, b_ms, b_by, lib, mma)
    times["K3"] = bodies["K3"]
    # bf16 at d=80 and 88 (ViT-H/14 and ViT-g/14: the wgmma body's two-box
    # tiles), in turns with the mma.sync body, SDPA and plain
    wide_times, timed_err = time_k1_wide(card, gen, wide[1])
    times.update(wide_times)
    times["wide"] = (*wide, timed_err)
    # the training forward: f32, safe softmax, ViT-B/16 at B=32, the wgmma
    # body in turns with the mma.sync body it replaced
    times["f32 B=32"] = time_k1_f32(card, gen, "vit-b16", 32, 197, 64, 12, False)
    return main_err, times


def _quant_linear(rng, k: int, n: int, qtype):
    """A random (n, k) weight quantized to `qtype` and loaded as the
    params loader loads it: a QuantLinear on the card."""
    from vit_cpp_tpu_torch.gguf.reader import TensorRecord
    from vit_cpp_tpu_torch.quant.blocks import quantize
    from vit_cpp_tpu_torch.quant.qlinear import quant_linear_from_record

    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    raw = np.frombuffer(quantize(w, qtype).tobytes(), np.uint8)
    return quant_linear_from_record(TensorRecord("w", (n, k), qtype, raw), device="cuda")


def qmm_f32_cases() -> list:
    """The edges of the f32 (3xTF32) body's tiling in every block format:
    128-row x 128-column blocks, 32-row K steps. M = 1, 8, one past a
    block, B=8 plus one and ViT-B/16's B=64; K = fc2's 3072 and 800 (K %
    64 = 32); N = 96 (a 128-wide tile covers it), 1000 (rows of codes
    8-byte aligned), 1001 (no vector loads), 768, 2304 and 3072."""
    from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType as G

    f32, cases = torch.float32, []
    for qt in (G.Q4_0, G.Q4_1, G.Q5_0, G.Q5_1, G.Q8_0):
        cases += [
            ("f32 M=1 N=768", (1,), 768, 768, qt, f32),
            ("f32 M=8 head N=1000", (8,), 768, 1000, qt, f32),
            ("f32 M=129 fc2 K=3072", (129,), 3072, 768, qt, f32),
            ("f32 M=129 K=800 N=1001", (129,), 800, 1001, qt, f32),
            ("f32 M=1577 N=3072", (1577,), 768, 3072, qt, f32),
            ("f32 M=1577 N=96", (1577,), 768, 96, qt, f32),
            ("f32 M=12608 qkv", (12608,), 768, 2304, qt, f32),
        ]
    return cases


def check_qmm_cases(cases, rng) -> float:
    """Each (name, leading dims, K, N, format, dtype) case through
    dequant_matmul against its plain version, within QMM_TOL of
    max|plain|; the worst absolute error."""
    from vit_cpp_tpu_torch.ops.qmatmul import dequant_matmul, dequant_matmul_plain

    worst = 0.0
    for name, lead, k, n, qt, dtype in cases:
        w = _quant_linear(rng, k, n, qt)
        x = torch.from_numpy(rng.standard_normal((*lead, k)).astype(np.float32)).to("cuda", dtype)
        got = dequant_matmul(x, w)
        ref = dequant_matmul_plain(x, w)
        torch.cuda.synchronize()
        if got.shape != (*lead, n) or got.dtype != dtype:
            raise AssertionError(f"{name}: got {tuple(got.shape)} {got.dtype}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = QMM_TOL[dtype] * scale
        log(f"kernel case dequant_matmul {name:<26} M={int(np.prod(lead))} K={k} N={n} "
            f"{qt.name} {str(dtype)[6:]}: max|kernel - plain| = {err:.3e} "
            f"(tolerance {tol:.3e} = {QMM_TOL[dtype]:.0e} x max|plain|)")
        if not err <= tol:
            raise AssertionError(f"dequant_matmul {name}: error {err} > {tol}")
        worst = max(worst, err)
    return worst


def time_qmm_f32(card: str, rng) -> dict:
    """The f32 body at ViT-B/16's linears at B=8 and B=64 on Q8_0 weights:
    kernel and plain version in turns, the bound (f32 x and y, 34 bytes
    per 32 weights, the operations at 3xTF32) and the library call,
    torch.matmul on the weight dequantized once in f32 with TF32 off
    (cuBLAS's f32 GEMM). Returns {"qkv", "qkv B=64", ...: (ms, plain_ms,
    bound_ms, bound_by, library_ms)}."""
    from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType as G
    from vit_cpp_tpu_torch.ops.qmatmul import dequant_matmul, dequant_matmul_plain

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 library yardstick needs TF32 off")
    times = {}
    for b in (8, 64):
        m = b * 197
        for layer, k, n in (("qkv", 768, 2304), ("proj", 768, 768), ("fc1", 768, 3072),
                            ("fc2", 3072, 768)):
            name = layer if b == 8 else f"{layer} B=64"
            w = _quant_linear(rng, k, n, G.Q8_0)
            x = torch.randn((m, k), device="cuda")
            k_ms, p_ms = time_pair(
                f"dequant_matmul ViT-B/16 {name} M={m} K={k} N={n} Q8_0 f32", card,
                lambda: dequant_matmul(x, w), lambda: dequant_matmul_plain(x, w),
            )
            dense = w.dequantize(torch.float32)  # once, outside the timed loop
            lib = cuda_ms(lambda: torch.matmul(x, dense))
            b_ms, b_by = bound(2.0 * m * k * n, 4 * m * k + k * n // 32 * 34 + 4 * m * n, "f32")
            log(f"dequant_matmul {name} f32: {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), library torch.matmul f32 on the weight dequantized "
                f"once {lib:.4f} ms on {card}")
            times[name] = (k_ms, p_ms, b_ms, b_by, lib)
    return times


def check_dequant_matmul(card: str):
    from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType as G
    from vit_cpp_tpu_torch.ops.qmatmul import dequant_matmul, dequant_matmul_plain

    rng = np.random.default_rng(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, x shape, K, N, format, dtype
        ("qkv", (1576,), 768, 2304, G.Q8_0, bf16),
        ("proj", (1576,), 768, 768, G.Q5_0, bf16),
        ("fc1", (1576,), 768, 3072, G.Q4_1, bf16),
        ("fc2", (1576,), 3072, 768, G.Q4_0, bf16),
        ("head", (8,), 768, 1000, G.Q5_1, bf16),
        ("head N=1001 (scalar loads)", (8,), 768, 1001, G.Q8_0, bf16),
        # ViTSTR-Base's head at B=64: 25 rows per image, 96 columns (a
        # 128-wide tile covers 96)
        ("ViTSTR head N=96", (64 * 25,), 768, 96, G.Q8_0, bf16),
        ("f32 qkv", (1576,), 768, 2304, G.Q4_1, f32),
        ("leading dims (8, 197)", (8, 197), 768, 768, G.Q8_0, bf16),
    ]
    # the edges of the bf16 body's tiling (256- or 128-row tiles of 128
    # columns, 64-row K steps) in every block format
    for qt in (G.Q4_0, G.Q4_1, G.Q5_0, G.Q5_1, G.Q8_0):
        cases += [
            ("M=1 N=768", (1,), 768, 768, qt, bf16),
            ("M=129 fc2 K=3072", (129,), 3072, 768, qt, bf16),
            ("M=1577 N=3072", (1577,), 768, 3072, qt, bf16),
            ("M=1577 N=1000", (1577,), 768, 1000, qt, bf16),
            ("M=129 N=1001", (129,), 768, 1001, qt, bf16),
            ("M=129 K=800 (K % 64 = 32)", (129,), 800, 768, qt, bf16),
        ]
    worst = check_qmm_cases(cases + qmm_f32_cases(), rng)

    times = {}
    for name, m, k, n in (("qkv", 1576, 768, 2304), ("proj", 1576, 768, 768),
                          ("fc1", 1576, 768, 3072), ("fc2", 1576, 3072, 768),
                          ("qkv B=64", 12608, 768, 2304)):
        w = _quant_linear(rng, k, n, G.Q8_0)
        x = torch.randn((m, k), device="cuda").to(bf16)
        k_ms, p_ms = time_pair(
            f"dequant_matmul ViT-B/16 {name} M={m} K={k} N={n} Q8_0 bf16", card,
            lambda: dequant_matmul(x, w), lambda: dequant_matmul_plain(x, w),
        )
        dense = w.dequantize(bf16)  # once, outside the timed loop
        lib = cuda_ms(lambda: torch.matmul(x, dense))
        # x and y in bf16, the weight as Q8_0 blocks (34 bytes per 32)
        b_ms, b_by = bound(2.0 * m * k * n, 2 * m * k + k * n // 32 * 34 + 2 * m * n, "bf16")
        log(f"dequant_matmul {name}: bound {b_ms:.4f} ms ({b_by}), library torch.matmul on "
            f"the weight dequantized once {lib:.4f} ms on {card}")
        times[name] = (k_ms, p_ms, b_ms, b_by, lib)
    return worst, times, time_qmm_f32(card, rng)


def check_flash_attention(card: str):
    from vit_cpp_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for b, nh, t, d, dtype in ((8, 12, 197, 64, torch.bfloat16),
                               (8, 12, 197, 64, torch.float32),
                               (4, 16, 257, 80, torch.bfloat16),
                               (4, 12, 1, 64, torch.bfloat16),
                               (4, 12, 65, 72, torch.bfloat16),
                               (4, 12, 128, 128, torch.bfloat16)):
        q, k, v = (torch.randn((b, nh, t, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got = flash_attention(q, k, v)
        ref = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        if got.shape != q.shape or got.dtype != dtype or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention {(b, nh, t, d)}: bad output")
        err = (got.float() - ref.float()).abs().max().item()
        tol = TOL[dtype]
        log(f"kernel case flash_attention B={b} H={nh} T={t} D={d} {str(dtype)[6:]}: "
            f"max|kernel - plain| = {err:.3e} (tolerance {tol:.0e})")
        if not err <= tol:
            raise AssertionError(f"flash_attention {(b, nh, t, d)}: error {err} > {tol}")
        worst = max(worst, err)
    q, k, v = (torch.randn((8, 12, 197, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    k_ms, p_ms = time_pair(
        "flash_attention ViT-B/16 B=8 H=12 T=197 D=64 bf16", card,
        lambda: flash_attention(q, k, v), lambda: flash_attention_plain(q, k, v),
    )
    lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    b_ms, b_by = attention_bound(8, 197, 768, 2)
    log(f"flash_attention: bound {b_ms:.4f} ms ({b_by}), library "
        f"scaled_dot_product_attention {lib:.4f} ms on {card}")
    return worst, (k_ms, p_ms, b_ms, b_by, lib)


def check_attention_grad(card: str):
    from vit_cpp_tpu_torch.ops.flash_attention import (
        attention_qkv_grad,
        attention_qkv_grad_mma,
        attention_qkv_grad_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, B, T, h, heads, dtype, ToMe sizes
        ("vit-b16 training f32", 32, 197, 768, 12, f32, False),
        ("vit-b16 training bf16", 32, 197, 768, 12, bf16, False),
        ("vit-b16 tome sizes f32", 32, 197, 768, 12, f32, True),
        ("vit-b16 tome sizes bf16", 32, 197, 768, 12, bf16, True),
        ("vit-ti nh=3 d=64", 32, 197, 192, 3, f32, False),
        ("vit-h14 d=80 T=257", 4, 257, 1280, 16, f32, False),
        ("vit-b8 T=785", 4, 785, 768, 12, f32, False),
        ("vit-b8 T=785 B=8 (--patch-size 8 training)", 8, 785, 768, 12, f32, False),
    ]
    # the edges of the tiling (64-row blocks of 16-row warps, chunks of 32
    # (bf16 16) keys or queries, 8-wide steps, d padded to 16), both dtypes
    for dtype in (f32, bf16):
        cases += [
            (f"T=1 {str(dtype)[6:]}", 4, 1, 256, 4, dtype, False),
            (f"T=63 {str(dtype)[6:]}", 4, 63, 256, 4, dtype, False),
            (f"T=64 {str(dtype)[6:]}", 4, 64, 256, 4, dtype, False),
            (f"T=65 sizes {str(dtype)[6:]}", 4, 65, 256, 4, dtype, True),
            (f"T=129 {str(dtype)[6:]}", 4, 129, 256, 4, dtype, False),
            (f"d=72 {str(dtype)[6:]}", 4, 197, 288, 4, dtype, False),
            (f"d=128 {str(dtype)[6:]}", 4, 197, 512, 4, dtype, False),
            (f"d=128 T=65 sizes {str(dtype)[6:]}", 4, 65, 512, 4, dtype, True),
        ]
    main_err = None
    for name, b, t, h, nh, dtype, sized in cases:
        qkv = torch.randn((b, t, 3 * h), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, t, h), generator=gen, device="cuda").to(dtype)
        sizes = (torch.randint(1, 5, (b, t), generator=gen, device="cuda").float()
                 if sized else None)
        got = attention_qkv_grad(qkv, do, nh, sizes=sizes)
        ref = attention_qkv_grad_plain(qkv, do, nh, sizes=sizes)
        torch.cuda.synchronize()
        if got.shape != (b, t, 3 * h) or got.dtype != dtype or not torch.isfinite(got).all():
            raise AssertionError(f"attention_qkv_grad {name}: bad output")
        err = (got.float() - ref.float()).abs().max().item()
        tol = GRAD_TOL[dtype] * ref.float().abs().max().item()
        log(f"kernel case attention_qkv_grad {name:<24} B={b} T={t} h={h} nh={nh}: "
            f"max|kernel - plain| = {err:.3e} (tolerance {tol:.3e} = "
            f"{GRAD_TOL[dtype]:.0e} x max|plain|)")
        if not err <= tol:
            raise AssertionError(f"attention_qkv_grad {name}: error {err} > {tol}")
        if main_err is None:
            main_err = err
    times = {}
    # ViT-B/16 training at B=32; T=785 is the shape of the JAX package's
    # lane path (K2'), B=8 the --patch-size 8 training path's. The mma.sync
    # body the wgmma bodies replaced (f32 and bf16 at d=64) is timed in
    # turns with them.
    for dtype, b, t in ((f32, 32, 197), (bf16, 32, 197), (f32, 4, 785), (f32, 8, 785)):
        qkv = torch.randn((b, t, 2304), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, t, 768), generator=gen, device="cuda").to(dtype)
        k_ms, p_ms = time_pair(
            f"attention_qkv_grad B={b} T={t} h=768 {str(dtype)[6:]}", card,
            lambda: attention_qkv_grad(qkv, do, 12),
            lambda: attention_qkv_grad_plain(qkv, do, 12),
        )
        lib = sdpa_grad_ms(qkv, do, 12)
        b_ms, b_by = k2_bound(b, t, 768, qkv.element_size())
        log(f"attention_qkv_grad B={b} T={t} {str(dtype)[6:]}: bound {b_ms:.4f} ms ({b_by}), "
            f"library scaled_dot_product_attention backward {lib:.4f} ms on {card}")
        r = turns({"wgmma": lambda: attention_qkv_grad(qkv, do, 12),
                   "mma.sync": lambda: attention_qkv_grad_mma(qkv, do, 12)})
        log(f"attention_qkv_grad B={b} T={t} {str(dtype)[6:]} bodies (device ms, in turns) on "
            f"{card}: wgmma {r['wgmma']:.4f}, mma.sync {r['mma.sync']:.4f} "
            f"({r['mma.sync'] / r['wgmma']:.2f}x)")
        times[(dtype, t, b)] = (k_ms, p_ms, b_ms, b_by, lib, r["mma.sync"])
        del qkv, do
    return main_err, times


def slice_parity(f32_path: str, tome: int = 0, tag: str = "slice parity") -> None:
    """The training loss and its gradients on the card (the kernels)
    against the card machine's CPU (the plain versions), full ViT-B/16
    width, B=2, f32; through ToMe merging with `tome`. A V-MoE file adds
    the router's auxiliary losses, and the router and experts to the
    gradients held."""
    from vit_cpp_tpu_torch.engine import detect_hparams
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.parallel.train import cross_entropy_loss

    tag = f"{tag} tome {tome}" if tome else tag
    mf = read_model(f32_path)
    hp = detect_hparams(mf)
    x, y = parity_batch(hp)

    def build(dev):
        params = load_params(mf, torch.float32, hparams=hp, device=dev)
        return (lambda: cross_entropy_loss(params, x.to(dev), y.to(dev), hp, tome=tome)), params

    card_vs_cpu(tag, build)


def parity_batch(hp):
    """The slice-parity batch: B=2 seeded pixels and labels on the CPU."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(
        rng.standard_normal((2, hp.in_chans, hp.img_size, hp.img_size)).astype(np.float32))
    return x, torch.from_numpy(rng.integers(0, hp.num_classes, (2,)))


def card_vs_cpu(tag: str, build) -> list:
    """`build(device)` -> (a loss closure, the tree it is differentiated
    by), on the card and on the CPU: the loss to PARITY_LOSS_RTOL, every
    gradient to PARITY_GRAD_TOL of max|g_cpu|, and 12 attention_qkv + 12
    attention_qkv_grad launches on the card. Returns the CPU gradients."""
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.parallel.train import tree_leaves

    out = {}
    for dev in ("cuda", "cpu"):
        loss_fn, tree = build(dev)
        names, leaves = _named_leaves(tree), tree_leaves(tree)
        for leaf in leaves:
            leaf.requires_grad_(True)
        KERNEL.reset()
        GRAD_KERNEL.reset()
        t0 = time.perf_counter()
        loss = loss_fn()
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (loss.item(), [g.cpu() for g in grads])
        log(f"{tag}: loss and gradients on {dev} in {time.perf_counter() - t0:.2f} s, "
            f"{KERNEL.launches} attention_qkv + {GRAD_KERNEL.launches} attention_qkv_grad launches")
        if dev == "cuda" and (KERNEL.launches, GRAD_KERNEL.launches) != (12, 12):
            raise AssertionError(f"{tag}: the card's step did not run the kernels")
    (l_card, g_card), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    worst, worst_name = 0.0, None
    for name, a, b in zip(names, g_card, g_cpu):
        scale = b.abs().max().item()
        r = (a - b).abs().max().item() / scale if scale else (a - b).abs().max().item()
        if not np.isfinite(r) or r > PARITY_GRAD_TOL:
            raise AssertionError(f"{tag}: {name} gradient off by {r} of max|g_cpu|")
        if r >= worst:
            worst, worst_name = r, name
        log(f"{tag}: grad {name:<24} max|g_card - g_cpu| / max|g_cpu| = {r:.3e}")
    log(f"{tag}: loss card {l_card:.7f} cpu {l_cpu:.7f} (relative {rel_loss:.2e}, "
        f"bound {PARITY_LOSS_RTOL:.0e}); worst gradient {worst_name} {worst:.3e} "
        f"(bound {PARITY_GRAD_TOL:.0e}) over {len(g_cpu)} leaves")
    if not rel_loss <= PARITY_LOSS_RTOL:
        raise AssertionError(f"{tag}: loss off by {rel_loss}")
    return g_cpu


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _named_leaves(v, f"{prefix}{k}.")]
    return [] if tree is None else [prefix[:-1]]


def write_dark_bright(root: str, n_per_class: int = 32, size: int = 224) -> str:
    """Two separable classes of generated images: dark vs bright noise."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for cls, lo, hi in (("aa_dark", 0, 40), ("bb_bright", 210, 255)):
        os.makedirs(os.path.join(root, cls))
        for i in range(n_per_class):
            img = rng.integers(lo, hi, (size, size, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(root, cls, f"{i}.png"))
    return root


def kernel_functions(kernel) -> tuple:
    """The names of the __global__ functions in a kernel's source, which
    the profiler's event names contain: read from the source, so that a
    renamed function is still found."""
    with open(os.path.join(HERE, kernel.source)) as f:
        src = f.read()
    names = []
    for m in re.finditer(r"__global__\s+void\s+", src):
        rest = src[m.end():]
        if rest.startswith("__launch_bounds__"):  # skip its (nested) parentheses
            i, depth = rest.index("("), 0
            while True:
                depth += {"(": 1, ")": -1}.get(rest[i], 0)
                i += 1
                if depth == 0:
                    break
            rest = rest[i:]
        names.append(re.match(r"\s*(\w+)", rest).group(1))
    if not names:
        raise AssertionError(f"no __global__ function found in {kernel.source}")
    return tuple(names)


def device_us(prof, *kernels) -> tuple:
    """(all device us, the device us of each kernel's functions) in a
    torch.profiler run."""
    names = [kernel_functions(k) for k in kernels]
    total, each = 0.0, [0.0] * len(kernels)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        total += us
        for i, fns in enumerate(names):
            if any(fn in e.key for fn in fns):
                each[i] += us
                break
    return total, each


def profile_update(f16: str, data: str) -> None:
    """One ViT-B/16 update at B=32 (the CLI's configuration) under
    torch.profiler: the attention kernels' share of device time."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.finetune import load_dataset
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.finetune import _preprocess_all, _reinit_head
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.parallel.train import create_train_state, train_step

    mf = read_model(f16)
    params, hp = _reinit_head(load_params(mf, torch.float32, device="cuda"), mf.hparams, 2)
    state = create_train_state(params)
    paths, labels, _ = load_dataset(data)
    x = _preprocess_all(paths[:32], hp, 0, "cuda").cuda()
    y = torch.from_numpy(labels[:32]).cuda()
    train_step(state, x, y, hp, smooth=0.1)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, x, y, hp, smooth=0.1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us, (fwd_us, bwd_us) = device_us(prof, KERNEL, GRAD_KERNEL)
    attn_us = fwd_us + bwd_us
    if dev_us <= 0:
        log("profiled update: torch.profiler saw no device time (shares not measured)")
        return
    if fwd_us <= 0 or bwd_us <= 0:
        raise AssertionError(
            f"profiled update: no device time under {kernel_functions(KERNEL)} "
            f"({fwd_us} us) or {kernel_functions(GRAD_KERNEL)} ({bwd_us} us)"
        )
    log(f"profiled update (ViT-B/16 f32 B=32, torch.profiler): {dev_us / 1e3:.2f} ms of device "
        f"time in {wall_us / 1e3:.2f} ms wall (idle share {1 - dev_us / wall_us:.3f}); "
        f"attention_qkv {fwd_us / 1e3:.2f} ms + attention_qkv_grad {bwd_us / 1e3:.2f} ms = "
        f"{attn_us / dev_us:.3f} of device time")
    top = sorted(
        ((getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0), e.key)
         for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA),
        reverse=True,
    )[:8]
    for us, key in top:
        log(f"  device {us / 1e3:8.3f} ms  {key[:100]}")


def finetune_path(f16: str, tmp: str, images_per_class: int = 32):
    """vit_cpp_tpu_torch.cli.finetune on the f16 ViT-B/16 file, then the
    written gguf served by VitEngine. Returns attention_qkv_grad's
    launches in the run."""
    from vit_cpp_tpu_torch.cli import finetune as cli_finetune
    from vit_cpp_tpu_torch.decode import decode_many
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL

    data = write_dark_bright(os.path.join(tmp, "train"), images_per_class)
    out = os.path.join(tmp, "ft.gguf")
    epochs, batch = 3, 32
    updates = epochs * (2 * images_per_class // batch)
    err = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.reset()
    GRAD_KERNEL.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_finetune.main([
            "-m", f16, "-d", data, "-o", out, "-b", str(batch), "--epochs", str(epochs),
            "--augment", "all", "--label-smooth", "0.1", "--ema", "0.99",
            "--ckpt-dir", os.path.join(tmp, "ckpt"), "--device", "cuda",
        ])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (KERNEL.launches, GRAD_KERNEL.launches)
    peak = torch.cuda.max_memory_allocated()
    for line in err.getvalue().splitlines():
        log(f"cli.finetune: {line}")
    if rc != 0:
        raise AssertionError(f"cli.finetune exited {rc}")
    losses = [float(v) for v in re.findall(r"^epoch \d+/\d+: loss (\S+)", err.getvalue(), re.M)]
    timing = re.search(r"([\d.]+) ms per update after the first, ([\d.]+) training images/s",
                       err.getvalue())
    if len(losses) != epochs or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"cli.finetune losses {losses}: not finite and falling")
    if launches != (12 * updates, 12 * updates):
        raise AssertionError(
            f"cli.finetune: {launches[0]} attention_qkv and {launches[1]} attention_qkv_grad "
            f"launches for {updates} updates (want 12 each per update)"
        )
    log(f"fine-tune ViT-B/16 f32 via cli.finetune: {updates} updates of batch {batch} in "
        f"{seconds:.1f} s (load, preprocess, checkpoints and export included); "
        f"{timing.group(1)} ms per update after the first, {timing.group(2)} training "
        f"images/s; losses per epoch {losses}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches[0]} attention_qkv + {launches[1]} "
        f"attention_qkv_grad = 12 + 12 per update")
    profile_update(f16, data)

    engine = VitEngine(out, device="cuda")
    if engine.id2label != {0: "aa_dark", 1: "bb_bright"}:
        raise AssertionError(f"ft.gguf labels {engine.id2label}")
    from vit_cpp_tpu_torch.finetune import load_dataset

    paths, labels, _ = load_dataset(data)
    pixels = torch.stack([engine.preprocess_image(im) for im in decode_many(paths)])
    probs = engine.predict_probs_batch(pixels).cpu().numpy()
    if probs.shape != (len(paths), 2) or not np.isfinite(probs).all():
        raise AssertionError(f"ft.gguf: bad probabilities {probs.shape}")
    top1 = float((probs.argmax(1) == labels).mean())
    log(f"ft.gguf served by VitEngine on the card: labels {engine.id2label}, "
        f"top-1 over the {len(paths)} training images {top1:.3f}")
    return launches[1]


def post(url: str, body: bytes):
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, out = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, out = e.code, {"error": e.read().decode(errors="replace")}
    return status, out, (time.perf_counter() - t0) * 1000.0


def asset_bodies():
    paths = sorted(
        p for p in glob.glob(os.path.join(HERE, "assets", "*"))
        if p.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if len(paths) != 10:
        raise AssertionError(f"expected the 10 images of assets/, found {len(paths)}")
    return paths, [open(p, "rb").read() for p in paths]


def serve(what: str, model: str, mm: str, per_batch: dict, tol: float, images, tome: int = 0,
          after=None):
    """Serve the ten assets from `model` through the daemon built with
    build_engine(mm=mm, tome=tome) and its defaults otherwise; check every
    answer against the f32 engine with the same tome on the same file (on
    `images`, the assets
    decoded once) and each kernel's launches (per_batch: Kernel ->
    launches per device batch); `after(engine)` runs on the served engine
    once the daemon is down. Returns {name: launches}."""
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.server import create_server

    paths, bodies = asset_bodies()
    t0 = time.perf_counter()
    engine, _ = build_engine(model, mm=mm, tome=tome, device="cuda")
    log(f"{what}: engine dtype={engine.dtype} mm={engine.mm_impl} "
        f"attn={engine.attn_impl} fold={engine.params['norm']['scale'] is None} "
        f"on {engine.device}, load {engine.load_ms:.0f} ms")
    httpd, batcher = create_server(engine, port=0, batch=8, max_wait_ms=5.0)
    log(f"{what}: daemon warmed up and bound in {time.perf_counter() - t0:.1f} s "
        f"(port {httpd.server_port}, micro-batch 8)")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        for kernel in per_batch:
            kernel.reset()
        with ThreadPoolExecutor(len(bodies)) as ex:
            results = list(ex.map(lambda b: post(base + "/v1/classify?topk=5", b), bodies))
        torch.cuda.synchronize()
        launches = {kernel.name: kernel.launches for kernel in per_batch}
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        server.join(timeout=30)
    if after is not None:
        after(engine)
    del engine

    ref = VitEngine(model, dtype="f32", mm_impl="xla", attn_impl="xla", tome=tome, device="cuda",
                    verbose=False)
    worst = 0.0
    for path, img, (status, out, ms) in zip(paths, images, results):
        if status != 200:
            raise AssertionError(f"{os.path.basename(path)}: HTTP {status} {out}")
        top = out["topk"]
        if len(top) != 5:
            raise AssertionError(f"{path}: top-5 has {len(top)} entries")
        probs = np.array([e["prob"] for e in top])
        if not (np.isfinite(probs).all() and (np.diff(probs) <= 0).all()):
            raise AssertionError(f"{path}: bad top-5 {probs}")
        pixels = ref.preprocess_image(img)
        want = ref.predict_probs_batch(pixels[None])[0].cpu().numpy()
        err = float(np.abs(probs - want[[e["id"] for e in top]]).max())
        worst = max(worst, err)
        log(f"{what}: request {os.path.basename(path):<14} 200 in {ms:8.1f} ms  "
            f"top-5 {[e['id'] for e in top]}  max|p - p_f32| = {err:.2e}")
    log(f"{what}: top-5 vs f32 engine on the same file: worst {worst:.2e} "
        f"(tolerance {tol:.0e})")
    if worst > tol:
        raise AssertionError(f"{what}: served probabilities off by {worst} > {tol}")
    log(f"{what}: /stats: {json.dumps(stats)}")
    if stats["requests"] != len(bodies):
        raise AssertionError(f"/stats counts {stats['requests']} requests, sent {len(bodies)}")
    for kernel, each in per_batch.items():
        n = launches[kernel.name]
        if n != each * stats["batches"] or n == 0:
            raise AssertionError(
                f"{what}: {kernel.name} launched {n} times for "
                f"{stats['batches']} device batches (want {each} per batch)"
            )
        log(f"{what}: {kernel.name} launches in the served run: {n} "
            f"= {each} x {stats['batches']} device batches")
    lat = sorted(ms for _, _, ms in results)
    log(f"{what}: request latency ms: min {lat[0]:.1f} median "
        f"{lat[len(lat) // 2]:.1f} max {lat[-1]:.1f}")
    return launches


# ViT-g/14 @224 (bench.py's "giant"; Zhai et al., "Scaling Vision
# Transformers"): hidden 1408, 16 heads of d=88, MLP 6144, T=257, 40
# layers, served at 4: the full-size file (~1.0 B parameters) would take
# chip_smoke past its time limit
G14_LAYERS = 40
VIT_G14 = dict(hidden_size=1408, num_hidden_layers=4, num_attention_heads=16, mlp_hidden=6144,
               num_classes=1000, patch_size=14, img_size=224)


def wide_forward(engine, card: str) -> None:
    """The served ViT-H/14 engine (the daemon's defaults) at B=64, the
    BENCH_DETAILS row's batch: finite (64, 1000) probabilities, K1 once
    per layer; the median host ms of 10 forwards, each ended by a
    synchronize, and the median stream-elapsed ms of the same forwards
    between two CUDA events, gaps included (cuda_ms cannot queue a forward
    of ~10^4 launches behind its sleep: the launch queue fills, and the
    host waits on the card); then one forward under torch.profiler: its
    device time, K1's share of it and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL

    layers = engine.hp.num_hidden_layers
    pixels = torch.randn((64, 3, 224, 224), generator=torch.Generator(device="cuda").manual_seed(25),
                         device="cuda")
    KERNEL.reset()
    probs = engine.predict_probs_batch(pixels)
    torch.cuda.synchronize()
    if (tuple(probs.shape) != (64, engine.hp.num_classes) or not torch.isfinite(probs).all()
            or KERNEL.launches != layers):
        raise AssertionError(f"ViT-H/14 B=64: probabilities {tuple(probs.shape)}, "
                             f"{KERNEL.launches} attention_qkv launches (want {layers})")
    times, dev = [], []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        engine.predict_probs_batch(pixels)
        end.record()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    ms = float(np.median(times))
    log(f"forward ViT-H/14 @224 W8A8 bf16 fold B=64 (the served engine; median of 10, host "
        f"clock with sync): {ms:.3f} ms ({64 / ms * 1e3:.1f} img/s, range {min(times):.3f}-"
        f"{max(times):.3f}), stream elapsed {float(np.median(dev)):.3f} ms (events) on {card}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict_probs_batch(pixels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us, (k1_us,) = device_us(prof, KERNEL)
    if dev_us <= 0:
        log("profiled ViT-H/14 forward: torch.profiler saw no device time (shares not measured)")
        return
    log(f"profiled ViT-H/14 W8A8 forward B=64 (torch.profiler): {dev_us / 1e3:.2f} ms of device "
        f"time in {wall_us / 1e3:.2f} ms wall (idle share {1 - dev_us / wall_us:.3f}); "
        f"attention_qkv {k1_us / 1e3:.2f} ms ({k1_us / dev_us:.3f} of device time, "
        f"{k1_us / layers:.1f} us per layer)")


def wide_paths(tmp: str, card: str, images) -> dict:
    """ViT-H/14 @224 (VIT_H14, full depth) and ViT-g/14 @224 (VIT_G14, 4 of
    its 40 layers), f16 files from write_synthetic_model(seed=0), each
    served through serve() at the daemon's defaults (bf16, W8A8, fast fused
    attention, LayerNorm folded, micro-batch 8): every answer within
    PROB_TOL of the f32 engine, K1 once per layer per device batch, on its
    bf16 wgmma body at d=80 / 88; then ViT-H/14's B=64 forward
    (wide_forward). {path: {kernel: launches}}."""
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.testing.synthetic import write_synthetic_model

    t_phase = time.perf_counter()
    out = {}
    for what, geometry, after in (
            ("ViT-H/14 f16 W8A8 daemon", VIT_H14, lambda e: wide_forward(e, card)),
            (f"ViT-g/14 f16 W8A8 daemon ({VIT_G14['num_hidden_layers']} of {G14_LAYERS} layers)",
             VIT_G14, None)):
        path = os.path.join(tmp, what.split()[0].replace("/", "") + "-synthetic-f16.gguf")
        t0 = time.perf_counter()
        write_synthetic_model(path, VitHParams(**geometry), ftype=1, seed=0)
        log(f"checkpoint: {what.split()[0]} @224 synthetic f16 (hidden "
            f"{geometry['hidden_size']}, {geometry['num_hidden_layers']} layers, 16 heads of "
            f"d={geometry['hidden_size'] // 16}) written in {time.perf_counter() - t0:.1f} s, "
            f"{os.path.getsize(path) / 2**20:.0f} MiB")
        out[what] = serve(what, path, "int8", {KERNEL: geometry["num_hidden_layers"]}, PROB_TOL,
                          images, after=after)
        if geometry is VIT_H14:  # ViT-g/14's file stays for g14_paths
            os.remove(path)
    log(f"wide_paths: {time.perf_counter() - t_phase:.1f} s")
    return out


def flagship_forward(q8: str, images) -> None:
    """The serving defaults (int8 W8A8 requantized from Q8_0, LayerNorm
    folded, bf16, fast fused attention) on the Q8_0 file, forward only,
    against the f32 engine on the same file."""
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine

    engine, _ = build_engine(q8, device="cuda")
    pixels = torch.stack([engine.preprocess_image(img) for img in images])
    got = engine.predict_probs_batch(pixels).cpu().numpy()
    del engine
    ref = VitEngine(q8, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda")
    want = ref.predict_probs_batch(pixels).cpu().numpy()
    if got.shape != (10, 1000) or not np.isfinite(got).all():
        raise AssertionError(f"flagship: bad probabilities {got.shape}")
    err = float(np.abs(got - want).max())
    agree = int((got.argmax(1) == want.argmax(1)).sum())
    log(f"flagship Q8_0 int8+fold forward: max|p - p_f32| over 10 x 1000 = "
        f"{err:.2e} (tolerance {FLAGSHIP_TOL:.0e}); top-1 agrees on {agree}/10")
    if err > FLAGSHIP_TOL:
        raise AssertionError(f"flagship: probabilities off by {err} > {FLAGSHIP_TOL}")


def split_head_path() -> int:
    """ops.core.attention(impl="pallas") over 12 layers' worth of ViT-B/16
    q, k, v at B=8: the split-head kernel's own entry point."""
    from vit_cpp_tpu_torch.ops.core import attention
    from vit_cpp_tpu_torch.ops.flash_attention import FLASH_KERNEL

    gen = torch.Generator(device="cuda").manual_seed(2)
    layers = [
        [torch.randn((8, 12, 197, 64), generator=gen, device="cuda").to(torch.bfloat16)
         for _ in range(3)]
        for _ in range(12)
    ]
    FLASH_KERNEL.reset()
    outs = [attention(q, k, v, impl="pallas") for q, k, v in layers]
    torch.cuda.synchronize()
    launches = FLASH_KERNEL.launches
    for (q, k, v), o in zip(layers, outs):
        ref = attention(q, k, v)  # the composed path
        err = (o.float() - ref.float()).abs().max().item()
        if not err <= TOL[torch.bfloat16]:
            raise AssertionError(f"attention(impl='pallas') vs composed: {err}")
    if launches != 12:
        raise AssertionError(f"flash_attention launched {launches} times for 12 calls")
    log(f"split-head attention entry point: 12 calls, {launches} flash_attention "
        "launches, each within 2e-2 of the composed attention")
    return launches


def turns(fns: dict, iters: int = 50) -> dict:
    """Each call's mean device ms, timed in turns: in order, then in
    reverse order, each time the mean of the two."""
    names = list(fns)
    first = {n: cuda_ms(fns[n], iters) for n in names}
    second = {n: cuda_ms(fns[n], iters) for n in reversed(names)}
    return {n: (first[n] + second[n]) / 2 for n in names}


def anatomy_variants(card, out, kernel, shape, names, fn, plain, flops, nbytes, ref_fn,
                     ref_name, lib_fn, lib_name, mma=None):
    """Check and time each variant of a diagnostic's kernel; `full`
    against the port's own kernel (ref_fn) bit for bit, then timed in
    turns with it, the library call and `mma` (name, fn: the mma.sync body
    a wgmma body replaced); the stage split. The first variant is the
    kernel's line, stored in out[kernel.name]."""
    for v in names:
        got, ref = fn(v), plain(v)
        torch.cuda.synchronize()
        if (got.shape != ref.shape or got.dtype != torch.bfloat16
                or not torch.isfinite(got).all()):
            raise AssertionError(f"{kernel.name} {v}: bad output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        tol = ANATOMY_TOL * ref.float().abs().max().item()
        if not err <= tol:
            raise AssertionError(f"{kernel.name} {v}: error {err} > {tol}")
        k_ms, p_ms = time_pair(f"{kernel.name} {v} {shape} bf16", card,
                               lambda: fn(v), lambda: plain(v), iters=10)
        b_ms, b_by = bound(flops(v), nbytes, "bf16")
        log(f"diagnostic {kernel.name} {v:<9} {shape}: max|kernel - plain| = {err:.3e} "
            f"(tolerance {tol:.3e} = {ANATOMY_TOL:.0e} x max|plain|); kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if v == names[0]:
            main = (err, p_ms, b_ms, b_by)
    full = fn(names[0])
    if not torch.equal(full, ref_fn()):
        diff = (full.float() - ref_fn().float()).abs().max().item()
        raise AssertionError(f"{kernel.name} full is not {ref_name}: max difference {diff}")
    t = turns({"full": lambda: fn(names[0]), ref_name: ref_fn, lib_name: lib_fn,
               **dict([mma] if mma else [])})
    log(f"diagnostic {kernel.name} full {shape}: equal to {ref_name} bit for bit; in turns, "
        f"device ms on {card}: full {t['full']:.4f} ms, {ref_name} "
        f"{t[ref_name]:.4f} ms, {lib_name} {t[lib_name]:.4f} ms"
        + (f", {mma[0]} {t[mma[0]]:.4f} ms" if mma else ""))
    out[kernel.name] = (main[0], t["full"], *main[1:], t[lib_name],
                        *([t[mma[0]]] if mma else []))
    split = turns({v: (lambda v=v: fn(v)) for v in names})
    log(f"stage split {kernel.name} {shape} on {card} (device ms, in turns; full "
        f"{split['full']:.4f} ms; "
        "full - variant, ms and share of full): " + "; ".join(
            f"{v} {split['full'] - split[v]:+.4f} ({(split['full'] - split[v]) / split['full']:+.3f})"
            for v in names[1:]))


def check_grad_anatomy(card: str, gen, out: dict) -> None:
    """T2 at its flagship shape (B=64, T=197, ViT-B/16's heads: the bf16
    wgmma body): every variant against its plain version, `full` bit-equal
    to K2 and timed in turns with it, K2's mma.sync body and SDPA's
    backward, the stage split; then `full` bit-equal to K2 at d=72 and 128
    (the mma.sync bodies). Its numbers into out[tg.KERNEL.name]."""
    from vit_cpp_tpu_torch.ops.flash_attention import attention_qkv_grad, attention_qkv_grad_mma
    from vit_cpp_tpu_torch.tools import attn_grad_anatomy as tg

    bf16 = torch.bfloat16
    b, t, h = 64, 197, 768
    qkv = torch.randn((b, t, 3 * h), generator=gen, device="cuda").to(bf16)
    do = torch.randn((b, t, h), generator=gen, device="cuda").to(bf16)
    anatomy_variants(card, out, tg.KERNEL, f"B={b} T={t} h={h}", tg.VARIANTS,
                     lambda v: tg.grad_variant(qkv, do, v, 12),
                     lambda v: tg.grad_variant_plain(qkv, do, v, 12),
                     lambda v: tg.dot_flops(v, b, t, h), 7 * b * t * h * 2,
                     lambda: attention_qkv_grad(qkv, do, 12), "attention_qkv_grad bf16",
                     sdpa_grad_fn(qkv, do, 12), "scaled_dot_product_attention backward",
                     ("attention_qkv_grad mma.sync bf16",
                      lambda: attention_qkv_grad_mma(qkv, do, 12)))
    del qkv, do
    for nh, d in ((4, 72), (4, 128)):
        qkv = torch.randn((2, 197, 3 * nh * d), generator=gen, device="cuda").to(bf16)
        do = torch.randn((2, 197, nh * d), generator=gen, device="cuda").to(bf16)
        if not torch.equal(tg.grad_variant(qkv, do, "full", nh), attention_qkv_grad(qkv, do, nh)):
            raise AssertionError(f"{tg.KERNEL.name} full at d={d} is not attention_qkv_grad bf16")
        log(f"diagnostic {tg.KERNEL.name} full B=2 T=197 nh={nh} d={d}: equal to "
            "attention_qkv_grad bf16 (its mma.sync body) bit for bit")


# T1's d=64 edges (the wgmma body's): one 64-query tile and its neighbours
# (T=1, 63, 64, 65), the resident keys' last length and one past it
# (256, 257: the ring), ViT-B/16's T and the lane shape; 2 and 12 heads
T1_EDGES = [(t, nh) for t in (1, 63, 64, 65, 197, 256, 257, 785) for nh in (2, 12)]


def check_t1_edges(gen) -> float:
    """T1 at d=64 on its edges (T1_EDGES, B=2): every variant of both forms
    against its plain version within ANATOMY_TOL (onedot where T >= 128),
    `full` bit-equal to attention_qkv and to its mma.sync body (the
    check-only entry); the worst error relative to max|plain|."""
    from vit_cpp_tpu_torch.ops.flash_attention import attention_qkv, attention_qkv_mma
    from vit_cpp_tpu_torch.tools import attn_anatomy as ta

    worst = 0.0
    for t, nh in T1_EDGES:
        qkv = torch.randn((2, t, 3 * 64 * nh), generator=gen, device="cuda").to(torch.bfloat16)
        k1 = attention_qkv(qkv, nh, fast=True)
        if not torch.equal(k1, attention_qkv_mma(qkv, nh, fast=True)):
            raise AssertionError(f"attention_qkv T={t} nh={nh}: the two bodies differ")
        for form, fn, plain, arg in (("pair", ta.pair_variant, ta.pair_variant_plain, nh),
                                     ("lane", ta.lane_variant, ta.lane_variant_plain, 64)):
            for v in ta.VARIANTS:
                if v == "onedot" and t < 128:
                    continue
                got, ref = fn(qkv, v, arg).float(), plain(qkv, v, arg).float()
                if v == "full" and not torch.equal(fn(qkv, v, arg), k1):
                    raise AssertionError(f"T1 {form} full T={t} nh={nh} is not attention_qkv")
                err = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
                if not torch.isfinite(got).all() or not err <= ANATOMY_TOL:
                    raise AssertionError(f"T1 {form} {v} T={t} nh={nh}: relative error {err}")
                worst = max(worst, err)
        del qkv, k1
    log(f"diagnostic T1 d=64 edges ({len(T1_EDGES)} shapes x 2 forms x {len(ta.VARIANTS)} "
        f"variants, B=2): every variant within {ANATOMY_TOL:.0e} x max|plain| (worst "
        f"{worst:.3e}); full equal to attention_qkv and its mma.sync body bit for bit")
    return worst


def t1_occupancy(card: str, t: int) -> None:
    """Registers and spills (ptxas, from the build's log) of each d=64 T1
    instantiation and its blocks per SM at T: the fewer of what the
    registers and what the shared memory allow. Shared memory as
    attention_wgmma.cuh's wgmma_smem_bytes gives it (64-row boxes of 8 KB
    for Q and each chunk's K (two each for nomask and onedot's lane form)
    and V (none for onedot), a ring of at most 4 chunks, 1024 bytes for the
    alignment, mxusum's 512-byte ones tile), plus 72 bytes of barriers and
    the 1 KB the card reserves for each block."""
    from vit_cpp_tpu_torch import _build
    from vit_cpp_tpu_torch.tools import attn_anatomy as ta
    from vit_cpp_tpu_torch.tools.grad_variants import parse_report
    from vit_cpp_tpu_torch.tools.sass_census import ptxas_usage

    usage = {}
    for name, regs in ptxas_usage(_build.build_log).items():
        m = re.search(r"anatomy_wgmmaILi(\d+)ELi(\d+)E", name)
        if m:
            usage[(int(m.group(1)), int(m.group(2)))] = regs
    sm_bytes = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_multiprocessor",
                       233472)
    slots = min((t + 63) // 64, 4)
    kernels = [(v, i, 8 if v == "nomask" else 0) for i, v in enumerate(ta.VARIANTS[:-1])]
    kernels += [("onedot pair", 7, 4), ("onedot lane", 7, 8)]
    parts = []
    for label, i, nks in kernels:
        boxes = nks // 4 if nks else 1
        smem = (1024 + 8192 * (boxes + (boxes + (i != 7)) * slots)
                + (512 if label == "mxusum" else 0))
        regs, st, ld = usage.get((i, nks), (-1, -1, -1))
        by_regs = 65536 // (128 * ((regs + 7) // 8 * 8)) if regs > 0 else 0
        blocks = min(by_regs, sm_bytes // (smem + 72 + 1024), 16)
        parts.append(f"{label} {regs} registers, spills {st}/{ld} B, {smem} B shared, "
                     f"{blocks} blocks per SM")
    notes = sorted({f"{code} {m.group(0)}" for code, name in parse_report(_build.build_log)[1]
                    for m in [re.search(r"(?<![A-Za-z_])(anatomy|attention)_wgmmaI\w+?EE", name)] if m})
    log(f"diagnostic T1 d=64 occupancy at T={t} on {card} ({sm_bytes} B of shared memory an "
        "SM): " + "; ".join(parts) + "; ptxas's C75xx notes on the wgmma kernels: "
        + (", ".join(notes) or "none"))


def check_fwd_anatomy(card: str, gen, out: dict) -> None:
    """T1 at its flagship shapes (pair B=128 T=197, lane B=8 T=785, ViT-B/16's
    heads: the bf16 wgmma body): every variant against its plain version,
    `full` bit-equal to K1 and timed in turns with it, K1's mma.sync body
    and SDPA, the stage split and the occupancy of each variant; then
    `full` bit-equal to K1 at d=72, 32 and 128 (the mma.sync body). Its
    numbers into out[kernel name]."""
    from vit_cpp_tpu_torch.ops.flash_attention import attention_qkv, attention_qkv_mma
    from vit_cpp_tpu_torch.tools import attn_anatomy as ta

    bf16 = torch.bfloat16
    for kernel, b, t, h, fn in (
        (ta.PAIR_KERNEL, 128, 197, 768, lambda x, v: ta.pair_variant(x, v, 12)),
        (ta.LANE_KERNEL, 8, 785, 768, lambda x, v: ta.lane_variant(x, v, 64)),
    ):
        qkv = torch.randn((b, t, 3 * h), generator=gen, device="cuda").to(bf16)
        plain = {ta.PAIR_KERNEL: lambda v: ta.pair_variant_plain(qkv, v, 12),
                 ta.LANE_KERNEL: lambda v: ta.lane_variant_plain(qkv, v, 64)}[kernel]
        anatomy_variants(card, out, kernel, f"B={b} T={t} h={h}", ta.VARIANTS,
                         lambda v: fn(qkv, v), plain, lambda v: ta.dot_flops(v, b, t, h),
                         4 * b * t * h * 2, lambda: attention_qkv(qkv, 12, fast=True),
                         "attention_qkv fast bf16", sdpa_fn(qkv, 12),
                         "scaled_dot_product_attention",
                         ("attention_qkv mma.sync fast bf16",
                          lambda: attention_qkv_mma(qkv, 12, fast=True)))
        t1_occupancy(card, t)
        del qkv
    for form, nh, d in (("pair", 4, 72), ("pair", 4, 128), ("lane", 4, 32), ("lane", 2, 128)):
        qkv = torch.randn((2, 197, 3 * nh * d), generator=gen, device="cuda").to(bf16)
        got = ta.pair_variant(qkv, "full", nh) if form == "pair" else ta.lane_variant(qkv, "full", d)
        if not torch.equal(got, attention_qkv_mma(qkv, nh, fast=True)):
            raise AssertionError(f"T1 {form} full at d={d} is not K1's mma.sync body")
        log(f"diagnostic T1 {form} full B=2 T=197 nh={nh} d={d}: equal to attention_qkv "
            "(its mma.sync body) bit for bit")


def check_diagnostics(card: str) -> dict:
    """Every variant of the three tools' kernels against its plain version
    at the tools' flagship shapes, timed; the anatomies' `full` against K1
    / K2 (bit for bit, then timed in turns with them, their mma.sync
    bodies and the library call) and their stage splits. Returns {kernel
    name: (err of the main variant, kernel ms, plain ms, bound ms, bound
    by, library ms[, mma.sync ms])}."""
    from vit_cpp_tpu_torch.tools import probe_int8_dot as tp
    from vit_cpp_tpu_torch.tools import time_ms

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    out = {}

    check_fwd_anatomy(card, gen, out)
    check_t1_edges(gen)
    check_grad_anatomy(card, gen, out)

    n = tp.M
    a8 = torch.randint(-127, 128, (n, n), generator=gen, device="cuda").to(torch.int8)
    b8 = torch.randint(-127, 128, (n, n), generator=gen, device="cuda").to(torch.int8)
    got = tp.dot(a8, b8)
    if not torch.equal(got, tp.dot_plain(a8, b8)):
        raise AssertionError("probe_int8_dot: the int8 product is not exact")
    ab, bb = a8.to(bf16), b8.to(bf16)
    got, ref = tp.dot(ab, bb), tp.dot_plain(ab, bb)
    err = (got - ref).abs().max().item()
    if not err <= PROBE_BF16_TOL * ref.abs().max().item():
        raise AssertionError(f"probe_int8_dot bf16: error {err}")
    rows = {}
    for kind, x, y, lib_fn, nbytes in (
        ("int8", a8, b8, lambda: torch._int_mm(a8, b8), (1 + 1 + 4) * n * n),
        ("bf16", ab, bb, lambda: torch.matmul(ab, bb), (2 + 2 + 4) * n * n),
    ):
        # a ~30 us call: timed as the tool times it, a CUDA graph of the
        # chain (an eager chain measures the wrapper's launch cost); in
        # turns: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (time_ms(f, 200) for f in (
            lambda: tp.dot_plain(x, y), lambda: tp.dot(x, y),
            lambda: tp.dot(x, y), lambda: tp.dot_plain(x, y)))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"timing probe_int8_dot {kind} {n}^3 (CUDA graph of 200 calls) on {card}: "
            f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms per call")
        lib = time_ms(lib_fn, 200)
        b_ms, b_by = bound(2.0 * n ** 3, nbytes, kind)
        rate = 2.0 * n ** 3 / (k_ms / 1e3) / 1e12
        log(f"diagnostic probe_int8_dot {kind} {n}^3: {rate:.1f} T{'OP' if kind == 'int8' else 'FLOP'}/s "
            f"in the kernel ({k_ms:.4f} ms), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"library {'torch._int_mm' if kind == 'int8' else 'torch.matmul'} {lib:.4f} ms")
        rows[kind] = (k_ms, p_ms, b_ms, b_by, lib)
    log(f"diagnostic probe_int8_dot: int8 exact; bf16 max|kernel - plain| = {err:.3e}; "
        f"int8 : bf16 kernel rate {rows['bf16'][0] / rows['int8'][0]:.2f}x on {card}")
    # where a 1024^3 call's time goes: the same call with one 128-byte K
    # step (launch, the ring's first fill, the epilogue), the K steps, and
    # C's write alone
    c32 = torch.empty((n, n), dtype=torch.int32, device="cuda")
    short = {"int8": (a8[:, :128].contiguous(), b8[:128].contiguous()),
             "bf16": (ab[:, :64].contiguous(), bb[:64].contiguous())}
    bt8 = b8.t().contiguous()
    if not torch.equal(tp.dot_nk(a8, bt8), tp.dot_plain(a8, b8)):
        raise AssertionError("probe_int8_dot: the int8 product with B given (N, K) is not exact")
    t = {f: time_ms(fn, 200) for f, fn in (
        ("int8 K=128", lambda: tp.dot(*short["int8"])), ("bf16 K=64", lambda: tp.dot(*short["bf16"])),
        ("int8 (N, K)", lambda: tp.dot_nk(a8, bt8)),
        ("torch.mm f32 out", lambda: torch.mm(ab, bb, out_dtype=torch.float32)),
        ("C write", lambda: c32.fill_(7)))}
    log(f"diagnostic probe_int8_dot {n}^3 on {card}, device ms (CUDA graph of 200 calls): one K "
        f"step int8 {t['int8 K=128']:.4f} / bf16 {t['bf16 K=64']:.4f} against the whole K "
        f"{rows['int8'][0]:.4f} / {rows['bf16'][0]:.4f} (8 / 16 steps: "
        f"{(rows['int8'][0] - t['int8 K=128']) / 7 * 1e3:.2f} / "
        f"{(rows['bf16'][0] - t['bf16 K=64']) / 15 * 1e3:.2f} us a step); int8 with B given "
        f"(N, K) {t['int8 (N, K)']:.4f}; torch.mm with an f32 output {t['torch.mm f32 out']:.4f}; "
        f"C's write alone (fill_) {t['C write']:.4f}")
    del c32, short, bt8
    out[tp.KERNEL.name] = (0.0, *rows["int8"])
    out[f"{tp.KERNEL.name} bf16"] = rows["bf16"]
    del a8, b8, ab, bb
    out[f"{tp.KERNEL.name} w8a8"] = probe_w8a8_shapes(card, gen)
    return out


# The W8A8 linears of ViT-B/16 at B=64 (M = 64 x 197 tokens): (K, N)
W8A8_B64_M = 64 * 197
W8A8_LINEARS = {"qkv": (768, 2304), "proj": (768, 768), "fc1": (768, 3072), "fc2": (3072, 768)}


def probe_w8a8_shapes(card: str, gen) -> dict:
    """T3 at the W8A8 linears' shapes of a B=64 batch: int8 exact (B given
    (K, N) and, as a W8A8 kernel keeps its weights, (N, K)), bf16 within
    PROBE_BF16_TOL; kernel, plain and library calls timed in turns, each
    beside its bound. {linear: {"int8": times, "int8_nk": times, "bf16":
    times}}, times as (ms, plain ms, bound ms, bound by, library ms)."""
    from vit_cpp_tpu_torch.tools import probe_int8_dot as tp

    m, out = W8A8_B64_M, {}
    for name, (k, n) in W8A8_LINEARS.items():
        a8 = torch.randint(-127, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
        b8 = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
        bt8 = b8.t().contiguous()
        ab, bb = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
        ref8 = tp.dot_plain(a8, b8)
        if not torch.equal(tp.dot(a8, b8), ref8) or not torch.equal(tp.dot_nk(a8, bt8), ref8):
            raise AssertionError(f"probe_int8_dot {name}: the int8 product is not exact")
        got, ref = tp.dot(ab, bb), tp.dot_plain(ab, bb)
        err = (got - ref).abs().max().item()
        if got.shape != (m, n) or not err <= PROBE_BF16_TOL * ref.abs().max().item():
            raise AssertionError(f"probe_int8_dot {name} bf16: error {err}")
        del ref8, got, ref
        c32 = torch.empty((m, n), dtype=torch.int32, device="cuda")
        t = turns({
            "int8": lambda: tp.dot(a8, b8), "int8 (N, K)": lambda: tp.dot_nk(a8, bt8),
            "torch._int_mm": lambda: torch._int_mm(a8, b8), "int8 plain": lambda: tp.dot_plain(a8, b8),
            "bf16": lambda: tp.dot(ab, bb), "torch.matmul": lambda: torch.matmul(ab, bb),
            "torch.mm f32 out": lambda: torch.mm(ab, bb, out_dtype=torch.float32),
            "bf16 plain": lambda: tp.dot_plain(ab, bb), "C write": lambda: c32.fill_(7),
        })
        ops = 2.0 * m * k * n
        b8_ms, b8_by = bound(ops, (m * k + k * n) * 1 + m * n * 4, "int8")
        bb_ms, bb_by = bound(ops, (m * k + k * n) * 2 + m * n * 4, "bf16")
        out[name] = {
            "int8": (t["int8"], t["int8 plain"], b8_ms, b8_by, t["torch._int_mm"]),
            "int8_nk": (t["int8 (N, K)"], t["int8 plain"], b8_ms, b8_by, t["torch._int_mm"]),
            "bf16": (t["bf16"], t["bf16 plain"], bb_ms, bb_by, t["torch.matmul"]),
        }
        log(f"diagnostic probe_int8_dot w8a8 B=64 {name} (M={m} K={k} N={n}) on {card}, device "
            f"ms in turns: int8 {t['int8']:.4f} (B given (N, K): {t['int8 (N, K)']:.4f}; bound "
            f"{b8_ms:.4f}, {b8_by}; torch._int_mm {t['torch._int_mm']:.4f}; plain "
            f"{t['int8 plain']:.4f}); bf16 {t['bf16']:.4f} (bound {bb_ms:.4f}, {bb_by}; "
            f"torch.matmul {t['torch.matmul']:.4f}, torch.mm with an f32 output "
            f"{t['torch.mm f32 out']:.4f}; plain {t['bf16 plain']:.4f}); C's 4-byte write alone "
            f"(fill_) {t['C write']:.4f}; exact int8, bf16 max|kernel - plain| {err:.3e}")
        log(f"diagnostic probe_int8_dot w8a8 B=64 {name}: int8 : bf16 kernel-time ratio "
            f"{t['bf16'] / t['int8']:.3f}x (B given (N, K): {t['bf16'] / t['int8 (N, K)']:.3f}x)")
        del a8, b8, bt8, ab, bb, c32
    return out


def diagnostics_path() -> dict:
    """The three tools' entry points as a user runs them, at their
    flagship flags; {kernel name: launches}."""
    from vit_cpp_tpu_torch.tools import attn_anatomy as ta
    from vit_cpp_tpu_torch.tools import attn_grad_anatomy as tg
    from vit_cpp_tpu_torch.tools import probe_int8_dot as tp

    runs = [
        ("attn_anatomy --kernel pair", ta.main,
         ["--kernel", "pair", "--t", "197", "--h", "768", "--b", "128"], ta.VARIANTS),
        ("attn_anatomy --kernel lane", ta.main,
         ["--t", "785", "--h", "768", "--b", "8", "--w", "3"], ta.VARIANTS),
        ("attn_grad_anatomy", tg.main, ["--t", "197", "--h", "768", "--b", "64"], tg.VARIANTS),
        ("probe_int8_dot", tp.main, [], ("exact=True", "in-kernel rates")),
    ]
    kernels = (ta.PAIR_KERNEL, ta.LANE_KERNEL, tg.KERNEL, tp.KERNEL)
    for kernel in kernels:
        kernel.reset()
    for label, tool_main, argv, expect in runs:
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = tool_main(argv)
        lines = text.getvalue().splitlines()
        for line in lines:
            log(f"tool {label}: {line}")
        log(f"tool {label}: {time.perf_counter() - t0:.1f} s")
        if rc != 0 or not all(any(e in line for line in lines) for e in expect):
            raise AssertionError(f"tool {label}: exit {rc}, output {lines}")
    torch.cuda.synchronize()
    launches = {kernel.name: kernel.launches for kernel in kernels}
    chain = ta.ITERS + 3  # each timing: three warm-up calls, then the chain
    want = {ta.PAIR_KERNEL.name: len(ta.VARIANTS) * chain,
            ta.LANE_KERNEL.name: len(ta.VARIANTS) * chain,
            tg.KERNEL.name: len(tg.VARIANTS) * (tg.ITERS + 3),
            tp.KERNEL.name: 1 + 2 * (tp.ITERS + 3)}
    if launches != want:
        raise AssertionError(f"tools: launches {launches}, want {want}")
    log(f"tools: launches {launches}")
    return launches


def forward_phase(q8: str, card: str, dtype: str) -> None:
    """The Q8_0 file's VitEngine (bf16 or f32, fused fast attention, fold
    off) at B=8 and B=64 with --mm pallas (the dequantizing kernel; f32
    runs its f32 body) and --mm xla (dequantize, then cuBLAS, TF32 off):
    the median of 20 forwards (f32: 10) on the host clock, each ended by a
    synchronize, taken in turns with the other, and the device ms per
    forward by cuda_ms; the two within Q8_PROB_TOL (f32: CLI_PROB_TOL).
    Then one --mm pallas forward at B=64 under torch.profiler: the two
    kernels' share of its device time and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL

    engines = {mm: VitEngine(q8, dtype=dtype, attn_impl="pallas-fast", mm_impl=mm,
                             device="cuda") for mm in ("pallas", "xla")}
    tol, passes = (Q8_PROB_TOL, 2) if dtype == "bf16" else (CLI_PROB_TOL, 1)
    gen = torch.Generator(device="cuda").manual_seed(6)
    batches = {b: torch.randn((b, 3, 224, 224), generator=gen, device="cuda") for b in (8, 64)}
    for b, pixels in batches.items():
        probs = {mm: engine.predict_probs_batch(pixels) for mm, engine in engines.items()}
        times = {mm: [] for mm in engines}
        # in turns (pallas, xla, xla, pallas), 5 forwards each: the host's
        # share of a B=8 forward drifts between calls
        for mm in ("pallas", "xla", "xla", "pallas") * passes:
            engine = engines[mm]
            engine.predict_probs_batch(pixels)
            torch.cuda.synchronize()
            for _ in range(5):
                t0 = time.perf_counter()
                engine.predict_probs_batch(pixels)
                torch.cuda.synchronize()
                times[mm].append((time.perf_counter() - t0) * 1e3)
        ms = {mm: float(np.median(t)) for mm, t in times.items()}
        dev = {mm: cuda_ms(lambda e=engine: e.predict_probs_batch(pixels), iters=10)
               for mm, engine in engines.items()}
        err = (probs["pallas"] - probs["xla"]).abs().max().item()
        log(f"forward Q8_0 ViT-B/16 {dtype} fold off B={b} (median of {10 * passes} in turns, "
            f"host clock with sync; device by cuda_ms): --mm pallas {ms['pallas']:.3f} ms "
            f"({b / ms['pallas'] * 1e3:.0f} img/s, range {min(times['pallas']):.3f}-"
            f"{max(times['pallas']):.3f}, device {dev['pallas']:.3f}), --mm xla "
            f"{ms['xla']:.3f} ms ({b / ms['xla'] * 1e3:.0f} img/s, range "
            f"{min(times['xla']):.3f}-{max(times['xla']):.3f}, device {dev['xla']:.3f}); "
            f"max|p_pallas - p_xla| = {err:.2e} (tolerance {tol:.0e}) on {card}")
        if not (torch.isfinite(probs["pallas"]).all() and err <= tol):
            raise AssertionError(f"{dtype} forward B={b}: --mm pallas vs xla probabilities "
                                 f"off by {err}")

    engine, pixels = engines["pallas"], batches[64]
    engine.predict_probs_batch(pixels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict_probs_batch(pixels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us, (k4_us, k1_us) = device_us(prof, QMM_KERNEL, KERNEL)
    if dev_us <= 0:
        log(f"profiled {dtype} forward: torch.profiler saw no device time (shares not measured)")
        return
    log(f"profiled {dtype} --mm pallas forward B=64 (torch.profiler): {dev_us / 1e3:.2f} ms of "
        f"device time in {wall_us / 1e3:.2f} ms wall (idle share {1 - dev_us / wall_us:.3f}); "
        f"dequant_matmul {k4_us / 1e3:.2f} ms ({k4_us / dev_us:.3f}), attention_qkv "
        f"{k1_us / 1e3:.2f} ms ({k1_us / dev_us:.3f}) of device time")


# Runs `python -m MODULE ARGS` as a user does, without JAX or the JAX
# package; `--tf32` first switches the process's TF32 flags on before the
# module runs, as a caller's setting would be.
_RUN_MODULE = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["vit_cpp_tpu"] = None
args = sys.argv[1:]
if args[0] == "--tf32":
    import torch
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    args = args[1:]
sys.argv = args
runpy.run_module(args[0], run_name="__main__", alter_sys=True)
"""


def run_module(*args: str, timeout: int = 300) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", _RUN_MODULE, *args], cwd=HERE, capture_output=True,
        text=True, timeout=timeout, env=dict(os.environ, PYTHONPATH=HERE),
    )


def _flags_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on


def vit_cli(f16: str, card: str) -> None:
    """`python -m vit_cpp_tpu_torch.cli.vit -m F16 -i assets/magpie.jpeg
    -k 5` with the process's TF32 flags on: the whole console surface, its
    top-5 lines equal to the in-process card engine's (made with TF32 on
    in this process too), and that f32 engine's 1000 probabilities within
    CLI_PROB_TOL of the card machine's CPU engine on the same pixels. An
    engine asked for "high" (TF32 on) is the control: it lands further
    from the CPU, so the f32 engine did turn TF32 off itself."""
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.io.image import load_image_rgb

    magpie = os.path.join(HERE, "assets", "magpie.jpeg")
    t0 = time.perf_counter()
    r = run_module("--tf32", "vit_cpp_tpu_torch.cli.vit", "-m", f16, "-i", magpie, "-k", "5")
    seconds = time.perf_counter() - t0
    for line in (r.stdout + r.stderr).splitlines():
        log(f"cli.vit: {line}")
    if r.returncode != 0:
        raise AssertionError(f"cli.vit exited {r.returncode}")
    out = r.stdout.splitlines()
    want = [f"vit_model_load: loading model from '{f16}' - please wait",
            "vit_model_load: hidden_size            = 768",
            "vit_model_load: num_hidden_layers      = 12",
            "vit_model_load: num_attention_heads    = 12",
            "vit_model_load: patch_size             = 16",
            "vit_model_load: img_size               = 224",
            "vit_model_load: num_classes            = 1000",
            "vit_model_load: ftype                  = 1",
            "vit_model_load: qntvr                  = 0"]
    if out[:9] != want or not re.match(r"vit_model_load: model size = +[\d.]+ MB / num tensors = 152$",
                                       out[9]):
        raise AssertionError(f"cli.vit: load echo {out[:10]}")
    if out[10:12] != [f"load_image_from_file: loaded image '{magpie}' (500 x 470)",
                      "processed, out dims : (224 x 224)"] or len(out) != 17:
        raise AssertionError(f"cli.vit: image lines {out[10:]}")
    err = r.stderr
    for line in ("main: seed = ", "main: n_threads = ", "vit_image_preprocess: scale = 2.232143"):
        if line not in err:
            raise AssertionError(f"cli.vit: no {line!r} on stderr")
    times = {k: float(v) for k, v in re.findall(r"main: +(model load|processing|total) time += +([\d.]+) ms", err)}
    if len(times) != 3:
        raise AssertionError(f"cli.vit: timing lines {times}")

    img = load_image_rgb(magpie)
    _flags_tf32(True)  # the process asks for TF32; the f32 engine must not use it
    try:
        engine = VitEngine(f16, device="cuda", verbose=False)
        top = engine.classify_file(magpie, topk=5, verbose=False)
        pixels = engine.preprocess_image(img)[None]
        p_card = engine.predict_probs_batch(pixels)[0].cpu().numpy()
        f_card = engine.features_batch(pixels)[0].cpu().numpy()
        del engine
        tf32 = VitEngine(f16, matmul_precision="high", device="cuda", verbose=False)
        p_tf32 = tf32.predict_probs_batch(pixels)[0].cpu().numpy()
        f_tf32 = tf32.features_batch(pixels)[0].cpu().numpy()
        del tf32
        flags_after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        _flags_tf32(False)
    if flags_after != (True, True):
        raise AssertionError(f"the engines left the process's TF32 flags at {flags_after}")
    lines = [f" > {label} : {prob:.2f}" for _, prob, label in top]
    if out[12:] != lines:
        raise AssertionError(f"cli.vit top-5 {out[12:]} != the card engine's {lines}")
    cpu = VitEngine(f16, device="cpu", verbose=False)
    p_cpu = cpu.predict_probs_batch(pixels.cpu())[0].numpy()
    f_cpu = cpu.features_batch(pixels.cpu())[0].numpy()
    pix_err = (cpu.preprocess_image(img) - pixels[0].cpu()).abs().max().item()
    del cpu
    err, err_tf32 = float(np.abs(p_card - p_cpu).max()), float(np.abs(p_tf32 - p_cpu).max())
    scale = float(np.abs(f_cpu).max())
    ferr = float(np.abs(f_card - f_cpu).max()) / scale
    ferr_tf32 = float(np.abs(f_tf32 - f_cpu).max()) / scale
    log(f"cli.vit ViT-B/16 f32 with TF32 on in the process: rc 0, 17 stdout lines, top-5 equal to "
        f"the card engine's; model load {times['model load']:.2f} ms, processing "
        f"{times['processing']:.2f} ms, total {times['total']:.2f} ms, {seconds:.1f} s with the "
        f"interpreter's start, on {card}")
    log(f"cli.vit f32 card engine vs the CPU engine, same pixels: max|p_card - p_cpu| over 1000 = "
        f"{err:.3e} (tolerance {CLI_PROB_TOL:.0e}); features max|f_card - f_cpu| / max|f| = "
        f"{ferr:.3e}; the TF32 control (matmul_precision='high'): max|p - p_cpu| = {err_tf32:.3e}, "
        f"features {ferr_tf32:.3e}; preprocessing card vs CPU max|x| difference {pix_err:.3e}")
    if not err <= CLI_PROB_TOL:
        raise AssertionError(f"cli.vit: f32 card probabilities off the CPU's by {err}")
    if not ferr < ferr_tf32:
        raise AssertionError("cli.vit: the f32 engine is no closer to the CPU than a TF32 engine")


# vit_serve's `cli.serve` stdout per configuration ("vit-serve defaults",
# "vit-serve --mm pallas"), the unsharded runs of mesh_paths' --mesh 1x1
SERVE_STDOUT = {}


def vit_serve(f16: str, q8: str, card: str) -> dict:
    """`python -m vit_cpp_tpu_torch.cli.serve` over the ten assets at
    batch 8: at its defaults on the f16 file, then with --mm pallas on the
    Q8_0 file in bf16 and in f32 (K4's f32 body). Each top-1 probability
    within PROB_TOL / Q8_PROB_TOL / CLI_PROB_TOL of the f32 engine (mm=xla,
    attn=xla) on the same file; labels equal wherever that engine's top-two
    gap exceeds the tolerance. The same files through serve_files in this
    process count the launches (12 attention_qkv per batch, then 49
    dequant_matmul + 12). Then, for the first two, images/s of serve_files
    at batch 64 over 320 files, decoding on one thread and on one per core.
    Returns {path: {kernel name: launches}}."""
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL
    from vit_cpp_tpu_torch.serve import serve_files, throughput

    paths, _ = asset_bodies()
    images = load_images_rgb_batch(paths)
    out = {}
    for what, model, flags, per_batch, tol in (
        ("vit-serve defaults", f16, [], {KERNEL: 12}, PROB_TOL),
        ("vit-serve --mm pallas", q8, ["--mm", "pallas"], {QMM_KERNEL: 49, KERNEL: 12}, Q8_PROB_TOL),
        # f32 activations: every block linear and the head on K4's f32 body
        ("vit-serve --dtype f32 --mm pallas", q8, ["--dtype", "f32", "--mm", "pallas"],
         {QMM_KERNEL: 49, KERNEL: 12}, CLI_PROB_TOL),
    ):
        r = run_module("vit_cpp_tpu_torch.cli.serve", "-m", model, *paths, "-b", "8", *flags)
        SERVE_STDOUT[what] = r.stdout  # mesh_paths compares --mesh 1x1 with it
        for line in r.stderr.splitlines():
            log(f"{what}: {line}")
        rows = [line.split("\t") for line in r.stdout.splitlines()]
        if r.returncode != 0 or len(rows) != 10 or [row[0] for row in rows] != paths:
            raise AssertionError(f"{what}: exit {r.returncode}, stdout {r.stdout!r}")
        summary = re.search(r"serve: 10/10 images in ([\d.]+)s = ([\d.]+) images/sec", r.stderr)
        if not summary:
            raise AssertionError(f"{what}: no summary line")

        ref = VitEngine(model, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda",
                        verbose=False)
        want = ref.predict_probs_batch(ref.preprocess_images(images)).cpu().numpy()
        del ref
        engine, _ = build_engine(model, dtype="f32" if "f32" in flags else "bf16",
                                 mm="pallas" if flags else "int8", device="cuda")
        for kernel in per_batch:
            kernel.reset()
        got = list(serve_files(engine, paths, batch=8, keep_probs=True))
        torch.cuda.synchronize()
        launches = {kernel.name: kernel.launches for kernel in per_batch}
        for kernel, each in per_batch.items():
            if launches[kernel.name] != 2 * each:
                raise AssertionError(f"{what}: {kernel.name} launched {launches[kernel.name]} "
                                     f"times for 2 batches (want {each} per batch)")
        worst, checked = 0.0, 0
        for (path, label, prob), res, p in zip(rows, got, want):
            err = float(np.abs(res.probs - p).max())
            worst = max(worst, err)
            top2 = np.sort(p)[-2:]
            if top2[1] - top2[0] > tol:  # a clear top-1: the labels must agree
                checked += 1
                want_label = engine.id2label.get(int(p.argmax()))
                if label != want_label or res.top1 != int(p.argmax()):
                    raise AssertionError(f"{what}: {path} labelled {label}, f32 {want_label}")
            if abs(float(prob) - p[res.top1]) > tol + 0.005:  # printed to 2 places
                raise AssertionError(f"{what}: {path} printed {prob}, f32 {p[res.top1]}")
        log(f"{what}: rc 0, 10 lines; serve_files probabilities vs the f32 engine worst "
            f"{worst:.2e} over 10 x 1000 (tolerance {tol:.0e}); labels checked where the f32 "
            f"top-two gap exceeds it: {checked}/10; launches {launches} = "
            f"{ {k.name: v for k, v in per_batch.items()} } x 2 batches; the CLI's own "
            f"{summary.group(2)} images/s over 10 files (first batches included) on {card}")
        if worst > tol:
            raise AssertionError(f"{what}: probabilities off by {worst} > {tol}")
        out[what] = launches
        if "f32" in flags:  # its batch throughput is not a serving configuration's
            del engine
            continue

        many = paths * 32
        throughput(engine, paths, batch=64)  # warm: the B=64 shapes
        rates = {1: [], 0: []}
        for n in (1, 0, 0, 1):  # in turns: one decode thread, one per core
            rates[n].append(throughput(engine, many, batch=64, decode_threads=n))
        log(f"{what}: serve_files throughput at batch 64 over 320 files (host clock, in turns): "
            f"{np.mean(rates[1]):.1f} img/s decoding on one thread {rates[1]}, "
            f"{np.mean(rates[0]):.1f} img/s on {os.cpu_count()} {rates[0]} on {card}")
        stage_ms(what, engine, many[:64], card)
        del engine
    return out


def stage_ms(what: str, engine, paths, card: str) -> None:
    """Where one batch's time goes in serve_files: each stage alone on the
    same 64 files, median of 3 (host clock, each ended by a sync)."""
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch

    def median_ms(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    images = load_images_rgb_batch(paths)
    pixels = engine.preprocess_images(images)
    ms = {
        "decode, 1 thread": median_ms(lambda: load_images_rgb_batch(paths, n_threads=1)),
        f"decode, {os.cpu_count()} threads": median_ms(lambda: load_images_rgb_batch(paths)),
        "preprocess": median_ms(lambda: engine.preprocess_images(images)),
        "forward": median_ms(lambda: engine.predict_probs_batch(pixels).cpu()),
    }
    log(f"{what}: one batch of 64 by stage, ms: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()) + f" on {card}")


def embeddings(f16: str, card: str) -> dict:
    """embed_files at the serving defaults (bf16, int8, fold on) against
    the unfolded f32 card engine's features_batch; folded and unfolded f32
    engines' features; one POST /v1/embed to the defaults' daemon against
    embed_file on the same bytes. Returns {path: {kernel name: launches}}."""
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.serve import embed_files
    from vit_cpp_tpu_torch.server import create_server

    paths, bodies = asset_bodies()
    images = load_images_rgb_batch(paths)
    engine, _ = build_engine(f16, device="cuda")
    KERNEL.reset()
    vecs = [e.vector for e in embed_files(engine, paths, batch=8)]
    torch.cuda.synchronize()
    launches = {KERNEL.name: KERNEL.launches}
    if launches[KERNEL.name] != 24 or any(v is None or v.shape != (768,) for v in vecs):
        raise AssertionError(f"embed_files: launches {launches}, shapes "
                             f"{[None if v is None else v.shape for v in vecs]}")
    unfolded = VitEngine(f16, device="cuda", verbose=False)
    pixels = unfolded.preprocess_images(images)
    f_ref = unfolded.features_batch(pixels).cpu().numpy()
    del unfolded
    folded = VitEngine(f16, fold_ln=True, device="cuda", verbose=False)
    f_fold = folded.features_batch(pixels).cpu().numpy()
    del folded
    scale = float(np.abs(f_ref).max())
    got = np.stack(vecs)
    err = float(np.abs(got - f_ref).max()) / scale
    cos = (got * f_ref).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(f_ref, axis=1)
    fold_err = float(np.abs(f_fold - f_ref).max())
    log(f"embed_files ViT-B/16 serving defaults vs the unfolded f32 engine: max|f - f_f32| / "
        f"max|f| = {err:.3e} (tolerance {EMBED_TOL:.0e}, max|f| = {scale:.3f}), 1 - cosine at "
        f"most {1 - cos.min():.3e}; attention_qkv launches {launches[KERNEL.name]} = 12 x 2 "
        f"batches")
    log(f"folded vs unfolded f32 engine features: max|f_fold - f| = {fold_err:.3e} "
        f"(tolerance {FOLD_FEATURE_TOL:.0e})")
    if not err <= EMBED_TOL:
        raise AssertionError(f"embed_files: features off by {err} of max|f|")
    if not fold_err <= FOLD_FEATURE_TOL:
        raise AssertionError(f"folded features off the unfolded by {fold_err}")

    magpie = paths.index(os.path.join(HERE, "assets", "magpie.jpeg"))
    httpd, batcher = create_server(engine, port=0, batch=8, max_wait_ms=5.0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        KERNEL.reset()
        status, body, ms = post(f"http://127.0.0.1:{httpd.server_port}/v1/embed", bodies[magpie])
        torch.cuda.synchronize()
        launches_post = KERNEL.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        server.join(timeout=30)
    want = engine.embed_file(paths[magpie])
    if status != 200 or body["shape"] != [768]:
        raise AssertionError(f"/v1/embed: HTTP {status} {str(body)[:200]}")
    post_err = float(np.abs(np.array(body["embedding"]) - want).max()) / float(np.abs(want).max())
    log(f"/v1/embed (the defaults' daemon, micro-batch 8) vs embed_file on the same bytes: "
        f"max|diff| / max|f| = {post_err:.3e} (tolerance {TOL[torch.bfloat16]:.0e}); "
        f"200 in {ms:.1f} ms, {launches_post} attention_qkv launches")
    if not post_err <= TOL[torch.bfloat16] or launches_post != 12:
        raise AssertionError(f"/v1/embed: off by {post_err}, {launches_post} launches")
    return {"embed_files": launches}


def vit_benchmark(ft: str, tmp: str, card: str) -> None:
    """vit_cpp_tpu_torch.cli.benchmark.run_eval on a dark/bright tree (8
    images per class, classnames.json beside it) with the fine-tuned
    ViT-B/16 (2 classes), f32 on the card and on the card machine's CPU:
    equal CSVs except where the CPU's top-two probabilities lie within
    BENCH_TIE of each other."""
    from unittest import mock

    from vit_cpp_tpu_torch.cli.benchmark import run_eval
    from vit_cpp_tpu_torch.engine import VitEngine

    rows, predict = [], VitEngine.predict_probs_batch

    def recording(engine, images):  # the probabilities behind the CSV's rows
        out = predict(engine, images)
        rows.append(out.cpu().numpy())
        return out

    root = os.path.join(tmp, "bench")
    val = write_dark_bright(os.path.join(root, "val"), 8)
    with open(os.path.join(root, "classnames.json"), "w") as f:
        json.dump(["aa_dark", "bb_bright"], f)
    csvs, lines = {}, {}
    for device in ("cuda", "cpu"):
        csv = os.path.join(root, f"{device}.csv")
        text = io.StringIO()
        t0 = time.perf_counter()
        rows.clear()
        with contextlib.redirect_stdout(text), \
                mock.patch.object(VitEngine, "predict_probs_batch", recording):
            acc = run_eval(ft, val, 0, csv, ext=".png", verbose=False, device=device)
        seconds = time.perf_counter() - t0
        lines[device] = text.getvalue().splitlines()[-1]
        with open(csv) as f:
            csvs[device] = f.read().splitlines()
        log(f"cli.benchmark run_eval on {device}: {lines[device]} ({len(csvs[device])} rows, "
            f"accuracy {acc:.4f}) in {seconds:.1f} s")
    probs = np.concatenate(rows)[: len(csvs["cpu"])]  # the CPU run's, in row order
    if len(csvs["cuda"]) != 16 or len(csvs["cpu"]) != 16:
        raise AssertionError(f"cli.benchmark: rows {len(csvs['cuda'])} / {len(csvs['cpu'])}")
    top2 = np.sort(probs, axis=1)[:, -2:]
    ties = top2[:, 1] - top2[:, 0] <= BENCH_TIE
    differ = [i for i, (a, b) in enumerate(zip(csvs["cuda"], csvs["cpu"])) if a != b]
    log(f"cli.benchmark card vs CPU: {len(differ)} of 16 rows differ, {int(ties.sum())} rows "
        f"with the CPU's top-two within {BENCH_TIE:.0e}; card {lines['cuda']!r} on {card}")
    if any(not ties[i] for i in differ) or not lines["cuda"].startswith("Top-1 Accuracy: "):
        raise AssertionError(f"cli.benchmark: rows {differ} differ off the near-ties")


def vit_inspect(*files: str) -> None:
    """vit_cpp_tpu_torch.cli.inspect on each file, as text and as
    --json --tensors: exit 0, and the JSON's total bytes equal the sum of
    the reader's record sizes."""
    from vit_cpp_tpu_torch.cli import inspect as cli_inspect
    from vit_cpp_tpu_torch.gguf.reader import read_model

    for path in files:
        texts = []
        for flags in ([], ["--json", "--tensors"]):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli_inspect.main([path, *flags])
            if rc != 0:
                raise AssertionError(f"cli.inspect {path} {flags}: exit {rc}")
            texts.append(text.getvalue())
        summary = json.loads(texts[1])
        records = sum(r.dtype.row_bytes(r.n_elements) for r in read_model(path).tensors.values())
        if summary["total_bytes"] != records or records != sum(t["bytes"] for t in summary["tensors"]):
            raise AssertionError(f"cli.inspect {path}: total_bytes {summary['total_bytes']}, "
                                 f"records {records}")
        counts = next(line.strip() for line in texts[0].splitlines() if " labels, " in line)
        log(f"cli.inspect {os.path.basename(path)}: rc 0; {counts}; "
            f"--json total_bytes {summary['total_bytes']} = the reader's records, "
            f"bytes by type {summary['bytes_by_dtype']}")


def _timm_state(hp) -> dict:
    """The synthetic f32 checkpoint's tensors under their timm names and
    shapes (the conv bias back to (C,)), as a user's torch.save writes."""
    from vit_cpp_tpu_torch.testing.synthetic import random_state_dict

    return {k: torch.from_numpy(v.reshape(-1) if k == "patch_embed.proj.bias" else v)
            for k, v in random_state_dict(hp, seed=0).items()}


def convert_checkpoint(f16: str, tmp: str, hp) -> str:
    """`python -m vit_cpp_tpu_torch.cli.convert --checkpoint vit.pth
    --heads 12 OUT` on the synthetic ViT-B/16's (`hp`) f32 tensors: every record
    (name, shape, dtype, bytes) and the hparams equal those of the f16
    file write_synthetic_model wrote from the same seed."""
    from vit_cpp_tpu_torch.gguf.reader import read_model

    pth, out = os.path.join(tmp, "vit-b16.pth"), os.path.join(tmp, "converted")
    os.makedirs(out)
    torch.save(_timm_state(hp), pth)
    t0 = time.perf_counter()
    r = run_module("vit_cpp_tpu_torch.cli.convert", "--checkpoint", pth, "--heads",
                   str(hp.num_attention_heads), out)
    seconds = time.perf_counter() - t0
    os.remove(pth)
    if r.returncode != 0:
        raise AssertionError(f"cli.convert exited {r.returncode}: {r.stderr[-2000:]}")
    conv = os.path.join(out, "ggml-model-f16.gguf")
    got, want = read_model(conv), read_model(f16)
    if got.hparams != want.hparams or got.id2label != want.id2label:
        raise AssertionError(f"cli.convert: hparams {got.hparams} != {want.hparams}")
    if list(got.tensors) != list(want.tensors):
        raise AssertionError("cli.convert: tensor names differ from the synthetic file's")
    for name, rec in got.tensors.items():
        other = want.tensors[name]
        if (rec.shape, rec.dtype) != (other.shape, other.dtype) or \
                rec.data.tobytes() != other.data.tobytes():
            raise AssertionError(f"cli.convert: record {name} differs")
    same = open(conv, "rb").read() == open(f16, "rb").read()
    log(f"cli.convert ViT-B/16 .pth -> f16 gguf: rc 0 in {seconds:.1f} s (interpreter start "
        f"included); {len(got.tensors)} records and the hparams equal the synthetic f16 "
        f"file's; whole file byte-identical: {same}")
    return conv


def _launches(prof) -> tuple:
    """(host launch calls, device kernels) in a torch.profiler run: the
    host's kernel-launch calls (cudaLaunchKernel, cuLaunchKernel and their
    Ex forms), and the kernel events the card reported."""
    host = dev = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev += e.count
        elif "LaunchKernel" in e.key:
            host += e.count
    return host, dev


def static_scales(conv: str, card: str) -> None:
    """The serving defaults (int8, fold, bf16, K1) with static scales on
    the converted file: calibrated on the ten assets, accepted by the
    guardrail, probabilities within FLAGSHIP_TOL of the f32 engine; the
    static and the dynamic W8A8 forward at B=64 timed in turns and
    profiled."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.cli.common import build_engine, calibrate_engine_from_paths
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.int8_matmul import w8a8_matmul
    from vit_cpp_tpu_torch.quant.int8 import params_have_static_scales

    paths, _ = asset_bodies()
    static, _ = build_engine(conv, act="static", device="cuda")
    t0 = time.perf_counter()
    KERNEL.reset()
    ok = calibrate_engine_from_paths(static, os.path.join(HERE, "assets"))
    torch.cuda.synchronize()
    cal_s, cal_launches = time.perf_counter() - t0, KERNEL.launches
    if not ok or not params_have_static_scales(static.params):
        raise AssertionError("static scales: the guardrail rejected the calibration")
    blocks = static.params["blocks"]
    ranges = {n: blocks[n]["kernel"].act_scale.flatten() for n in ("qkv", "proj", "fc1", "fc2")}
    ranges["head"] = static.params["head"]["kernel"].act_scale.flatten()
    log(f"static scales: calibrated on the 10 assets in {cal_s:.2f} s ({cal_launches} "
        f"attention_qkv launches: calibration and guardrail forwards); guardrail agreement "
        f"{static.calibration_agreement:.3f} (minimum 0.90); scale ranges over the layers: "
        + ", ".join(f"{n} {v.min().item():.4e}-{v.max().item():.4e}" for n, v in ranges.items()))

    dynamic, _ = build_engine(conv, device="cuda")
    pixels = static.preprocess_images(load_images_rgb_batch(paths))
    got = static.predict_probs_batch(pixels).float().cpu().numpy()
    dyn = dynamic.predict_probs_batch(pixels).float().cpu().numpy()
    ref = VitEngine(conv, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda",
                    verbose=False)
    want = ref.predict_probs_batch(pixels).cpu().numpy()
    del ref
    hp = static.hp
    if got.shape != (10, hp.num_classes) or not np.isfinite(got).all():
        raise AssertionError(f"static scales: bad probabilities {got.shape}")
    err, dyn_err = float(np.abs(got - want).max()), float(np.abs(dyn - want).max())
    agree = int((got.argmax(1) == want.argmax(1)).sum())
    log(f"static W8A8 serving defaults vs the f32 engine on the converted file: max|p - p_f32| "
        f"over 10 x {hp.num_classes} = {err:.3e} (tolerance {FLAGSHIP_TOL:.0e}); dynamic W8A8 {dyn_err:.3e}; "
        f"top-1 agrees on {agree}/10")
    if not err <= FLAGSHIP_TOL:
        raise AssertionError(f"static scales: probabilities off by {err} > {FLAGSHIP_TOL}")

    gen = torch.Generator(device="cuda").manual_seed(8)
    batch = torch.randn((64, 3, hp.img_size, hp.img_size), generator=gen, device="cuda")
    engines = {"static": static, "dynamic": dynamic}
    times = {k: [] for k in engines}
    for k in ("static", "dynamic", "dynamic", "static") * 2:
        engines[k].predict_probs_batch(batch)
        torch.cuda.synchronize()
        for _ in range(5):
            t0 = time.perf_counter()
            engines[k].predict_probs_batch(batch)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    ms = {k: float(np.median(v)) for k, v in times.items()}
    log(f"forward W8A8 ViT-B/16 bf16 fold on B=64 (converted file; median of 20 in turns, host "
        f"clock with sync): static {ms['static']:.3f} ms (range {min(times['static']):.3f}-"
        f"{max(times['static']):.3f}), dynamic {ms['dynamic']:.3f} ms (range "
        f"{min(times['dynamic']):.3f}-{max(times['dynamic']):.3f}) on {card}")
    tokens = 64 * (hp.n_patches + hp.n_prefix)
    x = torch.randn((tokens, hp.hidden_size), generator=gen, device="cuda").to(torch.bfloat16)
    for k, engine in engines.items():
        # 10 calls of one linear and 3 forwards per profile, averaged
        leaf = engine.params["blocks"]["qkv"]["kernel"][0]
        w8a8_matmul(x, leaf)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                w8a8_matmul(x, leaf)
            torch.cuda.synchronize()
        per_linear = [n / 10 for n in _launches(prof)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                engine.predict_probs_batch(batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / 3
        dev_us, (k1_us,) = device_us(prof, KERNEL)
        dev_us, k1_us = dev_us / 3, k1_us / 3
        per_forward = [n / 3 for n in _launches(prof)]
        if dev_us <= 0:
            log(f"profiled {k} W8A8 forward: torch.profiler saw no device time (not measured)")
            continue
        log(f"profiled {k} W8A8 forward B=64 (torch.profiler, mean of 3): {dev_us / 1e3:.2f} ms "
            f"of device time in {wall_us / 1e3:.2f} ms wall (idle share "
            f"{1 - dev_us / wall_us:.3f}); {per_forward[0]:.1f} kernel launches by the host, "
            f"{per_forward[1]:.1f} kernels on the card; attention_qkv {k1_us / 1e3:.2f} ms "
            f"({k1_us / dev_us:.3f} of device time); one "
            f"qkv linear ({tokens} x {hp.hidden_size} x {3 * hp.hidden_size}, mean of 10 calls): "
            f"{per_linear[0]:.1f} launches by the host, {per_linear[1]:.1f} kernels on the card")
    del engines, static, dynamic


def _read_banner(proc, timeout: float) -> str:
    """The daemon's '... on http://' line from its stderr (read on a
    thread, which keeps draining the pipe), or raise after `timeout` s."""
    lines, bound = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line.rstrip())
            if " on http://" in line:
                bound.set()
        bound.set()  # EOF: the daemon exited

    threading.Thread(target=read, daemon=True).start()
    bound.wait(timeout)
    banner = [ln for ln in lines if " on http://" in ln]
    if not banner:
        raise AssertionError(f"cli.server printed no banner: {lines[-20:]}")
    return banner[0]


def multi_daemon(conv: str, q8: str, tol: float, card: str) -> dict:
    """create_multi_server with the converted f16 file and the Q8_0 file at
    the serving defaults with static scales calibrated on the assets: the
    ten assets POSTed concurrently to each model's classify route (one
    model, the other, then both at once), top-5 against each model's f32
    engine, one embed per model, /stats, /metrics and a 404; 12
    attention_qkv launches per device batch. Then the same daemon through
    `python -m vit_cpp_tpu_torch.cli.server -m a=... -m b=... --act static
    --calib-dir assets`, one answer per model. Returns {path: launches}."""
    from vit_cpp_tpu_torch.cli.common import build_engine, calibrate_engine_from_paths
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.server import create_multi_server

    paths, bodies = asset_bodies()
    images = load_images_rgb_batch(paths)
    files = {"f16": conv, "q8": q8}
    refs = {}
    for name, path in files.items():
        ref = VitEngine(path, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda",
                        verbose=False)
        refs[name] = ref.predict_probs_batch(ref.preprocess_images(images)).cpu().numpy()
        del ref
    t0 = time.perf_counter()
    engines = {}
    for name, path in files.items():
        engines[name], _ = build_engine(path, act="static", device="cuda")
        if not calibrate_engine_from_paths(engines[name], os.path.join(HERE, "assets")):
            raise AssertionError(f"multi-model daemon: {name}: the guardrail rejected the scales")
    hp = engines["f16"].hp
    httpd, batchers = create_multi_server(engines, port=0, batch=8, max_wait_ms=5.0)
    log(f"multi-model daemon (f16 converted + Q8_0, static W8A8): loaded, calibrated, warmed "
        f"up and bound in {time.perf_counter() - t0:.1f} s (port {httpd.server_port})")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    rounds = {}
    try:
        for label, names in (("f16", ["f16"]), ("q8", ["q8"]), ("both", ["f16", "q8"])):
            with urllib.request.urlopen(base + "/stats", timeout=60) as r:
                before = json.loads(r.read())
            KERNEL.reset()
            jobs = [(n, i) for n in names for i in range(len(bodies))]
            with ThreadPoolExecutor(len(jobs)) as ex:
                results = list(ex.map(
                    lambda job: post(f"{base}/v1/{job[0]}/classify?topk=5", bodies[job[1]]), jobs))
            torch.cuda.synchronize()
            launches = KERNEL.launches
            with urllib.request.urlopen(base + "/stats", timeout=60) as r:
                stats = json.loads(r.read())
            batches = sum(stats[n]["batches"] - before[n]["batches"] for n in names)
            rounds[label] = (jobs, results, launches, batches)
        embeds = {n: post(f"{base}/v1/{n}/embed", bodies[0]) for n in files}
        missing = post(f"{base}/v1/nope/classify", bodies[0])
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        for b in batchers.values():
            b.close()
        server.join(timeout=30)
    worst = {n: 0.0 for n in files}
    for label, (jobs, results, launches, batches) in rounds.items():
        for (name, i), (status, out, _) in zip(jobs, results):
            if status != 200 or len(out["topk"]) != 5:
                raise AssertionError(f"multi-model daemon: /v1/{name}/classify {paths[i]}: "
                                     f"HTTP {status} {str(out)[:200]}")
            probs = np.array([e["prob"] for e in out["topk"]])
            if not (np.isfinite(probs).all() and (np.diff(probs) <= 0).all()):
                raise AssertionError(f"multi-model daemon: bad top-5 {probs}")
            err = float(np.abs(probs - refs[name][i][[e["id"] for e in out["topk"]]]).max())
            worst[name] = max(worst[name], err)
        if launches != hp.num_hidden_layers * batches or batches == 0:
            raise AssertionError(f"multi-model daemon {label}: attention_qkv launched {launches} "
                                 f"times for {batches} device batches (want one per layer)")
        lat = sorted(ms for _, _, ms in results)
        log(f"multi-model daemon, round {label}: {len(jobs)} concurrent requests, all 200; "
            f"attention_qkv {launches} = {hp.num_hidden_layers} x {batches} device batches; "
            f"latency ms min "
            f"{lat[0]:.1f} median {lat[len(lat) // 2]:.1f} max {lat[-1]:.1f}")
    log(f"multi-model daemon: top-5 vs each model's f32 engine: worst f16 {worst['f16']:.3e}, "
        f"q8 {worst['q8']:.3e} (tolerance {tol:.0e})")
    if max(worst.values()) > tol:
        raise AssertionError(f"multi-model daemon: probabilities off by {worst} > {tol}")
    for name, (status, body, ms) in embeds.items():
        vec = np.array(body.get("embedding", []))
        want = engines[name].embed_file(paths[0])
        err = float(np.abs(vec - want).max()) / float(np.abs(want).max()) if vec.size else 1.0
        if status != 200 or body["shape"] != [hp.hidden_size] or not err <= TOL[torch.bfloat16]:
            raise AssertionError(f"multi-model daemon: /v1/{name}/embed HTTP {status}, err {err}")
        log(f"multi-model daemon: /v1/{name}/embed 200 in {ms:.1f} ms, max|diff| / max|f| vs "
            f"embed_file {err:.3e} (tolerance {TOL[torch.bfloat16]:.0e})")
    if missing[0] != 404 or "/v1/q8/classify" not in missing[1]["error"]:
        raise AssertionError(f"multi-model daemon: unknown model gave {missing[:2]}")
    for name in files:
        if stats[name]["requests"] != 2 * len(bodies) or stats[name]["embed"]["requests"] != 1:
            raise AssertionError(f"multi-model daemon: /stats {name}: {stats[name]}")
        if f'vit_requests_total{{model="{name}",route="classify"}} {2 * len(bodies)}' not in metrics:
            raise AssertionError(f"multi-model daemon: /metrics lacks {name}'s counter")
    log(f"multi-model daemon: /stats {json.dumps(stats)}; /metrics labels both models; "
        f"/v1/nope/classify 404")
    del engines

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUN_MODULE, "vit_cpp_tpu_torch.cli.server", "-m", f"a={conv}",
         "-m", f"b={q8}", "--act", "static", "--calib-dir", os.path.join(HERE, "assets"),
         "--port", "0"],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
    )
    try:
        line = _read_banner(proc, 240)
        up = time.perf_counter() - t0
        cli_base = line.split(" on ")[1].split()[0]
        answers = {n: post(f"{cli_base}/v1/{n}/classify?topk=5", bodies[0]) for n in ("a", "b")}
        proc.send_signal(signal.SIGTERM)  # the daemon's clean stop
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
    for name, ref_name in (("a", "f16"), ("b", "q8")):
        status, out, ms = answers[name]
        if status != 200:
            raise AssertionError(f"cli.server /v1/{name}/classify: HTTP {status} {out}")
        probs = np.array([e["prob"] for e in out["topk"]])
        err = float(np.abs(probs - refs[ref_name][0][[e["id"] for e in out["topk"]]]).max())
        if not err <= tol:
            raise AssertionError(f"cli.server /v1/{name}/classify: off by {err}")
    if rc != 0:
        raise AssertionError(f"cli.server exited {rc} on SIGTERM")
    log(f"cli.server -m a=converted -m b=Q8_0 --act static --calib-dir assets: banner after "
        f"{up:.1f} s (interpreter start, two loads, two calibrations, warm-up), "
        f"/v1/a/classify and /v1/b/classify 200 within {tol:.0e} of the f32 engines, exit 0 "
        f"on SIGTERM")
    return {"serving_workflow daemon": {KERNEL.name: sum(r[2] for r in rounds.values())}}


def serving_workflow(f16: str, q8: str, tmp: str, card: str) -> dict:
    """The user's workflow: .pth -> cli.convert -> static scales -> the
    multi-model daemon (with the Q8_0 file from cli.quantize)."""
    t0 = time.perf_counter()
    from vit_cpp_tpu_torch.hparams import VitHParams

    conv = convert_checkpoint(f16, tmp, VitHParams(**VIT_B16))
    static_scales(conv, card)
    launches = multi_daemon(conv, q8, FLAGSHIP_TOL, card)
    log(f"serving_workflow: {time.perf_counter() - t0:.1f} s")
    return launches


# The model families (ViTSTR, SigLIP, resampled geometry, vit-explain) at
# ViT-B width. ViTSTR output is checked as served: the probabilities the
# served path decoded (recorded at its decode call) within
# VITSTR_PROB_TOL of the f32 engine's at every position; their argmax
# equal to the f32 engine's at every position 1.. but where the f32
# top-two lie within TEXT_TIE (PROB_TOL: such a position may decode to
# the other token); the served text and confidence equal to the host
# decode (greedy_decode) of those probabilities, the confidence to
# DECODE_RTOL (an f32 product on the card; F32_TINY absorbs its
# underflow). A text's confidence is a product of up to 24 probabilities
# near 1/96, so it is held to the f32 engine's relatively: |log c - log
# c_f32| within the sum over its positions of log(1 + VITSTR_PROB_TOL /
# (p - VITSTR_PROB_TOL)), p the f32 probability of the served token there.
# VITSTR_PROB_TOL is the bf16 limit, TOL[bf16], at which the tests hold
# the bf16 serving engines to the JAX package's: W8A8 itself moves a
# ViTSTR position's 96 probabilities further than PROB_TOL from f32 (the
# JAX package's W8A8 engine with f32 activations by 6.94e-3 at hidden 64,
# where the port's W8A8 agrees with it to 1.44e-3).
TEXT_TIE = PROB_TOL
VITSTR_PROB_TOL = 2e-2
DECODE_RTOL = 1e-5
F32_TINY = float(np.finfo(np.float32).tiny)
# vit-explain's top-5 vs classify_file's (the same f32 engine, the same
# composed attention): classes whose probabilities lie this close may
# swap places in the printed order.
EXPLAIN_TIE = 1e-5
# ViTSTR-Base (vitstr_base_patch16_224; Atienza, ICDAR 2021): 1 channel,
# the 96-token vocabulary, 25 positions.
VITSTR_B = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, num_classes=96,
                patch_size=16, img_size=224, in_chans=1, seq_len=25)
# The vision tower of google/siglip-base-patch16-224, headless: no CLS
# token, attention pooling, [-1, 1] pixels.
SIGLIP_B = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, num_classes=0,
                patch_size=16, img_size=224, num_prefix_tokens=0, global_pool="map",
                pixel_norm="unit")


def start_module(*args: str) -> subprocess.Popen:
    """run_module started in the background (its output read later by
    communicate)."""
    return subprocess.Popen(
        [sys.executable, "-c", _RUN_MODULE, *args], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(os.environ, PYTHONPATH=HERE),
    )


def vitstr_assets() -> list:
    paths = sorted(glob.glob(os.path.join(HERE, "assets", "vitstr", "*")))
    if len(paths) != 6:
        raise AssertionError(f"expected the 6 images of assets/vitstr, found {len(paths)}")
    return paths


@contextlib.contextmanager
def recorded(module, name: str):
    """Replace module.name for the block by a wrapper that keeps every
    call's (args, result) in the yielded list. Callers that import the
    name inside their body (recognize_files, the daemon's decode) see the
    wrapper."""
    real, calls = getattr(module, name), []

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def check_texts(what: str, id2label, probs, texts, ref_probs) -> dict:
    """Served ViTSTR output vs the f32 engine's (see TEXT_TIE above):
    `probs` (n, seq_len, V) the probabilities the served path decoded,
    `texts` [(text, confidence)] what it returned, `ref_probs` the f32
    engine's. Returns the figures for the log."""
    from vit_cpp_tpu_torch.models.vitstr import EOS_ID, greedy_decode

    err = float(np.abs(probs - ref_probs).max())
    if not err <= VITSTR_PROB_TOL:
        raise AssertionError(f"{what}: served probabilities off the f32 engine's by {err}")
    toks, ref_toks = probs.argmax(-1), ref_probs.argmax(-1)
    top2 = np.sort(ref_probs, axis=-1)[:, :, -2:]
    near = top2[..., 1] - top2[..., 0] <= TEXT_TIE
    flips, log_worst, log_max = 0, 0.0, 0.0
    for i, (text, conf) in enumerate(texts):
        apart = (toks[i] != ref_toks[i])[1:]
        if (apart & ~near[i, 1:]).any():
            raise AssertionError(f"{what}: image {i} decodes {toks[i, 1:]} where the f32 engine "
                                 f"decodes {ref_toks[i, 1:]} beyond near-ties")
        flips += int(apart.sum())
        want, want_conf = greedy_decode(probs[i], id2label)
        if text != want or not abs(conf - want_conf) <= DECODE_RTOL * want_conf + F32_TINY:
            raise AssertionError(f"{what}: image {i} served ({text!r}, {conf}), the host decode "
                                 f"of its probabilities ({want!r}, {want_conf})")
        ends = np.flatnonzero(toks[i, 1:] == EOS_ID)
        pos = np.arange(1, 1 + (ends[0] if len(ends) else toks.shape[1] - 1))
        p_f = ref_probs[i, pos, toks[i, pos]].astype(np.float64)
        log_err = abs(np.log(want_conf) - np.log(p_f).sum())
        bound = float(np.log1p(VITSTR_PROB_TOL / np.maximum(p_f - VITSTR_PROB_TOL, 1e-30)).sum())
        if not log_err <= bound:
            raise AssertionError(f"{what}: image {i} |log c - log c_f32| = {log_err} > {bound}")
        log_worst = max(log_worst, log_err / bound if bound else 0.0)
        log_max = max(log_max, log_err)
    return {"err": err, "flips": flips, "near": int(near[:, 1:].sum()),
            "positions": int(near[:, 1:].size), "log_share": log_worst, "log_err": log_max}


def vitstr_paths(ocr: str, ocr_q8: str, f16: str, card: str) -> tuple:
    """ViTSTR-Base through recognize_files at the serving defaults (f16:
    W8A8 + K1) and with --mm pallas (Q8_0: K4 + K1), with static scales
    calibrated on assets/vitstr, then beside a ViT-B/16 classifier in one
    two-model daemon. Returns ({path: launches}, {"f16" | "q8": the f32
    engine's probabilities and texts on that file}, {"" | "pallas" |
    "static": recognize_files' texts})."""
    from vit_cpp_tpu_torch.cli.common import build_engine, calibrate_engine_from_paths
    from vit_cpp_tpu_torch.engine import VitEngine, VitstrEngine
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.models import vitstr as vitstr_module
    from vit_cpp_tpu_torch.models.vitstr import greedy_decode
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL
    from vit_cpp_tpu_torch.serve import recognize_files
    from vit_cpp_tpu_torch.server import create_multi_server

    demos = vitstr_assets()
    images = load_images_rgb_batch(demos)
    ref, served = {}, {}
    for name, path in (("f16", ocr), ("q8", ocr_q8)):
        f32 = VitstrEngine(path, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda",
                           verbose=False)
        probs = f32.predict_probs_batch(f32.preprocess_images(images)).cpu().numpy()
        ref[name] = (probs, [greedy_decode(p, f32.id2label) for p in probs])
        del f32
    log(f"ViTSTR-B f32 engine (composed attention, TF32 off) texts: "
        f"{[t for t, _ in ref['f16'][1]]}, confidences {[f'{c:.3e}' for _, c in ref['f16'][1]]}")
    out = {}
    for what, path, kw, per_batch in (
        ("vitstr recognize_files defaults", ocr, {}, {KERNEL: 12}),
        ("vitstr recognize_files --mm pallas", ocr_q8, {"mm": "pallas"}, {KERNEL: 12, QMM_KERNEL: 49}),
        ("vitstr recognize_files --act static", ocr, {"act": "static"}, {KERNEL: 12}),
    ):
        engine, is_vitstr = build_engine(path, device="cuda", **kw)
        if not is_vitstr or engine.hp.seq_len != 25 or engine.hp.in_chans != 1:
            raise AssertionError(f"{what}: build_engine gave {type(engine).__name__} {engine.hp}")
        if kw.get("act") == "static":
            if not calibrate_engine_from_paths(engine, os.path.join(HERE, "assets", "vitstr")):
                raise AssertionError(f"{what}: the guardrail rejected the static scales")
            log(f"{what}: calibrated on assets/vitstr, guardrail agreement "
                f"{engine.calibration_agreement:.3f}")
        for kernel in (KERNEL, QMM_KERNEL):
            kernel.reset()
        with recorded(vitstr_module, "greedy_decode_device") as decoded:
            got = list(recognize_files(engine, demos, batch=8))
        torch.cuda.synchronize()
        launches = {kernel.name: kernel.launches for kernel in (KERNEL, QMM_KERNEL)}
        for kernel in (KERNEL, QMM_KERNEL):
            if launches[kernel.name] != per_batch.get(kernel, 0):
                raise AssertionError(f"{what}: {kernel.name} launched {launches[kernel.name]} "
                                     f"times for one batch (want {per_batch.get(kernel, 0)})")
        log(f"{what}: {[r.text for r in got]}; launches for one batch of 8: {launches}")
        if len(decoded) != 1:
            raise AssertionError(f"{what}: {len(decoded)} decode calls for one batch")
        ref_probs, ref_texts = ref["q8" if path == ocr_q8 else "f16"]
        probs = decoded[0][0][0][: len(demos)].float().cpu().numpy()
        fig = check_texts(what, engine.id2label, probs,
                          [(r.text, r.confidence) for r in got], ref_probs)
        log(f"{what}: the decoded probabilities within {fig['err']:.2e} of the f32 engine's "
            f"(tolerance {VITSTR_PROB_TOL:.0e}); {fig['flips']} of {fig['positions']} positions on a "
            f"near-tie decoded to the other token ({fig['near']} near-ties in all); texts "
            f"{sum(r.text == t for r, (t, _) in zip(got, ref_texts))}/{len(got)} equal to the "
            f"f32 engine's, every text and confidence the host decode of the served "
            f"probabilities; |log c - log c_f32| at most {fig['log_err']:.3f} "
            f"({fig['log_share']:.3f} of its bound)")
        out[what] = {k.name: launches[k.name] for k in per_batch}
        served[kw.get("mm", "") + kw.get("act", "")] = [r.text for r in got]
        del engine

    paths, bodies = asset_bodies()
    cls_ref = VitEngine(f16, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda",
                        verbose=False)
    cls_probs = cls_ref.predict_probs_batch(
        cls_ref.preprocess_images(load_images_rgb_batch(paths))).cpu().numpy()
    del cls_ref
    engines = {"cls": build_engine(f16, device="cuda")[0], "ocr": build_engine(ocr, device="cuda")[0]}
    httpd, batchers = create_multi_server(engines, port=0, batch=8, max_wait_ms=5.0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_port}"
    try:
        KERNEL.reset()
        jobs = [("cls/classify?topk=5", b) for b in bodies] + [
            ("ocr/recognize", open(d, "rb").read()) for d in demos]
        with recorded(vitstr_module, "greedy_decode") as decoded, \
                ThreadPoolExecutor(len(jobs)) as ex:
            results = list(ex.map(lambda job: post(f"{base}/v1/{job[0]}", job[1]), jobs))
        torch.cuda.synchronize()
        launches = KERNEL.launches
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        for b in batchers.values():
            b.close()
        server.join(timeout=30)
    id2label = engines["ocr"].id2label
    del engines
    worst = 0.0
    for i, (status, body, _) in enumerate(results[: len(bodies)]):
        top = body.get("topk", [])
        if status != 200 or len(top) != 5:
            raise AssertionError(f"two-model daemon /v1/cls/classify {paths[i]}: HTTP {status}")
        worst = max(worst, float(np.abs(np.array([e["prob"] for e in top])
                                        - cls_probs[i][[e["id"] for e in top]]).max()))
    # each response is matched to the decode call that returned its text
    # and confidence, and that call's probabilities are held to the f32
    # engine's on the image the response answers
    figs = []
    for i, (status, body, _) in enumerate(results[len(bodies):]):
        if status != 200:
            raise AssertionError(f"two-model daemon /v1/ocr/recognize {demos[i]}: HTTP {status} "
                                 f"{body}")
        said = (body.get("text"), body.get("confidence"))
        rows = [args[0] for args, out in decoded if out == said]
        if not rows:
            raise AssertionError(f"two-model daemon /v1/ocr/recognize {demos[i]}: {body} is no "
                                 f"decode call's result")
        figs.append(check_texts(f"two-model daemon /v1/ocr/recognize {demos[i]}", id2label,
                                np.asarray(rows[0])[None], [said], ref["f16"][0][i: i + 1]))
    batches = stats["cls"]["batches"] + stats["ocr"]["batches"]
    if launches != 12 * batches or worst > PROB_TOL:
        raise AssertionError(f"two-model daemon: {launches} attention_qkv launches for {batches} "
                             f"batches; classify off the f32 engine by {worst}")
    if [health["models"][n]["model"] for n in ("cls", "ocr")] != ["vit", "vitstr"] or \
            f'vit_requests_total{{model="ocr",route="recognize"}} {len(demos)}' not in metrics:
        raise AssertionError(f"two-model daemon: /healthz {health}")
    lat = sorted(ms for _, _, ms in results)
    log(f"two-model daemon (cls = ViT-B/16 f16, ocr = ViTSTR-B f16, serving defaults): "
        f"{len(bodies)} classify + {len(demos)} recognize requests at once, all 200; each text "
        f"the decode of probabilities within {max(f['err'] for f in figs):.2e} of the f32 "
        f"engine's, {sum(f['flips'] for f in figs)} near-tie positions decoded to the other "
        f"token; top-5 within {worst:.2e} of the f32 engine "
        f"(tolerance {PROB_TOL:.0e}); attention_qkv {launches} = 12 x {batches} device batches "
        f"({stats['cls']['batches']} cls, {stats['ocr']['batches']} ocr); latency ms median "
        f"{lat[len(lat) // 2]:.1f} max {lat[-1]:.1f}; /metrics labels route=\"recognize\"")
    out["two-model daemon (cls + ocr)"] = {KERNEL.name: launches}
    return out, ref, served


def siglip_path(siglip: str, card: str) -> dict:
    """The headless SigLIP-B/16 tower at the serving defaults: embed_files
    over the ten assets against the unfolded f32 engine (EMBED_TOL of
    max|f|), one POST /v1/embed against embed_file; 12 attention_qkv
    launches per batch."""
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.serve import embed_files
    from vit_cpp_tpu_torch.server import create_server

    paths, bodies = asset_bodies()
    images = load_images_rgb_batch(paths)
    ref = VitEngine(siglip, device="cuda", verbose=False)
    if (ref.hp.global_pool, ref.hp.pixel_norm, ref.hp.num_prefix_tokens) != ("map", "unit", 0):
        raise AssertionError(f"SigLIP: detected {ref.hp}")
    f_ref = ref.features_batch(ref.preprocess_images(images)).cpu().numpy()
    del ref
    engine, _ = build_engine(siglip, device="cuda")
    KERNEL.reset()
    vecs = [e.vector for e in embed_files(engine, paths, batch=8)]
    torch.cuda.synchronize()
    launches = KERNEL.launches
    got = np.stack(vecs)
    scale = float(np.abs(f_ref).max())
    err = float(np.abs(got - f_ref).max()) / scale
    cos = (got * f_ref).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(f_ref, axis=1)
    httpd, batcher = create_server(engine, port=0, batch=8, max_wait_ms=5.0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        KERNEL.reset()
        status, body, ms = post(f"http://127.0.0.1:{httpd.server_port}/v1/embed", bodies[0])
        torch.cuda.synchronize()
        post_launches = KERNEL.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        server.join(timeout=30)
    want = engine.embed_file(paths[0])
    post_err = float(np.abs(np.array(body.get("embedding", [0.0])) - want).max()) / float(
        np.abs(want).max())
    log(f"SigLIP-B/16 (map pooling, unit pixels, headless) embed_files at the serving defaults "
        f"vs the unfolded f32 engine: max|f - f_f32| / max|f| = {err:.3e} (tolerance "
        f"{EMBED_TOL:.0e}, max|f| = {scale:.3f}), 1 - cosine at most {1 - cos.min():.3e}; "
        f"attention_qkv {launches} = 12 x 2 batches; /v1/embed {status} in {ms:.1f} ms vs "
        f"embed_file {post_err:.3e} (tolerance {TOL[torch.bfloat16]:.0e}), {post_launches} launches")
    if not err <= EMBED_TOL or launches != 24 or got.shape != (10, SIGLIP_B["hidden_size"]):
        raise AssertionError(f"SigLIP embed_files: off by {err}, {launches} launches")
    if status != 200 or not post_err <= TOL[torch.bfloat16] or post_launches != 12:
        raise AssertionError(f"SigLIP /v1/embed: HTTP {status}, off by {post_err}")
    return {"siglip embed_files": {KERNEL.name: launches},
            "siglip /v1/embed": {KERNEL.name: post_launches}}


GEOMETRIES = (("img 384 (T=577)", {"img_size": 384}, ["--img-size", "384"], 577),
              ("patch 8 (T=785)", {"patch_size": 8}, ["--patch-size", "8"], 785))


def resampled_paths(f16: str, card: str) -> tuple:
    """The ViT-B/16 file served at 384 px and at patch 8 (the
    vit_base_patch16_384 and ViT-B/8 geometries) by serve_files at the
    serving defaults: top-5 within PROB_TOL of the f32 engine resampled
    the same way, 12 attention_qkv launches per batch. Returns ({path:
    launches}, {geometry: f32 probabilities})."""
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.serve import serve_files

    paths, _ = asset_bodies()
    images = load_images_rgb_batch(paths)
    out, refs = {}, {}
    for what, kw, _, t in GEOMETRIES:
        ref = VitEngine(f16, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda",
                        verbose=False, **kw)
        refs[what] = ref.predict_probs_batch(ref.preprocess_images(images)).cpu().numpy()
        del ref
        engine, _ = build_engine(f16, device="cuda", **kw)
        if engine.hp.n_patches + 1 != t:
            raise AssertionError(f"{what}: T = {engine.hp.n_patches + 1}")
        KERNEL.reset()
        got = list(serve_files(engine, paths, batch=8, keep_probs=True))
        torch.cuda.synchronize()
        launches = KERNEL.launches
        worst = 0.0
        for r, want in zip(got, refs[what]):
            top = np.argsort(-want, kind="stable")[:5]
            worst = max(worst, float(np.abs(r.probs[top] - want[top]).max()))
        log(f"resampled ViT-B/16 {what} serve_files at the serving defaults: top-5 vs the f32 "
            f"engine resampled the same way worst {worst:.2e} (tolerance {PROB_TOL:.0e}); "
            f"attention_qkv {launches} = 12 x 2 batches at T={t}")
        if worst > PROB_TOL or launches != 24:
            raise AssertionError(f"{what}: off by {worst}, {launches} launches")
        out[f"resampled {what} serve_files"] = {KERNEL.name: launches}
        del engine
    return out, refs


def resampled_times(f16: str, card: str) -> None:
    """Each resampled geometry's forward at B=64 at the serving defaults:
    the median of 20 on the host clock with sync, and one forward under
    torch.profiler with K1's share of its device time; then K1 alone at
    that shape (bf16, fast) against SDPA and its bound."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.models import vit as vit_module
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL, attention_qkv, attention_qkv_plain

    def hold(name, qkv, nh):
        got, ref = attention_qkv(qkv, nh, fast=True), attention_qkv_plain(qkv, nh, fast=True)
        err = (got.float() - ref.float()).abs().max().item()
        log(f"kernel case {name}: max|kernel - plain| = {err:.3e} (tolerance "
            f"{TOL[torch.bfloat16]:.0e})")
        if not (torch.isfinite(got).all() and err <= TOL[torch.bfloat16]):
            raise AssertionError(f"{name}: error {err} > {TOL[torch.bfloat16]}")

    gen = torch.Generator(device="cuda").manual_seed(9)
    for what, kw, _, t in GEOMETRIES:
        engine, _ = build_engine(f16, device="cuda", **kw)
        s = engine.hp.img_size
        pixels = torch.randn((64, 3, s, s), generator=gen, device="cuda")
        # the first forward's layer-0 qkv, the kernel's input on this path
        with recorded(vit_module, "attention_qkv") as calls:
            engine.predict_probs_batch(pixels)
        torch.cuda.synchronize()
        hold(f"attention_qkv on the B=64 {what} forward's first-layer qkv", calls[0][0][0],
             engine.hp.num_attention_heads)
        del calls
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            engine.predict_probs_batch(pixels)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        KERNEL.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.predict_probs_batch(pixels)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev_us, (k1_us,) = device_us(prof, KERNEL)
        ms = float(np.median(times))
        share = (f"{dev_us / 1e3:.2f} ms of device time in {wall_us / 1e3:.2f} ms wall (idle share "
                 f"{1 - dev_us / wall_us:.3f}), attention_qkv {k1_us / 1e3:.2f} ms "
                 f"({k1_us / dev_us:.3f}) in {KERNEL.launches} launches") if dev_us > 0 else \
            "torch.profiler saw no device time (shares not measured)"
        log(f"forward resampled ViT-B/16 {what} B=64 serving defaults (W8A8, fold, K1; median of "
            f"20, host clock with sync): {ms:.3f} ms ({64 / ms * 1e3:.0f} img/s, range "
            f"{min(times):.3f}-{max(times):.3f}); profiled: {share} on {card}")
        h, nh = engine.hp.hidden_size, engine.hp.num_attention_heads
        del engine, pixels
        qkv = torch.randn((64, t, 3 * h), generator=gen, device="cuda").to(torch.bfloat16)
        hold(f"attention_qkv B=64 T={t} h={h} bf16 fast (timed below)", qkv, nh)
        k_ms, lib = cuda_ms(lambda: attention_qkv(qkv, nh, fast=True)), sdpa_ms(qkv, nh)
        b_ms, b_by = attention_bound(64, t, h, 2)
        log(f"attention_qkv alone at B=64 T={t} h={h} bf16 fast: {k_ms:.4f} ms per call, "
            f"SDPA {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}) on {card}")
        del qkv


def explain_path(f16: str, tmp: str, card: str) -> None:
    """vit_cpp_tpu_torch.cli.explain on magpie.jpeg with the ViT-B/16
    file (f32 on the card): its top-5 lines equal classify_file's (up to
    classes within EXPLAIN_TIE), a 224 x 224 heatmap PNG and the 14 x 14
    grid; no kernel launches (composed attention keeps the
    probabilities)."""
    from PIL import Image

    from vit_cpp_tpu_torch.cli import explain
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.ops.flash_attention import FLASH_KERNEL, GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL

    magpie = os.path.join(HERE, "assets", "magpie.jpeg")
    png, npy = os.path.join(tmp, "heat.png"), os.path.join(tmp, "heat.npy")
    kernels = (KERNEL, QMM_KERNEL, FLASH_KERNEL, GRAD_KERNEL)
    for k in kernels:
        k.reset()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = explain.main(["-m", f16, "-i", magpie, "-o", png, "--npy", npy])
    seconds = time.perf_counter() - t0
    launched = sum(k.launches for k in kernels)
    engine = VitEngine(f16, device="cuda", verbose=False)
    top = engine.classify_file(magpie, topk=6, verbose=False)
    del engine
    lines = [f" > {label} : {prob:.2f}" for _, prob, label in top[:5]]
    got = out.getvalue().splitlines()
    tied = any(a[1] - b[1] <= EXPLAIN_TIE for a, b in zip(top, top[1:]))
    if rc != 0 or (got != lines and not (tied and sorted(got) == sorted(lines))):
        raise AssertionError(f"cli.explain rc {rc}: {got} vs classify_file {lines}")
    heat, grid = np.asarray(Image.open(png)), np.load(npy)
    if heat.shape != (224, 224) or grid.shape != (14, 14) or not (
            0.0 <= grid.min() and abs(grid.max() - 1.0) < 1e-6):
        raise AssertionError(f"cli.explain: heatmap {heat.shape}, grid {grid.shape}")
    if launched:
        raise AssertionError(f"cli.explain launched {launched} kernels")
    log(f"cli.explain ViT-B/16 f32 on magpie.jpeg: rc 0 in {seconds:.1f} s, top-5 lines equal "
        f"classify_file's, {err.getvalue().strip().splitlines()[-1]}; grid 14 x 14 in [0, 1]; "
        f"no kernel on this path (composed attention keeps the (B, L, H, T, T) probabilities): "
        f"0 launches on {card}")


def check_cli_outputs(procs: dict, ocr: str, vitstr_ref: dict, served: dict,
                      resampled_ref: dict) -> None:
    """The command lines started at the phase's start, each as a user runs
    it: `cli.vitstr` (f32, the console surface; its text is the f32
    engine's, its score printed to 2 places), `cli.serve` on ViTSTR at the
    defaults and with --mm pallas (one `path<TAB>text<TAB>conf` line per
    image, each text the f32 engine's or recognize_files' in this process
    with the same flags), and at the two resampled geometries (-k 5, labels equal to the
    f32 engine's where its top-two gap exceeds PROB_TOL)."""
    from vit_cpp_tpu_torch.hparams import VitHParams

    demos = vitstr_assets()
    paths, _ = asset_bodies()
    for name, proc in procs.items():
        ref_texts = vitstr_ref["q8" if "pallas" in name else "f16"][1]
        stdout, stderr = proc.communicate(timeout=600)
        for line in stderr.splitlines()[-4:]:
            log(f"{name}: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"{name} exited {proc.returncode}: {stderr[-2000:]}")
        lines = stdout.splitlines()
        if name == "cli.vitstr":
            hp = VitHParams(**VITSTR_B)
            want = [f"vit_model_load: loading model from '{ocr}' - please wait",
                    f"vit_model_load: hidden_size            = {hp.hidden_size}",
                    f"vit_model_load: num_hidden_layers      = {hp.num_hidden_layers}",
                    f"vit_model_load: num_attention_heads    = {hp.num_attention_heads}",
                    "vit_model_load: patch_size             = 16",
                    "vit_model_load: img_size               = 224",
                    "vit_model_load: num_classes            = 96",
                    "vit_model_load: ftype                  = 1",
                    "vit_model_load: qntvr                  = 0"]
            text, conf = ref_texts[0]
            tail = [f"load_image_from_file: loaded image '{demos[0]}' (184 x 72)",
                    "processed, out dims : (224 x 224)", "------------------ ", text,
                    f"score : {conf:.2f} ", "------------------ "]
            if lines[:9] != want or lines[10:] != tail or not re.match(
                    r"vit_model_load: model size = +[\d.]+ MB / num tensors = "
                    rf"{hp.expected_tensor_count()}$", lines[9]):
                raise AssertionError(f"cli.vitstr: stdout {lines}")
            log(f"cli.vitstr ViTSTR-B f32 on demo_1.png: rc 0, 16 stdout lines, text {text!r} = "
                f"the f32 engine's, score {conf:.2f}")
        elif "vitstr" in name:
            rows = [line.split("\t") for line in lines]
            same = served["pallas" if "pallas" in name else ""]
            if [r[0] for r in rows] != demos or any(
                    len(r) != 3 or r[1] not in (t, s) for r, (t, _), s in zip(rows, ref_texts, same)):
                raise AssertionError(f"{name}: stdout {lines}")
            equal = sum(r[1] == t for r, (t, _) in zip(rows, ref_texts))
            log(f"{name}: rc 0, 6 lines; texts equal to the f32 engine's: {equal}/6, the others "
                f"to recognize_files' with the same flags (held above to the f32 engine at every "
                f"position up to near-ties)")
        else:
            ref = resampled_ref[name.split("serve ")[1]]
            rows = [line.split("\t") for line in lines]
            if [r[0] for r in rows] != paths:
                raise AssertionError(f"{name}: stdout {lines}")
            checked = 0
            for row, p in zip(rows, ref):
                tags = [t.rsplit(":", 1) for t in row[1].split(" ")]
                top2 = np.sort(p)[-2:]
                if top2[1] - top2[0] > PROB_TOL:
                    checked += 1
                    if tags[0][0] != f"LABEL_{int(p.argmax())}":
                        raise AssertionError(f"{name}: {row[0]} labelled {tags[0][0]}")
                if abs(float(tags[0][1]) - p.max()) > PROB_TOL + 0.005:
                    raise AssertionError(f"{name}: {row[0]} printed {tags[0][1]}")
            log(f"{name}: rc 0, 10 lines of top-5; top-1 labels checked where the f32 top-two "
                f"gap exceeds {PROB_TOL:.0e}: {checked}/10, each printed top-1 within it")


def model_families(f16: str, tmp: str, card: str) -> dict:
    """ViTSTR-Base (written f16 and quantized to Q8_0 by cli.quantize),
    SigLIP-B/16 and the ViT-B/16 file at two resampled geometries, through
    the entry points users call, then vit-explain. The five command lines
    (cli.vitstr, cli.serve on ViTSTR at the defaults and --mm pallas, and
    at --img-size 384 and --patch-size 8) run as subprocesses beside the
    in-process checks and are read after them; the resampled forwards are
    timed once they have exited. Returns {path: launches}."""
    from vit_cpp_tpu_torch.cli import quantize
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.models.vitstr import vitstr_id2label
    from vit_cpp_tpu_torch.testing.synthetic import write_synthetic_model

    t0 = time.perf_counter()
    ocr, ocr_q8, siglip = (os.path.join(tmp, n) for n in (
        "vitstr-b16-synthetic-f16.gguf", "vitstr-b16-synthetic-q8_0.gguf",
        "siglip-b16-synthetic-f16.gguf"))
    write_synthetic_model(ocr, VitHParams(**VITSTR_B), ftype=1, seed=0, id2label=vitstr_id2label())
    with contextlib.redirect_stdout(io.StringIO()):
        if quantize.main([ocr, ocr_q8, "8"]) != 0:
            raise AssertionError("cli.quantize failed on the ViTSTR file")
    demos = vitstr_assets()
    paths, _ = asset_bodies()
    serve = "vit_cpp_tpu_torch.cli.serve"
    procs = {
        "cli.vitstr": start_module("vit_cpp_tpu_torch.cli.vitstr", "-m", ocr, "-i", demos[0]),
        "cli.serve vitstr defaults": start_module(serve, "-m", ocr, *demos, "-b", "8"),
        "cli.serve vitstr --mm pallas": start_module(serve, "-m", ocr_q8, *demos, "-b", "8",
                                                     "--mm", "pallas"),
        **{f"cli.serve {what}": start_module(serve, "-m", f16, *paths, "-b", "8", "-k", "5", *flags)
           for what, _, flags, _ in GEOMETRIES},
    }
    try:
        write_synthetic_model(siglip, VitHParams(**SIGLIP_B), ftype=1, seed=0)
        log(f"model_families: ViTSTR-B f16 + Q8_0 and SigLIP-B/16 f16 written, five command "
            f"lines started, in {time.perf_counter() - t0:.1f} s")
        launches, vitstr_ref, served = vitstr_paths(ocr, ocr_q8, f16, card)
        launches.update(siglip_path(siglip, card))
        more, resampled_ref = resampled_paths(f16, card)
        launches.update(more)
        explain_path(f16, tmp, card)
        vit_inspect(ocr, siglip)
        check_cli_outputs(procs, ocr, vitstr_ref, served, resampled_ref)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
    resampled_times(f16, card)
    log(f"model_families: {time.perf_counter() - t0:.1f} s")
    return launches


# ToMe on ViT-B/16 (phase `tome_paths`): r=16 merges 16 pairs in each of
# the first 11 layers and 10 in the last (the clamp), so the layers run at
# T = 197, 181, ..., 37, 21; training runs r=8 (T = 197, 189, ..., 109).
TOME_R = 16
TOME_TRAIN_R = 8
TOME_LAYERS = (0, 5, 11)  # T = 197, 117 and 21 (under one 128-query block)
TOME_GRAD_LAYERS = (1, 11)  # T = 189 and 109 at r=8
# Two matchings of one metric (card vs CPU) may choose another source or
# destination only where the two candidates' cosine scores lie within the
# rounding of f32 scores summed in another order: a 64-term dot of unit
# vectors moves by at most 64 x 2^-24 = 3.8e-6 each way, plus the
# normalization's rounding.
MATCH_TIE = 1e-5


@contextlib.contextmanager
def recording(module, name: str):
    """Record every call of `module.name` (its args and kwargs) while the
    body runs; the calls still reach the function."""
    calls, real = [], getattr(module, name)

    def wrapper(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def check_recorded_attention(what: str, calls, layers) -> float:
    """K1 against its plain version on the inputs the model gave it at
    `layers`; the largest error."""
    from vit_cpp_tpu_torch.ops.flash_attention import attention_qkv, attention_qkv_plain

    worst = 0.0
    for layer in layers:
        (qkv, nh), kw = calls[layer]
        got = attention_qkv(qkv, nh, **kw)
        ref = attention_qkv_plain(qkv, nh, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what} layer {layer}: non-finite kernel output")
        err = (got.float() - ref.float()).abs().max().item()
        tol = TOL[qkv.dtype]
        sizes, kv = kw.get("sizes"), kw.get("kv")
        detail = (f"sizes {sizes.min().item():.0f}-{sizes.max().item():.0f}" if sizes is not None
                  else f"kv={kv}" if kv is not None else "")
        log(f"kernel case {what} layer {layer}: B={qkv.shape[0]} T={qkv.shape[1]} "
            f"{str(qkv.dtype)[6:]} fast={kw.get('fast', False)} {detail}: max|kernel - plain| "
            f"= {err:.3e} (tolerance {tol:.0e})")
        if not err <= tol:
            raise AssertionError(f"{what} layer {layer}: error {err} > {tol}")
        worst = max(worst, err)
    return worst


def _cosine_scores(metric: torch.Tensor, n_prefix: int) -> torch.Tensor:
    """ops/tome.py's (B, Ta, Tb) scores, on the CPU in f32."""
    m = metric[:, n_prefix:].float().cpu()
    m = m / torch.clamp(torch.linalg.vector_norm(m, dim=-1, keepdim=True), min=1e-6)
    return torch.einsum("bad,bcd->bac", m[:, 0::2], m[:, 1::2])


def check_matching(merges) -> None:
    """Each layer's matching on the card against the port's CPU run of the
    same metric: equal sources and destinations, or a near-tie (the gap
    between the r-th and (r+1)-th best scores, or between the two
    destinations' scores, within MATCH_TIE). Then identical tokens, where
    every score ties: the card merges them losslessly."""
    from vit_cpp_tpu_torch.ops.tome import bipartite_match, tome_merge

    rows = src_diff = dst_diff = 0
    worst_gap = 0.0
    for (x, metric, sizes, r, n_prefix), _ in merges:
        if not r:
            continue
        _, idx_card, src_card = (a.cpu() for a in bipartite_match(metric, r, n_prefix))
        node_max, idx_cpu, src_cpu = bipartite_match(metric.cpu(), r, n_prefix)
        scores = _cosine_scores(metric, n_prefix)
        for b in range(metric.shape[0]):
            rows += 1
            if set(src_card[b].tolist()) != set(src_cpu[b].tolist()):
                src_diff += 1
                ranked = torch.sort(node_max[b], descending=True).values
                gap = (ranked[r - 1] - ranked[r]).item() if ranked.numel() > r else 0.0
                worst_gap = max(worst_gap, gap)
                if not gap <= MATCH_TIE:
                    raise AssertionError(f"matching: sources differ at T={metric.shape[1]} "
                                         f"row {b} with a score gap of {gap}")
            for a in src_cpu[b].tolist():
                i, j = int(idx_card[b, a]), int(idx_cpu[b, a])
                if i != j:
                    dst_diff += 1
                    gap = abs((scores[b, a, i] - scores[b, a, j]).item())
                    worst_gap = max(worst_gap, gap)
                    if not gap <= MATCH_TIE:
                        raise AssertionError(f"matching: destinations differ at "
                                             f"T={metric.shape[1]} row {b} with gap {gap}")
    log(f"tome matching, card vs CPU on the same metric: {rows} (layer, image) rows over "
        f"{len(merges)} layers; sources differ in {src_diff}, destinations in {dst_diff}, "
        f"each a near-tie (worst gap {worst_gap:.2e}, bound {MATCH_TIE:.0e})")

    gen = torch.Generator(device="cuda").manual_seed(11)
    row = torch.randn((1, 1, 64), generator=gen, device="cuda")
    metric = row.expand(8, 197, 64).contiguous()
    token = torch.randn((1, 1, 768), generator=gen, device="cuda")
    x = token.expand(8, 197, 768).contiguous()
    sizes = torch.ones((8, 197), device="cuda")
    _, idx, src = bipartite_match(metric, TOME_R, 1)
    exact = bool((src.cpu() == torch.arange(TOME_R)).all() and (idx == 0).all())
    xn, sn = tome_merge(x, metric, sizes, TOME_R, 1)
    err = (xn - token).abs().max().item()
    log(f"tome identical tokens on the card (every score ties): the CPU's merge (sources "
        f"0..{TOME_R - 1}, destination 0) {'exactly' if exact else 'NOT exactly (near-ties)'}; "
        f"merged tokens off the token by {err:.2e}, sizes sum {sn.sum(1).min().item():.0f}")
    if not (err <= 1e-6 and (sn.sum(1) == 197).all()):
        raise AssertionError(f"identical tokens: lossy merge ({err}) or lost counts")


def check_daemon(what: str, proc, paths, bodies, ref_probs, ref_feats) -> None:
    """A `cli.server` subprocess at its defaults (started by the caller):
    the ten assets to /v1/classify at once and one /v1/embed, against the
    f32 engine of the same file and options (`ref_probs`, `ref_feats`)."""
    line = _read_banner(proc, 240)
    base = line.split(" on ")[1].split()[0]
    with ThreadPoolExecutor(len(bodies)) as ex:
        results = list(ex.map(lambda b: post(base + "/v1/classify?topk=5", b), bodies))
    status, emb, _ = post(base + "/v1/embed", bodies[0])
    with urllib.request.urlopen(base + "/stats", timeout=60) as r:
        stats = json.loads(r.read())
    proc.send_signal(signal.SIGTERM)
    if proc.wait(timeout=60) != 0:
        raise AssertionError(f"{what} exited nonzero on SIGTERM")
    worst = 0.0
    for path, (code, out, _), want in zip(paths, results, ref_probs):
        if code != 200 or len(out["topk"]) != 5:
            raise AssertionError(f"{what} {path}: HTTP {code} {out}")
        probs = np.array([e["prob"] for e in out["topk"]])
        worst = max(worst, float(np.abs(probs - want[[e["id"] for e in out["topk"]]]).max()))
    if status != 200 or emb["shape"] != [ref_feats.shape[1]]:
        raise AssertionError(f"{what} /v1/embed: HTTP {status}")
    emb_err = float(np.abs(np.array(emb["embedding"]) - ref_feats[0]).max()
                    / np.abs(ref_feats[0]).max())
    log(f"{what} (defaults): ten assets at once, top-5 vs the f32 engine: worst {worst:.2e} "
        f"(tolerance {PROB_TOL:.0e}); /v1/embed max|f - f_f32| / max|f| = {emb_err:.3e} "
        f"(tolerance {EMBED_TOL:.0e}); /stats {json.dumps(stats)}; exit 0 on SIGTERM")
    if not (worst <= PROB_TOL and emb_err <= EMBED_TOL):
        raise AssertionError(f"{what}: off by {worst} / {emb_err}")


def check_cli_serve(what: str, proc, paths, ref_probs, id2label, tol: float) -> None:
    """A `cli.serve -k` run: one line per path, and each line's top-1
    label the f32 engine's (same file and options) where its top-two gap
    exceeds the tolerance, printed probabilities within it (printed to 2
    places)."""
    out, err = proc.communicate(timeout=300)
    rows = [line.split("\t") for line in out.splitlines()]
    if proc.returncode != 0 or [r[0] for r in rows] != paths:
        raise AssertionError(f"{what}: exit {proc.returncode}, stderr {err[-2000:]}")
    checked = 0
    for (_, tags), p in zip(rows, ref_probs):
        top2 = np.sort(p)[-2:]
        if top2[1] - top2[0] > tol:  # a clear top-1: the labels must agree
            checked += 1
            label = id2label.get(int(p.argmax()), f"LABEL_{int(p.argmax())}")
            if not tags.startswith(label + ":"):
                raise AssertionError(f"{what}: printed {tags!r}, f32 top-1 {label}")
            prob = float(tags[len(label) + 1:].split(" ")[0])
            if abs(prob - top2[1]) > tol + 0.005:  # printed to 2 places
                raise AssertionError(f"{what}: printed {prob}, f32 {top2[1]}")
    summary = err.strip().splitlines()[-1]
    log(f"{what}: rc 0, {len(rows)} lines, top-1 equal to the f32 engine's on the "
        f"{checked}/{len(rows)} with a clear top-two gap; {summary}")


def timed_forwards(what: str, fns: dict, card: str, batch: int = 64) -> dict:
    """Each forward (of `batch` images), median of 20 in turns (CUDA events
    around a forward ended by a synchronize), then one profiled run each:
    device time, idle share, attention_qkv's share and the launches.
    Returns {name: ms}."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL

    times = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(2):
        for name in order:
            fns[name]()
            torch.cuda.synchronize()
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fns[name]()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
    ms = {name: float(np.median(t)) for name, t in times.items()}
    for name, fn in fns.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev_us, (k1_us,) = device_us(prof, KERNEL)
        host, kernels = _launches(prof)
        shares = ("device time not measured" if dev_us <= 0 else
                  f"{dev_us / 1e3:.2f} ms device in {wall_us / 1e3:.2f} ms wall (idle share "
                  f"{1 - dev_us / wall_us:.3f}), attention_qkv {k1_us / dev_us:.3f} of it, "
                  f"{host} host launch calls and {kernels} device kernels")
        log(f"{what} {name}: median {ms[name]:.3f} ms ({batch * 1e3 / ms[name]:.0f} img/s, range "
            f"{min(times[name]):.3f}-{max(times[name]):.3f}); profiled: {shares} on {card}")
    return ms


def tome_paths(f16: str, q8: str, tmp: str, card: str, images) -> tuple:
    """ToMe and token padding on ViT-B/16 (phase `tome_paths`): K1 (fast
    bf16 and safe f32), K2 (f32) and K1 at kv=197 held to their plain
    versions on the inputs the merged, trained and padded forwards give
    them; the matching card vs CPU; cli.serve --tome 16 at the defaults,
    --mm pallas and --act static, the daemon cli.server --tome 16 (with
    /v1/embed), serve_files' launches; the padded forward; cli.finetune
    --tome 8 with its meta and K2 launches, the loss and gradients at B=2
    card vs CPU; the r = 0/8/16, padded/unpadded and per-update times.
    Returns ({path: {kernel name: launches}}, attention_qkv_grad's
    launches in cli.finetune --tome 8)."""
    from vit_cpp_tpu_torch.cli import finetune as cli_finetune
    from vit_cpp_tpu_torch.cli.common import build_engine, calibrate_engine_from_paths
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.finetune import _preprocess_all, _reinit_head, load_dataset
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.models import vit
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.ops import flash_attention
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL
    from vit_cpp_tpu_torch.parallel.train import create_train_state, train_step
    from vit_cpp_tpu_torch.serve import embed_files, serve_files

    t0 = time.perf_counter()
    paths, bodies = asset_bodies()
    assets = os.path.join(HERE, "assets")
    tome = ["--tome", str(TOME_R)]
    cli_serve = "vit_cpp_tpu_torch.cli.serve"
    procs = {
        "cli.serve --tome defaults": start_module(cli_serve, "-m", f16, *paths, "-b", "8", "-k", "5",
                                                  *tome),
        "cli.serve --tome --mm pallas": start_module(cli_serve, "-m", q8, *paths, "-b", "8", "-k",
                                                     "5", "--mm", "pallas", *tome),
        "cli.serve --tome --act static": start_module(cli_serve, "-m", f16, *paths, "-b", "8", "-k",
                                                      "5", "--act", "static", "--calib-dir",
                                                      assets, *tome),
    }
    daemon = subprocess.Popen(
        [sys.executable, "-c", _RUN_MODULE, "vit_cpp_tpu_torch.cli.server", "-m", f16, *tome,
         "--port", "0"],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
    )
    launches = {}
    try:
        refs = {}
        for name, model in (("f16", f16), ("q8", q8)):
            f32 = VitEngine(model, dtype="f32", mm_impl="xla", attn_impl="xla", tome=TOME_R,
                            device="cuda", verbose=False)
            px = f32.preprocess_images(images)
            refs[name] = (f32.predict_probs_batch(px).cpu().numpy(),
                          f32.features_batch(px).cpu().numpy(), f32.id2label)
            del f32

        # K1 at the merged forward's inputs: fast bf16 (the serving
        # defaults) and safe f32; the matching's metric of the same batch
        engine, _ = build_engine(f16, tome=TOME_R, device="cuda")
        pixels = engine.preprocess_images(images)
        with recording(vit, "attention_qkv") as calls, recording(vit, "tome_merge") as merges:
            engine.predict_probs_batch(pixels)
        k1_err = check_recorded_attention(f"attention_qkv tome r={TOME_R} serving", calls,
                                          TOME_LAYERS)
        check_matching(merges)
        del calls, merges
        f32 = VitEngine(f16, dtype="f32", attn_impl="pallas", tome=TOME_R, device="cuda",
                        verbose=False)
        with recording(vit, "attention_qkv") as calls:
            f32.predict_probs_batch(f32.preprocess_images(images))
        k1_err = max(k1_err, check_recorded_attention(f"attention_qkv tome r={TOME_R} f32",
                                                      calls, TOME_LAYERS))
        del f32, calls

        # serve_files, as cli.serve runs it: launches and probabilities
        for what, model, kw, per_batch, tol in (
            ("tome serve_files defaults", f16, {}, {KERNEL: 12}, PROB_TOL),
            ("tome serve_files --mm pallas", q8, {"mm": "pallas"}, {QMM_KERNEL: 49, KERNEL: 12},
             Q8_PROB_TOL),
            ("tome serve_files --act static", f16, {"act": "static"}, {KERNEL: 12}, PROB_TOL),
        ):
            eng = engine if not kw else build_engine(model, tome=TOME_R, device="cuda", **kw)[0]
            if kw.get("act") == "static" and not calibrate_engine_from_paths(eng, assets):
                raise AssertionError(f"{what}: the guardrail rejected the static scales")
            for kernel in per_batch:
                kernel.reset()
            got = list(serve_files(eng, paths, batch=8, keep_probs=True))
            torch.cuda.synchronize()
            launches[what] = {kernel.name: kernel.launches for kernel in per_batch}
            want = refs["q8" if model == q8 else "f16"][0]
            err = float(max(np.abs(r.probs - p).max() for r, p in zip(got, want)))
            log(f"{what} (tome {TOME_R}): probabilities vs the f32 engine with the same tome, "
                f"worst {err:.2e} over 10 x 1000 (tolerance {tol:.0e}); launches "
                f"{launches[what]} for 2 batches")
            if not err <= tol:
                raise AssertionError(f"{what}: off by {err} > {tol}")
            for kernel, each in per_batch.items():
                if launches[what][kernel.name] != 2 * each:
                    raise AssertionError(f"{what}: {kernel.name} launched "
                                         f"{launches[what][kernel.name]} times for 2 batches")
            if eng is not engine:
                del eng
        KERNEL.reset()
        vecs = np.stack([e.vector for e in embed_files(engine, paths, batch=8)])
        torch.cuda.synchronize()
        launches["tome embed_files"] = {KERNEL.name: KERNEL.launches}
        f_ref = refs["f16"][1]
        emb_err = float(np.abs(vecs - f_ref).max() / np.abs(f_ref).max())
        log(f"tome embed_files (defaults, tome {TOME_R}) vs the unfolded f32 engine with the "
            f"same tome: max|f - f_f32| / max|f| = {emb_err:.3e} (tolerance {EMBED_TOL:.0e}); "
            f"{KERNEL.launches} attention_qkv launches")
        if not (emb_err <= EMBED_TOL and KERNEL.launches == 24):
            raise AssertionError(f"tome embed_files: off by {emb_err}, {KERNEL.launches} launches")
        daemon_path = f"f16 W8A8 daemon --tome {TOME_R}"
        launches[daemon_path] = serve(daemon_path, f16, "int8", {KERNEL: 12}, PROB_TOL, images,
                                      tome=TOME_R)
        del engine

        # token padding: B=64 of the assets at the defaults and --mm pallas
        big = torch.cat([pixels] * 7)[:64]
        for what, model, kw in (("defaults", f16, {}), ("--mm pallas", q8, {"mm": "pallas"})):
            eng = build_engine(model, device="cuda", **kw)[0]
            KERNEL.reset()
            with recording(vit, "attention_qkv") as calls:
                padded = eng._forward(big, pad_tokens=True)
            torch.cuda.synchronize()
            n = KERNEL.launches
            launches[f"pad_tokens forward {what}"] = {KERNEL.name: n}
            plain = eng._forward(big)
            p_pad = torch.softmax(padded.float(), -1)
            err = (p_pad - torch.softmax(plain.float(), -1)).abs().max().item()
            (qkv, _), kw1 = calls[0]
            log(f"pad_tokens forward {what} B=64: T {qkv.shape[1]} with kv={kw1['kv']}, "
                f"{n} attention_qkv launches; max|p_padded - p| = {err:.2e} "
                f"(tolerance {PROB_TOL:.0e})")
            if not (err <= PROB_TOL and qkv.shape[1] == 200 and kw1["kv"] == 197
                    and n == 12 and torch.isfinite(p_pad).all()):
                raise AssertionError(f"pad_tokens {what}: off by {err} or wrong shapes")
            k1_err = max(k1_err, check_recorded_attention(f"attention_qkv pad_tokens {what}",
                                                          calls, (0,)))
            del calls, eng

        # the command lines, which ran beside the checks above
        for what, proc in procs.items():
            check_cli_serve(what, proc, paths, refs["q8" if "pallas" in what else "f16"][0],
                            refs["f16"][2], Q8_PROB_TOL if "pallas" in what else PROB_TOL)
        check_daemon(f"cli.server --tome {TOME_R}", daemon, paths, bodies, refs["f16"][0],
                     refs["f16"][1])
    finally:
        for proc in (*procs.values(), daemon):
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)

    # the times, once the command lines have exited
    engines = {r: build_engine(f16, tome=r, device="cuda")[0] for r in (0, 8, TOME_R)}
    timed_forwards("forward ViT-B/16 serving defaults B=64",
                   {f"tome r={r}": (lambda e=e: e.predict_probs_batch(big))
                    for r, e in engines.items()}, card)
    eng = engines[0]
    timed_forwards("forward ViT-B/16 serving defaults B=64",
                   {"unpadded (T=197)": lambda: eng._forward(big),
                    "pad_tokens (T=200, kv=197)": lambda: eng._forward(big, pad_tokens=True)},
                   card)
    del engines, eng

    # training through ToMe: the loss and gradients at B=2 card vs CPU, K2
    # on the inputs the merged backward gives it, then cli.finetune --tome 8
    f32_path = os.path.join(tmp, "vit-b16-synthetic-f32.gguf")
    with recording(flash_attention, "attention_qkv_grad") as grads:
        slice_parity(f32_path, tome=TOME_TRAIN_R)
    card_grads = [c for c in grads if c[0][0].is_cuda]
    k2_err = 0.0
    for layer in TOME_GRAD_LAYERS:
        (qkv, do, nh), kw = card_grads[::-1][layer]  # the backward runs the last layer first
        got = flash_attention.attention_qkv_grad(qkv, do, nh, **kw)
        ref = flash_attention.attention_qkv_grad_plain(qkv, do, nh, **kw)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = GRAD_TOL[qkv.dtype] * ref.float().abs().max().item()
        log(f"kernel case attention_qkv_grad tome r={TOME_TRAIN_R} layer {layer}: B=2 "
            f"T={qkv.shape[1]} f32 sizes {kw['sizes'].min().item():.0f}-"
            f"{kw['sizes'].max().item():.0f}: max|kernel - plain| = {err:.3e} (tolerance "
            f"{tol:.3e} = {GRAD_TOL[qkv.dtype]:.0e} x max|plain|)")
        if not err <= tol:
            raise AssertionError(f"attention_qkv_grad tome layer {layer}: {err} > {tol}")
        k2_err = max(k2_err, err)
    del grads, card_grads

    data = os.path.join(tmp, "train")
    out, ckpt = os.path.join(tmp, "ft-tome.gguf"), os.path.join(tmp, "ckpt-tome")
    err = io.StringIO()
    KERNEL.reset()
    GRAD_KERNEL.reset()
    with contextlib.redirect_stderr(err):
        rc = cli_finetune.main(["-m", f16, "-d", data, "-o", out, "-b", "32", "--epochs", "1",
                                "--tome", str(TOME_TRAIN_R), "--ckpt-dir", ckpt,
                                "--device", "cuda"])
    torch.cuda.synchronize()
    fin = (KERNEL.launches, GRAD_KERNEL.launches)
    for line in err.getvalue().splitlines():
        log(f"cli.finetune --tome {TOME_TRAIN_R}: {line}")
    losses = [float(v) for v in re.findall(r"^epoch \d+/\d+: loss (\S+)", err.getvalue(), re.M)]
    with open(ckpt + ".meta.json") as f:
        meta = json.load(f)
    updates = len(load_dataset(data)[0]) // 32
    if rc != 0 or len(losses) != 1 or not np.isfinite(losses[0]) or meta["tome"] != TOME_TRAIN_R:
        raise AssertionError(f"cli.finetune --tome: rc {rc}, losses {losses}, meta tome "
                             f"{meta.get('tome')}")
    if fin != (12 * updates, 12 * updates):
        raise AssertionError(f"cli.finetune --tome: launches {fin} for {updates} updates")
    log(f"cli.finetune --tome {TOME_TRAIN_R}: {updates} updates of batch 32, loss {losses[0]}, "
        f"meta tome {meta['tome']}, launches {fin[0]} attention_qkv + {fin[1]} "
        f"attention_qkv_grad = 12 + 12 per update")

    mf = read_model(f16)
    params, hp = _reinit_head(load_params(mf, torch.float32, device="cuda"), mf.hparams, 2)
    state = create_train_state(params)
    paths_t, labels, _ = load_dataset(data)
    x = _preprocess_all(paths_t[:32], hp, 0, "cuda").cuda()
    y = torch.from_numpy(labels[:32]).cuda()
    per_update = {0: [], TOME_TRAIN_R: []}
    for r in (0, TOME_TRAIN_R, TOME_TRAIN_R, 0):
        train_step(state, x, y, hp, tome=r)  # warm
        torch.cuda.synchronize()
        for _ in range(3):
            t1 = time.perf_counter()
            float(train_step(state, x, y, hp, tome=r))
            per_update[r].append((time.perf_counter() - t1) * 1e3)
    ms = {r: float(np.median(t)) for r, t in per_update.items()}
    log(f"update ViT-B/16 f32 B=32 (median of 6 in turns, host clock, loss read): tome 0 "
        f"{ms[0]:.2f} ms, tome {TOME_TRAIN_R} {ms[TOME_TRAIN_R]:.2f} ms "
        f"({ms[0] / ms[TOME_TRAIN_R]:.2f}x) on {card}")
    del state, params
    log(f"tome_paths: {time.perf_counter() - t0:.1f} s; worst K1 error {k1_err:.2e}, "
        f"K2 {k2_err:.2e}")
    return launches, fin[1]


MOE_B16 = dict(VIT_B16, num_experts=8, moe_layers=(1, 3, 5, 7, 9, 11), moe_top_k=2,
               moe_capacity=1.25)
# Routing card vs CPU on one tensor: the two may choose other experts only
# at a near-tie, where adjacent logits among a token's top k+1 lie within
# 1e-5 of the logit scale (max|logit|): f32 logits summed in another order
# move by ~1e-7 of it. moe_mlp's output on the tokens routed alike: f32
# absolute (summation order; |out| ~ 1), bf16 relative to max|out|.
ROUTE_TIE = 1e-5
MOE_OUT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# The upcycled f32 forward (E=8, top-2, capacity 8.0: nothing drops)
# against the dense one, absolute on the logits: the combine re-associates
# sum_j gate_j * f(x) in f32.
UPCYCLE_TOL = 1e-4


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def check_routing(what: str, y: torch.Tensor, mp: dict, hp) -> tuple:
    """moe_mlp on the card against the CPU's run of the same tensor and
    parameters: the experts chosen equal but at near-ties (ROUTE_TIE), and
    where no token differs the positions, keeps and slots too; the
    outputs of the tokens routed alike within MOE_OUT_TOL. Returns
    (tokens routed differently, near-ties, the error)."""
    from vit_cpp_tpu_torch.ops import moe
    from vit_cpp_tpu_torch.ops.core import mlp_act

    act = mlp_act(hp.hidden_act)
    b, t, _ = y.shape
    k = hp.moe_top_k
    runs = {}
    for dev in ("cuda", "cpu"):
        yd, mpd = y.to(dev), _tree_to(mp, dev)
        r = moe.route(yd, mpd["router"]["kernel"], hp)
        out, _ = moe.moe_mlp(yd, mpd, hp, act)
        runs[dev] = (r, out.cpu())
    (rc, out_c), (rp, out_p) = runs["cuda"], runs["cpu"]
    top = torch.sort(rp.logits, dim=-1, descending=True).values[..., : k + 1]
    gap = (top[..., :-1] - top[..., 1:]).min(dim=-1).values  # (B, T)
    tie = gap <= ROUTE_TIE * rp.logits.abs().max()
    differ = (rc.idx.cpu() != rp.idx).any(dim=-1)
    if (differ & ~tie).any():
        raise AssertionError(f"{what}: {int((differ & ~tie).sum())} tokens route to other "
                             f"experts on the card without a near-tie")
    per_token = lambda a: a.cpu().reshape(b, k, t).transpose(1, 2)  # noqa: E731
    keep_c, keep_p = per_token(rc.keep), per_token(rp.keep)
    if not differ.any() and not (torch.equal(keep_c, keep_p)
                                 and torch.equal(rc.dest.cpu(), rp.dest)
                                 and torch.equal(rc.posn.cpu(), rp.posn)):
        raise AssertionError(f"{what}: equal experts but other positions or slots")
    alike = ~differ & (keep_c == keep_p).all(dim=-1)
    diff = (out_c.float() - out_p.float()).abs()[alike].max().item()
    tol = MOE_OUT_TOL[y.dtype] * (1.0 if y.dtype == torch.float32
                                  else out_p.float().abs().max().item())
    log(f"{what}: card vs CPU on one (B={b}, T={t}) {str(y.dtype)[6:]} input: experts differ "
        f"for {int(differ.sum())} of {b * t} tokens, {int(tie.sum())} near-ties (gap <= "
        f"{ROUTE_TIE:.0e} x max|logit|); dropped {1 - rp.keep.float().mean().item():.4f}; "
        f"max|out_card - out_cpu| over the {int(alike.sum())} tokens routed alike = "
        f"{diff:.3e} (tolerance {tol:.3e})")
    if not diff <= tol:
        raise AssertionError(f"{what}: moe_mlp output off by {diff} > {tol}")
    return int(differ.sum()), int(tie.sum()), diff


def moe_family_profile(engine, big, card: str) -> None:
    """One profiled B=64 forward of the V-MoE engine: device time by
    family (the expert GEMMs, the dispatch and combine products, the
    router product and sort, attention_qkv, the W8A8 int8 GEMMs, the rest),
    idle share and launches; then the router diagnostics moe_aux returns."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL

    from vit_cpp_tpu_torch.ops.moe import moe_capacity

    hp = engine.hp
    h, e, m = hp.hidden_size, hp.num_experts, hp.mlp_dim
    ec = e * moe_capacity(hp.n_prefix + hp.n_patches, e, hp.moe_top_k, hp.moe_capacity)
    engine.predict_probs_batch(big)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        engine.predict_probs_batch(big)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us, (k1_us,) = device_us(prof, KERNEL)
    host, kernels = _launches(prof)
    # host calls that wait for the card (a synchronize, or a copy that
    # blocks); the timed region's own final synchronize is one of them
    waits = sum(ev.count for ev in prof.key_averages()
                if ev.device_type != torch.autograd.DeviceType.CUDA
                and ("Synchronize" in ev.key or "cudaMemcpy" in ev.key))
    fam = {"expert GEMMs": 0.0, "dispatch/combine": 0.0, "router + sort": 0.0,
           "W8A8 int8 GEMMs": 0.0}
    for ev in prof.key_averages(group_by_input_shape=True):
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
        shapes = [list(s) for s in (ev.input_shapes or [])]
        if not us:
            continue
        if ev.key == "aten::bmm" and len(shapes) > 1 and shapes[1] in ([e, h, m], [e, m, h]):
            fam["expert GEMMs"] += us
        elif ev.key == "aten::bmm" and shapes and ec in shapes[0][1:]:
            fam["dispatch/combine"] += us
        elif ev.key == "aten::mm" and len(shapes) > 1 and shapes[1] == [h, e]:
            fam["router + sort"] += us
        elif ev.key == "aten::sort":
            fam["router + sort"] += us
        elif ev.key == "aten::_int_mm":
            fam["W8A8 int8 GEMMs"] += us
    if dev_us <= 0:
        log("profiled V-MoE forward B=64: torch.profiler saw no device time (not measured)")
    else:
        fam["attention_qkv"] = k1_us
        fam["elementwise and other"] = dev_us - sum(fam.values())
        split = ", ".join(f"{name} {us / 1e3:.2f} ms ({us / dev_us:.3f})" for name, us in fam.items())
        log(f"profiled V-MoE forward B=64 (serving defaults): {dev_us / 1e3:.2f} ms device in "
            f"{wall_us / 1e3:.2f} ms wall (idle share {1 - dev_us / wall_us:.3f}), {host} host "
            f"launch calls, {waits} host waits (synchronize or memcpy calls) and {kernels} "
            f"device kernels; by family: {split} on {card}")
    _, aux = engine._forward(big, moe_aux=True)
    log("V-MoE forward B=64 router diagnostics (moe_aux, mean of the 6 MoE layers): "
        + ", ".join(f"{k} {v.item():.4f}" for k, v in aux.items()))


def moe_serving(moe_f16: str, moe_q8: str, images) -> dict:
    """The V-MoE files served: cli.server at its defaults and `cli.serve
    --mm pallas` on the Q8_0 file as subprocesses, beside the in-process
    daemon (defaults; 12 attention_qkv per batch) and serve_files with
    --mm pallas (37 dequant_matmul + 12 attention_qkv per batch), each
    against the f32 engine of the same file; the experts chosen by the
    served engine against the f32 engine's, per MoE layer. Returns
    {path: {kernel name: launches}}."""
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.ops import moe
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL
    from vit_cpp_tpu_torch.serve import serve_files

    paths, bodies = asset_bodies()
    procs = {"cli.serve V-MoE Q8_0 --mm pallas": start_module(
        "vit_cpp_tpu_torch.cli.serve", "-m", moe_q8, *paths, "-b", "8", "-k", "5", "--mm",
        "pallas")}
    daemon = subprocess.Popen(
        [sys.executable, "-c", _RUN_MODULE, "vit_cpp_tpu_torch.cli.server", "-m", moe_f16,
         "--port", "0"],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
    )
    launches = {}
    try:
        refs = {}
        for name, model in (("f16", moe_f16), ("q8", moe_q8)):
            f32 = VitEngine(model, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda",
                            verbose=False)
            px = f32.preprocess_images(images)
            with recorded(moe, "route") as routes:
                probs = f32.predict_probs_batch(px).cpu().numpy()
            refs[name] = (probs, f32.features_batch(px).cpu().numpy(), f32.id2label,
                          [r.idx[..., 0].cpu() for _, r in routes])
            del f32
        what = "V-MoE f16 W8A8 daemon"
        launches[what] = serve(what, moe_f16, "int8", {KERNEL: 12}, PROB_TOL, images)

        engine, _ = build_engine(moe_f16, device="cuda")
        with recorded(moe, "route") as routes:
            engine.predict_probs_batch(engine.preprocess_images(images))
        flips = [int((r.idx[..., 0].cpu() != want).sum())
                 for (_, r), want in zip(routes, refs["f16"][3])]
        log(f"V-MoE serving defaults vs the f32 engine, top-1 expert choices that differ per MoE "
            f"layer over the ten assets (10 x 197 tokens each): {flips}")
        del engine, routes

        what = "V-MoE serve_files --mm pallas"
        eng = build_engine(moe_q8, mm="pallas", device="cuda")[0]
        QMM_KERNEL.reset()
        KERNEL.reset()
        got = list(serve_files(eng, paths, batch=8, keep_probs=True))
        torch.cuda.synchronize()
        launches[what] = {QMM_KERNEL.name: QMM_KERNEL.launches, KERNEL.name: KERNEL.launches}
        err = float(max(np.abs(r.probs - p).max() for r, p in zip(got, refs["q8"][0])))
        log(f"{what}: probabilities vs the f32 engine of the Q8_0 file, worst {err:.2e} over "
            f"10 x 1000 (tolerance {Q8_PROB_TOL:.0e}); launches {launches[what]} for 2 batches "
            f"(37 dequant_matmul: 6 dense layers x 4 + 6 MoE layers x 2 + the head)")
        if not (err <= Q8_PROB_TOL and launches[what] == {QMM_KERNEL.name: 74, KERNEL.name: 24}):
            raise AssertionError(f"{what}: off by {err} or launches {launches[what]}")
        del eng

        for what, proc in procs.items():
            check_cli_serve(what, proc, paths, refs["q8"][0], refs["q8"][2], Q8_PROB_TOL)
        check_daemon("cli.server V-MoE", daemon, paths, bodies, refs["f16"][0], refs["f16"][1])
    finally:
        for proc in (*procs.values(), daemon):
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
    return launches


def moe_checks(moe_f16: str, f16: str, images) -> None:
    """Routing card vs CPU on the first MoE layer's LN'd input of a card
    forward (f32, and bf16 at the serving defaults); upcycling the dense
    f32 ViT-B/16 (E=8, top-2, capacity 8.0) against its dense forward."""
    import dataclasses

    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine, detect_hparams
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.models import vit
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.ops.moe import upcycle_params
    from vit_cpp_tpu_torch.ops.precision import matmul_precision
    from vit_cpp_tpu_torch.ops.preprocess import norm_constants, preprocess_batch

    for what, engine in (
        ("routing f32", VitEngine(moe_f16, dtype="f32", attn_impl="pallas", device="cuda",
                                  verbose=False)),
        ("routing bf16 (serving defaults)", build_engine(moe_f16, device="cuda")[0]),
    ):
        with recording(vit, "moe_mlp") as calls:
            engine.predict_probs_batch(engine.preprocess_images(images))
        (y, mp, hp, _), _ = calls[0]
        check_routing(what, y, mp, hp)
        del engine, calls

    mf = read_model(f16)
    hp = detect_hparams(mf)
    dense = load_params(mf, torch.float32, hparams=hp, device="cuda")
    layers = tuple(range(1, hp.num_hidden_layers, 2))
    up = upcycle_params(dense, hp, 8, layers)
    hp_up = dataclasses.replace(hp, num_experts=8, moe_layers=layers, moe_top_k=2,
                                moe_capacity=8.0)
    mean, std = norm_constants(hp.pixel_norm)
    x = preprocess_batch(images[:8], hp.img_size, mode=hp.interpolation, mean=mean, std=std,
                         device="cuda")
    with torch.inference_mode(), matmul_precision("highest"):
        want = vit.forward(dense, x, hp, attn_impl="pallas")
        got, aux = vit.forward(up, x, hp_up, attn_impl="pallas", moe_aux=True)
    err = (got - want).abs().max().item()
    log(f"upcycled ViT-B/16 (E=8 top-2, capacity 8.0, f32, TF32 off) vs dense on the card, B=8: "
        f"max|logits - dense| = {err:.3e} (tolerance {UPCYCLE_TOL:.0e}); dropped_frac "
        f"{aux['dropped_frac'].item()}")
    if not (err <= UPCYCLE_TOL and aux["dropped_frac"].item() == 0.0):
        raise AssertionError(f"upcycling: off by {err}")
    del dense, up


def moe_times(moe_f16: str, f16: str, card: str, images) -> None:
    """The V-MoE engine's forward at the serving defaults beside the dense
    ViT-B/16's, B=8 and B=64 (median of 20 in turns, CUDA events), then
    one B=64 V-MoE forward profiled by family."""
    from vit_cpp_tpu_torch.cli.common import build_engine

    engines = {"dense ViT-B/16": build_engine(f16, device="cuda")[0],
               "V-MoE E=8 top-2": build_engine(moe_f16, device="cuda")[0]}
    pixels = engines["dense ViT-B/16"].preprocess_images(images)
    for b in (8, 64):
        x = torch.cat([pixels] * 7)[:b]
        timed_forwards(f"forward serving defaults B={b}",
                       {name: (lambda e=e, x=x: e.predict_probs_batch(x))
                        for name, e in engines.items()}, card, batch=b)
    moe_family_profile(engines["V-MoE E=8 top-2"], torch.cat([pixels] * 7)[:64], card)


def moe_training(f16: str, moe_f32: str, tmp: str, card: str, images) -> int:
    """cli.finetune --moe 8 --moe-top-k 2 on the dense f16 file (B=32, 2
    updates; 12 attention_qkv + 12 attention_qkv_grad per update, ms per
    update, peak memory), its output served by cli.serve; the loss and
    gradients of an f32 V-MoE file at B=2 card vs CPU (slice_parity).
    Returns attention_qkv_grad's launches in the cli.finetune run."""
    from vit_cpp_tpu_torch.cli import finetune as cli_finetune
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.finetune import load_dataset
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL

    data = os.path.join(tmp, "train")
    out, ckpt = os.path.join(tmp, "ft-moe.gguf"), os.path.join(tmp, "ckpt-moe")
    err = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.reset()
    GRAD_KERNEL.reset()
    with contextlib.redirect_stderr(err):
        rc = cli_finetune.main(["-m", f16, "-d", data, "-o", out, "-b", "32", "--epochs", "1",
                                "--moe", "8", "--moe-top-k", "2", "--ckpt-dir", ckpt,
                                "--device", "cuda"])
    torch.cuda.synchronize()
    fin = (KERNEL.launches, GRAD_KERNEL.launches)
    peak = torch.cuda.max_memory_allocated()
    for line in err.getvalue().splitlines():
        log(f"cli.finetune --moe 8: {line}")
    losses = [float(v) for v in re.findall(r"^epoch \d+/\d+: loss (\S+)", err.getvalue(), re.M)]
    with open(ckpt + ".meta.json") as f:
        meta = json.load(f)
    updates = len(load_dataset(data)[0]) // 32
    if rc != 0 or len(losses) != 1 or not np.isfinite(losses[0]) or meta["moe"] != 8:
        raise AssertionError(f"cli.finetune --moe: rc {rc}, losses {losses}, meta moe "
                             f"{meta.get('moe')}")
    if fin != (12 * updates, 12 * updates):
        raise AssertionError(f"cli.finetune --moe: launches {fin} for {updates} updates")
    timing = re.search(r"([\d.]+) ms per update after the first", err.getvalue())
    log(f"cli.finetune --moe 8 --moe-top-k 2: {updates} updates of batch 32, loss {losses[0]}, "
        f"meta moe {meta['moe']} layers {meta['moe_layers']}, {timing.group(1)} ms per update "
        f"after the first, peak device memory {peak / 2**30:.2f} GiB; launches {fin[0]} "
        f"attention_qkv + {fin[1]} attention_qkv_grad = 12 + 12 per update on {card}")

    ref = VitEngine(out, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda",
                    verbose=False)
    paths, _ = asset_bodies()
    proc = start_module("vit_cpp_tpu_torch.cli.serve", "-m", out, *paths, "-b", "8", "-k", "2")
    ref_probs = ref.predict_probs_batch(ref.preprocess_images(images)).cpu().numpy()
    check_cli_serve("cli.serve on the cli.finetune --moe output", proc, paths, ref_probs,
                    ref.id2label, PROB_TOL)
    del ref
    slice_parity(moe_f32, tag="slice parity V-MoE")
    return fin[1]


def moe_paths(f16: str, tmp: str, card: str, images) -> tuple:
    """V-MoE ViT-B/16 (phase `moe_paths`): E=8 experts in the odd blocks,
    top-2, capacity 1.25, synthetic f16 and its Q8_0 rewrite by
    cli.quantize (routers f32, experts Q8_0); served, routed card vs CPU,
    upcycled, timed and trained. Returns ({path: {kernel name: launches}},
    attention_qkv_grad's launches in cli.finetune --moe 8)."""
    from vit_cpp_tpu_torch.cli import quantize
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.testing.synthetic import write_synthetic_model

    t0 = time.perf_counter()
    moe_f16 = os.path.join(tmp, "vit-b16-moe-f16.gguf")
    moe_q8 = os.path.join(tmp, "vit-b16-moe-q8_0.gguf")
    moe_f32 = os.path.join(tmp, "vit-b16-moe-f32.gguf")
    write_synthetic_model(moe_f16, VitHParams(**MOE_B16), ftype=1, seed=0)
    with contextlib.redirect_stdout(io.StringIO()):
        if quantize.main([moe_f16, moe_q8, "8"]) != 0:
            raise AssertionError("cli.quantize failed on the V-MoE file")
    mf = read_model(moe_q8)
    kinds = {}  # the 2-D block weights' record types: dense, router, experts
    for n, r in mf.tensors.items():
        if n.startswith("blocks.") and len(r.shape) == 2:
            kinds.setdefault(n.split(".")[3] if ".moe." in n else "dense", set()).add(r.dtype.name)
    log(f"checkpoints: V-MoE ViT-B/16 synthetic f16 ({os.path.getsize(moe_f16) / 2**20:.0f} MiB) "
        f"and Q8_0 ({os.path.getsize(moe_q8) / 2**20:.0f} MiB) in {time.perf_counter() - t0:.1f} "
        f"s; record types in the Q8_0 file: {kinds}")
    if kinds != {"dense": {"Q8_0"}, "router": {"F32"}, "experts": {"Q8_0"}}:
        raise AssertionError(f"Q8_0 V-MoE file: {kinds}")
    del mf
    launches = moe_serving(moe_f16, moe_q8, images)
    moe_checks(moe_f16, f16, images)
    moe_times(moe_f16, f16, card, images)
    write_synthetic_model(moe_f32, VitHParams(**MOE_B16), ftype=0, seed=0)
    grad = moe_training(f16, moe_f32, tmp, card, images)
    log(f"moe_paths: {time.perf_counter() - t0:.1f} s")
    return launches, grad


# The training extras (phase `training_extras`) at ViT-B/16 width. The
# QAT w8a8 linear (fake-quantized f32) against the port's W8A8 linear
# (int8 codes, torch._int_mm) on the same input, every linear of the
# served forward fed that forward's own input: the two round the weights
# and each token's activations to the same codes, so they differ by f32
# summation order only, relative to max|out| (the JAX package's own check
# of one linear is rtol 1e-5, tests/test_qat.py).
QAT_LINEAR_TOL = 1e-5
# The QAT block against the W8A8 block, chained: every block of both fed
# the served (W8A8) forward's own input to that block. The qkv inputs are
# then equal bit for bit, and the two blocks part only where the f32
# summation order moves an activation across a rounding boundary: that
# code lands one step (1/127 of its token's absmax) away. Held per block:
# - the share of activation codes that flip at each linear's input, at
#   most QAT_FLIP_SHARE;
# - the RMS of (QAT - W8A8) over the block's output at most QAT_BLOCK_RMS
#   of the RMS of (dense - W8A8): the dense f32 block on the same input
#   and the same f16-rounded weights carries the whole quantization noise
#   on every element, the QAT block only where codes flip. A QAT block
#   that quantized one site wrongly, or not at all, lands near 1 (1.05 at
#   a tiny size on the CPU).
# An NVIDIA H100 80GB HBM3 (700.00 W) measured at most 5.85e-4 flipped
# codes (fc2's input; proj's <= 2.5e-5) and a ratio of 2.3e-2 to 5.25e-2
# over the 12 blocks of this synthetic ViT-B/16 at B=8; the bounds leave
# ~3x margin.
QAT_FLIP_SHARE = 2e-3
QAT_BLOCK_RMS = 0.15
# Whole forwards are not held to each other: the flips compound over 12
# layers (2.149e-2 of max|logit| between the QAT and W8A8 forwards of
# this synthetic ViT-B/16 on an NVIDIA H100 80GB HBM3, 700.00 W, where
# the dense f32 forward is 2.968e-2 from W8A8's). The QAT forward must be
# the closer of the two to W8A8's, and share its argmax on every image
# whose top-two logits lie more than QAT_TIE x max|logit| apart.
QAT_TIE = 2.5e-2
# The bf16-moment AdamW step card vs CPU on equal gradients: the moments
# are elementwise products and sums (bit-equal); the update divides and
# takes square roots, where the card's division by a scalar multiplies by
# its reciprocal: an update an ulp apart, so each leaf's parameters at
# most one f32 ulp of the leaf's scale (its largest |p|) apart.
ADAMW_ULPS = 1


def _served_leaves(tree) -> dict:
    """The kernels serving quantizes: blocks.{qkv,proj,fc1,fc2} and the head."""
    out = {f"blocks.{n}": tree["blocks"][n]["kernel"] for n in ("qkv", "proj", "fc1", "fc2")}
    out["head"] = tree["head"]["kernel"]
    return out


def _serving_chain(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """The port's serving arithmetic on one (in, out) CPU kernel: the
    on-disk block round trip (quant/blocks.py) or f16 storage, then the
    load-time channelwise int8 (quant/int8.py), dequantized."""
    from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType
    from vit_cpp_tpu_torch.quant import blocks
    from vit_cpp_tpu_torch.quant.int8 import channelwise_int8

    if fmt == "w8a8":
        return channelwise_int8(w.half()).dequantize()
    dt = GGMLDType[fmt.upper()]
    wt = np.ascontiguousarray(w.numpy().T)
    back = blocks.dequantize(blocks.quantize(wt, dt), wt.size, dt).reshape(wt.shape).T
    return channelwise_int8(torch.from_numpy(np.ascontiguousarray(back))).dequantize()


def qat_codecs(f32: str, card: str) -> None:
    """fake_quant_params in every format on the ViT-B/16 f32 weights, card
    against CPU bit for bit, and against the serving chain on layer 0's
    four kernels and the head; fake_quant_act / _static on a real layer-0
    qkv input, card against CPU bit for bit; every QAT w8a8 linear against
    the W8A8 one on the served forward's input, and the whole forwards,
    on the card."""
    from vit_cpp_tpu_torch.engine import detect_hparams
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.models.vit import embed, forward
    from vit_cpp_tpu_torch.ops.core import layernorm, linear
    from vit_cpp_tpu_torch.ops.int8_matmul import w8a8_matmul
    from vit_cpp_tpu_torch.quant import qat
    from vit_cpp_tpu_torch.quant.int8 import convert_params_to_int8

    t0 = time.perf_counter()
    mf = read_model(f32)
    hp = detect_hparams(mf)
    cpu = load_params(mf, torch.float32, hparams=hp, device="cpu")
    gpu = _tree_to(cpu, "cuda")
    for fmt in qat.QAT_FORMATS:
        on_card = _served_leaves(qat.fake_quant_params(gpu, fmt))
        on_cpu = _served_leaves(qat.fake_quant_params(cpu, fmt))
        n = 0
        for name, a in on_card.items():
            if not torch.equal(a.cpu(), on_cpu[name]):
                raise AssertionError(f"qat {fmt}: {name} differs card vs CPU")
            n += a.numel()
            w = cpu["blocks"][name[7:]]["kernel"][0] if name != "head" else cpu["head"]["kernel"]
            got = on_cpu[name][0] if name != "head" else on_cpu[name]
            if not torch.equal(got, _serving_chain(w, fmt)):
                raise AssertionError(f"qat {fmt}: {name} is not the serving chain's")
        log(f"qat codecs {fmt}: fake_quant_params on the card = on the CPU bit for bit over "
            f"{n} weights; layer 0's four kernels and the head = quant/blocks round trip "
            f"-> channelwise int8 (the serving chain) bit for bit")
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((8, 3, hp.img_size, hp.img_size))
                         .astype(np.float32)).cuda()
    with torch.no_grad():
        ln1 = {k: v[0] for k, v in gpu["blocks"]["ln1"].items()}
        y = layernorm(embed(gpu, x, hp), ln1["scale"], ln1["bias"], hp.eps)
        y_cpu = y.cpu()
        sx = (y_cpu.abs().amax() * 0.5 / 127.0).reshape(1, 1)  # half the range: clips
        for what, fn in (("fake_quant_act", qat.fake_quant_act),
                         ("fake_quant_act_static", lambda v: qat.fake_quant_act_static(
                             v, sx.to(v.device)))):
            a, b = fn(y).cpu(), fn(y_cpu)
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: card vs CPU differ on the layer-0 qkv input")
            log(f"qat codecs {what} on the layer-0 qkv input {tuple(y.shape)}: card = CPU "
                f"bit for bit")
        log(f"qat codecs: the static scale {float(sx):.4e} (half the input's range) clips "
            f"{int((y_cpu.abs() / sx > 127).sum())} of {y_cpu.numel()} values")
        rounded = {**gpu, "head": {**gpu["head"], "kernel": gpu["head"]["kernel"].half().float()},
                   "blocks": {k: ({**v, "kernel": v["kernel"].half().float()}
                                  if k in ("qkv", "proj", "fc1", "fc2") else v)
                              for k, v in gpu["blocks"].items()}}
        int8 = convert_params_to_int8(rounded)
        fq = qat.fake_quant_params(gpu, "w8a8")
        taps: dict = {}
        served = forward(int8, x, hp, tap=lambda n, v: taps.setdefault(n[:-3], []).append(v))
        worst, n = 0.0, 0
        for site, inputs in taps.items():
            for l, v in enumerate(inputs):
                leaf_s, leaf_q = ((int8["head"]["kernel"], fq["head"]["kernel"]) if site == "head"
                                  else (int8["blocks"][site]["kernel"][l],
                                        fq["blocks"][site]["kernel"][l]))
                a = w8a8_matmul(v, leaf_s)
                b = linear(v, leaf_q, impl="qat")
                worst = max(worst, float((a - b).abs().max() / a.abs().max()))
                n += 1
        chain = qat_chain(hp, embed(int8, x, hp), int8, fq, rounded)
        trained = forward(fq, x, hp, mm_impl="qat")
        dense = forward(gpu, x, hp)
    scale = float(served.abs().max())
    d_qat = float((trained - served).abs().max()) / scale
    d_dense = float((dense - served).abs().max()) / scale
    top2 = served.topk(2, dim=-1).values
    ties = (top2[:, 0] - top2[:, 1]) <= QAT_TIE * scale
    same = (trained.argmax(-1) == served.argmax(-1)) | ties
    log(f"qat w8a8 vs W8A8 on the card, ViT-B/16 B=8: each of the {n} linears fed the served "
        f"forward's input, max|d| / max|out| {worst:.3e} (bound {QAT_LINEAR_TOL:.0e}); blocks "
        f"chained on the served inputs: flipped codes at most {chain[0]:.3e} of a site's "
        f"(bound {QAT_FLIP_SHARE:.0e}), rms(qat - W8A8) / rms(dense - W8A8) at most "
        f"{chain[1]:.3e} (bound {QAT_BLOCK_RMS}); whole forwards max|d| / max|logit| "
        f"{d_qat:.3e} against the dense f32 forward's {d_dense:.3e}; argmax equal "
        f"{int(same.sum())}/8 ({int(ties.sum())} within {QAT_TIE} x max|logit| of a tie); "
        f"qat_codecs {time.perf_counter() - t0:.1f} s on {card}")
    if worst > QAT_LINEAR_TOL or not d_qat < d_dense or not same.all():
        raise AssertionError("the QAT w8a8 forward is not the W8A8 forward")


def qat_chain(hp, h, int8, fq, dense) -> tuple:
    """The QAT, W8A8 and dense blocks on the W8A8 forward's own input to
    each block (h: the embedded tokens; the trees as in qat_codecs):
    (the largest share of flipped activation codes at any linear's
    input, the largest rms(qat - W8A8) / rms(dense - W8A8) of a block's
    output). Raises past QAT_FLIP_SHARE or QAT_BLOCK_RMS."""
    from vit_cpp_tpu_torch.models.vit import transformer_block, unstack_blocks

    def codes(v):  # the per-token int8 codes of the W8A8 activations
        return torch.round(v * (127.0 / v.abs().amax(-1, keepdim=True).clamp_min(1e-30)))

    layers = [unstack_blocks(t["blocks"], hp.num_hidden_layers) for t in (int8, fq, dense)]
    worst_flip = worst_rms = 0.0
    for l, (bs, bq, bd) in enumerate(zip(*layers)):
        ins = ({}, {})
        s = transformer_block(h, bs, hp, attn_impl="xla", mm_impl="int8",
                              tap=lambda n, v: ins[0].__setitem__(n, v))
        q = transformer_block(h, bq, hp, attn_impl="xla", mm_impl="qat",
                              tap=lambda n, v: ins[1].__setitem__(n, v))
        d = transformer_block(h, bd, hp, attn_impl="xla", mm_impl="xla")
        if not torch.equal(ins[0]["qkv_in"], ins[1]["qkv_in"]):
            raise AssertionError(f"qat chain: block {l}'s qkv inputs differ")
        flips = {n: float((codes(ins[0][n]) != codes(ins[1][n])).float().mean())
                 for n in ins[0]}
        ratio = float((q - s).pow(2).mean().sqrt() / (d - s).pow(2).mean().sqrt())
        log(f"qat chain block {l:2d}: flipped codes " + ", ".join(
            f"{n[:-3]} {f:.2e}" for n, f in flips.items()) +
            f"; rms(qat - W8A8) / rms(dense - W8A8) {ratio:.3e}")
        worst_flip, worst_rms = max(worst_flip, *flips.values()), max(worst_rms, ratio)
        if max(flips.values()) > QAT_FLIP_SHARE or ratio > QAT_BLOCK_RMS:
            raise AssertionError(f"qat chain: block {l} flips {flips}, rms ratio {ratio}")
        h = s
    return worst_flip, worst_rms


def extras_parity(f32: str, teacher: str) -> None:
    """LoRA (rank 8, b a nonzero seeded draw) and soft distillation: loss
    and gradients card vs CPU at B=2 (card_vs_cpu); then two bf16-moment
    AdamW steps on the CPU's distillation gradients, card vs CPU."""
    from vit_cpp_tpu_torch.engine import detect_hparams
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.models.lora import LORA_SITES, lora_trainable
    from vit_cpp_tpu_torch.models.params import load_params
    from vit_cpp_tpu_torch.parallel.train import (
        distill_cross_entropy_loss, lora_cross_entropy_loss, make_optimizer, tree_leaves)

    mf, tmf = read_model(f32), read_model(teacher)
    hp, thp = detect_hparams(mf), detect_hparams(tmf)
    x, y = parity_batch(hp)
    base = load_params(mf, torch.float32, hparams=hp)
    trainable = lora_trainable(base, 8, seed=0)
    gen = torch.Generator().manual_seed(1)
    for name in LORA_SITES:
        b = trainable["lora"]["blocks"][name]["b"]
        b.copy_(torch.randn(b.shape, generator=gen) * 0.02)
    trainable["head"] = {k: v.clone() for k, v in trainable["head"].items()}

    def lora(dev):
        tr, bp = _tree_to(trainable, dev), _tree_to(base, dev)
        return (lambda: lora_cross_entropy_loss(tr, bp, x.to(dev), y.to(dev), hp, 16.0)), tr

    card_vs_cpu("slice parity LoRA r=8 (a, b, head)", lora)
    t_cpu = load_params(tmf, torch.float32, hparams=thp)

    def distill(dev):
        student, t = _tree_to(base, dev), _tree_to(t_cpu, dev)
        return (lambda: distill_cross_entropy_loss(student, t, x.to(dev), y.to(dev), hp, thp,
                                                   0.5, 3.0, "soft")), student

    grads = card_vs_cpu("slice parity distill soft (alpha 0.5, tau 3)", distill)
    out = {}
    for dev in ("cuda", "cpu"):
        params = [p.detach().clone().to(dev) for p in tree_leaves(base)]
        opt = make_optimizer(params, lr=1e-3, weight_decay=0.05, mu_dtype="bf16")
        for scale in (1.0, -0.5):  # the second step reads a nonzero bf16 moment
            for p, g in zip(params, grads):
                p.grad = (g * scale).to(dev)
            opt.step()
        st = [opt.adamw.state[p] for p in params]
        out[dev] = ([p.cpu() for p in params], [s["exp_avg"].cpu() for s in st],
                    [s["exp_avg_sq"].cpu() for s in st])
    (p_card, m_card, v_card), (p_cpu, m_cpu, v_cpu) = out["cuda"], out["cpu"]
    if not all(torch.equal(a, b) for a, b in zip(m_card, m_cpu)):
        raise AssertionError("bf16 AdamW: the bf16 first moments differ card vs CPU")
    v_rel = max(float((a - b).abs().max() / max(b.abs().max(), 1e-30))
                for a, b in zip(v_card, v_cpu))
    # per leaf, in ulps of the leaf's largest parameter (its f32 scale)
    ulps = max(float((a - b).abs().max()) / float(np.spacing(b.abs().max().numpy()))
               for a, b in zip(p_card, p_cpu))
    changed = sum(int((a != b).sum()) for a, b in zip(p_card, p_cpu))
    log(f"bf16-moment AdamW, 2 steps on the CPU's distillation gradients ({len(p_cpu)} leaves): "
        f"first moments (bf16) card = CPU bit for bit, second moments max rel {v_rel:.2e}, "
        f"parameters at most {ulps:.3f} f32 ulp of their leaf's scale apart ({changed} of "
        f"{sum(b.numel() for b in p_cpu)} elements differ; bound {ADAMW_ULPS})")
    if ulps > ADAMW_ULPS:
        raise AssertionError(f"bf16 AdamW parameters {ulps} ulps apart card vs CPU")


def extras_finetune(what: str, argv: list, updates: int, per_update: int = 12) -> dict:
    """One cli.finetune run on the card: finite losses, `per_update` (the
    depth) attention_qkv + attention_qkv_grad launches per update, ms per
    update after the first, peak device memory. Returns {"k1", "k2", "ms",
    "peak_gib"}."""
    from vit_cpp_tpu_torch.cli import finetune as cli_finetune
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL

    err = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.reset()
    GRAD_KERNEL.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli_finetune.main([*argv, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1, k2, peak = KERNEL.launches, GRAD_KERNEL.launches, torch.cuda.max_memory_allocated()
    for line in err.getvalue().splitlines():
        log(f"{what}: {line}")
    losses = [float(v) for v in re.findall(r"^epoch \d+/\d+: loss (\S+)", err.getvalue(), re.M)]
    timing = re.search(r"([\d.]+) ms per update after the first", err.getvalue())
    if rc != 0 or not losses or not np.isfinite(losses).all() or timing is None:
        raise AssertionError(f"{what}: rc {rc}, losses {losses}")
    if (k1, k2) != (per_update * updates, per_update * updates):
        raise AssertionError(f"{what}: launches {k1} attention_qkv + {k2} attention_qkv_grad "
                             f"for {updates} updates (want {per_update} each per update)")
    ms = float(timing.group(1))
    log(f"{what}: {updates} updates, losses {losses}, {ms} ms per update after the first, "
        f"peak device memory {peak / 2**30:.2f} GiB, run {seconds:.1f} s; launches {k1} "
        f"attention_qkv + {k2} attention_qkv_grad = {per_update} + {per_update} per update")
    return {"k1": k1, "k2": k2, "ms": ms, "peak_gib": peak / 2**30}


def served_check(what: str, model: str, kw: dict, per_batch: dict, tol: float) -> dict:
    """serve_files over the ten assets at batch 8 through build_engine(**kw):
    each kernel's launches per batch, probabilities within `tol` of the
    f32 engine (mm=xla, attn=xla) on the same file. Returns {name: launches}."""
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.serve import serve_files

    paths, _ = asset_bodies()
    ref = VitEngine(model, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda",
                    verbose=False)
    want = ref.predict_probs_batch(ref.preprocess_images(load_images_rgb_batch(paths)))
    want = want.cpu().numpy()
    del ref
    engine, _ = build_engine(model, device="cuda", **kw)
    for kernel in per_batch:
        kernel.reset()
    got = list(serve_files(engine, paths, batch=8, keep_probs=True))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in per_batch}
    worst = max(float(np.abs(r.probs - p).max()) for r, p in zip(got, want))
    log(f"{what}: serve_files (batch 8, {engine.dtype} mm={engine.mm_impl} attn="
        f"{engine.attn_impl}) vs the f32 engine worst {worst:.2e} (tolerance {tol:.0e}) over "
        f"10 x {want.shape[1]}; launches {launches} for 2 batches")
    if worst > tol or any(launches[k.name] != 2 * n for k, n in per_batch.items()):
        raise AssertionError(f"{what}: off by {worst} or launches {launches}")
    return launches


def vitstr_gt(root: str, n: int = 64) -> str:
    """A gt.txt over the six assets/vitstr images, cycled to n samples."""
    os.makedirs(root)
    demos = vitstr_assets()
    with open(os.path.join(root, "gt.txt"), "w") as f:
        for i in range(n):
            path = demos[i % len(demos)]
            f.write(f"{path}\t{os.path.splitext(os.path.basename(path))[0].replace('_', '')}\n")
    return root


def training_extras(f16: str, f32: str, tmp: str, card: str) -> tuple:
    """Phase `training_extras`: the QAT codecs, LoRA / distillation /
    bf16-moment slice parity, then cli.finetune on the card without an
    extra (the baseline of the same call) and with each (2 updates of
    B=32 on the dark/bright set of (g); T=785 at B=8, 8 updates) and the
    outputs served. Returns ({path: {kernel name: launches}} for
    K1 and K4, {path: attention_qkv_grad launches})."""
    from vit_cpp_tpu_torch.cli import quantize
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL
    from vit_cpp_tpu_torch.serve import recognize_files

    t0 = time.perf_counter()
    qat_codecs(f32, card)
    extras_parity(f32, f16)
    data = os.path.join(tmp, "train")  # (g)'s 2 x 32 dark / bright images
    words = vitstr_gt(os.path.join(tmp, "vitstr-train"))
    out = {k: os.path.join(tmp, f"ft-{k}.gguf")
           for k in ("full", "lora", "distill", "qat", "bf16", "p8", "siglip", "vitstr")}
    # (key, what, model, data, flags, batch), one epoch of 64 images: 2
    # updates at B=32, 8 at B=8. Not more: the served QAT output's static
    # scales, measured on the noise images, move the ten photos'
    # probabilities further from the f32 engine's as its head trains, in
    # the JAX package too (tests/test_torch_qat.py); 3 epochs took them
    # 1.42e-2 apart on an NVIDIA H100 80GB HBM3 (700.00 W), past PROB_TOL
    runs = (
        ("full", "cli.finetune (full, f32 moment: the baseline)", f16, data, [], 32),
        ("lora", "cli.finetune --lora 8", f16, data, ["--lora", "8"], 32),
        ("distill", "cli.finetune --distill ft.gguf", f16, data,
         ["--distill", os.path.join(tmp, "ft.gguf")], 32),
        ("qat", "cli.finetune --qat q8_0 --qat-act static", f16, data,
         ["--qat", "q8_0", "--qat-act", "static"], 32),
        ("bf16", "cli.finetune --mu-dtype bf16", f16, data, ["--mu-dtype", "bf16"], 32),
        ("p8", "cli.finetune --patch-size 8 -b 8 (T=785)", f16, data,
         ["--patch-size", "8"], 8),
        ("siglip", "cli.finetune SigLIP-B/16 + head", os.path.join(
            tmp, "siglip-b16-synthetic-f16.gguf"), data, [], 32),
        ("vitstr", "cli.finetune ViTSTR-B (gt.txt)", os.path.join(
            tmp, "vitstr-b16-synthetic-f16.gguf"), words, [], 32),
    )
    k1, k2, rows = {}, {}, {}
    for key, what, model, d, flags, batch in runs:
        r = extras_finetune(what, ["-m", model, "-d", d, "-o", out[key], "-b", str(batch),
                                   "--epochs", "1", *flags], 64 // batch)
        k1[what], k2[what], rows[what] = {KERNEL.name: r["k1"]}, r["k2"], r
    log("training extras, ms per update after the first / peak GiB on " + card + ": " +
        "; ".join(f"{w} {r['ms']} / {r['peak_gib']:.2f}" for w, r in rows.items()))

    sidecar = out["qat"] + ".act_scales.json"
    q8 = os.path.join(tmp, "ft-qat-q8_0.gguf")
    with contextlib.redirect_stdout(io.StringIO()):
        if quantize.main([out["qat"], q8, "8"]) != 0:
            raise AssertionError("cli.quantize failed on the QAT output")
    paths, _ = asset_bodies()
    procs = {
        "cli.serve QAT output --act static --act-scales": start_module(
            "vit_cpp_tpu_torch.cli.serve", "-m", out["qat"], *paths, "-b", "8", "-k", "2",
            "--act", "static", "--act-scales", sidecar),
        "cli.serve QAT output Q8_0 --mm pallas": start_module(
            "vit_cpp_tpu_torch.cli.serve", "-m", q8, *paths, "-b", "8", "-k", "2",
            "--mm", "pallas"),
    }
    try:
        k1["LoRA output served (defaults)"] = served_check(
            "LoRA output (folded)", out["lora"], {}, {KERNEL: 12}, PROB_TOL)
        k1["QAT output --act static"] = served_check(
            "QAT output --act static --act-scales", out["qat"],
            {"act": "static", "act_scales": sidecar}, {KERNEL: 12}, PROB_TOL)
        k1["QAT output Q8_0 --mm pallas"] = served_check(
            "QAT output Q8_0 --mm pallas", q8, {"mm": "pallas"}, {KERNEL: 12, QMM_KERNEL: 49},
            Q8_PROB_TOL)
        k1["SigLIP + head served (defaults)"] = served_check(
            "SigLIP-B/16 + head output", out["siglip"], {}, {KERNEL: 12}, PROB_TOL)
        engine, is_vitstr = build_engine(out["vitstr"], device="cuda")
        KERNEL.reset()
        recs = list(recognize_files(engine, vitstr_assets(), batch=8))
        torch.cuda.synchronize()
        if not is_vitstr or KERNEL.launches != 12 or not all(
                0.0 <= r.confidence <= 1.0 for r in recs):
            raise AssertionError(f"ViTSTR output: {recs}, {KERNEL.launches} launches")
        k1["ViTSTR output recognize_files"] = {KERNEL.name: KERNEL.launches}
        log(f"ViTSTR-B output through recognize_files: {[r.text for r in recs]}, confidences "
            f"{[f'{r.confidence:.3e}' for r in recs]}, {KERNEL.launches} attention_qkv launches "
            "for 1 batch")
        for what, proc in procs.items():
            model = out["qat"] if "static" in what else q8
            ref = VitEngine(model, dtype="f32", mm_impl="xla", attn_impl="xla", device="cuda",
                            verbose=False)
            ref_probs = ref.predict_probs_batch(
                ref.preprocess_images(load_images_rgb_batch(paths))).cpu().numpy()
            check_cli_serve(what, proc, paths, ref_probs, ref.id2label, PROB_TOL)
            del ref
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
    log(f"training_extras: {time.perf_counter() - t0:.1f} s")
    return k1, k2


# The AOT artifact (phase `aot_paths`): the port's vit-export output served
# against the gguf engine of the same flags. The artifact's program runs the
# same kernels on the same operands as the engine's eager forward, so the
# probabilities agree to the last bits that summation order leaves.
AOT_TOL = 1e-5
# forward_debug on the card against the card machine's CPU (f32): each
# stage's max|card - cpu| over max(1, max|cpu|). The f32 rung (TF32 off,
# composed attention) differs by summation order; the bf16 W8A8 rung by
# bf16 rounding and int8 codes. The first stage over its tolerance is
# reported; the run fails on the final probabilities only (CLI_PROB_TOL for
# f32, PROB_TOL for W8A8, the bounds of the vit CLI and daemon phases).
STAGE_TOL = {"f32 xla": 1e-4, "bf16 W8A8 pallas-fast": 5e-2}

# Serves an artifact in a process that cannot import the model code, JAX or
# the JAX package: the probabilities of each baked batch on the pixels of
# argv[2] to argv[3] (.npz), and a JSON line with the load time and
# attention_qkv's launches per batch.
_AOT_CHILD = r"""
import json, sys
for name in ("jax", "vit_cpp_tpu", "vit_cpp_tpu_torch.models.vit",
             "vit_cpp_tpu_torch.models.params", "vit_cpp_tpu_torch.engine"):
    sys.modules[name] = None
import numpy as np, torch
from vit_cpp_tpu_torch.aot import AotEngine
from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
engine = AotEngine(sys.argv[1])
x = torch.from_numpy(np.load(sys.argv[2])).cuda()
res, probs = {"load_ms": engine.load_ms, "launches": {}}, {}
for b in engine.batches:
    engine.predict_probs_batch(x[:b])
    torch.cuda.synchronize()
    KERNEL.reset()
    p = engine.predict_probs_batch(x[:b])
    torch.cuda.synchronize()
    res["launches"][str(b)] = KERNEL.launches
    probs[str(b)] = p.cpu().numpy()
np.savez(sys.argv[3], **probs)
print(json.dumps(res))
"""

# Loads a card artifact with no card visible: must fail with the message.
_NO_CARD = r"""
import sys
sys.modules["jax"] = None
sys.modules["vit_cpp_tpu"] = None
from vit_cpp_tpu_torch.aot import AotEngine
try:
    AotEngine(sys.argv[1])
except ValueError as e:
    print(e)
    sys.exit(3)
"""


def export_cli(*argv: str) -> tuple:
    """vit_cpp_tpu_torch.cli.export_aot.main in this process: (rc, stdout,
    stderr, seconds)."""
    from vit_cpp_tpu_torch.cli import export_aot

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = export_aot.main(list(argv))
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def aot_launches(what: str, engine, pixels, per_batch: dict) -> dict:
    """One forward of `engine` with the counts set to 0 just before: each
    kernel of `per_batch` must have launched its count."""
    for kernel in per_batch:
        kernel.reset()
    out = engine.predict_probs_batch(pixels)
    torch.cuda.synchronize()
    launches = {kernel.name: kernel.launches for kernel in per_batch}
    for kernel, each in per_batch.items():
        if launches[kernel.name] != each:
            raise AssertionError(f"{what}: {kernel.name} launched {launches[kernel.name]} "
                                 f"times in one batch (want {each})")
    return out, launches


AOT_BLOCKS = 6  # the depth of aot_paths' artifacts and of mesh_paths' sharded ones
AOT_LOAD_MS = {}  # aot_paths' unsharded artifact's load ms, beside mesh_paths' sharded ones
MESH_EXPORTS = {}  # mesh_paths' sharded exports, started in aot_paths


def aot_paths(f16: str, q8: str, tmp: str, card: str) -> dict:
    """The AOT serving artifact (phase `aot_paths`) on the synthetic
    ViT-B/16 at its width and AOT_BLOCKS blocks (the depth cut to keep the
    script's time): `cli.export_aot -b 1,64` at the serving defaults and
    its --info; the artifact served in a fresh process that cannot import
    the model code, with the gguf moved away, against the gguf engine's
    probabilities at B=64 and B=1 (AOT_TOL) with AOT_BLOCKS attention_qkv
    launches per batch; a Q8_0 file exported with --mm pallas (25
    dequant_matmul + 6 attention_qkv per batch) and the f16 file with
    --act static --calib-dir assets, each against its gguf engine; cli.vit, cli.serve,
    the cli.server daemon with --bucket (over the baked 1 and 64) and
    cli.benchmark on the artifact, as subprocesses beside those checks;
    the card artifact refused on the CPU and in a process with no card, a
    CPU artifact refused on the card; then, the subprocesses done, load ms
    and the B=64 and B=1 forwards beside the gguf engine's (median of 20
    in turns, one profiled run each). mesh_paths' two sharded exports run
    under the launcher beside this phase and end before its timings
    (start_mesh_exports, finish_mesh_exports). Returns {path: {kernel
    name: launches}}."""
    import shutil

    from vit_cpp_tpu_torch.aot import AotEngine, read_meta
    from vit_cpp_tpu_torch.cli import quantize
    from vit_cpp_tpu_torch.cli.common import build_engine, calibrate_engine_from_paths
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL
    from vit_cpp_tpu_torch.testing.synthetic import write_synthetic_model

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "aot")
    os.makedirs(d)
    # ViT-B/16's width at AOT_BLOCKS blocks, for every export
    f16, q8 = (os.path.join(d, f"vit-b16-6-blocks-{k}.gguf") for k in ("f16", "q8_0"))
    write_synthetic_model(f16, VitHParams(**{**VIT_B16, "num_hidden_layers": AOT_BLOCKS}),
                          ftype=1, seed=0)
    with contextlib.redirect_stdout(io.StringIO()):
        if quantize.main([f16, q8, "8"]) != 0:
            raise AssertionError("cli.quantize failed on the 6-block file")
    # mesh_paths' sharded artifacts, exported under the launcher meanwhile
    MESH_EXPORTS.update(start_mesh_exports(f16, q8, tmp))
    gguf = os.path.join(d, "vit-b16-6-blocks-served.gguf")
    shutil.copyfile(f16, gguf)
    art = os.path.join(d, "vit-b16-w8a8.vitx")
    rc, _, err, secs = export_cli(gguf, art, "-b", "1,64")
    if rc != 0:
        raise AssertionError(f"cli.export_aot -b 1,64: exit {rc}: {err}")
    log(f"cli.export_aot -b 1,64 (bf16 W8A8 fold, fast fused attention): {err.strip()} "
        f"in {secs:.1f} s")
    rc, info, _, _ = export_cli("--info", art)
    meta = json.loads(info)
    if rc != 0 or meta != read_meta(art) or meta["platforms"] != ["torch-cuda"]:
        raise AssertionError(f"cli.export_aot --info: exit {rc}, {info[:500]}")
    log("cli.export_aot --info: " + json.dumps({k: v for k, v in meta.items()
                                                if k not in ("id2label", "hparams")}))

    engine, _ = build_engine(gguf, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(15)
    pixels = torch.randn((64, 3, 224, 224), generator=gen, device="cuda")
    want = {b: engine.predict_probs_batch(pixels[:b]).cpu().numpy() for b in (1, 64)}
    pix = os.path.join(d, "pixels.npy")
    np.save(pix, pixels.cpu().numpy())
    os.rename(gguf, gguf + ".moved")
    env = dict(os.environ, PYTHONPATH=HERE)
    child = subprocess.Popen([sys.executable, "-c", _AOT_CHILD, art, pix,
                              os.path.join(d, "p.npz")], cwd=HERE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env)
    nocard = subprocess.Popen([sys.executable, "-c", _NO_CARD, art], cwd=HERE,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(env, CUDA_VISIBLE_DEVICES=""))
    # the front ends on the artifact, as a user runs them
    paths, bodies = asset_bodies()
    magpie = os.path.join(HERE, "assets", "magpie.jpeg")
    val = write_dark_bright(os.path.join(d, "bench", "val"), 4)
    procs = {
        "cli.vit": start_module("vit_cpp_tpu_torch.cli.vit", "-m", art, "-i", magpie,
                                "-k", "5"),
        "cli.serve": start_module("vit_cpp_tpu_torch.cli.serve", "-m", art, *paths,
                                  "-b", "8", "-k", "5"),
        "cli.server": start_module("vit_cpp_tpu_torch.cli.server", "-m", art, "--bucket",
                                   "--port", "0"),
        "cli.benchmark": start_module("vit_cpp_tpu_torch.cli.benchmark", art, val, "0",
                                      os.path.join(d, "bench", "p.csv"), "--ext", ".png"),
    }
    out = {}

    # the two other exports
    art_q8 = os.path.join(d, "vit-b16-q8_0-pallas.vitx")
    rc, _, err, secs = export_cli(q8, art_q8, "-b", "8", "--mm", "pallas")
    if rc != 0:
        raise AssertionError(f"cli.export_aot --mm pallas: exit {rc}: {err}")
    q8_engine, _ = build_engine(q8, mm="pallas", device="cuda")
    p, out["vitx Q8_0 --mm pallas B=8"] = aot_launches(
        "aot Q8_0 --mm pallas", AotEngine(art_q8), pixels[:8],
        {QMM_KERNEL: 4 * AOT_BLOCKS + 1, KERNEL: AOT_BLOCKS})
    err_q8 = float((p - q8_engine.predict_probs_batch(pixels[:8])).abs().max())
    log(f"cli.export_aot Q8_0 --mm pallas -b 8 in {secs:.1f} s: {err.strip()}; launches per "
        f"batch {out['vitx Q8_0 --mm pallas B=8']}, max|p_aot - p_gguf| {err_q8:.2e}")
    del q8_engine

    assets = os.path.join(HERE, "assets")
    art_st = os.path.join(d, "vit-b16-static.vitx")
    rc, _, err, secs = export_cli(f16, art_st, "-b", "8", "--act", "static",
                                  "--calib-dir", assets)
    if rc != 0:
        raise AssertionError(f"cli.export_aot --act static: exit {rc}: {err}")
    live, _ = build_engine(f16, act="static", device="cuda")
    if not calibrate_engine_from_paths(live, assets):
        raise AssertionError("static calibration on assets/ rejected by the guardrail")
    static = AotEngine(art_st)
    p, out["vitx --act static B=8"] = aot_launches("aot static", static, pixels[:8],
                                                   {KERNEL: AOT_BLOCKS})
    err_st = float((p - live.predict_probs_batch(pixels[:8])).abs().max())
    log(f"cli.export_aot --act static --calib-dir assets -b 8 in {secs:.1f} s: meta act "
        f"{static.meta['act']!r}; max|p_aot - p_live static| {err_st:.2e}")
    act = static.meta["act"]
    del live, static
    if act != "static" or max(err_q8, err_st) > AOT_TOL:
        raise AssertionError(f"aot: Q8_0 pallas off by {err_q8}, static by {err_st}, "
                             f"meta act {act!r}")

    # cross-device loads
    try:
        AotEngine(art, device="cpu")
        raise AssertionError("a card artifact loaded on the CPU")
    except ValueError as e:
        log(f"card artifact on device cpu refused: {e}")
    tiny = os.path.join(d, "tiny.gguf")
    write_synthetic_model(tiny, VitHParams(hidden_size=64, num_hidden_layers=2,
                                           num_attention_heads=2, num_classes=7,
                                           patch_size=8, img_size=32), ftype=1, seed=0)
    cpu_art = os.path.join(d, "tiny-cpu.vitx")
    rc, _, err, _ = export_cli(tiny, cpu_art, "-b", "2", "--device", "cpu")
    if rc != 0:
        raise AssertionError(f"cli.export_aot --device cpu: exit {rc}: {err}")
    try:
        AotEngine(cpu_art)
        raise AssertionError("a CPU artifact loaded on the card")
    except ValueError as e:
        log(f"CPU artifact on device cuda refused: {e}")

    aot_engine = AotEngine(art)
    AOT_LOAD_MS["vitx W8A8 -b 1,64"] = aot_engine.load_ms
    size = os.path.getsize(art)
    log(f"artifact {os.path.basename(art)}: {size / 1e6:.1f} MB for batches "
        f"{aot_engine.batches} (blobs {meta['blob_lengths']}); AotEngine.load_ms "
        f"{aot_engine.load_ms:.1f}, VitEngine.load_ms {engine.load_ms:.1f} (the gguf engine "
        f"of the same flags) on {card}")

    c_out, c_err = child.communicate(timeout=300)
    if child.returncode != 0:
        raise AssertionError(f"artifact without model code: exit {child.returncode}: "
                             f"{c_err[-3000:]}")
    res = json.loads(c_out.splitlines()[-1])
    got = np.load(os.path.join(d, "p.npz"))
    errs = {b: float(np.abs(got[str(b)] - want[b]).max()) for b in (1, 64)}
    log(f"artifact served without models.vit, models.params, engine, jax or the gguf "
        f"(fresh process): load {res['load_ms']:.1f} ms, attention_qkv launches per batch "
        f"{res['launches']}, max|p_aot - p_gguf| B=1 {errs[1]:.2e}, B=64 {errs[64]:.2e} "
        f"(tolerance {AOT_TOL:.0e}) on {card}")
    if (res["launches"] != {"1": AOT_BLOCKS, "64": AOT_BLOCKS}
            or max(errs.values()) > AOT_TOL):
        raise AssertionError(f"artifact: launches {res['launches']}, errors {errs}")
    os.rename(gguf + ".moved", gguf)
    nc_out, nc_err = nocard.communicate(timeout=300)
    if nocard.returncode != 3 or "torch.cuda.is_available() is False" not in nc_out:
        raise AssertionError(f"card artifact with no card: exit {nocard.returncode}, "
                             f"{nc_out} {nc_err[-2000:]}")
    log(f"card artifact in a process with CUDA_VISIBLE_DEVICES='' refused: {nc_out.strip()}")

    images = load_images_rgb_batch(paths)
    ref = engine.predict_probs_batch(engine.preprocess_images(images + images[:1] * 54))
    ref = ref[:10].cpu().numpy()
    want_top = aot_engine.classify_file(magpie, topk=5, verbose=False)
    gguf_top = engine.classify_file(magpie, topk=5, verbose=False)
    line = _read_banner(procs["cli.server"], 240)
    base = line.split(" on ")[1].split()[0]
    with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
        health = json.loads(resp.read())
    with ThreadPoolExecutor(len(bodies)) as ex:
        answers = list(ex.map(lambda b: post(base + "/v1/classify?topk=5", b), bodies))
    status_embed = post(base + "/v1/embed", bodies[0])[0]
    with urllib.request.urlopen(base + "/stats", timeout=60) as resp:
        stats = json.loads(resp.read())
    procs["cli.server"].send_signal(signal.SIGTERM)
    worst = 0.0
    for (code, ans, _), p in zip(answers, ref):
        if code != 200:
            raise AssertionError(f"cli.server on the artifact: HTTP {code} {ans}")
        worst = max(worst, max(abs(e["prob"] - p[e["id"]]) for e in ans["topk"]))
    log(f"cli.server -m vitx --bucket: {line}; /healthz {json.dumps(health)}; ten assets "
        f"at once, top-5 vs the gguf engine's B=64 probabilities worst {worst:.2e} "
        f"(tolerance {PROB_TOL:.0e}); /v1/embed on a classifier artifact HTTP {status_embed}; "
        f"/stats {json.dumps(stats)}")
    if health.get("buckets") != [1, 64] or worst > PROB_TOL or status_embed != 404:
        raise AssertionError("cli.server on the artifact: buckets, answers or embed route off")
    if procs["cli.server"].wait(timeout=60) != 0:
        raise AssertionError("cli.server on the artifact exited nonzero on SIGTERM")
    out_v, err_v = procs["cli.vit"].communicate(timeout=300)
    lines = [ln for ln in out_v.splitlines() if ln.startswith(" > ")]
    if procs["cli.vit"].returncode != 0 or lines != [f" > {lab} : {p:.2f}"
                                                      for _, p, lab in want_top]:
        raise AssertionError(f"cli.vit on the artifact: {out_v!r} {err_v[-2000:]}")
    log(f"cli.vit -m vitx: rc 0, top-5 {[c for c, _, _ in want_top]} (the gguf engine's "
        f"{[c for c, _, _ in gguf_top]}); " + "; ".join(
            ln.strip() for ln in err_v.splitlines() if "time" in ln))
    out_s, err_s = procs["cli.serve"].communicate(timeout=300)
    rows = [ln.split("\t") for ln in out_s.splitlines()]
    if (procs["cli.serve"].returncode != 0 or [r[0] for r in rows] != paths
            or "compiled for batch 64; using it (ignoring -b 8)" not in err_s):
        raise AssertionError(f"cli.serve on the artifact: {out_s!r} {err_s[-2000:]}")
    for (_, tags), p in zip(rows, ref):
        first = tags.split(" ")[0].rsplit(":", 1)
        if abs(float(first[1]) - p.max()) > PROB_TOL + 0.005:
            raise AssertionError(f"cli.serve on the artifact: {tags!r} vs {p.max()}")
    log("cli.serve -m vitx: rc 0, 10 lines; " + "; ".join(
        ln for ln in err_s.strip().splitlines() if ln.startswith("serve:")))
    out_b, err_b = procs["cli.benchmark"].communicate(timeout=300)
    with open(os.path.join(d, "bench", "p.csv")) as f:
        n_rows = len(f.read().splitlines())
    if (procs["cli.benchmark"].returncode != 0 or n_rows != 8
            or "compiled for batch 64" not in err_b
            or not out_b.splitlines()[-1].startswith("Top-1 Accuracy: ")):
        raise AssertionError(f"cli.benchmark on the artifact: {n_rows} rows, {out_b} {err_b}")
    log(f"cli.benchmark -m vitx: rc 0, {n_rows} rows, {out_b.splitlines()[-1]}; "
        + "; ".join(ln for ln in err_b.splitlines() if ln.startswith("benchmark:")))

    finish_mesh_exports(MESH_EXPORTS)  # nothing else on the card while the forwards are timed
    _, out["vitx W8A8 -b 1,64 B=64"] = aot_launches("aot W8A8 B=64", aot_engine, pixels,
                                                    {KERNEL: AOT_BLOCKS})
    for b in (64, 1):
        timed_forwards(f"forward W8A8 bf16 B={b}", {
            "VitEngine (gguf)": lambda: engine.predict_probs_batch(pixels[:b]),
            "AotEngine (vitx)": lambda: aot_engine.predict_probs_batch(pixels[:b]),
        }, card, batch=b)
    log(f"phase aot_paths: {time.perf_counter() - t_phase:.1f} s")
    return out


def shard_kernels(card: str) -> dict:
    """Each kernel at the shapes one rank of a tensor-parallel mesh gives it
    (tp = 2 and 4 on ViT-B/16; tp = 1 is the unsharded call of the same
    layer), held to its plain version with the existing tolerances and
    timed with cuda_ms beside it: attention_qkv bf16 fast at B=64 and f32
    safe at B=32 (nh/tp heads), attention_qkv_grad f32 at B=32,
    dequant_matmul Q8_0 bf16 at B=64 on the column shards (qkv, fc1: N/tp)
    and the row shards (proj, fc2: K/tp), and W8A8's int8 product
    (int8_mm, torch._int_mm) at the same shards against an exact f64
    product. Returns {kernel name: {case: (ms, plain_ms, bound_ms,
    bound_by, library_ms)}} and the worst errors."""
    from vit_cpp_tpu_torch.gguf.dtypes import GGMLDType as G
    from vit_cpp_tpu_torch.ops.flash_attention import (
        attention_qkv,
        attention_qkv_grad,
        attention_qkv_grad_plain,
        attention_qkv_plain,
    )
    from vit_cpp_tpu_torch.ops.int8_matmul import int8_mm
    from vit_cpp_tpu_torch.ops.qmatmul import dequant_matmul, dequant_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"attention_qkv": {}, "dequant_matmul": {}, "dequant_matmul f32_out": {},
           "attention_qkv_grad": {}, "int8_mm": {}}
    errs = {k: 0.0 for k in out}
    for tp in (1, 2, 4):
        h, nh = 768 // tp, 12 // tp
        for b, dtype, fast in ((64, bf16, True), (32, f32, False)):
            qkv = torch.randn((b, 197, 3 * h), generator=gen, device="cuda").to(dtype)
            got, ref = attention_qkv(qkv, nh, fast=fast), attention_qkv_plain(qkv, nh, fast=fast)
            err = (got.float() - ref.float()).abs().max().item()
            what = f"tp{tp} B={b} {str(dtype)[6:]} {'fast' if fast else 'safe'} nh={nh}"
            log(f"kernel case mesh shard attention_qkv {what}: max|kernel - plain| = "
                f"{err:.3e} (tolerance {TOL[dtype]:.0e})")
            if not err <= TOL[dtype]:
                raise AssertionError(f"attention_qkv {what}: error {err}")
            errs["attention_qkv"] = max(errs["attention_qkv"], err)
            k_ms, p_ms = time_pair(f"mesh shard attention_qkv {what}", card,
                                   lambda: attention_qkv(qkv, nh, fast=fast),
                                   lambda: attention_qkv_plain(qkv, nh, fast=fast))
            out["attention_qkv"][what] = (
                k_ms, p_ms, *attention_bound(b, 197, h, qkv.element_size()), sdpa_ms(qkv, nh))
        qkv = torch.randn((32, 197, 3 * h), generator=gen, device="cuda")
        do = torch.randn((32, 197, h), generator=gen, device="cuda")
        got, ref = attention_qkv_grad(qkv, do, nh), attention_qkv_grad_plain(qkv, do, nh)
        err = (got - ref).abs().max().item()
        tol = GRAD_TOL[f32] * ref.abs().max().item()
        what = f"tp{tp} B=32 f32 nh={nh}"
        log(f"kernel case mesh shard attention_qkv_grad {what}: max|kernel - plain| = "
            f"{err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"attention_qkv_grad {what}: error {err} > {tol}")
        errs["attention_qkv_grad"] = max(errs["attention_qkv_grad"], err)
        k_ms, p_ms = time_pair(f"mesh shard attention_qkv_grad {what}", card,
                               lambda: attention_qkv_grad(qkv, do, nh),
                               lambda: attention_qkv_grad_plain(qkv, do, nh))
        out["attention_qkv_grad"][what] = (
            k_ms, p_ms, *k2_bound(32, 197, h, 4), sdpa_grad_ms(qkv, do, nh))
        rng = np.random.default_rng(tp)
        m = 64 * 197
        for layer, k, n in (("qkv", 768, 2304 // tp), ("fc1", 768, 3072 // tp),
                            ("proj", 768 // tp, 768), ("fc2", 3072 // tp, 768)):
            what = f"{layer} tp{tp} M={m} K={k} N={n}"
            w = _quant_linear(rng, k, n, G.Q8_0)
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
            got, ref = dequant_matmul(x, w), dequant_matmul_plain(x, w)
            err = (got.float() - ref.float()).abs().max().item()
            tol = QMM_TOL[bf16] * ref.float().abs().max().item()
            log(f"kernel case mesh shard dequant_matmul {what} Q8_0 bf16: max|kernel - plain| = "
                f"{err:.3e} (tolerance {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"dequant_matmul {what}: error {err} > {tol}")
            errs["dequant_matmul"] = max(errs["dequant_matmul"], err)
            k_ms, p_ms = time_pair(f"mesh shard dequant_matmul {what} Q8_0 bf16", card,
                                   lambda: dequant_matmul(x, w), lambda: dequant_matmul_plain(x, w))
            dense = w.dequantize(bf16)
            out["dequant_matmul"][what] = (
                k_ms, p_ms, *bound(2.0 * m * k * n, 2 * m * k + k * n // 32 * 34 + 2 * m * n,
                                   "bf16"),
                cuda_ms(lambda: torch.matmul(x, dense)))
            if tp > 1 and layer in ("proj", "fc2"):
                _check_row_partial(x, dense, what, card)
                row, f32_err = _check_k4_f32_out(x, w, dense, what, card)
                out["dequant_matmul f32_out"][what] = row
                errs["dequant_matmul f32_out"] = max(errs["dequant_matmul f32_out"], f32_err)
                x32 = torch.randn((m, k), generator=gen, device="cuda")
                errs["dequant_matmul f32 x"] = max(errs.get("dequant_matmul f32 x", 0.0),
                                                   _check_k4_f32_x(x32, w, what, card))
            xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
            codes = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                                  dtype=torch.int8)
            acc = int8_mm(xq, codes)
            exact = torch.matmul(xq.double(), codes.double())
            err = (acc.double() - exact).abs().max().item()
            log(f"kernel case mesh shard int8_mm {what}: max|int8_mm - f64 product| = {err:.1f} "
                f"(exact: tolerance 0)")
            if err != 0:
                raise AssertionError(f"int8_mm {what}: error {err}")
            i_ms = cuda_ms(lambda: int8_mm(xq, codes))
            f_ms = cuda_ms(lambda: torch.matmul(xq.double(), codes.double()))
            # int8 in, int32 out; the library call is int8_mm itself
            out["int8_mm"][what] = (i_ms, f_ms, *bound(2.0 * m * k * n, m * k + k * n + 4 * m * n,
                                                       "int8"), None)
            log(f"timing mesh shard int8_mm {what} on {card}: {i_ms:.4f} ms per call, the f64 "
                f"product {f_ms:.4f} ms")
    for kernel, rows in out.items():
        for what, (k_ms, p_ms, b_ms, b_by, lib) in rows.items():
            log(f"mesh shard {kernel} {what}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), library "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'} on {card}")
    return out, errs


def _check_k4_f32_out(x, w, dense, what: str, card: str) -> tuple:
    """K4's f32-output instantiation at a row shard (what a bf16 rank of a
    `--mm pallas` engine sums over "model" before it rounds): f32, within
    ROW_PARTIAL_TOL of max|f64 product|, timed beside its plain version,
    the bf16-output call and torch.mm with an f32 output on the weight
    dequantized once. Returns ((ms, plain_ms, bound_ms, bound_by,
    library_ms), the error relative to max|f64|)."""
    from vit_cpp_tpu_torch.ops.qmatmul import dequant_matmul, dequant_matmul_plain

    got = dequant_matmul(x, w, f32_out=True)
    ref = torch.matmul(x.double(), dense.double())
    err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
    log(f"kernel case mesh shard dequant_matmul f32 out {what} Q8_0 bf16 x: dtype "
        f"{str(got.dtype)[6:]}, max|kernel - f64| / max|f64| = {err:.3e} (tolerance "
        f"{ROW_PARTIAL_TOL:.0e})")
    if got.dtype != torch.float32 or not err <= ROW_PARTIAL_TOL:
        raise AssertionError(f"dequant_matmul f32 out {what}: {got.dtype}, error {err}")
    k_ms, p_ms = time_pair(f"mesh shard dequant_matmul f32 out {what} Q8_0", card,
                           lambda: dequant_matmul(x, w, f32_out=True),
                           lambda: dequant_matmul_plain(x, w, f32_out=True))
    b_ms = cuda_ms(lambda: dequant_matmul(x, w))
    lib = cuda_ms(lambda: torch.mm(x, dense, out_dtype=torch.float32))
    (m, k), n = x.shape, dense.shape[1]
    bound_ms, by = bound(2.0 * m * k * n, 2 * m * k + k * n // 32 * 34 + 4 * m * n, "bf16")
    log(f"timing mesh shard dequant_matmul f32 out {what} on {card}: {k_ms:.4f} ms per call, "
        f"the bf16-output call {b_ms:.4f} ms, torch.mm f32 out {lib:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({by})")
    return (k_ms, p_ms, bound_ms, by, lib), err


def _check_k4_f32_x(x, w, what: str, card: str) -> float:
    """K4's f32 body at a row shard (an f32 rank's row-parallel partial,
    `f32_out` with f32 x): within ROW_PARTIAL_TOL of max|f64 product| on
    the weight dequantized in f32; its ms beside the plain version's.
    Returns the error relative to max|f64|."""
    from vit_cpp_tpu_torch.ops.qmatmul import dequant_matmul, dequant_matmul_plain

    got = dequant_matmul(x, w, f32_out=True)
    ref = torch.matmul(x.double(), w.dequantize(torch.float32).double())
    err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
    k_ms = cuda_ms(lambda: dequant_matmul(x, w, f32_out=True))
    p_ms = cuda_ms(lambda: dequant_matmul_plain(x, w, f32_out=True))
    log(f"kernel case mesh shard dequant_matmul f32 x {what} Q8_0: dtype {str(got.dtype)[6:]}, "
        f"max|kernel - f64| / max|f64| = {err:.3e} (tolerance {ROW_PARTIAL_TOL:.0e}); "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms on {card}")
    if got.dtype != torch.float32 or not err <= ROW_PARTIAL_TOL:
        raise AssertionError(f"dequant_matmul f32 x {what}: {got.dtype}, error {err}")
    return err


def _check_row_partial(x, w, what: str, card: str) -> None:
    """A bf16 row-parallel shard's dense partial product (ops/core.py::
    _matmul_f32, what a rank sums over "model" before it rounds) is f32
    and within ROW_PARTIAL_TOL of max|f64 product| (bf16 products are
    exact in f32: only the f32 sum's order and roundings differ)."""
    from vit_cpp_tpu_torch.ops.core import _matmul_f32

    got = _matmul_f32(x, w)
    ref = torch.matmul(x.double(), w.double())
    err = (got.double() - ref).abs().max().item()
    tol = ROW_PARTIAL_TOL * ref.abs().max().item()
    log(f"row partial {what}: dtype {str(got.dtype)[6:]}, max|f32 partial - f64| = {err:.3e} "
        f"(tolerance {tol:.3e}); {cuda_ms(lambda: _matmul_f32(x, w)):.4f} ms, the bf16 "
        f"product {cuda_ms(lambda: torch.matmul(x, w)):.4f} ms on {card}")
    if got.dtype != torch.float32 or not err <= tol:
        raise AssertionError(f"row partial {what}: {got.dtype}, error {err} > {tol}")


def _descendants(pid: int) -> list:
    """The pids under `pid` (from /proc), depth first."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            kids = [int(c) for c in f.read().split()]
    except OSError:
        return []
    return [k for c in kids for k in (c, *_descendants(c))]


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


def launcher(*args: str) -> list:
    """`python3 -m torch.distributed.run --standalone --nproc-per-node 1 -m
    <args>`: one rank under the launcher (NCCL, world 1)."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "1", "-m", *args]


def mesh_daemon_probs(proc, bodies) -> tuple:
    """The ten assets' /v1/classify probabilities from a daemon started
    with --port 0 (its banner names the port), one request at a time."""
    port = int(re.search(r"http://127\.0\.0\.1:(\d+)", _read_banner(proc, 300)).group(1))
    probs = []
    for body in bodies:
        status, out, _ = post(f"http://127.0.0.1:{port}/v1/classify?topk=1000", body)
        if status != 200:
            raise AssertionError(f"daemon answered {status}: {out}")
        row = np.zeros(1000)
        for t in out["topk"]:
            row[t["id"]] = t["prob"]
        probs.append(row)
    return np.stack(probs), port


# One rank under the launcher: shard an engine on a 1x1 mesh, export it
# (aot.save_engine, -b 8), and write what the sharded engine itself serves:
# each asset's probabilities as the daemon batches a lone request (the
# image repeated to 8 rows) and vit-serve's stdout at -b 8.
_MESH_EXPORT = r"""
import contextlib, io, json, sys, time
import numpy as np, torch
from vit_cpp_tpu_torch.aot import save_engine
from vit_cpp_tpu_torch.cli.common import build_engine
from vit_cpp_tpu_torch.cli.serve import _serve_loop
from vit_cpp_tpu_torch.parallel.mesh import make_mesh, rank_device
from vit_cpp_tpu_torch.server import decode_rgb_from_bytes
model, mm, stem, paths = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]
engine, _ = build_engine(model, mm=mm, device=rank_device("cuda"))
engine.shard(make_mesh(1, 1, 1, device_type="cuda"))
t0 = time.perf_counter()
meta = save_engine(engine, stem + ".vitx", 8)
export_s = time.perf_counter() - t0
rows = []
for path in paths:
    with open(path, "rb") as f:
        px = engine.preprocess_image(decode_rgb_from_bytes(f.read()))
    rows.append(engine.predict_probs_batch(torch.stack([px] * 8))[0].cpu().numpy())
np.save(stem + ".npy", np.stack(rows))
out = io.StringIO()
with contextlib.redirect_stdout(out):
    _serve_loop(engine, False, paths, batch=8, topk=1, decode_threads=2)
with open(stem + ".txt", "w") as f:
    f.write(out.getvalue())
print(json.dumps({"export_s": export_s, "mesh": meta["mesh"],
                  "blob_lengths": meta["blob_lengths"]}))
"""


def start_mesh_exports(f16: str, q8: str, tmp: str) -> dict:
    """The sharded artifacts' exports, each one rank under the launcher
    (_MESH_EXPORT), started by aot_paths beside its own work: its
    AOT_BLOCKS-block files, `f16` at the serving defaults (W8A8) and the
    Q8_0 `q8` with --mm pallas. {what: [the launcher's process, the files'
    stem, blocks]}."""
    d = os.path.join(tmp, "mesh_vitx")
    os.makedirs(d)
    script = os.path.join(d, "export_sharded.py")
    with open(script, "w") as f:
        f.write(_MESH_EXPORT)
    env = dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="2")
    jobs = {}
    for what, model, mm, blocks in (("W8A8", f16, "int8", AOT_BLOCKS),
                                    ("Q8_0 --mm pallas", q8, "pallas", AOT_BLOCKS)):
        stem = os.path.join(d, what.split()[0])
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", script, model, mm, stem, *asset_bodies()[0]]
        jobs[what] = [subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True, env=env), stem, blocks]
    return jobs


def finish_mesh_exports(jobs: dict) -> None:
    """Wait for the exports (before aot_paths times its forwards) and check
    what each wrote."""
    for what, (proc, stem, _) in jobs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise AssertionError(f"sharded export {what}: exit {proc.returncode}: {err[-3000:]}")
        res = json.loads(out.strip().splitlines()[-1])
        log(f"sharded export {what} (1x1 mesh, launcher, -b 8): {res['export_s']:.1f} s, "
            f"meta mesh {res['mesh']}, blob_lengths {res['blob_lengths']}, "
            f"{os.path.getsize(stem + '.vitx') / 1e6:.1f} MB")
        if res["mesh"] != {"axis_names": ["data", "model"], "axis_sizes": [1, 1]}:
            raise AssertionError(f"sharded export {what}: meta mesh {res['mesh']}")


def serve_mesh_artifacts(jobs: dict, paths, spawn) -> dict:
    """Each exported sharded artifact served under the launcher as a user
    would: `vit-serve -m x.vitx -b 8` over the ten assets and `vit-server
    -m x.vitx --port 0`. {(what, tool): process}."""
    procs = {}
    for what, (_, stem, _) in jobs.items():
        procs[(what, "vit-serve")] = spawn(launcher(
            "vit_cpp_tpu_torch.cli.serve", "-m", stem + ".vitx", *paths, "-b", "8"))
        procs[(what, "vit-server")] = spawn(launcher(
            "vit_cpp_tpu_torch.cli.server", "-m", stem + ".vitx", "--port", "0"))
    return procs


def check_mesh_artifacts(jobs: dict, procs: dict, tmp: str, bodies, card: str) -> dict:
    """Each sharded artifact in this process (its launches per batch with
    the counts set to 0 just before, its load ms beside the unsharded
    artifact's), then what the launcher's vit-serve printed (the sharded
    engine's stdout) and vit-server answered (the sharded engine's
    probabilities, within 1e-6), and rank 0's exit code after SIGTERM.
    Returns {path: {kernel: launches}}."""
    from vit_cpp_tpu_torch.aot import AotEngine
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL

    pixels = torch.randn((8, 3, 224, 224), generator=torch.Generator(device="cuda").manual_seed(3),
                         device="cuda")
    launches = {}
    for what, (_, stem, blocks) in jobs.items():
        engine = AotEngine(stem + ".vitx")
        per_batch = {KERNEL: blocks}
        if "pallas" in what:
            per_batch[QMM_KERNEL] = 4 * blocks + 1
            unsharded = AotEngine(os.path.join(tmp, "aot", "vit-b16-q8_0-pallas.vitx")).load_ms
            than = f"the unsharded {blocks}-block -b 8 artifact's {unsharded:.1f}"
        else:
            than = (f"the unsharded {blocks}-block -b 1,64 artifact's "
                    f"{AOT_LOAD_MS['vitx W8A8 -b 1,64']:.1f} (two programs)")
        path = f"mesh 1x1 vitx {what} B=8"
        _, launches[path] = aot_launches(path, engine, pixels, per_batch)
        log(f"{path}: AotEngine rebuilt mesh {engine.meta['mesh']['axis_sizes']}, launches per "
            f"batch {launches[path]}; load_ms {engine.load_ms:.1f} beside {than} on {card}")
        del engine
        want = np.load(stem + ".npy")
        with open(stem + ".txt") as f:
            want_lines = f.read()
        out, err = procs[(what, "vit-serve")].communicate(timeout=300)
        if procs[(what, "vit-serve")].returncode or out != want_lines or len(
                out.splitlines()) != 10:
            raise AssertionError(f"vit-serve -m {what} sharded vitx: {out!r} vs {want_lines!r} "
                                 f"{err[-2000:]}")
        log(f"vit-serve -m sharded {what} vitx (launcher): 10 lines, equal to the sharded "
            f"engine's vit-serve stdout; "
            f"{[ln for ln in err.splitlines() if 'images/sec' in ln]}")
        daemon = procs[(what, "vit-server")]
        got, port = mesh_daemon_probs(daemon, bodies)
        diff = float(np.abs(got - want).max())
        log(f"vit-server -m sharded {what} vitx (launcher, port {port}): the ten assets' "
            f"probabilities vs the sharded engine's: max diff {diff:.3e} (bound 1e-6), "
            f"bit-equal {np.array_equal(got, want.astype(np.float64))}")
        if diff > 1e-6:
            raise AssertionError(f"vit-server on the sharded {what} artifact: off by {diff}")
        workers = [p for p in _descendants(daemon.pid)
                   if "vit_cpp_tpu_torch.cli.server" in _cmdline(p)]
        if not workers:
            raise AssertionError("vit-server on a sharded artifact: no worker under the launcher")
        os.kill(workers[0], signal.SIGTERM)
        rc = daemon.wait(timeout=120)
        log(f"vit-server -m sharded {what} vitx: exit code {rc} after SIGTERM")
        if rc != 0:
            raise AssertionError(f"vit-server on the sharded {what} artifact exited {rc}")
    return launches


def mesh_paths(f16: str, q8: str, tmp: str, card: str) -> tuple:
    """The multi-device layer on one card: every launch a 1x1 mesh under
    the torch.distributed launcher (NCCL, world 1; one card cannot hold two
    NCCL ranks). `vit-serve --mesh 1x1` at the defaults and with --mm
    pallas on Q8_0 prints what vit_serve's unsharded commands printed;
    `vit-server --mesh 1x1` answers the ten assets with the unsharded
    daemon's probabilities (1e-6) and leaves rank 0 with exit code 0 after
    SIGTERM; `vit-finetune --mesh 1x1 --fsdp` trains and its output
    serves, its losses within 1e-5 of the unsharded run's (the API run in
    this process, two updates at B=32, vs the same without a mesh). While
    the launches run, this process checks (untimed) the API runs and a
    1x1-mesh engine's launches through serve_files; then, alone on the
    card, its B=64 forward against the unsharded engine's in turns (what
    the sharded path costs when the collectives are trivial), and every
    kernel at the per-rank shapes of tp = 2 and 4 (shard_kernels).
    Beside those launches, the two sharded .vitx artifacts that aot_paths
    exported are served under the launcher (serve_mesh_artifacts,
    check_mesh_artifacts). Returns ({path: {kernel: launches}}, {path:
    K2 launches}, shard timings, errors)."""
    import signal

    import torch.distributed as dist

    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.finetune import finetune
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL
    from vit_cpp_tpu_torch.parallel.mesh import make_mesh
    from vit_cpp_tpu_torch.serve import serve_files

    t0 = time.perf_counter()
    paths, bodies = asset_bodies()
    # two intra-op threads each: the launches share the host's cores with
    # this process's checks
    env = dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="2")
    data = write_dark_bright(os.path.join(tmp, "mesh_train"), 16)
    ft_out = os.path.join(tmp, "mesh-ft.gguf")

    def spawn(cmd):
        return subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, env=env)

    serves = {what: spawn(launcher("vit_cpp_tpu_torch.cli.serve", "-m", model, *paths, "-b",
                                   "8", *flags, "--mesh", "1x1"))
              for what, model, flags in (("vit-serve defaults", f16, []),
                                         ("vit-serve --mm pallas", q8, ["--mm", "pallas"]))}
    daemons = (spawn(launcher("vit_cpp_tpu_torch.cli.server", "-m", f16, "--port", "0",
                              "--mesh", "1x1")),
               spawn([sys.executable, "-m", "vit_cpp_tpu_torch.cli.server", "-m", f16,
                      "--port", "0"]))
    ft = spawn(launcher("vit_cpp_tpu_torch.cli.finetune", "-m", f16, "-d", data, "-o", ft_out,
                        "-b", "32", "--epochs", "2", "--mesh", "1x1", "--fsdp"))
    exports = MESH_EXPORTS  # started and finished in aot_paths
    artifacts = serve_mesh_artifacts(exports, paths, spawn)
    try:
        # in this process meanwhile, untimed: a 1-rank NCCL group
        mesh = make_mesh(1, 1, 1, device_type="cuda")
        quiet = lambda m: None  # noqa: E731
        KERNEL.reset()
        GRAD_KERNEL.reset()
        _, _, _, sharded = finetune(f16, data, epochs=2, batch=32, mesh=mesh, fsdp=True,
                                    log=quiet)
        torch.cuda.synchronize()
        ft_launches = (KERNEL.launches, GRAD_KERNEL.launches)
        _, _, _, plain = finetune(f16, data, epochs=2, batch=32, log=quiet)
        launches = {}
        for what, model, mm, per_batch in (
            ("mesh 1x1 serve_files", f16, "int8", {KERNEL: 12}),
            ("mesh 1x1 serve_files --mm pallas", q8, "pallas", {QMM_KERNEL: 49, KERNEL: 12}),
        ):
            engine, _ = build_engine(model, mm=mm, device="cuda")
            engine.shard(mesh)
            for kernel in per_batch:
                kernel.reset()
            got = list(serve_files(engine, paths, batch=8))
            torch.cuda.synchronize()
            launches[what] = {k.name: k.launches for k in per_batch}
            if any(k.launches != 2 * n for k, n in per_batch.items()) or len(got) != 10:
                raise AssertionError(f"{what}: launches {launches[what]} for 2 batches")
            log(f"{what}: launches {launches[what]} = "
                f"{ {k.name: n for k, n in per_batch.items()} } x 2 batches")
            del engine

        (mesh_p, mesh_port), (plain_p, _) = (mesh_daemon_probs(d, bodies) for d in daemons)
        err = float(np.abs(mesh_p - plain_p).max())
        log(f"vit-server --mesh 1x1 (launcher, port {mesh_port}): the ten assets' probabilities "
            f"vs the unsharded daemon: max diff {err:.3e} (bound 1e-6), bit-equal "
            f"{np.array_equal(mesh_p, plain_p)}")
        if err > 1e-6:
            raise AssertionError(f"vit-server --mesh 1x1: probabilities off by {err}")
        workers = [p for p in _descendants(daemons[0].pid)
                   if "vit_cpp_tpu_torch.cli.server" in _cmdline(p)]
        if not workers:
            raise AssertionError("vit-server --mesh 1x1: no worker process under the launcher")
        os.kill(workers[0], signal.SIGTERM)  # rank 0: it broadcasts stop and returns
        daemons[1].send_signal(signal.SIGTERM)
        for name, d in zip(("--mesh 1x1 (the launcher: rank 0's code)", "unsharded"), daemons):
            rc = d.wait(timeout=120)
            log(f"vit-server {name}: exit code {rc} after SIGTERM")
            if rc != 0:
                raise AssertionError(f"vit-server {name} exited {rc}")
        for what, proc in serves.items():
            out, err_text = proc.communicate(timeout=300)
            if proc.returncode:
                raise AssertionError(f"{what} --mesh 1x1: exit {proc.returncode}: "
                                     f"{err_text[-2000:]}")
            log(f"{what} --mesh 1x1 (launcher): {len(out.splitlines())} lines, stdout equal "
                f"to the unsharded command's: {out == SERVE_STDOUT[what]}; "
                f"{[ln for ln in err_text.splitlines() if 'images/sec' in ln]}")
            if out != SERVE_STDOUT[what] or len(out.splitlines()) != 10:
                raise AssertionError(f"{what} --mesh 1x1: {out!r} != {SERVE_STDOUT[what]!r}")
        _, ft_err = ft.communicate(timeout=600)
        if ft.returncode:
            raise AssertionError(f"vit-finetune --mesh 1x1 --fsdp exited {ft.returncode}: "
                                 f"{ft_err[-3000:]}")
        cli_losses = re.findall(r"^epoch \d+/\d+: loss (\S+)", ft_err, re.M)
        launches.update(check_mesh_artifacts(exports, artifacts, tmp, bodies, card))
    finally:
        for p in (*daemons, ft, *serves.values(), *artifacts.values()):
            if p.poll() is None:
                for w in _descendants(p.pid):
                    os.kill(w, signal.SIGKILL)
                p.kill()
    diff = float(np.abs(np.array(sharded) - np.array(plain)).max())
    log(f"vit-finetune --mesh 1x1 --fsdp: losses {sharded} vs unsharded {plain} (max diff "
        f"{diff:.3e}, bound 1e-5); the launcher's run printed {cli_losses}; launches "
        f"{ft_launches[0]} attention_qkv + {ft_launches[1]} attention_qkv_grad for 2 updates")
    if diff > 1e-5 or cli_losses != [f"{v:.4f}" for v in sharded]:
        raise AssertionError(f"vit-finetune --mesh 1x1 --fsdp: {sharded} / {cli_losses} vs "
                             f"{plain}")
    if ft_launches != (24, 24):
        raise AssertionError(f"vit-finetune --mesh 1x1: launches {ft_launches}, want 12 + 12 "
                             "per update")
    served = VitEngine(ft_out, device="cuda", verbose=False)
    p = served.predict_probs_batch(served.preprocess_images(
        [decode_rgb(b) for b in bodies[:4]]))
    if p.shape != (4, 2) or not torch.isfinite(p).all():
        raise AssertionError(f"mesh-ft.gguf: bad probabilities {tuple(p.shape)}")
    log(f"mesh-ft.gguf (rank 0's output) serves: probabilities {tuple(p.shape)}, finite; "
        f"the launches and checks in {time.perf_counter() - t0:.1f} s")

    x = torch.randn((64, 3, 224, 224), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    plain_e, _ = build_engine(f16, device="cuda")
    mesh_e, _ = build_engine(f16, device="cuda")
    mesh_e.shard(mesh)
    a, b = plain_e.predict_probs_batch(x), mesh_e.predict_probs_batch(x)
    log(f"mesh 1x1 engine B=64 vs unsharded (serving defaults): max|diff| "
        f"{(a - b).abs().max().item():.3e}, bit-equal {torch.equal(a, b)}")
    if not torch.equal(a, b):
        raise AssertionError("the 1x1-mesh forward differs from the unsharded one")
    ms = timed_forwards("mesh overhead forward B=64", {
        "unsharded": lambda: plain_e.predict_probs_batch(x),
        "mesh 1x1": lambda: mesh_e.predict_probs_batch(x),
    }, card)
    log(f"mesh overhead: the 1x1-mesh forward costs {ms['mesh 1x1'] - ms['unsharded']:+.3f} ms "
        f"({ms['mesh 1x1'] / ms['unsharded'] - 1:+.2%}) over the unsharded one at B=64 on {card}")
    del plain_e, mesh_e
    shards, errs = shard_kernels(card)
    dist.destroy_process_group()
    log(f"mesh_paths in {time.perf_counter() - t0:.1f} s")
    return launches, {"cli.finetune --mesh 1x1 --fsdp": ft_launches[1]}, shards, errs


def decode_rgb(body: bytes):
    from vit_cpp_tpu_torch.server import decode_rgb_from_bytes

    return decode_rgb_from_bytes(body)


def op_dispatch_cost(f16: str, q8: str, card: str) -> None:
    """The host cost of the kernels' PyTorch operators (phase
    `op_dispatch`): each wrapper goes through torch.ops since the
    operators were registered; its CUDA implementation called directly is
    the wrapper as it was before. Host us per call of K1 and K4 at small
    shapes (200 calls, one sync), then forward_phase's B=8 forward (Q8_0,
    bf16, --mm pallas, fast fused attention) and tome_paths' r=16 B=64
    forward (the defaults) each way, median of 20 in turns on the host
    clock with a sync."""
    import vit_cpp_tpu_torch.models.vit as model_vit
    from vit_cpp_tpu_torch.cli.common import build_engine
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.ops import flash_attention as fa
    from vit_cpp_tpu_torch.ops import qmatmul as qm

    def direct_attention(qkv, num_heads, *, fast=False, kv=None, sizes=None):
        fa._check_args(qkv, num_heads, kv, sizes)
        return fa._attention_qkv_cuda(qkv, num_heads, fast, kv, sizes)

    def direct_dequant(x, w):
        qm._flatten(x, w)
        return qm._dequant_matmul_cuda(x, w.codes, w.scales, w.mins, w.offset, w.out_features)

    @contextlib.contextmanager
    def way(name):
        saved = model_vit.attention_qkv, qm.dequant_matmul
        if name == "direct":
            model_vit.attention_qkv, qm.dequant_matmul = direct_attention, direct_dequant
        try:
            yield
        finally:
            model_vit.attention_qkv, qm.dequant_matmul = saved

    gen = torch.Generator(device="cuda").manual_seed(17)
    qkv = torch.randn((1, 16, 192), generator=gen, device="cuda").bfloat16()
    q8_engine = VitEngine(q8, dtype="bf16", attn_impl="pallas-fast", mm_impl="pallas",
                          device="cuda", verbose=False)
    w = q8_engine.params["blocks"]["qkv"]["kernel"][0]
    x = torch.randn((16, w.in_features), generator=gen, device="cuda").bfloat16()
    calls = {"attention_qkv op": lambda: fa.attention_qkv(qkv, 1, fast=True),
             "attention_qkv direct": lambda: direct_attention(qkv, 1, fast=True),
             "dequant_matmul op": lambda: qm.dequant_matmul(x, w),
             "dequant_matmul direct": lambda: direct_dequant(x, w)}
    per_call = {k: [] for k in calls}
    for _ in range(3):
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            per_call[name].append((time.perf_counter() - t0) / 200 * 1e6)
    log("host us per call, small shapes (min of 3 runs of 200): " + ", ".join(
        f"{k} {min(v):.1f}" for k, v in per_call.items()) + f" on {card}")
    encode_cost(card)

    tome_engine, _ = build_engine(f16, tome=TOME_R, device="cuda")
    pixels = torch.randn((64, 3, 224, 224), generator=gen, device="cuda")
    for what, eng, batch in (("Q8_0 --mm pallas bf16 B=8", q8_engine, 8),
                             (f"defaults --tome {TOME_R} B=64", tome_engine, 64)):
        times = {"op": [], "direct": []}
        for name in ("op", "direct", "direct", "op") * 2:
            with way(name):
                eng.predict_probs_batch(pixels[:batch])
                torch.cuda.synchronize()
                for _ in range(5):
                    t0 = time.perf_counter()
                    eng.predict_probs_batch(pixels[:batch])
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
        ms = {k: float(np.median(v)) for k, v in times.items()}
        log(f"op dispatch, forward {what} (median of 20 in turns, host clock with sync): "
            f"through the operators {ms['op']:.3f} ms, wrappers calling the CUDA "
            f"implementations directly {ms['direct']:.3f} ms (+{ms['op'] - ms['direct']:.3f} ms, "
            f"{(ms['op'] / ms['direct'] - 1) * 100:.1f}%) on {card}")


def stage_parity(f16: str, card: str) -> None:
    """forward_debug (phase `stage_parity`) on the card at two rungs, f32
    (TF32 off, composed attention) and bf16 W8A8 with the fast fused
    attention (fold off, so that "pooled" is the same readout), against
    the card machine's CPU in f32, two 224 px images: each stage's
    max|card - cpu| / max(1, max|cpu|) and the first stage over
    STAGE_TOL. Fails if the probabilities are off (CLI_PROB_TOL f32,
    PROB_TOL W8A8) or the fused rung did not launch attention_qkv 12
    times."""
    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.models.vit import forward_debug, print_t
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.precision import matmul_precision

    t0 = time.perf_counter()
    cpu = VitEngine(f16, dtype="f32", device="cpu", verbose=False)
    x = torch.randn((2, 3, 224, 224), generator=torch.Generator().manual_seed(16))
    with torch.inference_mode():
        ref = forward_debug(cpu.params, x, cpu.hp)
    del cpu
    for what, kw, launches, prob_tol in (
        ("f32 xla", dict(dtype="f32"), 0, CLI_PROB_TOL),
        ("bf16 W8A8 pallas-fast", dict(dtype="bf16", mm_impl="int8", attn_impl="pallas-fast"),
         12, PROB_TOL),
    ):
        eng = VitEngine(f16, device="cuda", verbose=False, **kw)
        KERNEL.reset()
        with torch.inference_mode(), matmul_precision(eng.matmul_precision):
            got = forward_debug(eng.params, x.cuda(), eng.hp, attn_impl=eng.attn_impl,
                                mm_impl=eng.mm_impl)
        torch.cuda.synchronize()
        n = KERNEL.launches
        diffs = {k: float((got[k].float().cpu() - ref[k]).abs().max())
                 / max(1.0, float(ref[k].abs().max())) for k in ref}
        first = next((k for k, v in diffs.items() if v > STAGE_TOL[what]), None)
        log(f"stage parity {what} card vs CPU f32: " + ", ".join(
            f"{k} {v:.2e}" for k, v in diffs.items()) + f"; first stage over "
            f"{STAGE_TOL[what]:.0e}: {first}; attention_qkv launches {n} on {card}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            print_t(f"{what} probs", got["probs"][0], n=3)
        log(out.getvalue().strip())
        prob_err = float((got["probs"].cpu() - ref["probs"]).abs().max())
        if list(got) != list(ref) or n != launches or prob_err > prob_tol:
            raise AssertionError(f"stage parity {what}: keys {list(got)}, {n} launches, "
                                 f"probabilities off by {prob_err}")
        del eng
    log(f"phase stage_parity: {time.perf_counter() - t0:.1f} s")


# ViT-H/14 @224 (BENCH_DETAILS.json's vith14_224 rows): hidden 1280, 32
# layers, 16 heads of d=80, MLP 5120, T=257
VIT_H14 = dict(hidden_size=1280, num_hidden_layers=32, num_attention_heads=16,
               num_classes=1000, patch_size=14, img_size=224)
# the ViT-H/14 f32 update at B=128 under "dots+attn" must stay below this
# (the card holds 79.6 GiB)
H14_PEAK_GIB = 79.0
# remat's gradients against remat=False's, where they are not bit-equal:
# tests/test_torch_train.py's bound
REMAT_GRAD_TOL = dict(atol=5e-5, rtol=1e-3)


def remat_kernels(card: str) -> dict:
    """K1 (f32, safe) and K2 (f32) at the ViT-H/14 training shape B=8,
    T=257, 16 heads of d=80 (the wgmma bodies), against their plain
    versions; then each timed at B=8 and B=128 in turns with the mma.sync
    body it replaced, scaled_dot_product_attention (its backward) and the
    plain version, beside its bound. {name: B=8 times, name + " B=128":
    B=128 times}, each in the kernels line's order."""
    from vit_cpp_tpu_torch.ops.flash_attention import (
        attention_qkv, attention_qkv_grad, attention_qkv_grad_plain, attention_qkv_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(12)
    b, t, h, nh = 8, 257, 1280, 16
    qkv = torch.randn((b, t, 3 * h), generator=gen, device="cuda")
    do = torch.randn((b, t, h), generator=gen, device="cuda")
    for name, kern, plain, tol in (
        ("attention_qkv", lambda: attention_qkv(qkv, nh),
         lambda: attention_qkv_plain(qkv, nh), lambda ref: TOL[torch.float32]),
        ("attention_qkv_grad", lambda: attention_qkv_grad(qkv, do, nh),
         lambda: attention_qkv_grad_plain(qkv, do, nh),
         lambda ref: GRAD_TOL[torch.float32] * ref.abs().max().item()),
    ):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        log(f"kernel case {name} vit-h14 f32 safe B={b} T={t} h={h} nh={nh} (d=80): "
            f"max|kernel - plain| = {err:.3e} (tolerance {tol(ref):.3e})")
        if not torch.isfinite(got).all() or not err <= tol(ref):
            raise AssertionError(f"{name} at the ViT-H/14 shape: error {err}")
    del qkv, do
    out = {}
    for bb in (8, 128):
        tail = "" if bb == 8 else f" B={bb}"
        out["attention_qkv" + tail] = time_k1_f32(card, gen, "vit-h14", bb, t, 80, nh, False)
        out["attention_qkv_grad" + tail] = time_k2_bodies(card, gen, ((bb, t, nh),), 80)[
            (bb, t, nh)]
    return out


# ViT-g/14's training shapes (16 heads of d=88, T=257) at which K1 f32 safe
# and K2 f32 are timed: B=8 (and T=256 beside it: what the fifth 64-row
# tile's one real row costs) and B=64. (key, B, T)
G14_TIMED = (("g14_f32_b8", 8, 257), ("g14_f32_b8_t256", 8, 256), ("g14_f32_b64", 64, 257))


def g14_kernels(card: str) -> tuple:
    """K1 (f32, safe) and K2 (f32) at ViT-g/14's training shapes
    (G14_TIMED, 16 heads of d=88): each shape's input held first
    (hold_timed: within TOL[f32], K2 within GRAD_TOL[f32] x max|plain|, of
    the plain version and of the check-only mma.sync entry, two calls
    bit-equal), then timed in turns with the mma.sync body it replaced,
    scaled_dot_product_attention f32 (its backward) and the plain version,
    beside its bound. ({(kernel name, key): times in the kernels line's
    order}, {kernel name: worst error to plain})."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    out, held = {}, {}
    for key, b, t in G14_TIMED:
        out[("attention_qkv", key)] = time_k1_f32(card, gen, "vit-g14", b, t, 88, 16, False,
                                                  held=held)
        out[("attention_qkv_grad", key)] = time_k2_bodies(card, gen, ((b, t, 16),), 88,
                                                          held=held)[(b, t, 16)]
    for name in ("attention_qkv", "attention_qkv_grad"):
        t256, t257 = out[(name, "g14_f32_b8_t256")][0], out[(name, "g14_f32_b8")][0]
        log(f"{name} f32 d=88 B=8: T=257 takes {t257 / t256 - 1:+.1%} over T=256 (the fifth "
            "64-row tile holds one real row)")
    return out, held


def assets_tree(root: str) -> str:
    """A two-class tree of the ten assets, each twice (20 images): the
    first five in class "a", the last five in "b"."""
    paths, _ = asset_bodies()
    for i, path in enumerate(paths):
        cls = os.path.join(root, "a" if i < 5 else "b")
        os.makedirs(cls, exist_ok=True)
        for copy in range(2):
            shutil.copy(path, os.path.join(cls, f"{copy}-{os.path.basename(path)}"))
    return root


def g14_paths(tmp: str, card: str) -> tuple:
    """ViT-g/14 (VIT_G14) f32 training and serving on the card, every
    attention on K1's and K2's f32 bodies at d=88:
    (a) at full width and depth (G14_LAYERS): its ~1.0 B parameters made on
        the card by params_from_state_dict(random_state_dict(hp, 0)), two
        B=32 train_step updates under "dots+attn" (TRAIN_REMAT), the first
        under torch.profiler (device ms, idle share, K1's and K2's device ms
        and shares), the second timed by the host clock and by CUDA events;
        each with finite losses, G14_LAYERS attention_qkv and
        attention_qkv_grad launches and a peak under H14_PEAK_GIB;
    (b) cli.finetune on wide_paths' f16 file (4 of the 40 layers) over the
        assets (assets_tree, one epoch at -b 8: 2 updates, 4 + 4 launches
        each), its output served by the f32 engine;
    (c) serve_files --dtype f32 (mm=xla, K1 f32 fast, 4 launches per batch)
        on that file, within CLI_PROB_TOL of the f32 engine.
    Returns ({path: {kernel name: launches}}, {path: attention_qkv_grad
    launches})."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.engine import VitEngine
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.io.image import load_images_rgb_batch
    from vit_cpp_tpu_torch.models.params import params_from_state_dict
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.parallel import train as T
    from vit_cpp_tpu_torch.testing.synthetic import random_state_dict

    t_phase = time.perf_counter()
    launches, grads = {}, {}
    hp = VitHParams(**{**VIT_G14, "num_hidden_layers": G14_LAYERS})
    t0 = time.perf_counter()
    params = params_from_state_dict(random_state_dict(hp, seed=0), hp, device="cuda")
    n = sum(p.numel() for p in T.tree_leaves(params))
    log(f"ViT-g/14 f32 ({G14_LAYERS} layers, hidden {hp.hidden_size}, 16 heads of d=88): "
        f"{n / 1e6:.1f} M parameters made by params_from_state_dict on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn((32, 3, 224, 224), generator=gen, device="cuda")
    y = torch.randint(0, hp.num_classes, (32,), generator=gen, device="cuda")
    T.TRAIN_REMAT = "dots+attn"
    state = T.create_train_state(params)
    del params
    fixed = 4 * 4 * n / 2**30  # parameters, gradients, AdamW's two moments
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        KERNEL.reset()
        GRAD_KERNEL.reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if i == 0
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            start.record()
            loss = float(T.train_step(state, x, y, hp))
            end.record()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        got = (KERNEL.launches, GRAD_KERNEL.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        what = f"ViT-g/14 f32 B=32 train_step remat=dots+attn, update {i + 1}"
        log(f"{what}: loss {loss:.5f}, {got[0]} attention_qkv + {got[1]} attention_qkv_grad "
            f"launches, peak {peak:.2f} GiB (limit {H14_PEAK_GIB}; parameters, gradients and "
            f"moments {fixed:.2f}), {wall_ms:.1f} ms wall (host clock, synchronized), "
            f"{start.elapsed_time(end):.1f} ms stream elapsed (events) on {card}")
        if (not np.isfinite(loss) or got != (G14_LAYERS, G14_LAYERS)
                or not peak < H14_PEAK_GIB):
            raise AssertionError(f"{what}: loss {loss}, launches {got}, peak {peak}")
        if i == 0:
            dev_us, (fwd_us, bwd_us) = device_us(prof, KERNEL, GRAD_KERNEL)
            if dev_us <= 0:
                log("profiled ViT-g/14 update: torch.profiler saw no device time (shares not "
                    "measured)")
            elif fwd_us <= 0 or bwd_us <= 0:
                raise AssertionError(f"profiled ViT-g/14 update: no device time under "
                                     f"attention_qkv ({fwd_us} us) or attention_qkv_grad "
                                     f"({bwd_us} us)")
            else:
                log(f"profiled update (ViT-g/14 f32 B=32 remat=dots+attn, the first, "
                    f"torch.profiler) on {card}: {dev_us / 1e3:.2f} ms of device time in "
                    f"{wall_ms:.2f} ms wall (idle share {1 - dev_us / 1e3 / wall_ms:.3f}); "
                    f"attention_qkv {fwd_us / 1e3:.2f} ms ({fwd_us / dev_us:.3f} of device "
                    f"time), attention_qkv_grad {bwd_us / 1e3:.2f} ms ({bwd_us / dev_us:.3f})")
    path = f"vit-g14 {G14_LAYERS} layers B=32 train_step remat=dots+attn"
    launches[path] = {KERNEL.name: got[0], GRAD_KERNEL.name: got[1]}
    grads[path] = got[1]
    del state, x, y
    torch.cuda.empty_cache()

    g14 = os.path.join(tmp, "ViT-g14-synthetic-f16.gguf")  # wide_paths' file
    layers = VIT_G14["num_hidden_layers"]
    out = os.path.join(tmp, "ft-g14.gguf")
    data = assets_tree(os.path.join(tmp, "assets-tree"))
    what = f"cli.finetune ViT-g/14 ({layers} of {G14_LAYERS} layers) -b 8"
    st = extras_finetune(what, ["-m", g14, "-d", data, "-o", out, "-b", "8", "--epochs", "1"],
                         2, per_update=layers)
    launches[what] = {KERNEL.name: st["k1"], GRAD_KERNEL.name: st["k2"]}
    grads[what] = st["k2"]
    paths, _ = asset_bodies()
    engine = VitEngine(out, dtype="f32", device="cuda", verbose=False)
    probs = engine.predict_probs_batch(engine.preprocess_images(load_images_rgb_batch(paths)))
    torch.cuda.synchronize()
    if engine.id2label != {0: "a", 1: "b"} or tuple(probs.shape) != (10, 2) or not bool(
            torch.isfinite(probs).all()):
        raise AssertionError(f"ft-g14.gguf: labels {engine.id2label}, probabilities "
                             f"{tuple(probs.shape)}")
    log(f"ft-g14.gguf served by the f32 VitEngine on the card: labels {engine.id2label}, "
        f"finite (10, 2) probabilities, top-1 {probs.argmax(1).tolist()}")
    del engine
    what = f"ViT-g/14 ({layers} of {G14_LAYERS} layers) serve_files --dtype f32"
    launches[what] = served_check(what, g14, {"dtype": "f32", "mm": "xla"}, {KERNEL: layers},
                                  CLI_PROB_TOL)
    os.remove(g14)
    log(f"g14_paths: {time.perf_counter() - t_phase:.1f} s")
    return launches, grads


def profile_h14_update(state, x, y, hp, card: str) -> None:
    """One ViT-H/14 f32 update (train_step, the remat mode in force) under
    torch.profiler: K1's and K2's device ms and their shares of the
    update's device time."""
    from torch.profiler import ProfilerActivity, profile

    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.parallel.train import TRAIN_REMAT, train_step

    train_step(state, x, y, hp)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, x, y, hp)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us, (fwd_us, bwd_us) = device_us(prof, KERNEL, GRAD_KERNEL)
    if dev_us <= 0:
        log("profiled ViT-H/14 update: torch.profiler saw no device time (shares not measured)")
        return
    if fwd_us <= 0 or bwd_us <= 0:
        raise AssertionError(f"profiled ViT-H/14 update: no device time under attention_qkv "
                             f"({fwd_us} us) or attention_qkv_grad ({bwd_us} us)")
    log(f"profiled update (ViT-H/14 f32 B={x.shape[0]} remat={TRAIN_REMAT}, torch.profiler) on "
        f"{card}: {dev_us / 1e3:.2f} ms of device time in {wall_us / 1e3:.2f} ms wall; "
        f"attention_qkv {fwd_us / 1e3:.2f} ms ({fwd_us / dev_us:.3f} of device time), "
        f"attention_qkv_grad {bwd_us / 1e3:.2f} ms ({bwd_us / dev_us:.3f})")


def _update_stats(state, x, y, hp, what: str, card: str, timed: bool = True) -> dict:
    """One train_step of `state` (after a warm one) with the launch counts
    set to 0 just before and read just after, and the peak device memory
    in it; then, with `timed`, ms per update by cuda_ms and by the host
    clock over 5 updates. An update launches more kernels than CUDA's
    launch queue holds behind cuda_ms's sleep, so cuda_ms times it as it
    runs: its span is device time plus any gap the host leaves."""
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.parallel.train import TRAIN_REMAT, train_step

    train_step(state, x, y, hp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KERNEL.reset()
    GRAD_KERNEL.reset()
    t0 = time.perf_counter()
    loss = float(train_step(state, x, y, hp))
    one_ms = (time.perf_counter() - t0) * 1e3
    launches = (KERNEL.launches, GRAD_KERNEL.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(loss) or not launches[0] or not launches[1]:
        raise AssertionError(f"{what}: loss {loss}, launches {launches}")
    stats = dict(launches=launches, peak=peak, one_ms=one_ms, loss=loss)
    line = (f"{what} remat={TRAIN_REMAT}: {launches[0]} attention_qkv + {launches[1]} "
            f"attention_qkv_grad launches per update, peak {peak:.2f} GiB, loss {loss:.5f}")
    if timed:
        stats["device_ms"] = cuda_ms(lambda: train_step(state, x, y, hp), iters=5)
        t0 = time.perf_counter()
        for _ in range(5):
            train_step(state, x, y, hp)
        torch.cuda.synchronize()
        stats["wall_ms"] = (time.perf_counter() - t0) * 1e3 / 5
        line += (f"; {stats['device_ms']:.2f} ms of device time per update (cuda_ms), "
                 f"{stats['wall_ms']:.2f} ms wall (5 updates)")
    else:
        line += f"; {one_ms:.1f} ms wall"
    log(f"{line} on {card}")
    return stats


def remat_paths(f32: str, card: str) -> tuple:
    """Rematerialisation (models/vit.py::forward's `remat`; the training
    losses run parallel/train.py::TRAIN_REMAT, "dots+attn"):
    (a) ViT-B/16 f32 at B=32 through train_step in each mode: one step's
        gradients against remat=False's, K1 and K2 launches per update
        (12 / 24 / 24 / 12 and 12), peak device memory, ms per update;
    (b) ViT-H/14 f32: its weights made on the card by
        params_from_state_dict(random_state_dict(hp, 0)); the peak of a
        B=32 update in each mode, the "dots+attn" one profiled; then two
        B=128 updates through cross_entropy_loss under "dots+attn", with
        finite losses and a peak under H14_PEAK_GIB. No B=128 update runs
        without remat. (Its K1 and K2 are checked and timed by
        remat_kernels, after the paths: the timings launch the check-only
        entries.)
    Returns ({path: {kernel: launches per update}}, {path: K2 launches per
    update})."""
    from vit_cpp_tpu_torch.gguf.reader import read_model
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.models.params import load_params, params_from_state_dict
    from vit_cpp_tpu_torch.models.vit import REMAT_MODES
    from vit_cpp_tpu_torch.ops.flash_attention import GRAD_KERNEL, KERNEL
    from vit_cpp_tpu_torch.parallel import train as T
    from vit_cpp_tpu_torch.testing.synthetic import random_state_dict

    t_phase = time.perf_counter()
    # a remat update adds Python work per op (the recompute, the policy's
    # dispatch mode): other threads of this process compete for the host
    log(f"remat_paths: {threading.active_count()} Python threads alive in this process")
    launches, grads = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(11)
    hp = VitHParams(**VIT_B16)
    mf = read_model(f32)
    x = torch.randn((32, 3, 224, 224), generator=gen, device="cuda")
    y = torch.randint(0, hp.num_classes, (32,), generator=gen, device="cuda")
    ref = None
    try:
        for mode in REMAT_MODES:
            T.TRAIN_REMAT = mode
            state = T.create_train_state(load_params(mf, torch.float32, hparams=hp,
                                                     device="cuda"))
            g = torch.autograd.grad(T.cross_entropy_loss(state.params, x, y, hp),
                                    state.optimizer.params)
            if ref is None:
                ref = g
            else:
                worst = max((a - b).abs().max().item() for a, b in zip(g, ref))
                same = all(torch.equal(a, b) for a, b in zip(g, ref))
                log(f"remat ViT-B/16 B=32 remat={mode}: one step's gradients "
                    f"{'bit-equal to' if same else f'{worst:.3e} at most from'} remat=False's "
                    f"over {len(g)} leaves")
                if not same and not all(torch.allclose(a, b, **REMAT_GRAD_TOL)
                                        for a, b in zip(g, ref)):
                    raise AssertionError(f"remat={mode}: gradients off by {worst}")
            del g
            st = _update_stats(state, x, y, hp, "remat ViT-B/16 f32 B=32 train_step", card)
            layers = hp.num_hidden_layers
            want = (2 * layers if mode in (True, "dots") else layers, layers)
            if st["launches"] != want:
                raise AssertionError(f"remat={mode}: launches {st['launches']}, want {want}")
            path = f"train_step remat={mode}"
            launches[path] = {KERNEL.name: st["launches"][0], GRAD_KERNEL.name: st["launches"][1]}
            grads[path] = st["launches"][1]
            del state
        del ref
        torch.cuda.empty_cache()

        hh = VitHParams(**VIT_H14)
        t0 = time.perf_counter()
        params = params_from_state_dict(random_state_dict(hh, seed=0), hh, device="cuda")
        n = sum(p.numel() for p in T.tree_leaves(params))
        log(f"remat ViT-H/14 f32: {n / 1e6:.1f} M parameters made by params_from_state_dict on "
            f"the card in {time.perf_counter() - t0:.1f} s")
        state = T.create_train_state(params)
        fixed = 4 * 4 * n / 2**30  # parameters, gradients, AdamW's two moments
        peaks = {}
        x = torch.randn((32, 3, 224, 224), generator=gen, device="cuda")
        y = torch.randint(0, hh.num_classes, (32,), generator=gen, device="cuda")
        for mode in REMAT_MODES:
            T.TRAIN_REMAT = mode
            st = _update_stats(state, x, y, hh, "remat ViT-H/14 f32 B=32 train_step", card,
                               timed=False)
            peaks[mode] = st["peak"]
            path = f"vit-h14 B=32 train_step remat={mode}"
            launches[path] = {KERNEL.name: st["launches"][0], GRAD_KERNEL.name: st["launches"][1]}
            grads[path] = st["launches"][1]
            if mode == "dots+attn":
                profile_h14_update(state, x, y, hh, card)
        log(f"remat ViT-H/14 f32 B=32 peaks: " + ", ".join(
            f"{m}: {p:.2f} GiB" for m, p in peaks.items())
            + f"; parameters, gradients and moments {fixed:.2f} GiB; without remat B=128 "
            f"would take ~{fixed + 4 * (peaks[False] - fixed):.1f} GiB (4 x the B=32 "
            f"activations; not run)")
        T.TRAIN_REMAT = "dots+attn"
        del x, y
        torch.cuda.empty_cache()
        x = torch.randn((128, 3, 224, 224), generator=gen, device="cuda")
        y = torch.randint(0, hh.num_classes, (128,), generator=gen, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        KERNEL.reset()
        GRAD_KERNEL.reset()
        losses, ms = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            losses.append(float(T.update(state, T.cross_entropy_loss(state.params, x, y, hh))))
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n1, n2 = KERNEL.launches, GRAD_KERNEL.launches
        log(f"remat ViT-H/14 f32 B=128 cross_entropy_loss remat=dots+attn: 2 updates, losses "
            f"{losses}, {ms[0]:.1f} / {ms[1]:.1f} ms wall, peak {peak:.2f} GiB (limit "
            f"{H14_PEAK_GIB}), {n1} attention_qkv + {n2} attention_qkv_grad launches on {card}")
        per_update = hh.num_hidden_layers
        if (not all(np.isfinite(losses)) or not peak < H14_PEAK_GIB
                or (n1, n2) != (2 * per_update, 2 * per_update)):
            raise AssertionError(f"ViT-H/14 B=128: losses {losses}, peak {peak}, ({n1}, {n2})")
        launches["vit-h14 B=128 cross_entropy_loss remat=dots+attn"] = {
            KERNEL.name: n1, GRAD_KERNEL.name: n2}
        grads["vit-h14 B=128 cross_entropy_loss remat=dots+attn"] = n2
        del state, params, x, y
    finally:
        T.TRAIN_REMAT = "dots+attn"
        torch.cuda.empty_cache()
    log(f"remat_paths: {time.perf_counter() - t_phase:.1f} s")
    return launches, grads


def run_paths(card: str):
    from vit_cpp_tpu_torch.hparams import VitHParams
    from vit_cpp_tpu_torch.testing.synthetic import write_synthetic_model
    from vit_cpp_tpu_torch.cli import quantize
    from vit_cpp_tpu_torch.ops.flash_attention import KERNEL
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL

    from vit_cpp_tpu_torch.server import decode_rgb_from_bytes

    images = [decode_rgb_from_bytes(b) for b in asset_bodies()[1]]
    with tempfile.TemporaryDirectory() as tmp:
        f16 = os.path.join(tmp, "vit-b16-synthetic-f16.gguf")
        q8 = os.path.join(tmp, "vit-b16-synthetic-q8_0.gguf")
        t0 = time.perf_counter()
        write_synthetic_model(f16, VitHParams(**VIT_B16), ftype=1, seed=0)
        log(f"checkpoint: ViT-B/16 @224 synthetic f16 written in {time.perf_counter() - t0:.1f} s")
        f16_launches = serve(
            "f16 W8A8 daemon", f16, "int8", {KERNEL: 12}, PROB_TOL, images
        )

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = quantize.main([f16, q8, "8"])
        lines = out.getvalue().splitlines()
        if rc != 0:
            raise AssertionError("cli.quantize failed:\n" + "\n".join(lines))
        for line in lines:
            if re.match(r"quantize_model_file: (model|quant) size|main: +quantize time", line):
                log(f"cli.quantize: {line.strip()}")
        q8_launches = serve(
            "Q8_0 --mm pallas daemon", q8, "pallas", {QMM_KERNEL: 49, KERNEL: 12},
            Q8_PROB_TOL, images,
        )
        forward_phase(q8, card, "bf16")
        forward_phase(q8, card, "f32")
        flagship_forward(q8, images)
        vit_cli(f16, card)
        serve_launches = vit_serve(f16, q8, card)
        serve_launches.update(wide_paths(tmp, card, images))
        serve_launches.update(embeddings(f16, card))
        serve_launches.update(serving_workflow(f16, q8, tmp, card))
        serve_launches.update(model_families(f16, tmp, card))
        vit_inspect(f16, q8)
        serve_launches.update(aot_paths(f16, q8, tmp, card))
        mesh_launches, mesh_grad, mesh_shards, mesh_errs = mesh_paths(f16, q8, tmp, card)
        serve_launches.update(mesh_launches)
        stage_parity(f16, card)
        op_dispatch_cost(f16, q8, card)
        f32 = os.path.join(tmp, "vit-b16-synthetic-f32.gguf")
        write_synthetic_model(f32, VitHParams(**VIT_B16), ftype=0, seed=0)
        slice_parity(f32)
        grad_launches = finetune_path(f16, tmp)
        remat_launches, remat_grad_launches = remat_paths(f32, card)
        serve_launches.update(remat_launches)
        g14_launches, g14_grad_launches = g14_paths(tmp, card)
        serve_launches.update(g14_launches)
        remat_grad_launches.update(g14_grad_launches)
        tome_launches, tome_grad_launches = tome_paths(f16, q8, tmp, card, images)
        serve_launches.update(tome_launches)
        moe_launches, moe_grad_launches = moe_paths(f16, tmp, card, images)
        serve_launches.update(moe_launches)
        extras_launches, extras_grad_launches = training_extras(f16, f32, tmp, card)
        serve_launches.update(extras_launches)
        vit_benchmark(os.path.join(tmp, "ft.gguf"), tmp, card)
    flash_launches = split_head_path()
    grad_launches = {"cli.finetune": grad_launches,
                     f"cli.finetune --tome {TOME_TRAIN_R}": tome_grad_launches,
                     "cli.finetune --moe 8": moe_grad_launches, **extras_grad_launches,
                     **mesh_grad, **remat_grad_launches}
    return (f16_launches, q8_launches, flash_launches, grad_launches, serve_launches,
            (mesh_shards, mesh_errs))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from vit_cpp_tpu_torch import _build
    from vit_cpp_tpu_torch.ops.flash_attention import (
        FLASH_KERNEL,
        GRAD_KERNEL,
        GRAD_MMA_KERNEL,
        KERNEL,
        MMA_KERNEL,
    )
    from vit_cpp_tpu_torch.ops.qmatmul import KERNEL as QMM_KERNEL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the plain versions' bf16 products accumulate in f32 throughout
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    log(f"device: {kind}, compute capability {cap[0]}.{cap[1]}, "
        f"{torch.cuda.device_count()} visible; nvidia-smi: {smi}")
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.library()
    log(f"build: {os.path.relpath(lib, HERE)} from {len(_build.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", _build.build_log)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", _build.build_log))
    if regs:
        log(f"  ptxas: {len(regs)} kernel instantiations, {min(regs)}-{max(regs)} "
            f"registers per thread, {spills} bytes of spills")

    card = f"{kind} ({smi})"
    if sys.argv[1:] == ["--k1-bf16"]:
        # the wgmma body alone: its cases (and the mma.sync body's at d=64),
        # then its times in turns with that body and SDPA, and its host cost
        gen = torch.Generator(device="cuda").manual_seed(0)
        check_k1_d64(gen)
        time_k1_bodies(card, gen)
        encode_cost(card)
        log(smi)
        return 0
    if sys.argv[1:] == ["--k1-wide"]:
        # the wgmma body at d=80 and 88 alone: its cases against plain and
        # the mma.sync body, then its times in turns with that body, SDPA
        # and plain
        gen = torch.Generator(device="cuda").manual_seed(25)
        time_k1_wide(card, gen, check_k1_wide(gen)[1])
        log(smi)
        return 0
    if sys.argv[1:] == ["--t1"]:
        # T1 alone: its d=64 edges, then its variants at the flagship shapes
        # (full bit-equal to K1, in turns with K1, K1's mma.sync body and
        # SDPA, the stage split, each variant's occupancy) and full at d != 64
        check_t1_edges(torch.Generator(device="cuda").manual_seed(24))
        check_fwd_anatomy(card, torch.Generator(device="cuda").manual_seed(5), {})
        log(smi)
        return 0
    if sys.argv[1:] == ["--k2-bf16"]:
        # the backward's bf16 body alone: its cases against plain and the
        # mma.sync body, its times in turns with that body, SDPA's backward
        # and plain, then T2 on it (every variant, full bit-equal to K2 and
        # timed in turns, the stage split), and K3's f32 times
        gen = torch.Generator(device="cuda").manual_seed(23)
        check_k2_wgmma(gen, 64, K2_BF16_EDGES, torch.bfloat16)
        time_k2_bodies(card, gen, K2_BF16_TIMED, 64, torch.bfloat16)
        check_grad_anatomy(card, torch.Generator(device="cuda").manual_seed(5), {})
        time_k3_f32(card, gen)
        log(smi)
        return 0
    if sys.argv[1:] == ["--k2-f32"]:
        # the backward's f32 body alone: its cases against plain and the
        # mma.sync body, then its times in turns with that body and SDPA's
        # backward
        gen = torch.Generator(device="cuda").manual_seed(21)
        check_k2_wgmma(gen)
        time_k2_bodies(card, gen)
        log(smi)
        return 0
    if sys.argv[1:] == ["--attn-f32"]:
        # K1's f32 body at d=64 and 80 and K2's at d=80 alone: their cases
        # against plain and the mma.sync bodies, then their times in turns
        # with those bodies, SDPA (its backward) and plain
        gen = torch.Generator(device="cuda").manual_seed(22)
        check_k1_f32(gen)
        check_k2_wgmma(gen, 80, K2_WIDE_EDGES)
        check_k2_wgmma(gen, 88, K2_WIDE_EDGES)
        time_k1_f32_bodies(card, gen)
        time_k2_bodies(card, gen, K2_D80_TIMED, 80)
        log(smi)
        return 0
    if sys.argv[1:] == ["--g14"]:
        # f32 at d=88 (ViT-g/14's heads) alone: K1's and K3's edges and
        # K2's against plain and the mma.sync bodies, then the training
        # shapes held and timed in turns with those bodies, SDPA (its
        # backward) and plain
        gen = torch.Generator(device="cuda").manual_seed(26)
        check_k1_f32(gen, (88,))
        check_k2_wgmma(gen, 88, K2_WIDE_EDGES)
        g14_kernels(card)
        log(smi)
        return 0
    if sys.argv[1:] == ["--g14-train"]:
        # ViT-g/14's training and serving paths alone (g14_paths), on the
        # 4-layer f16 file that wide_paths writes, written here the same way
        from vit_cpp_tpu_torch.hparams import VitHParams
        from vit_cpp_tpu_torch.testing.synthetic import write_synthetic_model

        with tempfile.TemporaryDirectory() as tmp:
            write_synthetic_model(os.path.join(tmp, "ViT-g14-synthetic-f16.gguf"),
                                  VitHParams(**VIT_G14), ftype=1, seed=0)
            g14_paths(tmp, card)
        log(smi)
        return 0
    if sys.argv[1:] == ["--k4-f32"]:
        # the f32 body alone: its kernel cases, then its times at ViT-B/16's
        # linears (run from another tree's root, it measures that tree's body)
        rng = np.random.default_rng(0)
        check_qmm_cases(qmm_f32_cases(), rng)
        time_qmm_f32(card, rng)
        log(smi)
        return 0
    t_start = time.perf_counter()
    k1_err, k1_times = check_kernels(card)
    k4_err, k4_times, k4_f32_times = check_dequant_matmul(card)
    k3_err, k3_times = check_flash_attention(card)
    k3_f32_times = time_k3_f32(card, torch.Generator(device="cuda").manual_seed(22))
    k2_err, k2_times = check_attention_grad(card)
    k2_err = max(k2_err, check_k2_wgmma(torch.Generator(device="cuda").manual_seed(21)))
    gen = torch.Generator(device="cuda").manual_seed(23)
    k2_bf16_err = check_k2_wgmma(gen, 64, K2_BF16_EDGES, torch.bfloat16)
    k2_bf16_times = time_k2_bodies(card, gen, K2_BF16_TIMED[1:], 64, torch.bfloat16)
    MMA_KERNEL.reset()
    GRAD_MMA_KERNEL.reset()
    (_, q8_launches, flash_launches, grad_launches, serve_launches,
     (shards, shard_errs)) = run_paths(card)
    if MMA_KERNEL.launches or GRAD_MMA_KERNEL.launches:
        raise AssertionError(f"the check-only mma.sync entries launched {MMA_KERNEL.launches} "
                             f"(attention) and {GRAD_MMA_KERNEL.launches} (backward) times on "
                             "the paths")
    log("paths: the mma.sync bodies' check-only entries launched 0 times (every bf16 and f32 "
        "d=64, 80 and 88 attention went through a wgmma body, every f32 d=64 / 80 / 88 and "
        "bf16 d=64 backward through its wgmma body)")
    remat_times = remat_kernels(card)
    gen = torch.Generator(device="cuda").manual_seed(26)
    g14_err = (check_k1_f32(gen, (88,)), check_k2_wgmma(gen, 88, K2_WIDE_EDGES))
    g14_times, g14_held = g14_kernels(card)
    diag = check_diagnostics(card)
    tool_launches = diagnostics_path()
    for name in ("jax", "vit_cpp_tpu"):
        if sys.modules.get(name) is not None:
            raise AssertionError(f"{name} was imported")
    log(f"chip_smoke: checks, paths and diagnostics in {time.perf_counter() - t_start:.1f} s "
        "after the build")

    # K1 and K3 in bf16, K1 in f32 and K2 in f32 also carry the mma.sync
    # body's time (in turns with the wgmma body that replaced it)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "mma_sync_ms")

    def entry(kernel, launches, err, times, by_path=None, **more):
        """A kernel's numbers; `by_path`: its launches on each path that
        runs it; `more`: the same numbers at other shapes or types, each
        under its own key."""
        out = {
            "name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": launches, "max_abs_err": err,
            **dict(zip(keys, times)),
        }
        if by_path:
            out["launches_by_path"] = by_path
        for key, other in more.items():
            out[key] = dict(zip(keys, other))
        return out

    from vit_cpp_tpu_torch.tools import attn_anatomy as ta
    from vit_cpp_tpu_torch.tools import attn_grad_anatomy as tg
    from vit_cpp_tpu_torch.tools import probe_int8_dot as tp

    def by_shard(name):
        """A kernel's times at the per-rank shapes of tp = 1, 2, 4 (mesh_paths)."""
        return {"mesh_shards": {case: dict(zip(keys, t)) for case, t in shards[name].items()}}

    log(json.dumps({"kernels": [
        # K1: bf16 fast at ViT-B/16 B=8; B=64, T=577 / 785 at B=8, ViT-H/14
        # (d=80) at B=8 (T=256 too) and 64 and ViT-g/14 (d=88) at B=8 and
        # 32, and the training forward (f32 safe, B=32; ViT-H/14 B=8 and
        # 128; ViT-g/14 B=8, T=256 too, and 64), each with the mma.sync
        # body's time in turns, beside it, and both at tensor-parallel shards
        {**entry(KERNEL, q8_launches[KERNEL.name], k1_err, k1_times[(8, 197)],
                 by_path={"Q8_0 --mm pallas daemon": q8_launches[KERNEL.name],
                          **{p: n[KERNEL.name] for p, n in serve_launches.items()}},
                 b64=k1_times[(64, 197)], t577=k1_times[(8, 577)], t785=k1_times[(8, 785)],
                 h14_bf16_b8=k1_times["h14_bf16_b8"], h14_bf16_b8_t256=k1_times["h14_bf16_b8_t256"],
                 h14_bf16_b64=k1_times["h14_bf16_b64"], g14_bf16_b8=k1_times["g14_bf16_b8"],
                 g14_bf16_b32=k1_times["g14_bf16_b32"],
                 f32_b32=k1_times["f32 B=32"], h14_f32_b8=remat_times[KERNEL.name],
                 h14_f32_b128=remat_times[KERNEL.name + " B=128"],
                 **{key: g14_times[(KERNEL.name, key)] for key, _, _ in G14_TIMED}),
         **by_shard(KERNEL.name), "wide_edges_max_abs_err": k1_times["wide"][0],
         "wide_edges_apart_from_mma_sync": dict(k1_times["wide"][1]),
         "wide_timed_max_abs_err": k1_times["wide"][2],
         "g14_f32_edges_max_abs_err": g14_err[0],
         "g14_f32_timed_max_abs_err": g14_held[KERNEL.name]},
        # K4: its f32-output instantiation (a bf16 rank's row-parallel
        # partials) at the row shards of tp = 2, 4 under "f32_out"
        {**entry(QMM_KERNEL, q8_launches[QMM_KERNEL.name], k4_err, k4_times["qkv"],
                 by_path={"Q8_0 --mm pallas daemon": q8_launches[QMM_KERNEL.name],
                          **{p: n[QMM_KERNEL.name] for p, n in serve_launches.items()
                             if QMM_KERNEL.name in n}},
                 b64=k4_times["qkv B=64"], f32=k4_f32_times["qkv"],
                 f32_b64=k4_f32_times["qkv B=64"]),
         **by_shard(QMM_KERNEL.name),
         "f32_out": {case: dict(zip(keys, t))
                     for case, t in shards["dequant_matmul f32_out"].items()},
         "f32_out_max_rel_err": shard_errs["dequant_matmul f32_out"],
         "f32_x_row_shards_max_rel_err": shard_errs["dequant_matmul f32 x"]},
        # K3: bf16 (8, 12, 197, 64); f32 at (8, 12, 197, 64), ViT-H/14's
        # (1, 16, 257, 80) and ViT-g/14's (1, 16, 257, 88), bf16 at (8, 16,
        # 257, 80) and (8, 16, 257, 88) beside it
        entry(FLASH_KERNEL, flash_launches, k3_err, (*k3_times, k1_times["K3"][1]),
              f32=k3_f32_times[(8, 12, 197, 64)], f32_h14=k3_f32_times[(1, 16, 257, 80)],
              f32_g14=k3_f32_times[(1, 16, 257, 88)],
              h14_bf16=k1_times["K3 d=80"], g14_bf16=k1_times["K3 d=88"]),
        # K2: f32 at ViT-B/16 B=32 (the training path's, the wgmma body,
        # with the mma.sync body's time in turns); bf16 (its wgmma body) at
        # B=32 and 64 T=197 and B=8 T=785, T=785 at B=4 and 8, ViT-H/14 B=8
        # and 128 (d=80) and ViT-g/14 B=8 (T=256 too) and 64 (d=88;
        # mma.sync in turns) beside it, and f32 at tensor-parallel shards
        {**entry(GRAD_KERNEL, grad_launches["cli.finetune"], k2_err,
                 k2_times[(torch.float32, 197, 32)], by_path=grad_launches,
                 bf16=k2_times[(torch.bfloat16, 197, 32)],
                 bf16_b64=k2_bf16_times[(64, 197, 12)], bf16_t785=k2_bf16_times[(8, 785, 12)],
                 t785=k2_times[(torch.float32, 785, 4)],
                 t785_b8=k2_times[(torch.float32, 785, 8)],
                 h14_f32_b8=remat_times[GRAD_KERNEL.name],
                 h14_f32_b128=remat_times[GRAD_KERNEL.name + " B=128"],
                 **{key: g14_times[(GRAD_KERNEL.name, key)] for key, _, _ in G14_TIMED}),
         **by_shard(GRAD_KERNEL.name), "bf16_edges_max_rel_err": k2_bf16_err,
         "g14_f32_edges_max_rel_err": g14_err[1],
         "g14_f32_timed_max_rel_err": g14_held[GRAD_KERNEL.name]},
        *(entry(k, tool_launches[k.name], diag[k.name][0], diag[k.name][1:])
          for k in (ta.PAIR_KERNEL, ta.LANE_KERNEL, tg.KERNEL)),
        # T3: int8 at 1024^3; bf16 beside it, and both (int8 also with B
        # given (N, K)) at the W8A8 linears of a B=64 batch
        {**entry(tp.KERNEL, tool_launches[tp.KERNEL.name], diag[tp.KERNEL.name][0],
                 diag[tp.KERNEL.name][1:], bf16=diag[f"{tp.KERNEL.name} bf16"]),
         "w8a8_b64": {name: {kind: dict(zip(keys, times)) for kind, times in row.items()}
                      for name, row in diag[f"{tp.KERNEL.name} w8a8"].items()}},
    ]}))
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all, the build included")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
