// Stage anatomy of the fused-QKV attention forward for Hopper (sm_90a),
// CUDA C++: K1's bf16 bodies with one stage set per variant. At d = 64 the
// body is K1's bf16 wgmma body (attention_wgmma.cuh, the code of
// attention_qkv.cu's attention_wgmma); at every other d K1's bf16 mma.sync
// body (attention_body.cuh, attention_mma), as K1 itself takes them.
//
// Replaces the TPU kernels of tools/attn_anatomy.py: run_pair_variant
// (_pair_kernel, the head-pair form) and run_variant (_kernel, the
// 128-lane panel form), stage-toggled replicas of the TPU's serving
// attention kernel, timed variant by variant to split its time by stage.
// Here each variant is K1's body with that variant's stages changed and
// nothing else. d = 64: one warpgroup per (batch, head, 64-query tile), Q
// and K / V chunks of 64 keys by TMA (resident up to T = 256, else a ring
// of four), S and P V on wgmma.m64n64k16, software-pipelined. Other d: one
// block of 8 warps per (batch, head, 128-query tile), Q held in
// mma.sync.m16n8k16 A fragments, a cp.async ring of three K/V tiles of 64
// keys. Either way P is taken from the S accumulators in registers and
// every product runs on the tensor cores. `full` is K1's fast bf16 path,
// bit for bit.
//
// Input qkv is (B, T, 3h) bf16 ([q | k | v] on the feature axis, heads
// contiguous inside each third); output (B, T, h) bf16. `group` heads
// form one group: 2 for the pair form, 128/d for the lane form (2 at d =
// 64 in both). The group matters only where the JAX variant mixes heads.
// Variants (the stages of attention_wgmma.cuh and attention_body.cuh they
// change):
//   full      p = exp2(min(s, 120)); o = round(p) V / sum p   (K1 fast)
//   mxusum    full's output, the divisor the row sum of the rounded p
//             taken by the tensor cores: d = 64, one wgmma.m64n8k16 per
//             16-key step, P from registers against a tile of ones in
//             shared memory; other d, P times a tile of ones in V's
//             padding columns 16 NK .. 16 NK + 7, one more n8 tile of P V
//   bf16exp   p = exp2 of min(s, 120) in bf16, as JAX lowers it
//             (exp(ln 2 x), every step rounded to bf16); f32 row sum
//   noclamp   o = round(exp2(s)) V          (no clamp, no division)
//   noexp     o = round(min(s, 120)) V
//   nosoftmax o = round(s) V
//   nomask    o = G round(S_g) V_head, with S_g the score dot over the
//             group's G*d lanes (d = 64: two 64-column boxes of Q and of
//             K, 8 k16 steps; other d: Q fragments and K rows of 16 NKS),
//             P V over the head's d lanes
//   onedot    the score dot alone, of every key chunk: head j at position
//             i of its group stores S_src[:, i*d : (i+1)*d] from the
//             accumulators, S_src over the group's first head's d lanes
//             (pair form) or over the group's lanes (lane form, onedot_sum)
// with q scaled by log2(e)/sqrt(d) in f32 and rounded to bf16, f32
// scores, and p rounded to bf16 before P V with f32 accumulation, as the
// JAX kernels cast. onedot adds one score per n8 column into a sum stored
// under a condition that never holds, so that no chunk's products are
// dropped as dead code.
//
// At d != 64, NK is rounded up to 4 (d < 64) or 8 and NKS to 4, 8 or 16
// (the score dot's lanes up to 64, 128 or 256); the padding columns are
// zeros, which add exactly 0. At d = 128 the variants run K1's tiling
// exactly.
//
// What bounds it on this card: as K1, ViT-B/16 at T=197 is ~80 FLOP per
// byte of HBM traffic, below the bf16 ridge, so an ideal kernel is bound by
// the bytes; the wgmma body is bound by each block's chain of latencies
// and its softmax beside the products, the mma.sync body by issue on the
// SM. The variants move the same bytes (nomask and onedot's lane form read
// twice Q and K); their times split K1's time by stage. At d = 64 the
// variants keep K1's launch bounds, but not all of its three blocks per
// SM: nomask's shared memory (two Q and two K boxes a tile) holds one
// block an SM, onedot's and the registers of each variant set theirs
// (PERF.md section 6 lists them).
//
// The kernels and their launches are in attn_anatomy.cuh; nomask's and
// onedot's instantiations are in attn_anatomy_wide.cu, compiled at once
// with this file.

#include "attn_anatomy.cuh"

namespace anatomy {

// Every variant but nomask and onedot (attn_anatomy_wide.cu), into one
// output section.
template <int V>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  const attn::Group grp{a.group, a.group * a.d, 1, 0};
  if (a.d == attn::kWgD) return launch_wgmma<V, 0>(a, grp, stream);
  return a.d <= 64 ? launch<V, 4, 0>(a, grp, stream) : launch<V, 8, 0>(a, grp, stream);
}

}  // namespace anatomy

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// qkv: contiguous (B, T, 3h) bf16, h = nh * d, 16-byte aligned; out: bf16,
// 16-byte aligned, rows of out_stride elements (a multiple of 8); onedot
// writes out_copies sections h apart, every other variant one (the
// forward tool writes (B, T, h): out_stride = h, one copy).
// variant: 0 full, 1 mxusum, 2 bf16exp, 3 noclamp, 4 noexp, 5 nosoftmax,
// 6 nomask, 7 onedot. group divides nh; group * d <= 256, and group = 2
// at d = 64 (both forms' group there); onedot needs T >= group * d. qscale = log2(e)/sqrt(d). d = 64
// runs the wgmma body (TMA: 16-byte aligned rows), every other d the
// mma.sync body. Returns cudaGetLastError() after the launch.
extern "C" int vit_attn_anatomy(const void* qkv, void* out, int batch, int seq,
                                int nh, int d, int group, int variant,
                                int onedot_sum, long long out_stride,
                                int out_copies, float qscale, void* stream) {
  using namespace anatomy;
  if (batch < 1 || seq < 1 || nh < 1 || d < 8 || d > 128 || d % 8 != 0 ||
      group < 1 || nh % group != 0 || group * d > 256 || batch > 65535 ||
      nh > 65535 || out_copies < 1 || (variant != kOneDot && out_copies != 1) ||
      (d == attn::kWgD && group != 2) ||
      out_stride % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(qkv) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (variant == kOneDot && seq < group * d)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const bf16*>(qkv), static_cast<bf16*>(out), batch, seq, nh, d,
               group, onedot_sum, out_stride, out_copies, qscale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return (int)dispatch<kFull>(a, s);
    case kMxuSum: return (int)dispatch<kMxuSum>(a, s);
    case kBf16Exp: return (int)dispatch<kBf16Exp>(a, s);
    case kNoClamp: return (int)dispatch<kNoClamp>(a, s);
    case kNoExp: return (int)dispatch<kNoExp>(a, s);
    case kNoSoftmax: return (int)dispatch<kNoSoftmax>(a, s);
    case kNoMask: return (int)nomask(a, s);
    case kOneDot: return (int)onedot(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
