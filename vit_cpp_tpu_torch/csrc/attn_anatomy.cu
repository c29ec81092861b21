// Stage anatomy of the fused-QKV attention forward for Hopper (sm_90a),
// CUDA C++: K1's bf16 tensor-core body (attention_body.cuh, the code of
// attention_qkv.cu's attention_mma) with one stage set per variant.
//
// Replaces the TPU kernels of tools/attn_anatomy.py: run_pair_variant
// (_pair_kernel, the head-pair form) and run_variant (_kernel, the
// 128-lane panel form), stage-toggled replicas of the TPU's serving
// attention kernel, timed variant by variant to split its time by stage.
// Here each variant is K1's body with that variant's stages changed and
// nothing else: one block of 8 warps per (batch, head, 128-query tile),
// Q held in mma.sync.m16n8k16 A fragments, a cp.async ring of three K/V
// tiles of 64 keys, P taken from the S accumulators in registers, every
// product on the tensor cores. `full` is K1's fast bf16 path, bit for bit.
//
// Input qkv is (B, T, 3h) bf16 ([q | k | v] on the feature axis, heads
// contiguous inside each third); output (B, T, h) bf16. `group` heads
// form one group: 2 for the pair form, 128/d for the lane form. The
// group matters only where the JAX variant mixes heads. Variants (the
// attention_body.cuh stages they change):
//   full      p = exp2(min(s, 120)); o = round(p) V / sum p   (K1 fast)
//   mxusum    full's output, the divisor the row sum of the rounded p
//             taken by the tensor cores: P times a tile of ones in V's
//             padding columns 16 NK .. 16 NK + 7, one more n8 tile of P V
//   bf16exp   p = exp2 of min(s, 120) in bf16, as JAX lowers it
//             (exp(ln 2 x), every step rounded to bf16); f32 row sum
//   noclamp   o = round(exp2(s)) V          (no clamp, no division)
//   noexp     o = round(min(s, 120)) V
//   nosoftmax o = round(s) V
//   nomask    o = G round(S_g) V_head, with S_g the score dot over the
//             group's G*d lanes (Q fragments and K rows of 16 NKS), P V
//             over the head's d lanes (V rows of 16 NK)
//   onedot    the score dot alone, of every key tile: head j at position
//             i of its group stores S_src[:, i*d : (i+1)*d] from the C
//             fragments, S_src over the group's first head's d lanes
//             (pair form) or over the group's lanes (lane form, onedot_sum)
// with q scaled by log2(e)/sqrt(d) in f32 and rounded to bf16, f32
// scores, and p rounded to bf16 before P V with f32 accumulation, as the
// JAX kernels cast. onedot adds one score per n8 tile into a sum stored
// under a condition that never holds, so that no tile's products are
// dropped as dead code.
//
// NK is rounded up to 4 (d <= 64) or 8 and NKS to 4, 8 or 16 (the score
// dot's lanes up to 64, 128 or 256); the padding columns are zeros, which
// add exactly 0. At d = 64 and 128, the tools' widths, the variants run
// K1's tiling exactly.
//
// What bounds it on this card: as K1, issue on the SM (the mma.sync
// products, then the exp2 of every score; ViT-B/16 at T=197 is ~80 FLOP
// per byte of HBM traffic, below the bf16 ridge). The variants move the
// same bytes; their times split K1's time by stage.
//
// The kernel and its launch are in attn_anatomy.cuh; nomask's and
// onedot's instantiations are in attn_anatomy_wide.cu, compiled at once
// with this file.

#include "attn_anatomy.cuh"

namespace anatomy {

// Every variant but nomask and onedot (attn_anatomy_wide.cu), into one
// output section.
template <int V>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  const attn::Group grp{a.group, a.group * a.d, 1, 0};
  return a.d <= 64 ? launch<V, 4, 0>(a, grp, stream) : launch<V, 8, 0>(a, grp, stream);
}

}  // namespace anatomy

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// qkv: contiguous (B, T, 3h) bf16, h = nh * d, 16-byte aligned; out: bf16,
// 16-byte aligned, rows of out_stride elements (a multiple of 8); onedot
// writes out_copies sections h apart, every other variant one (the
// forward tool writes (B, T, h): out_stride = h, one copy).
// variant: 0 full, 1 mxusum, 2 bf16exp, 3 noclamp, 4 noexp, 5 nosoftmax,
// 6 nomask, 7 onedot. group divides nh; group * d <= 256; onedot needs
// T >= group * d. qscale = log2(e)/sqrt(d). Returns cudaGetLastError()
// after the launch.
extern "C" int vit_attn_anatomy(const void* qkv, void* out, int batch, int seq,
                                int nh, int d, int group, int variant,
                                int onedot_sum, long long out_stride,
                                int out_copies, float qscale, void* stream) {
  using namespace anatomy;
  if (batch < 1 || seq < 1 || nh < 1 || d < 8 || d > 128 || d % 8 != 0 ||
      group < 1 || nh % group != 0 || group * d > 256 || batch > 65535 ||
      nh > 65535 || out_copies < 1 || (variant != kOneDot && out_copies != 1) ||
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
