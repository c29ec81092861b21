// Stage anatomy of the fused-QKV attention backward for Hopper (sm_90a),
// CUDA C++: K2's bf16 tensor-core bodies (attention_grad_body.cuh, the code
// of attention_qkv_grad.cu's grad_rows_mma and grad_cols_mma) with one
// stage set per variant.
//
// Replaces the TPU kernel of tools/attn_grad_anatomy.py::run_variant
// (_grad_pair_kernel), a stage-toggled replica of the TPU's head-pair
// attention backward (safe softmax), timed variant by variant. Here each
// variant is K2's two launches with that variant's stages changed and
// nothing else: launch A, one block of 4 warps per (batch, head, 64-query
// tile), takes the row max, sum p and r = sum dp * pn in one online pass
// over the key tiles, then recomputes S and dP and writes dq and the row
// statistics; launch B, one block per (batch, head, 64-key tile),
// recomputes pn and ds and writes dk and dv. Every product runs on
// mma.sync.m16n8k16, P and dS taken from the accumulators in registers.
// `full` is K2's bf16 path without ToMe sizes, bit for bit.
//
// Input qkv (B, T, 3h) and dO (B, T, h), bf16; output dqkv (B, T, 3h)
// bf16. Per head, with qs = round(q log2(e)/sqrt(d)) and s = qs k^T:
//   full      pn = softmax(s) (exp2, row max); dv = round(pn)^T dO;
//             dp = dO v^T; r = sum dp pn; ds = round(pn (dp - r));
//             dq = ds k / sqrt(d); dk = ds^T q / sqrt(d)          (K2)
//   pipe      full's output, two heads per block, each stage (the S and
//   pipe2     dP products, the softmax, the dS chain, the dq / dv / dk
//             products) run for every head before the next starts, so a
//             warp has another head's independent products in flight;
//             four heads (pipe2) hold 4 x 2 x 32 f32 accumulators a thread
//             in launch B, and launch B's ring is one tile deep there (four
//             heads of K2's two-deep ring exceed 227 KB)
//   bf16exp   p = exp2 of round(s - max) in bf16, as JAX lowers it
//             (exp(ln 2 x), every step rounded to bf16); f32 sum p
//   nosoftmax pn = s                (no max, exp2, sum or division)
//   nodsoft   ds = round(dp)        (no r, no pn (dp - r))
//   dotsonly  pn = s, ds = round(dp)
//   onedot    the score dot alone, by the forward anatomy's kernel
//             (attn_anatomy.cu, onedot over a pair's lanes): head j at
//             position i of its pair stores (s_lo + s_hi)[:, i*d:(i+1)*d]
//             in all three sections of dqkv.
// Stages a variant switches off are not computed: nodsoft and dotsonly
// skip r, and their dP (nodsoft) or whole statistics pass (dotsonly);
// nosoftmax and dotsonly skip the max, the exp2 and the sum, and dotsonly
// launch A's second S product.
//
// NK is rounded up to 4 (d <= 64) or 8; the padding columns are zeros,
// which add exactly 0. At d = 64 and 128, the tools' widths, the variants
// run K2's tiling exactly.
//
// What bounds it on this card: as K2, the tensor cores' rate (five T x T
// x d products per head, nine with the recomputed S and dP, against ~2 MB
// of HBM traffic per image and layer at ViT-B/16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_grad_body.cuh"

extern "C" int vit_attn_anatomy(const void* qkv, void* out, int batch, int seq,
                                int nh, int d, int group, int variant,
                                int onedot_sum, long long out_stride,
                                int out_copies, float qscale, void* stream);

namespace {

using grad::bf16;

enum Variant { kFull, kPipe, kPipe2, kBf16Exp, kNoSoftmax, kNoDsoft, kDotsOnly, kOneDot };

constexpr int kAnatomyOneDot = 7;  // attn_anatomy.cu's onedot variant

// One stage set per variant: K2's (grad::Stages) with its stages changed.
template <int V>
struct Stages : grad::Stages {
  static constexpr bool kSoftmax = V != kNoSoftmax && V != kDotsOnly;
  static constexpr bool kBf16Exp = V == Variant::kBf16Exp;
  static constexpr bool kDsoft = V != kNoDsoft && V != kDotsOnly;
  static constexpr int kHeads = V == kPipe ? 2 : (V == kPipe2 ? 4 : 1);
  static constexpr int kColsRing = V == kPipe2 ? 1 : 0;
};

template <int V, int NK>
__global__ void __launch_bounds__(grad::kThreads,
                                  grad::blocks_for(grad::rows_smem_bytes<bf16, NK, Stages<V>>()))
    grad_rows_anatomy(grad::Args<bf16> a) {
  grad::grad_rows_body<bf16, NK, Stages<V>>(a);
}

template <int V, int NK>
__global__ void __launch_bounds__(grad::kThreads,
                                  grad::blocks_for(grad::cols_smem_bytes<bf16, NK, Stages<V>>()))
    grad_cols_anatomy(grad::Args<bf16> a) {
  grad::grad_cols_body<bf16, NK, Stages<V>>(a);
}

template <int V, int NK>
cudaError_t launch(const grad::Args<bf16>& a, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t rows_bytes = grad::rows_smem_bytes<bf16, NK, Stages<V>>();
  constexpr size_t cols_bytes = grad::cols_smem_bytes<bf16, NK, Stages<V>>();
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        grad_rows_anatomy<V, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        grad_cols_anatomy<V, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cols_bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.seq + grad::kTile - 1) / grad::kTile, a.nh / Stages<V>::kHeads, a.batch);
  grad_rows_anatomy<V, NK><<<grid, grad::kThreads, rows_bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grad_cols_anatomy<V, NK><<<grid, grad::kThreads, cols_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int V>
cudaError_t dispatch(const grad::Args<bf16>& a, cudaStream_t stream) {
  return a.d <= 64 ? launch<V, 4>(a, stream) : launch<V, 8>(a, stream);
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// qkv, dqkv: contiguous (B, T, 3h) bf16; dout: contiguous (B, T, h) bf16;
// all three 16-byte aligned; stats: an f32 workspace of B * nh * T * 3
// floats. variant: 0 full, 1 pipe, 2 pipe2, 3 bf16exp, 4 nosoftmax,
// 5 nodsoft, 6 dotsonly, 7 onedot. nh even; pipe2 needs nh % 4 == 0;
// pipe and pipe2 take d <= 64; onedot needs T >= 2d. qscale =
// log2(e)/sqrt(d), nat = 1/sqrt(d). Returns cudaGetLastError() after the
// launches.
extern "C" int vit_attn_grad_anatomy(const void* qkv, const void* dout, void* dqkv,
                                     void* stats, int batch, int seq, int nh, int d,
                                     int variant, float qscale, float nat,
                                     void* stream) {
  if (batch < 1 || seq < 1 || nh < 2 || nh % 2 != 0 || d < 8 || d > 128 ||
      d % 8 != 0 || batch > 65535 || nh > 65535 ||
      ((variant == kPipe || variant == kPipe2) && d > 64) ||
      (variant == kPipe2 && nh % 4 != 0) || misaligned(qkv) || misaligned(dout) ||
      misaligned(dqkv)) {
    return (int)cudaErrorInvalidValue;
  }
  if (variant == kOneDot) {
    return vit_attn_anatomy(qkv, dqkv, batch, seq, nh, d, 2, kAnatomyOneDot, 1,
                            3LL * nh * d, 3, qscale, stream);
  }
  const grad::Args<bf16> a{static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
                           nullptr, static_cast<bf16*>(dqkv), static_cast<float*>(stats),
                           batch, seq, nh, d, qscale, nat};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return (int)dispatch<kFull>(a, s);
    case kPipe: return (int)launch<kPipe, 4>(a, s);
    case kPipe2: return (int)launch<kPipe2, 4>(a, s);
    case kBf16Exp: return (int)dispatch<kBf16Exp>(a, s);
    case kNoSoftmax: return (int)dispatch<kNoSoftmax>(a, s);
    case kNoDsoft: return (int)dispatch<kNoDsoft>(a, s);
    case kDotsOnly: return (int)dispatch<kDotsOnly>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
