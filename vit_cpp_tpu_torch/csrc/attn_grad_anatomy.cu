// Stage anatomy of the fused-QKV attention backward for Hopper (sm_90a),
// CUDA C++: K2's bf16 bodies with one stage set per variant. At d = 64 the
// body is K2's bf16 wgmma body (attention_grad_bf16_wgmma.cuh, the code of
// attention_qkv_grad.cu's grad_rows_bf16_wgmma and grad_cols_bf16_wgmma);
// at every other d K2's bf16 mma.sync bodies (attention_grad_body.cuh,
// grad_rows_mma and grad_cols_mma), as K2 itself takes them.
//
// Replaces the TPU kernel of tools/attn_grad_anatomy.py::run_variant
// (_grad_pair_kernel), a stage-toggled replica of the TPU's head-pair
// attention backward (safe softmax), timed variant by variant. Here each
// variant is K2's two launches with that variant's stages changed and
// nothing else: launch A (one warpgroup, or at d != 64 four warps, per
// (batch, head, 64-query tile)) takes the row max, sum p and r = sum dp *
// pn in one online pass over the key chunks, then recomputes S and dP and
// writes dq and the row statistics; launch B (one per (batch, head,
// 64-key tile)) recomputes pn and ds and writes dk and dv. At d = 64 every
// product runs on wgmma.m64n64k16 fed by TMA, at other d on
// mma.sync.m16n8k16; P and dS are taken from the accumulators in
// registers. `full` is K2's bf16 path without ToMe sizes, bit for bit.
//
// Input qkv (B, T, 3h) and dO (B, T, h), bf16; output dqkv (B, T, 3h)
// bf16. Per head, with qs = round(q log2(e)/sqrt(d)) and s = qs k^T:
//   full      pn = softmax(s) (exp2, row max); dv = round(pn)^T dO;
//             dp = dO v^T; r = sum dp pn; ds = round(pn (dp - r));
//             dq = ds k / sqrt(d); dk = ds^T q / sqrt(d)          (K2)
//   pipe      full's output, two heads per block. d = 64: one head per
//   pipe2     warpgroup, two (pipe) or four (pipe2) warpgroups a block, so
//             that another head's independent products share the SM's
//             tensor cores with the block's own (the mma.sync form, every
//             stage run for each head in turn inside one warp, would hold
//             2 or 4 heads' accumulators a thread: more registers than a
//             warpgroup has); pipe2's 512 threads may hold 128 registers
//             each, and its launch B's ring is one chunk deep. Other d
//             (d < 64): the mma.sync form, each stage (the S and dP
//             products, the softmax, the dS chain, the dq / dv / dk
//             products) run for every head before the next starts, so a
//             warp has another head's independent products in flight;
//             four heads (pipe2) hold 4 x 2 x 32 f32 accumulators a thread
//             in launch B, and launch B's ring is one tile deep there
//             (four heads of K2's two-deep ring exceed 227 KB)
//   bf16exp   p = exp2 of round(s - max) in bf16, as JAX lowers it
//             (exp(ln 2 x), every step rounded to bf16); f32 sum p
//   nosoftmax pn = s                (no max, exp2, sum or division)
//   nodsoft   ds = round(dp)        (no r, no pn (dp - r))
//   dotsonly  pn = s, ds = round(dp)
//   onedot    the score dot alone over each head pair's 2d lanes: head j
//             at position i of its pair stores (s_lo + s_hi)[:, i*d:(i+1)*d]
//             in all three sections of dqkv. d = 64: the wgmma body's S
//             product (launch A's, qs of both heads against K of both,
//             every 64-key chunk); other d: the forward anatomy's kernel
//             (attn_anatomy.cu, onedot over a pair's lanes).
// Stages a variant switches off are not computed: nodsoft and dotsonly
// skip r, and their dP (nodsoft) or whole statistics pass (dotsonly);
// nosoftmax and dotsonly skip the max, the exp2 and the sum, and dotsonly
// launch A's second S product.
//
// At d != 64 NK is rounded up to 4 (d <= 64) or 8; the padding columns
// are zeros, which add exactly 0. At d = 128 the variants run K2's tiling
// exactly.
//
// What bounds it on this card: as K2, the bytes at ViT-B/16 (qkv, dO and
// dqkv, ~1.8 MB per image and layer in bf16, against five T x T x d
// products per head, nine with the recomputed S and dP).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_grad_bf16_wgmma.cuh"
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

// d = 64: the wgmma body with the variant's stages, S::kHeads warpgroups a
// block; one warpgroup takes K2's register caps.
template <int V>
__global__ void __launch_bounds__(gradbf::kWgThreads * Stages<V>::kHeads,
                                  Stages<V>::kHeads == 1 ? gradbf::kRowsBlocks : 1)
    grad_rows_anatomy_wgmma(const __grid_constant__ CUtensorMap qkv,
                            const __grid_constant__ CUtensorMap dout, gradbf::Params p) {
  gradbf::grad_rows_body<Stages<V>>(qkv, dout, p);
}

template <int V>
__global__ void __launch_bounds__(gradbf::kWgThreads * Stages<V>::kHeads,
                                  Stages<V>::kHeads == 1 ? gradbf::kColsBlocks : 1)
    grad_cols_anatomy_wgmma(const __grid_constant__ CUtensorMap qkv,
                            const __grid_constant__ CUtensorMap dout, gradbf::Params p) {
  gradbf::grad_cols_body<Stages<V>>(qkv, dout, p);
}

template <int V>
cudaError_t launch_wgmma(const grad::Args<bf16>& a, cudaStream_t stream) {
  static bool configured = false;
  return gradbf::launch<Stages<V>>(grad_rows_anatomy_wgmma<V>, grad_cols_anatomy_wgmma<V>,
                                   configured, a.qkv, a.dout, nullptr, a.dqkv, a.stats, a.batch,
                                   a.seq, a.nh, a.qscale, a.nat, stream);
}

// onedot at d = 64: one warpgroup per (batch, head pair, 64-query tile)
// runs the S product of launch A over the pair's 2d lanes, S = qs_0 K_0^T
// + qs_1 K_1^T (eight k steps of wgmma.m64n64k16), for every 64-key chunk
// (K_0 and K_1 by TMA through a ring of two slots), and stores the chunks
// of keys < 2d (T >= 2d): the plain version's output.
constexpr int kOneDotRing = 2;
constexpr size_t kOneDotSmem = 1024 + (2 + 2 * kOneDotRing) * gradbf::kBox;

__global__ void __launch_bounds__(gradbf::kWgThreads, gradbf::kRowsBlocks)
    grad_onedot_wgmma(const __grid_constant__ CUtensorMap qkv, bf16* out, int seq, int nh,
                      float qscale) {
  using gradbf::kBox;
  using gradbf::kChunk;
  constexpr int R = kOneDotRing;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[1 + R];
  unsigned char* sm = gradbf::align1024(smem_raw);
  unsigned char* sQ0 = sm;  // qs of the pair's two heads
  unsigned char* sQ1 = sm + kBox;
  auto slot = [&](int r) { return sm + 2 * kBox + r * 2 * kBox; };  // K of both heads

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, pair = blockIdx.y, q0 = blockIdx.x * gradbf::kRows;
  const int h = nh * gradbf::kD, hc = pair * 2 * gradbf::kD;
  const int nck = (seq + kChunk - 1) / kChunk;
  auto issue = [&](int c) {
    const int r = c % R;
    tc::mbar_arrive_expect_tx(&bars[1 + r], 2 * kBox);
    tc::tma_load_3d(slot(r), &qkv, h + hc, kChunk * c, b, &bars[1 + r]);
    tc::tma_load_3d(slot(r) + kBox, &qkv, h + hc + gradbf::kD, kChunk * c, b, &bars[1 + r]);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + R; ++i) tc::mbar_init(&bars[i], 1);
    tc::fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_arrive_expect_tx(&bars[0], 2 * kBox);
    tc::tma_load_3d(sQ0, &qkv, hc, q0, b, &bars[0]);
    tc::tma_load_3d(sQ1, &qkv, hc + gradbf::kD, q0, b, &bars[0]);
    for (int c = 0; c < R && c < nck; ++c) issue(c);
  }
  tc::mbar_wait_or_trap(&bars[0], 0);
  for (int i = tid; i < 2 * kBox / 16; i += gradbf::kWgThreads)
    gradbf::scale16(sm + 16 * i, sm + 16 * i, qscale);
  tc::fence_proxy_async();
  __syncthreads();

  const long long row3 = 3LL * h;
  bf16* ob = out + (long long)b * seq * row3 + hc;
  for (int c = 0; c < nck; ++c) {
    const unsigned char* k = slot(c % R);
    tc::mbar_wait_or_trap(&bars[1 + c % R], (c / R) & 1);
    float acc[32];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < gradbf::kD / 16; ++kk)
      tc::wgmma_m64n64k16_ss(acc, gradbf::kmajor(sQ0, kk), gradbf::kmajor(k, kk), kk);
#pragma unroll
    for (int kk = 0; kk < gradbf::kD / 16; ++kk)
      tc::wgmma_m64n64k16_ss(acc, gradbf::kmajor(sQ1, kk), gradbf::kmajor(k + kBox, kk), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_operands(acc);
    __syncthreads();  // every warp's wgmmas are past the slot
    if (tid == 0 && c + R < nck) issue(c + R);
    if (kChunk * c >= 2 * gradbf::kD) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = q0 + 16 * warp + g + 8 * i;
      if (t >= seq) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t v = tc::pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        bf16* o = ob + (long long)t * row3 + kChunk * c + 8 * j + 2 * q;
        *reinterpret_cast<uint32_t*>(o) = v;
        *reinterpret_cast<uint32_t*>(o + h) = v;
        *reinterpret_cast<uint32_t*>(o + 2 * h) = v;
      }
    }
  }
}

cudaError_t onedot_wgmma(const grad::Args<bf16>& a, cudaStream_t stream) {
  static bool configured = false;
  CUtensorMap mq, mo;
  cudaError_t err = gradbf::encode_maps(&mq, &mo, a.qkv, a.dout, a.batch, a.seq, a.nh);
  if (err != cudaSuccess) return err;
  if (!configured) {
    err = cudaFuncSetAttribute(grad_onedot_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kOneDotSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.seq + gradbf::kRows - 1) / gradbf::kRows, a.nh / 2, a.batch);
  grad_onedot_wgmma<<<grid, gradbf::kWgThreads, kOneDotSmem, stream>>>(mq, a.dqkv, a.seq, a.nh,
                                                                         a.qscale);
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// qkv, dqkv: contiguous (B, T, 3h) bf16; dout: contiguous (B, T, h) bf16;
// all three 16-byte aligned; stats: an f32 workspace of B * nh * T * 3
// floats. variant: 0 full, 1 pipe, 2 pipe2, 3 bf16exp, 4 nosoftmax,
// 5 nodsoft, 6 dotsonly, 7 onedot. nh even; pipe2 needs nh % 4 == 0;
// pipe and pipe2 take d <= 64; onedot needs T >= 2d. qscale =
// log2(e)/sqrt(d), nat = 1/sqrt(d). d = 64 runs the wgmma body (16-byte
// aligned rows, TMA), other d the mma.sync bodies. Returns
// cudaGetLastError() after the launches.
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
  const grad::Args<bf16> a{static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
                           nullptr, static_cast<bf16*>(dqkv), static_cast<float*>(stats),
                           batch, seq, nh, d, qscale, nat};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == gradbf::kD) {
    switch (variant) {
      case kFull: return (int)launch_wgmma<kFull>(a, s);
      case kPipe: return (int)launch_wgmma<kPipe>(a, s);
      case kPipe2: return (int)launch_wgmma<kPipe2>(a, s);
      case kBf16Exp: return (int)launch_wgmma<kBf16Exp>(a, s);
      case kNoSoftmax: return (int)launch_wgmma<kNoSoftmax>(a, s);
      case kNoDsoft: return (int)launch_wgmma<kNoDsoft>(a, s);
      case kDotsOnly: return (int)launch_wgmma<kDotsOnly>(a, s);
      case kOneDot: return (int)onedot_wgmma(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (variant == kOneDot) {
    return vit_attn_anatomy(qkv, dqkv, batch, seq, nh, d, 2, kAnatomyOneDot, 1,
                            3LL * nh * d, 3, qscale, stream);
  }
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
