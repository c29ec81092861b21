// Backward of the fused-QKV attention for Hopper (sm_90a), CUDA C++.
//
// vit_attention_qkv_grad replaces the TPU kernels behind vit_cpp_tpu/ops/
// flash_attention.py::_attention_qkv_grad: _qkv_grad_pair_kernel (d=64),
// _qkv_grad_kernel + _qkv_grad_head (any d, odd head tails) and
// _qkv_grad_lane_kernel (large T x h, via _attention_qkv_grad_lane). It
// covers all of their shapes: T >= 1, d a multiple of 8 up to 128, bf16
// or f32, with or without the ToMe `sizes` key weights. Its inputs are the
// (B, T, 3h) output of the fused projection ([q | k | v] on the feature
// axis, heads contiguous inside each third) and the (B, T, h) cotangent
// dO of the attention output; its output is the (B, T, 3h) cotangent
// [dq | dk | dv] in the same layout. Q, K, V and dO are read in place and
// dq, dk, dv written in place: no head split or concat in device memory.
//
// Which body takes a call:
//   f32, d = 64     grad_rows_wgmma / grad_cols_wgmma (attention_grad_
//                   wgmma.cuh: 3xTF32 on wgmma fed by TMA; every training
//                   path's head at ViT-Ti/S/B/L, ToMe, the mesh's shards)
//   f32, d = 80     grad_rows_wgmma80 / grad_cols_wgmma80 (the same body
//                   on d = 80's plan; ViT-H/14's training path)
//   f32, d = 88     grad_rows_wgmma88 / grad_cols_wgmma88 (d = 80's plan,
//                   each tile five 64-byte boxes and a 32-byte tail box;
//                   ViT-g/14's training path)
//   bf16, d = 64    grad_rows_bf16_wgmma / grad_cols_bf16_wgmma
//                   (attention_grad_bf16_wgmma.cuh: bf16 wgmma fed by TMA)
//   any other call  grad_rows_mma / grad_cols_mma (attention_grad_body.cuh:
//                   mma.sync fed by cp.async; bf16 at d = 72, 80, 88,
//                   128, ..., f32 at d = 72, 128, ...)
// vit_attention_qkv_grad_mma runs the mma.sync bodies at any (dtype, d),
// f32 d = 64, 80 and 88 and bf16 d = 64 included, so that the checks can
// time them beside the wgmma bodies; no path of the port calls it. The
// mma.sync bodies' code is attention_grad_body.cuh, which the backward
// anatomy (attn_grad_anatomy.cu) instantiates with stages changed at d !=
// 64 (at d = 64 it instantiates the bf16 wgmma body); what follows is their
// design, and each wgmma body's note says what it does in their place.
//
// Per head it computes what _qkv_grad_head computes (the forward is
// recomputed from qkv; no (T, T) tensor ever reaches device memory):
//   qs = round_T(q * log2(e)/sqrt(d)); s = qs k^T (f32);
//   p = exp2(s - rowmax s) [* sizes[key]]; pn = p / sum p;
//   dv = round_T(pn)^T dO; dp = dO v^T; r = sum_keys dp * pn;
//   ds = round_T(pn * (dp - r));
//   dq = ds k / sqrt(d); dk = ds^T q / sqrt(d) (q unscaled);
// every product accumulated in f32 and cast to T on store.
//
// What bounds it on this card. At ViT-B/16 (T=197, d=64) the backward is
// five T x T x d products per head (~0.15 GFLOP per image per layer)
// against ~2 MB of qkv, dO and dqkv traffic: the tensor cores' rate, not
// HBM. Recomputing s and dp costs products of its own (nine T x T x d
// products per tile pair here, against the five the result needs).
//
// What the design does about it. Blocks run in no order and share
// nothing, so the reductions over keys (dq) and over queries (dk, dv)
// are split into two launches, with no atomics (deterministic):
//   A. one block per (batch, head, 64-query tile), four warps of 16
//      query rows. Pass 1 over the key tiles (f32 32 keys; bf16 64, in
//      chunks of 16) computes S = qs K^T and dP = dO V^T and keeps, per
//      row, an online max m with l = sum p and u = sum dp * p, both
//      rescaled by exp2(m_old - m_new) when m grows; at its end r = u / l
//      (sum dp * pn up to f32 rounding). Pass 2 recomputes S and dP, takes
//      p = exp2(s - m) with the final, exact row max (as the plain version
//      does), forms dS and accumulates dQ = dS K. It writes dq and the
//      per-row (max, 1/sum p, r) into an f32 workspace (B, nh, T, 3).
//      Two products per key tile in pass 1, three in pass 2.
//   B. one block per (batch, head, 64-key tile), four warps of 16 keys.
//      It walks the query tiles (f32 32 queries; bf16 64, in chunks of
//      16), computes S^T = K qs^T and dP^T = V dO^T with the keys as
//      rows, recomputes pn from the stored row statistics and accumulates
//      dV = round(Pn^T) dO and dK = dS^T q in registers. Four products
//      per tile pair.
// Every product runs on the tensor cores, its A operand a warp's 16 rows
// and its accumulators in registers. The orientation of each launch makes
// P and dS, where they are operands, the A operand straight from the S
// and dP accumulators (dQ = dS K in A; dV = Pn^T dO and dK = dS^T q in B):
// no (T, T) tile goes through shared memory.
//   bf16: mma.sync.m16n8k16; the m16n8 C layout is the m16n8k16 A layout
//         (tensor_core.cuh), so rounded pairs of accumulators are the A
//         fragments; K, V, Q and dO fragments by ldmatrix (.trans where
//         the contraction runs over a tile's rows; f32 fragments whose
//         contraction runs along a row by ldmatrix too, 32-bit elements as
//         pairs of b16).
//   f32:  3xTF32 on mma.sync.m16n8k8.tf32 (tensor_core.cuh): each operand
//         split into TF32 hi and lo parts, hi*hi + hi*lo + lo*hi in f32
//         accumulators. One TF32 product (2^-11 per operand) would miss
//         the f32 tolerance; three stay at f32 rounding's size (the
//         tests emulate both on the CPU). TF32 rounding is two integer
//         operations (tensor_core.cuh).
//         The C tile is not the m16n8k8 A fragment: the contraction index
//         is renumbered instead of shuffling registers (tensor_core.cuh).
// Tiles are copied by cp.async, 16 bytes a thread, in the input type (bf16
// stays bf16 in shared memory), into a ring of K/V (A) or Q/dO (B) tiles,
// 2 deep in bf16 and 1 in f32 (32-row tiles): three or four blocks share
// an SM at d = 64 (f32: four) and hide one another's copies (ring(),
// stream(), blocks_for()). Rows are padded (bf16: 16 bytes, so ldmatrix's
// eight row addresses fall in distinct banks; f32: 4 floats, a row stride
// of 4 mod 8 words, so ldmatrix's rows and the scalar fragment loads do),
// and d is padded to a multiple of 16 with zero columns, which add
// exactly 0. qs is
// q * scale rounded to T: launch A scales its Q tile in place; launch B
// keeps q unscaled for dK and scales as it reads (f32) or into a tile of
// its own (bf16). Key or query tiles of 8 (bf16: 16) past the sequence
// skip their products, warps whose 16 rows are all past it skip the tile.
//
// Numerics. The softmax and ds chains use __fmul_rn / __fsub_rn so that
// nvcc cannot contract them into FMAs the plain version does not do. pn is
// p times 1/sum p, the reciprocal rounded once per row (the workspace
// holds it in place of sum p): at most an ulp from p / sum p, and no
// division per score. Pad keys get p = 0 and pad queries pn = 0, so
// neither reaches a real row's statistics or gradient. Launch B computes
// the scores in the other orientation (K as the A operand); its products
// are the same values at the same contraction positions (f32: the cross
// terms in the mirrored order), so its scores are A's unless the tensor
// cores sum a transposed tile in another order. If they do, s - max may
// exceed 0 by an ulp of s and p exceed 1 by as little: nothing overflows
// or divides by zero, and pn differs from A's by f32 rounding, far below
// the tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_grad_bf16_wgmma.cuh"
#include "attention_grad_body.cuh"
#include "attention_grad_wgmma.cuh"
#include "tensor_map.cuh"

namespace {

using grad::Args;
using grad::bf16;
using grad::blocks_for;
using grad::cols_smem_bytes;
using grad::kThreads;
using grad::kTile;
using grad::rows_smem_bytes;

// Launch A: one block per (batch, head, 64-query tile) -> dq, row statistics.
template <typename T, int NK>
__global__ void __launch_bounds__(kThreads, blocks_for(rows_smem_bytes<T, NK>())) grad_rows_mma(Args<T> a) {
  grad::grad_rows_body<T, NK>(a);
}

// Launch B: one block per (batch, head, 64-key tile) -> dk, dv.
template <typename T, int NK>
__global__ void __launch_bounds__(kThreads, blocks_for(cols_smem_bytes<T, NK>())) grad_cols_mma(Args<T> a) {
  grad::grad_cols_body<T, NK>(a);
}

template <typename T, int NK>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t rows_bytes = rows_smem_bytes<T, NK>();
  constexpr size_t cols_bytes = cols_smem_bytes<T, NK>();
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        grad_rows_mma<T, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        grad_cols_mma<T, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cols_bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.seq + kTile - 1) / kTile, a.nh, a.batch);
  grad_rows_mma<T, NK><<<grid, kThreads, rows_bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grad_cols_mma<T, NK><<<grid, kThreads, cols_bytes, stream>>>(a);
  return cudaGetLastError();
}

// NK = ceil(d / 16): 16-wide slices of the (zero-padded) head dimension.
template <typename T>
cudaError_t dispatch(const Args<T>& a, cudaStream_t stream) {
  switch ((a.d + 15) / 16) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    case 4: return launch<T, 4>(a, stream);
    case 5: return launch<T, 5>(a, stream);
    case 6: return launch<T, 6>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    case 8: return launch<T, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The f32 body at d = 64, 80 and 88 (attention_grad_wgmma.cuh): launch A,
// then launch B, one block of two warpgroups per SM.
__global__ void __launch_bounds__(gradwg::kThreads, 1)
    grad_rows_wgmma(const __grid_constant__ CUtensorMap qkv64,
                    const __grid_constant__ CUtensorMap qkv32,
                    const __grid_constant__ CUtensorMap do64, gradwg::Params p) {
  gradwg::grad_rows_body<64>(qkv64, qkv32, do64, p);
}

__global__ void __launch_bounds__(gradwg::kThreads, 1)
    grad_cols_wgmma(const __grid_constant__ CUtensorMap qkv64,
                    const __grid_constant__ CUtensorMap qkv32,
                    const __grid_constant__ CUtensorMap do32, gradwg::Params p) {
  gradwg::grad_cols_body<64>(qkv64, qkv32, do32, p);
}

__global__ void __launch_bounds__(gradwg::kThreads, 1)
    grad_rows_wgmma80(const __grid_constant__ CUtensorMap qkv64,
                      const __grid_constant__ CUtensorMap qkv32,
                      const __grid_constant__ CUtensorMap do64, gradwg::Params p) {
  gradwg::grad_rows_body<80>(qkv64, qkv32, do64, p);
}

__global__ void __launch_bounds__(gradwg::kThreads, 1)
    grad_cols_wgmma80(const __grid_constant__ CUtensorMap qkv64,
                      const __grid_constant__ CUtensorMap qkv16,
                      const __grid_constant__ CUtensorMap do16, gradwg::Params p) {
  gradwg::grad_cols_body<80>(qkv64, qkv16, do16, p);
}

// d = 88, with the maps of the three operands' tail boxes.
__global__ void __launch_bounds__(gradwg::kThreads, 1)
    grad_rows_wgmma88(const __grid_constant__ CUtensorMap qkv64,
                      const __grid_constant__ CUtensorMap qkv32,
                      const __grid_constant__ CUtensorMap do64,
                      const __grid_constant__ tf32wg::Tails tails, gradwg::Params p) {
  gradwg::grad_rows_body<88>(qkv64, qkv32, do64, p, tails.m);
}

__global__ void __launch_bounds__(gradwg::kThreads, 1)
    grad_cols_wgmma88(const __grid_constant__ CUtensorMap qkv64,
                      const __grid_constant__ CUtensorMap qkv16,
                      const __grid_constant__ CUtensorMap do16,
                      const __grid_constant__ tf32wg::Tails tails, gradwg::Params p) {
  gradwg::grad_cols_body<88>(qkv64, qkv16, do16, p, tails.m);
}

// Tensor maps over the images: qkv (rows of 3h) and dO (rows of h) f32, in
// boxes of `bc` columns in the (4 bc)-byte swizzle by 64 rows (the
// resident tiles) or each launch's kChunk (the streamed chunks); the token
// extent is seq. m: qkv's resident, launch A's and launch B's, then dO's
// resident and launch B's.
cudaError_t encode_grad(CUtensorMap (&m)[5], const void* qkv, const void* dout, uint64_t h,
                        int seq, int batch, int chunk_a, int chunk_b, uint32_t bc) {
  const uint64_t f = sizeof(float);
  const CUtensorMapDataType t = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int rows[5] = {64, chunk_a, chunk_b, 64, chunk_b};
  for (int i = 0; i < 5; ++i) {
    if (i == 2 && chunk_b == chunk_a) {
      m[2] = m[1];
      continue;
    }
    const bool q = i < 3;
    cudaError_t err = tc::encode_sw_3d(&m[i], t, q ? qkv : dout, (q ? 3 : 1) * h, seq, batch,
                                       (q ? 3 : 1) * h * f, seq * (q ? 3 : 1) * h * f, bc,
                                       rows[i], 4 * bc);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Launch A, then launch B, each with its maps (and at d = 88 its tail
// boxes' maps).
template <int D>
cudaError_t run_wgmma(const void* qkv, const void* dout, const void* sizes, void* dqkv,
                      void* stats, int batch, int seq, int nh, float qscale, float nat,
                      cudaStream_t stream) {
  using ga = gradwg::GA<D>;
  using gb = gradwg::GB<D>;
  const uint64_t h = (uint64_t)nh * D;
  CUtensorMap m[5];
  cudaError_t err = encode_grad(m, qkv, dout, h, seq, batch, ga::kChunk, gb::kChunk,
                                ga::kBoxCols);
  if (err != cudaSuccess) return err;
  // the tail maps as each launch's body takes them: qkv resident, qkv
  // streamed, then dO resident (A) or streamed (B)
  tf32wg::Tails ta, tb;
  if constexpr (ga::kTail > 0) {
    CUtensorMap t[5];
    err = encode_grad(t, qkv, dout, h, seq, batch, ga::kChunk, gb::kChunk, ga::kTail);
    if (err != cudaSuccess) return err;
    ta.m[0] = tb.m[0] = t[0], ta.m[1] = t[1], ta.m[2] = t[3], tb.m[1] = t[2], tb.m[2] = t[4];
  }
  const gradwg::Params p{static_cast<const float*>(sizes), static_cast<float*>(dqkv),
                         static_cast<float*>(stats), seq, nh, qscale, nat};
  const dim3 grid((seq + gradwg::kRows - 1) / gradwg::kRows, nh, batch);
  constexpr int kRowsBytes = gradwg::rows_smem_bytes<D>();
  constexpr int kColsBytes = gradwg::cols_smem_bytes<D>();
  auto* rows = D == 64 ? grad_rows_wgmma : D == 80 ? grad_rows_wgmma80 : nullptr;
  auto* cols = D == 64 ? grad_cols_wgmma : D == 80 ? grad_cols_wgmma80 : nullptr;
  static bool configured = false;
  if (!configured) {
    if constexpr (D == 88) {
      err = cudaFuncSetAttribute(grad_rows_wgmma88, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kRowsBytes);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(grad_cols_wgmma88,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kColsBytes);
    } else {
      err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowsBytes);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize, kColsBytes);
    }
    if (err != cudaSuccess) return err;
    configured = true;
  }
  if constexpr (D == 88)
    grad_rows_wgmma88<<<grid, gradwg::kThreads, kRowsBytes, stream>>>(m[0], m[1], m[3], ta, p);
  else
    rows<<<grid, gradwg::kThreads, kRowsBytes, stream>>>(m[0], m[1], m[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (D == 88)
    grad_cols_wgmma88<<<grid, gradwg::kThreads, kColsBytes, stream>>>(m[0], m[2], m[4], tb, p);
  else
    cols<<<grid, gradwg::kThreads, kColsBytes, stream>>>(m[0], m[2], m[4], p);
  return cudaGetLastError();
}

// The bf16 body at d = 64 (attention_grad_bf16_wgmma.cuh) at K2's stages:
// launch A, then launch B, one warpgroup per block.
__global__ void __launch_bounds__(gradbf::kWgThreads, gradbf::kRowsBlocks)
    grad_rows_bf16_wgmma(const __grid_constant__ CUtensorMap qkv,
                         const __grid_constant__ CUtensorMap dout, gradbf::Params p) {
  gradbf::grad_rows_body<grad::Stages>(qkv, dout, p);
}

__global__ void __launch_bounds__(gradbf::kWgThreads, gradbf::kColsBlocks)
    grad_cols_bf16_wgmma(const __grid_constant__ CUtensorMap qkv,
                         const __grid_constant__ CUtensorMap dout, gradbf::Params p) {
  gradbf::grad_cols_body<grad::Stages>(qkv, dout, p);
}

cudaError_t run_bf16_wgmma(const void* qkv, const void* dout, const void* sizes, void* dqkv,
                           void* stats, int batch, int seq, int nh, float qscale, float nat,
                           cudaStream_t stream) {
  static bool configured = false;
  return gradbf::launch<grad::Stages>(grad_rows_bf16_wgmma, grad_cols_bf16_wgmma, configured,
                                      qkv, dout, sizes, dqkv, stats, batch, seq, nh, qscale, nat,
                                      stream);
}

template <typename T>
cudaError_t run(const void* qkv, const void* dout, const void* sizes, void* dqkv, void* stats,
                int batch, int seq, int nh, int d, float qscale, float nat, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(qkv), static_cast<const T*>(dout),
                  static_cast<const float*>(sizes), static_cast<T*>(dqkv),
                  static_cast<float*>(stats), batch, seq, nh, d, qscale, nat};
  return dispatch<T>(a, stream);
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

bool bad_call(const void* qkv, const void* dout, const void* dqkv, int batch, int seq, int nh,
              int d) {
  return batch < 1 || seq < 1 || nh < 1 || d < 8 || d > 128 || d % 8 != 0 || batch > 65535 ||
         nh > 65535 || misaligned(qkv) || misaligned(dout) || misaligned(dqkv);
}

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// qkv, dqkv: contiguous (B, T, 3h); dout: contiguous (B, T, h); qkv, dout
// and dqkv 16-byte aligned (16-byte copies, TMA); sizes: (B, T) float32
// or null; stats: an f32 workspace of B * nh * T * 3 floats. dtype: 0 =
// float32, 1 = bfloat16. qscale = log2(e)/sqrt(d), nat = 1/sqrt(d).
// Returns cudaGetLastError() after the launches. f32 at d = 64, 80 and 88
// and bf16 at d = 64 take the wgmma bodies, every other call the mma.sync
// bodies.
extern "C" int vit_attention_qkv_grad(const void* qkv, const void* dout, const void* sizes,
                                      void* dqkv, void* stats, int batch, int seq, int nh,
                                      int d, float qscale, float nat, int dtype, void* stream) {
  if (bad_call(qkv, dout, dqkv, batch, seq, nh, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && d == 64)
    return (int)run_wgmma<64>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, qscale, nat, s);
  if (dtype == 0 && d == 80)
    return (int)run_wgmma<80>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, qscale, nat, s);
  if (dtype == 0 && d == 88)
    return (int)run_wgmma<88>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, qscale, nat, s);
  if (dtype == 0)
    return (int)run<float>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, d, qscale, nat, s);
  if (dtype == 1 && d == 64)
    return (int)run_bf16_wgmma(qkv, dout, sizes, dqkv, stats, batch, seq, nh, qscale, nat, s);
  if (dtype == 1)
    return (int)run<bf16>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, d, qscale, nat, s);
  return (int)cudaErrorInvalidValue;
}

// vit_attention_qkv_grad through the mma.sync bodies at any (dtype, d),
// f32 d = 64, 80 and 88 and bf16 d = 64 included, for the checks only:
// chip_smoke.py times them beside the wgmma bodies. No path of the port
// calls it.
extern "C" int vit_attention_qkv_grad_mma(const void* qkv, const void* dout, const void* sizes,
                                          void* dqkv, void* stats, int batch, int seq, int nh,
                                          int d, float qscale, float nat, int dtype,
                                          void* stream) {
  if (bad_call(qkv, dout, dqkv, batch, seq, nh, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, d, qscale, nat, s);
  if (dtype == 1)
    return (int)run<bf16>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, d, qscale, nat, s);
  return (int)cudaErrorInvalidValue;
}
