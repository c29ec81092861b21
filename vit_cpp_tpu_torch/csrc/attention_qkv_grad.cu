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
//   bf16, d = 64    grad_rows_bf16_wgmma / grad_cols_bf16_wgmma
//                   (attention_grad_bf16_wgmma.cuh: bf16 wgmma fed by TMA)
//   any other call  grad_rows_mma / grad_cols_mma (attention_grad_body.cuh:
//                   mma.sync fed by cp.async; bf16 and f32 at d = 72, 88,
//                   128, ...)
// vit_attention_qkv_grad_mma runs the mma.sync bodies at any (dtype, d),
// f32 d = 64 and 80 and bf16 d = 64 included, so that the checks can time
// them beside the wgmma bodies; no path of the port calls it. The
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

// The f32 body at d = 64 and 80 (attention_grad_wgmma.cuh): launch A, then
// launch B, one block of two warpgroups per SM.
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

// Tensor maps over the images: qkv (rows of 3h) and dO (rows of h) f32, in
// boxes of one swizzle row (d = 64: 32 columns, 128 bytes; d = 80: 16, 64
// bytes) by 64 rows (the resident tiles) or each launch's kChunk (the
// streamed chunks); the token extent is seq.
template <int D>
cudaError_t run_wgmma(const void* qkv, const void* dout, const void* sizes, void* dqkv,
                      void* stats, int batch, int seq, int nh, float qscale, float nat,
                      cudaStream_t stream) {
  using ga = gradwg::GA<D>;
  using gb = gradwg::GB<D>;
  auto* rows = D == 64 ? grad_rows_wgmma : grad_rows_wgmma80;
  auto* cols = D == 64 ? grad_cols_wgmma : grad_cols_wgmma80;
  const uint64_t h = (uint64_t)nh * D, f = sizeof(float);
  const uint32_t bc = ga::kBoxCols, sw = ga::kSw;
  CUtensorMap qkv_res, qkv_a, do_res, qkv_b, do_b;
  const CUtensorMapDataType t = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  cudaError_t err = tc::encode_sw_3d(&qkv_res, t, qkv, 3 * h, seq, batch, 3 * h * f,
                                     seq * 3 * h * f, bc, 64, sw);
  if (err == cudaSuccess)
    err = tc::encode_sw_3d(&qkv_a, t, qkv, 3 * h, seq, batch, 3 * h * f, seq * 3 * h * f, bc,
                           ga::kChunk, sw);
  if constexpr (ga::kChunk == gb::kChunk)
    qkv_b = qkv_a;
  else if (err == cudaSuccess)
    err = tc::encode_sw_3d(&qkv_b, t, qkv, 3 * h, seq, batch, 3 * h * f, seq * 3 * h * f, bc,
                           gb::kChunk, sw);
  if (err == cudaSuccess)
    err = tc::encode_sw_3d(&do_res, t, dout, h, seq, batch, h * f, seq * h * f, bc, 64, sw);
  if (err == cudaSuccess)
    err = tc::encode_sw_3d(&do_b, t, dout, h, seq, batch, h * f, seq * h * f, bc, gb::kChunk, sw);
  if (err != cudaSuccess) return err;
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)gradwg::rows_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)gradwg::cols_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const gradwg::Params p{static_cast<const float*>(sizes), static_cast<float*>(dqkv),
                         static_cast<float*>(stats), seq, nh, qscale, nat};
  const dim3 grid((seq + gradwg::kRows - 1) / gradwg::kRows, nh, batch);
  rows<<<grid, gradwg::kThreads, gradwg::rows_smem_bytes<D>(), stream>>>(qkv_res, qkv_a,
                                                                         do_res, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols<<<grid, gradwg::kThreads, gradwg::cols_smem_bytes<D>(), stream>>>(qkv_res, qkv_b,
                                                                         do_b, p);
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
// Returns cudaGetLastError() after the launches. f32 at d = 64 and 80 and
// bf16 at d = 64 take the wgmma bodies, every other call the mma.sync
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
  if (dtype == 0)
    return (int)run<float>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, d, qscale, nat, s);
  if (dtype == 1 && d == 64)
    return (int)run_bf16_wgmma(qkv, dout, sizes, dqkv, stats, batch, seq, nh, qscale, nat, s);
  if (dtype == 1)
    return (int)run<bf16>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, d, qscale, nat, s);
  return (int)cudaErrorInvalidValue;
}

// vit_attention_qkv_grad through the mma.sync bodies at any (dtype, d),
// f32 d = 64 and 80 and bf16 d = 64 included, for the checks only:
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
