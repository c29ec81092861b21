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

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // queries (launch A) or keys (launch B) per block
constexpr int kWarps = 4;  // 16 rows each
constexpr int kThreads = 32 * kWarps;

// Row stride (elements) of a staged tile of 16 NK columns.
template <typename T, int NK>
__host__ __device__ constexpr int ld() {
  return 16 * NK + (sizeof(T) == 4 ? 4 : 8);
}

// Tiles in a ring: one (f32) or two (bf16). Blocks on the same SM hide
// one another's copies; an H100 ran the f32 body 12% faster with one tile
// and three blocks than with two tiles and two blocks.
template <typename T>
__host__ __device__ constexpr int ring() {
  return sizeof(T) == 4 ? 1 : 2;
}

// Keys per chunk of launch A's tiles, queries per chunk of launch B's
// (f32 32, bf16 16): the S and dP accumulators of one chunk are 2 x
// chunk / 2 registers. The chunk loops are not unrolled: fully unrolled,
// the f32 body took 241-255 registers and ran 1.27x slower on an H100;
// the bf16 body ran 1.09x faster with chunks of 16 than of 32.
template <typename T>
__host__ __device__ constexpr int chunk() {
  return sizeof(T) == 4 ? 32 : 16;
}

// Rows of the tiles a block streams through its ring (keys in launch A,
// queries in launch B): f32 32, one chunk, so that a block's tiles take
// 52 KB at d = 64; bf16 64.
template <typename T>
__host__ __device__ constexpr int stream() {
  return sizeof(T) == 4 ? 32 : 64;
}

// bf16: launch B keeps a tile of round(q * scale) beside the ring.
template <typename T>
__host__ __device__ constexpr bool stage_qs() {
  return sizeof(T) == 2;
}

template <typename T, int NK>
__host__ __device__ constexpr size_t tile_bytes(int rows) {
  return (size_t)rows * ld<T, NK>() * sizeof(T);
}

// Launch A: qs, dO, and a ring of K and V tiles.
template <typename T, int NK>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  return 2 * tile_bytes<T, NK>(kTile) + 2 * ring<T>() * tile_bytes<T, NK>(stream<T>());
}

// Launch B: K, V, a ring of Q and dO tiles, the qs tile (bf16), then a
// ring of the query tiles' (max, 1/sum p, r) in f32.
template <typename T, int NK>
__host__ __device__ constexpr size_t cols_smem_bytes() {
  return 2 * tile_bytes<T, NK>(kTile) +
         (2 * ring<T>() + stage_qs<T>()) * tile_bytes<T, NK>(stream<T>()) +
         (size_t)ring<T>() * stream<T>() * 3 * sizeof(float);
}

// Blocks per SM that `smem` bytes a block allow (228 KB an SM, 1 KB of it
// reserved per block), at most four: each kernel caps its registers for
// that many (65536 / (128 x blocks) a thread). At d = 64 that is four
// blocks of f32 (52 KB each; an H100 ran launch A 6% and launch B 3%
// faster with four than with three) and three or four of bf16.
__host__ __device__ constexpr int blocks_for(size_t smem) {
  const size_t n = 233472 / (smem + 1024);
  return n > 4 ? 4 : (n < 1 ? 1 : (int)n);
}

__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// round_T(v): f32 keeps v, bf16 rounds it to the nearest bf16.
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return round_to(v, static_cast<T*>(nullptr));
}

// Two neighbouring outputs, cast to T.
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16(x, y);
}

// 16 bytes of T scaled in f32 by `s`, rounded back to T.
__device__ __forceinline__ void scale16(float* dst, const float* src, float s) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<float4*>(dst) =
      make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s), __fmul_rn(v.z, s), __fmul_rn(v.w, s));
}
__device__ __forceinline__ void scale16(bf16* dst, const bf16* src, float s) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[i] = tc::pack_bf16(__fmul_rn(f.x, s), __fmul_rn(f.y, s));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
}

// Rows row0 .. row0+ROWS-1 of one head's (T, d) slice into `dst` by
// cp.async, 16 bytes a thread; rows past `seq` are zeros. Columns d ..
// 16 NK are never written (zeroed once).
template <typename T, int NK, int ROWS>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long row_stride, int row0,
                                          int seq, int d) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = d / E;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    const bool real = row0 + r < seq;
    tc::cp_async<16>(dst + r * ld<T, NK>() + c * E,
                     src + (real ? row0 + r : 0) * row_stride + c * E, real ? 16 : 0);
  }
}

// Each thread scales the chunks it copied with copy_tile (its own copies
// are visible to it after the wait), or, with src != dst, any chunks.
template <typename T, int NK, int ROWS>
__device__ __forceinline__ void scale_tile(T* dst, const T* src, int d, float s) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = d / E;
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += kThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    scale16(dst + r * ld<T, NK>() + c * E, src + r * ld<T, NK>() + c * E, s);
  }
}

// Zero columns d .. 16 NK of `rows` staged rows (d % 16 == 8).
template <typename T, int NK>
__device__ __forceinline__ void zero_pad_columns(T* base, int rows, int d) {
  constexpr int E = 16 / sizeof(T);
  if (d == 16 * NK) return;
  for (int r = threadIdx.x; r < rows; r += kThreads)
    for (int c = d; c < 16 * NK; c += E)
      *reinterpret_cast<uint4*>(base + r * ld<T, NK>() + c) = make_uint4(0, 0, 0, 0);
}

// ------------------------------------------------------------- products
//
// score: c[j] (16 x 8, j < NT) = A B^T, A the 16 rows at `a`, B the rows
// 8j .. 8j+7 at `b`, both over the 16 NK staged columns. Tiles j >= live
// (bf16: pairs 2p >= live) are left at zero. f32: kScaleB multiplies B's
// values by `bscale` as they are read; kSwap mirrors the order of the
// cross terms, so that A^T's products come in B^T's order.
template <int NK, int NT, bool kScaleB, bool kSwap>
__device__ __forceinline__ void score(float (&c)[NT][4], const float* a, const float* b,
                                      int live, float bscale) {
  static_assert(NT % 2 == 0, "B fragments are loaded for pairs of tiles");
  constexpr int L = ld<float, NK>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2 * NK; ++kk) {
    uint32_t ra[4];
    tc::ldmatrix_x4(ra, a + (lane & 15) * L + 8 * kk + (lane >> 4) * 4);
    const tc::Split af[4] = {
        tc::split_tf32(__uint_as_float(ra[0])), tc::split_tf32(__uint_as_float(ra[1])),
        tc::split_tf32(__uint_as_float(ra[2])), tc::split_tf32(__uint_as_float(ra[3]))};
    // b0, b1 of tiles j and j + 1 for every pair, all loaded before the
    // products (1.07x faster on an H100 than loading each pair as it is
    // used); rows past `live` are in the tile and unused
    uint32_t bf[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; j += 2)
      tc::ldmatrix_x4(bf[j / 2], b + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * L + 8 * kk +
                                     ((lane >> 3) & 1) * 4);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= live) continue;
      float b0 = __uint_as_float(bf[j / 2][2 * (j & 1)]);
      float b1 = __uint_as_float(bf[j / 2][2 * (j & 1) + 1]);
      if (kScaleB) {
        b0 = __fmul_rn(b0, bscale);
        b1 = __fmul_rn(b1, bscale);
      }
      tc::mma_3xtf32<kSwap>(c[j], af, tc::split_tf32(b0), tc::split_tf32(b1));
    }
  }
}

template <int NK, int NT, bool kScaleB, bool kSwap>
__device__ __forceinline__ void score(float (&c)[NT][4], const bf16* a, const bf16* b,
                                      int live, float) {
  static_assert(!kScaleB, "bf16 operands are scaled in shared memory");
  constexpr int L = ld<bf16, NK>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t af[4];
    tc::ldmatrix_x4(af, a + (lane & 15) * L + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      if (2 * p >= live) continue;
      uint32_t bf[4];
      tc::ldmatrix_x4(bf, b + (16 * p + (lane & 7) + ((lane >> 4) << 3)) * L + kk * 16 +
                              ((lane >> 3) & 1) * 8);
      tc::mma_bf16(c[2 * p], af, bf[0], bf[1]);
      tc::mma_bf16(c[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

// accumulate: acc (16 x 16 NK, 2 NK tiles of 8 columns) += P B, P the
// 16 x 8 NP accumulator tiles p (already rounded to T), B the rows 0 ..
// 8 NP - 1 at `b`. P's tiles i >= live (bf16: pairs 2i >= live) are
// skipped.
template <int NK, int NP>
__device__ __forceinline__ void accumulate(float (&acc)[2 * NK][4], const float (&p)[NP][4],
                                           const float* b, int live) {
  constexpr int L = ld<float, NK>();
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (i >= live) continue;
    // contraction index k = q + 4 e is key (query) 8 i + 2 q + e
    const tc::Split af[4] = {tc::split_tf32(p[i][0]), tc::split_tf32(p[i][2]),
                             tc::split_tf32(p[i][1]), tc::split_tf32(p[i][3])};
    const float* br = b + (8 * i + 2 * q) * L + g;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
      tc::mma_3xtf32(acc[n], af, tc::split_tf32(br[8 * n]), tc::split_tf32(br[L + 8 * n]));
  }
}

template <int NK, int NP>
__device__ __forceinline__ void accumulate(float (&acc)[2 * NK][4], const float (&p)[NP][4],
                                           const bf16* b, int live) {
  constexpr int L = ld<bf16, NK>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NP / 2; ++c) {
    if (2 * c >= live) continue;
    const uint32_t af[4] = {
        tc::pack_bf16(p[2 * c][0], p[2 * c][1]), tc::pack_bf16(p[2 * c][2], p[2 * c][3]),
        tc::pack_bf16(p[2 * c + 1][0], p[2 * c + 1][1]),
        tc::pack_bf16(p[2 * c + 1][2], p[2 * c + 1][3]),
    };
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      uint32_t bf[4];
      tc::ldmatrix_x4_trans(bf, b + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L + n * 16 +
                                    (lane >> 4) * 8);
      tc::mma_bf16(acc[2 * n], af, bf[0], bf[1]);
      tc::mma_bf16(acc[2 * n + 1], af, bf[2], bf[3]);
    }
  }
}

// The operands of one call.
template <typename T>
struct Args {
  const T* qkv;        // (B, T, 3h)
  const T* dout;       // (B, T, h)
  const float* sizes;  // (B, T) or null
  T* dqkv;             // (B, T, 3h)
  float* stats;        // (B, nh, T, 3): row max, 1 / sum p, r
  int batch, seq, nh, d;
  float qscale, nat;
};

// ------------------------------------------------------------- launch A
// One block per (batch, head, 64-query tile) -> dq, row statistics.
template <typename T, int NK>
__global__ void __launch_bounds__(kThreads, blocks_for(rows_smem_bytes<T, NK>())) grad_rows_mma(Args<T> a) {
  constexpr int L = ld<T, NK>();
  constexpr int kT = kTile * L;
  constexpr int SR = stream<T>();  // keys per streamed tile
  constexpr int kTS = SR * L;
  constexpr int R = ring<T>();
  constexpr int KC = chunk<T>();  // keys (A) or queries (B) per chunk
  constexpr int NC = KC / 8;      // 8-wide accumulator tiles per chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // qs (scaled, rounded)
  T* sO = sQ + kT;                          // dO
  T* sK = sO + kT;                          // R tiles of SR keys
  T* sV = sK + R * kTS;                     // R tiles of SR keys

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kTile;
  const int seq = a.seq, d = a.d;
  const long long h = (long long)a.nh * d;
  const long long row3 = 3 * h;
  const T* xb = a.qkv + (long long)b * seq * row3 + (long long)head * d;
  const T* ob = a.dout + (long long)b * seq * h + (long long)head * d;
  const float* sz = a.sizes == nullptr ? nullptr : a.sizes + (long long)b * seq;

  zero_pad_columns<T, NK>(sQ, 2 * kTile + 2 * R * SR, d);

  // pass 1 (statistics) then pass 2 (dq) over the key tiles; step `it`
  // is key tile it % ntiles in ring slot it % R, one cp.async group each
  const int ntiles = (seq + SR - 1) / SR;
  const int nsteps = 2 * ntiles;
  auto issue = [&](int it) {
    if (it < nsteps) {
      const int k0 = (it % ntiles) * SR;
      copy_tile<T, NK, SR>(sK + (it % R) * kTS, xb + h, row3, k0, seq, d);
      copy_tile<T, NK, SR>(sV + (it % R) * kTS, xb + 2 * h, row3, k0, seq, d);
    }
    tc::cp_async_commit();  // possibly empty: the wait counts stay uniform
  };
  copy_tile<T, NK, kTile>(sQ, xb, row3, q0, seq, d);  // joins the first tile's group
  copy_tile<T, NK, kTile>(sO, ob, h, q0, seq, d);
  for (int it = 0; it < R - 1; ++it) issue(it);
  if constexpr (R == 1) tc::cp_async_commit();
  tc::cp_async_wait<(R > 1 ? R - 2 : 0)>();
  scale_tile<T, NK, kTile>(sQ, sQ, d, a.qscale);

  const int row0 = warp * 16;
  const bool active = q0 + row0 < seq;
  // rows g and g + 8 of the warp's 16, this lane's columns: running max,
  // sum p and sum dp * p (pass 1); then the row's max, 1 / sum p and r
  float m[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
  float l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};
  float dq[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    if constexpr (R == 1) {
      __syncthreads();  // every warp is done with tile it - 1
      issue(it);
    }
    tc::cp_async_wait<(R > 1 ? R - 2 : 0)>();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if constexpr (R > 1) issue(it + R - 1);
    if (!active) continue;
    const int k0 = (it % ntiles) * SR;
    const T* tk = sK + (it % R) * kTS;
    const T* tv = sV + (it % R) * kTS;
#pragma unroll 1
    for (int c0 = 0; c0 < SR; c0 += KC) {
      const int kc = k0 + c0;  // the chunk's first key
      const int live = min(NC, (seq - kc + 7) >> 3);  // 8-key tiles with a real key
      if (live <= 0) break;
      float s[NC][4], dp[NC][4];
      score<NK, NC, false, false>(s, sQ + row0 * L, tk + c0 * L, live, 0.f);
      score<NK, NC, false, false>(dp, sO + row0 * L, tv + c0 * L, live, 0.f);

      if (it < ntiles) {
        float mt[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kc + 8 * j + 2 * q + (e & 1) < seq) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (mt[i] > m[i]) {  // exp2(-inf) = 0 on the first chunk
            const float alpha = exp2f(__fsub_rn(m[i], mt[i]));
            l[i] = __fmul_rn(l[i], alpha);
            u[i] = __fmul_rn(u[i], alpha);
            m[i] = mt[i];
          }
        }
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kc + 8 * j + 2 * q + (e & 1);
            if (key >= seq) continue;
            float p = exp2f(__fsub_rn(s[j][e], m[e >> 1]));
            if (sz != nullptr) p = __fmul_rn(p, sz[key]);
            l[e >> 1] = __fadd_rn(l[e >> 1], p);
            u[e >> 1] = fmaf(dp[j][e], p, u[e >> 1]);
          }
        continue;
      }

      // pass 2: ds in place of s, then dq += ds k
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kc + 8 * j + 2 * q + (e & 1);
          const int i = e >> 1;
          float ds = 0.f;
          if (key < seq) {
            float p = exp2f(__fsub_rn(s[j][e], m[i]));
            if (sz != nullptr) p = __fmul_rn(p, sz[key]);
            const float pn = __fmul_rn(p, l[i]);
            ds = round_t<T>(__fmul_rn(pn, __fsub_rn(dp[j][e], r[i])));
          }
          s[j][e] = ds;
        }
      accumulate<NK, NC>(dq, s, tk + c0 * L, live);
    }
    if (it == ntiles - 1) {
      // the four lanes of a row: common max, rescaled sums, then r
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float sc = exp2f(__fsub_rn(m[i], mx));  // 0 for a lane with no key
        float lt = __fmul_rn(l[i], sc), ut = __fmul_rn(u[i], sc);
        lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
        lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
        ut = __fadd_rn(ut, __shfl_xor_sync(0xffffffffu, ut, 1));
        ut = __fadd_rn(ut, __shfl_xor_sync(0xffffffffu, ut, 2));
        m[i] = mx;
        l[i] = __frcp_rn(lt);
        r[i] = __fdiv_rn(ut, lt);
      }
    }
  }
  if (!active) return;

  T* dqb = a.dqkv + (long long)b * seq * row3 + (long long)head * d;
  float* st = a.stats + ((long long)b * a.nh + head) * seq * 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + row0 + g + 8 * i;
    if (t >= seq) continue;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
      if (8 * n < d)
        store2(dqb + (long long)t * row3 + 8 * n + 2 * q, __fmul_rn(dq[n][2 * i], a.nat),
               __fmul_rn(dq[n][2 * i + 1], a.nat));
    if (q == 0) {
      st[(long long)t * 3 + 0] = m[i];
      st[(long long)t * 3 + 1] = l[i];
      st[(long long)t * 3 + 2] = r[i];
    }
  }
}

// ------------------------------------------------------------- launch B
// One block per (batch, head, 64-key tile) -> dk, dv.
template <typename T, int NK>
__global__ void __launch_bounds__(kThreads, blocks_for(cols_smem_bytes<T, NK>())) grad_cols_mma(Args<T> a) {
  constexpr int L = ld<T, NK>();
  constexpr int kT = kTile * L;
  constexpr int SR = stream<T>();  // queries per streamed tile
  constexpr int kTS = SR * L;
  constexpr int R = ring<T>();
  constexpr int KC = chunk<T>();  // keys (A) or queries (B) per chunk
  constexpr int NC = KC / 8;      // 8-wide accumulator tiles per chunk
  constexpr bool kStage = stage_qs<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kT;
  T* sQ = sV + kT;        // R tiles of q as stored
  T* sO = sQ + R * kTS;   // R tiles of dO
  T* sQs = sO + R * kTS;  // bf16: round(q * scale) of the current tile
  float* sSt = reinterpret_cast<float*>(sQs + (kStage ? kTS : 0));  // R x SR x 3

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, head = blockIdx.y, k0 = blockIdx.x * kTile;
  const int seq = a.seq, d = a.d;
  const long long h = (long long)a.nh * d;
  const long long row3 = 3 * h;
  const T* xb = a.qkv + (long long)b * seq * row3 + (long long)head * d;
  const T* ob = a.dout + (long long)b * seq * h + (long long)head * d;
  const float* st = a.stats + ((long long)b * a.nh + head) * seq * 3;

  zero_pad_columns<T, NK>(sK, 2 * kTile + (2 * R + kStage) * SR, d);

  const int ntiles = (seq + SR - 1) / SR;
  auto issue = [&](int it) {
    if (it < ntiles) {
      const int q0 = it * SR;
      copy_tile<T, NK, SR>(sQ + (it % R) * kTS, xb, row3, q0, seq, d);
      copy_tile<T, NK, SR>(sO + (it % R) * kTS, ob, h, q0, seq, d);
      float* dst = sSt + (it % R) * SR * 3;
      for (int idx = threadIdx.x; idx < SR * 3; idx += kThreads) {
        const bool real = q0 + idx / 3 < seq;
        tc::cp_async<4>(dst + idx, st + (real ? (long long)q0 * 3 + idx : 0), real ? 4 : 0);
      }
    }
    tc::cp_async_commit();
  };
  copy_tile<T, NK, kTile>(sK, xb + h, row3, k0, seq, d);  // join the first tile's group
  copy_tile<T, NK, kTile>(sV, xb + 2 * h, row3, k0, seq, d);
  for (int it = 0; it < R - 1; ++it) issue(it);
  if constexpr (R == 1) tc::cp_async_commit();

  const int row0 = warp * 16;
  const bool active = k0 + row0 < seq;
  bool real[2];
  float w[2];  // sizes of this lane's keys (rows g, g + 8)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row0 + g + 8 * i;
    real[i] = key < seq;
    w[i] = (a.sizes == nullptr || !real[i]) ? 1.f : a.sizes[(long long)b * seq + key];
  }
  float dk[2 * NK][4], dv[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if constexpr (R == 1) {
      __syncthreads();  // every warp is done with tile it - 1
      issue(it);
    }
    tc::cp_async_wait<(R > 1 ? R - 2 : 0)>();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if constexpr (R > 1) issue(it + R - 1);
    const T* tq = sQ + (it % R) * kTS;
    const T* to = sO + (it % R) * kTS;
    const float* ts = sSt + (it % R) * SR * 3;
    if constexpr (kStage) {
      scale_tile<T, NK, SR>(sQs, tq, d, a.qscale);
      __syncthreads();
    }
    if (!active) continue;
    const int q0 = it * SR;
#pragma unroll 1
    for (int qh = 0; qh < SR; qh += KC) {  // the chunk's first query, in the tile
      const int live = min(NC, (seq - q0 - qh + 7) >> 3);
      if (live <= 0) break;
      float s[NC][4], dp[NC][4];
      if constexpr (kStage)
        score<NK, NC, false, true>(s, sK + row0 * L, sQs + qh * L, live, 0.f);
      else
        score<NK, NC, true, true>(s, sK + row0 * L, tq + qh * L, live, a.qscale);
      score<NK, NC, false, true>(dp, sV + row0 * L, to + qh * L, live, 0.f);
      // s <- round(pn), dp <- ds, both [key][query]
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qh + 8 * j + 2 * q + (e & 1);
          const int i = e >> 1;
          float pr = 0.f, ds = 0.f;
          if (real[i] && q0 + ql < seq) {
            float p = exp2f(__fsub_rn(s[j][e], ts[3 * ql]));
            if (a.sizes != nullptr) p = __fmul_rn(p, w[i]);
            const float pn = __fmul_rn(p, ts[3 * ql + 1]);
            ds = round_t<T>(__fmul_rn(pn, __fsub_rn(dp[j][e], ts[3 * ql + 2])));
            pr = round_t<T>(pn);
          }
          s[j][e] = pr;
          dp[j][e] = ds;
        }
      accumulate<NK, NC>(dv, s, to + qh * L, live);
      accumulate<NK, NC>(dk, dp, tq + qh * L, live);
    }
  }
  if (!active) return;

  T* db = a.dqkv + (long long)b * seq * row3 + (long long)head * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!real[i]) continue;
    const long long t = k0 + row0 + g + 8 * i;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      if (8 * n >= d) continue;
      const int c = 8 * n + 2 * q;
      store2(db + t * row3 + h + c, __fmul_rn(dk[n][2 * i], a.nat),
             __fmul_rn(dk[n][2 * i + 1], a.nat));
      store2(db + t * row3 + 2 * h + c, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
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

template <typename T>
cudaError_t run(const void* qkv, const void* dout, const void* sizes, void* dqkv, void* stats,
                int batch, int seq, int nh, int d, float qscale, float nat, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(qkv), static_cast<const T*>(dout),
                  static_cast<const float*>(sizes), static_cast<T*>(dqkv),
                  static_cast<float*>(stats), batch, seq, nh, d, qscale, nat};
  return dispatch<T>(a, stream);
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// qkv, dqkv: contiguous (B, T, 3h); dout: contiguous (B, T, h); qkv, dout
// and dqkv 16-byte aligned (16-byte copies); sizes: (B, T) float32 or
// null; stats: an f32 workspace of B * nh * T * 3 floats. dtype: 0 =
// float32, 1 = bfloat16. qscale = log2(e)/sqrt(d), nat = 1/sqrt(d).
// Returns cudaGetLastError() after the launches.
extern "C" int vit_attention_qkv_grad(const void* qkv, const void* dout, const void* sizes,
                                      void* dqkv, void* stats, int batch, int seq, int nh,
                                      int d, float qscale, float nat, int dtype, void* stream) {
  if (batch < 1 || seq < 1 || nh < 1 || d < 8 || d > 128 || d % 8 != 0 || batch > 65535 ||
      nh > 65535 || misaligned(qkv) || misaligned(dout) || misaligned(dqkv)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, d, qscale, nat, s);
  if (dtype == 1)
    return (int)run<bf16>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, d, qscale, nat, s);
  return (int)cudaErrorInvalidValue;
}
