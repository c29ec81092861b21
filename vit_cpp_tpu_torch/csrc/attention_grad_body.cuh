// K2's bodies (grad_rows_mma and grad_cols_mma of attention_qkv_grad.cu,
// bf16 and f32), shared with the backward anatomy (attn_grad_anatomy.cu,
// T2): device functions templated on the type, NK and a compile-time
// stage set (Stages below). The default stage set is K2 exactly;
// attn_grad_anatomy.cu instantiates one stage set per variant, each K2's
// bf16 bodies with the variant's stages changed. The design is written at
// attention_qkv_grad.cu's head.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <utility>

#include "tensor_core.cuh"

namespace grad {

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

// K2's stages. A stage set may switch off the softmax (pn = s: no max,
// exp2, sum or division), take its exp2 in bf16 as JAX lowers it, switch
// off the dsoftmax chain (ds = round(dp): no r, no pn (dp - r)), run
// kHeads heads per block with each stage run for every head before the
// next starts (inside each warp), and give launch B a ring of kColsRing
// tiles (0: ring<T>()).
struct Stages {
  static constexpr bool kSoftmax = true;
  static constexpr bool kBf16Exp = false;
  static constexpr bool kDsoft = true;
  static constexpr int kHeads = 1;
  static constexpr int kColsRing = 0;
};

template <typename T, class S>
__host__ __device__ constexpr int cols_ring() {
  return S::kColsRing != 0 ? S::kColsRing : ring<T>();
}

// Launch A, per head: qs, dO, and a ring of K and V tiles.
template <typename T, int NK, class S = Stages>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  return S::kHeads *
         (2 * tile_bytes<T, NK>(kTile) + 2 * ring<T>() * tile_bytes<T, NK>(stream<T>()));
}

// Launch B, per head: K, V, a ring of Q and dO tiles, the qs tile (bf16);
// then each head's ring of the query tiles' (max, 1/sum p, r) in f32.
template <typename T, int NK, class S = Stages>
__host__ __device__ constexpr size_t cols_smem_bytes() {
  return S::kHeads * (2 * tile_bytes<T, NK>(kTile) +
                      (2 * cols_ring<T, S>() + stage_qs<T>()) * tile_bytes<T, NK>(stream<T>()) +
                      (size_t)cols_ring<T, S>() * stream<T>() * 3 * sizeof(float));
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

// f(hh) for each head hh = 0 .. P - 1 of a block, hh a compile-time
// constant (Head<I>), so that the per-head arrays it indexes are registers
// from the start. (A loop over hh keeps them in memory until it is
// unrolled, and with P = 1 that alone changed K2's SASS.)
template <int I>
struct Head {
  __host__ __device__ constexpr operator int() const { return I; }
};

template <class F, int... I>
__device__ __forceinline__ void each_head(F& f, std::integer_sequence<int, I...>) {
  (f(Head<I>()), ...);
}

template <int P, class F>
__device__ __forceinline__ void for_heads(F&& f) {
  each_head(f, std::make_integer_sequence<int, P>());
}

// ------------------------------------------------------------- launch A
// One block per (batch, kHeads heads, 64-query tile) -> dq, row statistics.
template <typename T, int NK, class S = Stages>
__device__ __forceinline__ void grad_rows_body(Args<T> a) {
  constexpr int P = S::kHeads;
  constexpr int L = ld<T, NK>();
  constexpr int kT = kTile * L;
  constexpr int SR = stream<T>();  // keys per streamed tile
  constexpr int kTS = SR * L;
  constexpr int R = ring<T>();
  constexpr int KC = chunk<T>();  // keys (A) or queries (B) per chunk
  constexpr int NC = KC / 8;      // 8-wide accumulator tiles per chunk
  // a statistics pass (pass 1) when the softmax or the dsoftmax chain is on
  constexpr bool kStats = S::kSoftmax || S::kDsoft;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per head: qs (scaled, rounded), dO, R tiles of SR keys of K, of V
  T *sQ[P], *sO[P], *sK[P], *sV[P];
  for_heads<P>([&](auto hh) {
    sQ[hh] = reinterpret_cast<T*>(smem_raw) + hh * (2 * kT + 2 * R * kTS);
    sO[hh] = sQ[hh] + kT;
    sK[hh] = sO[hh] + kT;
    sV[hh] = sK[hh] + R * kTS;
  });

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, head0 = blockIdx.y * P, q0 = blockIdx.x * kTile;
  const int seq = a.seq, d = a.d;
  const long long h = (long long)a.nh * d;
  const long long row3 = 3 * h;
  const T* xb[P];
  const T* ob[P];
  for_heads<P>([&](auto hh) {
    xb[hh] = a.qkv + (long long)b * seq * row3 + (long long)(head0 + hh) * d;
    ob[hh] = a.dout + (long long)b * seq * h + (long long)(head0 + hh) * d;
  });
  const float* sz = a.sizes == nullptr ? nullptr : a.sizes + (long long)b * seq;

  zero_pad_columns<T, NK>(sQ[0], P * (2 * kTile + 2 * R * SR), d);

  // pass 1 (statistics) then pass 2 (dq) over the key tiles; step `it`
  // is key tile it % ntiles in ring slot it % R, one cp.async group each
  const int ntiles = (seq + SR - 1) / SR;
  const int nsteps = (kStats ? 2 : 1) * ntiles;
  auto issue = [&](int it) {
    if (it < nsteps) {
      const int k0 = (it % ntiles) * SR;
      for_heads<P>([&](auto hh) {
        copy_tile<T, NK, SR>(sK[hh] + (it % R) * kTS, xb[hh] + h, row3, k0, seq, d);
        copy_tile<T, NK, SR>(sV[hh] + (it % R) * kTS, xb[hh] + 2 * h, row3, k0, seq, d);
      });
    }
    tc::cp_async_commit();  // possibly empty: the wait counts stay uniform
  };
  for_heads<P>([&](auto hh) {
    copy_tile<T, NK, kTile>(sQ[hh], xb[hh], row3, q0, seq, d);  // joins the first tile's group
    copy_tile<T, NK, kTile>(sO[hh], ob[hh], h, q0, seq, d);
  });
  for (int it = 0; it < R - 1; ++it) issue(it);
  if constexpr (R == 1) tc::cp_async_commit();
  tc::cp_async_wait<(R > 1 ? R - 2 : 0)>();
  for_heads<P>([&](auto hh) {
    scale_tile<T, NK, kTile>(sQ[hh], sQ[hh], d, a.qscale);
  });

  const int row0 = warp * 16;
  const bool active = q0 + row0 < seq;
  // rows g and g + 8 of the warp's 16, this lane's columns: running max,
  // sum p and sum dp * p (pass 1); then the row's max, 1 / sum p and r
  float m[P][2], l[P][2], u[P][2], r[P][2];
  float dq[P][2 * NK][4];
  for_heads<P>([&](auto hh) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[hh][i] = -__int_as_float(0x7f800000);
      l[hh][i] = u[hh][i] = r[hh][i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
      dq[hh][n][0] = dq[hh][n][1] = dq[hh][n][2] = dq[hh][n][3] = 0.f;
  });

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
    const bool stats = kStats && it < ntiles;
    const T* tk[P];
    const T* tv[P];
    for_heads<P>([&](auto hh) {
      tk[hh] = sK[hh] + (it % R) * kTS;
      tv[hh] = sV[hh] + (it % R) * kTS;
    });
#pragma unroll 1
    for (int c0 = 0; c0 < SR; c0 += KC) {
      const int kc = k0 + c0;  // the chunk's first key
      const int live = min(NC, (seq - kc + 7) >> 3);  // 8-key tiles with a real key
      if (live <= 0) break;
      // pass 1 needs S (the softmax, or u = sum dp * s) and dP for u; pass
      // 2 S for pn and dP
      float s[P][NC][4], dp[P][NC][4];
      if (stats || S::kDsoft) {
        for_heads<P>([&](auto hh) {
          score<NK, NC, false, false>(s[hh], sQ[hh] + row0 * L, tk[hh] + c0 * L, live, 0.f);
        });
      }
      if (!stats || S::kDsoft) {
        for_heads<P>([&](auto hh) {
          score<NK, NC, false, false>(dp[hh], sO[hh] + row0 * L, tv[hh] + c0 * L, live, 0.f);
        });
      }

      if (stats) {
        for_heads<P>([&](auto hh) {
          if constexpr (S::kSoftmax) {
            float mt[2] = {m[hh][0], m[hh][1]};
#pragma unroll
            for (int j = 0; j < NC; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (kc + 8 * j + 2 * q + (e & 1) < seq) mt[e >> 1] = fmaxf(mt[e >> 1], s[hh][j][e]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (mt[i] > m[hh][i]) {  // exp2(-inf) = 0 on the first chunk
                const float alpha = exp2f(__fsub_rn(m[hh][i], mt[i]));
                l[hh][i] = __fmul_rn(l[hh][i], alpha);
                if constexpr (S::kDsoft) u[hh][i] = __fmul_rn(u[hh][i], alpha);
                m[hh][i] = mt[i];
              }
            }
          }
#pragma unroll
          for (int j = 0; j < NC; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kc + 8 * j + 2 * q + (e & 1);
              if (key >= seq) continue;
              if constexpr (S::kSoftmax) {
                float p = S::kBf16Exp ? tc::exp2_bf16(__fsub_rn(s[hh][j][e], m[hh][e >> 1]))
                                      : exp2f(__fsub_rn(s[hh][j][e], m[hh][e >> 1]));
                if (sz != nullptr) p = __fmul_rn(p, sz[key]);
                l[hh][e >> 1] = __fadd_rn(l[hh][e >> 1], p);
                if constexpr (S::kDsoft) u[hh][e >> 1] = fmaf(dp[hh][j][e], p, u[hh][e >> 1]);
              } else {
                u[hh][e >> 1] = fmaf(dp[hh][j][e], s[hh][j][e], u[hh][e >> 1]);
              }
            }
        });
        continue;
      }

      // pass 2: ds in place of s, then dq += ds k
      for_heads<P>([&](auto hh) {
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kc + 8 * j + 2 * q + (e & 1);
            const int i = e >> 1;
            float ds = 0.f;
            if (key < seq) {
              if constexpr (S::kDsoft) {
                float pn = s[hh][j][e];
                if constexpr (S::kSoftmax) {
                  float p = S::kBf16Exp ? tc::exp2_bf16(__fsub_rn(s[hh][j][e], m[hh][i]))
                                        : exp2f(__fsub_rn(s[hh][j][e], m[hh][i]));
                  if (sz != nullptr) p = __fmul_rn(p, sz[key]);
                  pn = __fmul_rn(p, l[hh][i]);
                }
                ds = round_t<T>(__fmul_rn(pn, __fsub_rn(dp[hh][j][e], r[hh][i])));
              } else {
                ds = round_t<T>(dp[hh][j][e]);
              }
            }
            s[hh][j][e] = ds;
          }
      });
      for_heads<P>([&](auto hh) {
        accumulate<NK, NC>(dq[hh], s[hh], tk[hh] + c0 * L, live);
      });
    }
    if (kStats && it == ntiles - 1) {
      // the four lanes of a row: common max, rescaled sums, then r
      for_heads<P>([&](auto hh) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (S::kSoftmax) {
            float mx = fmaxf(m[hh][i], __shfl_xor_sync(0xffffffffu, m[hh][i], 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float sc = exp2f(__fsub_rn(m[hh][i], mx));  // 0 for a lane with no key
            float lt = __fmul_rn(l[hh][i], sc), ut = __fmul_rn(u[hh][i], sc);
            lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
            lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
            if constexpr (S::kDsoft) {
              ut = __fadd_rn(ut, __shfl_xor_sync(0xffffffffu, ut, 1));
              ut = __fadd_rn(ut, __shfl_xor_sync(0xffffffffu, ut, 2));
            }
            m[hh][i] = mx;
            l[hh][i] = __frcp_rn(lt);
            r[hh][i] = S::kDsoft ? __fdiv_rn(ut, lt) : 0.f;
          } else {  // pn = s: r = sum dp * s
            float ut = __fadd_rn(u[hh][i], __shfl_xor_sync(0xffffffffu, u[hh][i], 1));
            ut = __fadd_rn(ut, __shfl_xor_sync(0xffffffffu, ut, 2));
            m[hh][i] = 0.f;
            l[hh][i] = 1.f;
            r[hh][i] = ut;
          }
        }
      });
    }
  }
  if (!active) return;

  for_heads<P>([&](auto hh) {
    T* dqb = a.dqkv + (long long)b * seq * row3 + (long long)(head0 + hh) * d;
    float* st = a.stats + ((long long)b * a.nh + head0 + hh) * seq * 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = q0 + row0 + g + 8 * i;
      if (t >= seq) continue;
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
        if (8 * n < d)
          store2(dqb + (long long)t * row3 + 8 * n + 2 * q, __fmul_rn(dq[hh][n][2 * i], a.nat),
                 __fmul_rn(dq[hh][n][2 * i + 1], a.nat));
      if (q == 0) {
        st[(long long)t * 3 + 0] = m[hh][i];
        st[(long long)t * 3 + 1] = l[hh][i];
        st[(long long)t * 3 + 2] = r[hh][i];
      }
    }
  });
}

// ------------------------------------------------------------- launch B
// One block per (batch, kHeads heads, 64-key tile) -> dk, dv.
template <typename T, int NK, class S = Stages>
__device__ __forceinline__ void grad_cols_body(Args<T> a) {
  constexpr int P = S::kHeads;
  constexpr int L = ld<T, NK>();
  constexpr int kT = kTile * L;
  constexpr int SR = stream<T>();  // queries per streamed tile
  constexpr int kTS = SR * L;
  constexpr int R = cols_ring<T, S>();
  constexpr int KC = chunk<T>();  // keys (A) or queries (B) per chunk
  constexpr int NC = KC / 8;      // 8-wide accumulator tiles per chunk
  constexpr bool kStage = stage_qs<T>();
  constexpr int kHead = 2 * kT + (2 * R + kStage) * kTS;  // one head's tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per head: K, V, R tiles of q as stored, R tiles of dO, and (bf16)
  // round(q * scale) of the current tile; after every head's tiles, each
  // head's R x SR x 3 statistics
  T *sK[P], *sV[P], *sQ[P], *sO[P], *sQs[P];
  float* sSt[P];
  for_heads<P>([&](auto hh) {
    sK[hh] = reinterpret_cast<T*>(smem_raw) + hh * kHead;
    sV[hh] = sK[hh] + kT;
    sQ[hh] = sV[hh] + kT;
    sO[hh] = sQ[hh] + R * kTS;
    sQs[hh] = sO[hh] + R * kTS;
    sSt[hh] = reinterpret_cast<float*>(reinterpret_cast<T*>(smem_raw) + P * kHead) +
              hh * R * SR * 3;
  });

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, head0 = blockIdx.y * P, k0 = blockIdx.x * kTile;
  const int seq = a.seq, d = a.d;
  const long long h = (long long)a.nh * d;
  const long long row3 = 3 * h;
  const T* xb[P];
  const T* ob[P];
  const float* st[P];
  for_heads<P>([&](auto hh) {
    xb[hh] = a.qkv + (long long)b * seq * row3 + (long long)(head0 + hh) * d;
    ob[hh] = a.dout + (long long)b * seq * h + (long long)(head0 + hh) * d;
    st[hh] = a.stats + ((long long)b * a.nh + head0 + hh) * seq * 3;
  });

  zero_pad_columns<T, NK>(sK[0], P * (2 * kTile + (2 * R + kStage) * SR), d);

  const int ntiles = (seq + SR - 1) / SR;
  auto issue = [&](int it) {
    if (it < ntiles) {
      const int q0 = it * SR;
      for_heads<P>([&](auto hh) {
        copy_tile<T, NK, SR>(sQ[hh] + (it % R) * kTS, xb[hh], row3, q0, seq, d);
        copy_tile<T, NK, SR>(sO[hh] + (it % R) * kTS, ob[hh], h, q0, seq, d);
        float* dst = sSt[hh] + (it % R) * SR * 3;
        for (int idx = threadIdx.x; idx < SR * 3; idx += kThreads) {
          const bool real = q0 + idx / 3 < seq;
          tc::cp_async<4>(dst + idx, st[hh] + (real ? (long long)q0 * 3 + idx : 0), real ? 4 : 0);
        }
      });
    }
    tc::cp_async_commit();
  };
  for_heads<P>([&](auto hh) {
    copy_tile<T, NK, kTile>(sK[hh], xb[hh] + h, row3, k0, seq, d);  // join the first tile's group
    copy_tile<T, NK, kTile>(sV[hh], xb[hh] + 2 * h, row3, k0, seq, d);
  });
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
  float dk[P][2 * NK][4], dv[P][2 * NK][4];
  for_heads<P>([&](auto hh) {
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[hh][n][e] = dv[hh][n][e] = 0.f;
  });

  for (int it = 0; it < ntiles; ++it) {
    if constexpr (R == 1) {
      __syncthreads();  // every warp is done with tile it - 1
      issue(it);
    }
    tc::cp_async_wait<(R > 1 ? R - 2 : 0)>();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if constexpr (R > 1) issue(it + R - 1);
    const T* tq[P];
    const T* to[P];
    const float* ts[P];
    for_heads<P>([&](auto hh) {
      tq[hh] = sQ[hh] + (it % R) * kTS;
      to[hh] = sO[hh] + (it % R) * kTS;
      ts[hh] = sSt[hh] + (it % R) * SR * 3;
    });
    if constexpr (kStage) {
      for_heads<P>([&](auto hh) {
        scale_tile<T, NK, SR>(sQs[hh], tq[hh], d, a.qscale);
      });
      __syncthreads();
    }
    if (!active) continue;
    const int q0 = it * SR;
#pragma unroll 1
    for (int qh = 0; qh < SR; qh += KC) {  // the chunk's first query, in the tile
      const int live = min(NC, (seq - q0 - qh + 7) >> 3);
      if (live <= 0) break;
      float s[P][NC][4], dp[P][NC][4];
      for_heads<P>([&](auto hh) {
        if constexpr (kStage)
          score<NK, NC, false, true>(s[hh], sK[hh] + row0 * L, sQs[hh] + qh * L, live, 0.f);
        else
          score<NK, NC, true, true>(s[hh], sK[hh] + row0 * L, tq[hh] + qh * L, live, a.qscale);
      });
      for_heads<P>([&](auto hh) {
        score<NK, NC, false, true>(dp[hh], sV[hh] + row0 * L, to[hh] + qh * L, live, 0.f);
      });
      // s <- round(pn), dp <- ds, both [key][query]
      for_heads<P>([&](auto hh) {
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = qh + 8 * j + 2 * q + (e & 1);
            const int i = e >> 1;
            float pr = 0.f, ds = 0.f;
            if (real[i] && q0 + ql < seq) {
              float pn = s[hh][j][e];
              if constexpr (S::kSoftmax) {
                float p = S::kBf16Exp ? tc::exp2_bf16(__fsub_rn(s[hh][j][e], ts[hh][3 * ql]))
                                      : exp2f(__fsub_rn(s[hh][j][e], ts[hh][3 * ql]));
                if (a.sizes != nullptr) p = __fmul_rn(p, w[i]);
                pn = __fmul_rn(p, ts[hh][3 * ql + 1]);
              }
              ds = S::kDsoft
                       ? round_t<T>(__fmul_rn(pn, __fsub_rn(dp[hh][j][e], ts[hh][3 * ql + 2])))
                       : round_t<T>(dp[hh][j][e]);
              pr = round_t<T>(pn);
            }
            s[hh][j][e] = pr;
            dp[hh][j][e] = ds;
          }
      });
      for_heads<P>([&](auto hh) {
        accumulate<NK, NC>(dv[hh], s[hh], to[hh] + qh * L, live);
      });
      for_heads<P>([&](auto hh) {
        accumulate<NK, NC>(dk[hh], dp[hh], tq[hh] + qh * L, live);
      });
    }
  }
  if (!active) return;

  for_heads<P>([&](auto hh) {
    T* db = a.dqkv + (long long)b * seq * row3 + (long long)(head0 + hh) * d;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!real[i]) continue;
      const long long t = k0 + row0 + g + 8 * i;
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n) {
        if (8 * n >= d) continue;
        const int c = 8 * n + 2 * q;
        store2(db + t * row3 + h + c, __fmul_rn(dk[hh][n][2 * i], a.nat),
               __fmul_rn(dk[hh][n][2 * i + 1], a.nat));
        store2(db + t * row3 + 2 * h + c, dv[hh][n][2 * i], dv[hh][n][2 * i + 1]);
      }
    }
  });
}

}  // namespace grad
