// Multi-head attention for Hopper (sm_90a), CUDA C++: two bodies, both on
// the tensor cores (bf16 products, and f32 as 3xTF32), two C entry points,
// each with its own launch counter in Python.
//
// vit_attention_qkv replaces the TPU kernels behind vit_cpp_tpu/ops/
// flash_attention.py::attention_qkv: _qkv_pair_kernel (d=64), _qkv_kernel
// + _sdpa (any d, odd head tails) and _qkv_lane_kernel (large T x h, via
// _attention_qkv_lane). It covers all of their shapes: T >= 1, d a
// multiple of 8 up to 128, bf16 or f32, fast (clamped) and safe
// (max-subtracted) softmax, the `kv` key mask and the ToMe `sizes` key
// weights. Its input qkv is the (B, T, 3h) output of the fused
// projection, [q | k | v] on the feature axis with heads contiguous inside
// each third (timm order); its output is (B, T, h).
//
// vit_flash_attention replaces flash_attention.py::flash_attention
// (_bhtd_kernel -> _sdpa in safe mode): q, k, v and the output are
// separate (B, H, T, D) tensors.
//
// Both bodies read Q, K and V through a (batch, head, token) stride set
// and write the output through another, so both layouts are read in
// place: no head split or merge transposes exist in device memory. One
// thread block owns one (batch, head, query tile) of 128 rows; keys are
// tiled 64 at a time through shared memory (K and V of one head at T=785,
// d=88 would not fit whole), and the (T, T) score matrix never leaves the
// SM.
//
// What bounds it on this card. At ViT-B/16 (T=197, h=768) attention is
// about 4 T^2 h = 0.12 GFLOP per image per layer against ~1.2 MB of qkv
// read and 0.3 MB written, i.e. ~80 FLOP per byte: below the H100's bf16
// ridge (~295 FLOP/B), so an ideal kernel is bound by HBM. A kernel that
// runs its products outside the tensor cores is not: it is bound by how
// fast the SM feeds operands to its multiply-adds. Both bodies below are
// still not bound by HBM but by issue on the SM: the mma.sync products
// (three per f32 product), then the exp2 of every score, while their K/V
// copies hide behind the products.
//
// bf16 body (attention_mma: serving, K1 and K3), in the FlashAttention-2
// manner. 8 warps, each owning 16 query rows (at ViT-B/16 B=64, 1536 blocks
// of 128 query rows keep every SM busy, and an H100 ran them faster than
// 64-row blocks of 4 warps). Q is scaled in f32, rounded to bf16 once and
// held in registers as mma.sync.m16n8k16 A fragments for the whole key
// loop. K and V tiles stay bf16 in shared memory; cp.async copies them 16
// bytes at a time into a ring of three, so the copies of the next two tiles
// overlap this tile's products. Rows are padded by 16 bytes so that the
// eight row addresses of every ldmatrix fall in distinct banks. S = Q K^T
// and O += P V run on the tensor cores with f32 accumulators (K fragments
// by ldmatrix, V fragments by ldmatrix.trans); the softmax runs on the S
// accumulators in registers, and P, rounded to bf16, is the A operand of
// P V straight from them (the m16n8 C layout is the m16n8k16 A layout): no
// round trip through shared memory. Key chunks of 16 past the last real
// key and warps whose 16 rows are all padding skip their products, which
// saves ~20% of the work at T=197. d that is not a multiple of 16 is
// padded with zero columns in shared memory, which add exactly 0. The
// output is staged through shared memory and written in 16-byte stores.
//
// f32 body (attention_tf32: training's forward, where the loss must agree
// with the CPU to 1e-5 relative, and f32 serving), the bf16 body's
// structure in 3xTF32 (tensor_core.cuh): each f32 operand is split into
// TF32 hi and lo parts and each product is hi*hi + hi*lo + lo*hi on
// mma.sync.m16n8k8 with f32 accumulators, which drops ~2^-22 of |x y|, the
// size of f32's own rounding (one TF32 product would drop ~2^-11). 8 warps
// of 16 query rows, one pass over the keys (item 2 below); Q, scaled in
// f32, is loaded once into registers as A fragments; K and V stay f32 in
// shared memory (rows of 16 NK + 4 floats, a stride of 4 mod 8 words
// that puts a warp's fragment loads, ldmatrix for K and scalar for V, in
// distinct banks), copied by cp.async into a ring of three (96 KB of f32
// tiles at d=64). P comes from the S accumulators in registers: the m16n8
// C tile holds columns (2q, 2q+1) where the m16n8k8 A fragment holds (q,
// q+4), so P V numbers its contraction index k = q + 4 e as key 2 q + e
// and reads V's rows 2 q and 2 q + 1 for B's rows q and q + 4. The output
// is written from the accumulators in 8-byte stores.
//
// Numerics of both, as in the TPU kernel (flash_attention.py _sdpa and
// _qkv_pair_kernel):
//  1. Q is scaled by log2(e)/sqrt(d) in f32 and rounded to the input type
//     before Q K^T; scores accumulate in f32.
//  2. fast: s = min(s, 120) with no row max. safe: s - max over the real
//     keys. The bf16 body takes the exact row max in a first pass over the
//     keys (the scores are recomputed in the second pass), so its weights
//     are exp2(s - max) as in the TPU kernel before they are rounded to
//     bf16. The f32 body, whose p is not rounded, keeps an online max in
//     one pass instead: o and l are rescaled by exp2(m_old - m_new) when
//     the max grows, which the division o / l cancels up to f32 rounding
//     (an H100 measured the f32 cases within 6e-6 of the plain version,
//     against 2e-5, and the safe body 1.41x faster than with the exact
//     max's first pass).
//  3. p = exp2(s), times the key mask (keys >= kv are skipped: weight 0),
//     times sizes[key] when given.
//  4. l = sum p in f32 from the f32 p; the PV product uses p rounded to
//     the input type with f32 accumulation; o / l after PV, then cast.
// Products of bf16 values are exact in f32, so the bf16 body differs from
// the plain version only in the order of its f32 sums; the f32 body also
// by 3xTF32's ~2^-22 per product. Query rows >= kv
// (token padding) are written as zeros, as the composed path
// (_attention_qkv_xla) does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBK = 64;  // keys per shared-memory tile

// Element strides of a (batch, head, token, feature) view; feature stride 1.
struct Strides {
  long long batch, head, token;
};

constexpr int kWarps = 8;               // 16 query rows each
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kMmaRows = 16 * kWarps;   // query rows per block
constexpr int kRing = 3;                // K and V tiles in flight

// ------------------------------------------------------------ f32 body

// Shared memory of the f32 body: a ring of K and V tiles of 64 rows; rows
// of 16 NK + 4 floats (a stride of 4 mod 8 words: the fragment loads of a
// warp fall in distinct banks).
__host__ __device__ constexpr size_t tf32_smem_bytes(int nk) {
  return (size_t)2 * kRing * kBK * (16 * nk + 4) * sizeof(float);
}

// NK = ceil(d / 16): 16-wide slices of the (zero-padded) head dimension,
// two 8-wide m16n8k8 steps each.
// Two blocks of 8 warps share an SM up to d = 64 (104 KB of tiles each):
// at most 128 registers a thread, with S's contraction loop unrolled by 2
// only (an H100 ran it 1.44x faster so than as one block of 181
// registers with the loop unrolled).
template <int NK>
__global__ void __launch_bounds__(kMmaThreads, NK <= 4 ? 2 : 1)
    attention_tf32(const float* __restrict__ qg, const float* __restrict__ kg,
                   const float* __restrict__ vg, Strides in,
                   const float* __restrict__ sizes, float* __restrict__ out,
                   Strides os, int seq, int d, int kv, float qscale, int fast) {
  constexpr int kLd = 16 * NK + 4;
  constexpr int kTile = kBK * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // kRing tiles
  float* sV = sK + kRing * kTile;                  // kRing tiles

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row and column
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kMmaRows;
  const long long in_off = b * in.batch + head * in.head;
  const float* qb = qg + in_off;
  const float* kb = kg + in_off;
  const float* vb = vg + in_off;
  float* ob = out + b * os.batch + head * os.head;
  const int chunks = d >> 2;  // 16-byte chunks of a row

  if (q0 >= kv) {  // every row of this tile is token padding
    for (int idx = tid; idx < kMmaRows * chunks; idx += kMmaThreads) {
      const int r = idx / chunks, c = idx - r * chunks;
      if (q0 + r < seq)
        *reinterpret_cast<float4*>(ob + (q0 + r) * os.token + 4 * c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  // the padding columns d .. 16 NK of every row: zero once, never copied over
  if (d < 16 * NK) {
    for (int r = tid; r < 2 * kRing * kBK; r += kMmaThreads)
      for (int c = d; c < 16 * NK; c += 4)
        *reinterpret_cast<float4*>(sK + r * kLd + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // one pass over the key tiles (safe mode keeps an online row max); tile
  // `it` in ring slot it % kRing, each tile's copies one cp.async group
  const int ntiles = (kv + kBK - 1) / kBK;
  auto issue = [&](int it) {
    if (it < ntiles) {
      const int k0 = it * kBK;
      float* dk = sK + (it % kRing) * kTile;
      float* dv = sV + (it % kRing) * kTile;
      // rows up to the next multiple of 8 past kv; keys >= kv are zeros
      const int rows = min(kBK, (kv - k0 + 7) & ~7);
      for (int idx = tid; idx < rows * chunks; idx += kMmaThreads) {
        const int r = idx / chunks, c = idx - r * chunks;
        const bool real = k0 + r < kv;
        const long long off = (real ? k0 + r : 0) * in.token + 4 * c;
        tc::cp_async<16>(dk + r * kLd + 4 * c, kb + off, real ? 16 : 0);
        tc::cp_async<16>(dv + r * kLd + 4 * c, vb + off, real ? 16 : 0);
      }
    }
    tc::cp_async_commit();  // possibly empty: the wait counts stay uniform
  };
  for (int it = 0; it < kRing - 1; ++it) issue(it);

  const int row0 = warp * 16;          // this warp's query rows
  const bool active = q0 + row0 < kv;  // ... hold at least one real row
  // Q scaled in f32 (q * scale is already of the input type), as the A
  // fragments of S = Q K^T for the whole key loop: rows g and g + 8,
  // columns 8 kk + q and + 4; zeros past kv and past d
  float qf[2 * NK][4];
#pragma unroll
  for (int kk = 0; kk < 2 * NK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + row0 + g + 8 * (i & 1), c = 8 * kk + q + 4 * (i >> 1);
      qf[kk][i] = (t < kv && c < d) ? __fmul_rn(qb[t * in.token + c], qscale) : 0.f;
    }

  float o[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows g and g + 8 of the warp's 16: running row max (safe) and this
  // lane's part of the row sum
  float m[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    tc::cp_async_wait<kRing - 2>();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    issue(it + kRing - 1);
    if (!active) continue;
    const int k0 = it * kBK;
    const int live = min(8, (kv - k0 + 7) >> 3);  // 8-key tiles with a real key
    const float* tk = sK + (it % kRing) * kTile;
    const float* tv = sV + (it % kRing) * kTile;

    // S = Q K^T in 3xTF32: n8 tile j holds keys k0 + 8 j .. + 7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < 2 * NK; ++kk) {
      const tc::Split af[4] = {tc::split_tf32(qf[kk][0]), tc::split_tf32(qf[kk][1]),
                               tc::split_tf32(qf[kk][2]), tc::split_tf32(qf[kk][3])};
      // b0, b1 of key tiles j and j + 1 (tensor_core.cuh) for every pair,
      // all loaded before the products (1.05x faster on an H100 than
      // loading each pair as it is used); tiles past `live` are unused
      uint32_t bf[4][4];
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        tc::ldmatrix_x4(bf[j / 2], tk + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                                       8 * kk + ((lane >> 3) & 1) * 4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < live)
          tc::mma_3xtf32(s[j], af, tc::split_tf32(__uint_as_float(bf[j / 2][2 * (j & 1)])),
                         tc::split_tf32(__uint_as_float(bf[j / 2][2 * (j & 1) + 1])));
    }

    if (!fast) {
      // the running max over the real keys, common to the row's four
      // lanes; o and l are rescaled to a new max (exp2(-inf) = 0 on the
      // first tile, where both are still 0)
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j < live && k0 + 8 * j + 2 * q + (e & 1) < kv) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
        if (mt[i] > m[i]) {
          const float alpha = exp2f(__fsub_rn(m[i], mt[i]));
          l[i] = __fmul_rn(l[i], alpha);
#pragma unroll
          for (int n = 0; n < 2 * NK; ++n) {
            o[n][2 * i] = __fmul_rn(o[n][2 * i], alpha);
            o[n][2 * i + 1] = __fmul_rn(o[n][2 * i + 1], alpha);
          }
          m[i] = mt[i];
        }
      }
    }

    // p in place of s (f32: no rounding for P V)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= live) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * q + (e & 1);
        float p = 0.f;
        if (key < kv) {
          p = exp2f(fast ? fminf(s[j][e], 120.f) : __fsub_rn(s[j][e], m[e >> 1]));
          if (sizes != nullptr) p = __fmul_rn(p, sizes[(size_t)b * seq + key]);
        }
        l[e >> 1] = __fadd_rn(l[e >> 1], p);
        s[j][e] = p;
      }
    }

    // O += P V in 3xTF32, P's A fragments straight from the S tiles: the
    // contraction index k = q + 4 e is key 8 i + 2 q + e (tensor_core.cuh)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i >= live) continue;
      const tc::Split af[4] = {tc::split_tf32(s[i][0]), tc::split_tf32(s[i][2]),
                               tc::split_tf32(s[i][1]), tc::split_tf32(s[i][3])};
      const float* br = tv + (8 * i + 2 * q) * kLd + g;
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
        tc::mma_3xtf32(o[n], af, tc::split_tf32(br[8 * n]), tc::split_tf32(br[kLd + 8 * n]));
    }
  }
  if (!active) {
    // all 16 rows are token padding: zeros
    for (int idx = lane; idx < 16 * chunks; idx += 32) {
      const int r = idx / chunks, c = idx - r * chunks;
      if (q0 + row0 + r < seq)
        *reinterpret_cast<float4*>(ob + (q0 + row0 + r) * os.token + 4 * c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + row0 + g + 8 * i;
    if (t >= seq) continue;
    const bool real = t < kv;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
      if (8 * n < d)
        *reinterpret_cast<float2*>(ob + t * os.token + 8 * n + 2 * q) =
            real ? make_float2(__fdiv_rn(o[n][2 * i], l[i]), __fdiv_rn(o[n][2 * i + 1], l[i]))
                 : make_float2(0.f, 0.f);
  }
}

// ----------------------------------------------------------- bf16 body

using bf16 = __nv_bfloat16;

// Shared memory of the bf16 body: the Q tile, then a ring of K and V
// tiles of 64 rows; rows of 16 NK + 8 bf16.
__host__ __device__ constexpr size_t mma_smem_bytes(int nk) {
  return (size_t)(kMmaRows + 2 * kRing * kBK) * (16 * nk + 8) * sizeof(bf16);
}

// NK = ceil(d / 16): 16-wide slices of the (zero-padded) head dimension.
template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
    attention_mma(const bf16* __restrict__ qg, const bf16* __restrict__ kg,
                  const bf16* __restrict__ vg, Strides in,
                  const float* __restrict__ sizes, bf16* __restrict__ out,
                  Strides os, int seq, int d, int kv, float qscale, int fast) {
  constexpr int kLd = 16 * NK + 8;  // row stride: +16 B puts ldmatrix rows in distinct banks
  constexpr int kTile = kBK * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kMmaRows * kLd;  // kRing tiles
  bf16* sV = sK + kRing * kTile;   // kRing tiles

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;  // fragment row and column pair
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kMmaRows;
  const long long in_off = b * in.batch + head * in.head;
  const bf16* qb = qg + in_off;
  const bf16* kb = kg + in_off;
  const bf16* vb = vg + in_off;
  bf16* ob = out + b * os.batch + head * os.head;
  const int chunks = d >> 3;  // 16-byte chunks of a row

  if (q0 >= kv) {  // every row of this tile is token padding
    for (int idx = tid; idx < kMmaRows * chunks; idx += kMmaThreads) {
      const int r = idx / chunks, c = idx - r * chunks;
      if (q0 + r < seq)
        *reinterpret_cast<uint4*>(ob + (q0 + r) * os.token + 8 * c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // the padding columns d .. 16 NK of every row: zero once, never copied over
  if (d < 16 * NK) {
    for (int r = tid; r < kMmaRows + 2 * kRing * kBK; r += kMmaThreads)
      *reinterpret_cast<uint4*>(sQ + r * kLd + d) = make_uint4(0, 0, 0, 0);
  }

  // pass 0 (safe mode only) reads K for the exact row max; pass 1 reads K
  // and V. Step `it` of the flat loop is tile it % ntiles of its pass, in
  // ring slot it % kRing; each step's copies are one cp.async group.
  const int ntiles = (kv + kBK - 1) / kBK;
  const int first = fast ? 1 : 0;
  const int nsteps = (2 - first) * ntiles;
  auto issue = [&](int it) {
    if (it < nsteps) {
      const int pass = first + (it >= ntiles);
      const int k0 = (it - (pass - first) * ntiles) * kBK;
      bf16* dk = sK + (it % kRing) * kTile;
      bf16* dv = sV + (it % kRing) * kTile;
      // rows up to the next multiple of 16 past kv; keys >= kv are zeros
      const int rows = min(kBK, (kv - k0 + 15) & ~15);
      for (int idx = tid; idx < rows * chunks; idx += kMmaThreads) {
        const int r = idx / chunks, c = idx - r * chunks;
        const bool real = k0 + r < kv;
        const long long off = (real ? k0 + r : 0) * in.token + 8 * c;
        tc::cp_async<16>(dk + r * kLd + 8 * c, kb + off, real ? 16 : 0);
        if (pass == 1) tc::cp_async<16>(dv + r * kLd + 8 * c, vb + off, real ? 16 : 0);
      }
    }
    tc::cp_async_commit();  // possibly empty: the wait counts stay uniform
  };

  // Q rows (zeros past kv) join the first tile's group; then each thread
  // scales its own chunks in f32 and rounds them to bf16 once
  for (int idx = tid; idx < kMmaRows * chunks; idx += kMmaThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    const bool real = q0 + r < kv;
    tc::cp_async<16>(sQ + r * kLd + 8 * c, qb + (real ? q0 + r : 0) * in.token + 8 * c,
                     real ? 16 : 0);
  }
  for (int it = 0; it < kRing - 1; ++it) issue(it);
  tc::cp_async_wait<kRing - 2>();
  for (int idx = tid; idx < kMmaRows * chunks; idx += kMmaThreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    uint32_t* w = reinterpret_cast<uint32_t*>(sQ + r * kLd + 8 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      w[i] = tc::pack_bf16(f.x * qscale, f.y * qscale);
    }
  }
  __syncthreads();  // Q in shared memory

  const int row0 = warp * 16;                // this warp's query rows
  const bool active = q0 + row0 < kv;        // ... hold at least one real row
  uint32_t qf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    tc::ldmatrix_x4(qf[kk], sQ + (row0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);

  float o[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows g and g + 8 of the warp's 16: row max (safe) and row sum
  float m[2] = {fast ? 0.f : -__int_as_float(0x7f800000), fast ? 0.f : -__int_as_float(0x7f800000)};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < nsteps; ++it) {
    tc::cp_async_wait<kRing - 2>();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    issue(it + kRing - 1);
    if (!active) continue;
    const int pass = first + (it >= ntiles);
    const int k0 = (it - (pass - first) * ntiles) * kBK;
    const int nch = min(4, (kv - k0 + 15) >> 4);  // 16-key chunks with a real key
    const bf16* tk = sK + (it % kRing) * kTile;
    const bf16* tv = sV + (it % kRing) * kTile;

    // S = Q K^T: n8 tile j holds keys k0 + 8 j .. + 7
    float s[8][4];
#pragma unroll
    for (int c16 = 0; c16 < 4; ++c16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * c16][e] = s[2 * c16 + 1][e] = 0.f;
      if (c16 >= nch) continue;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t kf[4];
        tc::ldmatrix_x4(kf, tk + (c16 * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                                kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * c16], qf[kk], kf[0], kf[1]);
        tc::mma_bf16(s[2 * c16 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    if (pass == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j / 2 >= nch) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * q + (e & 1) < kv) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      }
      if (it == ntiles - 1) {  // the four lanes of a row hold its 64 columns
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
        }
      }
      continue;
    }

    // p in place of s: f32 for the row sum, then rounded for P V
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j / 2 >= nch) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * q + (e & 1);
        float p = 0.f;
        if (key < kv) {
          p = exp2f(fast ? fminf(s[j][e], 120.f) : s[j][e] - m[e >> 1]);
          if (sizes != nullptr) p *= sizes[(size_t)b * seq + key];
        }
        l[e >> 1] += p;
        s[j][e] = p;
      }
    }

    // O += P V, P as A fragments straight from the S accumulators
#pragma unroll
    for (int c16 = 0; c16 < 4; ++c16) {
      if (c16 >= nch) continue;
      const uint32_t pf[4] = {
          tc::pack_bf16(s[2 * c16][0], s[2 * c16][1]),
          tc::pack_bf16(s[2 * c16][2], s[2 * c16][3]),
          tc::pack_bf16(s[2 * c16 + 1][0], s[2 * c16 + 1][1]),
          tc::pack_bf16(s[2 * c16 + 1][2], s[2 * c16 + 1][3]),
      };
#pragma unroll
      for (int n16 = 0; n16 < NK; ++n16) {
        uint32_t vf[4];
        tc::ldmatrix_x4_trans(vf, tv + (c16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                      n16 * 16 + (lane >> 4) * 8);
        tc::mma_bf16(o[2 * n16], pf, vf[0], vf[1]);
        tc::mma_bf16(o[2 * n16 + 1], pf, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // o / l rounded to bf16, staged in this warp's rows of sQ (its Q is in
  // registers), then written as 16-byte stores
  bf16* so = sQ + row0 * kLd;
  const bool real0 = q0 + row0 + g < kv, real1 = q0 + row0 + g + 8 < kv;
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
    const int c = 8 * j + 2 * q;
    *reinterpret_cast<uint32_t*>(so + g * kLd + c) =
        real0 ? tc::pack_bf16(o[j][0] / l[0], o[j][1] / l[0]) : 0u;
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kLd + c) =
        real1 ? tc::pack_bf16(o[j][2] / l[1], o[j][3] / l[1]) : 0u;
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int r = idx / chunks, c = idx - r * chunks;
    const int t = q0 + row0 + r;
    if (t < seq)
      *reinterpret_cast<uint4*>(ob + t * os.token + 8 * c) =
          *reinterpret_cast<const uint4*>(so + r * kLd + 8 * c);
  }
}

// ------------------------------------------------------------- launches

// The operands of one launch: Q, K, V and output pointers with their
// strides, the ToMe sizes (or null) and the geometry.
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  Strides in;
  const float* sizes;
  T* out;
  Strides os;
  int batch, seq, nh, d, kv;
  float qscale;
  int fast;
};

// Opt a kernel into `bytes` of dynamic shared memory, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  configured = err == cudaSuccess;
  return err;
}

template <int NK>
cudaError_t launch(const Args<float>& a, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(attention_tf32<NK>, tf32_smem_bytes(NK), configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kMmaRows - 1) / kMmaRows, a.nh, a.batch);
  attention_tf32<NK><<<grid, kMmaThreads, tf32_smem_bytes(NK), stream>>>(
      a.q, a.k, a.v, a.in, a.sizes, a.out, a.os, a.seq, a.d, a.kv, a.qscale, a.fast);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch(const Args<bf16>& a, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(attention_mma<NK>, mma_smem_bytes(NK), configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kMmaRows - 1) / kMmaRows, a.nh, a.batch);
  attention_mma<NK><<<grid, kMmaThreads, mma_smem_bytes(NK), stream>>>(
      a.q, a.k, a.v, a.in, a.sizes, a.out, a.os, a.seq, a.d, a.kv, a.qscale, a.fast);
  return cudaGetLastError();
}

// NK = ceil(d / 16): 16-wide slices of the head dimension.
template <typename T>
cudaError_t dispatch(const Args<T>& a, cudaStream_t stream) {
  switch ((a.d + 15) / 16) {
    case 1: return launch<1>(a, stream);
    case 2: return launch<2>(a, stream);
    case 3: return launch<3>(a, stream);
    case 4: return launch<4>(a, stream);
    case 5: return launch<5>(a, stream);
    case 6: return launch<6>(a, stream);
    case 7: return launch<7>(a, stream);
    case 8: return launch<8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_geometry(int batch, int seq, int nh, int d) {
  return batch < 1 || seq < 1 || nh < 1 || d < 8 || d > 128 || d % 8 != 0 ||
         batch > 65535 || nh > 65535;
}

// Fused QKV: q | k | v thirds of (B, T, 3h) rows; output (B, T, h).
template <typename T>
cudaError_t run_qkv(const void* qkv, const void* sizes, void* out, int batch,
                    int seq, int nh, int d, int kv, float qscale, int fast,
                    cudaStream_t stream) {
  const long long h = (long long)nh * d;
  const T* base = static_cast<const T*>(qkv);
  const Args<T> a{base, base + h, base + 2 * h, Strides{seq * 3 * h, d, 3 * h},
                  static_cast<const float*>(sizes), static_cast<T*>(out),
                  Strides{seq * h, d, h}, batch, seq, nh, d, kv, qscale, fast};
  return dispatch<T>(a, stream);
}

// Split heads: q, k, v and output each (B, H, T, D); safe softmax.
template <typename T>
cudaError_t run_bhtd(const void* q, const void* k, const void* v, void* out,
                     int batch, int nh, int seq, int d, float qscale,
                     cudaStream_t stream) {
  const Strides st{(long long)nh * seq * d, (long long)seq * d, d};
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), st, nullptr, static_cast<T*>(out),
                  st, batch, seq, nh, d, seq, qscale, 0};
  return dispatch<T>(a, stream);
}

// Both bodies copy 16-byte chunks.
bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// dtype: 0 = float32, 1 = bfloat16; tensors 16-byte aligned. sizes: (B, T)
// float32 or null. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int vit_attention_qkv(const void* qkv, const void* sizes, void* out,
                                 int batch, int seq, int nh, int d, int kv,
                                 float qscale, int fast, int dtype,
                                 void* stream) {
  if (bad_geometry(batch, seq, nh, d) || kv < 1 || kv > seq) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (misaligned(qkv) || misaligned(out)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)run_qkv<float>(qkv, sizes, out, batch, seq, nh, d, kv, qscale, fast, s);
  if (dtype == 1)
    return (int)run_qkv<bf16>(qkv, sizes, out, batch, seq, nh, d, kv, qscale, fast, s);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, out: contiguous (B, H, T, D). dtype as above. Safe softmax.
extern "C" int vit_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int batch, int nh, int seq, int d,
                                   float qscale, int dtype, void* stream) {
  if (bad_geometry(batch, seq, nh, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)run_bhtd<float>(q, k, v, out, batch, nh, seq, d, qscale, s);
  if (dtype == 1)
    return (int)run_bhtd<bf16>(q, k, v, out, batch, nh, seq, d, qscale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
