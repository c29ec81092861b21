// Multi-head attention for Hopper (sm_90a), CUDA C++: four bodies, all on
// the tensor cores (bf16 products, and f32 as 3xTF32), two C entry points,
// each with its own launch counter in Python, and a third for the checks.
//
// Which body takes a call, at both entry points:
//   bf16, d = 64          attention_wgmma (attention_wgmma.cuh: wgmma fed
//                         by TMA; every ViT-Ti/S/B/L head)
//   bf16, d = 80 and 88   attention_wgmma_d<D> (the same body, each tile a
//                         64-column box and a tail box; ViT-H/14, ViT-g/14)
//   bf16, any other d     attention_mma (attention_body.cuh: mma.sync fed
//                         by cp.async; d = 72, 128, ...)
//   f32, d = 64 and 80    attention_tf32_wgmma (attention_tf32_wgmma.cuh:
//                         3xTF32 on wgmma fed by TMA; every training
//                         forward, ViT-Ti/S/B/L and ViT-H/14, and f32
//                         serving)
//   f32, d = 88           attention_tf32_wgmma88 (the same body, each tile
//                         five 64-byte boxes and a 32-byte tail box;
//                         ViT-g/14's training forward and f32 serving)
//   f32, any other d      attention_tf32 (below: 3xTF32 on mma.sync;
//                         d = 72, 128, ...)
// vit_attention_mma runs the mma.sync bodies at any d (bf16:
// attention_mma; f32: attention_tf32), bf16 d = 64, 80, 88 and f32 d = 64,
// 80, 88 included, so that the checks can hold T1's `full` and the wgmma
// bodies to the bf16 one bit for bit and time each beside the wgmma body
// that replaced it; no path of the port calls it.
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
// The mma.sync bodies read Q, K and V through a (batch, head, token)
// stride set and write the output through another (the wgmma bodies read
// through tensor maps over the same views), so both layouts are read in
// place: no head split or merge transposes exist in device memory. In the
// two bodies below, one thread block owns one (batch, head, query tile)
// of 128 rows; keys are tiled 64 at a time through shared memory (K and V
// of one head at T=785, d=88 would not fit whole), and the (T, T) score
// matrix never leaves the SM.
//
// What bounds it on this card. At ViT-B/16 (T=197, h=768) attention is
// about 4 T^2 h = 0.12 GFLOP per image per layer against ~1.2 MB of qkv
// read and 0.3 MB written, i.e. ~80 FLOP per byte: below the H100's bf16
// ridge (~295 FLOP/B), so an ideal kernel is bound by HBM. A kernel that
// runs its products outside the tensor cores is not: it is bound by how
// fast the SM feeds operands to its multiply-adds. Both bodies below are
// still not bound by HBM but by issue on the SM: the mma.sync products
// (three per f32 product), then the exp2 of every score, while their K/V
// copies hide behind the products. The wgmma bodies' notes say what they
// do about that: bf16 and f32 at d = 64, 80 and 88.
//
// bf16 body (attention_mma: K1 and K3 at d other than 64, 80 and 88; its
// code is attention_body.cuh, which the forward anatomy attn_anatomy.cu
// instantiates with stages changed), in the FlashAttention-2 manner. 8
// warps, each owning 16 query rows (at ViT-B/16 B=64, 1536 blocks
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
// with the CPU to 1e-5 relative, and f32 serving, at every d but 64, 80
// and 88, which attention_tf32_wgmma takes; and through vit_attention_mma
// at any d for the checks), the bf16 body's
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
// Numerics of all four, as in the TPU kernel (flash_attention.py _sdpa
// and _qkv_pair_kernel):
//  1. Q is scaled by log2(e)/sqrt(d) in f32 and rounded to the input type
//     before Q K^T; scores accumulate in f32.
//  2. fast: s = min(s, 120) with no row max. safe: s - max over the real
//     keys. The bf16 bodies take the exact row max in a first pass over the
//     keys (the scores are recomputed in the second pass; the wgmma body
//     at kv <= 256 reads it from the one tile's accumulators), so their
//     weights are exp2(s - max) as in the TPU kernel before they are
//     rounded to bf16. The f32 bodies, whose p is not rounded, keep an
//     online max in one pass instead (the wgmma one per warpgroup, over
//     its half of the keys, the two states combined at the end): o and l
//     are rescaled by exp2(m_old - m_new) when
//     the max grows, which the division o / l cancels up to f32 rounding
//     (an H100 measured the f32 cases within 6e-6 of the plain version,
//     against 2e-5, and the safe body 1.41x faster than with the exact
//     max's first pass).
//  3. p = exp2(s), times the key mask (keys >= kv are skipped: weight 0),
//     times sizes[key] when given.
//  4. l = sum p in f32 from the f32 p; the PV product uses p rounded to
//     the input type with f32 accumulation; o / l after PV (the bf16 wgmma
//     body: o times one reciprocal of l per row, to the correctly rounded
//     quotient; the f32 bodies: __fdiv_rn), then cast.
// Products of bf16 values are exact in f32, so the mma.sync body differs
// from the plain version only in the order of its f32 sums; the bf16
// wgmma body also by the tensor cores' truncated sums; the f32 bodies by
// 3xTF32's ~2^-22 per product (the wgmma one's hi truncated, ~2^-21, and
// its sums truncated, drained by rounded additions). Query rows >= kv
// (token padding) are written as zeros, as the composed path
// (_attention_qkv_xla) does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_body.cuh"
#include "attention_tf32_wgmma.cuh"
#include "attention_wgmma.cuh"
#include "tensor_core.cuh"
#include "tensor_map.cuh"

namespace {

// the blocking both bodies share (attention_body.cuh)
using attn::bf16;
using attn::kBK;
using attn::kMmaRows;
using attn::kMmaThreads;
using attn::kRing;
using attn::Strides;

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

// attention_body.cuh's body at its default stage set.
// NK = ceil(d / 16): 16-wide slices of the (zero-padded) head dimension.
template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
    attention_mma(const bf16* __restrict__ qg, const bf16* __restrict__ kg,
                  const bf16* __restrict__ vg, Strides in,
                  const float* __restrict__ sizes, bf16* __restrict__ out,
                  Strides os, int seq, int d, int kv, float qscale, int fast) {
  attn::attention_mma_body<NK>(qg, kg, vg, in, sizes, out, os, seq, d, kv, qscale, fast);
}

// ---------------------------------------------------- bf16 body, d = 64

// attention_wgmma.cuh's body, one kernel per softmax (kFast) and per
// presence of ToMe sizes. Three blocks share an SM: at most 168 registers
// a thread.
template <bool kFast, bool kSizes>
__global__ void __launch_bounds__(attn::kWgThreads, 3)
    attention_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap, attn::WgCoords co,
                    const float* __restrict__ sizes, int seq, int kv, float qscale) {
  attn::attention_wgmma_body<64, kFast, kSizes>(qmap, kmap, vmap, omap, co, sizes, seq, kv,
                                                qscale);
}

// ---------------------------------------------- bf16 body, d = 80 and 88

// The same body at head dimension D (80: ViT-H/14, 88: ViT-g/14), one
// kernel per D, softmax and presence of sizes: each tile two TMA boxes
// (attention_wgmma.cuh), three blocks per SM as at d = 64.
template <int D, bool kFast, bool kSizes>
__global__ void __launch_bounds__(attn::kWgThreads, 3)
    attention_wgmma_d(const __grid_constant__ attn::WgMaps maps, attn::WgCoords co,
                      const float* __restrict__ sizes, int seq, int kv, float qscale) {
  attn::attention_wgmma_body<D, kFast, kSizes>(maps.q, maps.k, maps.v, maps.o, co, sizes, seq,
                                               kv, qscale, attn::Group{1, 0, 1, 0}, nullptr, 0,
                                               maps.tail);
}

// ----------------------------------------------- f32 body, d = 64, 80, 88

// attention_tf32_wgmma.cuh's body, one kernel per head dimension, per
// softmax (kFast) and per presence of ToMe sizes. Two blocks of two
// warpgroups per SM.
template <int D, bool kFast, bool kSizes>
__global__ void __launch_bounds__(fwdwg::kThreads, fwdwg::kBlocksPerSm)
    attention_tf32_wgmma(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, fwdwg::Params p) {
  fwdwg::attention_tf32_wgmma_body<D, kFast, kSizes>(qmap, kmap, vmap, p);
}

// At d = 88, with the maps of Q's, K's and V's tail boxes.
template <bool kFast, bool kSizes>
__global__ void __launch_bounds__(fwdwg::kThreads, fwdwg::kBlocksPerSm)
    attention_tf32_wgmma88(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ tf32wg::Tails tails, fwdwg::Params p) {
  fwdwg::attention_tf32_wgmma_body<88, kFast, kSizes>(qmap, kmap, vmap, p, tails.m);
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
  constexpr size_t bytes = attn::mma_smem_bytes<NK>();
  cudaError_t err = allow_smem(attention_mma<NK>, bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + kMmaRows - 1) / kMmaRows, a.nh, a.batch);
  attention_mma<NK><<<grid, kMmaThreads, bytes, stream>>>(
      a.q, a.k, a.v, a.in, a.sizes, a.out, a.os, a.seq, a.d, a.kv, a.qscale, a.fast);
  return cudaGetLastError();
}

// The operands of a bf16 wgmma launch: tensor maps of Q, K, V and the
// output (for fused qkv the first three are one map; at d = 80 and 88 each
// with its tail box's map), where a (batch, head)'s tiles lie in them, and
// the geometry.
struct WgArgs {
  attn::WgMaps m;
  attn::WgCoords co;
  const float* sizes;
  int batch, seq, nh, d, kv;
  float qscale;
  int fast;
};

template <int D, bool kFast, bool kSizes>
cudaError_t launch_wgmma(const WgArgs& a, cudaStream_t stream) {
  static bool configured = false;
  const dim3 grid((a.seq + attn::kWgRows - 1) / attn::kWgRows, a.nh, a.batch);
  const size_t bytes = attn::wgmma_smem_bytes<D>(a.kv);
  if constexpr (D == 64) {
    cudaError_t err = allow_smem(attention_wgmma<kFast, kSizes>,
                                 attn::wgmma_smem_bytes<64>(1 << 30), configured);
    if (err != cudaSuccess) return err;
    attention_wgmma<kFast, kSizes><<<grid, attn::kWgThreads, bytes, stream>>>(
        a.m.q, a.m.k, a.m.v, a.m.o, a.co, a.sizes, a.seq, a.kv, a.qscale);
  } else {
    cudaError_t err = allow_smem(attention_wgmma_d<D, kFast, kSizes>,
                                 attn::wgmma_smem_bytes<D>(1 << 30), configured);
    if (err != cudaSuccess) return err;
    attention_wgmma_d<D, kFast, kSizes><<<grid, attn::kWgThreads, bytes, stream>>>(
        a.m, a.co, a.sizes, a.seq, a.kv, a.qscale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const WgArgs& a, cudaStream_t stream) {
  if (a.fast)
    return a.sizes ? launch_wgmma<D, true, true>(a, stream)
                   : launch_wgmma<D, true, false>(a, stream);
  return a.sizes ? launch_wgmma<D, false, true>(a, stream)
                 : launch_wgmma<D, false, false>(a, stream);
}

cudaError_t launch_wgmma(const WgArgs& a, cudaStream_t stream) {
  switch (a.d) {
    case 64: return launch_wgmma<64>(a, stream);
    case 80: return launch_wgmma<80>(a, stream);
    case 88: return launch_wgmma<88>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The 4-D maps of one bf16 operand at d = 80 or 88, (d columns, heads,
// tokens, planes) with heads d * 2 bytes apart: the 64-column box in the
// 128-byte swizzle into `main`, the tail box (attn::wgmma_tail columns, a
// row of it one swizzle span) into `tail`; 64-row boxes.
cudaError_t encode_wide(CUtensorMap* main, CUtensorMap* tail, const void* base, int d,
                        uint64_t heads, uint64_t rows, uint64_t planes, uint64_t row_bytes,
                        uint64_t plane_bytes) {
  const uint64_t dims[4] = {(uint64_t)d, heads, rows, planes};
  const uint64_t strides[3] = {(uint64_t)d * 2, row_bytes, plane_bytes};
  cudaError_t err = tc::encode_bf16_4d(main, base, dims, strides, attn::kWgD, attn::kWgRows, 128);
  if (err != cudaSuccess) return err;
  const int cols = d == 80 ? attn::wgmma_tail<80>() : attn::wgmma_tail<88>();
  return tc::encode_bf16_4d(tail, base, dims, strides, cols, attn::kWgRows, 2 * cols);
}

// The operands of an f32 wgmma launch: tensor maps of Q (64-row boxes), K
// and V (16-row boxes; for fused qkv, one map), at d = 88 their tail
// boxes' maps, and the rest.
struct Tf32WgArgs {
  CUtensorMap q, k, v;
  tf32wg::Tails tails;
  fwdwg::Params p;
  int batch, nh, d, fast;
};

template <int D, bool kFast, bool kSizes>
cudaError_t launch_tf32_wgmma(const Tf32WgArgs& a, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t bytes = fwdwg::smem_bytes<D>();
  const dim3 grid((a.p.seq + fwdwg::kRows - 1) / fwdwg::kRows, a.nh, a.batch);
  if constexpr (D == 88) {
    cudaError_t err = allow_smem(attention_tf32_wgmma88<kFast, kSizes>, bytes, configured);
    if (err != cudaSuccess) return err;
    attention_tf32_wgmma88<kFast, kSizes><<<grid, fwdwg::kThreads, bytes, stream>>>(
        a.q, a.k, a.v, a.tails, a.p);
  } else {
    cudaError_t err = allow_smem(attention_tf32_wgmma<D, kFast, kSizes>, bytes, configured);
    if (err != cudaSuccess) return err;
    attention_tf32_wgmma<D, kFast, kSizes><<<grid, fwdwg::kThreads, bytes, stream>>>(
        a.q, a.k, a.v, a.p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32_wgmma(const Tf32WgArgs& a, cudaStream_t stream) {
  const bool sized = a.p.sizes != nullptr;
  if (a.fast)
    return sized ? launch_tf32_wgmma<D, true, true>(a, stream)
                 : launch_tf32_wgmma<D, true, false>(a, stream);
  return sized ? launch_tf32_wgmma<D, false, true>(a, stream)
               : launch_tf32_wgmma<D, false, false>(a, stream);
}

// The maps of Q, K and V (x; V's is K's when they are one tensor) over
// `planes` planes of `rows` rows (the token extent) of `cols` floats, rows
// `row_bytes` and planes `plane_bytes` apart, in boxes of `box_cols`
// floats in the (4 box_cols)-byte swizzle by 64 rows (Q) or kChunkK1 (K,
// V).
cudaError_t encode_tf32(CUtensorMap* m, const void* const (&x)[3], uint64_t cols,
                        uint64_t rows, uint64_t planes, uint64_t row_bytes, uint64_t plane_bytes,
                        uint32_t box_cols) {
  const CUtensorMapDataType t = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const uint32_t box_rows[3] = {fwdwg::kRows, fwdwg::kChunkK1, fwdwg::kChunkK1};
  for (int i = 0; i < 3; ++i) {
    if (i == 2 && x[2] == x[1]) {
      m[2] = m[1];
      break;
    }
    cudaError_t err = tc::encode_sw_3d(&m[i], t, x[i], cols, rows, planes, row_bytes,
                                       plane_bytes, box_cols, box_rows[i], 4 * box_cols);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Encodes an f32 wgmma launch's maps, boxes of one swizzle row (d = 64: 32
// floats in the 128-byte swizzle; d = 80 and 88: 16 in the 64-byte one;
// d = 88's tail boxes: 8 in the 32-byte one), then launches.
cudaError_t run_tf32_wgmma(Tf32WgArgs& a, const void* q, const void* k, const void* v,
                           uint64_t cols, uint64_t rows, uint64_t planes, uint64_t row_bytes,
                           uint64_t plane_bytes, cudaStream_t stream) {
  const void* const x[3] = {q, k, v};
  CUtensorMap m[3];
  cudaError_t err = encode_tf32(m, x, cols, rows, planes, row_bytes, plane_bytes,
                                a.d == 64 ? 32 : 16);
  if (err != cudaSuccess) return err;
  a.q = m[0], a.k = m[1], a.v = m[2];
  if (a.d == 88) {
    err = encode_tf32(a.tails.m, x, cols, rows, planes, row_bytes, plane_bytes,
                      fwdwg::G<88>::kTail);
    if (err != cudaSuccess) return err;
  }
  switch (a.d) {
    case 64: return launch_tf32_wgmma<64>(a, stream);
    case 80: return launch_tf32_wgmma<80>(a, stream);
    case 88: return launch_tf32_wgmma<88>(a, stream);
    default: return cudaErrorInvalidValue;
  }
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

// Fused QKV: q | k | v thirds of (B, T, 3h) rows; output (B, T, h). bf16
// and f32 at d = 64, 80 and 88 take the wgmma bodies unless `mma`.
template <typename T>
cudaError_t run_qkv(const void* qkv, const void* sizes, void* out, int batch,
                    int seq, int nh, int d, int kv, float qscale, int fast,
                    bool mma, cudaStream_t stream) {
  const long long h = (long long)nh * d;
  if constexpr (sizeof(T) == 4) {
    if (fwdwg::takes(d) && !mma) {
      // planes are images: rows of 3h (tokens past kv load as zeros); a
      // head's Q, K and V are column offsets
      Tf32WgArgs w;
      w.p = fwdwg::Params{attn::WgCoords{0, (int)h, (int)(2 * h), d, 1, 0},
                          static_cast<const float*>(sizes), static_cast<float*>(out),
                          Strides{seq * h, d, h}, seq, kv, qscale};
      w.batch = batch, w.nh = nh, w.d = d, w.fast = fast;
      return run_tf32_wgmma(w, qkv, qkv, qkv, 3 * h, kv, batch, 3 * h * 4,
                            (uint64_t)seq * 3 * h * 4, stream);
    }
  }
  if constexpr (sizeof(T) == 2) {
    if (attn::wgmma_takes(d) && !mma) {
      // planes are images: rows of 3h (tokens past kv load as zeros) in,
      // rows of h out; a head's Q, K and V are column offsets (d = 64) or
      // head offsets (d = 80, 88: 3 nh heads of d columns a row)
      WgArgs w;
      cudaError_t err;
      if (d == attn::kWgD) {
        err = tc::encode_sw128_3d(&w.m.q, qkv, 3 * h, kv, batch, 3 * h * 2,
                                  (uint64_t)seq * 3 * h * 2, attn::kWgD, attn::kWgRows);
        if (err == cudaSuccess)
          err = tc::encode_sw128_3d(&w.m.o, out, h, seq, batch, h * 2, (uint64_t)seq * h * 2,
                                    attn::kWgD, attn::kWgRows);
        w.co = attn::WgCoords{0, (int)h, (int)(2 * h), d, 1, 0};
      } else {
        err = encode_wide(&w.m.q, &w.m.tail[0], qkv, d, 3 * nh, kv, batch, 3 * h * 2,
                          (uint64_t)seq * 3 * h * 2);
        if (err == cudaSuccess)
          err = encode_wide(&w.m.o, &w.m.tail[3], out, d, nh, seq, batch, h * 2,
                            (uint64_t)seq * h * 2);
        w.m.tail[1] = w.m.tail[2] = w.m.tail[0];
        w.co = attn::WgCoords{0, nh, 2 * nh, 1, 1, 0};
      }
      if (err != cudaSuccess) return err;
      w.m.k = w.m.v = w.m.q;
      w.sizes = static_cast<const float*>(sizes);
      w.batch = batch, w.seq = seq, w.nh = nh, w.d = d, w.kv = kv, w.qscale = qscale;
      w.fast = fast;
      return launch_wgmma(w, stream);
    }
  }
  const T* base = static_cast<const T*>(qkv);
  const Args<T> a{base, base + h, base + 2 * h, Strides{seq * 3 * h, d, 3 * h},
                  static_cast<const float*>(sizes), static_cast<T*>(out),
                  Strides{seq * h, d, h}, batch, seq, nh, d, kv, qscale, fast};
  return dispatch<T>(a, stream);
}

// Split heads: q, k, v and output each (B, H, T, D); safe softmax. bf16
// and f32 at d = 64, 80 and 88 take the wgmma bodies unless `mma`.
template <typename T>
cudaError_t run_bhtd(const void* q, const void* k, const void* v, void* out,
                     int batch, int nh, int seq, int d, float qscale, bool mma,
                     cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if (fwdwg::takes(d) && !mma) {
      // planes are (image, head) pairs of seq rows of d
      if ((long long)batch * nh > 0x7fffffff) return cudaErrorInvalidValue;
      Tf32WgArgs w;
      const long long hd = (long long)seq * d;
      w.p = fwdwg::Params{attn::WgCoords{0, 0, 0, 0, nh, 1}, nullptr, static_cast<float*>(out),
                          Strides{nh * hd, hd, d}, seq, seq, qscale};
      w.batch = batch, w.nh = nh, w.d = d, w.fast = 0;
      return run_tf32_wgmma(w, q, k, v, d, seq, (uint64_t)batch * nh, d * 4, hd * 4, stream);
    }
  }
  if constexpr (sizeof(T) == 2) {
    if (attn::wgmma_takes(d) && !mma) {
      // planes are (image, head) pairs of seq rows of d (d = 80, 88: one
      // head a plane)
      if ((long long)batch * nh > 0x7fffffff) return cudaErrorInvalidValue;
      WgArgs w;
      const void* src[4] = {q, k, v, out};
      CUtensorMap* map[4] = {&w.m.q, &w.m.k, &w.m.v, &w.m.o};
      for (int i = 0; i < 4; ++i) {
        const cudaError_t err =
            d == attn::kWgD
                ? tc::encode_sw128_3d(map[i], src[i], d, seq, (uint64_t)batch * nh, d * 2,
                                      (uint64_t)seq * d * 2, attn::kWgD, attn::kWgRows)
                : encode_wide(map[i], &w.m.tail[i], src[i], d, 1, seq, (uint64_t)batch * nh,
                              d * 2, (uint64_t)seq * d * 2);
        if (err != cudaSuccess) return err;
      }
      w.co = attn::WgCoords{0, 0, 0, 0, nh, 1};
      w.sizes = nullptr;
      w.batch = batch, w.seq = seq, w.nh = nh, w.d = d, w.kv = seq, w.qscale = qscale;
      w.fast = 0;
      return launch_wgmma(w, stream);
    }
  }
  const Strides st{(long long)nh * seq * d, (long long)seq * d, d};
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), st, nullptr, static_cast<T*>(out),
                  st, batch, seq, nh, d, seq, qscale, 0};
  return dispatch<T>(a, stream);
}

// The bodies copy 16-byte chunks (TMA: 16-byte aligned bases).
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
    return (int)run_qkv<float>(qkv, sizes, out, batch, seq, nh, d, kv, qscale, fast, false, s);
  if (dtype == 1)
    return (int)run_qkv<bf16>(qkv, sizes, out, batch, seq, nh, d, kv, qscale, fast, false, s);
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
    return (int)run_bhtd<float>(q, k, v, out, batch, nh, seq, d, qscale, false, s);
  if (dtype == 1)
    return (int)run_bhtd<bf16>(q, k, v, out, batch, nh, seq, d, qscale, false, s);
  return (int)cudaErrorInvalidValue;
}

// The bodies the wgmma ones replaced, at any d, 64, 80 and 88 included,
// for the checks only: bf16 through the mma.sync body (attention_mma;
// T1's `full` is that body bit for bit), f32 through the 3xTF32 mma.sync
// body (attention_tf32); chip_smoke.py times each beside
// the wgmma body that replaced it. No path of the port calls it. dtype as
// above; split 0: q is the fused (B, T, 3h) qkv (k and v unused), out (B,
// T, h), kv, sizes and fast as vit_attention_qkv's; split 1: q, k, v and
// out (B, H, T, D), safe softmax (kv, sizes and fast unused).
extern "C" int vit_attention_mma(const void* q, const void* k, const void* v,
                                 const void* sizes, void* out, int batch, int seq,
                                 int nh, int d, int kv, float qscale, int fast, int split,
                                 int dtype, void* stream) {
  if (bad_geometry(batch, seq, nh, d) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split) {
    if (misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out))
      return (int)cudaErrorInvalidValue;
    if (dtype == 0) return (int)run_bhtd<float>(q, k, v, out, batch, nh, seq, d, qscale, true, s);
    return (int)run_bhtd<bf16>(q, k, v, out, batch, nh, seq, d, qscale, true, s);
  }
  if (kv < 1 || kv > seq || misaligned(q) || misaligned(out)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)run_qkv<float>(q, sizes, out, batch, seq, nh, d, kv, qscale, fast, true, s);
  return (int)run_qkv<bf16>(q, sizes, out, batch, seq, nh, d, kv, qscale, fast, true, s);
}

extern "C" const char* vit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
