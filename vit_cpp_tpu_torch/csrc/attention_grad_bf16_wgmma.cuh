// K2's bf16 body at d = 64 for Hopper (sm_90a): the attention backward on
// bf16 wgmma, fed by TMA. attention_qkv_grad.cu instantiates it at K2's
// stages (grad_rows_bf16_wgmma, grad_cols_bf16_wgmma) and sends it every
// bf16 call with d = 64: any B, T and nh, with or without ToMe sizes, the
// pair shapes and the lane shapes (T = 785) alike. attn_grad_anatomy.cu
// instantiates it with one stage set per variant (T2 at d = 64).
//
// Replaces, for those calls, the TPU kernels behind vit_cpp_tpu/ops/
// flash_attention.py::_attention_qkv_grad (:1166; the pair kernel
// _qkv_grad_pair_kernel :857, the pallas_call at :1214) and
// _attention_qkv_grad_lane (:1083; the pallas_call at :1113), as the
// mma.sync body of attention_grad_body.cuh did before it (that body still
// serves bf16 at every other d, and the checks reach it at d = 64 through
// vit_attention_qkv_grad_mma).
//
// What bounds it on this card. At ViT-B/16 B = 32 (T = 197) the backward
// reads qkv and dO and writes dqkv, 4.0 MB in bf16 (0.0202 ms at 3.35
// TB/s), for five T x T x d products per head (3.7 GFLOP, 0.0038 ms at
// 989 TFLOP/s; nine with the recomputed S and dP): the bytes bound it. The
// mma.sync body ran at ~11x that bound: each of its four warps ldmatrix'ed
// every K / V (launch A) or Q / dO (launch B) fragment it used and issued
// mma.sync on 16 rows, so the SM's schedulers, and not the tensor cores or
// HBM, set its pace (T2, PERF.md section 5: products and skeleton 0.57 of
// its time). Here one warpgroup instruction multiplies 64 rows by 64
// tokens over 16 lanes, reading its operands from shared memory as TMA
// landed them (or A from registers), and one thread moves every tile.
//
// Design (the two launches, the workspace and the numerics are the
// mma.sync body's, attention_qkv_grad.cu):
// - A warpgroup (128 threads) owns 64 resident rows of one (image, head),
//   wgmma's M: queries in launch A (qs and dO), keys in launch B (K and
//   V). The other tokens stream in 64-token chunks (one 8 KB box per
//   operand) through the warpgroup's ring of chunk slots (launch A: K and
//   V, 2 slots; launch B: q and dO, 2 slots), each refilled by the
//   warpgroup's first thread once every warp is past the wgmmas that read
//   it. A block is one warpgroup (K2) or, in the anatomy's pipe variants,
//   S::kHeads of them, one head each. K2's blocks take 49 KB (launch A)
//   and 59 KB (launch B) of shared memory and at most 168 registers a
//   thread: three blocks share an SM, so one block's loads and softmax
//   overlap another's products (kRowsBlocks, kColsBlocks). On an H100
//   (tools/grad_variants.py) launch B at two blocks (172 registers) took
//   89.9 us at B = 32, T = 197, at three (166) 70.9 us; launch A at four
//   (128 registers) spilled 8 bytes and gained 3%.
// - Every tile arrives by TMA over the 3-D maps (columns, tokens, images)
//   of the fused (B, T, 3h) qkv and the (B, T, h) dO, whose token extent is
//   T: rows past the sequence load as zeros, a box never reaches the next
//   image, and every box starts at a real token, so each barrier expects
//   the box's full bytes. A d = 64 bf16 row is one 128-byte swizzle row.
// - Products (all wgmma.m64n64k16, f32 accumulators):
//     launch A  S = qs K^T and dP = dO V^T, both operands K-major from
//               shared memory; dQ += dS K, dS from registers, K MN-major
//               (the transpose bit);
//     launch B  S^T = K qs^T and dP^T = V dO^T (the keys are the rows, so
//               Pn^T and dS^T need no transpose); dV += Pn^T dO and dK +=
//               dS^T q, Pn^T and dS^T from registers, dO and q MN-major.
//   The accumulators of two neighbouring 8-token columns, rounded to bf16
//   and packed in pairs, are the A fragment of a 16-token step (as K1's P,
//   attention_wgmma.cuh). The two chains of a step (S and dP; dV and dK)
//   alternate instruction by instruction, so the tensor cores have two
//   independent accumulators in flight.
// - qs is rounded to bf16 in shared memory: launch A scales its resident q
//   tile in place once; launch B needs each streamed q chunk twice (qs for
//   S^T, q for dK), so it writes qs into a tile of its own, and each tile
//   written by threads is fenced for the async proxy before a wgmma reads
//   it.
// - One schedule per step: wait for the chunk, issue the score products
//   and wait for them, refill the slot the previous step used, take the
//   softmax and dsoftmax chains into arrays of their own, issue the token
//   products and wait for them. Every step issues the same groups and
//   waits for the same count, so ptxas keeps the wgmmas asynchronous.
//   With the token products left in flight beside the next step's score
//   products, or the chains written over the score accumulators, ptxas
//   serialized every wgmma (C7515: registers that the softmax wrote in a
//   stage were accumulators of that stage's wgmmas), and the body ran
//   1.07-1.09x slower on an H100. Pipelining launch A's statistics pass
//   as K1's pass 1 (step s + 1's score products beside step s's softmax,
//   two accumulator sets) spilled at 168 registers and ran slower.
// - Launch B reads the row statistics (max, 1 / sum p, r) of a chunk's 64
//   queries from shared memory: each thread loads its share for the next
//   step into registers one step ahead and stores it at the top of the
//   step into one of two buffers.
// - A column past the sequence (the T tail: 5 real rows of 64 at T = 197,
//   one at T = 257) gets p = 0 and ds = 0 (launch A) or pn = ds = 0 (launch
//   B); only the chunk that reaches past T forms the mask. Its zero rows
//   add exactly 0 to every product.
// - The partial sums are added in a fixed order (each output element is
//   one warpgroup's one accumulator), so a call is bit-equal to the next.
//   The mma.sync body sums in another order: the two agree within bf16's
//   tolerance, not bit for bit.
// - A barrier wait that outlasts seconds traps (tc::mbar_wait_or_trap).
//
// Stages (T2): the body takes a stage set (grad::Stages, attention_grad_
// body.cuh): the softmax on or off (pn = s), its exp2 in bf16, the
// dsoftmax chain on or off (ds = round(dp)), S::kHeads warpgroups (heads)
// per block and launch B's ring depth (S::kColsRing, 0: 2). K2 is the
// default set; a variant computes only what its stages need, as the
// mma.sync body's variants do.
//
// Numerics (attention_qkv_grad.cu's contract): qs = round(q log2(e) /
// sqrt(d)); exp2 of s - max; __fmul_rn / __fsub_rn in the softmax and
// dsoftmax chains; one reciprocal of sum p per row; sizes as key weights on
// p; pad keys p = 0 and pad queries pn = 0; dv = round(pn)^T dO; ds =
// round(pn (dp - r)); dq and dk times 1/sqrt(d), rounded to bf16 on store.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_grad_body.cuh"
#include "tensor_core.cuh"
#include "tensor_map.cuh"

namespace gradbf {

using grad::bf16;

constexpr int kRows = 64;                 // resident rows per warpgroup: wgmma's M
constexpr int kD = 64;                    // the head dimension it takes
constexpr int kChunk = 64;                // streamed tokens per step
constexpr int kBox = kRows * kD * 2;      // bytes of one 64 x 64 bf16 tile
constexpr int kWgThreads = 128;           // one warpgroup
constexpr int kRowsRing = 2;              // launch A's (K, V) chunk slots
constexpr int kStatBytes = 2048;          // launch B's two buffers of 64 x 3 floats

// K2's blocks per SM, for the register caps of its kernels (168 registers
// a thread): three in each launch (49 and 59 KB of shared memory).
constexpr int kRowsBlocks = 3;
constexpr int kColsBlocks = 3;

template <class S>
__host__ __device__ constexpr int cols_ring() {
  return S::kColsRing != 0 ? S::kColsRing : 2;
}

// Per warpgroup: launch A qs, dO and its ring of (K, V) slots; launch B K,
// V, qs, its ring of (q, dO) slots and the statistics buffers. Both are
// multiples of 1024 bytes, so every tile keeps the swizzle's alignment.
__host__ __device__ constexpr int rows_wg_bytes() { return (2 + 2 * kRowsRing) * kBox; }
template <class S>
__host__ __device__ constexpr int cols_wg_bytes() {
  return (3 + 2 * cols_ring<S>()) * kBox + kStatBytes;
}

// Dynamic shared memory of a block of S::kHeads warpgroups, from a
// 1024-aligned base (+ 1024 for the alignment).
template <class S>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  return 1024 + (size_t)S::kHeads * rows_wg_bytes();
}
template <class S>
__host__ __device__ constexpr size_t cols_smem_bytes() {
  return 1024 + (size_t)S::kHeads * cols_wg_bytes<S>();
}

// The operands of one call besides its tensor maps.
struct Params {
  const float* sizes;  // (B, T) or null
  bf16* dqkv;          // (B, T, 3h)
  float* stats;        // (B, nh, T, 3): row max, 1 / sum p, r
  int seq, nh;
  float qscale, nat;
};

// This warpgroup's barrier (named barrier 1 + wg, 128 threads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (tc::smem_u32(p) & 1023)) & 1023);
}

// A K-major operand's k step kk (16 lanes, 32 bytes) of a 64-row tile.
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int kk) {
  return tc::sw128_desc(tile + 32 * kk, 16, 1024);
}
// An MN-major operand's 16-row step k16 of a 64-row tile (rows 16 k16 ..
// + 15 lie 2048 bytes apart).
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int k16) {
  return tc::sw128_desc(tile + 2048 * k16, 8192, 1024);
}

// 16 bytes of bf16 at `src` times s in f32, rounded back, to `dst` (the
// swizzle moves whole 16-byte chunks, so the elementwise pass ignores it).
__device__ __forceinline__ void scale16(unsigned char* dst, const unsigned char* src, float s) {
  uint4 w = *reinterpret_cast<const uint4*>(src);
  uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
    u[e] = tc::pack_bf16(__fmul_rn(f.x, s), __fmul_rn(f.y, s));
  }
  *reinterpret_cast<uint4*>(dst) = w;
}

// acc (64 x 64) = A B^T over d, A and B 64-row tiles, both K-major; two
// products (a1 b1^T into acc1 too) alternate step by step.
__device__ __forceinline__ void scores(float (&acc)[32], const unsigned char* a,
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) tc::wgmma_m64n64k16_ss(acc, kmajor(a, kk), kmajor(b, kk), kk);
}
__device__ __forceinline__ void scores2(float (&acc0)[32], const unsigned char* a0,
                                        const unsigned char* b0, float (&acc1)[32],
                                        const unsigned char* a1, const unsigned char* b1) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    tc::wgmma_m64n64k16_ss(acc0, kmajor(a0, kk), kmajor(b0, kk), kk);
    tc::wgmma_m64n64k16_ss(acc1, kmajor(a1, kk), kmajor(b1, kk), kk);
  }
}

// The 64 x 64 accumulator rounded to bf16 and packed as the A fragments of
// its four 16-token steps.
__device__ __forceinline__ void pack(uint32_t (&f)[4][4], const float (&acc)[32]) {
#pragma unroll
  for (int k16 = 0; k16 < 4; ++k16) {
    const float* x = acc + 8 * k16;  // 8-token columns 2 k16 and 2 k16 + 1
    f[k16][0] = tc::pack_bf16(x[0], x[1]);
    f[k16][1] = tc::pack_bf16(x[2], x[3]);
    f[k16][2] = tc::pack_bf16(x[4], x[5]);
    f[k16][3] = tc::pack_bf16(x[6], x[7]);
  }
}

// f(std::true_type) for a chunk that reaches past the sequence (it masks),
// else f(std::false_type).
template <class F>
__device__ __forceinline__ void with_mask(bool tail, F&& f) {
  if (tail)
    f(std::true_type());
  else
    f(std::false_type());
}

template <class S>
__device__ __forceinline__ float exp2_stage(float x) {
  return S::kBf16Exp ? tc::exp2_bf16(x) : exp2f(x);
}

// ------------------------------------------------------------- launch A
// One warpgroup per (batch, head, 64-query tile) -> dq, row statistics.
template <class S>
__device__ __forceinline__ void grad_rows_body(const CUtensorMap& qkv, const CUtensorMap& dout,
                                               const Params& a) {
  // a statistics pass (pass 1) when the softmax or the dsoftmax chain is
  // on; pass 1 needs dP only for r, pass 2 needs S only for pn
  constexpr bool kStats = S::kSoftmax || S::kDsoft;
  constexpr int R = kRowsRing;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[S::kHeads][1 + R];  // resident tiles; each slot
  unsigned char* sm = align1024(smem_raw);

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, head = blockIdx.y * S::kHeads + wg, q0 = blockIdx.x * kRows;
  const int seq = a.seq, h = a.nh * kD, hc = head * kD;
  unsigned char* sQ = sm + wg * rows_wg_bytes();  // qs (scaled in place)
  unsigned char* sO = sQ + kBox;
  auto slot = [&](int r) { return sO + kBox + r * 2 * kBox; };  // K, then V
  uint64_t* bar = bars[wg];
  const int nck = (seq + kChunk - 1) / kChunk;
  const int p2 = kStats ? nck : 0;  // pass 2's first step
  const int nsteps = p2 + nck;
  const float* sz = a.sizes == nullptr ? nullptr : a.sizes + (size_t)b * seq;

  auto issue = [&](int s) {  // the warpgroup's first thread: step s's K and V
    const int c0 = kChunk * (s < p2 ? s : s - p2), r = s % R;
    tc::mbar_arrive_expect_tx(&bar[1 + r], 2 * kBox);
    tc::tma_load_3d(slot(r), &qkv, h + hc, c0, b, &bar[1 + r]);
    tc::tma_load_3d(slot(r) + kBox, &qkv, 2 * h + hc, c0, b, &bar[1 + r]);
  };
  if (wt == 0) {
    for (int i = 0; i < 1 + R; ++i) tc::mbar_init(&bar[i], 1);
    tc::fence_mbarrier_init();
  }
  wg_sync(wg);
  if (wt == 0) {
    tc::mbar_arrive_expect_tx(&bar[0], 2 * kBox);
    tc::tma_load_3d(sQ, &qkv, hc, q0, b, &bar[0]);
    tc::tma_load_3d(sO, &dout, hc, q0, b, &bar[0]);
    for (int s = 0; s < R && s < nsteps; ++s) issue(s);
  }
  tc::mbar_wait_or_trap(&bar[0], 0);
  for (int i = wt; i < kBox / 16; i += kWgThreads) scale16(sQ + 16 * i, sQ + 16 * i, a.qscale);
  tc::fence_proxy_async();
  wg_sync(wg);

  auto wait_step = [&](int s) { tc::mbar_wait_or_trap(&bar[1 + s % R], (s / R) & 1); };
  // step s's products are done (and with them every earlier wgmma): the
  // slot of step s - 1 takes step s - 1 + R
  auto refill = [&](int s) {
    wg_sync(wg);
    if (wt == 0 && s >= 1 && s - 1 + R < nsteps) issue(s - 1 + R);
  };

  // rows g and g + 8 of the warp's 16, this lane's columns: running max,
  // sum p, sum dp p (pass 1); then the row's max, 1 / sum p and r
  float m[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
  float l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};

  if constexpr (kStats) {
    for (int s = 0; s < nck; ++s) {
      const int c0 = kChunk * s;
      const unsigned char* k = slot(s % R);
      wait_step(s);
      float sa[32], pa[32];
      tc::wgmma_fence();
      if constexpr (S::kDsoft)
        scores2(sa, sQ, k, pa, sO, k + kBox);
      else
        scores(sa, sQ, k);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_operands(sa);
      if constexpr (S::kDsoft) tc::fence_operands(pa);
      refill(s);
      with_mask(c0 + kChunk > seq, [&](auto mask) {
        constexpr bool kMask = decltype(mask)::value;
        if constexpr (S::kSoftmax) {
          float mt[2] = {m[0], m[1]};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!kMask || c0 + 8 * j + 2 * q + (e & 1) < seq)
                mt[e >> 1] = fmaxf(mt[e >> 1], sa[4 * j + e]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (mt[i] > m[i]) {  // exp2(-inf) = 0 on the first chunk
              const float alpha = exp2f(__fsub_rn(m[i], mt[i]));
              l[i] = __fmul_rn(l[i], alpha);
              if constexpr (S::kDsoft) u[i] = __fmul_rn(u[i], alpha);
              m[i] = mt[i];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c0 + 8 * j + 2 * q + (e & 1);
            if (kMask && key >= seq) continue;
            if constexpr (S::kSoftmax) {
              float p = exp2_stage<S>(__fsub_rn(sa[4 * j + e], m[e >> 1]));
              if (sz != nullptr) p = __fmul_rn(p, sz[key]);
              l[e >> 1] = __fadd_rn(l[e >> 1], p);
              if constexpr (S::kDsoft) u[e >> 1] = fmaf(pa[4 * j + e], p, u[e >> 1]);
            } else {
              u[e >> 1] = fmaf(pa[4 * j + e], sa[4 * j + e], u[e >> 1]);
            }
          }
      });
    }
    // the four lanes of a row: common max, rescaled sums, then 1 / sum p and r
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (S::kSoftmax) {
        float mx = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float sc = exp2f(__fsub_rn(m[i], mx));  // 0 for a lane with no key
        float lt = __fmul_rn(l[i], sc), ut = __fmul_rn(u[i], sc);
        lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
        lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
        if constexpr (S::kDsoft) {
          ut = __fadd_rn(ut, __shfl_xor_sync(0xffffffffu, ut, 1));
          ut = __fadd_rn(ut, __shfl_xor_sync(0xffffffffu, ut, 2));
        }
        m[i] = mx;
        l[i] = __frcp_rn(lt);
        r[i] = S::kDsoft ? __fdiv_rn(ut, lt) : 0.f;
      } else {  // pn = s: r = sum dp * s
        float ut = __fadd_rn(u[i], __shfl_xor_sync(0xffffffffu, u[i], 1));
        ut = __fadd_rn(ut, __shfl_xor_sync(0xffffffffu, ut, 2));
        m[i] = 0.f;
        l[i] = 1.f;
        r[i] = ut;
      }
    }
  }

  // pass 2: dS, then dQ += dS K chunk by chunk
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  for (int s = p2; s < nsteps; ++s) {
    const int c0 = kChunk * (s - p2);
    const unsigned char* k = slot(s % R);
    wait_step(s);
    float sa[32], pa[32];
    tc::wgmma_fence();
    if constexpr (S::kDsoft)
      scores2(sa, sQ, k, pa, sO, k + kBox);
    else
      scores(pa, sO, k + kBox);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();  // the previous step's dQ too
    if constexpr (S::kDsoft) tc::fence_operands(sa);
    tc::fence_operands(pa);
    refill(s);
    float dsv[32];
    with_mask(c0 + kChunk > seq, [&](auto mask) {
      constexpr bool kMask = decltype(mask)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + 8 * j + 2 * q + (e & 1), i = e >> 1;
          float ds = 0.f;
          if (!kMask || key < seq) {
            if constexpr (S::kDsoft) {
              float pn = sa[4 * j + e];
              if constexpr (S::kSoftmax) {
                float p = exp2_stage<S>(__fsub_rn(sa[4 * j + e], m[i]));
                if (sz != nullptr) p = __fmul_rn(p, sz[key]);
                pn = __fmul_rn(p, l[i]);
              }
              ds = __fmul_rn(pn, __fsub_rn(pa[4 * j + e], r[i]));
            } else {
              ds = pa[4 * j + e];
            }
          }
          dsv[4 * j + e] = ds;
        }
    });
    uint32_t ds16[4][4];
    pack(ds16, dsv);
    tc::wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) tc::wgmma_m64n64k16_rs(dq, ds16[k16], mnmajor(k, k16), 1);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
  }
  tc::wgmma_wait<0>();
  tc::fence_operands(dq);

  const long long row3 = 3LL * h;
  bf16* dqb = a.dqkv + (long long)b * seq * row3 + hc;
  float* st = a.stats + ((long long)b * a.nh + head) * seq * 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + 16 * warp + g + 8 * i;
    if (t >= seq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dqb + (long long)t * row3 + 8 * j + 2 * q) =
          tc::pack_bf16(__fmul_rn(dq[4 * j + 2 * i], a.nat), __fmul_rn(dq[4 * j + 2 * i + 1], a.nat));
    if (q == 0) {
      st[(long long)t * 3 + 0] = m[i];
      st[(long long)t * 3 + 1] = l[i];
      st[(long long)t * 3 + 2] = r[i];
    }
  }
}

// ------------------------------------------------------------- launch B
// One warpgroup per (batch, head, 64-key tile) -> dk, dv.
template <class S>
__device__ __forceinline__ void grad_cols_body(const CUtensorMap& qkv, const CUtensorMap& dout,
                                               const Params& a) {
  constexpr int R = cols_ring<S>();
  constexpr int kSt = kChunk * 3;  // floats of one chunk's statistics
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[S::kHeads][1 + R];
  unsigned char* sm = align1024(smem_raw);

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, head = blockIdx.y * S::kHeads + wg, k0 = blockIdx.x * kRows;
  const int seq = a.seq, h = a.nh * kD, hc = head * kD;
  unsigned char* sK = sm + wg * cols_wg_bytes<S>();
  unsigned char* sV = sK + kBox;
  unsigned char* sQs = sK + 2 * kBox;  // round(q * scale) of the current chunk
  auto slot = [&](int r) { return sK + 3 * kBox + r * 2 * kBox; };  // q, then dO
  float* sst = reinterpret_cast<float*>(sK + (3 + 2 * R) * kBox);  // two chunks' statistics
  uint64_t* bar = bars[wg];
  const int nck = (seq + kChunk - 1) / kChunk;
  const float* st = a.stats + ((long long)b * a.nh + head) * seq * 3;

  auto issue = [&](int s) {  // the warpgroup's first thread: step s's q and dO
    const int c0 = kChunk * s, r = s % R;
    tc::mbar_arrive_expect_tx(&bar[1 + r], 2 * kBox);
    tc::tma_load_3d(slot(r), &qkv, hc, c0, b, &bar[1 + r]);
    tc::tma_load_3d(slot(r) + kBox, &dout, hc, c0, b, &bar[1 + r]);
  };
  if (wt == 0) {
    for (int i = 0; i < 1 + R; ++i) tc::mbar_init(&bar[i], 1);
    tc::fence_mbarrier_init();
  }
  wg_sync(wg);
  if (wt == 0) {
    tc::mbar_arrive_expect_tx(&bar[0], 2 * kBox);
    tc::tma_load_3d(sK, &qkv, h + hc, k0, b, &bar[0]);
    tc::tma_load_3d(sV, &qkv, 2 * h + hc, k0, b, &bar[0]);
    for (int s = 0; s < R && s < nck; ++s) issue(s);
  }

  // this thread's share of step s's statistics (floats wt and wt + 128 of
  // its 3 x 64), loaded one step ahead
  float pre[2];
  auto fetch = [&](int s) {
    const int c0 = kChunk * s;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = wt + kWgThreads * e;
      pre[e] = i < kSt && c0 + i / 3 < seq ? __ldg(st + 3LL * c0 + i) : 0.f;
    }
  };
  fetch(0);
  bool real[2];
  float w[2];  // sizes of this thread's keys (rows g, g + 8)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * warp + g + 8 * i;
    real[i] = key < seq;
    w[i] = (a.sizes == nullptr || !real[i]) ? 1.f : a.sizes[(long long)b * seq + key];
  }
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  tc::mbar_wait_or_trap(&bar[0], 0);

  for (int s = 0; s < nck; ++s) {
    const int c0 = kChunk * s;
    unsigned char* x = slot(s % R);
    tc::mbar_wait_or_trap(&bar[1 + s % R], (s / R) & 1);
    // qs of the chunk, and its statistics into buffer s & 1
    for (int i = wt; i < kBox / 16; i += kWgThreads) scale16(sQs + 16 * i, x + 16 * i, a.qscale);
    float* ts = sst + (s & 1) * kSt;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (wt + kWgThreads * e < kSt) ts[wt + kWgThreads * e] = pre[e];
    if (s + 1 < nck) fetch(s + 1);
    tc::fence_proxy_async();
    wg_sync(wg);

    float sa[32], pa[32];
    tc::wgmma_fence();
    scores2(sa, sK, sQs, pa, sV, x + kBox);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();  // the previous step's dV and dK too
    tc::fence_operands(sa);
    tc::fence_operands(pa);
    if constexpr (R > 1) {  // the slot of step s - 1 takes step s - 1 + R
      wg_sync(wg);
      if (wt == 0 && s >= 1 && s - 1 + R < nck) issue(s - 1 + R);
    }

    // sa <- pn, pa <- ds, both [key][query]
    float pnv[32], dsv[32];
    with_mask(c0 + kChunk > seq, [&](auto mask) {
      constexpr bool kMask = decltype(mask)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = 8 * j + 2 * q + (e & 1);
          float pn = 0.f, ds = 0.f;
          if (real[i] && (!kMask || c0 + c < seq)) {
            pn = sa[4 * j + e];
            if constexpr (S::kSoftmax) {
              float p = exp2_stage<S>(__fsub_rn(sa[4 * j + e], ts[3 * c]));
              if (a.sizes != nullptr) p = __fmul_rn(p, w[i]);
              pn = __fmul_rn(p, ts[3 * c + 1]);
            }
            ds = S::kDsoft ? __fmul_rn(pn, __fsub_rn(pa[4 * j + e], ts[3 * c + 2]))
                           : pa[4 * j + e];
          }
          pnv[4 * j + e] = pn;
          dsv[4 * j + e] = ds;
        }
    });
    // dV += round(Pn^T) dO and dK += dS^T q, alternating
    uint32_t pn16[4][4], ds16[4][4];
    pack(pn16, pnv);
    pack(ds16, dsv);
    tc::wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16) {
      tc::wgmma_m64n64k16_rs(dv, pn16[k16], mnmajor(x + kBox, k16), 1);
      tc::wgmma_m64n64k16_rs(dk, ds16[k16], mnmajor(x, k16), 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    if constexpr (R == 1) {  // one slot: it takes step s + 1 once dV and dK are done
      wg_sync(wg);
      if (wt == 0 && s + 1 < nck) issue(s + 1);
    }
  }
  tc::wgmma_wait<0>();
  tc::fence_operands(dk);
  tc::fence_operands(dv);

  const long long row3 = 3LL * h;
  bf16* db = a.dqkv + (long long)b * seq * row3 + hc;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!real[i]) continue;
    const long long t = k0 + 16 * warp + g + 8 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n0 = 4 * j + 2 * i, c = 8 * j + 2 * q;
      *reinterpret_cast<uint32_t*>(db + t * row3 + h + c) =
          tc::pack_bf16(__fmul_rn(dk[n0], a.nat), __fmul_rn(dk[n0 + 1], a.nat));
      *reinterpret_cast<uint32_t*>(db + t * row3 + 2 * h + c) = tc::pack_bf16(dv[n0], dv[n0 + 1]);
    }
  }
}

// ------------------------------------------------------------- host side
// The tensor maps of one call: qkv (rows of 3h) and dO (rows of h) bf16,
// 64 x 64 boxes in the 128-byte swizzle, token extent seq.
inline cudaError_t encode_maps(CUtensorMap* mq, CUtensorMap* mo, const void* qkv,
                               const void* dout, int batch, int seq, int nh) {
  const uint64_t h = (uint64_t)nh * kD;
  cudaError_t err = tc::encode_sw128_3d(mq, qkv, 3 * h, seq, batch, 3 * h * 2,
                                        (uint64_t)seq * 3 * h * 2, kD, kRows);
  if (err != cudaSuccess) return err;
  return tc::encode_sw128_3d(mo, dout, h, seq, batch, h * 2, (uint64_t)seq * h * 2, kD, kRows);
}

// Launch A, then launch B, of the stage set S: `rows` and `cols` are its
// two __global__ instantiations, `configured` their shared-memory
// attributes' flag. nh must be a multiple of S::kHeads.
template <class S, class Rows, class Cols>
cudaError_t launch(Rows rows, Cols cols, bool& configured, const void* qkv, const void* dout,
                   const void* sizes, void* dqkv, void* stats, int batch, int seq, int nh,
                   float qscale, float nat, cudaStream_t stream) {
  CUtensorMap mq, mo;
  cudaError_t err = encode_maps(&mq, &mo, qkv, dout, batch, seq, nh);
  if (err != cudaSuccess) return err;
  if (!configured) {
    err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)rows_smem_bytes<S>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cols_smem_bytes<S>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const Params p{static_cast<const float*>(sizes), static_cast<bf16*>(dqkv),
                 static_cast<float*>(stats), seq, nh, qscale, nat};
  const dim3 grid((seq + kRows - 1) / kRows, nh / S::kHeads, batch);
  rows<<<grid, kWgThreads * S::kHeads, rows_smem_bytes<S>(), stream>>>(mq, mo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols<<<grid, kWgThreads * S::kHeads, cols_smem_bytes<S>(), stream>>>(mq, mo, p);
  return cudaGetLastError();
}

}  // namespace gradbf
