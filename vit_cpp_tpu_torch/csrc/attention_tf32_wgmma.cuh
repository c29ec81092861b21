// K1's and K3's f32 body at d = 64, 80 and 88 for Hopper (sm_90a): the
// attention forward in 3xTF32 on wgmma, fed by TMA. attention_qkv.cu
// instantiates it (attention_tf32_wgmma) and sends it every f32 call with
// d = 64, 80 or 88 from both C entry points: any B, T and nh, fast and
// safe, with or without the key mask `kv` and ToMe sizes.
//
// Replaces, for those calls, the TPU kernels behind vit_cpp_tpu/ops/
// flash_attention.py::attention_qkv (the d = 64 pair kernel
// _qkv_pair_kernel, and _qkv_kernel + _sdpa at d = 80 and 88),
// _attention_qkv_lane (large T x h) and flash_attention (split heads,
// safe mode), as attention_qkv.cu's attention_tf32 body (3xTF32 on
// mma.sync) did before it. That body still serves f32 at every other d,
// and the checks reach it at d = 64, 80 and 88 through vit_attention_mma.
//
// What bounds it on this card. Two T x T x d products per head at the
// 3xTF32 rate (a third of TF32's, ~165 TFLOP/s) against the (B, T, 3h)
// read and (B, T, h) written: the operations (at ViT-H/14 B = 8, 0.016 ms
// of products against 0.006 ms of bytes). The mma.sync body ran at 7x
// (d = 64) and 10x (d = 80) that bound: each of its 8 warps loaded and
// split into TF32 hi / lo every K and V fragment it used (each tile split
// eight times) and issued three mma.sync.m16n8k8 per 16 x 8 x 8 step, so
// the SM's schedulers set its pace; at d = 80 its ring of f32 tiles took
// 129 KB, one block of 8 warps per SM. Here one warpgroup instruction
// multiplies 64 rows by up to 16 keys over 8 lanes from shared memory, or
// by d columns with A from registers, and each tile is split once.
//
// Design (K2's f32 body's tiling, tf32_wgmma.cuh):
// - A block is two warpgroups over 64 query rows of one (image, head).
//   The Q tile lands once by TMA; q * log2(e)/sqrt(d) is written back in
//   place (its own hi part) and its lo part beside it.
// - Keys stream in chunks of 16, warpgroup w taking chunks w, w + 2, ...
//   through its own ring of two slots (one mbarrier per slot, refilled by
//   the warpgroup's first thread once its S wgmmas are past the slot). A
//   landed chunk is split once: K's lo part beside it, V transposed hi and
//   lo (token-contiguous, the renumbered contraction index), as the tf32
//   forms have no transpose. While one warpgroup splits or takes its
//   softmax, the other's wgmmas run.
// - S = qs K^T: m64nNk8 (N = 8 or 16, the chunk's 8-key columns with a
//   real key), 3 d / 8 wgmmas, both operands as they land, in two chains
//   that alternate (the hi hi terms; the cross terms), added once in f32:
//   each chain's sums are truncated, and two chains keep two wgmmas in
//   flight. O += P V: P from the S accumulators in registers as A
//   fragments, split hi / lo there, V^T from shared memory; the chunk's
//   products sum into a part that one rounded f32 addition drains into O
//   (the tensor cores truncate each wgmma's sum).
// - Each warpgroup keeps its own softmax state over its chunks: in safe
//   mode an online row max m (the four lanes of a row agree on it after
//   each chunk), with o and l rescaled by exp2(m_old - m_new) when it
//   grows. At the end warpgroup 1's o, m and l meet warpgroup 0's through
//   shared memory: m = max(m0, m1), o = o0 2^(m0 - m) + o1 2^(m1 - m), and
//   the same for l (fast mode: o0 + o1, l0 + l1), in a fixed order.
// - A d = 80 row is 2.5 rows of the 128-byte swizzle: tiles at d = 80 land
//   in five 64-byte boxes (the 64-byte swizzle), and their k steps read
//   that layout's descriptors; V^T's rows of 16 keys are 64 bytes, in the
//   same swizzle. A d = 88 row (88 = 5 x 16 + 8) lands in five 64-byte
//   boxes and a 32-byte tail box (the 32-byte swizzle, a map of its own),
//   the last k step. Shared memory: 89 KB at
//   d = 64, 111 KB at d = 80, two blocks per SM, so that one block's
//   loads, splits and epilogue overlap the other's products; at d = 88 a
//   ring of one chunk slot per warpgroup keeps two blocks (100 KB; a ring
//   of two takes 122 KB, one block): a chunk's TMA is issued once the
//   slot's S is done and waits behind the softmax and P V.
// - The output is written from the accumulators of warpgroup 0 in 8-byte
//   stores, o / l by a correctly rounded division; rows at or past kv are
//   zeros, rows past seq are not written, and a tile wholly past kv
//   writes zeros and loads nothing.
// - T = 257 (ViT-H/14) is 4 x 64 + 1 query rows: its fifth tile holds one
//   real row and costs a whole block; an H100 ran B = 8 in 0.0666 ms at T
//   = 256 and 0.0984 at T = 257 (PERF.md).
// - A barrier wait that outlasts seconds traps (tc::mbar_wait_or_trap).
//
// Numerics (attention_qkv.cu's contract for f32): Q scaled by qscale in
// f32; fast: p = exp2(min(s, 120)), no row max; safe: one pass with the
// online max; p times the key mask and sizes[key]; l = sum p in f32; o / l
// by __fdiv_rn; query rows >= kv are zeros. Products in 3xTF32 as K2's
// body: hi the operand the tensor cores truncate, lo = tf32(x - trunc(x)),
// the terms lo hi, hi lo, hi hi per k step.

#pragma once

#include <cuda.h>
#include <stdint.h>

#include "attention_body.cuh"
#include "attention_wgmma.cuh"
#include "tf32_wgmma.cuh"

namespace fwdwg {

using namespace tf32wg;

// 16-key chunks, two blocks per SM (89 KB of shared memory at d = 64, 111
// KB at d = 80, at most 128 registers a thread). On an H100 this ran
// faster than 32-key chunks at one block per SM (145 / 181 KB) at
// ViT-B/16 B = 32 and ViT-H/14 B = 128, a little slower at ViT-H/14 B = 8
// and --patch-size 8 B = 8. At d = 88 a ring of one slot per warpgroup
// keeps two blocks per SM (100 KB); a ring of two (122 KB, one block per
// SM) ran 1.21x (B = 8) and 1.47x (B = 64) slower at ViT-g/14's T = 257.
constexpr int kChunkK1 = 16;
constexpr int kBlocksPerSm = 2;
template <int D>
constexpr int kRingK1 = D == 88 ? 1 : 2;

template <int D>
using G = Geo<D, kChunkK1, kRingK1<D>>;

constexpr int kRows = 64;     // query rows per block: wgmma's M
constexpr int kThreads = 256;  // two warpgroups

// The head dimensions the body takes.
__host__ __device__ constexpr bool takes(int d) { return d == 64 || d == 80 || d == 88; }

// Per warpgroup: its ring of (K, V) chunks, K's lo part, V^T hi and lo.
template <int D>
__host__ __device__ constexpr int wg_bytes() {
  return G<D>::kRing * 2 * G<D>::kStr + G<D>::kStr + 2 * G<D>::kTr;
}

// Dynamic shared memory: the Q tile (hi, then lo), then each warpgroup's,
// from a 1024-aligned base (+ 1024 for the alignment).
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + 2 * G<D>::kRes + G<D>::kWgs * wg_bytes<D>();
}

// The operands of one launch besides its tensor maps: where a (batch,
// head)'s tiles lie in them, the ToMe sizes (B, seq) or null, the output
// and its (batch, head, token) strides, the geometry.
struct Params {
  attn::WgCoords co;
  const float* sizes;
  float* out;
  attn::Strides os;
  int seq, kv;
  float qscale;
};

// A chunk's p in place of its S (the thread's 8 NT columns c0 + 8 j + 2 q
// + (e & 1)), l += p, after (safe mode) the online max's step: the chunk's
// row max over its real keys, and o and l rescaled when it grows. kMask:
// the chunk holds keys >= kv, which weigh 0.
template <int NT, int D, bool kFast, bool kSizes, bool kMask>
__device__ __forceinline__ void online_softmax(float (&sa)[4 * NT], float (&m)[2],
                                               float (&l)[2], float (&o)[D / 2], int c0, int q,
                                               int kv, const float* __restrict__ sz) {
  if constexpr (!kFast) {
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!kMask || c0 + 8 * j + 2 * q + (e & 1) < kv)
          mt[e >> 1] = fmaxf(mt[e >> 1], sa[4 * j + e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      if (mt[i] > m[i]) {  // exp2(-inf) = 0 on the first chunk, where o and l are 0
        const float alpha = exp2f(__fsub_rn(m[i], mt[i]));
        l[i] = __fmul_rn(l[i], alpha);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * i] = __fmul_rn(o[4 * j + 2 * i], alpha);
          o[4 * j + 2 * i + 1] = __fmul_rn(o[4 * j + 2 * i + 1], alpha);
        }
        m[i] = mt[i];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = c0 + 8 * j + 2 * q + (e & 1);
      float p = 0.f;
      if (!kMask || key < kv) {
        p = exp2f(kFast ? fminf(sa[4 * j + e], 120.f) : __fsub_rn(sa[4 * j + e], m[e >> 1]));
        if constexpr (kSizes) p = __fmul_rn(p, __ldg(sz + key));
      }
      l[e >> 1] = __fadd_rn(l[e >> 1], p);
      sa[4 * j + e] = p;
    }
}

// One block per (batch, head, 64-query tile). The maps: Q in 64-row boxes,
// K and V in 16-row ones (for fused qkv, one tensor at three column
// offsets); their token extent is kv, so keys and query rows at or past
// kv land as zeros. With a tail box (d = 88), `tails` holds Q's, K's and
// V's tail maps.
template <int D, bool kFast, bool kSizes>
__device__ __forceinline__ void attention_tf32_wgmma_body(const CUtensorMap& qmap,
                                                          const CUtensorMap& kmap,
                                                          const CUtensorMap& vmap,
                                                          const Params& a,
                                                          const CUtensorMap* tails = nullptr) {
  using g_ = G<D>;
  constexpr int kRing = g_::kRing, kWgs = g_::kWgs, kRes = g_::kRes, kStr = g_::kStr;
  constexpr int kTr = g_::kTr, kChunk = g_::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[1 + kWgs * kRing];  // the Q tile; each warpgroup's slots
  __shared__ float xst[kRows][2];              // warpgroup 1's row max and sum p
  unsigned char* sm = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = sm;  // qs (its own hi part), then its lo part
  unsigned char* sQlo = sm + kRes;

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kRows;
  const int seq = a.seq, kv = a.kv;
  const int z = b * a.co.z_batch + head * a.co.z_head, hc = head * a.co.head_c;
  float* ob = a.out + b * a.os.batch + head * a.os.head;

  if (q0 >= kv) {  // every row of this tile is token padding: zeros
    for (int idx = tid; idx < kRows * (D / 4); idx += kThreads) {
      const int r = idx / (D / 4), c = idx - r * (D / 4);
      if (q0 + r < seq)
        *reinterpret_cast<float4*>(ob + (q0 + r) * a.os.token + 4 * c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  unsigned char* wb = sm + 2 * kRes + wg * wg_bytes<D>();
  auto slot = [&](int r) { return wb + r * 2 * kStr; };  // K, then V
  unsigned char* sKlo = wb + kRing * 2 * kStr;
  unsigned char* sVth = sKlo + kStr;
  unsigned char* sVtl = sVth + kTr;
  uint64_t* rbar = bars + 1 + wg * kRing;
  // this warpgroup's chunks wg, wg + 2, ...
  const int nch = (kv + kChunk - 1) / kChunk;
  const int nwc = nch > wg ? (nch - wg + 1) / 2 : 0;
  const float* sz = kSizes ? a.sizes + (size_t)b * seq : nullptr;

  auto issue = [&](int s) {  // the warpgroup's first thread: step s's K and V
    const int c0 = kChunk * (wg + 2 * s), r = s % kRing;
    unsigned char* k = slot(r);
    tc::mbar_arrive_expect_tx(&rbar[r], 2 * kStr);
    load_tile<g_, g_::kStrBox>(k, &kmap, a.co.k + hc, c0, z, &rbar[r], tails + 1);
    load_tile<g_, g_::kStrBox>(k + kStr, &vmap, a.co.v + hc, c0, z, &rbar[r], tails + 2);
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + kWgs * kRing; ++i) tc::mbar_init(&bars[i], 1);
    tc::fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_arrive_expect_tx(&bars[0], kRes);
    load_tile<g_, g_::kResBox>(sQ, &qmap, a.co.q + hc, q0, z, &bars[0], tails);
  }
  if (wt == 0)
    for (int s = 0; s < kRing && s < nwc; ++s) issue(s);
  tc::mbar_wait_or_trap(&bars[0], 0);
  split_resident<g_, true>(sQ, sQlo, a.qscale);
  tc::fence_proxy_async();
  __syncthreads();

  // rows g and g + 8 of the warp's 16: running max (safe) and this lane's
  // part of the row sum; o the warpgroup's 64 x D output, unnormalized
  float m[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
  float l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int s = 0; s < nwc; ++s) {
    const int c0 = kChunk * (wg + 2 * s);
    // step s's K and V landed, split (V transposed), fenced for the tensor
    // cores; the warpgroup is past step s - 1's products
    wg_sync(wg);
    tc::mbar_wait_or_trap(&rbar[s % kRing], (s / kRing) & 1);
    unsigned char* k = slot(s % kRing);
    split_stream<g_, false, false>(k, sKlo, nullptr, nullptr, 0.f, wt);
    split_stream<g_, true, false, false>(k + kStr, nullptr, sVth, sVtl, 0.f, wt);
    tc::fence_proxy_async();
    wg_sync(wg);
    with_nt<kChunk / 8>(min(kChunk / 8, (kv - c0 + 7) >> 3), [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      float sa[4 * NT], sx[4 * NT];
      tc::wgmma_fence();
      score<g_, NT>(sa, sx, sQ, sQlo, k, sKlo);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_each(sa);
      tc::fence_each(sx);
#pragma unroll
      for (int i = 0; i < 4 * NT; ++i) sa[i] = __fadd_rn(sa[i], sx[i]);
      wg_sync(wg);  // every warp's wgmmas are past the slot
      if (wt == 0 && s + kRing < nwc) issue(s + kRing);
      if (c0 + 8 * NT <= kv)
        online_softmax<NT, D, kFast, kSizes, false>(sa, m, l, o, c0, q, kv, sz);
      else
        online_softmax<NT, D, kFast, kSizes, true>(sa, m, l, o, c0, q, kv, sz);
      // O += P V over the chunk's live 8-key steps
      uint32_t fa[1][NT][8];
      fragments<NT>(fa[0], sa);
      float part[1][D / 2];
      tc::wgmma_fence();
      contract<g_, NT, 1>(part, fa, {sVth}, {sVtl});
      drain<1>({o}, part);
    });
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the four lanes of a row
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
  }

  // warpgroup 1's o (in its own slots, idle now), m and l to shared
  // memory; warpgroup 0 adds them to its own and writes the rows
  float* xo = reinterpret_cast<float*>(sm + 2 * kRes + wg_bytes<D>());
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) xo[i * 128 + wt] = o[i];
    if (q == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xst[16 * warp + g + 8 * i][0] = m[i];
        xst[16 * warp + g + 8 * i][1] = l[i];
      }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + g + 8 * i, t = q0 + r;
    if (t >= seq) continue;
    const bool real = t < kv;
    float s0 = 1.f, s1 = 1.f;
    if constexpr (!kFast) {
      const float mx = fmaxf(m[i], xst[r][0]);  // warpgroup 0 holds chunk 0: finite
      s0 = exp2f(__fsub_rn(m[i], mx));
      s1 = exp2f(__fsub_rn(xst[r][0], mx));
    }
    const float lt = __fadd_rn(__fmul_rn(l[i], s0), __fmul_rn(xst[r][1], s1));
    float* row = ob + (long long)t * a.os.token;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int n0 = 4 * j + 2 * i;
      const float x = __fadd_rn(__fmul_rn(o[n0], s0), __fmul_rn(xo[n0 * 128 + wt], s1));
      const float y = __fadd_rn(__fmul_rn(o[n0 + 1], s0), __fmul_rn(xo[(n0 + 1) * 128 + wt], s1));
      *reinterpret_cast<float2*>(row + 8 * j + 2 * q) =
          real ? make_float2(__fdiv_rn(x, lt), __fdiv_rn(y, lt)) : make_float2(0.f, 0.f);
    }
  }
}

}  // namespace fwdwg
