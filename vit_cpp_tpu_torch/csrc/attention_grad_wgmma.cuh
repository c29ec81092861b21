// K2's f32 body at d = 64, 80 and 88 for Hopper (sm_90a): the attention
// backward in 3xTF32 on wgmma, fed by TMA. attention_qkv_grad.cu
// instantiates it (grad_rows_wgmma, grad_cols_wgmma at d = 64;
// grad_rows_wgmma80, grad_cols_wgmma80 at d = 80; grad_rows_wgmma88,
// grad_cols_wgmma88 at d = 88) and sends it every f32 call with d = 64,
// 80 or 88: any B, T and nh, with or without ToMe sizes.
//
// Replaces, for those calls, the TPU kernels behind vit_cpp_tpu/ops/
// flash_attention.py::_attention_qkv_grad (:1214; the d = 64 pair kernel
// _qkv_grad_pair_kernel, _qkv_grad_kernel + _qkv_grad_head at d = 80 and
// 88) and _attention_qkv_grad_lane (:1113; large T x h), as the mma.sync
// body of attention_grad_body.cuh did before it (that body still serves
// bf16 and every other d, and the checks reach it at d = 64, 80 and 88
// through vit_attention_qkv_grad_mma).
//
// What bounds it on this card. Five T x T x d products per head at the
// 3xTF32 rate (a third of TF32's, ~165 TFLOP/s) against ~2 MB of qkv, dO
// and dqkv per ViT-B/16 image and layer: the operations. The mma.sync body
// ran at ~9% of that bound at B = 32, T = 197: each of its four warps
// loaded and split into TF32 hi / lo every K / V (launch A) or Q / dO
// (launch B) fragment it used, and issued three mma.sync.m16n8k8 per
// 16 x 8 x 8 step, so the SM's schedulers set its pace. Here one
// warpgroup instruction multiplies 64 rows by up to 32 tokens over 8
// lanes, reading both operands from shared memory (or A from registers),
// and each tile is split once, in shared memory.
//
// Design (the two launches, the workspace and the numerics are the
// mma.sync body's, attention_qkv_grad.cu):
// - A block is two warpgroups (256 threads) over one (image, head) and 64
//   resident rows, wgmma's M: queries in launch A, keys in launch B.
//   The resident tiles (qs and dO in A; K and V in B) land once by TMA,
//   each with its TF32 lo part split out beside it: 64 KB.
//   The other tokens stream in chunks of 32, warpgroup w taking chunks w,
//   w + 2, ..., each through its own ring of two chunk slots (TMA, one
//   mbarrier per slot, refilled by the warpgroup's first thread once its
//   wgmmas are past the slot). While one warpgroup splits or takes its
//   softmax, the other's wgmmas run: the two share the SM as two blocks
//   would, but the resident tiles are loaded and split once. One block
//   per SM (launch A 193 KB of shared memory, B 225 KB).
// - d = 80 and 88 take their own plan (GA, GB below): their tiles are
//   1.25x and 1.375x d = 64's, and the plan above would need 241 and 281
//   KB at d = 80. Launch A streams 32-token chunks through a ring of one
//   slot per warpgroup (201 KB at d = 80, 221 KB at d = 88: a chunk's TMA
//   waits for the slot's S and dP, and the other warpgroup's work covers
//   it); launch B 16-token chunks through a ring of two (181 and 199 KB),
//   whose transposed copies are rows of 64 bytes. 16-token chunks in
//   launch A as well ran slower on an H100 at d = 80: twice the wgmmas
//   per token, each half as wide.
// - Launch A (dq and the row statistics): pass 1 over the warpgroup's
//   chunks keeps the online max, sum p and sum dp p per row; the two
//   warpgroups' partial statistics meet in shared memory; pass 2 streams
//   the chunks again and accumulates dQ = dS K. The warpgroups' dQ
//   partials are added in a fixed order (deterministic).
// - Launch B (dk, dv): per chunk of queries, S^T = K qs^T and dP^T = V
//   dO^T, pn and ds from the stored statistics, dV += Pn^T dO and dK +=
//   dS^T q; the two partials added as in A.
// - Every tile arrives by TMA over a 3-D map (columns, tokens, images)
//   whose token extent is T: rows past the sequence load as zeros and a
//   box never reaches the next image. A d = 64 row is two boxes of 32
//   floats in the 128-byte swizzle, a d = 80 row (2.5 rows of that
//   swizzle) five boxes of 16 floats in the 64-byte swizzle, a d = 88 row
//   (88 = 5 x 16 + 8) eleven boxes of 8 floats in the 32-byte swizzle, one
//   k step each; each k step reads its layout's descriptors
//   (tf32_wgmma.cuh).
// - S and dP (S^T, dP^T) contract over d and read both operands as they
//   land (K-major): wgmma.m64nNk8 with N = 8 to 32 (a chunk's last 8-token
//   columns with a real token), 3 d / 8 per product (d / 8 k steps, three
//   TF32 terms each: lo hi, hi lo, hi hi; launch B mirrors the cross terms'
//   order, so that its S^T sums the terms of A's S in A's order). One
//   chain of small tf32 wgmmas is bound by their latency more than by the
//   tensor cores' rate (an H100 ran m64n32k8 at 183 TFLOP/s as one chain
//   per warpgroup, 245 as two), so S and dP (and dV and dK) alternate
//   instruction by instruction, two chains in flight. (Each product split
//   into a hi hi chain and a cross chain, four in flight, ran no faster at
//   d = 80.) At d = 80 and 88 the descriptors of a product's eight tiles
//   are made once per step and moved by one addition per k step: launch
//   A's ring of one slot makes every address loop-invariant, and the 80
//   hoisted descriptors spilled registers.
// - dQ = dS K, dV = Pn^T dO and dK = dS^T q contract over tokens. The tf32
//   forms have no transpose, so their B operands (K; dO and q) need
//   token-contiguous copies: the split pass writes them, transposed, hi
//   and lo, in the same pass that splits the landed tile, so the
//   transpose costs no pass of its own. Their A operands (dS, Pn, dS^T)
//   come from the S / dP accumulators in registers, split there: the
//   accumulator holds columns 2q, 2q + 1 of each 8-token step and the tf32
//   A fragment columns q, q + 4, so the contraction index is renumbered
//   (as the mma.sync body does) and the transposed copies store, within
//   each group of 8 tokens, token 2p at position p and token 2p + 1 at
//   position p + 4.
// - The tensor cores truncate each wgmma's sum (dequant_matmul.cu's f32
//   body): each chunk's token products (up to 4 k steps, 12 wgmmas) sum
//   into `part`, which is then added to the f32 accumulator by a rounded
//   addition, so at T = 785 25 rounded additions take the place of 300
//   truncations.
// - The tensor cores read a tf32 operand's top 19 bits: they truncate an
//   f32 to TF32. So a landed tile serves as its own hi part (only a scaled
//   qs tile is written back), and lo = tf32(x - trunc(x)) (split_trunc).
//   What 3xTF32 then drops is ~2^-21 of |x| per operand (rounding hi to
//   nearest, ~2^-22, cost an in-place pass and ran 4% slower on an H100).
// - A barrier wait that outlasts seconds traps (tc::mbar_wait_or_trap).
//
// Numerics (attention_qkv_grad.cu's contract): qs = q * log2(e)/sqrt(d)
// in f32; exp2 of s - max; __fmul_rn / __fsub_rn in the softmax and
// dsoftmax chains; one reciprocal of sum p per row; sizes as key weights
// on p; pad keys p = 0 and pad queries pn = 0; dq and dk times 1/sqrt(d).

#pragma once

#include <cuda.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace gradwg {

using namespace tf32wg;

// K2's tilings, launch A's (GA) and launch B's (GB): at d = 64 32-token
// chunks in rings of two, in the 128-byte swizzle; at d = 80 (in the
// 64-byte swizzle) and 88 (in the 32-byte one), launch A 32-token chunks
// in rings of one and launch B 16-token chunks in rings of two (at d = 80
// with 32 tokens in rings of two they would need 241 and 281 KB of shared
// memory). With 16-token chunks in both launches an H100 ran d = 80 at
// ViT-H/14 B = 8 (B = 128) in 0.524 (7.657) ms, slower than the mma.sync
// body at B = 128.
template <int D>
using GA = Geo<D, 32, D == 64 ? 2 : 1>;
template <int D>
using GB = Geo<D, D == 64 ? 32 : 16, 2>;

constexpr int kRows = 64;     // resident rows per block: wgmma's M
constexpr int kThreads = 256;  // two warpgroups

// Per warpgroup. Launch A: its ring of (K, V) chunks, K and V lo, K^T hi
// and lo. Launch B: its ring of (q, dO) chunks, qs and dO lo, dO^T hi and
// lo, q^T hi and lo.
template <int D>
__host__ __device__ constexpr int wg_rows_bytes() {
  return GA<D>::kRing * 2 * GA<D>::kStr + 2 * GA<D>::kStr + 2 * GA<D>::kTr;
}
template <int D>
__host__ __device__ constexpr int wg_cols_bytes() {
  return GB<D>::kRing * 2 * GB<D>::kStr + 2 * GB<D>::kStr + 4 * GB<D>::kTr;
}

// Dynamic shared memory: the four resident tiles (hi and lo of two), then
// each warpgroup's, from a 1024-aligned base (+ 1024 for the alignment):
// at d = 64 193 and 225 KB, at d = 80 201 and 181 KB, at d = 88 221 and 199
// KB (226,304 and 203,776 bytes; a block may take 232,448 with its static
// barriers and statistics).
template <int D>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  return 1024 + 4 * GA<D>::kRes + GA<D>::kWgs * wg_rows_bytes<D>();
}
template <int D>
__host__ __device__ constexpr size_t cols_smem_bytes() {
  return 1024 + 4 * GB<D>::kRes + GB<D>::kWgs * wg_cols_bytes<D>();
}

// The operands of one call besides its tensor maps.
struct Params {
  const float* sizes;  // (B, T) or null
  float* dqkv;         // (B, T, 3h)
  float* stats;        // (B, nh, T, 3): row max, 1 / sum p, r
  int seq, nh;
  float qscale, nat;
};

// ------------------------------------------------------------- launch A
// One block per (batch, head, 64-query tile) -> dq, row statistics. The
// maps: qkv in resident boxes (64 rows) and streamed ones (kChunk rows),
// dO in resident ones.
template <int D>
__device__ __forceinline__ void grad_rows_body(const CUtensorMap& qkv_res,
                                               const CUtensorMap& qkv_str,
                                               const CUtensorMap& do_res, const Params& a,
                                               const CUtensorMap* tails = nullptr) {
  using g_ = GA<D>;
  constexpr int kRing = g_::kRing, kWgs = g_::kWgs, kRes = g_::kRes, kStr = g_::kStr;
  constexpr int kTr = g_::kTr, kChunk = g_::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[1 + kWgs * kRing];  // resident tiles; each warpgroup's slots
  __shared__ float xst[kWgs][kRows][3];        // each warpgroup's row max, sum p, sum dp p
  static_assert(rows_smem_bytes<D>() + sizeof(bars) + sizeof(xst) <= 232448, "shared memory");
  unsigned char* sm = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = sm;  // qs (its own hi part), its lo part; dO, its lo part
  unsigned char* sQlo = sm + kRes;
  unsigned char* sO = sm + 2 * kRes;
  unsigned char* sOlo = sm + 3 * kRes;

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kRows;
  const int seq = a.seq, h = a.nh * D, hc = head * D;
  unsigned char* wb = sm + 4 * kRes + wg * wg_rows_bytes<D>();
  auto slot = [&](int r) { return wb + r * 2 * kStr; };  // K, then V
  unsigned char* sKlo = wb + kRing * 2 * kStr;
  unsigned char* sVlo = sKlo + kStr;
  unsigned char* sKth = sVlo + kStr;
  unsigned char* sKtl = sKth + kTr;
  uint64_t* rbar = bars + 1 + wg * kRing;
  // this warpgroup's chunks wg, wg + 2, ...: pass 1's steps, then pass 2's
  const int nch = (seq + kChunk - 1) / kChunk;
  const int nwc = nch > wg ? (nch - wg + 1) / 2 : 0;
  const int nsteps = 2 * nwc;
  const float* sz = a.sizes == nullptr ? nullptr : a.sizes + (size_t)b * seq;

  auto chunk0 = [&](int s) { return kChunk * (wg + 2 * (s < nwc ? s : s - nwc)); };
  auto issue = [&](int s) {  // the warpgroup's first thread: step s's K and V
    const int c0 = chunk0(s), r = s % kRing;
    unsigned char* k = slot(r);
    tc::mbar_arrive_expect_tx(&rbar[r], 2 * kStr);
    load_tile<g_, g_::kStrBox>(k, &qkv_str, h + hc, c0, b, &rbar[r], tails + 1);
    load_tile<g_, g_::kStrBox>(k + kStr, &qkv_str, 2 * h + hc, c0, b, &rbar[r], tails + 1);
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + kWgs * kRing; ++i) tc::mbar_init(&bars[i], 1);
    tc::fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_arrive_expect_tx(&bars[0], 2 * kRes);
    load_tile<g_, g_::kResBox>(sQ, &qkv_res, hc, q0, b, &bars[0], tails);
    load_tile<g_, g_::kResBox>(sO, &do_res, hc, q0, b, &bars[0], tails + 2);
  }
  if (wt == 0)
    for (int s = 0; s < kRing && s < nsteps; ++s) issue(s);
  tc::mbar_wait_or_trap(&bars[0], 0);
  split_resident<g_, true>(sQ, sQlo, a.qscale);
  split_resident<g_, false>(sO, sOlo, 0.f);
  tc::fence_proxy_async();
  __syncthreads();

  // step s's K and V landed, split (K also transposed in pass 2), fenced
  // for the tensor cores; the warpgroup is past step s - 1
  auto stream_in = [&](int s, bool transpose) {
    wg_sync(wg);
    tc::mbar_wait_or_trap(&rbar[s % kRing], (s / kRing) & 1);
    unsigned char* k = slot(s % kRing);
    if (transpose)
      split_stream<g_, true, false>(k, sKlo, sKth, sKtl, 0.f, wt);
    else
      split_stream<g_, false, false>(k, sKlo, nullptr, nullptr, 0.f, wt);
    split_stream<g_, false, false>(k + kStr, sVlo, nullptr, nullptr, 0.f, wt);
    tc::fence_proxy_async();
    wg_sync(wg);
  };
  // S and dP of step s, waited; then the slot takes step s + kRing
  auto products = [&](auto nt, int s, auto& sa, auto& pa) {
    constexpr int NT = decltype(nt)::value;
    const unsigned char* k = slot(s % kRing);
    tc::wgmma_fence();
    scores<g_, NT, false>(sa, pa, sQ, sQlo, k, sKlo, sO, sOlo, k + kStr, sVlo);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_each(sa);
    tc::fence_each(pa);
    wg_sync(wg);  // every warp's wgmmas are past the slot
    if (wt == 0 && s + kRing < nsteps) issue(s + kRing);
  };

  // rows g and g + 8 of the warp's 16: running max, sum p, sum dp p; then
  // the row's max, 1 / sum p and r
  float m[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
  float l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f}, r[2];

  // pass 1: the statistics
  for (int s = 0; s < nwc; ++s) {
    const int c0 = chunk0(s);
    stream_in(s, false);
    with_nt<kChunk / 8>(min(kChunk / 8, (seq - c0 + 7) >> 3), [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      float sa[4 * NT], pa[4 * NT];
      products(nt, s, sa, pa);
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + 2 * q + (e & 1) < seq) mt[e >> 1] = fmaxf(mt[e >> 1], sa[4 * j + e]);
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
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + 8 * j + 2 * q + (e & 1);
          if (key >= seq) continue;
          float p = exp2f(__fsub_rn(sa[4 * j + e], m[e >> 1]));
          if (sz != nullptr) p = __fmul_rn(p, sz[key]);
          l[e >> 1] = __fadd_rn(l[e >> 1], p);
          u[e >> 1] = fmaf(pa[4 * j + e], p, u[e >> 1]);
        }
    });
  }

  // the four lanes of a row, then the two warpgroups: common max,
  // rescaled sums, then 1 / sum p and r (warpgroup 0's part first)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i], lt = 0.f, ut = 0.f;
    if (nwc > 0) {  // some lane of the row holds a key of every chunk
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float sc = exp2f(__fsub_rn(m[i], mx));  // 0 for a lane with no key
      lt = __fmul_rn(l[i], sc);
      ut = __fmul_rn(u[i], sc);
      lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
      lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
      ut = __fadd_rn(ut, __shfl_xor_sync(0xffffffffu, ut, 1));
      ut = __fadd_rn(ut, __shfl_xor_sync(0xffffffffu, ut, 2));
    }
    if (q == 0) {
      float* x = xst[wg][16 * warp + g + 8 * i];
      x[0] = mx, x[1] = lt, x[2] = ut;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* x0 = xst[0][16 * warp + g + 8 * i];  // chunk 0's warpgroup: a finite max
    const float* x1 = xst[1][16 * warp + g + 8 * i];
    const float mx = fmaxf(x0[0], x1[0]);
    const float s0 = exp2f(__fsub_rn(x0[0], mx)), s1 = exp2f(__fsub_rn(x1[0], mx));
    const float lt = __fadd_rn(__fmul_rn(x0[1], s0), __fmul_rn(x1[1], s1));
    const float ut = __fadd_rn(__fmul_rn(x0[2], s0), __fmul_rn(x1[2], s1));
    m[i] = mx;
    l[i] = __frcp_rn(lt);
    r[i] = __fdiv_rn(ut, lt);
  }

  // pass 2: dS, then dQ += dS K chunk by chunk
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int s = nwc; s < nsteps; ++s) {
    const int c0 = chunk0(s);
    stream_in(s, true);
    with_nt<kChunk / 8>(min(kChunk / 8, (seq - c0 + 7) >> 3), [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      float sa[4 * NT], pa[4 * NT];
      products(nt, s, sa, pa);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + 8 * j + 2 * q + (e & 1), i = e >> 1;
          float ds = 0.f;
          if (key < seq) {
            float p = exp2f(__fsub_rn(sa[4 * j + e], m[i]));
            if (sz != nullptr) p = __fmul_rn(p, sz[key]);
            const float pn = __fmul_rn(p, l[i]);
            ds = __fmul_rn(pn, __fsub_rn(pa[4 * j + e], r[i]));
          }
          sa[4 * j + e] = ds;
        }
      uint32_t fa[1][NT][8];
      fragments<NT>(fa[0], sa);
      float part[1][D / 2];
      tc::wgmma_fence();
      contract<g_, NT, 1>(part, fa, {sKth}, {sKtl});
      drain<1>({acc}, part);
    });
  }

  // warpgroup 1's dQ to shared memory (its own slots, idle now), added to
  // warpgroup 0's; warpgroup 0 writes dq and the statistics
  float* xq = reinterpret_cast<float*>(sm + 4 * kRes + wg_rows_bytes<D>());
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) xq[i * 128 + wt] = acc[i];
  }
  __syncthreads();
  if (wg == 1) return;
  const long long row3 = 3LL * h;
  float* dqb = a.dqkv + (long long)b * seq * row3 + hc;
  float* st = a.stats + ((long long)b * a.nh + head) * seq * 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + 16 * warp + g + 8 * i;
    if (t >= seq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x = __fadd_rn(acc[4 * j + 2 * i], xq[(4 * j + 2 * i) * 128 + wt]);
      const float y = __fadd_rn(acc[4 * j + 2 * i + 1], xq[(4 * j + 2 * i + 1) * 128 + wt]);
      *reinterpret_cast<float2*>(dqb + (long long)t * row3 + 8 * j + 2 * q) =
          make_float2(__fmul_rn(x, a.nat), __fmul_rn(y, a.nat));
    }
    if (q == 0) {
      st[(long long)t * 3 + 0] = m[i];
      st[(long long)t * 3 + 1] = l[i];
      st[(long long)t * 3 + 2] = r[i];
    }
  }
}

// ------------------------------------------------------------- launch B
// One block per (batch, head, 64-key tile) -> dk, dv. The maps: qkv in
// resident boxes and streamed ones, dO in streamed ones.
template <int D>
__device__ __forceinline__ void grad_cols_body(const CUtensorMap& qkv_res,
                                               const CUtensorMap& qkv_str,
                                               const CUtensorMap& do_str, const Params& a,
                                               const CUtensorMap* tails = nullptr) {
  using g_ = GB<D>;
  constexpr int kRing = g_::kRing, kWgs = g_::kWgs, kRes = g_::kRes, kStr = g_::kStr;
  constexpr int kTr = g_::kTr, kChunk = g_::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[1 + kWgs * kRing];
  unsigned char* sm = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sm;  // K (its own hi part), its lo part; V, its lo part
  unsigned char* sKlo = sm + kRes;
  unsigned char* sV = sm + 2 * kRes;
  unsigned char* sVlo = sm + 3 * kRes;

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, head = blockIdx.y, k0 = blockIdx.x * kRows;
  const int seq = a.seq, h = a.nh * D, hc = head * D;
  unsigned char* wb = sm + 4 * kRes + wg * wg_cols_bytes<D>();
  auto slot = [&](int r) { return wb + r * 2 * kStr; };  // q (then qs hi), then dO
  unsigned char* sQslo = wb + kRing * 2 * kStr;
  unsigned char* sOlo = sQslo + kStr;
  unsigned char* sOth = sOlo + kStr;
  unsigned char* sOtl = sOth + kTr;
  unsigned char* sQth = sOtl + kTr;
  unsigned char* sQtl = sQth + kTr;
  uint64_t* rbar = bars + 1 + wg * kRing;
  const int nch = (seq + kChunk - 1) / kChunk;
  const int nwc = nch > wg ? (nch - wg + 1) / 2 : 0;
  const float* st = a.stats + ((long long)b * a.nh + head) * seq * 3;

  auto issue = [&](int s) {  // the warpgroup's first thread: step s's q and dO
    const int c0 = kChunk * (wg + 2 * s), r = s % kRing;
    unsigned char* x = slot(r);
    tc::mbar_arrive_expect_tx(&rbar[r], 2 * kStr);
    load_tile<g_, g_::kStrBox>(x, &qkv_str, hc, c0, b, &rbar[r], tails + 1);
    load_tile<g_, g_::kStrBox>(x + kStr, &do_str, hc, c0, b, &rbar[r], tails + 2);
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + kWgs * kRing; ++i) tc::mbar_init(&bars[i], 1);
    tc::fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_arrive_expect_tx(&bars[0], 2 * kRes);
    load_tile<g_, g_::kResBox>(sK, &qkv_res, h + hc, k0, b, &bars[0], tails);
    load_tile<g_, g_::kResBox>(sV, &qkv_res, 2 * h + hc, k0, b, &bars[0], tails);
  }
  if (wt == 0)
    for (int s = 0; s < kRing && s < nwc; ++s) issue(s);
  tc::mbar_wait_or_trap(&bars[0], 0);
  split_resident<g_, false>(sK, sKlo, 0.f);
  split_resident<g_, false>(sV, sVlo, 0.f);
  tc::fence_proxy_async();
  __syncthreads();

  bool real[2];
  float w[2];  // sizes of this thread's keys (rows g, g + 8)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * warp + g + 8 * i;
    real[i] = key < seq;
    w[i] = (a.sizes == nullptr || !real[i]) ? 1.f : a.sizes[(long long)b * seq + key];
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int s = 0; s < nwc; ++s) {
    const int c0 = kChunk * (wg + 2 * s);
    with_nt<kChunk / 8>(min(kChunk / 8, (seq - c0 + 7) >> 3), [&](auto nt) {
      constexpr int NT = decltype(nt)::value;
      // the statistics of this thread's query columns c0 + 8 j + 2 q + e
      float sx[NT][2], sl[NT][2], sr[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = c0 + 8 * j + 2 * q + e;
          const bool in = t < seq;
          sx[j][e] = in ? __ldg(st + 3LL * t) : 0.f;
          sl[j][e] = in ? __ldg(st + 3LL * t + 1) : 0.f;
          sr[j][e] = in ? __ldg(st + 3LL * t + 2) : 0.f;
        }
      wg_sync(wg);  // the warpgroup is past step s - 1
      tc::mbar_wait_or_trap(&rbar[s % kRing], (s / kRing) & 1);
      unsigned char* x = slot(s % kRing);
      split_stream<g_, true, true>(x, sQslo, sQth, sQtl, a.qscale, wt);
      split_stream<g_, true, false>(x + kStr, sOlo, sOth, sOtl, 0.f, wt);
      tc::fence_proxy_async();
      wg_sync(wg);

      float sa[4 * NT], pa[4 * NT];
      tc::wgmma_fence();
      scores<g_, NT, true>(sa, pa, sK, sKlo, x, sQslo, sV, sVlo, x + kStr, sOlo);
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_each(sa);
      tc::fence_each(pa);
      wg_sync(wg);  // every warp's wgmmas are past the slot
      if (wt == 0 && s + kRing < nwc) issue(s + kRing);

      // sa <- pn, pa <- ds, both [key][query]
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = e & 1;
          float pn = 0.f, ds = 0.f;
          if (real[i] && c0 + 8 * j + 2 * q + c < seq) {
            float p = exp2f(__fsub_rn(sa[4 * j + e], sx[j][c]));
            if (a.sizes != nullptr) p = __fmul_rn(p, w[i]);
            pn = __fmul_rn(p, sl[j][c]);
            ds = __fmul_rn(pn, __fsub_rn(pa[4 * j + e], sr[j][c]));
          }
          sa[4 * j + e] = pn;
          pa[4 * j + e] = ds;
        }
      // dV += Pn^T dO and dK += dS^T q
      uint32_t fa[2][NT][8];
      float part[2][D / 2];
      fragments<NT>(fa[0], sa);
      fragments<NT>(fa[1], pa);
      tc::wgmma_fence();
      contract<g_, NT, 2>(part, fa, {sOth, sQth}, {sOtl, sQtl});
      drain<2>({dv, dk}, part);
    });
  }

  // warpgroup 1's dK and dV to shared memory, added to warpgroup 0's;
  // warpgroup 0 writes them
  float* xk = reinterpret_cast<float*>(sm + 4 * kRes + wg_cols_bytes<D>());
  float* xv = xk + (D / 2) * 128;
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      xk[i * 128 + wt] = dk[i];
      xv[i * 128 + wt] = dv[i];
    }
  }
  __syncthreads();
  if (wg == 1) return;
  const long long row3 = 3LL * h;
  float* db = a.dqkv + (long long)b * seq * row3 + hc;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!real[i]) continue;
    const long long t = k0 + 16 * warp + g + 8 * i;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int n0 = 4 * j + 2 * i, c = 8 * j + 2 * q;
      const float kx = __fadd_rn(dk[n0], xk[n0 * 128 + wt]);
      const float ky = __fadd_rn(dk[n0 + 1], xk[(n0 + 1) * 128 + wt]);
      const float vx = __fadd_rn(dv[n0], xv[n0 * 128 + wt]);
      const float vy = __fadd_rn(dv[n0 + 1], xv[(n0 + 1) * 128 + wt]);
      *reinterpret_cast<float2*>(db + t * row3 + h + c) =
          make_float2(__fmul_rn(kx, a.nat), __fmul_rn(ky, a.nat));
      *reinterpret_cast<float2*>(db + t * row3 + 2 * h + c) = make_float2(vx, vy);
    }
  }
}

}  // namespace gradwg
