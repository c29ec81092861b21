// K1's and K3's bf16 body at d = 64, 80 and 88 for Hopper (sm_90a): the
// attention on wgmma, fed by TMA. attention_qkv.cu instantiates it
// (attention_wgmma at d = 64, attention_wgmma_d<D> at d = 80 and 88) and
// sends it every bf16 call with those d from both C entry points.
//
// Replaces, for those calls, the TPU kernels behind vit_cpp_tpu/ops/
// flash_attention.py::attention_qkv (:538; the d = 64 pair kernel
// _qkv_pair_kernel; at d = 80 and 88, ViT-H/14's and ViT-g/14's heads,
// _qkv_kernel :221, since the lane form needs 128 % d == 0),
// _attention_qkv_lane (:409; large T x h) and flash_attention (:1304;
// split heads, safe mode), as the mma.sync body of attention_body.cuh did
// before it (that body still serves bf16 at every other d, and the checks
// reach it at d = 64, 80 and 88 through vit_attention_mma).
//
// What bounds it on this card. At ViT-B/16 (T = 197, d = 64) one (image,
// head) reads 76 KB of q, k, v and writes 25 KB for 4 T^2 d = 9.9 MFLOP,
// ~98 FLOP per byte: under the H100's bf16 ridge (~295), so an ideal
// kernel is bound by HBM. The mma.sync body was not: eight warps each
// issued mma.sync on 16 rows and ldmatrix'ed every K and V fragment, and
// its skeleton alone (Q load, score dot, cp.async ring, loop) outlasted
// SDPA's whole attention (PERF.md section 5). Here the products cost the
// SM almost no instruction slots: one warpgroup instruction multiplies 64
// query rows by 64 keys over 16 lanes, reading Q, K and V straight from
// shared memory, and one thread moves every tile by TMA. What is left on
// the SM's schedulers is the softmax, which this body keeps to a clamp (or
// a subtraction), an exp2 and an add per score; and what is left of the
// time is mostly each block's chain of latencies (its loads, then its
// chunks, then its store: on an H100 a build of this body with no
// products, no exp2 and no K/V loads took more than half the whole's time
// at B = 64, T = 197).
//
// Design:
// - A block is one warpgroup (128 threads) owning 64 query rows of one
//   (image, head): wgmma's M. At B = 8, T = 197 that is 8 x 12 x 4 = 384
//   blocks over 132 SMs, and three blocks share an SM (154 of at most 168
//   registers a thread, at most ~73 KB of shared memory), so one block's
//   loads overlap another's products and softmax. A separate producer
//   warp would hold registers of its own for the whole block and cost the
//   third block per SM, so thread 0 issues the copies.
// - Loads by TMA, in the 128-byte swizzle that wgmma's descriptors read:
//   one d = 64 bf16 row is exactly one 128-byte swizzle row. Each operand
//   is a 3-D tensor map (row elements, tokens, planes), a plane being an
//   image (fused qkv: rows of 3h, Q / K / V of a head at column offsets)
//   or an (image, head) pair (split heads: rows of 64). The token extent
//   is kv, so TMA writes zeros for keys and query rows at or past kv, and
//   a box never reads the next image's rows. Boxes are 64 rows: the Q
//   tile, and K and V in chunks of 64 keys, each box starting at a real
//   key, so that each barrier expects the box's full bytes.
// - Keys: up to kv = 256 (ViT-B/16's 197, SigLIP's 196, ToMe's merged
//   lengths) every K and V chunk loads once, with the Q tile. Past it
//   (577, 785) they stream through a ring of kWgRing chunk slots, each
//   refilled by thread 0 once every warp is past the wgmmas that read it.
//   (The ring at d = 80 and 88: wgmma_ring below.)
//   Fast mode is one pass over the chunks; safe mode over more than one
//   chunk first takes the exact row max in a pass of S alone (reading K
//   again in pass 1 only when it does not stay resident).
// - S = Q K^T: wgmma.m64n64k16 with Q (A) and K (B) K-major from shared
//   memory, 4 k steps into one m64n64 f32 tile per chunk. O += P V:
//   wgmma.m64n64k16 with P from registers (the accumulators of two
//   neighbouring n8 columns, rounded to bf16 and packed in pairs, are the
//   A fragment of a 16-key step) and V MN-major from shared memory (the
//   transpose bit). Padded key columns run through both products (zeros
//   times p = 0) rather than being branched around.
// - Pass 1 is software-pipelined as FlashAttention-3 does within a
//   warpgroup: S of chunk c + 1 and P V of chunk c - 1 run on the tensor
//   cores while the warps take chunk c's softmax. Each iteration issues
//   the same groups and waits for the same count, so ptxas keeps the
//   wgmmas asynchronous (a data-dependent wait count made it serialize
//   them and cost 10% at T = 785).
// - The softmax is compiled per mode (fast or safe), per presence of
//   ToMe sizes and per chunk kind: only the chunk that reaches past kv
//   forms key indices and masks (its 8-key columns past kv skip their
//   exp2). Runtime tests of the mode, the sizes and the mask inside the
//   loop made the body 1.6x slower at B = 64, T = 197.
// - Q is scaled in shared memory once it lands (f32, rounded to bf16),
//   then fenced for the async proxy.
// - The epilogue divides by l with one reciprocal per row and two fused
//   multiply-adds per element (the correctly rounded quotient, so the
//   body's output is the mma.sync body's, bit for bit, on every case the
//   checks run), stages the bf16 tile over Q's in the swizzle, and one TMA store
//   writes it (rows past seq are not written; rows in [kv, seq) are
//   zeros). A tile wholly past kv stores zeros and loads nothing.
// - A barrier wait that outlasts seconds traps (tc::mbar_wait_or_trap):
//   a copy that never lands fails the launch instead of hanging the card.
//
// d = 80 and 88 (ViT-H/14, ViT-g/14). A row is 160 or 176 bytes, more than
// one 128-byte swizzle row, so a 64-row tile is two TMA boxes: columns 0
// .. 63 in the 128-byte swizzle, as at d = 64, and a tail box beside it,
// 16 columns in the 32-byte swizzle (d = 80) or 32 in the 64-byte one (d
// = 88, of which 24 are the head's). The maps are 4-D, (columns, heads,
// tokens, planes), with the head's d columns as the innermost extent: a
// d = 88 tail box reads zeros past column 88 (in fused qkv the next
// head's columns lie there, not zeros), and its store stops at column 88.
// S = Q K^T takes the same four k16 steps over the 64-column boxes, then
// one (d = 80) or two (d = 88, the second half zeros) over the tail
// boxes, each step inside one box and one swizzle. O += P V takes, per
// 16-key step, m64n64k16 over V's 64-column box and m64n16k16 (d = 80) or
// m64n24k16 (d = 88: the head's 24 of the box's 32) over its tail box,
// both MN-major. The accumulators of o grow by 8 or 12 a thread: 162 and
// 166 registers, three blocks per SM at both (wgmma_ring below). The
// other layout, a d = 80 row in five 16-column boxes of the 32-byte
// swizzle (five TMA boxes a tile, every S step in that swizzle) and one
// m64n80k16 for P V, gave the same bits 1.3x (B = 8) to 1.46x (B = 64)
// slower at T = 257 on an H100 (PERF.md). Stage sets other than K1's run
// at d = 64 only.
//
// Numerics (attention_qkv.cu's contract): Q * log2(e) / sqrt(d) in f32,
// rounded to bf16; f32 scores; fast: exp2(min(s, 120)), safe: exp2(s -
// max over the real keys); keys >= kv weigh 0; p times sizes[key]; l the
// f32 sum of the f32 p; P V on p rounded to bf16 with f32 accumulation;
// o / l rounded to bf16. On an H100 its outputs equal the mma.sync body's
// bit for bit at every d = 64 case chip_smoke.py and the card tests run
// (the same products in the same order, the same f32 sums; at d = 80 and
// 88 the k16 steps run in the same order, and d = 88's padding columns,
// zeros in both bodies, add exact zeros).
//
// Stage sets. The body takes one as a template argument, as the mma.sync
// body does (attention_body.cuh, whose attn::Stages it reads): the default
// is K1's, and the forward anatomy (attn_anatomy.cuh, T1) instantiates one
// per variant at d = 64, each K1's body with the variant's stages changed
// and nothing else. What a stage set changes here:
//   kExp, kClamp  the weight in wgmma_softmax: exp2f (K1), exp2 in bf16 as
//                 JAX lowers it, or none; the clamp at 120 or none
//   kSum       the divisor: 1 the f32 row sum of the f32 p (K1); 2 the row
//              sum of the rounded p taken by the tensor cores, one
//              wgmma.m64n8k16 per 16-key step beside P V, P from registers
//              against a 16 x 8 tile of ones (a d = 64 row of V fills its
//              128-byte swizzle row: no padding columns to hold the ones,
//              as the mma.sync body's V has); 0 none (no division)
//   kNKS       the score dot over the head group's first head (4: one
//              64-lane box of Q and of K) or over the group's two heads
//              (8: two boxes a tile, 8 k16 steps); 0 the head's own
//   kTimesGroup  o times the group size
//   kOneDot    the score dot alone: S of every chunk, then chunk (head %
//              group)'s keys stored from the accumulators in `copies`
//              sections; no V, no softmax, no P V

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_body.cuh"
#include "tensor_core.cuh"

namespace attn {

constexpr int kWgRows = 64;                 // query rows per block: wgmma's M
constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kWgD = 64;                    // the columns of one 128-byte swizzle row
constexpr int kWgBox = kWgRows * kWgD * 2;  // bytes of one 64-row box of them
constexpr int kWgRing = 4;                  // d = 64: K and V chunks of 64 keys in flight

// Where a (batch, head)'s tiles lie in the tensor maps: Q, K and V of
// head 0 at columns q, k and v, head n at + n head_c; plane b z_batch + n
// z_head. The output map uses column n head_c and the same plane. At d =
// 80 and 88 the maps are 4-D (columns, heads, tokens, planes) and q, k,
// v and head_c count heads, not columns.
struct WgCoords {
  int q, k, v, head_c, z_batch, z_head;
};

// The head dimensions the body takes. d = 64: a row is one 64-column box
// in the 128-byte swizzle. d = 80 and 88: the 64-column box and a tail
// box, 16 columns in the 32-byte swizzle (d = 80) or 32 in the 64-byte one
// (d = 88: columns 88 .. 95 lie past the maps' extent, zeros).
__host__ __device__ constexpr bool wgmma_takes(int d) { return d == 64 || d == 80 || d == 88; }
template <int D>
__host__ __device__ constexpr int wgmma_tail() {  // the tail box's columns
  return D == 80 ? 16 : D == 88 ? 32 : 0;
}
template <int D>
__host__ __device__ constexpr int wgmma_pv_tail() {  // the tail's columns P V computes
  return D == 88 ? 24 : wgmma_tail<D>();
}
template <int D>
__host__ __device__ constexpr int wgmma_tile() {  // bytes of a 64-row tile
  return kWgBox + kWgRows * wgmma_tail<D>() * 2;
}
// K and V chunks in flight: at three blocks per SM (launch bounds), d = 80
// holds 162 registers in a ring of 3 (72.7 KB of shared memory each),
// d = 88 166 in a ring of 2 (62.5 KB). On an H100 these ran fastest at
// T = 257 of the rings of 2 to 4 at two or three blocks per SM (d = 88
// also with m64n32k16 for P V's tail: 170 registers, two blocks per SM;
// or held to three, serialized wgmmas), by tools/grad_variants.py
// --entry k1.
template <int D>
__host__ __device__ constexpr int wgmma_ring() {
  return D == 80 ? 3 : D == 88 ? 2 : kWgRing;
}

// A launch's tensor maps at d = 80 and 88: each operand's 64-column box
// and, in `tail`, the tail boxes of Q, K, V and the output (for fused qkv
// Q, K and V are one map).
struct WgMaps {
  CUtensorMap q, k, v, o;
  CUtensorMap tail[4];
};

constexpr int kWgOnes = 512;                // kSum 2: bytes of the ones tile

// 64-lane boxes of Q and of each K chunk the score dot of a stage set reads.
template <class S>
__host__ __device__ constexpr int wgmma_boxes() {
  return S::kNKS != 0 ? S::kNKS / 4 : 1;
}

// Dynamic shared memory of a block over kv keys: the Q tile (then the
// output tile), and min(ceil(kv / 64), ring) slots of one K and one V
// tile each, from a 1024-aligned base (+ 1024 for the alignment);
// for a stage set, its boxes of Q and K, no V (onedot), and the ones tile
// (kSum 2).
template <int D = 64>
__host__ __device__ constexpr int wgmma_slots(int kv) {
  return (kv + 63) / 64 < wgmma_ring<D>() ? (kv + 63) / 64 : wgmma_ring<D>();
}
template <int D = 64, class S = Stages>
__host__ __device__ constexpr size_t wgmma_smem_bytes(int kv) {
  return 1024 +
         (size_t)wgmma_tile<D>() *
             (wgmma_boxes<S>() + (wgmma_boxes<S>() + (S::kOneDot ? 0 : 1)) * wgmma_slots<D>(kv)) +
         (S::kSum == 2 ? kWgOnes : 0);
}

// Chunk c's p in place of its S (f32: the row sum, from registers), then
// P rounded to bf16 as the A fragments of its four 16-key steps. The
// chunk's keys start at c0 = 64 c; the thread's columns are c0 + 8 j + q2
// + (e & 1) (q2 = 2 q). kMask: the chunk holds keys >= kv, which weigh 0
// (8-key columns past kv skip their exp2). Without kMask and kSizes no
// key index is formed: the loop is a clamp (or a subtraction), an exp2
// and an add per score (K1's stages; S's weight and sum otherwise).
template <bool kFast, bool kSizes, bool kMask, class S = Stages>
__device__ __forceinline__ void wgmma_softmax(float (&acc)[32], uint32_t (&p16)[4][4],
                                              float (&l)[2], const float (&m)[2], int c0,
                                              int q2, int kv, const float* __restrict__ srow) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = c0 + 8 * j + q2;
    if (kMask && c0 + 8 * j >= kv) {  // no real key in this 8-key column
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] = 0.f;
      continue;
    }
    float sz[2] = {1.f, 1.f};
    if constexpr (kSizes) {
#pragma unroll
      for (int e = 0; e < 2; ++e) sz[e] = !kMask || key + e < kv ? srow[key + e] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = kFast ? (S::kClamp ? fminf(acc[4 * j + e], 120.f) : acc[4 * j + e])
                            : acc[4 * j + e] - m[e >> 1];
      float p = S::kExp == 1 ? exp2f(x) : (S::kExp == 2 ? tc::exp2_bf16(x) : x);
      if constexpr (kSizes) p *= sz[e & 1];
      if constexpr (kMask) p = key + (e & 1) < kv ? p : 0.f;
      if constexpr (S::kSum == 1) l[e >> 1] += p;
      acc[4 * j + e] = p;
    }
  }
#pragma unroll
  for (int k16 = 0; k16 < 4; ++k16) {
    const float* lo = acc + 8 * k16;  // n8 columns 2 k16 and 2 k16 + 1
    p16[k16][0] = tc::pack_bf16(lo[0], lo[1]);
    p16[k16][1] = tc::pack_bf16(lo[2], lo[3]);
    p16[k16][2] = tc::pack_bf16(lo[4], lo[5]);
    p16[k16][3] = tc::pack_bf16(lo[6], lo[7]);
  }
}

// The body at head dimension D, for fast (clamped) or safe softmax and
// with or without ToMe sizes: each a kernel of its own, so that the
// softmax's inner loop holds neither test. S, grp, dots and dots_row: a
// stage set (K1's by default; other sets at d = 64 only) and what the
// anatomy's stage sets read: the head group, and onedot's output (rows of
// dots_row elements, the head's columns at head * head_c). At d = 64 the
// four maps are 3-D; at d = 80 and 88 they are the 64-column boxes' 4-D
// maps and `tails` the tail boxes' (Q, K, V, output: WgMaps::tail).
template <int D, bool kFast, bool kSizes, class S = Stages>
__device__ __forceinline__ void attention_wgmma_body(
    const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
    const CUtensorMap& omap, WgCoords co, const float* __restrict__ sizes, int seq, int kv,
    float qscale, Group grp = Group{1, 0, 1, 0}, bf16* dots = nullptr, long long dots_row = 0,
    const CUtensorMap* tails = nullptr) {
  constexpr int kBoxes = wgmma_boxes<S>();
  static_assert(kBoxes == 1 || kBoxes == 2, "the score dot reads one or two 64-lane boxes");
  static_assert(wgmma_takes(D), "the body takes d = 64, 80 and 88");
  static_assert(D == 64 || (kBoxes == 1 && S::kSum == 1 && !S::kOneDot),
                "stage sets other than K1's run at d = 64 only");
  constexpr int kTail = wgmma_tail<D>();  // columns of the tail box (none at d = 64)
  constexpr int kTailN = wgmma_pv_tail<D>();  // and of P V's product over it
  constexpr int kTile = wgmma_tile<D>();  // bytes of a 64-row tile (one box at d = 64)
  constexpr int kRing = wgmma_ring<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t bars[1 + 2 * kRing];  // Q; K of each slot; V of each slot
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;  // Q, then the output tile
  const int slots = wgmma_slots<D>(kv);
  auto sk = [&](int s) { return smem + kTile * (kBoxes + kBoxes * s); };
  auto sv = [&](int s) { return smem + kTile * (kBoxes + kBoxes * slots + s); };
  uint64_t* kbar = bars + 1;
  uint64_t* vbar = bars + 1 + kRing;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kWgRows;
  const int z = b * co.z_batch + head * co.z_head, hc = head * co.head_c;
  // Q's and K's columns: the head's, or its group's first head's
  const int qkc = S::kNKS != 0 ? (head - head % grp.size) * co.head_c : hc;

  if (q0 < kv) {
    // Chunks of 64 keys. Safe mode over more than one chunk takes the
    // exact row max in a first pass of S-steps over every chunk (pass 0),
    // then the weights in a second (pass 1). The K loads follow the
    // S-steps through the ring, unless every chunk fits in it (kv <= 256:
    // each K chunk loads once and pass 1 reuses it); V chunks load for
    // pass 1 only.
    const int nck = (kv + 63) / 64;
    const bool resident = nck <= kRing;
    const int np0 = (!kFast && nck > 1) ? nck : 0;  // pass 0's S-steps
    const int nk = resident ? nck : np0 + nck;      // K loads
    auto kslot = [&](int i) { return resident ? (i < nck ? i : i - nck) : i % kRing; };
    // d = 80 / 88: the 64-column box and the tail box of head `at`'s
    // 64-row tile at token t (operand i of WgMaps::tail)
    auto load_wide = [&](unsigned char* dst, const CUtensorMap& map, int i, int at, int t,
                         uint64_t* bar) {
      tc::tma_load_4d(dst, &map, 0, at, t, z, bar);
      tc::tma_load_4d(dst + kWgBox, &tails[i], 64, at, t, z, bar);
    };
    auto load_k = [&](int j) {  // K load j: the chunk of S-step j
      const int s = resident ? j : j % kRing;
      const int c = j < np0 ? j : j - np0;
      tc::mbar_arrive_expect_tx(&kbar[s], kBoxes * kTile);
      if constexpr (D == 64) {
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tc::tma_load_3d(sk(s) + x * kWgBox, &kmap, co.k + qkc + 64 * x, 64 * c, z, &kbar[s]);
      } else {
        load_wide(sk(s), kmap, 1, co.k + hc, 64 * c, &kbar[s]);
      }
    };
    auto load_v = [&](int c) {
      const int s = c % kRing;
      tc::mbar_arrive_expect_tx(&vbar[s], kTile);
      if constexpr (D == 64)
        tc::tma_load_3d(sv(s), &vmap, co.v + hc, 64 * c, z, &vbar[s]);
      else
        load_wide(sv(s), vmap, 2, co.v + hc, 64 * c, &vbar[s]);
    };

    if (tid == 0) {
      for (int i = 0; i < 1 + 2 * kRing; ++i) tc::mbar_init(&bars[i], 1);
      tc::fence_mbarrier_init();
    }
    __syncthreads();  // the barriers are initialized
    if (tid == 0) {
      tc::mbar_arrive_expect_tx(&bars[0], kBoxes * kTile);
      if constexpr (D == 64) {
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tc::tma_load_3d(sq + x * kWgBox, &qmap, co.q + qkc + 64 * x, q0, z, &bars[0]);
      } else {
        load_wide(sq, qmap, 0, co.q + hc, q0, &bars[0]);
      }
      for (int j = 0; j < nk && j < kRing; ++j) load_k(j);
      if constexpr (!S::kOneDot)
        for (int c = 0; c < nck && c < kRing; ++c) load_v(c);
    }
    // kSum 2: the ones tile after the V slots, read without swizzle
    unsigned char* ones = sv(slots);
    if constexpr (S::kSum == 2) {
      for (int i = tid; i < kWgOnes / 16; i += kWgThreads)
        reinterpret_cast<uint4*>(ones)[i] =
            make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
    }

    // Q * qscale in f32, rounded to bf16 in place (the swizzle moves whole
    // 16-byte chunks, so the elementwise pass ignores it), then fenced for
    // the tensor cores' reads
    tc::mbar_wait_or_trap(&bars[0], 0);
    for (int i = tid; i < kBoxes * kTile / 16; i += kWgThreads) {
      uint4* p = reinterpret_cast<uint4*>(sq) + i;
      uint4 w = *p;
      uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
        u[e] = tc::pack_bf16(f.x * qscale, f.y * qscale);
      }
      *p = w;
    }
    tc::fence_proxy_async();
    __syncthreads();

    // rows g and g + 8 of the warp's 16: row max (safe) and this lane's
    // part of the row sum
    float m[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
    float l[2] = {0.f, 0.f};
    uint32_t kph = 0, vph = 0;  // bit s: the parity of slot s's next wait
    const float* srow = kSizes ? sizes + (size_t)b * seq : nullptr;

    // S-step i: wait for its K chunk (once per load), then S = Q K^T into
    // `acc` on the tensor cores, committed as one group: k16 steps over the
    // 64-column boxes, then (d = 80 / 88) over the tail boxes, each step
    // inside one box
    auto issue_s = [&](int i, float (&acc)[32]) {
      const int s = kslot(i);
      if (!resident || i < nck) {
        tc::mbar_wait_or_trap(&kbar[s], (kph >> s) & 1);
        kph ^= 1u << s;
      }
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBoxes * kWgD / 16; ++kk) {
        const int at = kWgBox * (kk / 4) + 32 * (kk % 4);  // box kk / 4, k16 step kk % 4
        tc::wgmma_m64n64k16_ss(acc, tc::sw128_desc(sq + at, 16, 1024),
                               tc::sw128_desc(sk(s) + at, 16, 1024), kk);
      }
      if constexpr (D == 80) {  // one 32-byte row: one k16 step
        tc::wgmma_m64n64k16_ss(acc, tc::sw32_desc(sq + kWgBox, 16, 256),
                               tc::sw32_desc(sk(s) + kWgBox, 16, 256), 1);
      } else if constexpr (D == 88) {  // 64-byte rows: two (the second half zeros)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          tc::wgmma_m64n64k16_ss(acc, tc::sw64_desc(sq + kWgBox + 32 * kk, 16, 512),
                                 tc::sw64_desc(sk(s) + kWgBox + 32 * kk, 16, 512), 1);
      }
      tc::wgmma_commit();
    };
    // the exact max over the real keys of chunk c's S, into m
    auto row_max = [&](const float (&acc)[32], int c) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (64 * c + 8 * j + 2 * q + (e & 1) < kv) m[e >> 1] = fmaxf(m[e >> 1], acc[4 * j + e]);
    };
    auto reduce_max = [&] {  // the four lanes of a row hold its columns
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
      }
    };

    if constexpr (S::kOneDot) {
      // the score dot alone, chunk by chunk; chunk pos = head % group,
      // keys 64 pos .. + 63 of S, stored from the accumulators (T >= 64 x
      // group)
      const int pos = head % grp.size;
      float live = 0.f;  // keeps every chunk's products live
      for (int i = 0; i < nck; ++i) {
        float acc[32];
        issue_s(i, acc);
        tc::wgmma_wait<0>();
        tc::fence_operands(acc);
        if (i == pos) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = q0 + 16 * warp + g + 8 * r;
            if (t >= seq) continue;
            bf16* row = dots + ((long long)b * seq + t) * dots_row + hc + 2 * q;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const uint32_t v = tc::pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
              for (int cp = 0; cp < grp.copies; ++cp)
                *reinterpret_cast<uint32_t*>(row + cp * grp.copy_stride + 8 * j) = v;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) live += acc[4 * j];
        if (!resident) {
          __syncthreads();  // every warp's wgmmas are done with the slot
          if (tid == 0 && i + kRing < nk) load_k(i + kRing);
        }
      }
      if (grp.copies < 0) *dots = __float2bfloat16_rn(live);  // never: copies >= 1
      return;
    }

    // pass 0 (safe mode, more than one chunk): S-step by S-step, the max
    for (int i = 0; i < np0; ++i) {
      float acc[32];
      issue_s(i, acc);
      tc::wgmma_wait<0>();
      tc::fence_operands(acc);
      row_max(acc, i);
      if (!resident) {
        __syncthreads();  // every warp's wgmmas are done with the slot
        if (tid == 0 && i + kRing < nk) load_k(i + kRing);
      }
    }
    if (np0 > 0) reduce_max();

    // pass 1, software-pipelined over chunks as FlashAttention-3 does
    // within a warpgroup: S of chunk c + 1 and P V of chunk c - 1 run on
    // the tensor cores while the warps take chunk c's softmax. Every
    // iteration but the last issues S(c + 1), then P V(c) once chunk c's P
    // is packed, then waits until only P V(c) is in flight; the pattern is
    // the same in every iteration, so ptxas can tell which wgmmas a wait
    // retires and keeps them asynchronous. S and P fragments alternate
    // between two register sets (the loop is unrolled by 2 so that each
    // names its set at compile time).
    float sacc[2][32], o[32];
    float ot[kTail ? kTailN / 2 : 1];  // d = 80 / 88: o's columns 64 .. 63 + kTailN
    float lsum[4] = {0.f, 0.f, 0.f, 0.f};  // kSum 2: rows g and g + 8, every column
    uint32_t pf[2][4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    if constexpr (kTail != 0) {
#pragma unroll
      for (int i = 0; i < kTailN / 2; ++i) ot[i] = 0.f;
    }
    auto softmax = [&](int c, float (&acc)[32], uint32_t (&p16)[4][4]) {
      if (!kFast && np0 == 0) {  // one chunk: the exact max from registers
        row_max(acc, c);
        reduce_max();
      }
      if (64 * c + 64 <= kv)
        wgmma_softmax<kFast, kSizes, false, S>(acc, p16, l, m, 64 * c, 2 * q, kv, srow);
      else
        wgmma_softmax<kFast, kSizes, true, S>(acc, p16, l, m, 64 * c, 2 * q, kv, srow);
    };
    // O += P V(c) over the chunk's 16-key steps: V rows 16 k16 .. + 15 lie
    // 2048 bytes apart in its box (kSum 2: the row sums of P beside it, P
    // times the ones tile, in the same group); d = 80 / 88: the tail box's
    // columns beside each, m64n16 / m64n32 (rows 512 / 1024 bytes apart)
    auto issue_pv = [&](int c, const uint32_t (&p16)[4][4]) {
      const int s = c % kRing;
      tc::mbar_wait_or_trap(&vbar[s], (vph >> s) & 1);
      vph ^= 1u << s;
      tc::wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16) {
        tc::wgmma_m64n64k16_rs(o, p16[k16], tc::sw128_desc(sv(s) + 2048 * k16, 8192, 1024), 1);
        if constexpr (D == 80)
          tc::wgmma_bf16_rs<2>(ot, p16[k16], tc::sw32_desc(sv(s) + kWgBox + 512 * k16, 2048, 256),
                               1);
        else if constexpr (D == 88)
          tc::wgmma_bf16_rs<kTailN / 8>(ot, p16[k16],
                                        tc::sw64_desc(sv(s) + kWgBox + 1024 * k16, 4096, 512), 1);
      }
      if constexpr (S::kSum == 2) {
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16)
          tc::wgmma_m64n8k16_rs(lsum, p16[k16], tc::plain_desc(ones, 128, 256), 1);
      }
      tc::wgmma_commit();
    };
    // S-step i done: its K slot takes K load i + kRing; P V(c) done: its
    // V slot takes chunk c + kRing (the ring only)
    auto refill = [&](int i, int c) {
      if (resident) return;
      __syncthreads();  // every warp's wgmmas are past them
      if (tid == 0) {
        if (i + kRing < nk) load_k(i + kRing);
        if (c >= 0 && c + kRing < nck) load_v(c + kRing);
      }
    };
    auto iter = [&](int c, float (&acc)[32], float (&nacc)[32], uint32_t (&p16)[4][4]) {
      issue_s(np0 + c + 1, nacc);
      softmax(c, acc, p16);
      issue_pv(c, p16);
      tc::wgmma_wait<1>();  // S(c + 1) and P V(c - 1) are done
      tc::fence_operands(nacc);
      refill(np0 + c + 1, c - 1);
    };
    auto last = [&](int c, float (&acc)[32], uint32_t (&p16)[4][4]) {
      softmax(c, acc, p16);
      issue_pv(c, p16);
      tc::wgmma_wait<0>();
    };
    issue_s(np0, sacc[0]);
    tc::wgmma_wait<0>();
    tc::fence_operands(sacc[0]);
    refill(np0, -1);
    int c = 0;
    for (; c + 2 < nck; c += 2) {
      iter(c, sacc[0], sacc[1], pf[0]);
      iter(c + 1, sacc[1], sacc[0], pf[1]);
    }
    if (c + 1 < nck) {
      iter(c, sacc[0], sacc[1], pf[0]);
      last(c + 1, sacc[1], pf[1]);
    } else {
      last(c, sacc[0], pf[0]);
    }
    tc::fence_operands(o);
    if constexpr (kTail != 0) tc::fence_each(ot);

    if constexpr (S::kSum == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      }
    } else if constexpr (S::kSum == 2) {
      tc::fence_operands(lsum);
      l[0] = lsum[0];  // rows g and g + 8, summed over all the row's keys
      l[1] = lsum[2];
    }
    __syncthreads();  // every warp's wgmmas are done with Q's tile
    // o / l, rounded to bf16, staged over Q's tile in the 128-byte swizzle
    // (chunk j of row r at chunk j ^ (r % 8)); rows at or past kv are
    // zeros. The quotient is the correctly rounded o / l, as the mma.sync
    // body's IEEE division gives it, but from one reciprocal of l per row:
    // q = o * (1 / l), then q + (o - q l) / l by two fused multiply-adds
    // (exact for l and o / l in f32's normal range). o * (1 / l) alone is
    // off by an ulp in places, which moved a static-W8A8 ViTSTR token past
    // chip_smoke's near-tie bound; the IEEE division per element cost the
    // body a fifth of its time at B = 64, T = 197.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + g + 8 * i;
      const bool real = q0 + r < kv;
      const float inv = __frcp_rn(l[i]);
      auto div = [&](float v) {  // what is stored of an accumulator
        if constexpr (S::kSum != 0) {
          const float y = __fmul_rn(v, inv);
          return __fmaf_rn(__fmaf_rn(-y, l[i], v), inv, y);
        } else {
          return S::kTimesGroup ? v * (float)grp.size : v;
        }
      };
      unsigned char* row = sq + r * 128 + 4 * q;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(row + ((j ^ (r & 7)) << 4)) =
            real ? tc::pack_bf16(div(o[4 * j + 2 * i]), div(o[4 * j + 2 * i + 1])) : 0u;
      if constexpr (kTail != 0) {
        // the tail box's rows of 2 kTail bytes in its swizzle: chunk j of
        // row r at j ^ ((r / 4) % 2) (32-byte) or j ^ ((r / 2) % 4) (64-byte)
        unsigned char* trow = sq + kWgBox + r * 2 * kTail + 4 * q;
        const int flip = D == 80 ? (r >> 2) & 1 : (r >> 1) & 3;
#pragma unroll
        for (int j = 0; j < kTailN / 8; ++j)
          *reinterpret_cast<uint32_t*>(trow + ((j ^ flip) << 4)) =
              real ? tc::pack_bf16(div(ot[4 * j + 2 * i]), div(ot[4 * j + 2 * i + 1])) : 0u;
      }
    }
  } else {
    if constexpr (S::kOneDot) return;  // no row of S to store
    // every row of this tile is token padding: zeros
    for (int i = tid; i < kTile / 16; i += kWgThreads)
      reinterpret_cast<uint4*>(sq)[i] = make_uint4(0, 0, 0, 0);
  }
  tc::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    if constexpr (D == 64) {
      tc::tma_store_3d(&omap, hc, q0, z, sq);
    } else {  // the tail box's store stops at column d
      tc::tma_store_4d(&omap, 0, hc, q0, z, sq);
      tc::tma_store_4d(&tails[3], 64, hc, q0, z, sq + kWgBox);
    }
    tc::bulk_commit();
    tc::bulk_wait_read<0>();  // shared memory stays until the store has read it
  }
}

}  // namespace attn
