// 3xTF32 on wgmma, fed by TMA: the tiling and building blocks that K2's f32
// body (attention_grad_wgmma.cuh) and K1's f32 body (attention_tf32_
// wgmma.cuh) share, at a head dimension of 64, 80 or 88.
//
// - A block is two warpgroups (256 threads) over 64 resident rows of one
//   (image, head), wgmma's M. The resident tiles land once by TMA and are
//   split once, in shared memory, into TF32 hi and lo parts; the other
//   tokens stream in chunks, warpgroup w taking chunks w, w + 2, ..., each
//   through its own ring of kRing chunk slots.
// - A landed tile is kBoxes boxes of kBoxCols floats per row, in the
//   swizzle of the box's row bytes: at d = 64 two boxes of 32 floats in
//   the 128-byte swizzle, at d = 80 five of 16 in the 64-byte swizzle (a
//   320-byte row is 2.5 rows of the 128-byte swizzle; 64-byte boxes tile
//   it with no padding, so a tile holds exactly its bytes). At d = 88 (88
//   = 5 x 16 + 8) the five 64-byte boxes take a tail box of 8 floats in
//   the 32-byte swizzle, from a map of its own, so the tile again holds
//   exactly its bytes (a row padded to 96 floats would put K2's launch A
//   past a block's 227 KB; eleven 32-byte boxes ran 10-28% slower on an
//   H100). A k step (8 floats, 32 bytes) lies within one box: the tail
//   box is d = 88's last.
// - Products that contract over d (S = Q K^T and the like) read both
//   operands as they land (K-major): wgmma.m64nNk8 with N = 8 to 8 kChunk
//   / 8, three TF32 terms per k step (lo hi, hi lo, hi hi).
// - Products that contract over tokens read their B operand from a
//   token-contiguous copy (the tf32 forms have no transpose), written hi
//   and lo by the pass that splits the landed chunk: D rows of kChunk
//   tokens, in the 128-byte swizzle at kChunk = 32 and the 64-byte one at
//   kChunk = 16. Their A operand comes from accumulators in registers
//   (fragments()), whose columns 2q, 2q + 1 are the A fragment's q, q + 4:
//   the contraction index is renumbered, and the copies store, within each
//   group of 8 tokens, token 2p at position p and token 2p + 1 at p + 4.
// - The tensor cores read a tf32 operand's top 19 bits: they truncate an
//   f32 to TF32. So a landed tile serves as its own hi part and lo =
//   tf32(x - trunc(x)) (split_trunc). They also truncate each wgmma's sum:
//   a chunk's token products sum into a part that a rounded f32 addition
//   drains into the accumulator (drain()).

#pragma once

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace tf32wg {

// The tiling at head dimension D (64, 80 or 88), C streamed tokens per
// step (32 or 16) and R chunk slots per warpgroup.
template <int D, int C, int R = 2>
struct Geo {
  static constexpr int kD = D;
  static constexpr int kChunk = C;
  static constexpr int kRows = 64;  // resident rows per block: wgmma's M
  static constexpr int kWgs = 2;    // warpgroups per block
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kRing = R;   // chunk slots per warpgroup
  static constexpr int kBoxCols = D % 32 == 0 ? 32 : 16;  // floats a box row
  static constexpr int kSw = 4 * kBoxCols;      // its bytes: the swizzle
  static constexpr int kBoxes = D / kBoxCols;   // whole boxes
  static constexpr int kTail = D % kBoxCols;    // columns past them: a 32-byte box
  static constexpr int kMainSteps = kBoxes * kBoxCols / 8;  // k steps in the whole boxes
  static constexpr int kResBox = kRows * kSw;   // a box of a resident tile
  static constexpr int kRes = kBoxes * kResBox + kRows * 4 * kTail;  // a resident 64 x D tile
  static constexpr int kStrBox = C * kSw;       // a box of a streamed chunk
  static constexpr int kStr = kBoxes * kStrBox + C * 4 * kTail;  // a streamed C x D tile
  static constexpr int kSwT = 4 * C;            // a transposed row's bytes: its swizzle
  static constexpr int kTr = D * kSwT;          // a transposed D x C tile
  static_assert((D == 64 || D == 80 || D == 88) && (C == 32 || C == 16), "tiling");
  static_assert(kTail == 0 || kTail == 8, "a tail box is one k step");
};

// The maps of the tail boxes of a launch's three operands (d = 88).
struct Tails {
  CUtensorMap m[3];
};

template <int N>
using Nt = std::integral_constant<int, N>;

// f(Nt<nt>()) for the live 8-token columns of a chunk, nt = 1 .. kMax, so
// that the chunk's products and accumulators are sized at compile time.
template <int kMax, class F>
__device__ __forceinline__ void with_nt(int nt, F&& f) {
  if constexpr (kMax == 2) {
    if (nt == 1) f(Nt<1>()); else f(Nt<2>());
  } else {
    switch (nt) {
      case 1: f(Nt<1>()); break;
      case 2: f(Nt<2>()); break;
      case 3: f(Nt<3>()); break;
      default: f(Nt<4>()); break;
    }
  }
}

// The 128 threads of warpgroup `wg` meet (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// Descriptor of a K-major operand at p, in the kSw-byte swizzle (8-row
// atoms of 8 kSw bytes).
template <int kSw>
__device__ __forceinline__ uint64_t desc(const void* p) {
  if constexpr (kSw == 128) return tc::sw128_desc(p, 16, 1024);
  else if constexpr (kSw == 64) return tc::sw64_desc(p, 16, 512);
  else return tc::sw32_desc(p, 16, 256);
}

// desc<kSw>(p), opaque to the compiler: descriptors derived from it are
// computed where they are used, not hoisted out of a loop and held in
// registers across it.
template <int kSw>
__device__ __forceinline__ uint64_t desc_opaque(const void* p) {
  uint64_t d = desc<kSw>(p);
  asm volatile("" : "+l"(d));
  return d;
}

// The descriptor of p + off from p's: the start address field is the low
// 14 bits of (address >> 4), and a block's 227 KB keep it below 2^14, so
// one addition moves it (off a multiple of 16).
__device__ __forceinline__ uint64_t desc_at(uint64_t d, int off) {
  return d + (uint64_t)(off >> 4);
}

// Where the 16-byte chunk c of row r lies in its row, in the kSw-byte
// swizzle.
template <int kSw>
__device__ __forceinline__ int sw_chunk(int r, int c) {
  if constexpr (kSw == 128) return c ^ (r & 7);
  else if constexpr (kSw == 64) return c ^ ((r >> 1) & 3);
  else return c ^ ((r >> 2) & 1);
}

// The boxes of a tile (kBox bytes apart in shared memory) whose first
// column is `col`, at token `row` of plane z, completing `bar`.
// (The first two written out: as one loop they changed the SASS of K2's
// d = 64 launch A, 8704 -> 11376 instructions, and ran it slower on an
// H100.)
// With a tail (G::kTail columns), its box follows from `tail`'s map.
template <class G, int kBox>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, int col,
                                          int row, int z, uint64_t* bar,
                                          const CUtensorMap* tail = nullptr) {
  tc::tma_load_3d(dst, map, col, row, z, bar);
  tc::tma_load_3d(dst + kBox, map, col + G::kBoxCols, row, z, bar);
#pragma unroll
  for (int x = 2; x < G::kBoxes; ++x)
    tc::tma_load_3d(dst + x * kBox, map, col + x * G::kBoxCols, row, z, bar);
  if constexpr (G::kTail > 0)
    tc::tma_load_3d(dst + G::kBoxes * kBox, tail, col + G::kBoxes * G::kBoxCols, row, z, bar);
}

// x as the tensor cores' TF32 hi and lo parts: hi is x itself (they read
// its top 19 bits, truncating), lo = x - trunc(x), exact in f32, rounded
// to TF32.
__device__ __forceinline__ tc::Split split_trunc(float x) {
  const uint32_t hi = __float_as_uint(x);
  return tc::Split{hi, tc::tf32(__fsub_rn(x, __uint_as_float(hi & 0xffffe000u)))};
}

__device__ __forceinline__ uint4 his(const tc::Split (&s)[4]) {
  return make_uint4(s[0].hi, s[1].hi, s[2].hi, s[3].hi);
}
__device__ __forceinline__ uint4 los(const tc::Split (&s)[4]) {
  return make_uint4(s[0].lo, s[1].lo, s[2].lo, s[3].lo);
}

// A resident tile (kRes bytes as TMA wrote it) -> its TF32 lo part at the
// same offsets in `lo`; with kScale, x * scale first, written back in place
// (the tile is then its own hi part). Elementwise, so the swizzle does not
// matter. All threads of the block.
template <class G, bool kScale>
__device__ __forceinline__ void split_resident(unsigned char* t, unsigned char* lo, float scale) {
  for (int i = threadIdx.x; i < G::kRes / 16; i += G::kThreads) {
    const float4 v = reinterpret_cast<const float4*>(t)[i];
    const float f[4] = {v.x, v.y, v.z, v.w};
    tc::Split s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = split_trunc(kScale ? __fmul_rn(f[e], scale) : f[e]);
    if (kScale) reinterpret_cast<uint4*>(t)[i] = his(s);
    reinterpret_cast<uint4*>(lo)[i] = los(s);
  }
}

// A streamed chunk (C tokens x D columns in kBoxes boxes) -> with kLo, its
// TF32 lo part at the same offsets in `lo` (with kScale, x * scale first,
// written back in place); with kT, x's hi and lo (unscaled) transposed
// into `th` and `tl`: D rows of C tokens, the tokens of each 8 in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (the renumbered contraction index), in the
// (4 C)-byte swizzle. Thread wt of the warpgroup takes token wt % C and
// the 16-byte chunks of its row that fall to wt / C: at d = 64 and 80 with
// C = 32, D / 16 or 20 / 4 = 5 neighbouring ones, so that a warp's 16-byte
// accesses fall 8 (or 4) to a box row and its transposed 4-byte stores
// (one dim, 32 tokens) on 32 distinct banks; at d = 80 with C = 16, every
// eighth one from wt / 16 (20 chunks over 8 threads); at d = 88 every
// fourth (C = 32: 22 chunks over 4 threads) or eighth (C = 16) one, the
// last two of a row in the tail box's 32-byte rows.
template <class G, bool kT, bool kScale, bool kLo = true>
__device__ __forceinline__ void split_stream(unsigned char* x, unsigned char* lo,
                                             unsigned char* th, unsigned char* tl, float scale,
                                             int wt) {
  constexpr int C = G::kChunk, kCols = G::kD / 4;  // 16-byte chunks of a row
  constexpr int kCShift = C == 32 ? 5 : 4;
  constexpr int kGroups = 128 / C;  // threads per token
  constexpr bool kWhole = kCols % kGroups == 0;
  constexpr int kPer = (kCols + kGroups - 1) / kGroups;
  constexpr int kCpb = G::kSw / 16, kCpbShift = kCpb == 8 ? 3 : 2;  // chunks of a box row
  const int t = wt & (C - 1), s8 = t & 7;
  const int p = (s8 & 1) ? 4 + (s8 >> 1) : (s8 >> 1);  // position in its 8-token step
  const int k16 = 2 * (t >> 3) + (p >> 2), pw = (p & 3) << 2;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = kWhole ? kPer * (wt >> kCShift) + k : (wt >> kCShift) + kGroups * k;
    if (!kWhole && c >= kCols) break;
    int off = (c >> kCpbShift) * G::kStrBox + t * G::kSw +
              (sw_chunk<G::kSw>(t, c & (kCpb - 1)) << 4);
    if constexpr (G::kTail > 0)  // the tail box's 32-byte rows
      if (c >= G::kBoxes * kCpb)
        off = G::kBoxes * G::kStrBox + t * 32 + (sw_chunk<32>(t, c - G::kBoxes * kCpb) << 4);
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    const float f[4] = {v.x, v.y, v.z, v.w};
    tc::Split s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kT) {
        const tc::Split r = split_trunc(f[e]);
        const int n = 4 * c + e;
        const int toff = n * G::kSwT + ((sw_chunk<G::kSwT>(n, k16) << 4) | pw);
        *reinterpret_cast<uint32_t*>(th + toff) = r.hi;
        *reinterpret_cast<uint32_t*>(tl + toff) = r.lo;
      }
      if constexpr (kLo) s[e] = split_trunc(kScale ? __fmul_rn(f[e], scale) : f[e]);
    }
    if constexpr (kLo) {
      if (kScale) *reinterpret_cast<uint4*>(x + off) = his(s);
      *reinterpret_cast<uint4*>(lo + off) = los(s);
    }
  }
}

// The byte offset of k step kk (8 floats) in a landed tile of kBox-byte
// boxes (past them, the tail box).
template <class G, int kBox>
__device__ __forceinline__ int step_offset(int kk) {
  constexpr int kSteps = G::kBoxCols / 8;  // k steps of a box row
  return kk < G::kMainSteps ? (kk / kSteps) * kBox + 32 * (kk % kSteps) : G::kBoxes * kBox;
}

// The descriptor of k step kk of the tile at p, `off` bytes in: from d0,
// p's own, by one addition, or the tail box's in the 32-byte swizzle (kk
// is a constant of an unrolled loop).
template <class G>
__device__ __forceinline__ uint64_t step_desc(uint64_t d0, const unsigned char* p, int kk,
                                              int off) {
  if (kk < G::kMainSteps) return desc_at(d0, off);
  return desc<32>(p + off);
}

// acc (64 x 8 NT) = A B^T and acc2 = A2 B2^T over d in 3xTF32, the two
// chains alternating: A and A2 resident tiles (hi `ah`, lo `al`), B and B2
// a streamed one's first 8 NT rows. Per k step the terms lo hi, hi lo, hi
// hi; kSwap: hi lo, lo hi, hi hi (K2's launch B, whose A is launch A's B).
// Issued, not waited.
template <class G, int NT, bool kSwap>
__device__ __forceinline__ void scores(float (&acc)[4 * NT], float (&acc2)[4 * NT],
                                       const unsigned char* ah, const unsigned char* al,
                                       const unsigned char* bh, const unsigned char* bl,
                                       const unsigned char* ah2, const unsigned char* al2,
                                       const unsigned char* bh2, const unsigned char* bl2) {
  const int x = kSwap ? 0 : 1;  // the first term's A part: hi (0) or lo (1)
  if constexpr (G::kD == 64) {
#pragma unroll
    for (int kk = 0; kk < G::kD / 8; ++kk) {
      const int oa = step_offset<G, G::kResBox>(kk);
      const int ob = step_offset<G, G::kStrBox>(kk);
      const uint64_t a[2][2] = {{desc<G::kSw>(ah + oa), desc<G::kSw>(al + oa)},
                                {desc<G::kSw>(ah2 + oa), desc<G::kSw>(al2 + oa)}};
      const uint64_t b[2][2] = {{desc<G::kSw>(bh + ob), desc<G::kSw>(bl + ob)},
                                {desc<G::kSw>(bh2 + ob), desc<G::kSw>(bl2 + ob)}};
      tc::wgmma_tf32_ss<NT>(acc, a[0][x], b[0][1 - x], kk > 0);
      tc::wgmma_tf32_ss<NT>(acc2, a[1][x], b[1][1 - x], kk > 0);
      tc::wgmma_tf32_ss<NT>(acc, a[0][1 - x], b[0][x], 1);
      tc::wgmma_tf32_ss<NT>(acc2, a[1][1 - x], b[1][x], 1);
      tc::wgmma_tf32_ss<NT>(acc, a[0][0], b[0][0], 1);
      tc::wgmma_tf32_ss<NT>(acc2, a[1][0], b[1][0], 1);
    }
  } else {
    // the eight tiles' descriptors once, opaque (held across a loop, the
    // 80 of the k steps took 160 registers), then one addition each
    const uint64_t a0[2][2] = {{desc_opaque<G::kSw>(ah), desc_opaque<G::kSw>(al)},
                               {desc_opaque<G::kSw>(ah2), desc_opaque<G::kSw>(al2)}};
    const uint64_t b0[2][2] = {{desc_opaque<G::kSw>(bh), desc_opaque<G::kSw>(bl)},
                               {desc_opaque<G::kSw>(bh2), desc_opaque<G::kSw>(bl2)}};
    const unsigned char* const pa[2][2] = {{ah, al}, {ah2, al2}};
    const unsigned char* const pb[2][2] = {{bh, bl}, {bh2, bl2}};
    auto da = [&](int i, int j, int kk, int o) { return step_desc<G>(a0[i][j], pa[i][j], kk, o); };
    auto db = [&](int i, int j, int kk, int o) { return step_desc<G>(b0[i][j], pb[i][j], kk, o); };
#pragma unroll
    for (int kk = 0; kk < G::kD / 8; ++kk) {
      const int oa = step_offset<G, G::kResBox>(kk);
      const int ob = step_offset<G, G::kStrBox>(kk);
      tc::wgmma_tf32_ss<NT>(acc, da(0, x, kk, oa), db(0, 1 - x, kk, ob), kk > 0);
      tc::wgmma_tf32_ss<NT>(acc2, da(1, x, kk, oa), db(1, 1 - x, kk, ob), kk > 0);
      tc::wgmma_tf32_ss<NT>(acc, da(0, 1 - x, kk, oa), db(0, x, kk, ob), 1);
      tc::wgmma_tf32_ss<NT>(acc2, da(1, 1 - x, kk, oa), db(1, x, kk, ob), 1);
      tc::wgmma_tf32_ss<NT>(acc, da(0, 0, kk, oa), db(0, 0, kk, ob), 1);
      tc::wgmma_tf32_ss<NT>(acc2, da(1, 0, kk, oa), db(1, 0, kk, ob), 1);
    }
  }
}

// A B^T (64 x 8 NT) alone in two chains that alternate: hh = the hi hi
// terms, x = the cross terms (lo hi, hi lo per k step); the caller adds
// them by one rounded addition. Each chain's sums are truncated by the
// tensor cores: split so, the large terms' chain is d / 8 long and the
// cross terms are ~2^-10 of them (in one chain of 3 d / 8, an emulation
// of the truncated sums put K1's output 2.1e-6 from the plain version at
// ViT-B/16's shape, 1.4e-6 split). Issued, not waited.
template <class G, int NT>
__device__ __forceinline__ void score(float (&hh)[4 * NT], float (&x)[4 * NT],
                                      const unsigned char* ah, const unsigned char* al,
                                      const unsigned char* bh, const unsigned char* bl) {
  const uint64_t a[2] = {desc_opaque<G::kSw>(ah), desc_opaque<G::kSw>(al)};
  const uint64_t b[2] = {desc_opaque<G::kSw>(bh), desc_opaque<G::kSw>(bl)};
#pragma unroll
  for (int kk = 0; kk < G::kD / 8; ++kk) {
    const int oa = step_offset<G, G::kResBox>(kk);
    const int ob = step_offset<G, G::kStrBox>(kk);
    tc::wgmma_tf32_ss<NT>(x, step_desc<G>(a[1], al, kk, oa), step_desc<G>(b[0], bh, kk, ob),
                          kk > 0);
    tc::wgmma_tf32_ss<NT>(hh, step_desc<G>(a[0], ah, kk, oa), step_desc<G>(b[0], bh, kk, ob),
                          kk > 0);
    tc::wgmma_tf32_ss<NT>(x, step_desc<G>(a[0], ah, kk, oa), step_desc<G>(b[1], bl, kk, ob), 1);
  }
}

// The A fragments of a 64 x 8 NT operand held as accumulators (v[4 j + e]
// at row g + 8 (e >> 1), column 8 j + 2 q + (e & 1)): fragment column q is
// token 2q and q + 4 token 2q + 1, so a = {v0, v2, v1, v3}; fa[j] = {hi
// a0..a3, lo a0..a3}.
template <int NT>
__device__ __forceinline__ void fragments(uint32_t (&fa)[NT][8], const float (&v)[4 * NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float x[4] = {v[4 * j], v[4 * j + 2], v[4 * j + 1], v[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const tc::Split s = split_trunc(x[e]);
      fa[j][e] = s.hi;
      fa[j][4 + e] = s.lo;
    }
  }
}

// One m64nDk8 tf32 wgmma with A from registers (D = 64, 80 or 88).
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (D == 64) tc::wgmma_m64n64k8_tf32_rs(d, a, b, accumulate);
  else if constexpr (D == 80) tc::wgmma_m64n80k8_tf32_rs(d, a, b, accumulate);
  else tc::wgmma_m64n88k8_tf32_rs(d, a, b, accumulate);
}

// part[i] (64 x D) = A_i B_i over the chunk's NT live 8-token steps in
// 3xTF32 (lo hi, hi lo, hi hi per step), for i < P products whose chains
// alternate: A_i the fragments fa[i], B_i a transposed tile (hi bh[i], lo
// bl[i]), step j at bytes 32 j of its rows. Issued, not waited.
template <class G, int NT, int P>
__device__ __forceinline__ void contract(float (&part)[P][G::kD / 2],
                                         const uint32_t (&fa)[P][NT][8],
                                         const unsigned char* const (&bh)[P],
                                         const unsigned char* const (&bl)[P]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint64_t dh[P], dl[P];
    uint32_t hi[P][4], lo[P][4];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      dh[i] = desc<G::kSwT>(bh[i] + 32 * j);
      dl[i] = desc<G::kSwT>(bl[i] + 32 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[i][e] = fa[i][j][e], lo[i][e] = fa[i][j][4 + e];
    }
#pragma unroll
    for (int i = 0; i < P; ++i) wgmma_rs<G::kD>(part[i], lo[i], dh[i], j > 0);
#pragma unroll
    for (int i = 0; i < P; ++i) wgmma_rs<G::kD>(part[i], hi[i], dl[i], 1);
#pragma unroll
    for (int i = 0; i < P; ++i) wgmma_rs<G::kD>(part[i], hi[i], dh[i], 1);
  }
}

// *acc[i] += part[i] after the chunk's wgmmas, in rounded f32 additions.
template <int P, int N>
__device__ __forceinline__ void drain(float* const (&acc)[P], float (&part)[P][N]) {
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < P; ++i) {
    tc::fence_each(part[i]);
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = __fadd_rn(acc[i][n], part[i][n]);
  }
}

}  // namespace tf32wg
