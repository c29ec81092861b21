// K1's bf16 body (attention_mma of attention_qkv.cu, which serves K1 and
// K3), shared with the forward anatomy (attn_anatomy.cu, T1): a device
// function templated on NK and on a compile-time stage set. The default
// stage set, Stages, is K1's body exactly; attn_anatomy.cu instantiates
// one stage set per variant, each K1's body with the variant's stages
// changed and nothing else. The design is written at attention_qkv.cu's
// head: 8 warps of 16 query rows, Q held in registers as mma.sync.m16n8k16
// A fragments, a cp.async ring of three K/V tiles of 64 keys, P taken from
// the S accumulators in registers.
//
// What a stage set may change:
//   kExp       the weight: 1 exp2f (K1), 2 exp2 in bf16 as JAX lowers it,
//              0 none (p = the score)
//   kClamp     min(s, 120) in fast mode (K1) or not
//   kSum       the divisor: 1 the f32 row sum of the f32 p (K1); 2 the row
//              sum of the rounded p taken by the tensor cores, as one more
//              n8 tile of P V whose B operand is a tile of ones in V's
//              padding columns 16 NK .. 16 NK + 7; 0 none (no division)
//   kNKS       the score dot's width in 16-wide slices when it runs over
//              the lanes of the head's group (Group: its first head's,
//              `width` of them) instead of the head's own: Q fragments
//              and K rows of 16 kNKS, V rows of 16 NK (0: the head's, NK)
//   kTimesGroup  o times the group size (nomask)
//   kOneDot    the score dot alone: S of every key tile, the keys
//              pos*d .. pos*d + d - 1 (pos = head % group) stored from
//              the C fragments in `copies` sections
//   kNarrow    the caller rounds NK up: zero every padding column d ..
//              16 NK (K1's d is 16 NK or 16 NK - 8)

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                 // keys per shared-memory tile
constexpr int kWarps = 8;               // 16 query rows each
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kMmaRows = 16 * kWarps;   // query rows per block
constexpr int kRing = 3;                // K and V tiles in flight

// Element strides of a (batch, head, token, feature) view; feature stride 1.
struct Strides {
  long long batch, head, token;
};

// K1's fast path.
struct Stages {
  static constexpr int kExp = 1;
  static constexpr bool kClamp = true;
  static constexpr int kSum = 1;
  static constexpr int kNKS = 0;
  static constexpr bool kTimesGroup = false;
  static constexpr bool kOneDot = false;
  static constexpr bool kNarrow = false;
};

// The head group of a stage set whose score dot leaves the head's lanes:
// `size` heads, the dot over `width` lanes from the group's first head;
// onedot writes `copies` sections `copy_stride` elements apart. Unused by
// the default stage set.
struct Group {
  int size, width, copies;
  long long copy_stride;
};

template <int NK, class S>
__host__ __device__ constexpr int score_slices() {
  return S::kNKS != 0 ? S::kNKS : NK;
}

// Shared memory of the bf16 body: the Q tile, then a ring of K tiles (rows
// of 16 NKS + 8 bf16) and a ring of V tiles (rows of 16 NK + 8; none for
// onedot).
template <int NK, class S = Stages>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return ((size_t)(kMmaRows + kRing * kBK) * (16 * score_slices<NK, S>() + 8) +
          (S::kOneDot ? 0 : (size_t)kRing * kBK * (16 * NK + 8))) *
         sizeof(bf16);
}

// NK = ceil(d / 16): 16-wide slices of the (zero-padded) head dimension.
template <int NK, class S = Stages>
__device__ __forceinline__ void attention_mma_body(
    const bf16* __restrict__ qg, const bf16* __restrict__ kg, const bf16* __restrict__ vg,
    Strides in, const float* __restrict__ sizes, bf16* __restrict__ out, Strides os, int seq,
    int d, int kv, float qscale, int fast, Group grp = Group{1, 0, 1, 0}) {
  constexpr int NKS = score_slices<NK, S>();
  constexpr bool kWide = S::kNKS != 0;  // Q and K over the group's lanes
  constexpr int kLd = 16 * NKS + 8;  // row stride: +16 B puts ldmatrix rows in distinct banks
  constexpr int kTile = kBK * kLd;
  constexpr int kLdV = 16 * NK + 8;
  constexpr int kTileV = kBK * kLdV;
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
  const long long qk_off = kWide ? b * in.batch + (head - head % grp.size) * in.head : in_off;
  const bf16* qb = qg + qk_off;
  const bf16* kb = kg + qk_off;
  const bf16* vb = vg + in_off;
  bf16* ob = out + b * os.batch + head * os.head;
  const int chunks = d >> 3;  // 16-byte chunks of a row
  const int qk_chunks = kWide ? grp.width >> 3 : chunks;

  if (q0 >= kv) {  // every row of this tile is token padding
    for (int idx = tid; idx < kMmaRows * chunks; idx += kMmaThreads) {
      const int r = idx / chunks, c = idx - r * chunks;
      if (q0 + r < seq)
        *reinterpret_cast<uint4*>(ob + (q0 + r) * os.token + 8 * c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // the padding columns d .. 16 NK of every row: zero once, never copied over
  if constexpr (!kWide && !S::kNarrow) {
    if (d < 16 * NK) {
      for (int r = tid; r < kMmaRows + 2 * kRing * kBK; r += kMmaThreads)
        *reinterpret_cast<uint4*>(sQ + r * kLd + d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    const int qk_cols = 8 * qk_chunks;
    for (int r = tid; r < kMmaRows + kRing * kBK; r += kMmaThreads)
      for (int c = qk_cols; c < 16 * NKS; c += 8)
        *reinterpret_cast<uint4*>(sQ + r * kLd + c) = make_uint4(0, 0, 0, 0);
    if constexpr (!S::kOneDot) {
      for (int r = tid; r < kRing * kBK; r += kMmaThreads)
        for (int c = d; c < 16 * NK; c += 8)
          *reinterpret_cast<uint4*>(sV + r * kLdV + c) = make_uint4(0, 0, 0, 0);
    }
  }
  if constexpr (S::kSum == 2) {
    // the ones tile: V's padding columns 16 NK .. 16 NK + 7 of every row
    for (int r = tid; r < kRing * kBK; r += kMmaThreads)
      *reinterpret_cast<uint4*>(sV + r * kLdV + 16 * NK) =
          make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
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
      bf16* dv = sV + (it % kRing) * kTileV;
      // rows up to the next multiple of 16 past kv; keys >= kv are zeros
      const int rows = min(kBK, (kv - k0 + 15) & ~15);
      if constexpr (!kWide) {
        for (int idx = tid; idx < rows * chunks; idx += kMmaThreads) {
          const int r = idx / chunks, c = idx - r * chunks;
          const bool real = k0 + r < kv;
          const long long off = (real ? k0 + r : 0) * in.token + 8 * c;
          tc::cp_async<16>(dk + r * kLd + 8 * c, kb + off, real ? 16 : 0);
          if (pass == 1) tc::cp_async<16>(dv + r * kLdV + 8 * c, vb + off, real ? 16 : 0);
        }
      } else {
        for (int idx = tid; idx < rows * qk_chunks; idx += kMmaThreads) {
          const int r = idx / qk_chunks, c = idx - r * qk_chunks;
          const bool real = k0 + r < kv;
          tc::cp_async<16>(dk + r * kLd + 8 * c, kb + (real ? k0 + r : 0) * in.token + 8 * c,
                           real ? 16 : 0);
        }
        if (!S::kOneDot && pass == 1) {
          for (int idx = tid; idx < rows * chunks; idx += kMmaThreads) {
            const int r = idx / chunks, c = idx - r * chunks;
            const bool real = k0 + r < kv;
            tc::cp_async<16>(dv + r * kLdV + 8 * c, vb + (real ? k0 + r : 0) * in.token + 8 * c,
                             real ? 16 : 0);
          }
        }
      }
    }
    tc::cp_async_commit();  // possibly empty: the wait counts stay uniform
  };

  // Q rows (zeros past kv) join the first tile's group; then each thread
  // scales its own chunks in f32 and rounds them to bf16 once
  for (int idx = tid; idx < kMmaRows * qk_chunks; idx += kMmaThreads) {
    const int r = idx / qk_chunks, c = idx - r * qk_chunks;
    const bool real = q0 + r < kv;
    tc::cp_async<16>(sQ + r * kLd + 8 * c, qb + (real ? q0 + r : 0) * in.token + 8 * c,
                     real ? 16 : 0);
  }
  for (int it = 0; it < kRing - 1; ++it) issue(it);
  tc::cp_async_wait<kRing - 2>();
  for (int idx = tid; idx < kMmaRows * qk_chunks; idx += kMmaThreads) {
    const int r = idx / qk_chunks, c = idx - r * qk_chunks;
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
  uint32_t qf[NKS][4];
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk)
    tc::ldmatrix_x4(qf[kk], sQ + (row0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);

  float o[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows g and g + 8 of the warp's 16: row max (safe) and row sum
  float m[2] = {fast ? 0.f : -__int_as_float(0x7f800000), fast ? 0.f : -__int_as_float(0x7f800000)};
  float l[2] = {0.f, 0.f};
  float lsum[4] = {0.f, 0.f, 0.f, 0.f};  // kSum 2: the row sums, every column
  float live = 0.f;                      // onedot: keeps every tile's products live
  const int lo = (head % grp.size) * d;  // onedot: the first key column stored

  for (int it = 0; it < nsteps; ++it) {
    tc::cp_async_wait<kRing - 2>();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    issue(it + kRing - 1);
    if (!active) continue;
    const int pass = first + (it >= ntiles);
    const int k0 = (it - (pass - first) * ntiles) * kBK;
    const int nch = min(4, (kv - k0 + 15) >> 4);  // 16-key chunks with a real key
    const bf16* tk = sK + (it % kRing) * kTile;
    const bf16* tv = sV + (it % kRing) * kTileV;

    // S = Q K^T: n8 tile j holds keys k0 + 8 j .. + 7
    float s[8][4];
#pragma unroll
    for (int c16 = 0; c16 < 4; ++c16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * c16][e] = s[2 * c16 + 1][e] = 0.f;
      if (c16 >= nch) continue;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        uint32_t kf[4];
        tc::ldmatrix_x4(kf, tk + (c16 * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                                kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * c16], qf[kk], kf[0], kf[1]);
        tc::mma_bf16(s[2 * c16 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    if constexpr (S::kOneDot) {
      // the stored keys lo .. lo + d - 1 that fall in this tile, as pairs
      // of neighbouring keys (lo and d are multiples of 8)
      if (k0 < lo + d && k0 + kBK > lo) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + 8 * j + 2 * q;
          if (key < lo || key >= lo + d) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int t = q0 + row0 + g + 8 * i;
            if (t >= seq) continue;
            const uint32_t v = tc::pack_bf16(s[j][2 * i], s[j][2 * i + 1]);
            for (int cp = 0; cp < grp.copies; ++cp)
              *reinterpret_cast<uint32_t*>(ob + t * os.token + cp * grp.copy_stride + key - lo) = v;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) live += s[j][0];  // each n8 tile's chain ends in s[j]
      continue;
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
          const float x =
              fast ? (S::kClamp ? fminf(s[j][e], 120.f) : s[j][e]) : s[j][e] - m[e >> 1];
          p = S::kExp == 1 ? exp2f(x) : (S::kExp == 2 ? tc::exp2_bf16(x) : x);
          if (sizes != nullptr) p *= sizes[(size_t)b * seq + key];
        }
        if constexpr (S::kSum == 1) l[e >> 1] += p;
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
        tc::ldmatrix_x4_trans(vf, tv + (c16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdV +
                                      n16 * 16 + (lane >> 4) * 8);
        tc::mma_bf16(o[2 * n16], pf, vf[0], vf[1]);
        tc::mma_bf16(o[2 * n16 + 1], pf, vf[2], vf[3]);
      }
      if constexpr (S::kSum == 2) {
        uint32_t uf[2];  // the ones tile's B fragment
        tc::ldmatrix_x2_trans(uf, tv + (c16 * 16 + (lane & 15)) * kLdV + 16 * NK);
        tc::mma_bf16(lsum, pf, uf[0], uf[1]);
      }
    }
  }

  if constexpr (S::kOneDot) {
    if (grp.copies < 0) *ob = __float2bfloat16_rn(live);  // never: copies >= 1
    return;
  }

  if constexpr (S::kSum == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  } else if constexpr (S::kSum == 2) {
    l[0] = lsum[0];  // rows g and g + 8, summed over all four lanes' keys
    l[1] = lsum[2];
  }
  // what is stored of an accumulator
  auto fin = [&](float v, float li) {
    if constexpr (S::kSum != 0) return v / li;
    if constexpr (S::kTimesGroup) return v * (float)grp.size;
    return v;
  };

  // o / l rounded to bf16, staged in this warp's rows of sQ (its Q is in
  // registers), then written as 16-byte stores
  bf16* so = sQ + row0 * kLd;
  const bool real0 = q0 + row0 + g < kv, real1 = q0 + row0 + g + 8 < kv;
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
    const int c = 8 * j + 2 * q;
    *reinterpret_cast<uint32_t*>(so + g * kLd + c) =
        real0 ? tc::pack_bf16(fin(o[j][0], l[0]), fin(o[j][1], l[0])) : 0u;
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kLd + c) =
        real1 ? tc::pack_bf16(fin(o[j][2], l[1]), fin(o[j][3], l[1])) : 0u;
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

}  // namespace attn
