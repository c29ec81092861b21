// Dequantizing matmul for the ggml block formats, Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel vit_cpp_tpu/ops/pallas_qmatmul.py::_qmm_kernel
// (launched by _qmm_2d through pallas_quant_matmul):
//
//     y[m, n] = sum_k x[m, k] * ((codes[k, n] - offset) * scale[k/32, n] [+ min[k/32, n]])
//
// for Q4_0 (offset 8), Q5_0 (16), Q4_1, Q5_1 (with min) and Q8_0. Layouts
// are the QuantLinear's: x (M, K) row-major in f32 or bf16, codes (K, N)
// int8, scales and mins (K/32, N) f32, y (M, N) in x's dtype. K % 32 == 0.
//
// Numerics, as in the TPU kernel: each weight is dequantized in f32 as
// (c - offset) * scale, then + min (two roundings, never a fused
// multiply-add), rounded to x's dtype, and multiplied with f32
// accumulation; y is rounded once to x's dtype. The bias is added outside.
//
// What bounds it on this card. At ViT-B/16 serving shapes the block
// linears have M = B * 197 rows (1576 at B=8): the qkv product is 2 M K N
// = 5.6 GFLOP against 1.2 MB of x, 1.8 MB of codes and 0.2 MB of scales
// read and 7.3 MB of y written, about 485 FLOP per byte. That is above the
// H100's bf16 ridge (~295 FLOP/B), so the block linears are bound by the
// multiply-adds, i.e. by how fast the tensor cores are fed. The head
// (M = B = 8, 768 -> 1000) does 12 MFLOP on 0.8 MB: bound by launch time
// and the bytes of its codes. Unlike a plain GEMM, every block also has to
// dequantize its weight tile, which costs SM issue slots and shared-memory
// bandwidth beside the tensor cores' operand reads; the design below
// overlaps the two and dequantizes each weight tile once per 256 rows of x.
//
// bf16 body (dequant_matmul_wgmma: serving), for Hopper's asynchronous
// tensor cores. Unlike the TPU kernel, whose grid step holds the full K of
// a column tile in VMEM, a block owns a BM x 128 output tile (BM = 256, or
// 128 with two blocks per SM where 256-row blocks would cover less than
// half of the SMs: the wrapper picks it, ops/qmatmul.py::tile_rows) and
// loops over K in steps of 64 rows (two quant blocks). Per step, a ring of
// 4 (BM = 256) or 3 slots stages the x tile by TMA, already in the 128-byte
// swizzle that wgmma reads, and the raw int8 codes with their scale and min
// rows by cp.async. The two warpgroups issue step k's wgmma.m64n128k16
// (bf16, f32 accumulators in registers, both operands read from shared
// memory) and, while the tensor cores run them, dequantize step k + 1 into
// the other of two weight tiles and issue the copies of step k + S - 1;
// then they wait for the wgmmas and meet at one barrier. The dequantize
// turns each code into a float with a byte permute and one exact
// subtraction (the 2^23 + 128 + offset trick) instead of the quarter-rate
// int-to-float conversion, and writes the bf16 weights MN-major in the
// 128-byte swizzle (wgmma's transposed-B layout), 16 bytes at a time
// without bank conflicts. The epilogue rounds once to bf16, stages the tile
// in shared memory and writes 16-byte stores, masking the ragged M and N
// edges. A second instantiation of the same body (OutT = float,
// dequant_matmul_wgmma_f32out) skips the rounding and writes the f32
// accumulators: the partial product of a row-parallel shard, summed over
// the ranks before it is rounded. Rows of codes that are not 16-byte aligned (N = 1000) take 8-byte
// copies, odd N plain loads.
//
// f32 body (dequant_matmul_f32): a block owns a 64 x 64 output tile and
// loops over K in 32-row quant steps with a one-step register prefetch;
// each thread runs 4 x 4 f32 FMAs per k, so it is bound by shared-memory
// operand feed. It serves f32 activations (--mm pallas with dtype f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "tensor_map.cuh"

namespace {

constexpr int kQK = 32;  // rows of K per quant block
constexpr int kThreads = 256;

// W consecutive codes of row `row` from column `col`; zero past n.
template <int W>
struct __align__(8) Codes {
  int8_t c[W];
};

template <int W>
__device__ __forceinline__ Codes<W> load_codes(const int8_t* __restrict__ codes,
                                               int row, int col, int n,
                                               bool vec) {
  Codes<W> out;
  const int8_t* p = codes + (size_t)row * n + col;
  if (vec && col + W <= n) {
    *reinterpret_cast<uint2*>(out.c) = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) out.c[w] = col + w < n ? p[w] : 0;
  }
  return out;
}

// W consecutive f32 values (scales or mins) of one row from column `col`;
// zero past n.
template <int W>
__device__ __forceinline__ void load_row(const float* __restrict__ p, int col,
                                         int n, bool vec, float (&v)[W]) {
  if (vec && col + W <= n) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = col + w < n ? __ldg(p + w) : 0.f;
  }
}

// The f32 weight of one code: (c - offset) * scale, then + min.
__device__ __forceinline__ float dequant(int8_t c, int offset, float s,
                                         float mn, bool has_min) {
  float v = __fmul_rn((float)((int)c - offset), s);
  return has_min ? __fadd_rn(v, mn) : v;
}

// ---------------------------------------------------------------- bf16 x
using bf16 = __nv_bfloat16;

constexpr int kBK = 2 * kQK;       // K rows per pipeline step: two quant blocks
constexpr int kTN = 128;           // output columns per block
constexpr int kMmaThreads = 256;   // two warpgroups
constexpr int kLdo = kTN + 8;      // output staging row stride (elements)

// Shared memory of a block of BM output rows (256, or 128 with two blocks
// on an SM), from a 1024-aligned base: a ring of kStages x (x tile of BM
// rows x 64 bf16 in the 128-byte swizzle, as TMA writes it; codes; 2 scale
// and 2 min rows), then two dequantized weight tiles of 64 x 128 bf16,
// MN-major in the 128-byte swizzle (atoms of 8 K rows x 64 N; the two N
// atoms of a K group side by side, lbo 1024 bytes; K groups 2048 bytes
// apart), then one mbarrier per ring slot for its x tile. The output tile
// is staged over the ring at the end (an f32 tile too: 139 KB of the 172
// KB ring at BM = 256, 70 of 80 KB at BM = 128).
template <int BM>
struct Smem {
  static constexpr int kStages = BM == 256 ? 4 : 3;  // copy ring: K steps in flight
  static constexpr int kX = BM * 128;
  static constexpr int kCodes = kBK * kTN;
  static constexpr int kStage = kX + kCodes + 4 * kTN * 4;
  static constexpr int kW = kBK * kTN * 2;
  static constexpr int kBar = kStages * kStage + 2 * kW;
  static constexpr int kBytes = kBar + kStages * 8;
  static_assert(kStage % 1024 == 0 && kX % 1024 == 0, "atoms stay 1024-aligned");
  static_assert(BM * kLdo * 4 <= kStages * kStage, "output tile staging, f32 too");
};

// The body of both bf16 kernels; OutT is the output's type: bf16 (y in
// x's dtype), or float, the f32 partial product of a row-parallel shard
// (ops/core.py::linear under a mesh), rounded only after its sum.
template <int BM, bool kMin, typename OutT>
__device__ __forceinline__ void wgmma_body(const CUtensorMap& xmap,
                                           const int8_t* __restrict__ codes,
                                           const float* __restrict__ scales,
                                           const float* __restrict__ mins,
                                           OutT* __restrict__ out, int m, int n, int k,
                                           int offset) {
  using S = Smem<BM>;
  constexpr int kStages = S::kStages, H = BM / 128;  // H accumulators of 64 x 128
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kTN;
  const int nsteps = (k + kBK - 1) / kBK;
  const int nkb = k / kQK;
  const uintptr_t ca = reinterpret_cast<uintptr_t>(codes);
  const int cvec = n % 16 == 0 && ca % 16 == 0 ? 16 : n % 8 == 0 && ca % 8 == 0 ? 8 : 1;
  const bool svec = n % 4 == 0 && ((reinterpret_cast<uintptr_t>(scales) |
                                    reinterpret_cast<uintptr_t>(mins)) & 15) == 0;
  auto stage_x = [&](int s) { return smem + s * S::kStage; };
  auto stage_c = [&](int s) { return reinterpret_cast<int8_t*>(smem + s * S::kStage + S::kX); };
  auto stage_s = [&](int s) {  // rows: scale 0, scale 1, min 0, min 1
    return reinterpret_cast<float*>(smem + s * S::kStage + S::kX + S::kCodes);
  };
  auto tile_w = [&](int i) { return smem + kStages * S::kStage + i * S::kW; };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBar);  // x tile s has landed

  // The copies of K step `step` into ring slot `s`: the x tile by TMA
  // (thread 0), the codes, scales and mins as one cp.async group of every
  // thread. Rows and columns out of range are zeros.
  auto issue = [&](int step, int s) {
    const int k0 = step * kBK;
    if (tid == 0) {
      tc::mbar_arrive_expect_tx(&full[s], S::kX);
      tc::tma_load_2d(stage_x(s), &xmap, k0, m0, &full[s]);
    }
    int8_t* dc = stage_c(s);
    if (cvec == 16) {
      for (int idx = tid; idx < kBK * (kTN / 16); idx += kMmaThreads) {
        const int r = idx >> 3, c = (idx & 7) * 16;
        const bool ok = k0 + r < k && n0 + c < n;
        tc::cp_async<16>(dc + r * kTN + c,
                         ok ? codes + (size_t)(k0 + r) * n + n0 + c : codes, ok ? 16 : 0);
      }
    } else if (cvec == 8) {
      for (int idx = tid; idx < kBK * (kTN / 8); idx += kMmaThreads) {
        const int r = idx >> 4, c = (idx & 15) * 8;
        const bool ok = k0 + r < k && n0 + c < n;
        tc::cp_async<8>(dc + r * kTN + c,
                        ok ? codes + (size_t)(k0 + r) * n + n0 + c : codes, ok ? 8 : 0);
      }
    } else {  // rows of codes off 8-byte alignment: plain loads
      for (int idx = tid; idx < kBK * kTN; idx += kMmaThreads) {
        const int r = idx / kTN, c = idx % kTN;
        dc[r * kTN + c] = k0 + r < k && n0 + c < n ? codes[(size_t)(k0 + r) * n + n0 + c] : 0;
      }
    }
    float* ds = stage_s(s);
    for (int idx = tid; idx < (kMin ? 4 : 2) * (kTN / 4); idx += kMmaThreads) {
      const int row = idx >> 5, c = (idx & 31) * 4;
      const int kb = k0 / kQK + (row & 1);
      const float* src = (row < 2 ? scales : mins) + (size_t)kb * n + n0 + c;
      if (svec) {
        const bool ok = kb < nkb && n0 + c < n;
        tc::cp_async<16>(ds + row * kTN + c, ok ? src : scales, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kb < nkb && n0 + c + e < n;
          tc::cp_async<4>(ds + row * kTN + c + e, ok ? src + e : scales, ok ? 4 : 0);
        }
      }
    }
    tc::cp_async_commit();
  };

  // The codes of ring slot `s` -> weight tile `w`: 8 columns x 4 rows (2 of
  // each quant block) per thread, one 16-byte chunk per row at its swizzled
  // place. A code c (int8) becomes the float 2^23 + 128 + c by one byte
  // permute of c ^ 0x80 under the exponent byte of 2^23, so c - offset is
  // one exact subtraction away (no int-to-float conversion).
  const int dcol = (tid & 15) * 8, drow = tid >> 4;
  const int watom = (dcol >> 6) * 1024, wchunk = (dcol & 63) >> 3;
  const float bias = 8388608.f + 128.f + (float)offset;
  auto dequantize = [&](int s, unsigned char* w) {
    const int8_t* cs = stage_c(s);
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      const float* sr = stage_s(s) + blk * kTN + dcol;
      float sv[8], mv[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(sr + 4 * h);
        sv[4 * h] = t.x, sv[4 * h + 1] = t.y, sv[4 * h + 2] = t.z, sv[4 * h + 3] = t.w;
        if (kMin) {
          const float4 u = *reinterpret_cast<const float4*>(sr + 2 * kTN + 4 * h);
          mv[4 * h] = u.x, mv[4 * h + 1] = u.y, mv[4 * h + 2] = u.z, mv[4 * h + 3] = u.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = blk * kQK + drow + 16 * i;
        const uint2 raw = *reinterpret_cast<const uint2*>(cs + r * kTN + dcol);
        const uint32_t cw[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
        uint32_t packed[4];
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = j + h;
            const float c =
                __int_as_float(__byte_perm(cw[e >> 2], 0x4B000000u, 0x7650 | (e & 3))) - bias;
            v[h] = __fmul_rn(c, sv[e]);
            if (kMin) v[h] = __fadd_rn(v[h], mv[e]);
          }
          packed[j >> 1] = tc::pack_bf16(v[0], v[1]);
        }
        const int kr = r & 7;
        *reinterpret_cast<uint4*>(w + (r >> 3) * 2048 + watom + kr * 128 + ((wchunk ^ kr) << 4)) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  };

  // warpgroup wg owns rows wg BM / 2 .. + BM / 2 - 1, as H m64n128 accumulators
  const int wg = warp >> 2;
  float acc[H][64];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) tc::mbar_init(&full[s], 1);
    tc::fence_mbarrier_init();
  }
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) issue(s, s);
    else tc::cp_async_commit();  // empty group: the wait count stays uniform
  }
  tc::cp_async_wait<kStages - 2>();
  __syncthreads();
  dequantize(0, tile_w(0));
  tc::fence_proxy_async();  // the weight tile, for the wgmmas
  __syncthreads();

  // Step kb: its wgmmas run on the tensor cores while every thread
  // dequantizes step kb + 1 into the other weight tile and issues the
  // copies of step kb + kStages - 1 into step kb - 1's ring slot; then one
  // wait and one barrier.
  for (int kb = 0; kb < nsteps; ++kb) {
    const unsigned char* xs = stage_x(kb % kStages) + wg * (BM / 2) * 128;
    const unsigned char* ws = tile_w(kb & 1);
    tc::mbar_wait(&full[kb % kStages], (kb / kStages) & 1);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = tc::sw128_desc(ws + kk * 4096, 1024, 2048);
#pragma unroll
      for (int h = 0; h < H; ++h)
        tc::wgmma_m64n128k16(acc[h], tc::sw128_desc(xs + h * 64 * 128 + kk * 32, 16, 1024), db);
    }
    tc::wgmma_commit();
    if (kb + 1 < nsteps) {
      tc::cp_async_wait<kStages - 3>();
      __syncthreads();  // every thread's copies of step kb + 1 are in
      dequantize((kb + 1) % kStages, tile_w((kb + 1) & 1));
      tc::fence_proxy_async();
    }
    // ring slot (kb - 1) % kStages was step kb - 1's, whose wgmmas every
    // warpgroup waited for before the last barrier
    const int next = kb + kStages - 1;
    if (next < nsteps) issue(next, next % kStages);
    else tc::cp_async_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < H; ++h) tc::fence_operands(acc[h]);
    __syncthreads();
  }

  // round once to bf16 (or keep f32), stage the tile over the ring, then
  // 16-byte stores masked at the edges: 8 bf16 or 4 f32 outputs each
  constexpr int kVec = 16 / sizeof(OutT), kShift = kVec == 8 ? 4 : 5;
  OutT* so = reinterpret_cast<OutT*>(smem);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      OutT* p = so + (wg * (BM / 2) + h * 64 + (warp & 3) * 16 + g) * kLdo + 8 * j + 2 * q;
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16(acc[h][4 * j], acc[h][4 * j + 1]);
        *reinterpret_cast<uint32_t*>(p + 8 * kLdo) =
            tc::pack_bf16(acc[h][4 * j + 2], acc[h][4 * j + 3]);
      } else {
        *reinterpret_cast<float2*>(p) = make_float2(acc[h][4 * j], acc[h][4 * j + 1]);
        *reinterpret_cast<float2*>(p + 8 * kLdo) =
            make_float2(acc[h][4 * j + 2], acc[h][4 * j + 3]);
      }
    }
  __syncthreads();
  const bool ovec = n % kVec == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int idx = tid; idx < BM * (kTN / kVec); idx += kMmaThreads) {
    const int r = idx >> kShift, c = (idx & (kTN / kVec - 1)) * kVec;
    const int row = m0 + r, col = n0 + c;
    if (row >= m || col >= n) continue;
    OutT* dst = out + (size_t)row * n + col;
    const OutT* src = so + r * kLdo + c;
    if (ovec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kVec && col + e < n; ++e) dst[e] = src[e];
    }
  }
}

template <int BM, bool kMin>
__global__ void __launch_bounds__(kMmaThreads, 256 / BM)
    dequant_matmul_wgmma(const __grid_constant__ CUtensorMap xmap,
                         const int8_t* __restrict__ codes,
                         const float* __restrict__ scales,
                         const float* __restrict__ mins,
                         bf16* __restrict__ out, int m, int n, int k,
                         int offset) {
  wgmma_body<BM, kMin, bf16>(xmap, codes, scales, mins, out, m, n, k, offset);
}

// The f32-output instantiation: bf16 x and weights, y the f32 accumulators.
template <int BM, bool kMin>
__global__ void __launch_bounds__(kMmaThreads, 256 / BM)
    dequant_matmul_wgmma_f32out(const __grid_constant__ CUtensorMap xmap,
                                const int8_t* __restrict__ codes,
                                const float* __restrict__ scales,
                                const float* __restrict__ mins,
                                float* __restrict__ out, int m, int n, int k,
                                int offset) {
  wgmma_body<BM, kMin, float>(xmap, codes, scales, mins, out, m, n, k, offset);
}

template <int BM, bool kMin, typename OutT>
cudaError_t launch_wgmma(const void* x, const int8_t* codes, const float* scales,
                         const float* mins, void* out, int m, int n, int k, int offset,
                         cudaStream_t stream) {
  const auto kernel = [] {
    if constexpr (sizeof(OutT) == 2) return dequant_matmul_wgmma<BM, kMin>;
    else return dequant_matmul_wgmma_f32out<BM, kMin>;
  }();
  // x (M, K) bf16 as TMA reads it: boxes of BM rows x 64 columns (128
  // bytes), written in the 128-byte swizzle
  CUtensorMap xmap;
  const cudaError_t enc = tc::encode_sw128(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m,
                                           (uint64_t)k * 2, kBK, BM);
  if (enc != cudaSuccess) return enc;
  static bool configured = false;
  constexpr int bytes = Smem<BM>::kBytes + 1024;  // + alignment of the base
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((n + kTN - 1) / kTN, (m + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kMmaThreads, bytes, stream>>>(xmap, codes, scales, mins,
                                                static_cast<OutT*>(out), m, n, k, offset);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 x
constexpr int kFM = 64;          // output rows per block
constexpr int kFN = 64;          // output columns per block
constexpr int kFLdx = kQK + 1;   // odd stride: no bank conflicts on store

__global__ void __launch_bounds__(kThreads)
    dequant_matmul_f32(const float* __restrict__ x,
                       const int8_t* __restrict__ codes,
                       const float* __restrict__ scales,
                       const float* __restrict__ mins, float* __restrict__ out,
                       int m, int n, int k, int offset) {
  __shared__ float sX[2][kFM * kFLdx];
  __shared__ __align__(16) float sW[2][kQK * kFN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // outputs: rows ty + 16 i, cols tx + 16 j
  const int m0 = blockIdx.y * kFM;
  const int n0 = blockIdx.x * kFN;
  const bool has_min = mins != nullptr;
  const bool vec = n % 8 == 0 && (reinterpret_cast<uintptr_t>(codes) & 7) == 0;
  const bool vec_s = n % 4 == 0 && ((reinterpret_cast<uintptr_t>(scales) |
                                     reinterpret_cast<uintptr_t>(mins)) & 15) == 0;

  // x tile: 64 rows x 8 float4 chunks, two chunks per thread
  int xr[2], xc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int chunk = tid + kThreads * r;
    xr[r] = chunk >> 3;
    xc[r] = (chunk & 7) * 4;
  }
  // weight tile: 8 columns of one of the 32 rows per thread
  const int br = tid >> 3, bc = (tid & 7) * 8;
  const int col = n0 + bc;

  float4 xv[2];
  Codes<8> cv;
  float sv[8], mv[8] = {};
  auto fetch = [&](int kb) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      xv[r] = m0 + xr[r] < m
                  ? __ldg(reinterpret_cast<const float4*>(
                        x + (size_t)(m0 + xr[r]) * k + (size_t)kb * kQK + xc[r]))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    cv = load_codes<8>(codes, kb * kQK + br, col, n, vec);
    load_row<8>(scales + (size_t)kb * n + col, col, n, vec_s, sv);
    if (has_min) load_row<8>(mins + (size_t)kb * n + col, col, n, vec_s, mv);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nkb = k / kQK;
  fetch(0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int buf = kb & 1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* d = &sX[buf][xr[r] * kFLdx + xc[r]];
      d[0] = xv[r].x;
      d[1] = xv[r].y;
      d[2] = xv[r].z;
      d[3] = xv[r].w;
    }
    float wv[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) wv[w] = dequant(cv.c[w], offset, sv[w], mv[w], has_min);
    float4* dst = reinterpret_cast<float4*>(&sW[buf][br * kFN + bc]);
    dst[0] = make_float4(wv[0], wv[1], wv[2], wv[3]);
    dst[1] = make_float4(wv[4], wv[5], wv[6], wv[7]);
    __syncthreads();  // one barrier per step, as in the bf16 kernel
    if (kb + 1 < nkb) fetch(kb + 1);

#pragma unroll 8
    for (int kk = 0; kk < kQK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sX[buf][(ty + 16 * i) * kFLdx + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sW[buf][kk * kFN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < n) out[(size_t)r * n + c] = acc[i][j];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// dtype: 0 = float32, 1 = bfloat16 (x and y; x 16-byte aligned), 2 =
// bfloat16 x with a float32 y (the bf16 body's f32 accumulators). mins:
// (K/32, N) f32 or null. tile_m: output rows per block of the bf16 body,
// 256 or 128 (the f32 body's tile is fixed). Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int vit_dequant_matmul(const void* x, const void* codes,
                                  const void* scales, const void* mins,
                                  void* out, int m, int n, int k, int offset,
                                  int dtype, int tile_m, void* stream) {
  if (m < 1 || n < 1 || k < kQK || k % kQK != 0 || offset < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  const float* mn = static_cast<const float*>(mins);
  if (dtype == 1 || dtype == 2) {
    if (reinterpret_cast<uintptr_t>(x) & 15) return (int)cudaErrorInvalidValue;
    if (tile_m != 256 && tile_m != 128) return (int)cudaErrorInvalidValue;
    if (dtype == 2)
      return (int)(tile_m == 256
                       ? (mn ? launch_wgmma<256, true, float>(x, c, sc, mn, out, m, n, k, offset, s)
                             : launch_wgmma<256, false, float>(x, c, sc, mn, out, m, n, k, offset, s))
                       : (mn ? launch_wgmma<128, true, float>(x, c, sc, mn, out, m, n, k, offset, s)
                             : launch_wgmma<128, false, float>(x, c, sc, mn, out, m, n, k, offset, s)));
    if (tile_m == 256)
      return (int)(mn ? launch_wgmma<256, true, bf16>(x, c, sc, mn, out, m, n, k, offset, s)
                      : launch_wgmma<256, false, bf16>(x, c, sc, mn, out, m, n, k, offset, s));
    return (int)(mn ? launch_wgmma<128, true, bf16>(x, c, sc, mn, out, m, n, k, offset, s)
                    : launch_wgmma<128, false, bf16>(x, c, sc, mn, out, m, n, k, offset, s));
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dequant_matmul_f32<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), c, sc, mn, static_cast<float*>(out), m,
      n, k, offset);
  return (int)cudaGetLastError();
}
