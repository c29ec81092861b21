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
// overlaps the two and dequantizes each weight tile once per 256 rows of x
// (the f32 body: 128).
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
// f32 body (dequant_matmul_tf32: f32 activations, --dtype f32 --mm
// pallas, and a mesh's f32 row-parallel partials). The same TPU kernel
// with f32 x and y. At f32 the bound is the operations at 3xTF32 (a third
// of the TF32 tensor-core rate, ~165 TFLOP/s): ViT-B/16's qkv at B=64 is
// 44.6 GFLOP, 0.27 ms, against 0.05 ms of bytes. The FMA units alone (67
// TFLOP/s, and half of that where each FMA needs a shared-memory load, as
// in the FMA body this one replaces) cannot come near it, so every product
// runs on wgmma in 3xTF32: each f32 operand is split into TF32 high and
// low parts (tensor_core.cuh::split_tf32, hi rounded to nearest, lo = x -
// hi) and lo * hi, hi * lo, then hi * hi are summed in f32 accumulators,
// which keeps f32's accuracy. The tf32 wgmma forms read a shared-memory
// operand K-major only, so the block computes y's transpose: the
// dequantized weight is the A operand, from registers (each thread
// dequantizes and splits the 16 weights of its own fragments per step,
// with no shared weight tile to transpose), and x is the B operand, read
// from shared memory K-major as TMA lands it (one 32-row quant step of
// f32 x is one 128-byte swizzle row). A block owns 128 output columns
// (64 per warpgroup) x 128 rows of x, so each weight tile is dequantized
// once per 128 rows (the FMA body: 64), and loops over K in 32-row quant
// steps through a ring of 5 slots (x by TMA; codes, scales and mins by
// cp.async, the code tile padded so that the fragments' 2-byte reads are
// free of bank conflicts). While step k's 12 wgmma.m64n128k8 run, every
// thread splits step k + 2's x tile in place into hi and a lo tile beside
// it (read only after the next barrier), waits for step k - 1's wgmmas,
// meets the others at the step's one barrier and dequantizes step k + 1's
// fragments into a second register set, the only work between a barrier
// and the next step's wgmmas. Every 2 steps
// the tensor cores are drained and their partial sum is added to the
// running sum by rounded f32 additions: the tensor cores truncate each
// wgmma's sum, and kept in one accumulator over K = 3072 that bias
// reached 2.1e-5 of max|y|. Accumulators, partial sums and two fragment
// sets take ~250 registers: one block of 8 warps per SM, whose dequantize
// and split overlap the tensor cores only in part. The epilogue writes
// each thread's accumulators straight to y, two adjacent columns per
// 8-byte store, masking the ragged M and N edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "tensor_map.cuh"

namespace {

constexpr int kQK = 32;  // rows of K per quant block

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
constexpr int kFM = 128;           // rows of x per block: the wgmma's N
constexpr int kFN = 128;           // output columns per block: 64 per warpgroup, the wgmma's M
constexpr int kFLdc = kFN + 16;    // code tile row stride, bytes: fragment reads conflict-free

// Shared memory of the f32 body, from a 1024-aligned base: a ring of
// kStages slots, each the x tile of one 32-row quant step (128 rows x 32
// f32 = one 128-byte row per x row, in the 128-byte swizzle as TMA writes
// it, then split in place into its TF32 high part), its TF32 low part at
// the same offsets, the codes (32 rows x 128 columns, rows kFLdc bytes
// apart) and the scale and min rows; then one mbarrier per slot for its x
// tile.
struct SmemF32 {
  static constexpr int kStages = 5;
  static constexpr int kX = kFM * kQK * 4;
  static constexpr int kCodes = kQK * kFLdc;
  static constexpr int kStage = (2 * kX + kCodes + 2 * kFN * 4 + 1023) / 1024 * 1024;
  static constexpr int kBar = kStages * kStage;
  static constexpr int kBytes = kBar + kStages * 8;
  static_assert(kX % 1024 == 0, "atoms stay 1024-aligned");
};

// yT = W^T x^T in 3xTF32: warpgroup wg computes the 64 x 128 tile of yT
// for its 64 output columns and the block's 128 rows of x. A is the
// dequantized weight, from registers: each thread dequantizes and splits
// the 16 weights of its own fragments per step (two adjacent columns, 8
// rows of K). B is the x tile, K-major in shared memory as TMA lands it.
template <bool kMin>
__global__ void __launch_bounds__(kMmaThreads, 1)
    dequant_matmul_tf32(const __grid_constant__ CUtensorMap xmap,
                        const int8_t* __restrict__ codes,
                        const float* __restrict__ scales,
                        const float* __restrict__ mins, float* __restrict__ out,
                        int m, int n, int k, int offset) {
  using S = SmemF32;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int nsteps = k / kQK;
  const uintptr_t ca = reinterpret_cast<uintptr_t>(codes);
  const int cvec = n % 16 == 0 && ca % 16 == 0 ? 16 : n % 8 == 0 && ca % 8 == 0 ? 8 : 1;
  const bool svec = n % 4 == 0 && ((reinterpret_cast<uintptr_t>(scales) |
                                    reinterpret_cast<uintptr_t>(mins)) & 15) == 0;
  auto stage_x = [&](int s) { return smem + s * S::kStage; };
  auto stage_lo = [&](int s) { return smem + s * S::kStage + S::kX; };
  auto stage_c = [&](int s) { return smem + s * S::kStage + 2 * S::kX; };
  auto stage_s = [&](int s) {  // rows: scale, min
    return reinterpret_cast<float*>(smem + s * S::kStage + 2 * S::kX + S::kCodes);
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBar);  // x tile s has landed

  // The copies of quant step `step` into ring slot `s`: the x tile by TMA
  // (thread 0), the codes, scales and mins as one cp.async group of every
  // thread. Rows and columns out of range are zeros.
  auto issue = [&](int step, int s) {
    const int k0 = step * kQK;
    if (tid == 0) {
      tc::mbar_arrive_expect_tx(&full[s], S::kX);
      tc::tma_load_2d(stage_x(s), &xmap, k0, m0, &full[s]);
    }
    unsigned char* dc = stage_c(s);
    const int8_t* src = codes + (size_t)k0 * n + n0;
    if (cvec == 16) {  // one 16-byte chunk per thread
      static_assert(kQK * (kFN / 16) == kMmaThreads, "one chunk per thread");
      const int r = tid >> 3, c = (tid & 7) * 16;
      const bool ok = n0 + c < n;
      tc::cp_async<16>(dc + r * kFLdc + c, ok ? src + (size_t)r * n + c : codes, ok ? 16 : 0);
    } else if (cvec == 8) {
      for (int idx = tid; idx < kQK * (kFN / 8); idx += kMmaThreads) {
        const int r = idx >> 4, c = (idx & 15) * 8;
        const bool ok = n0 + c < n;
        tc::cp_async<8>(dc + r * kFLdc + c, ok ? src + (size_t)r * n + c : codes, ok ? 8 : 0);
      }
    } else {  // rows of codes off 8-byte alignment: plain loads
      for (int idx = tid; idx < kQK * kFN; idx += kMmaThreads) {
        const int r = idx / kFN, c = idx % kFN;
        dc[r * kFLdc + c] = n0 + c < n ? src[(size_t)r * n + c] : 0;
      }
    }
    float* ds = stage_s(s);
    for (int idx = tid; idx < (kMin ? 2 : 1) * (kFN / 4); idx += kMmaThreads) {
      const int row = idx >> 5, c = (idx & 31) * 4;
      const float* rsrc = (row == 0 ? scales : mins) + (size_t)step * n + n0 + c;
      if (svec) {
        const bool ok = n0 + c < n;
        tc::cp_async<16>(ds + row * kFN + c, ok ? rsrc : scales, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = n0 + c + e < n;
          tc::cp_async<4>(ds + row * kFN + c + e, ok ? rsrc + e : scales, ok ? 4 : 0);
        }
      }
    }
    tc::cp_async_commit();
  };

  // The x tile of slot `s` -> its TF32 high part in place and its low
  // part beside it, 16 bytes at a time at the offsets TMA wrote.
  auto split_x = [&](int s) {
    uint4* xs = reinterpret_cast<uint4*>(stage_x(s));
    uint4* ls = reinterpret_cast<uint4*>(stage_lo(s));
#pragma unroll
    for (int i = 0; i < S::kX / 16 / kMmaThreads; ++i) {
      const int idx = tid + i * kMmaThreads;
      const uint4 v = xs[idx];
      const tc::Split a = tc::split_tf32(__uint_as_float(v.x)),
                      b = tc::split_tf32(__uint_as_float(v.y)),
                      c = tc::split_tf32(__uint_as_float(v.z)),
                      d = tc::split_tf32(__uint_as_float(v.w));
      xs[idx] = make_uint4(a.hi, b.hi, c.hi, d.hi);
      ls[idx] = make_uint4(a.lo, b.lo, c.lo, d.lo);
    }
  };

  // Slot `s`'s codes -> this thread's A fragments of the step's four k8
  // slices, f[j] = {hi a0..a3, lo a0..a3}. Row r of warp w's 16 fragment
  // rows is output column pc = 16 w + 2 g (r = g) or pc + 1 (r = g + 8)
  // of the warpgroup's 64, so each k row is one 2-byte read, and the
  // warp's reads of 4 k rows (q) fall kFLdc bytes apart on 16 distinct
  // banks. A code becomes c - offset by the bf16 body's byte permute.
  const int pc = wg * 64 + (warp & 3) * 16 + 2 * g;
  const float bias = 8388608.f + 128.f + (float)offset;
  auto fragments = [&](int s, uint32_t (&f)[4][8]) {
    const float2 sv = *reinterpret_cast<const float2*>(stage_s(s) + pc);
    const float2 mv = kMin ? *reinterpret_cast<const float2*>(stage_s(s) + kFN + pc)
                           : make_float2(0.f, 0.f);
    const unsigned char* cs = stage_c(s) + pc;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // k = 8 j + q + 4 h
        const uint32_t cw =
            *reinterpret_cast<const uint16_t*>(cs + (8 * j + q + 4 * h) * kFLdc) ^ 0x8080u;
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // column pc + e: fragment row g + 8 e
          const float c = __int_as_float(__byte_perm(cw, 0x4B000000u, 0x7650 | e)) - bias;
          float v = __fmul_rn(c, e ? sv.y : sv.x);
          if (kMin) v = __fadd_rn(v, e ? mv.y : mv.x);
          const tc::Split p = tc::split_tf32(v);
          f[j][e + 2 * h] = p.hi;
          f[j][4 + e + 2 * h] = p.lo;
        }
      }
  };

  // part: a few steps' sum on the tensor cores; acc: the sum over K, in
  // rounded f32 additions (the tensor cores truncate each wgmma's sum, and
  // 3 K / 8 truncations into one accumulator would add up)
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t frag[2][4][8];

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
  tc::mbar_wait(&full[0], 0);
  __syncthreads();
  fragments(0, frag[0]);
  split_x(0);
  if (nsteps > 1) {
    tc::mbar_wait(&full[1], 0);
    split_x(1);
  }
  tc::fence_proxy_async();  // the split x tiles, for the wgmmas
  __syncthreads();

  // Step kb: its 12 wgmmas (lo * hi, hi * lo, hi * hi per k8 slice, as
  // tc::mma_3xtf32) run on the tensor cores into `part` while every
  // thread splits step kb + 2's x tile, waits for step kb - 1's wgmmas
  // (whose registers and ring slot it reuses), meets the others at the
  // step's one barrier, dequantizes step kb + 1's fragments into the
  // other register set and issues the copies of step kb + kStages - 1
  // into step kb - 1's ring slot. A split tile is so read by the wgmmas
  // only after the next step's barrier, and between a barrier and the
  // next wgmmas there is only the dequantize. Steps go in pairs so that
  // each names its register set, frag[h], at compile time; after each
  // pair the tensor cores are drained and acc += part.
  auto drain = [&] {
    tc::wgmma_wait<0>();
    tc::fence_operands(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  };
  for (int k2 = 0; k2 < nsteps; k2 += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kb = k2 + h;
      if (kb >= nsteps) break;
      const unsigned char* xs = stage_x(kb % kStages);
      const unsigned char* ls = stage_lo(kb % kStages);
      tc::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* f = frag[h][j];
        const uint64_t hi = tc::sw128_desc(xs + 32 * j, 16, 1024);
        const uint64_t lo = tc::sw128_desc(ls + 32 * j, 16, 1024);
        tc::wgmma_m64n128k8_tf32(part, f[4], f[5], f[6], f[7], hi, j > 0 || h > 0);
        tc::wgmma_m64n128k8_tf32(part, f[0], f[1], f[2], f[3], lo, 1);
        tc::wgmma_m64n128k8_tf32(part, f[0], f[1], f[2], f[3], hi, 1);
      }
      tc::wgmma_commit();
      if (kb + 2 < nsteps) {  // its slot's last reader, step kb - 3, is done
        tc::mbar_wait(&full[(kb + 2) % kStages], ((kb + 2) / kStages) & 1);
        split_x((kb + 2) % kStages);
        tc::fence_proxy_async();
      }
      if (kb + 1 < nsteps) {
        tc::wgmma_wait<1>();  // step kb - 1's wgmmas are done
        tc::cp_async_wait<kStages - 3>();  // step kb + 1's codes
        __syncthreads();  // every thread's copies are in, every warpgroup is past step kb - 1
        fragments((kb + 1) % kStages, frag[h ^ 1]);
      }
      const int next = kb + kStages - 1;
      if (next < nsteps) issue(next, next % kStages);
      else tc::cp_async_commit();
      if (h == 1) drain();
    }
  }
  if (nsteps & 1) drain();

  // yT's fragment rows g and g + 8 (columns pc, pc + 1), columns 8 j + 2 q
  // + i, are y[8 j + 2 q + i][pc, pc + 1]: acc[4 j + i], acc[4 j + 2 + i]
  const bool ovec = n % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  const int col = n0 + pc;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + 8 * j + 2 * q + i;
      if (row >= m || col >= n) continue;
      float* dst = out + (size_t)row * n + col;
      if (ovec) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[4 * j + i], acc[4 * j + 2 + i]);
      } else {
        dst[0] = acc[4 * j + i];
        if (col + 1 < n) dst[1] = acc[4 * j + 2 + i];
      }
    }
}

template <bool kMin>
cudaError_t launch_tf32(const void* x, const int8_t* codes, const float* scales,
                        const float* mins, float* out, int m, int n, int k, int offset,
                        cudaStream_t stream) {
  // x (M, K) f32 as TMA reads it: boxes of 128 rows x 32 columns (128
  // bytes), written in the 128-byte swizzle
  CUtensorMap xmap;
  const cudaError_t enc = tc::encode_sw128(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, k, m,
                                           (uint64_t)k * 4, kQK, kFM);
  if (enc != cudaSuccess) return enc;
  static bool configured = false;
  constexpr int bytes = SmemF32::kBytes + 1024;  // + alignment of the base
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_tf32<kMin>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  dequant_matmul_tf32<kMin><<<grid, kMmaThreads, bytes, stream>>>(xmap, codes, scales, mins,
                                                                  out, m, n, k, offset);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// x 16-byte aligned. dtype: 0 = float32, 1 = bfloat16 (x and y), 2 =
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
  if (reinterpret_cast<uintptr_t>(x) & 15) return (int)cudaErrorInvalidValue;  // TMA reads x
  if (dtype == 0)
    return (int)(mn ? launch_tf32<true>(x, c, sc, mn, static_cast<float*>(out), m, n, k, offset, s)
                    : launch_tf32<false>(x, c, sc, mn, static_cast<float*>(out), m, n, k, offset, s));
  if (dtype != 1 && dtype != 2) return (int)cudaErrorInvalidValue;
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
