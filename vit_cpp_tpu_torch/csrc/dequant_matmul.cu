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
// and the bytes of its codes.
//
// What the design does about it. Unlike the TPU kernel, whose grid step
// holds the full K of a column tile in VMEM, a block here owns one
// (64 x 128) output tile (bf16) or (64 x 64) (f32) and loops over K in
// steps of one 32-row quant block. Each step stages the x tile and the
// dequantized weight tile in shared memory, double-buffered: the next
// step's x, int8 codes (a quarter of the f32 weight bytes, half of bf16's)
// and its row of scales (and mins) are loaded into registers while the
// tensor cores work on the current step, so one __syncthreads per step
// suffices. The weight is dequantized once per step in registers on its
// way into shared memory, so every multiply reads a ready bf16 operand.
// bf16 x runs on the tensor cores through wmma (16x16x16 bf16, f32
// accumulators; 8 warps, 32 x 32 outputs each); f32 x runs f32 FMAs
// (4 x 4 outputs per thread). Ragged M and N edges are masked on load and
// store; the head's small M is one row of blocks, where launch time
// dominates. wgmma with TMA staging is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kQK = 32;  // rows of K per quant block: the K step
constexpr int kThreads = 256;

// W consecutive codes of row `row` from column `col`; zero past n.
template <int W>
struct __align__(16) Codes {
  int8_t c[W];
};

template <int W>
__device__ __forceinline__ Codes<W> load_codes(const int8_t* __restrict__ codes,
                                               int row, int col, int n,
                                               bool vec) {
  Codes<W> out;
  const int8_t* p = codes + (size_t)row * n + col;
  if (vec && col + W <= n) {
    if constexpr (W == 16) {
      *reinterpret_cast<uint4*>(out.c) = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      *reinterpret_cast<uint2*>(out.c) = __ldg(reinterpret_cast<const uint2*>(p));
    }
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
constexpr int kBM = 64;          // output rows per block
constexpr int kBN = 128;         // output columns per block
constexpr int kLdx = kQK + 8;    // x tile row stride (bf16)
constexpr int kLdb = kBN + 8;    // weight tile row stride (bf16)
constexpr int kLdc = kBN + 4;    // output staging row stride (f32)
constexpr int kXBytes = kBM * kLdx * 2;
constexpr int kStage = kXBytes + kQK * kLdb * 2;
constexpr int kSmemBf16 =
    2 * kStage > kBM * kLdc * 4 ? 2 * kStage : kBM * kLdc * 4;

__global__ void __launch_bounds__(kThreads)
    dequant_matmul_bf16(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ codes,
                        const float* __restrict__ scales,
                        const float* __restrict__ mins,
                        __nv_bfloat16* __restrict__ out, int m, int n, int k,
                        int offset) {
  __shared__ __align__(128) unsigned char smem[kSmemBf16];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 2 x 4 warps, 32 x 32 outputs each
  const int wn = warp & 3;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const bool has_min = mins != nullptr;
  const bool vec = n % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const bool vec_s = n % 4 == 0 && ((reinterpret_cast<uintptr_t>(scales) |
                                     reinterpret_cast<uintptr_t>(mins)) & 15) == 0;

  // x tile: one 8-element (16-byte) chunk per thread
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const bool x_in = m0 + xr < m;
  const __nv_bfloat16* xp = x + (size_t)(m0 + xr) * k + xc;
  // weight tile: 16 columns of one of the 32 rows per thread
  const int br = tid >> 3, bc = (tid & 7) * 16;
  const int col = n0 + bc;

  uint4 xv;
  Codes<16> cv;
  float sv[16], mv[16] = {};
  auto fetch = [&](int kb) {
    xv = x_in ? __ldg(reinterpret_cast<const uint4*>(xp + (size_t)kb * kQK))
              : make_uint4(0, 0, 0, 0);
    cv = load_codes<16>(codes, kb * kQK + br, col, n, vec);
    load_row<16>(scales + (size_t)kb * n + col, col, n, vec_s, sv);
    if (has_min) load_row<16>(mins + (size_t)kb * n + col, col, n, vec_s, mv);
  };
  auto stage_x = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem + buf * kStage);
  };
  auto stage_w = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem + buf * kStage + kXBytes);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nkb = k / kQK;
  fetch(0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int buf = kb & 1;
    *reinterpret_cast<uint4*>(stage_x(buf) + xr * kLdx + xc) = xv;
    __align__(16) __nv_bfloat16 wv[16];
#pragma unroll
    for (int w = 0; w < 16; ++w)
      wv[w] = __float2bfloat16_rn(dequant(cv.c[w], offset, sv[w], mv[w], has_min));
    uint4* dst = reinterpret_cast<uint4*>(stage_w(buf) + br * kLdb + bc);
    dst[0] = reinterpret_cast<const uint4*>(wv)[0];
    dst[1] = reinterpret_cast<const uint4*>(wv)[1];
    // one barrier per step: the buffer written here was last read two
    // steps ago, before every thread passed the previous step's barrier
    __syncthreads();
    if (kb + 1 < nkb) fetch(kb + 1);

    const __nv_bfloat16* sx = stage_x(buf);
    const __nv_bfloat16* sw = stage_w(buf);
#pragma unroll
    for (int kk = 0; kk < kQK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sx + (wm * 32 + i * 16) * kLdx + kk, kLdx);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sw + kk * kLdb + wn * 32 + j * 16, kLdb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // stage the f32 tile in shared memory, then write the ragged edge masked
  __syncthreads();
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sc + (wm * 32 + i * 16) * kLdc + wn * 32 + j * 16,
                              acc[i][j], kLdc, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN;
    if (m0 + r < m && n0 + c < n)
      out[(size_t)(m0 + r) * n + n0 + c] = __float2bfloat16_rn(sc[r * kLdc + c]);
  }
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
// dtype: 0 = float32, 1 = bfloat16 (x and y). mins: (K/32, N) f32 or null.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int vit_dequant_matmul(const void* x, const void* codes,
                                  const void* scales, const void* mins,
                                  void* out, int m, int n, int k, int offset,
                                  int dtype, void* stream) {
  if (m < 1 || n < 1 || k < kQK || k % kQK != 0 || offset < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  const float* mn = static_cast<const float*>(mins);
  if (dtype == 1) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    dequant_matmul_bf16<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), c, sc, mn,
        static_cast<__nv_bfloat16*>(out), m, n, k, offset);
  } else if (dtype == 0) {
    const dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    dequant_matmul_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), c, sc, mn, static_cast<float*>(out), m,
        n, k, offset);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
