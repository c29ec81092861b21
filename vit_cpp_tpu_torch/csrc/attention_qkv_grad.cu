// Backward of the fused-QKV attention for Hopper (sm_90a), CUDA C++.
//
// vit_attention_qkv_grad replaces the TPU kernels behind vit_cpp_tpu/ops/
// flash_attention.py::_attention_qkv_grad: _qkv_grad_pair_kernel (d=64),
// _qkv_grad_kernel + _qkv_grad_head (any d, odd head tails) and
// _qkv_grad_lane_kernel (large T x h, via _attention_qkv_grad_lane). It
// covers all of their shapes: T >= 1, d a multiple of 8 up to 128, bf16
// or f32, with or without the ToMe `sizes` key weights. Its inputs are the
// (B, T, 3h) output of the fused projection ([q | k | v] on the feature
// axis, heads contiguous inside each third) and the (B, T, h) cotangent
// dO of the attention output; its output is the (B, T, 3h) cotangent
// [dq | dk | dv] in the same layout. Q, K, V and dO are read in place and
// dq, dk, dv written in place: no head split or concat in device memory.
//
// Per head it computes what _qkv_grad_head computes (the forward is
// recomputed from qkv; no (T, T) tensor ever reaches device memory):
//   qs = round_T(q * log2(e)/sqrt(d)); s = qs k^T (f32);
//   p = exp2(s - rowmax s) [* sizes[key]]; pn = p / sum p;
//   dv = round_T(pn)^T dO; dp = dO v^T; r = sum_keys dp * pn;
//   ds = round_T(pn * (dp - r));
//   dq = ds k / sqrt(d); dk = ds^T q / sqrt(d) (q unscaled);
// every product accumulated in f32 and cast to T on store.
//
// What bounds it on this card. At ViT-B/16 (T=197, d=64) the backward is
// five T x T x d products per head (~0.15 GFLOP per image per layer)
// against ~2 MB of qkv, dO and dqkv traffic: on-chip operand feed, as for
// the forward kernel (attention_qkv.cu), not HBM.
//
// What the design does about it. Blocks run in no order and share
// nothing, so the reductions over keys (dq) and over queries (dk, dv)
// are split into two launches, with no atomics (deterministic):
//   A. one block per (batch, head, 64-query tile). Passes over 64-key
//      tiles take the exact row max, then sum p and u = sum dp * p
//      (r = u / sum p, which is sum dp * pn up to f32 rounding), then
//      dq. It writes dq and the per-row (max, sum p, r) into an f32
//      workspace (B, nh, T, 3).
//   B. one block per (batch, head, 64-key tile). It walks the query
//      tiles, recomputes pn from the stored row statistics and keeps dk
//      and dv in registers.
// Scores are recomputed in the same order of summation in both launches,
// so A's statistics fit B's scores bit for bit. 256 threads (16 x 16);
// each thread owns a 4 x 4 block of a 64 x 64 score tile and a 4 x
// ceil(d/16) block of an accumulator. Tiles are staged in shared memory
// as f32 (16-byte global loads) with a row stride of 16 ceil(d/16) + 4
// floats (columns past d zero): 16-byte aligned, and an odd number of
// 16-byte chunks, so the 16-byte operand loads of the products (four
// terms of a dot product, or four keys of an accumulation, per load) fall
// in distinct banks. Plain f32 FMAs: tensor cores and TMA are later work.
//
// Numerics. The softmax and ds chains use __fmul_rn / __fsub_rn /
// __fdiv_rn so that nvcc cannot contract them into FMAs the plain
// version does not do. Pad keys of the last tile get p = 0 and pad query
// rows pn = 0, so neither reaches a real row's statistics or gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTile = 64;      // queries or keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // tile rows per thread: ty + 16 * i
constexpr int kCols = 4;       // tile columns per thread: tx + 16 * j
constexpr int kPS = kTile + 4; // row stride of the 64 x 64 p / ds tiles

template <typename T>
struct Conv;

// Four consecutive elements of T (16- or 8-byte aligned) as a float4.
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &u.x, sizeof(lo));
    memcpy(&hi, &u.y, sizeof(hi));
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

template <>
struct Conv<float> {
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Conv<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// Row stride of a staged (64 x d) tile: 16 * DC columns + 4 floats.
template <int DC>
__host__ __device__ constexpr int ld() {
  return 16 * DC + 4;
}

template <int DC>
__host__ __device__ constexpr size_t rows_smem_floats() {
  // qs, dO, K, V tiles + the ds tile
  return 4 * (size_t)kTile * ld<DC>() + (size_t)kTile * kPS;
}

template <int DC>
__host__ __device__ constexpr size_t cols_smem_floats() {
  // K, V, qs, q, dO tiles + the p / ds tile + row max, sum, r
  return 5 * (size_t)kTile * ld<DC>() + (size_t)kTile * kPS + 3 * kTile;
}

// Stage rows row0 .. row0+63 of one head's (T, d) slice into `dst` as f32
// (row stride ld<DC>()), zero past T and past d, four columns per load
// (d % 8 == 0, so a group of four lies wholly inside or outside d).
// `scaled`: round_T(v * scale).
template <typename T, int DC>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int seq, int d, float scale,
                                          bool scaled) {
  constexpr int W4 = 4 * DC;  // groups of four columns per staged row
  for (int idx = threadIdx.x; idx < kTile * W4; idx += kThreads) {
    const int r = idx / W4, c = 4 * (idx - (idx / W4) * W4);
    const int t = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < seq && c < d) {
      v = Vec4<T>::load(src + (long long)t * row_stride + c);
      if (scaled) {
        v = make_float4(Conv<T>::round(__fmul_rn(v.x, scale)),
                        Conv<T>::round(__fmul_rn(v.y, scale)),
                        Conv<T>::round(__fmul_rn(v.z, scale)),
                        Conv<T>::round(__fmul_rn(v.w, scale)));
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld<DC>() + c) = v;
  }
}

// s[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c], c = 0 .. d-1 in order,
// four terms per 16-byte load.
template <int DC>
__device__ __forceinline__ void tile_dot(float (&s)[kRows][kCols],
                                         const float* a, const float* b,
                                         int d, int ty, int tx) {
  constexpr int L = ld<DC>();
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < d; c += 4) {
    float4 av[kRows], bv[kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * L + c);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * L + c);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][jj] += p[i] * m[tx + 16 jj]: one row of an accumulation.
template <int DC>
__device__ __forceinline__ void acc_row(float (&acc)[kRows][DC],
                                        const float (&p)[kRows],
                                        const float* m, int tx) {
  float mv[DC];
#pragma unroll
  for (int jj = 0; jj < DC; ++jj) mv[jj] = m[tx + 16 * jj];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(p[i], mv[jj], acc[i][jj]);
}

// acc[i][jj] += sum_k p[ty + 16 i][k] * m[k][tx + 16 jj] over all 64 k in
// order (entries of p past the real keys or queries are zero, and so are
// the staged rows of m there), four k per 16-byte load of p.
template <int DC>
__device__ __forceinline__ void tile_acc(float (&acc)[kRows][DC],
                                         const float* p, const float* m,
                                         int ty, int tx) {
  constexpr int L = ld<DC>();
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 pv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kPS + k);
    float px[kRows], py[kRows], pz[kRows], pw[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      px[i] = pv[i].x;
      py[i] = pv[i].y;
      pz[i] = pv[i].z;
      pw[i] = pv[i].w;
    }
    acc_row<DC>(acc, px, m + k * L, tx);
    acc_row<DC>(acc, py, m + (k + 1) * L, tx);
    acc_row<DC>(acc, pz, m + (k + 2) * L, tx);
    acc_row<DC>(acc, pw, m + (k + 3) * L, tx);
  }
}

// Sum (or max) over the 16 threads of one row group: 16 consecutive lanes.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The operands of one call.
template <typename T>
struct Args {
  const T* qkv;         // (B, T, 3h)
  const T* dout;        // (B, T, h)
  const float* sizes;   // (B, T) or null
  T* dqkv;              // (B, T, 3h)
  float* stats;         // (B, nh, T, 3): row max, sum p, r
  int batch, seq, nh, d;
  float qscale, nat;
};

// Launch A: one block per (batch, head, 64-query tile) -> dq, row stats.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    grad_rows_kernel(Args<T> a) {
  constexpr int L = ld<DC>();
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // qs (scaled, rounded)
  float* sO = sQ + kTile * L;    // dO
  float* sK = sO + kTile * L;
  float* sV = sK + kTile * L;
  float* sS = sV + kTile * L;    // ds, 64 x kPS

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int seq = a.seq, d = a.d;
  const long long h = (long long)a.nh * d;
  const long long row3 = 3 * h;
  const T* xb = a.qkv + (long long)b * seq * row3 + (long long)head * d;
  const T* ob = a.dout + (long long)b * seq * h + (long long)head * d;
  const float* sz = a.sizes == nullptr ? nullptr : a.sizes + (long long)b * seq;

  load_tile<T, DC>(sQ, xb, row3, q0, seq, d, a.qscale, true);
  load_tile<T, DC>(sO, ob, h, q0, seq, d, 1.f, false);

  float m[kRows], l[kRows], u[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -__int_as_float(0x7f800000);  // -inf
    l[i] = 0.f;
    u[i] = 0.f;
  }

  // pass 0: the exact row max over the real keys
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile<T, DC>(sK, xb + h, row3, k0, seq, d, 1.f, false);
    __syncthreads();
    float s[kRows][kCols];
    tile_dot<DC>(s, sQ, sK, d, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (k0 + tx + 16 * j < seq) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) m[i] = row_max(m[i]);

  // pass 1: sum p and sum dp * p
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile<T, DC>(sK, xb + h, row3, k0, seq, d, 1.f, false);
    load_tile<T, DC>(sV, xb + 2 * h, row3, k0, seq, d, 1.f, false);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<DC>(s, sQ, sK, d, ty, tx);
    tile_dot<DC>(dp, sO, sV, d, ty, tx);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int key = k0 + tx + 16 * j;
      if (key >= seq) continue;
      const float w = sz == nullptr ? 1.f : sz[key];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float p = exp2f(__fsub_rn(s[i][j], m[i]));
        if (sz != nullptr) p = __fmul_rn(p, w);
        l[i] = __fadd_rn(l[i], p);
        u[i] = fmaf(dp[i][j], p, u[i]);
      }
    }
  }
  float r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    l[i] = row_sum(l[i]);
    r[i] = __fdiv_rn(row_sum(u[i]), l[i]);
  }

  // pass 2: ds and dq = ds k
  float acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile<T, DC>(sK, xb + h, row3, k0, seq, d, 1.f, false);
    load_tile<T, DC>(sV, xb + 2 * h, row3, k0, seq, d, 1.f, false);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<DC>(s, sQ, sK, d, ty, tx);
    tile_dot<DC>(dp, sO, sV, d, ty, tx);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int key = k0 + tx + 16 * j;
      const float w = (sz == nullptr || key >= seq) ? 1.f : sz[key];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float ds = 0.f;
        if (key < seq) {
          float p = exp2f(__fsub_rn(s[i][j], m[i]));
          if (sz != nullptr) p = __fmul_rn(p, w);
          const float pn = __fdiv_rn(p, l[i]);
          ds = Conv<T>::round(__fmul_rn(pn, __fsub_rn(dp[i][j], r[i])));
        }
        sS[(ty + 16 * i) * kPS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_acc<DC>(acc, sS, sK, ty, tx);
  }

  T* dqb = a.dqkv + (long long)b * seq * row3 + (long long)head * d;
  float* st = a.stats + ((long long)b * a.nh + head) * seq * 3;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int c = tx + 16 * jj;
      if (c < d) dqb[(long long)t * row3 + c] = Conv<T>::store(__fmul_rn(acc[i][jj], a.nat));
    }
    if (tx == 0) {
      st[(long long)t * 3 + 0] = m[i];
      st[(long long)t * 3 + 1] = l[i];
      st[(long long)t * 3 + 2] = r[i];
    }
  }
}

// Launch B: one block per (batch, head, 64-key tile) -> dk, dv.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    grad_cols_kernel(Args<T> a) {
  constexpr int L = ld<DC>();
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kTile * L;
  float* sQs = sV + kTile * L;   // qs (scaled, rounded)
  float* sQ = sQs + kTile * L;   // q as stored
  float* sO = sQ + kTile * L;    // dO
  float* sP = sO + kTile * L;    // round(pn), then ds; 64 x kPS, [key][query]
  float* sM = sP + kTile * kPS;  // row max, sum p, r of the query tile
  float* sL = sM + kTile;
  float* sR = sL + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int seq = a.seq, d = a.d;
  const long long h = (long long)a.nh * d;
  const long long row3 = 3 * h;
  const T* xb = a.qkv + (long long)b * seq * row3 + (long long)head * d;
  const T* ob = a.dout + (long long)b * seq * h + (long long)head * d;
  const float* st = a.stats + ((long long)b * a.nh + head) * seq * 3;

  load_tile<T, DC>(sK, xb + h, row3, k0, seq, d, 1.f, false);
  load_tile<T, DC>(sV, xb + 2 * h, row3, k0, seq, d, 1.f, false);

  float w[kRows];  // sizes of this thread's keys
  bool real[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int key = k0 + ty + 16 * i;
    real[i] = key < seq;
    w[i] = (a.sizes == nullptr || !real[i]) ? 1.f : a.sizes[(long long)b * seq + key];
  }

  float dk[kRows][DC], dv[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();  // the previous query tile's readers are done
    load_tile<T, DC>(sQs, xb, row3, q0, seq, d, a.qscale, true);
    load_tile<T, DC>(sQ, xb, row3, q0, seq, d, 1.f, false);
    load_tile<T, DC>(sO, ob, h, q0, seq, d, 1.f, false);
    if (tid < kTile) {
      const int t = q0 + tid;
      const bool in = t < seq;
      sM[tid] = in ? st[(long long)t * 3 + 0] : 0.f;
      sL[tid] = in ? st[(long long)t * 3 + 1] : 1.f;
      sR[tid] = in ? st[(long long)t * 3 + 2] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<DC>(s, sK, sQs, d, ty, tx);  // [key][query]
    tile_dot<DC>(dp, sV, sO, d, ty, tx);
    float ds[kRows][kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int ql = tx + 16 * j;
      const bool qin = q0 + ql < seq;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float pn = 0.f;
        ds[i][j] = 0.f;
        if (real[i] && qin) {
          float p = exp2f(__fsub_rn(s[i][j], sM[ql]));
          if (a.sizes != nullptr) p = __fmul_rn(p, w[i]);
          pn = __fdiv_rn(p, sL[ql]);
          ds[i][j] = Conv<T>::round(__fmul_rn(pn, __fsub_rn(dp[i][j], sR[ql])));
        }
        sP[(ty + 16 * i) * kPS + ql] = Conv<T>::round(pn);
      }
    }
    __syncthreads();
    tile_acc<DC>(dv, sP, sO, ty, tx);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int i = 0; i < kRows; ++i) sP[(ty + 16 * i) * kPS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    tile_acc<DC>(dk, sP, sQ, ty, tx);
  }

  T* db = a.dqkv + (long long)b * seq * row3 + (long long)head * d;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (!real[i]) continue;
    const long long t = k0 + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      const int c = tx + 16 * jj;
      if (c < d) {
        db[t * row3 + h + c] = Conv<T>::store(__fmul_rn(dk[i][jj], a.nat));
        db[t * row3 + 2 * h + c] = Conv<T>::store(dv[i][jj]);
      }
    }
  }
}

template <typename T, int DC>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  static bool configured = false;
  const size_t rows_bytes = rows_smem_floats<DC>() * sizeof(float);
  const size_t cols_bytes = cols_smem_floats<DC>() * sizeof(float);
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        grad_rows_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)rows_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        grad_cols_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cols_bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.seq + kTile - 1) / kTile, a.nh, a.batch);
  grad_rows_kernel<T, DC><<<grid, kThreads, rows_bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grad_cols_kernel<T, DC><<<grid, kThreads, cols_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args<T>& a, cudaStream_t stream) {
  switch ((a.d + 15) / 16) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    case 4: return launch<T, 4>(a, stream);
    case 5: return launch<T, 5>(a, stream);
    case 6: return launch<T, 6>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    case 8: return launch<T, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(const void* qkv, const void* dout, const void* sizes,
                void* dqkv, void* stats, int batch, int seq, int nh, int d,
                float qscale, float nat, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(qkv), static_cast<const T*>(dout),
                  static_cast<const float*>(sizes), static_cast<T*>(dqkv),
                  static_cast<float*>(stats), batch, seq, nh, d, qscale, nat};
  return dispatch<T>(a, stream);
}

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// qkv, dqkv: contiguous (B, T, 3h); dout: contiguous (B, T, h); qkv and
// dout 16-byte aligned (four-element loads); sizes:
// (B, T) float32 or null; stats: an f32 workspace of B * nh * T * 3
// floats. dtype: 0 = float32, 1 = bfloat16. qscale = log2(e)/sqrt(d),
// nat = 1/sqrt(d). Returns cudaGetLastError() after the launches.
extern "C" int vit_attention_qkv_grad(const void* qkv, const void* dout,
                                      const void* sizes, void* dqkv,
                                      void* stats, int batch, int seq, int nh,
                                      int d, float qscale, float nat,
                                      int dtype, void* stream) {
  if (batch < 1 || seq < 1 || nh < 1 || d < 8 || d > 128 || d % 8 != 0 ||
      batch > 65535 || nh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, d, qscale, nat, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(qkv, dout, sizes, dqkv, stats, batch, seq, nh, d, qscale, nat, s);
  return (int)cudaErrorInvalidValue;
}
