// Multi-head attention for Hopper (sm_90a), CUDA C++: one kernel, two
// C entry points, each with its own launch counter in Python.
//
// vit_attention_qkv replaces the TPU kernels behind vit_cpp_tpu/ops/
// flash_attention.py::attention_qkv: _qkv_pair_kernel (d=64), _qkv_kernel
// + _sdpa (any d, odd head tails) and _qkv_lane_kernel (large T x h, via
// _attention_qkv_lane). It covers all of their shapes: T >= 1, d a
// multiple of 8 up to 128, bf16 or f32, fast (clamped) and safe
// (max-subtracted) softmax, the `kv` key mask and the ToMe `sizes` key
// weights. Its input qkv is the (B, T, 3h) output of the fused
// projection, [q | k | v] on the feature axis with heads contiguous inside
// each third (timm order); its output is (B, T, h).
//
// vit_flash_attention replaces flash_attention.py::flash_attention
// (_bhtd_kernel -> _sdpa in safe mode): q, k, v and the output are
// separate (B, H, T, D) tensors.
//
// The kernel reads Q, K and V through a (batch, head, token) stride set and
// writes the output through another, so both layouts are read in place:
// no head split or merge transposes exist in device memory.
//
// What bounds it on this card. At ViT-B/16 (T=197, h=768) attention is
// about 4 T^2 h = 0.12 GFLOP per image per layer against ~1.2 MB of qkv
// read and 0.3 MB written, i.e. ~80 FLOP per byte: below the H100's
// bf16 ridge (~295 FLOP/B) but far above what HBM needs, so the limit is
// on-chip: how fast the SM can feed operands to the multiply-adds. The
// (T, T) score matrix never leaves the SM.
//
// What the design does about it. One thread block per (batch, head,
// 64-query tile); 256 threads arranged 16 x 16. Key and value tiles of 64
// rows are staged through shared memory (K and V of one head at T=785,
// d=88 would not fit whole), converted to f32 once on the way in. Each
// thread owns a 4 x 4 block of the score tile and a 4 x ceil(d/16) block
// of the output accumulator in registers; row strides in shared memory
// are padded so that a half-warp's reads fall in distinct banks. The
// products run as plain f32 FMAs: a first, simple kernel; mma.sync /
// wgmma with TMA staging are later work.
//
// Numerics, as in the TPU kernel (flash_attention.py _sdpa and
// _qkv_pair_kernel):
//  1. Q is scaled by log2(e)/sqrt(d) in f32 and rounded to the input type
//     before Q K^T; scores accumulate in f32.
//  2. fast: s = min(s, 120) with no row max. safe: s - max over the real
//     keys. Safe mode takes the exact row max in a first pass over the
//     keys (the scores are recomputed in the second pass), so the weights
//     are exp2(s - max) as in the TPU kernel, not an online rescale.
//  3. p = exp2(s), times the key mask (keys >= kv are skipped: weight 0),
//     times sizes[key] when given.
//  4. l = sum p in f32 from the f32 p; the PV product uses p rounded to
//     the input type with f32 accumulation; o / l after PV, then cast.
// Query rows >= kv (token padding) are written as zeros, as the composed
// path (_attention_qkv_xla) does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // query rows per thread: ty + 16 * i
constexpr int kCols = 4;       // score columns per thread: tx + 16 * j
constexpr int kPStride = kBK + 1;

template <typename T>
struct Conv;

template <>
struct Conv<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Conv<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__host__ __device__ constexpr size_t smem_floats(int d, int dc) {
  // Q (64 x d+1) + K (64 x d+1) + V (64 x 16*dc) + P (64 x 65)
  return (size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) + (size_t)kBK * 16 * dc +
         (size_t)kBQ * kPStride;
}

// Element strides of a (batch, head, token, feature) view; feature stride 1.
struct Strides {
  long long batch, head, token;
};

// DC = ceil(d / 16): output columns per thread.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ qg, const T* __restrict__ kg,
                     const T* __restrict__ vg, Strides in,
                     const float* __restrict__ sizes, T* __restrict__ out,
                     Strides os, int seq, int d, int kv, float qscale,
                     int fast) {
  extern __shared__ float smem[];
  const int dq = d + 1;       // Q and K row stride (odd: no bank conflicts)
  const int dv = 16 * DC;     // V row stride (zero-filled past d)
  float* sQ = smem;
  float* sK = sQ + kBQ * dq;
  float* sV = sK + kBK * dq;
  float* sP = sV + kBK * dv;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.z;
  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const long long in_off = b * in.batch + head * in.head;
  const T* qb = qg + in_off;
  const T* kb = kg + in_off;
  const T* vb = vg + in_off;
  T* ob = out + b * os.batch + head * os.head;

  if (q0 >= kv) {  // every row of this tile is token padding
    for (int idx = tid; idx < kBQ * d; idx += kThreads) {
      const int r = idx / d, c = idx - (idx / d) * d;
      if (q0 + r < seq) ob[(q0 + r) * os.token + c] = Conv<T>::store(0.f);
    }
    return;
  }

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int t = q0 + r;
    float v = 0.f;
    if (t < seq) {
      v = Conv<T>::round(Conv<T>::load(qb[t * in.token + c]) * qscale);
    }
    sQ[r * dq + c] = v;
  }

  for (int idx = tid; idx < kBK * (dv - d); idx += kThreads) {
    // V columns past d: zeros, so the P V loop needs no column guard
    const int r = idx / (dv - d), c = d + idx % (dv - d);
    sV[r * dv + c] = 0.f;
  }

  float m[kRows];
  float l[kRows];
  float o[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = fast ? 0.f : -__int_as_float(0x7f800000);  // -inf
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[i][j] = 0.f;
  }

  // pass 0 (safe mode only): exact row max; pass 1: weights and P V
  for (int pass = fast ? 1 : 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < kv; k0 += kBK) {
      __syncthreads();  // previous tile's readers are done
      for (int idx = tid; idx < kBK * d; idx += kThreads) {
        const int r = idx / d, c = idx - r * d;
        const int t = k0 + r;
        float kval = 0.f, vval = 0.f;
        if (t < kv) {
          kval = Conv<T>::load(kb[t * in.token + c]);
          if (pass == 1) vval = Conv<T>::load(vb[t * in.token + c]);
        }
        sK[r * dq + c] = kval;
        if (pass == 1) sV[r * dv + c] = vval;
      }
      __syncthreads();

      float s[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < d; ++c) {
        float qv[kRows], kvv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty + 16 * i) * dq + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) kvv[j] = sK[(tx + 16 * j) * dq + c];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kvv[j], s[i][j]);
      }

      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            if (k0 + tx + 16 * j < kv) m[i] = fmaxf(m[i], s[i][j]);
        continue;
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int key = k0 + tx + 16 * j;
          float p = 0.f;
          if (key < kv) {
            p = exp2f(fast ? fminf(s[i][j], 120.f) : s[i][j] - m[i]);
            if (sizes != nullptr) p *= sizes[(size_t)b * seq + key];
          }
          l[i] += p;
          sP[(ty + 16 * i) * kPStride + tx + 16 * j] = Conv<T>::round(p);
        }
      }
      __syncthreads();

      const int nk = min(kBK, kv - k0);
      for (int k = 0; k < nk; ++k) {
        float pv[kRows], vv[DC];
#pragma unroll
        for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty + 16 * i) * kPStride + k];
#pragma unroll
        for (int j = 0; j < DC; ++j) vv[j] = sV[k * dv + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
      }
    }
    if (pass == 0) {
      // the 16 threads of one row group are 16 consecutive lanes
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        const float v = t < kv ? o[i][j] / l[i] : 0.f;
        ob[t * os.token + c] = Conv<T>::store(v);
      }
    }
  }
}

// The operands of one launch: Q, K, V and output pointers with their
// strides, the ToMe sizes (or null) and the geometry.
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  Strides in;
  const float* sizes;
  T* out;
  Strides os;
  int batch, seq, nh, d, kv;
  float qscale;
  int fast;
};

template <typename T, int DC>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  static bool configured = false;
  const size_t max_bytes = smem_floats(16 * DC, DC) * sizeof(float);
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T, DC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.seq + kBQ - 1) / kBQ, a.nh, a.batch);
  const size_t bytes = smem_floats(a.d, DC) * sizeof(float);
  attention_kernel<T, DC><<<grid, kThreads, bytes, stream>>>(
      a.q, a.k, a.v, a.in, a.sizes, a.out, a.os, a.seq, a.d, a.kv, a.qscale,
      a.fast);
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

bool bad_geometry(int batch, int seq, int nh, int d) {
  return batch < 1 || seq < 1 || nh < 1 || d < 8 || d > 128 || d % 8 != 0 ||
         batch > 65535 || nh > 65535;
}

// Fused QKV: q | k | v thirds of (B, T, 3h) rows; output (B, T, h).
template <typename T>
cudaError_t run_qkv(const void* qkv, const void* sizes, void* out, int batch,
                    int seq, int nh, int d, int kv, float qscale, int fast,
                    cudaStream_t stream) {
  const long long h = (long long)nh * d;
  const T* base = static_cast<const T*>(qkv);
  const Args<T> a{base, base + h, base + 2 * h, Strides{seq * 3 * h, d, 3 * h},
                  static_cast<const float*>(sizes), static_cast<T*>(out),
                  Strides{seq * h, d, h}, batch, seq, nh, d, kv, qscale, fast};
  return dispatch<T>(a, stream);
}

// Split heads: q, k, v and output each (B, H, T, D); safe softmax.
template <typename T>
cudaError_t run_bhtd(const void* q, const void* k, const void* v, void* out,
                     int batch, int nh, int seq, int d, float qscale,
                     cudaStream_t stream) {
  const Strides st{(long long)nh * seq * d, (long long)seq * d, d};
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), st, nullptr, static_cast<T*>(out),
                  st, batch, seq, nh, d, seq, qscale, 0};
  return dispatch<T>(a, stream);
}

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// dtype: 0 = float32, 1 = bfloat16. sizes: (B, T) float32 or null.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int vit_attention_qkv(const void* qkv, const void* sizes, void* out,
                                 int batch, int seq, int nh, int d, int kv,
                                 float qscale, int fast, int dtype,
                                 void* stream) {
  if (bad_geometry(batch, seq, nh, d) || kv < 1 || kv > seq) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_qkv<float>(qkv, sizes, out, batch, seq, nh, d, kv, qscale, fast, s);
  if (dtype == 1)
    return (int)run_qkv<__nv_bfloat16>(qkv, sizes, out, batch, seq, nh, d, kv, qscale, fast, s);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, out: contiguous (B, H, T, D). dtype as above. Safe softmax.
extern "C" int vit_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int batch, int nh, int seq, int d,
                                   float qscale, int dtype, void* stream) {
  if (bad_geometry(batch, seq, nh, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run_bhtd<float>(q, k, v, out, batch, nh, seq, d, qscale, s);
  if (dtype == 1)
    return (int)run_bhtd<__nv_bfloat16>(q, k, v, out, batch, nh, seq, d, qscale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
