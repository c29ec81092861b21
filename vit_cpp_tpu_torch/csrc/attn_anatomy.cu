// Stage anatomy of the fused-QKV attention forward for Hopper (sm_90a),
// CUDA C++: one kernel, the stage chosen by a template variant.
//
// Replaces the TPU kernels of tools/attn_anatomy.py: run_pair_variant
// (_pair_kernel, the head-pair form) and run_variant (_kernel, the
// 128-lane panel form). Both are stage-toggled replicas of the serving
// attention kernel, timed variant by variant to split its time by stage.
// Here every variant is a replica of the port's forward kernel
// (attention_qkv.cu): one block per (batch, head, 64-query tile), 256
// threads (16 x 16), key and value tiles of 64 rows staged through shared
// memory as f32, each thread a 4 x 4 block of the score tile and a
// 4 x ceil(d/16) block of the output, plain f32 FMAs.
//
// Input qkv is (B, T, 3h) bf16 ([q | k | v] on the feature axis, heads
// contiguous inside each third); output (B, T, h) bf16. `group` heads
// form one group: 2 for the pair form, 128/d for the lane form. The
// group matters only where the JAX variant mixes heads. Variants:
//   full      p = exp2(min(s, 120)); o = round(p) V / sum p
//   mxusum    full's output, the row sum taken from the P V product
//             through a ones column in V's padded column 16*ceil(d/16)
//             (the sum of the rounded p, as the TPU's MXU sums it)
//   bf16exp   p = exp2 of round(min(s, 120)) in bf16, as JAX lowers it
//             (exp(ln 2 x), every step rounded to bf16); f32 row sum;
//             o = p V / sum p
//   noclamp   o = round(exp2(s)) V          (no clamp, no division)
//   noexp     o = round(min(s, 120)) V
//   nosoftmax o = round(s) V
//   nomask    o = G round(S_g) V_head, with S_g the scores over the
//             group's G*d lanes (no per-head lane masks; the JAX kernel
//             adds G identical head terms)
//   onedot    the score dot only: head j at position i of its group
//             stores S_src[:, i*d : (i+1)*d], with S_src the group's
//             first head's scores (pair form) or the scores over the
//             group's lanes, the sum of its heads' (lane form, onedot_sum)
// with q scaled by log2(e)/sqrt(d) in f32 and rounded to bf16, f32
// scores, and p rounded to bf16 before P V with f32 accumulation, as the
// JAX kernels cast. onedot computes the scores of every key tile and
// stages them in shared memory, so that it times the whole score dot, as
// the TPU variant computes it, and not just the stored slice.
//
// What bounds it on this card: as attention_qkv.cu, the on-chip operand
// feed of the f32 FMAs (ViT-B/16 at T=197 is ~80 FLOP per byte of HBM
// traffic). The variants move the same bytes; their times split the
// kernel's time by stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Variant {
  kFull, kMxuSum, kBf16Exp, kNoClamp, kNoExp, kNoSoftmax, kNoMask, kOneDot
};

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // query rows per thread: ty + 16 * i
constexpr int kCols = 4;       // score columns per thread: tx + 16 * j
constexpr int kPStride = kBK + 1;
constexpr int kMaxDot = 256;   // widest score dot: a pair of d=128 heads

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// JAX's exp2 of a bf16 value: lax.exp2 lowers to exp(ln 2 * x) in the
// operand's type, so ln 2 (0.69140625), the product and the result are
// each rounded to bf16.
__device__ __forceinline__ float exp2_bf16(float x) {
  return bf16_round(expf(bf16_round(bf16_round(x) * 0.69140625f)));
}

// Q (64 x w+1) + K (64 x w+1) + V (64 x 16*dc+1) + P (64 x 65) floats.
__host__ __device__ constexpr size_t smem_floats(int w, int dc) {
  return 2 * (size_t)kBQ * (w + 1) + (size_t)kBK * (16 * dc + 1) +
         (size_t)kBQ * kPStride;
}

struct Args {
  const __nv_bfloat16* qkv;  // (B, T, 3h)
  __nv_bfloat16* out;        // rows of out_stride elements
  int seq, nh, d, group, onedot_sum;
  long long out_stride;      // elements per output row
  int out_copies;            // output sections written, each h apart
  float qscale;
};

// DC = ceil(d / 16) rounded up to 4 or 8: output columns per thread.
template <int V, int DC>
__global__ void __launch_bounds__(kThreads) anatomy_kernel(Args a) {
  extern __shared__ float smem[];
  const int d = a.d, seq = a.seq, G = a.group;
  const long long h = (long long)a.nh * d;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int pos = head % G;  // position in the group
  // the lanes of the score dot: the head's own, or its group's
  int dl0 = head * d, w = d;
  if (V == kNoMask) {
    dl0 = (head - pos) * d;
    w = G * d;
  } else if (V == kOneDot) {
    dl0 = (head - pos) * d;
    w = a.onedot_sum ? G * d : d;
  }
  const int wq = w + 1;           // Q and K row stride (odd: no bank conflicts)
  constexpr int dv = 16 * DC + 1; // V row stride; column 16*DC holds ones
  float* sQ = smem;
  float* sK = sQ + kBQ * wq;
  float* sV = sK + kBK * wq;
  float* sP = sV + kBK * dv;
  const __nv_bfloat16* xb = a.qkv + (long long)b * seq * 3 * h;
  const long long row3 = 3 * h;

  for (int idx = tid; idx < kBQ * w; idx += kThreads) {
    const int r = idx / w, c = idx - r * w, t = q0 + r;
    sQ[r * wq + c] =
        t < seq ? bf16_round(__bfloat162float(xb[t * row3 + dl0 + c]) * a.qscale) : 0.f;
  }
  for (int idx = tid; idx < kBK * (dv - d); idx += kThreads) {
    // V columns past d: zeros, then the ones column
    const int r = idx / (dv - d), c = d + idx % (dv - d);
    sV[r * dv + c] = c == dv - 1 ? 1.f : 0.f;
  }

  float l[kRows], o[kRows][DC + 1];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j <= DC; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * w; idx += kThreads) {
      const int r = idx / w, c = idx - r * w, t = k0 + r;
      sK[r * wq + c] = t < seq ? __bfloat162float(xb[t * row3 + h + dl0 + c]) : 0.f;
    }
    if (V != kOneDot) {
      for (int idx = tid; idx < kBK * d; idx += kThreads) {
        const int r = idx / d, c = idx - r * d, t = k0 + r;
        sV[r * dv + c] =
            t < seq ? __bfloat162float(xb[t * row3 + 2 * h + head * d + c]) : 0.f;
      }
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < w; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty + 16 * i) * wq + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + 16 * j) * wq + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const bool real = k0 + tx + 16 * j < seq;
        float p = s[i][j];
        if (V == kOneDot) {
          sP[(ty + 16 * i) * kPStride + tx + 16 * j] = p;  // f32, cast at store
          continue;
        }
        if (V == kFull || V == kMxuSum) p = exp2f(fminf(p, 120.f));
        if (V == kBf16Exp) p = exp2_bf16(fminf(p, 120.f));
        if (V == kNoClamp) p = exp2f(p);
        if (V == kNoExp) p = fminf(p, 120.f);
        if (!real) p = 0.f;
        if (V == kFull || V == kBf16Exp) l[i] += p;
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = bf16_round(p);
      }
    }
    __syncthreads();

    if (V == kOneDot) {
      // store the keys pos*d .. pos*d+d-1 that fall in this tile
      const int lo = pos * d;
      for (int idx = tid; idx < kBQ * kBK; idx += kThreads) {
        const int r = idx / kBK, kk = idx - r * kBK;
        const int t = q0 + r, key = k0 + kk;
        if (t < seq && key >= lo && key < lo + d) {
          const __nv_bfloat16 v = __float2bfloat16_rn(sP[r * kPStride + kk]);
          for (int cp = 0; cp < a.out_copies; ++cp)
            a.out[(long long)b * seq * a.out_stride + t * a.out_stride + cp * h +
                  head * d + key - lo] = v;
        }
      }
      continue;
    }

    const int nk = min(kBK, seq - k0);
    for (int k = 0; k < nk; ++k) {
      float pv[kRows], vv[DC + 1];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty + 16 * i) * kPStride + k];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = sV[k * dv + tx + 16 * j];
      if (V == kMxuSum) vv[DC] = sV[k * dv + dv - 1];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < DC; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
        if (V == kMxuSum) o[i][DC] = fmaf(pv[i], vv[DC], o[i][DC]);
      }
    }
  }
  if (V == kOneDot) return;

  if (V == kFull || V == kBf16Exp) {
    // the 16 threads of one row group are 16 consecutive lanes
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= seq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c >= d) continue;
      float v = o[i][j];
      if (V == kFull || V == kBf16Exp) v = v / l[i];
      if (V == kMxuSum) v = v / o[i][DC];
      if (V == kNoMask) v = v * (float)G;
      const __nv_bfloat16 bv = __float2bfloat16_rn(v);
      for (int cp = 0; cp < a.out_copies; ++cp)
        a.out[(long long)b * seq * a.out_stride + t * a.out_stride + cp * h +
              head * d + c] = bv;
    }
  }
}

template <int V, int DC>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        anatomy_kernel<V, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(kMaxDot, DC) * sizeof(float)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  int w = a.d;
  if (V == kNoMask || (V == kOneDot && a.onedot_sum)) w = a.group * a.d;
  const dim3 grid((a.seq + kBQ - 1) / kBQ, a.nh, batch);
  anatomy_kernel<V, DC><<<grid, kThreads, smem_floats(w, DC) * sizeof(float), stream>>>(a);
  return cudaGetLastError();
}

template <int V>
cudaError_t dispatch(const Args& a, int batch, cudaStream_t stream) {
  return a.d <= 64 ? launch<V, 4>(a, batch, stream) : launch<V, 8>(a, batch, stream);
}

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// qkv: contiguous (B, T, 3h) bf16, h = nh * d; out: bf16, rows of
// out_stride elements, out_copies sections h apart (the forward tool
// writes (B, T, h): out_stride = h, one copy). variant: 0 full,
// 1 mxusum, 2 bf16exp, 3 noclamp, 4 noexp, 5 nosoftmax, 6 nomask,
// 7 onedot. group divides nh; group * d <= 256; onedot needs
// T >= group * d. qscale = log2(e)/sqrt(d). Returns cudaGetLastError()
// after the launch.
extern "C" int vit_attn_anatomy(const void* qkv, void* out, int batch, int seq,
                                int nh, int d, int group, int variant,
                                int onedot_sum, long long out_stride,
                                int out_copies, float qscale, void* stream) {
  if (batch < 1 || seq < 1 || nh < 1 || d < 8 || d > 128 || d % 8 != 0 ||
      group < 1 || nh % group != 0 || group * d > kMaxDot || batch > 65535 ||
      nh > 65535 || out_copies < 1 || (variant == kOneDot && seq < group * d)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const __nv_bfloat16*>(qkv),
               static_cast<__nv_bfloat16*>(out), seq, nh, d, group, onedot_sum,
               out_stride, out_copies, qscale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return (int)dispatch<kFull>(a, batch, s);
    case kMxuSum: return (int)dispatch<kMxuSum>(a, batch, s);
    case kBf16Exp: return (int)dispatch<kBf16Exp>(a, batch, s);
    case kNoClamp: return (int)dispatch<kNoClamp>(a, batch, s);
    case kNoExp: return (int)dispatch<kNoExp>(a, batch, s);
    case kNoSoftmax: return (int)dispatch<kNoSoftmax>(a, batch, s);
    case kNoMask: return (int)dispatch<kNoMask>(a, batch, s);
    case kOneDot: return (int)dispatch<kOneDot>(a, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
