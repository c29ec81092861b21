// Stage anatomy of the fused-QKV attention backward for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel of tools/attn_grad_anatomy.py::run_variant
// (_grad_pair_kernel), a stage-toggled replica of the head-pair attention
// backward with the safe softmax, timed variant by variant. Here every
// variant replicates the TPU kernel's design as a port on FMA units, not
// the tensor-core design of the port's backward kernel
// (attention_qkv_grad.cu): launch A, one block per (batch, heads, query
// tile), takes the row max, sum p and r = sum dp * pn and writes dq and
// the row statistics; launch B, one block per (batch, heads, key tile),
// recomputes pn and writes dk and dv. Tiles are staged in shared memory
// as f32, with K2's row strides; plain f32 FMAs.
//
// Input qkv (B, T, 3h) and dO (B, T, h), bf16; output dqkv (B, T, 3h)
// bf16. Per head, with qs = round(q log2(e)/sqrt(d)) and s = qs k^T:
//   full      pn = softmax(s) (exp2, row max); dv = round(pn)^T dO;
//             dp = dO v^T; r = sum dp pn; ds = round(pn (dp - r));
//             dq = ds k / sqrt(d); dk = ds^T q / sqrt(d)
//   pipe      full's output, two heads per block with the stages of the
//   pipe2     two (four: pipe2) heads interleaved: each stage runs for
//             every head before the next stage starts, so a warp has
//             independent work while one head's operands load from
//             shared memory. Each thread keeps 16 scores of a tile in
//             every variant: 1 head x 64 x 64 (4 x 4 per thread), pipe
//             2 heads x 64 x 32 (4 x 2), pipe2 4 heads x 32 x 32 (2 x 2):
//             four heads of 64-row f32 tiles would not fit in 227 KB.
//   bf16exp   p = exp2 of round(s - max) in bf16, as JAX lowers it
//             (exp(ln 2 x), every step rounded to bf16); pn = p / (f32 sum p)
//   nosoftmax pn = s                (no max, sum or division)
//   nodsoft   ds = round(dp)        (no r, no pn (dp - r))
//   dotsonly  pn = s, ds = round(dp)
//   onedot    the score dot alone, by the forward anatomy's kernel
//             (attn_anatomy.cu, onedot over a pair's lanes): head j at
//             position i of its pair stores (s_lo + s_hi)[:, i*d:(i+1)*d]
//             in all three sections of dqkv.
// Stages a variant switches off are not computed: nodsoft and dotsonly
// skip the r pass, nosoftmax and dotsonly the max pass.
//
// What bounds it on this card: the on-chip operand feed of the f32 FMAs
// (five T x T x d products per head against ~2 MB of HBM traffic per
// image and layer at ViT-B/16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

extern "C" int vit_attn_anatomy(const void* qkv, void* out, int batch, int seq,
                                int nh, int d, int group, int variant,
                                int onedot_sum, long long out_stride,
                                int out_copies, float qscale, void* stream);

namespace {

enum Variant { kFull, kPipe, kPipe2, kBf16Exp, kNoSoftmax, kNoDsoft, kDotsOnly, kOneDot };

constexpr int kThreads = 256;  // 16 x 16
constexpr int kAnatomyOneDot = 7;  // attn_anatomy.cu's onedot variant

// heads per block P, tile rows per thread RO (owned tile: 16 RO rows) and
// RL (looped tile: 16 RL rows)
template <int V> struct Shape { static constexpr int P = 1, RO = 4, RL = 4; };
template <> struct Shape<kPipe> { static constexpr int P = 2, RO = 4, RL = 2; };
template <> struct Shape<kPipe2> { static constexpr int P = 4, RO = 2, RL = 2; };

__host__ __device__ constexpr bool softmax_on(int v) {
  return v != kNoSoftmax && v != kDotsOnly;
}
__host__ __device__ constexpr bool dsoft_on(int v) {
  return v != kNoDsoft && v != kDotsOnly;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// p = exp2 of a max-subtracted score, as the variant computes it
template <int V>
__device__ __forceinline__ float softexp(float s, float m) {
  if (V == kBf16Exp) {  // exp2 in bf16 as JAX lowers it: exp(ln 2 x), each step rounded
    return bf16_round(expf(bf16_round(bf16_round(__fsub_rn(s, m)) * 0.69140625f)));
  }
  return exp2f(__fsub_rn(s, m));
}

template <int DC>
__host__ __device__ constexpr int ld() { return 16 * DC + 4; }

template <int V, int DC>
__host__ __device__ constexpr size_t rows_smem_floats() {
  using S = Shape<V>;
  // per head: qs, dO (owned) + K, V (looped) + the ds tile
  return (size_t)S::P * (2 * 16 * S::RO * ld<DC>() + 2 * 16 * S::RL * ld<DC>() +
                         16 * S::RO * (16 * S::RL + 4));
}

template <int V, int DC>
__host__ __device__ constexpr size_t cols_smem_floats() {
  using S = Shape<V>;
  // per head: K, V (owned) + qs, q, dO (looped) + the p / ds tile + stats
  return (size_t)S::P * (2 * 16 * S::RO * ld<DC>() + 3 * 16 * S::RL * ld<DC>() +
                         16 * S::RO * (16 * S::RL + 4) + 3 * 16 * S::RL);
}

// Stage rows row0 .. row0 + ROWS-1 of one head's (T, d) slice into dst as
// f32 (row stride ld<DC>()), zero past T and past d; scaled: round(v * scale).
template <int DC, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int seq,
                                          int d, float scale, bool scaled) {
  constexpr int W4 = 4 * DC;
  for (int idx = threadIdx.x; idx < ROWS * W4; idx += kThreads) {
    const int r = idx / W4, c = 4 * (idx - (idx / W4) * W4), t = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < seq && c < d) {
      v = load4(src + (long long)t * row_stride + c);
      if (scaled) {
        v = make_float4(bf16_round(__fmul_rn(v.x, scale)), bf16_round(__fmul_rn(v.y, scale)),
                        bf16_round(__fmul_rn(v.z, scale)), bf16_round(__fmul_rn(v.w, scale)));
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld<DC>() + c) = v;
  }
}

// s[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c] for P heads at once
template <int P, int RO, int RL, int DC>
__device__ __forceinline__ void tile_dot(float (&s)[P][RO][RL], float* const (&a)[P],
                                         float* const (&b)[P], int d, int ty, int tx) {
  constexpr int L = ld<DC>();
#pragma unroll
  for (int hh = 0; hh < P; ++hh)
#pragma unroll
    for (int i = 0; i < RO; ++i)
#pragma unroll
      for (int j = 0; j < RL; ++j) s[hh][i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < d; c += 4) {
#pragma unroll
    for (int hh = 0; hh < P; ++hh) {
      float4 av[RO], bv[RL];
#pragma unroll
      for (int i = 0; i < RO; ++i)
        av[i] = *reinterpret_cast<const float4*>(a[hh] + (ty + 16 * i) * L + c);
#pragma unroll
      for (int j = 0; j < RL; ++j)
        bv[j] = *reinterpret_cast<const float4*>(b[hh] + (tx + 16 * j) * L + c);
#pragma unroll
      for (int i = 0; i < RO; ++i)
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          float t = s[hh][i][j];
          t = fmaf(av[i].x, bv[j].x, t);
          t = fmaf(av[i].y, bv[j].y, t);
          t = fmaf(av[i].z, bv[j].z, t);
          t = fmaf(av[i].w, bv[j].w, t);
          s[hh][i][j] = t;
        }
    }
  }
}

// acc[hh][i][jj] += sum_k p[hh][ty + 16 i][k] * m[hh][k][tx + 16 jj] over
// the K looped rows, four k per 16-byte load of p (row stride K + 4)
template <int P, int RO, int K, int DC>
__device__ __forceinline__ void tile_acc(float (&acc)[P][RO][DC], float* const (&p)[P],
                                         float* const (&m)[P], int ty, int tx) {
  constexpr int L = ld<DC>();
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
#pragma unroll
    for (int hh = 0; hh < P; ++hh) {
      float4 pv[RO];
#pragma unroll
      for (int i = 0; i < RO; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p[hh] + (ty + 16 * i) * (K + 4) + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float mv[DC];
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) mv[jj] = m[hh][(k + kk) * L + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < RO; ++i) {
          const float pk = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y : kk == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int jj = 0; jj < DC; ++jj) acc[hh][i][jj] = fmaf(pk, mv[jj], acc[hh][i][jj]);
        }
      }
    }
  }
}

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

struct Args {
  const __nv_bfloat16* qkv;  // (B, T, 3h)
  const __nv_bfloat16* dout; // (B, T, h)
  __nv_bfloat16* dqkv;       // (B, T, 3h)
  float* stats;              // (B, nh, T, 3): row max, sum p, r
  int seq, nh, d;
  float qscale, nat;
};

// Launch A: one block per (batch, P heads, 16 RO queries) -> dq, row stats.
template <int V, int DC>
__global__ void __launch_bounds__(kThreads) grad_rows_kernel(Args a) {
  using S = Shape<V>;
  constexpr int P = S::P, RO = S::RO, RL = S::RL, TO = 16 * RO, TL = 16 * RL;
  constexpr int L = ld<DC>(), PS = TL + 4;
  extern __shared__ __align__(16) float smem[];
  float *sQ[P], *sO[P], *sK[P], *sV[P], *sS[P];
  {
    float* f = smem;
#pragma unroll
    for (int hh = 0; hh < P; ++hh) {
      sQ[hh] = f; f += TO * L;
      sO[hh] = f; f += TO * L;
      sK[hh] = f; f += TL * L;
      sV[hh] = f; f += TL * L;
      sS[hh] = f; f += TO * PS;
    }
  }
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, head0 = blockIdx.y * P, q0 = blockIdx.x * TO;
  const int seq = a.seq, d = a.d;
  const long long h = (long long)a.nh * d, row3 = 3 * h;
  const __nv_bfloat16 *xb[P], *ob[P];
#pragma unroll
  for (int hh = 0; hh < P; ++hh) {
    xb[hh] = a.qkv + (long long)b * seq * row3 + (long long)(head0 + hh) * d;
    ob[hh] = a.dout + (long long)b * seq * h + (long long)(head0 + hh) * d;
    load_tile<DC, TO>(sQ[hh], xb[hh], row3, q0, seq, d, a.qscale, true);
    load_tile<DC, TO>(sO[hh], ob[hh], h, q0, seq, d, 1.f, false);
  }

  float m[P][RO], l[P][RO], u[P][RO];
#pragma unroll
  for (int hh = 0; hh < P; ++hh)
#pragma unroll
    for (int i = 0; i < RO; ++i) {
      m[hh][i] = softmax_on(V) ? -__int_as_float(0x7f800000) : 0.f;
      l[hh][i] = 1.f;
      u[hh][i] = 0.f;
    }

  if (softmax_on(V)) {  // pass 0: the exact row max over the real keys
    for (int k0 = 0; k0 < seq; k0 += TL) {
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < P; ++hh)
        load_tile<DC, TL>(sK[hh], xb[hh] + h, row3, k0, seq, d, 1.f, false);
      __syncthreads();
      float s[P][RO][RL];
      tile_dot<P, RO, RL, DC>(s, sQ, sK, d, ty, tx);
#pragma unroll
      for (int hh = 0; hh < P; ++hh)
#pragma unroll
        for (int i = 0; i < RO; ++i)
#pragma unroll
          for (int j = 0; j < RL; ++j)
            if (k0 + tx + 16 * j < seq) m[hh][i] = fmaxf(m[hh][i], s[hh][i][j]);
    }
#pragma unroll
    for (int hh = 0; hh < P; ++hh)
#pragma unroll
      for (int i = 0; i < RO; ++i) m[hh][i] = row_max(m[hh][i]);
  }

  float r[P][RO];
  if (softmax_on(V) || dsoft_on(V)) {  // pass 1: sum p and / or sum dp * p
#pragma unroll
    for (int hh = 0; hh < P; ++hh)
#pragma unroll
      for (int i = 0; i < RO; ++i) l[hh][i] = 0.f;
    for (int k0 = 0; k0 < seq; k0 += TL) {
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < P; ++hh) {
        load_tile<DC, TL>(sK[hh], xb[hh] + h, row3, k0, seq, d, 1.f, false);
        if (dsoft_on(V)) load_tile<DC, TL>(sV[hh], xb[hh] + 2 * h, row3, k0, seq, d, 1.f, false);
      }
      __syncthreads();
      float s[P][RO][RL], dp[P][RO][RL];
      tile_dot<P, RO, RL, DC>(s, sQ, sK, d, ty, tx);
      if (dsoft_on(V)) tile_dot<P, RO, RL, DC>(dp, sO, sV, d, ty, tx);
#pragma unroll
      for (int hh = 0; hh < P; ++hh)
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          if (k0 + tx + 16 * j >= seq) continue;
#pragma unroll
          for (int i = 0; i < RO; ++i) {
            const float p = softmax_on(V) ? softexp<V>(s[hh][i][j], m[hh][i]) : s[hh][i][j];
            if (softmax_on(V)) l[hh][i] = __fadd_rn(l[hh][i], p);
            if (dsoft_on(V)) u[hh][i] = fmaf(dp[hh][i][j], p, u[hh][i]);
          }
        }
    }
#pragma unroll
    for (int hh = 0; hh < P; ++hh)
#pragma unroll
      for (int i = 0; i < RO; ++i) {
        l[hh][i] = softmax_on(V) ? row_sum(l[hh][i]) : 1.f;
        r[hh][i] = softmax_on(V) ? __fdiv_rn(row_sum(u[hh][i]), l[hh][i]) : row_sum(u[hh][i]);
      }
  } else {
#pragma unroll
    for (int hh = 0; hh < P; ++hh)
#pragma unroll
      for (int i = 0; i < RO; ++i) r[hh][i] = 0.f;
  }

  // pass 2: ds and dq = ds k
  float acc[P][RO][DC];
#pragma unroll
  for (int hh = 0; hh < P; ++hh)
#pragma unroll
    for (int i = 0; i < RO; ++i)
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[hh][i][jj] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += TL) {
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < P; ++hh) {
      load_tile<DC, TL>(sK[hh], xb[hh] + h, row3, k0, seq, d, 1.f, false);
      load_tile<DC, TL>(sV[hh], xb[hh] + 2 * h, row3, k0, seq, d, 1.f, false);
    }
    __syncthreads();
    float s[P][RO][RL], dp[P][RO][RL];
    if (dsoft_on(V)) tile_dot<P, RO, RL, DC>(s, sQ, sK, d, ty, tx);
    tile_dot<P, RO, RL, DC>(dp, sO, sV, d, ty, tx);
#pragma unroll
    for (int hh = 0; hh < P; ++hh)
#pragma unroll
      for (int j = 0; j < RL; ++j) {
        const bool real = k0 + tx + 16 * j < seq;
#pragma unroll
        for (int i = 0; i < RO; ++i) {
          float ds = 0.f;
          if (real) {
            if (dsoft_on(V)) {
              const float pn = softmax_on(V)
                                   ? __fdiv_rn(softexp<V>(s[hh][i][j], m[hh][i]), l[hh][i])
                                   : s[hh][i][j];
              ds = bf16_round(__fmul_rn(pn, __fsub_rn(dp[hh][i][j], r[hh][i])));
            } else {
              ds = bf16_round(dp[hh][i][j]);
            }
          }
          sS[hh][(ty + 16 * i) * PS + tx + 16 * j] = ds;
        }
      }
    __syncthreads();
    tile_acc<P, RO, TL, DC>(acc, sS, sK, ty, tx);
  }

#pragma unroll
  for (int hh = 0; hh < P; ++hh) {
    __nv_bfloat16* dqb = a.dqkv + (long long)b * seq * row3 + (long long)(head0 + hh) * d;
    float* st = a.stats + ((long long)b * a.nh + head0 + hh) * seq * 3;
#pragma unroll
    for (int i = 0; i < RO; ++i) {
      const int t = q0 + ty + 16 * i;
      if (t >= seq) continue;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int c = tx + 16 * jj;
        if (c < d) dqb[(long long)t * row3 + c] = __float2bfloat16_rn(__fmul_rn(acc[hh][i][jj], a.nat));
      }
      if (tx == 0) {
        st[(long long)t * 3 + 0] = m[hh][i];
        st[(long long)t * 3 + 1] = l[hh][i];
        st[(long long)t * 3 + 2] = r[hh][i];
      }
    }
  }
}

// Launch B: one block per (batch, P heads, 16 RO keys) -> dk, dv.
template <int V, int DC>
__global__ void __launch_bounds__(kThreads) grad_cols_kernel(Args a) {
  using S = Shape<V>;
  constexpr int P = S::P, RO = S::RO, RL = S::RL, TO = 16 * RO, TL = 16 * RL;
  constexpr int L = ld<DC>(), PS = TL + 4;
  extern __shared__ __align__(16) float smem[];
  float *sK[P], *sV[P], *sQs[P], *sQ[P], *sO[P], *sP[P], *sM[P], *sL[P], *sR[P];
  {
    float* f = smem;
#pragma unroll
    for (int hh = 0; hh < P; ++hh) {
      sK[hh] = f; f += TO * L;
      sV[hh] = f; f += TO * L;
      sQs[hh] = f; f += TL * L;
      sQ[hh] = f; f += TL * L;
      sO[hh] = f; f += TL * L;
      sP[hh] = f; f += TO * PS;  // round(pn), then ds; [key][query]
      sM[hh] = f; f += TL;
      sL[hh] = f; f += TL;
      sR[hh] = f; f += TL;
    }
  }
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, head0 = blockIdx.y * P, k0 = blockIdx.x * TO;
  const int seq = a.seq, d = a.d;
  const long long h = (long long)a.nh * d, row3 = 3 * h;
  const __nv_bfloat16 *xb[P], *ob[P];
  const float* st[P];
#pragma unroll
  for (int hh = 0; hh < P; ++hh) {
    xb[hh] = a.qkv + (long long)b * seq * row3 + (long long)(head0 + hh) * d;
    ob[hh] = a.dout + (long long)b * seq * h + (long long)(head0 + hh) * d;
    st[hh] = a.stats + ((long long)b * a.nh + head0 + hh) * seq * 3;
    load_tile<DC, TO>(sK[hh], xb[hh] + h, row3, k0, seq, d, 1.f, false);
    load_tile<DC, TO>(sV[hh], xb[hh] + 2 * h, row3, k0, seq, d, 1.f, false);
  }
  bool real[RO];
#pragma unroll
  for (int i = 0; i < RO; ++i) real[i] = k0 + ty + 16 * i < seq;

  float dk[P][RO][DC], dv[P][RO][DC];
#pragma unroll
  for (int hh = 0; hh < P; ++hh)
#pragma unroll
    for (int i = 0; i < RO; ++i)
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) dk[hh][i][jj] = dv[hh][i][jj] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += TL) {
    __syncthreads();  // the previous query tile's readers are done
#pragma unroll
    for (int hh = 0; hh < P; ++hh) {
      load_tile<DC, TL>(sQs[hh], xb[hh], row3, q0, seq, d, a.qscale, true);
      load_tile<DC, TL>(sQ[hh], xb[hh], row3, q0, seq, d, 1.f, false);
      load_tile<DC, TL>(sO[hh], ob[hh], h, q0, seq, d, 1.f, false);
      if (tid < TL) {
        const int t = q0 + tid;
        const bool in = t < seq;
        sM[hh][tid] = in ? st[hh][(long long)t * 3 + 0] : 0.f;
        sL[hh][tid] = in ? st[hh][(long long)t * 3 + 1] : 1.f;
        sR[hh][tid] = in ? st[hh][(long long)t * 3 + 2] : 0.f;
      }
    }
    __syncthreads();

    float s[P][RO][RL], dp[P][RO][RL], ds[P][RO][RL];
    tile_dot<P, RO, RL, DC>(s, sK, sQs, d, ty, tx);  // [key][query]
    tile_dot<P, RO, RL, DC>(dp, sV, sO, d, ty, tx);
#pragma unroll
    for (int hh = 0; hh < P; ++hh)
#pragma unroll
      for (int j = 0; j < RL; ++j) {
        const int ql = tx + 16 * j;
        const bool qin = q0 + ql < seq;
#pragma unroll
        for (int i = 0; i < RO; ++i) {
          float pn = 0.f;
          ds[hh][i][j] = 0.f;
          if (real[i] && qin) {
            pn = softmax_on(V) ? __fdiv_rn(softexp<V>(s[hh][i][j], sM[hh][ql]), sL[hh][ql])
                               : s[hh][i][j];
            ds[hh][i][j] = dsoft_on(V)
                               ? bf16_round(__fmul_rn(pn, __fsub_rn(dp[hh][i][j], sR[hh][ql])))
                               : bf16_round(dp[hh][i][j]);
          }
          sP[hh][(ty + 16 * i) * PS + ql] = bf16_round(pn);
        }
      }
    __syncthreads();
    tile_acc<P, RO, TL, DC>(dv, sP, sO, ty, tx);
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < P; ++hh)
#pragma unroll
      for (int j = 0; j < RL; ++j)
#pragma unroll
        for (int i = 0; i < RO; ++i) sP[hh][(ty + 16 * i) * PS + tx + 16 * j] = ds[hh][i][j];
    __syncthreads();
    tile_acc<P, RO, TL, DC>(dk, sP, sQ, ty, tx);
  }

#pragma unroll
  for (int hh = 0; hh < P; ++hh) {
    __nv_bfloat16* db = a.dqkv + (long long)b * seq * row3 + (long long)(head0 + hh) * d;
#pragma unroll
    for (int i = 0; i < RO; ++i) {
      if (!real[i]) continue;
      const long long t = k0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int c = tx + 16 * jj;
        if (c < d) {
          db[t * row3 + h + c] = __float2bfloat16_rn(__fmul_rn(dk[hh][i][jj], a.nat));
          db[t * row3 + 2 * h + c] = __float2bfloat16_rn(dv[hh][i][jj]);
        }
      }
    }
  }
}

template <int V, int DC>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  using S = Shape<V>;
  static bool configured = false;
  const size_t rows_bytes = rows_smem_floats<V, DC>() * sizeof(float);
  const size_t cols_bytes = cols_smem_floats<V, DC>() * sizeof(float);
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        grad_rows_kernel<V, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        grad_cols_kernel<V, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cols_bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.seq + 16 * S::RO - 1) / (16 * S::RO), a.nh / S::P, batch);
  grad_rows_kernel<V, DC><<<grid, kThreads, rows_bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grad_cols_kernel<V, DC><<<grid, kThreads, cols_bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int V>
cudaError_t dispatch(const Args& a, int batch, cudaStream_t stream) {
  return a.d <= 64 ? launch<V, 4>(a, batch, stream) : launch<V, 8>(a, batch, stream);
}

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// qkv, dqkv: contiguous (B, T, 3h) bf16; dout: contiguous (B, T, h) bf16;
// qkv and dout 16-byte aligned; stats: an f32 workspace of B * nh * T * 3
// floats. variant: 0 full, 1 pipe, 2 pipe2, 3 bf16exp, 4 nosoftmax,
// 5 nodsoft, 6 dotsonly, 7 onedot. nh even; pipe2 needs nh % 4 == 0;
// pipe and pipe2 take d <= 64; onedot needs T >= 2d. qscale =
// log2(e)/sqrt(d), nat = 1/sqrt(d). Returns cudaGetLastError() after the
// launches.
extern "C" int vit_attn_grad_anatomy(const void* qkv, const void* dout, void* dqkv,
                                     void* stats, int batch, int seq, int nh, int d,
                                     int variant, float qscale, float nat,
                                     void* stream) {
  if (batch < 1 || seq < 1 || nh < 2 || nh % 2 != 0 || d < 8 || d > 128 ||
      d % 8 != 0 || batch > 65535 || nh > 65535 ||
      ((variant == kPipe || variant == kPipe2) && d > 64) ||
      (variant == kPipe2 && nh % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (variant == kOneDot) {
    return vit_attn_anatomy(qkv, dqkv, batch, seq, nh, d, 2, kAnatomyOneDot, 1,
                            3LL * nh * d, 3, qscale, stream);
  }
  const Args a{static_cast<const __nv_bfloat16*>(qkv),
               static_cast<const __nv_bfloat16*>(dout),
               static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(stats),
               seq, nh, d, qscale, nat};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull: return (int)dispatch<kFull>(a, batch, s);
    case kPipe: return (int)launch<kPipe, 4>(a, batch, s);
    case kPipe2: return (int)launch<kPipe2, 4>(a, batch, s);
    case kBf16Exp: return (int)dispatch<kBf16Exp>(a, batch, s);
    case kNoSoftmax: return (int)dispatch<kNoSoftmax>(a, batch, s);
    case kNoDsoft: return (int)dispatch<kNoDsoft>(a, batch, s);
    case kDotsOnly: return (int)dispatch<kDotsOnly>(a, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
