// The T1 stage anatomy's kernels, stage sets and launches (attn_anatomy.cu
// describes the variants), shared by the two sources that instantiate
// them, so that two nvcc processes compile them at once:
// attn_anatomy.cu holds full .. nosoftmax and the C entry,
// attn_anatomy_wide.cu nomask and onedot, whose score dot has its own
// width NKS. Two kernels: anatomy_wgmma at d = 64 (K1's wgmma body),
// anatomy_mma at every other d (K1's mma.sync body).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_body.cuh"
#include "attention_wgmma.cuh"
#include "tensor_map.cuh"

namespace anatomy {

using attn::bf16;

enum Variant {
  kFull, kMxuSum, kBf16Exp, kNoClamp, kNoExp, kNoSoftmax, kNoMask, kOneDot
};

// One stage set per variant: K1's (attn::Stages) with its stages changed.
template <int V, int NKS = 0>
struct Stages : attn::Stages {
  static constexpr int kExp =
      V == kBf16Exp ? 2 : (V == kNoExp || V == kNoSoftmax || V == kNoMask) ? 0 : 1;
  static constexpr bool kClamp = V == kFull || V == kMxuSum || V == kBf16Exp || V == kNoExp;
  static constexpr int kSum = V == kMxuSum ? 2 : (V == kFull || V == kBf16Exp) ? 1 : 0;
  static constexpr int kNKS = NKS;
  static constexpr bool kTimesGroup = V == kNoMask;
  static constexpr bool kOneDot = V == Variant::kOneDot;
  static constexpr bool kNarrow = true;
};

// K1's kernel parameters, the head group beside them. The tools pass K1's
// fast path: fast = 1, no sizes, kv = T; they stay runtime values, as in K1.
template <int V, int NK, int NKS>
__global__ void __launch_bounds__(attn::kMmaThreads)
    anatomy_mma(const bf16* __restrict__ qg, const bf16* __restrict__ kg,
                const bf16* __restrict__ vg, attn::Strides in,
                const float* __restrict__ sizes, bf16* __restrict__ out, attn::Strides os,
                int seq, int d, int kv, float qscale, int fast, attn::Group grp) {
  attn::attention_mma_body<NK, Stages<V, NKS>>(qg, kg, vg, in, sizes, out, os, seq, d, kv,
                                                qscale, fast, grp);
}

struct Args {
  const bf16* qkv;  // (B, T, 3h)
  bf16* out;        // rows of out_stride elements
  int batch, seq, nh, d, group, onedot_sum;
  long long out_stride;  // elements per output row
  int out_copies;        // onedot: output sections written, each h apart
  float qscale;
};

template <int V, int NK, int NKS>
cudaError_t launch(const Args& a, const attn::Group& grp, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t bytes = attn::mma_smem_bytes<NK, Stages<V, NKS>>();
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        anatomy_mma<V, NK, NKS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long h = (long long)a.nh * a.d;
  const attn::Strides in{(long long)a.seq * 3 * h, a.d, 3 * h};
  const attn::Strides os{(long long)a.seq * a.out_stride, a.d, a.out_stride};
  const dim3 grid((a.seq + attn::kMmaRows - 1) / attn::kMmaRows, a.nh, a.batch);
  anatomy_mma<V, NK, NKS><<<grid, attn::kMmaThreads, bytes, stream>>>(
      a.qkv, a.qkv + h, a.qkv + 2 * h, in, nullptr, a.out, os, a.seq, a.d, a.seq, a.qscale, 1,
      grp);
  return cudaGetLastError();
}

// d = 64: K1's wgmma body at the variant's stages (fast, no sizes, kv =
// T), with K1's launch bounds (three blocks per SM: at most 168 registers
// a thread). Q, K and V are boxes of one map over the fused qkv; the
// output is stored through `omap` (onedot: straight to `dots`).
template <int V, int NKS>
__global__ void __launch_bounds__(attn::kWgThreads, 3)
    anatomy_wgmma(const __grid_constant__ CUtensorMap qkv,
                  const __grid_constant__ CUtensorMap omap, attn::WgCoords co, int seq,
                  float qscale, attn::Group grp, bf16* dots, long long dots_row) {
  attn::attention_wgmma_body<64, true, false, Stages<V, NKS>>(qkv, qkv, qkv, omap, co, nullptr,
                                                              seq, seq, qscale, grp, dots,
                                                              dots_row);
}

// The tensor maps are encoded per call, as K1's fused-qkv call does: planes
// are images, rows of 3h in (a head's Q, K and V at column offsets 0, h and
// 2h; the token extent T, so TMA loads zeros past it) and of out_stride out.
template <int V, int NKS>
cudaError_t launch_wgmma(const Args& a, const attn::Group& grp, cudaStream_t stream) {
  using S = Stages<V, NKS>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(anatomy_wgmma<V, NKS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)attn::wgmma_smem_bytes<64, S>(1 << 30));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long h = (long long)a.nh * attn::kWgD;
  CUtensorMap mq, mo;
  cudaError_t err = tc::encode_sw128_3d(&mq, a.qkv, 3 * h, a.seq, a.batch, 3 * h * 2,
                                        (uint64_t)a.seq * 3 * h * 2, attn::kWgD, attn::kWgRows);
  if (err == cudaSuccess)
    err = tc::encode_sw128_3d(&mo, a.out, h, a.seq, a.batch, a.out_stride * 2,
                              (uint64_t)a.seq * a.out_stride * 2, attn::kWgD, attn::kWgRows);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + attn::kWgRows - 1) / attn::kWgRows, a.nh, a.batch);
  anatomy_wgmma<V, NKS><<<grid, attn::kWgThreads, attn::wgmma_smem_bytes<64, S>(a.seq),
                          stream>>>(
      mq, mo, attn::WgCoords{0, (int)h, (int)(2 * h), attn::kWgD, 1, 0}, a.seq, a.qscale, grp,
      a.out, a.out_stride);
  return cudaGetLastError();
}

// attn_anatomy_wide.cu
cudaError_t nomask(const Args& a, cudaStream_t stream);
cudaError_t onedot(const Args& a, cudaStream_t stream);

}  // namespace anatomy
