// The T1 stage anatomy's kernel, stage sets and launch (attn_anatomy.cu
// describes the variants), shared by the two sources that instantiate
// them, so that two nvcc processes compile them at once:
// attn_anatomy.cu holds full .. nosoftmax and the C entry,
// attn_anatomy_wide.cu nomask and onedot, whose score dot has its own
// width NKS.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_body.cuh"

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

// attn_anatomy_wide.cu
cudaError_t nomask(const Args& a, cudaStream_t stream);
cudaError_t onedot(const Args& a, cudaStream_t stream);

}  // namespace anatomy
