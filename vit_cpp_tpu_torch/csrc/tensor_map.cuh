// Host side of TMA for dequant_matmul.cu (K4), probe_int8_dot.cu (T3),
// attention_qkv.cu (K1 and K3's wgmma bodies, 3-D and, at d = 80 and 88
// in bf16, 4-D) and attention_qkv_grad.cu
// (K2's f32 wgmma body):
// tensor maps encoded by libcuda's cuTensorMapEncodeTiled, looked up
// through the runtime (no link against libcuda). A map is passed to its
// kernel by value as a __grid_constant__ parameter.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// `map` of a row-major 2-D tensor at `base` (`rows` rows of `cols`
// elements, rows `row_bytes` apart) as TMA moves it: boxes of `box_rows`
// rows x `box_cols` elements (at most 128 bytes), laid out in shared
// memory in the 128-byte swizzle; elements out of range load as zeros and
// are not stored.
// cudaErrorNotSupported without the encoder, cudaErrorInvalidValue if it
// refuses the map.
inline cudaError_t encode_sw128(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                                uint64_t cols, uint64_t rows, uint64_t row_bytes,
                                uint32_t box_cols, uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// `map` of a 3-D tensor of `type` at `base`: `depth` planes of `rows` rows
// of `cols` elements, rows `row_bytes` and planes `plane_bytes` apart, as
// TMA moves it in boxes of one plane's `box_rows` rows x `box_cols`
// elements (at most `swizzle` bytes) in the 128-, 64- or 32-byte swizzle.
// A box past `rows` loads zeros there and does not store there, and never
// reaches the next plane (attention_wgmma.cuh: planes are images or (image,
// head) pairs; attention_grad_wgmma.cuh and attention_tf32_wgmma.cuh:
// images or (image, head) pairs, f32; a d = 80 row in 64-byte boxes, a
// d = 88 row in 32-byte ones).
inline cudaError_t encode_sw_3d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                                uint64_t cols, uint64_t rows, uint64_t depth, uint64_t row_bytes,
                                uint64_t plane_bytes, uint32_t box_cols, uint32_t box_rows,
                                int swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {row_bytes, plane_bytes};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_128B;
  if (encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// `map` of a 4-D bf16 tensor at `base`: dims[0] elements a row (the
// innermost), then dims[1], dims[2] and dims[3], `strides` bytes apart,
// as TMA moves it in boxes of `box_rows` along dims[2] x `box_cols`
// elements (one along dims[1] and dims[3]) in the `swizzle`-byte swizzle
// (32, 64 or 128; `box_cols` at most `swizzle` bytes). A box past any
// extent loads zeros there and does not store there (attention_wgmma.cuh
// at d = 80 and 88: (d, heads, tokens, planes), so that a tail box read
// past column d is zeros and a stored one stops at d).
inline cudaError_t encode_bf16_4d(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                                  const uint64_t (&strides)[3], uint32_t box_cols,
                                  uint32_t box_rows, int swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t box[4] = {box_cols, 1, box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_128B;
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d, st, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The map of a bf16 tensor in the 128-byte swizzle.
inline cudaError_t encode_sw128_3d(CUtensorMap* map, const void* base, uint64_t cols,
                                   uint64_t rows, uint64_t depth, uint64_t row_bytes,
                                   uint64_t plane_bytes, uint32_t box_cols, uint32_t box_rows) {
  return encode_sw_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, cols, rows, depth, row_bytes,
                      plane_bytes, box_cols, box_rows, 128);
}

}  // namespace tc
