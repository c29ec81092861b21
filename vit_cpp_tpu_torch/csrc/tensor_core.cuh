// Tensor-core and asynchronous-copy building blocks of attention_qkv.cu
// and attention_qkv_grad.cu (K1/K3 and K2, and the anatomies built on
// their bodies: cp.async, ldmatrix, the bf16
// mma.sync.m16n8k16 product and the f32 3xTF32 product on
// mma.sync.m16n8k8.tf32, PTX ISA sm_80+), dequant_matmul.cu (K4:
// cp.async, TMA with mbarriers and the asynchronous wgmma products,
// bf16 m64n128k16 and tf32 m64n128k8 with A from registers, sm_90a),
// probe_int8_dot.cu (T3: TMA loads and stores and
// wgmma, bf16 m64n128k16 and s8 m64n128k32) and attention_wgmma.cuh (K1
// and K3 in bf16 at d = 64, 80 and 88: 3-D and 4-D TMA loads and stores,
// bf16 m64n64k16 with A from shared memory or from registers, m64n16k16,
// m64n24k16 and m64n32k16 with A from registers, in the 128-, 64- and
// 32-byte swizzles), attention_grad_wgmma.cuh and
// attention_tf32_wgmma.cuh (K2, and K1 and K3, in f32 at d = 64, 80 and
// 88, through tf32_wgmma.cuh: tf32 m64nNk8 with both operands from shared
// memory, N = 8 to 32, and m64n64k8 / m64n80k8 / m64n88k8 with A from
// registers, in the 128-, 64- and 32-byte swizzles). Every floating-point
// product accumulates in f32, the s8 product in s32.
//
// Fragment layouts of m16n8k16 (g = lane / 4, q = lane % 4):
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a0 = A[g][2q, 2q+1]   a1 = A[g+8][2q, 2q+1]
//     a2 = A[g][2q+8, +9]   a3 = A[g+8][2q+8, +9]
//   B (16 x 8, k x n), two registers: b0 = B[2q, 2q+1][g], b1 = B[2q+8, +9][g]
//   C (16 x 8, f32): c0, c1 = C[g][2q, 2q+1]; c2, c3 = C[g+8][2q, 2q+1]
// so the C tiles of two neighbouring n8 columns are, once rounded and
// packed in pairs, the A fragment of a 16-wide k slice.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of `bytes` (4, 8 or 16) from global to shared memory;
// only `src_bytes` of them are read and the rest are written as zeros (0:
// a zero chunk; `src` must still be a valid address).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` committed groups of this thread are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, and register i receives this lane's pair of matrix i (row g,
// columns 2q, 2q+1; with .trans, column g, rows 2q, 2q+1). Without .trans
// it also loads f32 rows, an 8 x 8 b16 matrix being 8 x 4 f32 whose
// element (g, q) lane 4g + q receives: the m16n8k8.tf32 A fragment (rows
// 0-7 and 8-15 at column 0, then at column 4) or the B fragments of two
// n8 tiles stored n-major (n rows 0-7 at k 0 and at k 4, then rows 8-15).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// Two 8 x 8 b16 matrices, transposed: lanes 0-7 and 8-15 give the row
// addresses of matrices 0 and 1 (the other lanes' addresses are unused).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)) : "memory");
}

// c += a b: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to nearest-even bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// v rounded to the nearest bf16, in an f32 register.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// JAX's exp2 of a bf16 value (the anatomies' bf16exp): lax.exp2 lowers to
// exp(ln 2 * x) in the operand's type, so x, ln 2 (0.69140625), the
// product and the result are each rounded to bf16.
__device__ __forceinline__ float exp2_bf16(float x) {
  return bf16_round(expf(bf16_round(bf16_round(x) * 0.69140625f)));
}

// ------------------------------------------ 3xTF32 (f32 on tensor cores)
//
// TF32 keeps 10 of f32's 23 mantissa bits, so one TF32 product is off by
// ~2^-11 of each operand. 3xTF32 splits each f32 operand x into hi =
// tf32(x) and lo = tf32(x - hi) (x - hi is exact in f32) and sums hi*hi
// + hi*lo + lo*hi in f32 accumulators: what it drops, lo*lo and the
// rounding of lo, is ~2^-22 of |x y|, the size of f32's own rounding.
//
// Fragment layouts of m16n8k8.tf32 (g = lane / 4, q = lane % 4):
//   A (16 x 8): a0 = A[g][q]  a1 = A[g+8][q]  a2 = A[g][q+4]  a3 = A[g+8][q+4]
//   B (8 x 8, k x n): b0 = B[q][g]  b1 = B[q+4][g]
//   C (16 x 8, f32): c0, c1 = C[g][2q, 2q+1]; c2, c3 = C[g+8][2q, 2q+1]
// The C layout is not the A layout: a C tile holds columns (2q, 2q+1),
// an A fragment columns (q, q+4). A product whose A operand is a C tile
// (P V, dS K) therefore numbers its contraction index k' = 2q + i as
// k = q + 4 i: A = {c0, c2, c1, c3}, and B's rows 2q and 2q+1 in place of
// q and q+4 (b0 = B[2q][g], b1 = B[2q+1][g]). A sum over k does not
// depend on how k is numbered.

// x rounded to TF32 (nearest, ties away from zero), in an f32 register:
// what cvt.rna.tf32.f32 computes for a finite x, in two integer
// operations (an H100 ran K2's f32 body 1.3x faster this way than with
// the cvt): add half of TF32's last place to the magnitude, then clear
// the 13 bits below it.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An operand split into its TF32 high and low parts.
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = tf32(x);
  return Split{hi, tf32(__fsub_rn(x, __uint_as_float(hi)))};
}

// c += a b on TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two small cross terms first, then hi * hi.
// kSwap takes the cross terms in the other order, so that the product of
// the transposed operands (b^T a^T, a's values as B) adds its terms in
// the order a b does.
template <bool kSwap = false>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split (&a)[4], Split b0,
                                           Split b1) {
  if (kSwap) mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  if (!kSwap) mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

// ------------------------------------------------ wgmma (sm_90a only)
//
// Shared-memory matrix descriptor of a tile in the 128-byte swizzle: rows
// of 128 bytes in atoms of 8 rows (1024 bytes, 1024-aligned) in which the
// 16-byte chunk j of row r is stored at chunk j ^ (r % 8). `lbo` and `sbo`
// are the leading and stride byte offsets: for a K-major operand, sbo is
// the distance between atoms of 8 rows (lbo unused); for an MN-major one,
// lbo is the distance between atoms of 64 MN elements and sbo between
// groups of 8 K rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | (uint64_t)1 << 62;
}

// The same in the 64-byte swizzle: rows of 64 bytes in atoms of 8 rows
// (512 bytes, 512-aligned) in which the 16-byte chunk j of row r is stored
// at chunk j ^ ((r / 2) % 4) (attention_grad_wgmma.cuh and
// attention_tf32_wgmma.cuh at d = 80: a 320-byte f32 row is five 64-byte
// boxes).
__device__ __forceinline__ uint64_t sw64_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | (uint64_t)2 << 62;
}

// The same in the 32-byte swizzle: rows of 32 bytes in atoms of 8 rows
// (256 bytes, 256-aligned) in which the 16-byte chunk j of row r is stored
// at chunk j ^ ((r / 4) % 2) (attention_wgmma.cuh at d = 80: the 16
// columns of a row past its first 64; tf32_wgmma.cuh at d = 88: a 352-byte
// f32 row is eleven 32-byte boxes).
__device__ __forceinline__ uint64_t sw32_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32 | (uint64_t)3 << 62;
}

// The same with no swizzle (attention_wgmma.cuh's ones tile): 8-row core
// matrices of 16-byte rows, 128 bytes each, `lbo` apart along K and `sbo`
// apart along M or N.
__device__ __forceinline__ uint64_t plain_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
}

// Orders this warpgroup's register and shared-memory accesses before the
// next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most `kPending` committed wgmma groups are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (the tensor cores' reads of a wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of `d` across a wgmma_wait.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
  asm volatile("" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) :: "memory");
  asm volatile("" : "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) :: "memory");
  asm volatile("" : "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]) :: "memory");
  asm volatile("" : "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) :: "memory");
  asm volatile("" : "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
                    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]) :: "memory");
  asm volatile("" : "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
                    "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]) :: "memory");
  asm volatile("" : "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
                    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]) :: "memory");
  asm volatile("" : "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) :: "memory");
}

// The same for s32 accumulators.
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
  asm volatile("" : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
                    "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]) :: "memory");
  asm volatile("" : "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                    "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]) :: "memory");
  asm volatile("" : "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
                    "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]) :: "memory");
  asm volatile("" : "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
                    "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]) :: "memory");
  asm volatile("" : "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
                    "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]) :: "memory");
  asm volatile("" : "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
                    "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]) :: "memory");
  asm volatile("" : "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
                    "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]) :: "memory");
  asm volatile("" : "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
                    "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]) :: "memory");
}

// The same for 32 accumulators (m64n64).
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
  asm volatile("" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
                    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) :: "memory");
  asm volatile("" : "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) :: "memory");
  asm volatile("" : "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]) :: "memory");
  asm volatile("" : "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
                    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) :: "memory");
}

// The same for 4 accumulators (m64n8).
__device__ __forceinline__ void fence_operands(float (&d)[4]) {
  asm volatile("" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) :: "memory");
}

// d (64 x 64 f32) = A B, or += A B with `accumulate`: A 64 x 16 bf16 and
// B 16 x 64 bf16, both from shared memory and both K-major (B stored as
// 64 N rows of 16 k: the attention's S = Q K^T, K's rows as they lie).
// The accumulator layout is m64n128's: warp w of the warpgroup holds rows
// 16 w + g and + 8, d[4 j + e] at column 8 j + 2 q + (e & 1) (g = lane /
// 4, q = lane % 4). Asynchronous, as above.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) = A B, or += A B with `accumulate`: A 64 x 16 bf16 from
// registers, in m16n8k16's A layout for the 16 rows of each warp (a0 =
// A[g][2q, 2q+1], a1 = A[g+8][..], a2 = A[g][2q+8, +9], a3 = A[g+8][..]),
// so that m64n64's accumulators of two neighbouring n8 columns, rounded
// and packed in pairs, are the A of a 16-wide k slice; B 16 x 64 bf16 from
// shared memory, MN-major (the transpose bit: N contiguous, the
// attention's V rows as they lie). Asynchronous: the A registers stay in
// use, as the operands above, until wgmma_wait.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 8 f32) = A B, or += A B with `accumulate`: A as wgmma_m64n64k16_rs
// takes it, B 16 x 8 bf16 from shared memory, K-major (warp w holds rows
// 16 w + g in d[0], d[1] and + 8 in d[2], d[3], columns 2 q, 2 q + 1).
// Asynchronous, as above.
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 8 NT f32) = A B, or += A B with `accumulate`: A as
// wgmma_m64n64k16_rs takes it, B 16 x 8 NT bf16 from shared memory,
// MN-major (the transpose bit) within one swizzle atom's width (NT = 2:
// 16 columns in the 32-byte swizzle; 3: 24 of the 64-byte one's 32: the
// columns of a d = 80 / 88 V row past its first 64).
// Accumulators as m64n64's, d[4 j + e] at column 8 j + 2 q + (e & 1).
// Asynchronous, as above.
template <int NT>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[4 * NT], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16_rs<2>(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16_rs<3>(float (&d)[12], const uint32_t (&a)[4],
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128 f32, this warpgroup's accumulators) += A B on the tensor
// cores: A 64 x 16 bf16, K-major; B 16 x 128 bf16, MN-major (N contiguous).
// Asynchronous: the operands stay in use until wgmma_wait.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128 f32, this warpgroup's accumulators) = A B, or += A B with
// `accumulate`, on the tensor cores in TF32: A 64 x 8 from registers, B
// 8 x 128 from shared memory, K-major (N rows of 8 k: the tf32 forms have
// no transpose). Warp w of the warpgroup holds rows 16 w .. 16 w + 15 of
// A as m16n8k8.tf32 does (g = lane / 4, q = lane % 4): a0 = A[g][q], a1 =
// A[g+8][q], a2 = A[g][q+4], a3 = A[g+8][q+4], each the bits of a value
// already rounded to TF32 (the tensor cores drop the low 13 bits). The
// sum d + A B is not rounded to nearest: on an H100 the error of many
// products into one accumulator grew with their count instead of
// averaging out (dequant_matmul.cu's f32 body). Asynchronous: the A
// registers stay in use, as the operands above, until wgmma_wait.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint32_t a0, uint32_t a1,
                                                     uint32_t a2, uint32_t a3, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}

// d (64 x 8 NT f32) = A B, or += A B with `accumulate`, in TF32: A 64 x 8
// and B 8 x 8 NT, both from shared memory and both K-major (rows of 8
// tf32 values, 32 bytes: the tf32 forms have no transpose). NT = 1 .. 4
// (N = 8 .. 32); the accumulators are laid out as m64n64k16's, d[4 j + e]
// at row 16 w + g + 8 (e >> 1), column 8 j + 2 q + (e & 1). Each value's
// low 13 bits are dropped: the operands are TF32 values already.
// Asynchronous, as above.
template <int NT>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[4 * NT], uint64_t a, uint64_t b,
                                              int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<1>(float (&d)[4], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<2>(float (&d)[8], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<3>(float (&d)[12], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<4>(float (&d)[16], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) = A B, or += A B with `accumulate`, in TF32: A 64 x 8
// from registers in m16n8k8.tf32's A layout for each warp's 16 rows (a0 =
// A[g][q], a1 = A[g+8][q], a2 = A[g][q+4], a3 = A[g+8][q+4], as
// wgmma_m64n128k8_tf32 takes it), B 8 x 64 from shared memory, K-major.
// Asynchronous, as above.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The same at N = 80: d (64 x 80 f32), B 8 x 80 (a d = 80 head's columns).
__device__ __forceinline__ void wgmma_m64n80k8_tf32_rs(float (&d)[40], const uint32_t (&a)[4],
                                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The same at N = 88: d (64 x 88 f32), B 8 x 88 (a d = 88 head's columns).
__device__ __forceinline__ void wgmma_m64n88k8_tf32_rs(float (&d)[44], const uint32_t (&a)[4],
                                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %49, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43"
      "}, {%44, %45, %46, %47}, %48, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Keeps the compiler from moving accesses of any accumulator array across
// a wgmma_wait, one register at a time.
template <int N>
__device__ __forceinline__ void fence_each(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128 s32, this warpgroup's accumulators) += A B on the tensor
// cores: A 64 x 32 s8 and B 32 x 128 s8, both K-major (the s8 form has no
// transpose: B is stored N rows of K bytes). It takes scale-d alone, no
// negate or transpose immediates. Asynchronous, as above.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// ------------------------------------- TMA and mbarriers (sm_90a only)

// An mbarrier for `count` arriving threads; fence_mbarrier_init makes the
// initialization visible to the asynchronous proxy (the TMA unit).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival, which also expects `bytes` of asynchronous copies
// to complete on the barrier before its phase flips.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// mbar_wait that gives up: after ~2^24 polls (seconds) the thread traps, so
// a copy that never lands fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, %2;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "sub.u32 n, n, 1;\n"
      "setp.ne.u32 p, n, 0;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity), "n"(1 << 24) : "memory");
}

// TMA: the box at (c0, c1) (innermost coordinate first) of the 2-D tensor
// `map` describes, into shared memory at `dst` in the map's layout;
// completes `bar`'s expected bytes. Out-of-range elements are zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar))
      : "memory");
}

// TMA: shared memory at `src`, in the map's layout, to the box at (c0, c1)
// of the 2-D tensor `map` describes; elements out of range are not
// written. Asynchronous: bulk_commit closes this thread's group of stores,
// bulk_wait_read<N> waits until at most N groups still read shared memory
// and bulk_wait<N> until at most N are still writing. The writes of this
// thread's generic proxy to `src` need fence_proxy_async first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(src))
      : "memory");
}

// The same for a 3-D tensor: the box at (c0, c1, c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int c0, int c1, int c2,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}

// The same for a 4-D tensor: the box at (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, int c0, int c1, int c2,
                                             int c3, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(smem_u32(src))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(kPending) : "memory");
}

template <int kPending>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(kPending) : "memory");
}

}  // namespace tc
