// Tensor-core and asynchronous-copy building blocks of attention_qkv.cu
// and attention_qkv_grad.cu (K1/K3 and K2: cp.async, ldmatrix, the bf16
// mma.sync.m16n8k16 product and the f32 3xTF32 product on
// mma.sync.m16n8k8.tf32, PTX ISA sm_80+) and dequant_matmul.cu (K4:
// cp.async, TMA with mbarriers and the asynchronous wgmma.m64n128k16
// product, sm_90a). Every product accumulates in f32.
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

}  // namespace tc
