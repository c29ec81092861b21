// Tensor-core product probe for Hopper (sm_90a), CUDA C++: C = A B with
// int8 x int8 -> int32 (mma.sync m16n8k32 .s8) or bf16 x bf16 -> f32
// (mma.sync m16n8k16 .bf16), one tiled kernel templated on the type.
//
// Replaces the TPU kernel of tools/probe_int8_dot.py::_mk (_dot_kernel,
// one whole-array jax.lax.dot_general inside Pallas), which asks whether
// the int8 mode of the matrix unit runs at twice the bf16 rate inside a
// kernel. Here the question is whether a hand-written kernel reaches
// Hopper's int8 tensor-core rate at twice its bf16 rate (1,979 vs 989
// dense TOP/s on the data sheet), which decides the design of a W8A8
// matmul kernel. wgmma, the only way to the full rate, is later work:
// this kernel measures what mma.sync gives.
//
// What bounds it: at M = K = N = 1024 the product is 2.1 GOP over 6.3
// (int8) or 8.4 (bf16) MB, ~1.9 / 2.5 us of HBM time at 3.35 TB/s, so a
// single call is bound by latency and the instruction issue of the tile
// loop, not by either peak.
//
// Design. One block of 128 threads (2 x 2 warps) per 64 x 64 tile of C;
// each warp owns 32 x 32 (2 x 4 mma tiles). The K loop steps 64 bytes of
// K (64 int8 or 32 bf16), double-buffered through shared memory: the next
// step's tiles are loaded into registers while the current step's mmas
// run. Both mma shapes take 32 bytes of K per instruction, so their A and
// B fragments are the same 32-bit words: A is staged row-major; B (K, N)
// is transposed on the way in (byte or half-word permutes in registers)
// to N-major rows, so that each B fragment is one 32-bit shared load.
// Row strides of 20 words put a warp's fragment loads in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64;  // C tile per block
constexpr int kBKB = 64;           // K bytes per step
constexpr int kSW = kBKB / 4 + 4;  // shared row stride in 32-bit words
constexpr int kThreads = 128;

template <typename T> struct Mma;

template <> struct Mma<int8_t> {
  using Acc = int32_t;
  static __device__ __forceinline__ void run(Acc (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <> struct Mma<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ void run(Acc (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// One K step's tiles in registers: A as two 16-byte chunks per thread, B
// as the 32-bit words this thread transposes.
template <typename T> struct Stage;

template <> struct Stage<int8_t> {
  // B step: 64 (k) x 64 (n) bytes = 256 blocks of 4 x 4 bytes, 2 per thread
  static constexpr int kBlocks = 2, kWords = 4;
  static __device__ __forceinline__ void load_b(uint32_t (&w)[kBlocks][kWords],
                                                const int8_t* b, int N, int k0, int n0) {
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) {
      const int blk = threadIdx.x + kThreads * i, kb = blk / 16, nb = blk % 16;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[i][r] = *reinterpret_cast<const uint32_t*>(b + (size_t)(k0 + 4 * kb + r) * N + n0 + 4 * nb);
    }
  }
  static __device__ __forceinline__ void store_b(uint32_t* sB, const uint32_t (&w)[kBlocks][kWords]) {
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) {
      const int blk = threadIdx.x + kThreads * i, kb = blk / 16, nb = blk % 16;
      // 4 x 4 byte transpose: o[j] holds column n = 4 nb + j at k = 4 kb .. +3
      const uint32_t t0 = __byte_perm(w[i][0], w[i][1], 0x5140);
      const uint32_t t1 = __byte_perm(w[i][0], w[i][1], 0x7362);
      const uint32_t t2 = __byte_perm(w[i][2], w[i][3], 0x5140);
      const uint32_t t3 = __byte_perm(w[i][2], w[i][3], 0x7362);
      sB[(4 * nb + 0) * kSW + kb] = __byte_perm(t0, t2, 0x5410);
      sB[(4 * nb + 1) * kSW + kb] = __byte_perm(t0, t2, 0x7632);
      sB[(4 * nb + 2) * kSW + kb] = __byte_perm(t1, t3, 0x5410);
      sB[(4 * nb + 3) * kSW + kb] = __byte_perm(t1, t3, 0x7632);
    }
  }
};

template <> struct Stage<__nv_bfloat16> {
  // B step: 32 (k) x 64 (n) bf16 = 512 blocks of 2 x 2, 4 per thread
  static constexpr int kBlocks = 4, kWords = 2;
  static __device__ __forceinline__ void load_b(uint32_t (&w)[kBlocks][kWords],
                                                const __nv_bfloat16* b, int N, int k0, int n0) {
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) {
      const int blk = threadIdx.x + kThreads * i, kb = blk / 32, nb = blk % 32;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        w[i][r] = *reinterpret_cast<const uint32_t*>(b + (size_t)(k0 + 2 * kb + r) * N + n0 + 2 * nb);
    }
  }
  static __device__ __forceinline__ void store_b(uint32_t* sB, const uint32_t (&w)[kBlocks][kWords]) {
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) {
      const int blk = threadIdx.x + kThreads * i, kb = blk / 32, nb = blk % 32;
      // word kb of row n holds k = 2 kb (low half) and 2 kb + 1 (high half)
      sB[(2 * nb + 0) * kSW + kb] = __byte_perm(w[i][0], w[i][1], 0x5410);
      sB[(2 * nb + 1) * kSW + kb] = __byte_perm(w[i][0], w[i][1], 0x7632);
    }
  }
};

// A step: 64 rows x 64 bytes = 256 chunks of 16 bytes, 2 per thread.
__device__ __forceinline__ void load_a(uint4 (&ra)[2], const uint8_t* a, size_t row_bytes,
                                       int m0, int kbyte0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + kThreads * i, row = c / 4, col = c % 4;
    ra[i] = *reinterpret_cast<const uint4*>(a + (size_t)(m0 + row) * row_bytes + kbyte0 + 16 * col);
  }
}

__device__ __forceinline__ void store_a(uint32_t* sA, const uint4 (&ra)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + kThreads * i, row = c / 4, col = c % 4;
    *reinterpret_cast<uint4*>(sA + row * kSW + 4 * col) = ra[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
               typename Mma<T>::Acc* __restrict__ c, int M, int N, int K) {
  using Acc = typename Mma<T>::Acc;
  using St = Stage<T>;
  constexpr int kBK = kBKB / sizeof(T);  // K elements per step
  __shared__ __align__(16) uint32_t sA[2][kBM * kSW];
  __shared__ __align__(16) uint32_t sB[2][kBN * kSW];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const uint8_t* ab = reinterpret_cast<const uint8_t*>(a);
  const size_t row_bytes = (size_t)K * sizeof(T);

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  uint4 ra[2];
  uint32_t rb[St::kBlocks][St::kWords];
  load_a(ra, ab, row_bytes, m0, 0);
  St::load_b(rb, b, N, 0, n0);
  store_a(sA[0], ra);
  St::store_b(sB[0], rb);
  __syncthreads();

  const int steps = K / kBK;
  for (int kt = 0; kt < steps; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < steps) {
      load_a(ra, ab, row_bytes, m0, (kt + 1) * kBKB);
      St::load_b(rb, b, N, (kt + 1) * kBK, n0);
    }
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {  // two 32-byte mma depths per step
      const int w0 = kc * 8 + q;
      uint32_t fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t* r = sA[buf] + (wm + 16 * i + g) * kSW + w0;
        fa[i][0] = r[0];
        fa[i][1] = r[8 * kSW];
        fa[i][2] = r[4];
        fa[i][3] = r[8 * kSW + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t* r = sB[buf] + (wn + 8 * j + g) * kSW + w0;
        fb[j][0] = r[0];
        fb[j][1] = r[4];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Mma<T>::run(acc[i][j], fa[i], fb[j]);
    }
    if (kt + 1 < steps) {
      store_a(sA[buf ^ 1], ra);
      St::store_b(sB[buf ^ 1], rb);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm + 16 * i + g, col = n0 + wn + 8 * j + 2 * q;
      Acc* p0 = c + (size_t)row * N + col;
      Acc* p1 = c + (size_t)(row + 8) * N + col;
      p0[0] = acc[i][j][0];
      p0[1] = acc[i][j][1];
      p1[0] = acc[i][j][2];
      p1[1] = acc[i][j][3];
    }
}

template <typename T>
cudaError_t run(const void* a, const void* b, void* c, int M, int N, int K,
                cudaStream_t stream) {
  const dim3 grid(N / kBN, M / kBM);
  dot_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<typename Mma<T>::Acc*>(c), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// a: contiguous (M, K), b: contiguous (K, N), c: contiguous (M, N), all
// 16-byte aligned. dtype 0: int8 inputs, int32 output, K % 64 == 0;
// dtype 1: bf16 inputs, f32 output, K % 32 == 0. M % 64 == N % 64 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int vit_probe_dot(const void* a, const void* b, void* c, int M, int N,
                             int K, int dtype, void* stream) {
  const int bk = dtype == 0 ? kBKB : kBKB / 2;
  if (M < kBM || N < kBN || K < bk || M % kBM || N % kBN || K % bk ||
      M / kBM > 65535 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<int8_t>(a, b, c, M, N, K, s);
  return (int)run<__nv_bfloat16>(a, b, c, M, N, K, s);
}
