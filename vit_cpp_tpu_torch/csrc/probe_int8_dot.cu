// Tensor-core product probe for Hopper (sm_90a), CUDA C++: C = A B with
// int8 x int8 -> int32 exact (wgmma m64n128k32 .s8) or bf16 x bf16 -> f32
// (wgmma m64n128k16 .bf16), one kernel templated on the type, on the
// asynchronous tensor cores fed by TMA.
//
// Replaces the TPU kernel of tools/probe_int8_dot.py::_mk (_dot_kernel,
// one whole-array jax.lax.dot_general inside Pallas), which asks whether
// the int8 mode of the matrix unit runs at twice the bf16 rate inside a
// kernel. Here: whether a hand-written kernel reaches Hopper's int8
// tensor-core rate at twice its bf16 rate (1,979 vs 989 dense TOP/s on
// the data sheet), which decides the design of a fused W8A8 matmul.
// wgmma is the only way to either full rate; mma.sync reaches neither.
//
// What bounds it (bytes: each input read once, C written once, at
// 3.35 TB/s; operations at the data-sheet peak). At M = K = N = 1024 the
// product is 2.1 GOP over 6.3 (int8) or 8.4 (bf16) MB: 1.9 / 2.5 us of
// memory time against 1.1 / 2.2 us of tensor-core time, so a single call
// is short enough that its launch and the ring's fill weigh. At the
// ViT-B/16 W8A8 linears of a B=64 batch (M = 64 x 197 = 12608) the int32 /
// f32 output dominates the bytes:
//
//   linear (K -> N)  GOP   C bytes  ops bound int8 / bf16  bytes bound int8 / bf16 inputs
//   qkv  768 -> 2304 44.6  116 MB   0.0225 / 0.0451 ms     0.0381 / 0.0415 ms
//   proj 768 -> 768  14.9  38.7 MB  0.0075 / 0.0150        0.0146 / 0.0177
//   fc1  768 -> 3072 59.5  155 MB   0.0301 / 0.0602        0.0498 / 0.0534
//   fc2 3072 -> 768  59.5  38.7 MB  0.0301 / 0.0602        0.0238 / 0.0361
//
// so only fc2 is bound by the int8 operations; at qkv, proj and fc1 the
// int32 store sets the int8 bound, and the int8 : bf16 ratio there reads
// as an output-bandwidth ratio, not a tensor-core one.
//
// Design. A persistent block per SM walks C's tiles (blockIdx.x, +
// gridDim.x, ...): 128 x 128 tiles (two consumer warpgroups, one m64n128
// accumulator each) where those still give every SM a tile, else 64 x 128
// (one warpgroup; 1024^3: 128 tiles in one wave, not 64). Each step of 128
// bytes of K (64 bf16 or 128 int8) goes through a ring of 4-6 shared-memory
// stages (as many as the block's 227 KB leave), one mbarrier each, filled
// by TMA in the 128-byte swizzle: A's
// BM x 128-byte box (K-major, as wgmma reads it) and B's 128 K rows x 128
// columns. bf16 reads B N-major through the descriptor (two 64 x 64 boxes,
// 8 KB apart: lbo 8192 between the 64-column atoms, sbo 1024 between
// groups of 8 K rows). s8 takes B K-major only, so the raw int8 tile is
// transposed in shared memory into a K-major tile (N rows of 128 K bytes,
// 16-byte chunk j of row n at j ^ (n % 8)): each thread reads four 4-byte
// words of a 4 x 4 byte block, permutes the bytes and writes four words,
// with lanes laid out so that the reads and the writes of a warp each fall
// in 32 distinct banks; fence.proxy.async then hands the tile to the
// tensor cores. An int8 B given K-major, (N, K), as a W8A8 kernel keeps its
// weights (dtype 2), skips the transpose: TMA writes it in wgmma's layout.
// Step k's wgmmas (32 bytes of K each) are issued while step k - 1's run;
// the block then waits for step k - 1's, meets at one barrier, refills
// step k - 1's ring slot by TMA (thread 0, whose division-free cursor runs
// on into the next tile) and (int8) transposes step k + 1 into the other of
// two K-major tiles while step k's wgmmas run, as K4 overlaps its
// dequantize. A tile's accumulators are staged in shared memory as four
// 32-column boxes in the 128-byte swizzle and leave by TMA stores, one box
// per step of the next tile: the int32 / f32 tile is written while the
// tensor cores work, not in a burst between tiles (at qkv, C's writes alone
// take about as long as the int8 products). K beyond the last whole step
// reads as TMA's zero fill; the stores drop rows and columns past M and N.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"
#include "tensor_map.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBN = 128;                  // C columns per block
constexpr int kStepBytes = 128;           // K bytes per step: one swizzle row
constexpr int kMaxStages = 6;             // TMA ring, at most
constexpr int kBTile = kStepBytes * kBN;  // B's tile of one step, 16 KB

template <typename T> struct Mma;

template <> struct Mma<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapDataType kOut = CU_TENSOR_MAP_DATA_TYPE_INT32;
  // K slice kk (32 bytes) of A's K-major tile and of the transposed B tile
  static __device__ __forceinline__ void run(Acc (&d)[64], const unsigned char* a,
                                             const unsigned char* b, int kk) {
    tc::wgmma_m64n128k32_s8(d, tc::sw128_desc(a + kk * 32, 16, 1024),
                            tc::sw128_desc(b + kk * 32, 16, 1024));
  }
  static __device__ __forceinline__ void store(Acc* p, Acc x, Acc y) {
    *reinterpret_cast<int2*>(p) = make_int2(x, y);
  }
};

template <> struct Mma<bf16> {
  using Acc = float;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType kOut = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // K slice kk (16 rows) of A's K-major tile and of B's N-major boxes
  static __device__ __forceinline__ void run(Acc (&d)[64], const unsigned char* a,
                                             const unsigned char* b, int kk) {
    tc::wgmma_m64n128k16(d, tc::sw128_desc(a + kk * 32, 16, 1024),
                         tc::sw128_desc(b + kk * 2048, 8192, 1024));
  }
  static __device__ __forceinline__ void store(Acc* p, Acc x, Acc y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// Shared memory of a block, from a 1024-aligned base: the ring of kStages
// x (A's tile, BM rows x 128 bytes; B's tile, 16 KB), then (int8 B given
// (K, N)) two K-major B tiles, then C's tile as four boxes of BM rows x
// 32 columns (128 bytes) in the 128-byte swizzle, as TMA stores it, then
// one mbarrier per ring slot. The ring takes what the rest leaves of a
// block's 227 KB, up to kMaxStages.
template <int BM, bool kTranspose>
struct Smem {
  static constexpr int kA = BM * kStepBytes;
  static constexpr int kStage = kA + kBTile;
  static constexpr int kCBox = BM * 128;
  static constexpr int kRest = (kTranspose ? 2 * kBTile : 0) + 4 * kCBox;
  static constexpr int kFit = (232448 - 1024 - kRest) / (kStage + 8);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kT = kStages * kStage;
  static constexpr int kC = kT + (kTranspose ? 2 * kBTile : 0);
  static constexpr int kBar = kC + 4 * kCBox;
  static constexpr int kBytes = kBar + kStages * 8;
  static_assert(kA % 1024 == 0 && kStage % 1024 == 0, "atoms stay 1024-aligned");
  static_assert(kStages >= 3, "the ring holds steps k - 1, k and k + 1");
};

// W warpgroups, one m64n128 accumulator each: a BM = 64 W row tile. kNK:
// B is given K-major, (N, K) (int8 only).
template <typename T, int W, bool kNK>
__global__ void __launch_bounds__(128 * W, 1)
    dot_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
               const __grid_constant__ CUtensorMap cmap, int M, int N, int K) {
  constexpr int kBM = 64 * W;
  constexpr bool kInt8 = sizeof(T) == 1, kTranspose = kInt8 && !kNK;
  using S = Smem<kBM, kTranspose>;
  constexpr int kStages = S::kStages;
  using Acc = typename Mma<T>::Acc;
  constexpr int kStepK = kStepBytes / sizeof(T);  // K elements per step
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  // the block's tiles: blockIdx.x, + gridDim.x, ...; tile t is C's rows
  // (t / tiles_n) BM .. and columns (t % tiles_n) 128 ..
  const int tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_n * ((M + kBM - 1) / kBM);
  const int nsteps = (K + kStepK - 1) / kStepK;
  const int total = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * nsteps;
  auto stage_a = [&](int s) { return smem + s * S::kStage; };
  auto stage_b = [&](int s) { return smem + s * S::kStage + S::kA; };
  auto tile_t = [&](int i) { return smem + S::kT + i * kBTile; };
  unsigned char* tile_c = smem + S::kC;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBar);

  // The TMA copies of the next step into ring slot `s` (thread 0, in step
  // order): A's box, then B's (int8: 128 rows x 128 bytes, K rows or, kNK,
  // N rows; bf16: two boxes of 64 x 64). The cursor walks the steps of the
  // block's tiles without a division, which would hold up warp 0's next
  // wgmma.
  int p_k = 0, p_m = (int)blockIdx.x / tiles_n, p_n = (int)blockIdx.x % tiles_n;
  auto issue = [&](int s) {
    const int k0 = p_k * kStepK, m0 = p_m * kBM, n0 = p_n * kBN;
    tc::mbar_arrive_expect_tx(&full[s], S::kStage);
    tc::tma_load_2d(stage_a(s), &amap, k0, m0, &full[s]);
    if (kNK) {
      tc::tma_load_2d(stage_b(s), &bmap, k0, n0, &full[s]);
    } else {
      tc::tma_load_2d(stage_b(s), &bmap, n0, k0, &full[s]);
      if (!kInt8) tc::tma_load_2d(stage_b(s) + kBTile / 2, &bmap, n0 + 64, k0, &full[s]);
    }
    if (++p_k == nsteps) {
      p_k = 0;
      for (p_n += gridDim.x; p_n >= tiles_n; p_n -= tiles_n) ++p_m;
    }
  };

  // The staged C tile of the previous tile, at (c_m0, c_n0), goes out by
  // TMA one 32-column box per step of the next tile (thread 0), so that its
  // writes to memory spread over the tile's steps; `boxes` are still to go.
  int boxes = 0, c_m0 = 0, c_n0 = 0;
  auto store_box = [&]() {
    const int b = 4 - boxes--;
    tc::tma_store_2d(&cmap, c_n0 + 32 * b, c_m0, tile_c + b * S::kCBox);
    tc::bulk_commit();
  };

  // int8 B given (K, N): the raw tile (128 K rows x 128 N bytes, swizzled)
  // -> the K-major tile (128 N rows x 128 K bytes, swizzled), in 4 x 4 byte
  // blocks (kb, nb) of rows k = 4 kb .. + 3, columns n = 4 nb .. + 3. A
  // warp's lanes take kb = (l2, l3, l1, l4) and nb = (l0, l1, l3, l4) in bits
  // 0-3 (l = lane bits): the word a lane reads of row k sits at chunk
  // (nb / 4) ^ (k % 8), word nb % 4, and the word it writes of row n at
  // chunk (kb / 4) ^ (n % 8), word kb % 4, which are 32 distinct banks in
  // both cases. The 32 cosets of this set (nb ^ 2 t for t < 8, and bit 4 of
  // kb and of nb) go to the block's 4 W warps in 8 / W rounds.
  const int l0 = lane & 1, l1 = (lane >> 1) & 1, l2 = (lane >> 2) & 1, l3 = (lane >> 3) & 1,
            l4 = lane >> 4;
  const int kb_lane = l2 | l3 << 1 | l1 << 2 | l4 << 3;
  const int nb_lane = l0 | l1 << 1 | l3 << 2 | l4 << 3;
  auto transpose = [&](const unsigned char* raw, unsigned char* t) {
#pragma unroll
    for (int i = 0; i < 8 / W; ++i) {
      const int coset = i * 4 * W + warp;
      const int kb = kb_lane | (coset >> 4) << 4;
      const int nb = (nb_lane ^ (coset & 7) << 1) | ((coset >> 3) & 1) << 4;
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 4 * kb + r;
        w[r] = *reinterpret_cast<const uint32_t*>(raw + k * 128 + (((nb >> 2) ^ (k & 7)) << 4) +
                                                  (nb & 3) * 4);
      }
      // o[j]: column n = 4 nb + j at k = 4 kb .. + 3
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
      const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * nb + j;
        *reinterpret_cast<uint32_t*>(t + n * 128 + (((kb >> 2) ^ (n & 7)) << 4) + (kb & 3) * 4) =
            o[j];
      }
    }
  };

  // warpgroup wg owns rows 64 wg .. + 63 of the tile
  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) tc::mbar_init(&full[s], 1);
    tc::fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages && s < total; ++s) issue(s);
  if constexpr (kTranspose) {
    tc::mbar_wait(&full[0], 0);
    transpose(stage_b(0), tile_t(0));
    tc::fence_proxy_async();  // the K-major tile, for the wgmmas
    __syncthreads();
  }

  // Step st (counted over all of the block's tiles): its wgmmas are issued
  // while step st - 1's may still run; once this warpgroup's st - 1 group
  // is done, one barrier says every warpgroup's is, so st - 1's ring slot
  // takes step st - 1 + kStages and (int8) the K-major tile st - 1 read
  // takes step st + 1.
  const int g = lane >> 2, q = lane & 3;
  int st = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int kb = 0; kb < nsteps; ++kb, ++st) {
      const int s = st % kStages;
      tc::mbar_wait(&full[s], (st / kStages) & 1);
      const unsigned char* bs = kTranspose ? tile_t(st & 1) : stage_b(s);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Mma<T>::run(acc, stage_a(s) + wg * 64 * kStepBytes, bs, kk);
      tc::wgmma_commit();
      tc::wgmma_wait<1>();
      tc::fence_operands(acc);
      __syncthreads();
      if (tid == 0) {
        if (st >= 1 && st - 1 + kStages < total) issue((st - 1) % kStages);
        if (boxes > 0) store_box();
      }
      if constexpr (kTranspose) {
        if (st + 1 < total) {
          tc::mbar_wait(&full[(st + 1) % kStages], ((st + 1) / kStages) & 1);
          transpose(stage_b((st + 1) % kStages), tile_t((st + 1) & 1));
          tc::fence_proxy_async();
          __syncthreads();
        }
      }
    }
    tc::wgmma_wait<0>();
    tc::fence_operands(acc);
    // Stage the tile once the previous tile's boxes have gone out and been
    // read. The m64n128 fragment: acc[4 j], [4 j + 1] at row 16 (warp % 4)
    // + g, columns 8 j + 2 q, + 1; acc[4 j + 2], [4 j + 3] eight rows below;
    // box col / 32 holds columns 32 b .. + 31 as 128-byte rows (rows and
    // columns past M and N are dropped by the store).
    if (tid == 0) {
      while (boxes > 0) store_box();
      tc::bulk_wait_read<0>();
    }
    __syncthreads();
    const int r0 = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * q;
      unsigned char* box = tile_c + (col >> 5) * S::kCBox + (col & 3) * 4;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        Mma<T>::store(reinterpret_cast<Acc*>(box + (r0 + 8 * e) * 128 +
                                             ((((col & 31) >> 2) ^ g) << 4)),
                      acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    tc::fence_proxy_async();  // the staged tile, for the TMA stores
    __syncthreads();
    if (tid == 0) c_m0 = t / tiles_n * kBM, c_n0 = t % tiles_n * kBN, boxes = 4;
  }
  if (tid == 0) {
    while (boxes > 0) store_box();
    tc::bulk_wait<0>();
  }
}

template <typename T, int W, bool kNK>
cudaError_t run(const void* a, const void* b, void* c, int M, int N, int K, int blocks,
                cudaStream_t stream) {
  constexpr int kStepK = kStepBytes / sizeof(T), kBM = 64 * W;
  // A (M, K): boxes of BM rows x one K step; B (K, N): boxes of one K step
  // x 128 bytes of columns, or (N, K): boxes of 128 rows x one K step; C
  // (M, N): boxes of BM rows x 32 columns
  CUtensorMap amap, bmap, cmap;
  cudaError_t err = tc::encode_sw128(&amap, Mma<T>::kType, a, K, M, (uint64_t)K * sizeof(T),
                                     kStepK, kBM);
  if (err != cudaSuccess) return err;
  err = kNK ? tc::encode_sw128(&bmap, Mma<T>::kType, b, K, N, (uint64_t)K, kStepK, kBN)
            : tc::encode_sw128(&bmap, Mma<T>::kType, b, N, K, (uint64_t)N * sizeof(T),
                               kStepBytes / sizeof(T), kStepK);
  if (err != cudaSuccess) return err;
  err = tc::encode_sw128(&cmap, Mma<T>::kOut, c, N, M, (uint64_t)N * 4, 32, kBM);
  if (err != cudaSuccess) return err;
  static bool configured = false;
  constexpr int bytes = Smem<kBM, sizeof(T) == 1 && !kNK>::kBytes + 1024;  // + base alignment
  if (!configured) {
    err = cudaFuncSetAttribute(dot_kernel<T, W, kNK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dot_kernel<T, W, kNK><<<blocks, 128 * W, bytes, stream>>>(amap, bmap, cmap, M, N, K);
  return cudaGetLastError();
}

// 128 x 128 tiles (two warpgroups) where they still give every SM a tile,
// else 64 x 128 (one warpgroup); one persistent block per SM at most.
template <typename T, bool kNK>
cudaError_t run_tiled(const void* a, const void* b, void* c, int M, int N, int K,
                      cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles_n = (N + kBN - 1) / kBN;
  if ((M + 127) / 128 * tiles_n >= sms) return run<T, 2, kNK>(a, b, c, M, N, K, sms, stream);
  const int narrow = M / 64 * tiles_n;
  return run<T, 1, kNK>(a, b, c, M, N, K, narrow < sms ? narrow : sms, stream);
}

}  // namespace

// C interface, loaded with ctypes (vit_cpp_tpu_torch/_build.py).
// a: contiguous (M, K), b: contiguous (K, N), c: contiguous (M, N), all
// 16-byte aligned. dtype 0: int8 inputs, int32 output, K % 64 == 0;
// dtype 1: bf16 inputs, f32 output, K % 32 == 0; dtype 2: as 0, with b
// contiguous (N, K) (B given K-major, as a W8A8 kernel keeps its weights).
// M % 64 == N % 64 == 0. Returns cudaGetLastError() after the launch.
extern "C" int vit_probe_dot(const void* a, const void* b, void* c, int M, int N,
                             int K, int dtype, void* stream) {
  const int kmul = dtype == 1 ? 32 : 64;
  if (M < 64 || N < 64 || K < kmul || M % 64 || N % 64 || K % kmul || M / 64 > 65535 ||
      dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_tiled<int8_t, false>(a, b, c, M, N, K, s);
  if (dtype == 2) return (int)run_tiled<int8_t, true>(a, b, c, M, N, K, s);
  return (int)run_tiled<bf16, false>(a, b, c, M, N, K, s);
}
