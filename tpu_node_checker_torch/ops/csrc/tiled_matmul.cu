// Tiled bf16 matmul on the tensor cores (wgmma), fed by a TMA ring, with a
// fused x scale epilogue.
//
// Replaces tpu_node_checker/ops/pallas_probe.py::_tiled_matmul (the Pallas
// kernel behind pallas_ok): C[M,N] = scale * (A[M,K] @ B[K,N]), bf16 inputs,
// f32 accumulation, f32 output.
//
// What bounds it on an H100: at the probe's 512^3 the work is 0.27 GFLOP
// (0.27 us at 989 TFLOP/s bf16) against 2 MiB of traffic (A, B read once,
// C written once: 0.63 us at 3.35 TB/s), so a launch is far longer than
// either; at 4096^3 the 137 GFLOP bound it (0.139 ms).  The design:
//
//  * one block per BM x BN output tile: BM/64 consumer warpgroups, each
//    owning 64 rows (the wgmma M), and one producer warp;
//  * the K loop walks slices 64 deep (128 bytes of bf16, the swizzle width).
//    The producer's one thread copies each slice of A (BM x 64) and B
//    (64 x BN) by TMA with a 128-byte swizzle into a 4-stage ring, each stage
//    completing on a "full" mbarrier and freed by the consumers on an "empty"
//    one, so up to three slices are in flight ahead of the math;
//  * each consumer warpgroup runs wgmma m64nBNk16 with both operands read
//    from shared memory through descriptors: A K-major, B (K, N) row-major
//    MN-major, read with the transpose flag.  One group of products stays in
//    flight while the previous slice's stage is handed back;
//  * the x scale runs on the f32 accumulators in registers, which are then
//    stored straight to C;
//  * the tile follows the grid (the wrapper picks it, pallas_probe.py
//    matmul_tile): 128 x 128 when that gives a block for every SM, else
//    64 x 64 (64 blocks at the probe's 512^2, where 128 x 128 gives 16).
//    The K loop is never split, so every tile sums in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;      // K slice: 64 bf16 = one 128-byte swizzled row
constexpr int STAGES = 4;

template <int BM, int BN>
struct Ring {
  static constexpr int CONSUMERS = BM * 2;            // one warpgroup per 64 rows
  static constexpr int THREADS = CONSUMERS + 32;      // and one producer warp
  static constexpr int A_BYTES = BM * BK * 2;         // one stage of A
  static constexpr int B_BYTES = BK * BN * 2;         // one stage of B
  static constexpr int SMEM_BYTES = STAGES * (A_BYTES + B_BYTES) + 1024 + 64;
};

template <int BM, int BN>
__global__ void __launch_bounds__(Ring<BM, BN>::THREADS)
tiled_matmul_kernel(__grid_constant__ const CUtensorMap amap,
                    __grid_constant__ const CUtensorMap bmap, float* __restrict__ c, int N,
                    int K, float scale) {
  using R = Ring<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = hopper::align_1024(smem_raw);         // STAGES x (BM x 64)
  uint8_t* sb = sa + STAGES * R::A_BYTES;             // STAGES x (64 x BN)
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * R::B_BYTES);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int slices = K / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], R::CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= R::CONSUMERS) {  // the producer warp: one thread issues every copy
    if (tid == R::CONSUMERS) {
      for (int i = 0; i < slices; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) hopper::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], R::A_BYTES + R::B_BYTES);
        hopper::tma_load_2d(sa + s * R::A_BYTES, &amap, &full[s], i * BK, m0);
        // B in column blocks of 64: each k row of a block is one swizzled row.
        for (int cb = 0; cb < BN / 64; ++cb)
          hopper::tma_load_2d(sb + s * R::B_BYTES + cb * BK * 128, &bmap, &full[s],
                              n0 + cb * 64, i * BK);
      }
    }
    return;
  }

  // A consumer warpgroup: rows wg*64 .. +64 of the tile.
  const int wg = tid / 128;
  const int lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int i = 0; i < slices; ++i) {
    const int s = i % STAGES;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* a_tile = sa + s * R::A_BYTES + wg * 64 * 128;
    const uint8_t* b_tile = sb + s * R::B_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A K-major: a k16 step is 32 bytes along the 128-byte row.  B MN-major:
      // a k16 step is 16 rows; column blocks of 64 are BK rows apart.
      const uint64_t da = hopper::make_desc(a_tile + kk * 32, 16, 1024, hopper::SWIZZLE_128B);
      const uint64_t db = hopper::make_desc(b_tile + kk * 16 * 128, BK * 128, 1024,
                                            hopper::SWIZZLE_128B);
      hopper::wgmma_ss<BN, 1>(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    // Keep this slice's products in flight; the previous slice's are done,
    // so its stage goes back to the producer.
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (i > 0) hopper::mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // Epilogue: x scale on the accumulators, then straight to C.  acc[4j+e] is
  // row 16*warp + lane/4 (+8 for e >= 2), column 8j + 2*(lane%4) + e%2.
  const int row = m0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int rr = row + 8 * ((i / 2) % 2);
    const int col = n0 + (i / 4) * 8 + (lane % 4) * 2;
    *reinterpret_cast<float2*>(c + (size_t)rr * N + col) =
        make_float2(acc[i] * scale, acc[i + 1] * scale);
  }
}

template <int BM, int BN>
int launch(const void* a, const void* b, void* c, int M, int N, int K, float scale,
           cudaStream_t stream) {
  using R = Ring<BM, BN>;
  CUtensorMap amap, bmap;
  cudaError_t err = hopper::encode_tmap_bf16_2d(&amap, a, K, M, BK, BM,
                                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hopper::encode_tmap_bf16_2d(&bmap, b, N, K, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(tiled_matmul_kernel<BM, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / BN, M / BM);
  tiled_matmul_kernel<BM, BN><<<grid, R::THREADS, R::SMEM_BYTES, stream>>>(
      amap, bmap, static_cast<float*>(c), N, K, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  The caller has checked: bf16 A (M,K) and B (K,N), f32
// C (M,N), all contiguous on one device, 16-byte aligned, M and N multiples of
// 128, K a multiple of 64, and picked the tile (bm, bn): 128 x 128 or 64 x 64.  Launches on `stream` and returns cudaGetLastError() (or the error
// of encoding a tensor map).
extern "C" int tnc_tiled_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                                int bm, int bn, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128) return launch<128, 128>(a, b, c, M, N, K, scale, st);
  if (bm == 64 && bn == 64) return launch<64, 64>(a, b, c, M, N, K, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
