// One product of the burn chain on the tensor cores (wgmma bf16), with the
// chain's rescale and cast fused into its epilogue:
//
//   out[M,N] = bf16(scale * (x[M,K] @ a[K,N]))     (bf16 in, f32 sums, bf16 out)
//
// Replaces no Pallas kernel.  The JAX chain (tpu_node_checker/ops/burn.py
// ::_burn_chain) is XLA's dot in a fori_loop, then x scale, then the cast; the
// port first ran each product as three kernels: cuBLAS's GEMM writing an f32
// result, a pass multiplying it by the scale, and a pass casting it to bf16.
// The two passes do no tensor-core work and took a third of the product's
// card time.
//
// What bounds it on an H100: at the chain's n = 2048 a product is 17.2 GFLOP
// (17.37 us at 989 TFLOP/s bf16) against 24 MiB of traffic (x and a read once,
// out written once: 7.5 us at 3.35 TB/s, and the chain's three buffers stay in
// the 50 MB L2): the tensor cores.  The design:
//
//  * one block per 128 x 256 output tile, partial tiles at the edges: at
//    n = 2048 that is 16 x 8 = 128 blocks, one wave on 132 SMs;
//  * two consumer warpgroups, each owning 64 rows and running wgmma m64n256k16
//    (128 f32 accumulators a thread), and one producer warp.  With 288
//    threads at one block an SM each thread may hold 224 registers, room for
//    128 accumulators, so no registers are moved between the roles;
//  * the K loop walks slices 64 deep (128 bytes of bf16, the swizzle width),
//    never split, so every output sums over K in one fixed order.  The
//    producer's one thread copies each slice of x (128 x 64, K-major) and of
//    a (64 x 256, read MN-major with the transpose flag, in column blocks of
//    64) by TMA with a 128-byte swizzle into a 4-stage ring (48 KiB a stage),
//    each stage completing on a "full" mbarrier and handed back by
//    each consumer warp on an "empty" one; one group of products stays in
//    flight while the previous slice's stage goes back;
//  * TMA fills zeros past the edges, so any M, N and K that are multiples of
//    8 are taken (rows 16-byte aligned): the zeros add nothing to the sums;
//  * the epilogue, in JAX's order: x scale on the f32 accumulators in
//    registers, then one round-to-nearest-even to bf16 (cvt.rn.bf16x2.f32).
//    A thread's accumulators hold two neighbouring columns in each group of
//    8, so the four threads sharing a row swap their pairs (a 4 x 4
//    transpose by shuffles) until each holds 8 whole columns, stored as one
//    16-byte write; rows and column groups past the edge are not stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;     // two consumer warpgroups of 64 rows
constexpr int BN = 256;
constexpr int BK = 64;      // K slice: 64 bf16 = one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int A_BYTES = BM * BK * 2;  // one stage of x
constexpr int B_BYTES = BK * BN * 2;  // one stage of a
constexpr int SMEM_BYTES = STAGES * (A_BYTES + B_BYTES) + 1024 + 64;

// (lo, hi) as two bf16, lo in the low half, each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The four threads of a row (lane % 4 = c) each hold word s[k] of column
// group k (columns 8k + 2c, 8k + 2c + 1) for k < 4: a 4 x 4 matrix, thread
// by word.  Transpose it, so that thread c holds the four words of group c,
// in column order: two exchanges, first with thread c ^ 2 (the pair of
// groups of the other half), then with thread c ^ 1.
__device__ __forceinline__ uint4 quad_transpose(uint32_t s0, uint32_t s1, uint32_t s2,
                                                uint32_t s3, int c) {
  const bool hi = c & 2, lo = c & 1;
  const uint32_t r0 = __shfl_xor_sync(FULL_MASK, hi ? s0 : s2, 2);
  const uint32_t r1 = __shfl_xor_sync(FULL_MASK, hi ? s1 : s3, 2);
  const uint32_t a0 = hi ? s2 : s0, a1 = hi ? s3 : s1;  // own words of groups 2hi, 2hi+1
  // Group c from this thread and from thread c ^ 2; group c ^ 1 goes to c ^ 1.
  const uint32_t keep_own = lo ? a1 : a0, keep_other = lo ? r1 : r0;
  const uint32_t g0 = __shfl_xor_sync(FULL_MASK, lo ? a0 : a1, 1);  // thread c ^ 1's
  const uint32_t g1 = __shfl_xor_sync(FULL_MASK, lo ? r0 : r1, 1);  // thread c ^ 3's
  const uint32_t e0 = lo ? g0 : keep_own, e1 = lo ? keep_own : g0;
  const uint32_t f0 = lo ? g1 : keep_other, f1 = lo ? keep_other : g1;
  return hi ? make_uint4(f0, f1, e0, e1) : make_uint4(e0, e1, f0, f1);
}

__global__ void __launch_bounds__(THREADS, 1)
burn_product_kernel(__grid_constant__ const CUtensorMap xmap,
                    __grid_constant__ const CUtensorMap amap, uint16_t* __restrict__ out,
                    int M, int N, int K, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = hopper::align_1024(smem_raw);  // STAGES x (BM x 64)
  uint8_t* sa = sx + STAGES * A_BYTES;         // STAGES x (64 x BN)
  uint64_t* full = reinterpret_cast<uint64_t*>(sa + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int slices = (K + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);  // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues every copy
    if (tid == CONSUMERS) {
      for (int i = 0; i < slices; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) hopper::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        // The whole boxes count, zeros past the edges included.
        hopper::mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
        hopper::tma_load_2d(sx + s * A_BYTES, &xmap, &full[s], i * BK, m0);
        // a in column blocks of 64: each k row of a block is one swizzled row.
        for (int cb = 0; cb < BN / 64; ++cb)
          hopper::tma_load_2d(sa + s * B_BYTES + cb * BK * 128, &amap, &full[s],
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
    const uint8_t* x_tile = sx + s * A_BYTES + wg * 64 * 128;
    const uint8_t* a_tile = sa + s * B_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // x K-major: a k16 step is 32 bytes along the 128-byte row.  a MN-major:
      // a k16 step is 16 rows; column blocks of 64 are BK rows apart.
      const uint64_t dx = hopper::make_desc(x_tile + kk * 32, 16, 1024, hopper::SWIZZLE_128B);
      const uint64_t da = hopper::make_desc(a_tile + kk * 16 * 128, BK * 128, 1024,
                                            hopper::SWIZZLE_128B);
      hopper::wgmma_ss<BN, 1>(acc, dx, da, 1);
    }
    hopper::wgmma_commit();
    // Keep this slice's products in flight; the previous slice's are done,
    // so its stage goes back to the producer, once for the warp.
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (i > 0 && lane == 0) hopper::mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // Epilogue.  acc[4j+e] is row 16*warp + lane/4 (+8 for e >= 2), column
  // 8j + 2*(lane%4) + e%2: per row half h, word j of this thread is
  // acc[4j+2h], acc[4j+2h+1] scaled and packed.  Four groups j at a time go
  // through the transpose, and thread c stores group 4t + c.
  const int c = lane % 4;
  const int row = m0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
#pragma unroll
    for (int t = 0; t < BN / 32; ++t) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * t + k;
        w[k] = pack_bf16x2(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
      }
      const uint4 v = quad_transpose(w[0], w[1], w[2], w[3], c);
      const int col = n0 + 8 * (4 * t + c);
      if (r < M && col < N)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * N + col) = v;
    }
  }
}

int launch(const void* x, const void* a, void* out, int M, int N, int K, float scale,
           cudaStream_t stream) {
  // The shared-memory size is set once a device, at the first launch (the
  // chain's warm-up, outside any graph capture).
  static bool attr_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[device]) {
    err = cudaFuncSetAttribute(burn_product_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[device] = true;
  }
  CUtensorMap xmap, amap;
  err = hopper::encode_tmap_bf16_2d(&xmap, x, K, M, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hopper::encode_tmap_bf16_2d(&amap, a, N, K, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  burn_product_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      xmap, amap, static_cast<uint16_t*>(out), M, N, K, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  The caller has checked: bf16 x (M,K), a (K,N) and out
// (M,N), all contiguous on one device, 16-byte aligned, out apart from x and
// a; M, N and K positive multiples of 8.  Launches on `stream` and returns
// cudaGetLastError() (or the error of encoding a tensor map).
extern "C" int tnc_burn_product(const void* x, const void* a, void* out, int M, int N, int K,
                                float scale, void* stream) {
  return launch(x, a, out, M, N, K, scale, static_cast<cudaStream_t>(stream));
}
