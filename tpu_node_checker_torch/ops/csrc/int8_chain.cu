// The int8 chain on the tensor cores (wgmma s8), in one launch:
//
//   acc[M,N] = sum over i < iters of roll(a, i, dims=0) @ b      (int8 in, int32 sums)
//
// Replaces no Pallas kernel.  The JAX chain (tpu_node_checker/ops/int8_probe.py
// ::_int8_chain) is XLA's dot_general in a fori_loop, one compiled program; the
// port first ran it as 128 library products (torch._int_mm), each with a
// materialised roll and an int32 read-modify-write of the sum.  On an H100
// cuBLAS picks its sm_80 WMMA int8 kernel for that product, which never
// reaches Hopper's wgmma, and the chain ran at 45-55 TOPS.
//
// What bounds it on an H100: at the probe's 1024^3 x 128 the work is 275 GOP
// (0.139 ms at 1,979 TOPS int8, dense), against 3 MiB of operands read once and
// 4 MiB of sums written once (2 us at 3.35 TB/s): the tensor cores, if every
// product's operands come from on-chip memory.  The design:
//
//  * the roll is an address: the wrapper passes a2 = [a; a] (2M, K), and row r
//    of roll(a, i) is a2[M + r - (i mod M)], so iteration i's A tile of the
//    output rows r0 .. r0+BM is the TMA box at row M + r0 - (i mod M): one
//    contiguous box that never runs past row 2M - 1.  No rolled copy exists;
//  * wgmma takes 8-bit operands K-major only, so B comes as bt = b^T (N, K);
//  * one block per BM x BN output tile and group of iterations: the block's
//    int32 sums stay in registers over all its products, and no product's
//    result reaches device memory.  The loop runs over K slices 128 deep (one
//    128-byte swizzled row of int8), and inside each slice over the block's
//    iterations, so a slice of bt is copied once a slice and serves every
//    iteration (a 2-stage ring), while A streams through an 8-stage ring:
//    about a byte copied from L2 for every 2 x BN operations;
//  * one producer warp issues every copy; BM/64 consumer warpgroups run wgmma
//    m64nBNk32 from shared memory, one group of products in flight while the
//    previous one's stage is handed back;
//  * 1024^2 holds few tiles (64 of 128 x 128), so the iterations are split into
//    groups until tiles x groups fills the SMs (the wrapper's plan,
//    int8_probe.py int8_chain_plan); each block adds its tile into the zeroed
//    acc with red.global.add.s32.  Integer addition is exact and associative,
//    and |acc| <= iters * K * 64 stays in int32, so every order gives the same
//    bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 128;  // K slice: 128 int8 = one 128-byte swizzled row
constexpr int A_STAGES = 8;
constexpr int B_STAGES = 2;

template <int BM, int BN>
struct Ring {
  static constexpr int CONSUMERS = BM * 2;        // one warpgroup per 64 rows
  static constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
  static constexpr int A_BYTES = BM * BK;         // one stage of A
  static constexpr int B_BYTES = BN * BK;         // one stage of bt
  static constexpr int SMEM_BYTES =
      A_STAGES * A_BYTES + B_STAGES * B_BYTES + 1024 + 16 * (A_STAGES + B_STAGES);
};

template <int R>
__device__ __forceinline__ void fence_regs(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define TNC_D8(i)                                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define TNC_D64(i)                                                                        \
  TNC_D8(i), TNC_D8(i + 8), TNC_D8(i + 16), TNC_D8(i + 24), TNC_D8(i + 32), TNC_D8(i + 40), \
      TNC_D8(i + 48), TNC_D8(i + 56)

// d[64 x N] (+)= A[64 x 32] . B[32 x N]: int8 A and B in shared memory, both
// K-major, through descriptors; int32 accumulators; scale_d = 0 overwrites d.
// Each thread holds N/2 accumulators, laid out as wgmma_ss's f32 ones
// (hopper.cuh): d[4j+e] is row 16*warp + lane/4 (+8 for e >= 2), column
// 8j + 2*(lane%4) + e%2.
template <int N>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 128 || N == 256, "wgmma_s8: N is 128 or 256");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : TNC_D64(0)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
        "%125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : TNC_D64(0), TNC_D64(64)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

#undef TNC_D64
#undef TNC_D8

template <int BM, int BN>
__global__ void __launch_bounds__(Ring<BM, BN>::THREADS)
int8_chain_kernel(__grid_constant__ const CUtensorMap amap,
                  __grid_constant__ const CUtensorMap bmap, int32_t* __restrict__ acc, int M,
                  int N, int K, int iters, int groups) {
  using R = Ring<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = hopper::align_1024(smem_raw);  // A_STAGES x (BM x 128)
  uint8_t* sb = sa + A_STAGES * R::A_BYTES;    // B_STAGES x (BN x 128)
  uint64_t* a_full = reinterpret_cast<uint64_t*>(sb + B_STAGES * R::B_BYTES);
  uint64_t* a_empty = a_full + A_STAGES;
  uint64_t* b_full = a_empty + A_STAGES;
  uint64_t* b_empty = b_full + B_STAGES;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // This block's iterations: group g of `groups` takes i0 .. i1 - 1.
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.z) * iters / groups);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * iters / groups);
  const int slices = K / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      hopper::mbar_init(&a_full[s], 1);
      hopper::mbar_init(&a_empty[s], R::CONSUMERS);
    }
    for (int s = 0; s < B_STAGES; ++s) {
      hopper::mbar_init(&b_full[s], 1);
      hopper::mbar_init(&b_empty[s], R::CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // The tensor maps see an int8 row of K bytes as K/2 two-byte elements (the
  // copy moves bytes; the swizzle acts on bytes), so a K coordinate is halved.
  if (tid >= R::CONSUMERS) {  // the producer warp: one thread issues every copy
    if (tid == R::CONSUMERS) {
      int t = 0;  // products issued so far: A's stage and phase
      for (int s = 0; s < slices; ++s) {
        const int bs = s % B_STAGES;
        if (s >= B_STAGES) hopper::mbar_wait(&b_empty[bs], ((s / B_STAGES) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&b_full[bs], R::B_BYTES);
        hopper::tma_load_2d(sb + bs * R::B_BYTES, &bmap, &b_full[bs], s * BK / 2, n0);
        for (int i = i0; i < i1; ++i, ++t) {
          const int st = t % A_STAGES;
          if (t >= A_STAGES) hopper::mbar_wait(&a_empty[st], ((t / A_STAGES) - 1) & 1);
          hopper::mbar_arrive_expect_tx(&a_full[st], R::A_BYTES);
          hopper::tma_load_2d(sa + st * R::A_BYTES, &amap, &a_full[st], s * BK / 2,
                              M + m0 - i % M);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows wg*64 .. +64 of the tile.
  const int wg = tid / 128;
  const int lane = tid % 32;
  int32_t d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;

  int t = 0;
  for (int s = 0; s < slices; ++s) {
    const int bs = s % B_STAGES;
    hopper::mbar_wait(&b_full[bs], (s / B_STAGES) & 1);
    const uint8_t* b_tile = sb + bs * R::B_BYTES;
    for (int i = i0; i < i1; ++i, ++t) {
      const int st = t % A_STAGES;
      hopper::mbar_wait(&a_full[st], (t / A_STAGES) & 1);
      const uint8_t* a_tile = sa + st * R::A_BYTES + wg * 64 * BK;
      fence_regs(d);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        // Both K-major: a k32 step is 32 bytes along the 128-byte row; 8-row
        // groups are 1024 bytes apart.
        const uint64_t da = hopper::make_desc(a_tile + kk * 32, 16, 1024, hopper::SWIZZLE_128B);
        const uint64_t db = hopper::make_desc(b_tile + kk * 32, 16, 1024, hopper::SWIZZLE_128B);
        wgmma_s8<BN>(d, da, db, 1);
      }
      hopper::wgmma_commit();
      // Keep this product in flight; the previous one is done, so its A stage
      // (and, at a slice's first product, the last slice's bt stage) goes back.
      hopper::wgmma_wait<1>();
      fence_regs(d);
      if (t > 0) {
        hopper::mbar_arrive(&a_empty[(t - 1) % A_STAGES]);
        if (i == i0) hopper::mbar_arrive(&b_empty[(s - 1) % B_STAGES]);
      }
    }
  }
  hopper::wgmma_wait<0>();
  fence_regs(d);

  // The block's partial tile into the sums: d[4j+e] is row 16*warp + lane/4
  // (+8 for e >= 2), column 8j + 2*(lane%4) + e%2.
  const int row = m0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    int32_t* p = acc + static_cast<size_t>(row + 8 * ((i / 2) % 2)) * N + n0 + (i / 4) * 8 +
                 (lane % 4) * 2;
    atomicAdd(p, d[i]);
    atomicAdd(p + 1, d[i + 1]);
  }
}

template <int BM, int BN>
int launch(const void* a2, const void* bt, void* acc, int M, int N, int K, int iters, int groups,
           cudaStream_t stream) {
  using R = Ring<BM, BN>;
  // The shared-memory size is set once a device, at the first launch (the
  // probe's warm-up, outside any graph capture).
  static bool attr_set[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[device]) {
    err = cudaFuncSetAttribute(int8_chain_kernel<BM, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[device] = true;
  }
  CUtensorMap amap, bmap;
  err = hopper::encode_tmap_bf16_2d(&amap, a2, K / 2, 2 * static_cast<uint64_t>(M), BK / 2, BM,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hopper::encode_tmap_bf16_2d(&bmap, bt, K / 2, N, BK / 2, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / BN, M / BM, groups);
  int8_chain_kernel<BM, BN><<<grid, R::THREADS, R::SMEM_BYTES, stream>>>(
      amap, bmap, static_cast<int32_t*>(acc), M, N, K, iters, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  The caller has checked: int8 a2 = [a; a] (2M, K) and
// bt = b^T (N, K), int32 acc (M, N) zeroed, all contiguous on one device,
// 16-byte aligned; M, N and K multiples of 128; 1 <= groups <= iters; and
// picked the tile (bm, bn): 128 x 256 or 128 x 128.  Launches on `stream` and
// returns cudaGetLastError() (or the error of encoding a tensor map).
extern "C" int tnc_int8_chain(const void* a2, const void* bt, void* acc, int M, int N, int K,
                              int iters, int bm, int bn, int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups < 1 || groups > iters) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 128 && bn == 256) return launch<128, 256>(a2, bt, acc, M, N, K, iters, groups, st);
  if (bm == 128 && bn == 128) return launch<128, 128>(a2, bt, acc, M, N, K, iters, groups, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
