// Tiled bf16 matmul on the tensor cores, with a fused x scale epilogue.
//
// Replaces tpu_node_checker/ops/pallas_probe.py::_tiled_matmul (the Pallas
// kernel behind pallas_ok): C[M,N] = scale * (A[M,K] @ B[K,N]), bf16 inputs,
// f32 accumulation, f32 output.
//
// What bounds it on an H100: at the probe's 512^3 the work is 0.27 GFLOP
// (0.27 us at 989 TFLOP/s bf16) against 2 MiB of traffic (A, B read once,
// C written once: 0.63 us at 3.35 TB/s), so device memory bounds it and a
// single launch is far shorter than its own launch overhead.  The probe
// exists to prove that hand-written code reaches the matrix unit, so the
// design spends its effort there and keeps the rest plain:
//
//  * one block of 8 warps per 128x128 output tile (the TPU kernel's tile);
//  * the K loop stages 128x32 slices of A and 32x128 slices of B in shared
//    memory with 16-byte vector loads (a full-K panel, as the TPU kernel keeps
//    in VMEM, does not fit in shared memory at large K);
//  * each warp owns a 32x64 sub-tile: 2x4 wmma m16n16k16 bf16 fragments with
//    f32 accumulators (mma.sync on the tensor cores);
//  * the x scale epilogue runs on the accumulator fragments before the store,
//    in the same kernel, as the TPU kernel's VPU epilogue does.
//
// wgmma and TMA are left for a later change that makes this fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int TM = 128;
constexpr int TN = 128;
constexpr int TK = 32;
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int A_LD = TK + 8;  // row pad: keeps 16-byte rows and spreads banks
constexpr int B_LD = TN + 8;

__global__ void __launch_bounds__(THREADS)
tiled_matmul_kernel(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b,
                    float* __restrict__ c, int M, int N, int K, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sa[TM * A_LD];
  __shared__ __align__(16) __nv_bfloat16 sb[TK * B_LD];

  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // 0..3: rows wm*32 .. +32
  const int wn = warp % 2;  // 0..1: cols wn*64 .. +64

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += TK) {
    // A slice: 128 rows x 32 cols = 512 vectors of 8 bf16; two per thread.
#pragma unroll
    for (int v = tid; v < TM * TK / 8; v += THREADS) {
      const int r = v / (TK / 8);
      const int c8 = (v % (TK / 8)) * 8;
      *reinterpret_cast<uint4*>(&sa[r * A_LD + c8]) =
          *reinterpret_cast<const uint4*>(&a[(size_t)(m0 + r) * K + k0 + c8]);
    }
    // B slice: 32 rows x 128 cols = 512 vectors of 8 bf16; two per thread.
#pragma unroll
    for (int v = tid; v < TK * TN / 8; v += THREADS) {
      const int r = v / (TN / 8);
      const int c8 = (v % (TN / 8)) * 8;
      *reinterpret_cast<uint4*>(&sb[r * B_LD + c8]) =
          *reinterpret_cast<const uint4*>(&b[(size_t)(k0 + r) * N + n0 + c8]);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sa[(wm * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &sb[kk * B_LD + wn * 64 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: x scale on the accumulators, then straight to C.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < acc[i][j].num_elements; ++e) acc[i][j].x[e] *= scale;
      float* dst = c + (size_t)(m0 + wm * 32 + i * 16) * N + n0 + wn * 64 + j * 16;
      wmma::store_matrix_sync(dst, acc[i][j], N, wmma::mem_row_major);
    }
}

}  // namespace

// C entry for ctypes.  The caller has checked: bf16 A (M,K) and B (K,N), f32
// C (M,N), all contiguous on one device, 16-byte aligned, M and N multiples of
// 128, K a multiple of 32.  Launches on `stream` and returns cudaGetLastError().
extern "C" int tnc_tiled_matmul(const void* a, const void* b, void* c, int M, int N,
                                int K, float scale, void* stream) {
  dim3 grid(N / TN, M / TM);
  tiled_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(c), M, N, K, scale);
  return static_cast<int>(cudaGetLastError());
}
