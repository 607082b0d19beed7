// Causal flash-attention forward over (B, H, S, D), f32 arithmetic throughout.
//
// Replaces tpu_node_checker/ops/flash_attention.py::_flash_forward (the Pallas
// kernel behind flash_attention_ok): one program per 128-row query block, a
// K/V loop that stops at the diagonal block, an online softmax with m, l and
// acc in f32, q and k/v upcast to f32 before both products, output acc/l in
// q's dtype.
//
// What bounds it on an H100: at the probe's (1, 2, 256, 128) bf16 the
// function moves 512 KiB (q, k, v read once, out written once: 0.16 us at
// 3.35 TB/s) and needs 34 MFLOP for the causal half, so a launch is far
// shorter than its own overhead.  The design keeps kernel and plain version
// close rather than fast:
//
//  * one block of 256 threads per (b, h, 128-row query block), grid
//    (S/128, H, B); the query block, pre-scaled by 1/sqrt(D), stays in
//    shared memory as f32 for the whole K/V loop;
//  * K/V tiles of 64 rows are staged in shared memory as f32, and the loop
//    runs to the end of the diagonal 128-row block only (the TPU kernel's
//    causal block skipping); only tiles that reach the diagonal are masked;
//  * two threads per query row: each computes half of the row's scores
//    (even / odd keys) and owns half of its D accumulators (interleaved
//    columns); the row max and row sum meet through one warp shuffle;
//  * both products run in f32 on the CUDA cores, as the reference does after
//    its upcast, so kernel and plain version differ only in summation order.
//    A bf16 tensor-core path is a later redesign.
//
// Shared memory: the f32 query block alone is 64 KiB at D = 128, so the
// kernel asks for dynamic shared memory above 48 KB with cudaFuncSetAttribute.
// Row strides are padded by one float so the 16 rows a warp touches at once
// fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;  // query rows per block (the TPU kernel's BLOCK)
constexpr int BK = 64;   // key rows per shared-memory tile
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;  // the reference's mask value

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int H, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // BQ x (D+1), pre-scaled
  float* ks = qs + BQ * (D + 1);      // BK x (D+1)
  float* vs = ks + BK * (D + 1);      // BK x D
  float* ps = vs + BK * D;            // BQ x (BK+1), probabilities of this tile

  const int qi = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)S * D;
  const int q0 = qi * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 1;   // query row within the block
  const int hh = tid & 1;   // which half of the keys / of the columns

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int row = e / D, col = e % D;
    qs[row * (D + 1) + col] = to_f32(q[head + (size_t)(q0 + row) * D + col]) * scale;
  }

  float m = NEG, l = 0.0f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  const int kv_end = q0 + BQ;  // through the diagonal block
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous tile's ks/vs reads are done (and qs is written)
    for (int e = tid; e < BK * D; e += THREADS) {
      const int row = e / D, col = e % D;
      const size_t g = head + (size_t)(kv0 + row) * D + col;
      ks[row * (D + 1) + col] = to_f32(k[g]);
      vs[row * D + col] = to_f32(v[g]);
    }
    __syncthreads();

    // Scores for keys kv0 + 2*jj + hh.
    float s[BK / 2];
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) s[jj] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * (D + 1) + d];
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj) s[jj] = fmaf(qd, ks[(2 * jj + hh) * (D + 1) + d], s[jj]);
    }
    if (kv0 + BK > q0) {  // only a tile that reaches the diagonal is masked
#pragma unroll
      for (int jj = 0; jj < BK / 2; ++jj)
        if (kv0 + 2 * jj + hh > q0 + r) s[jj] = NEG;
    }

    float tmax = NEG;
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) tmax = fmaxf(tmax, s[jj]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) {
      const float p = expf(s[jj] - m_new);
      psum += p;
      ps[r * (BK + 1) + 2 * jj + hh] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // both halves of this row's probabilities are in ps

#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr;
    for (int j = 0; j < BK; ++j) {
      const float pj = ps[r * (BK + 1) + j];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(pj, vs[j * D + hh + 2 * i], acc[i]);
    }
  }

  const float inv = 1.0f / l;
  T* o = out + head + (size_t)(q0 + r) * D;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) from_f32(o + hh + 2 * i, acc[i] * inv);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int S,
           float scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * 4;
  cudaError_t err = cudaFuncSetAttribute(flash_forward_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(S / BQ, H, B);
  flash_forward_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out, int B, int H, int S, int D,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, H, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, H, S, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, S, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry for ctypes.  The caller has checked: q, k, v, out contiguous
// (B, H, S, D) of one dtype (is_bf16 = 1 for bf16, 0 for f32) on one device,
// S a multiple of 128, D one of 32, 64, 128.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int tnc_flash_forward(const void* q, const void* k, const void* v, void* out, int B,
                                 int H, int S, int D, int is_bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_d<__nv_bfloat16>(q, k, v, out, B, H, S, D, scale, st);
  return dispatch_d<float>(q, k, v, out, B, H, S, D, scale, st);
}
