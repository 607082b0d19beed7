// Causal flash-attention forward over (B, H, S, D): a bf16 kernel on the
// tensor cores and an f32 kernel on the CUDA cores, one C entry for both.
//
// Replaces tpu_node_checker/ops/flash_attention.py::_flash_forward (the Pallas
// kernel behind flash_attention_ok): blockwise over query rows, a K/V loop
// that stops at the diagonal block, an online softmax with m, l and acc in
// f32, scale 1/sqrt(D), output acc/l in q's dtype.  The TPU kernel exists to
// put MXU products, VPU softmax arithmetic and VMEM staging on the chip; the
// bf16 kernel here puts the same work on wgmma, the SMs' f32 units and
// TMA-filled shared memory.
//
// What bounds it on an H100: at the probe's (1, 2, 256, 128) the function
// moves 512 KiB (0.16 us at 3.35 TB/s) and a launch is far longer than that;
// at (1, 16, 4096, 128) it needs 68.7 GFLOP for the causal half (0.069 ms at
// 989 TFLOP/s bf16), so the tensor cores bound it.
//
// bf16 (flash_forward_kernel), the path the probe runs:
//
//  * one block per (b, h, 64-row query tile): one consumer warpgroup (the
//    wgmma M of 64) and one producer warp.  The grid's query-tile index runs
//    backwards, so the longest rows of the causal triangle start first;
//  * the producer's one thread copies the Q tile once and then K and V tiles
//    of 64 rows into a 2-stage ring by TMA, each stage completing on a "full"
//    mbarrier and freed by the consumers on an "empty" one, so the next tile
//    is in flight while the warpgroup computes on this one.  Tiles land
//    swizzled (128 B rows, or 64 B at D = 32), as wgmma reads them;
//  * S = Q.K^T is wgmma m64n64k16 with both operands read from shared memory
//    (Q and K are K-major as stored), f32 accumulators;
//  * the online softmax runs on the accumulators in registers: scale by
//    log2(e)/sqrt(D), mask the diagonal tile only, row max and row sum over
//    the four threads that share a row, exp2;
//  * O += P.V is wgmma m64nDk16 with P as the register A operand: the f32
//    accumulator layout of the first product is the A layout of the second,
//    so P is packed to bf16 pairs in place.  V (kv, D) is MN-major for this
//    product and is read with the transpose flag;
//  * P is rounded to bf16 before P.V (the reference multiplies f32 P by f32
//    V); the row sum l uses the f32 P.  On random inputs this moves the
//    output by a few 1e-3 before its rounding to bf16 (tests/test_torch_ops.py
//    emulates it), within the probe's 2e-2.
//
// f32 (flash_forward_f32_kernel): the tensor cores would compute f32 as TF32,
// which misses the 1e-5 the f32 cases hold, so f32 stays on the CUDA cores:
// one block of 256 threads per 128-row query block, f32 tiles in shared
// memory, two threads per query row, both products as f32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;  // the reference's mask value

// ---------------------------------------------------------------- bf16, wgmma

constexpr int BM = 64;  // query rows per block: the wgmma M
constexpr int BN = 64;  // key rows per K/V tile (== BM: tile qt is the diagonal)
constexpr int STAGES = 2;
constexpr int CONSUMERS = 128;               // one warpgroup
constexpr int THREADS = CONSUMERS + 32;      // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int SW_ELEMS = D < 64 ? D : 64;  // elements in one swizzled row
  static constexpr int SW_BYTES = 2 * SW_ELEMS;     // 128 B, or 64 B at D = 32
  static constexpr uint64_t LAYOUT = SW_BYTES == 128 ? hopper::SWIZZLE_128B : hopper::SWIZZLE_64B;
  static constexpr int BLOCK_BYTES = 64 * SW_BYTES;  // 64 rows of one column block
  static constexpr int TILE_BYTES = 64 * D * 2;      // a 64-row tile of q, k or v
  static constexpr int SMEM_BYTES = (1 + 2 * STAGES) * TILE_BYTES + 1024 + 64;
};

// K-major descriptor for the k16 step `kk` of a 64 x D tile (Q or K).
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int kk) {
  using T = Tiles<D>;
  const int e = kk * 16;
  const uint8_t* p = tile + (e / T::SW_ELEMS) * T::BLOCK_BYTES + (e % T::SW_ELEMS) * 2;
  return hopper::make_desc(p, 16, 8 * T::SW_BYTES, T::LAYOUT);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_forward_kernel(__grid_constant__ const CUtensorMap qmap,
                     __grid_constant__ const CUtensorMap kmap,
                     __grid_constant__ const CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                     int S, float scale_log2) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = hopper::align_1024(smem_raw);
  uint8_t* sk = sq + T::TILE_BYTES;             // STAGES tiles
  uint8_t* sv = sk + STAGES * T::TILE_BYTES;    // STAGES tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * T::TILE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int row0 = blockIdx.x * S;             // this (b, h)'s first row in (B*H*S, D)
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest query tiles first
  const int q0 = qt * BM;
  const int n_tiles = qt + 1;                  // K/V tiles 0..qt; tile qt is the diagonal
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread issues every copy
    if (tid == CONSUMERS) {
      hopper::mbar_arrive_expect_tx(q_full, T::TILE_BYTES);
      for (int c = 0; c < D / T::SW_ELEMS; ++c)
        hopper::tma_load_2d(sq + c * T::BLOCK_BYTES, &qmap, q_full, c * T::SW_ELEMS, row0 + q0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) hopper::mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * T::TILE_BYTES);
        for (int c = 0; c < D / T::SW_ELEMS; ++c) {
          hopper::tma_load_2d(sk + s * T::TILE_BYTES + c * T::BLOCK_BYTES, &kmap, &full[s],
                              c * T::SW_ELEMS, row0 + j * BN);
          hopper::tma_load_2d(sv + s * T::TILE_BYTES + c * T::BLOCK_BYTES, &vmap, &full[s],
                              c * T::SW_ELEMS, row0 + j * BN);
        }
      }
    }
    return;
  }

  // The consumer warpgroup.  Thread t holds rows r and r + 8 of the tile.
  const int lane = tid % 32;
  const int r = (tid / 32) * 16 + lane / 4;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.0f, 0.0f};  // this thread's part of the row sums

  hopper::mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    hopper::mbar_wait(&full[s], (j / STAGES) & 1);
    const uint8_t* k_tile = sk + s * T::TILE_BYTES;
    const uint8_t* v_tile = sv + s * T::TILE_BYTES;

    // S = Q K^T, 64 x 64, f32.
    float sc[BN / 2];
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BN, 0>(sc, kmajor_desc<D>(sq, kk), kmajor_desc<D>(k_tile, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // Online softmax on the registers (base 2).  sc[4c+e] is row r + 8*(e/2),
    // key column 8c + 2*(lane%4) + e%2.
    const bool diagonal = j == n_tiles - 1;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (diagonal) {
        const int col = (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
        if (col > r + 8 * ((i / 2) % 2)) x = NEG;
      }
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
    uint32_t p[BN / 4];  // P in bf16 pairs: the A operand of P.V
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int h = (i / 2) % 2;
      const float p0 = exp2f(sc[i] - m[h]);
      const float p1 = exp2f(sc[i + 1] - m[h]);
      l[h] += p0 + p1;
      p[i / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];

    // O += P V.
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      const uint64_t desc_v = hopper::make_desc(v_tile + kk * 16 * T::SW_BYTES, T::BLOCK_BYTES,
                                                8 * T::SW_BYTES, T::LAYOUT);
      hopper::wgmma_rs<D, 1>(o, a, desc_v, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.0f / l[h];
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int h = (i / 2) % 2;
    const int col = (i / 4) * 8 + (lane % 4) * 2;
    __nv_bfloat16* dst = out + (size_t)(row0 + q0 + r + 8 * h) * D + col;
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(o[i] * inv[h], o[i + 1] * inv[h]);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int H, int S,
                float scale, cudaStream_t stream) {
  using T = Tiles<D>;
  const CUtensorMapSwizzle swizzle =
      T::SW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const uint64_t rows = (uint64_t)B * H * S;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = hopper::encode_tmap_bf16_2d(&maps[i], src[i], D, rows, T::SW_ELEMS, 64,
                                                  swizzle);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaFuncSetAttribute(flash_forward_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, S / BM);
  flash_forward_kernel<D><<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), S, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ f32, CUDA cores

constexpr int F32_BQ = 128;  // query rows per block (the TPU kernel's BLOCK)
constexpr int F32_BK = 64;   // key rows per shared-memory tile
constexpr int F32_THREADS = 256;

template <int D>
constexpr int f32_smem_floats() {
  return F32_BQ * (D + 1) + F32_BK * (D + 1) + F32_BK * D + F32_BQ * (F32_BK + 1);
}

// Row strides are padded by one float so the 16 rows a warp touches at once
// fall in distinct banks.
template <int D>
__global__ void __launch_bounds__(F32_THREADS)
flash_forward_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int H, int S,
                         float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // BQ x (D+1), pre-scaled
  float* ks = qs + F32_BQ * (D + 1);      // BK x (D+1)
  float* vs = ks + F32_BK * (D + 1);      // BK x D
  float* ps = vs + F32_BK * D;            // BQ x (BK+1), probabilities of this tile

  const int qi = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)S * D;
  const int q0 = qi * F32_BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 1;   // query row within the block
  const int hh = tid & 1;   // which half of the keys / of the columns

  for (int e = tid; e < F32_BQ * D; e += F32_THREADS) {
    const int row = e / D, col = e % D;
    qs[row * (D + 1) + col] = q[head + (size_t)(q0 + row) * D + col] * scale;
  }

  float m = NEG, l = 0.0f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  const int kv_end = q0 + F32_BQ;  // through the diagonal block
  for (int kv0 = 0; kv0 < kv_end; kv0 += F32_BK) {
    __syncthreads();  // the previous tile's ks/vs reads are done (and qs is written)
    for (int e = tid; e < F32_BK * D; e += F32_THREADS) {
      const int row = e / D, col = e % D;
      const size_t g = head + (size_t)(kv0 + row) * D + col;
      ks[row * (D + 1) + col] = k[g];
      vs[row * D + col] = v[g];
    }
    __syncthreads();

    // Scores for keys kv0 + 2*jj + hh.
    float s[F32_BK / 2];
#pragma unroll
    for (int jj = 0; jj < F32_BK / 2; ++jj) s[jj] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qd = qs[r * (D + 1) + d];
#pragma unroll
      for (int jj = 0; jj < F32_BK / 2; ++jj)
        s[jj] = fmaf(qd, ks[(2 * jj + hh) * (D + 1) + d], s[jj]);
    }
    if (kv0 + F32_BK > q0) {  // only a tile that reaches the diagonal is masked
#pragma unroll
      for (int jj = 0; jj < F32_BK / 2; ++jj)
        if (kv0 + 2 * jj + hh > q0 + r) s[jj] = NEG;
    }

    float tmax = NEG;
#pragma unroll
    for (int jj = 0; jj < F32_BK / 2; ++jj) tmax = fmaxf(tmax, s[jj]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < F32_BK / 2; ++jj) {
      const float p = expf(s[jj] - m_new);
      psum += p;
      ps[r * (F32_BK + 1) + 2 * jj + hh] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // both halves of this row's probabilities are in ps

#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr;
    for (int j = 0; j < F32_BK; ++j) {
      const float pj = ps[r * (F32_BK + 1) + j];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(pj, vs[j * D + hh + 2 * i], acc[i]);
    }
  }

  const float inv = 1.0f / l;
  float* o = out + head + (size_t)(q0 + r) * D;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[hh + 2 * i] = acc[i] * inv;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H, int S,
               float scale, cudaStream_t stream) {
  const int bytes = f32_smem_floats<D>() * 4;
  cudaError_t err = cudaFuncSetAttribute(flash_forward_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(S / F32_BQ, H, B);
  flash_forward_f32_kernel<D><<<grid, F32_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int S,
           int is_bf16, float scale, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(q, k, v, out, B, H, S, scale, stream)
                 : launch_f32<D>(q, k, v, out, B, H, S, scale, stream);
}

}  // namespace

// C entry for ctypes.  The caller has checked: q, k, v, out contiguous
// (B, H, S, D) of one dtype (is_bf16 = 1 for bf16, 0 for f32) on one device,
// 16-byte aligned, S a multiple of 128, D one of 32, 64, 128.  Launches on
// `stream` and returns cudaGetLastError() (or the error of encoding a tensor
// map).
extern "C" int tnc_flash_forward(const void* q, const void* k, const void* v, void* out, int B,
                                 int H, int S, int D, int is_bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, out, B, H, S, is_bf16, scale, st);
    case 64: return launch<64>(q, k, v, out, B, H, S, is_bf16, scale, st);
    case 128: return launch<128>(q, k, v, out, B, H, S, is_bf16, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
