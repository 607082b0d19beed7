// Double-buffered bulk-copy stream: out = 2x + 1 over an f32 (rows, cols)
// array, moved through shared memory by Hopper's asynchronous copy engine.
//
// Replaces tpu_node_checker/ops/dma_probe.py::_dma_stream (the Pallas kernel
// behind dma_ok), which pulls chunk_rows-row chunks HBM->VMEM through a 2-slot
// ring with async copies and DMA semaphores, transforms each chunk, and
// copies it back out through a second 2-slot ring.
//
// What bounds it on an H100: bytes.  Each element is read once and written
// once, 8 bytes per element (16.8 MB at the probe's 4096x512: 5.0 us at
// 3.35 TB/s; the 8 MiB input also fits in the 50 MB L2).  The probe exists to
// test the copy engines, so the design keeps the TPU kernel's shape on them:
//
//  * loads are 1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx)
//    into a 2-stage shared ring, one mbarrier per slot: one thread arms the
//    barrier with the byte count, every thread waits on its phase parity.
//    Tile i+1's copy is issued before tile i is waited on, as in the TPU
//    kernel.  1-D bulk copies need no tensor map (no cuTensorMapEncode call);
//  * 2x+1 is written into a 2-stage out ring and stored back with
//    cp.async.bulk.global.shared::cta.bulk_group; a bulk_group commit/wait
//    gates reuse of an out slot until the store two tiles back has read it,
//    as the TPU kernel's copy-out wait does;
//  * a TPU chunk (256x512 f32 = 512 KiB) is far above the 227 KB of shared
//    memory a block can hold, so each chunk is cut into tiles of at most
//    TILE_ELEMS floats that never cross a chunk boundary;
//  * bulk copies need 16-byte alignment and sizes in multiples of 16 bytes,
//    so each tile's aligned middle goes through the copy engine and the
//    (at most 3 + 3) ragged elements at its ends go through plain loads;
//  * a grid of persistent blocks, at most one per SM, each walks its own
//    contiguous range of tiles: one block would test one SM's copy path.
//
// 2x is exact in f32, so an FMA contraction of 2x+1 rounds exactly as the
// reference's x*2+1 does and the result compares bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::bulk_commit;
using hopper::bulk_load;
using hopper::bulk_store;
using hopper::bulk_wait_all;
using hopper::bulk_wait_read;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;

constexpr int THREADS = 512;
constexpr int TILE_ELEMS = 8192;  // 32 KiB of f32 per ring slot
constexpr int SMEM_BYTES = 4 * TILE_ELEMS * 4;  // 2 in slots + 2 out slots

// Element range [t0, t1) of tile `t`, and its 16-byte-aligned middle [a0, a1).
struct Tile {
  long long t0, t1, a0, a1;
};

__device__ __forceinline__ Tile tile_range(long long t, long long tiles_per_chunk,
                                           long long chunk_elems) {
  const long long chunk = t / tiles_per_chunk;
  const long long j = t % tiles_per_chunk;
  Tile r;
  r.t0 = chunk * chunk_elems + j * TILE_ELEMS;
  r.t1 = min(r.t0 + TILE_ELEMS, (chunk + 1) * chunk_elems);
  // The base pointer is 16-byte aligned, so element e is iff e % 4 == 0.
  r.a0 = (r.t0 + 3) & ~3LL;
  r.a1 = r.t1 & ~3LL;
  if (r.a1 < r.a0) r.a1 = r.a0;
  return r;
}

__global__ void __launch_bounds__(THREADS)
dma_stream_kernel(const float* __restrict__ x, float* __restrict__ out, long long chunk_elems,
                  long long tiles_per_chunk, long long num_tiles) {
  extern __shared__ __align__(128) float ring[];
  float* in_ring = ring;                      // slots 0, 1
  float* out_ring = ring + 2 * TILE_ELEMS;    // slots 0, 1
  __shared__ __align__(8) uint64_t full[2];

  // This block's contiguous range of tiles.
  const long long first = num_tiles * blockIdx.x / gridDim.x;
  const long long last = num_tiles * (blockIdx.x + 1) / gridDim.x;
  const int n = static_cast<int>(last - first);
  if (n <= 0) return;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  auto issue_load = [&](int i) {
    const Tile tr = tile_range(first + i, tiles_per_chunk, chunk_elems);
    const uint32_t bytes = static_cast<uint32_t>((tr.a1 - tr.a0) * 4);
    uint64_t* bar = &full[i & 1];
    if (bytes) {
      mbar_arrive_expect_tx(bar, bytes);
      bulk_load(in_ring + (i & 1) * TILE_ELEMS, x + tr.a0, bytes, bar);
    } else {
      mbar_arrive(bar);  // a tile with no aligned middle still completes its phase
    }
  };

  if (tid == 0) issue_load(0);
  for (int i = 0; i < n; ++i) {
    const int slot = i & 1;
    // Start tile i+1's copy before waiting on tile i.  Its slot was last read
    // in iteration i-1, which every thread left through the barrier below.
    if (tid == 0 && i + 1 < n) issue_load(i + 1);
    mbar_wait(&full[slot], (i >> 1) & 1);
    // Out slot reuse: the store issued from this slot two tiles back must have
    // finished reading it; only the newest group may still be in flight.
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();

    const Tile tr = tile_range(first + i, tiles_per_chunk, chunk_elems);
    const int n4 = static_cast<int>((tr.a1 - tr.a0) / 4);
    const float4* src = reinterpret_cast<const float4*>(in_ring + slot * TILE_ELEMS);
    float4* dst = reinterpret_cast<float4*>(out_ring + slot * TILE_ELEMS);
    for (int k = tid; k < n4; k += THREADS) {
      float4 v = src[k];
      v.x = fmaf(v.x, 2.0f, 1.0f);
      v.y = fmaf(v.y, 2.0f, 1.0f);
      v.z = fmaf(v.z, 2.0f, 1.0f);
      v.w = fmaf(v.w, 2.0f, 1.0f);
      dst[k] = v;
    }
    // Ragged ends outside the aligned middle: plain global loads and stores.
    const int head = static_cast<int>(tr.a0 - tr.t0);
    const int tail = static_cast<int>(tr.t1 - tr.a1);
    if (tr.a1 == tr.a0) {
      // No aligned middle: the whole (short) tile is plain.
      for (long long e = tr.t0 + tid; e < tr.t1; e += THREADS) out[e] = fmaf(x[e], 2.0f, 1.0f);
    } else {
      if (tid < head) out[tr.t0 + tid] = fmaf(x[tr.t0 + tid], 2.0f, 1.0f);
      if (tid < tail) out[tr.a1 + tid] = fmaf(x[tr.a1 + tid], 2.0f, 1.0f);
    }
    // Make this thread's shared-memory writes visible to the copy engine,
    // then let one thread store the slot back.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      if (n4) bulk_store(out + tr.a0, dst, static_cast<uint32_t>(n4) * 16u);
      bulk_commit();
    }
  }
  // Drain the last stores before the block exits.
  if (tid == 0) bulk_wait_all();
}

}  // namespace

// C entry for ctypes.  The caller has checked: f32, contiguous, x and out on
// one device and 16-byte aligned, rows a positive multiple of chunk_rows.
// Launches at most `num_sms` persistent blocks on `stream` and returns
// cudaGetLastError().
extern "C" int tnc_dma_stream(const void* x, void* out, long long rows, long long cols,
                              long long chunk_rows, int num_sms, void* stream) {
  const long long chunk_elems = chunk_rows * cols;
  const long long tiles_per_chunk = (chunk_elems + TILE_ELEMS - 1) / TILE_ELEMS;
  const long long num_tiles = (rows / chunk_rows) * tiles_per_chunk;
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(dma_stream_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>(num_tiles < num_sms ? num_tiles : num_sms);
  dma_stream_kernel<<<blocks, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), chunk_elems, tiles_per_chunk,
      num_tiles);
  return static_cast<int>(cudaGetLastError());
}
