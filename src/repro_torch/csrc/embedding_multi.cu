// Fused multi-slot pooled lookup over the ragged packed buffer (base mode).
//
// Replaces the Pallas kernel src/repro/kernels/embedding_multi.py
// (_ragged_kernel / multi_embedding_bag_ragged) with unique_cap=0, no
// residency cache and no step_kpath.  On the TPU one core ran a sequential
// grid over its step schedule, the whole batch resident in VMEM, and each
// (block_r, E) window of its buffer was DMA'd once; UB-coded steps folded
// the s lookup positions into one one-hot count GEMM, GM/L1-coded steps
// pooled one position at a time.
//
// What bounds it on this card: bytes.  The function needs the rows its ids
// hit, the (S, B, s) ids and the (S, B, E) f32 output; there are B * s * E
// adds per slot.  The TPU's "every window once per core" order does not
// carry over: a CTA holds a few hundred (query, lane) pairs, not the whole
// batch, so streaming every window through every batch tile would re-read
// a 570,000-row chunk once per batch tile.
//
// What the design does about it: all K cores run in one launch.  The host
// collapses each core's schedule into runs (the consecutive steps of one
// slot; padding steps on the trash slot form no run), and the grid is
// (batch tile, run).  A run covers the slot's chunk-local rows
// [0, n_steps * block_r); id l lives in step first + l / block_r at row
// step_block * block_r + l % block_r of the core's buffer, and any other id
// (-1, out of window) contributes zero, as on the TPU.  The strategy code
// picks where rows come from, following the paper's strategies:
//  * L1 / L1-UB (codes 2, 3): when the slot's region fits the CTA's shared
//    memory, every window of the run is staged once with 16-byte cp.async
//    copies and lookups are served from shared memory;
//  * GM / GM-UB (codes 0, 1), and L1 regions too large to stage: each
//    lookup reads its row straight from device memory (L2), coalesced over
//    the E lanes.
// Either way each output element is summed by one thread over the query's
// ids in id order, in f32, and written once: no atomics, and the UB and
// row-at-a-time data flows of the TPU agree to f32 rounding.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char rt_smem[];

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
ragged_kernel(const T* __restrict__ buffer, long core_stride, const int* __restrict__ lidx,
              const int* __restrict__ step_block, int n_steps, const int* __restrict__ runs,
              float* __restrict__ out, int n_slots, int b, int s, int e, int block_r,
              int smem_rows) {
  const int* run = runs + 5 * blockIdx.y;
  const int core = run[0], slot = run[1], first = run[2], n = run[3], code = run[4];
  const long region = static_cast<long>(n) * block_r;
  const T* cbuf = buffer + core * core_stride;
  const int* blocks = step_block + static_cast<long>(core) * n_steps + first;
  const bool resident = (code == 2 || code == 3) && region <= smem_rows;
  T* win = reinterpret_cast<T*>(rt_smem);
  if (resident) {
    for (int i = 0; i < n; ++i) {
      rt::stage_async(win + static_cast<long>(i) * block_r * e,
                      cbuf + static_cast<long>(blocks[i]) * block_r * e,
                      static_cast<long>(block_r) * e * sizeof(T));
    }
    rt::stage_wait();
    __syncthreads();
  }
  const long total = static_cast<long>(b) * e;
  const long base = static_cast<long>(core) * n_slots + slot;
  const int* ids_slot = lidx + base * b * s;
  float* out_slot = out + base * total;
  const long pair0 = static_cast<long>(blockIdx.x) * rt::kPairs + threadIdx.x;
#pragma unroll
  for (int k = 0; k < rt::kPer; ++k) {
    const long p = pair0 + static_cast<long>(k) * rt::kThreads;
    if (p < total) {
      const long q = p / e;
      const int lane = static_cast<int>(p - q * e);
      const int* ids = ids_slot + q * s;
      float acc = 0.f;
      for (int j = 0; j < s; ++j) {
        const int l = __ldg(ids + j);
        if (l >= 0 && l < region) {
          if (resident) {
            acc += rt::to_f32(win[static_cast<long>(l) * e + lane]);
          } else {
            const long row = static_cast<long>(__ldg(blocks + l / block_r)) * block_r + l % block_r;
            acc += rt::to_f32(cbuf[row * e + lane]);
          }
        }
      }
      out_slot[p] = acc;
    }
  }
}

}  // namespace

// buffer (K, >=T, E) with core stride core_stride elements; lidx (K, S, B, s)
// int32; step_block (K, n_steps) int32; runs (n_runs, 5) int32 rows of
// (core, slot, first_step, n_steps, strategy code); out (K, S, B, E) f32,
// zero-filled by the caller (slots without a run stay zero).  smem_rows is
// the shared-memory window capacity in rows (0 = never stage).
// Returns cudaGetLastError().
extern "C" int rt_multi_embedding_bag_ragged(const void* buffer, long core_stride,
                                             const int* lidx, const int* step_block, int n_steps,
                                             const int* runs, int n_runs, float* out,
                                             int n_slots, int b, int s, int e, int block_r,
                                             int smem_rows, int dtype, void* stream) {
  const long total = static_cast<long>(b) * e;
  if (total == 0 || n_runs == 0) return 0;
  const dim3 grid(static_cast<unsigned>((total + rt::kPairs - 1) / rt::kPairs),
                  static_cast<unsigned>(n_runs));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, {
    const size_t smem = static_cast<size_t>(smem_rows) * e * sizeof(T);
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ragged_kernel<T><<<grid, rt::kThreads, smem, st>>>(
        static_cast<const T*>(buffer), core_stride, lidx, step_block, n_steps, runs, out,
        n_slots, b, s, e, block_r, smem_rows);
  });
  return static_cast<int>(cudaGetLastError());
}
