// L1 strategy: pooled lookup served from a table held in shared memory.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_l1.py
// (_l1_kernel / embedding_bag_l1), which pinned the whole table in VMEM
// once and ran a sequential loop over each query's ids, reading rows by
// dynamic index from the resident copy.
//
// What bounds it on this card: bytes, and the size of on-chip memory.  The
// lookups themselves read B * s rows; a resident copy costs one table read
// per CTA.  A CTA can hold at most 227 KB of shared memory, while the
// planner (priced by a cost-model preset with a far larger on-chip budget)
// may send a table of any size here.
//
// What the design does about it: when the table fits the budget the wrapper
// passes (tile_rows >= m), every CTA stages the whole table into shared
// memory once with 16-byte cp.async copies and then serves each lookup by
// direct index from shared memory, in id order per (query, lane) pair.  A
// larger table is swept through shared memory tile_rows rows at a time
// (rt::sweep_tiles), each pair adding the ids that land in the current
// tile; nothing assumes the table is resident.  Ids outside [0, m)
// contribute zero on both paths.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char rt_smem[];

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
l1_resident_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                   float* __restrict__ out, int m, int b, int s, int e) {
  T* tab = reinterpret_cast<T*>(rt_smem);
  rt::stage_async(tab, table, static_cast<long>(m) * e * sizeof(T));
  rt::stage_wait();
  __syncthreads();
  const long total = static_cast<long>(b) * e;
  const long pair0 = static_cast<long>(blockIdx.x) * rt::kPairs + threadIdx.x;
#pragma unroll
  for (int k = 0; k < rt::kPer; ++k) {
    const long p = pair0 + static_cast<long>(k) * rt::kThreads;
    if (p < total) {
      const long q = p / e;
      const int lane = static_cast<int>(p - q * e);
      const int* ids = idx + q * s;
      float acc = 0.f;
      for (int j = 0; j < s; ++j) {
        const int r = __ldg(ids + j);
        if (r >= 0 && r < m) acc += rt::to_f32(tab[static_cast<long>(r) * e + lane]);
      }
      out[p] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
l1_tiled_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                float* __restrict__ out, int m, int b, int s, int e, int tile_rows) {
  const long total = static_cast<long>(b) * e;
  const long pair0 = static_cast<long>(blockIdx.x) * rt::kPairs + threadIdx.x;
  float acc[rt::kPer];
#pragma unroll
  for (int k = 0; k < rt::kPer; ++k) acc[k] = 0.f;
  rt::sweep_tiles(table, idx, reinterpret_cast<T*>(rt_smem), acc, pair0, total, s, e, 0, m,
                  tile_rows);
#pragma unroll
  for (int k = 0; k < rt::kPer; ++k) {
    const long p = pair0 + static_cast<long>(k) * rt::kThreads;
    if (p < total) out[p] = acc[k];
  }
}

template <typename T>
int launch(const T* table, const int* idx, float* out, int m, int b, int s, int e,
           int tile_rows, cudaStream_t st) {
  const long total = static_cast<long>(b) * e;
  const unsigned grid = static_cast<unsigned>((total + rt::kPairs - 1) / rt::kPairs);
  const bool resident = tile_rows >= m;
  const int rows = resident ? m : tile_rows;
  const size_t smem = static_cast<size_t>(rows) * e * sizeof(T);
  if (resident) {
    const cudaError_t err = cudaFuncSetAttribute(
        l1_resident_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    l1_resident_kernel<T><<<grid, rt::kThreads, smem, st>>>(table, idx, out, m, b, s, e);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        l1_tiled_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    l1_tiled_kernel<T><<<grid, rt::kThreads, smem, st>>>(table, idx, out, m, b, s, e, tile_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (m, E), idx (B, s) int32 -> out (B, E) f32.  tile_rows >= m selects
// the resident path; otherwise tile_rows (a multiple of 8) rows are staged at
// a time.  Returns cudaGetLastError().
extern "C" int rt_embedding_bag_l1(const void* table, const int* idx, float* out, int m, int b,
                                   int s, int e, int tile_rows, int dtype, void* stream) {
  if (static_cast<long>(b) * e == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, return launch<T>(static_cast<const T*>(table), idx, out, m, b, s, e,
                                            tile_rows, st));
  return 0;
}
