// Fused multi-slot pooled lookup over the dense stacked-slot layout.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_multi.py
// (_dense_kernel / multi_embedding_bag_dense).  There every slot's chunk is
// padded to the same R+1 rows (row R zero) and stacked (S, R+1, E); the
// grid (slot, batch tile) kept one slot's whole chunk resident in VMEM
// across its batch tiles, and each query summed its s pre-clipped rows in
// position order into an f32 accumulator.
//
// What bounds it on this card: bytes.  The function needs the distinct rows
// its ids hit, the (S, B, s) int32 ids and the (S, B, E) f32 output; there
// are B * s * E adds per slot.  The TPU's resident chunk does not carry
// over: a full-width taobao slot is 1,141,761 rows x 64 B = 73 MB, far past
// the 227 KB of shared memory a block can hold, and the rows a batch tile
// touches are scattered over all of it.
//
// What the design does about it: it is a gather from device memory (L2),
// not a staged window.  All K cores' slots run in one launch: grid.y is the
// (core, slot) pair, grid.x the batch tiles.  Each thread owns (query, lane)
// pairs of the row-major (B, E) output, so neighbouring threads read
// neighbouring lanes of one row (one 64 B row per query at E = 16 f32,
// coalesced), sums the query's s rows in position order from 0.0 in f32,
// and writes its element once: no atomics, no shared memory, and the same
// f32 additions as the plain version.  Every output element is written,
// empty slots' included (their ids point at the zero row).  Ids outside
// [0, R] contribute zero (the reference clamps them; callers pre-clip, so
// no served lookup has one).  Offsets are computed in 64 bits: a larger
// workload's stack passes 2^31 elements.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
dense_kernel(const T* __restrict__ chunks, long slot_stride, const int* __restrict__ lidx,
             float* __restrict__ out, int rows, int b, int s, int e) {
  const long slot = blockIdx.y;
  const T* chunk = chunks + slot * slot_stride;
  const long total = static_cast<long>(b) * e;
  const int* ids_slot = lidx + slot * b * s;
  float* out_slot = out + slot * total;
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
        if (l >= 0 && l < rows) acc += rt::to_f32(chunk[static_cast<long>(l) * e + lane]);
      }
      out_slot[p] = acc;
    }
  }
}

}  // namespace

// chunks (n_slots, rows, E) contiguous rows, slot stride slot_stride
// elements (n_slots = K * S); lidx (n_slots, B, s) int32; out (n_slots, B, E)
// f32, every element written.  Returns cudaGetLastError().
extern "C" int rt_multi_embedding_bag_dense(const void* chunks, long slot_stride,
                                            const int* lidx, float* out, int n_slots, int rows,
                                            int b, int s, int e, int dtype, void* stream) {
  const long total = static_cast<long>(b) * e;
  if (total == 0 || n_slots == 0) return 0;
  const dim3 grid(static_cast<unsigned>((total + rt::kPairs - 1) / rt::kPairs),
                  static_cast<unsigned>(n_slots));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, {
    dense_kernel<T><<<grid, rt::kThreads, 0, st>>>(static_cast<const T*>(chunks), slot_stride,
                                                   lidx, out, rows, b, s, e);
  });
  return static_cast<int>(cudaGetLastError());
}
