// GM strategy: pooled lookup gathered row by row from device memory.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_gm.py
// (_gm_kernel / embedding_bag_gm), which ran a (query, lookup) grid whose
// BlockSpec DMA'd the one indexed row into VMEM per step and summed it into
// the query's resident output row.
//
// What bounds it on this card: bytes.  Each lookup reads one E-wide row
// (E * itemsize bytes, 64 B at E=16 f32) from HBM or L2, plus its 4-byte id,
// and the (B, E) f32 output is written once; there are B * s * E adds, far
// below any compute roof.
//
// What the design does about it: there is no on-chip staging to pay for.
// Each thread owns (query, lane) pairs, so the E threads of one query read
// one row as a contiguous, coalesced segment straight into f32 registers,
// and the sum over the query's ids runs in id order in that register.
// Rows are read once per lookup (no table sweep); ids are read through the
// read-only path.  Ids outside [0, m) contribute zero.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
gm_kernel(const T* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
          int m, int b, int s, int e) {
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
        if (r >= 0 && r < m) acc += rt::to_f32(table[static_cast<long>(r) * e + lane]);
      }
      out[p] = acc;
    }
  }
}

}  // namespace

// table (m, E), idx (B, s) int32 -> out (B, E) f32.  Returns cudaGetLastError().
extern "C" int rt_embedding_bag_gm(const void* table, const int* idx, float* out, int m, int b,
                                   int s, int e, int dtype, void* stream) {
  const long total = static_cast<long>(b) * e;
  if (total == 0) return 0;
  const unsigned grid = static_cast<unsigned>((total + rt::kPairs - 1) / rt::kPairs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, gm_kernel<T><<<grid, rt::kThreads, 0, st>>>(
                               static_cast<const T*>(table), idx, out, m, b, s, e));
  return static_cast<int>(cudaGetLastError());
}
