// Fused multi-slot pooled lookup over the dense stacked-slot layout.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_multi.py:506
// (_dense_kernel, pallas_call :548).  There every slot's chunk is padded to
// the same R+1 rows (row R zero) and stacked (S, R+1, E); the grid (slot,
// batch tile) kept one slot's whole chunk resident in VMEM across its batch
// tiles, and each query summed its s pre-clipped rows in position order
// into an f32 accumulator.
//
// What bounds it on this card: bytes, and before them latency.  The call
// must write the (K * S, B, E) f32 output and read the (K * S, B, s) int32
// ids and the distinct rows its ids hit; there are B * s * E adds per slot.
// The TPU's resident chunk does not carry over: a full-width taobao slot is
// 1,141,737 rows x 64 B = 73 MB, far past the 227 KB of shared memory a
// block can hold, and the rows a batch tile touches are scattered over all
// of it, so each lookup is an id load and then a dependent row load from
// HBM, and the card reaches its byte rate only with many in flight.
//
// What the design does about it: a gather from device memory, no shared
// memory.  All K cores' slots run in one launch: grid (query tiles, K * S).
// A group of E * sizeof(T) / 16 threads owns a query, each thread one
// 16-byte vector (4 f32 or 8 bf16/f16 lanes) of kQ queries
// (kernels/embedding_multi.py::_queries picks kQ so that the grid offers
// every SM 4 CTAs: 2 queries a thread in f32 at path E's B = 8192, 1,024
// CTAs); for each position j in order a thread issues its kQ rows' loads
// before their adds, and the next position's ids under them.
// Each output element is summed by one thread in position order from 0.0
// in f32 and written once as float4s: no atomics, the plain version's
// additions, and every output element written, empty slots' included
// (their ids point at the zero row).  Ids outside [0, R] contribute zero
// (the reference clamps them; callers pre-clip, so no served lookup has
// one).  Offsets are computed in 64 bits: path E's stack is 1.17 GB, and a
// larger workload's passes 2^31 elements.  Rows that are no whole number of
// 16-byte vectors, or unaligned data, take the scalar kernel: kPer (query,
// lane) pairs a thread, the same sums.
#include "common.cuh"

namespace {

template <typename T, int kQ>
__global__ void __launch_bounds__(rt::kThreads)
dense_vec_kernel(const T* __restrict__ chunks, long slot_stride, const int* __restrict__ lidx,
                 float* __restrict__ out, int rows, int b, int s, int e) {
  constexpr int kLanes = 16 / sizeof(T);
  const int group = e / kLanes;
  const int per_pass = blockDim.x / group;  // queries a pass of the CTA covers
  const int qt = threadIdx.x / group;
  const int lane0 = (threadIdx.x - qt * group) * kLanes;
  const bool active = qt < per_pass;  // the last threads idle when group divides no kThreads
  const long slot = blockIdx.y;
  const T* chunk = chunks + slot * slot_stride + lane0;
  const int* ids_slot = lidx + slot * b * s;
  const long q0 = static_cast<long>(blockIdx.x) * per_pass * kQ + qt;
  int l[kQ];
  rt::load_ids<kQ>(l, ids_slot, q0, per_pass, b, s, 0, active && s > 0);
  float acc[kQ][8] = {};
  for (int j = 0; j < s; ++j) {
    int row[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) row[i] = l[i] >= 0 && l[i] < rows ? l[i] : -1;
    if (j + 1 < s) rt::load_ids<kQ>(l, ids_slot, q0, per_pass, b, s, j + 1, active);
    rt::add_rows_vec16<T, kQ, true>(acc, chunk, row, e);
  }
  rt::store_rows<T, kQ>(out + slot * b * e + lane0, acc, q0, per_pass, b, e, active);
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
dense_scalar_kernel(const T* __restrict__ chunks, long slot_stride, const int* __restrict__ lidx,
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

template <typename T, int kQ>
void launch_vec(const T* chunks, long slot_stride, const int* lidx, float* out, int n_slots,
                int rows, int b, int s, int e, cudaStream_t st) {
  const int group = e / (16 / static_cast<int>(sizeof(T)));
  const long per_cta = static_cast<long>(rt::kThreads / group) * kQ;
  const dim3 grid(static_cast<unsigned>((b + per_cta - 1) / per_cta),
                  static_cast<unsigned>(n_slots));
  dense_vec_kernel<T, kQ><<<grid, rt::kThreads, 0, st>>>(chunks, slot_stride, lidx, out, rows,
                                                          b, s, e);
}

}  // namespace

// chunks (n_slots, rows, E) contiguous rows, slot stride slot_stride
// elements (n_slots = K * S <= 65535); lidx (n_slots, B, s) int32; out
// (n_slots, B, E) f32, every element written.  queries = 1, 2, 4 or 8 runs
// the vector kernel with that many queries a thread (needs E * sizeof(T) %
// 16 == 0, E * sizeof(T) / 16 <= 256 and 16-byte aligned chunks and slot
// stride); 0 the scalar one.  Returns the launch's CUDA error (0 on success).
extern "C" int rt_multi_embedding_bag_dense(const void* chunks, long slot_stride,
                                            const int* lidx, float* out, int n_slots, int rows,
                                            int b, int s, int e, int queries, int dtype,
                                            void* stream) {
  const long total = static_cast<long>(b) * e;
  if (total == 0 || n_slots == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, {
    const T* c = static_cast<const T*>(chunks);
    if (queries == 0) {
      const dim3 grid(static_cast<unsigned>((total + rt::kPairs - 1) / rt::kPairs),
                      static_cast<unsigned>(n_slots));
      dense_scalar_kernel<T><<<grid, rt::kThreads, 0, st>>>(c, slot_stride, lidx, out, rows, b,
                                                            s, e);
    } else {
      const int lanes = 16 / static_cast<int>(sizeof(T));
      if (e % lanes || e / lanes > rt::kThreads) return static_cast<int>(cudaErrorInvalidValue);
      switch (queries) {
        case 1: launch_vec<T, 1>(c, slot_stride, lidx, out, n_slots, rows, b, s, e, st); break;
        case 2: launch_vec<T, 2>(c, slot_stride, lidx, out, n_slots, rows, b, s, e, st); break;
        case 4: launch_vec<T, 4>(c, slot_stride, lidx, out, n_slots, rows, b, s, e, st); break;
        case 8: launch_vec<T, 8>(c, slot_stride, lidx, out, n_slots, rows, b, s, e, st); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  });
  return static_cast<int>(cudaGetLastError());
}
