// The join of the plan cores' per-slot partials into the pooled tables.
//
// Replaces no Pallas kernel.  The JAX package joins the cores' partials
// with collectives (src/repro/core/partition.py::_sparse_rejoin: an
// all_to_all of each core's per-table partials to the table's owner, then
// an all_gather of the owners' buckets).  On one card the port reproduces
// that order of additions with core/partition.py::_scatter_slots (the
// (K, S, B, E) slot partials index_add_-ed into (K, N, B, E) per-table
// partials) and _sparse_rejoin (per sender, a gather of its rows of the
// tables each owner holds, mostly padding, index_add_-ed into the owners'
// buckets, then the buckets into the (N, B, E) output): at taobao's B =
// 262,144 about 2,100 planes of 16.8 MB, 36 GB a batch through the card's
// memory, where the join needs under 1 GB.  This kernel is that join in
// one pass, kept to the plain path's order so that it stays its bitwise
// twin.
//
// What bounds it on this card: bytes.  It must read each valid slot's
// (B, E) f32 plane once and write each table's plane once (taobao: 43
// planes in, 15 out, 16.8 MB each, 0.97 GB: 0.29 ms at 3.35 TB/s); it
// adds each plane once, far below any compute bound.
//
// What the design does about it: one thread per (table, 16-byte vector of
// the table's plane); neighbouring threads take neighbouring vectors (at
// E = 16, four threads a sample, neighbouring samples side by side), so
// every plane is read and written with coalesced float4 loads and stores,
// and each output element is written once, with no atomics and no shared
// memory.  The schedule, built at pack time
// (kernels/embedding_rejoin.py::rejoin_schedule), lists each table's terms
// in the order the plain path adds them: a term is a plane index times 4
// plus two flags, bit 0 where the term closes a sender's sum (one core's
// slots of the table, in slot order) and bit 1 where it closes an owner's
// (its senders, in core order); the owners follow in bucket row order.
// Three accumulators, each from 0.0f, add the terms in that order, as the
// plain path's three index_add_ stages do from their zero-filled outputs,
// so the result is bitwise the plain path's (-0.0 included: 0.0f + -0.0f
// is +0.0f).  A thread loads up to kUnroll terms' vectors before it adds
// them, so that the rock tables' eight terms are in flight together.  A
// table without terms is written as zeros.  Offsets are 64-bit: taobao's
// 48 slot planes hold 201 M floats and a larger batch passes 2^31.
// Planes that are no whole number of 16-byte vectors, or unaligned data,
// take the same kernel on single floats.
#include "common.cuh"

namespace {

constexpr int kUnroll = 4;

__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }
__device__ __forceinline__ void set_zero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <typename V>
__global__ void __launch_bounds__(rt::kThreads)
rejoin_kernel(const V* __restrict__ partials, const int* __restrict__ ptr,
              const int* __restrict__ terms, V* __restrict__ out, long plane) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const int table = blockIdx.y;
  const int first = __ldg(ptr + table), last = __ldg(ptr + table + 1);
  V sender, owner, sum;
  set_zero(sender);
  set_zero(owner);
  set_zero(sum);
  for (int j = first; j < last; j += kUnroll) {
    int term[kUnroll];
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u < last) {
        term[u] = __ldg(terms + j + u);
        v[u] = __ldg(partials + static_cast<long>(term[u] >> 2) * plane + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u < last) {
        add_to(sender, v[u]);
        if (term[u] & 1) {
          add_to(owner, sender);
          set_zero(sender);
        }
        if (term[u] & 2) {
          add_to(sum, owner);
          set_zero(owner);
        }
      }
    }
  }
  out[static_cast<long>(table) * plane + i] = sum;
}

template <typename V>
void launch(const float* partials, const int* ptr, const int* terms, float* out, int n_tables,
            long plane, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((plane + rt::kThreads - 1) / rt::kThreads),
                  static_cast<unsigned>(n_tables));
  rejoin_kernel<V><<<grid, rt::kThreads, 0, st>>>(reinterpret_cast<const V*>(partials), ptr,
                                                   terms, reinterpret_cast<V*>(out), plane);
}

}  // namespace

// partials (K * S, B, E) f32 slot planes of plane_elems = B * E floats
// each; ptr (n_tables + 1) and terms int32, the schedule (table t's terms
// are terms[ptr[t] .. ptr[t + 1])); out (n_tables, B, E) f32, every element
// written.  vector = 1 takes 16-byte vectors (needs plane_elems % 4 == 0
// and 16-byte aligned partials and out), 0 single floats.  n_tables <=
// 65535.  Returns the launch's CUDA error (0 on success).
extern "C" int rt_slot_rejoin(const float* partials, const int* ptr, const int* terms,
                              float* out, int n_tables, long plane_elems, int vector,
                              void* stream) {
  if (n_tables == 0 || plane_elems == 0) return 0;
  if (n_tables > 65535 || (vector && plane_elems % 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vector) {
    launch<float4>(partials, ptr, terms, out, n_tables, plane_elems / 4, st);
  } else {
    launch<float>(partials, ptr, terms, out, n_tables, plane_elems, st);
  }
  return static_cast<int>(cudaGetLastError());
}
