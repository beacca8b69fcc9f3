// GM strategy: pooled lookup gathered row by row from device memory.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_gm.py:27
// (_gm_kernel / embedding_bag_gm), which ran a (query, lookup) grid whose
// BlockSpec DMA'd the one indexed row into VMEM per step (double-buffered
// by the pipeline) and summed it into the query's resident output row.
//
// What bounds it on this card: the latency of scattered row reads, not
// bytes.  Each lookup reads one E-wide row (64 B at E = 16 f32) at a random
// place of a table far larger than L2 (73 MB for taobao's table 0), plus
// its 4-byte id; the (B, E) f32 output is written once.  At B = 8192 that
// is 0.5 MB of rows, 0.0003 ms at 3.35 TB/s, so what sets the time is how
// many row reads are in flight at once across the card.  TMA has no gather
// of scattered 64-byte rows, and a row is below what a bulk copy pays for,
// so there is no shared-memory staging.
//
// What the design does about it: one thread per (query, 16-byte lane
// vector), 4 threads per 64-byte f32 row (2 for bf16/f16), each reading its
// vector of every row with one 16-byte read-only load (ld.global.nc.v4);
// the grid covers all B * E / vec threads at once (128 CTAs of 256 at
// taobao's shapes, 8 warps an SM) with no loop per thread.  The threads of
// one query form a group of lanes inside a warp: lane g of the group loads
// the query's ids g, g + group, ... once (coalesced) and the group shares
// them by warp shuffles.  For s > 1 the id loop is unrolled by 4, so four
// independent row loads are in flight before the first add, and the adds
// stay in id order from 0.0 in f32 (s = 1 is a row copy, bitwise equal to
// the plain version).  Rows that are not a multiple of 16 bytes, a table
// that is not 16-byte aligned, or a row of more than 32 vectors take a
// scalar path: one thread per (query, lane), the same unrolled id loop.
// Ids outside [0, m) add nothing.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // row loads in flight per thread

// kGroup threads (a power of two <= 32) own the kGroup 16-byte vectors of
// one query's output row; thread t of the grid owns vector t % kGroup of
// query t / kGroup.
template <typename T, int kGroup>
__global__ void __launch_bounds__(rt::kThreads)
gm_vec_kernel(const T* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
              int m, int b, int s, int e) {
  constexpr int kLanes = 16 / sizeof(T);
  constexpr int kRound = kGroup > kUnroll ? kGroup : kUnroll;  // ids a group reads at once
  constexpr int kPerLane = kRound / kGroup;
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int g = static_cast<int>(threadIdx.x % kGroup);
  const long q_raw = t / kGroup;
  const bool live = q_raw < b;
  const long q = live ? q_raw : b - 1;  // the warp's shuffles need every lane
  const int* ids = idx + q * s;
  const uint4* rows = reinterpret_cast<const uint4*>(table) + g;
  const long stride = static_cast<long>(e) / kLanes;  // 16-byte vectors per row
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < s; j0 += kRound) {
    int mine[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = j0 + g + k * kGroup;
      mine[k] = j < s ? __ldg(ids + j) : -1;
    }
#pragma unroll
    for (int u0 = 0; u0 < kRound; u0 += kUnroll) {
      if (j0 + u0 >= s) break;  // the same for every lane of the warp
      uint4 x[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int u = u0 + k;
        const int r = __shfl_sync(kFull, mine[u / kGroup], u % kGroup, kGroup);
        ok[k] = r >= 0 && r < m;
        if (ok[k]) x[k] = __ldg(rows + static_cast<long>(r) * stride);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (ok[k]) rt::add_vec16<T>(acc, x[k]);
    }
  }
  if (live) {
    float4* o = reinterpret_cast<float4*>(out + q * e + g * kLanes);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if constexpr (kLanes == 8) o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
gm_scalar_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                 float* __restrict__ out, int m, int b, int s, int e) {
  const long p = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<long>(b) * e) return;
  const long q = p / e;
  const int lane = static_cast<int>(p - q * e);
  const int* ids = idx + q * s;
  float acc = 0.f;
  for (int j0 = 0; j0 < s; j0 += kUnroll) {
    float x[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int r = j0 + k < s ? __ldg(ids + j0 + k) : -1;
      ok[k] = r >= 0 && r < m;
      if (ok[k]) x[k] = rt::to_f32(table[static_cast<long>(r) * e + lane]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (ok[k]) acc += x[k];
  }
  out[p] = acc;
}

template <typename T>
int launch(const T* table, const int* idx, float* out, int m, int b, int s, int e,
           cudaStream_t st) {
  const long row_bytes = static_cast<long>(e) * sizeof(T);
  const int group = static_cast<int>(row_bytes / 16);
  const bool vec = row_bytes % 16 == 0 && group <= 32 && (32 % group) == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0;
  const long threads = static_cast<long>(b) * (vec ? group : e);
  const unsigned grid = static_cast<unsigned>((threads + rt::kThreads - 1) / rt::kThreads);
#define RT_GM_VEC(G) \
  case G:            \
    gm_vec_kernel<T, G><<<grid, rt::kThreads, 0, st>>>(table, idx, out, m, b, s, e); break;
  if (vec) {
    switch (group) {
      RT_GM_VEC(1)
      RT_GM_VEC(2)
      RT_GM_VEC(4)
      RT_GM_VEC(8)
      RT_GM_VEC(16)
      RT_GM_VEC(32)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    gm_scalar_kernel<T><<<grid, rt::kThreads, 0, st>>>(table, idx, out, m, b, s, e);
  }
#undef RT_GM_VEC
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (m, E), idx (B, s) int32 -> out (B, E) f32.  Returns cudaGetLastError().
extern "C" int rt_embedding_bag_gm(const void* table, const int* idx, float* out, int m, int b,
                                   int s, int e, int dtype, void* stream) {
  if (static_cast<long>(b) * e == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, return launch<T>(static_cast<const T*>(table), idx, out, m, b, s, e,
                                            st));
  return 0;
}
