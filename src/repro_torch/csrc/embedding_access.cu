// Access-reduction modes of the fused ragged lookup: batch dedup, the
// sparse gather and the residency cache.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_multi.py:139
// (_ragged_kernel) in the branches that unique_cap > 0, step_kpath and
// cache/hidx arm:
//  * dedup (:190-236): each step gathers the unique rows of its window once
//    by a (U, block_r) one-hot GEMM (_rows_onehot, :200), cnt @ rows_u
//    scatters them back to batch rows, and spilled ids row-stream
//    (:232-236);
//  * sparse gather (_rows_sparse, :205-227, step_kpath == 1): the same
//    rows_u by direct row copies of the sorted in-window unique ids;
//  * residency cache (:244-273): hot lookups summed from the core's
//    resident (C, E) mini-table once per slot.
//
// What bounds it on this card: bytes.  The function needs the distinct rows
// the batch hits (once each), the ids, the cache and the (K, S, B, E) f32
// output; at batch 8192 and E = 16 the output dominates.  On the TPU the
// whole batch sat in VMEM beside one window, so "each unique row once" came
// with the one pass over the windows, and the MXU made a dense read of the
// window cheap.  Neither holds here: a CTA holds a few thousand (query,
// lane) pairs, and a window streamed whole costs its bytes whatever few ids
// fall in it.
//
// What the design does about it: with dedup, three kernels one after the
// other on the stream and no torch op between them: the dedup kernel
// (embedding_dedup.cu) gives uniq, rank and spill, then
//  1. gather_kernel, grid (unique-entry tiles, core x slot): the grid
//     follows the unique ids, not the schedule's steps.  Each warp finds
//     its slot's run by one vote over the run list; each unique entry u of the slot is read straight
//     from the buffer row its chunk-local id maps to (the step block of
//     id / block_r, row id % block_r) and written, converted to f32, into
//     rows_u (K, S, U, E): once per batch, a few MB that stay in L2.  A
//     group of E * sizeof(T) / 16 threads copies one row as 16-byte vectors
//     and writes float4s.  Padding (-1), ids past the slot's region and
//     slots without a run give zeros, so every rows_u entry is written.  The
//     schedule's per-step gather path does not change the read on this
//     card: the one-hot and sparse gathers are the same copy;
//  2. access_vec_kernel, grid (query tiles, core x slot): each warp looks
//     up its slot's run (a slot without one writes zeros, so the output
//     needs no zero fill), the CTA starts staging the core's cache in
//     shared memory and waits for it only before the first hot add, and a
//     group
//     of E * sizeof(T) / 16 threads owns a query, each thread one 16-byte
//     vector of T (4 f32 or 8 bf16/f16 lanes) of Q queries.  For each id j
//     the group reads the query's rank, spill id and cache position once
//     (one broadcast load each), then rows_u[rank] as float4s, or the
//     spilled buffer row as a 16-byte vector, then the hot row from shared
//     memory; the Q queries' loads are issued before their adds.  Each
//     output element is summed by one thread in a fixed order (the rank or
//     spill term, then the hot term, for each j, from 0.0 in f32) and
//     written once as float4s: no atomics, and at s = 1 bitwise equal to
//     the plain version.
// Rows that are not a whole number of 16-byte vectors, or data that is not
// 16-byte aligned, take scalar kernels with the same arithmetic: one
// thread per (entry, lane) in the gather, kPer (query, lane) pairs per
// thread in the scatter.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char rt_access_smem[];

namespace {

// The scatter pass's arguments (one struct keeps the two kernels' long
// parameter lists in step).
struct Access {
  const void* buffer;
  long core_stride;
  const int* lidx;
  const int* rank;
  const float* rows_u;
  const int* hidx;
  const void* cache;
  int cache_rows;
  const int* step_block;
  int n_steps;
  const int* runs;
  int n_runs;
  float* out;
  int n_slots, b, s, e, block_r, u_cap, stage_cache;
};

constexpr unsigned kFull = 0xffffffffu;

// The index into runs (n_runs, 5) of (core, slot) = cs, or -1 when the slot
// has no run.  Each warp scans 32 runs a round and votes, with no barrier;
// called by all 32 lanes of every warp.
__device__ __forceinline__ int find_run(const int* __restrict__ runs, int n_runs, int n_slots,
                                        long cs) {
  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < n_runs; r0 += 32) {
    const int r = r0 + lane;
    const bool hit = r < n_runs &&
                     static_cast<long>(__ldg(runs + 5 * r)) * n_slots + __ldg(runs + 5 * r + 1) == cs;
    const unsigned votes = __ballot_sync(kFull, hit);
    if (votes) return r0 + __ffs(votes) - 1;
  }
  return -1;
}

// The buffer row of chunk-local id l in a run of n steps whose step blocks
// start at blocks, or -1 for an id outside the run's region (and -1 padding).
__device__ __forceinline__ long window_row(int l, const int* __restrict__ blocks, int n,
                                           int block_r) {
  if (l < 0 || l >= static_cast<long>(n) * block_r) return -1;
  return static_cast<long>(__ldg(blocks + l / block_r)) * block_r + l % block_r;
}

// The core's hot rows: null without a cache; with stage_cache, the whole
// CTA issues their copy into shared memory (complete only after
// rt::stage_wait() and __syncthreads()); else where they lie (L2).
template <typename T>
__device__ __forceinline__ const T* hot_rows(const Access& a, int core) {
  if (a.cache == nullptr) return nullptr;
  const T* hot = static_cast<const T*>(a.cache) + static_cast<long>(core) * a.cache_rows * a.e;
  if (!a.stage_cache) return hot;
  T* staged = reinterpret_cast<T*>(rt_access_smem);
  rt::stage_async(staged, hot, static_cast<long>(a.cache_rows) * a.e * sizeof(T));
  return staged;
}

// kVec: one thread per 16-byte vector of a row (E * sizeof(T) % 16 == 0,
// 16-byte aligned data); else one thread per (entry, lane).
template <typename T, bool kVec>
__global__ void __launch_bounds__(rt::kThreads)
gather_kernel(const T* __restrict__ buffer, long core_stride, const int* __restrict__ uniq,
              const int* __restrict__ step_block, int n_steps, const int* __restrict__ runs,
              int n_runs, int n_slots, int u_cap, int e, int block_r, float* __restrict__ rows_u) {
  constexpr int kLanes = kVec ? 16 / sizeof(T) : 1;  // lanes a thread copies
  const long cs = blockIdx.y;
  const int run_of = find_run(runs, n_runs, n_slots, cs);
  const int units = e / kLanes;  // threads per row
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long>(u_cap) * units) return;
  const long u = t / units;
  const int lane0 = static_cast<int>(t - u * units) * kLanes;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (run_of >= 0) {
    const int* run = runs + 5 * run_of;
    const int core = run[0];
    const long row = window_row(__ldg(uniq + cs * u_cap + u),
                                step_block + static_cast<long>(core) * n_steps + run[2], run[3],
                                block_r);
    if (row >= 0) {
      const T* src = buffer + core * core_stride + row * e + lane0;
      if constexpr (kVec) {
        rt::vec16_to_f32<T>(__ldg(reinterpret_cast<const uint4*>(src)), v);
      } else {
        v[0] = rt::to_f32(src[0]);
      }
    }
  }
  float* dst = rows_u + (cs * u_cap + u) * e + lane0;
  if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < kLanes / 4; ++k)
      reinterpret_cast<float4*>(dst)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
    dst[0] = v[0];
  }
}

// A group of E / kLanes threads owns a query, each thread one 16-byte vector
// of T (kLanes lanes) of kQ queries, kQ * (kThreads / group) queries a CTA.
template <typename T, int kQ>
__global__ void __launch_bounds__(rt::kThreads, kQ >= 8 ? 2 : 4) access_vec_kernel(Access a) {
  constexpr int kLanes = 16 / sizeof(T);
  const int group = a.e / kLanes;
  const int per_pass = blockDim.x / group;  // queries a pass of the CTA covers
  const int qt = threadIdx.x / group;
  const int lane0 = (threadIdx.x - qt * group) * kLanes;
  const bool active = qt < per_pass;  // the last threads idle when group divides no kThreads
  const long cs = blockIdx.y;
  const long q0 = static_cast<long>(blockIdx.x) * per_pass * kQ + qt;
  float* out_slot = a.out + cs * a.b * a.e + lane0;
  const int run_of = find_run(a.runs, a.n_runs, a.n_slots, cs);
  float acc[kQ][kLanes];
#pragma unroll
  for (int i = 0; i < kQ; ++i)
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc[i][k] = 0.f;
  if (run_of >= 0) {  // a slot without a run pools nothing: zeros
    const int* run = a.runs + 5 * run_of;
    const int core = run[0], first = run[2], n = run[3];
    const T* cbuf = static_cast<const T*>(a.buffer) + core * a.core_stride + lane0;
    const int* blocks = a.step_block + static_cast<long>(core) * a.n_steps + first;
    const T* hot = hot_rows<T>(a, core);  // its copy overlaps the first id's loads
    const long ids0 = cs * a.b * a.s;
    const int* ids_slot = a.lidx + ids0;
    const int* rank_slot = a.rank == nullptr ? nullptr : a.rank + ids0;
    const int* hidx_slot = a.hidx == nullptr ? nullptr : a.hidx + ids0;
    const float* ru = a.rows_u == nullptr ? nullptr : a.rows_u + cs * a.u_cap * a.e + lane0;
    for (int j = 0; j < a.s; ++j) {
      int r[kQ], h[kQ], row[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) {  // the group's ids: one broadcast load each
        const long q = q0 + static_cast<long>(i) * per_pass;
        const bool live = active && q < a.b;
        const long pos = q * a.s + j;
        r[i] = live && rank_slot != nullptr ? __ldg(rank_slot + pos) : -1;
        h[i] = live && hidx_slot != nullptr ? __ldg(hidx_slot + pos) : -1;
        row[i] = live ? __ldg(ids_slot + pos) : -1;
      }
#pragma unroll
      for (int i = 0; i < kQ; ++i)  // buffer rows fit an int (T < 2^31)
        if (r[i] < 0) row[i] = static_cast<int>(window_row(row[i], blocks, n, a.block_r));
#pragma unroll
      for (int i = 0; i < kQ; ++i) {  // the rank or spill term
        if (r[i] >= 0) {
          const float4* src = reinterpret_cast<const float4*>(ru + static_cast<long>(r[i]) * a.e);
#pragma unroll
          for (int k = 0; k < kLanes / 4; ++k) {
            const float4 x = __ldg(src + k);
            acc[i][4 * k] += x.x;
            acc[i][4 * k + 1] += x.y;
            acc[i][4 * k + 2] += x.z;
            acc[i][4 * k + 3] += x.w;
          }
        } else if (row[i] >= 0) {
          float v[8];
          rt::vec16_to_f32<T>(
              __ldg(reinterpret_cast<const uint4*>(cbuf + static_cast<long>(row[i]) * a.e)), v);
#pragma unroll
          for (int k = 0; k < kLanes; ++k) acc[i][k] += v[k];
        }
      }
      if (hot != nullptr) {
        if (j == 0 && a.stage_cache) {  // the staged cache is complete
          rt::stage_wait();
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < kQ; ++i) {  // then the hot term
          if (h[i] >= 0 && h[i] < a.cache_rows) {
            float v[8];
            rt::vec16_to_f32<T>(
                *reinterpret_cast<const uint4*>(hot + static_cast<long>(h[i]) * a.e + lane0), v);
#pragma unroll
            for (int k = 0; k < kLanes; ++k) acc[i][k] += v[k];
          }
        }
      }
    }
    if (a.s == 0 && hot != nullptr && a.stage_cache) rt::stage_wait();  // no copy left in flight
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const long q = q0 + static_cast<long>(i) * per_pass;
    if (q < a.b) {
      float4* dst = reinterpret_cast<float4*>(out_slot + q * a.e);
#pragma unroll
      for (int k = 0; k < kLanes / 4; ++k)
        dst[k] = make_float4(acc[i][4 * k], acc[i][4 * k + 1], acc[i][4 * k + 2],
                             acc[i][4 * k + 3]);
    }
  }
}

// The scalar scatter: kPer (query, lane) pairs per thread, thread t holding
// pairs t, t + kThreads, ... of the slot's row-major (B, E) output.
template <typename T>
__global__ void __launch_bounds__(rt::kThreads) access_scalar_kernel(Access a) {
  const long cs = blockIdx.y;
  const int run_of = find_run(a.runs, a.n_runs, a.n_slots, cs);
  const long total = static_cast<long>(a.b) * a.e;
  const long pair0 = static_cast<long>(blockIdx.x) * rt::kPairs + threadIdx.x;
  float* out_slot = a.out + cs * total;
  if (run_of < 0) {  // a slot without a run pools nothing
#pragma unroll
    for (int k = 0; k < rt::kPer; ++k) {
      const long p = pair0 + static_cast<long>(k) * rt::kThreads;
      if (p < total) out_slot[p] = 0.f;
    }
    return;
  }
  const int* run = a.runs + 5 * run_of;
  const int core = run[0], first = run[2], n = run[3];
  const T* cbuf = static_cast<const T*>(a.buffer) + core * a.core_stride;
  const int* blocks = a.step_block + static_cast<long>(core) * a.n_steps + first;
  const T* hot = hot_rows<T>(a, core);
  if (hot != nullptr && a.stage_cache) {
    rt::stage_wait();
    __syncthreads();
  }
  const long ids0 = cs * a.b * a.s;
  const int* ids_slot = a.lidx + ids0;
  const int* rank_slot = a.rank == nullptr ? nullptr : a.rank + ids0;
  const int* hidx_slot = a.hidx == nullptr ? nullptr : a.hidx + ids0;
  const float* ru = a.rows_u == nullptr ? nullptr : a.rows_u + cs * a.u_cap * a.e;
#pragma unroll
  for (int k = 0; k < rt::kPer; ++k) {
    const long p = pair0 + static_cast<long>(k) * rt::kThreads;
    if (p < total) {
      const long q = p / a.e;
      const int lane = static_cast<int>(p - q * a.e);
      float acc = 0.f;
      for (int j = 0; j < a.s; ++j) {
        const long pos = q * a.s + j;
        const int r = rank_slot == nullptr ? -1 : __ldg(rank_slot + pos);
        if (r >= 0) {
          acc += __ldg(ru + static_cast<long>(r) * a.e + lane);
        } else {
          const long row = window_row(__ldg(ids_slot + pos), blocks, n, a.block_r);
          if (row >= 0) acc += rt::to_f32(cbuf[row * a.e + lane]);
        }
        if (hot != nullptr) {
          const int h = __ldg(hidx_slot + pos);
          if (h >= 0 && h < a.cache_rows) acc += rt::to_f32(hot[static_cast<long>(h) * a.e + lane]);
        }
      }
      out_slot[p] = acc;
    }
  }
}

// Raise a kernel's dynamic shared memory limit to smem when a launch needs
// more than the largest limit set so far (allowed, one per kernel).
template <typename K>
cudaError_t allow_smem(K* kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

template <typename T, int kQ>
int launch_access_vec(const Access& a, int k, size_t smem, cudaStream_t st) {
  const int group = a.e / (16 / static_cast<int>(sizeof(T)));
  const long per_cta = static_cast<long>(rt::kThreads / group) * kQ;
  const dim3 grid(static_cast<unsigned>((a.b + per_cta - 1) / per_cta),
                  static_cast<unsigned>(k * a.n_slots));
  static size_t allowed = 0;
  const cudaError_t err = allow_smem(access_vec_kernel<T, kQ>, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  access_vec_kernel<T, kQ><<<grid, rt::kThreads, smem, st>>>(a);
  return 0;
}

}  // namespace

// The unique-row gather.  buffer (K, >=T, E) with core stride core_stride
// elements; uniq (K, S, U) int32 chunk-local ids (-1 padding); step_block
// (K, n_steps) int32; runs (n_runs, 5) int32 as for
// rt_multi_embedding_bag_ragged; rows_u (K, S, U, E) f32, every entry
// written: the row of each id inside its slot's region, converted to f32,
// else zero.  vector != 0 copies 16-byte vectors (needs E * sizeof(T) % 16
// == 0 and 16-byte aligned buffer rows).  Grid (U-entry tiles, K * S), so
// K * S <= 65535.  Returns cudaGetLastError().
extern "C" int rt_ragged_gather(const void* buffer, long core_stride, const int* uniq,
                                const int* step_block, int n_steps, const int* runs, int n_runs,
                                int k, int n_slots, int u_cap, int e, int block_r, float* rows_u,
                                int vector, int dtype, void* stream) {
  if (k * n_slots == 0 || u_cap == 0 || e == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, {
    const int lanes = vector ? 16 / static_cast<int>(sizeof(T)) : 1;
    if (e % lanes) return static_cast<int>(cudaErrorInvalidValue);
    const long threads = static_cast<long>(u_cap) * (e / lanes);
    const dim3 grid(static_cast<unsigned>((threads + rt::kThreads - 1) / rt::kThreads),
                    static_cast<unsigned>(k * n_slots));
    if (vector) {
      gather_kernel<T, true><<<grid, rt::kThreads, 0, st>>>(
          static_cast<const T*>(buffer), core_stride, uniq, step_block, n_steps, runs, n_runs,
          n_slots, u_cap, e, block_r, rows_u);
    } else {
      gather_kernel<T, false><<<grid, rt::kThreads, 0, st>>>(
          static_cast<const T*>(buffer), core_stride, uniq, step_block, n_steps, runs, n_runs,
          n_slots, u_cap, e, block_r, rows_u);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

// The scatter pass.  lidx (K, S, B, s) int32: the spill under dedup, else
// the ids (-1 where hidx hits); rank (K, S, B, s) int32 and rows_u
// (K, S, U, E) f32, both null without dedup; hidx (K, S, B, s) int32 and
// cache (K, C, E), both null without the cache; runs (n_runs, 5) int32 as
// for rt_multi_embedding_bag_ragged; out (K, S, B, E) f32, every element
// written (slots without a run as zero); grid (batch tiles, K * S), so
// K * S <= 65535.  stage_cache != 0 stages each core's cache in shared
// memory.  queries = 1, 2, 4 or 8 runs the vector kernel with that many
// queries a thread (needs E * sizeof(T) % 16 == 0, E * sizeof(T) / 16 <=
// 256 and 16-byte aligned buffer rows, cache and rows_u); 0 the scalar one.
// Returns cudaGetLastError().
extern "C" int rt_ragged_access(const void* buffer, long core_stride, const int* lidx,
                                const int* rank, const float* rows_u, const int* hidx,
                                const void* cache, int cache_rows, const int* step_block,
                                int n_steps, const int* runs, int n_runs, float* out, int k,
                                int n_slots, int b, int s, int e, int block_r, int u_cap,
                                int stage_cache, int queries, int dtype, void* stream) {
  if (static_cast<long>(b) * e == 0 || k * n_slots == 0) return 0;
  const Access a{buffer, core_stride, lidx, rank, rows_u, hidx, cache, cache_rows, step_block,
                 n_steps, runs, n_runs, out, n_slots, b, s, e, block_r, u_cap, stage_cache};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, {
    const size_t smem =
        cache != nullptr && stage_cache ? static_cast<size_t>(cache_rows) * e * sizeof(T) : 0;
    int rc = 0;
    if (queries == 0) {
      const long total = static_cast<long>(b) * e;
      const dim3 grid(static_cast<unsigned>((total + rt::kPairs - 1) / rt::kPairs),
                      static_cast<unsigned>(k * n_slots));
      static size_t allowed = 0;
      const cudaError_t err = allow_smem(access_scalar_kernel<T>, smem, allowed);
      if (err != cudaSuccess) return static_cast<int>(err);
      access_scalar_kernel<T><<<grid, rt::kThreads, smem, st>>>(a);
    } else {
      const int lanes = 16 / static_cast<int>(sizeof(T));
      if (e % lanes || e / lanes > rt::kThreads) return static_cast<int>(cudaErrorInvalidValue);
      switch (queries) {
        case 1: rc = launch_access_vec<T, 1>(a, k, smem, st); break;
        case 2: rc = launch_access_vec<T, 2>(a, k, smem, st); break;
        case 4: rc = launch_access_vec<T, 4>(a, k, smem, st); break;
        case 8: rc = launch_access_vec<T, 8>(a, k, smem, st); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    if (rc) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}
