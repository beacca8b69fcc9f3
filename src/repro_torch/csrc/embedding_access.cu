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
// with the one pass over the windows.  A CTA here holds a few thousand
// (query, lane) pairs, so gathering inside the per-batch-tile pass would
// read every unique row once per batch tile.
//
// What the design does about it: with dedup, three kernels one after the
// other on the stream and no torch op between them: the dedup kernel
// (embedding_dedup.cu) gives uniq, rank and spill, then
//  1. dedup_gather_kernel, grid (step, core): each real step finds the
//     range of its slot's sorted unique ids that fall in its window (binary
//     search) and writes those rows, converted to f32, into rows_u
//     (K, S, U, E): once per batch, a few MB that stay in L2.  The step's
//     gather path picks the data flow.  One-hot (0) streams the whole
//     window through shared memory with 16-byte cp.async, whatever the
//     ids, and copies the unique rows out of it, as the MXU GEMM read the
//     whole window.  Sparse (1) copies each unique row straight from device
//     memory.  Both copy the same elements through the same conversion, so
//     rows_u, and the output, are bitwise equal either way.  A slot's last
//     step zeroes the entries past its window (padding, ids past the
//     region), so rows_u needs no zero fill of its own;
//  2. access_kernel, grid (batch tile, core x slot): each CTA looks up its
//     slot's run (a slot without one writes zeros, so the output needs no
//     zero fill either), and each (query, lane) sums, in id
//     order, rows_u[rank] for a deduplicated lookup, else the buffer row of
//     a spilled id (of every id without dedup), and cache[hidx] for a hot
//     lookup, the cache staged in shared memory.  One thread sums each
//     output element in a fixed order and writes it once: no atomics.  The
//     reference's per-step flags only skip loops that add zeros, so they
//     are not needed.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char rt_access_smem[];

namespace {

// First position in the ascending ids of uniq[0, n) (-1 padding at the end
// counts as +inf) whose id is >= v.
__device__ __forceinline__ int lower_bound(const int* __restrict__ uniq, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int x = uniq[mid];
    if (x >= 0 && x < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
dedup_gather_kernel(const T* __restrict__ buffer, long core_stride, const int* __restrict__ uniq,
                    const int* __restrict__ step_slot, const int* __restrict__ step_base,
                    const int* __restrict__ step_block, const int* __restrict__ step_kpath,
                    int n_steps, int n_slots, int u_cap, int e, int block_r, int stage_rows,
                    float* __restrict__ rows_u) {
  const int core = blockIdx.y;
  const long t = static_cast<long>(core) * n_steps + blockIdx.x;
  const int slot = step_slot[t];
  if (slot >= n_slots) return;  // schedule padding on the trash slot
  const int base = step_base[t];
  const long cs = static_cast<long>(core) * n_slots + slot;
  const int* ids = uniq + cs * u_cap;
  float* dst = rows_u + cs * u_cap * e;
  __shared__ int range[2];
  if (threadIdx.x == 0) {
    range[0] = lower_bound(ids, u_cap, base);
    range[1] = lower_bound(ids, u_cap, base + block_r);
  }
  __syncthreads();
  const int lo = range[0];
  const long pairs = static_cast<long>(range[1] - lo) * e;
  // the slot's last step also zeroes the entries past its window: ids past
  // the slot's region and the -1 padding, so every rows_u entry is written
  const bool last = blockIdx.x + 1 == n_steps || step_slot[t + 1] != slot;
  if (last) {
    for (long p = static_cast<long>(range[1]) * e + threadIdx.x; p < static_cast<long>(u_cap) * e;
         p += blockDim.x)
      dst[p] = 0.f;
  }
  const T* window = buffer + core * core_stride + static_cast<long>(step_block[t]) * block_r * e;
  const bool onehot = step_kpath == nullptr || step_kpath[t] == 0;
  if (onehot) {
    T* tile = reinterpret_cast<T*>(rt_access_smem);
    for (int r0 = 0; r0 < block_r; r0 += stage_rows) {
      const int rows = min(stage_rows, block_r - r0);
      __syncthreads();  // the previous tile is no longer read
      rt::stage_async(tile, window + static_cast<long>(r0) * e,
                      static_cast<long>(rows) * e * sizeof(T));
      rt::stage_wait();
      __syncthreads();
      for (long p = threadIdx.x; p < pairs; p += blockDim.x) {
        const long u = lo + p / e;
        const int lane = static_cast<int>(p % e);
        const int r = ids[u] - base - r0;
        if (r >= 0 && r < rows) dst[u * e + lane] = rt::to_f32(tile[static_cast<long>(r) * e + lane]);
      }
    }
  } else {
    for (long p = threadIdx.x; p < pairs; p += blockDim.x) {
      const long u = lo + p / e;
      const int lane = static_cast<int>(p % e);
      const long r = ids[u] - base;
      dst[u * e + lane] = rt::to_f32(window[r * e + lane]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
access_kernel(const T* __restrict__ buffer, long core_stride, const int* __restrict__ lidx,
              const int* __restrict__ rank, const float* __restrict__ rows_u,
              const int* __restrict__ hidx, const T* __restrict__ cache, int cache_rows,
              const int* __restrict__ step_block, int n_steps, const int* __restrict__ runs,
              int n_runs, float* __restrict__ out, int n_slots, int b, int s, int e, int block_r, int u_cap,
              int stage_cache) {
  // this CTA's (core, slot) and its run, if it has one
  __shared__ int run_of;
  if (threadIdx.x == 0) run_of = -1;
  __syncthreads();
  for (int r = threadIdx.x; r < n_runs; r += blockDim.x)
    if (runs[5 * r] * n_slots + runs[5 * r + 1] == static_cast<int>(blockIdx.y)) run_of = r;
  __syncthreads();
  const long total = static_cast<long>(b) * e;
  const long pair0 = static_cast<long>(blockIdx.x) * rt::kPairs + threadIdx.x;
  if (run_of < 0) {  // a slot without a run pools nothing
    float* out_slot = out + static_cast<long>(blockIdx.y) * total;
#pragma unroll
    for (int k = 0; k < rt::kPer; ++k) {
      const long p = pair0 + static_cast<long>(k) * rt::kThreads;
      if (p < total) out_slot[p] = 0.f;
    }
    return;
  }
  const int* run = runs + 5 * run_of;
  const int core = run[0], slot = run[1], first = run[2], n = run[3];
  const long region = static_cast<long>(n) * block_r;
  const T* cbuf = buffer + core * core_stride;
  const int* blocks = step_block + static_cast<long>(core) * n_steps + first;
  const T* hot = cache == nullptr ? nullptr : cache + static_cast<long>(core) * cache_rows * e;
  if (hot != nullptr && stage_cache) {
    T* staged = reinterpret_cast<T*>(rt_access_smem);
    rt::stage_async(staged, hot, static_cast<long>(cache_rows) * e * sizeof(T));
    rt::stage_wait();
    __syncthreads();
    hot = staged;
  }
  const long cs = static_cast<long>(core) * n_slots + slot;
  const int* ids_slot = lidx + cs * b * s;
  const int* rank_slot = rank == nullptr ? nullptr : rank + cs * b * s;
  const int* hidx_slot = hidx == nullptr ? nullptr : hidx + cs * b * s;
  const float* ru = rows_u == nullptr ? nullptr : rows_u + cs * u_cap * e;
  float* out_slot = out + cs * total;
#pragma unroll
  for (int k = 0; k < rt::kPer; ++k) {
    const long p = pair0 + static_cast<long>(k) * rt::kThreads;
    if (p < total) {
      const long q = p / e;
      const int lane = static_cast<int>(p - q * e);
      float acc = 0.f;
      for (int j = 0; j < s; ++j) {
        const long pos = q * s + j;
        const int r = rank_slot == nullptr ? -1 : __ldg(rank_slot + pos);
        if (r >= 0) {
          acc += __ldg(ru + static_cast<long>(r) * e + lane);
        } else {
          const int l = __ldg(ids_slot + pos);
          if (l >= 0 && l < region) {
            const long row = static_cast<long>(__ldg(blocks + l / block_r)) * block_r + l % block_r;
            acc += rt::to_f32(cbuf[row * e + lane]);
          }
        }
        if (hidx_slot != nullptr) {
          const int h = __ldg(hidx_slot + pos);
          if (h >= 0 && h < cache_rows) acc += rt::to_f32(hot[static_cast<long>(h) * e + lane]);
        }
      }
      out_slot[p] = acc;
    }
  }
}

}  // namespace

// The dedup gather.  buffer (K, >=T, E) with core stride core_stride
// elements; uniq (K, S, U) int32, each (core, slot)'s unique chunk-local ids
// ascending, -1 padding last; step_slot/step_base/step_block/step_kpath
// (K, n_steps) int32 (step_kpath may be null: every step one-hot); rows_u
// (K, S, U, E) f32: every entry of a slot with steps is written, those past
// the slot's last window (padding included) as zero.
// stage_rows is the one-hot tile in rows (<= block_r).
// Returns cudaGetLastError().
extern "C" int rt_ragged_dedup_gather(const void* buffer, long core_stride, const int* uniq,
                                      const int* step_slot, const int* step_base,
                                      const int* step_block, const int* step_kpath, int n_steps,
                                      int k, int n_slots, int u_cap, int e, int block_r,
                                      int stage_rows, float* rows_u, int dtype, void* stream) {
  if (n_steps == 0 || k == 0 || u_cap == 0) return 0;
  if (stage_rows <= 0 || stage_rows > block_r) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_steps), static_cast<unsigned>(k));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, {
    const size_t smem = static_cast<size_t>(stage_rows) * e * sizeof(T);
    static size_t allowed = 0;  // the largest dynamic shared memory set so far
    if (smem > allowed) {
      const cudaError_t err = cudaFuncSetAttribute(
          dedup_gather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
    dedup_gather_kernel<T><<<grid, rt::kThreads, smem, st>>>(
        static_cast<const T*>(buffer), core_stride, uniq, step_slot, step_base, step_block,
        step_kpath, n_steps, n_slots, u_cap, e, block_r, stage_rows, rows_u);
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
// memory.  Returns cudaGetLastError().
extern "C" int rt_ragged_access(const void* buffer, long core_stride, const int* lidx,
                                const int* rank, const float* rows_u, const int* hidx,
                                const void* cache, int cache_rows, const int* step_block,
                                int n_steps, const int* runs, int n_runs, float* out, int k,
                                int n_slots, int b, int s, int e, int block_r, int u_cap,
                                int stage_cache, int dtype, void* stream) {
  const long total = static_cast<long>(b) * e;
  if (total == 0 || k * n_slots == 0) return 0;
  const dim3 grid(static_cast<unsigned>((total + rt::kPairs - 1) / rt::kPairs),
                  static_cast<unsigned>(k * n_slots));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, {
    const size_t smem =
        cache != nullptr && stage_cache ? static_cast<size_t>(cache_rows) * e * sizeof(T) : 0;
    static size_t allowed = 0;  // the largest dynamic shared memory set so far
    if (smem > allowed) {
      const cudaError_t err = cudaFuncSetAttribute(
          access_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
    access_kernel<T><<<grid, rt::kThreads, smem, st>>>(
        static_cast<const T*>(buffer), core_stride, lidx, rank, rows_u, hidx,
        static_cast<const T*>(cache), cache_rows, step_block, n_steps, runs, n_runs, out, n_slots,
        b, s, e, block_r, u_cap, stage_cache);
  });
  return static_cast<int>(cudaGetLastError());
}
