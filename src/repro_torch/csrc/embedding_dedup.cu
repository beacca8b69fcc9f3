// Batch dedup of the fused ragged lookup's ids: one CTA per slot, a
// presence bitmap in shared memory, ranks by popcount.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_multi.py:139
// (_ragged_kernel) in its dedup branch's id preparation: _dedup_indices
// (:281; XLA's argsort, cumsum and scatters outside the kernel), which
// feeds uniq/cnt/spill to the branch (:190-236).  Over each slot's B * s
// positions it gives uniq (U) (the first U distinct ids, ascending, -1
// padding), rank (B, s) (each lookup's place in uniq, -1 for padding ids
// and ids past the cap) and spill (B, s) (the ids past the cap, -1
// elsewhere): array-equal to the torch op
// kernels/embedding_multi.py::dedup_indices, its plain version.
//
// What bounds it on this card: launches and latency, not bytes.  The
// function reads the ids once and writes rank, spill and uniq once (1.9 MB
// at path D: 56 slots of 8,192 lookups); the torch op it replaces took
// about 20 launches (a segmented radix sort, a scan, scatters, wheres),
// whose host enqueue the card waited for.
//
// What the design does about it: one launch, one CTA of 1,024 threads per
// slot, no sort.  The rank of a valid id is the number of distinct ids
// below it, which a presence bitmap gives without ordering anything:
//  1. the CTA finds its slot's smallest and largest valid id, and writes
//     rank = spill = -1 for the padding (negative) ids (the plain op sorts
//     an id of INT_MAX with the padding and spills it: so does this);
//  2. it clears a bitmap over the window [lo, lo + span) in shared memory
//     (span at most window_bits, 1,310,720 ids by default, past taobao's
//     largest chunk) and sets each id's bit with atomicOr, whose result does
//     not depend on the order;
//  3. it counts the set bits of each 8-word group and scans the counts, so
//     that rank(id) = base + the group's prefix + the popcounts of at most 7
//     words before the id's word + the popcount of its word below its bit;
//  4. it writes uniq[r] for each set bit of rank r < U, and each lookup's
//     rank (r < U) or spill (r >= U).
// A slot whose ids span more than one window repeats 2-4 for the next
// window, which starts at the smallest id past the last one (empty stretches
// are skipped); base carries the distinct count of the windows before.  So
// any id values and any B * s are taken, in one pass over the ids per
// window; a served slot (ids within its chunk) takes one window.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char rt_dedup_smem[];

namespace {

constexpr int kDedupThreads = 1024;
constexpr int kGroupWords = 8;  // bitmap words per rank group
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// Exclusive prefix sum of a[0, n) in place by the whole CTA; returns the
// total.  Thread t scans a contiguous stretch; warp shuffles join them.
__device__ int block_exclusive_scan(int* a, int n, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, threadIdx.x * per), hi = min(n, lo + per);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += a[i];
  int x = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < n_warps ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, t, off);
      if (lane >= off) t += y;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  int run = x - local + (warp > 0 ? warp_tot[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  const int total = warp_tot[n_warps - 1];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kDedupThreads)
dedup_kernel(const int* __restrict__ lidx, int n, int u_cap, int window_words,
             int* __restrict__ uniq, int* __restrict__ rank, int* __restrict__ spill) {
  __shared__ int lo_hi[2], next_lo;
  __shared__ int warp_tot[32];
  const long row = blockIdx.x;
  const int* ids = lidx + row * n;
  int* rk = rank + row * n;
  int* sp = spill + row * n;
  int* un = uniq + row * u_cap;
  unsigned* words = reinterpret_cast<unsigned*>(rt_dedup_smem);
  int* gsum = reinterpret_cast<int*>(words + window_words);
  const int lane = threadIdx.x & 31;

  // 1. the valid ids' extent; padding ids are settled here
  if (threadIdx.x == 0) {
    lo_hi[0] = kIntMax;
    lo_hi[1] = -1;
  }
  __syncthreads();
  int lo_t = kIntMax, hi_t = -1;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int v = __ldg(ids + p);
    if (v >= 0 && v != kIntMax) {
      lo_t = min(lo_t, v);
      hi_t = max(hi_t, v);
    } else {  // the plain op sorts INT_MAX with the padding, and spills it
      rk[p] = -1;
      sp[p] = v == kIntMax ? v : -1;
    }
  }
  lo_t = __reduce_min_sync(kFull, lo_t);
  hi_t = __reduce_max_sync(kFull, hi_t);
  if (lane == 0) {
    atomicMin(&lo_hi[0], lo_t);
    atomicMax(&lo_hi[1], hi_t);
  }
  __syncthreads();
  int lo = lo_hi[0];
  const int hi = lo_hi[1];
  int base = 0;  // distinct ids in the windows before this one

  while (hi >= 0) {
    const long span = min(static_cast<long>(window_words) * 32,
                          (static_cast<long>(hi) - lo + 1 + 255) / 256 * 256);
    const int span_words = static_cast<int>(span / 32);
    const int n_groups = span_words / kGroupWords;
    // 2. the window's presence bitmap
    uint4* w4 = reinterpret_cast<uint4*>(words);
    for (int i = threadIdx.x; i < span_words / 4; i += blockDim.x) w4[i] = make_uint4(0, 0, 0, 0);
    if (threadIdx.x == 0) next_lo = kIntMax;
    __syncthreads();
    int nl = kIntMax;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int v = __ldg(ids + p);
      if (v >= lo && v != kIntMax) {
        const long d = static_cast<long>(v) - lo;
        if (d < span) {
          atomicOr(&words[d >> 5], 1u << (d & 31));
        } else {
          nl = min(nl, v);
        }
      }
    }
    nl = __reduce_min_sync(kFull, nl);
    if (lane == 0 && nl != kIntMax) atomicMin(&next_lo, nl);
    __syncthreads();
    // 3. set bits per group, scanned: gsum[g] = set bits before group g
    for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
      const uint4 a = w4[2 * g], b = w4[2 * g + 1];
      gsum[g] = __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w) + __popc(b.x) +
                __popc(b.y) + __popc(b.z) + __popc(b.w);
    }
    __syncthreads();
    const int total = block_exclusive_scan(gsum, n_groups, warp_tot);
    // 4. uniq in ascending order, then each lookup's rank or spill
    if (base < u_cap) {
      for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
        int r = base + gsum[g];
        for (int j = 0; j < kGroupWords && r < u_cap; ++j) {
          unsigned word = words[g * kGroupWords + j];
          while (word != 0 && r < u_cap) {
            const int bit = __ffs(word) - 1;
            un[r++] = lo + (g * kGroupWords + j) * 32 + bit;
            word &= word - 1;
          }
        }
      }
    }
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int v = __ldg(ids + p);
      const long d = static_cast<long>(v) - lo;
      if (v >= lo && d < span && v != kIntMax) {
        const int w = static_cast<int>(d >> 5);
        int r = base + gsum[w / kGroupWords];
        for (int j = w / kGroupWords * kGroupWords; j < w; ++j) r += __popc(words[j]);
        r += __popc(words[w] & ((1u << (d & 31)) - 1u));
        if (r < u_cap) {
          rk[p] = r;
          sp[p] = -1;
        } else {
          rk[p] = -1;
          sp[p] = v;
        }
      }
    }
    base += total;
    const bool more = static_cast<long>(lo) + span <= hi;
    const int following = next_lo;
    __syncthreads();  // the bitmap and gsum are read before the next window clears them
    if (!more) break;
    lo = following;
  }
  for (int r = base + threadIdx.x; r < u_cap; r += blockDim.x) un[r] = -1;
}

}  // namespace

// lidx (n_rows, n) int32 -> uniq (n_rows, u_cap), rank and spill
// (n_rows, n) int32, one CTA per row (slot).  window_bits (a positive
// multiple of 256) is the bitmap's capacity in ids: window_bits / 8 bytes of
// bitmap plus window_bits / 64 bytes of group ranks in shared memory.
// Returns cudaGetLastError().
extern "C" int rt_dedup_indices(const int* lidx, int n_rows, int n, int u_cap, int window_bits,
                                int* uniq, int* rank, int* spill, void* stream) {
  if (n_rows == 0) return 0;
  if (u_cap <= 0 || window_bits <= 0 || window_bits % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int window_words = window_bits / 32;
  const size_t smem = static_cast<size_t>(window_words) * sizeof(unsigned) +
                      static_cast<size_t>(window_words / kGroupWords) * sizeof(int);
  static size_t allowed = 0;  // the largest dynamic shared memory set so far
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        dedup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  dedup_kernel<<<n_rows, kDedupThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lidx, n, u_cap, window_words, uniq, rank, spill);
  return static_cast<int>(cudaGetLastError());
}
