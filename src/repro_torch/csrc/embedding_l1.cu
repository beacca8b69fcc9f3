// L1 strategy: pooled lookup served from a table held on chip, in one CTA's
// shared memory or spread over a thread-block cluster's.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_l1.py:25
// (_l1_kernel / embedding_bag_l1), which pinned the whole table in the
// core's VMEM once and ran a sequential loop over each query's ids,
// reading rows by dynamic index from the resident copy.
//
// What bounds it on this card: the copy of the table into shared memory,
// not the lookups.  Each CTA stages its rows from L2 through one SM's port,
// so a launch's time grows with the bytes each CTA holds (chip_smoke.py's
// l1_sweep), on top of a fixed cost for the copy's latency and the cluster's
// barriers that a batch of one query shows alone; the B * s row reads after
// it come from shared memory.  A CTA holds at most 227 KB, while the planner
// (priced by a cost-model preset with a 1 MiB or larger on-chip budget) may
// send a larger table.
//
// What the design does about it: kernels/embedding_l1.py::l1_schedule picks
// one of three modes per launch.
//  * resident (the table fits one CTA's 200 KB budget): every CTA stages
//    the whole table with bulk asynchronous copies (cp.async.bulk,
//    completed on an mbarrier) while its threads load their first ids, and
//    the grid, about one CTA of 256 threads per SM, walks the batch.
//  * cluster (the table fits 4, 8 or 16 CTAs): a thread-block cluster of C
//    CTAs on neighbouring SMs holds the table once between them: rank k
//    stages rows [k R, (k + 1) R) into its own shared memory, the cluster
//    synchronises, and every lookup of row r reads it from rank r / R
//    through distributed shared memory (mapa + ld.shared::cluster).  C is
//    the smallest size whose slice is at most 64 KB (else the largest that
//    schedules), so each CTA stages little; CTAs of 1024 threads give every
//    (query, vector) its own thread with few clusters, and the clusters the
//    card holds at once (cudaOccupancyMaxActiveClusters) bound the grid.
//    Taobao's table 2 (830 KB) takes 2 clusters of 16 CTAs of 52 KB: the
//    table crosses from L2 twice, not once per CTA.  The cluster
//    synchronises again before any CTA exits, so no CTA's shared memory
//    goes away while another still reads it.  A cluster the card cannot
//    schedule raises in the wrapper; it never drops to another mode.
//  * beyond (larger than any cluster that schedules): the wrapper calls the
//    row-range UB kernel (embedding_ub.cu), which reads such a table once
//    per launch; there is no second table sweep here.
// A thread owns one (query, 16-byte lane vector) of the output: 4 f32 or 8
// bf16/f16 lanes read with one 16-byte shared-memory load per id, four ids'
// loads in flight before their adds, summed in id order from 0.0 in f32
// (s = 1 is a row copy, bitwise equal to the plain version).  Rows that are
// not a multiple of 16 bytes (or a table that is not 16-byte aligned) take a
// scalar path: one thread per (query, lane), staged with 16-byte cp.async
// where aligned.  Ids outside [0, m) add nothing.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char rt_smem[];

namespace {

constexpr unsigned kBulkChunk = 32 * 1024;  // bytes per cp.async.bulk
constexpr int kUnroll = 4;                  // row loads in flight per thread
constexpr int kMaxThreads = 1024;           // threads a CTA (kernels/embedding_l1.py picks)

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives and waits: writes to
// shared memory before it are visible cluster-wide after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The shared-memory address `addr` of the CTA of cluster rank `rank`.
__device__ __forceinline__ uint32_t remote(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

template <bool kCluster>
__device__ __forceinline__ uint4 ld_vec(uint32_t addr) {
  uint4 w;
  if constexpr (kCluster) {
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w) : "r"(addr) : "memory");
  } else {
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w) : "r"(addr) : "memory");
  }
  return w;
}

template <typename T, bool kCluster>
__device__ __forceinline__ float ld_scalar(uint32_t addr) {
  if constexpr (sizeof(T) == 4) {
    float v;
    if constexpr (kCluster)
      asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
    else
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
    return v;
  } else {
    unsigned short u;
    if constexpr (kCluster)
      asm volatile("ld.shared::cluster.b16 %0, [%1];\n" : "=h"(u) : "r"(addr) : "memory");
    else
      asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(u) : "r"(addr) : "memory");
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return __bfloat162float(__ushort_as_bfloat16(u));
    else
      return __half2float(__ushort_as_half(u));
  }
}

// Start copying `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into this CTA's shared memory with bulk asynchronous copies
// started by thread 0, completing on the mbarrier `bar`; rt::bulk_wait waits.
__device__ __forceinline__ void bulk_start(void* dst, const void* src, uint32_t bytes,
                                           uint64_t* bar) {
  if (threadIdx.x == 0) {
    rt::bulk_expect(bar, bytes);
    for (uint32_t off = 0; off < bytes; off += kBulkChunk)
      rt::bulk_copy(static_cast<char*>(dst) + off, static_cast<const char*>(src) + off,
                    min(kBulkChunk, bytes - off), bar);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
}

// The ids j0 .. j0 + kUnroll - 1 of a query (-1 past s).
__device__ __forceinline__ void load_ids(const int* __restrict__ ids, int s, int j0,
                                         int (&r)[kUnroll]) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) r[k] = j0 + k < s ? __ldg(ids + j0 + k) : -1;
}

// out[q, :] = sum over the query's ids in [0, m), in id order from 0.0, of
// row[id, :].  Rank k of a cluster of C holds rows [k R, (k + 1) R);
// without a cluster (kCluster false) the CTA holds all m rows (R = m).  A
// thread serves the (query, 16-byte vector) items (kVec) or (query, lane)
// items t, t + threads, ... of the grid; its first item's ids are loaded
// while the table is being staged.
template <typename T, bool kCluster, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
l1_kernel(const T* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
          int m, int b, int s, int e, int rows_per_cta) {
  constexpr int kLanes = 16 / sizeof(T);
  __shared__ uint64_t bar;
  T* tab = reinterpret_cast<T*>(rt_smem);
  const uint32_t rank = kCluster ? cluster_rank() : 0u;
  const long lo = static_cast<long>(rank) * rows_per_cta;
  const long rows = max(0L, min(static_cast<long>(rows_per_cta), static_cast<long>(m) - lo));
  const long bytes = rows * e * static_cast<long>(sizeof(T));
  if constexpr (kVec) bulk_start(tab, table + lo * e, static_cast<uint32_t>(bytes), &bar);
  else rt::stage_async(tab, table + lo * e, bytes);

  const int per = kVec ? e / kLanes : e;  // items per query
  const long total = static_cast<long>(b) * per;
  const long w0 = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long step = static_cast<long>(gridDim.x) * blockDim.x;
  int first[kUnroll];
  load_ids(idx + (w0 < total ? w0 / per : 0) * s, s, 0, first);

  if constexpr (kVec) rt::bulk_wait(&bar);
  else rt::stage_wait();
  if constexpr (kCluster) cluster_sync();
  else __syncthreads();

  const uint32_t base = rt::smem_addr(tab);
  const long row_bytes = static_cast<long>(e) * sizeof(T);
  for (long w = w0; w < total; w += step) {
    const long q = w / per;
    const int sub = static_cast<int>(w - q * per);
    const long col = kVec ? 16L * sub : static_cast<long>(sizeof(T)) * sub;  // byte in the row
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < s; j0 += kUnroll) {
      int r[kUnroll];
      if (w == w0 && j0 == 0) {
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) r[k] = first[k];
      } else {
        load_ids(idx + q * s, s, j0, r);
      }
      uint4 x[kUnroll];
      float y[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        ok[k] = r[k] >= 0 && r[k] < m;
        if (ok[k]) {
          const int owner = kCluster ? r[k] / rows_per_cta : 0;
          uint32_t a = base + static_cast<uint32_t>((r[k] - owner * rows_per_cta) * row_bytes + col);
          if constexpr (kCluster) a = remote(a, owner);
          if constexpr (kVec) x[k] = ld_vec<kCluster>(a);
          else y[k] = ld_scalar<T, kCluster>(a);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (!ok[k]) continue;
        if constexpr (kVec) rt::add_vec16<T>(acc, x[k]);
        else acc[0] += y[k];
      }
    }
    if constexpr (kVec) {
      float4* o = reinterpret_cast<float4*>(out + q * e + sub * kLanes);
      o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      if constexpr (kLanes == 8) o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
      out[w] = acc[0];
    }
  }
  // no CTA of the cluster leaves while another may still read its rows
  if constexpr (kCluster) cluster_sync();
}

// Dynamic shared memory and the non-portable cluster size are set once per
// kernel and size, not on every launch.
template <typename T, bool kCluster, bool kVec>
cudaError_t prepare(size_t smem, int cluster) {
  static size_t allowed = 0;  // the largest dynamic shared memory set so far
  static bool nonportable = false;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        l1_kernel<T, kCluster, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  if (cluster > 8 && !nonportable) {
    const cudaError_t err = cudaFuncSetAttribute(
        l1_kernel<T, kCluster, kVec>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int cluster, int grid, int threads,
                                  size_t smem, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, bool kVec>
int launch(const T* table, const int* idx, float* out, int m, int b, int s, int e, int cluster,
           int rows_per_cta, int grid, int threads, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(rows_per_cta) * e * sizeof(T);
  if (cluster == 1) {
    if (rows_per_cta < m) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = prepare<T, false, kVec>(smem, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    l1_kernel<T, false, kVec><<<grid, threads, smem, st>>>(table, idx, out, m, b, s, e,
                                                           rows_per_cta);
    return static_cast<int>(cudaGetLastError());
  }
  if (static_cast<long>(cluster) * rows_per_cta < m || grid % cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare<T, true, kVec>(smem, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, cluster, grid, threads, smem, st);
  err = cudaLaunchKernelEx(&cfg, l1_kernel<T, true, kVec>, table, idx, out, m, b, s, e,
                           rows_per_cta);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int active_clusters(int cluster, size_t smem, int threads, int* n) {
  cudaError_t err = prepare<T, true, true>(smem, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, cluster, cluster, threads, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(n, l1_kernel<T, true, true>, &cfg);
  return static_cast<int>(err);
}

}  // namespace

// table (m, E), idx (B, s) int32 -> out (B, E) f32 in the resident mode
// (cluster == 1, rows_per_cta >= m) or the cluster mode (cluster CTAs of a
// cluster hold rows_per_cta rows each; grid a multiple of cluster), with
// `threads` threads a CTA (at most 1024).  Rows that are a multiple of 16
// bytes of a 16-byte-aligned table take the vector path.  Returns the
// launch's CUDA error (0 on success).
extern "C" int rt_embedding_bag_l1(const void* table, const int* idx, float* out, int m, int b,
                                   int s, int e, int cluster, int rows_per_cta, int grid,
                                   int threads, int dtype, void* stream) {
  if (static_cast<long>(b) * e == 0) return 0;
  if (cluster < 1 || grid < 1 || threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, {
    const bool vec = (e * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
    const T* t = static_cast<const T*>(table);
    return vec ? launch<T, true>(t, idx, out, m, b, s, e, cluster, rows_per_cta, grid, threads, st)
               : launch<T, false>(t, idx, out, m, b, s, e, cluster, rows_per_cta, grid, threads,
                                  st);
  });
  return 0;
}

// *n = the clusters of `cluster` CTAs of `threads` threads and `smem` bytes
// of dynamic shared memory each that the current card holds at once (0: it
// cannot schedule one).  Returns the query's CUDA error (0 on success).
extern "C" int rt_l1_active_clusters(int cluster, int smem, int threads, int dtype, int* n) {
  *n = 0;
  RT_DISPATCH_DTYPE(dtype, return active_clusters<T>(cluster, static_cast<size_t>(smem), threads,
                                                     n));
  return 0;
}
