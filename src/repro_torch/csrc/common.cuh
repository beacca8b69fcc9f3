// Shared pieces of the port's embedding kernels (sm_90a).
//
// Every embedding kernel here computes sum-pooled lookups: for each query
// row q and embedding lane e, out[q, e] = sum over the query's ids of
// row[id, e], read from an f32/bf16/f16 table and accumulated in f32.  Ids
// outside the table (or window) contribute exactly zero.  Each output
// element is summed by one thread in a fixed order and written once (no
// atomics, bitwise reproducible run to run).  Two ways to split the work:
//  * 16-byte vectors (the fused and dense kernels, the GM and L1 kernels,
//    the access kernels): a group of E * sizeof(T) / 16 threads owns a
//    query, each thread one 16-byte vector (4 f32 or 8 bf16/f16 lanes) of
//    the row, so a group reads a whole row with one load a thread and
//    writes float4s; load_ids, add_rows_vec16 and store_rows below are the
//    fused and dense kernels' shared steps;
//  * scalar (rows that are no whole number of 16-byte vectors, or data
//    that is not 16-byte aligned): a CTA of kThreads threads owns kPairs
//    consecutive (query, lane) pairs of the row-major (B, E) output, thread
//    t holding pairs t, t + kThreads, ..., so that neighbouring threads read
//    neighbouring lanes of one row.
// The UB kernel gives each CTA a range of table rows (embedding_ub.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rt {

constexpr int kThreads = 256;
constexpr int kPer = 16;  // (query, lane) pairs per thread
constexpr int kPairs = kThreads * kPer;

// dtype codes passed from Python: 0 = float32, 1 = bfloat16, 2 = float16
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Issue the copy of nbytes from global to shared memory by the whole CTA:
// 16-byte cp.async when both ends are 16-byte aligned (a tail of under 16
// bytes is copied plainly), else a plain byte copy.  Completion needs
// stage_wait() (or stage_commit() and stage_wait_prior()) and then
// __syncthreads().
__device__ __forceinline__ void stage_async(void* smem, const void* gmem, long nbytes) {
  const char* src = static_cast<const char*>(gmem);
  char* dst = static_cast<char*>(smem);
  long body = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    body = nbytes & ~15L;
    for (long off = threadIdx.x * 16L; off < body; off += blockDim.x * 16L) {
      uint32_t saddr = static_cast<uint32_t>(__cvta_generic_to_shared(dst + off));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(src + off));
    }
  }
  for (long off = body + threadIdx.x; off < nbytes; off += blockDim.x) dst[off] = src[off];
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Pipelined staging: close the copies issued so far into one group, and
// wait until at most `pending` of the most recent groups are in flight.
__device__ __forceinline__ void stage_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int pending>
__device__ __forceinline__ void stage_wait_prior() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// v[0 .. 16 / sizeof(T)) = the 4 f32 or 8 bf16/f16 lanes of one 16-byte
// vector of a table row, converted exactly to f32.
template <typename T>
__device__ __forceinline__ void vec16_to_f32(uint4 w, float (&v)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      v[i] = __uint_as_float(u[i]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    } else {
      v[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(u[i] & 0xffffu)));
      v[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(u[i] >> 16)));
    }
  }
}

// acc[0 .. 16 / sizeof(T)) += the lanes of one 16-byte vector (vec16_to_f32).
template <typename T>
__device__ __forceinline__ void add_vec16(float (&acc)[8], uint4 w) {
  float v[8];
  vec16_to_f32<T>(w, v);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) acc[i] += v[i];
}

// ---------------------------------------------------------------------------
// the fused (embedding_multi.cu) and dense (embedding_dense.cu) kernels'
// vector path: a thread holds one 16-byte vector of kN queries q0 + i * stride
// ---------------------------------------------------------------------------

// l[i] = id j of query q0 + i * stride of a (B, s) id block, or -1 for a
// query past b or an idle thread; all kN loads are issued before any is used.
template <int kN>
__device__ __forceinline__ void load_ids(int (&l)[kN], const int* __restrict__ ids, long q0,
                                         int stride, int b, int s, int j, bool active) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const long q = q0 + static_cast<long>(i) * stride;
    l[i] = active && q < b ? __ldg(ids + q * s + j) : -1;
  }
}

// acc[i] += the 16-byte vector at rows + row[i] * e for every row[i] >= 0:
// all the loads are issued first, then the adds, in i order.  kGlobal reads
// device memory through the read-only path, else shared memory.
template <typename T, int kN, bool kGlobal>
__device__ __forceinline__ void add_rows_vec16(float (&acc)[kN][8], const T* rows,
                                               const int (&row)[kN], int e) {
  uint4 w[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (row[i] >= 0) {
      const uint4* src = reinterpret_cast<const uint4*>(rows + static_cast<long>(row[i]) * e);
      w[i] = kGlobal ? __ldg(src) : *src;
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (row[i] >= 0) add_vec16<T>(acc[i], w[i]);
}

// out[q, lane0 .. lane0 + 16 / sizeof(T)) = acc[i] as float4s for each query
// q = q0 + i * stride below b (out points at lane0 of query 0).
template <typename T, int kN>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[kN][8], long q0,
                                           int stride, int b, int e, bool active) {
  constexpr int kLanes = 16 / sizeof(T);
  if (!active) return;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const long q = q0 + static_cast<long>(i) * stride;
    if (q < b) {
      float4* dst = reinterpret_cast<float4*>(out + q * e);
#pragma unroll
      for (int k = 0; k < kLanes / 4; ++k)
        dst[k] = make_float4(acc[i][4 * k], acc[i][4 * k + 1], acc[i][4 * k + 2],
                             acc[i][4 * k + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1-D bulk copies (cp.async.bulk) into shared memory, completed on an mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: initialise the mbarrier for one arrival and arrive, expecting
// `bytes` of bulk copies (at most 2^20 - 1) to complete its phase 0.
__device__ __forceinline__ void bulk_expect(uint64_t* bar, uint32_t bytes) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
}

// Copy `bytes` (a multiple of 16; both ends 16-byte aligned) from device
// memory into this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the copies expected on `bar` (phase 0) have all landed.
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b) : "memory");
  }
}

// ---------------------------------------------------------------------------
// the fused kernel's run list
// ---------------------------------------------------------------------------

// The index into runs (n_runs, 5) of (core, slot) = cs, or -1 when the slot
// has no run.  Each warp scans 32 runs a round and votes, with no barrier;
// called by all 32 lanes of every warp.
__device__ __forceinline__ int find_run(const int* __restrict__ runs, int n_runs, int n_slots,
                                        long cs) {
  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < n_runs; r0 += 32) {
    const int r = r0 + lane;
    const bool hit = r < n_runs && static_cast<long>(__ldg(runs + 5 * r)) * n_slots +
                                           __ldg(runs + 5 * r + 1) == cs;
    const unsigned votes = __ballot_sync(0xffffffffu, hit);
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

// Raise a kernel's dynamic shared memory limit to smem when a launch needs
// more than the largest limit set so far (allowed, one per kernel), so a
// repeated launch of the same size sets nothing.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

}  // namespace rt

// Instantiate the statement(s) given after the code with T bound to the
// table's element type (variadic: a launch's <<<...>>> holds commas).
#define RT_DISPATCH_DTYPE(code, ...)                    \
  switch (code) {                                       \
    case 0: {                                           \
      using T = float;                                  \
      __VA_ARGS__;                                      \
      break;                                            \
    }                                                   \
    case 1: {                                           \
      using T = __nv_bfloat16;                          \
      __VA_ARGS__;                                      \
      break;                                            \
    }                                                   \
    case 2: {                                           \
      using T = __half;                                 \
      __VA_ARGS__;                                      \
      break;                                            \
    }                                                   \
    default:                                            \
      return static_cast<int>(cudaErrorInvalidValue);   \
  }
