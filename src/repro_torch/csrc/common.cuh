// Shared pieces of the port's embedding kernels (sm_90a).
//
// Every embedding kernel here computes sum-pooled lookups: for each query
// row q and embedding lane e, out[q, e] = sum over the query's ids of
// row[id, e], read from an f32/bf16/f16 table and accumulated in f32.  Ids
// outside the table (or window) contribute exactly zero.  The fused and
// dense kernels, and the access kernels' scalar paths, split the work the
// same way: a CTA of kThreads threads owns kPairs consecutive (query, lane)
// pairs of the row-major (B, E) output, thread t holding pairs t,
// t + kThreads, ... so that neighbouring threads read neighbouring lanes of
// one row (coalesced) and each output element is summed by one thread in a
// fixed order (no atomics, bitwise reproducible run to run).  The GM and L1
// kernels and the access kernels' vector paths give each thread one 16-byte
// vector of a row (embedding_gm.cu, embedding_l1.cu, embedding_access.cu);
// the UB kernel gives each CTA a range of table rows (embedding_ub.cu).
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
