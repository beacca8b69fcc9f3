// Fused multi-slot pooled lookup over the ragged packed buffer (base mode).
//
// Replaces the Pallas kernel src/repro/kernels/embedding_multi.py:139
// (_ragged_kernel, pallas_call :460) with unique_cap=0, no residency cache
// and no step_kpath.  On the TPU one core ran a sequential grid over its
// step schedule, the whole batch resident in VMEM, and each (block_r, E)
// window of its buffer was DMA'd once; UB-coded steps folded the s lookup
// positions into one one-hot count GEMM, GM/L1-coded steps pooled one
// position at a time.
//
// What bounds it on this card: bytes, and before them latency.  The call
// must write the whole (K, S, B, E) f32 output (8.4 MB at taobao's K=8,
// S=2, B=8192, E=16) and read the (S, B, s) ids and the rows its ids hit
// (scattered over regions of up to 73 MB, so from HBM); there are B * s * E
// adds per slot.  Each lookup is a chain of dependent loads (id, step block,
// row), so the card reaches its byte rate only with many chains in flight.
// The TPU's "every window once per core" order does not carry over: a CTA
// holds a few hundred queries, not the whole batch.
//
// What the design does about it: one launch for all K cores; grid (K * S
// slots, query tiles), so the first tiles of every slot, where the staged
// runs' work sits, are dispatched first.  A group of E * sizeof(T) / 16
// threads owns a query, each thread one 16-byte vector (4 f32 or 8
// bf16/f16 lanes) of kQ queries (kernels/embedding_multi.py::_queries
// picks kQ so that the grid offers every SM the 4 CTAs it holds at once: 2
// queries a thread in f32 at taobao's B = 8192, 1,024 CTAs).  A thread
// loads its first ids before it knows its slot's run, each warp finds the
// run by one vote over the run list, and then, for each position j in
// order, the thread issues its kQ rows' loads before their adds (and the
// next position's ids under them).  Each output element is summed by one
// thread in id order from 0.0 in f32 and written once as float4s: no
// atomics, bitwise equal to the plain version.  A slot without a run
// writes zeros, so the output needs no zero fill.  A run covers the slot's
// chunk-local rows [0, n_steps * block_r): id l lives in step
// first + l / block_r at row step_block * block_r + l % block_r of the
// core's buffer, and any other id (-1, out of window) adds nothing.  The
// strategy code picks where rows come from, after the paper:
//  * L1 / L1-UB (codes 2, 3) whose region fits smem_rows: the paper's L1
//    data flow.  Warp 0 stages the region's step windows into shared memory
//    with 1-D bulk copies (cp.async.bulk on one mbarrier) while every thread
//    loads the first ids of all its queries, and a thread then serves 8
//    queries in f32 (4 in bf16/f16) from shared memory.  Only the slot's
//    first CTAs work (the others exit at once), so the region crosses from
//    L2 once per 512 queries at E = 16, not once per query tile: 16 times a
//    run at taobao's B = 8192.
//  * GM / GM-UB (codes 0, 1), and L1 regions too large to stage: each
//    lookup reads its row straight from device memory (L2/HBM).
// kernels/embedding_multi.py::STAGE_BYTES caps the staged region at 48 KB:
// the launch reserves the largest staged region in every CTA, gathered
// ones too, and 4 CTAs of 256 threads an SM (the register limit at kQ <= 4,
// 64 a thread; 2 at kQ = 8) need at most 56 KB each.  Taobao's paths stage
// 4 KB (path A), 8 KB (path C) and 8 KB (the mixed case) in f32: 4 CTAs an
// SM each.  Rows that are no whole number of 16-byte vectors, or unaligned
// data, take the scalar kernel: kPer (query, lane) pairs a thread, the same
// sums.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char rt_smem[];

namespace {

// The kernel's arguments (one struct keeps the two kernels in step).
struct Ragged {
  const void* buffer;
  long core_stride;
  const int* lidx;
  const int* step_block;
  int n_steps;
  const int* runs;
  int n_runs;
  float* out;
  int n_slots, b, s, e, block_r, smem_rows;
};

// A staged (resident) run: a CTA serves kM queries a thread (512 queries a
// CTA at E = 16; never fewer than a gathered tile's kQ, so the grid's tiles
// cover the batch) from the region's copy in shared memory.  The thread
// loads the first ids of all kM queries while the copy is in flight, then
// sums them kB at a time.  Returns at once on a CTA past the ones the slot
// needs; every thread of a CTA takes the same path (the barrier below).
template <typename T, int kQ>
__device__ __forceinline__ void ragged_resident(const Ragged& a, const T* cbuf,
                                                const int* blocks, int n, const int* ids_slot,
                                                float* out_slot, int per_pass, int qt, int lane0,
                                                bool active) {
  constexpr int kLanes = 16 / sizeof(T);
  constexpr int kM = 32 / kLanes > kQ ? 32 / kLanes : kQ;  // 8 f32, 4 bf16/f16
  constexpr int kB = 2;            // queries summed at a time
  __shared__ uint64_t bar;
  const long span = static_cast<long>(per_pass) * kM;  // queries a CTA
  if (blockIdx.y * span >= a.b) return;
  const int region = n * a.block_r;
  const uint32_t window = static_cast<uint32_t>(a.block_r) * a.e * sizeof(T);
  T* win = reinterpret_cast<T*>(rt_smem);
  if (threadIdx.x < 32) {  // warp 0 stages the step windows
    if (threadIdx.x == 0) rt::bulk_expect(&bar, window * n);
    __syncwarp();
    for (int i = threadIdx.x; i < n; i += 32)
      rt::bulk_copy(win + static_cast<long>(i) * a.block_r * a.e,
                    cbuf + static_cast<long>(__ldg(blocks + i)) * a.block_r * a.e, window, &bar);
  }
  const long q0 = blockIdx.y * span + qt;
  int first[kM];
  rt::load_ids<kM>(first, ids_slot, q0, per_pass, a.b, a.s, 0, active && a.s > 0);
  __syncthreads();  // the mbarrier is initialised before anyone waits on it
  rt::bulk_wait(&bar);
#pragma unroll
  for (int m = 0; m < kM; m += kB) {
    const long qm = q0 + static_cast<long>(m) * per_pass;
    int l[kB];
#pragma unroll
    for (int i = 0; i < kB; ++i) l[i] = first[m + i];
    float acc[kB][8] = {};
    for (int j = 0; j < a.s; ++j) {
      if (j > 0) rt::load_ids<kB>(l, ids_slot, qm, per_pass, a.b, a.s, j, active);
#pragma unroll
      for (int i = 0; i < kB; ++i) l[i] = l[i] >= 0 && l[i] < region ? l[i] : -1;
      rt::add_rows_vec16<T, kB, false>(acc, win + lane0, l, a.e);
    }
    rt::store_rows<T, kB>(out_slot, acc, qm, per_pass, a.b, a.e, active);
  }
}

// The vector kernel: kQ queries a thread on a gathered run, kRes a round on
// a staged one.
template <typename T, int kQ>
__global__ void __launch_bounds__(rt::kThreads, kQ >= 8 ? 2 : 4) ragged_vec_kernel(Ragged a) {
  constexpr int kLanes = 16 / sizeof(T);
  const int group = a.e / kLanes;
  const int per_pass = blockDim.x / group;  // queries a pass of the CTA covers
  const int qt = threadIdx.x / group;
  const int lane0 = (threadIdx.x - qt * group) * kLanes;
  const bool active = qt < per_pass;  // the last threads idle when group divides no kThreads
  const long cs = blockIdx.x;
  const int* ids_slot = a.lidx + cs * a.b * a.s;
  float* out_slot = a.out + cs * a.b * a.e + lane0;
  const long q0 = static_cast<long>(blockIdx.y) * per_pass * kQ + qt;
  int l[kQ];  // the first ids of a gathered run's tile, in flight during the vote
  rt::load_ids<kQ>(l, ids_slot, q0, per_pass, a.b, a.s, 0, active && a.s > 0);
  const int run_of = rt::find_run(a.runs, a.n_runs, a.n_slots, cs);
  float acc[kQ][8] = {};
  if (run_of < 0) {  // a slot without a run pools nothing: zeros
    rt::store_rows<T, kQ>(out_slot, acc, q0, per_pass, a.b, a.e, active);
    return;
  }
  const int* run = a.runs + 5 * run_of;
  const int core = run[0], first = run[2], n = run[3], code = run[4];
  const T* cbuf = static_cast<const T*>(a.buffer) + core * a.core_stride;
  const int* blocks = a.step_block + static_cast<long>(core) * a.n_steps + first;
  if ((code == 2 || code == 3) && static_cast<long>(n) * a.block_r <= a.smem_rows) {
    ragged_resident<T, kQ>(a, cbuf, blocks, n, ids_slot, out_slot, per_pass, qt, lane0,
                           active);
    return;
  }
  for (int j = 0; j < a.s; ++j) {
    int row[kQ];  // buffer rows fit an int (T < 2^31)
#pragma unroll
    for (int i = 0; i < kQ; ++i) row[i] = static_cast<int>(rt::window_row(l[i], blocks, n, a.block_r));
    if (j + 1 < a.s) rt::load_ids<kQ>(l, ids_slot, q0, per_pass, a.b, a.s, j + 1, active);
    rt::add_rows_vec16<T, kQ, true>(acc, cbuf + lane0, row, a.e);
  }
  rt::store_rows<T, kQ>(out_slot, acc, q0, per_pass, a.b, a.e, active);
}

// The scalar kernel: kPer (query, lane) pairs per thread, thread t holding
// pairs t, t + kThreads, ... of the slot's row-major (B, E) output; a staged
// run is copied into shared memory by every CTA (cp.async where aligned).
template <typename T>
__global__ void __launch_bounds__(rt::kThreads) ragged_scalar_kernel(Ragged a) {
  const long cs = blockIdx.y;
  const int run_of = rt::find_run(a.runs, a.n_runs, a.n_slots, cs);
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
  const int core = run[0], first = run[2], n = run[3], code = run[4];
  const long region = static_cast<long>(n) * a.block_r;
  const T* cbuf = static_cast<const T*>(a.buffer) + core * a.core_stride;
  const int* blocks = a.step_block + static_cast<long>(core) * a.n_steps + first;
  const bool resident = (code == 2 || code == 3) && region <= a.smem_rows;
  T* win = reinterpret_cast<T*>(rt_smem);
  if (resident) {
    for (int i = 0; i < n; ++i) {
      rt::stage_async(win + static_cast<long>(i) * a.block_r * a.e,
                      cbuf + static_cast<long>(__ldg(blocks + i)) * a.block_r * a.e,
                      static_cast<long>(a.block_r) * a.e * sizeof(T));
    }
    rt::stage_wait();
    __syncthreads();
  }
  const int* ids_slot = a.lidx + cs * a.b * a.s;
#pragma unroll
  for (int k = 0; k < rt::kPer; ++k) {
    const long p = pair0 + static_cast<long>(k) * rt::kThreads;
    if (p < total) {
      const long q = p / a.e;
      const int lane = static_cast<int>(p - q * a.e);
      const int* ids = ids_slot + q * a.s;
      float acc = 0.f;
      for (int j = 0; j < a.s; ++j) {
        const int l = __ldg(ids + j);
        if (resident) {
          if (l >= 0 && l < region) acc += rt::to_f32(win[static_cast<long>(l) * a.e + lane]);
        } else {
          const long row = rt::window_row(l, blocks, n, a.block_r);
          if (row >= 0) acc += rt::to_f32(cbuf[row * a.e + lane]);
        }
      }
      out_slot[p] = acc;
    }
  }
}

// The vector kernel's dynamic shared memory limit, raised once per kernel
// and size.
template <typename T, int kQ>
cudaError_t prepare_vec(size_t smem) {
  static size_t allowed = 0;
  return rt::allow_smem(ragged_vec_kernel<T, kQ>, smem, allowed);
}

template <typename T, int kQ>
int launch_vec(const Ragged& a, int k, size_t smem, cudaStream_t st) {
  const int group = a.e / (16 / static_cast<int>(sizeof(T)));
  const long per_cta = static_cast<long>(rt::kThreads / group) * kQ;
  const long tiles = (a.b + per_cta - 1) / per_cta;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(k * a.n_slots), static_cast<unsigned>(tiles));
  const cudaError_t err = prepare_vec<T, kQ>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_vec_kernel<T, kQ><<<grid, rt::kThreads, smem, st>>>(a);
  return 0;
}

template <typename T, int kQ>
int ctas_per_sm(size_t smem, int* n) {
  const cudaError_t err = prepare_vec<T, kQ>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, ragged_vec_kernel<T, kQ>, rt::kThreads, smem));
}

}  // namespace

// buffer (K, >=T, E) with core stride core_stride elements; lidx (K, S, B, s)
// int32; step_block (K, n_steps) int32; runs (n_runs, 5) int32 rows of
// (core, slot, first_step, n_steps, strategy code); out (K, S, B, E) f32,
// every element written (slots without a run as zero); the vector kernel's
// grid is (K * S, query tiles), so at most 65535 query tiles, the scalar
// one's (batch tiles, K * S), so K * S <= 65535.  smem_rows is the
// shared-memory window capacity in rows (0 = never stage).  queries = 1, 2,
// 4 or 8 runs the vector kernel with that many queries a thread (needs
// E * sizeof(T) % 16 == 0, E * sizeof(T) / 16 <= 256 and 16-byte aligned
// buffer rows and output); 0 the scalar one.  Returns the launch's CUDA
// error (0 on success).
extern "C" int rt_multi_embedding_bag_ragged(const void* buffer, long core_stride,
                                             const int* lidx, const int* step_block, int n_steps,
                                             const int* runs, int n_runs, float* out, int k,
                                             int n_slots, int b, int s, int e, int block_r,
                                             int smem_rows, int queries, int dtype,
                                             void* stream) {
  if (static_cast<long>(b) * e == 0 || k * n_slots == 0) return 0;
  const Ragged a{buffer, core_stride, lidx, step_block, n_steps, runs, n_runs, out,
                 n_slots, b, s, e, block_r, smem_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, {
    const size_t smem = static_cast<size_t>(smem_rows) * e * sizeof(T);
    int rc = 0;
    if (queries == 0) {
      const long total = static_cast<long>(b) * e;
      const dim3 grid(static_cast<unsigned>((total + rt::kPairs - 1) / rt::kPairs),
                      static_cast<unsigned>(k * n_slots));
      static size_t allowed = 0;
      const cudaError_t err = rt::allow_smem(ragged_scalar_kernel<T>, smem, allowed);
      if (err != cudaSuccess) return static_cast<int>(err);
      ragged_scalar_kernel<T><<<grid, rt::kThreads, smem, st>>>(a);
    } else {
      const int lanes = 16 / static_cast<int>(sizeof(T));
      if (e % lanes || e / lanes > rt::kThreads) return static_cast<int>(cudaErrorInvalidValue);
      switch (queries) {
        case 1: rc = launch_vec<T, 1>(a, k, smem, st); break;
        case 2: rc = launch_vec<T, 2>(a, k, smem, st); break;
        case 4: rc = launch_vec<T, 4>(a, k, smem, st); break;
        case 8: rc = launch_vec<T, 8>(a, k, smem, st); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    if (rc) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

// *n = the vector kernel's CTAs an SM of the current card holds at `queries`
// queries a thread and `smem` bytes of staging (registers and shared memory
// both counted).  Returns the query's CUDA error (0 on success).
extern "C" int rt_ragged_ctas_per_sm(int queries, int smem, int dtype, int* n) {
  *n = 0;
  RT_DISPATCH_DTYPE(dtype, {
    const size_t bytes = static_cast<size_t>(smem);
    switch (queries) {
      case 1: return ctas_per_sm<T, 1>(bytes, n);
      case 2: return ctas_per_sm<T, 2>(bytes, n);
      case 4: return ctas_per_sm<T, 4>(bytes, n);
      case 8: return ctas_per_sm<T, 8>(bytes, n);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
  return 0;
}
