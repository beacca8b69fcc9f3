// GM-UB / L1-UB strategies: a table sweep whose run time does not depend on
// the id values.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_ub.py
// (_ub_kernel / embedding_bag_ub).  On the TPU, each (batch tile, table
// chunk) grid step built a one-hot count matrix of the tile's ids against
// the chunk's rows and multiplied it by the chunk on the MXU; GM-UB
// streamed block_m-row chunks from HBM, L1-UB pinned the whole table.
//
// What bounds it on this card: bytes.  A literal one-hot GEMM would cost
// O(B * m * E) operations (10^11 at taobao's 846,812-row table and B=8192)
// for a function whose useful work is B * s * E adds.  What UB means is a
// conflict-free lookup that sweeps the table whatever the ids are, so the
// traffic is (batch CTAs) x (table bytes), served mostly from L2, plus
// the ids and the (B, E) f32 output.
//
// What the design does about it: the count matrix is never formed.  A CTA
// owns a tile of kPairs (query, lane) pairs and one split of the table's
// rows; it stages its split through shared memory tile_rows rows at a time
// with 16-byte cp.async copies (rt::sweep_tiles) and every pair adds the
// rows its query's ids hit in the current tile.  Splitting the rows over
// grid.y keeps enough CTAs in flight when the batch is small; the splits
// write f32 partials that a second kernel sums in split order, so the
// result is the same on every run.  persistent=True (L1-UB) passes
// tile_rows >= m when the table fits one CTA's shared memory, which makes
// the sweep a single resident tile; a larger table is tiled like GM-UB.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char rt_smem[];

namespace {

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
ub_kernel(const T* __restrict__ table, const int* __restrict__ idx, float* __restrict__ out,
          int m, int b, int s, int e, int tile_rows, int split_rows) {
  const long total = static_cast<long>(b) * e;
  const long pair0 = static_cast<long>(blockIdx.x) * rt::kPairs + threadIdx.x;
  const int row_lo = blockIdx.y * split_rows;
  const int row_hi = min(m, row_lo + split_rows);
  float acc[rt::kPer];
#pragma unroll
  for (int k = 0; k < rt::kPer; ++k) acc[k] = 0.f;
  rt::sweep_tiles(table, idx, reinterpret_cast<T*>(rt_smem), acc, pair0, total, s, e, row_lo,
                  row_hi, tile_rows);
  float* dst = out + static_cast<long>(blockIdx.y) * total;
#pragma unroll
  for (int k = 0; k < rt::kPer; ++k) {
    const long p = pair0 + static_cast<long>(k) * rt::kThreads;
    if (p < total) dst[p] = acc[k];
  }
}

// out[p] = sum over splits, in split order, of partial[split, p].
__global__ void __launch_bounds__(rt::kThreads)
reduce_splits_kernel(const float* __restrict__ partial, float* __restrict__ out, long total,
                     int n_splits) {
  const long p = static_cast<long>(blockIdx.x) * rt::kThreads + threadIdx.x;
  if (p >= total) return;
  float acc = 0.f;
  for (int i = 0; i < n_splits; ++i) acc += partial[i * total + p];
  out[p] = acc;
}

template <typename T>
int launch(const T* table, const int* idx, float* out, float* partial, int m, int b, int s,
           int e, int tile_rows, int split_rows, int n_splits, cudaStream_t st) {
  const long total = static_cast<long>(b) * e;
  const dim3 grid(static_cast<unsigned>((total + rt::kPairs - 1) / rt::kPairs),
                  static_cast<unsigned>(n_splits));
  const size_t smem = static_cast<size_t>(min(tile_rows, m)) * e * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      ub_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dst = n_splits > 1 ? partial : out;
  ub_kernel<T><<<grid, rt::kThreads, smem, st>>>(table, idx, dst, m, b, s, e, tile_rows,
                                                 split_rows);
  if (n_splits > 1) {
    const unsigned rgrid = static_cast<unsigned>((total + rt::kThreads - 1) / rt::kThreads);
    reduce_splits_kernel<<<rgrid, rt::kThreads, 0, st>>>(partial, out, total, n_splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (m, E), idx (B, s) int32 -> out (B, E) f32.  Rows are split into
// n_splits ranges of split_rows (a multiple of tile_rows, itself a multiple
// of 8); with n_splits > 1, partial is (n_splits, B, E) f32 scratch.
// Returns cudaGetLastError().
extern "C" int rt_embedding_bag_ub(const void* table, const int* idx, float* out, float* partial,
                                   int m, int b, int s, int e, int tile_rows, int split_rows,
                                   int n_splits, int dtype, void* stream) {
  if (static_cast<long>(b) * e == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, return launch<T>(static_cast<const T*>(table), idx, out, partial, m,
                                            b, s, e, tile_rows, split_rows, n_splits, st));
  return 0;
}
