// GM-UB / L1-UB strategies: a table sweep whose device-memory traffic does
// not depend on the id values.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_ub.py:34
// (_ub_kernel / embedding_bag_ub).  On the TPU, each (batch tile, table
// chunk) grid step built a one-hot count matrix of the tile's ids against
// the chunk's rows and multiplied it by the chunk on the MXU; GM-UB
// streamed block_m-row chunks from HBM, L1-UB pinned the whole table.
//
// What bounds it on this card: bytes.  A literal one-hot GEMM would cost
// O(B * m * E) operations (10^11 at taobao's 846,812-row table and B=8192)
// for a function whose useful work is B * s * E adds.  What UB means is a
// conflict-free lookup that reads the whole table whatever the ids are, so
// the floor is one read of the table plus the ids and the (B, E) f32
// output: 54 MB at taobao's table 1, 0.016 ms at 3.35 TB/s.
//
// What the design does about it: a CTA owns rows, not queries.  The grid
// is (row range x id chunk), sized by kernels/embedding_ub.py::ub_schedule
// to two CTAs per SM (2 x 132), all in flight at once:
//  * a table larger than one tile is cut into contiguous ranges, one per
//    CTA, and the batch's ids are one chunk: every row of the table is
//    read from device memory by exactly one CTA, once per launch (a table
//    under 2 x 132 x 128 rows gets fewer, 128-row ranges, and its ids a
//    few chunks; each chunk's CTAs read the small table again, from L2);
//  * a table that fits one tile (L1-UB's resident table, taobao's small
//    tables) is one range, and the id chunks split the ids; each chunk's CTA
//    stages the whole (small) table, from L2 after the first.
// Each CTA starts the loads of its first 8,192 ids (16-byte loads, all in
// flight) and the copies of its first three tiles, reads its id chunk once
// and lists the (position, row) hits that fall in its range in shared
// memory, bucketed by tile (a counting sort).  The scan keeps each thread's
// hits as a bit mask, so one warp-wide atomic claims their list slots and a
// thread adds its hits to the per-tile counts one run of equal tiles at a
// time: a batch of one repeated id serialises nothing.  It then streams its
// range through a ring of four 8 KB tiles in shared memory (16-byte
// cp.async, three tiles in flight while one is copied out) and, for each
// hit of the current tile, copies the row, converted to f32, to the hit's
// output position with 16-byte stores, E / 4 neighbouring threads per row.
// A CTA whose range takes more hits than its list holds (a batch of one
// repeated id) walks its ids again in pieces for each tile that has hits;
// it never overflows and still reads each row once.  A CTA's registers
// (127 a thread) let two fit an SM, and the schedule gives the card
// exactly two per SM: a 265th CTA would run alone in a second wave.  Every
// output element is written exactly once, without atomics, so the result
// is the same on every run:
//  * s = 1: rows go straight to out (B, E); a query whose id lies outside
//    [0, m) gets zeros from the CTA that owns range 0 of its id chunk;
//  * s != 1: rows go to a (B*s, E) f32 scratch, and pool_kernel sums each
//    query's s entries in position order from 0.0, skipping invalid ids.
#include "common.cuh"

extern __shared__ __align__(16) unsigned char rt_smem[];

namespace {

constexpr int kHitCap = 2048;  // hits a CTA lists in shared memory
constexpr int kMaxTiles = 64;  // tiles per range (kernels/embedding_ub.py MAX_TILES)
constexpr int kStages = 4;     // tiles in the shared-memory ring, kStages - 1 in flight
constexpr int kVec = 8;        // 16-byte id loads in flight per thread: 8,192 ids a CTA
constexpr int kPieceVec = 4;   // the same for one piece of ids (both lists' room)
constexpr unsigned kFull = 0xffffffffu;
static_assert(4 * kPieceVec * rt::kThreads == 2 * kHitCap, "a piece of ids fills both lists");
static_assert(4 * kVec <= 32, "a thread's ids of one slab fit a 32-bit mask");

// One slab of ids in registers: thread t holds v[4 * u + j] = the id at
// position base + 4 * (u * kThreads + t) + j (0 past hi), loaded as kSlots
// 16-byte loads all in flight at once where the ids are 16-byte aligned.
template <int kSlots>
__device__ __forceinline__ void load_ids(const int* __restrict__ idx, long base, long hi,
                                         bool aligned, int (&v)[4 * kSlots]) {
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
    const long q = base + 4L * (u * rt::kThreads + threadIdx.x);
    if (aligned && q + 3 < hi) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(idx + q));
      v[4 * u] = w.x;
      v[4 * u + 1] = w.y;
      v[4 * u + 2] = w.z;
      v[4 * u + 3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * u + j] = q + j < hi ? __ldg(idx + q + j) : 0;
    }
  }
}

__device__ __forceinline__ long slab_pos(long base, int i) {
  return base + 4L * ((i >> 2) * rt::kThreads + threadIdx.x) + (i & 3);
}

// The lanes of a warp claim consecutive slots of *counter, one for each set
// bit of their `bits`, with one atomic per warp; returns this lane's first
// slot.  Every lane of the warp calls it.
__device__ __forceinline__ int warp_claim_bits(unsigned bits, int* counter) {
  const int lane = threadIdx.x & 31;
  const int c = __popc(bits);
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  int base = 0;
  if (lane == 31 && incl > 0) base = atomicAdd(counter, incl);
  return __shfl_sync(kFull, base, 31) + incl - c;
}

// The lanes with `take` add one to counters[key], one atomic per distinct
// key in the warp, and get their slot (the old count plus their place among
// the lanes of the same key).  Every lane of the warp calls it.
__device__ __forceinline__ int warp_claim_keyed(bool take, int* counters, int key) {
  const unsigned mask = __ballot_sync(kFull, take);
  int slot = 0;
  if (take) {
    const unsigned peers = __match_any_sync(mask, key);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (static_cast<int>(threadIdx.x & 31) == leader) base = atomicAdd(&counters[key], __popc(peers));
    base = __shfl_sync(peers, base, leader);
    slot = base + __popc(peers & ((1u << (threadIdx.x & 31)) - 1u));
  }
  return slot;
}

// Four consecutive table elements as f32 (8- or 16-byte aligned loads).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&w.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// dst[pos[k], :] = f32(tile[row[k] - t0, :]) for k < n.  With E a multiple
// of 4 (and E / 4 dividing the CTA) each thread moves 4 elements at a time
// (a 16-byte store), E / 4 neighbouring threads per row, so a warp's stores
// are coalesced; otherwise one element at a time.
template <typename T>
__device__ __forceinline__ void copy_hits(const T* tile, const int* pos, const int* row, int n,
                                          int t0, int e, float* __restrict__ dst, long id_lo) {
  const int quads = e >> 2;
  if ((e & 3) == 0 && rt::kThreads % quads == 0) {
    // each thread keeps one quad of the row and walks the hits
    const int c = static_cast<int>(threadIdx.x) % quads * 4;
#pragma unroll 4
    for (int k = static_cast<int>(threadIdx.x) / quads; k < n; k += rt::kThreads / quads) {
      *reinterpret_cast<float4*>(dst + (id_lo + pos[k]) * e + c) =
          load4(tile + static_cast<long>(row[k] - t0) * e + c);
    }
  } else {
    const int total = n * e;
    for (int p = threadIdx.x; p < total; p += blockDim.x) {
      const int k = p / e;
      const int lane = p - k * e;
      dst[(id_lo + pos[k]) * e + lane] = rt::to_f32(tile[static_cast<long>(row[k] - t0) * e + lane]);
    }
  }
}

__device__ __forceinline__ void zero_row(float* o, int e) {
  if ((e & 3) == 0) {
    for (int c = 0; c < e; c += 4) *reinterpret_cast<float4*>(o + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int c = 0; c < e; ++c) o[c] = 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(rt::kThreads)
ub_kernel(const T* __restrict__ table, const int* __restrict__ idx, float* __restrict__ dst,
          int m, long n_ids, int e, int range_rows, int chunk_ids, int tile_rows,
          int zero_invalid) {
  __shared__ int tile_count[kMaxTiles];
  __shared__ int tile_start[kMaxTiles];
  __shared__ int tile_fill[kMaxTiles];
  __shared__ int n_hit, n_piece;
  const int row_lo = blockIdx.x * range_rows;
  const int row_hi = min(m, row_lo + range_rows);
  const int n_tiles = row_hi > row_lo ? (row_hi - row_lo + tile_rows - 1) / tile_rows : 0;
  const long id_lo = static_cast<long>(blockIdx.y) * chunk_ids;
  const long id_hi = min(n_ids, id_lo + chunk_ids);
  const long tile_elems = static_cast<long>(tile_rows) * e;
  T* ring = reinterpret_cast<T*>(rt_smem);
  // as the launch sized it: kStages tiles, or as many as a range holds
  const int n_buf = min(kStages, (range_rows + tile_rows - 1) / tile_rows);
  const uintptr_t lists =
      (reinterpret_cast<uintptr_t>(ring + n_buf * tile_elems) + 15) & ~uintptr_t(15);
  int* hit_pos = reinterpret_cast<int*>(lists);
  int* hit_row = hit_pos + kHitCap;
  int* t_pos = hit_row + kHitCap;  // the listed hits bucketed by tile
  int* t_row = t_pos + kHitCap;
  int* piece_pos = hit_pos;  // or, past the list, one piece's hits in both lists' room
  int* piece_row = t_pos;

  // tile t goes to ring slot t % kStages; one commit group per tile index
  // (empty past the range), so that wait_prior counts stay uniform
  auto stage = [&](int t) {
    if (t < n_tiles) {
      const int r0 = row_lo + t * tile_rows;
      const int rows = min(tile_rows, row_hi - r0);
      rt::stage_async(ring + (t % kStages) * tile_elems, table + static_cast<long>(r0) * e,
                      static_cast<long>(rows) * e * sizeof(T));
    }
    rt::stage_commit();
  };
  // 1. the first ids, then the first tiles, are in flight while the
  // counters are cleared (ids first: they would queue behind the table)
  const bool aligned = (reinterpret_cast<uintptr_t>(idx + id_lo) & 15) == 0;
  constexpr long kSlab = 4L * kVec * rt::kThreads;
  int v[4 * kVec];
  load_ids<kVec>(idx, id_lo, id_hi, aligned, v);
  for (int t = 0; t < kStages - 1; ++t) stage(t);
  for (int i = threadIdx.x; i < kMaxTiles; i += blockDim.x) tile_count[i] = 0;
  if (threadIdx.x == 0) n_hit = 0;
  __syncthreads();

  // 2. the hits of this range among the chunk's ids, as bit masks per
  // thread: one warp-wide atomic claims their list slots, and a thread adds
  // its hits to the per-tile counts one run of equal tiles at a time (so a
  // batch of one repeated id does not serialise them)
  for (long base = id_lo; base < id_hi; base += kSlab) {
    if (base != id_lo) load_ids<kVec>(idx, base, id_hi, aligned, v);
    unsigned hit = 0, bad = 0;
#pragma unroll
    for (int i = 0; i < 4 * kVec; ++i) {
      const bool in = slab_pos(base, i) < id_hi;
      hit |= static_cast<unsigned>(in && v[i] >= row_lo && v[i] < row_hi) << i;
      bad |= static_cast<unsigned>(in && (v[i] < 0 || v[i] >= m)) << i;
    }
    int k = warp_claim_bits(hit, &n_hit);
    int run_tile = -1, run_n = 0;
#pragma unroll
    for (int i = 0; i < 4 * kVec; ++i) {
      if ((hit >> i) & 1u) {
        const int r = v[i] - row_lo;
        if (k < kHitCap) {
          hit_pos[k] = static_cast<int>(slab_pos(base, i) - id_lo);
          hit_row[k] = r;
        }
        ++k;
        const int tile = r / tile_rows;
        if (tile != run_tile) {
          if (run_n) atomicAdd(&tile_count[run_tile], run_n);
          run_tile = tile;
          run_n = 0;
        }
        ++run_n;
      }
    }
    if (run_n) atomicAdd(&tile_count[run_tile], run_n);
    if (zero_invalid && blockIdx.x == 0 && bad) {
#pragma unroll
      for (int i = 0; i < 4 * kVec; ++i)
        if ((bad >> i) & 1u) zero_row(dst + slab_pos(base, i) * e, e);
    }
  }
  __syncthreads();
  const int hits = n_hit;
  const bool listed = hits <= kHitCap;

  // 3. bucket the listed hits by tile (a counting sort into t_pos/t_row)
  if (listed && hits > 0) {
    if (threadIdx.x == 0) {
      int acc = 0;
      for (int t = 0; t < n_tiles; ++t) {
        tile_start[t] = tile_fill[t] = acc;
        acc += tile_count[t];
      }
    }
    __syncthreads();
    for (int k0 = 0; k0 < hits; k0 += blockDim.x) {
      const int k = k0 + threadIdx.x;
      const bool take = k < hits;
      const int r = take ? hit_row[k] : 0;
      const int slot = warp_claim_keyed(take, tile_fill, r / tile_rows);
      if (take) {
        t_pos[slot] = hit_pos[k];
        t_row[slot] = r;
      }
    }
    __syncthreads();
  }

  // 4. stream the range through the ring, kStages - 1 tiles ahead
  for (int t = 0; t < n_tiles; ++t) {
    stage(t + kStages - 1);  // into the slot tile t - 1 left
    rt::stage_wait_prior<kStages - 1>();
    __syncthreads();
    const T* tile = ring + (t % kStages) * tile_elems;
    const int t0 = t * tile_rows;
    if (tile_count[t] > 0) {
      if (listed) {
        copy_hits(tile, t_pos + tile_start[t], t_row + tile_start[t], tile_count[t], t0, e, dst,
                  id_lo);
      } else {  // more hits than the list holds: this tile's, a piece of ids at a time
        const int rows = min(tile_rows, row_hi - row_lo - t0);
        for (long c = id_lo; c < id_hi; c += 2 * kHitCap) {
          if (threadIdx.x == 0) n_piece = 0;
          __syncthreads();
          const long c_hi = min(id_hi, c + 2 * kHitCap);
          int w[4 * kPieceVec];
          load_ids<kPieceVec>(idx, c, c_hi, aligned, w);
          unsigned hit = 0;
#pragma unroll
          for (int i = 0; i < 4 * kPieceVec; ++i) {
            const long r = static_cast<long>(w[i]) - row_lo;
            hit |= static_cast<unsigned>(slab_pos(c, i) < c_hi && r >= t0 && r < t0 + rows) << i;
          }
          int k = warp_claim_bits(hit, &n_piece);
#pragma unroll
          for (int i = 0; i < 4 * kPieceVec; ++i) {
            if ((hit >> i) & 1u) {
              piece_pos[k] = static_cast<int>(slab_pos(c, i) - id_lo);
              piece_row[k++] = w[i] - row_lo;
            }
          }
          __syncthreads();
          copy_hits(tile, piece_pos, piece_row, n_piece, t0, e, dst, id_lo);
          __syncthreads();
        }
      }
    }
    __syncthreads();  // the slot of tile t is free for tile t + kStages
  }
}

// out[q, :] = sum over j < s, in order from 0.0, of rows[q * s + j, :] for
// the ids in [0, m).
__global__ void __launch_bounds__(rt::kThreads)
pool_kernel(const int* __restrict__ idx, const float* __restrict__ rows, float* __restrict__ out,
            int m, int b, int s, int e) {
  const long p = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<long>(b) * e) return;
  const long q = p / e;
  const int lane = static_cast<int>(p - q * e);
  float acc = 0.f;
  for (int j = 0; j < s; ++j) {
    const int v = __ldg(idx + q * s + j);
    if (v >= 0 && v < m) acc += rows[(q * s + j) * e + lane];
  }
  out[p] = acc;
}

template <typename T>
int launch(const T* table, const int* idx, float* out, float* scratch, int m, int b, int s, int e,
           int tile_rows, int range_rows, int n_ranges, int chunk_ids, int n_chunks,
           cudaStream_t st) {
  const long n_ids = static_cast<long>(b) * s;
  if (n_ids > 0) {
    if (tile_rows <= 0 || tile_rows > range_rows || chunk_ids <= 0 ||
        (range_rows + tile_rows - 1) / tile_rows > kMaxTiles ||
        static_cast<long>(n_ranges) * range_rows < m || static_cast<long>(n_chunks) * chunk_ids < n_ids)
      return static_cast<int>(cudaErrorInvalidValue);
    const int n_buf = min(kStages, (range_rows + tile_rows - 1) / tile_rows);
    const size_t smem = ((static_cast<size_t>(n_buf) * tile_rows * e * sizeof(T) + 15) &
                         ~size_t(15)) + 4 * kHitCap * sizeof(int);
    static size_t allowed = 0;  // the largest dynamic shared memory set so far
    if (smem > allowed) {
      const cudaError_t err = cudaFuncSetAttribute(
          ub_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
    const dim3 grid(static_cast<unsigned>(n_ranges), static_cast<unsigned>(n_chunks));
    ub_kernel<T><<<grid, rt::kThreads, smem, st>>>(table, idx, s == 1 ? out : scratch, m, n_ids, e,
                                                   range_rows, chunk_ids, tile_rows, s == 1);
  }
  if (s != 1) {
    const unsigned pgrid = static_cast<unsigned>((static_cast<long>(b) * e + rt::kThreads - 1) /
                                                 rt::kThreads);
    pool_kernel<<<pgrid, rt::kThreads, 0, st>>>(idx, scratch, out, m, b, s, e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (m, E), idx (B, s) int32 -> out (B, E) f32.  The schedule
// (kernels/embedding_ub.py::ub_schedule): n_ranges ranges of range_rows
// rows, n_chunks chunks of chunk_ids ids, tiles of tile_rows <= range_rows
// rows (a range holds at most 64 tiles).  With s != 1, scratch is (B * s, E) f32; with
// s == 1 it is not read.  Returns cudaGetLastError().
extern "C" int rt_embedding_bag_ub(const void* table, const int* idx, float* out, float* scratch,
                                   int m, int b, int s, int e, int tile_rows, int range_rows,
                                   int n_ranges, int chunk_ids, int n_chunks, int dtype,
                                   void* stream) {
  if (static_cast<long>(b) * e == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_DTYPE(dtype, return launch<T>(static_cast<const T*>(table), idx, out, scratch, m, b,
                                            s, e, tile_rows, range_rows, n_ranges, chunk_ids,
                                            n_chunks, st));
  return 0;
}
