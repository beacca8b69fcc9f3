"""Fused multi-slot pooled lookup over the ragged packed buffer.

:func:`multi_embedding_bag_ragged` computes every slot's pooled lookup of
every core in one launch, driven by the pack-time step schedule
(``step_slot``/``step_base``/``step_block``/``step_strategy``, see
:func:`repro_torch.core.partition.pack_plan`): a slot's chunk occupies
consecutive ``block_r``-row blocks of its core's buffer, id ``l`` of the
slot lives at row ``step_block[t] * block_r + l % block_r`` of step
``t = first + l // block_r``, and ``-1`` or out-of-window ids contribute
exactly zero.  Steps on the trash slot ``S`` are schedule padding.

Base mode (no access reduction): ``csrc/embedding_multi.cu``, which reads
the schedule as per-slot *runs* (:func:`ragged_runs`), computed once at pack
time and stored on the device with the kernel's staging capacity
(:func:`ragged_stage_rows`).  One launch writes every output element (slots
without a run as zero); a group of threads owns a query, each thread one
16-byte vector of a few queries (:func:`_queries`; the scalar kernel where
:func:`_vector_ok` refuses; launches by path in
``multi_embedding_bag_ragged.paths``).

Access-reduction modes (the reference's ``unique_cap``/``cache``/
``step_kpath`` branches): ``csrc/embedding_access.cu``.

The legacy dense stacked-slot layout has its own kernel,
:func:`multi_embedding_bag_dense` (``csrc/embedding_dense.cu``): every slot
padded to the same ``R+1`` rows, ids pre-clipped to ``[0, R]`` with row
``R`` zero, no schedule.

* **batch dedup** (``unique_cap > 0``): :func:`batch_dedup` unique-izes
  each slot's ids (``csrc/embedding_dedup.cu``: a presence bitmap and
  popcount ranks, one CTA per slot; its plain version :func:`dedup_indices`
  sorts, and :func:`dedup_indices_bitmap` repeats the kernel's arithmetic
  in plain torch); a first pass gathers every unique row once per batch into
  ``rows_u (K, S, U, E)`` f32, and a second pass sums ``rows_u[rank]`` back
  into batch rows.  Ids past the cap spill and are read row by row.  Where
  the reference carries the dense multiplicity matrix ``cnt (S, B, U)``,
  the port carries each lookup's ``rank (S, B, s)`` (``-1`` for none):
  :func:`cnt_from_rank` rebuilds ``cnt`` for comparisons;
* **gather path** (``step_kpath``, dedup only): the reference's per-step
  choice between a one-hot GEMM over the step's window (``0``) and a sparse
  gather of the in-window unique rows (``1``).  On the card both run the
  same unique-row gather (:func:`gather_unique_rows`: one thread group per
  unique entry copies its buffer row), so ``rows_u`` and the output are
  bitwise equal either way; the wrapper still validates ``step_kpath`` and
  counts it (``modes["sparse"]``);
* **residency cache** (``cache (K, C, E)`` + ``hidx (K, S, B, s)``): hot
  lookups (``hidx >= 0``, already ``-1`` in ``lidx``) are summed from the
  core's resident mini-table once per slot.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = [
    "DEDUP_WINDOW_BITS",
    "batch_dedup",
    "cnt_from_rank",
    "dedup_indices",
    "dedup_indices_bitmap",
    "gather_unique_rows",
    "gather_unique_rows_plain",
    "multi_embedding_bag_dense",
    "multi_embedding_bag_dense_plain",
    "multi_embedding_bag_ragged",
    "multi_embedding_bag_ragged_plain",
    "ragged_block_b",
    "ragged_runs",
    "ragged_stage_rows",
    "scatter_queries",
]

# the reference's on-chip budget (bytes) for its batch chunking; kept so
# ragged_block_b returns the JAX package's values
_VMEM_BUDGET = 8 * 1024 * 1024
# shared memory (bytes) a CTA may use to stage an L1-coded slot's windows:
# every CTA of the launch reserves it, and 4 CTAs of 256 threads an SM (the
# kernel's register limit) need at most 56 KB each (csrc/embedding_multi.cu)
STAGE_BYTES = 48 * 1024
_MAX_RUNS = 65535  # grid.y limit

_ARGS = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_GATHER_ARGS = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
_ACCESS_ARGS = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
_DEDUP_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
# the dedup kernel's bitmap window, in ids: 160 KB of bits plus 20 KB of
# group ranks in shared memory; past taobao's largest chunk (1,141,730 rows),
# so a served slot takes one window
DEDUP_WINDOW_BITS = 40 * 32768
_GROUP_WORDS = 8  # bitmap words per rank group (csrc/embedding_dedup.cu)
_DENSE_ARGS = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# shared memory (bytes) for the resident cache in the scatter pass (a larger
# cache is read from L2)
CACHE_STAGE_BYTES = 64 * 1024
# queries a thread of a vector kernel may own: the access scatter
# (csrc/embedding_access.cu), the fused base kernel and the dense kernel
SCATTER_QUERIES = (1, 2, 4, 8)
_THREADS = 256  # rt::kThreads
_CTAS_PER_SM = 8  # 256-thread CTAs that fill an SM's 2,048 threads
# CTAs of the base and dense kernels an SM holds at once (the base kernel's
# register limit, 64 a thread): their grids aim at one such wave, not 8 CTAs
# an SM, which the card measured slower (PERF.md §6, queries_sweep)
_BASE_CTAS_PER_SM = 4


def _align8(n: int) -> int:
    return int(-(-n // 8) * 8)


def ragged_block_b(
    b: int,
    seq: int,
    e: int,
    block_r: int,
    *,
    block_b: int | None = None,
    vmem_budget: int = _VMEM_BUDGET,
    unique_cap: int = 0,
    cache_rows: int = 0,
) -> tuple[int, int]:
    """The reference's resident batch-tile rows and batch chunk count.

    A TPU concern (how much of the batch fits VMEM beside one window); the
    GPU grid tiles the batch itself, so the kernel does not read it.  The
    traffic model (:func:`repro_torch.core.traffic.modeled_hbm_traffic`)
    prices the fused path with it, as the reference's does, so the modeled
    figures equal the reference's; a test holds it to the reference.
    """
    if block_b is None:
        per_row = 4 * (
            seq * (2 if cache_rows else 1)
            + 2 * e + block_r + unique_cap + cache_rows
        )
        fixed = 2 * block_r * e * 4 + cache_rows * e * 4 + unique_cap * 4
        fit = (vmem_budget - fixed) // max(per_row, 1)
        block_b = max(8, (int(fit) // 8) * 8)
    block_b = min(block_b, _align8(b))
    block_b = max(8, (block_b // 8) * 8)
    n_chunks = -(-b // block_b)
    return block_b, n_chunks


def ragged_runs(step_slot, step_base, step_strategy, block_r: int, n_slots: int) -> np.ndarray:
    """Collapse a (K, n_steps) schedule into runs: ``(n_runs, 5)`` int32 rows
    of ``(core, slot, first_step, n_steps, strategy code)``, one per slot
    that has steps.  Trash-slot (``n_slots``) padding steps form no run.
    Raises when a slot's steps are not consecutive or its bases are not
    ``0, block_r, 2*block_r, ...`` — the layout :func:`pack_plan` emits."""
    step_slot = np.atleast_2d(np.asarray(step_slot))
    step_base = np.asarray(step_base).reshape(step_slot.shape)
    step_strategy = np.asarray(step_strategy).reshape(step_slot.shape)
    runs = []
    for core in range(step_slot.shape[0]):
        seen = set()
        t = 0
        n = step_slot.shape[1]
        while t < n:
            slot = int(step_slot[core, t])
            first = t
            while t < n and step_slot[core, t] == slot:
                t += 1
            if slot == n_slots:
                continue
            if slot in seen:
                raise ValueError(f"core {core}: steps of slot {slot} are not consecutive")
            seen.add(slot)
            bases = step_base[core, first:t]
            if not np.array_equal(bases, np.arange(t - first) * block_r):
                raise ValueError(f"core {core}: slot {slot} bases are not block_r steps")
            runs.append((core, slot, first, t - first, int(step_strategy[core, first])))
    return np.asarray(runs, np.int32).reshape(-1, 5)


def ragged_stage_rows(runs, block_r: int, row_bytes: int) -> int:
    """Shared-memory rows the kernel stages L1-coded regions into: the
    largest L1/L1-UB run region of ``runs`` that fits :data:`STAGE_BYTES`
    at ``row_bytes`` per row, or 0 (stage nothing)."""
    staged = [
        n * block_r for _c, _s, _f, n, code in np.asarray(runs).tolist()
        if code in (2, 3) and n * block_r * row_bytes <= STAGE_BYTES
    ]
    return max(staged, default=0)


def dedup_indices(lidx: torch.Tensor, unique_cap: int):
    """Batch-prep unique-ization of chunk-local ids, per slot.

    ``lidx (..., B, s)`` int -> ``(uniq, rank, spill)``: over each slot's
    ``B * s`` positions, ``uniq (..., U)`` holds the first ``unique_cap``
    distinct ids in ascending order (``-1`` padding), ``rank (..., B, s)``
    each lookup's position in ``uniq`` (``-1`` for padding ids and for ids
    past the cap), and ``spill (..., B, s)`` the ids past the cap (``-1``
    elsewhere).  ``-1`` ids never enter the unique set; every lookup lands in
    exactly one of ``rank``/``spill``.  ``uniq`` and ``spill`` equal the
    reference's ``_dedup_indices``; ``cnt_from_rank(rank)`` its ``cnt``.
    The plain version of :func:`batch_dedup`'s kernel, and the CPU route;
    runs on the ids' device (a sort and a scan per slot).
    """
    if unique_cap <= 0:
        raise ValueError(f"unique_cap must be positive, got {unique_cap}")
    *lead, b, s = lidx.shape
    flat = lidx.reshape(-1, b * s).to(torch.int32)
    big = torch.iinfo(torch.int32).max
    key = torch.where(flat < 0, big, flat)
    sv, order = torch.sort(key, dim=1, stable=True)
    valid = sv < big
    first = valid.clone()
    first[:, 1:] &= sv[:, 1:] != sv[:, :-1]
    rank_sorted = torch.cumsum(first, dim=1, dtype=torch.int32) - 1
    rank_sorted = torch.where(valid, rank_sorted, unique_cap)
    in_cap = first & (rank_sorted < unique_cap)
    uniq = torch.full((flat.shape[0], unique_cap + 1), -1, dtype=torch.int32,
                      device=lidx.device)
    # every first occurrence below the cap writes its value once; everything
    # else lands on the dropped trash entry U with -1
    uniq.scatter_(1, torch.where(in_cap, rank_sorted, unique_cap).long(),
                  torch.where(in_cap, sv, -1))
    pos_rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    rank = torch.where(pos_rank < unique_cap, pos_rank, -1)
    spill = torch.where((pos_rank >= unique_cap) & (flat >= 0), flat, -1)
    return (uniq[:, :unique_cap].contiguous().reshape(*lead, unique_cap),
            rank.reshape(*lead, b, s), spill.reshape(*lead, b, s))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def dedup_indices_bitmap(lidx: torch.Tensor, unique_cap: int, *,
                         window_bits: int = DEDUP_WINDOW_BITS):
    """The dedup kernel's arithmetic in plain torch, slot by slot: a
    presence bitmap of 32-bit words over a window of at most ``window_bits``
    ids, set-bit counts per 8-word group scanned into group ranks, and each
    id's rank as the set bits below it; a slot whose ids span more than one
    window moves on to the smallest id past the last one.  Same results as
    :func:`dedup_indices` (the tests hold the two, and the reference, equal)."""
    if unique_cap <= 0:
        raise ValueError(f"unique_cap must be positive, got {unique_cap}")
    if window_bits <= 0 or window_bits % (32 * _GROUP_WORDS):
        raise ValueError(f"window_bits must be a positive multiple of 256, got {window_bits}")
    *lead, b, s = lidx.shape
    flat = lidx.reshape(-1, b * s).to(torch.int32).long()
    dev = flat.device
    uniq = torch.full((flat.shape[0], unique_cap), -1, dtype=torch.long, device=dev)
    rank = torch.full_like(flat, -1)
    spill = torch.full_like(flat, -1)
    bit = torch.arange(32, device=dev)
    big = torch.iinfo(torch.int32).max  # sorted with the padding by the plain op, and spilled
    for row, ids in enumerate(flat):
        valid = (ids >= 0) & (ids != big)
        spill[row, ids == big] = big
        if not bool(valid.any()):
            continue
        lo, hi = int(ids[valid].min()), int(ids[valid].max())
        base = 0
        while True:
            span = min(window_bits, -(-(hi - lo + 1) // 256) * 256)
            inw = valid & (ids >= lo) & (ids < lo + span)
            d = ids[inw] - lo
            present = torch.zeros(span, dtype=torch.bool, device=dev)
            present[d] = True
            words = (present.view(-1, 32).long() << bit).sum(dim=1)
            counts = _popcount32(words).view(-1, _GROUP_WORDS)
            group_rank = torch.cumsum(counts.sum(dim=1), 0) - counts.sum(dim=1)
            word_rank = (torch.cumsum(counts, dim=1) - counts).reshape(-1)
            w = d >> 5
            r = (base + group_rank[w // _GROUP_WORDS] + word_rank[w]
                 + _popcount32(words[w] & ((1 << (d & 31)) - 1)))
            pos = inw.nonzero().squeeze(1)
            rank[row, pos] = torch.where(r < unique_cap, r, -1)
            spill[row, pos] = torch.where(r < unique_cap, -1, ids[pos])
            set_bits = present.nonzero().squeeze(1)
            ur = base + torch.arange(len(set_bits), device=dev)
            keep = ur < unique_cap
            uniq[row, ur[keep]] = lo + set_bits[keep]
            base += int(counts.sum())
            if lo + span > hi:
                break
            lo = int(ids[valid & (ids >= lo + span)].min())
    return (uniq.to(torch.int32).reshape(*lead, unique_cap),
            rank.to(torch.int32).reshape(*lead, b, s), spill.to(torch.int32).reshape(*lead, b, s))


def batch_dedup(lidx: torch.Tensor, unique_cap: int):
    """:func:`dedup_indices` through the dedup kernel: the same
    ``(uniq, rank, spill)``, array-equal.  CPU tensors run the plain version,
    CUDA tensors the kernel (``csrc/embedding_dedup.cu``, one launch, a
    bitmap window of :data:`DEDUP_WINDOW_BITS` ids)."""
    if unique_cap <= 0:
        raise ValueError(f"unique_cap must be positive, got {unique_cap}")
    if build.route(lidx) == "cpu":
        return dedup_indices(lidx, unique_cap)
    with torch.cuda.device(lidx.device):
        return _launch_dedup(lidx.to(torch.int32).contiguous(), unique_cap,
                             build.stream_of(lidx.device))


def _launch_dedup(lidx, unique_cap, stream):
    """The dedup kernel on contiguous int32 ids, on the current device."""
    *lead, b, s = lidx.shape
    n_rows = lidx.numel() // max(b * s, 1)
    uniq = torch.empty((*lead, unique_cap), dtype=torch.int32, device=lidx.device)
    rank = torch.empty_like(lidx)
    spill = torch.empty_like(lidx)
    if n_rows:
        fn = build.c_function("embedding_dedup", "rt_dedup_indices", _DEDUP_ARGS)
        rc = fn(lidx.data_ptr(), n_rows, b * s, unique_cap, DEDUP_WINDOW_BITS, uniq.data_ptr(),
                rank.data_ptr(), spill.data_ptr(), stream)
        build.check_launch(rc, "batch_dedup")
        batch_dedup.launches += 1
    return uniq, rank, spill


batch_dedup.launches = 0


def cnt_from_rank(rank: torch.Tensor, unique_cap: int) -> torch.Tensor:
    """The reference's multiplicity matrix from the port's ranks:
    ``rank (..., B, s)`` -> ``cnt (..., B, U)`` f32, ``cnt[b, u]`` the number
    of the row's lookups of ``uniq[u]``.  For comparisons only: the kernel
    never builds it (at batch 8192 and U = 1856 it would be 61 MB per slot)."""
    hit = rank >= 0
    onehot = torch.nn.functional.one_hot(torch.where(hit, rank, 0).long(), unique_cap)
    return (onehot * hit[..., None]).sum(dim=-2).float()


def _batched(buffer, lidx, step_block, *per_core):
    """Accept the reference's one-core shapes or the port's all-core ones:
    ``per_core`` are further (S, B, s)/(n_steps,) tensors (or None) that
    gain the core axis with ``lidx``."""
    if buffer.dim() == 2:
        return (True, buffer[None], lidx[None], step_block[None],
                *(None if t is None else t[None] for t in per_core))
    return (False, buffer, lidx, step_block, *per_core)


def _window_rows(ids, blocks, first, n, block_r):
    """Chunk-local ids of one run -> (valid, buffer rows)."""
    valid = (ids >= 0) & (ids < n * block_r)
    local = torch.where(valid, ids, 0)
    return valid, blocks[first + local // block_r] * block_r + local % block_r


def gather_unique_rows_plain(buffer, uniq, step_block, runs, *, block_r: int) -> torch.Tensor:
    """The dedup gather in plain torch: buffer (K, T, E), uniq (K, S, U) ->
    rows_u (K, S, U, E) f32, each in-window unique id's row copied once
    (zero for padding, out-of-window ids and slots without a run).  The
    gather kernel computes exactly this, whatever the steps' gather path."""
    k, s_slots, u = uniq.shape
    rows_u = torch.zeros((k, s_slots, u, buffer.shape[-1]), dtype=torch.float32,
                         device=buffer.device)
    blocks = step_block.long()
    for core, slot, first, n, _code in runs.tolist():
        valid, rows = _window_rows(uniq[core, slot].long(), blocks[core], first, n, block_r)
        rows_u[core, slot] = torch.where(valid[:, None], buffer[core][rows].float(), 0.0)
    return rows_u


def gather_unique_rows(buffer, uniq, step_block, runs, *, block_r: int) -> torch.Tensor:
    """:func:`gather_unique_rows_plain` through the gather kernel
    (``csrc/embedding_access.cu``): the same ``rows_u (K, S, U, E)`` f32,
    array-equal.  CPU tensors run the plain version, CUDA tensors the kernel
    (one launch; 16-byte vectors where :func:`_vector_ok` allows, else the
    scalar kernel, counted in ``gather_unique_rows.paths``)."""
    if build.route(buffer, uniq, step_block, runs) == "cpu":
        return gather_unique_rows_plain(buffer, uniq, step_block, runs, block_r=block_r)
    if buffer.dim() != 3 or uniq.dim() != 3 or uniq.shape[0] != buffer.shape[0]:
        raise ValueError(f"buffer (K, T, E) and uniq (K, S, U), got {tuple(buffer.shape)} "
                         f"and {tuple(uniq.shape)}")
    if buffer.stride(2) != 1 or buffer.stride(1) != buffer.shape[2]:
        raise ValueError("buffer rows must be contiguous")
    _check_ids(uniq, step_block, runs)
    if buffer.shape[0] * uniq.shape[1] > _MAX_RUNS:
        raise ValueError(f"{buffer.shape[0] * uniq.shape[1]} slots exceed the grid limit "
                         f"{_MAX_RUNS}")
    with torch.cuda.device(buffer.device):
        rows_u, path = _launch_gather(buffer, uniq, step_block, runs, block_r,
                                      build.stream_of(buffer.device))
    gather_unique_rows.launches += 1
    gather_unique_rows.paths[path] += 1
    return rows_u


gather_unique_rows.launches = 0
gather_unique_rows.paths = {"vector": 0, "scalar": 0}


def _vector_ok(buffer, *more) -> bool:
    """Whether the access kernels may move 16-byte vectors: a row of the
    buffer is a whole number of them, at most one per thread of a CTA, and
    every tensor's rows start 16-byte aligned (its base and, for the
    buffer, its core stride)."""
    item = buffer.element_size()
    row_bytes = buffer.shape[-1] * item
    return (row_bytes % 16 == 0 and row_bytes <= 16 * _THREADS
            and (buffer.stride(0) * item) % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (buffer, *more) if t is not None))


def scatter_queries(b: int, e: int, itemsize: int, n_slots: int, n_sms: int, *,
                    ctas_per_sm: int = _CTAS_PER_SM) -> int:
    """Queries each thread of a vector kernel owns: the largest of
    :data:`SCATTER_QUERIES` whose grid (query tiles x ``n_slots``) still
    offers every SM ``ctas_per_sm`` CTAs, else 1.  More queries a thread
    find the run (and stage the cache) once for more queries and keep more
    row loads in flight a thread; too few CTAs leave SMs idle.  The access
    scatter aims at 8 CTAs an SM (path D in f32: 4 queries a thread), the
    base and dense kernels at :data:`_BASE_CTAS_PER_SM` (paths A, C and E:
    2 in f32, 1 in bf16/f16), each the fastest count there (PERF.md §6)."""
    group = max(e * itemsize // 16, 1)
    per_pass = max(_THREADS // group, 1)
    for q in sorted(SCATTER_QUERIES, reverse=True):
        if -(-b // (per_pass * q)) * n_slots >= ctas_per_sm * n_sms:
            return q
    return 1


def _launch_gather(buffer, uniq, step_block, runs, block_r, stream):
    """The gather kernel on the current device -> (rows_u, "vector" or "scalar")."""
    k, _, e = buffer.shape
    _, s_slots, u_cap = uniq.shape
    rows_u = torch.empty((k, s_slots, u_cap, e), dtype=torch.float32, device=buffer.device)
    path = "vector" if _vector_ok(buffer, rows_u) else "scalar"
    fn = build.c_function("embedding_access", "rt_ragged_gather", _GATHER_ARGS)
    rc = fn(buffer.data_ptr(), buffer.stride(0), uniq.data_ptr(), step_block.data_ptr(),
            step_block.shape[-1], runs.data_ptr(), runs.shape[0], k, s_slots, u_cap, e, block_r,
            rows_u.data_ptr(), int(path == "vector"), build.dtype_code(buffer.dtype), stream)
    build.check_launch(rc, "gather_unique_rows")
    return rows_u, path


def multi_embedding_bag_ragged_plain(
    buffer: torch.Tensor,
    lidx: torch.Tensor,
    step_block: torch.Tensor,
    runs: torch.Tensor,
    *,
    block_r: int,
    unique_cap: int = 0,
    cache: torch.Tensor | None = None,
    hidx: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel's function in plain torch over the run list:
    buffer (K, T, E), lidx (K, S, B, s) -> (K, S, B, E) f32.  With
    ``unique_cap`` it takes the dedup route the kernel takes (unique rows
    gathered once, scattered back by rank, spill read row by row); with
    ``cache``/``hidx`` it adds each slot's hot lookups from the cache.  The
    gather path (``step_kpath``) does not change the result.  Each query's
    positions are summed in id order from 0.0 in f32, one at a time (the
    buffer or unique-row term, then the hot term), as the kernels sum them,
    so the base kernel is bitwise equal to it at every ``s``."""
    k, s_slots, b, _ = lidx.shape
    e = buffer.shape[-1]
    out = torch.zeros((k, s_slots, b, e), dtype=torch.float32, device=buffer.device)
    blocks = step_block.long()
    rows_u = rank = None
    if unique_cap:
        uniq, rank, lidx = dedup_indices(lidx, unique_cap)
        rows_u = gather_unique_rows_plain(buffer, uniq, step_block, runs, block_r=block_r)
    for core, slot, first, n, _code in runs.tolist():
        valid, rows = _window_rows(lidx[core, slot].long(), blocks[core], first, n, block_r)
        g = torch.where(valid[..., None], buffer[core][rows].float(), 0.0)  # (B, s, E)
        if rows_u is not None:  # a lookup has a rank or a spilled id, never both
            r = rank[core, slot].long()
            g = g + torch.where((r >= 0)[..., None], rows_u[core, slot][r.clamp(min=0)], 0.0)
        hot = None
        if cache is not None:
            h = hidx[core, slot].long()
            hit = (h >= 0) & (h < cache.shape[1])
            hot = torch.where(hit[..., None], cache[core][torch.where(hit, h, 0)].float(), 0.0)
        acc = out[core, slot]
        for j in range(g.shape[1]):
            acc = acc + g[:, j]
            if hot is not None:
                acc = acc + hot[:, j]
        out[core, slot] = acc
    return out


def multi_embedding_bag_ragged(
    buffer: torch.Tensor,  # (T, E) or (K, T, E), T % block_r == 0
    lidx: torch.Tensor,  # (S, B, s) or (K, S, B, s) int32 chunk-local ids
    step_block: torch.Tensor,  # (n_steps,) or (K, n_steps) row-block index into the buffer
    runs: torch.Tensor,  # (n_runs, 5) int32 ragged_runs of the schedule
    *,
    block_r: int,
    stage_rows: int = 0,
    unique_cap: int = 0,  # > 0 arms batch dedup (static cap per slot)
    cache: torch.Tensor | None = None,  # (C, E) or (K, C, E) resident hot rows
    hidx: torch.Tensor | None = None,  # like lidx: cache positions, -1 miss
    step_kpath: torch.Tensor | None = None,  # like step_block: 0 onehot, 1 sparse
    step_slot: torch.Tensor | None = None,  # like step_block; needed by dedup
    step_base: torch.Tensor | None = None,  # like step_block; needed by dedup
) -> torch.Tensor:
    """All slots' pooled lookups in one launch -> (S, B, E) or (K, S, B, E) f32.

    ``runs`` lies on the buffer's device (pack time stores it there, so a
    launch copies nothing from the host).  ``stage_rows`` is
    :func:`ragged_stage_rows` of the runs, the base kernel's shared-memory
    window capacity; 0 gathers every region from device memory.  The
    buffer's rows must be contiguous; its core stride may be anything (a
    ``[:, :-1]`` view of the packed ``(K, T+1, E)`` buffer works without a
    copy).  ``unique_cap``/``cache``+``hidx``/``step_kpath`` arm the access
    reduction with the reference's meaning (module docstring): callers have
    already set ``lidx`` to ``-1`` wherever ``hidx >= 0``, and ``step_kpath``
    needs ``unique_cap > 0``.  CPU tensors run the plain version, CUDA
    tensors the kernel.
    """
    if step_kpath is not None and not unique_cap:
        raise ValueError(
            "step_kpath (sparse kernel path) requires unique_cap > 0: the "
            "sparse gather rides the dedup uniq/cnt machinery"
        )
    if cache is not None and hidx is None:
        raise ValueError("cache requires the hidx hot-position tensor")
    if cache is not None and not cache.shape[-2]:
        cache = hidx = None  # a zero-row cache holds nothing
    single, buffer, lidx, step_block, cache, hidx, step_kpath, step_slot, step_base = _batched(
        buffer, lidx, step_block, cache, hidx, step_kpath, step_slot, step_base)
    if buffer.shape[1] % block_r:
        raise ValueError("buffer rows must be a multiple of block_r")
    if runs.dim() != 2 or runs.shape[1] != 5:
        raise ValueError(f"runs must be (n_runs, 5), got {tuple(runs.shape)}")
    if unique_cap and (step_slot is None or step_base is None):
        raise ValueError("batch dedup needs step_slot and step_base")
    extra = [t for t in (cache, hidx, step_kpath, step_slot, step_base) if t is not None]
    device = build.route(buffer, lidx, step_block, runs, *extra)
    if device == "cpu":
        out = multi_embedding_bag_ragged_plain(
            buffer, lidx, step_block, runs, block_r=block_r, unique_cap=unique_cap,
            cache=cache, hidx=hidx)
    elif unique_cap or cache is not None:
        out = _launch_access(buffer, lidx, step_block, runs, block_r, unique_cap,
                             cache, hidx, step_kpath, step_slot, step_base)
    else:
        out = _launch(buffer, lidx, step_block, runs, block_r, stage_rows)
    return out[0] if single else out


def _check_ids(lidx, step_block, runs, *more):
    if any(t.dtype != torch.int32 for t in (lidx, step_block, runs, *more)):
        raise TypeError("ids, schedule and runs must be int32")
    if not all(t.is_contiguous() for t in (lidx, step_block, runs, *more)):
        raise ValueError("ids, schedule and runs must be contiguous")
    if runs.shape[0] > _MAX_RUNS:
        raise ValueError(f"{runs.shape[0]} slot runs exceed the grid limit {_MAX_RUNS}")


def _queries(queries, vector: bool, b: int, e: int, itemsize: int, n_slots: int, device) -> int:
    """The base or dense kernel's queries a thread: ``queries`` when given
    (one of :data:`SCATTER_QUERIES`), else :func:`scatter_queries` at
    :data:`_BASE_CTAS_PER_SM`; 0 (the scalar kernel) where the data refuses
    16-byte vectors."""
    if queries is not None and queries not in SCATTER_QUERIES:
        raise ValueError(f"queries must be one of {SCATTER_QUERIES}, got {queries}")
    if not vector:
        return 0
    if queries is None:
        return scatter_queries(b, e, itemsize, n_slots, build.sm_count(device),
                               ctas_per_sm=_BASE_CTAS_PER_SM)
    return queries


def _launch(buffer, lidx, step_block, runs, block_r, stage_rows, *, queries=None):
    """The base kernel on CUDA tensors: one launch that writes every output
    element.  ``queries`` fixes the vector kernel's queries a thread
    (default :func:`_queries`); the scalar kernel runs where
    :func:`_vector_ok` refuses."""
    k, _, e = buffer.shape
    _, s_slots, b, seq = lidx.shape
    _check_ids(lidx, step_block, runs)
    if buffer.stride(2) != 1 or buffer.stride(1) != e:
        raise ValueError("buffer rows must be contiguous")
    if k * s_slots > _MAX_RUNS:
        raise ValueError(f"{k * s_slots} slots exceed the grid limit {_MAX_RUNS}")
    out = torch.empty((k, s_slots, b, e), dtype=torch.float32, device=buffer.device)  # all written
    q = _queries(queries, _vector_ok(buffer, out), b, e, buffer.element_size(), k * s_slots,
                 buffer.device)
    fn = build.c_function("embedding_multi", "rt_multi_embedding_bag_ragged", _ARGS)
    with torch.cuda.device(buffer.device):
        rc = fn(buffer.data_ptr(), buffer.stride(0), lidx.data_ptr(),
                step_block.data_ptr(), step_block.shape[-1], runs.data_ptr(),
                runs.shape[0], out.data_ptr(), k, s_slots, b, seq, e, block_r, stage_rows, q,
                build.dtype_code(buffer.dtype), build.stream_of(buffer.device))
    build.check_launch(rc, "multi_embedding_bag_ragged")
    multi_embedding_bag_ragged.launches += 1
    multi_embedding_bag_ragged.modes["base"] += 1
    multi_embedding_bag_ragged.paths["base_vector" if q else "base_scalar"] += 1
    return out


def _launch_access(buffer, lidx, step_block, runs, block_r, unique_cap, cache, hidx,
                   step_kpath, step_slot, step_base, *, queries=None):
    """Dedup and/or cache: (0) with dedup, the dedup kernel; (1) with dedup,
    the unique-row gather into ``rows_u``; (2) the scatter pass (ranks, spill
    or plain ids, hot fold).  At most three launches and no torch op.
    ``step_kpath``/``step_slot``/``step_base`` are validated only: on the
    card every step's gather is the same unique-row copy.  ``queries`` fixes
    the vector scatter's queries a thread (default :func:`scatter_queries`);
    the scalar kernels run where :func:`_vector_ok` refuses."""
    k, _, e = buffer.shape
    _, s_slots, b, seq = lidx.shape
    n_steps = step_block.shape[-1]
    if buffer.stride(2) != 1 or buffer.stride(1) != e:
        raise ValueError("buffer rows must be contiguous")
    per_step = [t for t in (step_kpath, step_slot, step_base) if t is not None]
    if any(t.shape != step_block.shape for t in per_step):
        raise ValueError("step_kpath, step_slot and step_base must be shaped like step_block")
    _check_ids(lidx, step_block, runs, *per_step)
    if k * s_slots > _MAX_RUNS:
        raise ValueError(f"{k * s_slots} slots exceed the grid limit {_MAX_RUNS}")
    if queries is not None and queries not in SCATTER_QUERIES:
        raise ValueError(f"queries must be one of {SCATTER_QUERIES}, got {queries}")
    cache_rows = 0
    if cache is not None:
        if cache.dtype != buffer.dtype:
            raise TypeError("cache must have the buffer's dtype")
        if hidx.shape != lidx.shape or cache.shape[0] != k or cache.shape[2] != e:
            raise ValueError("hidx must be shaped like lidx and cache (K, C, E)")
        _check_ids(hidx, step_block, runs)
        if not cache.is_contiguous():
            raise ValueError("cache must be contiguous")
        cache_rows = cache.shape[1]
    dev = buffer.device
    dtype = build.dtype_code(buffer.dtype)
    item = buffer.element_size()
    paths = multi_embedding_bag_ragged.paths
    with torch.cuda.device(dev):
        stream = build.stream_of(dev)
        rank = rows_u = None
        if unique_cap:
            uniq, rank, lidx = _launch_dedup(lidx, unique_cap, stream)
            rows_u, gather_path = _launch_gather(buffer, uniq, step_block, runs, block_r, stream)
            paths[f"gather_{gather_path}"] += 1
        stage_cache = int(cache_rows * e * item <= CACHE_STAGE_BYTES)
        out = torch.empty((k, s_slots, b, e), dtype=torch.float32, device=dev)  # all written
        if not _vector_ok(buffer, cache, rows_u):
            queries = 0  # the scalar kernel
        elif queries is None:
            queries = scatter_queries(b, e, item, k * s_slots, build.sm_count(dev))
        scatter = build.c_function("embedding_access", "rt_ragged_access", _ACCESS_ARGS)
        rc = scatter(buffer.data_ptr(), buffer.stride(0), lidx.data_ptr(),
                     rank.data_ptr() if rank is not None else None,
                     rows_u.data_ptr() if rows_u is not None else None,
                     hidx.data_ptr() if hidx is not None else None,
                     cache.data_ptr() if cache is not None else None, cache_rows,
                     step_block.data_ptr(), n_steps, runs.data_ptr(), runs.shape[0],
                     out.data_ptr(), k, s_slots, b, seq, e, block_r, unique_cap, stage_cache,
                     queries, dtype, stream)
        build.check_launch(rc, "multi_embedding_bag_ragged (access)")
    modes = multi_embedding_bag_ragged.modes
    multi_embedding_bag_ragged.launches += 1
    modes["dedup"] += bool(unique_cap)
    modes["cache"] += cache is not None
    modes["sparse"] += step_kpath is not None
    paths["scatter_vector" if queries else "scatter_scalar"] += 1
    return out


multi_embedding_bag_ragged.launches = 0
# launches by mode: "base" (no access reduction), "dedup", "cache", and
# "sparse" (given a step_kpath, which callers pass only with sparse steps)
multi_embedding_bag_ragged.modes = {"base": 0, "dedup": 0, "cache": 0, "sparse": 0}
# launches by the kernels' data path, 16-byte vectors or scalar: the base
# kernel, and the access modes' gather and scatter
multi_embedding_bag_ragged.paths = {"base_vector": 0, "base_scalar": 0,
                                    "gather_vector": 0, "gather_scalar": 0,
                                    "scatter_vector": 0, "scatter_scalar": 0}


# --------------------------------------------------------------------------
# dense stacked-slot layout (legacy, kept for layout comparisons)
# --------------------------------------------------------------------------


def _dense_batched(chunks, lidx):
    """The reference's one-core ``(S, R+1, E)``/``(S, B, s)`` shapes or the
    port's all-core ``(K, S, R+1, E)``/``(K, S, B, s)`` ones."""
    single = chunks.dim() == 3
    if single:
        chunks, lidx = chunks[None], lidx[None]
    if chunks.dim() != 4 or lidx.dim() != 4 or lidx.shape[:2] != chunks.shape[:2]:
        raise ValueError(
            f"chunks (S, R+1, E) or (K, S, R+1, E) and lidx (S, B, s) or (K, S, B, s) "
            f"with matching leading axes, got {tuple(chunks.shape)} and {tuple(lidx.shape)}")
    return single, chunks, lidx


def multi_embedding_bag_dense_plain(chunks: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """The dense kernel's function in plain torch: chunks (K, S, R+1, E),
    lidx (K, S, B, s) -> (K, S, B, E) f32, each query's ``s`` rows summed in
    position order from 0.0 in f32, as the reference's kernel does.  Ids
    must lie in ``[0, R]`` (callers pre-clip; an id outside raises)."""
    k, s_slots, rows, e = chunks.shape
    b, seq = lidx.shape[2:]
    if lidx.numel() and (int(lidx.min()) < 0 or int(lidx.max()) >= rows):
        raise IndexError(f"dense ids must lie in [0, {rows - 1}]")
    flat = chunks.reshape(k * s_slots, rows, e)
    ids = lidx.reshape(k * s_slots, b, seq).long()
    slot = torch.arange(k * s_slots, device=chunks.device)[:, None]
    acc = torch.zeros((k * s_slots, b, e), dtype=torch.float32, device=chunks.device)
    for j in range(seq):
        acc = acc + flat[slot, ids[:, :, j]].float()
    return acc.reshape(k, s_slots, b, e)


def multi_embedding_bag_dense(
    chunks: torch.Tensor,  # (S, R+1, E) or (K, S, R+1, E), trailing zero row
    lidx: torch.Tensor,  # (S, B, s) or (K, S, B, s) int32, pre-clipped to [0, R]
) -> torch.Tensor:
    """All slots' pooled lookups over the dense stacked-slot layout in one
    launch -> (S, B, E) or (K, S, B, E) f32.

    The CUDA grid tiles the batch itself, so there is no ``block_b``: the
    reference's batch tile is recorded by ``pack_plan`` in ``plan.meta``.
    CPU tensors run the plain version, CUDA tensors the kernel (16-byte
    vectors of :func:`_queries` queries a thread where
    :func:`_vector_ok` allows, else the scalar kernel; launches by path in
    ``multi_embedding_bag_dense.paths``), which gives zero for an id outside
    ``[0, R]`` where the plain version raises.
    """
    single, chunks, lidx = _dense_batched(chunks, lidx)
    if build.route(chunks, lidx) == "cpu":
        out = multi_embedding_bag_dense_plain(chunks, lidx)
    else:
        out = _launch_dense(chunks, lidx)
    return out[0] if single else out


def _launch_dense(chunks, lidx, *, queries=None):
    """The dense kernel on CUDA tensors; ``queries`` as for :func:`_launch`."""
    k, s_slots, rows, e = chunks.shape
    b, seq = lidx.shape[2:]
    if lidx.dtype != torch.int32:
        raise TypeError("ids must be int32")
    if not (chunks.is_contiguous() and lidx.is_contiguous()):
        raise ValueError("chunks and ids must be contiguous")
    if k * s_slots > _MAX_RUNS:
        raise ValueError(f"{k * s_slots} slots exceed the grid limit {_MAX_RUNS}")
    out = torch.empty((k, s_slots, b, e), dtype=torch.float32, device=chunks.device)
    if not out.numel():
        return out
    q = _queries(queries, _vector_ok(chunks, out), b, e, chunks.element_size(), k * s_slots,
                 chunks.device)
    fn = build.c_function("embedding_dense", "rt_multi_embedding_bag_dense", _DENSE_ARGS)
    with torch.cuda.device(chunks.device):
        rc = fn(chunks.data_ptr(), rows * e, lidx.data_ptr(), out.data_ptr(), k * s_slots,
                rows, b, seq, e, q, build.dtype_code(chunks.dtype),
                build.stream_of(chunks.device))
    build.check_launch(rc, "multi_embedding_bag_dense")
    multi_embedding_bag_dense.launches += 1
    multi_embedding_bag_dense.paths["vector" if q else "scalar"] += 1
    return out


multi_embedding_bag_dense.launches = 0
# launches by the kernel's data path: 16-byte vectors or scalar
multi_embedding_bag_dense.paths = {"vector": 0, "scalar": 0}
