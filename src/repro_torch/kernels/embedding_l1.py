"""L1 strategy: row gather from a table held in on-chip memory.

Paper §II-B: the table is preloaded once into the core's fast scratchpad
and every lookup is served from on-chip memory.  On the card that memory is
one CTA's shared memory or, for a larger table, a thread-block cluster's
distributed shared memory.  :func:`l1_schedule` picks one of three modes
per launch (``csrc/embedding_l1.cu`` says what bounds each):

* ``resident``: the table fits :data:`RESIDENT_BYTES`; every CTA holds it;
* ``cluster``: it fits ``C`` CTAs of at most :data:`RESIDENT_BYTES` each,
  ``C`` in :data:`CLUSTER_SIZES`; each cluster holds it once, a slice per
  CTA, and reads rows from the CTA that holds them;
* ``beyond``: no cluster the card schedules holds it; the row-range UB
  kernel (:mod:`repro_torch.kernels.embedding_ub`) serves the launch.

``embedding_bag_l1.modes`` counts the launches of each mode.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import build, embedding_ub
from repro_torch.kernels.ref import bag_f32

__all__ = ["L1Schedule", "embedding_bag_l1", "embedding_bag_l1_plain", "l1_schedule"]

THREADS = 256  # threads per CTA (resident; the cluster mode up to CLUSTER_THREADS)
CLUSTER_THREADS = 1024
SM_SHARED_BYTES = 228 * 1024  # shared memory of one SM
SM_THREADS = 2048  # threads one SM holds
CTA_RESERVED_BYTES = 1024  # shared memory the runtime keeps per CTA
CTA_MAX_BYTES = 226 * 1024  # dynamic shared memory a CTA can take beside its barrier
# dynamic shared memory one CTA's table (resident) or slice (cluster) may
# take, of the 227 KB a CTA can hold on Hopper
RESIDENT_BYTES = 200 * 1024
# the slice a cluster's CTA holds where a cluster of up to 16 allows: a CTA
# stages its slice through one SM's port, so a launch's time grows with the
# slice more than with the number of clusters (chip_smoke.py's l1_sweep)
CLUSTER_BYTES = 64 * 1024
# a 2-CTA cluster of CLUSTER_BYTES slices would hold a resident table
CLUSTER_SIZES = (4, 8, 16)
PORTABLE_CLUSTER = 8  # larger clusters need the card's non-portable opt-in
UB_BLOCK_M = 512  # the beyond mode's UB launch (ops.strategy_bag's GM-UB default)

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ACTIVE_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]


class L1Schedule(NamedTuple):
    """One launch: ``grid`` CTAs of ``threads`` threads in clusters of
    ``cluster`` (1: resident), each holding ``rows_per_cta`` rows in
    ``smem`` bytes of shared memory (CTA rank ``k`` of a cluster rows
    ``[k R, (k + 1) R)``).  ``beyond`` launches ``ub``'s UB grid instead
    (``cluster`` 0, ``rows_per_cta`` its range rows)."""

    mode: str
    cluster: int
    rows_per_cta: int
    grid: int
    smem: int
    threads: int = THREADS
    ub: embedding_ub.UbSchedule | None = None


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def ctas_per_sm(smem: int, threads: int = THREADS) -> int:
    """CTAs of ``threads`` threads and ``smem`` bytes of dynamic shared
    memory one SM holds."""
    return min(SM_THREADS // threads, SM_SHARED_BYTES // (smem + CTA_RESERVED_BYTES))


def cluster_threads(b: int, row_bytes: int, cluster: int) -> int:
    """Threads a CTA of the cluster mode: :data:`CLUSTER_THREADS` where the
    batch fills one cluster of such CTAs (fewer clusters stage the table
    fewer times), else :data:`THREADS`."""
    items = b * _ceil(row_bytes, 16)
    return CLUSTER_THREADS if items >= cluster * CLUSTER_THREADS else THREADS


def cluster_schedule(m: int, row_bytes: int, b: int, cluster: int, active: int,
                     threads: int) -> L1Schedule:
    """The cluster mode at ``cluster`` CTAs of ``threads`` threads per
    cluster, ``active`` clusters of which the card holds at once: as many
    clusters as give each (query, 16-byte vector) of the batch its own
    thread, at most ``active``."""
    rows = _ceil(m, cluster)
    want = _ceil(b * _ceil(row_bytes, 16), threads * cluster)
    return L1Schedule("cluster", cluster, rows, cluster * max(1, min(active, want)),
                      rows * row_bytes, threads)


@functools.lru_cache(maxsize=256)
def l1_schedule(
    m: int, row_bytes: int, b: int, s: int, n_sms: int,
    *, active_clusters: Callable[[int, int, int], int] | None = None,
) -> L1Schedule:
    """The mode and grid of one launch over an ``m``-row table of
    ``row_bytes``-byte rows and a (``b``, ``s``) batch on ``n_sms`` SMs.

    A table of at most :data:`RESIDENT_BYTES` is resident, in as many CTAs
    as give each (query, 16-byte vector) its own thread, at most as many as
    the SMs hold at once.  Otherwise it takes the smallest cluster size
    whose slice fits :data:`CLUSTER_BYTES` or, where none does, the largest
    size the card schedules whose slice fits :data:`RESIDENT_BYTES`, with
    ``active_clusters(C, smem, threads)`` the clusters the card holds at
    once (``cudaOccupancyMaxActiveClusters`` on the card; by default a model
    of ``n_sms`` SMs that ignores how clusters pack into the card's GPCs).
    A portable size the card cannot schedule raises; a non-portable size
    (16) it cannot schedule is passed over; a table no cluster holds goes
    beyond: to the UB kernel's grid."""
    if active_clusters is None:
        def active_clusters(c: int, smem: int, threads: int) -> int:
            return n_sms * ctas_per_sm(smem, threads) // c
    table_bytes = m * row_bytes
    if table_bytes <= RESIDENT_BYTES:
        want = _ceil(b * _ceil(row_bytes, 16), THREADS)
        grid = max(1, min(want, n_sms * ctas_per_sm(table_bytes)))
        return L1Schedule("resident", 1, m, grid, table_bytes)
    fits = [c for c in CLUSTER_SIZES if _ceil(m, c) * row_bytes <= RESIDENT_BYTES]
    small = [c for c in fits if _ceil(m, c) * row_bytes <= CLUSTER_BYTES]
    for c in small[:1] + fits[::-1]:
        smem = _ceil(m, c) * row_bytes
        threads = cluster_threads(b, row_bytes, c)
        active = active_clusters(c, smem, threads)
        if active >= 1:
            return cluster_schedule(m, row_bytes, b, c, active, threads)
        if c <= PORTABLE_CLUSTER:
            raise RuntimeError(
                f"embedding_bag_l1: a cluster of {c} CTAs with {smem} bytes of shared "
                "memory each cannot be scheduled on this card")
    ub = embedding_ub.ub_schedule(m, b * s, row_bytes, block_m=UB_BLOCK_M, persistent=False,
                                  n_sms=n_sms)
    return L1Schedule("beyond", 0, ub.range_rows, ub.n_ranges * ub.n_chunks, 0, ub=ub)


@functools.lru_cache(maxsize=None)
def card_clusters(device_index: int, dtype_code: int) -> Callable[[int, int, int], int]:
    """``active_clusters`` for one card and table type, each answer asked
    of the card once."""
    fn = build.c_function("embedding_l1", "rt_l1_active_clusters", _ACTIVE_ARGS)

    @functools.lru_cache(maxsize=None)
    def active(cluster: int, smem: int, threads: int) -> int:
        n = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            rc = fn(cluster, smem, threads, dtype_code, ctypes.byref(n))
        build.check_launch(rc, f"embedding_bag_l1 cluster occupancy ({cluster} CTAs, {smem} B)")
        return n.value

    return active


def schedule_for(table: torch.Tensor, indices: torch.Tensor) -> L1Schedule:
    """The schedule the wrapper launches for these CUDA tensors."""
    m, e = table.shape
    b, s = indices.shape
    return l1_schedule(m, e * table.element_size(), b, s, build.sm_count(table.device),
                       active_clusters=card_clusters(table.device.index,
                                                      build.dtype_code(table.dtype)))


def launch(table: torch.Tensor, indices: torch.Tensor, sched: L1Schedule) -> torch.Tensor:
    """One launch of the L1 kernel (resident or cluster mode) on CUDA
    tensors under ``sched``, without counting it."""
    m, e = table.shape
    b, s = indices.shape
    out = torch.empty((b, e), dtype=torch.float32, device=table.device)
    fn = build.c_function("embedding_l1", "rt_embedding_bag_l1", _ARGS)
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), indices.data_ptr(), out.data_ptr(), m, b, s, e,
                sched.cluster, sched.rows_per_cta, sched.grid, sched.threads,
                build.dtype_code(table.dtype), build.stream_of(table.device))
    build.check_launch(rc, f"embedding_bag_l1 ({sched.mode}, {sched.cluster} CTAs a cluster)")
    return out


def embedding_bag_l1_plain(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: (m, E), (B, s) -> (B, E) f32."""
    return bag_f32(table, indices)


def embedding_bag_l1(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """L1-strategy pooled lookup. table (m, E), indices (B, s) int32 ->
    (B, E) f32; ids outside ``[0, m)`` contribute zero.  CPU tensors run the
    plain version, CUDA tensors the kernel in the mode :func:`l1_schedule`
    picks."""
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError("table must be (m, E) and indices (B, s)")
    if build.route(table, indices) == "cpu":
        return embedding_bag_l1_plain(table, indices)
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("table and indices must be contiguous")
    sched = schedule_for(table, indices)
    if sched.mode == "beyond":
        out = embedding_ub.launch(table, indices, sched.ub)
    else:
        out = launch(table, indices, sched)
    embedding_bag_l1.launches += 1
    embedding_bag_l1.modes[sched.mode] += 1
    return out


embedding_bag_l1.launches = 0
embedding_bag_l1.modes = {"resident": 0, "cluster": 0, "beyond": 0}
