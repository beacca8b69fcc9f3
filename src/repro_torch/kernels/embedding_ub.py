"""GM-UB / L1-UB strategies: conflict-free lookup whose device-memory
traffic does not depend on the id values.

Paper §II-B: "Performs vectorized look-up operations after moving the table
in chunks to the shared memory."  The CUDA kernel (``csrc/embedding_ub.cu``)
gives each CTA a range of the table's rows and a chunk of the batch's ids:
it lists the ids that hit its range, streams the range through shared memory
tile by tile and copies each hit row to its output position — the one-hot
count product of the TPU kernel without forming the count matrix, reading
every row of a large table once per launch.  GM-UB (``persistent=False``)
streams ``block_m``-row tiles; L1-UB (``persistent=True``) keeps a table that
fits :data:`RESIDENT_BYTES` as one resident tile, and is tiled like GM-UB
otherwise.  :func:`ub_schedule` sizes the grid.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bag_f32

__all__ = ["UbSchedule", "embedding_bag_ub", "embedding_bag_ub_plain", "ub_schedule"]

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]
CTAS_PER_SM = 2  # CTAs an SM holds at once (shared memory and registers)
TILE_BYTES = 8 * 1024  # one streamed tile; a CTA keeps a ring of four
RESIDENT_BYTES = 96 * 1024  # an L1-UB table up to this size is one resident tile
MIN_RANGE_ROWS = 128  # below this a range costs more in id reads than rows
MAX_TILES = 64  # tiles per range (csrc/embedding_ub.cu kMaxTiles)


class UbSchedule(NamedTuple):
    """One launch's grid: ``n_ranges`` contiguous ranges of ``range_rows``
    table rows times ``n_chunks`` chunks of ``chunk_ids`` lookup positions,
    each range streamed through shared memory ``tile_rows`` rows at a time."""

    tile_rows: int
    range_rows: int
    n_ranges: int
    chunk_ids: int
    n_chunks: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def ub_schedule(
    m: int, n_ids: int, row_bytes: int, *, block_m: int, persistent: bool, n_sms: int,
) -> UbSchedule:
    """The grid of one launch over an ``m``-row table and ``n_ids = B * s``
    lookups, at most ``CTAS_PER_SM * n_sms`` CTAs so that it runs in one
    wave.  A table that fits one tile is one range, and the ids are cut into
    that many chunks; a larger table is cut into that many ranges (fewer
    where a range would fall below :data:`MIN_RANGE_ROWS` rows), and the ids
    into as few chunks as fill the card with them (one, for a large table,
    so that every row is read by one CTA)."""
    target = CTAS_PER_SM * n_sms
    if persistent and m * row_bytes <= RESIDENT_BYTES:
        tile_rows = max(m, 1)
    else:
        tile_rows = max(8, min(block_m, TILE_BYTES // row_bytes) // 8 * 8)
    if m <= tile_rows:
        range_rows, n_ranges = max(m, 1), 1
    else:
        range_rows = max(MIN_RANGE_ROWS, _ceil(_ceil(m, target), 8) * 8)
        range_rows = min(range_rows, MAX_TILES * tile_rows)
        n_ranges = _ceil(m, range_rows)
    want_chunks = max(1, target // n_ranges)
    # a chunk is a multiple of 4 ids, so that every chunk's 16-byte id loads
    # stay aligned
    chunk_ids = max(4, _ceil(_ceil(n_ids, want_chunks), 4) * 4) if want_chunks > 1 else max(n_ids, 1)
    n_chunks = max(1, _ceil(n_ids, chunk_ids))
    return UbSchedule(min(tile_rows, range_rows), range_rows, n_ranges, chunk_ids, n_chunks)


def embedding_bag_ub_plain(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: (m, E), (B, s) -> (B, E) f32."""
    return bag_f32(table, indices)


def embedding_bag_ub(
    table: torch.Tensor,
    indices: torch.Tensor,
    *,
    block_m: int = 512,
    persistent: bool = False,
) -> torch.Tensor:
    """UB-strategy pooled lookup. table (m, E), indices (B, s) int32 ->
    (B, E) f32; ids outside ``[0, m)`` contribute zero.  CPU tensors run the
    plain version, CUDA tensors the kernel."""
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError("table must be (m, E) and indices (B, s)")
    if build.route(table, indices) == "cpu":
        return embedding_bag_ub_plain(table, indices)
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("table and indices must be contiguous")
    m, e = table.shape
    b, s = indices.shape
    sched = ub_schedule(m, b * s, e * table.element_size(), block_m=block_m,
                        persistent=persistent, n_sms=build.sm_count(table.device))
    out = launch(table, indices, sched)
    embedding_bag_ub.launches += 1
    return out


def launch(table: torch.Tensor, indices: torch.Tensor, sched: UbSchedule) -> torch.Tensor:
    """One launch of the UB kernel on CUDA tensors under ``sched``, without
    counting it (the L1 wrapper's ``beyond`` mode counts its own)."""
    m, e = table.shape
    b, s = indices.shape
    out = torch.empty((b, e), dtype=torch.float32, device=table.device)
    scratch = out if s == 1 else torch.empty((b * s, e), dtype=torch.float32, device=table.device)
    fn = build.c_function("embedding_ub", "rt_embedding_bag_ub", _ARGS)
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), indices.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                m, b, s, e, sched.tile_rows, sched.range_rows, sched.n_ranges,
                sched.chunk_ids, sched.n_chunks, build.dtype_code(table.dtype),
                build.stream_of(table.device))
    build.check_launch(rc, "embedding_bag_ub")
    return out


embedding_bag_ub.launches = 0
