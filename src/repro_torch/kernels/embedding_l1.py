"""L1 strategy: row gather from a table held in on-chip memory.

Paper §II-B: the table is preloaded once into the core's fast scratchpad
and every lookup is served from on-chip memory.  The CUDA kernel
(``csrc/embedding_l1.cu``) stages the whole table in each CTA's shared
memory when it fits :data:`RESIDENT_BYTES`, and otherwise sweeps it through
shared memory :data:`TILE_BYTES` at a time — the planner's L1 budget comes
from a cost-model preset and may exceed one CTA's shared memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bag_f32

__all__ = ["embedding_bag_l1", "embedding_bag_l1_plain", "l1_tile_rows"]

# dynamic shared memory a resident table may take (of the 227 KB a CTA can
# hold on Hopper), and the tile size of the sweep for larger tables
RESIDENT_BYTES = 200 * 1024
TILE_BYTES = 64 * 1024

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]


def l1_tile_rows(m: int, row_bytes: int) -> int:
    """Rows staged per tile: all ``m`` when the table fits
    :data:`RESIDENT_BYTES` (the resident path), else a multiple of 8 rows
    filling :data:`TILE_BYTES`."""
    if m * row_bytes <= RESIDENT_BYTES:
        return m
    return max(8, TILE_BYTES // row_bytes // 8 * 8)


def embedding_bag_l1_plain(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: (m, E), (B, s) -> (B, E) f32."""
    return bag_f32(table, indices)


def embedding_bag_l1(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """L1-strategy pooled lookup. table (m, E), indices (B, s) int32 ->
    (B, E) f32; ids outside ``[0, m)`` contribute zero.  CPU tensors run the
    plain version, CUDA tensors the kernel."""
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError("table must be (m, E) and indices (B, s)")
    if build.route(table, indices) == "cpu":
        return embedding_bag_l1_plain(table, indices)
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("table and indices must be contiguous")
    m, e = table.shape
    b, s = indices.shape
    tile_rows = l1_tile_rows(m, e * table.element_size())
    out = torch.empty((b, e), dtype=torch.float32, device=table.device)
    fn = build.c_function("embedding_l1", "rt_embedding_bag_l1", _ARGS)
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), indices.data_ptr(), out.data_ptr(), m, b, s, e,
                tile_rows, build.dtype_code(table.dtype),
                build.stream_of(table.device))
    build.check_launch(rc, "embedding_bag_l1")
    embedding_bag_l1.launches += 1
    return out


embedding_bag_l1.launches = 0
