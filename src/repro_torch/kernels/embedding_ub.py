"""GM-UB / L1-UB strategies: conflict-free lookup whose run time does not
depend on the id values.

Paper §II-B: "Performs vectorized look-up operations after moving the table
in chunks to the shared memory."  The CUDA kernel (``csrc/embedding_ub.cu``)
sweeps the table through shared memory tile by tile and every (query, lane)
pair adds the rows its ids hit in the tile — the one-hot count product of
the TPU kernel without forming the count matrix.  GM-UB
(``persistent=False``) streams ``block_m``-row tiles; L1-UB
(``persistent=True``) keeps the whole table in one resident tile when it
fits a CTA's shared memory, and is tiled like GM-UB otherwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.embedding_l1 import l1_tile_rows
from repro_torch.kernels.ref import bag_f32

__all__ = ["embedding_bag_ub", "embedding_bag_ub_plain", "ub_schedule"]

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_PAIRS_PER_CTA = 4096  # csrc/common.cuh kPairs
_CTAS_PER_SM = 2  # splits are added until the grid fills the card this often


def ub_schedule(
    m: int, b: int, e: int, row_bytes: int, *, block_m: int, persistent: bool,
    n_sms: int,
) -> tuple[int, int, int]:
    """``(tile_rows, split_rows, n_splits)`` for one launch: the tile that
    passes through shared memory, and the row ranges the table is cut into
    so that (batch CTAs x splits) fills the card."""
    if persistent:
        tile_rows = l1_tile_rows(m, row_bytes)
    else:
        tile_rows = max(8, min(block_m, m) // 8 * 8)
    n_tiles = -(-m // tile_rows)
    batch_ctas = -(-(b * e) // _PAIRS_PER_CTA)
    n_splits = min(n_tiles, max(1, -(-(_CTAS_PER_SM * n_sms) // batch_ctas)))
    split_rows = -(-n_tiles // n_splits) * tile_rows
    return tile_rows, split_rows, -(-m // split_rows)


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
    n_sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    tile_rows, split_rows, n_splits = ub_schedule(
        m, b, e, e * table.element_size(), block_m=block_m,
        persistent=persistent, n_sms=n_sms,
    )
    out = torch.empty((b, e), dtype=torch.float32, device=table.device)
    partial = (
        torch.empty((n_splits, b, e), dtype=torch.float32, device=table.device)
        if n_splits > 1 else out
    )
    fn = build.c_function("embedding_ub", "rt_embedding_bag_ub", _ARGS)
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), indices.data_ptr(), out.data_ptr(),
                partial.data_ptr(), m, b, s, e, tile_rows, split_rows, n_splits,
                build.dtype_code(table.dtype), build.stream_of(table.device))
    build.check_launch(rc, "embedding_bag_ub")
    embedding_bag_ub.launches += 1
    return out


embedding_bag_ub.launches = 0
