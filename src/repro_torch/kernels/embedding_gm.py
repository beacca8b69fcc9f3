"""GM strategy: row-at-a-time lookup gathered from device memory.

Paper §II-B: "Read one row at a time ... from the off-chip memory (GM) ...
followed by pooling this row in an accumulation buffer."  The CUDA kernel
(``csrc/embedding_gm.cu``) gives each (query, lane) pair one thread that
reads the query's rows straight from device memory into an f32 register;
see the source for what bounds it and why.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bag_f32

__all__ = ["embedding_bag_gm", "embedding_bag_gm_plain"]

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]


def embedding_bag_gm_plain(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: (m, E), (B, s) -> (B, E) f32."""
    return bag_f32(table, indices)


def embedding_bag_gm(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """GM-strategy pooled lookup. table (m, E), indices (B, s) int32 ->
    (B, E) f32; ids outside ``[0, m)`` contribute zero.  CPU tensors run the
    plain version, CUDA tensors the kernel."""
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError("table must be (m, E) and indices (B, s)")
    if build.route(table, indices) == "cpu":
        return embedding_bag_gm_plain(table, indices)
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("table and indices must be contiguous")
    m, e = table.shape
    b, s = indices.shape
    out = torch.empty((b, e), dtype=torch.float32, device=table.device)
    fn = build.c_function("embedding_gm", "rt_embedding_bag_gm", _ARGS)
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), indices.data_ptr(), out.data_ptr(), m, b, s, e,
                build.dtype_code(table.dtype), build.stream_of(table.device))
    build.check_launch(rc, "embedding_bag_gm")
    embedding_bag_gm.launches += 1
    return out


embedding_bag_gm.launches = 0
