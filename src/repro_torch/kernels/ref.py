"""Plain-torch oracles for the embedding lookups.

The correctness references the kernels' plain versions are held against,
with the JAX package's semantics: ``embedding_bag_ref``/``gather_ref`` take
ids already known to be in ``[0, m)``; the chunked forms mask ids outside
the chunk to zero.  Torch indexing with ``-1`` would silently read the LAST
row, so no negative id reaches an index here unmasked.
"""
from __future__ import annotations

import torch

__all__ = [
    "bag_f32",
    "chunk_bag_ref",
    "chunk_gather_ref",
    "embedding_bag_ref",
    "gather_ref",
]


def _check_in_range(table: torch.Tensor, indices: torch.Tensor) -> None:
    if indices.numel() and (
        int(indices.min()) < 0 or int(indices.max()) >= table.shape[0]
    ):
        raise IndexError(
            "ids must lie in [0, rows); use chunk_bag_ref/bag_f32 to mask "
            "out-of-range ids"
        )


def embedding_bag_ref(
    table: torch.Tensor, indices: torch.Tensor, *, pooling: str = "sum"
) -> torch.Tensor:
    """Gather + pool. table (m, E), indices (B, s) int -> (B, E)."""
    _check_in_range(table, indices)
    g = table[indices.long()]  # (B, s, E)
    if pooling == "sum":
        out = g.sum(dim=1)
    elif pooling == "mean":
        out = g.mean(dim=1)
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    return out.to(table.dtype)


def gather_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Plain row gather. table (m, E), indices (...,) -> (..., E)."""
    _check_in_range(table, indices)
    return table[indices.long()]


def _chunk_rows(chunk, indices, row_offset):
    rows = chunk.shape[0]
    local = indices.long() - int(row_offset)
    in_range = (local >= 0) & (local < rows)
    g = chunk[local.clamp(0, rows - 1)]
    return torch.where(in_range[..., None], g, torch.zeros((), dtype=g.dtype))


def chunk_bag_ref(
    chunk: torch.Tensor,
    indices: torch.Tensor,
    row_offset: int,
    *,
    pooling: str = "sum",
) -> torch.Tensor:
    """The paper's offset-subtract + clip + mask partial lookup (§III-B).

    ``chunk`` holds rows [row_offset, row_offset+rows) of the full table.
    Out-of-chunk ids contribute zero; summing the results over all chunks of
    a table recovers ``embedding_bag_ref``.
    """
    g = _chunk_rows(chunk, indices, row_offset)
    if pooling == "sum":
        out = g.sum(dim=1)
    elif pooling == "mean":
        out = g.sum(dim=1) / indices.shape[-1]
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    return out.to(chunk.dtype)


def chunk_gather_ref(
    chunk: torch.Tensor, indices: torch.Tensor, row_offset: int
) -> torch.Tensor:
    """Pool-free chunked gather (vocab-parallel embedding partial)."""
    return _chunk_rows(chunk, indices, row_offset)


def bag_f32(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Sum-pooled lookup accumulated in f32: table (m, E), indices (B, s)
    -> (B, E) f32; ids outside ``[0, m)`` (``-1`` padding included)
    contribute zero.  The plain version of the GM, UB and L1 kernels, which
    all compute this function and differ only in their data flow."""
    return _chunk_rows(table, indices, 0).float().sum(dim=1)
