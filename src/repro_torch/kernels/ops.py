"""Strategy dispatch for the single-table embedding kernels.

``embedding_bag(table, indices, strategy)`` is the single entry point the
core library uses; the planner decides the strategy per table.  CPU tensors
run each kernel's plain version, CUDA tensors the kernel.  The lookup is
differentiable in the table, as the JAX package's custom VJP is: the forward
runs the strategy's kernel, the backward is the plain scatter-add of the
pooled cotangents (:func:`bag_grad`, PyTorch's ``index_add_``), which the
JAX package also leaves outside its kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.strategies import Strategy
from repro_torch.kernels import ref
from repro_torch.kernels.embedding_gm import embedding_bag_gm
from repro_torch.kernels.embedding_l1 import embedding_bag_l1
from repro_torch.kernels.embedding_ub import embedding_bag_ub

__all__ = [
    "bag_grad",
    "chunk_bag",
    "chunk_gather",
    "embedding_bag",
    "embedding_gather",
    "strategy_bag",
]


def strategy_bag(table, indices, strategy: Strategy, *, block_m: int = 512) -> torch.Tensor:
    """(m, E) table x (B, s) int32 ids -> (B, E) f32 through the strategy's
    kernel; ids outside ``[0, m)`` contribute zero."""
    if strategy == Strategy.GM:
        return embedding_bag_gm(table, indices)
    if strategy == Strategy.L1:
        return embedding_bag_l1(table, indices)
    if strategy == Strategy.GM_UB:
        return embedding_bag_ub(table, indices, block_m=block_m, persistent=False)
    if strategy == Strategy.L1_UB:
        return embedding_bag_ub(table, indices, persistent=True)
    raise ValueError(strategy)


def bag_grad(indices: torch.Tensor, g: torch.Tensor, rows: int, dtype) -> torch.Tensor:
    """The table's gradient of a sum-pooled lookup: ``d table[r]`` is the
    sum of ``g[b]`` over every ``(b, j)`` with ``indices[b, j] == r``, in f32
    (``g`` repeated ``s`` times and scatter-added into a ``(rows, E)``
    buffer), cast to ``dtype``.  Ids outside ``[0, rows)`` add nothing: the
    forward reads zero for them, so this is its exact adjoint."""
    s = indices.shape[1]
    flat = indices.reshape(-1).long()
    keep = (flat >= 0) & (flat < rows)
    gexp = g.float().repeat_interleave(s, dim=0)  # (B*s, E)
    gexp = torch.where(keep[:, None], gexp, torch.zeros((), device=g.device))
    dtable = torch.zeros((rows, g.shape[-1]), dtype=torch.float32, device=g.device)
    dtable.index_add_(0, torch.where(keep, flat, 0), gexp)
    return dtable.to(dtype)


class _StrategyBag(torch.autograd.Function):
    """The strategy kernel forward, :func:`bag_grad` backward."""

    @staticmethod
    def forward(ctx, table, indices, strategy, block_m):
        ctx.save_for_backward(indices)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return strategy_bag(table, indices, strategy, block_m=block_m)

    @staticmethod
    def backward(ctx, g):
        (indices,) = ctx.saved_tensors
        return bag_grad(indices, g, ctx.rows, ctx.dtype), None, None, None


def embedding_bag(
    table: torch.Tensor,
    indices: torch.Tensor,
    strategy: Strategy | str | None = None,
    *,
    pooling: str = "sum",
    block_m: int = 512,
) -> torch.Tensor:
    """Pooled embedding lookup with an explicit data-flow strategy,
    differentiable in ``table``.

    Args:
      table: (m, E) embedding table (f32/bf16/f16).
      indices: (B, s) int32 lookup ids.
      strategy: one of Strategy.{GM, GM_UB, L1, L1_UB}; ``None`` uses the
        plain gather (:func:`repro_torch.kernels.ref.embedding_bag_ref`).
      pooling: "sum" (paper default) or "mean".
    Returns:
      (B, E) pooled embeddings, in the table dtype.
    """
    if strategy is None:
        return ref.embedding_bag_ref(table, indices, pooling=pooling)
    out = _StrategyBag.apply(table, indices, Strategy(strategy), block_m)
    if pooling == "mean":
        out = out / indices.shape[-1]
    elif pooling != "sum":
        raise ValueError(f"unknown pooling {pooling!r}")
    return out.to(table.dtype)


def embedding_gather(
    table: torch.Tensor, indices: torch.Tensor, strategy=None, **kw
) -> torch.Tensor:
    """Pool-free row gather (s=1 bag): (m, E), (T,) -> (T, E)."""
    if strategy is None:
        return ref.gather_ref(table, indices)
    return embedding_bag(table, indices[:, None], strategy, pooling="sum", **kw)


def chunk_bag(
    chunk: torch.Tensor, indices: torch.Tensor, row_offset: int, *, pooling: str = "sum"
) -> torch.Tensor:
    """Offset-subtract + clip + mask partial pooled lookup (paper §III-B),
    differentiable in ``chunk``: ids outside the chunk contribute zero."""
    return ref.chunk_bag_ref(chunk, indices, row_offset, pooling=pooling)


def chunk_gather(chunk: torch.Tensor, indices: torch.Tensor, row_offset: int) -> torch.Tensor:
    """Pool-free chunked gather (the vocab-parallel embedding's partial)."""
    return ref.chunk_gather_ref(chunk, indices, row_offset)
