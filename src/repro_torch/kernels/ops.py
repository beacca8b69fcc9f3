"""Strategy dispatch for the single-table embedding kernels.

``embedding_bag(table, indices, strategy)`` is the single entry point the
core library uses; the planner decides the strategy per table.  CPU tensors
run each kernel's plain version, CUDA tensors the kernel.  This slice ports
the forward pass; the gradient (the reference's custom VJP scatter-add)
waits for the training slice (ROADMAP A10).
"""
from __future__ import annotations

import torch

from repro_torch.core.strategies import Strategy
from repro_torch.kernels import ref
from repro_torch.kernels.embedding_gm import embedding_bag_gm
from repro_torch.kernels.embedding_l1 import embedding_bag_l1
from repro_torch.kernels.embedding_ub import embedding_bag_ub

__all__ = ["embedding_bag", "embedding_gather", "strategy_bag"]


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


def embedding_bag(
    table: torch.Tensor,
    indices: torch.Tensor,
    strategy: Strategy | str | None = None,
    *,
    pooling: str = "sum",
    block_m: int = 512,
) -> torch.Tensor:
    """Pooled embedding lookup with an explicit data-flow strategy.

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
    out = strategy_bag(table, indices, Strategy(strategy), block_m=block_m)
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
