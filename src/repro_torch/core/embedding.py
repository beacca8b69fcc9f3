"""PartitionedEmbeddingBag — the public API tying planner + executor together.

Usage::

    bag = PartitionedEmbeddingBag(workload, n_cores=8, planner="asymmetric")
    tables = bag.init(torch.Generator().manual_seed(0))  # list of (m_i, E)
    packed = bag.pack(tables, device="cuda")             # placed per the plan
    pooled = bag.apply(packed, indices)                  # (N, B, E)

Across cards each rank packs its own core (``bag.pack(tables, device=...,
core=rank)``) and every rank calls ``bag.apply(packed, indices,
mesh=mesh)`` with the same indices.

``indices`` is a list of per-table (B, s_i) int arrays or the pre-stacked
(N, B, s_max) tensor with ``-1`` padding.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import planner as planner_lib
from repro_torch.core.cost_model import CostModel, analytic_model
from repro_torch.core.partition import PackedPlan, pack_plan, partitioned_lookup
from repro_torch.core.strategies import Plan
from repro_torch.core.tables import Workload

__all__ = ["PartitionedEmbeddingBag", "stack_indices"]


def stack_indices(indices: Sequence, s_max: int | None = None) -> torch.Tensor:
    """Per-table (B, s_i) index arrays -> (N, B, s_max) int32 with -1 padding."""
    indices = [torch.as_tensor(np.asarray(i) if not isinstance(i, torch.Tensor) else i)
               for i in indices]
    s_max = s_max or max(i.shape[1] for i in indices)
    padded = [
        torch.nn.functional.pad(i.to(torch.int32), (0, s_max - i.shape[1]), value=-1)
        for i in indices
    ]
    return torch.stack(padded)


@dataclasses.dataclass
class PartitionedEmbeddingBag:
    workload: Workload
    n_cores: int
    # a PLANNERS name or any callable with the planner signature
    # (workload, n_cores, model, **kwargs) -> Plan
    planner: str | Callable[..., Plan] = "asymmetric"
    cost_model: CostModel | None = None
    dtype: torch.dtype = torch.float32
    planner_kwargs: dict = dataclasses.field(default_factory=dict)
    layout: str = "ragged"

    def __post_init__(self):
        self.cost_model = self.cost_model or analytic_model()
        plan_fn = (
            planner_lib.PLANNERS[self.planner]
            if isinstance(self.planner, str)
            else self.planner
        )
        self.plan: Plan = plan_fn(
            self.workload, self.n_cores, self.cost_model, **self.planner_kwargs
        )
        self.plan.validate(self.workload.tables)
        self.s_max = max(t.seq for t in self.workload.tables)
        self.n_tables = len(self.workload.tables)

    # -- parameters ---------------------------------------------------------

    def init(self, generator: torch.Generator | None = None) -> list[torch.Tensor]:
        """Fresh (m_i, E) tables on the CPU: N(0, 1/E) entries."""
        return [
            (torch.randn((t.rows, t.dim), generator=generator) / np.sqrt(t.dim)).to(self.dtype)
            for t in self.workload.tables
        ]

    def pack(
        self,
        table_data: Sequence | None,
        *,
        layout: str | None = None,
        block_r: int | None = None,
        block_b: int | None = None,
        autotune: bool = False,
        freqs=None,
        unique_cap: int | None = None,
        cache_rows: int | None = None,
        kernel_path: str | None = None,
        tuning_cache=None,
        device: torch.device | str = "cpu",
        core: int | None = None,
        mesh=None,
    ) -> PackedPlan:
        """Materialize the plan on ``device``.  ``autotune=True`` sweeps the
        fused kernel's ``block_r``/``block_b`` first on ``device`` (recorded
        in ``plan.meta["tuning"]``; see :mod:`repro_torch.core.autotune`).

        ``unique_cap``/``cache_rows`` default to the planner's selection in
        ``plan.meta["cache"]``; ``freqs`` defaults to the histograms the plan
        was priced under, so a dedup/cache plan packs its residency cache
        without extra arguments.  ``kernel_path`` (``None`` = the planner's
        choice in ``plan.meta["kernel"]``) selects the dedup'd gather;
        ``tuning_cache`` (a :class:`repro_torch.core.autotune.TuningCache`)
        lets the sweep reuse prior picks for shape-identical plans.

        ``core`` keeps only that core's slice on ``device`` (one rank's
        share of a device mesh); ``mesh`` is the mesh its sweep ranks
        over, each rank timing its own core."""
        layout = layout or self.layout
        if freqs is None:
            freqs = self.planner_kwargs.get("freqs")
        if autotune and layout == "ragged" and block_r is None:
            from repro_torch.core.autotune import autotune_block_sizes

            best = autotune_block_sizes(
                self.plan, self.workload.tables, batch=self.workload.batch,
                freqs=freqs, cache=tuning_cache, dtype=self.dtype, device=device,
                mesh=mesh,
            )
            block_r, block_b = best["block_r"], block_b or best["block_b"]
            # the sweep's winning access-reduction sizes ship with its block
            # sizes (with default candidates these equal the planner's pick)
            if unique_cap is None:
                unique_cap = best["unique_cap"]
            if cache_rows is None:
                cache_rows = best["cache_rows"]
            if kernel_path is None:
                kernel_path = best["kernel_path"]
        return pack_plan(
            self.plan,
            self.workload.tables,
            table_data,
            dtype=self.dtype,
            layout=layout,
            block_r=block_r,
            block_b=block_b,
            freqs=freqs,
            unique_cap=unique_cap,
            cache_rows=cache_rows,
            kernel_path=kernel_path,
            device=device,
            core=core,
        )

    def layout_summary(self) -> dict:
        """Packing-efficiency summary recorded by the last :meth:`pack`."""
        return dict(self.plan.meta.get("layout", {}))

    # -- execution ----------------------------------------------------------

    def apply(
        self,
        packed: PackedPlan,
        indices,
        *,
        use_kernels="fused",
        reduce_mode: str = "sparse",
        mesh=None,
        axis: str = "model",
        batch_axes: tuple[str, ...] = (),
    ) -> torch.Tensor:
        if isinstance(indices, (list, tuple)):
            indices = stack_indices(indices, self.s_max)
        return partitioned_lookup(
            packed,
            indices,
            n_tables=self.n_tables,
            use_kernels=use_kernels,
            reduce_mode=reduce_mode,
            mesh=mesh,
            axis=axis,
            batch_axes=batch_axes,
        )

    def reference(self, table_data, indices) -> torch.Tensor:
        """Dense single-device oracle for testing."""
        if isinstance(indices, (list, tuple)):
            indices = stack_indices(indices, self.s_max)
        indices = torch.as_tensor(indices)
        outs = []
        for i, t in enumerate(table_data):
            t = torch.as_tensor(t)
            idx = indices[i].to(t.device).long()
            valid = idx >= 0
            g = t[torch.where(valid, idx, 0)]
            g = torch.where(valid[..., None], g, torch.zeros((), dtype=g.dtype))
            outs.append(g.sum(dim=1).float())
        return torch.stack(outs)
