"""Modeled per-batch lookup bytes of a placement (the plan report's tree).

This slice ports the part of the reference's traffic model that
``InferenceEngine.plan_report`` reads: :func:`modeled_plan_traffic` without
the access-reduction ``post`` figures.  Dedup/cache accounting and the
per-path, kernel-path and cross-host models wait for ROADMAP A7 and A4.
The figures are modeled from the plan's geometry; they are not measured.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.cost_model import freq_of
from repro_torch.core.strategies import Plan, Strategy
from repro_torch.core.tables import TableSpec

__all__ = ["modeled_plan_traffic"]


def modeled_plan_traffic(
    plan: Plan,
    tables: Sequence[TableSpec],
    batch: int,
    freqs=None,
) -> dict:
    """Expected per-batch HBM *lookup* bytes of a placement under an access
    histogram.

    Per chunk: the expected lookups landing in it are ``B·s·mass`` where
    ``mass`` is the chunk's share of the table's access mass
    (``freq.range_mass``; uniform ``rows/m`` when no histogram is given).

    * ``GM``     — every landing lookup reads one row from device memory;
    * ``GM-UB``  — the chunk is swept once per batch regardless of where
      lookups land;
    * ``L1``/``L1-UB`` — resident on chip: zero steady-state bytes.

    Symmetric-group tables are priced the same way over the whole table
    (UB sweeps once per core, since every core sweeps its own replica).
    """
    total = 0.0
    per_table = [0.0] * len(tables)
    per_chunk = []  # parallel to plan.assignments (the plan_report tree)
    l1_bytes = 0
    for a in plan.assignments:
        t = tables[a.table_idx]
        f = freq_of(freqs, a.table_idx)
        lo, hi = a.row_offset, a.row_offset + a.rows
        mass = (
            f.range_mass(lo, hi) if f is not None else a.rows / max(t.rows, 1)
        )
        # replicas split the batch; per-assignment share keeps the total exact
        eff_batch = batch // max(a.replicas, 1)
        if a.strategy is Strategy.GM:
            b = eff_batch * t.seq * mass * t.row_bytes
        elif a.strategy is Strategy.GM_UB:
            b = a.rows * t.row_bytes
        else:  # L1 / L1-UB resident
            b = 0.0
            l1_bytes += a.rows * t.row_bytes
        total += b
        per_table[a.table_idx] += b
        per_chunk.append(int(b))
    n_cores = max(plan.n_cores, 1)
    for ti, strat in zip(plan.symmetric_tables, plan.symmetric_strategies):
        t = tables[ti]
        if strat is Strategy.GM:
            b = batch * t.seq * t.row_bytes
        elif strat is Strategy.GM_UB:
            b = n_cores * t.rows * t.row_bytes
        else:
            b = 0.0
            l1_bytes += t.rows * t.row_bytes
        total += b
        per_table[ti] += b
    return {
        "batch": int(batch),
        "hbm_lookup_bytes": int(total),
        "per_table_bytes": [int(b) for b in per_table],
        "per_chunk_bytes": per_chunk,
        "l1_resident_bytes": int(l1_bytes),
    }
