"""The four per-core data-flow strategies (paper §II-B) and placement types.

Strategy semantics on the H100 (the kernels in ``repro_torch/csrc``):

  GM     each lookup's row is gathered straight from device memory into
         an f32 register (``embedding_gm.cu``).
  GM_UB  the table is swept through shared memory tile by tile and every
         id is checked against every tile: run time independent of the
         ids (``embedding_ub.cu``).
  L1     the table is staged in a CTA's shared memory and rows are read by
         index from there; a table too large for it is swept in tiles
         (``embedding_l1.cu``).
  L1_UB  the UB sweep over one resident tile when the table fits.

``L1``/``L1_UB`` are only eligible when the (padded) table fits the
persistent-buffer budget ``l1_bytes`` of the cost-model preset the plan was
priced under.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

from repro_torch.core.tables import TableSpec


class Strategy(str, enum.Enum):
    GM = "GM"
    GM_UB = "GM-UB"
    L1 = "L1"
    L1_UB = "L1-UB"

    @property
    def is_ub(self) -> bool:
        return self in (Strategy.GM_UB, Strategy.L1_UB)

    @property
    def is_l1(self) -> bool:
        return self in (Strategy.L1, Strategy.L1_UB)


ALL_STRATEGIES: tuple[Strategy, ...] = (
    Strategy.GM,
    Strategy.GM_UB,
    Strategy.L1,
    Strategy.L1_UB,
)


@dataclasses.dataclass(frozen=True)
class ChunkAssignment:
    """One table chunk placed on one core.

    ``row_offset:row_offset+rows`` of table ``table_idx`` lives on ``core``
    and is looked up with ``strategy``.  ``batch_lo:batch_hi`` is the slice of
    the query batch this placement serves (replication > 1 splits the batch;
    the paper fixes replication to 1 so the full batch is the default).
    """

    table_idx: int
    core: int
    row_offset: int
    rows: int
    strategy: Strategy
    batch_frac: tuple[int, int] = (0, 1)  # (slot, n_replicas)

    @property
    def replicas(self) -> int:
        return self.batch_frac[1]


@dataclasses.dataclass(frozen=True)
class Plan:
    """Full placement: which chunk of which table lives on which core.

    ``symmetric_tables`` lists table indices that fell back to symmetric
    batch-split execution (paper III-B step 4, LIF threshold).
    """

    workload_name: str
    n_cores: int
    assignments: tuple[ChunkAssignment, ...]
    symmetric_tables: tuple[int, ...] = ()
    symmetric_strategies: tuple[Strategy, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)

    def per_core(self) -> dict[int, list[ChunkAssignment]]:
        out: dict[int, list[ChunkAssignment]] = {k: [] for k in range(self.n_cores)}
        for a in self.assignments:
            out[a.core].append(a)
        return out

    def chunks_of(self, table_idx: int) -> list[ChunkAssignment]:
        return [a for a in self.assignments if a.table_idx == table_idx]

    def validate(self, tables: Sequence[TableSpec]) -> None:
        """Invariants: every asymmetric table's rows are exactly covered by
        its chunks (per replica group), chunks never overlap, cores in range."""
        n = len(tables)
        sym = set(self.symmetric_tables)
        covered: dict[int, set[tuple[int, int]]] = {}
        rep_count: dict[tuple[int, int, int], set[int]] = {}
        for a in self.assignments:
            if not (0 <= a.table_idx < n):
                raise ValueError(f"bad table idx {a.table_idx}")
            if not (0 <= a.core < self.n_cores):
                raise ValueError(f"bad core {a.core}")
            if a.table_idx in sym:
                raise ValueError(f"table {a.table_idx} both symmetric and asymmetric")
            if a.rows <= 0 or a.row_offset < 0:
                raise ValueError("bad chunk geometry")
            span = (a.row_offset, a.row_offset + a.rows)
            covered.setdefault(a.table_idx, set()).add(span)
            key = (a.table_idx, *span)
            slots = rep_count.setdefault(key, set())
            if a.batch_frac[0] in slots:
                raise ValueError(f"duplicate replica slot for chunk {key}")
            slots.add(a.batch_frac[0])
        for key, slots in rep_count.items():
            if slots != set(range(len(slots))):
                raise ValueError(f"non-contiguous replica slots for chunk {key}")
        for ti, spans in covered.items():
            m = tables[ti].rows
            pos = 0
            for lo, hi in sorted(spans):
                if lo != pos:
                    raise ValueError(
                        f"table {ti}: gap/overlap at row {pos} (next chunk at {lo})"
                    )
                pos = hi
            if pos < m:
                raise ValueError(f"table {ti}: rows {pos}..{m} uncovered")
        for ti in range(n):
            if ti not in covered and ti not in sym:
                raise ValueError(f"table {ti} not placed at all")
