"""Table / workload descriptions for embedding-dominated models.

The paper's unit of work is an *embedding table*: shape ``(m, E)`` looked up
``s`` times per query (sequence length) and pooled (sum) into one ``E``-vector
per query.  A *workload* is the set of tables extracted from one DLRM, plus
the query batch size.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One embedding table.

    Attributes:
      name: table identifier (feature name).
      rows: number of rows ``m`` (category cardinality).
      dim: embedding dimension ``E``.
      seq: lookups per query ``s`` (multi-hot / history length). The paper
        fixes ``s=1`` for all public workloads and 1..172 for Huawei-25MB.
      zipf_alpha: skew of the pseudo-realistic access distribution for this
        table (1.0 ~ typical CTR long-tail; 0 = uniform).
      dtype_bytes: bytes per element (paper: fp16 -> 2).
    """

    name: str
    rows: int
    dim: int = 16
    seq: int = 1
    zipf_alpha: float = 1.05
    dtype_bytes: int = 2

    @property
    def bytes(self) -> int:
        return self.rows * self.dim * self.dtype_bytes

    @property
    def row_bytes(self) -> int:
        return self.dim * self.dtype_bytes


@dataclasses.dataclass(frozen=True)
class Workload:
    """A DLRM embedding workload: a set of tables + a query batch size."""

    name: str
    tables: tuple[TableSpec, ...]
    batch: int = 8192

    @property
    def total_bytes(self) -> int:
        return sum(t.bytes for t in self.tables)

    @property
    def total_lookups(self) -> int:
        return self.batch * sum(t.seq for t in self.tables)

    def replace(self, **kw) -> "Workload":
        return dataclasses.replace(self, **kw)

    def scaled(self, batch: int) -> "Workload":
        return self.replace(batch=batch)

    def summary(self) -> str:
        mb = self.total_bytes / 2**20
        return (
            f"{self.name}: {len(self.tables)} tables, {mb:.1f} MiB total, "
            f"batch={self.batch}, lookups/query={sum(t.seq for t in self.tables)}"
        )


def make_workload(
    name: str,
    cardinalities: Sequence[int],
    *,
    dim: int = 16,
    seqs: Sequence[int] | None = None,
    batch: int = 8192,
    zipf_alpha: float = 1.05,
    dtype_bytes: int = 2,
) -> Workload:
    seqs = list(seqs) if seqs is not None else [1] * len(cardinalities)
    if len(seqs) != len(cardinalities):
        raise ValueError("seqs and cardinalities must align")
    tables = tuple(
        TableSpec(
            name=f"{name}_t{i}",
            rows=int(m),
            dim=dim,
            seq=int(s),
            zipf_alpha=zipf_alpha,
            dtype_bytes=dtype_bytes,
        )
        for i, (m, s) in enumerate(zip(cardinalities, seqs))
    )
    return Workload(name=name, tables=tables, batch=batch)


def pad_rows(rows: int, multiple: int = 8) -> int:
    """Pad a row count to a sublane-friendly multiple."""
    return int(-(-rows // multiple) * multiple)


def table_histogram(workload: Workload, edges: Iterable[int] | None = None):
    """Fig-2 style histogram of tables by row count."""
    edges = list(edges) if edges is not None else [0, 10, 100, 1_000, 10_000, 100_000, 1_000_000, 10_000_000, 10**9]
    rows = np.array([t.rows for t in workload.tables])
    hist, _ = np.histogram(rows, bins=edges)
    return list(zip(edges[:-1], edges[1:], hist.tolist()))
