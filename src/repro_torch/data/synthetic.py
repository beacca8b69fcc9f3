"""Synthetic query generators for the paper distributions (§IV-A).

The preferred interface takes a :class:`repro_torch.data.distributions.Distribution`
object (or a per-table list/dict, or a :class:`DriftSchedule`) — sampler and
exact histogram come from the same place, so plans can be priced under the
distribution the stream was actually drawn from:

    from repro_torch.data.distributions import Zipf
    idx = query_batch(rng, workload, Zipf(1.2))

The legacy string spellings (``"uniform"`` / ``"fixed"`` / ``"real"``) are
**deprecated**: they named ad-hoc draws with no queryable histogram (the
``"real"`` inverse-CDF approximation did not even match a proper zipf).  They
now warn and route to the equivalent distribution objects (``"real"`` maps to
``Zipf(table.zipf_alpha)`` per table, preserving the per-table skew knob).
"""
from __future__ import annotations

import warnings

import numpy as np

from repro_torch.core.tables import TableSpec, Workload
from repro_torch.data import distributions as dist_lib

__all__ = ["sample_indices", "query_batch", "ctr_batch"]

_LEGACY = ("uniform", "fixed", "real")


def _coerce(distribution, table: TableSpec | None = None):
    """Map a legacy string to a Distribution object (with a warning)."""
    if not isinstance(distribution, str):
        return distribution
    if distribution not in _LEGACY:
        raise ValueError(distribution)
    warnings.warn(
        f"string distribution {distribution!r} is deprecated: pass a "
        "repro_torch.data.distributions.Distribution object (e.g. Uniform(), "
        "Fixed(), Zipf(alpha)) so the exact access histogram travels with "
        "the stream.",
        DeprecationWarning,
        stacklevel=3,
    )
    if distribution == "uniform":
        return dist_lib.Uniform()
    if distribution == "fixed":
        return dist_lib.Fixed()
    alpha = table.zipf_alpha if table is not None else 1.05
    return dist_lib.Zipf(max(alpha, 1.0001), hot_prefix=False)


def _default_dist(table: TableSpec):
    """The pseudo-realistic default: the table's own zipf_alpha, scattered
    hot rows (matches the legacy ``"real"`` semantics, minus the warning)."""
    return dist_lib.Zipf(max(table.zipf_alpha, 1.0001), hot_prefix=False)


def sample_indices(
    rng: np.random.Generator,
    table: TableSpec,
    batch: int,
    distribution=None,
) -> np.ndarray:
    """(batch, seq) int32 lookup indices for one table.

    ``distribution`` is a :class:`Distribution` object (preferred), ``None``
    (the table's pseudo-realistic zipf default), or a deprecated legacy
    string (``"uniform"``/``"fixed"``/``"real"``)."""
    if distribution is None:
        return _default_dist(table).sample(rng, table, batch)
    d = _coerce(distribution, table)
    if isinstance(d, dist_lib.Fixed) and isinstance(distribution, str):
        # legacy "fixed" drew a random constant row, not row 0
        d = dist_lib.Fixed(int(rng.integers(0, table.rows)))
    return d.sample(rng, table, batch)


def query_batch(
    rng: np.random.Generator,
    workload: Workload,
    distribution=None,
    batch: int | None = None,
    *,
    step: int = 0,
) -> np.ndarray:
    """Stacked (N_tables, B, s_max) indices with -1 seq padding.

    ``distribution`` may be a :class:`Distribution`, a per-table list/dict,
    a :class:`DriftSchedule` (resolved at ``step``), ``None`` (per-table
    pseudo-realistic zipf defaults), or a deprecated legacy string."""
    batch = batch or workload.batch
    if distribution is None:
        distribution = [_default_dist(t) for t in workload.tables]
    if isinstance(distribution, str):
        s_max = max(t.seq for t in workload.tables)
        out = np.full((len(workload.tables), batch, s_max), -1, np.int32)
        with warnings.catch_warnings():
            warnings.simplefilter("once", DeprecationWarning)
            for i, t in enumerate(workload.tables):
                out[i, :, : t.seq] = sample_indices(rng, t, batch, distribution)
        return out
    return dist_lib.sample_workload(rng, workload, distribution, batch, step=step)


def ctr_batch(
    rng: np.random.Generator,
    workload: Workload,
    n_dense: int = 13,
    distribution=None,
    batch: int | None = None,
    *,
    step: int = 0,
) -> dict:
    """A full DLRM training/serving batch (dense + indices + labels)."""
    batch = batch or workload.batch
    return {
        "dense": rng.standard_normal((batch, n_dense)).astype(np.float32),
        "indices": query_batch(rng, workload, distribution, batch, step=step),
        "labels": (rng.random(batch) < 0.25).astype(np.float32),
    }
