"""Parameterized per-table query-access distributions + exact histograms.

The paper's headline robustness claim (20x+ on extremely unbalanced query
distributions, low sensitivity to distribution shift) needs *controllable*
skew: this module provides the generators, the exact per-row frequency
histograms they induce, and the streaming sketch + drift metrics the serving
layer uses to detect when live traffic has walked away from the histogram a
plan was priced under.

Pieces:

* :class:`RowProbs` — a compact exact per-row access histogram for one table:
  explicitly-weighted hot rows plus a uniform tail, so a 187M-row Criteo
  table costs ~KBs, not GBs.  Supports the mass queries the frequency-aware
  cost model needs (``prefix_mass``/``range_mass``/``top_mass``/
  ``effective_rows``) and two drift metrics (``l1_distance``,
  :func:`drift_distance`).
* :class:`Distribution` subclasses — :class:`Uniform`, :class:`Zipf`,
  :class:`HotSet`, :class:`Fixed`: each pairs an index sampler with the
  *analytic* ``RowProbs`` it draws from, so generator and histogram agree
  exactly (tested, not hoped).
* :class:`DriftSchedule` — day-parted drift: a cyclic sequence of
  (n_batches, distribution) phases, modelling diurnal traffic shift
  (Gupta et al., arXiv:1906.03109).
* :class:`FrequencySketch` — bounded-memory streaming top-K counter
  (space-saving) over served batches; converts to ``RowProbs`` for the drift
  trigger.
* ``PRESETS`` / :func:`get_distribution` — per-workload defaults for the six
  ``workloads.py`` table sets and a ``"zipf:1.2"``-style CLI spec parser.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from repro_torch.core.tables import TableSpec, Workload

__all__ = [
    "RowProbs",
    "Distribution",
    "Uniform",
    "Zipf",
    "HotSet",
    "Fixed",
    "DriftSchedule",
    "FrequencySketch",
    "PRESETS",
    "get_distribution",
    "parse_drift",
    "workload_probs",
    "sample_workload",
    "empirical_probs",
    "drift_distance",
]


# --------------------------------------------------------------------------
# Compact exact per-row histogram
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowProbs:
    """Exact per-row access probabilities for one table, stored compactly.

    ``ids``/``probs`` list the explicitly-weighted rows (descending
    probability); ``tail`` is the remaining mass spread uniformly over the
    ``rows - len(ids)`` rows not listed.  The uniform distribution is the
    degenerate ``RowProbs(rows, [], [], 1.0)``.
    """

    rows: int
    ids: np.ndarray  # (T,) int64, unique, sorted by prob descending
    probs: np.ndarray  # (T,) float64, descending
    tail: float  # mass spread uniformly over rows not in ``ids``

    def __post_init__(self):
        object.__setattr__(self, "ids", np.asarray(self.ids, np.int64))
        object.__setattr__(self, "probs", np.asarray(self.probs, np.float64))
        total = float(self.probs.sum()) + self.tail
        if not math.isclose(total, 1.0, abs_tol=1e-6):
            raise ValueError(f"probabilities sum to {total}, not 1")
        if len(self.ids) != len(set(self.ids.tolist())):
            raise ValueError("duplicate ids in RowProbs")

    # -- constructors -------------------------------------------------------

    @staticmethod
    def uniform(rows: int) -> "RowProbs":
        return RowProbs(rows, np.zeros(0, np.int64), np.zeros(0), 1.0)

    @staticmethod
    def from_counts(
        ids: np.ndarray, counts: np.ndarray, rows: int, total: int | None = None
    ) -> "RowProbs":
        """Empirical histogram from (id, count) pairs; tail = unseen rows.

        ``total`` defaults to ``counts.sum()`` — pass a larger value when the
        counts are a top-K subset of a longer stream (sketch overflow), the
        difference becomes the uniform tail.
        """
        counts = np.asarray(counts, np.float64)
        ids = np.asarray(ids, np.int64)
        n = float(total if total is not None else counts.sum())
        if n <= 0:
            return RowProbs.uniform(rows)
        # ties sorted by ascending id (not input order): sketch/empirical
        # histograms must be reproducible across runs — the planner's cache
        # contents and shadow re-pack plans are derived from this ordering.
        order = np.lexsort((ids, -counts))
        ids, counts = ids[order], counts[order]
        tail = max(0.0, 1.0 - float(counts.sum()) / n)
        probs = counts / n
        if tail > 0.0 and len(ids) >= rows:
            # every row is explicitly listed, so the leftover stream mass
            # has no unseen rows to live on — spread it uniformly over the
            # listed rows instead of silently dropping it (adding a
            # constant keeps the descending prob order intact).
            probs = probs + tail / rows
            tail = 0.0
        return RowProbs(rows, ids, probs, tail)

    # -- internals ----------------------------------------------------------

    @property
    def _tail_rows(self) -> int:
        return self.rows - len(self.ids)

    @property
    def _tail_per_row(self) -> float:
        return self.tail / self._tail_rows if self._tail_rows > 0 else 0.0

    # -- mass queries (what the frequency-aware cost model consumes) --------

    def top_mass(self, k: int) -> float:
        """Mass of the ``k`` hottest rows (rank order, not id order)."""
        k = min(k, self.rows)
        explicit = float(self.probs[: min(k, len(self.probs))].sum())
        extra = max(0, k - len(self.ids))
        return min(1.0, explicit + extra * self._tail_per_row)

    def range_mass(self, lo: int, hi: int) -> float:
        """Mass landing in the contiguous id range ``[lo, hi)`` — the
        expected fraction of this table's lookups a chunk at that range
        serves."""
        lo, hi = max(lo, 0), min(hi, self.rows)
        if hi <= lo:
            return 0.0
        in_range = (self.ids >= lo) & (self.ids < hi)
        explicit = float(self.probs[in_range].sum())
        n_tail = (hi - lo) - int(in_range.sum())
        return min(1.0, explicit + n_tail * self._tail_per_row)

    def prefix_mass(self, n: int) -> float:
        """Mass in rows ``[0, n)`` (hot-prefix layouts concentrate here)."""
        return self.range_mass(0, n)

    def range_top_mass(self, lo: int, hi: int, k: int = 8) -> float:
        """Mass of the ``k`` hottest rows *inside* ``[lo, hi)`` — the
        concentration a GM chunk sees (bank/line-conflict proxy)."""
        lo, hi = max(lo, 0), min(hi, self.rows)
        if hi <= lo:
            return 0.0
        in_range = (self.ids >= lo) & (self.ids < hi)
        explicit = self.probs[in_range][:k]  # probs are rank-sorted
        extra = max(0, k - len(explicit))
        n_tail = (hi - lo) - int(in_range.sum())
        return min(1.0, float(explicit.sum()) + min(extra, n_tail) * self._tail_per_row)

    def expected_unique(
        self, lo: int, hi: int, n: float, *, skip_top: int = 0
    ) -> float:
        """Expected number of *distinct* rows in ``[lo, hi)`` touched when the
        table receives ``n`` lookups drawn from this histogram — the analytic
        dedup factor: a chunk whose lookups pile onto few hot rows needs only
        ``expected_unique`` HBM row reads per batch once duplicates are folded
        (E[unique] = Σ_r 1-(1-p_r)^n ≤ n·mass, with equality only when no row
        repeats).  ``skip_top`` excludes the chunk's ``skip_top`` hottest
        explicit rows — the ones a residency cache already holds."""
        lo, hi = max(lo, 0), min(hi, self.rows)
        if hi <= lo or n <= 0:
            return 0.0
        in_range = (self.ids >= lo) & (self.ids < hi)
        p = self.probs[in_range][skip_top:]  # probs are rank-sorted
        # 1-(1-p)^n via expm1/log1p: stable for tiny per-row probabilities
        e = float(-np.expm1(n * np.log1p(-np.minimum(p, 1.0 - 1e-15))).sum())
        n_tail = (hi - lo) - int(in_range.sum())
        per = self._tail_per_row
        if n_tail > 0 and per > 0:
            e += n_tail * float(-np.expm1(n * math.log1p(-min(per, 1.0 - 1e-15))))
        return min(e, float(hi - lo))

    def effective_rows(self, coverage: float = 0.99) -> int:
        """Fewest rows (by rank) covering ``coverage`` of the access mass —
        the histogram's working-set size.  Uniform degenerates to
        ``ceil(coverage * rows)``."""
        eps = 1e-12
        cum = np.cumsum(self.probs) if len(self.probs) else np.zeros(0)
        if len(cum) and cum[-1] >= coverage - eps:
            return int(np.searchsorted(cum, coverage - eps) + 1)
        covered = float(cum[-1]) if len(cum) else 0.0
        per = self._tail_per_row
        if per <= 0:
            return min(len(self.ids), self.rows)
        extra = math.ceil((coverage - covered) / per)
        return int(min(self.rows, len(self.ids) + max(extra, 0)))

    def mass_of_ids(self, ids: np.ndarray) -> float:
        """Mass this histogram assigns to an explicit id set."""
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return 0.0
        explicit = np.isin(ids, self.ids)
        lookup = {int(i): float(p) for i, p in zip(self.ids, self.probs)}
        m = sum(lookup[int(i)] for i in ids[explicit])
        return min(1.0, m + (len(ids) - int(explicit.sum())) * self._tail_per_row)

    # -- drift metrics ------------------------------------------------------

    def l1_distance(self, other: "RowProbs") -> float:
        """Exact L1 distance Σ_r |p(r) − q(r)| between two histograms over
        the same row space (∈ [0, 2]).  Beware finite-sample bias: an
        *empirical* histogram of S samples from a uniform distribution over
        m ≫ S rows sits at L1 ≈ 2 from the analytic uniform — use
        :func:`drift_distance` for the serving trigger."""
        if self.rows != other.rows:
            raise ValueError("histograms cover different row counts")
        union = np.union1d(self.ids, other.ids)
        pa = {int(i): float(p) for i, p in zip(self.ids, self.probs)}
        pb = {int(i): float(p) for i, p in zip(other.ids, other.probs)}
        ta, tb = self._tail_per_row, other._tail_per_row
        d = sum(
            abs(pa.get(int(i), ta) - pb.get(int(i), tb)) for i in union
        )
        d += (self.rows - len(union)) * abs(ta - tb)
        return float(d)

    def spec(self) -> dict:
        """Small JSON-able summary (for ``plan.meta['distribution']``)."""
        return {
            "rows": int(self.rows),
            "n_explicit": int(len(self.ids)),
            "top1_mass": self.top_mass(1),
            "top64_mass": self.top_mass(64),
            "effective_rows_99": self.effective_rows(0.99),
            "tail": float(self.tail),
        }


def drift_distance(
    measured: RowProbs,
    baseline: RowProbs,
    ks: tuple[int, ...] = (1, 8, 64, 512),
) -> float:
    """Sample-robust drift metric ∈ [0, 1] for the serving trigger.

    Raw :meth:`RowProbs.l1_distance` saturates on sparse samples (S samples
    of a uniform over m ≫ S rows measure ≈ 2 from uniform).  Instead compare
    the mass the two histograms assign to the same hot id sets:

    * the *baseline's* top-k ids (analytic, noise-free): catches hot rows
      going cold — skew collapse and hot-set relocation;
    * the *measured* top-k ids, filtered to confidently-hot ones (probability
      well above the smallest explicit probability, i.e. observed several
      times): catches skew onset, without the one-observation noise floor
      that would make stationary sparse traffic look drifted.
    """
    d = 0.0
    for k in ks:
        ids = baseline.ids[: min(k, len(baseline.ids))]
        if len(ids):
            d = max(d, abs(baseline.mass_of_ids(ids) - measured.mass_of_ids(ids)))
    if len(measured.probs):
        floor = min(3.5 * float(measured.probs[-1]), float(measured.probs[0]))
        trusted_ids = measured.ids[measured.probs >= floor]
        for k in ks:
            ids = trusted_ids[: min(k, len(trusted_ids))]
            if len(ids):
                d = max(d, abs(measured.mass_of_ids(ids) - baseline.mass_of_ids(ids)))
    return d


# --------------------------------------------------------------------------
# Distributions
# --------------------------------------------------------------------------


def _coprime_step(m: int) -> int:
    """An odd multiplier coprime to ``m`` near the golden-ratio point, so
    ``id = (rank * step) % m`` is a bijection that scatters hot ranks."""
    step = max(3, int(m * 0.6180339887) | 1)
    while math.gcd(step, m) != 1:
        step += 2
    return step % m if m > 1 else 1


class Distribution:
    """One table's query-access law: a sampler + the exact histogram it
    draws from.  ``sample`` and ``probs`` agree by construction — samplers
    draw from the compact (top ids + uniform tail) form directly."""

    name = "base"

    def probs(self, table: TableSpec) -> RowProbs:
        raise NotImplementedError

    def sample(
        self, rng: np.random.Generator, table: TableSpec, batch: int
    ) -> np.ndarray:
        """(batch, table.seq) int32 indices drawn exactly from ``probs``."""
        return _sample_from_probs(rng, self.probs(table), (batch, table.seq))

    def spec(self) -> dict:
        return {"name": self.name}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec()})"


def _sample_from_probs(
    rng: np.random.Generator, rp: RowProbs, shape: tuple[int, ...]
) -> np.ndarray:
    """Draw ids from a compact histogram: explicit ids by their weights,
    tail uniformly over the complement (exact for prefix-form histograms,
    rejection-corrected otherwise)."""
    n = int(np.prod(shape))
    out = np.empty(n, np.int64)
    n_exp = len(rp.ids)
    exp_mass = float(rp.probs.sum())
    pick_exp = rng.random(n) < exp_mass
    k = int(pick_exp.sum())
    if k:
        out[pick_exp] = rp.ids[rng.choice(n_exp, size=k, p=rp.probs / exp_mass)]
    sel = ~pick_exp
    n_tail = int(sel.sum())
    if n_tail:
        if rp._tail_rows <= 0:
            # no tail rows: redirect residual draws into the explicit set
            out[sel] = rp.ids[rng.integers(0, max(n_exp, 1), n_tail)]
        elif n_exp == 0:
            out[sel] = rng.integers(0, rp.rows, n_tail)
        else:
            # uniform over the complement of the explicit ids: the j-th
            # complement element is j + #{explicit ids <= it}
            draws = rng.integers(0, rp._tail_rows, n_tail)
            sorted_ids = np.sort(rp.ids)
            out[sel] = draws + np.searchsorted(
                sorted_ids - np.arange(len(sorted_ids)), draws, side="right"
            )
    return out.reshape(shape).astype(np.int32)


class Uniform(Distribution):
    name = "uniform"

    def probs(self, table: TableSpec) -> RowProbs:
        return RowProbs.uniform(table.rows)


class Fixed(Distribution):
    """Every lookup hits one row (the paper's bank-conflict stress test)."""

    name = "fixed"

    def __init__(self, row: int = 0):
        self.row = row

    def probs(self, table: TableSpec) -> RowProbs:
        r = min(self.row, table.rows - 1)
        return RowProbs(table.rows, np.array([r]), np.array([1.0]), 0.0)

    def spec(self) -> dict:
        return {"name": self.name, "row": self.row}


class Zipf(Distribution):
    """Zipf(α) over row ranks: rank r has probability ∝ r^−α.

    The ``top_k`` hottest ranks are materialized explicitly; the remaining
    mass becomes a uniform tail (exact compact form for huge tables).  With
    ``hot_prefix=True`` (default) rank r maps to row id r−1, so the hot set
    is the *contiguous id prefix* — the layout frequency-aware planners can
    actually pin (production systems get this via frequency-ordered row
    remapping).  ``hot_prefix=False`` scatters ranks over the id space with
    a coprime multiplicative bijection instead.
    """

    name = "zipf"

    def __init__(self, alpha: float = 1.2, *, top_k: int = 1024, hot_prefix: bool = True):
        if alpha <= 0:
            raise ValueError("alpha must be > 0")
        self.alpha = float(alpha)
        self.top_k = int(top_k)
        self.hot_prefix = bool(hot_prefix)

    def probs(self, table: TableSpec) -> RowProbs:
        m = table.rows
        k = min(self.top_k, m)
        ranks = np.arange(1, k + 1, dtype=np.float64)
        w = ranks ** (-self.alpha)
        # tail mass: integrate the remaining ranks (exact enough for the
        # compact form; the sampler draws the tail uniformly either way)
        if m > k:
            r = np.arange(k + 1, m + 1, dtype=np.float64)
            tail_w = float((r ** (-self.alpha)).sum()) if m - k <= 1 << 20 else float(
                # Euler–Maclaurin integral bound for huge tables
                ((m + 0.5) ** (1 - self.alpha) - (k + 0.5) ** (1 - self.alpha))
                / (1 - self.alpha)
                if self.alpha != 1.0
                else math.log((m + 0.5) / (k + 0.5))
            )
        else:
            tail_w = 0.0
        total = float(w.sum()) + tail_w
        probs = w / total
        ids = np.arange(k, dtype=np.int64)
        if not self.hot_prefix:
            step = _coprime_step(m)
            ids = ((ids + 1) * step) % m  # +1: keep rank 1 off id 0
        order = np.argsort(-probs, kind="stable")
        return RowProbs(m, ids[order], probs[order], tail_w / total)

    def spec(self) -> dict:
        return {
            "name": self.name,
            "alpha": self.alpha,
            "top_k": self.top_k,
            "hot_prefix": self.hot_prefix,
        }


class HotSet(Distribution):
    """``n_hot`` rows (a contiguous block starting at ``offset``) carry
    ``hot_mass`` of the traffic uniformly; the rest is a uniform tail.

    ``flip()`` returns the same shape relocated to a disjoint block — the
    drift scenario where overall skew statistics are unchanged but *which*
    rows are hot moved (top-mass curves alone cannot see this; the id-aware
    :func:`drift_distance` can).
    """

    name = "hotset"

    def __init__(
        self,
        hot_frac: float = 0.01,
        hot_mass: float = 0.9,
        *,
        offset: int = 0,
        n_hot: int | None = None,
    ):
        if not (0 < hot_mass <= 1):
            raise ValueError("hot_mass in (0, 1]")
        self.hot_frac = float(hot_frac)
        self.hot_mass = float(hot_mass)
        self.offset = int(offset)
        self.n_hot = n_hot

    def _n_hot(self, m: int) -> int:
        n = self.n_hot if self.n_hot is not None else int(round(m * self.hot_frac))
        return max(1, min(n, m))

    def probs(self, table: TableSpec) -> RowProbs:
        m = table.rows
        n = self._n_hot(m)
        if n >= m:
            return RowProbs.uniform(m)
        # offset < 0 means "the end block" (the flipped position), disjoint
        # from the default prefix block whenever n <= m/2.
        off = (m - n) if self.offset < 0 else self.offset % m
        ids = (np.arange(n, dtype=np.int64) + off) % m
        probs = np.full(n, self.hot_mass / n)
        return RowProbs(m, ids, probs, 1.0 - self.hot_mass)

    def flip(self, to_offset: int = -1) -> "HotSet":
        """Same skew shape, hot block relocated (default: the end block) —
        drift that per-rank statistics cannot see."""
        return HotSet(
            self.hot_frac, self.hot_mass, offset=to_offset, n_hot=self.n_hot
        )

    def spec(self) -> dict:
        return {
            "name": self.name,
            "hot_frac": self.hot_frac,
            "hot_mass": self.hot_mass,
            "offset": self.offset,
            "n_hot": self.n_hot,
        }


class DriftSchedule:
    """Day-parted drift: a cyclic sequence of (n_batches, Distribution)
    phases.  ``at(step)`` returns the distribution governing batch ``step``;
    generators and the driftbench walk the schedule batch-by-batch."""

    name = "drift"

    def __init__(self, phases: list[tuple[int, Distribution]], *, cycle: bool = True):
        if not phases:
            raise ValueError("empty drift schedule")
        self.phases = [(int(n), d) for n, d in phases]
        self.cycle = cycle
        self.period = sum(n for n, _ in self.phases)

    def at(self, step: int) -> Distribution:
        if self.cycle:
            step = step % self.period
        pos = 0
        for n, d in self.phases:
            pos += n
            if step < pos:
                return d
        return self.phases[-1][1]

    def phase_index(self, step: int) -> int:
        if self.cycle:
            step = step % self.period
        pos = 0
        for i, (n, _) in enumerate(self.phases):
            pos += n
            if step < pos:
                return i
        return len(self.phases) - 1

    def spec(self) -> dict:
        return {
            "name": self.name,
            "cycle": self.cycle,
            "phases": [[n, d.spec()] for n, d in self.phases],
        }

    def __repr__(self) -> str:
        return f"DriftSchedule({self.spec()})"


# --------------------------------------------------------------------------
# Workload-level helpers
# --------------------------------------------------------------------------


def _per_table(dist, n_tables: int) -> list[Distribution]:
    if isinstance(dist, Distribution):
        return [dist] * n_tables
    if isinstance(dist, dict):
        return [dist.get(i, Uniform()) for i in range(n_tables)]
    dist = list(dist)
    if len(dist) != n_tables:
        raise ValueError("per-table distribution list length mismatch")
    return dist


def workload_probs(workload: Workload, dist) -> list[RowProbs]:
    """Exact per-table histograms a distribution induces on a workload."""
    per = _per_table(dist, len(workload.tables))
    return [d.probs(t) for d, t in zip(per, workload.tables)]


def sample_workload(
    rng: np.random.Generator,
    workload: Workload,
    dist,
    batch: int | None = None,
    *,
    step: int = 0,
) -> np.ndarray:
    """Stacked (N, B, s_max) int32 indices with -1 seq padding.

    ``dist`` may be a :class:`Distribution`, a per-table dict/list, or a
    :class:`DriftSchedule` (resolved at ``step``)."""
    batch = batch or workload.batch
    if isinstance(dist, DriftSchedule):
        dist = dist.at(step)
    per = _per_table(dist, len(workload.tables))
    s_max = max(t.seq for t in workload.tables)
    out = np.full((len(workload.tables), batch, s_max), -1, np.int32)
    for i, (d, t) in enumerate(zip(per, workload.tables)):
        out[i, :, : t.seq] = d.sample(rng, t, batch)
    return out


def empirical_probs(indices: np.ndarray, rows: int) -> RowProbs:
    """Exact empirical histogram of an index stream (``-1`` padding ignored)."""
    flat = np.asarray(indices).ravel()
    flat = flat[flat >= 0]
    if flat.size == 0:
        return RowProbs.uniform(rows)
    ids, counts = np.unique(flat, return_counts=True)
    return RowProbs.from_counts(ids, counts, rows)


# --------------------------------------------------------------------------
# Streaming sketch (serving-side measured histogram)
# --------------------------------------------------------------------------


class FrequencySketch:
    """Bounded-memory streaming frequency counter for one table.

    Exact while distinct ids ≤ ``capacity``; beyond that it degrades to the
    space-saving top-K sketch (evict the minimum counter, inherit its count
    + 1) — the hot rows the drift trigger cares about keep exact-ish counts,
    the cold tail folds into ``RowProbs.tail``."""

    def __init__(self, rows: int, capacity: int = 4096):
        self.rows = rows
        self.capacity = capacity
        self.counts: dict[int, int] = {}
        self.total = 0

    def update(self, indices: np.ndarray) -> None:
        flat = np.asarray(indices).ravel()
        flat = flat[flat >= 0]
        if flat.size == 0:
            return
        ids, counts = np.unique(flat, return_counts=True)
        self.total += int(flat.size)
        fresh: list[tuple[int, int]] = []
        for i, c in zip(ids.tolist(), counts.tolist()):
            if i in self.counts:
                self.counts[i] += c
            else:
                fresh.append((c, i))
        if not fresh:
            return
        # deterministic tie order everywhere (heaviest first, then LOWEST id):
        # admission, eviction, and the resulting top-k promotion must be
        # byte-stable across runs so shadow re-pack plans and residency-cache
        # contents derived from the sketch are reproducible.
        fresh.sort(key=lambda ci: (-ci[0], ci[1]))
        room = self.capacity - len(self.counts)
        for c, i in fresh[:room]:
            self.counts[i] = c
        overflow = fresh[room:] if room >= 0 else fresh
        if overflow:
            # batch-granular space-saving: evict the k coldest counters in
            # one pass (vs an O(capacity) min-scan per inserted id) and give
            # each newcomer its victim's count as the floor.
            victims = heapq.nsmallest(
                len(overflow), self.counts.items(), key=lambda kv: (kv[1], kv[0])
            )
            for (c, i), (vid, floor) in zip(overflow, victims):
                del self.counts[vid]
                self.counts[i] = floor + c

    def to_probs(self) -> RowProbs:
        if not self.counts:
            return RowProbs.uniform(self.rows)
        ids = np.fromiter(self.counts.keys(), np.int64, len(self.counts))
        counts = np.fromiter(self.counts.values(), np.float64, len(self.counts))
        return RowProbs.from_counts(ids, counts, self.rows, total=self.total)

    def reset(self) -> None:
        self.counts.clear()
        self.total = 0


# --------------------------------------------------------------------------
# Presets + CLI spec parsing
# --------------------------------------------------------------------------

# Per-workload defaults for the six `workloads.py` table sets.  Skew levels
# follow the public characterizations: CTR long-tails around α ≈ 1.05–1.2
# (Criteo/Avazu), display ads and short-video traffic more concentrated
# (Taobao/KuaiRec), TenRec article reads hot-set-like, and the synthetic
# Huawei-25MB model gets the day-parted drift schedule the paper's
# production setting implies.
PRESETS: dict[str, "Distribution | DriftSchedule"] = {
    "criteo-1tb": Zipf(1.05),
    "avazu-ctr": Zipf(1.1),
    "taobao": Zipf(1.2),
    "tenrec-qb": HotSet(hot_frac=0.005, hot_mass=0.8),
    "kuairec-big": HotSet(hot_frac=0.02, hot_mass=0.85),
    "huawei-25mb": DriftSchedule(
        [(64, Zipf(1.05)), (64, Zipf(1.3)), (64, HotSet(0.01, 0.9))]
    ),
}


def get_distribution(spec: str) -> "Distribution | DriftSchedule":
    """Parse a CLI distribution spec.

    Accepted forms: ``uniform``, ``fixed``, ``zipf:<alpha>``,
    ``hotset:<frac>:<mass>[:<offset>]``, a workload preset name from
    ``PRESETS``, or ``real`` (alias for ``zipf:1.05``, the legacy
    pseudo-realistic draw)."""
    if spec in PRESETS:
        return PRESETS[spec]
    head, _, rest = spec.partition(":")
    if head == "uniform":
        return Uniform()
    if head == "fixed":
        return Fixed(int(rest) if rest else 0)
    if head == "real":
        # legacy semantics: scattered hot rows (no pinnable id prefix)
        return Zipf(1.05, hot_prefix=False)
    if head == "zipf":
        return Zipf(float(rest) if rest else 1.2)
    if head == "hotset":
        parts = [p for p in rest.split(":") if p]
        frac = float(parts[0]) if parts else 0.01
        mass = float(parts[1]) if len(parts) > 1 else 0.9
        off = int(parts[2]) if len(parts) > 2 else 0
        return HotSet(frac, mass, offset=off)
    raise ValueError(f"unknown distribution spec {spec!r}")


def parse_drift(spec: str, phase_batches: int = 16) -> DriftSchedule:
    """Parse a drift-scenario spec: comma-separated distribution specs, each
    optionally ``@<n_batches>`` (default ``phase_batches``).

    ``"uniform@8,zipf:1.2@8,hotset:0.01:0.9:-1@8"`` is the benchmark's
    uniform → skew-onset → hot-set-flip matrix; the named shorthand
    ``"flip"`` expands to exactly that."""
    if spec == "flip":
        spec = f"uniform@{phase_batches},zipf:1.2@{phase_batches},hotset:0.01:0.9:-1@{phase_batches}"
    phases = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        d, _, n = part.partition("@")
        phases.append((int(n) if n else phase_batches, get_distribution(d)))
    return DriftSchedule(phases, cycle=False)
