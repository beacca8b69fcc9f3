"""Greedy workload partitioning (paper §III) + beyond-paper extensions.

Three planners, all driven by the linear :class:`CostModel`:

* :func:`plan_baseline`    — every table looked up from global memory, batch
  split evenly over cores (models the vendor-compiler data flow).
* :func:`plan_symmetric`   — paper §III-A: one strategy per table, the same
  table set in every core's L1, batch split evenly.
* :func:`plan_asymmetric`  — paper §III-B: tables/chunks placed on individual
  cores (aggregated L1 = K x larger), greedy least-loaded-core assignment,
  chunking rule, LIF-triggered symmetric fallback.

Beyond-paper (§Perf, opt-in flags):

* ``replicate_hot``   — replication factor > 1 for chunks whose cost dominates
  a core (paper fixes replication to 1).
* ``lpt``             — sort by descending *estimated cost* (classic LPT bound
  for makespan) instead of the paper's (desc seq, asc size) key.
* ``freqs``           — frequency-aware planning (DESIGN.md §5): per-table
  access histograms (``RowProbs`` from :mod:`repro_torch.data.distributions`).
  Chunk costs are priced under the measured mass (``CostModel.predict`` with
  ``freq``/``row_range``), GM placements pay the conflict surcharge on hot
  traffic, and oversized tables gain a *hot-prefix split*: when the hottest
  L1-sized prefix carries most of the access mass, the table splits into a
  small L1-resident hot chunk plus a cheap cold GM remainder — the promotion
  raw table size alone would never justify.  ``freqs=None`` (default) is the
  uniform assumption and reproduces the paper's planner exactly.

Every planner records what it assumed in ``plan.meta`` (see
:mod:`repro_torch.core.partition` for the full ``plan.meta`` key reference):
``planner`` (name + option tags), ``lif``/``fell_back`` (asymmetric), and
``distribution`` — per-table histogram summaries when ``freqs`` was given
(``None`` entries = uniform assumption), so the serving layer can later diff
live traffic against what the plan was priced under.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.cost_model import CostModel, core_times, freq_of, lif
from repro_torch.core.strategies import ChunkAssignment, Plan, Strategy
from repro_torch.core.tables import TableSpec, Workload

__all__ = [
    "PLANNERS",
    "kernel_meta",
    "plan_asymmetric",
    "plan_baseline",
    "plan_symmetric",
    "predicted_p99",
    "select_access_reduction",
    "size_unique_cap",
]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _paper_order(tables: Sequence[TableSpec]) -> list[int]:
    """Sort by descending sequence length, ascending size (paper §III-A)."""
    return sorted(
        range(len(tables)), key=lambda i: (-tables[i].seq, tables[i].bytes)
    )


def _lpt_order(tables: Sequence[TableSpec], batch: int, model: CostModel) -> list[int]:
    def cost(i: int) -> float:
        return min(
            model.predict(tables[i], batch, 1, s)
            for s in (Strategy.L1, Strategy.L1_UB, Strategy.GM, Strategy.GM_UB)
        )

    return sorted(range(len(tables)), key=lambda i: -cost(i))


def predicted_p99(
    model: CostModel,
    tables: Sequence[TableSpec],
    batch: int,
    plan: Plan,
    freqs=None,
) -> float:
    """Model-predicted P99 (max per-core time) of a plan; ``freqs`` re-prices
    it under measured access histograms (how a stale plan is scored against
    drifted traffic)."""
    sym = dict(zip(plan.symmetric_tables, plan.symmetric_strategies))
    t = core_times(
        model, tables, batch, plan.assignments, plan.n_cores, sym, freqs
    )
    return float(t.max()) if len(t) else 0.0


def _validate_freqs(freqs, n_tables: int) -> None:
    """Reject histogram collections that reference tables the workload does
    not have: a mapping keyed by an unknown index (or a sequence longer than
    the table list) used to be *silently ignored* by ``freq_of`` — a typo'd
    key meant the planner quietly priced that table as uniform."""
    if freqs is None:
        return
    if isinstance(freqs, Mapping):
        unknown = sorted(
            k for k in freqs
            if not (isinstance(k, (int, np.integer)) and 0 <= int(k) < n_tables)
        )
        if unknown:
            raise ValueError(
                f"freqs contains entries for unknown tables {unknown!r} "
                f"(workload has tables 0..{n_tables - 1}); a silently "
                "dropped histogram would be priced as uniform"
            )
    elif len(freqs) > n_tables:
        raise ValueError(
            f"freqs has {len(freqs)} entries for a {n_tables}-table "
            "workload; the extras would be silently ignored"
        )


def _uniform_or(freq, rows: int):
    from repro_torch.data.distributions import RowProbs

    return freq if freq is not None else RowProbs.uniform(rows)


def select_access_reduction(
    tables: Sequence[TableSpec],
    freqs=None,
    *,
    dedup: bool = True,
    cache: bool = True,
    cache_target: float = 0.75,
    max_cache_rows: int = 4096,
    min_cache_coverage: float = 0.05,
) -> dict:
    """Size the executor's access-reduction knobs from the histograms
    (DESIGN.md §6): the residency-cache row budget and the expected cache
    coverage.  Returns a partial ``plan.meta["cache"]`` record; the planner
    fills in ``unique_cap`` once the chunking is known.

    ``cache_rows`` — smallest explicit-row prefix (rows merged across tables,
    ranked by per-query expected hits ``p·s``, ties by (table, id)) covering
    ``cache_target`` of the workload's lookups, aligned to 8 and capped at
    ``max_cache_rows``; coverage is a per-query fraction, so the rule is
    batch-size independent.  A histogram too flat to ever reach
    ``min_cache_coverage`` disables the cache (0 rows): pinning uniform
    traffic buys nothing.
    """
    cache_rows = 0
    coverage = 0.0
    total_seq = float(sum(t.seq for t in tables)) or 1.0
    if cache and freqs is not None:
        weights = []
        for i, t in enumerate(tables):
            f = freq_of(freqs, i)
            if f is None:
                continue
            for p in np.asarray(f.probs, np.float64):
                weights.append(p * t.seq)
        weights = np.sort(np.asarray(weights))[::-1]
        if len(weights):
            cum = np.cumsum(weights) / total_seq
            if float(cum[-1]) >= min_cache_coverage:
                k = int(np.searchsorted(cum, min(cache_target, cum[-1])) + 1)
                cache_rows = min(int(-(-k // 8) * 8), max_cache_rows)
                # coverage of the CLAMPED budget, not the uncapped prefix —
                # what the carve can actually deliver.
                coverage = float(cum[min(cache_rows, len(cum)) - 1])
    return {
        "dedup": bool(dedup),
        "cache_rows": int(cache_rows),
        "cache_target": float(cache_target),
        "coverage": coverage,
        "unique_cap": 0,
    }


def size_unique_cap(
    tables: Sequence[TableSpec],
    batch: int,
    assignments: Sequence[ChunkAssignment],
    freqs=None,
) -> int:
    """unique_cap sizing shared by the flat and hierarchical planners: max
    expected unique rows over the placed chunks with 25% headroom (overflow
    spills to the cold path, so the cap bounds memory, not correctness),
    clamped at each chunk's hard ceiling ``min(rows, lookups)``.  Sized
    WITHOUT the cache exclusion so a cold cache (post-swap, pre-warm) still
    dedups within budget."""
    cap = 8.0
    for a in assignments:
        t = tables[a.table_idx]
        f = _uniform_or(freq_of(freqs, a.table_idx), t.rows)
        n = batch * t.seq / max(a.replicas, 1)
        u = f.expected_unique(a.row_offset, a.row_offset + a.rows, n)
        cap = max(cap, min(1.25 * u, float(a.rows), n))
    return int(-(-int(cap) // 8) * 8)


def kernel_meta(
    tables: Sequence[TableSpec],
    batch: int,
    assignments: Sequence[ChunkAssignment],
    model: CostModel,
    freqs,
    kernel_path: str,
    dedup_armed: bool,
) -> dict:
    """Per-chunk gather-path choice (DESIGN.md §11), shared by the flat and
    hierarchical planners: price the dedup'd unique-row gather both ways for
    every placed chunk; without dedup the sparse path has no uniq/cnt
    machinery to ride, so auto is all-one-hot (the records still carry both
    modeled costs for reporting)."""
    per_chunk = []
    n_sparse = 0
    for a in assignments:
        chunk_tab = dataclasses.replace(tables[a.table_idx], rows=a.rows)
        eff_batch = batch // max(a.replicas, 1)
        auto_path, kcosts = model.best_kernel_path(
            chunk_tab, eff_batch, 1, freq_of(freqs, a.table_idx),
            (a.row_offset, a.row_offset + a.rows),
        )
        if kernel_path == "auto":
            path = auto_path if dedup_armed else "onehot"
        else:
            path = kernel_path
        n_sparse += path == "sparse"
        per_chunk.append({
            "table": a.table_idx,
            "core": a.core,
            "rows": a.rows,
            "path": path,
            "onehot_us": kcosts["onehot"] * 1e6,
            "sparse_us": kcosts["sparse"] * 1e6,
        })
    return {
        "path": kernel_path,
        "dedup_armed": dedup_armed,
        "per_chunk": per_chunk,
        "n_sparse": int(n_sparse),
        "n_onehot": len(per_chunk) - int(n_sparse),
    }


def _distribution_meta(freqs, n_tables: int):
    """JSON-able record of the histograms a plan was priced under."""
    if freqs is None:
        return None
    out = []
    for i in range(n_tables):
        f = freq_of(freqs, i)
        out.append(f.spec() if f is not None and hasattr(f, "spec") else None)
    return {"per_table": out}


# --------------------------------------------------------------------------
# baseline + symmetric (paper III-A)
# --------------------------------------------------------------------------


def plan_baseline(
    workload: Workload, n_cores: int, model: CostModel, *, freqs=None
) -> Plan:
    """Vendor-compiler analog: GM gathers for everything, batch split.

    ``freqs`` is accepted for interface parity (recorded in the meta) but
    cannot change the plan — the baseline has no strategy freedom, which is
    exactly why it is distribution-sensitive."""
    n = len(workload.tables)
    _validate_freqs(freqs, n)
    return Plan(
        workload_name=workload.name,
        n_cores=n_cores,
        assignments=(),
        symmetric_tables=tuple(range(n)),
        symmetric_strategies=tuple(Strategy.GM for _ in range(n)),
        meta={
            "planner": "baseline",
            "distribution": _distribution_meta(freqs, n),
        },
    )


def plan_symmetric(
    workload: Workload, n_cores: int, model: CostModel, *, freqs=None
) -> Plan:
    """Paper §III-A greedy: same tables in every core's L1, batch split K-ways.

    With ``freqs``, strategy picks are priced under the per-table histograms
    (GM picks pay the conflict surcharge on hot traffic, so hot tables lean
    harder toward L1/UB)."""
    tables, batch = workload.tables, workload.batch
    _validate_freqs(freqs, len(tables))
    order = _paper_order(tables)
    l1_left = model.hardware.l1_bytes
    strategies: dict[int, Strategy] = {}
    for i in order:
        t = tables[i]
        if t.bytes <= l1_left:
            strat, _ = model.best_strategy(
                t, batch, n_cores, (Strategy.L1, Strategy.L1_UB),
                freq_of(freqs, i),
            )
            l1_left -= t.bytes
        else:
            strat, _ = model.best_strategy(
                t, batch, n_cores, (Strategy.GM, Strategy.GM_UB),
                freq_of(freqs, i),
            )
        strategies[i] = strat
    n = len(tables)
    return Plan(
        workload_name=workload.name,
        n_cores=n_cores,
        assignments=(),
        symmetric_tables=tuple(range(n)),
        symmetric_strategies=tuple(strategies[i] for i in range(n)),
        meta={
            "planner": "symmetric",
            "l1_left": l1_left,
            "distribution": _distribution_meta(freqs, n),
        },
    )


# --------------------------------------------------------------------------
# asymmetric (paper III-B)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Item:
    table_idx: int
    row_offset: int
    rows: int
    seq: int
    bytes: int
    # chunk of a frequency-hot-split table: exempt from the symmetric LIF
    # fallback (replicating a skew-heavy table symmetric GM would stream K x
    # its bytes and forfeit the L1 promotion the split exists for)
    hot: bool = False


def _hot_window(freq, width: int) -> tuple[int, int]:
    """Best contiguous id window of ``width`` rows by access mass: slide over
    the histogram's explicitly-hot ids (two-pointer on the sorted id list) —
    finds the hot prefix, a relocated hot block, or any hot middle run."""
    m = freq.rows
    width = min(width, m)
    ids = np.sort(np.asarray(freq.ids, np.int64))
    if len(ids) == 0:
        return 0, width
    probs_by_id = dict(zip(freq.ids.tolist(), freq.probs.tolist()))
    p = np.array([probs_by_id[int(i)] for i in ids])
    best_lo, best_mass, i, acc = 0, -1.0, 0, 0.0
    for j in range(len(ids)):
        acc += p[j]
        while ids[j] - ids[i] >= width:
            acc -= p[i]
            i += 1
        if acc > best_mass:
            best_mass = acc
            best_lo = int(ids[i])
    lo = max(0, min(best_lo, m - width)) // 8 * 8
    return lo, min(lo + width, m)


def _hot_split(
    t: TableSpec, batch: int, model: CostModel, freq
) -> tuple[int, int] | None:
    """Frequency-aware chunking (DESIGN.md §5): the ``[lo, hi)`` hot window
    to split into an L1-resident chunk, or ``None`` when not beneficial.

    An oversized table whose hottest L1-sized contiguous id window carries
    most of the access mass splits at the window: the hot chunk runs
    L1/L1-UB (conflict-free, serves ~all lookups), the cold remainder stays
    GM/GM-UB but is nearly idle — the promotion raw size alone would never
    justify.  Requires block-concentrated histograms (hot-prefix/hot-set
    generators, or production frequency-ordered row remapping); a scattered
    or uniform histogram prices the split as useless and returns ``None``."""
    l1_bytes = model.hardware.l1_bytes
    h = (l1_bytes // t.row_bytes) // 8 * 8  # L1-capacity rows, aligned
    if h < 8 or h >= t.rows:
        return None
    lo, hi = _hot_window(freq, h)
    hot_mass = freq.range_mass(lo, hi)
    if hot_mass < 0.5:
        return None
    hot_tab = dataclasses.replace(t, rows=hi - lo)
    _, hot_cost = model.best_strategy(
        hot_tab, batch, 1, (Strategy.L1, Strategy.L1_UB), freq, (lo, hi)
    )
    cold_cost = sum(
        model.best_strategy(
            dataclasses.replace(t, rows=b - a), batch, 1,
            (Strategy.GM, Strategy.GM_UB), freq, (a, b),
        )[1]
        for a, b in ((0, lo), (hi, t.rows))
        if b > a
    )
    _, whole_cost = model.best_strategy(
        t, batch, 1, (Strategy.GM, Strategy.GM_UB), freq, (0, t.rows)
    )
    return (lo, hi) if hot_cost + cold_cost < whole_cost else None


def _chunk_items(
    tables: Sequence[TableSpec], batch: int, model: CostModel, freqs=None
) -> list[_Item]:
    """Paper III-B step 1: split tables larger than L1 into the fewest chunks,
    but only when the L1 speed-up exceeds the number of chunks.  With a
    frequency histogram, a hot-window split (hot L1 chunk + cold remainder)
    is tried first — see :func:`_hot_split`."""
    l1_bytes = model.hardware.l1_bytes
    items: list[_Item] = []
    for i, t in enumerate(tables):
        freq = freq_of(freqs, i)
        if t.bytes > l1_bytes and l1_bytes > 0 and freq is not None:
            win = _hot_split(t, batch, model, freq)
            if win is not None:
                lo, hi = win
                for a, b in ((0, lo), (lo, hi), (hi, t.rows)):
                    if b > a:
                        items.append(
                            _Item(
                                i, a, b - a, t.seq, (b - a) * t.row_bytes,
                                hot=True,
                            )
                        )
                continue
        if t.bytes > l1_bytes and l1_bytes > 0:
            n_chunks = -(-t.bytes // l1_bytes)
            gm_cost = min(
                model.predict(t, batch, 1, Strategy.GM),
                model.predict(t, batch, 1, Strategy.GM_UB),
            )
            chunk_rows = -(-t.rows // n_chunks)
            chunk_tab = dataclasses.replace(t, rows=chunk_rows)
            l1_cost = min(
                model.predict(chunk_tab, batch, 1, Strategy.L1),
                model.predict(chunk_tab, batch, 1, Strategy.L1_UB),
            )
            speedup = gm_cost / max(l1_cost, 1e-30)
            if speedup > n_chunks:
                off = 0
                while off < t.rows:
                    rows = min(chunk_rows, t.rows - off)
                    items.append(_Item(i, off, rows, t.seq, rows * t.row_bytes))
                    off += rows
                continue
        items.append(_Item(i, 0, t.rows, t.seq, t.bytes))
    return items


def plan_asymmetric(
    workload: Workload,
    n_cores: int,
    model: CostModel,
    *,
    lif_threshold: float = 1.25,
    lpt: bool = False,
    replicate_hot: bool = False,
    max_replicas: int = 4,
    rock_theta: float = 1.1,
    shard_rocks: bool = False,
    freqs=None,
    dedup: bool = False,
    cache: bool = False,
    cache_target: float = 0.75,
    max_cache_rows: int = 4096,
    kernel_path: str = "auto",
) -> Plan:
    """Paper §III-B greedy asymmetric planner.

    0. "big rock" pre-pass (our fix to the paper's greedy, see DESIGN.md):
       an un-chunkable table whose best single-core cost exceeds
       ``rock_theta * total_work / K`` (the LPT makespan lower bound) can only
       hurt the makespan when placed on one core — it goes straight to the
       symmetric batch-split group (replication=1 per the paper);
    1. chunk oversized tables (if the L1 speed-up beats the chunk count;
       with ``freqs``, the hot-prefix split is tried first — hot L1 chunk +
       cold GM remainder, the frequency-aware promotion);
    2. sort (desc seq, asc size) [or LPT with ``lpt=True``];
    3. place each item on the least-loaded core; L1 strategies if that core
       still has L1 room, else GM strategies — all costs priced under
       ``freqs`` when given (chunk access mass + GM conflict surcharge);
    4. when LIF >= threshold, the remaining tables fall back to symmetric.

    Frequency-aware planning implies LPT ordering: the paper's (desc seq,
    asc size) key places byte-tiny tables first, letting them claim the L1
    budget before the mass-heavy hot chunks even arrive — under a histogram
    the placement order must follow priced cost, not raw size.

    ``dedup``/``cache`` (DESIGN.md §6, both default off) arm the executor's
    access-reduction subsystem: every chunk is priced on post-dedup /
    post-cache traffic (``CostModel.dedup``/``cache_rows``), the residency
    cache is sized by :func:`select_access_reduction`, and the chosen
    ``unique_cap`` (max expected unique rows over the placed chunks, with
    headroom) is recorded in ``plan.meta["cache"]`` for ``pack_plan``.

    ``kernel_path`` (DESIGN.md §11) extends the per-chunk strategy choice to
    the *gather implementation* inside the fused kernel: ``"auto"``
    (default) prices every placed chunk's dedup'd unique-row gather both
    ways (``CostModel.best_kernel_path``) and records the per-chunk argmin
    in ``plan.meta["kernel"]``; ``"onehot"``/``"sparse"`` force one path
    everywhere.  The sparse path rides the dedup machinery, so without
    ``dedup=True`` auto resolves to all-one-hot and forcing ``"sparse"``
    raises.
    """
    tables, batch = workload.tables, workload.batch
    if kernel_path not in ("auto", "onehot", "sparse"):
        raise ValueError(f"unknown kernel_path {kernel_path!r}")
    if kernel_path == "sparse" and not dedup:
        raise ValueError(
            "kernel_path='sparse' requires dedup=True: the sparse gather "
            "rides the dedup uniq/cnt machinery"
        )
    _validate_freqs(freqs, len(tables))
    lpt = lpt or freqs is not None
    access = None
    if dedup or cache:
        access = select_access_reduction(
            tables, freqs, dedup=dedup, cache=cache,
            cache_target=cache_target, max_cache_rows=max_cache_rows,
        )
        model = dataclasses.replace(
            model, dedup=dedup, cache_rows=access["cache_rows"]
        )

    def best_single_core(i: int, t: TableSpec) -> float:
        cands = [Strategy.GM, Strategy.GM_UB]
        if model.fits_l1(t):
            cands += [Strategy.L1, Strategy.L1_UB]
        f = freq_of(freqs, i)
        return min(model.predict(t, batch, 1, s, f) for s in cands)

    pre_sym: list[int] = []
    rock_chunks: list[ChunkAssignment] = []
    if rock_theta is not None and n_cores > 1:
        costs = [best_single_core(i, t) for i, t in enumerate(tables)]
        bound = rock_theta * sum(costs) / n_cores
        chunkable = {
            it.table_idx
            for it in _chunk_items(tables, batch, model, freqs)
            if it.rows < tables[it.table_idx].rows
        }
        pre_sym = [
            i
            for i, c in enumerate(costs)
            if c > bound and i not in chunkable
        ]
        if shard_rocks:
            # TPU profile (DESIGN.md §2): on a pod every chip has its own
            # HBM, so the paper's symmetric fallback (replicated tables)
            # would multiply memory K x.  Rocks are instead row-sharded into
            # K GM chunks — capacity sharding with the same offset-clip-psum
            # execution (Megatron-style).
            for i in pre_sym:
                t = tables[i]
                rows = -(-t.rows // n_cores)
                off = 0
                core = 0
                while off < t.rows:
                    r = min(rows, t.rows - off)
                    strat, _ = model.best_strategy(
                        dataclasses.replace(t, rows=r), batch, 1,
                        (Strategy.GM, Strategy.GM_UB),
                        freq_of(freqs, i), (off, off + r),
                    )
                    rock_chunks.append(
                        ChunkAssignment(i, core % n_cores, off, r, strat)
                    )
                    off += r
                    core += 1
            pre_sym = []

    placed_elsewhere = set(pre_sym) | {a.table_idx for a in rock_chunks}
    reduced = Workload(
        name=workload.name,
        tables=tuple(t for i, t in enumerate(tables) if i not in placed_elsewhere),
        batch=batch,
    )
    idx_map = [i for i in range(len(tables)) if i not in placed_elsewhere]
    reduced_freqs = (
        [freq_of(freqs, i) for i in idx_map] if freqs is not None else None
    )
    items = _chunk_items(reduced.tables, batch, model, reduced_freqs)
    # re-map chunk items back to original table indices
    for it in items:
        it.table_idx = idx_map[it.table_idx]
    if lpt:
        key = {
            id(it): min(
                model.predict(
                    dataclasses.replace(tables[it.table_idx], rows=it.rows),
                    batch,
                    1,
                    s,
                    freq_of(freqs, it.table_idx),
                    (it.row_offset, it.row_offset + it.rows),
                )
                for s in (Strategy.L1, Strategy.L1_UB, Strategy.GM, Strategy.GM_UB)
            )
            for it in items
        }
        items.sort(key=lambda it: -key[id(it)])
    else:
        items.sort(key=lambda it: (-it.seq, it.bytes))

    load = np.zeros(n_cores)
    l1_left = np.full(n_cores, float(model.hardware.l1_bytes))
    assignments: list[ChunkAssignment] = list(rock_chunks)
    for a in rock_chunks:
        load[a.core] += model.predict(
            dataclasses.replace(tables[a.table_idx], rows=a.rows),
            batch, 1, a.strategy,
            freq_of(freqs, a.table_idx),
            (a.row_offset, a.row_offset + a.rows),
        )
    def _sym_candidates(t: TableSpec):
        cands = [Strategy.GM, Strategy.GM_UB]
        if model.fits_l1(t):
            cands += [Strategy.L1, Strategy.L1_UB]
        return tuple(cands)

    sym_tables: list[int] = list(pre_sym)
    sym_strats: list[Strategy] = [
        model.best_strategy(
            tables[i], batch, n_cores, _sym_candidates(tables[i]),
            freq_of(freqs, i),
        )[0]
        for i in pre_sym
    ]
    fell_back = False

    for pos, it in enumerate(items):
        # LIF check (paper step 4): remaining tables go symmetric.  Only
        # meaningful once every core has work — before that LIF is trivially
        # K/(#loaded cores).  The TPU profile (shard_rocks) disables the
        # symmetric fallback: replicating tables multiplies per-chip HBM, so
        # imbalance is left to the greedy balancing + rock pre-pass instead.
        if (
            not fell_back
            and not shard_rocks
            and np.all(load > 0)
            and lif(load) >= lif_threshold
        ):
            fell_back = True
        if fell_back:
            # whole tables only — chunks of an already-started table must be
            # completed asymmetrically to preserve coverage, and hot-split
            # chunks always place asymmetrically (see _Item.hot).
            started = {a.table_idx for a in assignments}
            if it.table_idx not in started and not it.hot:
                if it.table_idx not in sym_tables:
                    t = tables[it.table_idx]
                    strat, _ = model.best_strategy(
                        t, batch, n_cores, (Strategy.GM, Strategy.GM_UB),
                        freq_of(freqs, it.table_idx),
                    )
                    sym_tables.append(it.table_idx)
                    sym_strats.append(strat)
                continue

        core = int(np.argmin(load))
        chunk_tab = dataclasses.replace(tables[it.table_idx], rows=it.rows)
        it_freq = freq_of(freqs, it.table_idx)
        it_range = (it.row_offset, it.row_offset + it.rows)
        if it.bytes <= l1_left[core]:
            strat, cost = model.best_strategy(
                chunk_tab, batch, 1, (Strategy.L1, Strategy.L1_UB),
                it_freq, it_range,
            )
        else:
            strat, cost = model.best_strategy(
                chunk_tab, batch, 1, (Strategy.GM, Strategy.GM_UB),
                it_freq, it_range,
            )

        replicas = 1
        if (
            replicate_hot
            and n_cores > 1
            and load.sum() > 0
            and cost > 2.0 * (load.sum() / n_cores)
        ):
            # beyond-paper: split this chunk's batch over r cores.
            replicas = min(max_replicas, n_cores)
        if replicas == 1:
            if strat.is_l1:
                l1_left[core] -= it.bytes
            assignments.append(
                ChunkAssignment(it.table_idx, core, it.row_offset, it.rows, strat)
            )
            load[core] += cost
        else:
            # each replica serves a ceil-divided batch fraction, and the
            # strategy is re-picked per replica core: the first core's L1
            # state says nothing about the replica's core, and charging the
            # first pick's cost would let a GM replica masquerade as L1.
            rep_batch = -(-batch // replicas)
            for r in range(replicas):
                c = int(np.argmin(load))
                if it.bytes <= l1_left[c]:
                    strat_r, rep_cost = model.best_strategy(
                        chunk_tab, rep_batch, 1, (Strategy.L1, Strategy.L1_UB),
                        it_freq, it_range,
                    )
                    l1_left[c] -= it.bytes
                else:
                    strat_r, rep_cost = model.best_strategy(
                        chunk_tab, rep_batch, 1, (Strategy.GM, Strategy.GM_UB),
                        it_freq, it_range,
                    )
                assignments.append(
                    ChunkAssignment(
                        it.table_idx,
                        c,
                        it.row_offset,
                        it.rows,
                        strat_r,
                        batch_frac=(r, replicas),
                    )
                )
                load[c] += rep_cost

    if access is not None and access["dedup"]:
        access["unique_cap"] = size_unique_cap(tables, batch, assignments, freqs)

    dedup_armed = bool(access is not None and access["dedup"])
    kmeta = kernel_meta(
        tables, batch, assignments, model, freqs, kernel_path, dedup_armed
    )

    plan = Plan(
        workload_name=workload.name,
        n_cores=n_cores,
        assignments=tuple(assignments),
        symmetric_tables=tuple(sym_tables),
        symmetric_strategies=tuple(sym_strats),
        meta={
            "planner": "asymmetric" + ("+lpt" if lpt else "")
            + ("+rep" if replicate_hot else "")
            + ("+freq" if freqs is not None else "")
            + ("+dedup" if dedup else "")
            + ("+cache" if cache else ""),
            "lif": float(lif(load)) if load.sum() else 1.0,
            "fell_back": fell_back,
            "distribution": _distribution_meta(freqs, len(tables)),
        },
    )
    if access is not None:
        plan.meta["cache"] = access
    plan.meta["kernel"] = kmeta
    plan.validate(tables)
    return plan


def _plan_hierarchical(workload, n_cores, model, **kw):
    raise NotImplementedError(
        "planner='hierarchical' (the two-level mesh planner) is not ported "
        "yet: ROADMAP A4"
    )


PLANNERS = {
    "baseline": plan_baseline,
    "symmetric": plan_symmetric,
    "asymmetric": plan_asymmetric,
    "hierarchical": _plan_hierarchical,
}
