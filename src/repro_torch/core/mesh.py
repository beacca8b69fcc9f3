"""Two-level (hosts x cores) mesh: geometry and the hierarchical planner.

A plan core is one partition of the work on one device (see
:mod:`repro_torch.core.partition`); ``mesh_shape = (hosts, cores_per_host)``
fixes how many there are and how they group.  In the reference, hosts are
machines whose cross-host links (``HardwareSpec.host_link_bw``) are an order
of magnitude slower than in-host links, so a placement that keeps each
table's rejoin inside one host crosses the slow tier only once.  On one
card a "host" is a group of plan cores and the rejoin is one device-local
reduction; the plans, maps and modeled bytes are the reference's, bit for
bit.

:func:`plan_hierarchical` (the registered ``"hierarchical"`` placement
policy) plans over a ``(hosts, cores_per_host)`` mesh:

1. **host-level rock pre-pass** — an un-chunkable table whose best
   single-core cost exceeds the LPT makespan bound is row-sharded over ALL
   ``H*C`` cores in host-contiguous slices;
2. **LPT host assignment** — remaining tables go *whole* to the least
   loaded host (descending priced cost), so every non-rock table's chunks,
   and therefore its entire in-host rejoin, live on one host;
3. **per-host asymmetric planning** — each host's table set is planned by
   :func:`~repro_torch.core.planner.plan_asymmetric` over its own ``C``
   cores (``shard_rocks=True``: the symmetric batch-split fallback spans
   the whole flat axis, so it is disabled), then chunk/core ids are
   remapped into the global flat core space ``host*C + core``.

A ``(1, n)`` mesh short-circuits to a verbatim ``plan_asymmetric`` call
(plus the ``plan.meta["mesh"]`` stamp), so the single-host path is
bit-identical to the flat planner.

The hierarchy reaches the executor only through the rejoin maps
(:func:`repro_torch.core.partition._rejoin_maps`): with ``hosts > 1`` each
table gets one owner core per holding host, all sharing one bucket
position, so ``rejoin_owned_pos`` keeps its ``(N,)`` shape and every core
sends only to an owner on its own host.
:func:`repro_torch.core.traffic.modeled_cross_host_traffic` prices the one
cross-host collective against a flat pooled all-gather.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from repro_torch.core.cost_model import CostModel, core_times, freq_of, lif
from repro_torch.core.planner import (
    _chunk_items,
    _distribution_meta,
    _validate_freqs,
    kernel_meta,
    plan_asymmetric,
    select_access_reduction,
    size_unique_cap,
)
from repro_torch.core.strategies import ChunkAssignment, Plan, Strategy
from repro_torch.core.tables import TableSpec, Workload

__all__ = [
    "MeshShapeError",
    "host_of_core",
    "plan_hierarchical",
    "resolve_mesh_shape",
]


class MeshShapeError(ValueError):
    """A mesh shape that cannot be planned or executed: non-integral
    geometry, a hosts/cores product disagreeing with ``n_cores``, or a
    plan whose core count does not match the devices the engine would
    execute on.  Subclasses ``ValueError`` so existing ``pytest.raises``
    guards keep matching; the message always says what to change."""


def resolve_mesh_shape(
    mesh_shape,
    n_cores,
    *,
    default_cores: int | None = None,
    warn: bool = True,
) -> tuple[int, int]:
    """Resolve the EngineConfig mesh fields to ``(hosts, cores_per_host)``.

    ``mesh_shape`` wins when given (a 2-sequence of positive ints; JSON
    round-trips deliver it as a list).  The legacy scalar ``n_cores`` keeps
    working as ``(1, n_cores)`` with a :class:`DeprecationWarning`; both
    given together must agree (``hosts * cores_per_host == n_cores``).
    Neither given resolves to ``(1, default_cores)`` — the engine passes
    ``torch.cuda.device_count()``.
    """
    if mesh_shape is not None:
        try:
            hosts, cph = (int(v) for v in mesh_shape)
        except (TypeError, ValueError):
            raise MeshShapeError(
                f"mesh_shape must be a (hosts, cores_per_host) pair of "
                f"positive ints, got {mesh_shape!r}"
            ) from None
        if hosts <= 0 or cph <= 0:
            raise MeshShapeError(
                f"mesh_shape entries must be positive, got {mesh_shape!r}"
            )
        if n_cores is not None and int(n_cores) != hosts * cph:
            raise MeshShapeError(
                f"mesh_shape {hosts}x{cph} = {hosts * cph} cores "
                f"disagrees with n_cores={n_cores}; drop the deprecated "
                "n_cores field (mesh_shape already determines it)"
            )
        return hosts, cph
    if n_cores is not None:
        if int(n_cores) <= 0:
            raise MeshShapeError(f"n_cores must be positive, got {n_cores}")
        if warn:
            warnings.warn(
                "EngineConfig.n_cores is deprecated: pass "
                f"mesh_shape=(1, {int(n_cores)}) instead (scalar n_cores "
                "plans a single-host mesh)",
                DeprecationWarning,
                stacklevel=3,
            )
        return 1, int(n_cores)
    return 1, int(default_cores or 1)


def host_of_core(core: int, cores_per_host: int) -> int:
    """Flat core id -> host id (cores are host-contiguous: host ``h`` owns
    ``[h*C, (h+1)*C)``)."""
    return core // max(cores_per_host, 1)


def plan_hierarchical(
    workload: Workload,
    n_cores: int,
    model: CostModel,
    *,
    hosts: int = 1,
    lif_threshold: float = 1.25,
    lpt: bool = False,
    rock_theta: float = 1.1,
    shard_rocks: bool = False,
    freqs=None,
    dedup: bool = False,
    cache: bool = False,
    cache_target: float = 0.75,
    max_cache_rows: int = 4096,
    kernel_path: str = "auto",
) -> Plan:
    """Hierarchical placement over a ``(hosts, n_cores // hosts)`` mesh.

    ``n_cores`` is the TOTAL flat core count (``hosts`` must divide it) —
    the planner keeps the flat planner signature so it registers as a
    normal :data:`~repro_torch.core.planner.PLANNERS` entry; the engine injects
    ``hosts`` from the resolved ``mesh_shape``.

    With ``hosts == 1`` this IS :func:`plan_asymmetric` (same kwargs,
    verbatim delegation) plus the ``plan.meta["mesh"]`` record — the
    collapse guarantee.  With ``hosts > 1``:

    * the symmetric LIF fallback is structurally disabled (it batch-splits
      over the whole flat axis, which crosses hosts per batch row), so the
      returned plan never has a symmetric group;
    * access-reduction arming (``dedup``/``cache``) is sized globally
      (one ``unique_cap``, one cache budget) exactly like the flat
      planner, but per-host sub-plans are priced under the armed model;
    * ``plan.meta["mesh"]`` records ``hosts``/``cores_per_host``/
      ``host_tables`` (which whole tables each host holds)/``rocks``
      (globally row-sharded table ids) — :func:`~repro_torch.core.partition.
      pack_plan` reads it to build the hierarchical rejoin maps.
    """
    hosts = int(hosts)
    if hosts <= 0:
        raise MeshShapeError(f"hosts must be positive, got {hosts}")
    if n_cores % hosts:
        raise MeshShapeError(
            f"hosts={hosts} must divide n_cores={n_cores} "
            "(cores are host-contiguous groups of equal size)"
        )
    cph = n_cores // hosts
    if hosts == 1:
        plan = plan_asymmetric(
            workload, n_cores, model,
            lif_threshold=lif_threshold, lpt=lpt, rock_theta=rock_theta,
            shard_rocks=shard_rocks, freqs=freqs, dedup=dedup, cache=cache,
            cache_target=cache_target, max_cache_rows=max_cache_rows,
            kernel_path=kernel_path,
        )
        held = {a.table_idx for a in plan.assignments}
        plan.meta["mesh"] = {
            "hosts": 1,
            "cores_per_host": n_cores,
            "host_tables": [sorted(held)],
            "rocks": [],
        }
        return plan

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

    costs = [best_single_core(i, t) for i, t in enumerate(tables)]

    # host-level rock pre-pass: a table no single core can carry without
    # blowing the LPT makespan bound is row-sharded over ALL flat cores in
    # host-contiguous slices — each host holds (and later rejoins) its own
    # slice locally; only the pooled bucket entry crosses hosts.
    rocks: list[int] = []
    rock_chunks: list[ChunkAssignment] = []
    if rock_theta is not None:
        bound = rock_theta * sum(costs) / n_cores
        chunkable = {
            it.table_idx
            for it in _chunk_items(tables, batch, model, freqs)
            if it.rows < tables[it.table_idx].rows
        }
        rocks = [
            i for i, c in enumerate(costs) if c > bound and i not in chunkable
        ]
        for i in rocks:
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

    # LPT host assignment: remaining tables go WHOLE to the least loaded
    # host (every host has the same core count, so total priced work per
    # host is the balance metric).  Host-locality is the point: one host
    # holds all of a table's chunks, so its rejoin never leaves the host.
    host_tables: list[list[int]] = [[] for _ in range(hosts)]
    host_load = np.zeros(hosts)
    for a in rock_chunks:
        h = host_of_core(a.core, cph)
        host_load[h] += model.predict(
            dataclasses.replace(tables[a.table_idx], rows=a.rows),
            batch, 1, a.strategy,
            freq_of(freqs, a.table_idx),
            (a.row_offset, a.row_offset + a.rows),
        )
    rock_set = set(rocks)
    order = sorted(
        (i for i in range(len(tables)) if i not in rock_set),
        key=lambda i: (-costs[i], i),
    )
    for i in order:
        h = int(np.argmin(host_load))
        host_tables[h].append(i)
        host_load[h] += costs[i]

    # per-host asymmetric planning over the host's own C cores, remapped
    # into the global flat core space.  shard_rocks=True: in-host rocks are
    # row-sharded over the host's cores and the symmetric fallback (which
    # would batch-split over the whole flat axis) is disabled.
    assignments: list[ChunkAssignment] = list(rock_chunks)
    host_lifs: list[float] = []
    for h in range(hosts):
        ids = sorted(host_tables[h])
        host_tables[h] = ids
        if not ids:
            host_lifs.append(1.0)
            continue
        sub_wl = Workload(
            name=workload.name,
            tables=tuple(tables[i] for i in ids),
            batch=batch,
        )
        sub_freqs = (
            [freq_of(freqs, i) for i in ids] if freqs is not None else None
        )
        sub = plan_asymmetric(
            sub_wl, cph, model,
            lif_threshold=lif_threshold, lpt=lpt, rock_theta=rock_theta,
            shard_rocks=True, freqs=sub_freqs, kernel_path="auto",
        )
        for a in sub.assignments:
            assignments.append(
                dataclasses.replace(
                    a, table_idx=ids[a.table_idx], core=h * cph + a.core
                )
            )
        host_lifs.append(float(sub.meta.get("lif", 1.0)))

    if access is not None and access["dedup"]:
        access["unique_cap"] = size_unique_cap(tables, batch, assignments, freqs)
    dedup_armed = bool(access is not None and access["dedup"])
    kmeta = kernel_meta(
        tables, batch, assignments, model, freqs, kernel_path, dedup_armed
    )

    load = core_times(
        model, tables, batch, tuple(assignments), n_cores, {}, freqs
    )
    plan = Plan(
        workload_name=workload.name,
        n_cores=n_cores,
        assignments=tuple(assignments),
        symmetric_tables=(),
        symmetric_strategies=(),
        meta={
            "planner": f"hierarchical({hosts}x{cph})"
            + ("+lpt" if lpt else "")
            + ("+freq" if freqs is not None else "")
            + ("+dedup" if dedup else "")
            + ("+cache" if cache else ""),
            "lif": float(lif(load)) if load.sum() else 1.0,
            "fell_back": False,
            "distribution": _distribution_meta(freqs, len(tables)),
            "mesh": {
                "hosts": hosts,
                "cores_per_host": cph,
                "host_tables": [list(host_tables[h]) for h in range(hosts)],
                "rocks": list(rocks),
                "host_lif": host_lifs,
            },
        },
    )
    if access is not None:
        plan.meta["cache"] = access
    plan.meta["kernel"] = kmeta
    plan.validate(tables)
    return plan
