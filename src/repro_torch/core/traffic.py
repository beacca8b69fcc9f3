"""Modeled per-batch traffic of a placement and of the fused executor.

The reference's analytic traffic model, ported as is so that its figures
equal the reference's for the same plan and pack (including the
reference's ``ragged_block_b`` batch chunking, a TPU VMEM concern the
port's kernels do not have):

* :func:`modeled_hbm_traffic` — bytes per executor path of a packed plan
  (the fused streaming kernel, the retired per-slot scan, a plain gather)
  and the rejoin volume (:func:`modeled_rejoin_traffic`, which also
  prices one rank's slice of a pack);
* :func:`modeled_plan_traffic` — expected lookup bytes of a placement
  under an access histogram, with the access reduction's post-dedup and
  post-cache figures and cache hit rate when asked (``dedup=``/
  ``cache_rows=``); ``InferenceEngine.plan_report`` reads its per-chunk
  bytes;
* :func:`modeled_kernel_path_traffic` — the dedup'd gather priced one-hot
  and sparse per chunk, against the plan's recorded choices;
* :func:`modeled_cross_host_traffic` — the bytes a two-level mesh's
  rejoin puts on the cross-host tier, against a flat pooled all-gather.

All figures are modeled from the plan's geometry; none is measured.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import freq_of
from repro_torch.core.partition import PackedPlan, cache_plan_entries
from repro_torch.core.strategies import Plan, Strategy
from repro_torch.core.tables import TableSpec
from repro_torch.kernels.embedding_multi import ragged_block_b

__all__ = [
    "modeled_cross_host_traffic",
    "modeled_hbm_traffic",
    "modeled_kernel_path_traffic",
    "modeled_plan_traffic",
    "modeled_rejoin_traffic",
]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def modeled_hbm_traffic(
    packed: PackedPlan, *, batch: int, seq: int, n_tables: int
) -> dict:
    """Analytic traffic per path -> nested dict of byte counts, the
    reference's model of its TPU data flow (windows streamed once per core
    and batch chunk, or every dense slot's whole chunk, ids, output, rejoin
    volume); equal to the reference's figures for the same pack.  Modeled,
    not measured on the card."""
    item = packed.chunk_data.element_size()
    e = int(packed.chunk_data.shape[-1])
    k = packed.n_cores
    slot_table = _host(packed.slot_table)
    slot_rows = _host(packed.slot_rows)
    n_real_slots = int((slot_table >= 0).sum())

    idx_bytes = n_real_slots * batch * seq * 4
    out_bytes = n_real_slots * batch * e * item

    if packed.layout == "dense":
        # every slot's whole padded chunk, on every core
        s_max = slot_table.shape[1]
        rpad = int(packed.chunk_data.shape[-2])
        window_bytes = k * s_max * rpad * e * item
        scan_bytes = window_bytes
        batch_chunks = 1
    else:
        step_slot = _host(packed.step_slot)
        step_block = _host(packed.step_block)
        br = packed.block_r
        _, batch_chunks = ragged_block_b(
            batch, seq, e, br, block_b=packed.block_b or None,
            unique_cap=packed.unique_cap, cache_rows=packed.cache_rows,
        )
        window_bytes = 0
        for core in range(k):
            real = step_slot[core] < slot_table.shape[1]
            n_blocks = len(np.unique(step_block[core][real]))
            refetch = 1 if (~real).any() and n_blocks else 0
            window_bytes += (n_blocks + refetch) * br * e * item
        window_bytes *= batch_chunks
        # the retired per-slot scan: every real slot paid the core-max window
        scan_bytes = 0
        for core in range(k):
            real = slot_table[core] >= 0
            if real.any():
                max_alloc = int(
                    (-(-(slot_rows[core][real] + 1) // br) * br).max()
                )
                scan_bytes += int(real.sum()) * max_alloc * e * item

    gather_bytes = n_real_slots * batch * seq * e * item

    paths = {
        "fused": {
            "window_bytes": int(window_bytes),
            "idx_bytes": idx_bytes,
            "out_bytes": out_bytes,
            "batch_chunks": int(batch_chunks),
            "total": int(window_bytes) + idx_bytes + out_bytes,
        },
        "per_slot_scan_legacy": {
            "window_bytes": int(scan_bytes),
            "idx_bytes": idx_bytes,
            "out_bytes": out_bytes,
            "total": int(scan_bytes) + idx_bytes + out_bytes,
        },
        "xla_gather": {
            "row_bytes": gather_bytes,
            "idx_bytes": idx_bytes,
            "out_bytes": out_bytes,
            "total": gather_bytes + idx_bytes + out_bytes,
        },
    }

    return {
        "itemsize": item,
        "batch": batch,
        "seq": seq,
        "paths": paths,
        "rejoin": modeled_rejoin_traffic(packed, batch=batch, n_tables=n_tables),
    }


def modeled_rejoin_traffic(packed: PackedPlan, *, batch: int, n_tables: int) -> dict:
    """The rejoin's volume: total bytes sent across the group by ring
    collectives, per rejoin mode.  Reads only the replicated rejoin maps,
    so one rank's slice of a pack prices the whole group's rejoin."""
    item = packed.chunk_data.element_size()
    e = int(packed.chunk_data.shape[-1])
    send = _host(packed.rejoin_send)
    k = int(send.shape[0])
    dense_partial = n_tables * batch * e * item
    psum_bytes = 2 * max(k - 1, 0) * dense_partial
    off_core_sends = 0
    for c in range(k):
        for d in range(k):
            if c != d:
                off_core_sends += int((send[c, d] >= 0).sum())
    a2a_bytes = off_core_sends * batch * e * item
    o = int(packed.rejoin_bucket.shape[1])
    gather_rejoin = max(k - 1, 0) * k * o * batch * e * item
    return {
        "psum_bytes": int(psum_bytes),
        "ring_bytes": int(psum_bytes),
        "sparse_all_to_all_bytes": int(a2a_bytes),
        "sparse_all_gather_bytes": int(gather_rejoin),
        "sparse_bytes": int(a2a_bytes + gather_rejoin),
    }


def modeled_plan_traffic(
    plan: Plan,
    tables: Sequence[TableSpec],
    batch: int,
    freqs=None,
    *,
    dedup: bool = False,
    cache_rows: int = 0,
) -> dict:
    """Expected per-batch HBM *lookup* bytes of a placement under an access
    histogram (DESIGN.md §5) — the drift benchmark's deterministic metric.

    Per chunk: the expected lookups landing in it are ``B·s·mass`` where
    ``mass`` is the chunk's share of the table's access mass
    (``freq.range_mass``; uniform ``rows/m`` when no histogram is given).

    * ``GM``     — every landing lookup streams one row from HBM;
    * ``GM-UB``  — the chunk is streamed HBM→VMEM once per batch regardless
      of where lookups land;
    * ``L1``/``L1-UB`` — resident in the persistent buffer: zero steady-state
      HBM bytes (the promotion payoff).

    A frequency-aware plan that pins the hot slice in L1 collapses this
    figure under skew; a stale plan whose L1 slice went cold pays the full
    GM bill again.  Symmetric-group tables are priced the same way over the
    whole table (UB streams once per core since every core sweeps its own
    replica of the table).

    ``dedup``/``cache_rows`` additionally report the access-reduction
    subsystem's **post** figures (DESIGN.md §6) under a ``"post"`` key —
    the pre keys are byte-identical to the PR3 model either way:

    * per GM chunk, cache-resident rows (the same per-core carve
      ``pack_plan`` materializes, via ``cache_plan_entries``) leave the HBM
      bill entirely, and with ``dedup`` the surviving lookups pay
      ``min(lookups, E[unique rows])`` (``RowProbs.expected_unique``);
    * GM-UB streams the chunk once regardless (dedup-neutral); L1/L1-UB
      stay at zero; the symmetric group runs outside the fused executor and
      is never dedup'd.
    """
    from repro_torch.data.distributions import RowProbs

    total = 0.0
    per_table = [0.0] * len(tables)
    per_chunk = []  # parallel to plan.assignments (the plan_report tree)
    l1_bytes = 0
    post_wanted = bool(dedup or cache_rows)
    post_total = 0.0
    post_per_table = [0.0] * len(tables)
    cached_lookups = 0.0
    asym_lookups = 0.0
    cached_ids: dict[int, list[int]] = {}
    if post_wanted and cache_rows:
        for _core, lst in cache_plan_entries(
            plan, tables, freqs, cache_rows
        ).items():
            for _s_i, a, gid, _w in lst:
                cached_ids.setdefault(id(a), []).append(gid)
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
        if post_wanted:
            n = eff_batch * t.seq
            asym_lookups += n * mass
            pb = b
            if a.strategy is Strategy.GM:
                fh = f if f is not None else RowProbs.uniform(t.rows)
                ids = cached_ids.get(id(a), [])
                cache_mass = fh.mass_of_ids(np.asarray(ids)) if ids else 0.0
                cached_lookups += n * cache_mass
                lookups = n * max(mass - cache_mass, 0.0)
                if dedup:
                    lookups = min(
                        lookups,
                        fh.expected_unique(lo, hi, n, skip_top=len(ids)),
                    )
                pb = lookups * t.row_bytes
            post_total += pb
            post_per_table[a.table_idx] += pb
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
        post_total += b  # symmetric path: no dedup/cache
        post_per_table[ti] += b
    out = {
        "batch": int(batch),
        "hbm_lookup_bytes": int(total),
        "per_table_bytes": [int(b) for b in per_table],
        "per_chunk_bytes": per_chunk,
        "l1_resident_bytes": int(l1_bytes),
    }
    if post_wanted:
        out["post"] = {
            "dedup": bool(dedup),
            "cache_rows": int(cache_rows),
            "hbm_lookup_bytes": int(post_total),
            "per_table_bytes": [int(b) for b in post_per_table],
            "cache_hit_rate": cached_lookups / max(asym_lookups, 1e-30),
            "reduction_vs_pre": total / max(post_total, 1e-30),
        }
    return out


def modeled_kernel_path_traffic(
    plan: Plan,
    tables: Sequence[TableSpec],
    batch: int,
    freqs=None,
    *,
    model=None,
    block_r: int | None = None,
) -> dict:
    """Modeled gather-side cost/bytes of the kernel-path choice per chunk
    (DESIGN.md §11) — the crossover columns the benches report.

    Per placed chunk, prices the dedup'd unique-row gather both ways with
    :meth:`CostModel.kernel_path_costs` (one-hot: ``U·R`` equality
    materialization + MXU flops; sparse: ``U`` row copies + per-step loop
    overhead) and totals three schedules: forced one-hot, forced sparse, and
    ``auto`` = the plan's recorded per-chunk picks
    (``plan.meta["kernel"]["per_chunk"]``; absent records fall back to the
    per-chunk argmin, which is what the planner would have recorded).  By
    construction ``auto_us <= min(onehot_us, sparse_us)`` — the acceptance
    invariant the bench gate checks.
    """
    from repro_torch.core.cost_model import analytic_model

    model = model or analytic_model()
    block_r = (
        block_r
        or int((plan.meta.get("layout") or {}).get("block_r") or 0)
        or 512
    )
    per_chunk_meta = (plan.meta.get("kernel") or {}).get("per_chunk") or []
    per_chunk = []
    tot = {
        "onehot_us": 0.0, "sparse_us": 0.0, "auto_us": 0.0,
        "onehot_bytes": 0.0, "sparse_bytes": 0.0, "auto_bytes": 0.0,
    }
    for i, a in enumerate(plan.assignments):
        chunk_tab = dataclasses.replace(tables[a.table_idx], rows=a.rows)
        eff_batch = batch // max(a.replicas, 1)
        costs = model.kernel_path_costs(
            chunk_tab, eff_batch, 1, freq_of(freqs, a.table_idx),
            (a.row_offset, a.row_offset + a.rows), block_r=block_r,
        )
        argmin = "sparse" if costs["sparse"] < costs["onehot"] else "onehot"
        path = (
            per_chunk_meta[i].get("path", argmin)
            if i < len(per_chunk_meta) else argmin
        )
        tot["onehot_us"] += costs["onehot"] * 1e6
        tot["sparse_us"] += costs["sparse"] * 1e6
        tot["auto_us"] += costs[path] * 1e6
        tot["onehot_bytes"] += costs["onehot_bytes"]
        tot["sparse_bytes"] += costs["sparse_bytes"]
        tot["auto_bytes"] += costs[f"{path}_bytes"]
        per_chunk.append({
            "table": a.table_idx,
            "core": a.core,
            "rows": a.rows,
            "unique": costs["unique"],
            "path": path,
            "onehot_us": costs["onehot"] * 1e6,
            "sparse_us": costs["sparse"] * 1e6,
            "onehot_bytes": costs["onehot_bytes"],
            "sparse_bytes": costs["sparse_bytes"],
        })
    n_sparse = sum(1 for r in per_chunk if r["path"] == "sparse")
    return {
        "batch": int(batch),
        "block_r": int(block_r),
        "per_chunk": per_chunk,
        "n_sparse": n_sparse,
        "n_onehot": len(per_chunk) - n_sparse,
        **{k: float(v) for k, v in tot.items()},
        "auto_never_worse": tot["auto_us"]
        <= min(tot["onehot_us"], tot["sparse_us"]) * (1 + 1e-9) + 1e-12,
    }


def modeled_cross_host_traffic(
    plan: Plan,
    tables: Sequence[TableSpec],
    batch: int,
    freqs=None,
    *,
    mesh_shape: tuple[int, int] | None = None,
    out_itemsize: int = 4,
) -> dict:
    """Modeled per-batch bytes crossing host boundaries on a two-level mesh,
    the reference's model, equal to its figures for the same plan.

    The hierarchical data flow crosses the slow host tier exactly once: the
    ``all_gather`` of the per-host owner buckets.  In the unique-row wire
    format the model prices, each ``(table, holding host)`` bucket entry
    carries the host's post-dedup payload —
    ``min(E[unique rows], unique_cap, rows held)`` rows of
    ``row_bytes + 4`` (the row plus its batch-position id) — and an
    H-host all-gather moves every entry to the ``H - 1`` other hosts:

    ``cross_host_bytes = (H-1) · Σ_(t,h) min(U_th, cap, rows_th) · (row_bytes + 4)``

    ``U_th`` is :meth:`RowProbs.expected_unique` over the batch's
    ``B · seq`` draws restricted to host ``h``'s row spans of table ``t``
    (uniform assumption when no histogram is given); ``cap`` is the plan's
    packed dedup width (``plan.meta["cache"]["unique_cap"]``, the clamp
    that makes the figure FLAT in batch size past dedup saturation —
    absent/0 means no clamp and the bytes keep growing with the batch).

    The flat baseline is the host-oblivious placement's pooled rejoin: the
    dense per-table ``(B, E)`` partials all-gathered across hosts,
    ``flat_allgather_bytes = (H-1) · N · B · E · out_itemsize`` — batch-
    scaled by construction.  ``reduction_vs_flat`` is their ratio.

    ``mesh_shape`` defaults to ``plan.meta["mesh"]`` (a flat plan models as
    one host: zero cross-host bytes, reduction 1.0).  The executable rejoin
    adds pooled ``(B, E)`` bucket entries (on one card, inside one device);
    this function prices the unique-row wire format a cross-host transport
    would use.  Modeled, not measured on the card.
    """
    from repro_torch.data.distributions import RowProbs

    if mesh_shape is None:
        mesh_meta = plan.meta.get("mesh") or {}
        mesh_shape = (
            int(mesh_meta.get("hosts", 1)),
            int(mesh_meta.get("cores_per_host", plan.n_cores)),
        )
    hosts, cph = int(mesh_shape[0]), int(mesh_shape[1])
    cap = int((plan.meta.get("cache") or {}).get("unique_cap") or 0)
    n_tables = len(tables)
    e = tables[0].dim if tables else 0

    # rows each (table, host) holds, merged over the host's chunks
    spans: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for a in plan.assignments:
        h = a.core // max(cph, 1)
        spans.setdefault((a.table_idx, h), []).append(
            (a.row_offset, a.row_offset + a.rows)
        )

    entries = []
    hier = 0.0
    unique_total = 0.0
    per_host = [0.0] * hosts
    for (ti, h), sp in sorted(spans.items()):
        t = tables[ti]
        f = freq_of(freqs, ti)
        if f is None:
            f = RowProbs.uniform(t.rows)
        n = batch * t.seq
        rows_held = sum(hi - lo for lo, hi in sp)
        u = sum(f.expected_unique(lo, hi, n) for lo, hi in sp)
        payload_rows = min(u, float(rows_held), float(n))
        if cap:
            payload_rows = min(payload_rows, float(cap))
        nbytes = payload_rows * (t.row_bytes + 4)
        hier += nbytes
        unique_total += u
        per_host[h] += nbytes
        entries.append({
            "table": ti,
            "host": h,
            "rows_held": int(rows_held),
            "expected_unique": float(u),
            "payload_rows": float(payload_rows),
            "bytes": float(nbytes),
        })
    # symmetric-group tables rejoin with a batch-split all_gather that is
    # inherently batch-scaled and crosses hosts: charge them at the flat
    # rate (hierarchical plans have no symmetric group for exactly this
    # reason).
    sym_bytes = len(plan.symmetric_tables) * batch * e * out_itemsize

    factor = max(hosts - 1, 0)
    cross = factor * (hier + sym_bytes)
    flat = factor * n_tables * batch * e * out_itemsize
    return {
        "hosts": hosts,
        "cores_per_host": cph,
        "batch": int(batch),
        "unique_cap": cap,
        "bucket_entries": len(entries),
        "expected_unique_rows": float(unique_total),
        "cross_host_bytes": float(cross),
        "flat_allgather_bytes": float(flat),
        "reduction_vs_flat": (
            flat / cross if cross > 0 else 1.0
        ),
        "per_host_bytes": [float(factor * b) for b in per_host],
        "per_entry": entries,
    }
