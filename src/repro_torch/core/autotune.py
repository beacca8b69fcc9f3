"""Block-size sweep for the fused ragged kernel, timed on the serving device.

``block_r`` trades step count against chunk padding: a large row block
means fewer, bigger steps but pads every small chunk up to the block, while
a small block keeps padding tight at the cost of more steps.  ``block_b``
is the reference's resident batch tile, recorded for parity (the port's
grid tiles the batch itself).

:func:`autotune_block_sizes` packs the plan abstractly (zero tables) at
each candidate on the serving device, runs the fused lookup of every core
with synthetic indices drawn from the histograms (the kernel's per-slot
partials; the join after it moves the same bytes under every block size),
and records the sweep in
``plan.meta["tuning"]`` with the reference's keys.  Every candidate carries
``wall_us``, the host clock around ``iters`` lookups ending in a
synchronize, and ``device_us``.  On the card ``device_us`` is the card's own
time for one lookup: CUDA events on a stream the sweep owns, around
``iters`` lookups (after a warm-up call, which also builds the kernels)
that wait behind a spin kernel until the host has enqueued them all, so
the card runs them back to back and neither the host's gaps nor another
thread's kernels, which run on other streams, are in the time; the sweep
ranks by it (:func:`best_candidate`) and records ``"compiled": True``.  A
sweep runs so on a worker thread too (a drift replan's shadow build) while
the server launches its own kernels; it opens no profiler session.
The host clock ranks only the host's enqueue there.  On the CPU
``device_us`` is ``None``, the sweep times the kernels' plain versions and
ranks by ``wall_us``, and records ``"compiled": False``, as the reference
records interpret mode: the ranking then reflects step count and padding,
not the card.  The reference times its heaviest core alone; here one launch
runs all cores, so the whole launch is timed.  Across cards (``mesh=``)
each rank packs and times its own core, and every candidate is ranked by
the slowest rank's time (an ``all_reduce`` of ``MAX`` over the core axis):
the reference's heaviest core, and one pick on every rank.

:class:`TuningCache` memoizes whole sweeps on a (plan shape digest, backend)
key, the backend being ``"cuda"`` or ``"cpu"``; the access histograms are
left out of the key, so a shape-identical replan under new traffic is a
hit.  :func:`plan_shape_digest` equals the reference's for the same backend
string.
"""
from __future__ import annotations

import hashlib
import json
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import freq_of
from repro_torch.core.partition import _fused_slot_partials, pack_plan
from repro_torch.core.strategies import Plan
from repro_torch.core.tables import TableSpec

__all__ = ["TuningCache", "autotune_block_sizes", "best_candidate", "plan_shape_digest"]

_BLOCK_R_CANDIDATES = (64, 128, 256, 512)

# the spin kernel (torch.cuda._sleep) that holds a candidate's lookups on
# the sweep's stream while the host enqueues them (~5 ms at first); a spin
# that ended before the enqueue did is run again four times as long, up to
# _GATES times
_GATE_CYCLES = 10_000_000
_GATES = 5


class TuningCache:
    """Sweep-result memo keyed on (plan shape digest, backend).

    The digest covers everything that shapes the timed kernels (per-core
    chunk inventory, per-chunk kernel path, table dims, batch, the candidate
    grids, the backend) and nothing that does not (access histograms, table
    contents).  ``save``/``load`` round-trip the store as JSON."""

    def __init__(self):
        self._store: dict[str, dict] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def lookup(self, key: str) -> dict | None:
        rec = self._store.get(key)
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def store(self, key: str, record: dict) -> None:
        self._store[key] = record

    def stats(self) -> dict:
        return {"entries": len(self._store), "hits": self.hits, "misses": self.misses}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self._store, f)

    def load(self, path) -> None:
        with open(path) as f:
            self._store.update(json.load(f))


def plan_shape_digest(
    plan: Plan,
    tables: Sequence[TableSpec],
    batch: int,
    backend: str,
    candidates: tuple = (),
) -> str:
    """Stable digest of everything that shapes an autotune sweep's kernels."""
    kernel_meta = plan.meta.get("kernel") or {}
    access_meta = plan.meta.get("cache") or {}
    paths = [r.get("path") for r in kernel_meta.get("per_chunk") or []]
    payload = {
        "backend": backend,
        "batch": int(batch),
        "tables": [(t.rows, t.dim, t.seq) for t in tables],
        "chunks": sorted(
            (a.core, a.table_idx, a.row_offset, a.rows, str(a.strategy),
             list(a.batch_frac))
            for a in plan.assignments
        ),
        "sym": sorted(plan.symmetric_tables),
        "access": [
            int(access_meta.get("unique_cap") or 0),
            int(access_meta.get("cache_rows") or 0),
        ],
        "kernel": [kernel_meta.get("path"), paths],
        "candidates": [list(c) for c in candidates],
    }
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def _synthetic_indices(tables, batch, freqs, seed) -> np.ndarray:
    """(N, batch, s_max) int32 ids drawn from ``freqs`` (uniform where a
    table has no histogram), as the reference draws them."""
    from repro_torch.data.distributions import _sample_from_probs

    s_max = max(t.seq for t in tables)
    rng = np.random.default_rng(seed)
    idx = np.full((len(tables), batch, s_max), -1, np.int32)
    for i, t in enumerate(tables):
        f = freq_of(freqs, i)
        if f is not None and len(f.ids):
            idx[i, :, : t.seq] = _sample_from_probs(rng, f, (batch, t.seq))
        else:
            idx[i, :, : t.seq] = rng.integers(0, t.rows, (batch, t.seq))
    return idx


def best_candidate(candidates: Sequence[dict], backend: str) -> dict:
    """The sweep's pick: the candidate with the least ``device_us`` on the
    card (``backend == "cuda"``), else the least ``wall_us``."""
    key = "device_us" if backend == "cuda" else "wall_us"
    return min(candidates, key=lambda c: c[key])


def _device_us(run, calls: int, stream) -> float:
    """The card's time for one ``run()`` in microseconds: CUDA events on
    ``stream`` around ``calls`` runs that wait behind a spin kernel on it,
    over ``calls``.  The events count when the spin still held the runs
    after the host had enqueued them all (the start event not yet reached),
    so the card ran them back to back; else the spin runs again four times
    as long, up to ``_GATES`` times, and then it raises.  Only ``stream``'s
    work is in the time: other threads' kernels run on other streams, and
    slow it only where they share the card."""
    cycles = _GATE_CYCLES
    for _ in range(_GATES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            torch.cuda._sleep(cycles)
            start.record(stream)
            for _ in range(calls):
                run()
            end.record(stream)
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) * 1e3 / calls
        cycles *= 4
    raise RuntimeError(
        f"the host's enqueue of {calls} lookups outlasted every gate "
        f"(the last spun {cycles // 4:,} cycles)")


def _rank_by_slowest(candidates: list, group, device) -> None:
    """Each candidate's times become the slowest rank's (``all_reduce``
    MAX over ``group``), the rank's own kept as ``rank_*``."""
    import torch.distributed as dist

    keys = ["wall_us"] + (["device_us"] if candidates[0]["device_us"] is not None else [])
    t = torch.tensor([[c[key] for key in keys] for c in candidates], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    for c, row in zip(candidates, t.tolist()):
        for key, v in zip(keys, row):
            c[f"rank_{key}"], c[key] = c[key], v


def autotune_block_sizes(
    plan: Plan,
    tables: Sequence[TableSpec],
    *,
    batch: int,
    block_r_candidates: Sequence[int] = _BLOCK_R_CANDIDATES,
    block_b_candidates: Sequence[int | None] = (None,),
    unique_cap_candidates: Sequence[int | None] = (None,),
    cache_rows_candidates: Sequence[int | None] = (None,),
    kernel_path_candidates: Sequence[str | None] = (None,),
    freqs=None,
    iters: int = 2,
    seed: int = 0,
    cache: TuningCache | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
    mesh=None,
) -> dict:
    """Sweep (block_r, block_b[, unique_cap, cache_rows, kernel_path]) on
    ``device``, record ``plan.meta["tuning"]``, return the best combination
    as ``{"block_r", "block_b", "unique_cap", "cache_rows", "kernel_path"}``
    (ready for :func:`repro_torch.core.partition.pack_plan`).

    The access axes default to the single candidate ``None`` = whatever
    ``plan.meta`` selected; ``"sparse"`` candidates are skipped where the
    effective dedup width is 0.  ``cache`` short-circuits the sweep when the
    plan-shape digest was swept before on this backend: the prior record is
    re-stamped into ``plan.meta["tuning"]`` with a hit marker.

    ``mesh`` times this rank's core alone (its place along ``"model"``) and
    ranks each candidate by the slowest rank's time, recorded as its
    ``wall_us``/``device_us``; the rank's own time is ``rank_wall_us``/
    ``rank_device_us``.  Every rank of ``mesh`` must call it together.
    """
    if not plan.assignments:
        plan.meta["tuning"] = {"candidates": [], "best": None}
        return {"block_r": None, "block_b": None, "unique_cap": None,
                "cache_rows": None, "kernel_path": None}
    device = torch.device(device)
    backend = device.type
    core, k = None, 1
    if mesh is not None:
        from repro_torch.launch.mesh import axis_rank, axis_size

        core, k = axis_rank(mesh, "model"), axis_size(mesh, "model")
    cache_key = None
    if cache is not None:
        cache_key = plan_shape_digest(
            plan, tables, batch, backend,
            (block_r_candidates, block_b_candidates, unique_cap_candidates,
             cache_rows_candidates, kernel_path_candidates, (iters, seed))
            + ((("model", k),) if mesh is not None else ()),
        )
        rec = cache.lookup(cache_key)
        if rec is not None:
            plan.meta["tuning"] = {
                **rec["tuning"],
                "cache": {"hit": True, "key": cache_key, **cache.stats()},
            }
            return dict(rec["best"])

    # on the card everything the sweep enqueues goes to a stream of its own
    stream = torch.cuda.Stream(device) if backend == "cuda" else None

    def sync():
        if stream is not None:
            stream.synchronize()

    meta_cap = int((plan.meta.get("cache") or {}).get("unique_cap") or 0)
    candidates = []
    with torch.cuda.stream(stream):
        idx = torch.from_numpy(_synthetic_indices(tables, batch, freqs, seed)).to(device)
        for br in dict.fromkeys(int(c) for c in block_r_candidates):
            for bb in dict.fromkeys(block_b_candidates):
                for uc in dict.fromkeys(unique_cap_candidates):
                    for cr in dict.fromkeys(cache_rows_candidates):
                        for kp in dict.fromkeys(kernel_path_candidates):
                            eff_cap = meta_cap if uc is None else int(uc)
                            if kp == "sparse" and not eff_cap:
                                continue  # no dedup machinery to ride
                            packed = pack_plan(
                                plan, tables, None, dtype=dtype, block_r=br, block_b=bb,
                                unique_cap=uc, cache_rows=cr, freqs=freqs,
                                kernel_path=kp, device=device, core=core,
                            )

                            def run():
                                _fused_slot_partials(packed, idx)

                            run()  # warm-up (builds the kernels on first use)
                            sync()
                            t0 = time.perf_counter()
                            for _ in range(iters):
                                run()
                            sync()
                            wall_us = (time.perf_counter() - t0) / iters * 1e6
                            device_us = (_device_us(run, iters, stream)
                                         if stream is not None else None)
                            lay = plan.meta["layout"]
                            candidates.append({
                                "block_r": br,
                                "block_b": 0 if bb is None else int(bb),
                                "unique_cap": int(packed.unique_cap),
                                "cache_rows": int(packed.cache_rows),
                                "kernel_path": packed.kernel_path if kp is None else kp,
                                "n_steps": lay["n_steps"],
                                "padding_frac": lay["padding_frac"],
                                "chunk_bytes": lay["chunk_bytes"],
                                "wall_us": wall_us,
                                "device_us": device_us,
                            })
                            del packed
    if not candidates:
        raise ValueError(
            "no feasible autotune candidates: every combination was skipped "
            "(kernel_path='sparse' needs a nonzero unique_cap candidate)"
        )
    if mesh is not None:
        _rank_by_slowest(candidates, mesh.get_group("model"), device)
    best = best_candidate(candidates, backend)
    tuning = {
        "candidates": candidates,
        "best": dict(best),
        "backend": backend,
        "compiled": backend == "cuda",
        "iters": iters,
    }
    result = {
        "block_r": best["block_r"],
        "block_b": best["block_b"] or None,
        "unique_cap": best["unique_cap"],
        "cache_rows": best["cache_rows"],
        "kernel_path": best["kernel_path"],
    }
    plan.meta["tuning"] = tuning
    if cache is not None:
        cache.store(cache_key, {"tuning": tuning, "best": dict(result)})
        plan.meta["tuning"] = {
            **tuning,
            "cache": {"hit": False, "key": cache_key, **cache.stats()},
        }
    return result
