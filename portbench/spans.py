"""The program's own spans and counters (``repro_torch.tracing``), read once
per traced run for every reader of a program span or counter.

:func:`program` runs, on first use in a run, a profiled stretch of
``trace.STRETCH_BATCHES`` batches of the loop (``trace._stretch_once``), in
which the program's ``repro.*`` spans record, and then one pass of the loop
over the pool inside ``repro_torch.tracing.counting()``.  From the stretch:

* the device time of the kernels and copies launched under each span, a
  batch: each device operation goes to the span whose device-side record
  holds it, and counts for that span, every ``repro.*`` span above it in
  the profiler's host event tree, and the batch of the harness's
  ``portbench.step`` range above it (:func:`_device_ms`); the median over
  the batches (``device_ms``);
* each idle gap of the card, put down to where the host was meanwhile: at
  each instant the innermost ``repro.*`` span, else the innermost harness
  range (``portbench.*``), else ``host.other`` (``idle_s``).

Both, and the counters with the counting pass's time, go to
``portbench/out/spans-<cell>-<seed>.json``.  A program without spans gives
no device part, one without counters no counts: the readers then return
``None``.  Counting adds small reductions to the device's stream, so the
pass runs after the stretch.
"""
from __future__ import annotations

import bisect
import json
import statistics
import time

import numpy as np

from portbench import trace

__all__ = ["HOST_OTHER", "PROGRAM", "count_share", "device_ms", "idle_by_span", "program"]

PROGRAM = "repro."  # the program's span names begin so
STEP = "portbench.step"
HOST_OTHER = "host.other"
_EPS_US = 1e-3  # a device record's bounds are its operations' own


def idle_by_span(gaps, program_spans, harness_ranges) -> list[list]:
    """Each gap ``(start, end)`` split by where the host was: a list, per
    gap, of ``[name, length]`` pieces in time order.  A piece goes to the
    innermost span of ``program_spans`` that covers it (the latest to
    start, since spans on one thread nest), else to the innermost range of
    ``harness_ranges``, else to :data:`HOST_OTHER`.  Spans and ranges are
    ``(start, end, name)``; times in any one unit."""
    layers = []
    for ivs in (program_spans, harness_ranges):
        ivs = sorted(ivs)
        layers.append((np.array([s for s, _, _ in ivs], dtype=float),
                       np.array([e for _, e, _ in ivs], dtype=float),
                       [n for _, _, n in ivs]))
    edges = np.concatenate([t for starts, ends, _ in layers for t in (starts, ends)])
    out = []
    for g0, g1 in gaps:
        cuts = sorted({g0, g1, *edges[(edges > g0) & (edges < g1)].tolist()})
        pieces: list[list] = []
        for a, b in zip(cuts[:-1], cuts[1:]):
            mid, name = (a + b) / 2, HOST_OTHER
            for starts, ends, names in layers:
                cover = np.flatnonzero((starts <= mid) & (ends > mid))
                if cover.size:
                    name = names[cover[np.argmax(starts[cover])]]
                    break
            if pieces and pieces[-1][0] == name:
                pieces[-1][1] += b - a
            else:
                pieces.append([name, b - a])
        out.append(pieces)
    return out


def _device_ms(prof, steps, device_ops) -> dict[str, list[float]] | None:
    """Device ms under each ``repro.*`` span, a batch: ``{span: [ms of
    batch 0, 1, ...]}`` over the ``portbench.step`` ranges ``steps``.

    A span that launches device work has a device-side record too (the
    profiler's ``gpu_user_annotation``), from the first to the last record
    launched directly inside it; with one host thread and one stream the
    k-th such record of a name belongs to the k-th host span of that name.
    Each operation of ``device_ops`` goes to the innermost such record
    around it, and counts for that host span, every ``repro.*`` span above
    it in the host's event tree, and the batch of the ``portbench.step``
    above it.  ``None`` where a name's device and host records do not pair
    up."""
    import torch

    cpu_type = torch.autograd.DeviceType.CPU
    host: dict[str, list] = {}
    device: dict[str, list] = {}
    for e in prof.events():
        if e.name.startswith(PROGRAM):
            if e.device_type == cpu_type:
                host.setdefault(e.name, []).append(e)
            elif e.is_user_annotation:
                device.setdefault(e.name, []).append(e)
    records = []
    for name, recs in device.items():
        on_host = sorted(host.get(name, []), key=lambda e: e.time_range.start)
        if len(on_host) != len(recs):
            return None
        recs = sorted(recs, key=lambda e: e.time_range.start)
        records += [(d.time_range.start, d.time_range.end, h) for d, h in zip(recs, on_host)]
    step_starts = [s.time_range.start for s in steps]
    owners = []  # per record: the repro.* names it counts for, and its batch
    for _, _, span in records:
        names, batch, node = [], None, span
        while node is not None:
            if node.name.startswith(PROGRAM):
                names.append(node.name)
            elif node.name == STEP:
                batch = bisect.bisect_right(step_starts, node.time_range.start) - 1
            node = node.cpu_parent
        owners.append((names, batch))
    starts = np.array([r[0] for r in records], dtype=float)
    ends = np.array([r[1] for r in records], dtype=float)
    per: dict[str, list[float]] = {}
    for e in device_ops:
        t0, t1 = e.time_range.start, e.time_range.end
        around = np.flatnonzero((starts <= t0 + _EPS_US) & (ends >= t1 - _EPS_US))
        if not around.size:
            continue
        names, batch = owners[around[np.argmax(starts[around])]]
        if batch is None:
            continue
        for name in names:
            per.setdefault(name, [0.0] * len(steps))[batch] += (t1 - t0) / 1e3
    return per


def _read_session(got) -> dict | None:
    import torch

    ours, host, prof = got
    program_spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.name.startswith(PROGRAM)
                     and e.device_type == torch.autograd.DeviceType.CPU]
    steps = sorted((e for e in host if e.name == STEP), key=lambda e: e.time_range.start)
    if not steps:
        return None
    per_batch = _device_ms(prof, steps, ours)
    if not per_batch:
        return None
    busy, window, gaps = trace.busy_and_gaps(
        [(e.time_range.start, e.time_range.end) for e in ours])
    split = idle_by_span(gaps, program_spans,
                         [(e.time_range.start, e.time_range.end, e.name) for e in host])
    idle: dict[str, float] = {}
    for pieces in split:
        for name, us in pieces:
            idle[name] = idle.get(name, 0.0) + us / 1e6
    return {
        "batches": len(steps), "busy_s": busy / 1e6, "window_s": window / 1e6,
        "device_ms": {n: statistics.median(v) for n, v in sorted(per_batch.items())},
        "device_ms_per_batch": dict(sorted(per_batch.items())),
        "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        # every gap, longest first: [seconds, [[span or range, seconds], ...]]
        "gaps": sorted(([(g1 - g0) / 1e6, [[n, us / 1e6] for n, us in pieces]]
                        for (g0, g1), pieces in zip(gaps, split)), key=lambda g: -g[0]),
    }


def _stretch(state, sessions: int = 3) -> dict | None:
    """The stretch read by span (:func:`_read_session`); ``None`` off the
    card, for a program without spans, or when no session of ``sessions``
    kept its records whole."""
    import torch

    if state.device.type != "cuda":
        return None
    for _ in range(sessions):
        got = trace._stretch_once(state, trace.STRETCH_BATCHES)
        torch.cuda.synchronize()
        if got is None:
            continue
        if not any(e.name.startswith(PROGRAM) for e in got[2].events()):
            return None  # a program without spans
        read = _read_session(got)
        if read is not None:
            return read
    return None


def _counts(state) -> dict | None:
    try:
        from repro_torch.tracing import counting
    except ImportError:  # a program without counters
        return None
    from portbench.harness import run_loop

    t = time.perf_counter()
    with counting() as counts:
        run_loop(state, n_batches=len(state.pool), keep=False)
    return {"counts": counts, "counting_s": time.perf_counter() - t}


def program(ctx) -> dict:
    """The run's program spans and counters, measured on first use:
    ``{"stretch": dict or None, "counts": dict or None, "counting_s"}``."""
    got = vars(ctx).get("_program")
    if got is None:
        got = {"stretch": _stretch(ctx.state), "counts": None, "counting_s": None}
        got.update(_counts(ctx.state) or {})
        path = ctx.cell.root / "portbench" / "out" / f"spans-{ctx.cell.name}-{ctx.seed}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(got, indent=1))
        vars(ctx)["_program"] = got
    return got


def device_ms(ctx, *names: str) -> float | None:
    """Median over the stretch's batches of the device ms under the spans
    ``names`` together, a batch; ``None`` off the card or where the program
    recorded none of them."""
    s = program(ctx)["stretch"]
    if s is None:
        return None
    runs = [s["device_ms_per_batch"][f"{PROGRAM}{n}"] for n in names
            if f"{PROGRAM}{n}" in s["device_ms_per_batch"]]
    if not runs:
        return None
    return statistics.median(sum(batch) for batch in zip(*runs))


def count_share(ctx, part: str, *, of_misses: bool = False) -> float | None:
    """100 x counter ``part`` over ``lookups`` (over the lookups the cache
    misses, ``of_misses``); ``None`` where the program counted neither."""
    got = program(ctx)["counts"]
    if not got or part not in got or "lookups" not in got:
        return None
    base = got["lookups"] - (got.get("cache_hits", 0) if of_misses else 0)
    return 100.0 * got[part] / base if base > 0 else None
