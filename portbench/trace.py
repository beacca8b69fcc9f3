"""What a traced run reads after its window: a profiled stretch of the same
closed loop, and the context each per-layer metric's reader gets.

The stretch runs ``STRETCH_BATCHES`` batches of the loop under
``torch.profiler``, opened and closed by the marker kernels of
:func:`portbench.yardstick.profile_calls`.  Its window is the card's
timeline from the first to the last operation of those batches; the card
is busy where a kernel, copy or set runs, and each idle gap is named by the
harness's host range (``portbench.release``, ``step``, ``readback``,
``wait``) that overlaps it most.
"""
from __future__ import annotations

import dataclasses
import functools

from portbench import spec, yardstick

__all__ = ["Context", "STRETCH_BATCHES", "busy_and_gaps"]

STRETCH_BATCHES = 24
_TOP = 10


def busy_and_gaps(intervals: list[tuple[float, float]]) -> tuple[float, float, list]:
    """Union length of ``intervals``, the window from their first start to
    their last end, and the gaps inside it as ``(start, end)``."""
    if not intervals:
        return 0.0, 0.0, []
    spans = sorted(intervals)
    busy, gaps = 0.0, []
    cur0, cur1 = spans[0]
    for s, e in spans[1:]:
        if s > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, s))
            cur0, cur1 = s, e
        else:
            cur1 = max(cur1, e)
    busy += cur1 - cur0
    return busy, max(e for _, e in spans) - spans[0][0], gaps


def _stretch_once(state, n_batches: int):
    import torch

    from portbench.harness import run_loop

    stream = torch.cuda.current_stream()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for cycles in yardstick.OPEN_CYCLES:
            torch.cuda._sleep(cycles)
        stream.synchronize()
        run_loop(state, n_batches=n_batches, keep=False)
        torch.cuda._sleep(1_000)
        stream.synchronize()
    events = yardstick.device_events(prof)
    marks = sorted((e for e in events if yardstick.MARK in e.name),
                   key=lambda e: e.time_range.start)
    if len(marks) < 2:
        return None
    lo = max(e.time_range.end for e in marks[:-1])  # the opening markers' end
    hi = marks[-1].time_range.start  # the closing marker's start
    ours = [e for e in events if yardstick.MARK not in e.name
            and lo <= e.time_range.start and e.time_range.end <= hi]
    if not ours or sum(e.self_device_time_total for e in ours) <= 0:
        return None
    host = [e for e in prof.events() if e.name.startswith("portbench.")
            and e.device_type == torch.autograd.DeviceType.CPU]
    return ours, host, prof


def stretch(state, trace_path=None, n_batches: int = STRETCH_BATCHES,
            sessions: int = 3) -> dict | None:
    """The card's busy and idle time over a profiled stretch of the loop,
    its longest operations and idle gaps; ``None`` off the card, or when no
    session of ``sessions`` kept its records.  The kept session's trace
    goes to ``trace_path`` (Chrome's format) where one is given."""
    import torch

    if state.device.type != "cuda":
        return None
    got = None
    for _ in range(sessions):
        got = _stretch_once(state, n_batches)
        if got is not None:
            break
    if got is None:
        return None
    ours, host, prof = got
    if trace_path is not None:
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
    busy, window, gaps = busy_and_gaps([(e.time_range.start, e.time_range.end) for e in ours])
    ops: dict = {}
    for e in ours:
        ops[e.name] = ops.get(e.name, 0.0) + e.self_device_time_total
    named = []
    for g0, g1 in gaps:
        best, name = 0.0, "host.other"
        for h in host:
            overlap = min(g1, h.time_range.end) - max(g0, h.time_range.start)
            if overlap > best:
                best, name = overlap, h.name
        named.append([name, (g1 - g0) / 1e6])
    torch.cuda.synchronize()
    return {
        "busy_s": busy / 1e6, "window_s": window / 1e6,
        "device_ops": [[n[:160], t / 1e6] for n, t in
                       sorted(ops.items(), key=lambda kv: -kv[1])[:_TOP]],
        "idle_gaps": sorted(named, key=lambda g: -g[1])[:_TOP],
    }


@dataclasses.dataclass
class Context:
    """What a per-layer reader sees: the cell, the run's state (the
    program's engine and the harness's pool), the window's batches, and the
    profiled stretch (taken once, on first use; ``None`` off the card)."""

    cell: spec.Cell
    state: object
    batches: list
    start: float
    seconds: float
    seed: int = 0

    @functools.cached_property
    def stretch(self) -> dict | None:
        """:func:`stretch` of this run, its trace written under
        ``portbench/out/``."""
        path = self.cell.root / "portbench" / "out" / f"trace-{self.cell.name}-{self.seed}.json"
        return stretch(self.state, path)

    @property
    def completed(self) -> int:
        end = self.start + self.seconds
        return sum(1 for bt in self.batches if bt.error is None and bt.done <= end)
