"""Spans and counters inside the program, for a profiler or a benchmark to read.

:func:`span` names a stretch of the lookup or the step.  While a
``torch.profiler`` session records, it opens
``torch.profiler.record_function("repro.<name>")``, so the span lands in
the profiler's host timeline beside the device's kernels and copies (one
clock), and each kernel launched inside it hangs under it in the
profiler's event tree; otherwise it is one shared no-op context, and costs
a flag read.

:func:`count` adds to a counter of the access path, and does anything only
inside a :func:`counting` block: device values are summed on their device,
with no synchronize, and read once when the block exits.  Counting adds
small reductions to the device's stream, so it belongs outside a timed or
profiled stretch.

Spans: ``lookup`` (:func:`repro_torch.core.partition.partitioned_lookup`)
with ``lookup.index_copy``, ``lookup.slot_ids``, ``lookup.access``,
``lookup.scatter`` (the plain join only: the card's sparse rejoin has
none) and ``lookup.rejoin`` inside it; ``step.bottom_mlp``,
``step.interact`` and ``step.top_mlp``
(:func:`repro_torch.models.dlrm.forward_packed`).  Counters: ``lookups``
(valid lookups) and ``cache_hits`` (those the residency cache serves), from
the hot/cold split; ``unique_rows`` and ``spilled`` (lookups past
``unique_cap``, read row by row), from the batch dedup; ``index_entries``
(entries of the ``(N, B, s)`` indices, ``-1`` padding included) and
``index_copy_bytes`` (their bytes where they arrive as anything but a
tensor on the lookup's device, else 0), from the index copy;
``slot_id_entries`` (entries of every slot's ``(K, S, B, s)`` ids), from
the slot ids.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.autograd import profiler as _profiler

__all__ = ["count", "counting", "span"]

_NOOP = contextlib.nullcontext()
_COUNTS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "repro_torch_counts", default=None)


def span(name: str):
    """``record_function("repro.<name>")`` while a profiler records, else
    the shared no-op context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(f"repro.{name}")
    return _NOOP


def count(name: str, value) -> None:
    """Inside :func:`counting`, add to counter ``name``: an int adds
    itself, a bool tensor its true entries, an id tensor its entries
    ``>= 0`` (the port's ``-1`` marks no id).  Outside it, nothing."""
    counts = _COUNTS.get()
    if counts is None:
        return
    if isinstance(value, torch.Tensor):
        value = (value if value.dtype == torch.bool else value >= 0).sum(dtype=torch.int64)
    counts[name] = counts.get(name, 0) + value


@contextlib.contextmanager
def counting():
    """Record :func:`count` calls of this thread inside the block into the
    dict it yields, whose values are ints once the block exits."""
    counts: dict = {}
    token = _COUNTS.set(counts)
    try:
        yield counts
    finally:
        _COUNTS.reset(token)
        for name, value in counts.items():
            counts[name] = int(value)
