"""Deterministic fault injection for the serving data plane.

The containment machinery (fail-only-your-batch, degraded mode) and the
integrity subsystem (validation, checksums, NaN guards) are only
trustworthy if they are *exercised*: :class:`FaultInjector` threads seeded,
reproducible faults through named points in the runtime so the tests and
``chip_smoke.py`` can drive each fault type and assert detection and blast
radius.  The injector is the JAX package's: the same :class:`FaultPlan`
fires the same sequence and draws the same random numbers.

Fault-point catalog (where each point fires):

* ``"step"``   — inside ``Server._execute``, immediately before the primary
  ``step_fn`` call.  ``mode="crash"`` raises :class:`InjectedFault` there,
  exercising batch-failure containment (and degraded mode when repeated);
* ``"buffer"`` — in ``Server.pump`` before execution.  Mutating modes
  (``"bitflip"``, ``"nan-rows"``) call the armed ``corrupt`` hook (see
  :func:`arm_buffer_corruption`) which silently corrupts the live packed
  buffers — the server is NOT told, detection must come from the checksum
  cadence or the NaN output guard;
* ``"query"``  — the traffic generator's injection point:
  :meth:`FaultInjector.poison_queries` rewrites a batch's index stream with
  out-of-vocab / negative ids, exercising the validation policies;
* ``"replan"`` — inside the engine's drift ``replan`` callable.
  ``mode="crash"`` raises (a replan_error the pump contains);
  ``mode="stall"`` parks the build thread on an injector-held event until
  :meth:`FaultInjector.release_stalls` (or a safety timeout), exercising
  the stuck-replan abandonment path.

Every firing is recorded in ``injector.events`` (point, mode, batch) so a
bench can compute detection rates against ground truth.  All randomness
comes from the plan's seed: the same :class:`FaultPlan` against the same
traffic reproduces the same corruption, bit for bit.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import numpy as np

__all__ = [
    "FAULT_POINTS",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "arm_buffer_corruption",
]

FAULT_POINTS = ("step", "buffer", "query", "replan")


class InjectedFault(RuntimeError):
    """The exception a ``step``/``replan`` crash fault raises."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: fires once, at the first eligible firing of its
    ``point`` with batch index >= ``at_batch``.

    ``mode`` selects the behavior per point (see the module catalog);
    ``count`` scales mutating faults (bit flips / NaN rows / poisoned
    queries)."""

    point: str
    at_batch: int = 0
    mode: str = ""
    count: int = 1

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; known: {list(FAULT_POINTS)}"
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FaultPlan:
    """A seeded, serializable schedule of faults."""

    faults: list[FaultSpec] = dataclasses.field(default_factory=list)
    seed: int = 0

    def to_dict(self) -> dict:
        return {"seed": self.seed, "faults": [f.to_dict() for f in self.faults]}

    @classmethod
    def from_dict(cls, d) -> "FaultPlan":
        return cls(
            faults=[FaultSpec(**f) for f in d.get("faults", [])],
            seed=int(d.get("seed", 0)),
        )


class FaultInjector:
    """Executes a :class:`FaultPlan` against the runtime's named points.

    The runtime calls :meth:`fire` at each point; matching unfired specs
    trigger.  Components that own mutable state *arm* hooks the injector
    calls instead of raising (``"corrupt"`` for packed-buffer faults)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.events: list[dict] = []
        self._hooks: dict[str, Callable] = {}
        self._fired: set[int] = set()
        self._stall = threading.Event()

    def arm(self, name: str, hook: Callable) -> None:
        self._hooks[name] = hook

    def fire(self, point: str, *, batch: int | None = None, **ctx) -> None:
        """Trigger any eligible fault at ``point``.  ``batch=None`` means
        the caller has no batch index (e.g. the replan thread): every
        unfired spec at that point is eligible."""
        for i, f in enumerate(self.plan.faults):
            if f.point != point or i in self._fired:
                continue
            if batch is not None and batch < f.at_batch:
                continue
            self._fired.add(i)
            self.events.append(
                {"point": point, "mode": f.mode or "crash",
                 "batch": None if batch is None else int(batch)}
            )
            if point == "step" or (point == "replan" and f.mode != "stall"):
                raise InjectedFault(
                    f"injected {f.mode or 'crash'} at {point!r}"
                    + (f" (batch {batch})" if batch is not None else "")
                )
            if point == "replan":  # stall: park until released (bounded)
                self._stall.wait(timeout=ctx.get("max_stall_s", 60.0))
            elif point == "buffer":
                hook = self._hooks.get("corrupt")
                if hook is not None:
                    hook(f.mode or "bitflip", max(f.count, 1), self.rng)

    def poison_queries(self, batch: int, idx, rows) -> tuple[np.ndarray, int]:
        """Query-stream injection: rewrite ``count`` random entries of the
        batch's stacked ``(N, B, s)`` index array with invalid ids (OOV for
        ``mode="oov"``, ``< -1`` for ``mode="negative"``).  Returns the
        (possibly poisoned) array and how many *queries* were touched."""
        idx = np.asarray(idx)
        rows = np.asarray(rows, np.int64)
        poisoned: set[int] = set()
        for i, f in enumerate(self.plan.faults):
            if f.point != "query" or i in self._fired or batch < f.at_batch:
                continue
            self._fired.add(i)
            idx = idx.copy()
            n, b = idx.shape[0], idx.shape[1]
            for _ in range(max(f.count, 1)):
                t = int(self.rng.integers(n))
                q = int(self.rng.integers(b))
                s = int(self.rng.integers(idx.shape[2])) if idx.ndim > 2 else None
                val = (
                    -int(self.rng.integers(2, 100))
                    if f.mode == "negative"
                    else int(rows[t]) + int(self.rng.integers(1000))
                )
                if s is None:
                    idx[t, q] = val
                else:
                    idx[t, q, s] = val
                poisoned.add(q)
            self.events.append(
                {"point": "query", "mode": f.mode or "oov", "batch": int(batch),
                 "queries": len(poisoned)}
            )
        return idx, len(poisoned)

    def release_stalls(self) -> None:
        """Un-park any stalled replan threads (end-of-run cleanup)."""
        self._stall.set()

    def summary(self) -> dict:
        return {
            "plan": self.plan.to_dict(),
            "fired": len(self._fired),
            "events": list(self.events),
        }


def arm_buffer_corruption(injector: FaultInjector, engine, server) -> None:
    """Arm the ``"buffer"`` point's ``corrupt`` hook against a live
    engine+server pair: flips bits (``"bitflip"``) or NaN-poisons rows
    (``"nan-rows"``) inside real slot regions of ``engine.packed``'s ragged
    buffer, in place on the buffer's device, without telling the server's
    counters.  A bit flip flips the bit the JAX package flips in its numpy
    copy: the element viewed as a signed integer of its width, xor'ed with
    the same mask.  The steps read ``engine.packed`` when they run, so the
    next batch sees the damage; a step that carries ``rebuild`` is rebuilt
    all the same, as in the JAX package.  Detection must come from the
    integrity subsystem."""
    import torch

    ints = {4: torch.int32, 2: torch.int16}

    def corrupt(mode: str, count: int, rng) -> None:
        packed = engine.packed
        chunk = packed.chunk_data
        slot_table = np.asarray(packed.slot_table.cpu())
        slot_start = np.asarray(packed.slot_row_start.cpu())
        slot_rows = np.asarray(packed.slot_rows.cpu())
        cores, slots = np.nonzero(slot_table >= 0)
        for _ in range(count):
            j = int(rng.integers(len(cores)))
            c, s = int(cores[j]), int(slots[j])
            # hit the slot's hottest rows (the low ids under a skewed
            # distribution) so the corruption actually reaches served output
            r = int(slot_start[c, s]) + int(
                rng.integers(min(int(slot_rows[c, s]), 8))
            )
            if mode == "nan-rows":
                chunk[c, r, :] = float("nan")
            else:
                col = int(rng.integers(chunk.shape[2]))
                bits = chunk.element_size() * 8
                raw = chunk[c, r, col : col + 1].view(ints[chunk.element_size()])
                raw ^= 1 << int(rng.integers(bits - 1))
        rebuild = getattr(server.step_fn, "rebuild", None)
        if rebuild is not None:
            server.step_fn = rebuild()

    injector.arm("corrupt", corrupt)
