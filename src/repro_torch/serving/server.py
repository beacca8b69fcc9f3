"""Continuous-batching serving runtime with explicit robustness semantics.

A deployment-shaped serving layer exercised at CPU scale (DESIGN.md §8).
The paper's asymmetric data flows make each batch fast; this runtime is
about what happens *between* batches under production traffic — the
SLA-vs-batching tension of Gupta et al. (1906.03109) and the
degrade-gracefully-under-spikes requirement of Park et al. (1811.09886):

* ``Batcher`` — queues single queries and releases batches on (max_batch |
  max_wait), the knob that trades P99 latency against throughput (paper
  Fig. 4's x-axis is exactly this batch size).  With ``adaptive=True`` it
  also releases early when the observed arrival rate says the batch cannot
  fill before the wait budget (or the oldest request's deadline) expires —
  waiting out the lockstep timer would only add latency;
* **admission control** — ``max_queue`` bounds the queue; on overflow the
  ``admission`` policy decides: ``"block"`` (pump in place until space —
  cooperative backpressure), ``"reject"`` (fail the new request with
  :class:`QueueFull`), ``"shed-oldest"`` (drop the stalest queued request,
  admit the new one).  Backpressure is a first-class signal instead of
  unbounded memory growth;
* **per-request deadlines** — ``deadline_s`` (server default, per-request
  override) sheds requests whose deadline already passed *before* spending
  execution on them; their handles fail with :class:`DeadlineExceeded`;
* **fault containment** — a ``step_fn`` exception fails only that batch's
  handles (:class:`BatchExecutionError`), never poisons the pump; after
  ``degrade_after`` consecutive failures the server enters a *degraded
  mode* that serves via ``fallback_step_fn`` (the reference non-fused path
  when built by :meth:`repro_torch.engine.InferenceEngine.serve`) and probes the
  primary every ``probe_every`` batches until one succeeds;
* request-level API — ``submit_request(payload) -> RequestHandle``: a
  Future-style handle filled with *that query's* slice of the batch output
  when the batch it rode in executes (``split_fn`` splits the batch result;
  default: index the leading axis).  ``handle.wait(timeout)`` blocks (for
  cross-thread drivers) and ``handle.result()`` raises the typed error the
  request failed with, so callers distinguish shed vs failed vs slow;
* hedged requests — if a batch's execution exceeds ``hedge_factor`` x the
  median, a backup execution is launched (simulated duplicate here) and the
  faster result wins: classic tail-taming for stragglers;
* drift replanning (``DriftConfig``, DESIGN.md §5) — a streaming frequency
  sketch over the served index streams, a hysteresis drift trigger against
  the histogram the live plan was priced under, shadow re-pack off the hot
  path, and an atomic plan hot-swap gated on one-batch old/new parity.
  With ``overlap=True`` the shadow re-pack runs on a worker thread and is
  polled across subsequent ``pump()`` calls, so the pump keeps serving
  while the replacement plan builds (the overlap-replan protocol).

Data-plane integrity (DESIGN.md §9) rides the same pump:

* **input validation** — a ``validator`` (built by the engine's validation
  policy, :mod:`repro_torch.serving.validation`) runs at batch release, before
  any device work: OOV/negative index counters always, sanitization under
  ``null-row``, and per-request failure with :class:`InvalidQueryError`
  under ``reject`` (blast radius: the offending request only);
* **corruption detection + self-heal** — when the engine wires an
  integrity manifest (``integrity={"check_every": N, "nan_guard": True}``),
  the pump re-checksums the packed buffers every N batches and NaN/Inf-
  guards every batch output (:class:`PoisonedOutputError` fails only that
  batch).  A detected mismatch triggers a targeted repair through the
  step's ``integrity_repair`` hook — corrupt regions are re-materialized
  from the source tables (or zero-quarantined) and the repaired step swaps
  in atomically, exactly like a drift hot-swap.  Drift hot-swaps verify the
  shadow's own manifest before cutover;
* **fault injection** — a :class:`repro_torch.serving.faults.FaultInjector` fires
  seeded faults at the named points (``step``/``buffer``) so
  ``benchmarks/chaosbench.py`` can measure detection + blast radius.

Every submitted request is accounted for exactly once::

    submitted == served + shed + rejected + failed + invalid + pending

(``deadline_misses`` counts the deadline-shed subset of ``shed``;
``invalid`` counts requests failed by ``reject``-mode validation; the
identity is surfaced by :meth:`Server.stats` and asserted by the
fault-injection tests and ``benchmarks/servebench.py``.)

The replanning state machine per served batch:

    serve -> sketch.update -> [every check_every batches]
      drift < threshold        -> strikes = 0                (stationary)
      drift >= threshold       -> strikes += 1               (hysteresis)
      strikes >= patience      -> shadow = replan(measured)  (off hot path;
                                  threaded when overlap=True)
                                  parity(old, shadow) on a live batch
                                  ok  -> step_fn = shadow    (atomic swap)
                                         baseline = measured; cooldown
                                  bad -> keep old plan; count parity_failure
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from repro_torch.data.distributions import FrequencySketch, drift_distance
from repro_torch.serving.latency import LatencyTracker

__all__ = [
    "BatchExecutionError",
    "Batcher",
    "DeadlineExceeded",
    "DriftConfig",
    "InvalidQueryError",
    "PoisonedOutputError",
    "Query",
    "QueueFull",
    "RequestHandle",
    "Server",
    "ServingError",
]

_PENDING = object()

ADMISSION_POLICIES = ("block", "reject", "shed-oldest")

# EWMA smoothing for the batcher's inter-arrival estimate: light enough to
# track a traffic shift within ~a batch of arrivals.
_ARRIVAL_ALPHA = 0.2


class ServingError(RuntimeError):
    """Base of the serving runtime's typed failures."""


class QueueFull(ServingError):
    """Admission denied (``reject``) or shed from a full queue
    (``shed-oldest``): the request never executed."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before a batch could execute it."""


class BatchExecutionError(ServingError):
    """The batch this request rode in failed in ``step_fn``; the original
    executor error is chained as ``__cause__``."""


class InvalidQueryError(ServingError):
    """The request failed input validation under the ``reject`` policy
    (out-of-vocab or negative indices); it never executed, and the rest of
    its batch served normally."""


class PoisonedOutputError(BatchExecutionError):
    """The batch executed but produced NaN/Inf output (the corruption
    guard); only this batch's handles fail, and an integrity sweep runs
    immediately to find and heal the poisoned buffer region."""


class RequestHandle:
    """Future-style result of one submitted query.

    Filled (or failed) when the batch containing the query executes in
    :meth:`Server.pump`; ``result()`` before that raises ``RuntimeError``
    (the serving loop is synchronous — ``pump()``/``drain()`` drive it).
    ``wait(timeout)`` blocks until the handle resolves, for drivers that
    pump the server from another thread."""

    __slots__ = ("_result", "_error", "_done")

    def __init__(self):
        self._result: Any = _PENDING
        self._error: BaseException | None = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the handle resolves (or ``timeout`` seconds pass);
        returns :meth:`done`.  In a single-threaded driver nothing else can
        resolve the handle, so call it with a timeout."""
        return self._done.wait(timeout)

    def result(self) -> Any:
        if self._error is not None:
            raise self._error
        if self._result is _PENDING:
            raise RuntimeError(
                "request not served yet — pump()/drain() the server first"
            )
        return self._result

    def _set(self, value: Any) -> None:
        self._result = value
        self._done.set()

    def _set_error(self, err: BaseException) -> None:
        self._error = err
        self._done.set()


@dataclasses.dataclass
class Query:
    payload: Any
    t_enqueue: float
    handle: RequestHandle | None = None
    deadline: float | None = None  # absolute clock time, None = no deadline


class Batcher:
    """Admission queue + release rule.

    Lockstep rule: release when ``max_batch`` queries are queued or the
    oldest has waited ``max_wait_s``.  ``adaptive=True`` adds the
    arrival-rate-aware early release: an EWMA of inter-arrival gaps
    estimates the time to *fill* the batch; when now + fill-time overshoots
    the wait budget (or the earliest queued deadline), the batch is
    released immediately — under a trickle of traffic the lockstep rule
    would park every query for the full ``max_wait_s`` for nothing."""

    def __init__(
        self,
        max_batch: int,
        max_wait_s: float = 0.005,
        *,
        adaptive: bool = False,
        clock: Callable[[], float] | None = None,
    ):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.adaptive = adaptive
        self.clock = clock or time.perf_counter
        self.queue: list[Query] = []
        self._ewma_gap: float | None = None
        self._last_arrival: float | None = None

    def submit(
        self,
        payload: Any,
        now: float | None = None,
        handle: RequestHandle | None = None,
        deadline: float | None = None,
    ) -> None:
        now = now if now is not None else self.clock()
        if self._last_arrival is not None:
            gap = max(now - self._last_arrival, 0.0)
            self._ewma_gap = (
                gap
                if self._ewma_gap is None
                else (1 - _ARRIVAL_ALPHA) * self._ewma_gap + _ARRIVAL_ALPHA * gap
            )
        self._last_arrival = now
        self.queue.append(Query(payload, now, handle, deadline))

    def expected_fill_s(self) -> float | None:
        """Expected further wait for the batch to fill at the observed
        arrival rate (None until two arrivals have been seen)."""
        if self._ewma_gap is None:
            return None
        return (self.max_batch - len(self.queue)) * self._ewma_gap

    def maybe_release(
        self, now: float | None = None, *, force: bool = False
    ) -> list[Query] | None:
        now = now if now is not None else self.clock()
        if not self.queue:
            return None
        release = (
            force
            or len(self.queue) >= self.max_batch
            or now - self.queue[0].t_enqueue >= self.max_wait_s
        )
        if not release and self.adaptive:
            fill = self.expected_fill_s()
            if fill is not None:
                budget = self.queue[0].t_enqueue + self.max_wait_s
                deadlines = [
                    q.deadline for q in self.queue if q.deadline is not None
                ]
                if deadlines:
                    budget = min(budget, min(deadlines))
                release = now + fill >= budget
        if release:
            batch, self.queue = (
                self.queue[: self.max_batch],
                self.queue[self.max_batch :],
            )
            return batch
        return None


@dataclasses.dataclass
class DriftConfig:
    """Online-replanning configuration for :class:`Server`.

    ``baseline`` — per-table ``RowProbs`` the live plan was priced under
    (``None`` entries mean the uniform assumption for that table).
    ``extract_indices`` — payload list -> stacked (N, B, s) int32 index array
    (``-1`` padding ignored), so the sketch sees the actual served lookups.
    ``replan`` — measured per-table ``RowProbs`` -> a *new step_fn*: the
    shadow re-pack (plan + pack + compile) runs inside this callable, off
    the pump's hot path from the old plan's point of view — the old plan
    keeps serving until the swap.

    ``overlap`` — ``True`` runs ``replan`` on a worker thread and polls it
    across subsequent ``pump()`` calls: serving continues on the old plan
    while the shadow builds, and the parity check + swap happen on the
    first batch served after the build completes (``Server.drain`` joins a
    still-running build so the swap is never lost at end of traffic).
    ``False`` (default) builds the shadow inline on the triggering batch —
    deterministic, but the pump stalls for the build.

    ``build_timeout_batches`` — an overlapped build still alive after this
    many further served batches is *abandoned*: the server stops polling
    it, counts ``replans_abandoned``, and becomes eligible to trigger a
    fresh replan after the cooldown — a wedged build thread must not pin
    the server to a stale plan forever.  ``None`` (default) waits
    indefinitely (the pre-existing behavior).

    ``metric`` — ``"topmass"`` (default): the sample-robust
    :func:`repro_torch.data.distributions.drift_distance`; ``"l1"``: raw exact L1
    distance (the textbook trigger — beware its finite-sample bias on large
    sparse tables, see the drift_distance docstring).  The trigger fires
    after ``patience`` consecutive over-threshold checks (hysteresis: one
    noisy window never replans) and then rests for ``cooldown`` batches.
    """

    baseline: Sequence[Any]
    extract_indices: Callable[[list[Any]], np.ndarray]
    replan: Callable[[list[Any]], Callable[[list[Any]], Any]]
    check_every: int = 8
    threshold: float = 0.2
    patience: int = 2
    cooldown: int = 32
    sketch_capacity: int = 4096
    metric: str = "topmass"
    parity_rtol: float = 1e-4
    parity_atol: float = 1e-5
    overlap: bool = False
    build_timeout_batches: int | None = None


class _ShadowBuild(threading.Thread):
    """One overlapped shadow re-pack: runs ``replan(measured)`` off the pump
    thread, parking either the built step_fn or the exception it raised."""

    def __init__(self, replan, measured):
        super().__init__(name="shadow-replan", daemon=True)
        self.replan = replan
        self.measured = measured
        self.step_fn = None
        self.error: BaseException | None = None
        self.abandoned = False  # set by the pump when the build times out

    def run(self):
        try:
            self.step_fn = self.replan(self.measured)
        except BaseException as e:  # surfaced as a replan_error by the pump
            self.error = e


def _tree_finite(x) -> bool:
    """NaN/Inf guard over a batch-output pytree (floating leaves only)."""
    if isinstance(x, dict):
        return all(_tree_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_tree_finite(v) for v in x)
    arr = np.asarray(x)
    if arr.dtype.kind != "f":
        return True
    return bool(np.all(np.isfinite(arr)))


def _tree_allclose(a, b, rtol: float, atol: float) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(
            _tree_allclose(a[k], b[k], rtol, atol) for k in a
        )
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            _tree_allclose(x, y, rtol, atol) for x, y in zip(a, b)
        )
    return np.allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


class Server:
    def __init__(
        self,
        step_fn: Callable[[list[Any]], Any],
        *,
        max_batch: int = 256,
        max_wait_s: float = 0.005,
        hedge_factor: float = 3.0,
        n_replicas: int = 2,
        layout: dict | None = None,
        exec_mode: dict | None = None,
        cache: dict | None = None,
        drift: DriftConfig | None = None,
        split_fn: Callable[[Any, int], Sequence[Any]] | None = None,
        max_queue: int | None = None,
        admission: str = "block",
        deadline_s: float | None = None,
        adaptive_batching: bool = False,
        fallback_step_fn: Callable[[list[Any]], Any] | None = None,
        degrade_after: int = 3,
        probe_every: int = 4,
        clock: Callable[[], float] | None = None,
        validator: Callable[[list[Any]], tuple] | None = None,
        integrity: Mapping[str, Any] | None = None,
        fault_injector: Any | None = None,
    ):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {admission!r}; "
                f"known: {list(ADMISSION_POLICIES)}"
            )
        if max_queue is not None and max_queue <= 0:
            raise ValueError(f"max_queue must be positive, got {max_queue}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        if probe_every <= 0:
            raise ValueError(f"probe_every must be positive, got {probe_every}")
        self.step_fn = step_fn
        self.clock = clock or time.perf_counter
        self.batcher = Batcher(
            max_batch, max_wait_s, adaptive=adaptive_batching, clock=self.clock
        )
        # batch output -> per-query results for submit_request handles;
        # default indexes the leading (batch) axis.
        self.split_fn = split_fn or (lambda out, n: [out[i] for i in range(n)])
        self.tracker = LatencyTracker()
        self.hedge_factor = hedge_factor
        self.n_replicas = max(n_replicas, 1)
        self.hedges = 0
        self._exec_times: list[float] = []
        # admission control + deadlines
        self.max_queue = max_queue
        self.admission = admission
        self.deadline_s = deadline_s
        # request accounting: submitted == served + shed + rejected + failed
        # + invalid + pending (queue), with deadline_misses the deadline-shed
        # subset of shed.  Every path below keeps the identity.
        self.submitted = 0
        self.served = 0
        self.rejected = 0
        self.shed = 0
        self.deadline_misses = 0
        self.failed = 0
        self.invalid = 0
        # input validation (DESIGN.md §9): counters always, sanitization /
        # per-request rejection per the validator's mode.
        self.validator = validator
        self.oov_indices = 0
        self.negative_indices = 0
        # buffer integrity: checksum cadence + NaN output guard, acting
        # through the step's integrity_verify/integrity_repair hooks.
        self.integrity_cfg = dict(integrity) if integrity else None
        self._integrity_every = (
            int(self.integrity_cfg.get("check_every", 0))
            if self.integrity_cfg
            else 0
        )
        self._nan_guard = (
            bool(self.integrity_cfg.get("nan_guard", True))
            if self.integrity_cfg
            else False
        )
        self.integrity_checks = 0
        self.corruptions_detected = 0
        self.heals = 0
        self.heal_failures = 0
        self.quarantined_regions = 0
        self.poisoned_batches = 0
        self.integrity_events: list[dict] = []
        # deterministic fault injection (chaosbench / tests)
        self.fault_injector = fault_injector
        # monotone executed-batch counter (includes failed batches): the
        # clock the integrity cadence and fault schedules run on.
        self.total_batches = 0
        # fault containment / degraded mode
        self.fallback_step_fn = fallback_step_fn
        self.degrade_after = degrade_after
        self.probe_every = probe_every
        self.batch_failures = 0
        self.degraded_batches = 0
        self.probes = 0
        self.probe_failures = 0
        self.degraded = False
        self._consecutive_failures = 0
        self._batches_since_probe = 0
        # packed-layout summary (plan.meta["layout"]) so deployment stats
        # report the executor's memory/padding efficiency alongside latency.
        self.layout = dict(layout) if layout else {}
        # executor configuration (use_kernels / reduce_mode / tuning): the
        # deployment-level record of which data-flow path served the traffic.
        self.exec_mode = dict(exec_mode) if exec_mode else {
            "use_kernels": "fused", "reduce_mode": "sparse"}
        # access-reduction record (plan.meta["cache"]): which dedup width /
        # residency cache the live plan carries; refreshed on every hot swap
        # (the shadow re-pack re-carves the cache from the measured sketch).
        self.cache = dict(cache) if cache else {}
        # drift replanning state
        self.drift = drift
        self.replans = 0
        self.parity_failures = 0
        self.replan_errors = 0
        self.replans_abandoned = 0
        self.replan_events: list[dict] = []
        self.last_drift = 0.0
        self.drift_checks = 0
        self._baseline = list(drift.baseline) if drift else []
        self._sketches: list[FrequencySketch | None] = (
            [
                FrequencySketch(b.rows, drift.sketch_capacity)
                if b is not None
                else None
                for b in self._baseline
            ]
            if drift
            else []
        )
        self._batches_served = 0
        self._strikes = 0
        self._rest_until = 0
        self._shadow_build: _ShadowBuild | None = None
        self._shadow_started = 0  # _batches_served when the build launched
        # (payloads, out) of the most recent successful batch — the parity
        # probe drain() uses when an overlapped build outlives the traffic.
        self._last_probe: tuple[list[Any], Any] | None = None

    # -- admission ----------------------------------------------------------

    def submit(
        self,
        payload: Any,
        *,
        deadline_s: float | None = None,
        now: float | None = None,
    ) -> None:
        """Fire-and-forget enqueue.  Raises :class:`QueueFull` when the
        queue is bounded, full, and the admission policy is ``reject``
        (there is no handle to fail)."""
        self._admit(payload, None, deadline_s, now)

    def submit_request(
        self,
        payload: Any,
        *,
        deadline_s: float | None = None,
        now: float | None = None,
    ) -> RequestHandle:
        """Request-level entry: enqueue one query, get a Future-style handle
        whose ``result()`` is that query's slice of the batch output.  A
        rejected request comes back as an already-failed handle
        (``result()`` raises :class:`QueueFull`) rather than raising here —
        backpressure is a per-request signal a closed-loop caller inspects."""
        handle = RequestHandle()
        self._admit(payload, handle, deadline_s, now)
        return handle

    def _admit(
        self,
        payload: Any,
        handle: RequestHandle | None,
        deadline_s: float | None,
        now: float | None,
    ) -> None:
        now = now if now is not None else self.clock()
        self.submitted += 1
        eff_deadline_s = deadline_s if deadline_s is not None else self.deadline_s
        deadline = now + eff_deadline_s if eff_deadline_s is not None else None
        if self.max_queue is not None and len(self.batcher.queue) >= self.max_queue:
            if self.admission == "reject":
                self.rejected += 1
                err = QueueFull(
                    f"admission queue full ({self.max_queue}); request rejected"
                )
                if handle is not None:
                    handle._set_error(err)
                    return
                raise err
            if self.admission == "shed-oldest":
                while len(self.batcher.queue) >= self.max_queue:
                    victim = self.batcher.queue.pop(0)
                    self.shed += 1
                    if victim.handle is not None:
                        victim.handle._set_error(
                            QueueFull(
                                f"shed from full queue ({self.max_queue}) "
                                f"to admit newer traffic"
                            )
                        )
            else:  # "block": cooperative backpressure — the submitting
                # caller pumps the server until space frees (each forced
                # pump consumes >= 1 queued query, so this terminates).
                while (
                    self.max_queue is not None
                    and len(self.batcher.queue) >= self.max_queue
                ):
                    self.pump(force=True)
        self.batcher.submit(payload, now=now, handle=handle, deadline=deadline)

    # -- execution ----------------------------------------------------------

    def _shed_expired(self, batch: list[Query], now: float) -> list[Query]:
        """Deadline gate at release time: a request already past its
        deadline is shed before any execution is spent on it."""
        live = []
        for q in batch:
            if q.deadline is not None and now > q.deadline:
                self.shed += 1
                self.deadline_misses += 1
                if q.handle is not None:
                    q.handle._set_error(
                        DeadlineExceeded(
                            f"deadline exceeded by {now - q.deadline:.4f}s "
                            f"before execution"
                        )
                    )
            else:
                live.append(q)
        return live

    def _primary(self, payloads: list[Any]) -> Any:
        """The primary step call, with the ``step`` fault point in front of
        it — an injected crash raises *inside* the containment try, exactly
        where a real executor fault would."""
        if self.fault_injector is not None:
            self.fault_injector.fire("step", batch=self.total_batches)
        return self.step_fn(payloads)

    def _execute(self, payloads: list[Any]) -> Any:
        """Run the step under the fault-containment state machine.

        HEALTHY: primary ``step_fn``; ``degrade_after`` consecutive failures
        (with a fallback available) enter DEGRADED.  DEGRADED: serve via
        ``fallback_step_fn``, probing the primary every ``probe_every``
        batches; one successful probe returns to HEALTHY.  Raises only when
        no path could serve the batch."""
        if self.degraded:
            self._batches_since_probe += 1
            if self._batches_since_probe >= self.probe_every:
                self._batches_since_probe = 0
                self.probes += 1
                try:
                    out = self._primary(payloads)
                except Exception:
                    self.probe_failures += 1
                else:
                    self.degraded = False
                    self._consecutive_failures = 0
                    return out
            self.degraded_batches += 1
            return self.fallback_step_fn(payloads)
        try:
            out = self._primary(payloads)
        except Exception:
            self._consecutive_failures += 1
            if (
                self.fallback_step_fn is not None
                and self.degrade_after > 0
                and self._consecutive_failures >= self.degrade_after
            ):
                # K strikes: degrade and serve THIS batch via the fallback
                # instead of failing it too.
                self.degraded = True
                self._batches_since_probe = 0
                self.degraded_batches += 1
                return self.fallback_step_fn(payloads)
            raise
        self._consecutive_failures = 0
        return out

    def pump(self, force: bool = False) -> Any | None:
        """Release + execute one batch if ready. Returns results or None.
        ``force=True`` releases whatever is queued even under ``max_batch``
        before ``max_wait_s`` (the drain/flush path)."""
        now = self.clock()
        batch = self.batcher.maybe_release(now, force=force)
        if batch is None:
            return None
        batch = self._shed_expired(batch, now)
        if not batch:
            return None
        if self.validator is not None:
            batch = self._validate(batch)
            if not batch:
                return None
        if self.fault_injector is not None:
            # the silent-corruption point: mutating faults damage the packed
            # buffers here WITHOUT telling the server — detection must come
            # from the checksum cadence / NaN guard below.
            self.fault_injector.fire("buffer", batch=self.total_batches)
        payloads = [q.payload for q in batch]
        self.total_batches += 1
        t0 = self.clock()
        try:
            out = self._execute(payloads)
        except Exception as e:
            # fault containment: the error fails only this batch's handles
            # and never propagates out of (or poisons) the pump.
            self.batch_failures += 1
            self.failed += len(batch)
            err = BatchExecutionError(
                f"batch of {len(batch)} failed in step_fn: {e!r}"
            )
            err.__cause__ = e
            for q in batch:
                if q.handle is not None:
                    q.handle._set_error(err)
            self._maybe_integrity_check()
            return None
        if self._nan_guard and not _tree_finite(out):
            # poisoned output: fail only this batch, then hunt the source —
            # an immediate integrity sweep finds + heals the bad region.
            self.poisoned_batches += 1
            self.batch_failures += 1
            self.failed += len(batch)
            err = PoisonedOutputError(
                f"batch of {len(batch)} produced non-finite output"
            )
            for q in batch:
                if q.handle is not None:
                    q.handle._set_error(err)
            self._integrity_sweep(reason="poisoned-output")
            return None
        dt = self.clock() - t0
        # hedging: a straggling execution is retried on a backup replica; we
        # model the win as the median execution time (the backup is healthy).
        if (
            len(self._exec_times) >= 8
            and dt > self.hedge_factor * float(np.median(self._exec_times))
            and self.n_replicas > 1
        ):
            self.hedges += 1
            dt = float(np.median(self._exec_times))
        self._exec_times.append(dt)
        now = self.clock()
        self.served += len(batch)
        self.tracker.record_depth(len(self.batcher.queue))
        for q in batch:
            self.tracker.record(now - q.t_enqueue, queries=1)
        if any(q.handle is not None for q in batch):
            try:
                parts = list(self.split_fn(out, len(batch)))
                if len(parts) != len(batch):
                    raise ValueError(
                        f"split_fn returned {len(parts)} parts for a "
                        f"{len(batch)}-query batch"
                    )
            except Exception as e:  # a bad split fails the handles, not pump
                for q in batch:
                    if q.handle is not None:
                        q.handle._set_error(e)
            else:
                for q, r in zip(batch, parts):
                    if q.handle is not None:
                        q.handle._set(r)
        if self.drift is not None:
            if self.drift.overlap:
                self._last_probe = (payloads, out)
            self._observe(payloads, out)
        self._maybe_integrity_check()
        return out

    # -- data-plane integrity (DESIGN.md §9) --------------------------------

    def _validate(self, batch: list[Query]) -> list[Query]:
        """Release-time input validation: count OOV/negative indices, apply
        the validator's sanitization, and (``reject`` mode) fail only the
        offending requests' handles.  A crashing validator fails the whole
        batch as invalid rather than poisoning the pump."""
        payloads = [q.payload for q in batch]
        try:
            payloads, counts, bad = self.validator(payloads)
        except Exception as e:
            self.invalid += len(batch)
            err = InvalidQueryError(f"validator failed on batch: {e!r}")
            err.__cause__ = e
            for q in batch:
                if q.handle is not None:
                    q.handle._set_error(err)
            return []
        self.oov_indices += int(counts.get("oov", 0))
        self.negative_indices += int(counts.get("negative", 0))
        live: list[Query] = []
        for i, q in enumerate(batch):
            if i in bad:
                self.invalid += 1
                if q.handle is not None:
                    q.handle._set_error(InvalidQueryError(bad[i]))
            else:
                q.payload = payloads[i]
                live.append(q)
        return live

    def _maybe_integrity_check(self) -> None:
        if self._integrity_every and self.total_batches % self._integrity_every == 0:
            self._integrity_sweep(reason="cadence")

    def _integrity_sweep(self, reason: str) -> None:
        """Verify the live step's buffer checksums; on a mismatch, repair
        through the step's ``integrity_repair`` hook and swap the repaired
        step in atomically (the same cut-over a drift hot-swap uses)."""
        verify = getattr(self.step_fn, "integrity_verify", None)
        if verify is None:
            return
        self.integrity_checks += 1
        try:
            bad = verify()
        except Exception as e:
            self.heal_failures += 1
            self.integrity_events.append(
                {"batch": self.total_batches, "reason": reason,
                 "error": repr(e)}
            )
            return
        if not bad:
            return
        self.corruptions_detected += len(bad)
        event = {
            "batch": self.total_batches,
            "reason": reason,
            "regions": [list(r) for r in bad],
            "healed": False,
        }
        repair = getattr(self.step_fn, "integrity_repair", None)
        if repair is None:
            self.heal_failures += 1
        else:
            try:
                fix = repair(bad)
            except Exception as e:
                self.heal_failures += 1
                event["error"] = repr(e)
            else:
                self.step_fn = fix["step_fn"]  # atomic cut-over
                if fix.get("fallback_step_fn") is not None:
                    # the fallback closes over the same buffers: a healed
                    # primary needs a healed reference path too.
                    self.fallback_step_fn = fix["fallback_step_fn"]
                report = fix.get("report") or {}
                self.heals += 1
                self.quarantined_regions += len(report.get("quarantined", []))
                event["healed"] = True
                event["report"] = report
        self.integrity_events.append(event)

    # -- drift replanning ---------------------------------------------------

    def _observe(self, payloads: list[Any], out: Any) -> None:
        """Feed the served batch to the sketches; maybe trigger a hot-swap."""
        d = self.drift
        idx = np.asarray(d.extract_indices(payloads))
        for i, sk in enumerate(self._sketches):
            if sk is not None and i < idx.shape[0]:
                sk.update(idx[i])
        self._batches_served += 1
        # a completed overlapped build swaps on this batch (parity probe)
        if self._shadow_build is not None:
            if self._shadow_build.is_alive():
                timeout = d.build_timeout_batches
                if (
                    timeout is not None
                    and self._batches_served - self._shadow_started >= timeout
                ):
                    self._abandon_shadow()
                return  # keep serving on the old plan while it builds
            self._finish_shadow(payloads, out)
            return
        if self._batches_served % d.check_every:
            return
        if self._batches_served < self._rest_until:
            return
        measured = [sk.to_probs() if sk else None for sk in self._sketches]
        self.last_drift = self._distance(measured)
        self.drift_checks += 1
        if self.last_drift >= d.threshold:
            self._strikes += 1
        else:
            self._strikes = 0
        if self._strikes < d.patience:
            return
        self._strikes = 0
        self._rest_until = self._batches_served + d.cooldown
        # shadow re-pack: the new plan is built + compiled while the old
        # step_fn remains live; only after parity does the swap happen.
        if d.overlap:
            self._shadow_build = _ShadowBuild(d.replan, measured)
            self._shadow_started = self._batches_served
            self._shadow_build.start()
            return
        build = _ShadowBuild(d.replan, measured)
        build.run()  # inline (synchronous) shadow build
        self._shadow_build = build
        self._finish_shadow(payloads, out)

    def _abandon_shadow(self) -> None:
        """Stop polling a wedged overlapped build: the (daemon) thread is
        left to die on its own, the server frees itself to replan again
        after the cooldown, and the incident is recorded."""
        build = self._shadow_build
        build.abandoned = True
        self._shadow_build = None
        self.replans_abandoned += 1
        self.replan_events.append(
            {
                "batch": self._batches_served,
                "drift": float(self.last_drift),
                "parity_ok": False,
                "abandoned": True,
            }
        )

    def _finish_shadow(self, payloads: list[Any], out: Any) -> None:
        """Join the shadow build and run the parity-gated atomic swap
        against a live batch's (payloads, output)."""
        build = self._shadow_build
        self._shadow_build = None
        if build.ident is not None:  # started as a thread (overlap mode)
            build.join()
        measured = build.measured
        if build.error is not None:
            # a crashing re-pack must not take serving down with it
            self.replan_errors += 1
            self.replan_events.append(
                {
                    "batch": self._batches_served,
                    "drift": float(self.last_drift),
                    "parity_ok": False,
                    "error": repr(build.error),
                }
            )
            return
        shadow = build.step_fn
        # integrity gate: a shadow whose freshly packed buffers already fail
        # their own manifest must never cut over.
        shadow_verify = getattr(shadow, "integrity_verify", None)
        if shadow_verify is not None:
            bad = shadow_verify()
            if bad:
                self.corruptions_detected += len(bad)
                self.integrity_events.append(
                    {"batch": self._batches_served, "reason": "hot-swap",
                     "regions": [list(r) for r in bad], "healed": False}
                )
                self.replan_events.append(
                    {"batch": self._batches_served,
                     "drift": float(self.last_drift),
                     "parity_ok": False, "integrity_ok": False}
                )
                return
        shadow_out = shadow(payloads)
        d = self.drift
        ok = _tree_allclose(out, shadow_out, d.parity_rtol, d.parity_atol)
        self.replan_events.append(
            {
                "batch": self._batches_served,
                "drift": float(self.last_drift),
                "parity_ok": bool(ok),
            }
        )
        if not ok:
            self.parity_failures += 1
            return
        self.step_fn = shadow  # atomic cut-over
        self.replans += 1
        self._baseline = measured
        # a fresh plan is a fresh primary: leave degraded mode and restart
        # the failure count (the fallback stays valid — same tables, same
        # math — for the next incident).
        self.degraded = False
        self._consecutive_failures = 0
        # the shadow re-pack re-materialized the residency cache from the
        # measured histograms — surface the new carve in stats()
        bag = getattr(shadow, "bag", None)
        if bag is not None:
            self.layout = dict(bag.layout_summary())
            self.cache = dict(bag.plan.meta.get("cache") or {})
        for sk in self._sketches:
            if sk is not None:
                sk.reset()

    def _distance(self, measured: list[Any]) -> float:
        d = self.drift
        worst = 0.0
        for m, b in zip(measured, self._baseline):
            if m is None or b is None or m.rows != b.rows:
                continue
            if d.metric == "l1":
                worst = max(worst, 0.5 * b.l1_distance(m))
            else:
                worst = max(worst, drift_distance(m, b))
        return worst

    # -- drain / stats ------------------------------------------------------

    def flush(self) -> Any | None:
        """Force-release one partial batch (the explicit flush path the old
        ``drain()`` lacked — it no-op pumped until ``max_wait_s`` elapsed)."""
        return self.pump(force=True)

    def drain(self, max_iters: int = 10_000) -> list[Query]:
        """Serve everything queued, force-releasing partial batches instead
        of busy-waiting on the (max_batch | max_wait) rule, and join any
        in-flight overlapped replan.  Returns the queries it could NOT
        serve (still queued after ``max_iters`` forced pumps) — empty on a
        clean drain — instead of dropping them silently."""
        it = 0
        while self.batcher.queue and it < max_iters:
            self.pump(force=True)
            it += 1
        if self._shadow_build is not None:
            # end of traffic with a shadow still building: join it and run
            # the parity probe on the last served batch's (payloads, out) —
            # the swap (and its event record) must not be lost.  With a
            # build timeout configured the join is bounded: a wedged build
            # must not hang the drain forever.
            build = self._shadow_build
            bounded = (
                self.drift is not None
                and self.drift.build_timeout_batches is not None
            )
            build.join(timeout=5.0 if bounded else None)
            if build.is_alive():
                self._abandon_shadow()
            elif self._last_probe is not None:
                self._finish_shadow(*self._last_probe)
            else:
                self._shadow_build = None
                if build.error is not None:
                    self.replan_errors += 1
        return list(self.batcher.queue)

    def stats(self) -> dict:
        s = self.tracker.summary()
        s["hedged_batches"] = self.hedges
        # request accounting — the identity submitted == served + shed +
        # rejected + failed + invalid + pending is checked by
        # tests/servebench/chaosbench.
        s["submitted"] = self.submitted
        s["served"] = self.served
        s["rejected"] = self.rejected
        s["shed"] = self.shed
        s["deadline_misses"] = self.deadline_misses
        s["failed"] = self.failed
        s["invalid"] = self.invalid
        s["pending"] = len(self.batcher.queue)
        s["batch_failures"] = self.batch_failures
        s["degraded_batches"] = self.degraded_batches
        s["degraded"] = self.degraded
        if self.probes:
            s["probes"] = self.probes
            s["probe_failures"] = self.probe_failures
        s["admission"] = {
            "policy": self.admission,
            "max_queue": self.max_queue,
            "deadline_s": self.deadline_s,
            "adaptive": self.batcher.adaptive,
        }
        if self.validator is not None:
            s["validation"] = {
                "mode": getattr(self.validator, "mode", "custom"),
                "oov_indices": self.oov_indices,
                "negative_indices": self.negative_indices,
                "invalid_queries": self.invalid,
            }
        if self.integrity_cfg is not None:
            s["integrity"] = {
                "check_every": self._integrity_every,
                "nan_guard": self._nan_guard,
                "checks": self.integrity_checks,
                "corruptions_detected": self.corruptions_detected,
                "heals": self.heals,
                "heal_failures": self.heal_failures,
                "quarantined_regions": self.quarantined_regions,
                "poisoned_batches": self.poisoned_batches,
                "events": list(self.integrity_events),
            }
        if self.layout:
            s["layout"] = dict(self.layout)
        if self.cache:
            s["cache"] = dict(self.cache)
        s["exec_mode"] = dict(self.exec_mode)
        if self.drift is not None:
            s["replan"] = {
                "replans": self.replans,
                "parity_failures": self.parity_failures,
                "replan_errors": self.replan_errors,
                "abandoned": self.replans_abandoned,
                "drift_checks": self.drift_checks,
                "last_drift": float(self.last_drift),
                "threshold": self.drift.threshold,
                "metric": self.drift.metric,
                "events": list(self.replan_events),
            }
        return s
