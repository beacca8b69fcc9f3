"""The serving runtime's robustness semantics, held against the JAX package.

The port's ``serving/server.py`` is the reference's line for line; these
tests drive both with pure-Python steps through the scenarios of
``tests/test_serving_runtime.py`` that no other port test covers (admission
by reject, shed-oldest and block; deadline shedding; the handle's wait
timeout; adaptive release, also under deadlines; degraded mode absent
without a fallback, and a failing fallback failing its batch; drain's
forced flush and its report of unserved queries; the flush of one partial
batch; ``engine.serve`` honouring the admission config).  Each scenario runs
once on each package, from the same inputs and a fake clock, checks the
reference's semantics, and returns what it observed: the request
accounting and each handle's outcome, which must be equal across the two.
"""
import numpy as np
import pytest

from repro.serving import server as jserver
from repro_torch.serving import server as tserver

ACCOUNTING = ("submitted", "served", "shed", "rejected", "failed", "invalid", "pending",
              "deadline_misses", "batch_failures", "degraded_batches", "degraded")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _echo_step(payloads):
    return list(payloads)


def _accounting(srv) -> dict:
    s = srv.stats()
    assert s["submitted"] == (s["served"] + s["shed"] + s["rejected"] + s["failed"]
                              + s["invalid"] + s["pending"])
    return {k: s[k] for k in ACCOUNTING}


def _outcome(h):
    """A handle's outcome: its result, the name of its error, or pending."""
    if not h.done():
        return "pending"
    if h._error is not None:
        return type(h._error).__name__
    r = h.result()
    return r.tolist() if isinstance(r, np.ndarray) else r


# --------------------------------------------------------------------------
# scenarios: each takes a server module, returns what it observed
# --------------------------------------------------------------------------


def reject_admission(m):
    srv = m.Server(_echo_step, max_batch=4, max_wait_s=60.0, max_queue=2, admission="reject")
    ok = [srv.submit_request(i) for i in range(2)]
    spill = srv.submit_request(99)
    assert spill.done()
    with pytest.raises(m.QueueFull):
        spill.result()
    with pytest.raises(m.QueueFull):
        srv.submit(100)  # fire-and-forget has no handle to fail: it raises
    assert srv.rejected == 2 and srv.drain() == []
    return {"handles": [_outcome(h) for h in ok + [spill]], **_accounting(srv)}


def shed_oldest_admission(m):
    srv = m.Server(_echo_step, max_batch=4, max_wait_s=60.0, max_queue=2,
                   admission="shed-oldest")
    handles = [srv.submit_request(i) for i in range(6)]
    for h in handles[:4]:
        with pytest.raises(m.QueueFull, match="shed"):
            h.result()
    srv.drain()
    assert srv.shed == 4 and srv.served == 2 and srv.rejected == 0
    return {"handles": [_outcome(h) for h in handles], **_accounting(srv)}


def block_admission(m):
    calls = []

    def step(payloads):
        calls.append(len(payloads))
        return list(payloads)

    srv = m.Server(step, max_batch=4, max_wait_s=60.0, max_queue=4, admission="block")
    handles = [srv.submit_request(i) for i in range(12)]
    queued = len(srv.batcher.queue)
    assert queued <= 4
    srv.drain()
    assert [h.result() for h in handles] == list(range(12)) and max(calls) <= 4
    return {"queued": queued, "calls": calls, "handles": [_outcome(h) for h in handles],
            **_accounting(srv)}


def deadline_shedding(m):
    clock = FakeClock()
    executed = []

    def step(payloads):
        executed.extend(payloads)
        return list(payloads)

    srv = m.Server(step, max_batch=8, max_wait_s=0.0, deadline_s=0.5, clock=clock.now)
    stale = srv.submit_request("stale")
    fresh = srv.submit_request("fresh", deadline_s=10.0)  # per-request override
    clock.advance(1.0)
    srv.pump()
    with pytest.raises(m.DeadlineExceeded):
        stale.result()
    assert fresh.result() == "fresh" and "stale" not in executed
    return {"executed": executed, "handles": [_outcome(stale), _outcome(fresh)],
            **_accounting(srv)}


def handle_wait_timeout(m):
    srv = m.Server(_echo_step, max_batch=2, max_wait_s=60.0)
    h = srv.submit_request(7)
    before = h.wait(timeout=0.01)  # pending: nothing pumps
    srv.drain()
    after = h.wait(timeout=0.01)
    assert (before, after, h.result()) == (False, True, 7)
    return {"waits": [before, after], **_accounting(srv)}


def adaptive_release(m):
    clock = FakeClock()
    lockstep = m.Batcher(max_batch=8, max_wait_s=5.0, clock=clock.now)
    adaptive = m.Batcher(max_batch=8, max_wait_s=5.0, adaptive=True, clock=clock.now)
    for b in (lockstep, adaptive):
        b.submit("a", now=0.0)
        b.submit("b", now=1.0)  # observed gap 1 s: a fill needs 6 s more
    clock.t = 1.0
    parked = lockstep.maybe_release()
    released = adaptive.maybe_release()
    assert parked is None and released is not None and len(released) == 2
    fast = m.Batcher(max_batch=8, max_wait_s=5.0, adaptive=True, clock=clock.now)
    for i in range(4):
        fast.submit(i, now=1.0 + i * 1e-4)
    clock.t = 1.0 + 4e-4
    held = fast.maybe_release()
    assert held is None  # a fast stream fills well within the budget
    return {"released": [q.payload for q in released], "parked": parked, "held": held}


def adaptive_release_under_deadlines(m):
    clock = FakeClock()
    b = m.Batcher(max_batch=8, max_wait_s=5.0, adaptive=True, clock=clock.now)
    b.submit("a", now=0.0, deadline=1.5)
    b.submit("b", now=1.0, deadline=2.5)
    clock.t = 1.0
    batch = b.maybe_release()  # "a" dies at 1.5: release now, not at t=5
    assert batch is not None and [q.payload for q in batch] == ["a", "b"]
    return {"released": [q.payload for q in batch]}


def no_fallback_no_degraded_mode(m):
    def primary(payloads):
        raise RuntimeError("always down")

    srv = m.Server(primary, max_batch=1, max_wait_s=0.0, degrade_after=2)
    handles = [srv.submit_request(i) for i in range(5)]
    srv.drain()
    assert not srv.degraded and srv.degraded_batches == 0 and srv.batch_failures == 5
    for h in handles:
        with pytest.raises(m.BatchExecutionError):
            h.result()
    return {"handles": [_outcome(h) for h in handles], **_accounting(srv)}


def fallback_failure_fails_the_batch(m):
    def primary(payloads):
        raise RuntimeError("primary down")

    def fallback(payloads):
        raise RuntimeError("fallback also down")

    srv = m.Server(primary, max_batch=1, max_wait_s=0.0, fallback_step_fn=fallback,
                   degrade_after=1)
    h = srv.submit_request(0)
    assert srv.pump() is None
    with pytest.raises(m.BatchExecutionError, match="fallback also down"):
        h.result()
    assert srv.degraded  # degraded entry happened though the fallback died
    return {"handles": [_outcome(h)], **_accounting(srv)}


def drain_force_flushes(m):
    calls = []

    def step(payloads):
        calls.append(len(payloads))
        return list(payloads)

    srv = m.Server(step, max_batch=8, max_wait_s=60.0)
    handles = [srv.submit_request(i) for i in range(3)]
    assert srv.drain() == [] and calls == [3]  # one forced partial batch
    return {"calls": calls, "handles": [_outcome(h) for h in handles], **_accounting(srv)}


def drain_reports_unserved(m):
    srv = m.Server(_echo_step, max_batch=1, max_wait_s=60.0)
    for i in range(3):
        srv.submit(i)
    left = [q.payload for q in srv.drain(max_iters=1)]  # one forced pump only
    queued = len(srv.batcher.queue)
    assert left == [1, 2] and queued == 2  # reported, not dropped
    assert srv.drain() == [] and srv.served == 3
    return {"left": left, "queued": queued, **_accounting(srv)}


def flush_one_partial_batch(m):
    srv = m.Server(_echo_step, max_batch=8, max_wait_s=60.0)
    srv.submit(1)
    held = srv.pump()
    flushed = srv.flush()
    assert held is None and flushed == [1]
    return {"flushed": flushed, **_accounting(srv)}


SCENARIOS = [reject_admission, shed_oldest_admission, block_admission, deadline_shedding,
             handle_wait_timeout, adaptive_release, adaptive_release_under_deadlines,
             no_fallback_no_degraded_mode, fallback_failure_fails_the_batch,
             drain_force_flushes, drain_reports_unserved, flush_one_partial_batch]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_runtime_scenario_matches_reference(scenario):
    assert scenario(tserver) == scenario(jserver)


# --------------------------------------------------------------------------
# engine wiring
# --------------------------------------------------------------------------


def test_engine_serve_respects_admission_config():
    """``engine.serve`` takes the admission knobs from the config: a queue
    of 4 under ``reject`` rejects 2 of 6 requests, in both packages."""
    from repro.data.distributions import Uniform as JUniform, sample_workload as jsample
    from repro.data.workloads import small_workload as jsmall
    from repro.engine import EngineConfig as JEngineConfig, InferenceEngine as JEngine
    from repro_torch.data.distributions import Uniform, sample_workload
    from repro_torch.data.workloads import small_workload
    from repro_torch.engine import EngineConfig, InferenceEngine

    cfg = dict(mesh_shape=(1, 1), max_batch=8, max_wait_s=0.0, max_queue=4,
               admission="reject", deadline_s=5.0)
    observed = {}
    for name, build, wl, sample, dist in (
        ("port", lambda wl: InferenceEngine.build(None, wl, EngineConfig(**cfg), device="cpu"),
         small_workload(batch=8), sample_workload, Uniform()),
        ("reference", lambda wl: JEngine.build(None, wl, JEngineConfig(**cfg)),
         jsmall(batch=8), jsample, JUniform()),
    ):
        eng = build(wl)
        idx = np.asarray(sample(np.random.default_rng(1), wl, dist, 8))
        srv = eng.serve(max_batch=8, max_wait_s=60.0)
        assert (srv.max_queue, srv.admission, srv.deadline_s) == (4, "reject", 5.0)
        handles = [srv.submit_request(idx[:, q % 8]) for q in range(6)]
        done_early = sum(1 for h in handles if h.done())
        srv.drain()
        observed[name] = {"done_early": done_early,
                          "outcomes": [_outcome(h) if h._error is not None else "served"
                                       for h in handles], **_accounting(srv)}
    assert observed["port"] == observed["reference"]
    assert observed["port"]["rejected"] == 2 and observed["port"]["done_early"] == 2
