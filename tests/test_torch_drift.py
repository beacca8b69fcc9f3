"""Drift replanning in the port against the JAX package.

* The reference's server scenarios (``tests/test_drift_server.py``: the
  trigger, hysteresis, parity gate, cooldown, replan errors, and the
  overlapped shadow builds made deterministic by the same slow or exploding
  ``replan`` stubs) run through both packages' servers on the same traffic;
  each asserts the reference's expectations, and the two runs' replan
  events and counters are equal.
* An engine-level drift run (``drift="replan"``, no overlap) through the
  port and the reference on the same stream replans at the same batches,
  with every served output within rtol = atol = 1e-5.
* ``InferenceEngine.rebuild(freqs)`` gives the reference's plan and packed
  buffers for the same histogram.

The JAX side runs as its own tests run it: the XLA path on one CPU device.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import tables as jtables
from repro.data import distributions as jdist
from repro.engine import EngineConfig as JEngineConfig, InferenceEngine as JEngine
from repro.serving import server as jserver
from repro_torch.core import tables as ttables
from repro_torch.data import distributions as tdist
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.serving import server as tserver

TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = {
    "port": dict(server=tserver, dist=tdist, tables=ttables),
    "jax": dict(server=jserver, dist=jdist, tables=jtables),
}


def _wl(pkg):
    t = PKGS[pkg]["tables"]
    return t.Workload("drift-test", (t.TableSpec("big", rows=20_000, dim=4, seq=1),
                                     t.TableSpec("small", rows=64, dim=4, seq=2)), batch=64)


def _ref_step(tables, tag="a"):
    """Pure-numpy pooled-embedding step over per-query (N, s) payloads."""

    def step(payloads):
        idx = np.stack(payloads, axis=1)  # (N, B, s)
        outs = []
        for i, t in enumerate(tables):
            ii = idx[i]
            valid = ii >= 0
            g = t[np.where(valid, ii, 0)]
            g[~valid] = 0.0
            outs.append(g.sum(axis=1))
        return np.stack(outs)

    step.tag = tag
    return step


def _tables(rng):
    return [rng.standard_normal((rows, 4)).astype(np.float32) for rows in (20_000, 64)]


def _drive(pkg, srv, rng, dist, n_batches):
    d = PKGS[pkg]["dist"]
    wl = _wl(pkg)
    for _ in range(n_batches):
        idx = d.sample_workload(rng, wl, dist, wl.batch)
        for q in range(wl.batch):
            srv.submit(idx[:, q])
        srv.pump()


def _extract(payloads):
    return np.stack(payloads, axis=1)


def _config(pkg, tables, replans_log=None, **kw):
    def replan(measured):
        if replans_log is not None:
            replans_log.append(measured)
        return _ref_step(tables, tag="replanned")

    d = PKGS[pkg]["dist"]
    defaults = dict(
        baseline=d.workload_probs(_wl(pkg), d.Uniform()),
        extract_indices=_extract,
        replan=replan,
        check_every=2,
        patience=2,
        cooldown=4,
    )
    defaults.update(kw)
    return PKGS[pkg]["server"].DriftConfig(**defaults)


def _server(pkg, step, drift):
    wl = _wl(pkg)
    return PKGS[pkg]["server"].Server(step, max_batch=wl.batch, max_wait_s=0.0, drift=drift)


def _summary(srv):
    """What must agree between the two packages' runs."""
    s = srv.stats()
    return {"tag": srv.step_fn.tag, "served": srv.served, "submitted": srv.submitted,
            "replan": {k: v for k, v in s["replan"].items() if k != "events"},
            "events": [{k: v for k, v in e.items() if k != "error"} for e in s["replan"]["events"]],
            "errors": [e.get("error") for e in s["replan"]["events"]]}


def _both(scenario):
    out = {pkg: scenario(pkg) for pkg in PKGS}
    assert out["port"] == out["jax"]
    return out["port"]


def test_hot_swap_on_drift_with_parity():
    """Skew onset trips the trigger; the shadow plan passes parity on the
    cut-over batch and is atomically swapped in."""
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(0)
        tables = _tables(rng)
        measured_log = []
        srv = _server(pkg, _ref_step(tables, tag="original"), _config(pkg, tables, measured_log))
        _drive(pkg, srv, rng, d.Uniform(), 4)
        assert srv.replans == 0
        _drive(pkg, srv, rng, d.Zipf(1.6), 12)
        assert srv.replans >= 1 and srv.parity_failures == 0
        assert srv.step_fn.tag == "replanned"
        assert all(ev["parity_ok"] for ev in srv.replan_events)
        assert measured_log[0][0].top_mass(64) > 0.4
        s = srv.stats()
        assert s["replan"]["events"][0]["drift"] >= s["replan"]["threshold"]
        return _summary(srv), float(measured_log[0][0].top_mass(64))

    _both(run)


@pytest.mark.parametrize("which", ["uniform", "zipf"])
def test_no_replan_thrash_on_stationary_traffic(which):
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(1)
        tables = _tables(rng)
        dist = d.Uniform() if which == "uniform" else d.Zipf(1.6)
        srv = _server(pkg, _ref_step(tables, tag="original"),
                      _config(pkg, tables, baseline=d.workload_probs(_wl(pkg), dist)))
        _drive(pkg, srv, rng, dist, 24)
        assert srv.drift_checks > 3
        assert srv.replans == 0, f"thrash under stationary {dist!r}"
        return _summary(srv)

    _both(run)


def test_parity_failure_blocks_cutover():
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(2)
        tables = _tables(rng)

        def broken_replan(measured):
            good = _ref_step(tables, tag="broken")
            return lambda payloads: good(payloads) + 1.0  # wrong outputs

        srv = _server(pkg, _ref_step(tables, tag="original"),
                      _config(pkg, tables, replan=broken_replan))
        _drive(pkg, srv, rng, d.HotSet(0.005, 0.95), 16)
        assert srv.parity_failures >= 1 and srv.replans == 0
        assert srv.step_fn.tag == "original"
        return _summary(srv)

    _both(run)


def test_cooldown_limits_replan_rate():
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(3)
        tables = _tables(rng)
        srv = _server(pkg, _ref_step(tables), _config(pkg, tables, cooldown=1000))
        _drive(pkg, srv, rng, d.HotSet(0.005, 0.95), 24)
        assert srv.replans == 1  # continuing drift, but the cooldown holds
        return _summary(srv)

    _both(run)


def _scripted_distance(srv, script):
    it = iter(script)
    srv._distance = lambda measured: next(it)


def test_strikes_reset_on_under_threshold_check():
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(10)
        tables = _tables(rng)
        srv = _server(pkg, _ref_step(tables, tag="original"),
                      _config(pkg, tables, check_every=1, patience=2))
        _scripted_distance(srv, [0.9, 0.0, 0.9, 0.9, 0.0, 0.0])
        _drive(pkg, srv, rng, d.Uniform(), 2)
        assert srv.replans == 0
        _drive(pkg, srv, rng, d.Uniform(), 2)
        assert srv.replans == 1 and srv.replan_events[0]["batch"] == 4
        return _summary(srv)

    _both(run)


def test_check_every_one_checks_every_batch():
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(11)
        tables = _tables(rng)
        srv = _server(pkg, _ref_step(tables),
                      _config(pkg, tables, check_every=1, patience=1, cooldown=1000))
        _scripted_distance(srv, [0.0, 0.0, 0.0, 0.9])
        _drive(pkg, srv, rng, d.Uniform(), 3)
        assert srv.drift_checks == 3 and srv.replans == 0
        _drive(pkg, srv, rng, d.Uniform(), 1)
        assert srv.replans == 1 and srv.replan_events[0]["batch"] == 4
        return _summary(srv)

    _both(run)


def test_strikes_survive_nothing_across_cooldown():
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(12)
        tables = _tables(rng)
        srv = _server(pkg, _ref_step(tables, tag="original"),
                      _config(pkg, tables, check_every=1, patience=2, cooldown=3))
        _scripted_distance(srv, [0.9] * 2 + [0.9, 0.9, 0.9, 0.0])
        _drive(pkg, srv, rng, d.Uniform(), 2)
        assert srv.replans == 1
        _scripted_distance(srv, [0.9, 0.9, 0.0, 0.0])
        _drive(pkg, srv, rng, d.Uniform(), 5)
        assert srv.replans == 2 and srv.replan_events[1]["batch"] == 6
        return _summary(srv)

    _both(run)


def test_extract_indices_fewer_tables_than_baseline():
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(13)
        tables = _tables(rng)
        srv = _server(pkg, _ref_step(tables, tag="original"), _config(
            pkg, tables, extract_indices=lambda payloads: _extract(payloads)[:1]))
        _drive(pkg, srv, rng, d.HotSet(0.005, 0.95), 16)
        assert srv.replans >= 1 and srv.step_fn.tag == "replanned"
        assert srv.parity_failures == 0
        return _summary(srv)

    _both(run)


def test_parity_failure_then_successful_swap():
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(14)
        tables = _tables(rng)
        attempts = []

        def flaky_replan(measured):
            attempts.append(len(attempts))
            good = _ref_step(tables, tag="replanned")
            if len(attempts) == 1:  # first shadow build is wrong
                return lambda payloads: good(payloads) + 1.0
            return good

        srv = _server(pkg, _ref_step(tables, tag="original"),
                      _config(pkg, tables, replan=flaky_replan, cooldown=2))
        _drive(pkg, srv, rng, d.HotSet(0.005, 0.95), 24)
        assert len(attempts) >= 2 and srv.parity_failures == 1
        assert srv.replans >= 1 and srv.step_fn.tag == "replanned"
        events = srv.replan_events
        assert not events[0]["parity_ok"] and events[1]["parity_ok"]
        return _summary(srv), len(attempts)

    _both(run)


@pytest.mark.parametrize("overlap", [False, True])
def test_replan_exception_is_contained(overlap):
    """A crashing shadow re-pack, inline or on the worker thread, is
    counted and recorded and does not take serving down or swap anything
    in."""
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(18 if overlap else 15)
        tables = _tables(rng)

        def exploding_replan(measured):
            raise RuntimeError("packer OOM")

        srv = _server(pkg, _ref_step(tables, tag="original"), _config(
            pkg, tables, replan=exploding_replan, cooldown=2, overlap=overlap))
        _drive(pkg, srv, rng, d.HotSet(0.005, 0.95), 16)
        srv.drain()
        assert srv.replan_errors >= 1 and srv.replans == 0
        assert srv.step_fn.tag == "original"
        assert all("packer OOM" in e for e in _summary(srv)["errors"] if e)
        assert srv.served == srv.submitted
        return _summary(srv)

    _both(run)


def test_overlap_replan_serves_while_shadow_builds():
    """The pump keeps serving on the old plan while the shadow builds on
    the worker thread (held by a gate); the swap lands on the first batch
    after the build completes."""
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(16)
        tables = _tables(rng)
        gate, started = threading.Event(), threading.Event()

        def slow_replan(measured):
            started.set()
            assert gate.wait(timeout=30.0), "test gate never opened"
            return _ref_step(tables, tag="replanned")

        srv = _server(pkg, _ref_step(tables, tag="original"),
                      _config(pkg, tables, replan=slow_replan, overlap=True))
        _drive(pkg, srv, rng, d.HotSet(0.005, 0.95), 8)
        assert started.wait(timeout=30.0)
        served_before = srv.served
        _drive(pkg, srv, rng, d.HotSet(0.005, 0.95), 3)
        assert srv.served == served_before + 3 * 64
        assert srv.step_fn.tag == "original" and srv.replans == 0
        gate.set()
        srv._shadow_build.join(timeout=30.0)
        _drive(pkg, srv, rng, d.HotSet(0.005, 0.95), 1)  # completion batch
        assert srv.replans == 1 and srv.step_fn.tag == "replanned"
        return _summary(srv)

    _both(run)


def test_drain_joins_inflight_shadow_build():
    def run(pkg):
        d = PKGS[pkg]["dist"]
        rng = np.random.default_rng(17)
        tables = _tables(rng)
        gate = threading.Event()

        def slow_replan(measured):
            assert gate.wait(timeout=30.0), "test gate never opened"
            return _ref_step(tables, tag="replanned")

        srv = _server(pkg, _ref_step(tables, tag="original"),
                      _config(pkg, tables, replan=slow_replan, overlap=True))
        _drive(pkg, srv, rng, d.HotSet(0.005, 0.95), 8)
        assert srv.replans == 0 and srv._shadow_build is not None
        gate.set()
        assert srv.drain() == []
        assert srv.replans == 1 and srv.step_fn.tag == "replanned"
        return _summary(srv)

    _both(run)



def test_hot_swap_e2e_packed_plans():
    """The replan callable re-plans and re-packs a real
    ``PartitionedEmbeddingBag`` under the measured histogram, in both
    packages on the same stream: the same swaps, parity-identical outputs,
    and a frequency-aware swapped-in plan."""
    import dataclasses

    import jax
    import torch

    from repro import compat
    from repro.core import PartitionedEmbeddingBag as JBag, analytic_model as janalytic
    from repro.core.cost_model import TPU_V5E as JTPU
    from repro_torch.core.cost_model import TPU_V5E, analytic_model
    from repro_torch.core.embedding import PartitionedEmbeddingBag

    rng = np.random.default_rng(4)
    data = [rng.standard_normal((r, 8)).astype(np.float32) for r in (4096, 32)]

    def run(pkg):
        t = PKGS[pkg]["tables"]
        d = PKGS[pkg]["dist"]
        wl = t.Workload("e2e", (t.TableSpec("t", rows=4096, dim=8, seq=1),
                                t.TableSpec("u", rows=32, dim=8, seq=2)), batch=32)
        if pkg == "port":
            model = analytic_model(dataclasses.replace(TPU_V5E, l1_bytes=2048, dma_latency=1e-8))

            def make_step(freqs):
                bag = PartitionedEmbeddingBag(
                    wl, n_cores=1, planner="asymmetric", cost_model=model,
                    planner_kwargs=dict(freqs=freqs) if freqs is not None else {})
                packed = bag.pack(data)

                def step(payloads):
                    idx = torch.from_numpy(np.stack(payloads, axis=1))
                    return bag.apply(packed, idx, use_kernels=False).numpy()

                step.bag = bag
                return step
        else:
            model = janalytic(dataclasses.replace(JTPU, l1_bytes=2048, dma_latency=1e-8))
            mesh = compat.make_mesh((1, jax.device_count()), ("data", "model"))
            tables = [jax.numpy.asarray(x) for x in data]

            def make_step(freqs):
                bag = JBag(wl, n_cores=jax.device_count(), planner="asymmetric",
                           cost_model=model,
                           planner_kwargs=dict(freqs=freqs) if freqs is not None else {})
                packed = bag.pack(tables)
                apply = jax.jit(lambda idx: bag.apply(packed, idx, mesh=mesh, use_kernels=False))

                def step(payloads):
                    idx = jax.numpy.stack(payloads, axis=1)
                    return np.asarray(jax.block_until_ready(apply(idx)))

                step.bag = bag
                return step

        freqs0 = d.workload_probs(wl, d.Uniform())
        srv = PKGS[pkg]["server"].Server(
            make_step(freqs0), max_batch=wl.batch, max_wait_s=0.0,
            drift=PKGS[pkg]["server"].DriftConfig(
                baseline=freqs0, extract_indices=_extract, replan=make_step,
                check_every=2, patience=2, cooldown=4))
        gen = np.random.default_rng(5)
        outs = []
        for _ in range(12):
            idx = d.sample_workload(gen, wl, d.HotSet(0.01, 0.95), wl.batch)
            for q in range(wl.batch):
                srv.submit(idx[:, q])
            outs.append(np.asarray(srv.pump()))
        assert srv.replans >= 1 and srv.parity_failures == 0
        plan = srv.step_fn.bag.plan
        assert plan.meta["planner"].endswith("+freq") and plan.meta["distribution"] is not None
        return srv.replan_events, plan.meta["planner"], np.stack(outs)

    port, ref = run("port"), run("jax")
    assert [(e["batch"], e["parity_ok"]) for e in port[0]] == [
        (e["batch"], e["parity_ok"]) for e in ref[0]]
    assert port[1] == ref[1]
    np.testing.assert_allclose(port[2], ref[2], **TOL)

# ------------------------------------------------------------ engine level


def _engines(**cfg):
    """The same drift config built by both packages over the same tables
    (the reference's e2e recipe: a 4096-row table that stops fitting on
    chip once a hot set appears)."""
    rows, seqs, dim, batch = [4096, 32], [1, 2], 8, 32
    twl = ttables.make_workload("e2e", rows, dim=dim, seqs=seqs, batch=batch)
    jwl = jtables.make_workload("e2e", rows, dim=dim, seqs=seqs, batch=batch)
    rng = np.random.default_rng(4)
    data = [rng.standard_normal((r, dim)).astype(np.float32) for r in rows]
    base = dict(planner="asymmetric", mesh_shape=(1, 1), max_batch=batch,
                hardware_options={"l1_bytes": 2048, "dma_latency": 1e-8}, **cfg)
    teng = InferenceEngine.build(data, twl, EngineConfig(**base), device="cpu")
    # the reference's access reduction runs only in its fused kernel
    # (interpret mode on the CPU); without it, the XLA path
    jkernels = "fused" if cfg.get("access", "none") != "none" else "xla"
    jeng = JEngine.build([jnp.asarray(t) for t in data], jwl,
                         JEngineConfig(use_kernels=jkernels, **base))
    return teng, jeng


@pytest.mark.parametrize("access", ["none", "full"])
def test_engine_drift_run_matches_reference(access):
    """``drift="replan"`` without overlap through both engines on the same
    uniform-then-hot-set stream: the same replan events, every served
    output within 1e-5, and the same swapped-in plan."""
    cfg = dict(drift="replan", distribution="uniform", access=access,
               integrity="checksum", integrity_options={"check_every": 4},
               drift_options={"check_every": 2, "patience": 2, "cooldown": 4})
    teng, jeng = _engines(**cfg)
    outs, stats = {}, {}
    for name, eng, d in (("port", teng, tdist), ("jax", jeng, jdist)):
        srv = eng.serve(max_wait_s=0.0)
        gen = np.random.default_rng(5)
        handles = []
        for b in range(16):
            dist = d.Uniform() if b < 4 else d.HotSet(0.01, 0.95)
            idx = d.sample_workload(gen, eng.workload, dist, eng.workload.batch)
            handles += [srv.submit_request(idx[:, q]) for q in range(eng.workload.batch)]
            srv.pump()
        srv.drain()
        outs[name] = np.stack([np.asarray(h.result()) for h in handles])
        stats[name] = srv.stats()
        stats[name]["plan"] = srv.step_fn.bag.plan
    tr, jr = stats["port"]["replan"], stats["jax"]["replan"]
    assert tr["replans"] >= 1 and tr["parity_failures"] == tr["replan_errors"] == 0
    assert [(e["batch"], e["parity_ok"]) for e in tr["events"]] == \
        [(e["batch"], e["parity_ok"]) for e in jr["events"]]
    np.testing.assert_allclose([e["drift"] for e in tr["events"]],
                               [e["drift"] for e in jr["events"]], rtol=1e-12)
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)
    tplan, jplan = stats["port"]["plan"], stats["jax"]["plan"]
    assert tplan.meta["planner"] == jplan.meta["planner"] and "+freq" in tplan.meta["planner"]
    assert [(a.table_idx, a.core, a.row_offset, a.rows, a.strategy.name)
            for a in tplan.assignments] == [
        (a.table_idx, a.core, a.row_offset, a.rows, a.strategy.name) for a in jplan.assignments]
    assert stats["port"]["integrity"]["corruptions_detected"] == 0


@pytest.mark.parametrize("dist", ["hotset:0.01:0.95", "zipf:1.4"])
def test_rebuild_gives_reference_plan(dist):
    """``rebuild(freqs)`` re-plans and re-packs like the reference for the
    same histogram: the same assignments, plan meta, packed buffers and
    manifest, over the engine's own tables."""
    teng, jeng = _engines(access="full", integrity="checksum", distribution="uniform")
    trows = tdist.workload_probs(teng.workload, tdist.get_distribution(dist))
    jrows = jdist.workload_probs(jeng.workload, jdist.get_distribution(dist))
    tnew, jnew = teng.rebuild(trows), jeng.rebuild(jrows)
    assert all(a is b for a, b in zip(tnew.table_data, teng.table_data))
    assert tnew.device == teng.device
    tplan, jplan = tnew.plan, jnew.plan
    assert [(a.table_idx, a.core, a.row_offset, a.rows, a.strategy.name)
            for a in tplan.assignments] == [
        (a.table_idx, a.core, a.row_offset, a.rows, a.strategy.name) for a in jplan.assignments]
    for key in ("planner", "cache", "layout", "kernel"):
        assert tplan.meta.get(key) == jplan.meta.get(key), key
    for f in ("chunk_data", "cache_data", "sym_data"):
        np.testing.assert_array_equal(getattr(tnew.packed, f).numpy(),
                                      np.asarray(getattr(jnew.packed, f)))
    assert tnew.manifest.checksums == jnew.manifest.checksums
