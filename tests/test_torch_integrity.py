"""Data-plane integrity in the port against the JAX package.

* :class:`IntegrityManifest` gives the reference's region keys, spans and
  CRC32s for the same packed buffers (ragged, with a residency cache, with
  a symmetric group, with padding tails on several cores, the dense layout,
  and bfloat16), finds the same corrupt keys after the same byte is flipped
  in both, repairs bitwise equal to a fresh pack (the cache rebuilt from
  the repaired chunk) and quarantines an abstract pack as the reference
  does.
* The reference's server scenarios (``tests/test_integrity_faults.py``)
  run through both packages on the same traffic and the same fault plans:
  their counters, detected regions and healed buffers agree.

The JAX side runs as its own tests run it: the XLA path
(``use_kernels="xla"``) on one CPU device, or ``simulate=True`` for
plan-and-pack-only builds over several cores.  The port runs on the CPU
(the kernels' plain versions).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.integrity import IntegrityManifest as JManifest
from repro.core.tables import make_workload as jmake_workload
from repro.data.workloads import small_workload as jsmall_workload
from repro.engine import EngineConfig as JEngineConfig, InferenceEngine as JEngine
from repro.serving import faults as jfaults
from repro.serving import server as jserver
from repro_torch.core.integrity import IntegrityManifest, region_label
from repro_torch.core.partition import pack_plan
from repro_torch.core.tables import TableSpec, Workload, make_workload
from repro_torch.data.distributions import Uniform, Zipf, sample_workload, workload_probs
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.serving import faults as tfaults
from repro_torch.serving import server as tserver

TOL = dict(rtol=1e-5, atol=1e-5)
E = 16
# one oversized hot table and l1_bytes=0, so the carve is the only home for
# the measured hot rows (the reference's cache recipe)
CACHE_CFG = dict(
    planner="asymmetric", access="full", distribution="hotset:0.001:0.95",
    hardware_options={"l1_bytes": 0, "dma_latency": 1e-8},
)


def _tables(rows, dim=E, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((r, dim)) / 4).astype(np.float32) for r in rows]


def _pair(cfg, *, rows=None, cache_wl=False, tables="seeded"):
    """The same config built by both packages over the same tables:
    ``(port engine, jax engine)``."""
    if cache_wl:
        rows, seqs, dim, batch = [50_000, 32], [1, 2], 8, 32
        twl = make_workload("cachewl", rows, dim=dim, seqs=seqs, batch=batch)
        jwl = jmake_workload("cachewl", rows, dim=dim, seqs=seqs, batch=batch)
    else:
        twl, jwl = small_workload("integ", batch=8), jsmall_workload("integ", batch=8)
        dim = E
    rows = [t.rows for t in twl.tables]
    data = _tables(rows, dim) if tables == "seeded" else tables
    teng = InferenceEngine.build(data, twl, EngineConfig(**cfg), device="cpu")
    jdata = data if isinstance(data, str) else [jnp.asarray(t) for t in data]
    jeng = JEngine.build(jdata, jwl, JEngineConfig(simulate=True, **cfg))
    return teng, jeng


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


MANIFEST_CASES = {
    "ragged": dict(planner="asymmetric", mesh_shape=(1, 1)),
    "tails_4_cores": dict(planner="asymmetric", mesh_shape=(1, 4)),
    "cache": dict(CACHE_CFG, mesh_shape=(1, 1)),
    "symmetric": dict(planner="symmetric", mesh_shape=(1, 2)),
    "lif_fallback": dict(planner="asymmetric", mesh_shape=(1, 4),
                         planner_options={"shard_rocks": False}),
    "dense": dict(planner="asymmetric", mesh_shape=(1, 2), layout="dense"),
    "bfloat16": dict(planner="asymmetric", mesh_shape=(1, 2), dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(MANIFEST_CASES))
def test_manifest_crcs_equal_reference(case):
    cfg = dict(MANIFEST_CASES[case], integrity="checksum")
    teng, jeng = _pair(cfg, cache_wl=case == "cache")
    got, want = teng.manifest, jeng.manifest
    assert isinstance(got, IntegrityManifest) and isinstance(want, JManifest)
    assert list(got.checksums) == list(want.checksums)
    assert got.checksums == want.checksums
    assert got.spans == want.spans
    assert got.meta == want.meta
    kinds = {k[0] for k in got.checksums}
    want_kind = {"cache": "cache", "symmetric": "sym", "lif_fallback": "sym"}.get(case)
    if want_kind:
        assert want_kind in kinds
    if case == "tails_4_cores":
        assert sum(k[0] == "tail" for k in got.checksums) == 4
    assert [region_label(k) for k in got.checksums] == [
        jfaults_label(k) for k in want.checksums]


def jfaults_label(key):
    from repro.core.integrity import region_label as jlabel

    return jlabel(key)


@pytest.mark.parametrize("case,where", [
    ("ragged", (0, 1, 3)), ("ragged", (0, -1, 0)), ("tails_4_cores", (2, 5, 7)),
    ("dense", (1, 0, 4, 2)), ("cache", "cache"), ("symmetric", "sym"),
])
def test_verify_and_repair_like_reference(case, where):
    """The same byte flipped in both packages' buffers: the same corrupt
    keys; the port's in-place repair equals the reference's repair and a
    fresh ``pack_plan`` of the same plan, bit for bit."""
    cfg = dict(MANIFEST_CASES[case], integrity="checksum")
    teng, jeng = _pair(cfg, cache_wl=case == "cache")
    fresh = pack_plan(teng.plan, teng.workload.tables, teng.table_data, dtype=torch.float32,
                      layout=teng.packed.layout, block_r=teng.packed.block_r, freqs=teng.freqs,
                      device="cpu")
    field = {"cache": "cache_data", "sym": "sym_data"}.get(where, "chunk_data")
    pos = (0, 0, 0) if isinstance(where, str) else where
    tbuf = getattr(teng.packed, field)
    tbuf[pos[:-1]][pos[-1]:pos[-1] + 1].view(torch.int32).bitwise_xor_(1 << 20)
    jbuf = np.array(getattr(jeng.packed, field))
    jbuf.view(np.uint32)[pos] ^= np.uint32(1 << 20)
    jeng.packed = dataclasses.replace(jeng.packed, **{field: jnp.asarray(jbuf)})
    bad = teng.verify_integrity()
    assert bad and bad == jeng.verify_integrity()
    report = teng.heal()
    jreport = jeng.heal()
    assert report == jreport and report["clean"] and report["healed"]
    for f in ("chunk_data", "cache_data", "sym_data"):
        got = _np(getattr(teng.packed, f))
        assert np.array_equal(got, _np(getattr(fresh, f))), f
        assert np.array_equal(got, _np(getattr(jeng.packed, f))), f
    assert teng.verify_integrity() == []


def test_cache_region_rebuilt_from_repaired_chunk():
    """A corrupt chunk row that the cache also holds, and a corrupt cache
    row: both heal, and the cache mini-table is rebuilt from the repaired
    chunk through ``cache_remap`` (equal to the reference's repair)."""
    teng, jeng = _pair(dict(CACHE_CFG, mesh_shape=(1, 1), integrity="checksum"), cache_wl=True)
    assert teng.packed.cache_rows > 0
    pristine = teng.packed.cache_data.clone()
    remap = teng.packed.cache_remap[0]
    row = int(torch.nonzero(remap >= 0)[0])
    teng.packed.chunk_data[0, row] += 1.0
    teng.packed.cache_data[0, 0] += 2.0
    jchunk, jcache = np.array(jeng.packed.chunk_data), np.array(jeng.packed.cache_data)
    jchunk[0, row] += 1.0
    jcache[0, 0] += 2.0
    jeng.packed = dataclasses.replace(jeng.packed, chunk_data=jnp.asarray(jchunk),
                                      cache_data=jnp.asarray(jcache))
    bad = teng.verify_integrity()
    assert ("cache", 0, -1) in bad and any(k[0] == "chunk" for k in bad)
    assert bad == jeng.verify_integrity()
    report = teng.heal()
    assert report == jeng.heal() and report["clean"]
    assert torch.equal(teng.packed.cache_data, pristine)
    assert np.array_equal(_np(teng.packed.cache_data), _np(jeng.packed.cache_data))


def test_abstract_pack_quarantines_without_source():
    """A corrupt region with no source tables is zeroed and quarantined,
    and its checksum re-pinned, exactly as in the reference."""
    cfg = dict(planner="asymmetric", use_kernels="xla", mesh_shape=(1, 1), integrity="checksum")
    teng, jeng = _pair(cfg, tables="abstract")
    teng.packed.chunk_data[0, 0, 0] = 3.0
    jchunk = np.array(jeng.packed.chunk_data)
    jchunk[0, 0, 0] = 3.0
    jpacked = dataclasses.replace(jeng.packed, chunk_data=jchunk)
    assert teng.manifest.verify(teng.packed) == jeng.manifest.verify(jpacked) != []
    packed, report = teng.manifest.repair(teng.packed, teng.plan, teng.workload.tables, None)
    jpacked, jreport = jeng.manifest.repair(jpacked, jeng.plan, jeng.workload.tables, None)
    assert report == jreport
    assert report["quarantined"] and report["clean"] and not report["healed"]
    assert teng.manifest.verify(packed) == []  # re-pinned, not re-flagged
    assert teng.manifest.checksums == jeng.manifest.checksums
    assert np.array_equal(_np(packed.chunk_data), _np(jpacked.chunk_data))


# ----------------------------------------------------------- server scenarios


PKGS = {
    "port": dict(EngineConfig=EngineConfig, build=lambda *a, **k: InferenceEngine.build(
        *a, device="cpu", **k), faults=tfaults, server=tserver, wl=small_workload),
    "jax": dict(EngineConfig=JEngineConfig, build=JEngine.build, faults=jfaults,
                server=jserver, wl=jsmall_workload),
}


def _engine(pkg, *, validation="clip", check_every=2, **overrides):
    """The reference test's engine, built by ``pkg`` over seeded tables."""
    p = PKGS[pkg]
    wl = p["wl"]("integ", batch=8)
    kwargs = dict(
        planner="asymmetric", use_kernels="xla" if pkg == "jax" else "fused",
        mesh_shape=(1, 1), validation=validation, integrity="checksum",
        integrity_options={"check_every": check_every, "nan_guard": True},
        max_batch=8,
    )
    kwargs.update(overrides)
    tables = _tables([t.rows for t in wl.tables])
    if pkg == "jax":
        tables = [jnp.asarray(t) for t in tables]
    return p["build"](tables, wl, p["EngineConfig"](**kwargs)), wl


def _drive(srv, wl, n_batches, *, drain=True, seed=0):
    rng = np.random.default_rng(seed)
    handles = []
    for _ in range(n_batches):
        idx = sample_workload(rng, wl, Zipf(1.2), 8)
        handles.extend(srv.submit_request(idx[:, q]) for q in range(8))
        srv.pump()
    if drain:
        srv.drain()
    return handles


def _accounting(s):
    return s["submitted"] == (s["served"] + s["shed"] + s["rejected"] + s["failed"]
                              + s["invalid"] + s["pending"])


def _both(scenario):
    out = {pkg: scenario(pkg) for pkg in PKGS}
    return out["port"], out["jax"]


def _chunk(engine):
    return _np(engine.packed.chunk_data)


def test_manifest_detects_and_repairs_bit_exact():
    def run(pkg):
        engine, _ = _engine(pkg)
        pristine = _chunk(engine)
        assert engine.verify_integrity() == []
        chunk = np.array(pristine)
        chunk[0, 1, 3] += 1.0  # silent corruption inside slot 0's region
        if pkg == "port":
            engine.packed.chunk_data.copy_(torch.from_numpy(chunk))
        else:
            engine.packed = dataclasses.replace(engine.packed, chunk_data=jnp.asarray(chunk))
        bad = engine.verify_integrity()
        assert bad and all(k[0] in ("chunk", "tail") for k in bad)
        report = engine.heal()
        assert report["clean"] and report["healed"] and not report["quarantined"]
        assert np.array_equal(_chunk(engine), pristine)
        assert engine.verify_integrity() == []
        return bad, report, pristine

    port, ref = _both(run)
    assert port[0] == ref[0] and port[1] == ref[1]
    assert np.array_equal(port[2], ref[2])


def test_tail_region_covers_padding():
    def run(pkg):
        engine, _ = _engine(pkg)
        chunk = _chunk(engine)
        chunk[0, -1, 0] = 7.0  # the shared trailing zero row
        if pkg == "port":
            engine.packed.chunk_data.copy_(torch.from_numpy(chunk))
        else:
            engine.packed = dataclasses.replace(engine.packed, chunk_data=jnp.asarray(chunk))
        bad = engine.verify_integrity()
        assert ("tail", 0, -1) in bad
        report = engine.heal()
        assert report["clean"]
        assert not _chunk(engine)[0, -1].any()
        return bad, report

    port, ref = _both(run)
    assert port == ref


def test_step_crash_contained_to_one_batch():
    def run(pkg):
        p = PKGS[pkg]
        engine, wl = _engine(pkg)
        # the step point fires with the post-increment batch counter, so
        # at_batch=2 crashes the second batch (handles 8..15)
        inj = p["faults"].FaultInjector(p["faults"].FaultPlan(
            [p["faults"].FaultSpec("step", at_batch=2, mode="crash")]))
        srv = engine.serve(max_wait_s=0.0, fault_injector=inj)
        handles = _drive(srv, wl, 4)
        s = srv.stats()
        assert s["batch_failures"] == 1 and s["failed"] == 8
        assert s["served"] == 3 * 8
        with pytest.raises(p["server"].BatchExecutionError):
            handles[8].result()  # batch 1's handles
        handles[0].result()  # batch 0 served before the crash
        failed = [i for i, h in enumerate(handles) if h._error is not None]
        return failed, inj.events, [np.asarray(h.result()) for h in handles if h._error is None]

    port, ref = _both(run)
    assert port[0] == ref[0] == list(range(8, 16))
    assert port[1] == ref[1]
    for got, want in zip(port[2], ref[2]):
        np.testing.assert_allclose(got, want, **TOL)


def _buffer_fault(pkg, mode, at_batch, count, check_every, n_batches=8):
    p = PKGS[pkg]
    engine, wl = _engine(pkg, check_every=check_every)
    pristine = _chunk(engine)
    inj = p["faults"].FaultInjector(p["faults"].FaultPlan(
        [p["faults"].FaultSpec("buffer", at_batch=at_batch, mode=mode, count=count)]))
    srv = engine.serve(max_wait_s=0.0, fault_injector=inj)
    p["faults"].arm_buffer_corruption(inj, engine, srv)
    handles = _drive(srv, wl, n_batches)
    return engine, srv, inj, handles, pristine


def test_bitflip_detected_on_cadence_and_healed_bitwise():
    def run(pkg):
        engine, srv, inj, _, pristine = _buffer_fault(pkg, "bitflip", 2, 3, 2)
        integ = srv.stats()["integrity"]
        assert integ["corruptions_detected"] >= 1
        assert integ["heals"] >= 1 and integ["heal_failures"] == 0
        assert engine.verify_integrity() == []
        assert np.array_equal(_chunk(engine), pristine)
        events = [{k: e[k] for k in ("batch", "reason", "regions", "healed")}
                  for e in integ["events"]]
        return events, integ["corruptions_detected"], inj.events

    port, ref = _both(run)
    assert port == ref


def test_nan_rows_trip_output_guard_and_heal():
    def run(pkg):
        engine, srv, _, handles, _ = _buffer_fault(pkg, "nan-rows", 1, 2, 4)
        s = srv.stats()
        integ = s["integrity"]
        assert integ["corruptions_detected"] >= 1 or integ["poisoned_batches"] >= 1
        assert integ["heals"] >= 1 and integ["heal_failures"] == 0
        assert engine.verify_integrity() == []
        poisoned = [i for i, h in enumerate(handles)
                    if h.done() and isinstance(h._error, PKGS[pkg]["server"].PoisonedOutputError)]
        if integ["poisoned_batches"]:
            assert len(poisoned) == 8 * integ["poisoned_batches"]
        assert _accounting(s)
        return poisoned, [{k: e[k] for k in ("batch", "reason", "regions", "healed")}
                          for e in integ["events"]], integ["poisoned_batches"]

    port, ref = _both(run)
    assert port == ref


def test_stuck_replan_abandoned_on_timeout():
    def run(pkg):
        p = PKGS[pkg]
        engine, wl = _engine(
            pkg, drift="replan",
            drift_options={"check_every": 2, "threshold": 0.0, "patience": 1,
                           "cooldown": 100, "overlap": True, "build_timeout_batches": 2},
        )
        inj = p["faults"].FaultInjector(p["faults"].FaultPlan(
            [p["faults"].FaultSpec("replan", mode="stall")]))
        srv = engine.serve(max_wait_s=0.0, fault_injector=inj)
        _drive(srv, wl, 10, drain=False)
        inj.release_stalls()
        srv.drain()
        rp = srv.stats()["replan"]
        assert rp["abandoned"] >= 1
        assert any(e.get("abandoned") for e in rp["events"])
        return rp["abandoned"], [(e["batch"], e.get("abandoned")) for e in rp["events"]]

    port, ref = _both(run)
    assert port == ref


def test_hot_swap_rejects_corrupt_shadow():
    """The drift swap's integrity gate: a shadow step whose buffers fail
    verification is never swapped in (parity is not even consulted)."""
    def run(pkg):
        srv_mod = PKGS[pkg]["server"]
        wl = Workload("swap-gate", (TableSpec("t0", rows=256, dim=4, seq=1),), batch=16)

        def step(payloads):
            return [np.zeros(4, np.float32) for _ in payloads]

        def corrupt_shadow(measured):
            shadow = lambda payloads: [np.zeros(4, np.float32) for _ in payloads]  # noqa: E731
            shadow.integrity_verify = lambda: [("chunk", 0, 0)]  # always dirty
            return shadow

        srv = srv_mod.Server(
            step, max_batch=wl.batch, max_wait_s=0.0,
            integrity={"check_every": 0, "nan_guard": False},
            drift=srv_mod.DriftConfig(
                baseline=workload_probs(wl, Uniform()),
                extract_indices=lambda p: np.stack(p, axis=1),
                replan=corrupt_shadow,
                check_every=2, threshold=0.0, patience=1, cooldown=100,
            ),
        )
        rng = np.random.default_rng(0)
        for _ in range(6):
            idx = sample_workload(rng, wl, Uniform(), wl.batch)
            for q in range(wl.batch):
                srv.submit(idx[:, q])
            srv.pump()
        srv.drain()
        s = srv.stats()
        assert s["replan"]["replans"] == 0
        assert s["integrity"]["corruptions_detected"] >= 1
        assert any(e.get("reason") == "hot-swap" for e in s["integrity"]["events"])
        return s["integrity"]["events"], s["replan"]["events"]

    port, ref = _both(run)
    assert port == ref


def test_oov_burst_end_to_end_reject():
    def run(pkg):
        p = PKGS[pkg]
        engine, wl = _engine(pkg, validation="reject")
        inj = p["faults"].FaultInjector(p["faults"].FaultPlan(
            [p["faults"].FaultSpec("query", at_batch=2, mode="oov", count=6)]))
        srv = engine.serve(max_wait_s=0.0, fault_injector=inj)
        rows = [t.rows for t in wl.tables]
        rng = np.random.default_rng(0)
        handles, poisoned_total = [], 0
        for b in range(5):
            idx = sample_workload(rng, wl, Zipf(1.2), 8)
            idx, n = inj.poison_queries(b, idx, rows)
            poisoned_total += n
            handles.extend(srv.submit_request(idx[:, q]) for q in range(8))
            srv.pump()
        srv.drain()
        s = srv.stats()
        assert poisoned_total >= 1
        assert s["invalid"] == poisoned_total
        assert s["served"] == s["submitted"] - poisoned_total
        rejected = [i for i, h in enumerate(handles)
                    if h.done() and isinstance(h._error, p["server"].InvalidQueryError)]
        assert len(rejected) == poisoned_total
        return rejected, s["validation"]

    port, ref = _both(run)
    assert port == ref


def test_clean_drift_run_reports_no_corruption():
    """Overlapped replans on a checksummed engine: every hot swap verifies
    the shadow's own manifest and the cadence checks the live step's engine,
    so clean traffic reports no corrupt region and every heal hook stays
    bound to its own engine."""
    engine, wl = _engine("port", check_every=2, drift="replan",
                         drift_options={"check_every": 2, "threshold": 0.0, "patience": 1,
                                        "cooldown": 2, "overlap": True})
    srv = engine.serve(max_wait_s=0.0)
    _drive(srv, wl, 16)
    s = srv.stats()
    assert s["replan"]["replans"] >= 1 and s["replan"]["replan_errors"] == 0
    assert s["integrity"]["checks"] >= 8
    assert s["integrity"]["corruptions_detected"] == 0 and s["integrity"]["heals"] == 0
    assert srv.step_fn.engine is not engine
    assert srv.step_fn.integrity_verify == srv.step_fn.engine.verify_integrity
