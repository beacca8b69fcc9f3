"""Drift replans, integrity sweeps and the degraded fallback across ranks.

Four gloo ranks, spawned once for the module (``test_torch_multicard.py``'s
``spawn``), serve the smoke workload with one plan core each.  Rank 0 runs
the server; the others follow rank 0's op stream: lookups on the
generation the header names, a rebuild's share (built alongside, no
collective), the swap point, the commit or drop, integrity sweeps and heals
of their own slices.  Held:

- ``drift="replan"`` without overlap on a scheduled drift stream, with
  checksums, against the one-process port on the same config and traffic:
  the same replan batches, events and counters; outputs bitwise for
  ``sparse`` and ``split_sparse``, within rtol = atol = 1e-5 for ``psum``;
  ``sparse`` also against the JAX package's ``Server`` on 4 forced host
  devices (a subprocess, ``use_kernels="xla"``), within 1e-5;
- overlapped builds: replans, no errors, every rank on the same
  generation at the end, outputs within 1e-5 of the one-process run;
- a replan crash on rank 0, a failed build on rank 2, another plan packed
  on rank 1, a stalled build on rank 0 and one on rank 2: each counted (an
  error naming the rank, or abandoned), serving carries on, no rank hangs;
- a follower holds only gen 0 and the live generation at the end: every
  other share it built has been freed;
- the union of the ranks' manifests is the one-process manifest, cache
  regions included (a plan that carves a residency cache on two cores);
- a bit flipped in a chunk region on rank 1 and in the tail on rank 3, or
  in the cache on rank 2, is found under the one-process keys, healed on
  its rank, and the outputs equal the one-process run's bitwise;
- the CPU's degraded fallback across ranks: the followers run the plain
  path, the outputs equal the one-process degraded run's;
- no rank issues a collective off its main thread (every collective of the
  spawn is guarded).

The serve CLI under four ranks runs the ``taobao-zipf12`` preset at smoke
size in a second spawn.  This file imports no JAX (the reference runs in its
subprocess).
"""
import copy
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.data import distributions as dist_lib
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultSpec
from test_torch_multicard import BATCH, SMOKE, SPLIT, SRC, TOL, WORLD, _inputs, spawn

STREAM = "uniform@4,zipf:1.2@12,hotset:0.01:0.9:-1@16"
N_BATCHES = 32
DRIFT = dict(check_every=4, patience=2, cooldown=8)
INTEGRITY = dict(integrity="checksum", integrity_options={"check_every": 4})


# a plan with a residency cache on cores 2 and 3 (GM chunks under the a100
# cost model)
CACHE = dict(distribution="zipf:1.2", access="full", hardware="a100")
# rank 2's first share in "stall2" sleeps this long: past the swap point's
# wait (twice rank 0's build, plus a second), within the end-of-job wait
STALL_S = 3.0


def _drift(overlap=False, **extra):
    return dict(drift="replan", drift_options=dict(DRIFT, overlap=overlap, **extra), **INTEGRITY)


# the served cases (rank 0's faults in FAULTS, a follower's own in _sabotage)
CASES = {
    "sparse": dict(SMOKE, reduce_mode="sparse", **_drift()),
    "psum": dict(SMOKE, reduce_mode="psum", **_drift()),
    "split_sparse": dict(SPLIT, reduce_mode="sparse", **_drift()),
    "overlap": dict(SMOKE, **_drift(overlap=True)),
    "crash0": dict(SMOKE, **_drift()),
    "fail2": dict(SMOKE, **_drift()),
    "mismatch1": dict(SMOKE, **_drift()),
    "stall0": dict(SMOKE, **_drift(overlap=True, build_timeout_batches=4)),
    "stall2": dict(SMOKE, **_drift(overlap=True)),
    "bitflip": dict(SMOKE, **INTEGRITY),
    "cache": dict(CACHE, **_drift()),
    "degraded": dict(SMOKE, degrade_after=2, probe_every=4),
}
FAULTS = {
    "crash0": [FaultSpec("replan", mode="crash")],
    "stall0": [FaultSpec("replan", mode="stall")],
    "degraded": [FaultSpec("step", at_batch=2), FaultSpec("step", at_batch=3)],
}
ONE_PROCESS = ("sparse", "psum", "split_sparse", "crash0", "bitflip", "cache", "degraded")
BITWISE = ("sparse", "split_sparse", "crash0", "bitflip", "cache", "degraded")
# the bit flips before serving: (core, region kind), the bit of the first
# element of the region's first row
FLIPS = {"bitflip": ((1, "chunk"), (3, "tail")), "cache": ((2, "cache"),)}
FLIP_BIT = 1 << 22


def _stream():
    """The drift stream's (N, B, s) batches, the same in every process."""
    wl = small_workload(batch=BATCH)
    sched = dist_lib.parse_drift(STREAM)
    rng = np.random.default_rng(0)
    return [dist_lib.sample_workload(rng, wl, sched.at(b), BATCH) for b in range(N_BATCHES)]


def _injector(name):
    return FaultInjector(FaultPlan(list(FAULTS[name]))) if name in FAULTS else None


def _flip(eng, core: int, kind: str) -> tuple:
    """Flip ``FLIP_BIT`` in the first element of the first row of ``core``'s
    first chunk region (``kind="chunk"``), its tail or its cache, in
    whichever buffer holds that core (a rank's slice or a whole pack);
    returns the region key."""
    c = core - eng.manifest.core
    if kind == "cache":
        key = ("cache", core, -1)
        assert key in eng.manifest.checksums
        raw = eng.packed.cache_data[c, 0, 0:1].view(torch.int32)
        raw ^= FLIP_BIT
        return key
    keys = [k for k in eng.manifest.spans if k[0] == kind and k[1] == core]
    key = min(keys)
    lo, hi = eng.manifest.spans[key]
    assert hi > lo
    raw = eng.packed.chunk_data[c, lo, 0:1].view(torch.int32)
    raw ^= FLIP_BIT
    return key


def _serve(eng, name):
    """Serve the drift stream through ``eng.serve()`` (rank 0, or one
    process): each request's output (``None`` where it failed) and the
    server's record."""
    inj = _injector(name)
    srv = eng.serve(max_wait_s=0.0, fault_injector=inj)
    handles = []
    for idx in _stream():
        handles += [srv.submit_request(idx[:, q]) for q in range(BATCH)]
        srv.pump()
    srv.drain()
    if inj is not None:
        inj.release_stalls()
        for t in threading.enumerate():
            if t.name == "shadow-replan":
                t.join(timeout=30.0)
    s = srv.stats()
    outs = [h.result() if h._error is None else None for h in handles]
    rec = {"outputs": outs, "replan": s.get("replan"), "integrity": s.get("integrity"),
           "degraded_batches": s["degraded_batches"], "batch_failures": s["batch_failures"],
           "served": s["served"], "submitted": s["submitted"],
           "generation": srv.step_fn.engine.generation, "op_log": eng.op_log}
    return rec


def _one_process(name):
    wl, tables, _ = _inputs()
    cfg = dict(CASES[name], mesh_shape=[1, WORLD])
    eng = InferenceEngine.build(tables, wl, EngineConfig(**cfg), device="cpu")
    for core, kind in FLIPS.get(name, ()):
        _flip(eng, core, kind)
    return eng


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------


def _guard_collectives(log: list) -> None:
    """Make every collective of this process raise (and be logged) when it
    is issued off the main thread."""
    import torch.distributed as dist

    for name in ("broadcast", "broadcast_object_list", "all_gather_object", "all_gather",
                 "all_gather_into_tensor", "all_reduce", "all_to_all_single", "barrier",
                 "batch_isend_irecv"):
        fn = getattr(dist, name)

        def guarded(*a, _fn=fn, _name=name, **k):
            if threading.current_thread() is not threading.main_thread():
                log.append((_name, threading.current_thread().name))
                raise RuntimeError(f"{_name} issued off the main thread")
            return _fn(*a, **k)

        setattr(dist, name, guarded)


def _sabotage(rank, name):
    """The rank's own fault: rank 2's first share fails, or stalls for
    ``STALL_S``; rank 1's first share packs other tables (so another
    fingerprint)."""
    real = InferenceEngine._shadow
    calls = []

    def shadow(self, freqs, gen):
        calls.append(gen)
        if len(calls) == 1 and (name, rank) == ("fail2", 2):
            raise RuntimeError("injected build failure")
        if len(calls) == 1 and (name, rank) == ("stall2", 2):
            time.sleep(STALL_S)
        if len(calls) == 1 and (name, rank) == ("mismatch1", 1):
            self = copy.copy(self)
            self._table_data = [t + 1.0 for t in self._table_data]
        return real(self, freqs, gen)

    if (name, rank) in (("fail2", 2), ("stall2", 2), ("mismatch1", 1)):
        InferenceEngine._shadow = shadow
    return lambda: setattr(InferenceEngine, "_shadow", real)


def _cases(rank, tmp):
    from repro_torch.launch.mesh import init_card_mesh

    off_main = []
    _guard_collectives(off_main)
    mesh = init_card_mesh(device_type="cpu")
    wl, tables, _ = _inputs()
    out = {}
    for name, cfg in CASES.items():
        undo = _sabotage(rank, name)
        eng = InferenceEngine.build(tables, wl, EngineConfig(**cfg), device="cpu", mesh=mesh)
        rec = {"manifest": (None if eng.manifest is None else
                            {"checksums": dict(eng.manifest.checksums),
                             "spans": dict(eng.manifest.spans)}),
               "cache_rows": eng.packed.cache_rows}
        rec["flipped"] = [_flip(eng, core, kind) for core, kind in FLIPS.get(name, ())
                          if core == rank]
        if rank == 0:
            rec.update(_serve(eng, name))
            eng.close()
        else:
            rec["lookups"] = eng.follow()
            rec["follow"] = eng.follow_stats
        undo()
        out[name] = rec
    out["off_main"] = off_main
    torch.save(out, f"{tmp}/drift_{rank}.pt")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drift")
    codes, errors = spawn(_cases, tmp)
    assert codes == [0] * WORLD, errors
    return [torch.load(tmp / f"drift_{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_process():
    return {name: _serve(_one_process(name), name) for name in ONE_PROCESS}


def _events(rec):
    return [{k: e[k] for k in ("batch", "drift", "parity_ok")} for e in rec["replan"]["events"]]


def _counters(rec):
    return {k: v for k, v in rec["replan"].items() if k != "events"}


def _same_outputs(got, want, bitwise):
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if g is None:
            continue
        if bitwise:
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **TOL)


# --------------------------------------------------------------------------
# against the one-process port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sparse", "psum", "split_sparse"])
def test_replans_match_one_process(cases, one_process, name):
    got, want = cases[0][name], one_process[name]
    assert got["replan"]["replans"] >= 1
    assert _events(got) == _events(want)
    assert _counters(got) == _counters(want)
    assert got["integrity"]["checks"] == want["integrity"]["checks"] > 0
    assert got["integrity"]["corruptions_detected"] == 0
    assert got["served"] == got["submitted"] == N_BATCHES * BATCH
    _same_outputs(got["outputs"], want["outputs"], name in BITWISE)


@pytest.mark.parametrize("name", ["sparse", "psum", "split_sparse"])
def test_every_rank_serves_the_committed_generation(cases, name):
    lead = cases[0][name]
    assert lead["generation"] == lead["replan"]["replans"] >= 1
    for r in range(1, WORLD):
        follow = cases[r][name]["follow"]
        assert follow["generation"] == lead["generation"]
        assert follow["lookups"]["plain"] == 0
        # the lookups, the parity probes included
        assert follow["lookups"]["fused"] == N_BATCHES + len(lead["replan"]["events"])


@pytest.mark.parametrize("name", ["sparse", "psum", "split_sparse"])
def test_swap_points_and_sweeps_report_every_rank(cases, name):
    log = cases[0][name]["op_log"]
    joins = [e for e in log if e["op"] == "join"]
    sweeps = [e for e in log if e["op"] == "verify"]
    assert len(joins) == len(cases[0][name]["replan"]["events"])
    assert all(len(e["build_s"]) == WORLD and min(e["build_s"]) > 0 for e in joins)
    assert sweeps and all(len(e["ms"]) == WORLD for e in sweeps)


def test_overlapped_builds(cases, one_process):
    got = cases[0]["overlap"]
    r = got["replan"]
    assert r["replans"] >= 1 and r["replan_errors"] == r["parity_failures"] == 0
    assert r["abandoned"] == 0
    assert got["served"] == got["submitted"] == N_BATCHES * BATCH
    for rank in range(1, WORLD):
        assert cases[rank]["overlap"]["follow"]["generation"] == got["generation"] >= 1
    _same_outputs(got["outputs"], one_process["sparse"]["outputs"], bitwise=False)


def test_no_collective_off_the_main_thread(cases):
    for r in range(WORLD):
        assert cases[r]["off_main"] == [], r


# --------------------------------------------------------------------------
# failures on any rank
# --------------------------------------------------------------------------


def test_replan_crash_on_rank_0(cases, one_process):
    got, want = cases[0]["crash0"], one_process["crash0"]
    assert got["replan"]["replan_errors"] == 1
    assert "injected crash" in got["replan"]["events"][0]["error"]
    assert _events(got) == _events(want) and _counters(got) == _counters(want)
    _same_outputs(got["outputs"], want["outputs"], bitwise=True)


@pytest.mark.parametrize("name,rank,message", [
    ("fail2", 2, "injected build failure"),
    ("mismatch1", 1, "packed another plan than rank 0"),
    ("stall2", 2, "its share was still building"),
])
def test_failed_share_is_counted_and_dropped(cases, name, rank, message):
    got = cases[0][name]
    first = got["replan"]["events"][0]
    assert got["replan"]["replan_errors"] == 1 and not first["parity_ok"]
    assert f"failed on ranks [{rank}]" in first["error"] and message in first["error"]
    # serving carries on, and a later rebuild swaps on every rank
    assert got["served"] == got["submitted"] == N_BATCHES * BATCH
    assert got["replan"]["replans"] >= 1
    for r in range(1, WORLD):
        assert cases[r][name]["follow"]["generation"] == got["generation"] >= 2


def test_stalled_build_on_rank_0_is_abandoned(cases):
    got = cases[0]["stall0"]
    assert got["replan"]["abandoned"] == 1
    assert any(e.get("abandoned") for e in got["replan"]["events"])
    assert got["served"] == got["submitted"] == N_BATCHES * BATCH
    for r in range(1, WORLD):
        follow = cases[r]["stall0"]["follow"]
        assert follow["generation"] == got["generation"]
        assert follow["held"] == sorted({0, got["generation"]})


@pytest.mark.parametrize("name", [n for n in CASES if n not in ("bitflip", "degraded")])
def test_followers_free_every_other_generation(cases, name):
    """At the end a follower holds gen 0 and the live generation, and every
    other share it built (superseded, failed, dropped) has been freed."""
    lead = cases[0][name]
    for r in range(1, WORLD):
        follow = cases[r][name]["follow"]
        assert follow["held"] == sorted({0, lead["generation"]})
        assert follow["shares_alive"] == [g for g in follow["held"] if g]


# --------------------------------------------------------------------------
# integrity across ranks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sparse", "cache"])
def test_rank_manifests_make_up_the_one_process_manifest(cases, name):
    whole = _one_process(name).manifest
    kinds = {k[0] for k in whole.checksums}
    assert ("cache" in kinds) == (name == "cache")
    union_crc, union_spans = {}, {}
    for r in range(WORLD):
        m = cases[r][name]["manifest"]
        for k, crc in m["checksums"].items():
            if k[0] == "sym":
                assert whole.checksums[k] == crc  # each rank's own copy
            else:
                assert k[1] == r and k not in union_crc
                union_crc[k] = crc
        union_spans.update(m["spans"])
    assert union_crc == {k: v for k, v in whole.checksums.items() if k[0] != "sym"}
    assert union_spans == whole.spans


def test_stripped_slice_manifest_has_its_core_keys():
    from repro_torch.core.integrity import IntegrityManifest

    eng = _one_process("sparse")
    whole = eng.manifest
    for core in range(WORLD):
        part = IntegrityManifest.from_packed(eng.packed.strip_core(core), eng.plan, core=core)
        mine = {k: v for k, v in whole.checksums.items() if k[0] == "sym" or k[1] == core}
        assert part.checksums == mine and part.core == core
        assert part.spans == {k: v for k, v in whole.spans.items() if k[1] == core}
        assert part.verify(eng.packed.strip_core(core)) == []


def test_bit_flips_found_under_global_keys_and_healed(cases, one_process):
    got, want = cases[0]["bitflip"], one_process["bitflip"]
    flipped = [tuple(k) for r in range(WORLD) for k in cases[r]["bitflip"]["flipped"]]
    assert [k[:2] for k in flipped] == [("chunk", 1), ("tail", 3)]
    gi, wi = got["integrity"], want["integrity"]
    for key in ("checks", "corruptions_detected", "heals", "quarantined_regions",
                "heal_failures"):
        assert gi[key] == wi[key], key
    assert gi["corruptions_detected"] == 2 and gi["heals"] == 1
    first = gi["events"][0]
    assert [tuple(k) for k in first["regions"]] == flipped
    assert first["regions"] == wi["events"][0]["regions"] and first["healed"]
    assert sorted(first["report"]["healed"]) == sorted(wi["events"][0]["report"]["healed"])
    _same_outputs(got["outputs"], want["outputs"], bitwise=True)
    # after the first sweep (batch 4) the outputs are a clean run's
    wl, tables, _ = _inputs()
    clean = InferenceEngine.build(tables, wl, EngineConfig(**SMOKE, mesh_shape=[1, WORLD]),
                                  device="cpu")
    for b, idx in enumerate(_stream()[4:], start=4):
        want_b = clean.lookup(idx).numpy()
        for q in range(BATCH):
            assert np.array_equal(got["outputs"][b * BATCH + q], want_b[:, q])


def test_cache_region_flip_healed_on_its_rank(cases, one_process):
    """A plan with a residency cache: the flipped cache region of core 2 is
    found under its global key and healed on rank 2; the replans (hot-set
    carves) and outputs are the one-process run's."""
    got, want = cases[0]["cache"], one_process["cache"]
    rows = [cases[r]["cache"]["cache_rows"] for r in range(WORLD)]
    assert rows == [_one_process("cache").packed.cache_rows] * WORLD and rows[0] > 0
    flipped = [tuple(k) for r in range(WORLD) for k in cases[r]["cache"]["flipped"]]
    assert flipped == [("cache", 2, -1)]
    gi, wi = got["integrity"], want["integrity"]
    for key in ("checks", "corruptions_detected", "heals", "quarantined_regions",
                "heal_failures"):
        assert gi[key] == wi[key], key
    first = gi["events"][0]
    assert [tuple(k) for k in first["regions"]] == flipped and first["healed"]
    assert first["report"]["healed"] == wi["events"][0]["report"]["healed"] == ["cache[core=2]"]
    assert got["replan"]["replans"] >= 1
    assert _events(got) == _events(want) and _counters(got) == _counters(want)
    _same_outputs(got["outputs"], want["outputs"], bitwise=True)


def test_degraded_fallback_across_ranks(cases, one_process):
    got, want = cases[0]["degraded"], one_process["degraded"]
    assert got["degraded_batches"] == want["degraded_batches"] >= 1
    assert got["batch_failures"] == want["batch_failures"] == 1
    _same_outputs(got["outputs"], want["outputs"], bitwise=True)
    for r in range(1, WORLD):
        lookups = cases[r]["degraded"]["follow"]["lookups"]
        assert lookups["plain"] == got["degraded_batches"]
        assert lookups["fused"] + lookups["plain"] == N_BATCHES - 1


# --------------------------------------------------------------------------
# against the reference's Server on 4 forced host devices
# --------------------------------------------------------------------------

_REFERENCE = """
import json, sys
import numpy as np, jax.numpy as jnp
from repro.engine import EngineConfig, InferenceEngine
from repro.data.workloads import small_workload

data = np.load(sys.argv[1])
cfg = json.loads(sys.argv[2])
tables = [jnp.asarray(data[f"t{i}"]) for i in range(int(data["n"]))]
stream = data["stream"]
wl = small_workload(batch=stream.shape[2])
eng = InferenceEngine.build(tables, wl, EngineConfig(use_kernels="xla", **cfg))
srv = eng.serve(max_wait_s=0.0)
handles = []
for idx in stream:
    handles += [srv.submit_request(idx[:, q]) for q in range(idx.shape[1])]
    srv.pump()
srv.drain()
events = [[e["batch"], e["parity_ok"]] for e in srv.stats()["replan"]["events"]]
np.savez(sys.argv[3], outputs=np.stack([np.asarray(h.result()) for h in handles]),
         events=np.asarray(events, np.int64).reshape(-1, 2))
print("OK")
"""


def test_sparse_replans_match_reference_server(cases, tmp_path):
    _, tables, _ = _inputs()
    np.savez(tmp_path / "inputs.npz", stream=np.stack(_stream()), n=len(tables),
             **{f"t{i}": t for i, t in enumerate(tables)})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(tmp_path / "inputs.npz"),
         json.dumps(CASES["sparse"]), str(tmp_path / "out.npz")],
        capture_output=True, text=True, env=env, timeout=100)
    assert proc.returncode == 0 and proc.stdout.startswith("OK"), proc.stdout + proc.stderr[-3000:]
    ref = np.load(tmp_path / "out.npz")
    got = cases[0]["sparse"]
    assert [[e["batch"], e["parity_ok"]] for e in got["replan"]["events"]] == \
        ref["events"].tolist()
    np.testing.assert_allclose(np.stack(got["outputs"]), ref["outputs"], **TOL)


# --------------------------------------------------------------------------
# the serve CLI under four ranks: a shipped preset
# --------------------------------------------------------------------------

PRESET_CLI = ["--device", "cpu", "--preset", "taobao-zipf12", "--workload", "smoke",
              "--batch", str(BATCH), "--queries", str(24 * BATCH),
              "--drift", "zipf:1.2@8,hotset:0.01:0.9:-1@16",
              "--set", 'drift_options={"overlap": false}', "--set", "deadline_s=null",
              "--set", 'integrity_options={"check_every": 4}']


def _preset_cli(rank, tmp):
    from repro_torch.launch import serve

    res = serve.main(PRESET_CLI)
    if rank == 0:
        (s,) = res["stats"].values()
        res = {"logits": res["served_logits"], "replan": s["replan"],
               "integrity": s["integrity"], "served": s["served"],
               "submitted": s["submitted"], "report": res["engine"].plan_report()}
    else:
        res = {"followed": res["followed"], "follow": res["engine"].follow_stats}
    torch.save(res, f"{tmp}/preset_{rank}.pt")


def test_preset_under_four_ranks(tmp_path):
    from repro_torch.launch import serve

    codes, errors = spawn(_preset_cli, tmp_path)
    assert codes == [0] * WORLD, errors
    lead = torch.load(tmp_path / "preset_0.pt", weights_only=False)
    one = serve.main(PRESET_CLI + ["--set", f"mesh_shape=[1,{WORLD}]"])
    (s,) = one["stats"].values()
    assert lead["served"] == lead["submitted"] == 24 * BATCH
    assert lead["replan"]["replans"] >= 1 and lead["replan"]["replan_errors"] == 0
    assert [(e["batch"], e["parity_ok"]) for e in lead["replan"]["events"]] == \
        [(e["batch"], e["parity_ok"]) for e in s["replan"]["events"]]
    assert lead["integrity"]["checks"] == s["integrity"]["checks"] > 0
    np.testing.assert_allclose(lead["logits"], one["served_logits"], rtol=1e-4, atol=1e-4)
    for r in range(1, WORLD):
        follow = torch.load(tmp_path / f"preset_{r}.pt", weights_only=False)["follow"]
        assert follow["generation"] == lead["replan"]["replans"]
    assert "cards: 4 ranks (gloo)" in lead["report"] and "drift policy=replan" in lead["report"]
