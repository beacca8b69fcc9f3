"""The block-size sweep's record and ranking, on the CPU.

* Every candidate of a sweep carries ``device_us`` beside ``wall_us``: the
  card's own time on CUDA, ``None`` on the CPU, where the sweep still ranks
  by ``wall_us``.
* :func:`best_candidate` ranks by ``device_us`` for ``"cuda"`` and by
  ``wall_us`` for ``"cpu"`` when the two disagree.
* ``TuningCache`` keeps ``device_us`` through ``save``/``load``.
* ``block_sizes`` packs at the given sizes with no sweep, and a rebuild
  passes the live engine's only on the card: the CPU sweeps again, as the
  reference does.
* The card's ``device_us`` is CUDA-event time of lookups held behind a
  spin kernel on the sweep's stream: the events are scripted here (a spin
  that ended before the host's enqueue did is run again, four times as
  long, and the sweep raises when none held).

The record's top-level keys and its candidate list against the reference's
are held in ``tests/test_torch_access.py``.
"""
import contextlib
import types

import pytest
import torch

from repro_torch.core import autotune as tune
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine


def _cpu_sweep(tuning_cache=None):
    cfg = EngineConfig(mesh_shape=(1, 2), distribution="zipf:1.2", access="full",
                       tuning="sweep")
    return InferenceEngine.build(None, small_workload(batch=16), cfg, device="cpu",
                                 tuning_cache=tuning_cache)


def test_cpu_sweep_records_device_us_none_and_ranks_by_wall():
    eng = _cpu_sweep()
    t = eng.plan.meta["tuning"]
    assert t["backend"] == "cpu" and len(t["candidates"]) == 4
    assert all("device_us" in c and c["device_us"] is None for c in t["candidates"])
    assert t["best"]["wall_us"] == min(c["wall_us"] for c in t["candidates"])
    assert eng.packed.block_r == t["best"]["block_r"]


# wall and device times that disagree: the host ranks 64 first, the card 256
MADE_UP = [
    {"block_r": 64, "wall_us": 900.0, "device_us": 210.0},
    {"block_r": 128, "wall_us": 1100.0, "device_us": 120.0},
    {"block_r": 256, "wall_us": 1500.0, "device_us": 60.0},
    {"block_r": 512, "wall_us": 1200.0, "device_us": 65.0},
]


@pytest.mark.parametrize("backend,want", [("cuda", 256), ("cpu", 64)])
def test_best_candidate_ranks_by_device_time_on_the_card(backend, want):
    assert tune.best_candidate(MADE_UP, backend)["block_r"] == want


def test_best_candidate_on_the_cpu_ignores_missing_device_time():
    cands = [dict(c, device_us=None) for c in MADE_UP]
    assert tune.best_candidate(cands, "cpu")["block_r"] == 64


@pytest.mark.parametrize("record", ["cpu_sweep", "made_up"])
def test_tuning_cache_round_trip_keeps_device_us(tmp_path, record):
    cache = tune.TuningCache()
    if record == "cpu_sweep":
        _cpu_sweep(cache)
    else:
        best = tune.best_candidate(MADE_UP, "cuda")
        cache.store("k", {"tuning": {"candidates": MADE_UP, "best": best, "backend": "cuda",
                                     "compiled": True, "iters": 2},
                          "best": {"block_r": best["block_r"]}})
    path = tmp_path / "tuning.json"
    cache.save(path)
    again = tune.TuningCache()
    again.load(path)
    assert len(again) == len(cache) == 1
    (key,) = cache._store
    got, want = again.lookup(key), cache.lookup(key)
    assert got == want
    assert [c["device_us"] for c in got["tuning"]["candidates"]] == \
        [c["device_us"] for c in want["tuning"]["candidates"]]
    assert "device_us" in got["tuning"]["best"]



class _FakeEvent:
    """A CUDA event whose ``query()`` follows a script: True when the card
    had reached it by the time the host asked (the spin did not hold)."""

    def __init__(self, script, times, log):
        self.script, self.times, self.log = script, times, log

    def record(self, stream):
        self.log.append("record")

    def query(self):
        return next(self.script)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return next(self.times)


@pytest.mark.parametrize("reached,want,spins", [
    ([False], 0.5, [10_000_000]),  # the spin held the lookups: one try
    ([True, False], 0.5, [10_000_000, 40_000_000]),  # too short: 4x longer
    ([True, True, True, False], 0.5, [10_000_000 * 4**k for k in range(4)]),
    ([True] * 5, None, [10_000_000 * 4**k for k in range(5)]),  # never held: raises
])
def test_device_us_counts_the_lookups_held_behind_the_spin(monkeypatch, reached, want, spins):
    """The sweep's time on the card: CUDA events around lookups queued behind
    a spin kernel on the sweep's stream, counted only when the spin still
    held them once the host had enqueued them all (the start event not yet
    reached); a spin that ended first is run again four times as long."""
    script, log, slept = iter(reached), [], []
    times = iter([1.0] * 5)  # ms for 2 lookups -> 500 us each
    events = iter(range(100))
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing: _FakeEvent(
        script if next(events) % 2 == 0 else iter([True]), times, log))
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "_sleep", slept.append)
    runs = []
    if want is None:
        with pytest.raises(RuntimeError, match="outlasted every gate"):
            tune._device_us(lambda: runs.append(1), 2, object())
    else:
        assert tune._device_us(lambda: runs.append(1), 2, object()) == pytest.approx(want * 1e3)
    assert slept == spins and len(runs) == 2 * len(spins)
    assert log == ["record", "record"] * len(spins)



@pytest.mark.parametrize("block_r", [64, 128, 256, 512])
def test_pinned_block_sizes_skip_the_sweep(block_r):
    """A build given ``block_sizes`` records no sweep, packs at that
    ``block_r`` with the planner's access sizes (those of a sweep over the
    default candidates), and looks up what the swept engine does (pooled
    within 1e-5: the block size moves only the plain version's order)."""
    swept = _cpu_sweep()
    pinned = InferenceEngine.build(None, swept.workload, swept.config, device="cpu",
                                   block_sizes={"block_r": block_r, "block_b": None})
    assert "tuning" not in pinned.plan.meta and pinned.packed.block_r == block_r
    sched = lambda e: (e.packed.unique_cap, e.packed.cache_rows, e.packed.kernel_path)  # noqa: E731
    assert sched(pinned) == sched(swept)
    idx = torch.from_numpy(tune._synthetic_indices(swept.workload.tables, swept.workload.batch,
                                                   swept.freqs, 0))
    assert torch.allclose(pinned.lookup(idx), swept.lookup(idx), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("device,tuning,pinned", [
    ("cpu", "sweep", False), ("cuda", "sweep", True), ("cuda", "fixed", False)])
def test_rebuild_pins_block_sizes_on_the_card_only(monkeypatch, device, tuning, pinned):
    """``rebuild`` hands ``build`` the live engine's block sizes only where a
    swept engine serves on the card (``build`` is recorded here, so the
    card's branch runs on the CPU)."""
    cfg = EngineConfig(mesh_shape=(1, 2), distribution="zipf:1.2", access="full",
                       tuning=tuning, tuning_options={} if tuning == "sweep" else {"block_r": 128})
    eng = InferenceEngine.build(None, small_workload(batch=16), cfg, device="cpu")
    seen = {}

    def build(*args, **kwargs):
        seen.update(kwargs)
        return types.SimpleNamespace()

    monkeypatch.setattr(eng, "device", torch.device(device))
    monkeypatch.setattr(InferenceEngine, "build", build)
    eng.rebuild(eng.freqs)
    want = {"block_r": eng.packed.block_r, "block_b": eng.packed.block_b or None}
    assert seen["device"] == torch.device(device)
    assert seen["block_sizes"] == (want if pinned else None)
