"""The block-size sweep's record and ranking, on the CPU.

* Every candidate of a sweep carries ``device_us`` beside ``wall_us``: the
  card's own time on CUDA, ``None`` on the CPU, where the sweep still ranks
  by ``wall_us``.
* :func:`best_candidate` ranks by ``device_us`` for ``"cuda"`` and by
  ``wall_us`` for ``"cpu"`` when the two disagree.
* ``TuningCache`` keeps ``device_us`` through ``save``/``load``.

The record's top-level keys and its candidate list against the reference's
are held in ``tests/test_torch_access.py``.
"""
import pytest

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
