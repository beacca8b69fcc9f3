"""Serving through the port on the CPU: the engine-built Server round trip,
the serve CLI, the engine's config surface, and the no-silent-fallback
rules (the default device is the card; a missing card raises)."""
import json

import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as JEngineConfig
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.launch import serve as serve_cli

TOL = dict(rtol=1e-5, atol=1e-5)


def _engine(**cfg):
    wl = small_workload(batch=16)
    cfg.setdefault("mesh_shape", (1, 4))
    cfg.setdefault("distribution", "uniform")
    cfg.setdefault("planner_options", {"shard_rocks": False})
    return InferenceEngine.build(None, wl, EngineConfig(**cfg), device="cpu")


def _queries(wl, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = np.full((len(wl.tables), max(t.seq for t in wl.tables)), -1, np.int32)
        for i, t in enumerate(wl.tables):
            q[i, : t.seq] = rng.integers(0, t.rows, size=t.seq)
        out.append(q)
    return out


def test_serve_round_trip_matches_lookup():
    engine = _engine(max_batch=8)
    assert engine.plan.symmetric_tables  # the fallback group is exercised
    srv = engine.serve()
    queries = _queries(engine.workload, 20)
    handles = [srv.submit_request(q) for q in queries]
    srv.pump()
    srv.drain()
    want = engine.lookup(np.stack(queries, axis=1)).numpy()
    for i, h in enumerate(handles):
        assert h.done()
        np.testing.assert_allclose(h.result(), want[:, i], **TOL)
    s = srv.stats()
    assert s["submitted"] == 20 == s["served"]
    assert s["submitted"] == (s["served"] + s["shed"] + s["rejected"] + s["failed"]
                              + s["invalid"] + s["pending"])
    assert s["batch_failures"] == s["degraded_batches"] == 0


def _broken(payloads):
    raise RuntimeError("kernel launch failed")


def _broken_unless_plain(eng):
    return _broken if eng.config.use_kernels == "fused" else eng._default_step()


def test_degraded_fallback_serves_plain_path():
    """On a CPU engine a failing primary step hands batches to the reference
    view (the plain gather path) after degrade_after failures; results stay
    exact."""
    engine = _engine(max_batch=4, degrade_after=1)
    srv = engine.serve(make_step=_broken_unless_plain)
    queries = _queries(engine.workload, 8, seed=3)
    handles = [srv.submit_request(q) for q in queries]
    srv.pump()
    srv.drain()
    s = srv.stats()
    assert s["degraded_batches"] >= 1 and s["served"] >= 4
    want = engine.lookup(np.stack(queries, axis=1)).numpy()
    served = [i for i, h in enumerate(handles) if h.done() and h._error is None]
    assert len(served) == s["served"]
    for i in served:
        np.testing.assert_allclose(handles[i].result(), want[:, i], **TOL)


def test_cuda_engine_builds_no_plain_fallback():
    """A CUDA engine's server has no plain fallback, whatever degrade_after
    says: a failing kernel step fails its batch and is counted, never served
    by the plain version.  The engine is a CUDA-device view over a CPU pack:
    serve() and the failing step touch no card."""
    cpu = _engine(max_batch=4, degrade_after=1)
    engine = InferenceEngine(
        config=cpu.config, workload=cpu.workload, bag=cpu.bag, packed=cpu.packed,
        device=torch.device("cuda"), freqs=cpu.freqs, table_data=cpu.table_data,
        cost_model=cpu.cost_model,
    )
    srv = engine.serve(make_step=_broken_unless_plain)
    assert srv.fallback_step_fn is None
    for q in _queries(engine.workload, 8, seed=3):
        srv.submit_request(q)
    srv.pump()
    srv.drain()
    s = srv.stats()
    assert s["batch_failures"] >= 2 and s["degraded_batches"] == 0 and s["served"] == 0


def test_serve_cli_on_cpu(capsys, tmp_path):
    saved = tmp_path / "engine.json"
    result = serve_cli.main([
        "--workload", "smoke", "--batch", "32", "--queries", "64",
        "--distribution", "uniform", "--device", "cpu",
        "--set", "mesh_shape=[1,4]", "--set", 'planner_options={"shard_rocks": false}',
        "--save-config", str(saved),
    ])
    out = capsys.readouterr().out
    assert "predicted P99" in out and "tpu_v5e preset" in out
    assert "dist=uniform" in out and "device=cpu" in out
    s = result["stats"]["uniform"]
    assert s["submitted"] == 64 == s["served"]
    # a CPU engine's degraded mode serves from the reference view's step
    assert result["server"].fallback_step_fn is not None
    logits = result["last"]["logits"]
    assert logits.shape == (32,) and np.isfinite(logits).all()
    cfg = EngineConfig.load(saved)
    assert cfg.mesh_shape == (1, 4) and cfg.max_batch == 32
    # the served logits equal a forward over the engine's packed tables
    from repro_torch.models.dlrm import forward_packed

    engine = result["engine"]
    want = forward_packed(
        result["cfg"], engine.bag, engine.packed, result["params"],
        {"dense": torch.from_numpy(result["last"]["dense"]),
         "indices": result["last"]["indices"]},
    )
    np.testing.assert_allclose(logits, want.numpy(), **TOL)


def test_cli_shard_rocks_default_and_unknown_flags():
    args = serve_cli.build_parser().parse_args(["--workload", "taobao"])
    assert serve_cli.config_from_args(args).planner_options == {"shard_rocks": True}
    with pytest.raises(SystemExit):
        serve_cli.build_parser().parse_args(["--preset", "taobao-zipf12"])
    with pytest.raises(SystemExit):
        serve_cli.main(["--workload", "nope", "--device", "cpu"])


def test_reference_config_json_loads_unchanged():
    jcfg = JEngineConfig(distribution="zipf:1.2", mesh_shape=(1, 8), max_batch=512,
                         planner_options={"lpt": True}, degrade_after=0)
    cfg = EngineConfig.from_json(jcfg.to_json())
    assert cfg.to_dict() == json.loads(jcfg.to_json()) | {"mesh_shape": (1, 8)}
    assert EngineConfig.from_json(cfg.to_json()) == cfg
    cfg.validate()
    assert [f for f in EngineConfig.__dataclass_fields__] == [
        f for f in JEngineConfig.__dataclass_fields__]


@pytest.mark.parametrize("field,value,item", [
    ("access", "full", "A7"), ("drift", "replan", "A6"), ("integrity", "checksum", "A8"),
    ("tuning", "sweep", "A7"), ("layout", "dense", "B8"), ("planner", "hierarchical", "A4"),
    ("model", "dlrm", "A9"),
])
def test_unported_config_values_raise(field, value, item):
    with pytest.raises(NotImplementedError, match=item):
        _engine(**{field: value})


def test_bad_config_values_raise_like_reference():
    for bad in (dict(reduce_mode="x"), dict(hardware="h100"), dict(max_batch=0),
                dict(kernel_path="sparse")):
        with pytest.raises(ValueError):
            EngineConfig(**bad).validate()


def test_default_device_is_the_card(monkeypatch):
    """No silent CPU fallback: without CUDA the default build raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.build(None, small_workload(batch=16), EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--workload", "smoke", "--queries", "8", "--batch", "8"])


def test_stats_and_report():
    engine = _engine()
    s = engine.stats()
    assert s["n_cores"] == 4 and s["device"] == "cpu"
    assert s["layout"]["kind"] == "ragged"
    report = engine.plan_report()
    assert "symmetric group" in report and "core 0" in report
