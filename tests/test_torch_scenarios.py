"""The four scenario towers in the port, held against the JAX package.

Mirrors ``tests/test_scenario_matrix.py`` for every registered scenario:
protocol conformance, table extraction, config stamping, step parity, a
drift rebuild, a served round trip, sampling in range, the forced-sparse
cell, the registry, and ``build_scenario`` by name.  The port's wrapper
holds the JAX wrapper's tables and tower parameters
(:func:`scenario_from_jax`; the two packages' initializers draw other
values), and on the CPU:

* the served step equals the port's own ``reference_forward`` bitwise (the
  JAX package's gate: seq=1 pooled vectors are row copies, and both paths
  run one tower module);
* the pooled embeddings are array-equal to the JAX wrapper's;
* the scores are within rtol = atol = 1e-5 of the JAX wrapper's;
* the MoE tower routes every token to the same experts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.distributions import Zipf as JZipf, get_distribution as jdist
from repro.engine import EngineConfig as JEngineConfig
from repro.models.registry import SCENARIOS as JSCENARIOS, get_scenario as jget_scenario
from repro_torch.data.distributions import Zipf, get_distribution, workload_probs
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.models.registry import SCENARIOS, get_scenario, list_scenarios
from repro_torch.models.scenarios import ScenarioModel, scenario_from_jax

BATCH = 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _carried(js, batch=BATCH):
    """The port's wrapper holding the JAX wrapper ``js``'s values."""
    return scenario_from_jax(js.name, [np.asarray(t) for t in js.table_data()],
                             jax.tree_util.tree_map(np.asarray, js.params),
                             batch=batch, device="cpu")


def _config(name, **over):
    return EngineConfig.from_dict({**SCENARIOS[name].default_config, "mesh_shape": (1, 1),
                                   **over})


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def cell(request):
    """One (JAX wrapper, port wrapper, port engine) per registered scenario,
    built through the entry's own default config."""
    name = request.param
    js = jget_scenario(name, batch=BATCH)
    ts = _carried(js)
    engine = InferenceEngine.from_scenario(ts, _config(name), device="cpu")
    return js, ts, engine


def test_protocol_conformance(cell):
    _, scenario, _ = cell
    assert isinstance(scenario, ScenarioModel)
    assert scenario.name in SCENARIOS
    assert scenario.workload.batch == BATCH
    assert scenario.device == torch.device("cpu")


def test_table_extraction_matches_workload(cell):
    js, scenario, _ = cell
    tables = scenario.table_data()
    specs = scenario.workload.tables
    assert len(tables) == len(specs)
    for arr, spec, want in zip(tables, specs, js.table_data()):
        assert tuple(arr.shape) == (spec.rows, spec.dim)
        np.testing.assert_array_equal(arr.numpy(), np.asarray(want))
    assert [(t.rows, t.dim, t.seq) for t in specs] == \
        [(t.rows, t.dim, t.seq) for t in js.workload.tables]


def test_config_stamps_model_name(cell):
    _, scenario, engine = cell
    assert engine.config.model == scenario.name
    assert engine.stats()["model"] == scenario.name
    assert f"model {scenario.name}" in engine.plan_report()
    assert engine.scenario is scenario


def test_step_parity_bitwise(cell):
    """Fused engine step == plain-lookup reference forward, bit for bit."""
    _, scenario, engine = cell
    batch = scenario.sample_batch(np.random.default_rng(0), Zipf(1.2))
    got = np.asarray(scenario.make_step(engine)(scenario.payloads(batch)))
    assert got.shape == (BATCH,)
    np.testing.assert_array_equal(got, scenario.reference_forward(batch))


def test_matches_reference_package(cell):
    """The same values, the same batch: the port's pooled lookups are
    array-equal to the JAX wrapper's, its scores within 1e-5."""
    js, scenario, engine = cell
    batch = scenario.sample_batch(np.random.default_rng(5), Zipf(1.2))
    jbatch = js.sample_batch(np.random.default_rng(5), JZipf(1.2))
    for key in batch:
        np.testing.assert_array_equal(batch[key], np.asarray(jbatch[key]))
    jpooled = np.asarray(js._pooled_reference(jnp.asarray(batch["indices"])))
    np.testing.assert_array_equal(engine.lookup(batch["indices"]).numpy(), jpooled)
    np.testing.assert_array_equal(scenario.pooled_reference(batch["indices"]).numpy(),
                                  jpooled)
    step = scenario.make_step(engine)(scenario.payloads(batch))
    np.testing.assert_allclose(step, js.reference_forward(jbatch), **TOL)


def test_moe_routes_match_reference():
    """The MoE tower's router picks the same top-2 experts for every token
    in both packages (``torch.topk`` against ``lax.top_k``)."""
    js = jget_scenario("moe", batch=64)
    ts = _carried(js, batch=64)
    batch = ts.sample_batch(np.random.default_rng(7), Zipf(1.2))
    x = ts.pooled_reference(batch["indices"]).transpose(0, 1)  # (B, N, E)
    probs = torch.softmax(x @ ts.tower.moe["router"], dim=-1)
    got = torch.topk(probs, ts.spec.top_k, dim=-1).indices.numpy()
    jx = jnp.asarray(x.numpy())
    jprobs = jax.nn.softmax(jx @ js.params["moe"]["router"], axis=-1)
    want = np.asarray(jax.lax.top_k(jprobs, js.spec.top_k)[1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("attn_block", [1024, 4, 3])
def test_attention_blocks_match_reference(attn_block):
    """The transformer tower's attention against the JAX package's on the
    same weights and tokens, over one KV block and over several (with a
    padded last block at 4 of 6 tokens); anything but the towers' case
    raises."""
    from repro.models.layers import AttnSpec as JAttnSpec, attention as jattention
    from repro_torch.models.layers import AttnSpec, attention

    js = jget_scenario("transformer", batch=8)
    params = jax.tree_util.tree_map(np.asarray, js.params["attn"])
    x = np.random.default_rng(9).standard_normal((8, 6, 16)).astype(np.float32)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, causal=False, rope=None,
              attn_block=attn_block)
    want, _ = jattention(js.params["attn"], jnp.asarray(x), JAttnSpec(**kw),
                         positions=jnp.broadcast_to(jnp.arange(6)[None], (8, 6)))
    got, cache = attention({k: torch.tensor(v) for k, v in params.items()},
                           torch.tensor(x), AttnSpec(**kw))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(NotImplementedError):
        attention(params, torch.tensor(x), AttnSpec(**dict(kw, causal=True)))


def test_rebuild_after_drift_hot_swap(cell):
    """The drift policy's shadow re-pack keeps the scenario and bit parity."""
    _, scenario, engine = cell
    rebuilt = engine.rebuild(workload_probs(scenario.workload, Zipf(1.2)))
    assert rebuilt.scenario is scenario
    batch = scenario.sample_batch(np.random.default_rng(1), Zipf(1.2))
    got = np.asarray(scenario.make_step(rebuilt)(scenario.payloads(batch)))
    np.testing.assert_array_equal(got, scenario.reference_forward(batch))


def test_served_roundtrip(cell):
    """Request-level parity through ``engine.serve`` with the scenario's own
    step and split (none passed)."""
    _, scenario, engine = cell
    srv = engine.serve(max_batch=8, max_wait_s=0.0)
    batch = scenario.sample_batch(np.random.default_rng(2), Zipf(1.2), batch=8)
    handles = [srv.submit_request(p) for p in scenario.payloads(batch)]
    srv.pump(force=True)
    got = np.asarray([h.result() for h in handles])
    np.testing.assert_array_equal(got, scenario.reference_forward(batch))
    assert srv.stats()["served"] == 8


def test_distribution_sampling_in_range(cell):
    js, scenario, _ = cell
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for spec in ("uniform", "zipf:1.2", "hotset:0.02:0.9"):
        idx = np.asarray(scenario.sample_batch(rng, get_distribution(spec))["indices"])
        np.testing.assert_array_equal(
            idx, np.asarray(js.sample_batch(jrng, jdist(spec))["indices"]))
        assert idx.shape[:2] == (len(scenario.workload.tables), BATCH)
        for i, t in enumerate(scenario.workload.tables):
            valid = idx[i][idx[i] >= 0]
            assert valid.size and valid.max() < t.rows


def test_forced_sparse_kernel_cell():
    """The dlrm scenario under its dedup-armed default config serves
    bit-identically whether the dedup'd gather runs one-hot or sparse, and
    both match the reference forward."""
    scenario = get_scenario("dlrm", batch=BATCH, device="cpu")
    batch = scenario.sample_batch(np.random.default_rng(4), Zipf(1.2))
    outs, engines = {}, {}
    for kp in ("onehot", "sparse"):
        engines[kp] = InferenceEngine.from_scenario(scenario, _config("dlrm", kernel_path=kp))
        outs[kp] = np.asarray(scenario.make_step(engines[kp])(scenario.payloads(batch)))
    assert engines["sparse"].packed.kernel_path == "sparse"
    assert engines["onehot"].packed.kernel_path == "onehot"
    np.testing.assert_array_equal(outs["sparse"], outs["onehot"])
    np.testing.assert_array_equal(outs["sparse"], scenario.reference_forward(batch))


# -----------------------------------------------------------------------
# registry
# -----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_default_config_validates(name):
    entry = SCENARIOS[name]
    assert entry.default_config == JSCENARIOS[name].default_config
    assert entry.description == JSCENARIOS[name].description
    cfg = EngineConfig.from_dict({**entry.default_config, "model": name})
    cfg.validate()
    assert cfg.model == name
    assert cfg.to_dict() == JEngineConfig.from_dict(
        {**entry.default_config, "model": name}).to_dict()


def test_unknown_config_field_rejected():
    entry = next(iter(SCENARIOS.values()))
    with pytest.raises((TypeError, ValueError)):
        EngineConfig.from_dict({**entry.default_config, "not_a_field": 1})


def test_unknown_model_name_rejected():
    with pytest.raises(ValueError, match="unknown"):
        EngineConfig(model="nope").validate()
    with pytest.raises(ValueError, match="nope"):
        get_scenario("nope", device="cpu")


def test_list_scenarios_sorted_and_complete():
    assert list_scenarios() == sorted(SCENARIOS) == sorted(JSCENARIOS)
    assert set(list_scenarios()) == {"dlrm", "moe", "mamba2", "transformer"}


def test_build_scenario_by_name():
    eng = InferenceEngine.build_scenario("transformer", EngineConfig(mesh_shape=(1, 1)),
                                         device="cpu", batch=8)
    assert eng.config.model == "transformer"
    assert eng.scenario is not None and eng.scenario.workload.batch == 8
    assert eng.device == eng.scenario.device == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_build_scenario_from_config_model(name):
    """``EngineConfig(model=name)`` alone names the scenario; its engine
    serves the tower, equal to the reference forward."""
    cfg = dataclasses.replace(_config(name), model=name, max_batch=8)
    eng = InferenceEngine.build_scenario(config=cfg, device="cpu", batch=8)
    assert eng.scenario.name == name
    srv = eng.serve()
    batch = eng.scenario.sample_batch(np.random.default_rng(6), Zipf(1.2))
    handles = [srv.submit_request(p) for p in eng.scenario.payloads(batch)]
    srv.drain()
    s = srv.stats()
    assert s["served"] == s["submitted"] == 8 and s["batch_failures"] == 0
    np.testing.assert_array_equal(np.asarray([h.result() for h in handles]),
                                  eng.scenario.reference_forward(batch))


def test_scenario_on_another_device_keeps_values(monkeypatch):
    """``on`` copies a wrapper with the same tables and tower values (the
    card's CPU twin); the copy's tower is its own.  The default device is
    the card: without one a wrapper raises."""
    scenario = get_scenario("mamba2", batch=BATCH, device="cpu")
    twin = scenario.on("cpu")
    assert twin.tower is not scenario.tower
    batch = scenario.sample_batch(np.random.default_rng(8), Zipf(1.2))
    np.testing.assert_array_equal(twin.reference_forward(batch),
                                  scenario.reference_forward(batch))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_scenario("mamba2", batch=BATCH)
