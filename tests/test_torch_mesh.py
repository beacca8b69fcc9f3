"""The two-level mesh in the port, held against the JAX package.

Mirrors ``tests/test_mesh.py``: mesh-shape resolution, the ``(1, n)``
collapse (plan, pack and output bit-identical to the flat planner's), the
host-local hierarchical plan, ``cross_host_sends == 0``, the rejoin on every
mesh shape against a dense oracle, the fixed-shape partition property, the
cross-host byte and time model, and the engine wiring.  Everything here is
host code: every plan, map, packed array and modeled figure is compared with
the reference's by ``array_equal`` or ``==``.  The port's lookups (the fused
kernel's plain version, then the owner-sharded rejoin on the CPU) are held
against a numpy oracle within rtol = atol = 2e-5, the reference's tolerance
for the same check.  One taobao case (batch 8192, zipf 1.2, dedup, the
``a100`` preset on a 2x4 mesh, where five tables are row-sharded over both
hosts) compares assignments, ``meta["mesh"]``, ``unique_cap`` and the rejoin
maps with the reference's.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import partition as jpart
from repro.core.embedding import PartitionedEmbeddingBag as JBag
from repro.core.mesh import plan_hierarchical as jplan_hierarchical
from repro.core.tables import make_workload as jmake_workload
from repro.core.traffic import modeled_cross_host_traffic as jcross
from repro.data.distributions import Zipf as JZipf, workload_probs as jprobs
from repro.data.distributions import get_distribution as jdist
from repro.data.workloads import get_workload as jget
from repro.engine import EngineConfig as JEngineConfig, InferenceEngine as JEngine
from repro_torch.core import cost_model as tcm
from repro_torch.core import partition as tpart
from repro_torch.core.embedding import PartitionedEmbeddingBag, stack_indices
from repro_torch.core.mesh import (
    MeshShapeError,
    host_of_core,
    plan_hierarchical,
    resolve_mesh_shape,
)
from repro_torch.core.planner import plan_asymmetric
from repro_torch.core.tables import make_workload
from repro_torch.core.traffic import modeled_cross_host_traffic
from repro_torch.data.distributions import Zipf, get_distribution, workload_probs
from repro_torch.data.workloads import get_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from test_torch_partition import assert_packs_equal

E = 16
TOL = dict(rtol=2e-5, atol=2e-5)  # the reference's tolerance for this check
ROWS = [900, 260, 1400, 70, 40, 512]
SEQS = [2, 1, 3, 1, 1, 2]


def _models(l1_bytes=4096):
    return (jcm.analytic_model(dataclasses.replace(jcm.TPU_V5E, l1_bytes=l1_bytes)),
            tcm.analytic_model(dataclasses.replace(tcm.TPU_V5E, l1_bytes=l1_bytes)))


def _wls(batch=32, rows=ROWS, seqs=SEQS, name="mesh"):
    return (jmake_workload(name, rows, dim=E, seqs=seqs, batch=batch),
            make_workload(name, rows, dim=E, seqs=seqs, batch=batch))


def _assignments(plan):
    return [(a.table_idx, a.core, a.row_offset, a.rows, a.strategy.name, a.batch_frac)
            for a in plan.assignments]


def assert_plans_equal(tplan, jplan):
    assert _assignments(tplan) == _assignments(jplan)
    assert list(tplan.symmetric_tables) == list(jplan.symmetric_tables)
    assert [s.name for s in tplan.symmetric_strategies] == \
        [s.name for s in jplan.symmetric_strategies]
    assert tplan.n_cores == jplan.n_cores
    assert tplan.meta == jplan.meta


def _bags(hosts, cph, *, batch=32, rows=ROWS, seqs=SEQS, freqs_dist=None, **kw):
    """The same hierarchical bag in both packages, packed on the same tables."""
    jwl, twl = _wls(batch, rows, seqs)
    jmodel, tmodel = _models()
    jkw, tkw = dict(hosts=hosts, **kw), dict(hosts=hosts, **kw)
    if freqs_dist is not None:
        jkw["freqs"] = jprobs(jwl, freqs_dist[0])
        tkw["freqs"] = workload_probs(twl, freqs_dist[1])
    jbag = JBag(jwl, n_cores=hosts * cph, planner="hierarchical", cost_model=jmodel,
                planner_kwargs=jkw)
    tbag = PartitionedEmbeddingBag(twl, n_cores=hosts * cph, planner="hierarchical",
                                   cost_model=tmodel, planner_kwargs=tkw)
    rng = np.random.default_rng(hosts * 10 + cph)
    tables = [(rng.standard_normal((r, E)) / 4).astype(np.float32) for r in rows]
    jp = jbag.pack([jnp.asarray(t) for t in tables])
    tp = tbag.pack(tables)
    return jbag, tbag, jp, tp, tables


def _indices(wl, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, t.rows, (wl.batch, t.seq)).astype(np.int32) for t in wl.tables]


def _oracle(tables, idx):
    """Dense numpy oracle: (N, B, E) sum over each query's rows."""
    return np.stack([t[i].sum(axis=1) for t, i in zip(tables, idx)])


def _lookup(tbag, tp, idx):
    return tbag.apply(tp, stack_indices(idx, tbag.s_max)).numpy()


# --------------------------------------------------------------------------
# resolve_mesh_shape / host_of_core
# --------------------------------------------------------------------------


def test_resolve_mesh_shape_wins_over_n_cores():
    assert resolve_mesh_shape((2, 3), None) == (2, 3)
    assert resolve_mesh_shape([4, 2], 8) == (4, 2)  # JSON delivers a list


def test_resolve_legacy_n_cores_warns_deprecation():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert resolve_mesh_shape(None, 4) == (1, 4)
    assert any(issubclass(w.category, DeprecationWarning)
               and "mesh_shape=(1, 4)" in str(w.message) for w in caught)


def test_resolve_default_has_no_warning():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert resolve_mesh_shape(None, None, default_cores=6) == (1, 6)
    assert not caught


@pytest.mark.parametrize(
    "shape,n_cores",
    [((2, 3), 5), ((0, 4), None), ((2, -1), None), ("2x3", None), ((2,), None)],
)
def test_resolve_rejects_bad_geometry(shape, n_cores):
    with pytest.raises(MeshShapeError):
        resolve_mesh_shape(shape, n_cores, warn=False)


def test_mesh_shape_error_is_value_error():
    assert issubclass(MeshShapeError, ValueError)


def test_host_of_core():
    assert [host_of_core(c, 2) for c in range(6)] == [0, 0, 1, 1, 2, 2]


# --------------------------------------------------------------------------
# (1, n) collapse: bit-identical plans, packs and outputs
# --------------------------------------------------------------------------


def test_single_host_plan_is_bit_identical():
    jwl, twl = _wls()
    jmodel, tmodel = _models()
    flat = plan_asymmetric(twl, 4, tmodel, lpt=True)
    hier = plan_hierarchical(twl, 4, tmodel, hosts=1, lpt=True)
    assert hier.assignments == flat.assignments
    assert hier.symmetric_tables == flat.symmetric_tables
    assert hier.symmetric_strategies == flat.symmetric_strategies
    assert hier.meta["planner"] == flat.meta["planner"]
    assert hier.meta["mesh"] == {
        "hosts": 1, "cores_per_host": 4,
        "host_tables": [sorted({a.table_idx for a in flat.assignments})],
        "rocks": [],
    }
    assert_plans_equal(hier, jplan_hierarchical(jwl, 4, jmodel, hosts=1, lpt=True))


def test_single_host_pack_and_output_identical():
    _, twl = _wls()
    _, tmodel = _models()
    flat_bag = PartitionedEmbeddingBag(twl, n_cores=4, planner="asymmetric", cost_model=tmodel)
    jbag, hier_bag, jp, hier_packed, tables = _bags(1, 4)
    flat_packed = flat_bag.pack(tables)
    for field in ("chunk_data", "slot_table", "slot_offset", "slot_rows", "step_slot",
                  "rejoin_send", "rejoin_owned_pos", "rejoin_bucket"):
        assert torch.equal(getattr(flat_packed, field), getattr(hier_packed, field)), field
    assert_packs_equal(jp, hier_packed, jbag.plan, hier_bag.plan)
    idx = _indices(twl)
    np.testing.assert_array_equal(_lookup(hier_bag, hier_packed, idx),
                                  _lookup(flat_bag, flat_packed, idx))


# --------------------------------------------------------------------------
# multi-host plans: validity, host-locality, hierarchical rejoin maps
# --------------------------------------------------------------------------


def test_hierarchical_plan_host_local_and_valid():
    jwl, twl = _wls()
    jmodel, tmodel = _models()
    plan = plan_hierarchical(twl, 4, tmodel, hosts=2, lpt=True)
    plan.validate(twl.tables)
    assert_plans_equal(plan, jplan_hierarchical(jwl, 4, jmodel, hosts=2, lpt=True))
    mesh = plan.meta["mesh"]
    assert mesh["hosts"] == 2 and mesh["cores_per_host"] == 2
    assert plan.symmetric_tables == ()  # structurally disabled
    rocks = set(mesh["rocks"])
    hosts_of = {}
    for a in plan.assignments:
        hosts_of.setdefault(a.table_idx, set()).add(host_of_core(a.core, 2))
    for ti, hs in hosts_of.items():
        if ti not in rocks:
            assert len(hs) == 1, f"non-rock table {ti} spans hosts {hs}"
    for h, ids in enumerate(mesh["host_tables"]):
        for ti in ids:
            assert hosts_of[ti] == {h}


def test_hierarchical_rejoin_has_no_cross_host_sends():
    jbag, tbag, jp, tp, _ = _bags(2, 2)
    rejoin = tbag.plan.meta["rejoin"]
    assert rejoin["hosts"] == 2
    assert rejoin["cross_host_sends"] == 0
    assert_packs_equal(jp, tp, jbag.plan, tbag.plan)


def test_hosts_must_divide_cores():
    _, twl = _wls()
    _, tmodel = _models()
    with pytest.raises(MeshShapeError):
        plan_hierarchical(twl, 4, tmodel, hosts=3)
    with pytest.raises(MeshShapeError):
        plan_hierarchical(twl, 4, tmodel, hosts=0)


@pytest.mark.parametrize("hosts,cph", [(1, 4), (4, 1), (2, 2), (3, 2)])
def test_emulated_rejoin_matches_oracle(hosts, cph):
    """Every mesh shape: the port's pack equals the reference's (maps
    included), and its lookup, through the owner-sharded rejoin, equals the
    dense oracle; the three rejoins agree."""
    jbag, tbag, jp, tp, tables = _bags(hosts, cph)
    assert_packs_equal(jp, tp, jbag.plan, tbag.plan)
    idx = _indices(tbag.workload)
    want = _oracle(tables, idx)
    sidx = stack_indices(idx, tbag.s_max)
    for reduce_mode in ("sparse", "psum", "ring"):
        got = tbag.apply(tp, sidx, reduce_mode=reduce_mode).numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=reduce_mode)


def test_hierarchical_with_dedup_and_freqs():
    jbag, tbag, jp, tp, tables = _bags(2, 2, freqs_dist=(JZipf(1.2), Zipf(1.2)), dedup=True)
    assert tbag.plan.meta["cache"]["unique_cap"] > 0
    assert_plans_equal(tbag.plan, jbag.plan)
    assert_packs_equal(jp, tp, jbag.plan, tbag.plan)
    idx = _indices(tbag.workload)
    np.testing.assert_allclose(_lookup(tbag, tp, idx), _oracle(tables, idx), **TOL)


def test_multi_host_tables_sum_every_hosts_partial():
    """A table row-sharded over both hosts has one owner on each, at one
    shared bucket position; the rejoin adds both hosts' partials (each
    host's alone is short of the oracle by the other host's rows)."""
    jbag, tbag, jp, tp, tables = _bags(2, 2, rows=[20000, 30, 40, 50], seqs=[1, 1, 1, 1],
                                       batch=16)
    rocks = tbag.plan.meta["mesh"]["rocks"]
    assert rocks and rocks == jbag.plan.meta["mesh"]["rocks"]
    bucket = tp.rejoin_bucket.numpy()
    for ti in rocks:
        owners = sorted(int(c) for c in np.nonzero((bucket == ti).any(axis=1))[0])
        assert {host_of_core(c, 2) for c in owners} == {0, 1}
        assert len({int(np.nonzero(bucket[c] == ti)[0][0]) for c in owners}) == 1
    assert_packs_equal(jp, tp, jbag.plan, tbag.plan)
    idx = _indices(tbag.workload)
    sidx = stack_indices(idx, tbag.s_max)
    local = tpart._local_asym_lookup(tp, sidx, n_tables=4, use_kernels="fused")
    got = tpart._sparse_rejoin(local, tp).numpy()
    want = _oracle(tables, idx)
    np.testing.assert_allclose(got, want, **TOL)
    for h in (0, 1):
        one_host = local[2 * h: 2 * h + 2].sum(dim=0).numpy()
        assert not np.allclose(one_host[rocks], want[rocks], **TOL)


# --------------------------------------------------------------------------
# partition property: every (table, row) owned by exactly one (host, core)
# --------------------------------------------------------------------------


def _assert_partition(plan, wl, hosts, cph):
    plan.validate(wl.tables)  # exact coverage, no overlap
    sym = set(plan.symmetric_tables)
    owners = {}
    for a in plan.assignments:
        assert 0 <= a.core < hosts * cph
        key = (a.table_idx, a.row_offset, a.rows)
        assert key not in owners, f"row span {key} owned twice"
        owners[key] = (host_of_core(a.core, cph), a.core)
    covered = {ti for ti, _, _ in owners}
    assert covered | sym == set(range(len(wl.tables)))


@pytest.mark.parametrize("hosts,cph", [(1, 1), (1, 4), (4, 1), (2, 3), (3, 2)])
def test_partition_property_fixed_shapes(hosts, cph):
    jwl, twl = _wls()
    jmodel, tmodel = _models()
    plan = plan_hierarchical(twl, hosts * cph, tmodel, hosts=hosts)
    _assert_partition(plan, twl, hosts, cph)
    assert_plans_equal(plan, jplan_hierarchical(jwl, hosts * cph, jmodel, hosts=hosts))


@pytest.mark.parametrize("seed", range(6))
def test_partition_property_random_shapes(seed):
    """Seeded random workloads and mesh shapes, (1, n) and (n, 1) among
    them: the plan is a true partition equal to the reference's, the pack
    equals the reference's, and the rejoin reconstructs the dense oracle."""
    rng = np.random.default_rng(seed)
    hosts, cph = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    n_tables = int(rng.integers(2, 8))
    rows = [int(rng.integers(8, 600)) for _ in range(n_tables)]
    seqs = [int(rng.integers(1, 3)) for _ in range(n_tables)]
    jbag, tbag, jp, tp, tables = _bags(hosts, cph, batch=16, rows=rows, seqs=seqs)
    _assert_partition(tbag.plan, tbag.workload, hosts, cph)
    assert_plans_equal(tbag.plan, jbag.plan)
    assert_packs_equal(jp, tp, jbag.plan, tbag.plan)
    idx = _indices(tbag.workload, seed=seed)
    np.testing.assert_allclose(_lookup(tbag, tp, idx), _oracle(tables, idx), **TOL)


# --------------------------------------------------------------------------
# cross-host traffic model
# --------------------------------------------------------------------------


def test_flat_plan_models_zero_cross_host():
    jwl, twl = _wls()
    jmodel, tmodel = _models()
    x = modeled_cross_host_traffic(plan_asymmetric(twl, 4, tmodel), twl.tables, twl.batch)
    assert x["hosts"] == 1
    assert x["cross_host_bytes"] == 0.0
    assert x["reduction_vs_flat"] == 1.0
    from repro.core.planner import plan_asymmetric as jplan_asymmetric

    assert x == jcross(jplan_asymmetric(jwl, 4, jmodel), jwl.tables, jwl.batch)


def test_cross_host_bytes_beat_flat_and_flatten_in_batch():
    jwl, twl = _wls(batch=64)
    jmodel, tmodel = _models()
    jf, tf = jprobs(jwl, JZipf(1.2)), workload_probs(twl, Zipf(1.2))
    plan = plan_hierarchical(twl, 8, tmodel, hosts=4, freqs=tf, dedup=True)
    jplan = jplan_hierarchical(jwl, 8, jmodel, hosts=4, freqs=jf, dedup=True)
    assert_plans_equal(plan, jplan)
    x = modeled_cross_host_traffic(plan, twl.tables, twl.batch, tf)
    assert x == jcross(jplan, jwl.tables, jwl.batch, jf)
    assert 0 < x["cross_host_bytes"] < x["flat_allgather_bytes"]
    big = modeled_cross_host_traffic(plan, twl.tables, twl.batch * 64, tf)
    assert big == jcross(jplan, jwl.tables, jwl.batch * 64, jf)
    assert big["cross_host_bytes"] <= x["cross_host_bytes"] * 64
    even_bigger = modeled_cross_host_traffic(plan, twl.tables, twl.batch * 128, tf)
    assert even_bigger["cross_host_bytes"] / big["cross_host_bytes"] < 1.02
    assert even_bigger["flat_allgather_bytes"] == 2 * big["flat_allgather_bytes"]


@pytest.mark.parametrize("preset", ["TPU_V5E", "A100", "ASCEND_910"])
def test_cross_host_time_model(preset):
    jmodel = jcm.analytic_model(getattr(jcm, preset))
    tmodel = tcm.analytic_model(getattr(tcm, preset))
    assert tmodel.cross_host_time(1 << 20, hosts=1) == 0.0
    assert tmodel.cross_host_time(0, hosts=4) == 0.0
    t2 = tmodel.cross_host_time(1 << 20, hosts=2)
    t4 = tmodel.cross_host_time(1 << 20, hosts=4)
    assert t4 > t2 > 0
    for nbytes, hosts in ((1 << 20, 2), (1 << 20, 4), (12345, 3), (0, 2)):
        assert tmodel.cross_host_time(nbytes, hosts=hosts) == \
            jmodel.cross_host_time(nbytes, hosts=hosts)


# --------------------------------------------------------------------------
# engine wiring: config, simulate, stats and report
# --------------------------------------------------------------------------


def test_engine_config_validates_mesh_shape():
    with pytest.raises(MeshShapeError):
        EngineConfig(mesh_shape=(2, 3), n_cores=5).validate()
    EngineConfig(mesh_shape=(1, 1)).validate()
    EngineConfig(planner="hierarchical", access="dedup", mesh_shape=(2, 2),
                 simulate=True).validate()


@pytest.mark.parametrize("simulate", [True, False])
def test_engine_builds_reports_and_executes_any_mesh(simulate):
    """Where the reference builds a ``simulate=True`` engine but refuses to
    execute it on fewer devices than plan cores, the port executes: a plan
    core is a partition of one device.  Stats and report equal the
    reference's figures."""
    jwl, twl = _wls()
    rng = np.random.default_rng(0)
    tables = [(rng.standard_normal((r, E)) / 4).astype(np.float32) for r in ROWS]
    cfg = dict(planner="hierarchical", mesh_shape=(2, 2), access="dedup",
               distribution="zipf:1.2")
    jeng = JEngine.build([jnp.asarray(t) for t in tables], jwl,
                         JEngineConfig(simulate=True, **cfg))
    eng = InferenceEngine.build(tables, twl, EngineConfig(simulate=simulate, **cfg),
                                device="cpu")
    assert eng.packed.n_cores == 4
    stats, jstats = eng.stats(), jeng.stats()
    assert stats["mesh_shape"] == jstats["mesh_shape"] == [2, 2]
    assert stats["cross_host"] == jstats["cross_host"]
    assert stats["cross_host"]["flat_allgather_bytes"] > 0
    assert stats["mesh"] == jstats["mesh"]
    report = eng.plan_report()
    assert "host 0" in report and "host 1" in report
    assert "cross-host" in report and "mesh 2x2" in report
    tree = ("  host", "    core", "      chunk", "mesh ")  # the tree and the mesh line
    jlines = [ln for ln in jeng.plan_report().splitlines() if ln.startswith(tree)]
    assert [ln for ln in report.splitlines() if ln.startswith(tree)] == jlines
    idx = _indices(twl)
    np.testing.assert_allclose(eng.lookup(idx).numpy(), _oracle(tables, idx), **TOL)
    srv = eng.serve(max_batch=8)
    for q in range(16):
        srv.submit_request(stack_indices(idx, eng.bag.s_max)[:, q % twl.batch].numpy())
    srv.drain()
    s = srv.stats()
    assert s["served"] == s["submitted"] == 16 and s["batch_failures"] == 0


def test_engine_single_host_mesh_executes():
    _, twl = _wls()
    eng = InferenceEngine.build(None, twl, EngineConfig(planner="hierarchical",
                                                        mesh_shape=(1, 1)), device="cpu")
    idx = _indices(twl)
    tables = [t.numpy() for t in eng.table_data]
    np.testing.assert_allclose(eng.lookup(idx).numpy(), _oracle(tables, idx), **TOL)


# --------------------------------------------------------------------------
# taobao at full width: the 2x4 plan priced under a100
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def taobao_plans():
    """Planned once per module: taobao, batch 8192, zipf 1.2, dedup, the
    a100 preset, a 2x4 mesh, in both packages."""
    jwl, twl = jget("taobao", 8192), get_workload("taobao", 8192)
    jf, tf = jprobs(jwl, jdist("zipf:1.2")), workload_probs(twl, get_distribution("zipf:1.2"))
    kw = dict(hosts=2, dedup=True, shard_rocks=True, kernel_path="auto")
    jplan = jplan_hierarchical(jwl, 8, jcm.analytic_model(jcm.A100), freqs=jf, **kw)
    tplan = plan_hierarchical(twl, 8, tcm.analytic_model(tcm.A100), freqs=tf, **kw)
    return jplan, tplan, twl


def test_taobao_a100_2x4_plan_and_maps_match_reference(taobao_plans):
    jplan, tplan, twl = taobao_plans
    assert_plans_equal(tplan, jplan)
    mesh = tplan.meta["mesh"]
    assert mesh["hosts"] == 2 and mesh["rocks"] == [0, 1, 3, 4, 5]
    assert len(tplan.assignments) == 53 and not tplan.symmetric_tables
    assert tplan.meta["cache"]["unique_cap"] == jplan.meta["cache"]["unique_cap"] == 1040
    tmaps = tpart._rejoin_maps(tplan, 15, 8, mesh_shape=(2, 4))
    jmaps = jpart._rejoin_maps(jplan, 15, 8, mesh_shape=(2, 4))
    for got, want in zip(tmaps, jmaps):
        np.testing.assert_array_equal(got, want)
    owner, bucket, owned_pos, send = tmaps
    for ti in mesh["rocks"]:  # one owner on each host, one shared position
        owners = np.nonzero((bucket == ti).any(axis=1))[0]
        assert {host_of_core(int(c), 4) for c in owners} == {0, 1}
        assert all(bucket[c, owned_pos[ti]] == ti for c in owners)
    cross = sum(int((send[c, d] >= 0).sum()) for c in range(8) for d in range(8)
                if c // 4 != d // 4)
    assert cross == 0
    assert modeled_cross_host_traffic(tplan, twl.tables, 8192, None) == \
        jcross(jplan, jget("taobao", 8192).tables, 8192, None)
