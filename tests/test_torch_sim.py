"""The port's Ascend-910 simulator and conflict-free estimate
(``repro_torch.sim``) against the JAX package's (``repro.sim``): the
measurements the OLS cost model is fitted on, the fit, every planner's
simulated latency on every workload and distribution, and the Fig. 3
estimate, all equal (the same numpy code on the same inputs: no
tolerance); then the five claims of ``tests/test_system.py`` on the port.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import planner as jplanner
from repro.core.cost_model import ASCEND_910 as J_ASCEND_910
from repro.core.cost_model import CostModel as JCostModel
from repro.data.workloads import WORKLOADS as JWORKLOADS
from repro.sim import ascend as jascend
from repro.sim import estimate as jestimate
from repro_torch.core.cost_model import ASCEND_910, CostModel
from repro_torch.core.planner import plan_asymmetric, plan_baseline, plan_symmetric
from repro_torch.data.workloads import WORKLOADS
from repro_torch.sim import ascend, estimate
from repro_torch.sim.ascend import SimParams, collect_measurements, simulate_plan

PLANNERS = {"baseline": plan_baseline, "symmetric": plan_symmetric,
            "asymmetric": plan_asymmetric}
DISTS = ("uniform", "real", "fixed")


@pytest.fixture(scope="module")
def fitted():
    p = SimParams()
    model = CostModel.fit(collect_measurements(list(WORKLOADS.values()), p), ASCEND_910)
    return p, model


@pytest.fixture(scope="module")
def both_fits():
    meas = collect_measurements(list(WORKLOADS.values()), SimParams())
    jmeas = jascend.collect_measurements(list(JWORKLOADS.values()), jascend.SimParams())
    return (meas, CostModel.fit(meas, ASCEND_910),
            jmeas, JCostModel.fit(jmeas, J_ASCEND_910))


def test_sim_params_and_hit_ratios_equal():
    assert dataclasses.astuple(SimParams())[1:] == dataclasses.astuple(jascend.SimParams())[1:]
    assert SimParams().hbm_bw_core == jascend.SimParams().hbm_bw_core
    for rows, cache, alpha in ((1000, 10, 1.05), (10**6, 4096, 1.0), (50, 80, 1.2)):
        got = ascend.zipf_hit_ratio(rows, cache, alpha)
        assert got == jascend.zipf_hit_ratio(rows, cache, alpha)
    for name in WORKLOADS:
        for t, jt in zip(WORKLOADS[name].tables, JWORKLOADS[name].tables):
            for dist in DISTS:
                assert (ascend.hit_ratio(t, dist, 16 << 20)
                        == jascend.hit_ratio(jt, dist, 16 << 20)), (name, t.name, dist)


def test_measurements_and_fit_equal(both_fits):
    meas, model, jmeas, jmodel = both_fits
    assert len(meas) == len(jmeas) > 0
    for (t, b, c, s, sec), (jt, jb, jc, js, jsec) in zip(meas, jmeas):
        assert (t.name, t.rows, t.dim, t.seq, b, c, s.value, sec) == \
            (jt.name, jt.rows, jt.dim, jt.seq, jb, jc, js.value, jsec)
    assert {s.value: b for s, b in model.betas.items()} == \
        {s.value: b for s, b in jmodel.betas.items()}
    assert model.r2(meas) == jmodel.r2(jmeas)


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_simulate_plan_equal(name, both_fits):
    """Every planner's plan, and the vendor baseline, simulated under every
    distribution: the same record as the JAX package's."""
    _, model, _, jmodel = both_fits
    wl, jwl = WORKLOADS[name].scaled(8192), JWORKLOADS[name].scaled(8192)
    p, jp = SimParams(), jascend.SimParams()
    for planner, fn in PLANNERS.items():
        plan = fn(wl, 32, model)
        jplan = getattr(jplanner, f"plan_{planner}")(jwl, 32, jmodel)
        for dist in DISTS:
            for baseline in ((False, True) if planner == "baseline" else (False,)):
                got = simulate_plan(plan, wl, dist, p, baseline=baseline)
                want = jascend.simulate_plan(jplan, jwl, dist, jp, baseline=baseline)
                assert got == want, (name, planner, dist, baseline)


def test_fig3_estimate_equal():
    for name in WORKLOADS:
        wl, jwl = WORKLOADS[name].scaled(4096), JWORKLOADS[name].scaled(4096)
        assert estimate.fig3_estimate(wl) == jestimate.fig3_estimate(jwl), name
        for use_l1 in (None, False):
            assert (estimate.theoretical_batch_time(wl, ASCEND_910, use_l1=use_l1)
                    == jestimate.theoretical_batch_time(jwl, J_ASCEND_910, use_l1=use_l1))


# ------------------------------------------- tests/test_system.py, on the port


def test_asymmetric_beats_baseline_everywhere(fitted):
    """Paper Table I: our strategies beat the vendor baseline on every
    workload and distribution (paper: 1.5-6.5x real, >20x fixed)."""
    p, model = fitted
    for name, wl in WORKLOADS.items():
        wl = wl.scaled(8192)
        plan = plan_asymmetric(wl, 32, model)
        for dist in DISTS:
            base = simulate_plan(plan_baseline(wl, 32, model), wl, dist, p, baseline=True)
            ours = simulate_plan(plan, wl, dist, p)
            speedup = base["p99_us"] / ours["p99_us"]
            assert speedup > 1.5, (name, dist, speedup)
            if dist == "fixed":
                assert speedup > 20, (name, dist, speedup)


def test_distribution_robustness(fitted):
    """Paper §IV-C: the asymmetric strategy's P99 varies far less across
    query distributions than the baseline's."""
    p, model = fitted
    for name, wl in WORKLOADS.items():
        wl = wl.scaled(8192)
        plan = plan_asymmetric(wl, 32, model)
        ours = [simulate_plan(plan, wl, d, p)["p99_us"] for d in DISTS]
        base = [simulate_plan(plan_baseline(wl, 32, model), wl, d, p, baseline=True)["p99_us"]
                for d in DISTS]
        assert max(ours) / min(ours) < 1.5, (name, ours)
        assert max(base) / min(base) > 5.0, (name, base)


def test_asymmetric_l1_capacity_advantage(fitted):
    """Paper §III-B: aggregated L1 across K cores lets the asymmetric plan
    keep K x more table bytes on-chip than the symmetric plan."""
    p, model = fitted
    wl = WORKLOADS["huawei-25mb"].scaled(8192)
    sym = plan_symmetric(wl, 32, model)
    asym = plan_asymmetric(wl, 32, model)
    sym_l1 = sum(wl.tables[i].bytes
                 for i, s in zip(sym.symmetric_tables, sym.symmetric_strategies) if s.is_l1)
    asym_l1 = sum(a.rows * wl.tables[a.table_idx].row_bytes
                  for a in asym.assignments if a.strategy.is_l1)
    assert asym_l1 > 3 * sym_l1


def test_cost_model_ols_quality(fitted):
    p, model = fitted
    meas = collect_measurements(list(WORKLOADS.values()), p)
    assert model.r2(meas) > 0.95  # the linear model (eq. 2) fits the measurements


def test_pareto_dominance(fitted):
    """Fig 4: across batch sizes, asymmetric sits on the Pareto front at
    >=80% of operating points."""
    p, model = fitted
    wins = total = 0
    for b in (1024, 4096, 8192, 16384):
        for name in ("criteo-1tb", "avazu-ctr", "taobao"):
            wl = WORKLOADS[name].scaled(b)
            res = {strat: simulate_plan(fn(wl, 32, model), wl, "real", p,
                                        baseline=(strat == "baseline"))
                   for strat, fn in PLANNERS.items()}
            best = min(r["p99_us"] for r in res.values())
            total += 1
            wins += res["asymmetric"]["p99_us"] <= 1.05 * best
    assert wins / total >= 0.8, (wins, total)


def test_sim_draws_from_numpy_alone():
    """The jitter is drawn from numpy's seeded generator: two runs agree,
    another seed differs."""
    wl = WORKLOADS["taobao"].scaled(1024)
    plan = plan_asymmetric(wl, 8, CostModel.fit(collect_measurements([wl]), ASCEND_910))
    a, b = simulate_plan(plan, wl, "real"), simulate_plan(plan, wl, "real")
    c = simulate_plan(plan, wl, "real", seed=1)
    assert a == b and a["p99_us"] != c["p99_us"]
    assert np.isfinite([a["mean_us"], a["p99_us"], a["tps"]]).all()
