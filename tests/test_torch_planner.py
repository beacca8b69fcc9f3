"""Planning parity at full width: the port's planners produce the JAX
package's plans bit for bit (assignments, symmetric group, every ``meta``
record) on the paper's taobao and criteo-1tb workloads at batch 8192, under
each cost-model preset.  Plan-only: nothing is packed."""
import numpy as np
import pytest

from repro.core import cost_model as jcm
from repro.core.planner import PLANNERS as JPLANNERS, predicted_p99 as jp99
from repro.data.distributions import get_distribution as jdist, workload_probs as jprobs
from repro.data.workloads import get_workload as jget
from repro_torch.core import cost_model as tcm
from repro_torch.core.mesh import MeshShapeError, resolve_mesh_shape
from repro_torch.core.planner import PLANNERS as TPLANNERS, predicted_p99 as tp99
from repro_torch.data.distributions import get_distribution as tdist, workload_probs as tprobs
from repro_torch.data.workloads import get_workload as tget

PRESETS = ["TPU_V5E", "A100", "ASCEND_910"]
VARIANTS = [
    ("asymmetric", {}),
    ("asymmetric", {"shard_rocks": True}),
    ("symmetric", {}),
    ("baseline", {}),
]


def _plan_key(plan):
    return (
        [(a.table_idx, a.core, a.row_offset, a.rows, a.strategy.name, a.batch_frac)
         for a in plan.assignments],
        list(plan.symmetric_tables),
        [s.name for s in plan.symmetric_strategies],
        plan.n_cores,
    )


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("dist", [None, "uniform"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("workload", ["taobao", "criteo-1tb"])
def test_full_width_plans_match_reference(workload, k, dist, preset):
    jwl, twl = jget(workload, 8192), tget(workload, 8192)
    jf = jprobs(jwl, jdist(dist)) if dist else None
    tf = tprobs(twl, tdist(dist)) if dist else None
    jmodel = jcm.analytic_model(getattr(jcm, preset))
    tmodel = tcm.analytic_model(getattr(tcm, preset))
    for name, opts in VARIANTS:
        jplan = JPLANNERS[name](jwl, k, jmodel, freqs=jf, **opts)
        tplan = TPLANNERS[name](twl, k, tmodel, freqs=tf, **opts)
        assert _plan_key(tplan) == _plan_key(jplan), (name, opts)
        assert tplan.meta == jplan.meta, (name, opts)
        assert tp99(tmodel, twl.tables, 8192, tplan, tf) == jp99(
            jmodel, jwl.tables, 8192, jplan, jf)


def test_taobao_k8_uniform_engages_the_fallback():
    """The slice's main-path plan: the LIF fallback puts six taobao tables
    in the symmetric GM-UB group, next to nine asymmetric L1 chunks."""
    wl = tget("taobao", 8192)
    plan = TPLANNERS["asymmetric"](
        wl, 8, tcm.analytic_model(tcm.TPU_V5E), freqs=tprobs(wl, tdist("uniform"))
    )
    assert plan.symmetric_tables == (11, 12, 13, 14, 1, 7)
    assert {s.name for s in plan.symmetric_strategies} == {"GM_UB"}
    assert len(plan.assignments) == 9
    assert {a.strategy.name for a in plan.assignments} == {"L1"}


def test_mesh_shape_resolution_and_hierarchical_plan():
    assert resolve_mesh_shape((1, 8), None) == (1, 8)
    assert resolve_mesh_shape(None, None, default_cores=1) == (1, 1)
    with pytest.deprecated_call():
        assert resolve_mesh_shape(None, 4) == (1, 4)
    with pytest.raises(MeshShapeError):
        resolve_mesh_shape((2, 4), 6)
    for hosts in (1, 2, 4):
        tplan = TPLANNERS["hierarchical"](tget("taobao", 64), 8, tcm.analytic_model(),
                                          hosts=hosts)
        jplan = JPLANNERS["hierarchical"](jget("taobao", 64), 8, jcm.analytic_model(),
                                          hosts=hosts)
        assert _plan_key(tplan) == _plan_key(jplan), hosts
        assert tplan.meta == jplan.meta, hosts
    np.testing.assert_equal(sorted(TPLANNERS), sorted(JPLANNERS))
