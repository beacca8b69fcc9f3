"""Planner exploration: placements + predicted P99 for every paper workload.

Run:  PYTHONPATH=src python -m repro_torch.examples.autoplan [--device cpu]

Fits the linear cost model on simulator measurements (the OLS step of paper
eq. 2), then prints each planner's placement structure, LIF, and predicted
P99 — including the beyond-paper LPT and hot-replication variants.  All of
it is host work; ``--device`` is checked as every example checks it.
"""
import argparse

from repro_torch.core.cost_model import ASCEND_910, CostModel
from repro_torch.core.planner import (
    plan_asymmetric,
    plan_baseline,
    plan_symmetric,
    predicted_p99,
)
from repro_torch.data.workloads import WORKLOADS
from repro_torch.device import resolve_device
from repro_torch.sim.ascend import SimParams, collect_measurements


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    p = SimParams()
    meas = collect_measurements(list(WORKLOADS.values()), p)
    model = CostModel.fit(meas, ASCEND_910)
    print(f"cost model fitted on {len(meas)} simulated measurements, "
          f"R^2={model.r2(meas):.4f}")
    k = 32
    for name, wl in WORKLOADS.items():
        wl = wl.scaled(8192)
        print(f"\n== {wl.summary()}")
        plans = {
            "baseline": plan_baseline(wl, k, model),
            "symmetric": plan_symmetric(wl, k, model),
            "asymmetric": plan_asymmetric(wl, k, model),
            "asym+lpt": plan_asymmetric(wl, k, model, lpt=True),
            "asym+rep": plan_asymmetric(wl, k, model, replicate_hot=True),
        }
        for pname, plan in plans.items():
            p99 = predicted_p99(model, wl.tables, wl.batch, plan) * 1e6
            print(
                f"  {pname:>10s}: {len(plan.assignments):3d} chunks, "
                f"{len(plan.symmetric_tables):2d} symmetric, "
                f"LIF={plan.meta.get('lif', 1.0):.3f}, "
                f"predicted P99 {p99:9.1f} us"
            )


if __name__ == "__main__":
    main()
