"""Quickstart: the InferenceEngine facade, four plan cores in one launch.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Declares the whole pipeline with an ``EngineConfig`` (placement policy,
pricing distribution, hardware), builds it with ``InferenceEngine.build``
(plan -> access-reduction arming -> pack in one call), executes the
partitioned lookup (``mesh_shape=(1, 4)``: four plan cores, each a
partition of one launch on the card), checks exactness against the dense
oracle, and prints each plan's predicted P99.  The manual chain (``plan_* ->
pack_plan -> PartitionedEmbeddingBag``) still exists underneath —
``engine.bag`` / ``engine.packed`` expose it for composition.
"""
import argparse

import numpy as np
import torch

from repro_torch.data.synthetic import query_batch
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    wl = small_workload(batch=64)
    rng = np.random.default_rng(0)
    idx = query_batch(rng, wl, "real")

    print(wl.summary())
    for planner in ("baseline", "symmetric", "asymmetric"):
        config = EngineConfig(
            planner=planner,
            mesh_shape=(1, 4),
            # tiny L1 to exercise chunking (the quickstart's classic knob)
            hardware_options={"l1_bytes": 4096},
        )
        engine = InferenceEngine.build(None, wl, config, device=args.device,
                                       rng=torch.Generator().manual_seed(0))
        out = engine.lookup(idx)
        ref = engine.bag.reference(engine.table_data, idx)
        err = float((out.cpu() - ref.cpu()).abs().max())
        p99 = engine.stats()["predicted_p99_us"]
        print(
            f"{planner:>10s}: {len(engine.plan.assignments):2d} chunks asym, "
            f"{len(engine.plan.symmetric_tables):2d} sym | predicted P99 "
            f"{p99:8.1f}us | max err vs dense oracle {err:.2e}"
        )
    print("OK — asymmetric placement executes exactly and is predicted fastest.")


if __name__ == "__main__":
    main()
