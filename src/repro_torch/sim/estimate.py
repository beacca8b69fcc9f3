"""High-level conflict-free performance estimation (paper §IV-B, Fig. 3).

Per the paper: assume conflict-free memory accesses, symmetric partitioning,
and no L1 persistent preloading on platforms whose stack doesn't support it
(A100).  For each table the estimate takes the best supported path's
bandwidth-limited time; tables are processed in parallel across cores with
the batch split K ways.
"""
from __future__ import annotations

from repro_torch.core.cost_model import A100, ASCEND_910, TPU_V5E, HardwareSpec
from repro_torch.core.tables import Workload


def theoretical_batch_time(
    workload: Workload,
    hw: HardwareSpec,
    *,
    use_l1: bool | None = None,
) -> float:
    """Seconds per batch under the conflict-free high-level model."""
    if use_l1 is None:
        use_l1 = hw.l1_bytes > 0
    batch, k = workload.batch, hw.cores
    total = 0.0
    l1_left = hw.l1_bytes * k  # aggregated scratchpad across cores
    # larger tables benefit least from L1 — greedily give L1 to the smallest
    for t in sorted(workload.tables, key=lambda t: t.bytes):
        n = batch * t.seq / k  # lookups per core (symmetric split)
        if use_l1 and t.bytes * k <= l1_left:
            # resident in every core's scratchpad
            per = t.row_bytes / hw.l1_bw
            l1_left -= t.bytes * k
        else:
            per = t.row_bytes / (hw.hbm_bw / k)
        total += n * per
    return total


def fig3_estimate(workload: Workload) -> dict[str, float]:
    """Queries/s per platform (Fig 3 companion, + our TPU v5e target)."""
    out = {}
    for hw in (ASCEND_910, A100, TPU_V5E):
        t = theoretical_batch_time(workload, hw)
        out[hw.name] = workload.batch / t
    return out
