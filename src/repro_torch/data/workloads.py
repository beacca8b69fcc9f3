"""The six paper workloads (§IV-A): table sets extracted from public CTR /
recommendation datasets, plus the synthetic stand-in for Huawei-25MB.

Cardinalities come from the public dataset statistics (Criteo Terabyte,
Avazu CTR, Taobao display-ads, TenRec-QB, KuaiRec); where the paper's exact
preprocessing is unknown the counts are approximations of the same public
stats — what matters downstream is the size distribution (paper Fig. 2).
Following the paper, the "huge" user_id/item_id-class tables that do not fit
the accelerator's global memory are excluded (Criteo's two largest fields).

All tables: E=16, fp16, sum pooling; sequence length 1 except Huawei-25MB
(1..172).  Default batch 8192 (paper Table I).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.tables import Workload, make_workload

# Criteo Terabyte, 26 categorical fields; two largest (user/item-class,
# 292M & 227M rows) excluded per the paper.
_CRITEO_1TB = [
    39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 130229467, 3067956,
    405282, 10, 2209, 11938, 155, 4, 976, 14, 40790948, 187188510,
    590152, 12973, 108, 36,
]

# Avazu click-through: 22 fields (site/app/device + anonymized C-fields).
_AVAZU = [
    241, 8, 8, 3697, 4614, 25, 5481, 329, 32, 381763, 1611748, 6793,
    6, 5, 2509, 9, 10, 432, 5, 68, 169, 61,
]

# Taobao display-ad CTR (ad features + user profile features).
_TAOBAO = [
    1141730, 846812, 12978, 423437, 255876, 461498, 2,  # ad-side
    98, 13, 3, 7, 4, 3, 2, 5,  # user profile
]

# TenRec QB-article CTR subset (approx. public stats).
_TENREC_QB = [
    1000000, 220000, 539, 4, 2, 2, 31, 14, 9, 3,
]

# KuaiRec ("big" matrix): users, items, and categorical side features.
_KUAIREC_BIG = [
    7176, 10728, 31, 9, 467, 340, 5, 3, 8, 2, 118, 4,
]


def _huawei_25mb(seed: int = 7) -> Workload:
    """Synthetic production-like workload: 25 MiB of tables, seq in [1, 172].

    The paper gives no access distributions for this model; we synthesize a
    size mix (log-uniform rows) and a long-tail of multi-hot sequence lengths
    capped at 172, scaled so the total is ~25 MiB at E=16 fp16.
    """
    rng = np.random.default_rng(seed)
    n = 30
    rows = np.exp(rng.uniform(np.log(64), np.log(200_000), n)).astype(int)
    rows = np.maximum(rows, 4)
    scale = (25 * 2**20) / float(rows.sum() * 16 * 2)
    rows = np.maximum((rows * scale).astype(int), 4)
    seqs = np.ones(n, int)
    heavy = rng.choice(n, size=8, replace=False)
    seqs[heavy] = rng.integers(2, 173, size=8)
    return make_workload("Huawei-25MB", rows.tolist(), dim=16, seqs=seqs.tolist())


WORKLOADS: dict[str, Workload] = {
    "criteo-1tb": make_workload("Criteo-1TB", _CRITEO_1TB, dim=16),
    "avazu-ctr": make_workload("Avazu-CTR", _AVAZU, dim=16),
    "taobao": make_workload("Taobao", _TAOBAO, dim=16),
    "tenrec-qb": make_workload("TenRec-QB-art.", _TENREC_QB, dim=16),
    "kuairec-big": make_workload("KuaiRec-big", _KUAIREC_BIG, dim=16),
    "huawei-25mb": _huawei_25mb(),
}


def get_workload(name: str, batch: int | None = None) -> Workload:
    wl = WORKLOADS[name]
    return wl if batch is None else wl.scaled(batch)


def small_workload(name: str = "smoke", n_tables: int = 6, batch: int = 32) -> Workload:
    """Tiny deterministic workload for CPU tests/examples."""
    rows = [64, 200, 1000, 48, 4096, 333][:n_tables]
    seqs = [1, 2, 1, 4, 1, 3][:n_tables]
    return make_workload(name, rows, dim=16, seqs=seqs, batch=batch)
