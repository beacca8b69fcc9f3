"""Why a preset's logits move between two f32 evaluations while its pooled
embeddings do not: reduction order at the preset's magnitudes.

For each shipped preset, at its own widths and batch, on the CPU:

* the DLRM forward over the packed engine (``forward_packed``) against the
  dense oracle (``forward_dense``), which pools in another order;
* the same packed forward in f32 against its MLPs evaluated in f64 on the
  same pooled input, the f32 rounding of the MLPs alone.

huawei-25mb pools up to 166 lookups a query, so its pooled values and its
logits are about 30x and 80x taobao's and tenrec's, and the same relative
f32 error (under 1e-6 in all three) is an absolute one of about 1e-5.  Two
devices that sum the MLPs' products in different orders differ by that
much; the printed record (``-s``) gives each preset's figures.
"""
import copy
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.presets import load_preset
from repro_torch.data.distributions import DriftSchedule, get_distribution, sample_workload
from repro_torch.data.workloads import get_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.models.dlrm import (
    DLRMConfig,
    forward_dense,
    forward_packed,
    init_dlrm,
    interact,
)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# the MLPs' f32 rounding relative to the largest logit: their dot products
# run over at most 512 terms, so a few hundred ulps (f32 eps 1.19e-7) at most
F32_REL = 1e-5


@pytest.mark.parametrize("preset", ["huawei-dayparted", "taobao-zipf12", "tenrec-hotset"])
def test_logit_gap_is_f32_reduction_order(preset):
    spec = load_preset(preset)
    config = EngineConfig.from_dict({**spec["config"], "tuning": "none"})
    wl = get_workload(spec["workload"], config.max_batch)
    cfg = DLRMConfig(arch=f"dlrm-{spec['workload']}", workload=wl)
    params = init_dlrm(cfg, torch.Generator().manual_seed(0), "cpu")  # the serve CLI's
    engine = InferenceEngine.build(params["tables"], wl, config, device="cpu")
    dist = get_distribution(spec["distribution"])
    if isinstance(dist, DriftSchedule):
        dist = dist.at(0)
    rng = np.random.default_rng(0)
    idx = sample_workload(rng, wl, dist, wl.batch)
    dense = torch.from_numpy(rng.standard_normal((wl.batch, cfg.n_dense)).astype(np.float32))
    batch = {"dense": dense, "indices": idx}
    packed = forward_packed(cfg, engine.bag, engine.packed, params, batch)
    oracle = forward_dense(cfg, params, batch)
    pooled = engine.lookup(idx)
    with torch.no_grad():
        bottom = copy.deepcopy(params["bottom"]).double()
        top = copy.deepcopy(params["top"]).double()
        f64 = top(interact(bottom(dense.double()), pooled.double()))[..., 0]
    largest = float(packed.abs().max())
    gap = float((packed - oracle).abs().max())
    f32_err = float((packed.double() - f64).abs().max())
    print(json.dumps({"preset": preset, "max_abs_logit": largest,
                      "max_abs_pooled": float(pooled.abs().max()),
                      "packed_vs_dense": gap, "packed_vs_dense_rel": gap / largest,
                      "f32_vs_f64": f32_err, "f32_vs_f64_rel": f32_err / largest}))
    torch.testing.assert_close(packed, oracle, **LOGIT_TOL)
    assert f32_err <= F32_REL * largest
    assert gap <= F32_REL * largest
