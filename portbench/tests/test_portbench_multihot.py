"""The harness on a tiny multi-hot cell on the CPU, with the kernels' plain
versions: bags of up to 172 ids, one of them longer than its table has
rows, ``-1`` padding up to the longest, batch dedup and the hot-row cache
armed.  A run agrees with the plain reference within the Huawei-25MB
configuration's limits; the control (bf16 tables) and each fault planted
under the timed path make ``correct`` false.  And the configuration holds
the table set the program lists as ``huawei-25mb``."""
import json

import numpy as np
import pytest

from portbench import harness, spec
from portbench.tests import tiny

SECONDS = 0.3
SEQS = [172, 1, 40, 100, 1, 7]  # over tiny's rows: table 3 has bags of 100 over 48 rows
HUAWEI = tiny.REPO / "portbench" / "configs" / "dlrm-huawei-25mb.json"


def make_root(dst):
    """:func:`tiny.make_root` with the tiny configuration made multi-hot,
    planned and checked as Huawei-25MB is, under Huawei-25MB's key law."""
    root = tiny.make_root(dst)
    pb = root / "portbench"
    huawei = json.loads(HUAWEI.read_text())
    cfg_path = pb / "configs" / "dlrm-tiny.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(seqs=SEQS, limits=huawei["limits"],
               engine={**huawei["engine"], "mesh_shape": [1, 4]})
    cfg_path.write_text(json.dumps(cfg))
    traffic_path = pb / "traffic" / "tiny.json"
    traffic = json.loads(traffic_path.read_text())
    mix = json.loads((tiny.REPO / "portbench" / "traffic" / "zipf105-b8k.json").read_text())
    traffic["distribution"] = mix["distribution"]
    traffic_path.write_text(json.dumps(traffic))
    return root


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return spec.load_cell(make_root(tmp_path_factory.mktemp("multihot")), tiny.CELL)


def test_the_tiny_cell_is_multi_hot_with_dedup_and_cache(cell):
    import torch

    assert max(cell.config["seqs"]) == 172 and cell.traffic["batch"] == 64
    assert any(s > m for s, m in zip(cell.config["seqs"], cell.config["rows"]))
    state = harness.build(cell, 3, torch.device("cpu"))
    assert state.engine.packed.unique_cap > 0 and state.engine.packed.cache_rows > 0
    idx = state.pool[0][0]
    assert idx.shape == (6, 64, 172)
    assert ((idx >= 0).sum(axis=2) == np.array(SEQS)[:, None]).all()


def test_reference_agrees_with_a_multihot_run(cell):
    out = harness.run_cell(cell, 2**31 + 29, SECONDS, False, device="cpu")
    checks = out["checks"]
    assert out["correct"], checks
    assert out["failed"] == 0 and out["attempted"] == out["info"]["compared_batches"] > 0
    for name in ("pooled_max_abs_err", "logit_max_abs_err"):
        assert checks[name]["value"] <= cell.config["limits"][name]


def test_bf16_tables_fail_the_comparison(cell):
    out = harness.run_cell(cell, 5, SECONDS, False, device="cpu",
                           engine_overrides={"dtype": "bfloat16"})
    assert not out["correct"]
    assert out["checks"]["pooled_max_abs_err"]["value"] > cell.config["limits"]["pooled_max_abs_err"]


def _last_id_dropped(orig):
    """Every slot's last bag position read as padding."""
    def _slot_indices(packed, indices):
        local, valid = orig(packed, indices)
        valid = valid.clone()
        valid[..., -1] = False
        return local, valid
    return _slot_indices


def _pooled_altered(orig):
    """One pooled value moved by ten times the pooled limit."""
    limit = json.loads(HUAWEI.read_text())["limits"]["pooled_max_abs_err"]

    def partitioned_lookup(*args, **kwargs):
        out = orig(*args, **kwargs)
        out[0, 5, 3] += 10 * limit
        return out
    return partitioned_lookup


FAULTS = {
    "last_id_dropped": ("repro_torch.core.partition", "_slot_indices", _last_id_dropped),
    "pooled_altered": ("repro_torch.core.embedding", "partitioned_lookup", _pooled_altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    module, name, make = FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    out = harness.run_cell(cell, 17, SECONDS, False, device="cpu")
    assert not out["correct"], out["checks"]


def test_the_configuration_is_the_programs_huawei_25mb():
    from repro_torch.data.workloads import WORKLOADS

    cfg = json.loads(HUAWEI.read_text())
    tables = WORKLOADS["huawei-25mb"].tables
    assert cfg["rows"] == [t.rows for t in tables]
    assert cfg["seqs"] == [t.seq for t in tables]
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    [entry] = [c for c in bench["configs"] if c["name"] == cfg["name"]]
    assert entry["file"] == "portbench/configs/dlrm-huawei-25mb.json" and entry["reduced"] == []
