"""The harness on the CPU at a tiny size, with the kernels' plain versions:
a run agrees with the plain reference, and the control (bf16 tables) and
each fault planted under the timed path make ``correct`` false."""
import pytest
import torch

from portbench import harness, spec
from portbench.tests import tiny

SECONDS = 0.3


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return spec.load_cell(tiny.make_root(tmp_path_factory.mktemp("tiny")), tiny.CELL)


def test_reference_agrees_with_a_run(cell):
    out = harness.run_cell(cell, 2**31 + 11, SECONDS, False, device="cpu")
    checks = out["checks"]
    assert out["correct"], checks
    assert out["failed"] == 0 and out["attempted"] == out["info"]["compared_batches"] > 0
    assert checks["pooled_max_abs_err"]["value"] == 0.0  # s = 1: each bag is one row
    assert checks["logit_max_abs_err"]["value"] <= cell.config["limits"]["logit_max_abs_err"]
    assert list(out["metrics"]) == [m["name"] for m in cell.end_to_end]


def test_bf16_tables_fail_the_comparison(cell):
    out = harness.run_cell(cell, 5, SECONDS, False, device="cpu",
                           engine_overrides={"dtype": "bfloat16"})
    assert not out["correct"]
    assert out["checks"]["pooled_max_abs_err"]["value"] > cell.config["limits"]["pooled_max_abs_err"]


def _half_batch(orig):
    def forward_packed(*args, **kwargs):
        out = orig(*args, **kwargs)
        half = out.shape[0] // 2
        out[half:] = out[:half].mean()
        return out
    return forward_packed


def _logit_altered(orig):
    def forward_packed(*args, **kwargs):
        out = orig(*args, **kwargs)
        out[3] += 1e-3
        return out
    return forward_packed


def _pooled_altered(orig):
    def partitioned_lookup(*args, **kwargs):
        out = orig(*args, **kwargs)
        out[1, 7, 2] += 1e-3
        return out
    return partitioned_lookup


FAULTS = {
    "half_batch_mean": ("repro_torch.models.dlrm", "forward_packed", _half_batch),
    "exchange_left_out": ("repro_torch.core.partition", "_sparse_rejoin",
                          lambda orig: lambda local, packed: local[0]),
    "logit_altered": ("repro_torch.models.dlrm", "forward_packed", _logit_altered),
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


@pytest.mark.cuda
def test_the_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    sound = harness.run_cell(cell, 23, SECONDS, False, device="cuda")
    control = harness.run_cell(cell, 23, SECONDS, False, device="cuda",
                               engine_overrides={"dtype": "bfloat16"})
    assert sound["correct"], sound["checks"]
    assert not control["correct"], control["checks"]
