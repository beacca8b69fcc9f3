"""The harness is driven by files: a configuration, a traffic mix or a
per-layer metric dropped into a copy is found by name; and a whole run, in
a process of its own, prints the contract's line without loading JAX or
the JAX package."""
import json
import os
import subprocess
import sys

from portbench import harness, spec
from portbench.tests import tiny


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "dlrm-tiny.json").read_text())
    cfg.update(name="dlrm-tiny2", rows=[30, 40, 50], seqs=[1, 1, 1])
    (pb / "configs" / "dlrm-tiny2.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "tiny.json").read_text())
    traffic["distribution"] = {"kind": "hotset", "hot_frac": 0.1, "hot_mass": 0.9}
    (pb / "traffic" / "tiny-hot.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "pool_batches.py").write_text(
        "def read(ctx):\n    return float(len(ctx.state.pool))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dlrm-tiny2", "source": "tests", "reduced": [],
                             "why": "tests", "file": "portbench/configs/dlrm-tiny2.json"})
    bench["workloads"].append({"name": "tiny2-hot", "config": "dlrm-tiny2",
                               "traffic": "tiny-hot", "chips": 1, "why": "tests"})
    bench["per_layer"].append({"name": "pool_batches", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "tests",
                               "moves": "samples_per_s", "workloads": ["tiny2-hot"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(root, "tiny2-hot")
    assert cell.config["rows"] == [30, 40, 50]
    assert cell.traffic["distribution"]["kind"] == "hotset"
    assert [m["name"] for m in cell.per_layer][-1] == "pool_batches"
    assert "pool_batches" not in [m["name"] for m in spec.load_cell(root, tiny.CELL).per_layer]
    out = harness.run_cell(cell, 3, 0.2, True, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["pool_batches"] == {"value": 3.0, "unit": "batches"}


SCRIPT = """
import json, sys, time
t0 = time.perf_counter()
from pathlib import Path
from portbench import harness
rc = harness.main(["--workload", sys.argv[2], "--seed", "2147483659", "--seconds", "0.3",
                   "--trace", "1"], root=Path(sys.argv[1]), t0=t0, device="cpu")
tops = sorted({m.split(".")[0] for m in sys.modules})
print("MODULES " + json.dumps(tops), file=sys.stderr)
sys.exit(rc)
"""


def test_a_run_prints_the_contract_line_and_loads_no_jax(tmp_path):
    root = tiny.make_root(tmp_path)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(tiny.REPO), str(tiny.REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(root), tiny.CELL],
                          capture_output=True, text=True, env=env, timeout=110)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    # the contract's keys, and the compared numbers last under a key of their own
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["checks"]) == {"failed_batches", "pooled_max_abs_err", "logit_max_abs_err"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    err = proc.stderr.strip().splitlines()
    tops = json.loads(err[-1].removeprefix("MODULES "))
    # whole top-level names: the port's name begins with the JAX package's
    assert "repro_torch" in tops
    assert not {"jax", "jaxlib", "flax", "repro", "benchmarks"} & set(tops)
    assert [ln.split()[1] for ln in err[-4:-1]] == list(line["checks"])
