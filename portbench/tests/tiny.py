"""A tiny cell for the CPU tests: a copy of the benchmark's files under a
temporary root, with one configuration of six small tables over four plan
cores and one traffic mix of 64 samples a batch."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny-zipf"


def make_root(dst: Path) -> Path:
    """``dst`` laid out as a checkout: ``BENCHMARK.json`` naming the tiny
    cell, the tiny configuration and traffic files, the metric readers."""
    pb = dst / "portbench"
    shutil.copytree(REPO / "portbench" / "metrics", pb / "metrics")
    (pb / "configs").mkdir(parents=True)
    (pb / "traffic").mkdir(parents=True)
    cfg = json.loads((REPO / "portbench" / "configs" / "dlrm-taobao.json").read_text())
    cfg.update(name="dlrm-tiny", rows=[64, 200, 1000, 48, 4096, 333], seqs=[1] * 6)
    cfg["engine"] = {**cfg["engine"], "mesh_shape": [1, 4]}
    (pb / "configs" / "dlrm-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((REPO / "portbench" / "traffic" / "zipf12-b256k.json").read_text())
    traffic.update(batch=64, pool=3, warmup_batches=2)
    (pb / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "dlrm-tiny", "source": "tests", "reduced": [], "why": "tests",
                         "file": "portbench/configs/dlrm-tiny.json"}]
    bench["workloads"] = [{"name": CELL, "config": "dlrm-tiny", "traffic": "tiny", "chips": 1,
                           "why": "tests"}]
    for m in bench["per_layer"]:
        m["workloads"] = [CELL]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst
