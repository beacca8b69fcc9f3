"""What ``BENCHMARK.json`` says of one cell, and the files it names.

A cell names a configuration and a traffic mix; each is found by name as
``portbench/configs/<file>`` (the configuration's ``file`` entry) and
``portbench/traffic/<traffic>.json``, and each per-layer metric as
``portbench/metrics/<name>.py``.  Nothing here knows a cell, a
configuration, a mix or a metric by name.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ["Cell", "load_cell", "load_reader"]


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration
    and traffic read; raises ``KeyError`` for a cell that is not there."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return Cell(
        root=root, name=name, chips=int(cell["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def load_reader(root: Path, metric: str):
    """The ``read(ctx)`` function of ``portbench/metrics/<metric>.py``."""
    path = Path(root) / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
