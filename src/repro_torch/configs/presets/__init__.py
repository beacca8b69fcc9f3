"""Curated EngineConfig preset packs for the paper workloads.

Each ``<name>.json`` in this directory is one deployment recipe, a copy of
the JAX package's file of the same name::

    {
      "name":         "<preset name>",
      "description":  "<one line>",
      "workload":     "<repro_torch.data.workloads.WORKLOADS key>",
      "distribution": "<traffic spec for the serve CLI>",
      "config":       { <EngineConfig fields> }
    }

``launch/serve.py --preset <name>`` loads one: the config becomes the
engine recipe and the workload/distribution fill the CLI's traffic flags
(explicit ``--workload``/``--distribution``/``--set`` still override).  The
packs are taobao under zipf-1.2 skew, tenrec under a hot-set stream, and
the day-parted huawei schedule, each with the access-reduction, drift and
integrity policies tuned for that traffic.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ["list_presets", "load_preset"]

_PRESET_DIR = Path(__file__).resolve().parent
_REQUIRED = ("name", "description", "workload", "config")


def list_presets() -> list[str]:
    return sorted(p.stem for p in _PRESET_DIR.glob("*.json"))


def load_preset(name: str) -> dict:
    """Load and validate one preset pack.  The embedded config is
    round-tripped through :class:`repro_torch.engine.EngineConfig` (unknown
    fields and invalid policy names fail here, not at build time)."""
    path = _PRESET_DIR / f"{name}.json"
    if not path.is_file():
        raise ValueError(
            f"unknown preset {name!r}; available: {list_presets()}"
        )
    data = json.loads(path.read_text())
    missing = [k for k in _REQUIRED if k not in data]
    if missing:
        raise ValueError(f"preset {name!r} is missing fields: {missing}")

    from repro_torch.data.workloads import WORKLOADS
    from repro_torch.engine import EngineConfig

    if data["workload"] not in WORKLOADS:
        raise ValueError(
            f"preset {name!r} names unknown workload {data['workload']!r}"
        )
    EngineConfig.from_dict(data["config"]).validate()
    return data
