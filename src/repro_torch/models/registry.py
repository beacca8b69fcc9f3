"""The scenario registry: the JAX package's ``SCENARIOS``, entry for entry.

Each entry pairs a :class:`repro_torch.models.scenarios.ScenarioModel`
factory with a ``default_config`` dict of
:class:`repro_torch.engine.EngineConfig` fields, the same recipe the JAX
package serves it under.  The architecture registry of the LM side
(``get_config``, ``Bundle``, ``build``) is not part of the port yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["SCENARIOS", "ScenarioEntry", "get_scenario", "list_scenarios"]


@dataclasses.dataclass(frozen=True)
class ScenarioEntry:
    """One registered scenario: ``factory(batch=, seed=, device=)`` returns
    a conforming wrapper; ``default_config`` holds plain ``EngineConfig``
    field values."""

    name: str
    factory: Callable[..., Any]
    description: str
    default_config: dict


def _scenario_entries() -> dict[str, ScenarioEntry]:
    from repro_torch.models import scenarios as S

    entries = [
        ScenarioEntry(
            "dlrm",
            S.make_dlrm_scenario,
            "paper DLRM: bottom MLP + pairwise interaction + top MLP",
            {"planner": "asymmetric", "access": "full", "distribution": "zipf:1.2"},
        ),
        ScenarioEntry(
            "moe",
            S.make_moe_scenario,
            "top-k routed MoE tower over the feature tokens",
            {"planner": "asymmetric", "access": "full", "distribution": "zipf:1.2"},
        ),
        ScenarioEntry(
            "mamba2",
            S.make_mamba2_scenario,
            "SSD state-space tower over the embedded feature sequence",
            {"planner": "asymmetric", "access": "dedup",
             "distribution": "hotset:0.02:0.9"},
        ),
        ScenarioEntry(
            "transformer",
            S.make_transformer_scenario,
            "pre-norm self-attention + SwiGLU block over feature tokens",
            {"planner": "asymmetric", "access": "none", "tuning": "none"},
        ),
    ]
    return {e.name: e for e in entries}


SCENARIOS: dict[str, ScenarioEntry] = _scenario_entries()


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


def get_scenario(name: str, *, batch: int | None = None, seed: int = 0, device=None):
    """Instantiate a registered scenario wrapper (its default workload) on
    ``device`` (``None`` = the card)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; registered: {list_scenarios()}")
    kwargs: dict[str, Any] = {"seed": seed, "device": device}
    if batch is not None:
        kwargs["batch"] = batch
    return SCENARIOS[name].factory(**kwargs)
