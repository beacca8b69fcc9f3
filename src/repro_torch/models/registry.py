"""Architecture + scenario registries, as the JAX package's.

* :data:`ARCH_MODULES` — ``--arch <id>`` -> an LM config
  (:mod:`repro_torch.configs`) and, through :func:`build`, a :class:`Bundle`
  of its step functions and batch shapes (every family runs: dense, moe,
  ssm, hybrid, encdec with its frames and vlm with its embeds);
* :data:`SCENARIOS` — each entry pairs a
  :class:`repro_torch.models.scenarios.ScenarioModel` factory with a
  ``default_config`` dict of :class:`repro_torch.engine.EngineConfig`
  fields, the same recipe the JAX package serves it under.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCfg
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

__all__ = [
    "ARCH_IDS",
    "ARCH_MODULES",
    "Bundle",
    "SCENARIOS",
    "SHAPES",
    "ScenarioEntry",
    "Spec",
    "build",
    "get_config",
    "get_scenario",
    "list_scenarios",
]

ARCH_MODULES: dict[str, str] = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
}

ARCH_IDS = tuple(ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


class Spec(NamedTuple):
    """A model input's shape and dtype (the JAX package's
    ``ShapeDtypeStruct`` stand-in)."""

    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass
class Bundle:
    cfg: ArchConfig

    # -- params ---------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None):
        """Fresh parameters from ``generator``.  Across the ranks of a card
        mesh every rank seeds the same generator, and
        ``sharding.with_sharding`` places the tree (rank 0's values
        scattered); the step builders take a ``ShardCtx`` over that mesh
        as they take one over a shape."""
        return T.init_params(self.cfg, generator)

    def param_struct(self, dtype: torch.dtype | None = None):
        """The parameter tree's shapes and dtypes as ``meta`` tensors (the
        JAX package's ``eval_shape``): no memory, no values; ``dtype``
        recasts every leaf."""
        with torch.device("meta"):
            s = self.init(None)
        if dtype is not None:
            s = tree_map(lambda x: x.to(dtype), s)
        return s

    # -- steps ----------------------------------------------------------------
    def train_step(self, ctx, optimizer, shape: ShapeCfg):
        return T.make_train_step(self.cfg, ctx, optimizer, shape)

    def prefill_step(self, ctx, shape: ShapeCfg):
        return T.make_prefill_step(self.cfg, ctx, shape)

    def serve_step(self, ctx):
        return T.make_serve_step(self.cfg, ctx)

    # -- shape specs ----------------------------------------------------------
    def batch_specs(self, shape: ShapeCfg, act_dtype=torch.bfloat16) -> dict[str, Spec]:
        """Every model input of a shape, as the JAX package lists them."""
        cfg = self.cfg
        b, s = shape.batch, shape.seq
        i32 = torch.int32
        if shape.kind in ("train", "prefill"):
            out: dict[str, Spec] = {}
            if cfg.input_kind == "embeds":
                out["embeds"] = Spec((b, s, cfg.d_model), act_dtype)
                out["positions"] = Spec((3, b, s), i32)
            elif cfg.input_kind == "frames_tokens":
                out["frames"] = Spec((b, s, cfg.d_model), act_dtype)
                out["tokens"] = Spec((b, s), i32)
            else:
                out["tokens"] = Spec((b, s), i32)
            if shape.kind == "train":
                out["labels"] = Spec((b, s), i32)
            return out
        if cfg.input_kind == "embeds":
            return {"embeds": Spec((b, 1, cfg.d_model), act_dtype),
                    "positions": Spec((3, b, 1), i32)}
        return {"tokens": Spec((b, 1), i32)}

    def cache_struct(self, shape: ShapeCfg, dtype: torch.dtype = torch.bfloat16) -> dict:
        """The serve cache of a decode shape as ``meta`` tensors."""
        return T.init_cache(self.cfg, shape, dtype=dtype, device="meta")

    def make_batch(self, shape: ShapeCfg, generator: torch.Generator,
                   act_dtype=torch.bfloat16) -> dict:
        """A random batch drawn from ``generator``, on its device: token and
        label ids in ``[0, vocab)``, positions in ``[0, seq)`` (each M-RoPE
        component drawn on its own), normal frames and embeds."""
        out = {}
        for k, v in self.batch_specs(shape, act_dtype).items():
            if v.dtype == torch.int32:
                hi = self.cfg.vocab if k in ("tokens", "labels") else shape.seq
                out[k] = torch.randint(0, max(hi, 2), v.shape, generator=generator,
                                       dtype=torch.int32, device=generator.device)
            else:
                out[k] = torch.randn(v.shape, generator=generator,
                                     device=generator.device).to(v.dtype)
        return out


def build(arch: str, smoke: bool = False) -> Bundle:
    cfg = get_config(arch, smoke)
    # whisper needs the frames+tokens input kind
    if cfg.family == "encdec" and cfg.input_kind == "tokens":
        cfg = dataclasses.replace(cfg, input_kind="frames_tokens")
    return Bundle(cfg)


# ==========================================================================
# the scenario registry
# ==========================================================================


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
