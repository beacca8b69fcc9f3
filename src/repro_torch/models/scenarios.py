"""ScenarioModel wrappers: the four towers served through the engine.

Each wrapper owns a recommender-shaped workload (embedding tables and a
batch), hands its tables to :meth:`repro_torch.engine.InferenceEngine.build`,
and supplies the two forwards every scenario is held on:

* :meth:`ScenarioModel.make_step` — the served path: pooled embeddings from
  the engine's partitioned lookup (the port's kernels on the card), then the
  model's *tower*, the dense compute on top of the lookups;
* :meth:`ScenarioModel.reference_forward` — plain lookups into the source
  tables, then the **same** tower module on the same device.

Every scenario table has ``seq=1``, so each pooled vector is one row copied
exactly by either path: equal pooled inputs through one tower module give
bitwise equal scores, the JAX package's gate.  The towers are plain PyTorch
(``nn.Module``s; their products are ``torch`` matmuls and einsums), written
as the JAX package writes them so that the two packages agree closely:

* ``dlrm`` — bottom MLP on dense features, pairwise interaction, top MLP
  (:mod:`repro_torch.models.dlrm`);
* ``moe`` — the feature tokens through a capacity-routed top-k MoE layer
  (:mod:`repro_torch.models.moe`);
* ``mamba2`` — the feature sequence scanned by an SSD block
  (:mod:`repro_torch.models.mamba2`);
* ``transformer`` — a pre-norm self-attention and SwiGLU block
  (:mod:`repro_torch.models.layers`).

A wrapper lives on one device (``device=None`` is the card): its tower and a
copy of its tables for the reference lookups sit there, the tables it hands
the engine stay on the host.  :meth:`_TowerScenario.on` copies a wrapper to
another device with the same values; :func:`scenario_from_jax` carries the
JAX package's tables and tower parameters across.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Mapping, Protocol, Sequence, runtime_checkable

import numpy as np
import torch
from torch import nn

from repro_torch.core.tables import Workload, make_workload
from repro_torch.device import resolve_device

__all__ = [
    "DLRMScenario",
    "Mamba2Scenario",
    "MoEScenario",
    "ScenarioModel",
    "TransformerScenario",
    "make_dlrm_scenario",
    "make_mamba2_scenario",
    "make_moe_scenario",
    "make_transformer_scenario",
    "scenario_from_jax",
]


@runtime_checkable
class ScenarioModel(Protocol):
    """What the engine and the scenario tests need from a model wrapper.

    ``make_step(engine)`` must work on any engine built from ``workload``,
    the re-planned engine of a drift hot-swap included: the drift policy
    calls it again on every shadow re-pack."""

    name: str
    workload: Workload

    def table_data(self) -> list:
        """Per-table (rows, dim) embedding tensors, aligned with
        ``workload.tables``: what :meth:`InferenceEngine.build` packs."""
        ...

    def sample_batch(self, rng, distribution, batch: int | None = None) -> dict:
        """Draw one batch of queries under a traffic distribution."""
        ...

    def payloads(self, batch: Mapping) -> list:
        """Split a batch into per-query ``submit_request`` payloads."""
        ...

    def reference_forward(self, batch: Mapping) -> np.ndarray:
        """Dense-lookup scores (B,) for a batch."""
        ...

    def make_step(self, engine) -> Callable:
        """Served path: payloads -> (B,) scores through the engine."""
        ...

    def split(self, out, n: int) -> Sequence:
        """Batch output -> per-request results (``Server`` split_fn)."""
        ...


def _frozen(value) -> nn.Parameter:
    """An inference-only f32 parameter holding a copy of ``value``."""
    return nn.Parameter(torch.as_tensor(value, dtype=torch.float32).clone(),
                        requires_grad=False)


# --------------------------------------------------------------------------
# towers
# --------------------------------------------------------------------------


class _DLRMTower(nn.Module):
    def __init__(self, bottom: nn.Module, top: nn.Module):
        super().__init__()
        self.bottom, self.top = bottom, top

    def forward(self, pooled, dense):
        from repro_torch.models.dlrm import interact

        bot = self.bottom(dense)
        return self.top(interact(bot, pooled.to(bot.dtype)))[..., 0]

    def load_jax(self, params: Mapping) -> None:
        self.bottom.load_xw(params["bottom"])
        self.top.load_xw(params["top"])


class _HeadTower(nn.Module):
    """A tower made of flat parameter groups (each a ``ParameterDict``) and
    a ``(E, 1)`` scoring head; ``groups`` names the groups in the JAX
    package's parameter tree."""

    def __init__(self, params: Mapping[str, Any]):
        super().__init__()
        self.groups = tuple(k for k, v in params.items() if isinstance(v, Mapping))
        for k, v in params.items():
            if isinstance(v, Mapping):
                self.add_module(k, nn.ParameterDict({n: _frozen(a) for n, a in v.items()}))
            else:
                self.register_parameter(k, _frozen(v))

    @torch.no_grad()
    def load_jax(self, params: Mapping) -> None:
        for k, v in params.items():
            if k in self.groups:
                group = getattr(self, k)
                if set(group) != set(v):
                    raise ValueError(f"{k}: expected {sorted(group)}, got {sorted(v)}")
                for name, arr in v.items():
                    group[name].copy_(torch.tensor(np.asarray(arr)))
            else:
                getattr(self, k).copy_(torch.tensor(np.asarray(v)))


class _MoETower(_HeadTower):
    def __init__(self, params, spec):
        super().__init__(params)
        self.spec = spec

    def forward(self, pooled):
        from repro_torch.models.moe import moe_apply

        x = pooled.transpose(0, 1)  # (B, N, E) feature tokens
        y, _aux = moe_apply(self.moe, x, self.spec)
        return (y.mean(dim=1) @ self.head)[..., 0]


class _Mamba2Tower(_HeadTower):
    def __init__(self, params, spec):
        super().__init__(params)
        self.spec = spec

    def forward(self, pooled):
        from repro_torch.models.mamba2 import mamba_apply

        u = pooled.transpose(0, 1)  # (B, N, E) feature sequence
        y, _state = mamba_apply(self.mamba, u, self.spec)
        return (y[:, -1, :] @ self.head)[..., 0]


class _TransformerTower(_HeadTower):
    def __init__(self, params, spec):
        super().__init__(params)
        self.spec = spec

    def forward(self, pooled):
        from repro_torch.models.layers import attention, mlp_apply, rms_norm

        x = pooled.transpose(0, 1)  # (B, N, E) feature tokens
        a, _cache = attention(self.attn, rms_norm(x, self.ln1), self.spec)
        h = x + a
        h = h + mlp_apply(self.mlp, rms_norm(h, self.ln2))
        return (h.mean(dim=1) @ self.head)[..., 0]


# --------------------------------------------------------------------------
# the shared wrapper body
# --------------------------------------------------------------------------


class _TowerScenario:
    """Common wrapper body: seeded tables and tower, the plain-lookup
    reference, the engine-backed step and the per-query payloads.

    Subclasses set ``name`` and define ``_init_tower(generator)`` returning
    the tower module; the fused and reference paths share that module, so
    their agreement reduces to the pooled lookups (bitwise at seq=1)."""

    name: str = "tower"

    def __init__(self, workload: Workload, seed: int = 0, device=None):
        self.workload = workload
        self.seed = seed
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self._tables = [
            torch.randn((t.rows, t.dim), generator=gen) / float(np.sqrt(t.dim))
            for t in workload.tables
        ]
        self.tower = self._init_tower(gen).to(self.device).eval()
        self._device_tables = None

    def on(self, device) -> "_TowerScenario":
        """This wrapper on ``device``: the same tables and tower values."""
        other = copy.copy(self)
        other.device = resolve_device(device)
        other.tower = copy.deepcopy(self.tower).to(other.device)
        other._device_tables = None
        return other

    # -- protocol: tables and batches ----------------------------------------

    def table_data(self) -> list:
        return list(self._tables)

    def sample_batch(self, rng, distribution, batch: int | None = None) -> dict:
        from repro_torch.data.distributions import sample_workload

        return {"indices": sample_workload(rng, self.workload, distribution, batch)}

    def payloads(self, batch: Mapping) -> list:
        idx = np.asarray(batch["indices"])
        return [{"indices": idx[:, i]} for i in range(idx.shape[1])]

    def collate(self, payloads: Sequence[Mapping]) -> dict:
        return {"indices": np.stack([np.asarray(p["indices"]) for p in payloads], axis=1)}

    # -- protocol: the two forwards ------------------------------------------

    def _tower_inputs(self, batch: Mapping, device) -> tuple:
        return ()

    @torch.no_grad()
    def pooled_reference(self, indices) -> torch.Tensor:
        """Plain lookups into the source tables on the wrapper's device:
        (N, B, s) -> (N, B, E) f32."""
        if self._device_tables is None:
            self._device_tables = [t.to(self.device) for t in self._tables]
        idx = torch.as_tensor(np.asarray(indices), device=self.device).long()
        outs = []
        for i, t in enumerate(self._device_tables):
            valid = idx[i] >= 0
            g = t[torch.where(valid, idx[i], 0)]
            outs.append(torch.where(valid[..., None], g, 0.0).sum(dim=1).float())
        return torch.stack(outs)

    @torch.no_grad()
    def reference_forward(self, batch: Mapping) -> np.ndarray:
        pooled = self.pooled_reference(batch["indices"])
        return self.tower(pooled, *self._tower_inputs(batch, self.device)).cpu().numpy()

    def make_step(self, engine) -> Callable:
        tower = self.tower

        @torch.no_grad()
        def step(payloads):
            batch = self.collate(payloads)
            pooled = engine.lookup(batch["indices"])
            return tower(pooled, *self._tower_inputs(batch, pooled.device)).cpu().numpy()

        step.bag = engine.bag
        return step

    def split(self, out, n: int) -> Sequence:
        return [out[i] for i in range(n)]

    # -- the JAX package's values -----------------------------------------------

    def load_jax(self, tables: Sequence, params: Mapping) -> None:
        """Take the JAX wrapper's ``table_data()`` and tower ``params`` (as
        numpy arrays) in place of this wrapper's own."""
        if len(tables) != len(self.workload.tables):
            raise ValueError(f"expected {len(self.workload.tables)} tables, got {len(tables)}")
        self._tables = [torch.tensor(np.asarray(t), dtype=torch.float32) for t in tables]
        self._device_tables = None
        self.tower.load_jax(params)

    @property
    def embed_dim(self) -> int:
        return self.workload.tables[0].dim

    def _init_tower(self, generator) -> nn.Module:  # pragma: no cover - abstract
        raise NotImplementedError


# --------------------------------------------------------------------------
# the four scenarios
# --------------------------------------------------------------------------


class DLRMScenario(_TowerScenario):
    """Facebook-DLRM: bottom MLP on dense features, sum-pooled embedding
    bags, pairwise dot interaction, top MLP.  The only scenario with a
    dense-feature side input."""

    name = "dlrm"

    def __init__(self, workload: Workload, seed: int = 0, n_dense: int = 13, device=None):
        from repro_torch.models.dlrm import DLRMConfig

        self.cfg = DLRMConfig(
            arch="dlrm-scenario", workload=workload, n_dense=n_dense,
            embed_dim=workload.tables[0].dim, bottom_mlp=(32, 16), top_mlp=(32,),
        )
        super().__init__(workload, seed, device)

    def _init_tower(self, generator) -> nn.Module:
        from repro_torch.models.dlrm import init_dlrm

        params = init_dlrm(self.cfg, generator)
        params.pop("tables")  # the scenario's tables live in self._tables
        return _DLRMTower(params["bottom"], params["top"])

    def _tower_inputs(self, batch: Mapping, device) -> tuple:
        return (torch.as_tensor(np.asarray(batch["dense"]), device=device),)

    def sample_batch(self, rng, distribution, batch: int | None = None) -> dict:
        out = super().sample_batch(rng, distribution, batch)
        b = out["indices"].shape[1]
        out["dense"] = rng.standard_normal((b, self.cfg.n_dense)).astype(np.float32)
        return out

    def payloads(self, batch: Mapping) -> list:
        idx, dense = np.asarray(batch["indices"]), np.asarray(batch["dense"])
        return [{"indices": idx[:, i], "dense": dense[i]} for i in range(idx.shape[1])]

    def collate(self, payloads: Sequence[Mapping]) -> dict:
        return {
            "indices": np.stack([np.asarray(p["indices"]) for p in payloads], axis=1),
            "dense": np.stack([np.asarray(p["dense"]) for p in payloads]),
        }


class MoEScenario(_TowerScenario):
    """Pooled per-table embeddings as one routing group through a top-k
    capacity-routed MoE layer, mean-pooled into a linear scoring head.
    ``capacity_factor`` is sized so no token drops."""

    name = "moe"

    def _init_tower(self, generator) -> nn.Module:
        from repro_torch.models.layers import dense_init
        from repro_torch.models.moe import MoESpec, moe_init

        self.spec = MoESpec(n_experts=4, top_k=2, d_ff=32, capacity_factor=4.0)
        return _MoETower({"moe": moe_init(generator, self.embed_dim, self.spec),
                          "head": dense_init(generator, (self.embed_dim, 1))}, self.spec)


class Mamba2Scenario(_TowerScenario):
    """The per-query feature sequence scanned by one SSD block; the last
    position's output feeds the scoring head."""

    name = "mamba2"

    def _init_tower(self, generator) -> nn.Module:
        from repro_torch.models.layers import dense_init
        from repro_torch.models.mamba2 import MambaSpec, mamba_init

        self.spec = MambaSpec(d_model=self.embed_dim, d_state=16, head_dim=8, chunk=4)
        return _Mamba2Tower({"mamba": mamba_init(generator, self.spec),
                             "head": dense_init(generator, (self.embed_dim, 1))}, self.spec)


class TransformerScenario(_TowerScenario):
    """One pre-norm self-attention and SwiGLU block over the feature
    tokens, mean-pooled into the scoring head."""

    name = "transformer"

    def _init_tower(self, generator) -> nn.Module:
        from repro_torch.models.layers import AttnSpec, attn_init, dense_init, mlp_init

        e = self.embed_dim
        self.spec = AttnSpec(n_heads=4, n_kv_heads=2, head_dim=8, causal=False, rope=None)
        return _TransformerTower({
            "ln1": torch.zeros((e,)),
            "attn": attn_init(generator, e, self.spec),
            "ln2": torch.zeros((e,)),
            "mlp": mlp_init(generator, e, 32),
            "head": dense_init(generator, (e, 1)),
        }, self.spec)


# --------------------------------------------------------------------------
# default workloads: the JAX package's, one embedding/MLP ratio each
# --------------------------------------------------------------------------


def _default_workload(name: str, cards, batch: int) -> Workload:
    return make_workload(name, cards, dim=16, batch=batch)


def make_dlrm_scenario(batch: int = 64, seed: int = 0, device=None) -> DLRMScenario:
    """Mid-size CTR mix: one big table, mixed satellites."""
    return DLRMScenario(_default_workload("dlrm-ctr", [4000, 1500, 600, 250], batch),
                        seed, device=device)


def make_moe_scenario(batch: int = 64, seed: int = 0, device=None) -> MoEScenario:
    """Embedding-heavy: one oversized table dominates the bytes."""
    return MoEScenario(_default_workload("moe-ranker", [30000, 2000, 500, 120], batch),
                       seed, device)


def make_mamba2_scenario(batch: int = 64, seed: int = 0, device=None) -> Mamba2Scenario:
    """History-shaped: many medium tables (a long feature sequence)."""
    return Mamba2Scenario(_default_workload(
        "mamba2-session", [3000, 3000, 2000, 2000, 800, 800, 200, 200], batch), seed, device)


def make_transformer_scenario(batch: int = 64, seed: int = 0,
                              device=None) -> TransformerScenario:
    """MLP-heavy: smaller tables, the tower dominates the FLOPs."""
    return TransformerScenario(_default_workload(
        "transformer-ctr", [12000, 6000, 1500, 400, 120, 80], batch), seed, device)


def scenario_from_jax(name: str, tables: Sequence, params: Mapping, *, batch: int = 64,
                      seed: int = 0, device=None) -> _TowerScenario:
    """The port's ``name`` wrapper holding the JAX wrapper's values: its
    ``table_data()`` and tower ``params``, given as numpy arrays (the DLRM
    MLPs as ``{"w": (in, out), "b": (out,)}`` layers)."""
    from repro_torch.models.registry import get_scenario

    scenario = get_scenario(name, batch=batch, seed=seed, device="cpu")
    scenario.load_jax(tables, params)
    return scenario.on(device)
