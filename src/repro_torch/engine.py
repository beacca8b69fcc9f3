"""InferenceEngine — the declarative public API facade.

One object replaces the hand-wired ``plan_asymmetric`` → ``pack_plan`` →
``PartitionedEmbeddingBag`` / ``Server`` chain::

    from repro_torch.engine import EngineConfig, InferenceEngine

    config = EngineConfig(distribution="uniform", mesh_shape=(1, 8))
    engine = InferenceEngine.build(table_data, workload, config)  # on "cuda"
    pooled = engine.lookup(indices)            # (N, B, E)
    server = engine.serve()                    # request-level serving
    handle = server.submit_request(query)      # Future-style handle
    server.pump(); pooled_one = handle.result()
    print(engine.plan_report())

``EngineConfig`` is the JAX package's, field for field: a reference config
JSON loads unchanged.  Stage behavior is pluggable through six named
registries (placement, access reduction, tuning, drift, validation,
integrity) holding the builtin policies this slice runs.  A value the JAX
package accepts but this slice cannot execute yet raises
``NotImplementedError`` naming its ROADMAP item at validation; none is
ignored.  The engine builds on the card unless ``device="cpu"`` is passed,
and raises when CUDA is absent.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Callable, Mapping, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

__all__ = [
    "ACCESS_POLICIES",
    "AccessReductionPolicy",
    "DRIFT_POLICIES",
    "DriftPolicy",
    "EngineConfig",
    "HARDWARE_PRESETS",
    "INTEGRITY_POLICIES",
    "InferenceEngine",
    "IntegrityPolicy",
    "PLACEMENT_POLICIES",
    "PlacementPolicy",
    "PolicyRegistry",
    "TUNING_POLICIES",
    "TuningPolicy",
    "VALIDATION_POLICIES",
    "ValidationPolicy",
]


# --------------------------------------------------------------------------
# Policy protocols + registries
# --------------------------------------------------------------------------


@runtime_checkable
class PlacementPolicy(Protocol):
    """Maps a workload onto cores.  Same signature as the planner functions
    in :mod:`repro_torch.core.planner`."""

    def plan(self, workload, n_cores: int, model, **options):  # -> Plan
        ...


@runtime_checkable
class AccessReductionPolicy(Protocol):
    """Chooses the planner's access-reduction arming: the kwargs merged into
    the placement call (``dedup=``/``cache=``/sizing)."""

    def planner_kwargs(self, **options) -> dict:
        ...


@runtime_checkable
class TuningPolicy(Protocol):
    """Chooses the fused kernel's block sizes at pack time: the kwargs
    merged into :meth:`PartitionedEmbeddingBag.pack`."""

    def pack_kwargs(self, **options) -> dict:
        ...


@runtime_checkable
class ValidationPolicy(Protocol):
    """Builds the server's query-index validator: a callable
    ``payloads -> (payloads', counts, bad)`` run at batch release, or
    ``None`` for no validation."""

    def validator(self, *, rows, **options):
        ...


@runtime_checkable
class IntegrityPolicy(Protocol):
    """Wires packed-buffer corruption detection: ``manifest`` freezes the
    pack-time checksums (``None`` disables), ``server_config`` returns the
    cadence/guard knobs the server runs them under."""

    def manifest(self, packed, plan, **options):
        ...

    def server_config(self, **options):
        ...


@runtime_checkable
class DriftPolicy(Protocol):
    """Wires online replanning into the server (``None`` = static)."""

    def drift_config(self, *, baseline, extract_indices, replan, **options):
        ...


class PolicyRegistry:
    """Named factory registry for one policy kind.  ``register`` accepts a
    zero-arg factory (class or callable) and doubles as a decorator; unknown
    names raise with the registered alternatives listed."""

    def __init__(self, kind: str):
        self.kind = kind
        self._factories: dict[str, Callable[[], Any]] = {}

    def register(self, name: str, factory: Callable[[], Any] | None = None):
        if factory is None:  # decorator form
            return lambda f: self.register(name, f)
        if not isinstance(name, str) or not name:
            raise ValueError(f"{self.kind} policy name must be a non-empty string")
        self._factories[name] = factory
        return factory

    def create(self, name: str):
        if name not in self._factories:
            raise ValueError(
                f"unknown {self.kind} policy {name!r}; "
                f"registered: {self.names()}"
            )
        return self._factories[name]()

    def names(self) -> list[str]:
        return sorted(self._factories)


PLACEMENT_POLICIES = PolicyRegistry("placement")
ACCESS_POLICIES = PolicyRegistry("access-reduction")
TUNING_POLICIES = PolicyRegistry("tuning")
DRIFT_POLICIES = PolicyRegistry("drift")
VALIDATION_POLICIES = PolicyRegistry("validation")
INTEGRITY_POLICIES = PolicyRegistry("integrity")


class _PlannerPlacement:
    """Builtin placement: delegate to a :data:`repro_torch.core.planner.PLANNERS`
    entry — the engine path and the manual chain share the planner code."""

    def __init__(self, planner_name: str):
        self.planner_name = planner_name

    def plan(self, workload, n_cores, model, **options):
        from repro_torch.core.planner import PLANNERS

        return PLANNERS[self.planner_name](workload, n_cores, model, **options)


for _name in ("baseline", "symmetric", "asymmetric"):
    PLACEMENT_POLICIES.register(
        _name, (lambda n: lambda: _PlannerPlacement(n))(_name)
    )


class _NoAccessReduction:
    def planner_kwargs(self, **options) -> dict:
        return {}


ACCESS_POLICIES.register("none", _NoAccessReduction)


class _NoTuning:
    def pack_kwargs(self, **options) -> dict:
        return {}


class _FixedTuning:
    """Caller-pinned block sizes: ``tuning_options`` pass straight through
    (``block_r``/``block_b``)."""

    def pack_kwargs(self, **options) -> dict:
        return {k: options[k] for k in ("block_r", "block_b") if k in options}


TUNING_POLICIES.register("none", _NoTuning)
TUNING_POLICIES.register("fixed", _FixedTuning)


class _NoDrift:
    def drift_config(self, *, baseline, extract_indices, replan, **options):
        return None


DRIFT_POLICIES.register("none", _NoDrift)


class _IndexValidation:
    """Builtin validation policies: the three OOV/negative-index modes of
    :class:`repro_torch.serving.validation.IndexValidator`."""

    def __init__(self, mode: str):
        self.mode = mode

    def validator(self, *, rows, **options):
        from repro_torch.serving.validation import payload_validator

        return payload_validator(rows, self.mode)


for _mode in ("clip", "null-row", "reject"):
    VALIDATION_POLICIES.register(
        _mode, (lambda m: lambda: _IndexValidation(m))(_mode)
    )


class _NoIntegrity:
    def manifest(self, packed, plan, **options):
        return None

    def server_config(self, **options):
        return None


INTEGRITY_POLICIES.register("none", _NoIntegrity)


# --------------------------------------------------------------------------
# EngineConfig
# --------------------------------------------------------------------------


HARDWARE_PRESETS = ("tpu_v5e", "a100", "ascend_910")


def _hardware_presets() -> dict:
    from repro_torch.core import cost_model

    # single source: each preset name is its cost_model constant, uppercased
    return {name: getattr(cost_model, name.upper()) for name in HARDWARE_PRESETS}


@dataclasses.dataclass
class EngineConfig:
    """Declarative build recipe for :class:`InferenceEngine` — the JAX
    package's fields, defaults and validation, so a config JSON written by
    either package loads in the other.

    ``distribution`` is a CLI-style spec string (``"uniform"``,
    ``"zipf:1.2"``, ``"hotset:0.01:0.9"``, a workload preset name, …) —
    the access histograms the plan is priced under; ``None`` keeps the
    paper's uniform assumption.  ``hardware`` names the cost-model preset
    the plan is priced under; it does not describe the card the engine runs
    on.
    """

    # scenario model: "pooled" = the raw embedding lookup (the scenario
    # towers are not ported yet, ROADMAP A9)
    model: str = "pooled"
    model_options: dict = dataclasses.field(default_factory=dict)
    # placement
    planner: str = "asymmetric"
    planner_options: dict = dataclasses.field(default_factory=dict)
    distribution: str | None = None
    # access reduction
    access: str = "none"
    access_options: dict = dataclasses.field(default_factory=dict)
    # block-size tuning
    tuning: str = "none"
    tuning_options: dict = dataclasses.field(default_factory=dict)
    # online replanning
    drift: str = "none"
    drift_options: dict = dataclasses.field(default_factory=dict)
    # data-plane integrity: input validation + buffer corruption detection
    validation: str = "clip"
    validation_options: dict = dataclasses.field(default_factory=dict)
    integrity: str = "none"
    integrity_options: dict = dataclasses.field(default_factory=dict)
    # executor
    layout: str = "ragged"
    use_kernels: str = "fused"  # "fused" | "xla" (the plain gather path)
    reduce_mode: str = "sparse"  # "sparse" | "psum" | "ring"
    kernel_path: str = "auto"
    # hardware / cost model
    hardware: str = "tpu_v5e"
    hardware_options: dict = dataclasses.field(default_factory=dict)
    dtype: str = "float32"
    n_cores: int | None = None  # deprecated: use mesh_shape (None = devices)
    # (hosts, cores_per_host); the plan has hosts * cores_per_host cores
    mesh_shape: tuple | list | None = None
    # the JAX package skips its plan-cores == device-mesh check with this;
    # plan cores are partitions of one device here, so there is no check
    simulate: bool = False
    # serving: batching + admission control + deadlines + degraded mode
    max_batch: int = 256
    max_wait_s: float = 0.0
    max_queue: int | None = None  # None = unbounded admission queue
    admission: str = "block"  # "block" | "reject" | "shed-oldest"
    deadline_s: float | None = None  # default per-request deadline
    adaptive_batching: bool = False  # arrival-rate-aware early release
    degrade_after: int = 3  # consecutive batch failures before degraded
    #   mode (0 disables the fallback path entirely)
    probe_every: int = 4  # degraded-mode primary-probe cadence

    def __post_init__(self) -> None:
        # JSON round-trips deliver mesh_shape as a list; normalize so a
        # loaded config compares equal to the one that was saved
        if self.mesh_shape is not None:
            self.mesh_shape = tuple(self.mesh_shape)

    def validate(self) -> None:
        if self.layout not in ("ragged", "dense"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.use_kernels not in ("fused", "xla"):
            raise ValueError(
                f"use_kernels must be 'fused' or 'xla', got {self.use_kernels!r}"
            )
        if self.reduce_mode not in ("sparse", "psum", "ring"):
            raise ValueError(f"unknown reduce_mode {self.reduce_mode!r}")
        if self.hardware not in _hardware_presets():
            raise ValueError(
                f"unknown hardware preset {self.hardware!r}; "
                f"known: {sorted(_hardware_presets())}"
            )
        if self.dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {self.max_batch}")
        if self.max_wait_s < 0:
            raise ValueError(
                f"max_wait_s must be >= 0, got {self.max_wait_s} "
                "(0 releases as soon as anything is queued)"
            )
        from repro_torch.serving.server import ADMISSION_POLICIES

        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {self.admission!r}; "
                f"known: {list(ADMISSION_POLICIES)}"
            )
        if self.max_queue is not None and self.max_queue <= 0:
            raise ValueError(
                f"max_queue must be positive (or None for unbounded), "
                f"got {self.max_queue}"
            )
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive (or None), got {self.deadline_s}"
            )
        if self.degrade_after < 0:
            raise ValueError(
                f"degrade_after must be >= 0 (0 disables degraded mode), "
                f"got {self.degrade_after}"
            )
        if self.probe_every <= 0:
            raise ValueError(
                f"probe_every must be positive, got {self.probe_every}"
            )
        if self.kernel_path not in ("auto", "onehot", "sparse"):
            raise ValueError(
                f"kernel_path must be 'auto', 'onehot' or 'sparse', "
                f"got {self.kernel_path!r}"
            )
        if self.kernel_path == "sparse" and self.access not in ("dedup", "full"):
            raise ValueError(
                "kernel_path='sparse' requires access='dedup' or 'full' "
                "(the sparse gather rides the dedup machinery)"
            )
        if self.mesh_shape is not None:
            from repro_torch.core.mesh import resolve_mesh_shape

            # raises MeshShapeError on bad geometry / n_cores disagreement
            resolve_mesh_shape(self.mesh_shape, self.n_cores, warn=False)
        if self.access != "none":
            if self.planner not in ("asymmetric", "hierarchical"):
                raise ValueError(
                    "access reduction requires planner='asymmetric' or "
                    "'hierarchical'"
                )
            if self.layout != "ragged":
                raise ValueError("access reduction requires layout='ragged'")
            if self.use_kernels != "fused":
                raise ValueError("access reduction requires use_kernels='fused'")
        if self.integrity != "none":
            check_every = self.integrity_options.get("check_every", 64)
            if not isinstance(check_every, int) or check_every < 0:
                raise ValueError(
                    f"integrity_options['check_every'] must be an int >= 0, "
                    f"got {check_every!r}"
                )
        self.require_ported()
        # fail early on unknown policy names (before any planning work)
        for reg, name in (
            (PLACEMENT_POLICIES, self.planner),
            (ACCESS_POLICIES, self.access),
            (TUNING_POLICIES, self.tuning),
            (DRIFT_POLICIES, self.drift),
            (VALIDATION_POLICIES, self.validation),
            (INTEGRITY_POLICIES, self.integrity),
        ):
            reg.create(name)

    def require_ported(self) -> None:
        """Raise ``NotImplementedError`` for a value the JAX package accepts
        but this slice cannot execute yet, naming the ROADMAP item that ports
        it (the registries hold only what runs)."""
        pending = [
            (self.model != "pooled", f"model={self.model!r} (scenario towers)", "A9"),
            (self.planner == "hierarchical", "planner='hierarchical'", "A4"),
            (self.access != "none", f"access={self.access!r}", "A7"),
            (self.tuning == "sweep", "tuning='sweep'", "A7"),
            (self.drift != "none", f"drift={self.drift!r}", "A6"),
            (self.integrity != "none", f"integrity={self.integrity!r}", "A8"),
            (self.layout == "dense", "layout='dense'", "B8"),
        ]
        for bad, what, item in pending:
            if bad:
                raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")

    # -- JSON round-trip ----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "EngineConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown EngineConfig fields: {unknown}")
        return cls(**dict(d))

    def to_json(self, **dumps_kwargs) -> str:
        dumps_kwargs.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **dumps_kwargs)

    @classmethod
    def from_json(cls, s: str) -> "EngineConfig":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> None:
        Path(path).write_text(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "EngineConfig":
        return cls.from_json(Path(path).read_text())


# --------------------------------------------------------------------------
# InferenceEngine
# --------------------------------------------------------------------------


_TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
}


def _payload_indices(q) -> np.ndarray:
    """A query payload is either the raw (N, s) index array or a dict with
    an ``"indices"`` entry (the serving convention)."""
    return np.asarray(q["indices"] if isinstance(q, Mapping) else q)


class InferenceEngine:
    """The facade: plan → pack on the device, built once by :meth:`build`,
    exposing ``lookup`` / ``serve`` / ``stats`` / ``plan_report``.

    Attributes useful for composition (e.g. a DLRM forward on top of the
    packed embeddings): ``bag`` (the :class:`PartitionedEmbeddingBag`),
    ``packed`` (the :class:`PackedPlan`), ``plan``, ``device``, ``freqs``
    (the histograms the plan was priced under), ``cost_model``.
    """

    def __init__(
        self, *, config, workload, bag, packed, device, freqs, table_data,
        cost_model,
    ):
        self.config = config
        self.workload = workload
        self.bag = bag
        self.packed = packed
        self.device = device
        self.freqs = freqs
        self.cost_model = cost_model
        self._table_data = table_data
        self._server = None

    # -- construction -------------------------------------------------------

    @classmethod
    def build(
        cls,
        tables,
        workload,
        config: EngineConfig | None = None,
        *,
        device=None,
        freqs=None,
        rng: torch.Generator | None = None,
    ) -> "InferenceEngine":
        """Build the pipeline from a declarative config on ``device``
        (``None`` = ``"cuda"``, which raises when CUDA is absent).

        ``tables`` — per-table (m_i, E) arrays (numpy or torch), or ``None``
        to initialize fresh tables (``rng`` seeds them; default seed 0), or
        the string ``"abstract"`` for shape-only packing.  ``freqs``
        overrides ``config.distribution`` with explicit per-table
        :class:`~repro_torch.data.distributions.RowProbs`.  ``K`` is
        ``mesh_shape``'s core count; without one it is the number of visible
        CUDA devices (1 on the CPU), as the JAX package defaults to its
        device count.
        """
        from repro_torch.core.cost_model import analytic_model
        from repro_torch.core.embedding import PartitionedEmbeddingBag
        from repro_torch.core.mesh import resolve_mesh_shape
        from repro_torch.device import resolve_device

        config = config if config is not None else EngineConfig()
        config.validate()
        device = resolve_device(device)

        hosts, cores_per_host = resolve_mesh_shape(
            config.mesh_shape, config.n_cores,
            default_cores=torch.cuda.device_count() if device.type == "cuda" else 1,
        )
        n_cores = hosts * cores_per_host
        hw = _hardware_presets()[config.hardware]
        if config.hardware_options:
            hw = dataclasses.replace(hw, **config.hardware_options)
        model = analytic_model(hw)

        if freqs is None and config.distribution:
            from repro_torch.data.distributions import (
                DriftSchedule,
                get_distribution,
                workload_probs,
            )

            dist = get_distribution(config.distribution)
            if isinstance(dist, DriftSchedule):
                dist = dist.at(0)
            freqs = workload_probs(workload, dist)

        placement = PLACEMENT_POLICIES.create(config.planner)
        access = ACCESS_POLICIES.create(config.access)
        tuning = TUNING_POLICIES.create(config.tuning)

        planner_kwargs = dict(config.planner_options)
        planner_kwargs.update(access.planner_kwargs(**config.access_options))
        if freqs is not None:
            planner_kwargs["freqs"] = freqs
        if config.planner == "asymmetric":
            # the per-chunk gather-path record lands in plan.meta["kernel"]
            planner_kwargs.setdefault("kernel_path", config.kernel_path)

        bag = PartitionedEmbeddingBag(
            workload,
            n_cores=n_cores,
            planner=placement.plan,
            cost_model=model,
            planner_kwargs=planner_kwargs,
            layout=config.layout,
            dtype=_TORCH_DTYPES[config.dtype],
        )
        if isinstance(tables, str):
            if tables != "abstract":
                raise ValueError(f"unknown tables spec {tables!r}")
            table_data = None
        elif tables is None:
            table_data = bag.init(
                rng if rng is not None else torch.Generator().manual_seed(0)
            )
        else:
            table_data = list(tables)
        packed = bag.pack(
            table_data, device=device,
            **tuning.pack_kwargs(**config.tuning_options),
        )
        return cls(
            config=config,
            workload=workload,
            bag=bag,
            packed=packed,
            device=device,
            freqs=freqs,
            table_data=table_data,
            cost_model=model,
        )

    def reference_view(self) -> "InferenceEngine":
        """A shallow engine view over the SAME bag/packed tables whose
        executor runs the plain gather path (``use_kernels="xla"``): equal
        results, no kernels.  A CPU engine's server serves from it in
        degraded mode; a CUDA engine's server never does (see :meth:`serve`)."""
        return InferenceEngine(
            config=dataclasses.replace(self.config, use_kernels="xla"),
            workload=self.workload,
            bag=self.bag,
            packed=self.packed,
            device=self.device,
            freqs=self.freqs,
            table_data=self._table_data,
            cost_model=self.cost_model,
        )

    # -- execution ----------------------------------------------------------

    @property
    def plan(self):
        return self.bag.plan

    @property
    def table_data(self):
        return self._table_data

    @property
    def _use_kernels(self):
        return "fused" if self.config.use_kernels == "fused" else False

    @torch.no_grad()
    def lookup(self, indices) -> torch.Tensor:
        """Partitioned pooled lookup: per-table index arrays (or the stacked
        (N, B, s_max) array with ``-1`` padding) → (N, B, E) f32 on the
        engine's device."""
        if not isinstance(indices, (list, tuple, torch.Tensor)):
            indices = torch.from_numpy(np.array(indices))
        return self.bag.apply(
            self.packed,
            indices,
            use_kernels=self._use_kernels,
            reduce_mode=self.config.reduce_mode,
        )

    def _default_step(self):
        """payloads (list of queries) → (N, B, E) numpy."""

        def step(payloads):
            idx = np.stack([_payload_indices(q) for q in payloads], axis=1)
            return self.lookup(idx).cpu().numpy()

        step.bag = self.bag
        return step

    @staticmethod
    def _default_split(out, n: int):
        """(N, B, E) batch output → per-query (N, E) slices."""
        return [out[:, i] for i in range(n)]

    def serve(
        self,
        *,
        make_step: Callable[["InferenceEngine"], Callable] | None = None,
        split_fn: Callable[[Any, int], Sequence[Any]] | None = None,
        max_batch: int | None = None,
        max_wait_s: float | None = None,
        fault_injector=None,
        **server_kwargs,
    ):
        """Build a :class:`repro_torch.serving.server.Server` driven by this
        engine: microbatching behind ``submit_request(query) -> handle``.

        ``make_step(engine) -> step`` customizes what runs per batch (e.g.
        a full DLRM forward on ``engine.bag``/``engine.packed``).  Default:
        the pooled embedding lookup, with per-query results split as (N, E)
        slices.  Robustness semantics come from the config: ``max_queue`` +
        ``admission`` bound the queue and ``deadline_s`` sheds stale requests.
        On a CPU engine, when ``degrade_after > 0`` and the primary executor
        is the fused path, a fallback step built from ``make_step`` over
        :meth:`reference_view` serves batches in degraded mode after
        repeated failures.  A CUDA engine gets no such fallback: a batch
        whose kernels fail fails, and is counted, rather than being served by
        the plain version on the card.  Fault injection waits for ROADMAP A8.
        """
        from repro_torch.serving.server import Server

        if fault_injector is not None:
            raise NotImplementedError("fault injection is not ported yet: ROADMAP A8")
        maker = make_step or (lambda eng: eng._default_step())

        step0 = maker(self)
        if getattr(step0, "bag", None) is None:
            step0.bag = self.bag
        fallback = server_kwargs.pop("fallback_step_fn", None)
        if (
            fallback is None
            and self.device.type == "cpu"
            and self.config.degrade_after > 0
            and self.config.use_kernels == "fused"
        ):
            fallback = maker(self.reference_view())

        validator = VALIDATION_POLICIES.create(self.config.validation).validator(
            rows=[t.rows for t in self.workload.tables],
            **self.config.validation_options,
        )
        kwargs = dict(
            max_batch=max_batch or self.config.max_batch,
            max_wait_s=(
                max_wait_s if max_wait_s is not None else self.config.max_wait_s
            ),
            layout=self.bag.layout_summary(),
            exec_mode={
                "use_kernels": self.config.use_kernels,
                "reduce_mode": self.config.reduce_mode,
            },
            cache=dict(self.plan.meta.get("cache") or {}),
            split_fn=split_fn or self._default_split,
            max_queue=self.config.max_queue,
            admission=self.config.admission,
            deadline_s=self.config.deadline_s,
            adaptive_batching=self.config.adaptive_batching,
            fallback_step_fn=fallback,
            degrade_after=self.config.degrade_after,
            probe_every=self.config.probe_every,
            validator=validator,
        )
        kwargs.update(server_kwargs)  # explicit kwargs override the config
        srv = Server(step0, **kwargs)
        self._server = srv
        return srv

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Plan/layout summary (+ live server stats if :meth:`serve` was
        called).  ``predicted_p99_us`` is the cost model's figure under the
        config's ``hardware`` preset, not a time measured on the card."""
        from repro_torch.core.planner import predicted_p99

        plan = self.plan
        out = {
            "model": self.config.model,
            "workload": self.workload.name,
            "n_cores": plan.n_cores,
            "device": str(self.device),
            "planner": plan.meta.get("planner"),
            "n_chunks": len(plan.assignments),
            "n_symmetric": len(plan.symmetric_tables),
            "lif": plan.meta.get("lif"),
            "predicted_p99_us": predicted_p99(
                self.cost_model, self.workload.tables, self.workload.batch,
                plan, self.freqs,
            ) * 1e6,
            "layout": self.bag.layout_summary(),
            "config": self.config.to_dict(),
        }
        for key in ("cache", "distribution", "kernel", "mesh"):
            if plan.meta.get(key) is not None:
                out[key] = plan.meta[key]
        out["mesh_shape"] = [1, plan.n_cores]
        if self._server is not None:
            out["server"] = self._server.stats()
        return out

    def _placement_tree(self, kern: dict) -> list[str]:
        """Placement as a core → chunk tree with per-level modeled lookup
        bytes (single host: the multi-host tree waits for ROADMAP A4)."""
        from repro_torch.core.traffic import modeled_plan_traffic

        plan = self.plan
        traffic = modeled_plan_traffic(
            plan, self.workload.tables, self.workload.batch, self.freqs
        )
        recs = list(zip(plan.assignments, kern["per_chunk"], traffic["per_chunk_bytes"]))
        lines = [
            f"  host 0: {len(recs)} chunks, "
            f"modeled lookup {sum(b for *_, b in recs):,}B"
        ]
        for core in sorted({r[0].core for r in recs}):
            core_recs = [r for r in recs if r[0].core == core]
            lines.append(
                f"    core {core}: {len(core_recs)} chunks, "
                f"modeled lookup {sum(b for *_, b in core_recs):,}B"
            )
            for a, rec, b in core_recs:
                lines.append(
                    f"      chunk table={rec['table']} "
                    f"rows={rec['rows']} strategy={a.strategy.name} "
                    f"kernel={rec['path']} "
                    f"(modeled onehot {rec['onehot_us']:.2f}us / "
                    f"sparse {rec['sparse_us']:.2f}us, lookup {b:,}B)"
                )
        return lines

    def plan_report(self) -> str:
        """Human-readable build report (what ``launch/serve.py`` prints).
        Modeled figures are the cost model's under the ``hardware`` preset."""
        s = self.stats()
        lines = [
            f"model {self.config.model}",
            f"workload {self.workload.summary()}",
            f"plan: {s['n_chunks']} chunks, {s['n_symmetric']} symmetric, "
            f"{s['n_cores']} cores, planner={s['planner']}, "
            f"predicted P99 {s['predicted_p99_us']:.1f}us "
            f"(cost model, {self.config.hardware} preset)",
        ]
        if self.plan.symmetric_tables:
            lines.append(
                "symmetric group: "
                + ", ".join(
                    f"{t}:{st.name}" for t, st in zip(
                        self.plan.symmetric_tables, self.plan.symmetric_strategies
                    )
                )
            )
        lay = s.get("layout") or {}
        if lay:
            lines.append(
                f"layout={lay['kind']} chunk_bytes={lay['chunk_bytes']:,} "
                f"(dense would be {lay['dense_bytes']:,}; "
                f"{lay['bytes_vs_dense']:.2%} of dense, "
                f"padding_frac={lay['padding_frac']:.2%})"
            )
        kern = s.get("kernel")
        if kern and kern.get("per_chunk"):
            lines.append(
                f"kernel path={kern['path']} "
                f"({kern['n_sparse']} sparse / {kern['n_onehot']} one-hot chunks)"
            )
            lines.extend(self._placement_tree(kern))
        lines.append(
            f"executor kernels={self.config.use_kernels} "
            f"reduce={self.config.reduce_mode} layout={self.config.layout} "
            f"device={self.device}"
        )
        if self.config.validation != "clip":
            lines.append(f"integrity validation={self.config.validation}")
        return "\n".join(lines)
