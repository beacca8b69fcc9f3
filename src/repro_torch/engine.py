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
integrity) holding the builtin policies; every value the JAX package's
``EngineConfig`` accepts builds and serves.  A scenario model
(``config.model``, :data:`SCENARIO_MODELS`) is served through
:meth:`InferenceEngine.build_scenario`, whose engine runs the scenario's
tower over the lookups.  The engine builds on the card unless
``device="cpu"`` is passed, and raises when CUDA is absent.

Across cards, every rank of a ``torchrun`` job builds the engine with the
same config and seed and the device mesh
(:func:`repro_torch.launch.mesh.init_card_mesh`)::

    mesh = init_card_mesh()                       # one rank per card
    engine = InferenceEngine.build(None, workload, config, mesh=mesh)
    if engine.rank == 0:
        pooled = engine.lookup(indices)           # each core on its own card
        engine.close()
    else:
        engine.follow()                           # until rank 0 closes

Each rank keeps on its card only its plan core's slice; rank 0 sends every
lookup's indices to the others, which run it with it until ``close``.

Rank 0 alone runs a :class:`~repro_torch.serving.server.Server`.  All the
other ranks must do travels as one ordered op stream that rank 0 sends from
its main thread: lookups, a drift rebuild's announcement and its swap point,
the server's decision on it, integrity sweeps and heals.  So every rank
issues every collective in the same order, and a shadow build, on any rank,
issues none.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Mapping, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.models.registry import list_scenarios

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
    "SCENARIO_MODELS",
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


for _name in ("baseline", "symmetric", "asymmetric", "hierarchical"):
    PLACEMENT_POLICIES.register(
        _name, (lambda n: lambda: _PlannerPlacement(n))(_name)
    )


class _AccessArming:
    def __init__(self, dedup: bool, cache: bool):
        self.dedup, self.cache = dedup, cache

    def planner_kwargs(self, **options) -> dict:
        if not (self.dedup or self.cache):
            return {}
        return {"dedup": self.dedup, "cache": self.cache, **options}


ACCESS_POLICIES.register("none", lambda: _AccessArming(False, False))
ACCESS_POLICIES.register("dedup", lambda: _AccessArming(True, False))
ACCESS_POLICIES.register("cache", lambda: _AccessArming(False, True))
ACCESS_POLICIES.register("full", lambda: _AccessArming(True, True))


class _NoTuning:
    def pack_kwargs(self, **options) -> dict:
        return {}


class _FixedTuning:
    """Caller-pinned block sizes: ``tuning_options`` pass straight through
    (``block_r``/``block_b``)."""

    def pack_kwargs(self, **options) -> dict:
        return {k: options[k] for k in ("block_r", "block_b") if k in options}


class _SweepTuning:
    """The :func:`repro_torch.core.autotune.autotune_block_sizes` sweep on
    the serving device, recorded in ``plan.meta["tuning"]`` by
    ``bag.pack(autotune=True)``."""

    def pack_kwargs(self, **options) -> dict:
        return {"autotune": True}


TUNING_POLICIES.register("none", _NoTuning)
TUNING_POLICIES.register("fixed", _FixedTuning)
TUNING_POLICIES.register("sweep", _SweepTuning)


class _NoDrift:
    def drift_config(self, *, baseline, extract_indices, replan, **options):
        return None


class _ReplanDrift:
    """The drift state machine: sketch → hysteresis trigger → shadow re-pack
    → parity-gated hot swap.  ``options`` are
    :class:`repro_torch.serving.server.DriftConfig` knobs
    (threshold/check_every/patience/cooldown/metric/overlap/...)."""

    def drift_config(self, *, baseline, extract_indices, replan, **options):
        from repro_torch.serving.server import DriftConfig

        return DriftConfig(
            baseline=baseline,
            extract_indices=extract_indices,
            replan=replan,
            **options,
        )


DRIFT_POLICIES.register("none", _NoDrift)
DRIFT_POLICIES.register("replan", _ReplanDrift)


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


class _ChecksumIntegrity:
    """Builtin ``checksum`` policy: per-region CRC32 manifest at pack time
    (:class:`repro_torch.core.integrity.IntegrityManifest`), verified on a
    batch cadence and on drift hot-swaps, with NaN/Inf output guards.
    Options: ``check_every`` (batches between sweeps, default 64; 0 = only
    on hot-swap/poisoned output) and ``nan_guard`` (default True)."""

    def manifest(self, packed, plan, **options):
        from repro_torch.core.integrity import IntegrityManifest

        # a rank of a device mesh keys its slice's regions by its plan core
        return IntegrityManifest.from_packed(packed, plan, core=options.get("core"))

    def server_config(self, **options):
        return {
            "check_every": int(options.get("check_every", 64)),
            "nan_guard": bool(options.get("nan_guard", True)),
        }


INTEGRITY_POLICIES.register("none", _NoIntegrity)
INTEGRITY_POLICIES.register("checksum", _ChecksumIntegrity)


# --------------------------------------------------------------------------
# EngineConfig
# --------------------------------------------------------------------------


HARDWARE_PRESETS = ("tpu_v5e", "a100", "ascend_910")
# the scenario towers of repro_torch.models.registry.SCENARIOS
SCENARIO_MODELS = tuple(list_scenarios())


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

    # scenario model: "pooled" = the raw embedding lookup; a SCENARIO_MODELS
    # name serves that scenario's tower over the lookups (build_scenario)
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
    # without a device mesh plan cores are partitions of one card and any
    # core count executes; with one (build(mesh=...)) a plan whose core
    # count is not the mesh's "model" size builds only with this, and its
    # lookups raise, as the JAX package's do
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
        if self.model != "pooled" and self.model not in SCENARIO_MODELS:
            raise ValueError(
                f"unknown scenario model {self.model!r}; registered: "
                f"{sorted(SCENARIO_MODELS)} (or 'pooled')"
            )
        if self.integrity != "none":
            check_every = self.integrity_options.get("check_every", 64)
            if not isinstance(check_every, int) or check_every < 0:
                raise ValueError(
                    f"integrity_options['check_every'] must be an int >= 0, "
                    f"got {check_every!r}"
                )
        # fail early on unknown policy names (before any planning work)
        for reg, field in (
            (PLACEMENT_POLICIES, "planner"),
            (ACCESS_POLICIES, "access"),
            (TUNING_POLICIES, "tuning"),
            (DRIFT_POLICIES, "drift"),
            (VALIDATION_POLICIES, "validation"),
            (INTEGRITY_POLICIES, "integrity"),
        ):
            reg.create(getattr(self, field))

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


# the op header rank 0 sends the other ranks of a device mesh: (op,
# generation, executor, N, B, s).  Generation 0 is the pack every rank built;
# rank 0 numbers each rebuild's.  The executor is 1 for the fused kernels, 0
# for the plain path (the CPU's degraded fallback).  REPLAN is followed by
# the measured histograms.
(_OP_STOP, _OP_LOOKUP, _OP_REPLAN, _OP_JOIN, _OP_COMMIT, _OP_DROP, _OP_VERIFY,
 _OP_HEAL) = range(8)
_HEADER = 6
# how long a follower waits at a swap point for its share of a rebuild: the
# same work took rank 0 ``build_s``, so a share still building after twice
# that, plus a second for the host's scheduling, is counted as stalled (a
# failed build) rather than holding rank 0's pump.  JOIN carries the wait
# in milliseconds in the header's N.
_JOIN_WAIT_TIMES, _JOIN_WAIT_SLACK_S = 2.0, 1.0
# at the end of the job a follower waits this long for a share still
# building, as the server's drain does for its own under a build timeout
_END_WAIT_S = 5.0


def _on_main_thread(what: str) -> None:
    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError(
            f"{what} issues collectives across the ranks of a device mesh: "
            "only a rank's main thread may")


def _gather(obj) -> list:
    """Every rank's ``obj``, in rank order (a collective: every rank calls
    it, from its main thread)."""
    import torch.distributed as dist

    _on_main_thread("a gather")
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, obj)
    return every


def _recv_object():
    import torch.distributed as dist

    box = [None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class _Generation:
    """One pack across the ranks, shared by its engine and that engine's
    views: its number, and whether every rank has joined its build."""

    __slots__ = ("number", "joined", "__weakref__")

    def __init__(self, number: int = 0, joined: bool = True):
        self.number, self.joined = number, joined


class _OpStream:
    """Rank 0's end of the ordered op stream of a device mesh, shared by the
    engine rank 0 built and every rebuild of it.

    Each op is sent from rank 0's main thread.  A rebuild on a shadow
    thread queues its REPLAN, and a generation rank 0 no longer holds queues
    its DROP; both go out before rank 0's next op, after the server's
    decision on the last swap point (COMMIT when its live step serves that
    generation, else DROP)."""

    def __init__(self, device):
        self.device = device
        self.queued: collections.deque = collections.deque()  # (op, generation, payload)
        self.generations = itertools.count(1)  # next() is atomic: any thread may number
        self.server = None  # the Server whose decision ends a swap point
        self.swap = None  # (generation, the server's replan events at its swap point)
        self.closed = False
        # each rank's seconds at the swap points, sweeps and heals
        self.log: collections.deque = collections.deque(maxlen=256)

    def queue(self, op: int, gen: int, payload=None) -> None:
        self.queued.append((op, gen, payload))

    def send(self, op: int, gen: int = 0, *, executor: int = 1, shape=(0, 0, 0),
             payload=None) -> None:
        """Send one op, after the decision and the queued ops before it."""
        _on_main_thread("an op")
        self._decide()
        while self.queued:
            self._header(*self.queued.popleft())
        self._header(op, gen, payload, executor, shape)

    def _decide(self) -> None:
        if self.swap is None:
            return
        gen, events = self.swap
        srv = self.server
        if len(srv.replan_events) == events:
            return  # the parity probe or the integrity gate is still to come
        self.swap = None
        live = getattr(srv.step_fn, "engine", None)
        self._header(_OP_COMMIT if live is not None and live.generation == gen else _OP_DROP,
                     gen)

    def _header(self, op, gen, payload=None, executor=1, shape=(0, 0, 0)) -> None:
        import torch.distributed as dist

        dist.broadcast(torch.tensor([op, gen, executor, *shape], dtype=torch.int64,
                                    device=self.device), src=0)
        if payload is not None:
            dist.broadcast_object_list([payload], src=0)


def _rank_summary(packed, bag, workload, chunk_bytes: list) -> dict:
    """What the ranks of a device mesh hold: each rank's chunk bytes on its
    card, beside the whole buffer's and the rejoin's modeled bytes."""
    import torch.distributed as dist

    from repro_torch.core.traffic import modeled_rejoin_traffic

    return {
        "world": dist.get_world_size(),
        "backend": str(dist.get_backend()),
        "chunk_bytes": chunk_bytes,
        "whole_chunk_bytes": int(bag.plan.meta["layout"]["chunk_bytes"]),
        "fingerprint": packed.host["fingerprint"],
        "rejoin_modeled": modeled_rejoin_traffic(
            packed, batch=workload.batch, n_tables=len(workload.tables)),
    }


def _rank_record(mesh, packed, bag, workload) -> dict:
    """:func:`_rank_summary`, gathered on every rank after a check that
    every rank packed the same plan (the whole packs' fingerprints are
    equal; else raise).  Collective over the whole job: every rank calls
    it."""
    from repro_torch.launch.mesh import all_gather_cat

    fp = packed.host["fingerprint"]
    mine = torch.tensor([int(fp[i:i + 15], 16) for i in range(0, 60, 15)]
                        + [packed.chunk_bytes], dtype=torch.int64, device=packed.device)
    every = all_gather_cat(mine)
    rows = every.view(-1, mine.numel()).tolist()
    differ = [r for r, row in enumerate(rows) if row[:4] != rows[0][:4]]
    if differ:
        raise RuntimeError(
            f"ranks {differ} packed another plan than rank 0: every rank must "
            "build from the same config, tables and seed"
        )
    return _rank_summary(packed, bag, workload, [row[4] for row in rows])


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
    (the histograms the plan was priced under), ``cost_model``,
    ``tuning_cache`` (the sweep memo; another build given it reuses its
    sweeps), ``manifest`` (the pack-time integrity checksums, or ``None``),
    ``scenario`` (the :class:`repro_torch.models.scenarios.ScenarioModel`
    whose tower :meth:`serve` runs, or ``None`` for the pooled lookup).
    """

    def __init__(
        self, *, config, workload, bag, packed, device, freqs, table_data,
        cost_model, manifest=None, scenario=None, tuning_cache=None, mesh=None,
        ranks=None,
    ):
        self.config = config
        self.workload = workload
        self.bag = bag
        self.packed = packed
        self.device = device
        self.freqs = freqs
        self.cost_model = cost_model
        self.manifest = manifest  # pack-time integrity checksums (or None)
        self.scenario = scenario  # ScenarioModel wrapper (or None = pooled)
        self.tuning_cache = tuning_cache
        self.mesh = mesh  # the DeviceMesh the plan cores run on, or None
        self.ranks = ranks  # the mesh's build record (see build), or None
        self._table_data = table_data
        self._server = None
        # across the ranks of a device mesh: this pack's generation, rank
        # 0's op stream (None elsewhere), this rank's plan core, and the
        # seconds this rank's build took
        self._gen = _Generation()
        self._stream = None
        self._core = None
        self.build_s = None

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
        tuning_cache=None,
        block_sizes: dict | None = None,
        mesh=None,
        _shadow: bool = False,
    ) -> "InferenceEngine":
        """Build the pipeline from a declarative config on ``device``
        (``None`` = ``"cuda"``, which raises when CUDA is absent; under a
        process group, this rank's card).

        ``tables`` — per-table (m_i, E) arrays (numpy or torch), or ``None``
        to initialize fresh tables (``rng`` seeds them; default seed 0), or
        the string ``"abstract"`` for shape-only packing.  ``freqs``
        overrides ``config.distribution`` with explicit per-table
        :class:`~repro_torch.data.distributions.RowProbs`.  ``K`` is
        ``mesh_shape``'s core count; without one it is the ``"model"`` size
        of ``mesh``, or without a mesh the number of visible CUDA devices (1
        on the CPU), as the JAX package defaults to its device count.
        ``tuning_cache`` (a
        :class:`repro_torch.core.autotune.TuningCache`; default: a fresh one)
        memoizes ``tuning="sweep"`` sweeps across builds;
        ``block_sizes`` (``block_r``/``block_b``) packs at those sizes in
        place of the tuning policy's, with no sweep (:meth:`rebuild` on the
        card passes its own).

        ``mesh`` (a ``DeviceMesh`` with a ``"model"`` dim, from
        :func:`repro_torch.launch.mesh.init_card_mesh`) runs each plan core
        on its own rank: every rank of the mesh calls ``build`` with the
        same arguments, plans and packs on the host, keeps its core's slice
        on its card, and the ranks compare the packs' fingerprints.  A plan
        whose core count is not the ``"model"`` size raises
        :class:`~repro_torch.core.mesh.MeshShapeError` unless
        ``config.simulate``; such an engine packs the whole plan and its
        lookups raise.  Drift rebuilds, integrity sweeps and heals run
        across the ranks through rank 0's op stream (:meth:`rebuild`,
        :meth:`verify_integrity`, :meth:`heal`).

        ``_shadow=True`` (a rebuild's share on one rank) issues no
        collective: the kernels are built, ``block_sizes`` pins the pack's
        sizes, and the ranks compare the packs at the swap point.
        """
        from repro_torch.core.cost_model import analytic_model
        from repro_torch.core.embedding import PartitionedEmbeddingBag
        from repro_torch.core.mesh import MeshShapeError, resolve_mesh_shape
        from repro_torch.device import resolve_device

        config = config if config is not None else EngineConfig()
        config.validate()
        device = resolve_device(device)

        model_size = torch.cuda.device_count() if device.type == "cuda" else 1
        if mesh is not None:
            from repro_torch.launch.mesh import axis_size

            if mesh.device_type != device.type:
                raise ValueError(
                    f"a {mesh.device_type} device mesh cannot serve from {device}")
            model_size = axis_size(mesh, "model")
        hosts, cores_per_host = resolve_mesh_shape(
            config.mesh_shape, config.n_cores, default_cores=model_size,
        )
        n_cores = hosts * cores_per_host
        if mesh is not None and n_cores != model_size and not config.simulate:
            raise MeshShapeError(
                f"plan spans {n_cores} cores (mesh_shape {hosts}x{cores_per_host}) "
                f"but the device mesh 'model' axis has {model_size} card(s) "
                f"(world size {mesh.size()}); either run under a matching device "
                f"mesh (torchrun --nproc-per-node {n_cores}), set "
                f"mesh_shape=(1, {model_size}), or pass simulate=True for "
                "plan/model-only work (execution will still raise)"
            )
        executable = mesh is not None and n_cores == model_size
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
        if config.planner in ("asymmetric", "hierarchical"):
            # the per-chunk gather-path record lands in plan.meta["kernel"]
            planner_kwargs.setdefault("kernel_path", config.kernel_path)
        if config.planner == "hierarchical":
            planner_kwargs.setdefault("hosts", hosts)

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
        if tuning_cache is None:
            from repro_torch.core.autotune import TuningCache

            tuning_cache = TuningCache()
        core = None
        if executable:
            from repro_torch.launch.mesh import axis_rank

            core = axis_rank(mesh, "model")
            if device.type == "cuda" and not _shadow:
                from repro_torch.kernels.build import build_ranks

                build_ranks()  # rank 0 compiles; the others wait, then load
        packed = bag.pack(
            table_data, device=device, tuning_cache=tuning_cache, core=core,
            mesh=mesh if executable and not _shadow else None,
            **(block_sizes if block_sizes is not None
               else tuning.pack_kwargs(**config.tuning_options)),
        )
        manifest = INTEGRITY_POLICIES.create(config.integrity).manifest(
            packed, bag.plan, **({"core": core} if core is not None else {}),
            **config.integrity_options
        )
        ranks = (_rank_record(mesh, packed, bag, workload)
                 if executable and not _shadow else None)
        engine = cls(
            config=config,
            workload=workload,
            bag=bag,
            packed=packed,
            device=device,
            freqs=freqs,
            table_data=table_data,
            cost_model=model,
            manifest=manifest,
            tuning_cache=tuning_cache,
            mesh=mesh,
            ranks=ranks,
        )
        engine._core = core
        if executable and not _shadow and torch.distributed.get_rank() == 0:
            engine._stream = _OpStream(device)
        return engine

    @classmethod
    def from_scenario(
        cls, scenario, config: EngineConfig | None = None, *, device=None, freqs=None,
        mesh=None,
    ) -> "InferenceEngine":
        """An engine over a :class:`~repro_torch.models.scenarios.ScenarioModel`:
        the wrapper's workload and tables go through :meth:`build`, and the
        engine carries the wrapper, so :meth:`serve` runs its tower step
        (and drift hot-swaps rebuild it).  ``device=None`` is the
        wrapper's own device.  ``mesh`` is :meth:`build`'s: the tower runs on
        rank 0, over the lookup across the ranks."""
        config = config if config is not None else EngineConfig()
        name = getattr(scenario, "name", None)
        if config.model == "pooled" and name in SCENARIO_MODELS:
            config = dataclasses.replace(config, model=name)  # stamp the recipe
        engine = cls.build(
            scenario.table_data(), scenario.workload, config,
            device=scenario.device if device is None else device, freqs=freqs, mesh=mesh,
        )
        engine.scenario = scenario
        return engine

    @classmethod
    def build_scenario(
        cls, name: str | None = None, config: EngineConfig | None = None, *,
        device=None, freqs=None, mesh=None, **factory_kwargs,
    ) -> "InferenceEngine":
        """Resolve a registered scenario by name (default: ``config.model``)
        on ``device`` (``None`` = the card) and build it.
        ``factory_kwargs`` override ``config.model_options``
        (``batch=``/``seed=``)."""
        from repro_torch.models.registry import get_scenario

        config = config if config is not None else EngineConfig()
        name = name or (config.model if config.model != "pooled" else None)
        if name is None:
            raise ValueError("build_scenario needs a scenario name (argument or config.model)")
        opts = {**config.model_options, **factory_kwargs}
        scenario = get_scenario(name, device=device, **opts)
        return cls.from_scenario(scenario, config, device=scenario.device, freqs=freqs,
                                 mesh=mesh)

    def reference_view(self) -> "InferenceEngine":
        """A shallow engine view over the SAME bag/packed tables whose
        executor runs the plain gather path (``use_kernels="xla"``): equal
        results, no kernels.  A CPU engine's server serves from it in
        degraded mode; a CUDA engine's server never does (see :meth:`serve`).
        Across the ranks of a device mesh the view's lookups send the plain
        executor in the op header, so the other ranks run the plain path on
        the same generation."""
        view = InferenceEngine(
            config=dataclasses.replace(self.config, use_kernels="xla"),
            workload=self.workload,
            bag=self.bag,
            packed=self.packed,
            device=self.device,
            freqs=self.freqs,
            table_data=self._table_data,
            cost_model=self.cost_model,
            manifest=self.manifest,
            scenario=self.scenario,
            tuning_cache=self.tuning_cache,
            mesh=self.mesh,
            ranks=self.ranks,
        )
        view._gen, view._stream, view._core = self._gen, self._stream, self._core
        return view

    def rebuild(self, freqs) -> "InferenceEngine":
        """Same config and tables, re-planned and re-packed under new
        histograms on the same device: the shadow re-pack the drift policy
        runs off the hot path.  The tables are this engine's own (never
        re-initialized), and the tuning cache carries over so a
        shape-identical re-plan skips the block-size sweep.  On the card,
        and across the ranks of a device mesh, a swept engine's rebuild
        keeps its block sizes and runs no sweep: on the card the candidates
        lie within the noise of one another, and a sweep under serving load
        would pick among equals and outlast a drift policy's build timeout;
        across ranks a sweep is a collective.  A CPU engine sweeps as the
        reference does.  The scenario wrapper carries over, so a hot-swap
        re-invokes the same tower's ``make_step``.

        Across the ranks of a device mesh rank 0 calls it (from the pump
        thread or a shadow thread): it announces the rebuild to the other
        ranks (REPLAN, with ``freqs``), which build their shares alongside;
        no rank issues a collective while it builds, and the first op for
        the new engine is its swap point (:meth:`_join`)."""
        if self._across:
            self._require_lead("a rebuild")
            stream = self._stream
            gen = next(stream.generations)
            if threading.current_thread() is threading.main_thread():
                stream.send(_OP_REPLAN, gen, payload=freqs)
            else:
                stream.queue(_OP_REPLAN, gen, freqs)
            try:
                engine = self._shadow(freqs, gen)
            except BaseException:
                stream.queue(_OP_DROP, gen)
                raise
            # once rank 0 lets go of this generation, so do the others
            weakref.finalize(engine._gen, stream.queue, _OP_DROP, gen)
            return engine
        engine = InferenceEngine.build(
            self._table_data if self._table_data is not None else "abstract",
            self.workload,
            self.config,
            device=self.device,
            freqs=freqs,
            tuning_cache=self.tuning_cache,
            block_sizes=self._kept_block_sizes() if self.device.type == "cuda" else None,
            mesh=self.mesh,
        )
        engine.scenario = self.scenario
        return engine

    def _kept_block_sizes(self) -> dict | None:
        """A swept engine's own block sizes, for a rebuild that runs no
        sweep (``None``: the tuning policy packs without one)."""
        if self.config.tuning != "sweep":
            return None
        return {"block_r": self.packed.block_r, "block_b": self.packed.block_b or None}

    # -- across the ranks of a device mesh ----------------------------------

    @property
    def _across(self) -> bool:
        return self.mesh is not None and self.mesh.size() > 1

    @property
    def generation(self) -> int:
        """Which pack across the ranks this engine serves: 0 for the one
        every rank built, then each rebuild's number (0 without a mesh)."""
        return self._gen.number

    @property
    def op_log(self) -> list:
        """On rank 0 of a device mesh, each rank's times at the recent swap
        points (``build_s``: its shadow build), integrity sweeps and heals
        (``ms``: its own host time), beside rank 0's wall ``ms`` of the op."""
        return list(self._stream.log) if self._stream is not None else []

    def _shadow(self, freqs, gen: int) -> "InferenceEngine":
        """This rank's share of rebuild ``gen``: the whole plan planned and
        packed on the host from ``freqs``, this core's slice kept on the
        card, and no collective (``build(_shadow=True)``)."""
        t0 = time.perf_counter()
        card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())
        with card:  # a thread starts on card 0
            engine = InferenceEngine.build(
                self._table_data if self._table_data is not None else "abstract",
                self.workload, self.config, device=self.device, freqs=freqs,
                tuning_cache=self.tuning_cache, block_sizes=self._kept_block_sizes(),
                mesh=self.mesh, _shadow=True,
            )
        engine.scenario = self.scenario
        engine._gen = _Generation(gen, joined=False)
        engine._stream = self._stream
        engine.build_s = time.perf_counter() - t0
        return engine

    def _build_report(self) -> dict:
        return {"fingerprint": self.packed.host["fingerprint"],
                "chunk_bytes": self.packed.chunk_bytes, "cache_rows": self.packed.cache_rows,
                "build_s": self.build_s}

    def _join(self) -> None:
        """The swap point of a rebuild across ranks, on rank 0 before the
        first op for its generation: every rank reports its share (JOIN),
        and the ranks compare the packs' fingerprints.  If a rank failed,
        packed another plan or was still building when its wait ran out
        (``_JOIN_WAIT_TIMES``), every rank drops the generation (DROP) and this
        raises, naming the ranks.  Then the server's decision on the
        shadow (after its integrity gate and parity probe) commits or drops
        it on every rank."""
        if self._gen.joined:
            return
        stream, gen = self._stream, self.generation
        t0 = time.perf_counter()
        wait_ms = int((_JOIN_WAIT_TIMES * self.build_s + _JOIN_WAIT_SLACK_S) * 1e3)
        stream.send(_OP_JOIN, gen, shape=(wait_ms, 0, 0))
        every = _gather(self._build_report())
        fp = self.packed.host["fingerprint"]
        failed = {r: rec.get("error") or "packed another plan than rank 0"
                  for r, rec in enumerate(every)
                  if rec.get("error") or rec["fingerprint"] != fp}
        if failed:
            stream.send(_OP_DROP, gen)
            raise RuntimeError(f"rebuild {gen} failed on ranks {sorted(failed)}: " + "; ".join(
                f"rank {r}: {msg}" for r, msg in sorted(failed.items())))
        self._gen.joined = True
        ms = (time.perf_counter() - t0) * 1e3
        build_s = [rec["build_s"] for rec in every]
        cache_rows = [rec["cache_rows"] for rec in every]
        self.ranks = {**_rank_summary(self.packed, self.bag, self.workload,
                                      [rec["chunk_bytes"] for rec in every]),
                      "build_s": build_s, "join_ms": ms}
        stream.log.append({"op": "join", "generation": gen, "build_s": build_s, "ms": ms,
                           "cache_rows": cache_rows})
        if stream.server is not None:
            stream.swap = (gen, len(stream.server.replan_events))
        else:
            stream.send(_OP_COMMIT, gen)

    def _replicated(self, key: tuple) -> bool:
        """Whether more than one rank holds a region: the symmetric tables
        on every rank, and every region when the mesh has a data axis."""
        from repro_torch.launch.mesh import axis_size

        return key[0] == "sym" or self.mesh.size() > axis_size(self.mesh, "model")

    def _verify_local(self) -> dict:
        import torch.distributed as dist

        t0 = time.perf_counter()
        bad = self.manifest.verify(self.packed)
        rank = dist.get_rank()
        # a region more than one rank holds is named with the rank
        bad = [(*k, rank) if self._replicated(k) else k for k in bad]
        return {"bad": bad, "ms": (time.perf_counter() - t0) * 1e3}

    def _heal_local(self) -> dict:
        """Repair this rank's slice (``manifest.repair``: a fresh sweep,
        then each corrupt region rebuilt from the plan's rows of this
        rank's core)."""
        import torch.distributed as dist

        from repro_torch.core.integrity import region_label

        rank = dist.get_rank()
        t0 = time.perf_counter()
        self.packed, report = self.manifest.repair(
            self.packed, self.plan, self.workload.tables, self._table_data)
        labels = {region_label(k): k for k in self.manifest.checksums}
        for kind in ("healed", "quarantined"):
            report[kind] = [f"{lb}@rank{rank}" if self._replicated(labels[lb]) else lb
                            for lb in report[kind]]
        return {**report, "ms": (time.perf_counter() - t0) * 1e3}

    # -- data-plane integrity -----------------------------------------------

    def verify_integrity(self) -> list[tuple]:
        """Re-checksum the packed buffers against the pack-time manifest;
        returns the corrupt region keys (empty = clean, or no manifest).

        Across the ranks of a device mesh (rank 0; VERIFY) each rank checks
        its own slice and the keys are gathered, keyed by the global core;
        a region more than one rank holds (a symmetric table) carries the
        rank as a fourth element."""
        if self.manifest is None:
            return []
        if not self._across:
            return self.manifest.verify(self.packed)
        self._join()
        t0 = time.perf_counter()
        self._stream.send(_OP_VERIFY, self.generation)
        every = _gather(self._verify_local())
        order = {"chunk": 0, "tail": 0, "cache": 1, "sym": 2}
        bad = sorted((k for rec in every for k in rec["bad"]), key=lambda k: (
            order[k[0]], k[1], k[0] == "tail", k[2], k[3] if len(k) > 3 else -1))
        self._stream.log.append({"op": "verify", "generation": self.generation,
                                 "ms": [rec["ms"] for rec in every],
                                 "wall_ms": (time.perf_counter() - t0) * 1e3})
        return bad

    def heal(self) -> dict:
        """Targeted repair of corrupt buffer regions, in place on the
        engine's device: re-materialize them from the source tables
        (bit-exact) or zero-quarantine regions with no source.  The steps
        read ``self.packed`` when they run, so the next batch sees the
        repaired buffers.

        Across the ranks of a device mesh (rank 0; HEAL) each rank repairs
        its own slice and the reports are gathered."""
        if self.manifest is None:
            return {"healed": [], "quarantined": [], "clean": True}
        if not self._across:
            self.packed, report = self.manifest.repair(
                self.packed, self.plan, self.workload.tables, self._table_data
            )
            return report
        self._join()
        t0 = time.perf_counter()
        self._stream.send(_OP_HEAL, self.generation)
        every = _gather(self._heal_local())
        self._stream.log.append({"op": "heal", "generation": self.generation,
                                 "ms": [rec["ms"] for rec in every],
                                 "wall_ms": (time.perf_counter() - t0) * 1e3})
        return {"healed": [lb for rec in every for lb in rec["healed"]],
                "quarantined": [lb for rec in every for lb in rec["quarantined"]],
                "clean": all(rec["clean"] for rec in every)}

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

    @property
    def rank(self) -> int:
        """This process's rank in the job (0 without a mesh)."""
        if self.mesh is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank()

    def _require_executable(self) -> None:
        """Raise when the plan's core count is not the device mesh's
        ``"model"`` size (a ``simulate=True`` build): running it would
        hand some cores no card or some cards no core."""
        if self.mesh is None:
            return
        from repro_torch.core.mesh import MeshShapeError
        from repro_torch.launch.mesh import axis_size

        k, cores = axis_size(self.mesh, "model"), self.plan.n_cores
        if cores != k:
            raise MeshShapeError(
                f"cannot execute: plan spans {cores} cores but the device mesh "
                f"'model' axis has {k} card(s) — this engine was built with "
                "simulate=True for plan/model work; to run lookups, rebuild "
                f"under a matching device mesh (torchrun --nproc-per-node {cores})"
            )

    def _require_lead(self, what: str) -> None:
        if self.rank != 0:
            raise RuntimeError(
                f"{what} runs on rank 0; rank {self.rank} follows it: call follow()")

    @torch.no_grad()
    def lookup(self, indices) -> torch.Tensor:
        """Partitioned pooled lookup: per-table index arrays (or the stacked
        (N, B, s_max) array with ``-1`` padding) → (N, B, E) f32 on the
        engine's device.  On a device mesh, rank 0 calls it (the other
        ranks run :meth:`follow`)."""
        self._require_executable()
        if not isinstance(indices, (list, tuple, torch.Tensor)):
            indices = torch.from_numpy(np.array(indices))
        if self.mesh is not None:
            if isinstance(indices, (list, tuple)):
                from repro_torch.core.embedding import stack_indices

                indices = stack_indices(indices, self.bag.s_max)
            indices = self.broadcast_batch(indices)
        return self.bag.apply(
            self.packed,
            indices,
            use_kernels=self._use_kernels,
            reduce_mode=self.config.reduce_mode,
            mesh=self.mesh,
        )

    def lookup_stages(self, indices) -> dict:
        """:meth:`lookup` across the device mesh as its stages, to time each
        alone: :func:`repro_torch.core.partition.mesh_lookup_stages`'s
        ``"lookup"``, ``"rejoin"`` and ``"sym"``, and ``"whole"``, the
        lookup itself.  Every rank calls it, and then each stage, together
        (after rank 0's :meth:`close`, not through :meth:`follow`)."""
        from repro_torch.core.partition import mesh_lookup_stages

        self._require_executable()
        if self.mesh is None:
            raise RuntimeError("lookup_stages() times the lookup across a device mesh")
        idx = torch.as_tensor(indices, device=self.device)
        kw = dict(use_kernels=self._use_kernels, reduce_mode=self.config.reduce_mode)
        stages = mesh_lookup_stages(self.packed, idx, mesh=self.mesh,
                                    n_tables=self.bag.n_tables, **kw)
        stages["whole"] = lambda: self.bag.apply(self.packed, idx, mesh=self.mesh, **kw)
        return stages

    def broadcast_batch(self, indices) -> torch.Tensor:
        """The stacked (N, B, s) indices on this engine's device.  On a
        device mesh this is rank 0's half of a lookup: it sends the op
        header (this engine's generation and executor) and the indices to
        the other ranks, whose :meth:`follow` then runs the lookup with rank
        0.  A served step on rank 0 calls it and then the lookup with
        ``mesh=engine.mesh``."""
        idx = torch.as_tensor(indices, device=self.device)
        if self.mesh is None:
            return idx
        import torch.distributed as dist

        self._require_lead("a lookup")
        self._require_executable()
        if idx.dim() != 3:
            raise ValueError(f"indices must be stacked (N, B, s), got {tuple(idx.shape)}")
        idx = idx.to(torch.int32).contiguous()
        self._join()
        self._stream.send(_OP_LOOKUP, self.generation,
                          executor=int(self._use_kernels == "fused"), shape=idx.shape)
        dist.broadcast(idx, src=0)
        return idx

    @torch.no_grad()
    def follow(self) -> int:
        """The serving loop of every rank but 0 on a device mesh: run each
        op rank 0 sends, with rank 0, until rank 0's :meth:`close`.
        Returns the number of lookups run.

        Besides lookups (on the generation and with the executor the
        header names) that is a rebuild's share (REPLAN: built on a thread
        when the drift policy overlaps its builds, else inline, while this
        rank keeps serving the live generation; a newer REPLAN supersedes
        it), its report at the swap point (JOIN, waiting for the share no
        longer than the header says), the decision (COMMIT or DROP), and
        integrity sweeps and heals of this rank's slice (VERIFY, HEAL).  A
        rank holds the generations rank 0 holds and the one pending share:
        a superseded, failed or dropped share is let go of, once its thread
        has ended.  An op for a generation this rank does not hold raises,
        which ends the job.  ``follow_stats`` records the lookups by
        executor, the generation committed last, the generations held at
        the end, the rebuild shares still alive then and, on the card, the
        bytes allocated then."""
        import torch.distributed as dist

        from repro_torch.serving.server import _ShadowBuild

        if self.mesh is None or self.rank == 0:
            raise RuntimeError("follow() runs on the ranks after 0 of a device mesh")
        self._require_executable()
        held = {0: self}  # the generations rank 0 still holds
        pending = None  # the announced rebuild's share, not yet committed or dropped
        retired: list = []  # let-go shares whose threads were still running
        shares = weakref.WeakValueDictionary()  # every share built, while alive
        lookups = {"fused": 0, "plain": 0}
        live = 0
        overlap = bool(self.config.drift_options.get("overlap", False))

        def share(freqs, gen):
            shares[gen] = engine = self._shadow(freqs, gen)
            return engine

        def let_go():
            nonlocal pending
            if pending is not None:
                pending.step_fn = None
                retired.append(pending)
                pending = None

        def end():
            let_go()
            for build in retired:
                if build.ident is not None:
                    build.join(timeout=_END_WAIT_S)
                if not build.is_alive():
                    build.step_fn = None

        def report(build, wait_s) -> dict:
            if build.ident is not None:
                build.join(timeout=wait_s)
            if build.is_alive():
                return {"error": f"its share was still building {wait_s:.1f} s after rank 0's"}
            if build.error is not None:
                return {"error": repr(build.error)}
            return build.step_fn._build_report()

        def engine_of(gen):
            if gen in held:
                return held[gen]
            if pending is not None and pending.gen == gen and pending.step_fn is not None:
                return pending.step_fn  # joined: its integrity gate and parity probe
            raise RuntimeError(
                f"rank {self.rank} holds no generation {gen} (holds {sorted(held)}): "
                "the ranks' op streams disagree")

        try:
            while True:
                header = torch.empty(_HEADER, dtype=torch.int64, device=self.device)
                dist.broadcast(header, src=0)
                op, gen, executor, *shape = header.tolist()
                for build in [b for b in retired if not b.is_alive()]:
                    build.step_fn = None  # a let-go share that finished since
                    retired.remove(build)
                if op == _OP_STOP:
                    return sum(lookups.values())
                if op == _OP_LOOKUP:
                    eng = engine_of(gen)
                    idx = torch.empty(shape, dtype=torch.int32, device=self.device)
                    dist.broadcast(idx, src=0)
                    eng.bag.apply(eng.packed, idx, use_kernels="fused" if executor else False,
                                  reduce_mode=eng.config.reduce_mode, mesh=self.mesh)
                    lookups["fused" if executor else "plain"] += 1
                elif op == _OP_REPLAN:
                    let_go()
                    pending = _ShadowBuild(lambda freqs, g=gen: share(freqs, g), _recv_object())
                    pending.gen = gen
                    pending.start() if overlap else pending.run()
                elif op == _OP_JOIN:
                    if pending is None or pending.gen != gen:
                        raise RuntimeError(f"rank {self.rank} was not building generation {gen}")
                    rec = report(pending, shape[0] / 1e3)
                    _gather(rec)
                    if "error" in rec:
                        let_go()
                elif op == _OP_COMMIT:
                    held[gen] = engine_of(gen)
                    pending, live = None, gen
                elif op == _OP_DROP:
                    if pending is not None and pending.gen == gen:
                        let_go()
                    if gen:
                        held.pop(gen, None)
                elif op == _OP_VERIFY:
                    _gather(engine_of(gen)._verify_local())
                elif op == _OP_HEAL:
                    _gather(engine_of(gen)._heal_local())
                else:
                    raise RuntimeError(f"unknown op {op} from rank 0")
        finally:
            end()
            self.follow_stats = {
                "lookups": lookups, "generation": live, "held": sorted(held),
                "shares_alive": sorted(shares.keys()),
                "allocated": (torch.cuda.memory_allocated(self.device)
                              if self.device.type == "cuda" else None)}

    def close(self) -> None:
        """On rank 0 of a device mesh, end the other ranks' :meth:`follow`
        loops (once).  Nothing to do elsewhere."""
        if self._stream is None or self._stream.closed:
            return
        self._stream.closed = True
        self._stream.send(_OP_STOP)

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
        engine: microbatching behind ``submit_request(query) -> handle``,
        drift replanning per the config's drift policy.

        ``make_step(engine) -> step`` customizes what runs per batch (e.g.
        a full DLRM forward on ``engine.bag``/``engine.packed``); it is also
        how a drift hot-swap rebuilds: the policy calls ``make_step`` again
        on the re-planned engine.  Default: the scenario's tower step and
        split when the engine carries a scenario, else the pooled embedding
        lookup, with per-query results split as (N, E) slices.  Each step
        carries ``engine``, the engine it serves from.

        Robustness semantics come from the config: ``max_queue`` +
        ``admission`` bound the queue and ``deadline_s`` sheds stale
        requests.  On a CPU engine, when ``degrade_after > 0`` and the
        primary executor is the fused path, a fallback step built from
        ``make_step`` over :meth:`reference_view` serves batches in degraded
        mode after repeated failures.  A CUDA engine gets no such fallback:
        a batch whose kernels, integrity check or rebuild fail fails, and is
        counted, rather than being served by the plain version on the card.

        Data-plane integrity is wired per the config's
        ``validation``/``integrity`` policies: the validator runs at batch
        release, and with an integrity manifest the step carries
        ``integrity_verify``/``integrity_repair`` hooks the server's
        checksum cadence and NaN guard act through; a repair re-materializes
        the corrupt regions in place and swaps a freshly built step in.
        ``fault_injector`` threads a seeded
        :class:`repro_torch.serving.faults.FaultInjector` through the server
        and the replan path.

        On a device mesh the server runs on rank 0 only, and a step that
        looks up calls :meth:`broadcast_batch` first (the default step does,
        through :meth:`lookup`); the other ranks run :meth:`follow`.  A
        replan announces its rebuild to them, the server's swap point joins
        their shares (the step's ``join_ranks`` hook), and the integrity
        cadence, gate and heal run on every rank's slice; all of it is sent
        from the thread that pumps the server, which must be rank 0's main
        thread.
        """
        from repro_torch.serving.server import Server

        if self.mesh is not None:
            self._require_lead("the server")
        if make_step is None and self.scenario is not None:
            # the scenario's tower over the lookups, re-invoked on every
            # drift hot-swap and heal rebuild
            make_step = self.scenario.make_step
            if split_fn is None:
                split_fn = self.scenario.split
        maker = make_step or (lambda eng: eng._default_step())

        def _make_fallback(eng):
            if (
                eng.device.type == "cpu"
                and self.config.degrade_after > 0
                and self.config.use_kernels == "fused"
            ):
                return maker(eng.reference_view())
            return None

        def _wire(step, eng):
            """Attach the engine-side hooks the server's integrity machinery
            (and a drift hot-swap's shadow) act through.  Hooks bind to the
            step's OWN engine so they stay correct across swaps."""
            if getattr(step, "bag", None) is None:
                step.bag = eng.bag
            step.engine = eng
            step.rebuild = lambda: _wire(maker(eng), eng)
            if eng._across:
                # the server's swap point for a shadow built across ranks
                step.join_ranks = eng._join
            if eng.manifest is not None:
                step.integrity_verify = eng.verify_integrity

                def _repair(bad):
                    report = eng.heal()
                    return {
                        "step_fn": _wire(maker(eng), eng),
                        "fallback_step_fn": _make_fallback(eng),
                        "report": report,
                    }

                step.integrity_repair = _repair
            return step

        step0 = _wire(maker(self), self)
        fallback = server_kwargs.pop("fallback_step_fn", None)
        if fallback is None:
            fallback = _make_fallback(self)

        def _replan(measured):
            if fault_injector is not None:
                fault_injector.fire("replan", batch=None)
            shadow_engine = self.rebuild(measured)
            return _wire(maker(shadow_engine), shadow_engine)

        baseline = self.freqs
        if baseline is None:
            # drift needs something to diff against: the uniform assumption
            # the plan was implicitly priced under.
            from repro_torch.data.distributions import RowProbs

            baseline = [RowProbs.uniform(t.rows) for t in self.workload.tables]
        drift_cfg = DRIFT_POLICIES.create(self.config.drift).drift_config(
            baseline=baseline,
            extract_indices=lambda payloads: np.stack(
                [_payload_indices(q) for q in payloads], axis=1
            ),
            replan=_replan,
            **self.config.drift_options,
        )
        validator = VALIDATION_POLICIES.create(self.config.validation).validator(
            rows=[t.rows for t in self.workload.tables],
            **self.config.validation_options,
        )
        integrity_cfg = INTEGRITY_POLICIES.create(self.config.integrity).server_config(
            **self.config.integrity_options
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
            drift=drift_cfg,
            split_fn=split_fn or self._default_split,
            max_queue=self.config.max_queue,
            admission=self.config.admission,
            deadline_s=self.config.deadline_s,
            adaptive_batching=self.config.adaptive_batching,
            fallback_step_fn=fallback,
            degrade_after=self.config.degrade_after,
            probe_every=self.config.probe_every,
            validator=validator,
            integrity=integrity_cfg,
            fault_injector=fault_injector,
        )
        kwargs.update(server_kwargs)  # explicit kwargs override the config
        srv = Server(step0, **kwargs)
        self._server = srv
        if self._stream is not None:
            self._stream.server = srv  # its decisions end the swap points
        return srv

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Plan/layout/tuning/cache summary (+ live server stats if
        :meth:`serve` was called).  ``predicted_p99_us`` is the cost model's
        figure under the config's ``hardware`` preset, not a time measured
        on the card."""
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
        for key in ("cache", "tuning", "distribution", "kernel", "mesh"):
            if plan.meta.get(key) is not None:
                out[key] = plan.meta[key]
        mesh_meta = plan.meta.get("mesh") or {}
        out["mesh_shape"] = [
            int(mesh_meta.get("hosts", 1)),
            int(mesh_meta.get("cores_per_host", plan.n_cores)),
        ]
        if out["mesh_shape"][0] > 1:
            from repro_torch.core.traffic import modeled_cross_host_traffic

            xh = modeled_cross_host_traffic(
                plan, self.workload.tables, self.workload.batch, self.freqs
            )
            out["cross_host"] = {
                k: xh[k] for k in (
                    "cross_host_bytes", "flat_allgather_bytes",
                    "reduction_vs_flat", "bucket_entries", "unique_cap",
                )
            }
        if self.ranks is not None:
            out["ranks"] = self.ranks
        if self._server is not None:
            out["server"] = self._server.stats()
        return out

    def _placement_tree(self, kern: dict) -> list[str]:
        """Placement as a host → core → chunk tree with per-level modeled
        bytes: each chunk line carries its modeled lookup bytes, each core
        and host line the sum over its children, and on a multi-host mesh
        each host line adds the bytes its owner buckets put on the modeled
        cross-host tier (on one card, a host is a group of plan cores)."""
        from repro_torch.core.traffic import (
            modeled_cross_host_traffic,
            modeled_plan_traffic,
        )

        plan = self.plan
        tables, batch = self.workload.tables, self.workload.batch
        traffic = modeled_plan_traffic(plan, tables, batch, self.freqs)
        mesh_meta = plan.meta.get("mesh") or {}
        hosts = int(mesh_meta.get("hosts", 1))
        cph = int(mesh_meta.get("cores_per_host", plan.n_cores))
        xh = (
            modeled_cross_host_traffic(plan, tables, batch, self.freqs)
            if hosts > 1 else None
        )
        recs = list(zip(plan.assignments, kern["per_chunk"], traffic["per_chunk_bytes"]))
        lines: list[str] = []
        for h in range(hosts):
            host_recs = [r for r in recs if r[0].core // cph == h]
            host_line = (
                f"  host {h}: {len(host_recs)} chunks, "
                f"modeled lookup {sum(b for *_, b in host_recs):,}B"
            )
            if xh is not None:
                host_line += f", cross-host {xh['per_host_bytes'][h]:,.0f}B"
            lines.append(host_line)
            for core in sorted({r[0].core for r in host_recs}):
                core_recs = [r for r in host_recs if r[0].core == core]
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
        tuning = s.get("tuning")
        if tuning and tuning.get("best"):
            best = tuning["best"]
            lines.append(
                f"autotuned block_r={best['block_r']} "
                f"block_b={best['block_b'] or 'auto'} "
                f"({len(tuning['candidates'])} candidates, "
                f"backend={tuning['backend']})"
            )
        acc = s.get("cache")
        if acc:
            lines.append(
                f"access-reduction dedup={acc['dedup']} "
                f"unique_cap={acc['unique_cap']} cache_rows={acc['cache_rows']} "
                f"(modeled coverage={acc['coverage']:.2%})"
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
        xh = s.get("cross_host")
        if xh:
            h, c = s["mesh_shape"]
            lines.append(
                f"mesh {h}x{c} (hosts x cores/host): modeled cross-host "
                f"{xh['cross_host_bytes']:,.0f}B vs flat all-gather "
                f"{xh['flat_allgather_bytes']:,.0f}B "
                f"({xh['reduction_vs_flat']:.1f}x reduction, "
                f"{xh['bucket_entries']} bucket entries)"
            )
        if self.ranks is not None:
            r = self.ranks
            per = ", ".join(f"{b:,}" for b in r["chunk_bytes"])
            mod = r["rejoin_modeled"]
            lines.append(
                f"cards: {r['world']} ranks ({r['backend']}), one plan core each: "
                f"chunk bytes per rank [{per}] of {r['whole_chunk_bytes']:,} in all"
            )
            lines.append(
                f"rejoin modeled (core/traffic.py, per batch of {self.workload.batch}): "
                f"sparse all_to_all {mod['sparse_all_to_all_bytes']:,}B + all_gather "
                f"{mod['sparse_all_gather_bytes']:,}B, psum/ring {mod['psum_bytes']:,}B"
            )
        if self.config.drift != "none":
            lines.append(f"drift policy={self.config.drift} "
                         f"{self.config.drift_options}")
        if self.config.validation != "clip" or self.config.integrity != "none":
            regions = len(self.manifest.checksums) if self.manifest else 0
            where = " in this rank's slice" if self._across else ""
            lines.append(
                f"integrity validation={self.config.validation} "
                f"checksums={self.config.integrity}"
                + (f" ({regions} regions{where})" if regions else "")
            )
        return "\n".join(lines)
