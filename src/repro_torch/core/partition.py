"""Execution of a placement :class:`Plan` on one device or across cards
(paper §III-B).

The paper places table *chunks* on individual cores, subtracts the chunk
offset from the ids, clips them, and combines partial pools with atomic
inter-core accumulation.  Without a mesh a plan core is one partition of
the work on one device: ``K`` comes from the plan (``mesh_shape``), not
from the number of GPUs.  With a device mesh (``mesh=``, a
``torch.distributed`` ``DeviceMesh``) each plan core is its own rank's
program, as the reference's ``shard_map`` runs it: the rank holds its
core's slice (:meth:`PackedPlan.strip_core`) and the rejoin crosses the
ranks by real collectives.  The packed layout is the reference's, field
for field:

* the per-core chunk inventory is a *ragged packed buffer*
  ``(K, R_total+1, E)``: every core's chunks concatenated row-wise, each
  chunk region padded to a ``block_r`` multiple with at least one zero row,
  plus one shared trailing zero row, and int32 per-slot metadata;
* pack time emits the per-core **step schedule** (``step_slot``/
  ``step_base``/``step_block``/``step_strategy``): one step per ``block_r``
  rows of each chunk, grouped by strategy; the fused kernel
  (:func:`repro_torch.kernels.embedding_multi.multi_embedding_bag_ragged`)
  runs all K cores' schedules in ONE launch;
* the owner-sharded rejoin maps (``rejoin_*``) and the symmetric fallback
  group (``sym_*``) are built as in the reference;
* ``layout="dense"`` keeps the legacy stacked-slot layout instead:
  ``(K, S, R+1, E)`` with every slot padded to the largest chunk (plus one
  zero row), no step schedule, and its own kernel
  (:func:`repro_torch.kernels.embedding_multi.multi_embedding_bag_dense`).

The rejoins become device-local reductions of the per-core ``(N, B, E)``
partials that reproduce the reference's collectives: ``"sparse"`` sums each
table's partials at its owner bucket and gathers the buckets, ``"psum"``
sums over cores, ``"ring"`` accumulates in core 0's ring order.  On the
card the ``"sparse"`` rejoin of the fused kernels' partials is one kernel
(:func:`repro_torch.kernels.embedding_rejoin.slot_rejoin`) that joins the
per-slot partials straight into the output, in the plain path's order of
additions, from a schedule written at pack time.  The reference splits
the symmetric group's batch over the K cores (core ``c``
serves rows ``[c*B/K, (c+1)*B/K)``); side by side the K slices are the whole
batch, so here one launch per table serves the whole batch.  The port still
requires ``B % K == 0`` there, only so that it accepts the batches the
reference accepts: its computation does not need it.

Across cards (``mesh=``) the rejoins are the reference's collectives over
the ``axis`` dim: ``"sparse"`` is an ``all_to_all`` of each rank's rows of
the tables an owner holds, summed at the owner in sender order, then an
``all_gather`` of the owner buckets; ``"psum"`` an ``all_reduce``;
``"ring"`` K-1 send/receive steps to the next rank.  The symmetric group
runs on the rank's ``B/K`` slice of the batch and is ``all_gather``-ed
back.  ``batch_axes`` splits the batch over those dims and leaves the
output split, as the reference's ``out_specs`` do.

``use_kernels``: ``"fused"`` (default) runs the CUDA kernels (their plain
versions on CPU tensors); ``False`` is the plain gather path, the same math
without kernels.  The access-reduction knobs arm the fused kernel as in
the reference: ``unique_cap`` (batch dedup), ``cache_rows`` (the per-core
hot-row residency cache, carved by :func:`cache_plan_entries`) and
``kernel_path`` (the per-step one-hot or sparse gather of the dedup'd
rows); they need the ragged layout, as in the reference.

``plan.meta`` gets the reference's ``layout``, ``rejoin``,
``cache["packed"]`` and ``kernel["packed"]`` records, equal key for key.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cost_model import freq_of
from repro_torch.core.strategies import Plan, Strategy
from repro_torch.core.tables import TableSpec
from repro_torch.kernels.embedding_multi import (
    multi_embedding_bag_dense,
    multi_embedding_bag_dense_plain,
    multi_embedding_bag_ragged,
    ragged_runs,
    ragged_stage_rows,
)
from repro_torch.kernels.embedding_rejoin import rejoin_schedule, slot_rejoin
from repro_torch.kernels.ops import strategy_bag
from repro_torch.tracing import count, span

__all__ = [
    "COLLECTIVE_BYTES",
    "STRATEGY_CODE",
    "PackedPlan",
    "batch_share",
    "cache_plan_entries",
    "mesh_lookup_stages",
    "pack_plan",
    "partitioned_lookup",
    "ragged_block_r",
    "ragged_core_rows",
    "vocab_parallel_embed",
    "vocab_parallel_embed_shard",
]

STRATEGY_CODE: dict[Strategy, int] = {
    Strategy.GM: 0,
    Strategy.GM_UB: 1,
    Strategy.L1: 2,
    Strategy.L1_UB: 3,
}
_CODE_STRATEGY = {v: k for k, v in STRATEGY_CODE.items()}

_ROW_PAD = 8  # row padding of every chunk region and the symmetric tables
_RAGGED_BLOCK_R = 512  # row-block cap for the ragged fused-kernel schedule
_RAGGED_BLOCK_R_MIN = 64  # floor: bounds step count; wastes < 64 rows/chunk


@dataclasses.dataclass
class PackedPlan:
    """Tensor-ified Plan on one device, with the reference's field names.

    ``chunk_data`` is ``(K, R_total+1, E)`` with each core's chunks
    concatenated row-wise (``slot_row_start`` gives each slot's first row);
    the ``step_*`` arrays hold the fused kernel's per-core (slot, row-block,
    strategy) schedule.  Under ``layout="dense"`` it is ``(K, S, R+1, E)``
    and the schedule is empty.  The ``rejoin_*`` maps drive the owner-sharded
    sparse rejoin: ``rejoin_send[c, d]`` lists the tables core ``c`` sends
    to owner ``d``, ``rejoin_bucket[d]`` lists the tables core ``d`` owns,
    and ``rejoin_owned_pos[t]`` is table ``t``'s position in its owner's
    bucket.  Port-only: ``step_runs`` is the schedule collapsed into the
    fused kernel's per-slot runs, on the device, and ``stage_rows`` the
    kernel's shared-memory staging capacity; ``rejoin_ptr``/``rejoin_terms``
    are the whole pack's sparse rejoin written down as one join of the slot
    partials (:func:`repro_torch.kernels.embedding_rejoin.rejoin_schedule`,
    on the device; one rank's slice keeps them, and its executor does not
    read them); ``host`` holds numpy copies of
    the ``sym_*`` metadata, which the executor reads on the host, and, in
    one rank's slice, the ``fingerprint`` of the whole pack it came from.
    """

    # the reference's field lists: every array field, and the fields
    # replicated across the core axis (every other one is core-sharded)
    _ARRAY_FIELDS = (
        "chunk_data", "slot_table", "slot_offset", "slot_rows",
        "slot_row_start", "slot_strategy", "slot_rep", "slot_nrep",
        "step_slot", "step_base", "step_block", "step_strategy",
        "step_kpath",
        "rejoin_send", "rejoin_owned_pos", "rejoin_bucket",
        "sym_data", "sym_table", "sym_rows", "sym_strategy",
        "cache_data", "cache_remap",
    )
    _REPLICATED_FIELDS = (
        "rejoin_send", "rejoin_owned_pos", "rejoin_bucket",
        "sym_data", "sym_table", "sym_rows", "sym_strategy",
    )

    # asymmetric slots
    chunk_data: Any  # ragged: (K, R_total+1, E); dense: (K, S, R+1, E)
    slot_table: Any  # (K, S) int32, -1 = empty
    slot_offset: Any  # (K, S) int32 row offset within the source table
    slot_rows: Any  # (K, S) int32
    slot_row_start: Any  # (K, S) int32 first row in the ragged buffer
    slot_strategy: Any  # (K, S) int32
    slot_rep: Any  # (K, S) int32
    slot_nrep: Any  # (K, S) int32
    # fused-kernel step schedule (ragged layout only; (K, 0) otherwise)
    step_slot: Any  # (K, T) int32 slot id per step (S = trash slot)
    step_base: Any  # (K, T) int32 chunk-local first row of the step's block
    step_block: Any  # (K, T) int32 row-block index into the ragged buffer
    step_strategy: Any  # (K, T) int32 strategy code of the step's slot
    step_kpath: Any  # (K, T) int32 gather path per step (0 onehot, 1 sparse)
    # owner-sharded sparse rejoin maps
    rejoin_send: Any  # (K, K, n_send) int32 table ids, -1 = none
    rejoin_owned_pos: Any  # (N,) int32 bucket position at the owner, -1
    rejoin_bucket: Any  # (K, O) int32 owned table ids, -1 pad
    # symmetric fallback group
    sym_data: Any  # (Nsym, Msym+1, E)
    sym_table: Any  # (Nsym,) int32
    sym_rows: Any  # (Nsym,) int32
    sym_strategy: Any  # (Nsym,) int32
    # hot-row residency cache (zero-sized when off)
    cache_data: Any = None  # (K, C, E) per-core resident hot-row mini-table
    cache_remap: Any = None  # (K, T+1) int32 buffer row -> cache pos, -1 cold
    # static layout descriptors
    layout: str = "ragged"
    block_r: int = 0  # fused-kernel row-block size
    slot_window: int = 0  # largest per-slot block_r allocation (informational)
    block_b: int = 0  # the reference's resident batch rows; 0 = auto
    unique_cap: int = 0  # batch-dedup width per slot; 0 = dedup off
    cache_rows: int = 0  # padded residency-cache rows; 0 = cache off
    kernel_path: str = "onehot"  # resolved gather mode; "onehot" = no sparse
    # port-only: the fused kernel's inputs made once at pack time
    step_runs: Any = None  # (n_runs, 5) int32 (core, slot, first, n_steps, code)
    stage_rows: int = 0  # shared-memory rows for staging L1-coded regions
    rejoin_ptr: Any = None  # (N+1,) int32 first schedule term of each table
    rejoin_terms: Any = None  # (T,) int32 slot plane * 4 + end-of-sum flags
    # port-only: host-side copies the executor reads without a device sync
    host: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_cores(self) -> int:
        return self.chunk_data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.chunk_data.device

    @property
    def chunk_bytes(self) -> int:
        return self.chunk_data.numel() * self.chunk_data.element_size()

    def strip_core(self, core: int) -> "PackedPlan":
        """Core ``core``'s slice of every core-sharded field, the replicated
        fields as they are: what one rank of a device mesh holds (the
        reference's ``strip_core``).  The core axis stays, at size 1, as
        ``shard_map`` hands each program its block, so the executor serves
        the slice as it serves a whole pack; ``step_runs`` keeps that
        core's runs and ``stage_rows`` is sized to them."""
        if not 0 <= core < self.n_cores:
            raise IndexError(f"core {core} of a {self.n_cores}-core pack")
        sl = slice(core, core + 1)
        fields = {f: getattr(self, f)[sl] for f in self._ARRAY_FIELDS
                  if f not in self._REPLICATED_FIELDS}
        runs = self.step_runs[self.step_runs[:, 0] == core].clone()
        runs[:, 0] = 0
        row_bytes = self.chunk_data.shape[-1] * self.chunk_data.element_size()
        return dataclasses.replace(
            self, **fields, step_runs=runs,
            stage_rows=ragged_stage_rows(runs.cpu().numpy(), self.block_r, row_bytes),
        )

    def to(self, device) -> "PackedPlan":
        """The same pack with every tensor on ``device``."""
        dev = torch.device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dev) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def fingerprint(self) -> str:
        """A digest of every tensor and layout field: two packs with one
        fingerprint hold the same bytes."""
        h = hashlib.sha256()
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().contiguous()
                h.update(f"{f.name}{tuple(v.shape)}{v.dtype}".encode())
                if v.numel():
                    h.update(v.reshape(-1).view(torch.uint8).numpy())
            elif f.name != "host":
                h.update(f"{f.name}={v!r}".encode())
        return h.hexdigest()


def _align(n: int, mult: int) -> int:
    return int(-(-n // mult) * mult)


def _rejoin_maps(
    plan: Plan, n_tables: int, k: int, mesh_shape: tuple[int, int] | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Owner-sharded rejoin maps: (owner, bucket_table, owned_pos, send_table).

    Each asymmetric table is owned by the core holding most of its rows (ties
    break to the lowest core id); ``send_table[c, d]`` lists the tables core
    ``c`` holds partials for that core ``d`` owns (deduplicated — a core
    pre-sums all its slots of one table before sending).

    ``mesh_shape=(hosts, cores_per_host)`` with ``hosts > 1`` builds the
    two-level variant: each table gets one owner core *per host that holds
    rows of it* (a globally row-sharded rock appears in every host's
    buckets), every core sends only to its own host's owner, and a table's
    bucket position is chosen to be free in ALL of its owners' buckets, so
    ``owned_pos`` keeps the flat ``(N,)`` shape with one globally
    consistent position.  :func:`_sparse_rejoin` adds each owner's bucket
    into the output by table id, so it sums a multi-host table's per-host
    partials unchanged.  ``owner`` keeps one primary owner per table, for
    reporting only.  ``hosts == 1`` (or ``None``) is the single-level map.
    The maps equal the reference's, table and host order included.
    """
    rows_by: dict[tuple[int, int], int] = {}
    for a in plan.assignments:
        key = (a.table_idx, a.core)
        rows_by[key] = rows_by.get(key, 0) + a.rows
    hosts, cph = mesh_shape if mesh_shape is not None else (1, k)
    if hosts > 1:
        # owner per (table, holding host): the in-host core with most rows.
        host_owner: dict[tuple[int, int], int] = {}
        owners_of: dict[int, list[int]] = {}
        for ti in sorted({a.table_idx for a in plan.assignments}):
            by_host: dict[int, list[int]] = {}
            for (t, c) in rows_by:
                if t == ti:
                    by_host.setdefault(c // cph, []).append(c)
            owners_of[ti] = []
            for h in sorted(by_host):
                oc = min(by_host[h], key=lambda c: (-rows_by[(ti, c)], c))
                host_owner[(ti, h)] = oc
                owners_of[ti].append(oc)
        # one globally consistent bucket position per table: the smallest
        # position free in every one of its owners' buckets (greedy in
        # table order — deterministic, and N tables keep owned_pos (N,)).
        used: dict[int, set[int]] = {c: set() for c in range(k)}
        owner = -np.ones(n_tables, np.int32)
        owned_pos = -np.ones(n_tables, np.int32)
        for ti, ocs in owners_of.items():
            p = 0
            while any(p in used[c] for c in ocs):
                p += 1
            owned_pos[ti] = p
            for c in ocs:
                used[c].add(p)
            # primary owner (reporting only): the owner on the host with
            # the most rows of the table.
            owner[ti] = max(
                ocs,
                key=lambda c: (
                    sum(r for (t, cc), r in rows_by.items()
                        if t == ti and cc // cph == c // cph),
                    -c,
                ),
            )
        o_max = max(
            1, max((max(s) + 1 for s in used.values() if s), default=0)
        )
        bucket = -np.ones((k, o_max), np.int32)
        for ti, ocs in owners_of.items():
            for c in ocs:
                bucket[c, int(owned_pos[ti])] = ti
        send_sets: dict[tuple[int, int], set[int]] = {}
        for a in plan.assignments:
            d = host_owner[(a.table_idx, a.core // cph)]
            send_sets.setdefault((a.core, d), set()).add(a.table_idx)
    else:
        owner = -np.ones(n_tables, np.int32)
        for ti in {a.table_idx for a in plan.assignments}:
            cores = [c for (t, c) in rows_by if t == ti]
            owner[ti] = min(cores, key=lambda c: (-rows_by[(ti, c)], c))
        owned: dict[int, list[int]] = {c: [] for c in range(k)}
        for ti in range(n_tables):
            if owner[ti] >= 0:
                owned[int(owner[ti])].append(ti)
        o_max = max(1, max((len(v) for v in owned.values()), default=0))
        bucket = -np.ones((k, o_max), np.int32)
        owned_pos = -np.ones(n_tables, np.int32)
        for c, lst in owned.items():
            for p, ti in enumerate(lst):
                bucket[c, p] = ti
                owned_pos[ti] = p
        send_sets = {}
        for a in plan.assignments:
            send_sets.setdefault((a.core, int(owner[a.table_idx])), set()).add(
                a.table_idx
            )
    n_send = max([1] + [len(v) for v in send_sets.values()])
    send = -np.ones((k, k, n_send), np.int32)
    for (c, d), tis in send_sets.items():
        for q, ti in enumerate(sorted(tis)):
            send[c, d, q] = ti
    return owner, bucket, owned_pos, send


def _as_table(t, dtype: torch.dtype) -> torch.Tensor:
    """A (m, E) table given as a numpy array or tensor, on the CPU in ``dtype``."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    return t.detach().to("cpu", dtype)


def cache_plan_entries(
    plan: Plan,
    tables: Sequence[TableSpec],
    freqs,
    cache_rows: int,
) -> dict[int, list]:
    """Per-core residency-cache carve: the ``cache_rows`` rows of each core's
    **GM** chunk inventory with the highest expected hit count.

    Only GM chunks are candidates: GM is the one strategy that pays device
    memory per landing lookup, so it is the only place a resident hot row
    saves modeled (and real per-lookup) traffic.  Candidates are ranked by
    per-query expected hits ``p · seq / replicas`` with deterministic tie
    order (table, then row id), as the reference ranks them.  Returns
    ``{core: [(slot_index, assignment, global_row, weight), ...]}`` (at most
    ``cache_rows`` entries per core).  Shared by :func:`pack_plan` (contents)
    and :func:`repro_torch.core.traffic.modeled_plan_traffic` (hits).
    """
    out: dict[int, list] = {c: [] for c in range(plan.n_cores)}
    if not cache_rows or freqs is None:
        return out
    for core, assigns in plan.per_core().items():
        cand = []
        for s_i, a in enumerate(assigns):
            f = freq_of(freqs, a.table_idx)
            if f is None or a.strategy is not Strategy.GM:
                continue
            ids = np.asarray(f.ids, np.int64)
            probs = np.asarray(f.probs, np.float64)
            sel = (ids >= a.row_offset) & (ids < a.row_offset + a.rows)
            w = probs[sel] * tables[a.table_idx].seq / max(a.replicas, 1)
            for gid, ww in zip(ids[sel].tolist(), w.tolist()):
                cand.append((-ww, a.table_idx, gid, s_i))
        cand.sort()
        out[core] = [
            (s_i, assigns[s_i], gid, -nw)
            for nw, _, gid, s_i in cand[:cache_rows]
        ]
    return out


def ragged_block_r(plan: Plan, block_r: int | None = None) -> int:
    """The ragged layout's row-block size: ``block_r`` rounded up to the
    row padding, or by default sized off the smallest chunk (one step per
    block; the cap bounds a step, the floor the step count)."""
    min_rows = min((a.rows for a in plan.assignments), default=1)
    br = block_r or min(
        _RAGGED_BLOCK_R,
        max(_align(min_rows + 1, _ROW_PAD), _RAGGED_BLOCK_R_MIN),
    )
    return max(_align(br, _ROW_PAD), _ROW_PAD)


def ragged_core_rows(plan: Plan, block_r: int | None = None) -> list[int]:
    """Each core's rows in the ragged packed buffer, as :func:`pack_plan`
    lays them out (every chunk region a block multiple with at least one
    zero row after its data), without building it."""
    br = ragged_block_r(plan, block_r)
    per_core = plan.per_core()
    return [sum(_align(a.rows + 1, br) for a in per_core.get(c, []))
            for c in range(plan.n_cores)]


def pack_plan(
    plan: Plan,
    tables: Sequence[TableSpec],
    table_data: Sequence[Any] | None,
    *,
    dtype: torch.dtype = torch.float32,
    layout: str = "ragged",
    block_r: int | None = None,
    block_b: int | None = None,
    freqs=None,
    unique_cap: int | None = None,
    cache_rows: int | None = None,
    kernel_path: str | None = None,
    device: torch.device | str = "cpu",
    core: int | None = None,
) -> PackedPlan:
    """Materialize a Plan into the packed executor layout on ``device``.

    ``table_data[i]`` is the (m_i, E) table i (numpy array or tensor), or
    ``None`` for abstract packing (zeros; shape-only work).  The buffers are
    built on the host and moved to ``device`` once.  ``layout="ragged"``
    concatenates each core's chunks row-wise; ``layout="dense"`` pads every
    slot to the global ``max_rows`` (the legacy layout, kept for
    comparison).  ``block_r`` overrides the fused kernel's row-block size;
    ``block_b`` is recorded for ``plan.meta["layout"]`` parity.

    ``unique_cap``/``cache_rows`` arm the access reduction; ``None``
    resolves each from ``plan.meta["cache"]`` (the planner's selection).
    The cache carve needs the access histograms: pass the same ``freqs``
    the plan was priced under.  Ragged layout only, as is ``kernel_path``,
    which picks the dedup'd gather per
    step: ``"onehot"``, ``"sparse"`` (every step; needs ``unique_cap > 0``)
    or ``"auto"`` (per chunk from ``plan.meta["kernel"]["per_chunk"]``;
    without dedup every step stays one-hot); ``None`` resolves from
    ``plan.meta["kernel"]["path"]``, defaulting to ``"onehot"``.

    ``core`` puts only that core's slice on ``device``
    (:meth:`PackedPlan.strip_core`): one rank's share of a device mesh.
    The whole pack is built on the host all the same, and the slice's
    ``host["fingerprint"]`` is the whole pack's, for the ranks to compare.
    """
    rank_core = core  # the loops below reuse the name
    if layout not in ("ragged", "dense"):
        raise ValueError(f"unknown layout {layout!r}")
    access_meta = plan.meta.get("cache") or {}
    if unique_cap is None:
        unique_cap = int(access_meta.get("unique_cap") or 0)
    if cache_rows is None:
        cache_rows = int(access_meta.get("cache_rows") or 0)
    if cache_rows and freqs is None:
        raise ValueError(
            "cache_rows > 0 needs the access histograms (freqs) to carve "
            "the hot-row residency cache"
        )
    if layout == "dense" and (unique_cap or cache_rows):
        raise ValueError("dedup/cache require layout='ragged'")
    kernel_meta = plan.meta.get("kernel") or {}
    if kernel_path is None:
        kernel_path = kernel_meta.get("path") or "onehot"
    if kernel_path not in ("onehot", "sparse", "auto"):
        raise ValueError(f"unknown kernel_path {kernel_path!r}")
    if kernel_path == "sparse":
        if layout == "dense":
            raise ValueError("kernel_path='sparse' requires layout='ragged'")
        if not unique_cap:
            raise ValueError(
                "kernel_path='sparse' requires batch dedup (unique_cap > 0): "
                "the sparse gather rides the dedup uniq/cnt machinery"
            )
    # per-assignment gather path (parallel to plan.assignments; per_core()
    # returns the same objects)
    path_of: dict[int, str] = {}
    if kernel_path == "sparse":
        path_of = {id(a): "sparse" for a in plan.assignments}
    elif kernel_path == "auto" and unique_cap:
        per_chunk = kernel_meta.get("per_chunk") or []
        if len(per_chunk) == len(plan.assignments):
            path_of = {
                id(a): rec.get("path", "onehot")
                for a, rec in zip(plan.assignments, per_chunk)
            }
    e = tables[0].dim
    if any(t.dim != e for t in tables):
        raise ValueError("all tables must share the embedding dim E")
    k = plan.n_cores
    per_core = plan.per_core()
    max_slots = max((len(v) for v in per_core.values()), default=0)
    max_slots = max(max_slots, 1)
    max_rows = max((a.rows for a in plan.assignments), default=1)
    max_rows_pad = _align(max_rows, _ROW_PAD)
    loaded: dict[int, torch.Tensor] = {}

    def tbl(i):
        if i not in loaded:
            loaded[i] = (
                torch.zeros((tables[i].rows, e), dtype=dtype)
                if table_data is None else _as_table(table_data[i], dtype)
            )
        return loaded[i]

    slot_table = -np.ones((k, max_slots), np.int32)
    slot_offset = np.zeros((k, max_slots), np.int32)
    slot_rows = np.zeros((k, max_slots), np.int32)
    slot_row_start = np.zeros((k, max_slots), np.int32)
    slot_strategy = np.zeros((k, max_slots), np.int32)
    slot_rep = np.zeros((k, max_slots), np.int32)
    slot_nrep = np.ones((k, max_slots), np.int32)

    for core in range(k):
        for s_i, a in enumerate(per_core.get(core, [])):
            slot_table[core, s_i] = a.table_idx
            slot_offset[core, s_i] = a.row_offset
            slot_rows[core, s_i] = a.rows
            slot_strategy[core, s_i] = STRATEGY_CODE[a.strategy]
            slot_rep[core, s_i] = a.batch_frac[0]
            slot_nrep[core, s_i] = a.batch_frac[1]
            if a.row_offset + a.rows > tables[a.table_idx].rows:
                raise ValueError("chunk exceeds table rows")

    itemsize = torch.empty((), dtype=dtype).element_size()
    dense_bytes = k * max_slots * (max_rows_pad + 1) * e * itemsize

    if layout == "dense":
        # every slot padded to the global max rows plus one zero row (the
        # redirect target of invalid ids); empty slots stay all zeros.  One
        # (K, S, R+1, E) tensor filled in place: padding and stacking per
        # slot would hold the whole buffer twice on the host.
        buf = torch.zeros((k, max_slots, max_rows_pad + 1, e), dtype=dtype)
        for core in range(k):
            for s_i, a in enumerate(per_core.get(core, [])):
                buf[core, s_i, : a.rows] = tbl(a.table_idx)[
                    a.row_offset : a.row_offset + a.rows
                ]
        steps: list[list[tuple[int, int, int, int, int]]] = [[] for _ in range(k)]
        br = slot_window = 0
        cache_buf = torch.zeros((k, 0, e), dtype=dtype)
        remap_np = np.zeros((k, 1), np.int32)
    else:
        # ragged: per core, concatenate chunks row-wise; each chunk's region
        # is padded to a block_r multiple (>= 1 zero row after the data, the
        # slot's redirect target), so the fused kernel's row-blocks tile it.
        # block_r is sized off the SMALLEST real chunk.
        br = ragged_block_r(plan, block_r)
        # per-strategy step schedule: slots grouped by strategy code (then
        # ascending size) so every strategy's steps form one contiguous run.
        core_order: dict[int, list[int]] = {
            core: sorted(
                range(len(per_core.get(core, []))),
                key=lambda s_i: (
                    STRATEGY_CODE[per_core[core][s_i].strategy],
                    per_core[core][s_i].rows,
                    s_i,
                ),
            )
            for core in range(k)
        }
        steps = []
        slot_window = br
        t_needed = br
        for core in range(k):
            cur = 0
            core_steps: list[tuple[int, int, int, int, int]] = []
            for s_i in core_order[core]:
                a = per_core[core][s_i]
                alloc = _align(a.rows + 1, br)
                slot_row_start[core, s_i] = cur
                code = STRATEGY_CODE[a.strategy]
                kp = 1 if path_of.get(id(a)) == "sparse" else 0
                for j in range(alloc // br):
                    core_steps.append((s_i, j * br, cur // br + j, code, kp))
                cur += alloc
                slot_window = max(slot_window, alloc)
            steps.append(core_steps)
            t_needed = max(t_needed, cur)
        t_pad = _align(t_needed, br)

        buf = torch.zeros((k, t_pad + 1, e), dtype=dtype)
        for core in range(k):
            for s_i, a in enumerate(per_core.get(core, [])):
                start = int(slot_row_start[core, s_i])
                buf[core, start : start + a.rows] = tbl(a.table_idx)[
                    a.row_offset : a.row_offset + a.rows
                ]

        if cache_rows:
            # residency-cache carve: each core's top-mass GM rows go into
            # the mini-table and the buffer-row remap points at them; clamp to
            # the realized carve so no zero rows are allocated
            entries = cache_plan_entries(plan, tables, freqs, cache_rows)
            cache_rows = min(cache_rows, max((len(v) for v in entries.values()), default=0))
        if cache_rows:
            cache_pad = _align(cache_rows, _ROW_PAD)
            cache_buf = torch.zeros((k, cache_pad, e), dtype=dtype)
            remap_np = -np.ones((k, t_pad + 1), np.int32)
            for core in range(k):
                for p, (s_i, a, gid, _w) in enumerate(entries[core]):
                    remap_np[core, int(slot_row_start[core, s_i]) + gid - a.row_offset] = p
                    cache_buf[core, p] = tbl(a.table_idx)[gid]
            cache_rows = cache_pad
            plan.meta.setdefault("cache", {})["packed"] = {
                "cache_rows": int(cache_pad),
                "rows_per_core": [len(entries[c]) for c in range(k)],
            }
        else:
            cache_buf = torch.zeros((k, 0, e), dtype=dtype)
            remap_np = np.zeros((k, t_pad + 1), np.int32)
            if plan.meta.get("cache", {}).get("cache_rows"):
                # requested but nothing carvable: record the empty carve
                plan.meta["cache"]["packed"] = {"cache_rows": 0, "rows_per_core": [0] * k}

    # uniform step count across cores; padding steps target the trash slot
    # (id = max_slots) with base 0.
    n_steps = max((len(s) for s in steps), default=0)
    n_pad_steps = sum(n_steps - len(s) for s in steps)
    step_slot = np.full((k, n_steps), max_slots, np.int32)
    step_base = np.zeros((k, n_steps), np.int32)
    step_block = np.zeros((k, n_steps), np.int32)
    step_strategy = np.zeros((k, n_steps), np.int32)
    step_kpath = np.zeros((k, n_steps), np.int32)
    for core, core_steps in enumerate(steps):
        for t, (s_i, base, blk, code, kp) in enumerate(core_steps):
            step_slot[core, t] = s_i
            step_base[core, t] = base
            step_block[core, t] = blk
            step_strategy[core, t] = code
            step_kpath[core, t] = kp

    mesh_meta = plan.meta.get("mesh") or {}
    mesh_shape = (
        int(mesh_meta.get("hosts", 1)),
        int(mesh_meta.get("cores_per_host", k)),
    )
    _, rejoin_bucket, rejoin_owned_pos, rejoin_send = _rejoin_maps(
        plan, len(tables), k, mesh_shape=mesh_shape
    )

    ragged_bytes = buf.numel() * itemsize
    plan.meta["layout"] = {
        "kind": layout,
        "chunk_bytes": ragged_bytes,
        "dense_bytes": dense_bytes,
        "bytes_vs_dense": ragged_bytes / max(dense_bytes, 1),
        "block_r": br,
        "block_b": int(block_b or 0),
        "slot_window": slot_window,
        "n_steps": int(step_slot.shape[1]),
        "n_padding_steps": int(n_pad_steps),
        "padding_frac": 1.0
        - sum(a.rows for a in plan.assignments)
        * e * itemsize / max(ragged_bytes, 1),
    }
    cph = mesh_shape[1]
    plan.meta["rejoin"] = {
        "n_owned_max": int(rejoin_bucket.shape[1]),
        "n_send_max": int(rejoin_send.shape[2]),
        "owned_per_core": [
            int((rejoin_bucket[c] >= 0).sum()) for c in range(k)
        ],
        "hosts": mesh_shape[0],
        "cross_host_sends": sum(
            int((rejoin_send[c, d] >= 0).sum())
            for c in range(k)
            for d in range(k)
            if c // cph != d // cph
        ),
    }
    # a pack with no sparse step resolves to plain "onehot"
    n_sparse_steps = int((step_kpath == 1).sum())
    kernel_resolved = kernel_path if n_sparse_steps else "onehot"
    n_sparse_chunks = sum(1 for a in plan.assignments if path_of.get(id(a)) == "sparse")
    plan.meta.setdefault("kernel", {})["packed"] = {
        "path": kernel_resolved,
        "sparse_chunks": n_sparse_chunks,
        "onehot_chunks": len(plan.assignments) - n_sparse_chunks,
        "sparse_steps": n_sparse_steps,
    }

    # symmetric group: every table padded to the largest one (+1 zero row)
    sym_idx = list(plan.symmetric_tables)
    if sym_idx:
        msym = _align(max(tables[i].rows for i in sym_idx), _ROW_PAD)
        sym_data = torch.zeros((len(sym_idx), msym + 1, e), dtype=dtype)
        for j, i in enumerate(sym_idx):
            sym_data[j, : tables[i].rows] = tbl(i)
        sym_table = np.array(sym_idx, np.int32)
        sym_rows = np.array([tables[i].rows for i in sym_idx], np.int32)
        sym_strategy = np.array(
            [STRATEGY_CODE[s] for s in plan.symmetric_strategies], np.int32
        )
    else:
        sym_data = torch.zeros((0, 1, e), dtype=dtype)
        sym_table = np.zeros((0,), np.int32)
        sym_rows = np.zeros((0,), np.int32)
        sym_strategy = np.zeros((0,), np.int32)

    ints = {
        "slot_table": slot_table, "slot_offset": slot_offset,
        "slot_rows": slot_rows, "slot_row_start": slot_row_start,
        "slot_strategy": slot_strategy, "slot_rep": slot_rep,
        "slot_nrep": slot_nrep,
        "step_slot": step_slot, "step_base": step_base,
        "step_block": step_block, "step_strategy": step_strategy,
        "step_kpath": step_kpath,
        "rejoin_send": rejoin_send, "rejoin_owned_pos": rejoin_owned_pos,
        "rejoin_bucket": rejoin_bucket,
        "sym_table": sym_table, "sym_rows": sym_rows,
        "sym_strategy": sym_strategy,
        "cache_remap": remap_np,
    }
    tensors = {name: torch.as_tensor(arr) for name, arr in ints.items()}
    runs = ragged_runs(step_slot, step_base, step_strategy, br, max_slots)
    rejoin_ptr, rejoin_terms = rejoin_schedule(
        slot_table, rejoin_send, rejoin_owned_pos, rejoin_bucket, len(tables))
    host = {
        "sym_table": sym_table, "sym_rows": sym_rows, "sym_strategy": sym_strategy,
    }
    packed = PackedPlan(
        chunk_data=buf,
        sym_data=sym_data,
        cache_data=cache_buf,
        layout=layout,
        block_r=br,
        slot_window=slot_window,
        block_b=int(block_b or 0),
        unique_cap=int(unique_cap),
        cache_rows=int(cache_rows),
        kernel_path=kernel_resolved,
        step_runs=torch.as_tensor(runs),
        stage_rows=ragged_stage_rows(runs, br, e * itemsize),
        rejoin_ptr=torch.as_tensor(rejoin_ptr),
        rejoin_terms=torch.as_tensor(rejoin_terms),
        host=host,
        **tensors,
    )
    if rank_core is not None:
        host["fingerprint"] = packed.fingerprint()
        packed = packed.strip_core(rank_core)
    return packed.to(device)


# --------------------------------------------------------------------------
# strategy dispatch on one table (symmetric group)
# --------------------------------------------------------------------------


def _bag_with_strategy(
    chunk: torch.Tensor, lidx: torch.Tensor, strategy_code: int, use_kernels
) -> torch.Tensor:
    """(R+1, E) chunk x (B, s) pre-clipped local ids -> (B, E) f32."""
    if use_kernels is False:
        # plain gather path: identical math; strategies only differ in timing.
        return chunk[lidx.long()].float().sum(dim=1)
    return strategy_bag(chunk, lidx, _CODE_STRATEGY[int(strategy_code)])


# --------------------------------------------------------------------------
# per-core sweeps (all K cores at once; leading core axis)
# --------------------------------------------------------------------------


def _replica_bmask(packed: PackedPlan, b: int) -> torch.Tensor:
    """(K, S, B) bool: which batch rows each slot's replica serves."""
    bpos = torch.arange(b, dtype=torch.int64, device=packed.device)
    nrep = packed.slot_nrep.long()[..., None]
    rep = packed.slot_rep.long()[..., None]
    return (bpos * nrep) // b == rep


def _slot_indices(packed: PackedPlan, indices: torch.Tensor):
    """Chunk-local ids of every slot: ``(local, valid)``, both (K, S, B, s).
    Counts ``slot_id_entries``."""
    b = indices.shape[1]
    ti = packed.slot_table.long()
    idx = indices.long()[ti.clamp(min=0)]  # (K, S, B, s)
    count("slot_id_entries", idx.numel())
    local = idx - packed.slot_offset.long()[..., None, None]
    valid = (
        (idx >= 0)
        & (local >= 0)
        & (local < packed.slot_rows.long()[..., None, None])
        & (ti >= 0)[..., None, None]
        & _replica_bmask(packed, b)[..., None]
    )
    return local, valid


def _scatter_slots(packed: PackedPlan, pooled: torch.Tensor, n_tables: int) -> torch.Tensor:
    """(K, S, B, E) per-slot partials -> (K, N, B, E) per-table partials.
    One add per slot index, each onto distinct (core, table) rows, so the
    sum order is fixed.  The first stage of the plain join: the card's
    sparse path does not come here (:func:`partitioned_lookup` joins its
    slot partials with :func:`slot_rejoin`, held bitwise to this stage and
    :func:`_sparse_rejoin` after it); the CPU, the ``psum`` and ``ring``
    rejoins, the mesh path and partials that carry a gradient do."""
    k, s_slots, b, e = pooled.shape
    with span("lookup.scatter"):
        out = pooled.new_zeros((k * n_tables + 1, b, e))
        ti = packed.slot_table.long()
        cores = torch.arange(k, device=pooled.device)
        target = torch.where(ti >= 0, cores[:, None] * n_tables + ti, k * n_tables)
        for s_i in range(s_slots):
            out.index_add_(0, target[:, s_i], pooled[:, s_i])
        return out[:-1].view(k, n_tables, b, e)


def _local_asym_lookup(
    packed: PackedPlan, indices: torch.Tensor, *, n_tables: int, use_kernels
) -> torch.Tensor:
    """indices (N, B, s) -> per-core partials (K, N, B, E) f32 (pre-rejoin)."""
    return _scatter_slots(packed, _slot_partials(packed, indices, use_kernels=use_kernels),
                          n_tables)


def _slot_partials(packed: PackedPlan, indices: torch.Tensor, *, use_kernels) -> torch.Tensor:
    """indices (N, B, s) -> per-slot partials (K, S, B, E) f32.

    ``use_kernels``: ``"fused"`` = the layout's fused kernel over all cores
    in one launch; ``False`` = the plain gather path.
    """
    if use_kernels == "fused":
        return _fused_slot_partials(packed, indices)
    if packed.layout == "dense":
        return _dense_slot_partials(packed, indices)
    buffer = packed.chunk_data  # (K, T+1, E)
    with span("lookup.slot_ids"):
        local, valid = _slot_indices(packed, indices)
        zrow = buffer.shape[1] - 1  # shared trailing zero row
        start = packed.slot_row_start.long()[..., None, None]
        gidx = torch.where(valid, start + local, zrow)  # (K, S, B, s)
    with span("lookup.access"):
        cores = torch.arange(packed.n_cores, device=buffer.device)[:, None, None, None]
        return buffer[cores, gidx].float().sum(dim=3)  # (K, S, B, E)


def _dense_ids(packed: PackedPlan, indices: torch.Tensor) -> torch.Tensor:
    """Dense-layout slot ids (K, S, B, s): chunk-local ids, invalid lookups
    redirected to each slot's trailing zero row ``R``."""
    with span("lookup.slot_ids"):
        local, valid = _slot_indices(packed, indices)
        rpad = packed.chunk_data.shape[-2] - 1
        return torch.where(valid, local, rpad)


def _dense_slot_partials(packed: PackedPlan, indices: torch.Tensor) -> torch.Tensor:
    """The plain stacked-slot gather over (K, S, R+1, E) -> (K, S, B, E)."""
    ids = _dense_ids(packed, indices)
    with span("lookup.access"):
        return multi_embedding_bag_dense_plain(packed.chunk_data, ids)


def _fused_ids(packed: PackedPlan, indices: torch.Tensor):
    """The fused kernel's id inputs: ``(lidx, hidx)``, both (K, S, B, s)
    int32.  ``lidx`` holds chunk-local ids with ``-1`` for invalid lookups;
    with the residency cache, lookups of cache-resident rows leave it
    (``-1``) and arrive in ``hidx`` as cache positions (else ``hidx`` is
    ``None``).  The split comes before any dedup, as in the reference.
    Counts ``lookups`` and ``cache_hits``."""
    with span("lookup.slot_ids"):
        local, valid = _slot_indices(packed, indices)
        count("lookups", valid)
        # -1 sentinel: matches no row-block window in the kernel
        lidx = torch.where(valid, local, -1).to(torch.int32)
        if not packed.cache_rows:
            return lidx, None
        # the remap's trailing entry (the shared zero row) is -1
        trash = packed.cache_remap.shape[-1] - 1
        g = torch.where(valid, packed.slot_row_start.long()[..., None, None] + local, trash)
        cores = torch.arange(packed.n_cores, device=packed.device)[:, None, None, None]
        hidx = packed.cache_remap[cores, g]
        count("cache_hits", hidx)
        return torch.where(hidx >= 0, -1, lidx), hidx


def _fused_slot_partials(packed: PackedPlan, indices: torch.Tensor) -> torch.Tensor:
    """One fused-kernel launch for every slot of every core -> (K, S, B, E)."""
    k, s_slots = packed.slot_table.shape
    b = indices.shape[1]
    e = packed.chunk_data.shape[-1]
    if packed.layout == "dense":
        lidx = _dense_ids(packed, indices).to(torch.int32)
        with span("lookup.access"):
            pooled = multi_embedding_bag_dense(packed.chunk_data, lidx)
    elif packed.step_slot.shape[-1] == 0:
        pooled = torch.zeros((k, s_slots, b, e), dtype=torch.float32, device=packed.device)
    else:
        lidx, hidx = _fused_ids(packed, indices)
        with span("lookup.access"):
            pooled = multi_embedding_bag_ragged(
                packed.chunk_data[:, :-1],  # drop the shared zero row: block_r-tiled
                lidx,
                packed.step_block,
                packed.step_runs,
                block_r=packed.block_r,
                stage_rows=packed.stage_rows,
                unique_cap=packed.unique_cap,
                cache=packed.cache_data if hidx is not None else None,
                hidx=hidx,
                # an all-onehot pack passes no selector at all
                step_kpath=packed.step_kpath if packed.kernel_path != "onehot" else None,
                step_slot=packed.step_slot,
                step_base=packed.step_base,
            )
    return pooled


def _local_sym_lookup(
    packed: PackedPlan, idx: torch.Tensor, *, n_tables: int, use_kernels
) -> torch.Tensor:
    """Symmetric fallback: idx (N, B', s) -> (N, B', E) f32.

    Each table goes to its strategy kernel as its own rows plus one zero
    row, ``sym_data[i, :rows+1]``, with invalid ids redirected to that zero
    row (row ``rows``): the reference redirects to the zero row of the
    table padded to the largest symmetric table, which holds the same zero,
    so the result is unchanged while a UB sweep reads ``rows+1`` rows
    instead of the largest table's."""
    _, bl, _ = idx.shape
    e = packed.sym_data.shape[-1]
    out = torch.zeros((n_tables, bl, e), dtype=torch.float32, device=idx.device)
    for i, (ti, rows, code) in enumerate(zip(
        packed.host["sym_table"].tolist(),
        packed.host["sym_rows"].tolist(),
        packed.host["sym_strategy"].tolist(),
    )):
        ids = idx[ti]
        valid = (ids >= 0) & (ids < rows)
        lidx = torch.where(valid, ids, rows).to(torch.int32)
        out[ti] += _bag_with_strategy(
            packed.sym_data[i, : rows + 1], lidx, code, use_kernels
        )
    return out


# --------------------------------------------------------------------------
# inter-core rejoin (device-local, without a mesh)
# --------------------------------------------------------------------------


def _sparse_rejoin(local: torch.Tensor, packed: PackedPlan) -> torch.Tensor:
    """Owner-sharded rejoin of the per-core partials ``local`` (K, N, B, E).

    Reproduces the reference's ``all_to_all`` + ``all_gather``: each core's
    partial rows of the tables an owner holds land in that owner's bucket
    (summed in sender order), and the buckets are gathered back into the
    (N, B, E) output, in bucket row order.  Tables held by no core come out
    zero.  The plain path's rejoin, after :func:`_scatter_slots`, and the
    reference that :func:`slot_rejoin` (the card's sparse path, which does
    not come here) is held to bitwise.  On the card, where several owners
    hold one table (two-level maps), the last ``index_add_`` sums them in
    no fixed order; :func:`slot_rejoin` and the CPU sum them in bucket row
    order."""
    k, n_tables, b, e = local.shape
    send = packed.rejoin_send.long()  # (K, K, n_send)
    o = packed.rejoin_bucket.shape[1]
    pos = packed.rejoin_owned_pos.long()[send.clamp(min=0)]
    pos = torch.where(send >= 0, pos, o)  # trash bucket for -1 padding
    owners = torch.arange(k, device=local.device)[:, None]
    owned = local.new_zeros((k * (o + 1), b, e))
    for c in range(k):
        x = local[c][send[c].clamp(min=0)]  # (K, n_send, B, E)
        x = torch.where((send[c] >= 0)[..., None, None], x, 0.0)
        owned.index_add_(0, (owners * (o + 1) + pos[c]).reshape(-1), x.reshape(-1, b, e))
    owned = owned.view(k, o + 1, b, e)[:, :o].reshape(k * o, b, e)
    bucket = packed.rejoin_bucket.long().reshape(-1)
    out = local.new_zeros((n_tables + 1, b, e))
    out.index_add_(0, torch.where(bucket >= 0, bucket, n_tables), owned)
    return out[:n_tables]


def _ring_psum(local: torch.Tensor) -> torch.Tensor:
    """Ring accumulation as core 0 sees it: its own partial, then core
    K-1's, K-2's, ... (each ring step forwards the previous core's buffer)."""
    k = local.shape[0]
    acc = local[0].clone()
    for t in range(1, k):
        acc += local[(k - t) % k]
    return acc


# --------------------------------------------------------------------------
# rejoin across the ranks of a device mesh (one plan core per rank)
# --------------------------------------------------------------------------

# payload bytes the ranks of the rejoin's axis handed to each collective,
# summed over the ranks and counting only what goes to another rank; every
# rank sends the same shapes, so each rank counts the group's total.  The
# all_reduce entry counts its input on every rank (its bytes on the wire
# are the collective library's choice).  Read and reset by the caller.
COLLECTIVE_BYTES: dict[str, int] = {}


def _count(op: str, nbytes: int) -> None:
    COLLECTIVE_BYTES[op] = COLLECTIVE_BYTES.get(op, 0) + int(nbytes)


def _mesh_sparse_rejoin(local: torch.Tensor, packed: PackedPlan, group,
                        me: int, k: int) -> torch.Tensor:
    """The reference's ``_sparse_rejoin`` across ranks: ``local`` is this
    rank's (N, B, E) partial.  Each rank sends every owner its rows of the
    tables that owner holds (``all_to_all``), the owner sums what arrives
    in sender order into its bucket, and an ``all_gather`` of the buckets
    gives every rank the (N, B, E) output."""
    from repro_torch.launch.mesh import all_gather_cat

    n_tables, b, e = local.shape
    send = packed.rejoin_send.long()  # (K, K, n_send), replicated
    o = packed.rejoin_bucket.shape[1]
    mine = send[me]  # (K, n_send): what this rank sends each owner
    x = local[mine.clamp(min=0)]
    x = torch.where((mine >= 0)[..., None, None], x, 0.0).contiguous()
    arrived = torch.empty_like(x)
    dist.all_to_all_single(arrived, x, group=group)
    _count("all_to_all", x.nbytes * (k - 1))
    recv = send[:, me]  # (K, n_send): what each sender sent this owner
    pos = packed.rejoin_owned_pos.long()[recv.clamp(min=0)]
    pos = torch.where(recv >= 0, pos, o)  # trash bucket for -1 padding
    owned = local.new_zeros((o + 1, b, e))
    owned.index_add_(0, pos.reshape(-1), arrived.view(-1, b, e))
    owned = owned[:o]
    gathered = all_gather_cat(owned, group)
    _count("all_gather", owned.nbytes * k * (k - 1))
    bucket = packed.rejoin_bucket.long().reshape(-1)
    out = local.new_zeros((n_tables + 1, b, e))
    out.index_add_(0, torch.where(bucket >= 0, bucket, n_tables), gathered)
    return out[:n_tables]


def _mesh_ring(local: torch.Tensor, group, me: int, k: int) -> torch.Tensor:
    """The reference's ``_ring_psum``: K-1 steps, each sending the buffer
    to the next rank and adding the one from the previous rank, so rank
    ``r`` sums its own partial, then rank r-1's, r-2's, ...  (rank 0's
    order is the one-card ``_ring_psum``'s)."""
    acc, buf = local.clone(), local
    nxt = dist.get_global_rank(group, (me + 1) % k)
    prv = dist.get_global_rank(group, (me - 1) % k)
    for _ in range(k - 1):
        new = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, nxt, group),
               dist.P2POp(dist.irecv, new, prv, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        _count("send", buf.nbytes * k)
        buf = new
        acc += buf
    return acc


def _mesh_rejoin(local: torch.Tensor, packed: PackedPlan, reduce_mode: str, group,
                 me: int, k: int) -> torch.Tensor:
    """This rank's (N, B, E) partial -> the (N, B, E) rejoined output,
    through the collectives of ``reduce_mode`` over ``group`` (``me`` is
    this rank's place in it, ``k`` its size)."""
    if reduce_mode == "sparse":
        return _mesh_sparse_rejoin(local, packed, group, me, k)
    if reduce_mode == "ring":
        return _mesh_ring(local, group, me, k)
    out = local.clone()
    dist.all_reduce(out, group=group)
    _count("all_reduce", out.nbytes * k)
    return out


def _mesh_sym(packed: PackedPlan, idx: torch.Tensor, group, me: int, k: int, *,
              n_tables: int, use_kernels) -> torch.Tensor:
    """The symmetric group on this rank's ``B/K`` slice of the batch,
    ``all_gather``-ed back along the batch -> (N, B, E)."""
    b = idx.shape[1]
    if b % k:
        raise ValueError(
            f"the symmetric group splits the batch over the {k} cores: "
            f"batch {b} must be a multiple of {k}"
        )
    from repro_torch.launch.mesh import all_gather_cat

    bl = b // k
    sym = _local_sym_lookup(packed, idx[:, me * bl:(me + 1) * bl], n_tables=n_tables,
                            use_kernels=use_kernels)
    gathered = all_gather_cat(sym, group)
    _count("all_gather_sym", sym.nbytes * k * (k - 1))
    return gathered.view(k, n_tables, bl, -1).permute(1, 0, 2, 3).reshape(n_tables, b, -1)


def batch_share(x: torch.Tensor, mesh, batch_axes, dim: int = 1) -> torch.Tensor:
    """This rank's share of ``x``'s batch dim ``dim`` over the
    ``batch_axes`` dims of ``mesh`` (the first axis the slowest), as the
    reference's ``PartitionSpec`` splits it."""
    from repro_torch.launch.mesh import axis_rank, axis_size

    parts, pos = 1, 0
    for ax in batch_axes:
        parts, pos = parts * axis_size(mesh, ax), pos * axis_size(mesh, ax) + axis_rank(mesh, ax)
    b = x.shape[dim]
    if b % parts:
        raise ValueError(f"batch {b} does not split over {parts} ranks of {batch_axes}")
    return x.narrow(dim, pos * (b // parts), b // parts)


def _mesh_context(packed, indices, mesh, axis, batch_axes):
    """(this rank's share of the indices, the ``axis`` group, this rank's
    place along it, its size), after checking that ``packed`` is one
    core's slice of a plan of that many cores."""
    from repro_torch.core.mesh import MeshShapeError
    from repro_torch.launch.mesh import axis_rank, axis_size

    k, me = axis_size(mesh, axis), axis_rank(mesh, axis)
    if packed.n_cores != 1 or packed.rejoin_send.shape[0] != k:
        raise MeshShapeError(
            f"a rank of the {k}-rank {axis!r} axis runs one core's slice of a "
            f"{k}-core plan; got {packed.n_cores} core(s) of a "
            f"{packed.rejoin_send.shape[0]}-core plan (pack with core=rank)"
        )
    if batch_axes:
        indices = batch_share(indices, mesh, batch_axes)
    return indices, mesh.get_group(axis), me, k


def _mesh_lookup(packed, indices, *, mesh, axis, batch_axes, n_tables, use_kernels,
                 reduce_mode) -> torch.Tensor:
    indices, group, me, k = _mesh_context(packed, indices, mesh, axis, batch_axes)
    local = _local_asym_lookup(packed, indices, n_tables=n_tables, use_kernels=use_kernels)
    out = _mesh_rejoin(local[0], packed, reduce_mode, group, me, k)
    if packed.sym_data.shape[0]:
        out = out + _mesh_sym(packed, indices, group, me, k, n_tables=n_tables,
                              use_kernels=use_kernels)
    return out


def mesh_lookup_stages(
    packed: PackedPlan,
    indices,
    *,
    mesh,
    n_tables: int,
    use_kernels="fused",
    reduce_mode: str = "sparse",
    axis: str = "model",
) -> dict:
    """The stages of :func:`partitioned_lookup` across ``mesh``, each a
    function of no arguments, to time alone: ``"lookup"`` (this rank's
    core), ``"rejoin"`` (``reduce_mode``'s collectives on that core's
    partial, computed once here) and, where the plan has a symmetric
    group, ``"sym"`` (this rank's ``B/K`` slice and its ``all_gather``).
    Every rank of ``mesh`` calls this, and then each stage, together."""
    indices = torch.as_tensor(indices, device=packed.device)
    indices, group, me, k = _mesh_context(packed, indices, mesh, axis, ())

    def lookup():
        return _local_asym_lookup(packed, indices, n_tables=n_tables,
                                  use_kernels=use_kernels)[0]

    partial = lookup()
    stages = {"lookup": lookup,
              "rejoin": lambda: _mesh_rejoin(partial, packed, reduce_mode, group, me, k)}
    if packed.sym_data.shape[0]:
        stages["sym"] = lambda: _mesh_sym(packed, indices, group, me, k, n_tables=n_tables,
                                          use_kernels=use_kernels)
    return stages


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def partitioned_lookup(
    packed: PackedPlan,
    indices: torch.Tensor,
    *,
    n_tables: int,
    use_kernels="fused",
    reduce_mode: str = "sparse",
    mesh=None,
    axis: str = "model",
    batch_axes: tuple[str, ...] = (),
) -> torch.Tensor:
    """Execute the plan. indices (N, B, s) int -> pooled (N, B, E) f32.

    ``use_kernels``: "fused" (default) = the CUDA kernels (plain versions on
    CPU tensors); False = the plain gather path.  ``reduce_mode``: "sparse"
    (default, owner-sharded), "psum" or "ring" — equal results.

    The per-slot partials (K, S, B, E) are joined into the output in one of
    two ways, with bitwise equal results.  On the card, for the fused
    kernels' ``"sparse"`` rejoin of a whole pack whose partials carry no
    gradient, one launch of :func:`slot_rejoin` under the ``lookup.rejoin``
    span, following the pack's ``rejoin_ptr``/``rejoin_terms``.  Everywhere
    else (CPU tensors, ``use_kernels=False``, ``"psum"``, ``"ring"``,
    partials that carry a gradient, the mesh path) the plain join:
    :func:`_scatter_slots` into per-core partials (K, N, B, E) under
    ``lookup.scatter``, then the rejoin (:func:`_sparse_rejoin`, the plain
    path and the kernel's reference) under ``lookup.rejoin``.

    ``mesh`` (a ``DeviceMesh``; every rank of it calls this with the same
    indices) runs each plan core as its own rank: ``packed`` is this rank's
    slice (``pack_plan(..., core=<rank along axis>)``) and ``axis`` the dim
    the cores lie along.  ``batch_axes`` splits B over those dims: each
    rank returns its (N, B/D, E) share.
    """
    if not (use_kernels is False or use_kernels == "fused"):
        raise ValueError(f"use_kernels must be 'fused' or False, got {use_kernels!r}")
    if reduce_mode not in ("sparse", "psum", "ring"):
        raise ValueError(f"unknown reduce_mode {reduce_mode!r}")
    with span("lookup"):
        with span("lookup.index_copy"):
            moved = not (isinstance(indices, torch.Tensor) and indices.device == packed.device)
            indices = torch.as_tensor(indices, device=packed.device)
            count("index_entries", indices.numel())
            count("index_copy_bytes", indices.numel() * indices.element_size() if moved else 0)
        if mesh is not None:
            return _mesh_lookup(packed, indices, mesh=mesh, axis=axis,
                                batch_axes=tuple(batch_axes), n_tables=n_tables,
                                use_kernels=use_kernels, reduce_mode=reduce_mode)
        if packed.rejoin_send.shape[0] != packed.n_cores:
            from repro_torch.core.mesh import MeshShapeError

            raise MeshShapeError(
                f"this pack is one core's slice of a {packed.rejoin_send.shape[0]}-core "
                "plan: look it up across the device mesh (mesh=)"
            )
        pooled = _slot_partials(packed, indices, use_kernels=use_kernels)
        if (reduce_mode == "sparse" and use_kernels == "fused" and pooled.is_cuda
                and not pooled.requires_grad):
            with span("lookup.rejoin"):
                out = slot_rejoin(pooled, packed.rejoin_ptr, packed.rejoin_terms)
        else:
            local = _scatter_slots(packed, pooled, n_tables)
            with span("lookup.rejoin"):
                if reduce_mode == "sparse":
                    out = _sparse_rejoin(local, packed)
                elif reduce_mode == "ring":
                    out = _ring_psum(local)
                else:
                    out = local.sum(dim=0)
        if packed.sym_data.shape[0]:
            # the reference splits this group's batch over the K cores; one
            # launch per table here serves the whole batch, and the check only
            # keeps the port to the batches the reference accepts
            k, b = packed.n_cores, indices.shape[1]
            if b % k:
                raise ValueError(
                    f"the symmetric group splits the batch over the {k} cores: "
                    f"batch {b} must be a multiple of {k}"
                )
            out = out + _local_sym_lookup(
                packed, indices, n_tables=n_tables, use_kernels=use_kernels
            )
        return out


# --------------------------------------------------------------------------
# vocab-parallel gather (the pool-free chunked case, for LM embeddings)
# --------------------------------------------------------------------------


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor, n_shards: int) -> torch.Tensor:
    """(V, d) table, (B, S) tokens -> (B, S, d), over ``n_shards`` row
    shards of ``V / n_shards`` rows: the paper's offset-subtract, clip,
    masked lookup and accumulation specialised to s=1 pool-free gathers (==
    Megatron's vocab-parallel embedding).  The JAX package runs one shard
    on each device of the model axis and ``psum``s; here the shards run one
    after another and their partials are summed in shard order.  A token's
    row comes from its own shard and every other shard adds zeros, so the
    result equals a plain gather.  ``torch.chunk`` makes the backward build
    one gradient per shard, concatenated once."""
    v = table.shape[0]
    if n_shards < 1 or v % n_shards:
        raise ValueError(f"{v} rows do not split into {n_shards} shards")
    vl = v // n_shards
    tokens = tokens.long()
    out = None
    for k, shard in enumerate(table.chunk(n_shards)):
        local = tokens - k * vl
        valid = (local >= 0) & (local < vl)
        emb = shard[torch.where(valid, local, 0)]
        emb = torch.where(valid[..., None], emb, torch.zeros_like(emb))
        out = emb if out is None else out + emb
    return out


class _SumOverGroup(torch.autograd.Function):
    """A sum over ``group``'s ranks (``all_reduce``) whose backward is the
    identity: the output is replicated over the group, so each rank's
    gradient already is the whole gradient of its own partial (summing
    the ranks' gradients again would count it once a rank)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def vocab_parallel_embed_shard(table_shard: torch.Tensor, tokens: torch.Tensor, index: int,
                               group) -> torch.Tensor:
    """One rank of the model axis (the JAX package's ``shard_map`` form):
    (V/K, d) row shard number ``index``, (B, S) tokens -> (B, S, d).  The
    offset-subtract, the masked local gather, then the sum over ``group``
    (the model axis's ranks; :class:`_SumOverGroup`).  A token's row comes
    from its own rank and every other rank adds zeros, so the result
    equals a plain gather."""
    vl = table_shard.shape[0]
    local = tokens.long() - index * vl
    valid = (local >= 0) & (local < vl)
    emb = table_shard[torch.where(valid, local, 0)]
    emb = torch.where(valid[..., None], emb, torch.zeros_like(emb))
    return _SumOverGroup.apply(emb, group)
