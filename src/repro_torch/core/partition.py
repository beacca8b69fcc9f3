"""Execution of a placement :class:`Plan` on one device (paper §III-B).

The paper places table *chunks* on individual cores, subtracts the chunk
offset from the ids, clips them, and combines partial pools with atomic
inter-core accumulation.  Here a plan core is one partition of the work on
one device: ``K`` comes from the plan (``mesh_shape``), not from the number
of GPUs.  The packed layout is the reference's, field for field:

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
  group (``sym_*``) are built as in the reference.

The rejoins become device-local reductions of the per-core ``(N, B, E)``
partials that reproduce the reference's collectives: ``"sparse"`` sums each
table's partials at its owner bucket and gathers the buckets, ``"psum"``
sums over cores, ``"ring"`` accumulates in core 0's ring order.  The
reference splits the symmetric group's batch over the K cores (core ``c``
serves rows ``[c*B/K, (c+1)*B/K)``); side by side the K slices are the whole
batch, so here one launch per table serves the whole batch.  The port still
requires ``B % K == 0`` there, only so that it accepts the batches the
reference accepts: its computation does not need it.

``use_kernels``: ``"fused"`` (default) runs the CUDA kernels (their plain
versions on CPU tensors); ``False`` is the plain gather path, the same math
without kernels.  ``layout="dense"``
(ROADMAP B8) and the access-reduction knobs ``unique_cap``/``cache_rows``
(ROADMAP A7) are not ported yet and raise.

``plan.meta`` gets the reference's ``layout``, ``rejoin`` and
``kernel["packed"]`` records, equal key for key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.strategies import Plan, Strategy
from repro_torch.core.tables import TableSpec
from repro_torch.kernels.embedding_multi import (
    multi_embedding_bag_ragged,
    ragged_runs,
    ragged_stage_rows,
)
from repro_torch.kernels.ops import strategy_bag

__all__ = [
    "STRATEGY_CODE",
    "PackedPlan",
    "pack_plan",
    "partitioned_lookup",
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
    strategy) schedule.  The ``rejoin_*`` maps drive the owner-sharded
    sparse rejoin: ``rejoin_send[c, d]`` lists the tables core ``c`` sends
    to owner ``d``, ``rejoin_bucket[d]`` lists the tables core ``d`` owns,
    and ``rejoin_owned_pos[t]`` is table ``t``'s position in its owner's
    bucket.  Port-only: ``step_runs`` is the schedule collapsed into the
    fused kernel's per-slot runs, on the device, and ``stage_rows`` the
    kernel's shared-memory staging capacity; ``host`` holds numpy copies of
    the ``sym_*`` metadata, which the executor reads on the host.
    """

    # asymmetric slots
    chunk_data: Any  # (K, R_total+1, E)
    slot_table: Any  # (K, S) int32, -1 = empty
    slot_offset: Any  # (K, S) int32 row offset within the source table
    slot_rows: Any  # (K, S) int32
    slot_row_start: Any  # (K, S) int32 first row in the ragged buffer
    slot_strategy: Any  # (K, S) int32
    slot_rep: Any  # (K, S) int32
    slot_nrep: Any  # (K, S) int32
    # fused-kernel step schedule
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
    # hot-row residency cache (zero-sized: not ported yet, ROADMAP A7)
    cache_data: Any = None  # (K, 0, E)
    cache_remap: Any = None  # (K, T+1) int32, zeros while the cache is off
    # static layout descriptors
    layout: str = "ragged"
    block_r: int = 0  # fused-kernel row-block size
    slot_window: int = 0  # largest per-slot block_r allocation (informational)
    block_b: int = 0  # the reference's resident batch rows; 0 = auto
    unique_cap: int = 0  # batch-dedup width per slot; always 0 here
    cache_rows: int = 0  # residency-cache rows; always 0 here
    kernel_path: str = "onehot"  # resolved gather mode
    # port-only: the fused kernel's inputs made once at pack time
    step_runs: Any = None  # (n_runs, 5) int32 (core, slot, first, n_steps, code)
    stage_rows: int = 0  # shared-memory rows for staging L1-coded regions
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


def _align(n: int, mult: int) -> int:
    return int(-(-n // mult) * mult)


def _rejoin_maps(
    plan: Plan, n_tables: int, k: int, mesh_shape: tuple[int, int] | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Owner-sharded rejoin maps: (owner, bucket_table, owned_pos, send_table).

    Each asymmetric table is owned by the core holding most of its rows (ties
    break to the lowest core id); ``send_table[c, d]`` lists the tables core
    ``c`` holds partials for that core ``d`` owns (deduplicated — a core
    pre-sums all its slots of one table before sending).  Only the
    single-host map is ported: a ``mesh_shape`` with ``hosts > 1`` comes from
    the hierarchical planner (ROADMAP A4) and raises.
    """
    hosts = mesh_shape[0] if mesh_shape is not None else 1
    if hosts > 1:
        raise NotImplementedError(
            "multi-host rejoin maps (hierarchical planner) are not ported "
            "yet: ROADMAP A4"
        )
    rows_by: dict[tuple[int, int], int] = {}
    for a in plan.assignments:
        key = (a.table_idx, a.core)
        rows_by[key] = rows_by.get(key, 0) + a.rows
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
    send_sets: dict[tuple[int, int], set[int]] = {}
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
) -> PackedPlan:
    """Materialize a Plan into the packed executor layout on ``device``.

    ``table_data[i]`` is the (m_i, E) table i (numpy array or tensor), or
    ``None`` for abstract packing (zeros; shape-only work).  The buffers are
    built on the host and moved to ``device`` once.  ``block_r`` overrides
    the fused kernel's row-block size; ``block_b`` is recorded for
    ``plan.meta["layout"]`` parity.  ``unique_cap``/``cache_rows``
    default to ``plan.meta["cache"]`` like the reference; any value above 0
    raises (ROADMAP A7), as does ``layout="dense"`` (ROADMAP B8).
    """
    del freqs  # only the residency-cache carve reads it (ROADMAP A7)
    if layout not in ("ragged", "dense"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "dense":
        raise NotImplementedError(
            "layout='dense' (the legacy stacked-slot layout) is not ported "
            "yet: ROADMAP B8"
        )
    access_meta = plan.meta.get("cache") or {}
    if unique_cap is None:
        unique_cap = int(access_meta.get("unique_cap") or 0)
    if cache_rows is None:
        cache_rows = int(access_meta.get("cache_rows") or 0)
    if unique_cap or cache_rows:
        raise NotImplementedError(
            "batch dedup (unique_cap) and the residency cache (cache_rows) "
            "are not ported yet: ROADMAP A7"
        )
    kernel_meta = plan.meta.get("kernel") or {}
    if kernel_path is None:
        kernel_path = kernel_meta.get("path") or "onehot"
    if kernel_path not in ("onehot", "sparse", "auto"):
        raise ValueError(f"unknown kernel_path {kernel_path!r}")
    if kernel_path == "sparse":
        raise ValueError(
            "kernel_path='sparse' requires batch dedup (unique_cap > 0): "
            "the sparse gather rides the dedup uniq/cnt machinery"
        )
    e = tables[0].dim
    if any(t.dim != e for t in tables):
        raise ValueError("all tables must share the embedding dim E")
    k = plan.n_cores
    per_core = plan.per_core()
    max_slots = max((len(v) for v in per_core.values()), default=0)
    max_slots = max(max_slots, 1)
    max_rows = max((a.rows for a in plan.assignments), default=1)
    max_rows_pad = _align(max_rows, _ROW_PAD)
    cache: dict[int, torch.Tensor] = {}

    def tbl(i):
        if i not in cache:
            cache[i] = (
                torch.zeros((tables[i].rows, e), dtype=dtype)
                if table_data is None else _as_table(table_data[i], dtype)
            )
        return cache[i]

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

    # ragged: per core, concatenate chunks row-wise; each chunk's region is
    # padded to a block_r multiple (>= 1 zero row after the data, the slot's
    # redirect target), so the fused kernel's row-blocks tile it.  block_r is
    # sized off the SMALLEST real chunk.
    min_rows = min((a.rows for a in plan.assignments), default=1)
    br = block_r or min(
        _RAGGED_BLOCK_R,
        max(_align(min_rows + 1, _ROW_PAD), _RAGGED_BLOCK_R_MIN),
    )
    br = max(_align(br, _ROW_PAD), _ROW_PAD)
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
    steps: list[list[tuple[int, int, int, int]]] = []
    slot_window = br
    t_needed = br
    for core in range(k):
        cur = 0
        core_steps: list[tuple[int, int, int, int]] = []
        for s_i in core_order[core]:
            a = per_core[core][s_i]
            alloc = _align(a.rows + 1, br)
            slot_row_start[core, s_i] = cur
            code = STRATEGY_CODE[a.strategy]
            for j in range(alloc // br):
                core_steps.append((s_i, j * br, cur // br + j, code))
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
        for t, (s_i, base, blk, code) in enumerate(core_steps):
            step_slot[core, t] = s_i
            step_base[core, t] = base
            step_block[core, t] = blk
            step_strategy[core, t] = code

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
    plan.meta.setdefault("kernel", {})["packed"] = {
        "path": "onehot",
        "sparse_chunks": 0,
        "onehot_chunks": len(plan.assignments),
        "sparse_steps": 0,
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
        "cache_remap": np.zeros((k, t_pad + 1), np.int32),
    }
    dev = torch.device(device)
    tensors = {name: torch.as_tensor(arr).to(dev) for name, arr in ints.items()}
    runs = ragged_runs(step_slot, step_base, step_strategy, br, max_slots)
    host = {
        "sym_table": sym_table, "sym_rows": sym_rows, "sym_strategy": sym_strategy,
    }
    return PackedPlan(
        chunk_data=buf.to(dev),
        sym_data=sym_data.to(dev),
        cache_data=torch.zeros((k, 0, e), dtype=dtype, device=dev),
        layout=layout,
        block_r=br,
        slot_window=slot_window,
        block_b=int(block_b or 0),
        kernel_path="onehot",
        step_runs=torch.as_tensor(runs).to(dev),
        stage_rows=ragged_stage_rows(runs, br, e * itemsize),
        host=host,
        **tensors,
    )


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
    """Chunk-local ids of every slot: ``(local, valid)``, both (K, S, B, s)."""
    b = indices.shape[1]
    ti = packed.slot_table.long()
    idx = indices.long()[ti.clamp(min=0)]  # (K, S, B, s)
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
    sum order is fixed."""
    k, s_slots, b, e = pooled.shape
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
    """indices (N, B, s) -> per-core partials (K, N, B, E) f32 (pre-rejoin).

    ``use_kernels``: ``"fused"`` = the fused ragged kernel over all cores in
    one launch; ``False`` = the plain gather path.
    """
    if use_kernels == "fused":
        return _fused_asym_lookup(packed, indices, n_tables=n_tables)
    local, valid = _slot_indices(packed, indices)
    buffer = packed.chunk_data  # (K, T+1, E)
    zrow = buffer.shape[1] - 1  # shared trailing zero row
    start = packed.slot_row_start.long()[..., None, None]
    gidx = torch.where(valid, start + local, zrow)  # (K, S, B, s)
    cores = torch.arange(packed.n_cores, device=buffer.device)[:, None, None, None]
    pooled = buffer[cores, gidx].float().sum(dim=3)  # (K, S, B, E)
    return _scatter_slots(packed, pooled, n_tables)


def _fused_asym_lookup(
    packed: PackedPlan, indices: torch.Tensor, *, n_tables: int
) -> torch.Tensor:
    """One fused-kernel launch for every slot of every core -> (K, N, B, E)."""
    local, valid = _slot_indices(packed, indices)
    k, s_slots, b, _ = local.shape
    e = packed.chunk_data.shape[-1]
    if packed.step_slot.shape[-1] == 0:
        pooled = torch.zeros((k, s_slots, b, e), dtype=torch.float32, device=packed.device)
    else:
        # -1 sentinel: matches no row-block window in the kernel
        lidx = torch.where(valid, local, -1).to(torch.int32)
        pooled = multi_embedding_bag_ragged(
            packed.chunk_data[:, :-1],  # drop the shared zero row: block_r-tiled
            lidx,
            packed.step_block,
            packed.step_runs,
            block_r=packed.block_r,
            stage_rows=packed.stage_rows,
        )
    return _scatter_slots(packed, pooled, n_tables)


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
# inter-core rejoin (device-local)
# --------------------------------------------------------------------------


def _sparse_rejoin(local: torch.Tensor, packed: PackedPlan) -> torch.Tensor:
    """Owner-sharded rejoin of the per-core partials ``local`` (K, N, B, E).

    Reproduces the reference's ``all_to_all`` + ``all_gather``: each core's
    partial rows of the tables an owner holds land in that owner's bucket
    (summed in sender order), and the buckets are gathered back into the
    (N, B, E) output.  Tables held by no core come out zero."""
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
# entry point
# --------------------------------------------------------------------------


def partitioned_lookup(
    packed: PackedPlan,
    indices: torch.Tensor,
    *,
    n_tables: int,
    use_kernels="fused",
    reduce_mode: str = "sparse",
) -> torch.Tensor:
    """Execute the plan. indices (N, B, s) int -> pooled (N, B, E) f32.

    ``use_kernels``: "fused" (default) = the CUDA kernels (plain versions on
    CPU tensors); False = the plain gather path.  ``reduce_mode``: "sparse"
    (default, owner-sharded), "psum" or "ring" — equal results.
    """
    if not (use_kernels is False or use_kernels == "fused"):
        raise ValueError(f"use_kernels must be 'fused' or False, got {use_kernels!r}")
    if reduce_mode not in ("sparse", "psum", "ring"):
        raise ValueError(f"unknown reduce_mode {reduce_mode!r}")
    indices = torch.as_tensor(indices, device=packed.device)
    local = _local_asym_lookup(
        packed, indices, n_tables=n_tables, use_kernels=use_kernels
    )
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
