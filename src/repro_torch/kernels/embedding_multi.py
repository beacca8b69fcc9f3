"""Fused multi-slot pooled lookup over the ragged packed buffer.

:func:`multi_embedding_bag_ragged` computes every slot's pooled lookup of
every core in one launch, driven by the pack-time step schedule
(``step_slot``/``step_base``/``step_block``/``step_strategy``, see
:func:`repro_torch.core.partition.pack_plan`): a slot's chunk occupies
consecutive ``block_r``-row blocks of its core's buffer, id ``l`` of the
slot lives at row ``step_block[t] * block_r + l % block_r`` of step
``t = first + l // block_r``, and ``-1`` or out-of-window ids contribute
exactly zero.  Steps on the trash slot ``S`` are schedule padding.

This slice ports the base mode (no batch dedup, no residency cache, no
sparse kernel path); those modes wait for ROADMAP B5-B7.  The CUDA kernel is
``csrc/embedding_multi.cu``; it reads the schedule as per-slot *runs*
(:func:`ragged_runs`), which pack time computes once on the host and stores
on the packed plan, on the device, with the kernel's staging capacity
(:func:`ragged_stage_rows`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = [
    "multi_embedding_bag_ragged",
    "multi_embedding_bag_ragged_plain",
    "ragged_block_b",
    "ragged_runs",
    "ragged_stage_rows",
]

# the reference's on-chip budget (bytes) for its batch chunking; kept so
# ragged_block_b returns the JAX package's values
_VMEM_BUDGET = 8 * 1024 * 1024
# shared memory (bytes) a CTA may use to stage an L1-coded slot's windows
STAGE_BYTES = 96 * 1024
_MAX_RUNS = 65535  # grid.y limit

_ARGS = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _align8(n: int) -> int:
    return int(-(-n // 8) * 8)


def ragged_block_b(
    b: int,
    seq: int,
    e: int,
    block_r: int,
    *,
    block_b: int | None = None,
    vmem_budget: int = _VMEM_BUDGET,
    unique_cap: int = 0,
    cache_rows: int = 0,
) -> tuple[int, int]:
    """The reference's resident batch-tile rows and batch chunk count.

    A TPU concern (how much of the batch fits VMEM beside one window); the
    GPU grid tiles the batch itself, so the kernel does not read it.  The
    reference's traffic model prices its fused path with it, which the
    port's will too (ROADMAP A4/A7); a test holds it to the reference.
    """
    if block_b is None:
        per_row = 4 * (
            seq * (2 if cache_rows else 1)
            + 2 * e + block_r + unique_cap + cache_rows
        )
        fixed = 2 * block_r * e * 4 + cache_rows * e * 4 + unique_cap * 4
        fit = (vmem_budget - fixed) // max(per_row, 1)
        block_b = max(8, (int(fit) // 8) * 8)
    block_b = min(block_b, _align8(b))
    block_b = max(8, (block_b // 8) * 8)
    n_chunks = -(-b // block_b)
    return block_b, n_chunks


def ragged_runs(step_slot, step_base, step_strategy, block_r: int, n_slots: int) -> np.ndarray:
    """Collapse a (K, n_steps) schedule into runs: ``(n_runs, 5)`` int32 rows
    of ``(core, slot, first_step, n_steps, strategy code)``, one per slot
    that has steps.  Trash-slot (``n_slots``) padding steps form no run.
    Raises when a slot's steps are not consecutive or its bases are not
    ``0, block_r, 2*block_r, ...`` — the layout :func:`pack_plan` emits."""
    step_slot = np.atleast_2d(np.asarray(step_slot))
    step_base = np.asarray(step_base).reshape(step_slot.shape)
    step_strategy = np.asarray(step_strategy).reshape(step_slot.shape)
    runs = []
    for core in range(step_slot.shape[0]):
        seen = set()
        t = 0
        n = step_slot.shape[1]
        while t < n:
            slot = int(step_slot[core, t])
            first = t
            while t < n and step_slot[core, t] == slot:
                t += 1
            if slot == n_slots:
                continue
            if slot in seen:
                raise ValueError(f"core {core}: steps of slot {slot} are not consecutive")
            seen.add(slot)
            bases = step_base[core, first:t]
            if not np.array_equal(bases, np.arange(t - first) * block_r):
                raise ValueError(f"core {core}: slot {slot} bases are not block_r steps")
            runs.append((core, slot, first, t - first, int(step_strategy[core, first])))
    return np.asarray(runs, np.int32).reshape(-1, 5)


def ragged_stage_rows(runs, block_r: int, row_bytes: int) -> int:
    """Shared-memory rows the kernel stages L1-coded regions into: the
    largest L1/L1-UB run region of ``runs`` that fits :data:`STAGE_BYTES`
    at ``row_bytes`` per row, or 0 (stage nothing)."""
    staged = [
        n * block_r for _c, _s, _f, n, code in np.asarray(runs).tolist()
        if code in (2, 3) and n * block_r * row_bytes <= STAGE_BYTES
    ]
    return max(staged, default=0)


def _batched(buffer, lidx, step_block):
    """Accept the reference's one-core shapes or the port's all-core ones."""
    if buffer.dim() == 2:
        return True, buffer[None], lidx[None], step_block[None]
    return False, buffer, lidx, step_block


def multi_embedding_bag_ragged_plain(
    buffer: torch.Tensor,
    lidx: torch.Tensor,
    step_block: torch.Tensor,
    runs: torch.Tensor,
    *,
    block_r: int,
) -> torch.Tensor:
    """The kernel's function in plain torch over the run list:
    buffer (K, T, E), lidx (K, S, B, s) -> (K, S, B, E) f32."""
    k, s_slots, b, _ = lidx.shape
    e = buffer.shape[-1]
    out = torch.zeros((k, s_slots, b, e), dtype=torch.float32, device=buffer.device)
    blocks = step_block.long()
    for core, slot, first, n, _code in runs.tolist():
        ids = lidx[core, slot].long()
        valid = (ids >= 0) & (ids < n * block_r)
        local = torch.where(valid, ids, 0)
        rows = blocks[core, first + local // block_r] * block_r + local % block_r
        g = buffer[core][rows].float()  # (B, s, E)
        out[core, slot] = torch.where(valid[..., None], g, 0.0).sum(dim=1)
    return out


def multi_embedding_bag_ragged(
    buffer: torch.Tensor,  # (T, E) or (K, T, E), T % block_r == 0
    lidx: torch.Tensor,  # (S, B, s) or (K, S, B, s) int32 chunk-local ids
    step_block: torch.Tensor,  # (n_steps,) or (K, n_steps) row-block index into the buffer
    runs: torch.Tensor,  # (n_runs, 5) int32 ragged_runs of the schedule
    *,
    block_r: int,
    stage_rows: int = 0,
) -> torch.Tensor:
    """All slots' pooled lookups in one launch -> (S, B, E) or (K, S, B, E) f32.

    ``runs`` lies on the buffer's device (pack time stores it there, so a
    launch copies nothing from the host).  ``stage_rows`` is
    :func:`ragged_stage_rows` of the runs, the kernel's shared-memory window
    capacity; 0 gathers every region from device memory.  The buffer's rows
    must be contiguous; its core stride may be anything (a ``[:, :-1]`` view
    of the packed ``(K, T+1, E)`` buffer works without a copy).  CPU tensors
    run the plain version, CUDA tensors the kernel.
    """
    single, buffer, lidx, step_block = _batched(buffer, lidx, step_block)
    if buffer.shape[1] % block_r:
        raise ValueError("buffer rows must be a multiple of block_r")
    if runs.dim() != 2 or runs.shape[1] != 5:
        raise ValueError(f"runs must be (n_runs, 5), got {tuple(runs.shape)}")
    device = build.route(buffer, lidx, step_block, runs)
    if device == "cpu":
        out = multi_embedding_bag_ragged_plain(buffer, lidx, step_block, runs, block_r=block_r)
    else:
        out = _launch(buffer, lidx, step_block, runs, block_r, stage_rows)
    return out[0] if single else out


def _launch(buffer, lidx, step_block, runs, block_r, stage_rows):
    k, _, e = buffer.shape
    _, s_slots, b, seq = lidx.shape
    if lidx.dtype != torch.int32 or step_block.dtype != torch.int32 or runs.dtype != torch.int32:
        raise TypeError("lidx, step_block and runs must be int32")
    if buffer.stride(2) != 1 or buffer.stride(1) != e:
        raise ValueError("buffer rows must be contiguous")
    if not (lidx.is_contiguous() and step_block.is_contiguous() and runs.is_contiguous()):
        raise ValueError("lidx, step_block and runs must be contiguous")
    n_runs = runs.shape[0]
    if n_runs > _MAX_RUNS:
        raise ValueError(f"{n_runs} slot runs exceed the grid limit {_MAX_RUNS}")
    out = torch.zeros((k, s_slots, b, e), dtype=torch.float32, device=buffer.device)
    fn = build.c_function("embedding_multi", "rt_multi_embedding_bag_ragged", _ARGS)
    with torch.cuda.device(buffer.device):
        rc = fn(buffer.data_ptr(), buffer.stride(0), lidx.data_ptr(),
                step_block.data_ptr(), step_block.shape[-1], runs.data_ptr(),
                n_runs, out.data_ptr(), s_slots, b, seq, e, block_r, stage_rows,
                build.dtype_code(buffer.dtype), build.stream_of(buffer.device))
    build.check_launch(rc, "multi_embedding_bag_ragged")
    multi_embedding_bag_ragged.launches += 1
    return out


multi_embedding_bag_ragged.launches = 0
