"""The join of the plan cores' per-slot partials into the pooled tables.

A plan's cores hand back one pooled partial per slot, ``(K, S, B, E)`` f32
(:func:`repro_torch.core.partition._slot_partials`).  The owner-sharded
rejoin sums them into the ``(N, B, E)`` output in three levels: each
core's slots of a table, in slot order (``_scatter_slots``); each owner's
senders of the table, in core order; the owners holding the table, in
bucket row order (``_sparse_rejoin``).  :func:`rejoin_schedule` writes
that order down once, at pack time, from the plan's maps, and
:func:`slot_rejoin` follows it: the plain version on CPU tensors, the CUDA
kernel (``csrc/embedding_rejoin.cu``; see the source for what bounds it
and why) on CUDA tensors.  Both add in the plain path's order from 0.0, so
both are bitwise equal to ``_sparse_rejoin(_scatter_slots(partials))``.

A schedule is ``(ptr, terms)``, int32: table ``t``'s terms are
``terms[ptr[t]:ptr[t + 1]]``, each a plane index ``c * S + s`` of the
partials times 4 plus the flags :data:`SENDER_END` (the term closes one
core's sum of the table) and :data:`OWNER_END` (it closes one owner's).
Terms whose sum would only add zeros are left out: a sum that starts from
0.0 is never -0.0, and adding 0.0 to it changes nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = ["OWNER_END", "SENDER_END", "rejoin_schedule", "slot_rejoin", "slot_rejoin_plain"]

SENDER_END = 1
OWNER_END = 2

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_long, ctypes.c_int, ctypes.c_void_p]
_MAX_TABLES = 65535  # the kernel's grid.y


def rejoin_schedule(slot_table, rejoin_send, rejoin_owned_pos, rejoin_bucket,
                    n_tables: int) -> tuple[np.ndarray, np.ndarray]:
    """The join's ``(ptr, terms)`` from a whole pack's maps: ``slot_table``
    (K, S), ``rejoin_send`` (K, K, n_send), ``rejoin_owned_pos`` (N,) and
    ``rejoin_bucket`` (K, O), as ``_sparse_rejoin`` reads them.  Bucket row
    ``(d, p)`` holds table ``bucket[d, p]`` and sums, in core order, what
    each core ``c`` sends owner ``d`` at position ``p`` (the tables ``t``
    of ``send[c, d]`` with ``owned_pos[t] == p``); core ``c``'s partial of
    ``t`` is the sum of its slots of ``t`` in slot order."""
    slot_table = np.asarray(slot_table)
    send = np.asarray(rejoin_send)
    owned_pos = np.asarray(rejoin_owned_pos)
    bucket = np.asarray(rejoin_bucket)
    k, s_slots = slot_table.shape
    per_table: list[list[int]] = [[] for _ in range(n_tables)]
    for d, p in np.ndindex(*bucket.shape):
        out_table = int(bucket[d, p])
        if out_table < 0:
            continue
        owner = []
        for c in range(k):
            for t in send[c, d].tolist():
                if t < 0 or owned_pos[t] != p:
                    continue
                slots = np.flatnonzero(slot_table[c] == t)
                if slots.size:
                    owner += [4 * (c * s_slots + int(s)) for s in slots]
                    owner[-1] |= SENDER_END
        if owner:
            owner[-1] |= OWNER_END
            per_table[out_table] += owner
    ptr = np.zeros(n_tables + 1, np.int32)
    ptr[1:] = np.cumsum([len(x) for x in per_table])
    terms = np.array([x for table in per_table for x in table], np.int32)
    return ptr, terms


def slot_rejoin_plain(partials: torch.Tensor, ptr: torch.Tensor,
                      terms: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: partials (K, S, B, E) f32 ->
    (N, B, E) f32, ``N = len(ptr) - 1``, each table's terms added in
    schedule order into three sums from 0.0, as the kernel adds them."""
    k, s_slots, b, e = partials.shape
    planes = partials.reshape(k * s_slots, b, e)
    ptr, terms = ptr.tolist(), terms.tolist()
    zero = partials.new_zeros((b, e))
    out = []
    for first, last in zip(ptr[:-1], ptr[1:]):
        sender = owner = total = zero
        for term in terms[first:last]:
            sender = sender + planes[term >> 2]
            if term & SENDER_END:
                owner, sender = owner + sender, zero
            if term & OWNER_END:
                total, owner = total + owner, zero
        out.append(total)
    return torch.stack(out) if out else partials.new_zeros((0, b, e))


def slot_rejoin(partials: torch.Tensor, ptr: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """The slot partials (K, S, B, E) f32 joined into the pooled tables
    (N, B, E) f32 by the schedule ``(ptr, terms)`` (:func:`rejoin_schedule`).
    CPU tensors run the plain version, CUDA tensors the kernel (16-byte
    vectors where :func:`_vector_ok` allows, else single floats; launches
    by path in ``slot_rejoin.paths``)."""
    if partials.dim() != 4 or ptr.dim() != 1 or terms.dim() != 1:
        raise ValueError("partials must be (K, S, B, E), ptr (N+1,) and terms (T,)")
    if partials.dtype != torch.float32:
        raise TypeError(f"partials must be float32, got {partials.dtype}")
    if build.route(partials, ptr, terms) == "cpu":
        return slot_rejoin_plain(partials, ptr, terms)
    if ptr.dtype != torch.int32 or terms.dtype != torch.int32:
        raise TypeError("the schedule must be int32")
    if not partials.is_contiguous():
        raise ValueError("partials must be contiguous")
    n_tables = ptr.shape[0] - 1
    if n_tables > _MAX_TABLES:
        raise ValueError(f"{n_tables} tables exceed the grid limit {_MAX_TABLES}")
    b, e = partials.shape[2:]
    out = torch.empty((n_tables, b, e), dtype=torch.float32, device=partials.device)
    if not out.numel():
        return out
    vector = _vector_ok(partials, out)
    fn = build.c_function("embedding_rejoin", "rt_slot_rejoin", _ARGS)
    with torch.cuda.device(partials.device):
        rc = fn(partials.data_ptr(), ptr.data_ptr(), terms.data_ptr(), out.data_ptr(), n_tables,
                b * e, int(vector), build.stream_of(partials.device))
    build.check_launch(rc, "slot_rejoin")
    slot_rejoin.launches += 1
    slot_rejoin.paths["vector" if vector else "scalar"] += 1
    return out


def _vector_ok(partials: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel may move 16-byte vectors: a plane is a whole
    number of them and both tensors start 16-byte aligned."""
    b, e = partials.shape[2:]
    return (b * e) % 4 == 0 and partials.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0


slot_rejoin.launches = 0
# launches by the kernel's data path: 16-byte vectors or single floats
slot_rejoin.paths = {"vector": 0, "scalar": 0}
