"""Packed-buffer corruption detection and targeted self-heal.

The executor's speed comes from long-lived, packed buffers, exactly the
kind of state that silent memory corruption poisons for every later batch.
:class:`IntegrityManifest` freezes a CRC32 per buffer *region* at pack time
and re-verifies them on a batch cadence and on every drift hot-swap:

* one region per (core, slot) chunk in the ragged buffer: the slot's
  allocated span ``[slot_row_start, slot_row_start + align(rows+1,
  block_r))``, its redirect and padding rows included;
* one tail region per core (the zero padding past the last slot and the
  shared trailing zero row);
* one region per core of the residency cache, and one per symmetric table.

The regions, their keys and their checksums are the JAX package's: a
region's CRC32 is taken over its bytes on the host (``.cpu()``, C order),
so identical buffers give identical manifests in both packages.  The check
stays on the host: a sweep copies each buffer to the host once and
checksums its regions with :func:`zlib.crc32`.

One rank of a device mesh holds one core's slice of the buffers
(``PackedPlan.strip_core``): its manifest keys the slice's regions by the
slice's *global* core, so the union of the ranks' ``chunk``/``tail``/
``cache`` regions is the one-process manifest of the same plan.  The
symmetric tables are replicated, and each rank checksums its own copy.

``verify`` returns the mismatching region keys; ``repair`` re-materializes
exactly those regions from the source tables, writing the rows that
``pack_plan`` copied into the live buffers in place (on the card, on the
card), then rebuilds the cache mini-table from the repaired buffer through
``cache_remap`` on the buffer's device.  The result is bitwise equal to a
fresh pack.  A region with no source data (abstract packs) is zeroed and
reported as *quarantined*: served as if the rows were padding until a full
re-pack replaces the plan.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.partition import _as_table

__all__ = ["IntegrityManifest", "region_label"]


def _host(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes on the host as a numpy array in C order (16-bit
    floats viewed as int16: numpy has no bfloat16, and the bytes are what
    the checksum reads)."""
    t = t.detach().cpu().contiguous()
    if t.element_size() == 2 and t.is_floating_point():
        t = t.view(torch.int16)
    return t.numpy()


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _align(n: int, b: int) -> int:
    return -(-n // b) * b


def region_label(key: tuple) -> str:
    kind, a, b = key
    return f"{kind}[core={a}]" if b < 0 else f"{kind}[core={a},slot={b}]"


@dataclasses.dataclass
class IntegrityManifest:
    """Frozen pack-time checksums of one :class:`PackedPlan`'s buffers.

    ``checksums`` maps a region key ``(kind, core_or_table, slot)`` to its
    CRC32 (``slot = -1`` for whole-array regions); ``spans`` gives the
    ragged-buffer row range of ``chunk``/``tail`` regions.  ``core`` is the
    global core of the buffers' first core (0 for a whole pack).
    """

    checksums: dict[tuple, int]
    spans: dict[tuple, tuple[int, int]]
    meta: dict
    core: int = 0

    @classmethod
    def from_packed(cls, packed, plan, *, core: int | None = None) -> "IntegrityManifest":
        """The manifest of ``packed``; ``core`` is the global core of a
        one-core slice (a rank's share of a device mesh), whose regions are
        keyed by it (``None``: a whole pack, keyed 0..K-1)."""
        checksums: dict[tuple, int] = {}
        spans: dict[tuple, tuple[int, int]] = {}
        chunk = _host(packed.chunk_data)
        k = chunk.shape[0]
        base = 0 if core is None else int(core)
        if packed.layout == "ragged":
            slot_table = _host(packed.slot_table)
            slot_rows = _host(packed.slot_rows)
            slot_start = _host(packed.slot_row_start)
            br = max(int(packed.block_r), 1)
            for c in range(k):
                end = 0
                for s_i in range(slot_table.shape[1]):
                    if slot_table[c, s_i] < 0:
                        continue
                    lo = int(slot_start[c, s_i])
                    hi = lo + _align(int(slot_rows[c, s_i]) + 1, br)
                    key = ("chunk", base + c, s_i)
                    spans[key] = (lo, hi)
                    checksums[key] = _crc(chunk[c, lo:hi])
                    end = max(end, hi)
                key = ("tail", base + c, -1)
                spans[key] = (end, chunk.shape[1])
                checksums[key] = _crc(chunk[c, end:])
        else:  # dense layout: one region per core (no ragged spans to carve)
            for c in range(k):
                checksums[("chunk", base + c, -1)] = _crc(chunk[c])
        if packed.cache_rows:
            cache = _host(packed.cache_data)
            for c in range(k):
                checksums[("cache", base + c, -1)] = _crc(cache[c])
        sym = _host(packed.sym_data)
        for i in range(sym.shape[0]):
            checksums[("sym", i, -1)] = _crc(sym[i])
        return cls(
            checksums=checksums,
            spans=spans,
            meta={"layout": packed.layout, "block_r": int(packed.block_r),
                  "regions": len(checksums)},
            core=base,
        )

    def _local(self, key: tuple) -> int:
        """The buffers' own core index of a ``chunk``/``tail``/``cache``
        key's global core."""
        return key[1] - self.core

    # -- verification -------------------------------------------------------

    def _current(self, key: tuple, chunk, cache, sym) -> int:
        kind, a, _ = key
        if kind in ("chunk", "tail"):
            c = self._local(key)
            if key in self.spans:
                lo, hi = self.spans[key]
                return _crc(chunk[c, lo:hi])
            return _crc(chunk[c])
        if kind == "cache":
            return _crc(cache[self._local(key)]) if cache is not None else self.checksums[key]
        return _crc(sym[a])

    def verify(self, packed) -> list[tuple]:
        """Re-checksum every region against the live buffers (one copy of
        each buffer to the host); returns the mismatching region keys
        (empty = clean)."""
        chunk = _host(packed.chunk_data)
        cache = _host(packed.cache_data) if packed.cache_rows else None
        sym = _host(packed.sym_data)
        return [key for key, crc in self.checksums.items()
                if self._current(key, chunk, cache, sym) != crc]

    # -- repair -------------------------------------------------------------

    def repair(self, packed, plan, tables, table_data) -> tuple[Any, dict]:
        """Re-materialize the corrupt regions in place; returns
        ``(packed, report)`` (the same :class:`PackedPlan`, its buffers
        repaired).

        Regions are restored bit-exact from ``table_data`` (healed); with no
        source (``table_data is None``) they are zeroed and *quarantined*:
        the manifest checksum is re-pinned to the zeroed bytes so cadence
        checks stop re-flagging the region while a full re-pack is pending.
        ``report`` = ``{"healed": [...], "quarantined": [...], "clean": bool}``
        with keys as :func:`region_label` strings.
        """
        bad = self.verify(packed)
        if not bad:
            return packed, {"healed": [], "quarantined": [], "clean": True}
        chunk, sym = packed.chunk_data, packed.sym_data
        cache = packed.cache_data if packed.cache_rows else None
        sym_table = packed.host["sym_table"]
        per_core = plan.per_core()
        healed: list[tuple] = []
        quarantined: list[tuple] = []

        def src(table_idx, lo, n):
            if table_data is None:
                return None
            rows = _as_table(table_data[table_idx], chunk.dtype)[lo : lo + n]
            return rows.to(chunk.device)

        # chunk regions first: the cache rebuild below reads from them.
        # ``core`` is the key's global core (the plan's), ``c`` its index
        # in these buffers (0 on a rank's one-core slice)
        for key in bad:
            kind, core, s_i = key
            c = self._local(key)
            if kind == "tail":
                lo, hi = self.spans[key]
                chunk[c, lo:hi] = 0  # padding is zeros by construction
                healed.append(key)
            elif kind == "chunk" and key in self.spans:
                lo, hi = self.spans[key]
                chunk[c, lo:hi] = 0
                a = per_core[core][s_i]
                rows = src(a.table_idx, a.row_offset, a.rows)
                if rows is not None:
                    chunk[c, lo : lo + a.rows] = rows
                    healed.append(key)
                else:
                    quarantined.append(key)
            elif kind == "chunk":  # dense layout: rebuild the whole core
                chunk[c] = 0
                for s, a in enumerate(per_core.get(core, [])):
                    rows = src(a.table_idx, a.row_offset, a.rows)
                    if rows is not None:
                        chunk[c, s, : a.rows] = rows
                (healed if table_data is not None else quarantined).append(key)
            elif kind == "sym":
                ti = int(sym_table[core])
                sym[core] = 0
                rows = src(ti, 0, tables[ti].rows)
                if rows is not None:
                    sym[core, : rows.shape[0]] = rows
                    healed.append(key)
                else:
                    quarantined.append(key)
        # cache regions: the mini-table is a copy of buffer rows; rebuild it
        # from the (now repaired) buffer through the row -> position remap.
        if cache is not None:
            for key in bad:
                if key[0] != "cache":
                    continue
                c = self._local(key)
                remap = packed.cache_remap[c].long()
                rows = torch.nonzero(remap >= 0).squeeze(1)
                cache[c] = 0
                cache[c, remap[rows]] = chunk[c, rows]
                healed.append(key)

        # quarantined (zeroed, no source) regions get their checksum
        # re-pinned; healed regions must match the original CRC again.
        if quarantined:
            host_chunk, host_sym = _host(chunk), _host(sym)
            for key in quarantined:
                self.checksums[key] = self._current(key, host_chunk, None, host_sym)
        report = {
            "healed": [region_label(key) for key in healed],
            "quarantined": [region_label(key) for key in quarantined],
            "clean": not self.verify(packed),
        }
        return packed, report
