"""Input hardening: query-index validation policies (DESIGN.md §9).

Every lookup path treats ``-1`` as the padding sentinel — it redirects to
the packed buffer's shared zero row and contributes exactly nothing to the
pooled sum.  Anything else outside ``[0, rows)`` is *invalid traffic*: the
reference path would clamp it into a neighboring row (``jnp.take`` clip
semantics) and the partitioned paths would zero-contribute it, both
silently.  :class:`IndexValidator` makes that policy explicit per engine:

* ``clip``     — today's behavior, now explicit: indices pass through
  untouched (bit-identical outputs by construction), but out-of-vocab and
  negative counts are surfaced in ``Server.stats()`` so bad traffic is at
  least *visible*;
* ``null-row`` — invalid ids are mapped to ``-1`` (the zero row), so a bad
  id contributes nothing to pooling on **every** executor path — the
  reference path's clamp-into-a-real-row behavior included;
* ``reject``   — a query carrying any invalid id fails its own handle with
  :class:`repro_torch.serving.server.InvalidQueryError`; the rest of the batch
  serves normally (blast radius: the offending request only).

The validator runs in the server's pump at batch-release time, on the host
(numpy) side — before any device work is spent on the batch.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

__all__ = ["VALIDATION_MODES", "IndexValidator", "payload_validator"]

VALIDATION_MODES = ("clip", "null-row", "reject")


class IndexValidator:
    """Validates stacked index arrays against per-table vocab sizes.

    ``rows[i]`` is table i's vocabulary size; an index array is ``(N, ...)``
    with the leading axis the table axis.  ``-1`` is the legal padding
    sentinel; ``idx < -1`` counts as ``negative`` and ``idx >= rows[i]`` as
    ``oov``, and their union is ``invalid``.
    """

    def __init__(self, rows, mode: str = "clip"):
        if mode not in VALIDATION_MODES:
            raise ValueError(
                f"unknown validation mode {mode!r}; known: {list(VALIDATION_MODES)}"
            )
        self.rows = np.asarray(rows, np.int64).reshape(-1)
        self.mode = mode

    def check(self, idx) -> tuple[np.ndarray, dict]:
        """One index array -> (sanitized, counts).

        ``counts`` has ``oov`` / ``negative`` / ``invalid`` totals.  In
        ``null-row`` mode the returned array has invalid entries replaced by
        ``-1``; ``clip`` and ``reject`` return the input untouched (reject's
        enforcement happens at the request level, from ``counts``).
        """
        idx = np.asarray(idx)
        if idx.size == 0:
            return idx, {"oov": 0, "negative": 0, "invalid": 0}
        if idx.shape[0] != self.rows.shape[0]:
            raise ValueError(
                f"index array has {idx.shape[0]} tables, validator knows "
                f"{self.rows.shape[0]}"
            )
        rows = self.rows.reshape((-1,) + (1,) * (idx.ndim - 1))
        negative = idx < -1
        oov = idx >= rows
        invalid = negative | oov
        counts = {
            "oov": int(oov.sum()),
            "negative": int(negative.sum()),
            "invalid": int(invalid.sum()),
        }
        if self.mode == "null-row" and counts["invalid"]:
            idx = np.where(invalid, np.array(-1, idx.dtype), idx)
        return idx, counts


def _get_indices(payload: Any) -> np.ndarray:
    return np.asarray(
        payload["indices"] if isinstance(payload, Mapping) else payload
    )


def _set_indices(payload: Any, idx: np.ndarray) -> Any:
    if isinstance(payload, Mapping):
        out = dict(payload)
        out["indices"] = idx
        return out
    return idx


def payload_validator(rows, mode: str = "clip"):
    """Build the batch-level validator :class:`repro_torch.serving.server.Server`
    calls at release time: ``payloads -> (payloads', counts, bad)`` where
    ``counts`` are the batch's oov/negative totals and ``bad`` maps the
    positions of requests to fail (``reject`` mode) to a reason string."""
    v = IndexValidator(rows, mode)

    def validate(payloads):
        counts = {"oov": 0, "negative": 0}
        bad: dict[int, str] = {}
        out = list(payloads)
        for i, p in enumerate(payloads):
            sanitized, c = v.check(_get_indices(p))
            counts["oov"] += c["oov"]
            counts["negative"] += c["negative"]
            if not c["invalid"]:
                continue
            if v.mode == "reject":
                bad[i] = (
                    f"{c['oov']} out-of-vocab + {c['negative']} negative "
                    f"indices in query"
                )
            elif v.mode == "null-row":
                out[i] = _set_indices(p, sanitized)
        return out, counts, bad

    validate.mode = mode
    return validate
