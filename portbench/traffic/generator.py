"""The traffic generator: per-table index draws for a traffic mix's file.

A frozen copy of ``src/repro_torch/data/distributions.py`` at commit
b2230fa (``Uniform``, ``Zipf``, ``HotSet``, ``_sample_from_probs`` and
``sample_workload``, with ``RowProbs`` cut to the fields a draw reads), so
that a later change to the program's data module moves no metric.  The
program receives only the arrays drawn here.

A mix's ``distribution`` object names one law for every table:

* ``{"kind": "uniform"}``;
* ``{"kind": "zipf", "alpha": 1.2, "top_k": 1024, "hot_prefix": true}``:
  rank r has probability proportional to r^-alpha, the ``top_k`` hottest
  ranks explicit and the rest a uniform tail; with ``hot_prefix`` rank r
  is row r-1;
* ``{"kind": "hotset", "hot_frac": 0.005, "hot_mass": 0.8, "offset": 0}``:
  a block of ``round(rows * hot_frac)`` rows from ``offset`` carries
  ``hot_mass`` of the draws uniformly, the rest a uniform tail.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["RowProbs", "row_probs", "sample_batch"]


@dataclasses.dataclass(frozen=True)
class RowProbs:
    """One table's law in compact form: ``ids`` carry ``probs`` (descending),
    the ``tail`` mass is spread uniformly over the other rows."""

    rows: int
    ids: np.ndarray
    probs: np.ndarray
    tail: float

    @property
    def tail_rows(self) -> int:
        return self.rows - len(self.ids)


def _coprime_step(m: int) -> int:
    step = max(3, int(m * 0.6180339887) | 1)
    while math.gcd(step, m) != 1:
        step += 2
    return step % m if m > 1 else 1


def _zipf(m: int, alpha: float, top_k: int, hot_prefix: bool) -> RowProbs:
    k = min(top_k, m)
    w = np.arange(1, k + 1, dtype=np.float64) ** (-alpha)
    if m > k:
        if m - k <= 1 << 20:
            tail_w = float((np.arange(k + 1, m + 1, dtype=np.float64) ** (-alpha)).sum())
        elif alpha != 1.0:
            tail_w = float(((m + 0.5) ** (1 - alpha) - (k + 0.5) ** (1 - alpha)) / (1 - alpha))
        else:
            tail_w = math.log((m + 0.5) / (k + 0.5))
    else:
        tail_w = 0.0
    total = float(w.sum()) + tail_w
    probs = w / total
    ids = np.arange(k, dtype=np.int64)
    if not hot_prefix:
        ids = ((ids + 1) * _coprime_step(m)) % m
    order = np.argsort(-probs, kind="stable")
    return RowProbs(m, ids[order], probs[order], tail_w / total)


def _hotset(m: int, hot_frac: float, hot_mass: float, offset: int) -> RowProbs:
    n = max(1, min(int(round(m * hot_frac)), m))
    if n >= m:
        return RowProbs(m, np.zeros(0, np.int64), np.zeros(0), 1.0)
    off = (m - n) if offset < 0 else offset % m
    ids = (np.arange(n, dtype=np.int64) + off) % m
    return RowProbs(m, ids, np.full(n, hot_mass / n), 1.0 - hot_mass)


def row_probs(dist: dict, rows: int) -> RowProbs:
    """The law a mix's ``distribution`` object gives a table of ``rows``."""
    kind = dist["kind"]
    if kind == "uniform":
        return RowProbs(rows, np.zeros(0, np.int64), np.zeros(0), 1.0)
    if kind == "zipf":
        return _zipf(rows, float(dist["alpha"]), int(dist.get("top_k", 1024)),
                     bool(dist.get("hot_prefix", True)))
    if kind == "hotset":
        return _hotset(rows, float(dist["hot_frac"]), float(dist["hot_mass"]),
                       int(dist.get("offset", 0)))
    raise ValueError(f"unknown distribution kind {kind!r}")


def _draw(rng: np.random.Generator, rp: RowProbs, shape: tuple[int, ...]) -> np.ndarray:
    """Ids from a compact law: explicit ids by weight, the tail uniformly
    over the rows not listed."""
    n = int(np.prod(shape))
    out = np.empty(n, np.int64)
    n_exp = len(rp.ids)
    exp_mass = float(rp.probs.sum())
    pick_exp = rng.random(n) < exp_mass
    k = int(pick_exp.sum())
    if k:
        out[pick_exp] = rp.ids[rng.choice(n_exp, size=k, p=rp.probs / exp_mass)]
    sel = ~pick_exp
    n_tail = int(sel.sum())
    if n_tail:
        if rp.tail_rows <= 0:
            out[sel] = rp.ids[rng.integers(0, max(n_exp, 1), n_tail)]
        elif n_exp == 0:
            out[sel] = rng.integers(0, rp.rows, n_tail)
        else:
            draws = rng.integers(0, rp.tail_rows, n_tail)
            sorted_ids = np.sort(rp.ids)
            out[sel] = draws + np.searchsorted(
                sorted_ids - np.arange(len(sorted_ids)), draws, side="right")
    return out.reshape(shape).astype(np.int32)


def sample_batch(rng: np.random.Generator, laws: list[RowProbs], seqs: list[int],
                 batch: int) -> np.ndarray:
    """Stacked ``(N, batch, max(seqs))`` int32 indices, ``-1`` past each
    table's sequence length."""
    out = np.full((len(laws), batch, max(seqs)), -1, np.int32)
    for i, (rp, s) in enumerate(zip(laws, seqs)):
        out[i, :, :s] = _draw(rng, rp, (batch, s))
    return out
