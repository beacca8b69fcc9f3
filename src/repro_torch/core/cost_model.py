"""Linear P99 cost model (paper eq. 2) + OLS fitting + analytic seeds.

Per table ``i`` and strategy ``p``:

    J_i = b0 + b1 * (B * s_i / K)                 if p in {GM, L1}
    J_i = b0 + b1 * (B * s_i / K) + b2 * m_i      if p in {GM-UB, L1-UB}

The betas differ per strategy (and, on real hardware, per hyper-parameter
configuration); they are fitted with ordinary least squares on collected
measurements.  ``analytic_model`` seeds the betas from hardware datasheet
constants so the planner works before any profiling, mirroring the paper's
high-level estimation (§IV-B); ``fit`` replaces them with OLS estimates from
(simulated or real) measurements.

Frequency-aware pricing (DESIGN.md §5): every prediction entry point accepts
an optional per-table access histogram ``freq`` (any object with the
``RowProbs`` mass interface from :mod:`repro_torch.data.distributions`) plus the
chunk's ``row_range`` within its source table.  With a histogram the work
term is scaled by the mass actually landing in the chunk
(``freq.range_mass``), and GM — the only strategy whose latency depends on
*which* rows are hit — pays a conflict-serialization surcharge proportional
to the chunk's access concentration (``gm_conflict``; the paper's
bank/line-conflict pathology on unbalanced distributions, §IV-C).  With
``freq=None`` everything degenerates exactly to the uniform-assumption
model above.

Access-reduction pricing (DESIGN.md §6): ``CostModel`` additionally carries
the executor's two access-reduction knobs, both off by default so every
existing consumer is untouched:

* ``dedup=True`` — the fused executor unique-izes indices per chunk before
  gathering, so a GM chunk pays per *unique* row, not per lookup:
  the work term becomes ``min(lookups, E[unique rows])``
  (``RowProbs.expected_unique``) and the conflict surcharge vanishes (each
  row is read exactly once — nothing serializes);
* ``cache_rows=C`` — a per-core resident mini-table holds the C hottest
  rows; the mass they carry is served from VMEM and leaves the GM work term
  (per-chunk approximation: each chunk prices its own top-C rows as cached;
  the packer's actual per-core allocation is modeled exactly by
  ``repro_torch.core.traffic.modeled_plan_traffic``).

Kernel-path crossover pricing (DESIGN.md §11): the dedup'd unique-row gather
inside the fused kernel has two implementations — the one-hot MXU GEMM
(dense in ``U·R``: it materializes a (U, block_r) equality matrix per step
and pays matmul FLOPs over the whole chunk) and the true-sparse row gather
(pays only ``U`` row copies plus a per-step loop overhead).
:meth:`CostModel.kernel_path_costs` prices both from the chunk's expected
unique-row count (access-mass-scaled) and
:meth:`CostModel.best_kernel_path` picks the cheaper; the planner records
the per-chunk choice in ``plan.meta["kernel"]`` and pack time emits it into
the step schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.strategies import ALL_STRATEGIES, Strategy
from repro_torch.core.tables import TableSpec

__all__ = [
    "A100",
    "ASCEND_910",
    "TPU_V5E",
    "HARDWARE",
    "KERNEL_PATHS",
    "Betas",
    "CostModel",
    "HardwareSpec",
    "analytic_model",
    "core_times",
    "freq_of",
    "lif",
]

# the fused kernel's unique-row gather implementations (DESIGN.md §11);
# "auto" (planner/engine spelling) means cost-modeled per-chunk argmin.
KERNEL_PATHS = ("onehot", "sparse")

# sparse-gather calibration constants (seconds): per-unique-row control
# overhead of the masked dynamic-slice row copy, and per-row-block-step
# fixed overhead of the gather loop (trip count is the static unique cap,
# paid once per streamed window whether or not rows land in it).
_SPARSE_GATHER_OVERHEAD = 2e-9
_SPARSE_STEP_OVERHEAD = 5e-8
# nominal fused-kernel row-block when the caller doesn't know the pack's
# (matches partition._RAGGED_BLOCK_R)
_NOMINAL_BLOCK_R = 512


# --------------------------------------------------------------------------
# Hardware descriptions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Datasheet-level description of one multi-core lookup platform."""

    name: str
    cores: int
    hbm_bw: float  # bytes/s aggregate HBM bandwidth
    l2_bw: float  # bytes/s shared cache bandwidth (aggregate)
    l1_bw: float  # bytes/s per-core scratchpad (VMEM/L1) bandwidth
    l1_bytes: int  # persistent per-core scratchpad budget for tables
    dma_latency: float  # seconds, per independent small DMA transfer
    vector_flops: float  # per-core vector unit ops/s (elementwise)
    matmul_flops: float  # per-core MXU/cube flops/s (for one-hot lookups)
    link_bw: float = 50e9  # bytes/s per inter-chip link (pods)
    # cross-host (NIC/DCN) bandwidth per host: the two-level mesh's second,
    # slower interconnect tier (~100 Gb/s Ethernet/ICI-DCN).  The asymmetry
    # link_bw >> host_link_bw is what makes host-local placement matter.
    host_link_bw: float = 12.5e9
    host_link_latency: float = 5e-6  # seconds per cross-host collective hop

    @property
    def hbm_bw_per_core(self) -> float:
        return self.hbm_bw / self.cores


# Ascend 910: 32 DaVinci cores, 1 MB L1 each, 32 MB shared L2, ~1.2 TB/s HBM.
ASCEND_910 = HardwareSpec(
    name="ascend910",
    cores=32,
    hbm_bw=1.2e12,
    l2_bw=4.0e12,
    l1_bw=1.0e12,
    l1_bytes=1 << 20,
    dma_latency=0.6e-6,
    vector_flops=2.0e12 / 32,
    matmul_flops=256e12 / 32,
)

# Nvidia A100 80GB: 108 SMs, ~2.0 TB/s HBM2e, 192 kB smem/SM (no persistent
# preload support in the stack -> l1_bytes=0 per the paper's assumption).
A100 = HardwareSpec(
    name="a100",
    cores=108,
    hbm_bw=2.0e12,
    l2_bw=5.0e12,
    l1_bw=19.5e12 / 108,
    l1_bytes=0,
    dma_latency=0.4e-6,
    vector_flops=19.5e12 / 108,
    matmul_flops=312e12 / 108,
)

# TPU v5e preset: the reference's default pricing.  Its values are inputs
# to the linear model only, kept verbatim so plans match the JAX package bit
# for bit; they describe nothing about the card this package runs on.
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    cores=1,
    hbm_bw=819e9,
    l2_bw=819e9,
    l1_bw=10.0e12,
    l1_bytes=64 << 20,
    dma_latency=1.0e-6,
    vector_flops=4.0e12,
    matmul_flops=197e12,
    link_bw=50e9,
)

HARDWARE: dict[str, HardwareSpec] = {
    h.name: h for h in (ASCEND_910, A100, TPU_V5E)
}


# --------------------------------------------------------------------------
# The linear model
# --------------------------------------------------------------------------


Betas = tuple[float, float, float]  # (b0, b1, b2)


def freq_of(freqs, table_idx: int):
    """Normalize a per-table histogram collection (None | sequence | mapping
    keyed by table index) to one table's histogram or ``None``."""
    if freqs is None:
        return None
    if isinstance(freqs, Mapping):
        return freqs.get(table_idx)
    return freqs[table_idx] if table_idx < len(freqs) else None


@dataclasses.dataclass
class CostModel:
    """Per-strategy linear P99 model (paper eq. 2).

    ``gm_conflict`` scales the GM conflict-serialization surcharge applied
    under a measured access histogram (see module docstring): lookups piling
    onto few hot rows serialize on memory banks/cache lines, so GM work is
    multiplied by ``1 + gm_conflict * concentration`` where concentration is
    the access mass of the chunk's ``conflict_rows`` (bank-count-scale)
    hottest rows, normalized by the chunk's total mass.  Uniform traffic →
    concentration ≈ 0 → no surcharge; the paper's ``fixed`` distribution →
    concentration = 1 (the >10x pathology).  L1/UB strategies are
    conflict-free by construction (persistent scratchpad / one-hot MXU
    sweep) — the robustness asymmetry the paper measures.

    ``dedup``/``cache_rows`` price the executor's access-reduction subsystem
    (module docstring; both default off = the unarmed model, bit-identical).
    """

    betas: dict[Strategy, Betas]
    hardware: HardwareSpec = TPU_V5E
    gm_conflict: float = 8.0
    conflict_rows: int = 64
    dedup: bool = False
    cache_rows: int = 0

    # -- prediction ---------------------------------------------------------

    def predict(
        self,
        table: TableSpec,
        batch: int,
        cores: int,
        strategy: Strategy,
        freq=None,
        row_range: tuple[int, int] | None = None,
    ) -> float:
        """Estimated P99 latency contribution (seconds) of one table on one
        core, with the batch split over ``cores`` cores.

        ``freq`` is the access histogram of the *source table* (``RowProbs``
        interface); ``row_range`` identifies the chunk ``[lo, hi)`` being
        priced within it (default: the whole table, ``table.rows`` rows).
        With a histogram the work term is scaled by the chunk's access mass
        and GM pays the conflict surcharge; ``freq=None`` reproduces the
        uniform-assumption model exactly."""
        b0, b1, b2 = self.betas[strategy]
        work = batch * table.seq / max(cores, 1)
        if freq is not None:
            lo, hi = row_range if row_range is not None else (0, table.rows)
            n = work  # lookups landing on this core before any reduction
            mass = freq.range_mass(lo, hi)
            cache_mass = 0.0
            if self.cache_rows and strategy is Strategy.GM:
                # resident-cache hit: the chunk's hottest rows are served
                # from the per-core mini-table, never from HBM.
                cache_mass = freq.range_top_mass(lo, hi, self.cache_rows)
            work = n * max(mass - cache_mass, 0.0)
            if strategy is Strategy.GM and work > 0:
                if self.dedup:
                    # per-unique-row reads: duplicates fold at batch prep, so
                    # no repeated-row serialization survives (no surcharge).
                    work = min(
                        work,
                        freq.expected_unique(
                            lo, hi, n, skip_top=self.cache_rows
                        ),
                    )
                else:
                    # conflict concentration of the rows still going to HBM
                    top = self.cache_rows + self.conflict_rows
                    conc = (
                        freq.range_top_mass(lo, hi, top) - cache_mass
                    ) / max(mass - cache_mass, 1e-30)
                    work *= 1.0 + self.gm_conflict * max(conc, 0.0)
        j = b0 + b1 * work
        if strategy.is_ub:
            j += b2 * table.rows
        return j

    def best_strategy(
        self,
        table: TableSpec,
        batch: int,
        cores: int,
        candidates: Sequence[Strategy],
        freq=None,
        row_range: tuple[int, int] | None = None,
    ) -> tuple[Strategy, float]:
        costs = [
            (self.predict(table, batch, cores, s, freq, row_range), s)
            for s in candidates
        ]
        cost, strat = min(costs, key=lambda cs: cs[0])
        return strat, cost

    def fits_l1(self, table: TableSpec, rows: int | None = None) -> bool:
        rows = table.rows if rows is None else rows
        return rows * table.row_bytes <= self.hardware.l1_bytes

    def cross_host_time(self, nbytes: float, hosts: int = 2) -> float:
        """Modeled wall time of the two-level mesh's one cross-host
        collective: a ring all-gather of the per-host owner buckets over the
        slow inter-host tier (DESIGN.md §12).  ``nbytes`` is the total
        payload crossing host boundaries; a single host pays nothing."""
        if hosts <= 1 or nbytes <= 0:
            return 0.0
        return (
            (hosts - 1) * self.hardware.host_link_latency
            + nbytes / self.hardware.host_link_bw
        )

    # -- kernel-path (dense-vs-sparse gather) crossover ---------------------

    def expected_chunk_unique(
        self,
        table: TableSpec,
        batch: int,
        cores: int,
        freq=None,
        row_range: tuple[int, int] | None = None,
    ) -> float:
        """Expected distinct rows of chunk ``row_range`` hit per batch pass.

        With a histogram this is ``freq.expected_unique``; under the uniform
        assumption it is the closed-form occupancy ``R·(1-(1-1/R)^n)`` of
        the chunk's share of the lookups.  Always ≤ min(lookups, rows)."""
        lo, hi = row_range if row_range is not None else (0, table.rows)
        rows = max(hi - lo, 1)
        n = batch * table.seq / max(cores, 1)
        if freq is not None:
            mass = freq.range_mass(lo, hi)
            u = freq.expected_unique(lo, hi, n)
            return float(min(u, n * mass, rows))
        n_c = n * rows / max(table.rows, 1)
        u = rows * (1.0 - (1.0 - 1.0 / rows) ** n_c)
        return float(min(u, n_c, rows))

    def kernel_path_costs(
        self,
        table: TableSpec,
        batch: int,
        cores: int,
        freq=None,
        row_range: tuple[int, int] | None = None,
        *,
        block_r: int = _NOMINAL_BLOCK_R,
    ) -> dict:
        """Price the dedup'd unique-row gather both ways for one chunk.

        One-hot (per batch pass): a ``(U, block_r)`` equality one-hot is
        materialized per row-block step and GEMM'd against the window — per
        unique row the full chunk width ``R`` pays a vector-unit compare,
        2·E MXU flops, and 4 one-hot bytes through VMEM.  Sparse: each
        unique row is one masked dynamic-slice copy (``E`` row bytes through
        VMEM + fixed control overhead) plus a per-step loop overhead that
        scales with the chunk's step count — the crossover is decided by
        ``U·R`` vs ``U·E + steps`` (chunk access mass is inside ``U``).

        Returns ``{"onehot", "sparse"}`` seconds plus ``"onehot_bytes"`` /
        ``"sparse_bytes"`` (the modeled gather-side traffic the benches
        report), ``"unique"``, and ``"steps"``.  The shared segment-sum
        scatter (``cnt @ rows_u``) is identical on both paths and omitted —
        it cannot move the argmin.
        """
        lo, hi = row_range if row_range is not None else (0, table.rows)
        rows = max(hi - lo, 1)
        u = self.expected_chunk_unique(table, batch, cores, freq, row_range)
        hw = self.hardware
        e = table.dim
        itemsize = table.row_bytes / max(table.dim, 1)
        steps = float(-(-rows // max(block_r, 1)))
        t_onehot = u * rows * (
            1.0 / hw.vector_flops
            + 2.0 * e / hw.matmul_flops
            + 4.0 / hw.l1_bw
        )
        t_sparse = (
            u * (e * itemsize / hw.l1_bw + _SPARSE_GATHER_OVERHEAD)
            + steps * _SPARSE_STEP_OVERHEAD
        )
        return {
            "onehot": t_onehot,
            "sparse": t_sparse,
            "onehot_bytes": u * rows * 4.0,
            "sparse_bytes": u * e * itemsize + steps * u * 4.0,
            "unique": u,
            "steps": steps,
        }

    def best_kernel_path(
        self,
        table: TableSpec,
        batch: int,
        cores: int,
        freq=None,
        row_range: tuple[int, int] | None = None,
        *,
        block_r: int = _NOMINAL_BLOCK_R,
    ) -> tuple[str, dict]:
        """Cost-modeled per-chunk gather choice: (path, the cost record)."""
        costs = self.kernel_path_costs(
            table, batch, cores, freq, row_range, block_r=block_r
        )
        path = "sparse" if costs["sparse"] < costs["onehot"] else "onehot"
        return path, costs

    # -- fitting ------------------------------------------------------------

    @staticmethod
    def fit(
        measurements: Iterable[tuple[TableSpec, int, int, Strategy, float]],
        hardware: HardwareSpec = TPU_V5E,
    ) -> "CostModel":
        """OLS fit per strategy.

        ``measurements``: iterable of (table, batch, cores, strategy,
        measured_seconds).  Strategies never observed fall back to the
        analytic seed.
        """
        rows: dict[Strategy, list[tuple[list[float], float]]] = {
            s: [] for s in ALL_STRATEGIES
        }
        for table, batch, cores, strategy, t in measurements:
            work = batch * table.seq / max(cores, 1)
            feats = [1.0, work, float(table.rows) if strategy.is_ub else 0.0]
            rows[strategy].append((feats, t))
        seed = analytic_model(hardware)
        betas: dict[Strategy, Betas] = {}
        for s in ALL_STRATEGIES:
            data = rows[s]
            if len(data) < 2:
                betas[s] = seed.betas[s]
                continue
            X = np.array([f for f, _ in data])
            y = np.array([t for _, t in data])
            if not s.is_ub:
                X = X[:, :2]
            coef, *_ = np.linalg.lstsq(X, y, rcond=None)
            coef = np.clip(coef, 0.0, None)  # latencies are non-negative
            b = (float(coef[0]), float(coef[1]), float(coef[2]) if s.is_ub else 0.0)
            betas[s] = b
        return CostModel(betas=betas, hardware=hardware)

    def r2(
        self,
        measurements: Iterable[tuple[TableSpec, int, int, Strategy, float]],
    ) -> float:
        ys, yh = [], []
        for table, batch, cores, strategy, t in measurements:
            ys.append(t)
            yh.append(self.predict(table, batch, cores, strategy))
        ys, yh = np.array(ys), np.array(yh)
        ss_res = float(np.sum((ys - yh) ** 2))
        ss_tot = float(np.sum((ys - ys.mean()) ** 2)) or 1e-30
        return 1.0 - ss_res / ss_tot


def analytic_model(hw: HardwareSpec = TPU_V5E) -> CostModel:
    """Seed betas from datasheet constants (conflict-free assumption, §IV-B).

    GM     per lookup: one small DMA (latency-bound for tiny rows).
    L1     per lookup: scratchpad row read.
    GM-UB  stream the whole table once (b2*m) + per-query one-hot row cost.
    L1-UB  one-hot matmul across the resident table: cost ~ b1*work + b2*m
           (the m-term is the MXU sweep over table rows per batch tile).
    """
    row_bytes = 32.0  # E=16 fp16 nominal; OLS refit absorbs the difference.
    gm_row = hw.dma_latency + row_bytes / hw.hbm_bw_per_core
    l1_row = row_bytes / hw.l1_bw + 5e-9
    # UB: table streamed in chunks at HBM bw; one-hot matmul per (tile x chunk).
    ub_stream_per_row = row_bytes / hw.hbm_bw_per_core
    ub_mxu_per_row = 2.0 * 128 * 16 / hw.matmul_flops  # one 128-wide tile col
    betas = {
        Strategy.GM: (2e-6, gm_row, 0.0),
        Strategy.L1: (2e-6, l1_row, 0.0),
        Strategy.GM_UB: (3e-6, l1_row, ub_stream_per_row + ub_mxu_per_row),
        Strategy.L1_UB: (3e-6, l1_row, ub_mxu_per_row),
    }
    return CostModel(betas=betas, hardware=hw)


# --------------------------------------------------------------------------
# Plan-level metrics
# --------------------------------------------------------------------------


def core_times(
    model: CostModel,
    tables: Sequence[TableSpec],
    batch: int,
    plan_assignments,
    n_cores: int,
    symmetric: Mapping[int, Strategy] | None = None,
    freqs=None,
) -> np.ndarray:
    """Per-core accumulated P99 estimate for a plan.

    Asymmetric chunks serve the full batch slice assigned to them
    (replication splits the batch); the chunk behaves like a table with
    ``rows``-row footprint.  Symmetric tables add their K-way batch-split
    cost to every core.  ``freqs`` (None | sequence | mapping by table index)
    re-prices every chunk under the given access histograms.
    """
    t = np.zeros(n_cores)
    for a in plan_assignments:
        tab = tables[a.table_idx]
        chunk_tab = dataclasses.replace(tab, rows=a.rows)
        # the chunk serves batch/replicas queries entirely on this core
        eff_batch = batch // max(a.replicas, 1)
        t[a.core] += model.predict(
            chunk_tab, eff_batch, 1, a.strategy,
            freq_of(freqs, a.table_idx),
            (a.row_offset, a.row_offset + a.rows),
        )
    if symmetric:
        for ti, strat in symmetric.items():
            tab = tables[ti]
            t += model.predict(tab, batch, n_cores, strat, freq_of(freqs, ti))
    return t


def lif(times: np.ndarray) -> float:
    """Load Imbalance Factor = t_max / t_avg (paper III-B)."""
    avg = float(times.mean()) or 1e-30
    return float(times.max()) / avg
