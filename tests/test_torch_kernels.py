"""The port's kernels (plain versions on CPU tensors) against the JAX
package's Pallas kernels in interpret mode, on the same seeded inputs.

Tolerance: rtol = atol = 1e-5 for every table dtype.  bf16/f16 rows convert
exactly to f32 and both sides sum in f32, so the only difference is the f32
summation order.  The L1 kernel is held against ``kernels/ref.py``: the JAX
package's L1 Pallas kernel does not trace under the installed jax.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as jref
from repro.kernels.embedding_gm import embedding_bag_gm as jax_gm
from repro.kernels.embedding_multi import multi_embedding_bag_ragged as jax_ragged
from repro.kernels.embedding_multi import ragged_block_b as jax_ragged_block_b
from repro.kernels.embedding_ub import embedding_bag_ub as jax_ub
from repro_torch.core.strategies import ALL_STRATEGIES
from repro_torch.kernels import ops, ref
from repro_torch.kernels.embedding_gm import embedding_bag_gm
from repro_torch.kernels.embedding_l1 import (
    CLUSTER_BYTES,
    CLUSTER_SIZES,
    RESIDENT_BYTES,
    embedding_bag_l1,
    l1_schedule,
)
from repro_torch.kernels.embedding_multi import (
    _BASE_CTAS_PER_SM,
    SCATTER_QUERIES,
    _queries,
    multi_embedding_bag_ragged,
    multi_embedding_bag_ragged_plain,
    ragged_block_b,
    ragged_runs,
    ragged_stage_rows,
    scatter_queries,
)
from repro_torch.kernels.embedding_ub import (
    MAX_TILES,
    TILE_BYTES,
    embedding_bag_ub,
    ub_schedule,
)

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _tables(rng, m, e, dtype):
    t32 = (rng.standard_normal((m, e)) * 0.5).astype(np.float32)
    t = torch.from_numpy(t32).to(DTYPES[dtype])
    return t, jnp.asarray(t32).astype(dtype)


# --------------------------------------------------------------------------
# K1: the fused ragged kernel, base mode
# --------------------------------------------------------------------------

BLOCK_R = 8
# (slot, strategy code, steps); slot 4 (rows < block_r) covers "block_r >
# chunk"; two trailing trash-slot steps are schedule padding
_SCHEDULE = [(0, 1, 2), (1, 0, 1), (2, 3, 3), (3, 2, 1), (4, 0, 1)]
_N_SLOTS = 5


def _ragged_inputs(seed, b=12, s=3, dtype="float32"):
    rng = np.random.default_rng(seed)
    step_slot, step_base, step_block, step_strat = [], [], [], []
    blk = 0
    regions = {}
    for slot, code, n in _SCHEDULE:
        regions[slot] = n * BLOCK_R
        for j in range(n):
            step_slot.append(slot)
            step_base.append(j * BLOCK_R)
            step_block.append(blk)
            step_strat.append(code)
            blk += 1
    for _ in range(2):  # padding steps: trash slot, base 0, block 0
        step_slot.append(_N_SLOTS)
        step_base.append(0)
        step_block.append(0)
        step_strat.append(0)
    t_rows = blk * BLOCK_R
    buf_t, buf_j = _tables(rng, t_rows, 16, dtype)
    # ids from -3 to region + 5: -1 padding, other negatives, out-of-window
    lidx = np.stack([
        rng.integers(-3, regions[slot] + 5, size=(b, s)) for slot in range(_N_SLOTS)
    ]).astype(np.int32)
    steps = [np.asarray(a, np.int32) for a in (step_slot, step_base, step_block, step_strat)]
    return buf_t, buf_j, lidx, steps


def _runs(steps, n_slots=_N_SLOTS):
    """The run list of reference-shaped (slot, base, block, strategy) steps."""
    return torch.from_numpy(ragged_runs(steps[0], steps[1], steps[3], BLOCK_R, n_slots))


def _port_ragged(buf_t, lidx, steps):
    return multi_embedding_bag_ragged(
        buf_t, torch.from_numpy(lidx), torch.from_numpy(steps[2]), _runs(steps), block_r=BLOCK_R,
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_ragged_matches_pallas(dtype, seed):
    buf_t, buf_j, lidx, steps = _ragged_inputs(seed, dtype=dtype)
    want = jax_ragged(
        buf_j, jnp.asarray(lidx), *map(jnp.asarray, steps),
        block_r=BLOCK_R, interpret=True,
    )
    got = _port_ragged(buf_t, lidx, steps)
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ragged_matches_pallas_batch_chunked():
    """The reference chunks a batch past its on-chip budget outside the
    kernel (here forced with block_b=8 over 20 rows: 3 chunks); the port's
    grid tiles the batch itself, with the same result."""
    buf_t, buf_j, lidx, steps = _ragged_inputs(2, b=20)
    want = jax_ragged(
        buf_j, jnp.asarray(lidx), *map(jnp.asarray, steps),
        block_r=BLOCK_R, block_b=8, interpret=True,
    )
    got = _port_ragged(buf_t, lidx, steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ragged_all_cores_one_call():
    """The port's batched (K, ...) form equals K one-core calls."""
    cores = [_ragged_inputs(seed) for seed in (3, 4)]
    buf = torch.stack([c[0] for c in cores])
    lidx = torch.stack([torch.from_numpy(c[2]) for c in cores])
    steps = [np.stack([c[3][i] for c in cores]) for i in range(4)]
    runs = _runs(steps)
    assert runs.shape == (2 * len(_SCHEDULE), 5)
    got = multi_embedding_bag_ragged(buf, lidx, torch.from_numpy(steps[2]), runs,
                                     block_r=BLOCK_R)
    for k, (b_t, _, l_np, st) in enumerate(cores):
        one = _port_ragged(b_t, l_np, st)
        torch.testing.assert_close(got[k], one, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(8192, 1, 16, 64), (64, 4, 16, 512), (33, 5, 32, 8)])
def test_ragged_block_b_matches_reference(shape):
    b, seq, e, block_r = shape
    for kw in ({}, {"block_b": 24}, {"unique_cap": 16, "cache_rows": 64}):
        assert ragged_block_b(b, seq, e, block_r, **kw) == jax_ragged_block_b(
            b, seq, e, block_r, **kw)


def test_ragged_runs_reject_split_slot():
    slot = np.array([[0, 1, 0]], np.int32)
    base = np.array([[0, 0, 8]], np.int32)
    with pytest.raises(ValueError, match="not consecutive"):
        ragged_runs(slot, base, np.zeros_like(slot), 8, 2)


def test_ragged_rejects_unaligned_buffer():
    buf_t, _, lidx, steps = _ragged_inputs(0)
    with pytest.raises(ValueError, match="multiple of block_r"):
        _port_ragged(buf_t[:-1], lidx, steps)


def test_ragged_stage_rows():
    """Staging capacity: the largest L1/L1-UB region that fits the budget;
    GM/GM-UB regions and oversized L1 regions are never staged."""
    runs = np.array([[0, 0, 0, 4, 0], [0, 1, 4, 2, 2], [1, 0, 0, 3, 3],
                     [1, 1, 3, 1000, 2]], np.int32)
    assert ragged_stage_rows(runs, 8, 64) == 24
    assert ragged_stage_rows(runs[:1], 8, 64) == 0
    assert ragged_stage_rows(runs, 256, 64) == 768  # exactly 48 KiB
    assert ragged_stage_rows(runs, 256, 128) == 0  # 512 rows * 128 B > 48 KiB


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 3])
def test_ragged_plain_sums_in_id_order(dtype, s):
    """The plain version sums each query's in-window rows one position at a
    time, in id order from 0.0 in f32: the base kernel's order, so the card
    holds the two bitwise at every s."""
    buf_t, _, lidx, steps = _ragged_inputs(5, b=40, s=s, dtype=dtype)
    runs = _runs(steps)
    got = multi_embedding_bag_ragged_plain(
        buf_t[None], torch.from_numpy(lidx)[None], torch.from_numpy(steps[2])[None], runs,
        block_r=BLOCK_R)[0].numpy()
    rows = buf_t.float().numpy()
    want = np.zeros(got.shape, np.float32)
    for _core, slot, first, n, _code in runs.tolist():
        for q in range(lidx.shape[1]):
            acc = np.zeros(rows.shape[1], np.float32)
            for j in range(s):
                l = int(lidx[slot, q, j])
                if 0 <= l < n * BLOCK_R:
                    acc = acc + rows[steps[2][first + l // BLOCK_R] * BLOCK_R + l % BLOCK_R]
            want[slot, q] = acc
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path,k,s_slots", [("A", 8, 2), ("C", 8, 2), ("E", 8, 2)])
@pytest.mark.parametrize("item,want", [(4, 2), (2, 1)])
def test_base_and_dense_grids_fill_the_card(path, k, s_slots, item, want):
    """The fused base kernel (paths A and C) and the dense kernel (path E)
    take their queries a thread from ``scatter_queries`` at the 4 CTAs an
    SM their vector kernel holds: at taobao's served shapes (B = 8192,
    E = 16, K x S slots) the grid offers each of the H100's 132 SMs at least
    that wave, about 8 CTAs an SM (1,024 CTAs, the fastest count the card
    measured), and more queries a thread would leave SMs short."""
    b, e = 8192, 16
    q = scatter_queries(b, e, item, k * s_slots, 132, ctas_per_sm=_BASE_CTAS_PER_SM)
    assert q == want
    per_pass = 256 // (e * item // 16)
    ctas = -(-b // (per_pass * q)) * k * s_slots
    assert ctas == 1024 and ctas >= _BASE_CTAS_PER_SM * 132
    assert -(-b // (per_pass * 2 * q)) * k * s_slots < _BASE_CTAS_PER_SM * 132


def test_queries_choice():
    """A vector kernel's queries a thread: the caller's when it is one of
    ``SCATTER_QUERIES``, 0 (the scalar kernel) where the data refuses
    vectors, and anything else refused."""
    assert _queries(4, True, 8192, 16, 4, 16, None) == 4
    assert _queries(None, False, 8192, 16, 4, 16, None) == 0
    assert _queries(8, False, 8192, 16, 4, 16, None) == 0
    with pytest.raises(ValueError, match="queries"):
        _queries(3, True, 8192, 16, 4, 16, None)


# --------------------------------------------------------------------------
# K2-K4: the single-table strategy kernels
# --------------------------------------------------------------------------

SHAPES = [(16, 16, 4, 1), (100, 16, 32, 4), (513, 32, 33, 5)]  # (m, E, B, s)


def _bag_inputs(shape, dtype, seed=0, invalid=True):
    m, e, b, s = shape
    rng = np.random.default_rng(seed)
    t, j = _tables(rng, m, e, dtype)
    lo, hi = (-2, m + 3) if invalid else (0, m)
    idx = rng.integers(lo, hi, size=(b, s)).astype(np.int32)
    return t, j, idx


@pytest.mark.parametrize("persistent", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_ub_matches_pallas(shape, dtype, persistent):
    t, j, idx = _bag_inputs(shape, dtype)
    want = jax_ub(j, jnp.asarray(idx), block_b=8, block_m=16,
                  persistent=persistent, interpret=True)
    got = embedding_bag_ub(t, torch.from_numpy(idx), block_m=16, persistent=persistent)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_gm_matches_pallas(shape, dtype):
    # the Pallas GM kernel's row DMA takes only in-range ids
    t, j, idx = _bag_inputs(shape, dtype, invalid=False)
    want = jax_gm(j, jnp.asarray(idx), interpret=True)
    got = embedding_bag_gm(t, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_l1_matches_ref(shape, dtype):
    t, j, idx = _bag_inputs(shape, dtype, invalid=False)
    want = jref.embedding_bag_ref(j.astype(jnp.float32), jnp.asarray(idx))
    got = embedding_bag_l1(t, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_invalid_ids_contribute_zero(strategy):
    """-1 and ids >= m pool to exactly zero (never the last row)."""
    t, j, _ = _bag_inputs((40, 16, 6, 3), "float32")
    idx = np.array([[-1, -1, -1], [39, -1, 40], [0, 1, 2], [-5, 41, 39],
                    [7, 7, 7], [-1, 3, -1]], np.int32)
    got = ops.strategy_bag(t, torch.from_numpy(idx), strategy)
    want = jref.chunk_bag_ref(j, jnp.asarray(idx), 0)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_ops_embedding_bag_matches_ref(strategy):
    t, j, idx = _bag_inputs((100, 16, 32, 4), "float32", invalid=False)
    for pooling in ("sum", "mean"):
        got = ops.embedding_bag(t, torch.from_numpy(idx), strategy, pooling=pooling)
        want = jref.embedding_bag_ref(j, jnp.asarray(idx), pooling=pooling)
        assert got.dtype == t.dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ref_oracles_match_jax():
    t, j, idx = _bag_inputs((64, 16, 8, 3), "float32", invalid=False)
    ti = torch.from_numpy(idx)
    np.testing.assert_allclose(
        ref.gather_ref(t, ti).numpy(), np.asarray(jref.gather_ref(j, jnp.asarray(idx))), **TOL)
    for off in (0, 10, 60):
        np.testing.assert_allclose(
            ref.chunk_bag_ref(t[off:off + 20], ti, off).numpy(),
            np.asarray(jref.chunk_bag_ref(j[off:off + 20], jnp.asarray(idx), off)), **TOL)
        np.testing.assert_allclose(
            ref.chunk_gather_ref(t[off:off + 20], ti, off).numpy(),
            np.asarray(jref.chunk_gather_ref(j[off:off + 20], jnp.asarray(idx), off)), **TOL)
    with pytest.raises(IndexError):
        ref.embedding_bag_ref(t, torch.full((2, 2), -1, dtype=torch.int32))


def _ub_writes(m, ids, sched):
    """How often the UB kernel's grid writes each lookup position: CTA
    (range x, chunk y) writes the positions of chunk y whose id lies in range
    x, and for s = 1 range 0 also writes the positions of invalid ids."""
    flat = ids.reshape(-1)
    writes = np.zeros(flat.size, np.int64)
    for x in range(sched.n_ranges):
        lo, hi = x * sched.range_rows, min(m, (x + 1) * sched.range_rows)
        for y in range(sched.n_chunks):
            v = flat[y * sched.chunk_ids:(y + 1) * sched.chunk_ids]
            hit = writes[y * sched.chunk_ids:(y + 1) * sched.chunk_ids]
            hit += (v >= lo) & (v < hi)
            if ids.shape[1] == 1 and x == 0:
                hit += (v < 0) | (v >= m)
    return writes


def test_launch_geometry():
    """Tile/range choices the CUDA launches use: the L1 kernel resident when
    the table fits, and a table no cluster holds on the UB kernel's grid;
    the UB kernel's grid at path A's shapes (taobao table 1
    plus its zero row, B = 8192, s = 1) cuts the table into ranges that each
    row lies in exactly once, with the ids as one chunk (so every row is read
    by one CTA), 2 x 132 CTAs (two per SM: one wave), and a small table as
    one range whose ids are split over more than one CTA per SM."""
    l1 = l1_schedule(100, 64, 8192, 1, 132)
    assert (l1.mode, l1.cluster, l1.rows_per_cta, l1.smem) == ("resident", 1, 100, 6400)
    assert 0 < l1.grid <= 2 * 132
    big = l1_schedule(1_000_000, 64, 8192, 1, 132)
    assert (big.mode, big.cluster, big.smem) == ("beyond", 0, 0)
    assert big.ub == ub_schedule(1_000_000, 8192, 64, block_m=512, persistent=False, n_sms=132)
    assert big.grid == big.ub.n_ranges * big.ub.n_chunks
    m = 846_813
    sched = ub_schedule(m, 8192, 64, block_m=512, persistent=False, n_sms=132)
    assert sched.tile_rows * 64 == TILE_BYTES and sched.range_rows % 8 == 0
    assert sched.n_ranges * sched.range_rows >= m > (sched.n_ranges - 1) * sched.range_rows
    assert (sched.n_chunks, sched.chunk_ids) == (1, 8192)
    assert sched.n_ranges * sched.n_chunks == 2 * 132
    assert -(-sched.range_rows // sched.tile_rows) <= MAX_TILES
    for persistent in (True, False):
        small = ub_schedule(98, 8192, 64, block_m=512, persistent=persistent, n_sms=132)
        assert (small.n_ranges, small.range_rows, small.tile_rows) == (1, 98, 98)
        assert 132 < small.n_ranges * small.n_chunks <= 2 * 132 and small.n_chunks * small.chunk_ids >= 8192


def _check_l1_slices(m, row_bytes, sched):
    """Every row of the table lies in exactly one CTA's slice of a cluster
    (or the resident CTA's), each slice within its budget, ``C`` a power of
    two up to 16 that divides the grid; beyond: the UB ranges cover the
    table.  Under the default model of the card, which schedules every
    cluster size."""
    if sched.mode == "beyond":
        assert -(-m // max(CLUSTER_SIZES)) * row_bytes > RESIDENT_BYTES
        assert sched.ub.n_ranges * sched.ub.range_rows >= m
        assert sched.rows_per_cta == sched.ub.range_rows
        assert sched.grid == sched.ub.n_ranges * sched.ub.n_chunks
        return
    c, r = sched.cluster, sched.rows_per_cta
    assert c in (1, *CLUSTER_SIZES) and c & (c - 1) == 0
    assert sched.grid >= c and sched.grid % c == 0
    assert sched.smem == r * row_bytes
    owner = np.minimum(np.arange(m) // max(r, 1), c)
    np.testing.assert_array_equal(np.bincount(owner, minlength=c)[c:], 0)  # each row in one slice
    assert (sched.mode == "resident") == (m * row_bytes <= RESIDENT_BYTES)
    if sched.mode == "resident":
        assert (c, r) == (1, m) and sched.smem <= RESIDENT_BYTES
        return
    assert c > 1 and sched.smem <= RESIDENT_BYTES and (c - 1) * r < m <= c * r
    if sched.smem <= CLUSTER_BYTES:  # the smallest size whose slice meets the target
        assert all(-(-m // k) * row_bytes > CLUSTER_BYTES for k in CLUSTER_SIZES if k < c)
    else:  # no size meets it: the largest
        assert c == max(CLUSTER_SIZES)


@pytest.mark.parametrize("rows,row_bytes,mode,cluster", [
    (12_979, 64, "cluster", 16),   # taobao table 2 + zero row, f32: 830,656 B
    (12_979, 32, "cluster", 8),    # the same in bf16/f16
    (99, 64, "resident", 1),       # a 98-row table + zero row
    (4_096, 64, "cluster", 4),     # 256 KB
    (16_385, 64, "cluster", 16),   # ascend_910's largest L1 table (1 MiB) + zero row
    (200_000, 64, "beyond", 0),    # 12.8 MB
])
def test_l1_schedule_cases(rows, row_bytes, mode, cluster):
    """The modes the main path and the cost-model presets reach: taobao's
    table 2 goes to a cluster in f32 and bf16, a 98-row table is resident,
    the largest table ``ascend_910`` (1 MiB of L1) sends at E = 16 f32 takes
    a cluster of 16 (its slice past the 64 KB target), and a 12.8 MB table
    goes beyond."""
    sched = l1_schedule(rows, row_bytes, 8192, 1, 132)
    assert (sched.mode, sched.cluster) == (mode, cluster)
    _check_l1_slices(rows, row_bytes, sched)
    if mode == "cluster":  # one (query, 16-byte vector) per thread, 1024 threads a CTA
        assert sched.threads == 1024
        assert sched.grid == cluster * -(-8192 * row_bytes // 16 // (1024 * cluster))


def test_l1_schedule_follows_the_card():
    """The clusters the card holds bound the grid; a portable cluster it
    cannot schedule raises; where a non-portable one (16) does not schedule,
    the table takes 8 if its slices fit a CTA, else it goes beyond; a batch
    that fills no cluster of 1024-thread CTAs takes 256 threads."""
    one = l1_schedule(12_979, 64, 8192, 1, 132, active_clusters=lambda c, smem, threads: 1)
    assert (one.mode, one.cluster, one.grid, one.threads) == ("cluster", 16, 16, 1024)
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        l1_schedule(12_979, 64, 8192, 1, 132, active_clusters=lambda c, smem, threads: 0)
    no16 = dict(active_clusters=lambda c, smem, threads: 0 if c > 8 else 4)
    assert l1_schedule(16_385, 64, 8192, 1, 132, **no16).cluster == 8
    rows16 = 16 * (RESIDENT_BYTES // 64)
    assert l1_schedule(rows16, 64, 8192, 1, 132).cluster == 16
    assert l1_schedule(rows16, 64, 8192, 1, 132, **no16).mode == "beyond"
    small = l1_schedule(12_979, 64, 512, 1, 132)
    assert (small.cluster, small.threads, small.grid) == (16, 256, 16)


@settings(max_examples=200, deadline=None)
@given(
    m=st.integers(min_value=0, max_value=80_000),
    row_bytes=st.sampled_from([8, 20, 24, 32, 48, 64, 128, 256]),
    b=st.integers(min_value=1, max_value=20_000),
    s=st.integers(min_value=1, max_value=4),
    n_sms=st.sampled_from([66, 132]),
)
def test_l1_schedule_slices_cover_table(m, row_bytes, b, s, n_sms):
    """Whatever the table and batch, on a card whose SMs hold a cluster of
    every size: each row in exactly one CTA's slice, each slice within the
    budget, ``C`` a power of two <= 16 dividing the grid, and the grid at
    most the clusters the SMs hold."""
    sched = l1_schedule(m, row_bytes, b, s, n_sms)
    _check_l1_slices(m, row_bytes, sched)
    if sched.mode == "cluster":
        per_sm = min(2048 // sched.threads, (228 * 1024) // (sched.smem + 1024))
        assert sched.grid // sched.cluster <= max(1, n_sms * per_sm // sched.cluster)


@pytest.mark.parametrize("persistent", [False, True])
@pytest.mark.parametrize("shape", [(846_813, 8192, 1, 512), (12_979, 8192, 1, 512),
                                   (98, 8192, 1, 512), (200_000, 5000, 1, 64),
                                   (3000, 700, 2, 64), (513, 33, 5, 16), (0, 5, 1, 64),
                                   (5000, 8192, 3, 512)])
def test_ub_schedule_writes_each_output_once(shape, persistent):
    """Over every (range, chunk) CTA, each lookup position is written exactly
    once (s = 1: rows and invalid ids alike) or, for s > 1, once if its id is
    valid; the ranges cover the table with at most MAX_TILES tiles each."""
    m, b, s, block_m = shape
    sched = ub_schedule(m, b * s, 64, block_m=block_m, persistent=persistent, n_sms=132)
    assert 1 <= sched.tile_rows <= sched.range_rows
    assert sched.n_chunks == 1 or sched.chunk_ids % 4 == 0  # aligned 16-byte id loads
    assert sched.n_ranges * sched.n_chunks <= 2 * 132 or sched.range_rows == MAX_TILES * sched.tile_rows
    assert -(-sched.range_rows // sched.tile_rows) <= MAX_TILES
    assert sched.n_ranges * sched.range_rows >= m
    assert sched.n_chunks * sched.chunk_ids >= b * s > (sched.n_chunks - 1) * sched.chunk_ids
    ids = np.random.default_rng(0).integers(-2, m + 3, size=(b, s))
    writes = _ub_writes(m, ids, sched)
    want = 1 if s == 1 else ((ids >= 0) & (ids < m)).reshape(-1)
    np.testing.assert_array_equal(writes, want)


def test_wrappers_reject_unhandled_device():
    """No silent fallback: a tensor on a device with neither a kernel nor a
    plain version raises, and so do mixed devices."""
    t = torch.zeros((8, 16), device="meta")
    idx = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    for fn in (embedding_bag_gm, embedding_bag_l1, embedding_bag_ub):
        with pytest.raises(ValueError, match="device"):
            fn(t, idx)
        with pytest.raises(ValueError, match="share one device"):
            fn(torch.zeros((8, 16)), idx)
    with pytest.raises(ValueError, match="device"):
        multi_embedding_bag_ragged(
            torch.zeros((8, 16), device="meta"),
            torch.zeros((1, 2, 1), dtype=torch.int32, device="meta"),
            torch.zeros((1,), dtype=torch.int32, device="meta"),
            torch.zeros((0, 5), dtype=torch.int32, device="meta"),
            block_r=8,
        )
