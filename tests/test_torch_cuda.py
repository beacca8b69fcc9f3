"""The CUDA kernels on the card against their plain versions, and the
engine on the card against the same engine on the CPU.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode): it is
marked ``cuda`` and skips without one.  This file imports no JAX, so it
runs on a machine with only PyTorch:
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Tolerance: rtol = atol = 1e-5 for every table dtype (bf16/f16 rows convert
exactly to f32; kernel and plain version differ only in f32 summation
order).  The dedup gather's two data flows are held bitwise equal, and so
are the access call and its plain version at s = 1, the fused base kernel
and the dense kernel and their plain versions at every s (all sum in
position order from 0.0) and the UB, GM and L1
kernels and ``bag_f32`` for s = 1 (a row copy).  The dedup kernel is held
array-equal to ``dedup_indices``, the unique-row gather to
``gather_unique_rows_plain``, and the slot join bitwise to its plain
version (both add in the plain join's order from 0.0).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.strategies import ALL_STRATEGIES
from repro_torch.core.tables import make_workload
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.embedding_gm import embedding_bag_gm
from repro_torch.kernels.embedding_l1 import (
    CLUSTER_BYTES,
    RESIDENT_BYTES,
    embedding_bag_l1,
    schedule_for,
)
from repro_torch.kernels import embedding_multi
from repro_torch.kernels.embedding_multi import (
    CACHE_STAGE_BYTES,
    SCATTER_QUERIES,
    batch_dedup,
    dedup_indices,
    gather_unique_rows,
    gather_unique_rows_plain,
    multi_embedding_bag_dense,
    multi_embedding_bag_dense_plain,
    multi_embedding_bag_ragged,
    multi_embedding_bag_ragged_plain,
    ragged_runs,
    ragged_stage_rows,
)
from repro_torch.kernels.embedding_rejoin import slot_rejoin, slot_rejoin_plain
from repro_torch.kernels.embedding_ub import embedding_bag_ub
from test_torch_rejoin import CASES as JOIN_CASES, _random_partials as join_random_partials

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
BLOCK_R = 16
# (strategy code, steps) per slot; two trash-slot padding steps follow
SCHEDULE = [(1, 3), (0, 1), (3, 2), (2, 4), (2, 200), (0, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _schedule():
    slot, base, block, strat = [], [], [], []
    blk = 0
    for s_i, (code, n) in enumerate(SCHEDULE):
        for j in range(n):
            slot.append(s_i)
            base.append(j * BLOCK_R)
            block.append(blk)
            strat.append(code)
            blk += 1
    slot += [len(SCHEDULE)] * 2
    base += [0, 0]
    block += [0, 0]
    strat += [0, 0]
    return [np.asarray(a, np.int32) for a in (slot, base, block, strat)], blk * BLOCK_R


@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_kernel_matches_plain(cuda, dtype):
    """Every strategy code (staged and gathered regions), multi-step slots,
    padding steps, -1 and out-of-window ids, two cores in one launch."""
    rng = np.random.default_rng(0)
    steps, t_rows = _schedule()
    k, b, s = 2, 700, 3
    buf = torch.from_numpy(rng.standard_normal((k, t_rows + 1, 16)).astype(np.float32)).to(dtype)
    regions = [n * BLOCK_R for _, n in SCHEDULE]
    lidx = np.stack([np.stack([rng.integers(-3, r + 9, size=(b, s)) for r in regions])
                     for _ in range(k)]).astype(np.int32)
    steps2 = [np.stack([a, a]) for a in steps]
    runs = ragged_runs(steps2[0], steps2[1], steps2[3], BLOCK_R, len(SCHEDULE))
    stage_rows = ragged_stage_rows(runs, BLOCK_R, 16 * buf.element_size())
    assert stage_rows > 0  # staged and gathered L1 regions both run
    lidx_d, block_d, runs_d = (torch.from_numpy(a).to(cuda) for a in (lidx, steps2[2], runs))
    before = multi_embedding_bag_ragged.launches
    got = multi_embedding_bag_ragged(buf.to(cuda)[:, :-1], lidx_d, block_d, runs_d,
                                     block_r=BLOCK_R, stage_rows=stage_rows)
    torch.cuda.synchronize()
    assert multi_embedding_bag_ragged.launches == before + 1
    want = multi_embedding_bag_ragged_plain(
        buf.to(cuda)[:, :-1], lidx_d, block_d, runs_d, block_r=BLOCK_R)
    assert torch.equal(got, want)
    cpu = multi_embedding_bag_ragged_plain(buf[:, :-1], torch.from_numpy(lidx),
                                           torch.from_numpy(steps2[2]), torch.from_numpy(runs),
                                           block_r=BLOCK_R)
    assert torch.equal(got.cpu(), cpu)


# --------------------------------------------------------------------------
# the fused base kernel (K1): vector and scalar paths, run-less slots
# --------------------------------------------------------------------------

# per core, (slot, strategy code, steps) in schedule order: staged L1 and
# L1-UB regions, GM and GM-UB regions, an L1 region too large to stage (200
# steps of 16 rows: 200 KB in f32, 100 KB in bf16/f16); core 0 has no run
# for slot 2, core 1 none for slots 1, 3 and 4; padding steps fill core 1 up
BASE_RUNS = [[(0, 2, 3), (1, 0, 1), (3, 3, 2), (4, 2, 200)], [(2, 1, 2), (0, 2, 1)]]
BASE_SLOTS = 5
BASE_EMPTY = [(0, 2), (1, 1), (1, 3), (1, 4)]


def _base_case(cuda, dtype, e, s, *, unaligned=False, b=700, seed=21):
    """Two cores of the schedule above: (buffer, lidx, step_block, runs) on
    the card and the staging capacity, with ids from -3 past each region
    (slots without a run get ids too).  ``unaligned`` shifts the buffer one
    element off 16 bytes and gives it an odd core stride."""
    rng = np.random.default_rng(seed)
    n_steps = max(sum(n for _, _, n in runs) for runs in BASE_RUNS)
    slot = np.full((2, n_steps), BASE_SLOTS, np.int32)
    base = np.zeros((2, n_steps), np.int32)
    block = np.zeros((2, n_steps), np.int32)
    code = np.zeros((2, n_steps), np.int32)
    for core, runs in enumerate(BASE_RUNS):
        t = 0
        for sl, c, n in runs:
            slot[core, t:t + n] = sl
            base[core, t:t + n] = np.arange(n) * BLOCK_R
            block[core, t:t + n] = rng.permutation(n_steps)[:n]  # blocks in any order
            code[core, t:t + n] = c
            t += n
    runs = ragged_runs(slot, base, code, BLOCK_R, BASE_SLOTS)
    t_rows = n_steps * BLOCK_R
    table = rng.standard_normal((2, t_rows, e)).astype(np.float32)
    buf = torch.from_numpy(table).to(dtype).to(cuda)
    if unaligned:
        stride = t_rows * e + 1
        flat = torch.zeros(2 * stride + 1, dtype=dtype, device=cuda)
        view = flat[1:].as_strided((2, t_rows, e), (stride, e, 1))
        view.copy_(buf)
        buf = view
    lidx = np.stack([np.stack([
        rng.integers(-3, dict((sl, n) for sl, _, n in runs_c).get(sl, 1) * BLOCK_R + 9,
                     size=(b, s)) for sl in range(BASE_SLOTS)]) for runs_c in BASE_RUNS])
    stage_rows = ragged_stage_rows(runs, BLOCK_R, e * buf.element_size())
    return (buf, torch.from_numpy(lidx.astype(np.int32)).to(cuda),
            torch.from_numpy(block).to(cuda), torch.from_numpy(runs).to(cuda)), stage_rows


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("staged", [True, False])
def test_ragged_base_kernel_bitwise(cuda, dtype, s, staged):
    """The base kernel's vector path bitwise equal to its plain version at
    s = 1 and s = 3, with its L1 regions staged in shared memory or all
    gathered (``stage_rows=0``): one launch, counted on the vector path; the
    slots without a run come out zero."""
    args, stage_rows = _base_case(cuda, dtype, 16, s)
    assert stage_rows > 0  # staged and gathered L1 regions both run
    paths = multi_embedding_bag_ragged.paths
    before = dict(paths), multi_embedding_bag_ragged.launches
    got = multi_embedding_bag_ragged(*args, block_r=BLOCK_R,
                                     stage_rows=stage_rows if staged else 0)
    torch.cuda.synchronize()
    assert multi_embedding_bag_ragged.launches == before[1] + 1
    assert paths["base_vector"] == before[0]["base_vector"] + 1
    assert torch.equal(got, multi_embedding_bag_ragged_plain(*args, block_r=BLOCK_R))
    for core, slot in BASE_EMPTY:
        assert not got[core, slot].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("queries", list(SCATTER_QUERIES))
def test_ragged_base_any_queries_per_thread(cuda, dtype, queries):
    """The base kernel at each count of queries a thread (the grid the
    wrapper may pick), bitwise at s = 3, staged and gathered regions."""
    args, stage_rows = _base_case(cuda, dtype, 16, 3, seed=22)
    got = embedding_multi._launch(*args, BLOCK_R, stage_rows, queries=queries)
    torch.cuda.synchronize()
    assert torch.equal(got, multi_embedding_bag_ragged_plain(*args, block_r=BLOCK_R))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,unaligned", [(6, False), (16, True)])
@pytest.mark.parametrize("s", [1, 3])
def test_ragged_base_scalar_path(cuda, dtype, e, unaligned, s):
    """Rows that are no whole number of 16-byte vectors, or a buffer off 16
    bytes with an odd core stride, take the scalar kernel: bitwise equal to
    the plain version, staged regions included."""
    args, stage_rows = _base_case(cuda, dtype, e, s, unaligned=unaligned)
    paths = multi_embedding_bag_ragged.paths
    before = dict(paths)
    got = multi_embedding_bag_ragged(*args, block_r=BLOCK_R, stage_rows=stage_rows)
    torch.cuda.synchronize()
    assert paths["base_scalar"] == before["base_scalar"] + 1
    assert torch.equal(got, multi_embedding_bag_ragged_plain(*args, block_r=BLOCK_R))


@pytest.mark.parametrize("e", [16, 6])
def test_ragged_runless_slots_zero_over_nan_memory(cuda, e):
    """The kernel writes every output element itself: when the allocator
    hands back memory that was just filled with NaN, the slots without a run
    come out exactly zero and no NaN is left (vector and scalar paths)."""
    args, stage_rows = _base_case(cuda, torch.float32, e, 1)
    k, s_slots, b, _ = args[1].shape
    junk = torch.full((k, s_slots, b, e), float("nan"), device=cuda)
    ptr = junk.data_ptr()
    del junk
    got = multi_embedding_bag_ragged(*args, block_r=BLOCK_R, stage_rows=stage_rows)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr  # the NaN block came back
    assert not torch.isnan(got).any()
    for core, slot in BASE_EMPTY:
        assert torch.equal(got[core, slot], torch.zeros_like(got[core, slot]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(16, 16, 4, 1), (513, 32, 33, 5), (3000, 16, 700, 2),
                                   (200_000, 16, 5000, 1)])
def test_strategy_kernels_match_plain(cuda, shape, dtype):
    m, e, b, s = shape
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.standard_normal((m, e)).astype(np.float32)).to(dtype).to(cuda)
    idx = torch.from_numpy(rng.integers(-2, m + 3, size=(b, s)).astype(np.int32)).to(cuda)
    want = ref.bag_f32(t, idx)
    counters = (embedding_bag_gm, embedding_bag_l1, embedding_bag_ub)
    before = sum(c.launches for c in counters)
    for strategy in ALL_STRATEGIES:
        got = ops.strategy_bag(t, idx, strategy, block_m=64)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL, msg=lambda m_: f"{strategy}: {m_}")
    assert sum(c.launches for c in counters) == before + len(ALL_STRATEGIES)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["uniform", "one_row", "hot_range", "pooled"])
@pytest.mark.parametrize("persistent", [False, True])
def test_ub_kernel_skew_and_pooling(cuda, dtype, case, persistent):
    """K2 on a table larger than one tile and on a resident one: uniform ids,
    a batch of one repeated row (one CTA takes every hit and walks its ids in
    pieces), most ids in one range, and s = 3 with ids outside [0, m) and -1
    padding.  s = 1 is bitwise equal to ``bag_f32``; s = 3 within TOL."""
    rng = np.random.default_rng(3)
    m = 100 if persistent else 150_000
    b, s = 5000, (3 if case == "pooled" else 1)
    t = torch.from_numpy(rng.standard_normal((m, 16)).astype(np.float32)).to(dtype).to(cuda)
    ids = rng.integers(0, m, size=(b, s))
    if case == "one_row":
        ids[:] = m // 3
    elif case == "hot_range":
        ids[: 4 * b // 5] = rng.integers(0, 40, size=(4 * b // 5, s))
    elif case == "pooled":
        ids[rng.random(ids.shape) < 0.2] = -1
        ids[::7, 1] = m + 5
        ids[::11, 2] = -9
    idx = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    before = embedding_bag_ub.launches
    got = embedding_bag_ub(t, idx, persistent=persistent)
    torch.cuda.synchronize()
    assert embedding_bag_ub.launches == before + 1
    want = ref.bag_f32(t, idx)
    if s == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)


def _table(rng, m, e, dtype, cuda, *, aligned=True):
    """An (m, e) table on the card; ``aligned=False`` gives a contiguous
    table whose data starts 4 bytes past a 16-byte boundary."""
    t = torch.from_numpy(rng.standard_normal((m, e)).astype(np.float32)).to(dtype)
    if aligned:
        return t.to(cuda)
    flat = torch.empty(m * e + 8, dtype=dtype, device=cuda)
    start = 4 // t.element_size()
    view = flat[start:start + m * e].view(m, e)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


# table bytes per L1 case: the mode and cluster size l1_schedule gives them
L1_CASES = {
    "resident": (RESIDENT_BYTES, "resident", 1),
    "cluster_4": (4 * CLUSTER_BYTES, "cluster", 4),
    "cluster_8": (8 * CLUSTER_BYTES, "cluster", 8),
    "cluster_16": (16 * CLUSTER_BYTES, "cluster", 16),
    "cluster_16_past_target": (16 * RESIDENT_BYTES, "cluster", 16),
    "beyond": (12_800_000, "beyond", 0),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(L1_CASES))
def test_l1_kernel_modes(cuda, dtype, case):
    """K4 in each mode: resident, a cluster of every size ``l1_schedule``
    picks (16 where the card schedules it, else 8 or beyond), 16 with
    slices up to the CTA budget, and beyond (the UB kernel); bitwise equal
    to ``bag_f32`` at s = 1 with ids outside [0, m); the per-mode counter
    counts the launch."""
    from repro_torch.kernels.embedding_l1 import card_clusters

    rng = np.random.default_rng(12)
    e = 16
    table_bytes, want_mode, want_c = L1_CASES[case]
    row_bytes = e * torch.tensor([], dtype=dtype).element_size()
    m = table_bytes // row_bytes
    t = _table(rng, m, e, dtype, cuda)
    ids = rng.integers(0, m, size=(5000, 1))
    ids[::97] = -1
    ids[5::101] = m + 7
    idx = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    sched = schedule_for(t, idx)
    active = card_clusters(t.device.index, build.dtype_code(dtype))
    if want_c == 16 and active(16, -(-m // 16) * row_bytes, sched.threads) < 1:
        want_mode, want_c = ("cluster", 8) if -(-m // 8) * row_bytes <= RESIDENT_BYTES else (
            "beyond", 0)
    assert (sched.mode, sched.cluster if sched.mode != "beyond" else 0) == (want_mode, want_c)
    before = dict(embedding_bag_l1.modes)
    launches = embedding_bag_l1.launches
    got = embedding_bag_l1(t, idx)
    torch.cuda.synchronize()
    assert embedding_bag_l1.launches == launches + 1
    assert {k: v - before[k] for k, v in embedding_bag_l1.modes.items()} == {
        k: int(k == want_mode) for k in before}
    assert torch.equal(got, ref.bag_f32(t, idx))


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
@pytest.mark.parametrize("threads", [256, 1024])
@pytest.mark.parametrize("s", [1, 3])
def test_l1_kernel_any_cluster_size(cuda, cluster, threads, s):
    """The cluster kernel at every size and CTA width, forced (l1_schedule
    picks no cluster of 2: two slices of at most 64 KB hold a resident
    table), on a 400 KB f32 table with ids outside [0, m): bitwise equal to
    ``bag_f32`` at s = 1, within TOL at s = 3."""
    from repro_torch.kernels.embedding_l1 import card_clusters, cluster_schedule, launch

    rng = np.random.default_rng(15)
    m, b = 6400, 3000
    t = _table(rng, m, 16, torch.float32, cuda)
    ids = rng.integers(-2, m + 3, size=(b, s))
    idx = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    smem = -(-m // cluster) * 64
    active = card_clusters(t.device.index, 0)(cluster, smem, threads)
    assert active >= 1
    got = launch(t, idx, cluster_schedule(m, 64, b, cluster, active, threads))
    torch.cuda.synchronize()
    want = ref.bag_f32(t, idx)
    if s == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["uniform", "one_row", "pooled", "unaligned"])
def test_l1_kernel_taobao_table2(cuda, dtype, case):
    """K4 at taobao table 2's shape (12,978 rows plus the zero row, E = 16,
    B = 8192) in the cluster mode: uniform ids, one repeated row, s = 3 with
    -1 padding and ids >= m, and a table 4 bytes off a 16-byte boundary (the
    scalar path).  s = 1 is bitwise equal to ``bag_f32``; s = 3 within TOL."""
    rng = np.random.default_rng(13)
    m, b = 12_979, 8192
    s = 3 if case == "pooled" else 1
    t = _table(rng, m, 16, dtype, cuda, aligned=case != "unaligned")
    ids = rng.integers(0, m, size=(b, s))
    if case == "one_row":
        ids[:] = 4321
    elif case == "pooled":
        ids[rng.random(ids.shape) < 0.2] = -1
        ids[::7, 1] = m + 5
        ids[::11, 2] = m
    idx = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    assert schedule_for(t, idx).mode == "cluster"
    before = embedding_bag_l1.modes["cluster"]
    got = embedding_bag_l1(t, idx)
    torch.cuda.synchronize()
    assert embedding_bag_l1.modes["cluster"] == before + 1
    want = ref.bag_f32(t, idx)
    if s == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e", [16, 32, 5, 12])
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("aligned", [True, False])
def test_gm_kernel_matches_plain(cuda, dtype, e, s, aligned):
    """K3 with 16-byte vector loads (E = 16 and 32; E = 12 in bf16/f16) and
    on its scalar path (E = 5, rows of 20 or 10 bytes; E = 12 in f32, three
    vectors a row; a table 4 bytes off a 16-byte boundary), s = 1 and 3,
    ids outside [0, m) and -1 padding.  s = 1 is bitwise equal to
    ``bag_f32``; s = 3 within TOL."""
    rng = np.random.default_rng(14)
    m, b = 100_003, 3001
    t = _table(rng, m, e, dtype, cuda, aligned=aligned)
    ids = rng.integers(0, m, size=(b, s))
    ids[rng.random(ids.shape) < 0.1] = -1
    ids[::13, 0] = m
    ids[::17, s - 1] = -7
    idx = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    before = embedding_bag_gm.launches
    got = embedding_bag_gm(t, idx)
    torch.cuda.synchronize()
    assert embedding_bag_gm.launches == before + 1
    want = ref.bag_f32(t, idx)
    if s == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)


def _dedup_ids(case, rng):
    """(slots, B, s) ids and the unique cap of one dedup edge case."""
    if case == "all_padding":
        return np.full((3, 200, 2), -1, np.int32), 16
    if case == "one_id":
        return np.full((3, 200, 2), 77, np.int32), 16
    if case == "cap_one":
        return rng.integers(-1, 500, size=(4, 300, 1)).astype(np.int32), 1
    if case == "cap_above_distinct":
        return rng.integers(-1, 30, size=(4, 300, 1)).astype(np.int32), 64
    if case == "seq3":
        return rng.integers(-3, 5000, size=(5, 700, 3)).astype(np.int32), 600
    if case == "wide":  # past one bitmap window, with empty stretches between ids
        ids = rng.integers(0, 3_000_000, size=(3, 4096, 1))
        ids[:, ::5] = rng.integers(2**31 - 5000, 2**31 - 1, size=ids[:, ::5].shape)
        ids[:, ::9] = 2**31 - 1  # the plain op's padding key: spilled, never unique
        return ids.astype(np.int32), 3000
    return rng.integers(-1, 1_141_730, size=(8, 8192, 1)).astype(np.int32), 1856


@pytest.mark.parametrize("case", ["all_padding", "one_id", "cap_one", "cap_above_distinct",
                                  "seq3", "wide", "taobao_chunk"])
def test_dedup_kernel_matches_plain(cuda, case):
    """The dedup kernel's uniq, rank and spill are array-equal to
    ``dedup_indices`` on the card and on the CPU ("wide" spans several
    bitmap windows with empty stretches between them)."""
    ids, cap = _dedup_ids(case, np.random.default_rng(8))
    lidx = torch.from_numpy(ids).to(cuda)
    before = batch_dedup.launches
    got = batch_dedup(lidx, cap)
    torch.cuda.synchronize()
    assert batch_dedup.launches == before + 1
    for a, b, c in zip(got, dedup_indices(lidx, cap), dedup_indices(torch.from_numpy(ids), cap)):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), c)


def test_dedup_source_is_built():
    assert "embedding_dedup" in build.SOURCES


@pytest.mark.parametrize("planner", ["asymmetric", "symmetric"])
def test_engine_on_card_matches_cpu(cuda, planner):
    wl = small_workload(batch=64)
    config = EngineConfig(mesh_shape=(1, 4), distribution="uniform", planner=planner,
                          planner_options={"shard_rocks": False} if planner == "asymmetric" else {})
    tables = [torch.randn((t.rows, t.dim), generator=torch.Generator().manual_seed(i))
              for i, t in enumerate(wl.tables)]
    gpu = InferenceEngine.build(tables, wl, config)
    cpu = InferenceEngine.build(tables, wl, config, device="cpu")
    assert gpu.device.type == "cuda"
    rng = np.random.default_rng(2)
    idx = np.full((len(wl.tables), 64, 4), -1, np.int32)
    for i, t in enumerate(wl.tables):
        idx[i, :, : t.seq] = rng.integers(0, t.rows, size=(64, t.seq))
    for reduce_mode in ("sparse", "psum", "ring"):
        gpu.config.reduce_mode = cpu.config.reduce_mode = reduce_mode
        torch.testing.assert_close(gpu.lookup(idx).cpu(), cpu.lookup(idx), **TOL)


def _cards_cases(rank, tmp):
    """Every case of ``test_torch_multicard`` with one plan core per card."""
    from test_torch_multicard import CASES, _inputs
    from repro_torch.launch.mesh import init_card_mesh

    mesh = init_card_mesh()
    wl, tables, idx = _inputs()
    out = {}
    for name, cfg in CASES.items():
        if cfg.get("mesh_shape") and np.prod(cfg["mesh_shape"]) != mesh.size():
            continue
        eng = InferenceEngine.build(tables, wl, EngineConfig(**cfg), mesh=mesh)
        assert eng.device == torch.device("cuda", rank)
        if rank == 0:
            out[name] = eng.lookup(idx).cpu()
            eng.close()
        else:
            eng.follow()
    torch.save(out, f"{tmp}/cards_{rank}.pt")


def test_partitioned_lookup_across_cards(cuda, tmp_path):
    """One NCCL rank per card (every card of the host, two or more), each
    holding one plan core: each case equals the one-card engine of the same
    plan within 1e-5."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    from test_torch_multicard import CASES, _inputs, spawn

    codes, errors = spawn(_cards_cases, tmp_path, world=n, device="cuda", timeout_s=300)
    assert codes == [0] * n, errors
    got = torch.load(tmp_path / "cards_0.pt")
    wl, tables, idx = _inputs()
    for name, cfg in CASES.items():
        if name not in got:
            continue
        cfg = dict(cfg)
        cfg.setdefault("mesh_shape", [1, n])
        one = InferenceEngine.build(tables, wl, EngineConfig(**cfg))
        torch.testing.assert_close(got[name], one.lookup(idx).cpu(), **TOL, msg=name)


def _sharded_lm_one_card(rank, tmp):
    """qwen3-smoke on a (1, 1) card mesh (NCCL, this process's card)."""
    from test_torch_sharded_lm import QWEN, _case
    from repro_torch.launch.mesh import init_card_mesh

    _case("qwen3_1x1", rank, init_card_mesh(device_type="cuda"), tmp,
          spec=(1, (1, 1), QWEN, "accum"))


def test_sharded_lm_one_card_mesh(cuda, tmp_path):
    """The DeviceMesh path on one card: qwen3-smoke (two accumulated
    microbatches, two strided prefill sub-batches) with every leaf a
    ``DTensor`` of a (1, 1) NCCL mesh, against the unsharded train step,
    prefill and decode on the card: the loss and every gradient, the
    prefill's logits and caches and each decode step's logits within
    ``1e-5 * max(|ref|, 1)``; the local bytes equal ``per_device_bytes``."""
    from test_torch_multicard import spawn
    from test_torch_sharded_lm import QWEN, _cfg, _inputs, _run
    from repro_torch.tree import leaves, tree_map

    codes, errors = spawn(_sharded_lm_one_card, tmp_path, world=1, device="cuda",
                          timeout_s=300)
    assert codes == [0], errors
    got = torch.load(tmp_path / "qwen3_1x1_0.pt", weights_only=False)
    cfg = _cfg(QWEN, "accum")
    want = _run(cfg, *tree_map(lambda x: x.to(cuda), _inputs(cfg)))

    def close(a, b, what):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
        assert err <= 1e-5, (what, err)

    close(got["loss"], want["loss"], "loss")
    for a, b in zip(leaves(got["grads"]), leaves(want["grads"])):
        close(a, b, "grad")
    close(got["prefill"], want["prefill"], "prefill")
    for key in want["cache"]:
        close(got["cache"][key], want["cache"][key], key)
    for t, (a, b) in enumerate(zip(got["decode"], want["decode"])):
        close(a, b, f"decode {t}")
    for what, (local, per_device) in got["bytes"].items():
        assert local == per_device, (what, local, per_device)


def _sharded_families_one_card(rank, tmp):
    """mamba2-smoke and whisper-smoke on a (1, 1) card mesh (NCCL, this
    process's card): the whole results and the local bytes."""
    from test_torch_sharded_families import FAMILIES, _cfg
    from test_torch_sharded_lm import _bytes, _full, _inputs, _run, _shapes
    from repro_torch.launch.dryrun import make_ctx
    from repro_torch.launch.mesh import init_card_mesh

    mesh = init_card_mesh(device_type="cuda")
    for fam in ("mamba2", "whisper"):
        cfg = _cfg(FAMILIES[fam])
        out, placed = _run(cfg, *_inputs(cfg), make_ctx(mesh, _shapes()[0], False), mesh)
        torch.save(_full(out) | {"bytes": _bytes(cfg, mesh, placed)}, f"{tmp}/{fam}.pt")


def test_sharded_families_one_card_mesh(cuda, tmp_path):
    """The split mamba mixer and whisper's position rows and split cross
    cache on one card: mamba2-smoke and whisper-smoke with every leaf a
    ``DTensor`` of a (1, 1) NCCL mesh, against the unsharded train step,
    prefill and decode on the card, within ``1e-5 * max(|ref|, 1)``; the
    local bytes equal ``per_device_bytes``."""
    from test_torch_multicard import spawn
    from test_torch_sharded_families import FAMILIES, _cfg
    from test_torch_sharded_lm import _inputs, _run
    from repro_torch.tree import leaves, tree_map

    codes, errors = spawn(_sharded_families_one_card, tmp_path, world=1, device="cuda",
                          timeout_s=300)
    assert codes == [0], errors

    def close(a, b, what):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
        assert err <= 1e-5, (what, err)

    for fam in ("mamba2", "whisper"):
        got = torch.load(tmp_path / f"{fam}.pt", weights_only=False)
        cfg = _cfg(FAMILIES[fam])
        want = _run(cfg, *tree_map(lambda x: x.to(cuda), _inputs(cfg)))
        close(got["loss"], want["loss"], (fam, "loss"))
        for a, b in zip(leaves(got["grads"]), leaves(want["grads"]), strict=True):
            close(a, b, (fam, "grad"))
        close(got["prefill"], want["prefill"], (fam, "prefill"))
        for key in want["cache"]:
            close(got["cache"][key], want["cache"][key], (fam, key))
        for t, (a, b) in enumerate(zip(got["decode"], want["decode"], strict=True)):
            close(a, b, (fam, f"decode {t}"))
        for what, (local, per_device) in got["bytes"].items():
            assert local == per_device, (fam, what, local, per_device)


def _access_case(cuda, dtype, *, unique_cap, cache_rows, seed=4):
    """Two cores, every strategy code, padding steps, -1 and out-of-window
    ids, a spill-prone slot, hot lookups split off through ``hidx``."""
    rng = np.random.default_rng(seed)
    steps, t_rows = _schedule()
    k, b, s = 2, 700, 3
    buf = torch.from_numpy(rng.standard_normal((k, t_rows + 1, 16)).astype(np.float32)).to(dtype)
    regions = [n * BLOCK_R for _, n in SCHEDULE]
    lidx = np.stack([np.stack([rng.integers(-3, r + 9, size=(b, s)) for r in regions])
                     for _ in range(k)]).astype(np.int32)
    lidx[:, 1] = 5  # all-duplicate slot
    steps2 = [np.stack([a, a]) for a in steps]
    runs = ragged_runs(steps2[0], steps2[1], steps2[3], BLOCK_R, len(SCHEDULE))
    kw = dict(block_r=BLOCK_R, unique_cap=unique_cap)
    if cache_rows:
        hidx = np.where(rng.random(lidx.shape) < 0.3,
                        rng.integers(0, cache_rows, size=lidx.shape), -1).astype(np.int32)
        lidx = np.where(hidx >= 0, -1, lidx).astype(np.int32)
        cache = torch.from_numpy(rng.standard_normal((k, cache_rows, 16)).astype(np.float32))
        kw.update(cache=cache.to(dtype).to(cuda), hidx=torch.from_numpy(hidx).to(cuda))
    d = {n: torch.from_numpy(a).to(cuda) for n, a in
         zip(("slot", "base", "block", "strat"), steps2)}
    args = (buf.to(cuda)[:, :-1], torch.from_numpy(lidx).to(cuda), d["block"],
            torch.from_numpy(runs).to(cuda))
    return args, kw, d


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("unique_cap,cache_rows", [(64, 0), (8, 0), (0, 24), (64, 24), (4, 8)])
def test_access_kernel_matches_plain(cuda, dtype, unique_cap, cache_rows):
    """Dedup (with and without spill), the cache, both, against the plain
    version; forced one-hot and sparse gathers bitwise equal."""
    args, kw, d = _access_case(cuda, dtype, unique_cap=unique_cap, cache_rows=cache_rows)
    want = multi_embedding_bag_ragged_plain(*args, **kw)
    outs = []
    for kpath in ((None,) if not unique_cap else (0, 1)):
        extra = dict(step_slot=d["slot"], step_base=d["base"])
        if kpath is not None:
            extra["step_kpath"] = torch.full_like(d["block"], kpath)
        before = dict(multi_embedding_bag_ragged.modes)
        got = multi_embedding_bag_ragged(*args, **kw, **extra)
        torch.cuda.synchronize()
        modes = multi_embedding_bag_ragged.modes
        assert modes["dedup"] - before["dedup"] == bool(unique_cap)
        assert modes["cache"] - before["cache"] == bool(cache_rows)
        torch.testing.assert_close(got, want, **TOL)
        outs.append(got)
    for other in outs[1:]:
        assert torch.equal(other, outs[0])


@pytest.mark.parametrize("access", ["dedup", "cache", "full"])
def test_access_engine_on_card_matches_cpu(cuda, access):
    wl = small_workload(batch=64)
    config = EngineConfig(mesh_shape=(1, 4), distribution="zipf:1.2", hardware="a100",
                          access=access, kernel_path="auto",
                          planner_options={"shard_rocks": True})
    tables = [torch.randn((t.rows, t.dim), generator=torch.Generator().manual_seed(i))
              for i, t in enumerate(wl.tables)]
    gpu = InferenceEngine.build(tables, wl, config)
    cpu = InferenceEngine.build(tables, wl, config, device="cpu")
    rng = np.random.default_rng(2)
    idx = np.full((len(wl.tables), 64, 4), -1, np.int32)
    for i, t in enumerate(wl.tables):
        idx[i, :, : t.seq] = rng.integers(0, min(t.rows, 50), size=(64, t.seq))
    torch.testing.assert_close(gpu.lookup(idx).cpu(), cpu.lookup(idx), **TOL)


def _dense_case(k, seq, *, seed=6, s_slots=3, rows=1001, b=1037):
    """(K, S, R+1, E) stacks with a zero last row and an empty last slot;
    ids in [0, R], some at 0 and at R, a batch that fills no tile evenly."""
    rng = np.random.default_rng(seed)
    chunks = rng.standard_normal((k, s_slots, rows, 16)).astype(np.float32)
    chunks[:, :, -1] = 0
    chunks[:, -1] = 0
    lidx = rng.integers(0, rows, size=(k, s_slots, b, seq)).astype(np.int32)
    lidx[:, :, ::7, 0] = 0
    lidx[:, :, ::5, -1] = rows - 1
    lidx[:, -1] = rows - 1
    return torch.from_numpy(chunks), torch.from_numpy(lidx)


def test_dense_source_is_built():
    assert "embedding_dense" in build.SOURCES


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seq", [1, 3])
def test_dense_kernel_matches_plain(cuda, dtype, seq):
    """Two cores in one launch, bitwise equal to the plain version on the
    card and on the CPU; the empty slot comes out zero."""
    chunks, lidx = _dense_case(2, seq)
    chunks = chunks.to(dtype)
    c_d, l_d = chunks.to(cuda), lidx.to(cuda)
    before = multi_embedding_bag_dense.launches, multi_embedding_bag_dense.paths["vector"]
    got = multi_embedding_bag_dense(c_d, l_d)
    torch.cuda.synchronize()
    assert multi_embedding_bag_dense.launches == before[0] + 1
    assert multi_embedding_bag_dense.paths["vector"] == before[1] + 1
    assert torch.equal(got, multi_embedding_bag_dense_plain(c_d, l_d))
    assert torch.equal(got.cpu(), multi_embedding_bag_dense_plain(chunks, lidx))
    assert not got[:, -1].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_kernel_single_core_and_ids_outside(cuda, dtype):
    """The reference's 3-D one-core call; an id outside [0, R] gives zero
    (the plain version refuses it, callers pre-clip)."""
    chunks, lidx = _dense_case(1, 3, seed=7)
    chunks = chunks[0].to(dtype).to(cuda)
    ids = lidx[0].to(cuda)
    got = multi_embedding_bag_dense(chunks, ids)
    torch.cuda.synchronize()
    assert got.shape == (3, 1037, 16)
    torch.testing.assert_close(got, multi_embedding_bag_dense_plain(chunks[None], ids[None])[0],
                               **TOL)
    rows = chunks.shape[1]
    bad = ids.clone()
    bad[:, ::2, 1] = -4
    bad[:, 1::2, 1] = rows + 2
    on_zero_row = torch.where((bad < 0) | (bad >= rows), rows - 1, bad)
    want = multi_embedding_bag_dense_plain(chunks[None], on_zero_row[None])[0]
    assert torch.equal(multi_embedding_bag_dense(chunks, bad), want)
    with pytest.raises(IndexError):
        multi_embedding_bag_dense_plain(chunks[None], bad[None])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("queries", list(SCATTER_QUERIES))
def test_dense_kernel_any_queries_per_thread(cuda, dtype, queries):
    """The dense kernel at each count of queries a thread, bitwise at s = 3."""
    chunks, lidx = _dense_case(2, 3, seed=8)
    c_d, l_d = chunks.to(dtype).to(cuda), lidx.to(cuda)
    got = embedding_multi._launch_dense(c_d, l_d, queries=queries)
    torch.cuda.synchronize()
    assert torch.equal(got, multi_embedding_bag_dense_plain(c_d, l_d))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,unaligned", [(6, False), (16, True)])
@pytest.mark.parametrize("seq", [1, 3])
def test_dense_kernel_scalar_path(cuda, dtype, e, unaligned, seq):
    """Rows that are no whole number of 16-byte vectors, or a stack off 16
    bytes, take the scalar kernel: bitwise equal to the plain version."""
    chunks, lidx = _dense_case(2, seq, seed=9)
    chunks = chunks[..., :e].contiguous().to(dtype).to(cuda)
    if unaligned:
        flat = torch.zeros(chunks.numel() + 1, dtype=dtype, device=cuda)
        flat[1:].copy_(chunks.reshape(-1))
        chunks = flat[1:].view(chunks.shape)
    l_d = lidx.to(cuda)
    paths = multi_embedding_bag_dense.paths
    before = dict(paths)
    got = multi_embedding_bag_dense(chunks, l_d)
    torch.cuda.synchronize()
    assert paths["scalar"] == before["scalar"] + 1
    assert torch.equal(got, multi_embedding_bag_dense_plain(chunks, l_d))


def test_dense_engine_on_card_matches_cpu(cuda):
    wl = small_workload(batch=64)
    config = EngineConfig(mesh_shape=(1, 4), distribution="uniform", layout="dense",
                          planner_options={"shard_rocks": False})
    tables = [torch.randn((t.rows, t.dim), generator=torch.Generator().manual_seed(i))
              for i, t in enumerate(wl.tables)]
    gpu = InferenceEngine.build(tables, wl, config)
    cpu = InferenceEngine.build(tables, wl, config, device="cpu")
    assert gpu.packed.layout == "dense"
    rng = np.random.default_rng(2)
    idx = np.full((len(wl.tables), 64, 4), -1, np.int32)
    for i, t in enumerate(wl.tables):
        idx[i, :, : t.seq] = rng.integers(0, t.rows, size=(64, t.seq))
    before = multi_embedding_bag_dense.launches
    for reduce_mode in ("sparse", "psum", "ring"):
        gpu.config.reduce_mode = cpu.config.reduce_mode = reduce_mode
        torch.testing.assert_close(gpu.lookup(idx).cpu(), cpu.lookup(idx), **TOL)
    assert multi_embedding_bag_dense.launches == before + 3


# --------------------------------------------------------------------------
# the served access call's unique-row gather and vector scatter
# --------------------------------------------------------------------------

ACCESS_BLOCK_R = 16
# per core, (slot, steps) in schedule order; slot 2 has no run on core 0,
# slots 1 and 3 none on core 1; padding steps fill core 1 up
ACCESS_RUNS = [[(0, 3), (3, 2), (1, 1)], [(2, 4), (0, 1)]]
ACCESS_SLOTS = 4


def _unique_case(cuda, dtype, e, *, u=300, unaligned=False, seed=12):
    """Two cores of the schedule above, a (K, S, U) unique-id array with
    sorted ids (some past the slot's region) and -1 padding; U = 300 fills no
    CTA tile evenly.  ``unaligned`` starts the buffer 4 bytes past a 16-byte
    boundary."""
    rng = np.random.default_rng(seed)
    n_steps = max(sum(n for _, n in c) for c in ACCESS_RUNS)
    step_slot = np.full((2, n_steps), ACCESS_SLOTS, np.int32)
    step_base = np.zeros((2, n_steps), np.int32)
    step_block = np.zeros((2, n_steps), np.int32)
    uniq = np.full((2, ACCESS_SLOTS, u), -1, np.int32)
    for core, runs in enumerate(ACCESS_RUNS):
        blocks = rng.permutation(n_steps)
        t = 0
        for slot, n in runs:
            step_slot[core, t:t + n] = slot
            step_base[core, t:t + n] = np.arange(n) * ACCESS_BLOCK_R
            step_block[core, t:t + n] = blocks[t:t + n]
            t += n
        for slot in range(ACCESS_SLOTS):
            region = dict(runs).get(slot, 1) * ACCESS_BLOCK_R
            m = int(rng.integers(u // 2, u + 1))
            ids = rng.choice(region + 40, size=min(m, region + 40), replace=False)
            uniq[core, slot, :len(ids)] = np.sort(ids)
    t_rows = n_steps * ACCESS_BLOCK_R
    flat = torch.from_numpy(rng.standard_normal(2 * t_rows * e + 8).astype(np.float32))
    flat = flat.to(dtype).to(cuda)
    off = 1 if unaligned else 0
    buf = flat[off:off + 2 * t_rows * e].view(2, t_rows, e)
    runs = ragged_runs(step_slot, step_base, np.zeros_like(step_slot), ACCESS_BLOCK_R,
                       ACCESS_SLOTS)
    d = {n: torch.from_numpy(a).to(cuda) for n, a in
         (("slot", step_slot), ("base", step_base), ("block", step_block), ("runs", runs),
          ("uniq", uniq))}
    return buf, d


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,unaligned,path", [(16, False, "vector"), (6, False, "scalar"),
                                              (16, True, "scalar")])
def test_gather_kernel_array_equal_to_plain(cuda, dtype, e, unaligned, path):
    """The unique-row gather is an exact copy: array-equal to
    ``gather_unique_rows_plain`` (and to the CPU's) with -1 padding, ids past
    the region, slots without a run and U off the CTA tile, in the 16-byte
    vector path and the scalar one (E = 6, or an unaligned buffer)."""
    buf, d = _unique_case(cuda, dtype, e, unaligned=unaligned)
    before = dict(gather_unique_rows.paths)
    got = gather_unique_rows(buf, d["uniq"], d["block"], d["runs"], block_r=ACCESS_BLOCK_R)
    torch.cuda.synchronize()
    assert gather_unique_rows.paths[path] == before[path] + 1
    want = gather_unique_rows_plain(buf, d["uniq"], d["block"], d["runs"],
                                    block_r=ACCESS_BLOCK_R)
    assert torch.equal(got, want)
    cpu = gather_unique_rows_plain(buf.cpu(), d["uniq"].cpu(), d["block"].cpu(),
                                   d["runs"].cpu(), block_r=ACCESS_BLOCK_R)
    assert torch.equal(got.cpu(), cpu)
    assert not got[0, 2].any() and not got[1, 1].any()  # slots without a run


def _scatter_case(cuda, dtype, e, s, *, cache_rows, unaligned=False, seed=13):
    """The gather case's schedule with (K, S, B, s) ids over each slot's
    region (-1 padding and out-of-window ids included) and, with a cache, 30%
    of lookups split off to hot rows."""
    buf, d = _unique_case(cuda, dtype, e, unaligned=unaligned)
    rng = np.random.default_rng(seed)
    b = 700
    lidx = np.full((2, ACCESS_SLOTS, b, s), -1, np.int32)
    for core, runs in enumerate(ACCESS_RUNS):
        for slot in range(ACCESS_SLOTS):
            region = dict(runs).get(slot, 1) * ACCESS_BLOCK_R
            lidx[core, slot] = rng.integers(-3, region + 9, size=(b, s))
    kw = dict(block_r=ACCESS_BLOCK_R, step_slot=d["slot"], step_base=d["base"])
    if cache_rows:
        hidx = np.where(rng.random(lidx.shape) < 0.3,
                        rng.integers(0, cache_rows, size=lidx.shape), -1).astype(np.int32)
        lidx = np.where(hidx >= 0, -1, lidx).astype(np.int32)
        cache = rng.standard_normal((2, cache_rows, e)).astype(np.float32)
        kw.update(cache=torch.from_numpy(cache).to(dtype).to(cuda),
                  hidx=torch.from_numpy(hidx).to(cuda))
    return (buf, torch.from_numpy(lidx).to(cuda), d["block"], d["runs"]), kw


# cache rows: none, staged in shared memory, and past CACHE_STAGE_BYTES (read
# from L2) at every dtype's row size
SCATTER_CACHES = {"none": 0, "staged": 24, "l2": 4200}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("cache,unique_cap", [
    (cache, cap) for cache in SCATTER_CACHES for cap in (0, 256, 8) if cache != "none" or cap])
def test_access_scatter_matches_plain(cuda, dtype, s, cache, unique_cap):
    """The served access call (dedup kernel, gather, vector scatter) against
    its plain version: bitwise at s = 1, within TOL at s = 3; with the
    dedup's spill (cap 8), the cache staged or read from L2, and the cache
    alone.  Counted by the wrapper's own counters: one gather and one scatter
    launch, both 16-byte vector paths."""
    cache_rows = SCATTER_CACHES[cache]
    args, kw = _scatter_case(cuda, dtype, 16, s, cache_rows=cache_rows)
    if cache == "l2":
        assert cache_rows * 16 * args[0].element_size() > CACHE_STAGE_BYTES
    paths = multi_embedding_bag_ragged.paths
    before = dict(paths), batch_dedup.launches
    got = multi_embedding_bag_ragged(*args, unique_cap=unique_cap, **kw)
    torch.cuda.synchronize()
    assert paths["gather_vector"] - before[0]["gather_vector"] == bool(unique_cap)
    assert paths["scatter_vector"] - before[0]["scatter_vector"] == 1
    assert batch_dedup.launches - before[1] == bool(unique_cap)
    plain_kw = {k: v for k, v in kw.items() if k not in ("step_slot", "step_base")}
    want = multi_embedding_bag_ragged_plain(*args, unique_cap=unique_cap, **plain_kw)
    if s == 1:
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, **TOL)
    assert not got[0, 2].any() and not got[1, 1].any()  # slots without a run


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("queries", list(SCATTER_QUERIES))
def test_access_scatter_any_queries_per_thread(cuda, dtype, queries):
    """The vector scatter at each count of queries a thread (the grid the
    wrapper may pick), bitwise at s = 1 with dedup, spill and the cache."""
    args, kw = _scatter_case(cuda, dtype, 16, 1, cache_rows=24)
    buf, lidx, block, runs = args
    got = embedding_multi._launch_access(
        buf, lidx, block, runs, ACCESS_BLOCK_R, 64, kw["cache"], kw["hidx"], None,
        kw["step_slot"], kw["step_base"], queries=queries)
    torch.cuda.synchronize()
    want = multi_embedding_bag_ragged_plain(*args, block_r=ACCESS_BLOCK_R, unique_cap=64,
                                            cache=kw["cache"], hidx=kw["hidx"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e,unaligned", [(6, False), (16, True)])
@pytest.mark.parametrize("s", [1, 3])
def test_access_scalar_path_matches_plain(cuda, dtype, e, unaligned, s):
    """Rows that are no whole number of 16-byte vectors, or an unaligned
    buffer, take the scalar gather and scatter: bitwise at s = 1, within TOL
    at s = 3, with dedup, spill and the cache."""
    args, kw = _scatter_case(cuda, dtype, e, s, cache_rows=24, unaligned=unaligned)
    paths = multi_embedding_bag_ragged.paths
    before = dict(paths)
    got = multi_embedding_bag_ragged(*args, unique_cap=8, **kw)
    torch.cuda.synchronize()
    assert paths["gather_scalar"] == before["gather_scalar"] + 1
    assert paths["scatter_scalar"] == before["scatter_scalar"] + 1
    plain_kw = {k: v for k, v in kw.items() if k not in ("step_slot", "step_base")}
    want = multi_embedding_bag_ragged_plain(*args, unique_cap=8, **plain_kw)
    if s == 1:
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, **TOL)


# --------------------------------------------------------------------------
# the slot join: the card's sparse rejoin
# --------------------------------------------------------------------------

SERVED = Path(__file__).resolve().parent.parent / "portbench" / "configs"


def _served_pack(name, b):
    """The benchmark configuration ``name`` packed on the host as it is
    served (zero tables: the join reads only the plan's maps)."""
    cfg = json.loads((SERVED / f"dlrm-{name}.json").read_text())
    wl = make_workload(cfg["name"], cfg["rows"], dim=cfg["embed_dim"], seqs=cfg["seqs"],
                       batch=b, dtype_bytes=cfg["plan_dtype_bytes"])
    config = EngineConfig.from_dict({**cfg["engine"], "dtype": cfg["dtype"]})
    return InferenceEngine.build("abstract", wl, config, device="cpu").packed


def _join_partials(k, s, b, e, seed):
    """Normal partials with a tenth of the entries -0.0 and a tenth +0.0."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((k, s, b, e), generator=g)
    pick = torch.rand((k, s, b, e), generator=g)
    x[pick < 0.1] = -0.0
    x[(pick >= 0.1) & (pick < 0.2)] = 0.0
    return x


@pytest.mark.parametrize("name", ["taobao", "tenrec"])
@pytest.mark.parametrize("b,e,path", [(262_144, 16, "vector"), (1000, 16, "vector"),
                                      (1001, 6, "scalar")])
def test_rejoin_kernel_bitwise_equal_to_plain(cuda, name, b, e, path):
    """The join kernel at the served shapes (B = 262,144), at a batch whose
    plane is no multiple of the CTA, and on single floats (a plane of an
    odd number of pairs), bit for bit its plain version's, -0.0 included."""
    packed = _served_pack(name, b)
    k, s = packed.slot_table.shape
    partials = _join_partials(k, s, b, e, seed=b)
    ptr, terms = packed.rejoin_ptr, packed.rejoin_terms
    want = slot_rejoin_plain(partials, ptr, terms)
    before = slot_rejoin.launches, dict(slot_rejoin.paths)
    got = slot_rejoin(partials.to(cuda), ptr.to(cuda), terms.to(cuda))
    torch.cuda.synchronize()
    assert slot_rejoin.launches == before[0] + 1
    assert slot_rejoin.paths[path] == before[1][path] + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", list(JOIN_CASES))
def test_rejoin_kernel_on_every_kind_of_pack(cuda, case):
    """The join kernel, bit for bit its plain version, on the CPU tests'
    packs: several slots of one table on one core, replicas, the two-level
    maps, empty slots beside a table no core holds, -0.0 partials."""
    packed, _, partials = JOIN_CASES[case]()
    for x in ([] if partials is None else [partials]) + [join_random_partials(packed)]:
        want = slot_rejoin_plain(x, packed.rejoin_ptr, packed.rejoin_terms)
        got = slot_rejoin(x.to(cuda), packed.rejoin_ptr.to(cuda), packed.rejoin_terms.to(cuda))
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def _join_engines(cuda):
    wl = small_workload(batch=64)
    config = EngineConfig(mesh_shape=(1, 4), distribution="uniform",
                          planner_options={"shard_rocks": False})
    tables = [torch.randn((t.rows, t.dim), generator=torch.Generator().manual_seed(i))
              for i, t in enumerate(wl.tables)]
    gpu = InferenceEngine.build(tables, wl, config)
    cpu = InferenceEngine.build(tables, wl, config, device="cpu")
    rng = np.random.default_rng(4)
    idx = np.full((len(wl.tables), 64, 4), -1, np.int32)
    for i, t in enumerate(wl.tables):
        idx[i, :, : t.seq] = rng.integers(0, t.rows, size=(64, t.seq))
    return gpu, cpu, idx


def test_sparse_lookup_on_card_launches_the_join_once(cuda):
    """A served sparse lookup on the card launches the fused access kernel
    once and the join once; the result is the CPU engine's, and bit for bit
    the plain join of the card's own slot partials.  ``psum`` and ``ring``
    keep the plain join and launch no join."""
    from repro_torch.core import partition

    gpu, cpu, idx = _join_engines(cuda)
    for _ in range(2):
        before = slot_rejoin.launches, multi_embedding_bag_ragged.launches
        got = gpu.lookup(idx)
        torch.cuda.synchronize()
        assert slot_rejoin.launches == before[0] + 1
        assert multi_embedding_bag_ragged.launches == before[1] + 1
    torch.testing.assert_close(got.cpu(), cpu.lookup(idx), **TOL)
    packed, n_tables = gpu.packed, gpu.bag.n_tables
    sidx = torch.as_tensor(idx, device=cuda)
    pooled = partition._slot_partials(packed, sidx, use_kernels="fused")
    plain = partition._sparse_rejoin(partition._scatter_slots(packed, pooled, n_tables), packed)
    joined = slot_rejoin(pooled, packed.rejoin_ptr, packed.rejoin_terms)
    assert torch.equal(joined.view(torch.int32), plain.view(torch.int32))
    for reduce_mode in ("psum", "ring"):
        gpu.config.reduce_mode = cpu.config.reduce_mode = reduce_mode
        before = slot_rejoin.launches
        torch.testing.assert_close(gpu.lookup(idx).cpu(), cpu.lookup(idx), **TOL)
        assert slot_rejoin.launches == before


def test_lookup_spans_on_card(cuda):
    """Under a profiler the card's sparse lookup opens ``repro.lookup`` with
    the child spans ``index_copy``, ``slot_ids``, ``access`` and
    ``rejoin``: the join has no ``scatter`` stage."""
    gpu, _, idx = _join_engines(cuda)
    gpu.lookup(idx)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gpu.lookup(idx)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.name.startswith("repro.lookup")}
    assert names == {"repro.lookup", "repro.lookup.index_copy", "repro.lookup.slot_ids",
                     "repro.lookup.access", "repro.lookup.rejoin"}


# a spin of about 0.1 s at the H100's clocks: long past a small lookup's enqueue
HOLD_CYCLES = 200_000_000


def _old_copy_lookup(gpu, idx):
    """The lookup of a tensor made by ``torch.as_tensor(indices, device=)``,
    the copy the index copy made before it staged host indices."""
    return gpu.bag.apply(gpu.packed, torch.as_tensor(idx, device=gpu.device))


def test_host_indices_do_not_wait_for_the_stream(cuda):
    """Behind a spin on the current stream, a fused lookup of a numpy batch
    returns while the stream is still busy: the host no longer drains it
    before the index copy.  The result is bitwise the old copy's."""
    gpu, _, idx = _join_engines(cuda)
    want = _old_copy_lookup(gpu, idx)
    gpu.bag.apply(gpu.packed, idx)  # builds the kernels, caches a staging block
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    got = gpu.bag.apply(gpu.packed, idx)
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_the_callers_array_may_change_once_the_lookup_returns(cuda):
    """The caller overwrites its array as soon as the lookup returns, while
    the card has not yet copied the batch: the result is still bitwise the
    old copy's of the original ids."""
    gpu, _, idx = _join_engines(cuda)
    want = _old_copy_lookup(gpu, idx)
    gpu.bag.apply(gpu.packed, idx)
    torch.cuda.synchronize()
    mine = idx.copy()
    torch.cuda._sleep(HOLD_CYCLES)
    got = gpu.bag.apply(gpu.packed, mine)
    mine[...] = np.random.default_rng(9).permutation(mine.reshape(-1)).reshape(mine.shape)
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_batches_back_to_back_behind_a_held_stream(cuda):
    """Four different batches, int32 and int64, one of them a strided view,
    one a CPU tensor, enqueued behind one spin: each is bitwise the old
    copy's lookup, and under counting every byte went through a staging
    buffer (none for a tensor already on the card)."""
    from repro_torch import tracing

    gpu, _, idx = _join_engines(cuda)
    rng = np.random.default_rng(11)
    batches = [np.where(idx >= 0, rng.permutation(idx.reshape(-1)).reshape(idx.shape) % 7, -1)
               .astype(np.int32) for _ in range(4)]
    batches = [batches[0], batches[1].astype(np.int64),
               np.repeat(batches[2], 2, axis=1)[:, ::2], torch.from_numpy(batches[3])]
    assert not batches[2].flags.c_contiguous
    wants = [_old_copy_lookup(gpu, b) for b in batches]
    for b in batches:
        gpu.bag.apply(gpu.packed, b)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    with tracing.counting() as counts:
        gots = [gpu.bag.apply(gpu.packed, b) for b in batches]
        assert not torch.cuda.current_stream().query()
    nbytes = sum(b.nbytes if isinstance(b, np.ndarray) else b.numel() * b.element_size()
                 for b in batches)
    assert counts["index_copy_staged_bytes"] == counts["index_copy_bytes"] == nbytes
    for got, want in zip(gots, wants):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with tracing.counting() as on_card:
        gpu.bag.apply(gpu.packed, torch.as_tensor(idx, device=cuda))
    assert on_card["index_copy_staged_bytes"] == on_card["index_copy_bytes"] == 0


def test_broadcast_batch_stages_the_served_indices(cuda):
    """The served step's index move, ``engine.broadcast_batch`` (which the
    serve CLI's step calls before its lookup), returns behind a held stream
    and stages every byte; the lookup on its tensor copies nothing more,
    and the result is bitwise the old copy's."""
    from repro_torch import tracing

    gpu, _, idx = _join_engines(cuda)
    want = _old_copy_lookup(gpu, idx)
    gpu.bag.apply(gpu.packed, gpu.broadcast_batch(idx))
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    with tracing.counting() as counts:
        got = gpu.bag.apply(gpu.packed, gpu.broadcast_batch(idx))
        assert not torch.cuda.current_stream().query()
    assert counts["index_copy_staged_bytes"] == idx.nbytes
    assert counts["index_copy_bytes"] == 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64])
def test_to_device_does_not_wait_for_the_stream(cuda, dtype):
    """A host array of the dense features, the labels or the indices, as
    the serve CLI's step and the DLRM training loop move them: behind a
    held stream the copy returns at once, the caller may overwrite its
    array, and the card reads the values it had; nothing is counted
    without a counter."""
    from repro_torch import tracing
    from repro_torch.device import to_device

    want = np.random.default_rng(3).integers(-1, 1000, (64, 13)).astype(dtype)
    to_device(want, cuda)
    torch.cuda.synchronize()
    mine = want.copy()
    torch.cuda._sleep(HOLD_CYCLES)
    with tracing.counting() as counts:
        got = to_device(mine, cuda)
        mine[...] = 0
        assert not torch.cuda.current_stream().query()
    assert counts == {}
    assert got.device.type == "cuda" and got.dtype == torch.from_numpy(want).dtype
    assert np.array_equal(got.cpu().numpy(), want)


def test_the_served_step_makes_no_pageable_copy(cuda):
    """The serve CLI's step on the card, run again on its last batch: under
    counting every index byte goes through a staging buffer, and the
    profiler records no copy from pageable memory to the card."""
    from repro_torch import tracing
    from repro_torch.launch import serve

    res = serve.main(["--workload", "smoke", "--batch", "16", "--queries", "32",
                      "--distribution", "uniform"])
    last, step = res["last"], res["server"].step_fn
    idx = last["indices"]
    payloads = [{"dense": last["dense"][i], "indices": idx[:, i]} for i in range(16)]
    with tracing.counting() as counts:
        logits = step(payloads)
    assert counts["index_copy_staged_bytes"] == idx.nbytes
    assert np.allclose(logits, last["logits"], rtol=1e-6, atol=1e-6)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(payloads)
        torch.cuda.synchronize()
    copies = {e.name for e in prof.events() if e.name.startswith("Memcpy HtoD")}
    assert copies and not any("Pageable" in name for name in copies)


def test_sweep_on_the_card_ranks_by_device_time(cuda):
    """The CUDA sweep times every candidate by the card's own time and picks
    the least ``device_us``; ``wall_us`` stays recorded beside it."""
    wl = small_workload(batch=64)
    config = EngineConfig(mesh_shape=(1, 4), distribution="zipf:1.2", hardware="a100",
                          access="full", tuning="sweep", planner_options={"shard_rocks": True})
    eng = InferenceEngine.build(None, wl, config)
    t = eng.plan.meta["tuning"]
    assert t["backend"] == "cuda" and t["compiled"] is True
    assert [c["block_r"] for c in t["candidates"]] == [64, 128, 256, 512]
    assert all(isinstance(c["device_us"], float) and c["device_us"] > 0
               and c["wall_us"] > 0 for c in t["candidates"])
    assert t["best"]["device_us"] == min(c["device_us"] for c in t["candidates"])
    assert eng.packed.block_r == t["best"]["block_r"]


@pytest.mark.parametrize("field", ["chunk_data", "cache_data"])
def test_bitflip_on_the_card_detected_and_healed_bitwise(cuda, field):
    """A bit flipped in a packed buffer on the card: the manifest (equal to
    the CPU engine's) finds the region the CPU engine reports for the same
    flip, and the in-place heal leaves every buffer bitwise equal to a
    fresh pack; the served batch after it equals the CPU's."""
    from repro_torch.data.distributions import Zipf, sample_workload
    from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultSpec, \
        arm_buffer_corruption

    wl = small_workload(batch=16)
    rng = np.random.default_rng(0)
    tables = [rng.standard_normal((t.rows, t.dim)).astype(np.float32) for t in wl.tables]
    config = EngineConfig(mesh_shape=(1, 4), distribution="zipf:1.2", hardware="a100",
                          access="full", integrity="checksum",
                          planner_options={"shard_rocks": True})
    card = InferenceEngine.build(tables, wl, config)
    cpu = InferenceEngine.build(tables, wl, config, device="cpu")
    assert card.packed.cache_rows > 0
    assert card.manifest.checksums == cpu.manifest.checksums
    fields = ("chunk_data", "cache_data", "sym_data")
    pristine = {f: getattr(card.packed, f).clone() for f in fields}
    bad = {}
    for name, eng in (("card", card), ("cpu", cpu)):
        if field == "chunk_data":
            inj = FaultInjector(FaultPlan([FaultSpec("buffer", mode="bitflip", count=3)], seed=5))
            arm_buffer_corruption(inj, eng, type("NoServer", (), {"step_fn": None}))
            inj.fire("buffer", batch=0)
        else:
            eng.packed.cache_data[1, 2, 3:4].view(torch.int32).bitwise_xor_(1 << 27)
        bad[name] = eng.verify_integrity()
        report = eng.heal()
        assert report["clean"] and report["healed"] and not report["quarantined"]
    assert bad["card"] == bad["cpu"] and bad["card"]
    for f in fields:
        assert torch.equal(getattr(card.packed, f), pristine[f]), f
        assert torch.equal(getattr(card.packed, f).cpu(), getattr(cpu.packed, f)), f
    idx = sample_workload(rng, wl, Zipf(1.2), 16)
    torch.testing.assert_close(card.lookup(idx).cpu(), cpu.lookup(idx), **TOL)


def test_sweep_on_a_worker_thread_counts_only_its_own_kernels(cuda):
    """The block-size sweep of a shadow build runs on a worker thread while
    the server launches its own kernels: each candidate's ``device_us``
    (CUDA events on the sweep's own stream) stays within 20% of the same
    sweep run alone, and two sweeps at once raise no error."""
    import copy
    import threading

    from repro_torch.core.autotune import autotune_block_sizes
    from repro_torch.data.workloads import get_workload

    wl = get_workload("taobao", 512)
    config = EngineConfig(distribution="zipf:1.2", access="full", mesh_shape=(1, 1),
                          planner_options={"shard_rocks": True})
    eng = InferenceEngine.build(None, wl, config)

    def sweep(out, key):
        plan = copy.deepcopy(eng.plan)  # each sweep records into its own plan
        try:
            autotune_block_sizes(plan, wl.tables, batch=wl.batch, freqs=eng.freqs,
                                 device="cuda")
            out[key] = [c["device_us"] for c in plan.meta["tuning"]["candidates"]]
        except Exception as e:  # reported below
            out[key] = e

    res = {}
    sweep(res, "warm")
    sweep(res, "alone")
    workers = [threading.Thread(target=sweep, args=(res, k)) for k in ("loaded", "second")]
    for w in workers:
        w.start()
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, t.rows, (wl.batch, 1)) for t in wl.tables]).astype(np.int32)
    lookups = 0
    while any(w.is_alive() for w in workers):
        eng.lookup(idx)
        torch.cuda.synchronize()
        lookups += 1
    for w in workers:
        w.join()
    assert lookups > 0
    for key in ("alone", "loaded", "second"):
        assert not isinstance(res[key], Exception), res[key]
        assert len(res[key]) == 4 and all(v > 0 for v in res[key])
    for a, b in zip(res["alone"], res["loaded"]):
        assert abs(b - a) <= 0.2 * a, (res["alone"], res["loaded"])


def test_rebuild_keeps_its_block_sizes_under_load(cuda):
    """A drift replan's shadow build on the card: taobao-zipf12's first
    engine (swept) is rebuilt under the hot-set histogram twice, once alone
    and once on a worker thread while the main thread launches lookups.
    Both rebuilds pack the live engine's block sizes and run no sweep, so
    the pick cannot follow the load; each rebuilt engine's lookup equals
    its plain view's within 1e-5.  The seconds of each are printed."""
    import threading
    import time

    from repro_torch.configs.presets import load_preset
    from repro_torch.core.autotune import TuningCache
    from repro_torch.data.distributions import get_distribution, workload_probs
    from repro_torch.data.workloads import get_workload

    preset = load_preset("taobao-zipf12")
    config = EngineConfig.from_dict(preset["config"])
    assert config.tuning == "sweep"
    wl = get_workload(preset["workload"], config.max_batch)
    eng = InferenceEngine.build(None, wl, config)
    assert eng.plan.meta["tuning"]["best"]["block_r"] == eng.packed.block_r
    hot = workload_probs(wl, get_distribution("hotset:0.01:0.9:-1"))
    built = {}

    def rebuild(key):
        eng.tuning_cache = TuningCache()  # no cached pick to fall back on
        t0 = time.perf_counter()
        try:
            built[key] = (eng.rebuild(hot), time.perf_counter() - t0)
        except Exception as e:  # reported below
            built[key] = (e, None)

    rebuild("alone")
    worker = threading.Thread(target=rebuild, args=("loaded",))
    worker.start()
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, t.rows, (wl.batch, 1)) for t in wl.tables]).astype(np.int32)
    lookups = 0
    while worker.is_alive():
        eng.lookup(idx)
        torch.cuda.synchronize()
        lookups += 1
    worker.join(timeout=600)
    assert not worker.is_alive() and lookups > 0
    print(json.dumps({"block_r": eng.packed.block_r, "lookups_beside": lookups,
                      **{k: s for k, (_, s) in built.items()}}))
    for key, (new, _) in built.items():
        assert not isinstance(new, Exception), new
        assert "tuning" not in new.plan.meta, key
        assert (new.packed.block_r, new.packed.block_b) == (eng.packed.block_r,
                                                             eng.packed.block_b), key
        got, want = new.lookup(idx), new.reference_view().lookup(idx)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), key


# --------------------------------------------------------------------------
# training on the card: the strategy kernels under autograd, the DLRM and
# the dense LM train steps against their CPU twins
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 3])
def test_strategy_kernel_grads_match_plain(cuda, s, dtype):
    """ops.embedding_bag's table gradient on the card (kernel forward,
    index_add_ backward, whose adds land in no fixed order) against autograd
    of the plain lookup on the same card, -1 padding and ids >= m included;
    each kernel launched once per strategy."""
    m, e, b = 20_000, 16, 4096
    rng = np.random.default_rng(2)
    t0 = torch.from_numpy(rng.standard_normal((m, e)).astype(np.float32)).to(dtype).to(cuda)
    idx = rng.integers(0, m, size=(b, s)).astype(np.int32)
    idx[::7, -1], idx[::11, 0] = -1, m + 5
    idx = torch.from_numpy(idx).to(cuda)
    w = torch.from_numpy(rng.standard_normal((b, e)).astype(np.float32)).to(cuda)
    t = t0.clone().requires_grad_()
    (ref.bag_f32(t.float(), idx).to(dtype).float() * w).sum().backward()  # f32 scatter, cast
    want = t.grad
    counters = (embedding_bag_gm, embedding_bag_l1, embedding_bag_ub)
    before = sum(c.launches for c in counters)
    for strategy in ALL_STRATEGIES:
        t = t0.clone().requires_grad_()
        (ops.embedding_bag(t, idx, strategy).float() * w).sum().backward()
        torch.cuda.synchronize()
        torch.testing.assert_close(t.grad.float(), want.float(), **TOL,
                                   msg=lambda m_: f"{strategy}: {m_}")
    assert sum(c.launches for c in counters) == before + len(ALL_STRATEGIES)


def test_dlrm_train_steps_on_card_match_cpu(cuda):
    """Three Adagrad steps of the DLRM on the card and on the CPU from the
    same parameters and batches, the losses within rtol 1e-5; and one SGD
    step at lr 1, so every gradient, within rtol = atol = 1e-5.  (Adagrad's
    first step moves each parameter by lr * sign(gradient), so a gradient
    at the rounding level, summed in another order on the card, can move
    one element by 2 * lr: its parameters are not compared.)"""
    from repro_torch.core.tables import make_workload
    from repro_torch.data.synthetic import ctr_batch
    from repro_torch.models import dlrm
    from repro_torch.training.optimizer import adagrad, sgd
    from repro_torch.tree import leaves

    wl = make_workload("t", [100_000, 5_000, 300], dim=16, seqs=[1, 3, 2], batch=1024)
    cfg = dlrm.DLRMConfig(arch="t", workload=wl)
    serving = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", cuda):
        batches = [{k_: torch.as_tensor(v, device=dev)
                    for k_, v in ctr_batch(np.random.default_rng(k), wl).items()}
                   for k in range(3)]
        params = dlrm.train_params(serving, dev)
        opt = adagrad(0.05)
        state, step, losses = opt.init(params), dlrm.make_dlrm_train_step(cfg, opt), []
        for b in batches:
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        one = sgd(1.0)
        p0 = dlrm.train_params(serving, dev)
        runs[str(dev)] = losses, dlrm.make_dlrm_train_step(cfg, one)(p0, one.init(p0), batches[0])[0]
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5)
    for a, b_ in zip(leaves(runs["cuda"][1]), leaves(runs["cpu"][1])):
        torch.testing.assert_close(a.cpu(), b_, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-0.6b", "chatglm3-6b"])
def test_dense_lm_on_card_matches_cpu(cuda, arch):
    """A SMOKE dense LM on the card: the first train step's loss and
    gradient update (SGD at lr 1) against the CPU twin within 1e-5, and
    prefill + teacher-forced decode against the full forward within the
    JAX package's bound."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import sgd
    from repro_torch.tree import leaves, tree_map

    bundle = registry.build(arch, smoke=True)
    cfg = bundle.cfg
    params = bundle.init(torch.Generator().manual_seed(0))
    shape = ShapeCfg("smoke", "train", 64, 2)
    batch = bundle.make_batch(shape, torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda x: x.to(dev), params)
        opt = sgd(1.0)
        out[str(dev)] = T.make_train_step(cfg, None, opt, shape)(
            p, opt.init(p), {k: v.to(dev) for k, v in batch.items()})
    np.testing.assert_allclose(float(out["cuda"][2]["loss"]), float(out["cpu"][2]["loss"]),
                               rtol=1e-5)
    for a, b_ in zip(leaves(out["cuda"][0]), leaves(out["cpu"][0])):
        torch.testing.assert_close(a.cpu(), b_, rtol=1e-5, atol=1e-5)
    p = tree_map(lambda x: x.to(cuda), params)
    tokens = batch["tokens"].to(cuda)
    s0, seq = 48, 64
    logits, cache = T.make_prefill_step(cfg, None, ShapeCfg("t", "decode", seq, 2))(
        p, {"tokens": tokens[:, :s0]})
    dec = [logits]
    serve = T.make_serve_step(cfg, None)
    for t in range(s0, seq):
        lg, cache = serve(p, cache, {"tokens": tokens[:, t:t + 1]})
        dec.append(lg)
    dec = torch.cat(dec[:-1], dim=1)
    h, _, _ = T.forward_seq(cfg, p, {"tokens": tokens})
    want = T.lm_logits(cfg, p, h)[:, s0 - 1:seq - 1]
    assert float((dec - want).abs().max()) < 2e-3 * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b", "mamba2-780m",
                                  "zamba2-1.2b"])
def test_family_lm_on_card_matches_cpu(cuda, arch):
    """A SMOKE moe, ssm or hybrid LM on the card: the first train step's
    loss, aux loss and update (SGD at lr 1) against the CPU twin within
    1e-5; the prefill's caches and every decode step's logits and cache
    (mixtral's rolling past its window) against the CPU twin's within 1e-5;
    and, with the MoE capacity raised so that nothing drops, decode against
    the full forward within the JAX package's bound."""
    import dataclasses

    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import sgd
    from repro_torch.tree import leaves, tree_map

    bundle = registry.build(arch, smoke=True)
    cfg = bundle.cfg
    params = bundle.init(torch.Generator().manual_seed(0))
    shape = ShapeCfg("smoke", "train", 64, 2)
    batch = bundle.make_batch(shape, torch.Generator().manual_seed(1))
    s0, seq = 40, 52
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda x: x.to(dev), params)
        opt = sgd(1.0)
        new, _, m = T.make_train_step(cfg, None, opt, shape)(
            p, opt.init(p), {k: v.to(dev) for k, v in batch.items()})
        tokens = batch["tokens"].to(dev)
        logits, cache = T.make_prefill_step(cfg, None, ShapeCfg("t", "decode", seq, 2))(
            p, {"tokens": tokens[:, :s0]})
        steps = [(logits, cache)]
        for t in range(s0, seq):
            steps.append(T.decode_step(cfg, p, steps[-1][1], {"tokens": tokens[:, t:t + 1]}))
        out[str(dev)] = new, m, steps
    for key in ("loss", "aux"):
        np.testing.assert_allclose(float(out["cuda"][1][key]), float(out["cpu"][1][key]),
                                   rtol=1e-5, atol=1e-6)
    for a, b_ in zip(leaves(out["cuda"][0]), leaves(out["cpu"][0])):
        torch.testing.assert_close(a.cpu(), b_, rtol=1e-5, atol=1e-5)
    for (lg, c), (w_lg, w_c) in zip(out["cuda"][2], out["cpu"][2]):
        torch.testing.assert_close(lg.cpu(), w_lg, rtol=1e-5, atol=1e-5)
        assert c["pos"] == w_c["pos"]
        for k in w_c:
            if k != "pos":
                torch.testing.assert_close(c[k].cpu(), w_c[k], rtol=1e-5, atol=1e-5)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    p, tokens = tree_map(lambda x: x.to(cuda), params), batch["tokens"].to(cuda)
    logits, cache = T.make_prefill_step(cfg, None, ShapeCfg("t", "decode", seq, 2))(
        p, {"tokens": tokens[:, :s0]})
    dec = [logits]
    for t in range(s0, seq):
        lg, cache = T.decode_step(cfg, p, cache, {"tokens": tokens[:, t:t + 1]})
        dec.append(lg)
    dec = torch.cat(dec[:-1], dim=1)
    h, _, _ = T.forward_seq(cfg, p, {"tokens": tokens[:, :seq]})
    want = T.lm_logits(cfg, p, h)[:, s0 - 1:seq - 1]
    assert float((dec - want).abs().max()) < 2e-3 * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-2b"])
def test_encdec_vlm_lm_on_card_matches_cpu(cuda, arch):
    """A SMOKE encdec or vlm LM on the card (whisper's 40 frames beside its
    tokens; qwen2-vl's embeds and (3, B, S) M-RoPE positions): the first
    train step's loss and update (SGD at lr 1) against the CPU twin within
    1e-5; the prefill's caches (whisper's ``ck``/``cv`` over the frames)
    and every decode step's logits and cache against the CPU twin's within
    1e-5; and decode against the card's full forward within the JAX
    package's bound."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import registry
    from repro_torch.models import transformer as T
    from repro_torch.training.optimizer import sgd
    from repro_torch.tree import leaves, tree_map

    bundle = registry.build(arch, smoke=True)
    cfg = bundle.cfg
    params = bundle.init(torch.Generator().manual_seed(0))
    shape = ShapeCfg("smoke", "train", 64, 2)
    batch = bundle.make_batch(shape, torch.Generator().manual_seed(1))
    if "frames" in batch:
        batch["frames"] = batch["frames"][:, :40]
    s0, seq = 40, 52

    def prefix(inputs, n):
        return {k: v if k == "frames" else v[..., :n] if k == "positions" else v[:, :n]
                for k, v in inputs.items() if k != "labels"}

    def step(inputs, t):
        return {k: v[..., t:t + 1] if k == "positions" else v[:, t:t + 1]
                for k, v in inputs.items() if k not in ("frames", "labels")}

    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda x: x.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        opt = sgd(1.0)
        new, _, m = T.make_train_step(cfg, None, opt, shape)(p, opt.init(p), b)
        logits, cache = T.make_prefill_step(cfg, None, ShapeCfg("t", "decode", seq, 2))(
            p, prefix(b, s0))
        steps = [(logits, cache)]
        for t in range(s0, seq):
            steps.append(T.decode_step(cfg, p, steps[-1][1], step(b, t)))
        out[str(dev)] = new, m, steps
    np.testing.assert_allclose(float(out["cuda"][1]["loss"]), float(out["cpu"][1]["loss"]),
                               rtol=1e-5)
    for a, b_ in zip(leaves(out["cuda"][0]), leaves(out["cpu"][0])):
        torch.testing.assert_close(a.cpu(), b_, rtol=1e-5, atol=1e-5)
    for (lg, c), (w_lg, w_c) in zip(out["cuda"][2], out["cpu"][2]):
        torch.testing.assert_close(lg.cpu(), w_lg, rtol=1e-5, atol=1e-5)
        assert c["pos"] == w_c["pos"] and sorted(c) == sorted(w_c)
        for k in w_c:
            if k != "pos":
                torch.testing.assert_close(c[k].cpu(), w_c[k], rtol=1e-5, atol=1e-5)
    p, b = tree_map(lambda x: x.to(cuda), params), {k: v.to(cuda) for k, v in batch.items()}
    dec = torch.cat([lg for lg, _ in out["cuda"][2][:-1]], dim=1)
    h, _, _ = T.forward_seq(cfg, p, prefix(b, seq))
    want = T.lm_logits(cfg, p, h)[:, s0 - 1:seq - 1]
    assert float((dec - want).abs().max()) < 2e-3 * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("arch", ["dlrm", "qwen3-0.6b", "granite-moe-3b-a800m", "zamba2-1.2b",
                                  "whisper-small", "qwen2-vl-2b"])
def test_train_cli_on_card(cuda, arch, tmp_path, capsys):
    from repro_torch.launch import train

    out = train.main(["--arch", arch, "--steps", "5", "--checkpoint-dir", str(tmp_path)])
    assert all(np.isfinite(out["losses"])) and len(out["losses"]) == 5
    assert "on cuda" in capsys.readouterr().out
