"""The CUDA kernels on the card against their plain versions, and the
engine on the card against the same engine on the CPU.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode): it is
marked ``cuda`` and skips without one.  This file imports no JAX, so it
runs on a machine with only PyTorch:
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Tolerance: rtol = atol = 1e-5 for every table dtype (bf16/f16 rows convert
exactly to f32; kernel and plain version differ only in f32 summation
order).  The dedup gather's two data flows are held bitwise equal, and so
are the dense kernel and its plain version (both sum in position order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.strategies import ALL_STRATEGIES
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.embedding_gm import embedding_bag_gm
from repro_torch.kernels.embedding_l1 import embedding_bag_l1
from repro_torch.kernels.embedding_multi import (
    multi_embedding_bag_dense,
    multi_embedding_bag_dense_plain,
    multi_embedding_bag_ragged,
    multi_embedding_bag_ragged_plain,
    ragged_runs,
    ragged_stage_rows,
)
from repro_torch.kernels.embedding_ub import embedding_bag_ub

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
    torch.testing.assert_close(got, want, **TOL)
    cpu = multi_embedding_bag_ragged_plain(buf[:, :-1], torch.from_numpy(lidx),
                                           torch.from_numpy(steps2[2]), torch.from_numpy(runs),
                                           block_r=BLOCK_R)
    torch.testing.assert_close(got.cpu(), cpu, **TOL)


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
    before = multi_embedding_bag_dense.launches
    got = multi_embedding_bag_dense(c_d, l_d)
    torch.cuda.synchronize()
    assert multi_embedding_bag_dense.launches == before + 1
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
