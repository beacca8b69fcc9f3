"""The CUDA kernels on the card against their plain versions, and the
engine on the card against the same engine on the CPU.

Every test here needs an NVIDIA card (a CUDA kernel has no CPU mode): it is
marked ``cuda`` and skips without one.  This file imports no JAX, so it
runs on a machine with only PyTorch:
``python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Tolerance: rtol = atol = 1e-5 for every table dtype (bf16/f16 rows convert
exactly to f32; kernel and plain version differ only in f32 summation
order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.strategies import ALL_STRATEGIES
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.kernels import ops, ref
from repro_torch.kernels.embedding_gm import embedding_bag_gm
from repro_torch.kernels.embedding_l1 import embedding_bag_l1
from repro_torch.kernels.embedding_multi import (
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
