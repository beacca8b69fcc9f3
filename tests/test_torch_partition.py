"""Packing and execution parity of the port against the JAX package.

* ``pack_plan`` gives array-equal fields and equal ``plan.meta["layout"]``/
  ``["rejoin"]``/``["kernel"]`` on the same Plan (hand-built plans with
  replicas, a row split and empty cores, and planner-made smoke plans).
* ``engine.lookup`` on the CPU (the kernels' plain versions) matches the
  JAX oracle ``bag.reference`` and the JAX per-core emulation (the fused
  ragged kernel in interpret mode for the asymmetric slots, the XLA path
  for the symmetric group, whose Pallas L1 kernel does not trace under the
  installed jax), within rtol = atol = 1e-5 (f32 summation order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro.core.embedding import stack_indices as jstack
from repro.core.strategies import ChunkAssignment as JChunk, Plan as JPlan, Strategy as JStrategy
from repro.core.tables import make_workload as jmake_workload
from repro.data.workloads import small_workload as jsmall_workload
from repro.engine import EngineConfig as JEngineConfig, InferenceEngine as JEngine
from repro_torch.core import partition as tpart
from repro_torch.core.strategies import ChunkAssignment, Plan, Strategy
from repro_torch.core.tables import make_workload
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine

TOL = dict(rtol=1e-5, atol=1e-5)
E = 16


def _params(rows, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((r, E)) / 4).astype(np.float32) for r in rows]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or x.dtype.name == "bfloat16" else x


def assert_packs_equal(jp, tp, jplan, tplan):
    for f in jpart.PackedPlan._ARRAY_FIELDS:
        want, got = _np(getattr(jp, f)), _np(getattr(tp, f))
        assert want.shape == got.shape, f
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)
    for f in ("layout", "block_r", "slot_window", "block_b", "unique_cap",
              "cache_rows", "kernel_path"):
        assert getattr(tp, f) == getattr(jp, f), f
    for key in ("layout", "rejoin", "kernel"):
        assert tplan.meta[key] == jplan.meta[key], key


# hand-built plans: (rows, K, [(table, core, offset, rows, strategy, batch_frac)], sym)
HAND_PLANS = {
    "replicas": ([512, 64, 96], 4, [
        (0, 0, 0, 512, "GM", (0, 2)), (0, 1, 0, 512, "L1", (1, 2)),
        (1, 2, 0, 64, "L1_UB", (0, 1)), (2, 3, 0, 96, "GM_UB", (0, 1))], ()),
    "row_split": ([700, 40, 9], 2, [
        (0, 0, 0, 300, "L1", (0, 1)), (0, 1, 300, 400, "GM", (0, 1)),
        (1, 1, 0, 40, "GM_UB", (0, 1))], ((2, "L1"),)),
    "empty_cores": ([40, 24, 300], 8, [
        (0, 5, 0, 40, "L1", (0, 1)), (1, 2, 0, 24, "L1_UB", (0, 1))],
        ((2, "GM_UB"),)),
}


def _hand_plans(name):
    rows, k, chunks, sym = HAND_PLANS[name]
    out = []
    for mk, CA, P, S in ((jmake_workload, JChunk, JPlan, JStrategy),
                         (make_workload, ChunkAssignment, Plan, Strategy)):
        wl = mk(name, rows, dim=E, batch=32)
        plan = P(
            workload_name=name, n_cores=k,
            assignments=tuple(CA(t, c, o, r, S[s], batch_frac=bf) for t, c, o, r, s, bf in chunks),
            symmetric_tables=tuple(t for t, _ in sym),
            symmetric_strategies=tuple(S[s] for _, s in sym),
        )
        plan.validate(wl.tables)
        out.append((wl, plan))
    return out, rows


@pytest.mark.parametrize("name", list(HAND_PLANS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_matches_reference_hand_plans(name, dtype):
    ((jwl, jplan), (twl, tplan)), rows = _hand_plans(name)
    params = _params(rows)
    jp = jpart.pack_plan(jplan, jwl.tables, [jnp.asarray(p) for p in params],
                         dtype=getattr(jnp, dtype))
    tp = tpart.pack_plan(tplan, twl.tables, params, dtype=getattr(torch, dtype))
    assert_packs_equal(jp, tp, jplan, tplan)


def _engines(rows=None, seqs=None, *, batch=64, wl_name="mix", **cfg):
    """The same EngineConfig built by both packages on the same tables."""
    if rows is None:
        jwl, twl = jsmall_workload(batch=batch), small_workload(batch=batch)
    else:
        jwl = jmake_workload(wl_name, rows, dim=E, seqs=seqs, batch=batch)
        twl = make_workload(wl_name, rows, dim=E, seqs=seqs, batch=batch)
    params = _params([t.rows for t in twl.tables], seed=7)
    jeng = JEngine.build([jnp.asarray(p) for p in params], jwl,
                         JEngineConfig(simulate=True, **cfg))
    teng = InferenceEngine.build(params, twl, EngineConfig(**cfg), device="cpu")
    return jeng, teng, params


SMOKE_FALLBACK = dict(mesh_shape=(1, 4), distribution="uniform",
                      planner_options={"shard_rocks": False})
MIXED = dict(rows=[100, 57, 1000, 8, 3000, 16, 450, 333],
             seqs=[1, 2, 1, 4, 1, 1, 3, 1])
SLICES = {
    "smoke_k1": dict(mesh_shape=(1, 1)),
    "smoke_k4_fallback": SMOKE_FALLBACK,
    "mixed_k4_chunked": dict(MIXED, mesh_shape=(1, 4), hardware_options={"l1_bytes": 4096}),
    "mixed_k4_symmetric": dict(MIXED, mesh_shape=(1, 4), planner="symmetric",
                               hardware_options={"l1_bytes": 8192}),
    "mixed_k2_baseline": dict(MIXED, mesh_shape=(1, 2), planner="baseline"),
    "smoke_k4_bf16": dict(SMOKE_FALLBACK, dtype="bfloat16"),
    "smoke_k4_ascend": dict(SMOKE_FALLBACK, hardware="ascend_910"),
}


@pytest.mark.parametrize("name", ["smoke_k1", "smoke_k4_fallback", "mixed_k4_chunked"])
def test_pack_matches_reference_planner_plans(name):
    jeng, teng, _ = _engines(**SLICES[name])
    assert_packs_equal(jeng.packed, teng.packed, jeng.plan, teng.plan)


def test_fallback_engages_in_slice_fixtures():
    _, teng, _ = _engines(**SMOKE_FALLBACK)
    assert teng.plan.symmetric_tables and teng.plan.assignments
    _, teng, _ = _engines(**SLICES["mixed_k4_symmetric"])
    strategies = set(teng.plan.symmetric_strategies)
    assert {Strategy.L1, Strategy.GM_UB} <= strategies


def _indices(wl, seed=11):
    rng = np.random.default_rng(seed)
    per_table = [rng.integers(0, t.rows, size=(wl.batch, t.seq)).astype(np.int32)
                 for t in wl.tables]
    return per_table


def _jax_emulated(jeng, sidx):
    """Per-core fused sweeps + psum + batch-split symmetric group (XLA)."""
    packed, n = jeng.packed, jeng.bag.n_tables
    k, b = packed.n_cores, sidx.shape[1]
    out = jnp.zeros((n, b, E), jnp.float32)
    for core in range(k):
        out = out + jpart._local_asym_lookup(
            packed.strip_core(core), sidx, n_tables=n, use_kernels="fused")
    bl = b // k
    syms = [jpart._local_sym_lookup(packed, sidx[:, c * bl:(c + 1) * bl], n_tables=n,
                                    use_kernels=False) for c in range(k)]
    return np.asarray(out + jnp.concatenate(syms, axis=1))


@pytest.mark.parametrize("name", list(SLICES))
def test_lookup_matches_reference(name):
    jeng, teng, params = _engines(**SLICES[name])
    per_table = _indices(teng.workload)
    sidx = jstack([jnp.asarray(i) for i in per_table], jeng.bag.s_max)
    oracle = np.asarray(jeng.bag.reference(
        [jnp.asarray(p).astype(getattr(jnp, teng.config.dtype)) for p in params], sidx))
    emulated = _jax_emulated(jeng, sidx)
    tol = TOL if teng.config.dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for use_kernels in ("fused", "xla"):
        for reduce_mode in ("sparse", "psum", "ring"):
            eng = dataclasses.replace(teng.config, use_kernels=use_kernels,
                                      reduce_mode=reduce_mode)
            teng.config = eng
            got = teng.lookup(np.asarray(sidx)).numpy()
            np.testing.assert_allclose(got, emulated, **TOL,
                                       err_msg=f"{use_kernels}/{reduce_mode}")
            np.testing.assert_allclose(got, oracle, **tol)
    # list-of-tables input goes through the port's stack_indices
    np.testing.assert_allclose(teng.lookup(per_table).numpy(), emulated, **TOL)


def test_per_core_partials_match_reference():
    jeng, teng, _ = _engines(**SLICES["mixed_k4_chunked"])
    sidx = jstack([jnp.asarray(i) for i in _indices(teng.workload)], jeng.bag.s_max)
    n = teng.bag.n_tables
    got = tpart._local_asym_lookup(teng.packed, torch.from_numpy(np.array(sidx)),
                                   n_tables=n, use_kernels="fused")
    for core in range(teng.packed.n_cores):
        want = jpart._local_asym_lookup(jeng.packed.strip_core(core), sidx,
                                        n_tables=n, use_kernels="fused")
        np.testing.assert_allclose(got[core].numpy(), np.asarray(want), **TOL)


def test_window_streams_once_per_core():
    """Each buffer row-block appears at most once per core in the port's
    schedule: a window is never re-streamed within a core."""
    rng = np.random.default_rng(3)
    rows = [20_000] + [int(x) for x in rng.integers(8, 200, 15)]
    wl = make_workload("skew", rows, dim=E, batch=32)
    from repro_torch.core.embedding import PartitionedEmbeddingBag
    from repro_torch.core.cost_model import TPU_V5E, analytic_model

    bag = PartitionedEmbeddingBag(
        wl, n_cores=4, planner="asymmetric",
        cost_model=analytic_model(dataclasses.replace(TPU_V5E, l1_bytes=1 << 20)),
        planner_kwargs=dict(lif_threshold=1e9, rock_theta=None),
    )
    packed = bag.pack(None)
    step_slot = packed.step_slot.numpy()
    step_block = packed.step_block.numpy()
    n_slots = packed.slot_table.shape[1]
    for core in range(packed.n_cores):
        real = step_slot[core] < n_slots
        blocks = step_block[core][real]
        assert len(blocks) == len(np.unique(blocks)), "window re-streamed"
    # the kernel's runs cover every real step exactly once
    runs = packed.step_runs.numpy()
    assert int(runs[:, 3].sum()) == int((step_slot < n_slots).sum())


def test_lookup_rejects_unknown_use_kernels():
    """Only "fused" and False select an executor; the reference's legacy
    ``True`` spelling is not taken."""
    _, teng, _ = _engines(**SMOKE_FALLBACK)
    idx = torch.zeros((len(teng.workload.tables), 8, teng.bag.s_max), dtype=torch.int32)
    for bad in (True, "xla", 1):
        with pytest.raises(ValueError, match="use_kernels"):
            tpart.partitioned_lookup(teng.packed, idx, n_tables=teng.bag.n_tables,
                                     use_kernels=bad)


def test_unported_pack_options_raise():
    """Pack options the layout cannot take raise the reference's errors:
    the sparse gather without dedup, and dense with dedup, the cache or
    the sparse gather."""
    (_, (twl, tplan)), _ = _hand_plans("replicas")
    with pytest.raises(ValueError, match="sparse"):
        tpart.pack_plan(tplan, twl.tables, None, kernel_path="sparse")
    for kw, match in ((dict(unique_cap=8), "dedup/cache require layout='ragged'"),
                      (dict(cache_rows=8, freqs=[]), "dedup/cache require layout='ragged'"),
                      (dict(kernel_path="sparse", unique_cap=0),
                       "kernel_path='sparse' requires layout='ragged'")):
        with pytest.raises(ValueError, match=match):
            tpart.pack_plan(tplan, twl.tables, None, layout="dense", **kw)


@pytest.mark.parametrize("kernel_path", ["onehot", "sparse"])
def test_dedup_pack_option_packs_like_reference(kernel_path):
    """``unique_cap`` packs (batch dedup), field for field as the reference,
    and the dedup'd lookup stays exact."""
    ((jwl, jplan), (twl, tplan)), rows = _hand_plans("replicas")
    params = _params(rows)
    jp = jpart.pack_plan(jplan, jwl.tables, [jnp.asarray(p) for p in params],
                         unique_cap=8, kernel_path=kernel_path)
    tp = tpart.pack_plan(tplan, twl.tables, params, unique_cap=8, kernel_path=kernel_path)
    assert tp.unique_cap == 8 and tp.kernel_path == kernel_path
    assert_packs_equal(jp, tp, jplan, tplan)
    idx = np.stack(_indices(twl))
    got = tpart._local_asym_lookup(tp, torch.from_numpy(idx), n_tables=3,
                                   use_kernels="fused").sum(dim=0)
    want = tpart._local_asym_lookup(tp, torch.from_numpy(idx), n_tables=3,
                                    use_kernels=False).sum(dim=0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_symmetric_batch_split_needs_divisible_batch():
    _, teng, _ = _engines(**SMOKE_FALLBACK)
    idx = np.zeros((len(teng.workload.tables), 6, teng.bag.s_max), np.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        teng.lookup(idx)
