"""Access reduction in the port against the JAX package, on the CPU.

* ``dedup_indices`` gives the reference's ``uniq`` and ``spill`` array-equal,
  and ``cnt_from_rank`` its ``cnt``, on all-duplicate, all-unique and
  overflow-spill batches.
* ``pack_plan`` gives array-equal ``cache_data``/``cache_remap``/
  ``step_kpath`` and equal ``plan.meta["cache"]``/``["kernel"]`` records on
  hand plans and planner plans, including the deterministic cache ties.
* ``multi_embedding_bag_ragged`` (the kernel's plain version here) and
  ``InferenceEngine.lookup`` match the reference (its Pallas kernel in
  interpret mode) within rtol = atol = 1e-5 under dedup, cache and both,
  with every kernel path, an empty slot, a padding core and batch
  chunking; forced one-hot and sparse packs give bitwise equal outputs.
* The traffic models equal the reference's figures; ``plan_shape_digest``
  equals the reference's for the same backend string; ``TuningCache`` hits
  on a shape-identical replan; the CPU sweep gives the reference's
  candidate list (all but the wall times).

Tolerance: f32 sums in another order than the reference's GEMMs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jtune
from repro.core import partition as jpart
from repro.core import traffic as jtraffic
from repro.core.cost_model import TPU_V5E as JTPU_V5E, analytic_model as janalytic
from repro.core.embedding import PartitionedEmbeddingBag as JBag
from repro.core.strategies import ChunkAssignment as JChunk, Plan as JPlan, Strategy as JStrategy
from repro.core.tables import make_workload as jmake_workload
from repro.data.distributions import RowProbs as JRowProbs, Zipf as JZipf
from repro.data.distributions import workload_probs as jworkload_probs
from repro.data.workloads import small_workload as jsmall_workload
from repro.engine import EngineConfig as JEngineConfig, InferenceEngine as JEngine
from repro.kernels.embedding_multi import _dedup_indices
from repro.kernels.embedding_multi import multi_embedding_bag_ragged as jmulti
from repro_torch.core import autotune as tune
from repro_torch.core import partition as tpart
from repro_torch.core import traffic
from repro_torch.core.cost_model import TPU_V5E, analytic_model
from repro_torch.core.embedding import PartitionedEmbeddingBag
from repro_torch.core.strategies import ChunkAssignment, Plan, Strategy
from repro_torch.core.tables import make_workload
from repro_torch.data.distributions import RowProbs, Zipf, sample_workload, workload_probs
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.kernels.embedding_multi import (
    cnt_from_rank,
    dedup_indices,
    gather_unique_rows_plain,
    multi_embedding_bag_ragged,
    ragged_runs,
)
from repro_torch.launch import serve as serve_cli

TOL = dict(rtol=1e-5, atol=1e-5)
E = 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


# --------------------------------------------------------------------------
# the dedup op
# --------------------------------------------------------------------------


def _dedup_case(name):
    rng = np.random.default_rng(5)
    if name == "all_duplicate":
        return np.full((3, 16, 4), 7, np.int32), 8
    if name == "all_unique":
        ids = rng.permutation(500)[: 3 * 16 * 2].reshape(3, 16, 2)
        return ids.astype(np.int32), 32
    if name == "overflow_spill":
        return rng.integers(-1, 100, size=(2, 32, 4)).astype(np.int32), 16
    # padding: -1 everywhere but a few ids, one all-padding slot
    ids = np.full((3, 8, 3), -1, np.int32)
    ids[0, ::2, 0] = rng.integers(0, 9, size=4)
    ids[2] = rng.integers(-1, 4, size=(8, 3))
    return ids, 8


@pytest.mark.parametrize("name", ["all_duplicate", "all_unique", "overflow_spill", "padding"])
def test_dedup_indices_match_reference(name):
    lidx, cap = _dedup_case(name)
    uniq, cnt, spill = (np.asarray(a) for a in _dedup_indices(jnp.asarray(lidx), cap))
    got_u, rank, got_s = dedup_indices(torch.from_numpy(lidx), cap)
    assert got_u.is_contiguous() and rank.is_contiguous() and got_s.is_contiguous()  # kernel inputs
    np.testing.assert_array_equal(got_u.numpy(), uniq)
    np.testing.assert_array_equal(got_s.numpy(), spill)
    np.testing.assert_array_equal(cnt_from_rank(rank, cap).numpy(), cnt)
    # every valid lookup lands in exactly one of rank / spill
    assert ((rank.numpy() >= 0) + (got_s.numpy() >= 0) == (lidx >= 0)).all()
    if name == "overflow_spill":
        assert (spill >= 0).any()
    # uniq is ascending with -1 padding last (the kernel's binary search)
    for row in got_u.reshape(-1, cap).numpy():
        real = row[row >= 0]
        assert (np.diff(real) > 0).all() and (row[len(real):] == -1).all()


def test_dedup_indices_rejects_zero_cap():
    with pytest.raises(ValueError, match="unique_cap"):
        dedup_indices(torch.zeros((1, 2, 2), dtype=torch.int32), 0)


# --------------------------------------------------------------------------
# the fused lookup's access modes, one core, against the reference kernel
# --------------------------------------------------------------------------

BLOCK_R = 16
# (strategy code, steps) per slot; one trash-slot padding step follows
SCHEDULE = [(0, 2), (1, 1), (2, 3), (3, 1)]


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
    slot.append(len(SCHEDULE))
    base.append(0)
    block.append(0)
    strat.append(0)
    return [np.asarray(a, np.int32) for a in (slot, base, block, strat)], blk * BLOCK_R


def _kernel_case(b=24, s=3, cache_rows=0, hot_frac=0.3, seed=0, lo=-2):
    rng = np.random.default_rng(seed)
    steps, t_rows = _schedule()
    buf = rng.standard_normal((t_rows, E)).astype(np.float32)
    regions = [n * BLOCK_R for _, n in SCHEDULE]
    lidx = np.stack([rng.integers(lo, r + 5, size=(b, s)) for r in regions]).astype(np.int32)
    lidx[1] = 3  # an all-duplicate slot
    cache = hidx = None
    if cache_rows:
        cache = rng.standard_normal((cache_rows, E)).astype(np.float32)
        hidx = np.where(rng.random(lidx.shape) < hot_frac,
                        rng.integers(0, cache_rows, size=lidx.shape), -1).astype(np.int32)
        lidx = np.where(hidx >= 0, -1, lidx).astype(np.int32)
    return buf, lidx, steps, cache, hidx


def _both(buf, lidx, steps, cache, hidx, *, unique_cap=0, kpath=None, block_b=None):
    slot, base, block, strat = steps
    jkw = dict(block_r=BLOCK_R, interpret=True, unique_cap=unique_cap, block_b=block_b)
    tkw = dict(block_r=BLOCK_R, unique_cap=unique_cap)
    if cache is not None:
        jkw.update(cache=jnp.asarray(cache), hidx=jnp.asarray(hidx))
        tkw.update(cache=torch.from_numpy(cache), hidx=torch.from_numpy(hidx))
    if kpath is not None:
        jkw["step_kpath"] = jnp.asarray(kpath)
        tkw["step_kpath"] = torch.from_numpy(kpath)
    want = np.asarray(jmulti(jnp.asarray(buf), jnp.asarray(lidx), *map(jnp.asarray, steps), **jkw))
    runs = torch.from_numpy(ragged_runs(slot, base, strat, BLOCK_R, len(SCHEDULE)))
    got = multi_embedding_bag_ragged(
        torch.from_numpy(buf), torch.from_numpy(lidx), torch.from_numpy(block), runs,
        step_slot=torch.from_numpy(slot), step_base=torch.from_numpy(base), **tkw)
    return got.numpy(), want


KERNEL_CASES = {
    "dedup": dict(unique_cap=64),
    "dedup_spill": dict(unique_cap=8),
    "dedup_chunked": dict(unique_cap=24, block_b=8),
    "cache": dict(cache_rows=16),
    "dedup_cache": dict(unique_cap=32, cache_rows=16),
    "dedup_cache_spill": dict(unique_cap=4, cache_rows=8),
}


@pytest.mark.parametrize("name,kpath", [
    (name, kpath) for name in KERNEL_CASES for kpath in ("none", "onehot", "sparse", "mixed")
    if kpath == "none" or KERNEL_CASES[name].get("unique_cap")  # a gather path needs dedup
])
def test_ragged_access_matches_reference_kernel(name, kpath):
    kw = dict(KERNEL_CASES[name])
    cache_rows = kw.pop("cache_rows", 0)
    buf, lidx, steps, cache, hidx = _kernel_case(cache_rows=cache_rows)
    n = len(steps[0])
    kp = {"none": None, "onehot": np.zeros(n, np.int32), "sparse": np.ones(n, np.int32),
          "mixed": (np.arange(n) % 2).astype(np.int32)}[kpath]
    got, want = _both(buf, lidx, steps, cache, hidx, kpath=kp, **kw)
    np.testing.assert_allclose(got, want, **TOL)


def test_gather_paths_bitwise_on_kernel_inputs():
    """Forced one-hot and sparse give bitwise equal outputs, and the
    unique-row gather is an exact copy of the buffer rows."""
    buf, lidx, steps, cache, hidx = _kernel_case(cache_rows=16)
    n = len(steps[0])
    outs = [_both(buf, lidx, steps, cache, hidx, unique_cap=32, kpath=np.full(n, v, np.int32))
            for v in (0, 1)]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])  # the reference's gate
    slot, base, block, strat = steps
    uniq, _, _ = dedup_indices(torch.from_numpy(lidx)[None], 32)
    runs = torch.from_numpy(ragged_runs(slot, base, strat, BLOCK_R, len(SCHEDULE)))
    rows_u = gather_unique_rows_plain(torch.from_numpy(buf)[None], uniq,
                                      torch.from_numpy(block)[None], runs, block_r=BLOCK_R)
    for (core, s_i, first, n_steps, _), u in zip(runs.tolist(), uniq[0]):
        ids = u[u >= 0].numpy()
        inside = ids < n_steps * BLOCK_R  # out-of-window ids gather zeros
        rows = block[first + ids[inside] // BLOCK_R] * BLOCK_R + ids[inside] % BLOCK_R
        got = rows_u[core, s_i, : len(ids)].numpy()
        np.testing.assert_array_equal(got[inside], buf[rows])
        np.testing.assert_array_equal(got[~inside], 0.0)


def test_ragged_access_argument_errors():
    buf, lidx, steps, cache, hidx = _kernel_case(cache_rows=8)
    slot, base, block, strat = (torch.from_numpy(a) for a in steps)
    runs = torch.from_numpy(ragged_runs(*steps[:2], steps[3], BLOCK_R, len(SCHEDULE)))
    args = (torch.from_numpy(buf), torch.from_numpy(lidx), block, runs)
    with pytest.raises(ValueError, match="unique_cap"):
        multi_embedding_bag_ragged(*args, block_r=BLOCK_R, step_kpath=torch.zeros_like(block))
    with pytest.raises(ValueError, match="hidx"):
        multi_embedding_bag_ragged(*args, block_r=BLOCK_R, cache=torch.from_numpy(cache))
    with pytest.raises(ValueError, match="step_slot"):
        multi_embedding_bag_ragged(*args, block_r=BLOCK_R, unique_cap=8)


# --------------------------------------------------------------------------
# packing: the cache carve, step_kpath and the meta records
# --------------------------------------------------------------------------

CACHE_PLAN = ([2000, 64, 300], [4, 1, 2], 2, [
    (0, 0, 0, 1000, "GM"), (0, 1, 1000, 1000, "GM"),
    (1, 0, 0, 64, "L1_UB"), (2, 1, 0, 300, "GM_UB")])
EMPTY_PLAN = ([100], [2], 2, [(0, 0, 0, 100, "GM")])  # core 1 holds nothing


def _hand(spec, batch=32):
    rows, seqs, k, chunks = spec
    out = []
    for mk, CA, P, S in ((jmake_workload, JChunk, JPlan, JStrategy),
                         (make_workload, ChunkAssignment, Plan, Strategy)):
        wl = mk("acc", rows, dim=E, seqs=seqs, batch=batch)
        plan = P(workload_name="acc", n_cores=k,
                 assignments=tuple(CA(t, c, o, r, S[s]) for t, c, o, r, s in chunks),
                 symmetric_tables=(), symmetric_strategies=())
        plan.validate(wl.tables)
        out.append((wl, plan))
    return out


def _params(tables, seed=6):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((t.rows, E)) / 4).astype(np.float32) for t in tables]


def assert_access_packs_equal(jp, tp, jplan, tplan):
    for f in jpart.PackedPlan._ARRAY_FIELDS:
        want, got = _np(getattr(jp, f)), _np(getattr(tp, f))
        assert want.shape == got.shape, f
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)
    for f in ("block_r", "slot_window", "unique_cap", "cache_rows", "kernel_path"):
        assert getattr(tp, f) == getattr(jp, f), f
    for key in ("layout", "rejoin", "kernel", "cache"):
        assert tplan.meta.get(key) == jplan.meta.get(key), key


@pytest.mark.parametrize("uc,cr,kp", [
    (0, 64, "onehot"), (48, 0, "onehot"), (48, 0, "sparse"), (48, 64, "sparse"),
    (48, 64, "onehot"), (0, 64, "auto"), (16, 3, "onehot"),
])
def test_pack_cache_and_kernel_path_match_reference(uc, cr, kp):
    (jwl, jplan), (twl, tplan) = _hand(CACHE_PLAN)
    params = _params(twl.tables)
    jfreqs, tfreqs = jworkload_probs(jwl, JZipf(1.2)), workload_probs(twl, Zipf(1.2))
    jp = jpart.pack_plan(jplan, jwl.tables, [jnp.asarray(p) for p in params],
                         unique_cap=uc, cache_rows=cr, freqs=jfreqs, kernel_path=kp)
    tp = tpart.pack_plan(tplan, twl.tables, params, unique_cap=uc, cache_rows=cr,
                         freqs=tfreqs, kernel_path=kp)
    assert_access_packs_equal(jp, tp, jplan, tplan)
    if cr:
        assert int((tp.cache_remap >= 0).sum()) > 0
        assert tp.cache_data.shape[1] == tp.cache_rows
    entries = tpart.cache_plan_entries(tplan, twl.tables, tfreqs, 64)
    jentries = jpart.cache_plan_entries(jplan, jwl.tables, jfreqs, 64)
    assert {c: [(s, a.table_idx, g, w) for s, a, g, w in v] for c, v in entries.items()} == {
        c: [(s, a.table_idx, g, w) for s, a, g, w in v] for c, v in jentries.items()}


def test_cache_carve_deterministic_ties():
    """Equal-mass rows carve in (table, id) order, as in the reference."""
    plans = _hand(([64, 64], [1, 1], 1, [(0, 0, 0, 64, "GM"), (1, 0, 0, 64, "GM")]))
    got = []
    for (wl, plan), R, part in zip(plans, (JRowProbs, RowProbs), (jpart, tpart)):
        f = R(64, np.array([5, 3, 9]), np.array([0.2, 0.2, 0.2]), 0.4)
        entries = part.cache_plan_entries(plan, wl.tables, [f, f], 4)
        got.append([(a.table_idx, gid) for _s, a, gid, _w in entries[0]])
    assert got[0] == got[1] == [(0, 3), (0, 5), (0, 9), (1, 3)]


def test_pack_access_validation():
    (_, _), (twl, tplan) = _hand(CACHE_PLAN)
    with pytest.raises(ValueError, match="freqs"):
        tpart.pack_plan(tplan, twl.tables, None, cache_rows=8)
    with pytest.raises(ValueError, match="unique_cap"):
        tpart.pack_plan(tplan, twl.tables, None, kernel_path="sparse")
    with pytest.raises(ValueError, match="unknown kernel_path"):
        tpart.pack_plan(tplan, twl.tables, None, unique_cap=8, kernel_path="csr")
    # a uniform histogram carves nothing: the empty carve is recorded
    tplan.meta["cache"] = {"cache_rows": 16}
    tp = tpart.pack_plan(tplan, twl.tables, None, freqs=workload_probs(twl, Zipf(1.2)),
                         unique_cap=0)
    assert tp.cache_rows == 16 and tplan.meta["cache"]["packed"]["cache_rows"] == 16


# --------------------------------------------------------------------------
# engine-level parity: access x kernel_path, empty slot, padding core
# --------------------------------------------------------------------------

MIXED = dict(rows=[1000, 57, 3000, 8, 2000, 16, 450, 333], seqs=[3, 2, 1, 4, 2, 1, 3, 1])


def _engines(*, rows=None, seqs=None, batch=32, **cfg):
    if rows is None:
        jwl, twl = jsmall_workload(batch=batch), small_workload(batch=batch)
    else:
        jwl = jmake_workload("mix", rows, dim=E, seqs=seqs, batch=batch)
        twl = make_workload("mix", rows, dim=E, seqs=seqs, batch=batch)
    params = _params(twl.tables, seed=7)
    jeng = JEngine.build([jnp.asarray(p) for p in params], jwl,
                         JEngineConfig(simulate=True, **cfg))
    teng = InferenceEngine.build(params, twl, EngineConfig(**cfg), device="cpu")
    return jeng, teng, params


def _jax_fused(jeng, sidx):
    packed, n = jeng.packed, jeng.bag.n_tables
    return np.asarray(sum(
        jpart._local_asym_lookup(packed.strip_core(c), sidx, n_tables=n, use_kernels="fused")
        for c in range(packed.n_cores)))


ACCESS_CFG = dict(MIXED, mesh_shape=(1, 4), distribution="zipf:1.2", hardware="a100",
                  planner_options={"shard_rocks": True})


@pytest.mark.parametrize("kernel_path", ["onehot", "sparse", "auto"])
@pytest.mark.parametrize("access", ["dedup", "cache", "full"])
def test_engine_lookup_access_matches_reference(access, kernel_path):
    cfg = dict(ACCESS_CFG, access=access, kernel_path=kernel_path)
    if kernel_path == "sparse" and access == "cache":
        fields = {k: v for k, v in cfg.items() if k not in MIXED}
        for config in (EngineConfig(**fields), JEngineConfig(**fields)):
            with pytest.raises(ValueError, match="sparse"):
                config.validate()
        return
    jeng, teng, params = _engines(**cfg)
    assert_access_packs_equal(jeng.packed, teng.packed, jeng.plan, teng.plan)
    assert teng.packed.unique_cap == (0 if access == "cache" else teng.plan.meta["cache"]["unique_cap"])
    if access != "dedup":
        assert teng.packed.cache_rows > 0
    idx = sample_workload(np.random.default_rng(3), teng.workload, Zipf(1.2), 32)
    want = _jax_fused(jeng, jnp.asarray(idx))
    got = tpart._local_asym_lookup(teng.packed, torch.from_numpy(idx), n_tables=8,
                                   use_kernels="fused").sum(dim=0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    oracle = np.asarray(jeng.bag.reference([jnp.asarray(p) for p in params], jnp.asarray(idx)))
    np.testing.assert_allclose(teng.lookup(idx).numpy(), oracle, **TOL)


@pytest.mark.parametrize("spec", ["empty_slot_padding_core", "cache_plan"])
def test_hand_plan_lookup_forced_paths_bitwise(spec):
    """Forced one-hot and sparse packs give bitwise equal outputs (the
    reference's gate), equal to the reference within tolerance; core 1 of
    the empty plan holds nothing and its partial is exactly zero."""
    (jwl, jplan), (twl, tplan) = _hand(EMPTY_PLAN if spec.startswith("empty") else CACHE_PLAN)
    params = _params(twl.tables)
    jfreqs, tfreqs = jworkload_probs(jwl, JZipf(1.2)), workload_probs(twl, Zipf(1.2))
    idx = sample_workload(np.random.default_rng(9), twl, Zipf(1.2), 32)
    idx[0, :, 1] = -1  # sequence padding
    n = len(twl.tables)
    outs = {}
    for kp in ("onehot", "sparse"):
        kw = dict(unique_cap=16, cache_rows=16, kernel_path=kp)
        jp = jpart.pack_plan(jplan, jwl.tables, [jnp.asarray(p) for p in params],
                             freqs=jfreqs, **kw)
        tp = tpart.pack_plan(tplan, twl.tables, params, freqs=tfreqs, **kw)
        got = tpart._local_asym_lookup(tp, torch.from_numpy(idx), n_tables=n, use_kernels="fused")
        if spec.startswith("empty"):
            np.testing.assert_array_equal(got[1].numpy(), 0.0)
        outs[kp] = got.sum(dim=0).numpy()
        want = np.asarray(sum(
            jpart._local_asym_lookup(jp.strip_core(c), jnp.asarray(idx), n_tables=n,
                                     use_kernels="fused") for c in range(2)))
        np.testing.assert_allclose(outs[kp], want, **TOL)
    np.testing.assert_array_equal(outs["onehot"], outs["sparse"])


def test_engine_access_under_batch_chunking():
    """The reference chunks a forced block_b's batch; the port's grid tiles
    the batch itself: the results agree."""
    cfg = dict(ACCESS_CFG, access="full", tuning="fixed", tuning_options={"block_b": 8})
    jeng, teng, _ = _engines(**cfg)
    assert teng.packed.block_b == jeng.packed.block_b == 8
    idx = sample_workload(np.random.default_rng(4), teng.workload, Zipf(1.2), 32)
    got = tpart._local_asym_lookup(teng.packed, torch.from_numpy(idx), n_tables=8,
                                   use_kernels="fused").sum(dim=0)
    np.testing.assert_allclose(got.numpy(), _jax_fused(jeng, jnp.asarray(idx)), **TOL)


# --------------------------------------------------------------------------
# traffic models
# --------------------------------------------------------------------------


@pytest.mark.parametrize("access", ["none", "full"])
def test_traffic_models_match_reference(access):
    cfg = dict(ACCESS_CFG, access=access, kernel_path="auto")
    jeng, teng, _ = _engines(**cfg)
    batch, n = teng.workload.batch, len(teng.workload.tables)
    seq = teng.bag.s_max
    assert traffic.modeled_hbm_traffic(teng.packed, batch=batch, seq=seq, n_tables=n) == \
        jtraffic.modeled_hbm_traffic(jeng.packed, batch=batch, seq=seq, n_tables=n)
    for kw in (dict(), dict(dedup=True), dict(cache_rows=64), dict(dedup=True, cache_rows=96)):
        assert traffic.modeled_plan_traffic(
            teng.plan, teng.workload.tables, batch, teng.freqs, **kw) == \
            jtraffic.modeled_plan_traffic(jeng.plan, jeng.workload.tables, batch, jeng.freqs, **kw)
    for block_r in (None, 64):
        assert traffic.modeled_kernel_path_traffic(
            teng.plan, teng.workload.tables, batch, teng.freqs, model=teng.cost_model,
            block_r=block_r) == jtraffic.modeled_kernel_path_traffic(
            jeng.plan, jeng.workload.tables, batch, jeng.freqs, model=jeng.cost_model,
            block_r=block_r)


# --------------------------------------------------------------------------
# tuning: digest, cache, sweep
# --------------------------------------------------------------------------


def _bags(cfg_freqs=True, **planner_kwargs):
    jwl = jmake_workload("tune", [1200, 40, 300], dim=E, seqs=[2, 1, 3], batch=24)
    twl = make_workload("tune", [1200, 40, 300], dim=E, seqs=[2, 1, 3], batch=24)
    kw = dict(lif_threshold=1e9, rock_theta=None, **planner_kwargs)
    jkw, tkw = dict(kw), dict(kw)
    if cfg_freqs:
        jkw["freqs"], tkw["freqs"] = jworkload_probs(jwl, JZipf(1.2)), workload_probs(twl, Zipf(1.2))
    jbag = JBag(jwl, n_cores=2, planner="asymmetric",
                cost_model=janalytic(dataclasses.replace(JTPU_V5E, l1_bytes=4096)),
                planner_kwargs=jkw)
    tbag = PartitionedEmbeddingBag(
        twl, n_cores=2, planner="asymmetric",
        cost_model=analytic_model(dataclasses.replace(TPU_V5E, l1_bytes=4096)),
        planner_kwargs=tkw)
    return jbag, tbag


@pytest.mark.parametrize("backend", ["cpu", "cuda", "tpu"])
def test_plan_shape_digest_matches_reference(backend):
    jbag, tbag = _bags(dedup=True, cache=True)
    cands = ((64, 128), (None,), (None, 16), (None,), (None, "sparse"), (2, 0))
    for c in ((), cands):
        assert tune.plan_shape_digest(tbag.plan, tbag.workload.tables, 24, backend, c) == \
            jtune.plan_shape_digest(jbag.plan, jbag.workload.tables, 24, backend, c)


def test_tuning_cache_hits_on_shape_identical_replan():
    cache = tune.TuningCache()
    _, tbag = _bags(dedup=True)
    first = tune.autotune_block_sizes(tbag.plan, tbag.workload.tables, batch=24,
                                      freqs=tbag.planner_kwargs["freqs"], cache=cache)
    assert tbag.plan.meta["tuning"]["cache"]["hit"] is False
    _, replan = _bags(dedup=True, cfg_freqs=False)  # new traffic, same shapes
    replan.plan.meta["cache"] = dict(tbag.plan.meta["cache"])
    replan.plan.meta["kernel"] = dict(tbag.plan.meta["kernel"])
    again = tune.autotune_block_sizes(replan.plan, replan.workload.tables, batch=24,
                                      cache=cache)
    assert again == first and replan.plan.meta["tuning"]["cache"]["hit"] is True
    assert cache.stats() == {"entries": 1, "hits": 1, "misses": 1}


def test_engine_reuses_its_tuning_cache():
    cfg = EngineConfig(mesh_shape=(1, 2), distribution="zipf:1.2", access="full",
                       tuning="sweep")
    eng = InferenceEngine.build(None, small_workload(batch=16), cfg, device="cpu")
    assert eng.stats()["tuning"]["cache"]["hit"] is False
    again = InferenceEngine.build(None, small_workload(batch=16), cfg, device="cpu",
                                  tuning_cache=eng.tuning_cache)
    assert again.stats()["tuning"]["cache"]["hit"] is True
    assert again.packed.block_r == eng.packed.block_r


SWEEP_KEYS = ("block_r", "block_b", "n_steps", "padding_frac", "chunk_bytes", "unique_cap",
              "cache_rows", "kernel_path")


@pytest.mark.parametrize("grid", ["default", "access_axes"])
def test_sweep_candidates_match_reference(grid):
    jbag, tbag = _bags(dedup=True, cache=True)
    kw = dict(batch=24, iters=1)
    if grid == "access_axes":
        kw.update(block_r_candidates=(64, 128), unique_cap_candidates=(0, 16),
                  cache_rows_candidates=(None, 8), kernel_path_candidates=(None, "sparse"))
    jbest = jtune.autotune_block_sizes(jbag.plan, jbag.workload.tables,
                                       freqs=jbag.planner_kwargs["freqs"], **kw)
    tbest = tune.autotune_block_sizes(tbag.plan, tbag.workload.tables,
                                      freqs=tbag.planner_kwargs["freqs"], **kw)
    jt, tt = jbag.plan.meta["tuning"], tbag.plan.meta["tuning"]
    assert [{k: c[k] for k in SWEEP_KEYS} for c in tt["candidates"]] == \
        [{k: c[k] for k in SWEEP_KEYS} for c in jt["candidates"]]
    assert tt["backend"] == "cpu" and tt["compiled"] is False and tt["iters"] == 1
    assert set(tt) == set(jt) and set(tbest) == set(jbest)
    assert all(c["wall_us"] > 0 for c in tt["candidates"])


# --------------------------------------------------------------------------
# the engine's records and the serve CLI
# --------------------------------------------------------------------------


def test_stats_and_report_carry_access_tuning_kernel():
    cfg = EngineConfig(mesh_shape=(1, 4), distribution="zipf:1.2", hardware="a100",
                       access="full", tuning="sweep", kernel_path="auto")
    eng = InferenceEngine.build(None, small_workload(batch=16), cfg, device="cpu")
    s = eng.stats()
    assert s["cache"]["dedup"] is True and "packed" in s["cache"]
    assert s["tuning"]["best"]["block_r"] == eng.packed.block_r
    assert s["kernel"]["packed"]["path"] == eng.packed.kernel_path
    report = eng.plan_report()
    assert "autotuned block_r=" in report and "backend=cpu" in report
    assert "access-reduction dedup=True" in report


def test_serve_cli_access_full_sweep_on_cpu(capsys):
    result = serve_cli.main([
        "--workload", "smoke", "--batch", "16", "--queries", "32", "--device", "cpu",
        "--distribution", "zipf:1.2", "--set", "mesh_shape=[1,4]",
        "--set", "access=full", "--set", "tuning=sweep", "--set", "hardware=a100",
    ])
    out = capsys.readouterr().out
    assert "access-reduction dedup=True" in out and "autotuned block_r=" in out
    s = result["stats"]["zipf:1.2"]
    assert s["submitted"] == 32 == s["served"] and s["cache"]["dedup"] is True
    engine = result["engine"]
    assert engine.packed.unique_cap > 0
    assert np.isfinite(result["last"]["logits"]).all()
