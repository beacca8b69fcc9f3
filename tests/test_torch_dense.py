"""The dense stacked-slot layout in the port against the JAX package.

* ``multi_embedding_bag_dense`` (the plain version the CPU route runs)
  against the JAX package's Pallas kernel in interpret mode, in f32, bf16
  and f16, for s = 1 and 3, a batch that is no multiple of the reference's ``block_b`` and
  an empty slot whose ids all sit on the zero row;
* ``pack_plan(layout="dense")`` field for field against the reference's on
  the hand-built plans of ``test_torch_partition.py``, with equal
  ``plan.meta["layout"]``/``["rejoin"]``/``["kernel"]``;
* ``partitioned_lookup`` on a dense pack (fused and plain, every rejoin)
  against the reference's per-core dense lookup and against the port's own
  ragged lookup on the same plan (the layout-oracle of the JAX package's
  ``test_ragged_layout.py``);
* the traffic model on a dense pack, and a dense ``InferenceEngine`` on
  the smoke workload (pooled output and DLRM logits).

Tolerance: rtol = atol = 1e-5 on pooled outputs (f32 sums in another
order on the XLA side; the kernel and its plain version sum in the same
order and agree exactly), 1e-4 on logits (MLP reductions, as in
``test_torch_dlrm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_partition import HAND_PLANS, _hand_plans, _indices, _params, assert_packs_equal

from repro.core import partition as jpart
from repro.core import traffic as jtraffic
from repro.core.embedding import stack_indices as jstack
from repro.data.workloads import small_workload as jsmall_workload
from repro.engine import EngineConfig as JEngineConfig, InferenceEngine as JEngine
from repro.kernels.embedding_multi import multi_embedding_bag_dense as jdense
from repro.models import dlrm as jdlrm
from repro_torch.core import partition as tpart
from repro_torch.core import traffic
from repro_torch.core.embedding import PartitionedEmbeddingBag
from repro_torch.core.tables import make_workload
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.kernels.embedding_multi import (
    multi_embedding_bag_dense,
    multi_embedding_bag_dense_plain,
)
from repro_torch.models import dlrm

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
E = 16
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _stack(s_slots=3, rows=41, b=10, seq=3, seed=0):
    """A (S, R+1, E) stack with a zero last row and an empty last slot,
    ids in [0, R] with the empty slot's all on row R."""
    rng = np.random.default_rng(seed)
    chunks = rng.standard_normal((s_slots, rows, E)).astype(np.float32)
    chunks[:, -1] = 0
    chunks[-1] = 0
    lidx = rng.integers(0, rows, size=(s_slots, b, seq)).astype(np.int32)
    lidx[:, ::3, 0] = rows - 1
    lidx[-1] = rows - 1
    return chunks, lidx


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seq", [1, 3])
def test_dense_plain_matches_pallas(dtype, seq):
    tdt, jdt = DTYPES[dtype]
    chunks, lidx = _stack(seq=seq)
    want = np.asarray(jdense(jnp.asarray(chunks).astype(jdt), jnp.asarray(lidx),
                             block_b=4, interpret=True))
    got = multi_embedding_bag_dense(torch.from_numpy(chunks).to(tdt), torch.from_numpy(lidx))
    assert got.dtype == torch.float32 and got.shape == (3, 10, E)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[-1].any()  # the empty slot pools the zero row only
    plain = multi_embedding_bag_dense_plain(torch.from_numpy(chunks).to(tdt)[None],
                                            torch.from_numpy(lidx)[None])
    assert torch.equal(plain[0], got)


def test_dense_all_cores_one_call():
    """The (K, S, ...) call equals the reference's one call per core."""
    stacks = [_stack(seed=s) for s in range(3)]
    want = np.stack([np.asarray(jdense(jnp.asarray(c), jnp.asarray(i), interpret=True))
                     for c, i in stacks])
    chunks = torch.from_numpy(np.stack([c for c, _ in stacks]))
    lidx = torch.from_numpy(np.stack([i for _, i in stacks]))
    before = multi_embedding_bag_dense.launches
    got = multi_embedding_bag_dense(chunks, lidx)
    assert multi_embedding_bag_dense.launches == before  # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dense_plain_refuses_ids_outside_the_stack():
    chunks, lidx = _stack()
    for bad in (-1, chunks.shape[1]):
        ids = lidx.copy()
        ids[0, 0, 0] = bad
        with pytest.raises(IndexError, match="dense ids"):
            multi_embedding_bag_dense(torch.from_numpy(chunks), torch.from_numpy(ids))


def test_dense_wrapper_checks_shapes_and_devices():
    chunks, lidx = _stack()
    with pytest.raises(ValueError, match="matching leading axes"):
        multi_embedding_bag_dense(torch.from_numpy(chunks), torch.from_numpy(lidx[:2]))
    with pytest.raises(ValueError, match="device"):
        multi_embedding_bag_dense(torch.zeros((1, 2, 4, E), device="meta"),
                                  torch.zeros((1, 2, 3, 1), dtype=torch.int32, device="meta"))


def _dense_packs(name, dtype="float32"):
    ((jwl, jplan), (twl, tplan)), rows = _hand_plans(name)
    params = _params(rows)
    jp = jpart.pack_plan(jplan, jwl.tables, [jnp.asarray(p) for p in params],
                         dtype=getattr(jnp, dtype), layout="dense")
    tp = tpart.pack_plan(tplan, twl.tables, params, dtype=getattr(torch, dtype), layout="dense")
    return jp, tp, jplan, tplan, twl, params


@pytest.mark.parametrize("name", list(HAND_PLANS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_pack_matches_reference(name, dtype):
    jp, tp, jplan, tplan, _, _ = _dense_packs(name, dtype)
    assert tp.layout == "dense" and tp.chunk_data.dim() == 4
    assert tp.step_runs.shape == (0, 5) and tp.stage_rows == 0
    assert_packs_equal(jp, tp, jplan, tplan)
    assert tplan.meta["layout"]["kind"] == "dense"
    assert tplan.meta["layout"]["chunk_bytes"] == tplan.meta["layout"]["dense_bytes"]


def _jax_dense_lookup(jp, sidx, n, use_kernels):
    """The reference's per-core dense sweeps + psum + batch-split symmetric
    group (XLA path: its Pallas L1 kernel does not trace here)."""
    k, b = jp.n_cores, sidx.shape[1]
    out = jnp.zeros((n, b, E), jnp.float32)
    for core in range(k):
        out = out + jpart._local_asym_lookup(jp.strip_core(core), sidx, n_tables=n,
                                             use_kernels=use_kernels)
    bl = b // k
    syms = [jpart._local_sym_lookup(jp, sidx[:, c * bl:(c + 1) * bl], n_tables=n,
                                    use_kernels=False) for c in range(k)]
    return np.asarray(out + jnp.concatenate(syms, axis=1))


@pytest.mark.parametrize("name", list(HAND_PLANS))
def test_dense_lookup_matches_reference_and_ragged(name):
    jp, tp, _, tplan, twl, params = _dense_packs(name)
    n = len(twl.tables)
    idx = np.stack(_indices(twl))
    want_fused = _jax_dense_lookup(jp, jnp.asarray(idx), n, "fused")
    want_plain = _jax_dense_lookup(jp, jnp.asarray(idx), n, False)
    ragged = tpart.pack_plan(tplan, twl.tables, params)
    oracle = tpart.partitioned_lookup(ragged, torch.from_numpy(idx), n_tables=n).numpy()
    for use_kernels, want in (("fused", want_fused), (False, want_plain)):
        for reduce_mode in ("sparse", "psum", "ring"):
            got = tpart.partitioned_lookup(tp, torch.from_numpy(idx), n_tables=n,
                                           use_kernels=use_kernels,
                                           reduce_mode=reduce_mode).numpy()
            msg = f"{use_kernels}/{reduce_mode}"
            np.testing.assert_allclose(got, want, **TOL, err_msg=msg)
            np.testing.assert_allclose(got, oracle, **TOL, err_msg=msg)


@pytest.mark.parametrize("name", list(HAND_PLANS))
def test_dense_traffic_matches_reference(name):
    jp, tp, _, _, twl, _ = _dense_packs(name)
    kw = dict(batch=twl.batch, seq=2, n_tables=len(twl.tables))
    got = traffic.modeled_hbm_traffic(tp, **kw)
    assert got == jtraffic.modeled_hbm_traffic(jp, **kw)
    assert got["paths"]["fused"]["window_bytes"] == tp.chunk_bytes


def test_dense_after_ragged_reports_dense():
    """``layout_summary`` reports the last pack; the dense pack's bytes are
    the ragged pack's ``dense_bytes``; an autotune request leaves a dense
    pack unswept, as in the reference."""
    rng = np.random.default_rng(0)
    rows = [5000] + [int(x) for x in rng.integers(16, 256, 11)]
    wl = make_workload("skew", rows, dim=E, batch=32)
    bag = PartitionedEmbeddingBag(wl, n_cores=4,
                                  planner_kwargs=dict(lif_threshold=1e9, rock_theta=None))
    ragged = bag.pack(None, layout="ragged")
    meta = bag.layout_summary()
    assert meta["kind"] == "ragged"
    dense = bag.pack(None, layout="dense", autotune=True)
    assert bag.layout_summary()["kind"] == "dense"
    assert dense.chunk_bytes == meta["dense_bytes"] > 2 * ragged.chunk_bytes
    assert "tuning" not in bag.plan.meta


def test_dense_rejects_access_reduction_like_reference():
    (_, (twl, tplan)), _ = _hand_plans("replicas")
    for kw, match in ((dict(unique_cap=8), "dedup/cache require layout='ragged'"),
                      (dict(kernel_path="sparse"), "kernel_path='sparse' requires layout='ragged'")):
        with pytest.raises(ValueError, match=match):
            tpart.pack_plan(tplan, twl.tables, None, layout="dense", **kw)


@pytest.mark.parametrize("shard_rocks", [False, True])
def test_dense_engine_matches_reference(shard_rocks):
    batch = 32
    jcfg = jdlrm.DLRMConfig(arch="smoke", workload=jsmall_workload(batch=batch))
    tcfg = dlrm.DLRMConfig(arch="smoke", workload=small_workload(batch=batch))
    jparams = jdlrm.init_dlrm(jcfg, jax.random.PRNGKey(0))
    params = dlrm.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    config = dict(mesh_shape=(1, 4), distribution="uniform", layout="dense",
                  planner_options={"shard_rocks": shard_rocks})
    jeng = JEngine.build(jparams["tables"], jcfg.workload, JEngineConfig(simulate=True, **config))
    teng = InferenceEngine.build(params["tables"], tcfg.workload, EngineConfig(**config),
                                 device="cpu")
    assert teng.packed.layout == "dense" and teng.stats()["layout"]["kind"] == "dense"
    assert "layout=dense" in teng.plan_report()
    assert bool(teng.plan.symmetric_tables) is not shard_rocks
    per_table = _indices(tcfg.workload)
    sidx = jstack([jnp.asarray(i) for i in per_table], jeng.bag.s_max)
    want = _jax_dense_lookup(jeng.packed, sidx, len(per_table), "fused")
    np.testing.assert_allclose(teng.lookup(np.array(sidx)).numpy(), want, **TOL)
    np.testing.assert_allclose(teng.reference_view().lookup(np.array(sidx)).numpy(), want,
                               **TOL)
    dense_in = np.random.default_rng(3).standard_normal((batch, 13)).astype(np.float32)
    got = dlrm.forward_packed(tcfg, teng.bag, teng.packed, params,
                              {"dense": torch.from_numpy(dense_in), "indices": np.array(sidx)})
    logits = jdlrm.forward_dense(jcfg, jparams, {"dense": jnp.asarray(dense_in), "indices": sidx})
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), **LOGIT_TOL)
