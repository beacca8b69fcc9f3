"""The slot join (``kernels/embedding_rejoin.py``) against the plain join.

On the card the sparse rejoin is one kernel that joins the per-slot
partials (K, S, B, E) straight into the pooled tables, following a
schedule written at pack time; its plain version runs the same schedule on
the CPU.  Both must equal ``_sparse_rejoin(_scatter_slots(partials))``
bitwise (each element's bits, so a -0.0 that turns into +0.0 counts), on
every kind of pack: the served taobao and tenrec plans, a multi-hot plan
whose tables lie on several cores (one of them twice), replicas, the
two-level ``mesh_shape=(2, 4)`` maps (a table held by an owner on each
host), empty slots beside a table that no core holds, and partials of
-0.0.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model as tcm
from repro_torch.core import partition as tpart
from repro_torch.core.embedding import PartitionedEmbeddingBag
from repro_torch.core.strategies import ChunkAssignment, Plan, Strategy
from repro_torch.core.tables import make_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.kernels.embedding_rejoin import (
    OWNER_END,
    SENDER_END,
    rejoin_schedule,
    slot_rejoin,
    slot_rejoin_plain,
)

E = 16
B = 24
CONFIGS = Path(__file__).resolve().parent.parent / "portbench" / "configs"


def _served(name):
    """The benchmark's ``name`` configuration packed as it is served, with
    zero tables (the join reads only the plan's maps)."""
    cfg = json.loads((CONFIGS / f"dlrm-{name}.json").read_text())
    wl = make_workload(cfg["name"], cfg["rows"], dim=cfg["embed_dim"], seqs=cfg["seqs"],
                       batch=B, dtype_bytes=cfg["plan_dtype_bytes"])
    config = EngineConfig.from_dict({**cfg["engine"], "dtype": cfg["dtype"]})
    engine = InferenceEngine.build("abstract", wl, config, device="cpu")
    return engine.packed, len(wl.tables), None


def _hand(rows, seqs, k, chunks, sym=()):
    wl = make_workload("hand", rows, dim=E, seqs=seqs, batch=B)
    plan = Plan(
        workload_name="hand", n_cores=k,
        assignments=tuple(ChunkAssignment(t, c, o, r, Strategy[s], batch_frac=bf)
                          for t, c, o, r, s, bf in chunks),
        symmetric_tables=tuple(t for t, _ in sym),
        symmetric_strategies=tuple(Strategy[s] for _, s in sym),
    )
    plan.validate(wl.tables)
    rng = np.random.default_rng(5)
    tables = [(rng.standard_normal((r, E)) / 4).astype(np.float32) for r in rows]
    return wl, tpart.pack_plan(plan, wl.tables, tables)


def _multi_hot():
    """Table 0 (3 ids a query) over cores 0, 1 and 2, twice on core 1;
    partials from a real lookup, so several cores' partials of one table
    are nonzero in one query."""
    wl, packed = _hand([700, 64, 90], [3, 2, 1], 4, [
        (0, 0, 0, 200, "GM", (0, 1)), (0, 1, 200, 100, "L1", (0, 1)),
        (0, 2, 300, 250, "GM_UB", (0, 1)), (0, 1, 550, 150, "GM", (0, 1)),
        (1, 2, 0, 64, "L1", (0, 1)), (2, 3, 0, 90, "L1_UB", (0, 1))])
    rng = np.random.default_rng(9)
    idx = np.full((3, B, 3), -1, np.int32)
    for i, t in enumerate(wl.tables):
        idx[i, :, : t.seq] = rng.integers(0, t.rows, size=(B, t.seq))
    partials = tpart._slot_partials(packed, torch.from_numpy(idx), use_kernels="fused")
    nonzero = partials.ne(0).any(dim=-1) & (packed.slot_table == 0)[..., None]  # (K, S, B)
    assert (nonzero.any(dim=1).sum(dim=0) >= 2).any()  # a query with two cores' partials
    return packed, 3, partials


def _replicas():
    _, packed = _hand([512, 64, 96], [1, 1, 1], 4, [
        (0, 0, 0, 512, "GM", (0, 2)), (0, 1, 0, 512, "L1", (1, 2)),
        (1, 2, 0, 64, "L1_UB", (0, 1)), (2, 3, 0, 96, "GM_UB", (0, 1))])
    assert int(packed.slot_nrep.max()) == 2
    return packed, 3, None


def _mesh_2x4():
    rows = [20000, 30, 40, 50, 700, 90]
    wl = make_workload("mesh", rows, dim=E, seqs=[1, 2, 1, 1, 3, 1], batch=B)
    model = tcm.analytic_model(dataclasses.replace(tcm.TPU_V5E, l1_bytes=4096))
    bag = PartitionedEmbeddingBag(wl, n_cores=8, planner="hierarchical", cost_model=model,
                                  planner_kwargs=dict(hosts=2))
    packed = bag.pack(None)
    bucket = packed.rejoin_bucket.numpy()
    owners = [np.flatnonzero((bucket == t).any(axis=1)) for t in range(len(rows))]
    assert any(len({int(c) // 4 for c in o}) == 2 for o in owners), "no table on both hosts"
    return packed, len(rows), None


def _empty_and_unheld():
    """Cores 0, 1, 3, 4, 6 and 7 hold no slot; table 2 lies in the
    symmetric group, held by no core."""
    _, packed = _hand([40, 24, 300], [1, 1, 1], 8, [
        (0, 5, 0, 40, "L1", (0, 1)), (1, 2, 0, 24, "L1_UB", (0, 1))], sym=((2, "GM_UB"),))
    assert int((packed.slot_table < 0).sum()) > 0
    assert not (packed.rejoin_bucket == 2).any()
    return packed, 3, None


def _negative_zero():
    """Every partial -0.0 but for one slot's: the sums are +0.0, as the
    plain path's from its zero-filled outputs."""
    packed, n, _ = _replicas()
    k, s = packed.slot_table.shape
    partials = torch.full((k, s, B, E), -0.0)
    partials[1, 0, :3] = torch.randn(3, E)
    return packed, n, partials


CASES = {
    "taobao": lambda: _served("taobao"),
    "tenrec": lambda: _served("tenrec"),
    "multi_hot": _multi_hot,
    "replicas": _replicas,
    "mesh_2x4": _mesh_2x4,
    "empty_slots_unheld_table": _empty_and_unheld,
    "negative_zero": _negative_zero,
}


def _random_partials(packed, seed=3):
    """Normal partials with a tenth of the entries -0.0 and a tenth +0.0,
    empty slots' included (the join must leave those out)."""
    k, s = packed.slot_table.shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((k, s, B, E), generator=g)
    pick = torch.rand((k, s, B, E), generator=g)
    x[pick < 0.1] = -0.0
    x[(pick >= 0.1) & (pick < 0.2)] = 0.0
    return x


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_slot_join_is_bitwise_the_plain_join(case):
    packed, n_tables, partials = CASES[case]()
    ptr, terms = rejoin_schedule(packed.slot_table.numpy(), packed.rejoin_send.numpy(),
                                 packed.rejoin_owned_pos.numpy(),
                                 packed.rejoin_bucket.numpy(), n_tables)
    np.testing.assert_array_equal(packed.rejoin_ptr.numpy(), ptr)
    np.testing.assert_array_equal(packed.rejoin_terms.numpy(), terms)
    for x in ([] if partials is None else [partials]) + [_random_partials(packed)]:
        want = tpart._sparse_rejoin(tpart._scatter_slots(packed, x, n_tables), packed)
        for got in (slot_rejoin_plain(x, packed.rejoin_ptr, packed.rejoin_terms),
                    slot_rejoin(x, packed.rejoin_ptr, packed.rejoin_terms)):
            assert got.shape == want.shape == (n_tables, B, E)
            assert torch.equal(_bits(got), _bits(want))
    # every slot of an owned table is one term, read once, and each table's
    # last term closes its sender's and its owner's sums
    valid = packed.slot_table.numpy().reshape(-1) >= 0
    planes = np.sort(terms >> 2)
    np.testing.assert_array_equal(planes, np.flatnonzero(valid))
    for t in range(n_tables):
        if ptr[t + 1] > ptr[t]:
            assert terms[ptr[t + 1] - 1] & (SENDER_END | OWNER_END) == SENDER_END | OWNER_END
        else:
            assert not got[t].any()


def test_negative_zero_partials_sum_to_positive_zero():
    packed, _, partials = _negative_zero()
    got = slot_rejoin(partials, packed.rejoin_ptr, packed.rejoin_terms)
    zeros = got == 0
    assert zeros.any() and not torch.signbit(got[zeros]).any()


def test_cpu_lookup_still_takes_the_plain_join(monkeypatch):
    """On CPU tensors the sparse lookup goes through the module's
    ``_scatter_slots`` and ``_sparse_rejoin`` (a fault patched into either
    shows in the output), and its result is the slot join's."""
    packed, n_tables, _ = _multi_hot()
    idx = torch.zeros((n_tables, B, 3), dtype=torch.int32)
    calls = []
    for name in ("_scatter_slots", "_sparse_rejoin"):
        orig = getattr(tpart, name)
        monkeypatch.setattr(tpart, name, lambda *a, _o=orig, _n=name, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    out = tpart.partitioned_lookup(packed, idx, n_tables=n_tables)
    assert calls == ["_scatter_slots", "_sparse_rejoin"]
    partials = tpart._slot_partials(packed, idx, use_kernels="fused")
    assert torch.equal(_bits(out), _bits(slot_rejoin(partials, packed.rejoin_ptr,
                                                     packed.rejoin_terms)))


def test_stripped_core_keeps_the_whole_packs_schedule():
    packed, _, _ = _replicas()
    one = packed.strip_core(2)
    assert torch.equal(one.rejoin_ptr, packed.rejoin_ptr)
    assert torch.equal(one.rejoin_terms, packed.rejoin_terms)


def test_slot_join_refuses_what_it_does_not_take():
    packed, _, _ = _replicas()
    partials = _random_partials(packed)
    with pytest.raises(TypeError, match="float32"):
        slot_rejoin(partials.double(), packed.rejoin_ptr, packed.rejoin_terms)
    with pytest.raises(ValueError, match=r"\(K, S, B, E\)"):
        slot_rejoin(partials[0], packed.rejoin_ptr, packed.rejoin_terms)
