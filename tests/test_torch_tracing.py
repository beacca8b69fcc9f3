"""The port's spans and counters (``repro_torch.tracing``) on the CPU, on a
small engine with batch dedup and the hot-row cache armed.

* Without a profiler ``span`` is one shared no-op, and only a
  ``counting()`` block fills counters.
* Under ``torch.profiler`` one ``forward_packed`` records ``repro.lookup``
  with ``index_copy``, ``slot_ids``, ``access``, ``scatter`` and ``rejoin``
  nested in it, in that order, and the three ``repro.step.*`` spans after
  it, on every layout, executor path and rejoin.
* The counters equal a recount from ``_fused_ids`` and ``dedup_indices``:
  ``cache_hits + ranked + spilled == lookups``, and a batch past
  ``unique_cap`` spills; the index and slot-id counters equal the entries
  and bytes of the multi-hot batch (``s`` up to 4), and the copy's bytes
  are 0 for indices already on the device; a CPU pack stages nothing
  (``index_copy_staged_bytes`` 0) whatever form the host indices take.
* Counting leaves the pooled outputs and the logits bitwise as they were.
* The benchmark's readers of the index and slot-id counters
  (``portbench/metrics/index_pad_share.py``, ``slot_id_pad_share.py``,
  ``index_copy_roofline.py``) give nothing where a counter or the span is
  absent.
"""
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import spec
from repro_torch import tracing
from repro_torch.core import partition
from repro_torch.core.partition import _fused_ids
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.kernels.embedding_multi import dedup_indices
from repro_torch.models import dlrm

ACCESS = dict(mesh_shape=(1, 4), distribution="zipf:1.2", hardware="a100", access="full")
LOOKUP_CHILDREN = ["index_copy", "slot_ids", "access", "scatter", "rejoin"]
STEP_SPANS = ["repro.step.bottom_mlp", "repro.step.interact", "repro.step.top_mlp"]
B = 256
COUNTERS = {"lookups", "cache_hits", "unique_rows", "spilled", "index_entries",
            "index_copy_bytes", "index_copy_staged_bytes", "slot_id_entries"}


def _model(**config):
    wl = small_workload(batch=16)
    cfg = dlrm.DLRMConfig(arch="tracing", workload=wl, bottom_mlp=(32, 16), top_mlp=(32,))
    params = dlrm.init_dlrm(cfg, torch.Generator().manual_seed(0))
    engine = InferenceEngine.build(params["tables"], wl, EngineConfig(**config), device="cpu")
    return cfg, params, engine


@pytest.fixture(scope="module")
def model():
    cfg, params, engine = _model(**ACCESS)
    assert engine.packed.unique_cap and engine.packed.cache_rows  # dedup and cache armed
    return cfg, params, engine


def _indices(engine, kind: str, seed: int = 0) -> np.ndarray:
    """(N, B, s_max) int32: ``"skewed"`` draws each id from a table's first
    rows, ``"uniform"`` from all of them; ``-1`` pads each table past its s."""
    rng = np.random.default_rng(seed)
    tables = engine.bag.workload.tables
    idx = np.full((len(tables), B, max(t.seq for t in tables)), -1, dtype=np.int32)
    for i, t in enumerate(tables):
        hi = min(t.rows, 8) if kind == "skewed" else t.rows
        idx[i, :, :t.seq] = rng.integers(0, hi, (B, t.seq))
    return idx


def _forward(cfg, params, engine, idx, **kw):
    dense = torch.from_numpy(np.random.default_rng(1).standard_normal((B, cfg.n_dense),
                                                                      dtype=np.float32))
    return dlrm.forward_packed(cfg, engine.bag, engine.packed, params,
                               {"dense": dense, "indices": idx}, **kw)


def test_without_a_profiler_spans_are_one_noop_and_only_counting_fills(model):
    cfg, params, engine = model
    assert tracing.span("lookup") is tracing.span("step.top_mlp")
    with tracing.span("lookup") as inside:
        assert inside is None
    idx = _indices(engine, "uniform")
    _forward(cfg, params, engine, idx)
    tracing.count("lookups", 5)  # outside a block: dropped
    with tracing.counting() as counts:
        assert counts == {}
        _forward(cfg, params, engine, idx)
    assert set(counts) == COUNTERS
    assert all(type(v) is int and v >= 0 for v in counts.values())
    with tracing.counting() as again:
        pass
    assert again == {}


@pytest.mark.parametrize("config,use_kernels,reduce_mode", [
    (ACCESS, "fused", "sparse"),
    (dict(mesh_shape=(1, 4), distribution="uniform"), False, "ring"),
    (dict(mesh_shape=(1, 4), distribution="uniform", layout="dense"), "fused", "psum"),
], ids=["ragged-access-fused-sparse", "ragged-plain-ring", "dense-fused-psum"])
def test_spans_nest_under_the_profiler(config, use_kernels, reduce_mode):
    cfg, params, engine = _model(**config)
    idx = _indices(engine, "uniform")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _forward(cfg, params, engine, idx, use_kernels=use_kernels, reduce_mode=reduce_mode)
    spans = sorted((e for e in prof.events() if e.name.startswith("repro.")),
                   key=lambda e: e.time_range.start)
    [lookup] = [e for e in spans if e.name == "repro.lookup"]
    children = [e.name for e in spans if e.cpu_parent is lookup]
    assert children == [f"repro.lookup.{n}" for n in LOOKUP_CHILDREN]
    steps = [e for e in spans if e.name.startswith("repro.step.")]
    assert [e.name for e in steps] == STEP_SPANS
    assert all(e.time_range.start >= lookup.time_range.end for e in steps)
    assert all(e.cpu_parent is None or not e.cpu_parent.name.startswith("repro.")
               for e in steps)
    assert {e.name for e in spans} == {"repro.lookup", *STEP_SPANS,
                                       *(f"repro.lookup.{n}" for n in LOOKUP_CHILDREN)}


def _recount(engine, idx) -> dict:
    packed = engine.packed
    lidx, hidx = _fused_ids(packed, torch.as_tensor(idx))
    hits = int((hidx >= 0).sum())
    uniq, rank, spill = dedup_indices(lidx, packed.unique_cap)
    return {"lookups": int((lidx >= 0).sum()) + hits, "cache_hits": hits,
            "ranked": int((rank >= 0).sum()), "unique_rows": int((uniq >= 0).sum()),
            "spilled": int((spill >= 0).sum()), "index_entries": idx.size,
            "index_copy_bytes": idx.nbytes, "index_copy_staged_bytes": 0,  # a CPU pack
            "slot_id_entries": lidx.numel()}


@pytest.mark.parametrize("kind", ["skewed", "uniform"])
def test_counters_equal_the_recount(model, kind):
    cfg, params, engine = model
    idx = _indices(engine, kind)
    with tracing.counting() as counts:
        _forward(cfg, params, engine, idx)
    want = _recount(engine, idx)
    assert counts == {k: want[k] for k in COUNTERS}
    assert counts["cache_hits"] + want["ranked"] + counts["spilled"] == counts["lookups"]
    assert counts["cache_hits"] > 0
    if kind == "skewed":  # a few ids a table: within the cap
        assert counts["spilled"] == 0
    else:  # past unique_cap in the large tables' slots
        assert counts["spilled"] > 0


def test_counts_add_over_batches(model):
    cfg, params, engine = model
    batches = [_indices(engine, "uniform", seed) for seed in (2, 3)]
    with tracing.counting() as counts:
        for idx in batches:
            _forward(cfg, params, engine, idx)
    parts = [_recount(engine, idx) for idx in batches]
    assert counts == {k: sum(p[k] for p in parts) for k in counts}


def test_counting_leaves_outputs_bitwise(model):
    cfg, params, engine = model
    idx = _indices(engine, "uniform")
    pooled = engine.lookup(idx)
    logits = _forward(cfg, params, engine, idx)
    with tracing.counting():
        pooled_counted = engine.lookup(idx)
        logits_counted = _forward(cfg, params, engine, idx)
    assert torch.equal(pooled, pooled_counted)
    assert torch.equal(logits, logits_counted)


def test_index_and_slot_id_counters_are_the_batch_entries_and_bytes(model):
    """On a multi-hot batch ((6, B, 4) int32, ``-1`` past each table's s)
    handed over from the host, as the served step hands it: the index copy
    counts every entry, padding included, and its bytes; the slot ids count
    every entry of (K, S, B, s).  Indices already on the device (``lookup``
    makes a tensor of them first) move no bytes."""
    cfg, params, engine = model
    packed = engine.packed
    idx = _indices(engine, "uniform")
    assert idx.shape == (6, B, 4) and (idx < 0).any()
    k, s_slots = packed.slot_table.shape
    with tracing.counting() as counts:
        _forward(cfg, params, engine, idx)
    assert counts["index_entries"] == idx.size == 6 * B * 4
    assert counts["index_copy_bytes"] == idx.nbytes == 4 * idx.size
    assert counts["slot_id_entries"] == k * s_slots * B * 4
    assert counts["lookups"] == _recount(engine, idx)["lookups"] < counts["index_entries"]
    with tracing.counting() as on_device:
        engine.lookup(idx)
    assert on_device["index_copy_bytes"] == 0
    assert on_device["index_entries"] == counts["index_entries"]


def test_index_and_slot_id_counters_record_nothing_outside_counting(model):
    cfg, params, engine = model
    idx = _indices(engine, "skewed")
    with tracing.counting() as counts:
        engine.lookup(idx)
    before = dict(counts)
    engine.lookup(idx)
    _forward(cfg, params, engine, idx)
    assert counts == before
    assert tracing._COUNTS.get() is None


def _index_forms(idx: np.ndarray) -> dict:
    """The same ids in the forms a caller may hand the lookup."""
    return {
        "numpy-int32": idx,
        "numpy-int64": idx.astype(np.int64),
        "numpy-permuted": np.ascontiguousarray(idx.transpose(1, 0, 2)).transpose(1, 0, 2),
        "numpy-strided": np.repeat(idx, 2, axis=1)[:, ::2],
        "cpu-tensor": torch.from_numpy(idx.copy()),
    }


@pytest.mark.parametrize("form", list(_index_forms(np.zeros((1, 1, 1), np.int32))))
def test_a_cpu_pack_stages_no_index_bytes(model, form):
    """On a CPU pack nothing goes through a page-locked buffer:
    ``index_copy_staged_bytes`` reads 0 for host arrays and for a tensor
    already on the lookup's device, while ``index_entries`` and
    ``index_copy_bytes`` count as before, and the pooled output is bitwise
    that of the int32 array."""
    cfg, params, engine = model
    idx = _indices(engine, "uniform", seed=5)
    given = _index_forms(idx)[form]
    want = engine.bag.apply(engine.packed, idx)
    with tracing.counting() as counts:
        got = engine.bag.apply(engine.packed, given)
    assert torch.equal(got, want)
    assert counts["index_copy_staged_bytes"] == 0
    assert counts["index_entries"] == idx.size
    moved = 0 if form == "cpu-tensor" else given.nbytes
    assert counts["index_copy_bytes"] == moved


@pytest.mark.parametrize("form", list(_index_forms(np.zeros((1, 1, 1), np.int32))))
def test_index_copy_keeps_dtype_shape_and_values(form):
    """The index copy of a CPU pack hands the kernels the caller's dtype,
    shape and values; a tensor already on the device comes back as it is,
    and a numpy array without a copy."""
    idx = np.random.default_rng(6).integers(-1, 50, (3, 8, 4)).astype(np.int32)
    given = _index_forms(idx)[form]
    got = partition._index_copy(given, torch.device("cpu"))
    assert got.device.type == "cpu" and tuple(got.shape) == idx.shape
    assert got.dtype == torch.as_tensor(given).dtype
    assert torch.equal(got.long(), torch.from_numpy(idx).long())
    if form == "cpu-tensor":
        assert got is given
    else:
        assert np.shares_memory(got.numpy(), given)


@pytest.mark.parametrize("form", list(_index_forms(np.zeros((1, 1, 1), np.int32))))
def test_to_device_on_the_cpu_stages_nothing(form):
    """``to_device`` to the CPU is ``torch.as_tensor``: the caller's dtype,
    shape and values, a numpy array without a copy, a CPU tensor as it is;
    its counter reads 0, and no counter is touched without one."""
    from repro_torch.device import to_device

    idx = np.random.default_rng(8).integers(-1, 50, (3, 8, 4)).astype(np.int32)
    given = _index_forms(idx)[form]
    with tracing.counting() as counts:
        got = to_device(given, torch.device("cpu"), counter="index_copy_staged_bytes")
        to_device(given, "cpu")
    assert counts == {"index_copy_staged_bytes": 0}
    assert got.dtype == torch.as_tensor(given).dtype
    assert torch.equal(got.long(), torch.from_numpy(idx).long())
    if form == "cpu-tensor":
        assert got is given
    else:
        assert np.shares_memory(got.numpy(), given)


def test_broadcast_batch_on_a_cpu_engine_stages_nothing(model):
    """The served step's index move on a CPU engine: no page-locked buffer,
    the lookup's counters as for the array itself, and the same pooled
    output."""
    cfg, params, engine = model
    idx = _indices(engine, "skewed")
    want = engine.bag.apply(engine.packed, idx)
    with tracing.counting() as counts:
        got = engine.bag.apply(engine.packed, engine.broadcast_batch(idx))
    assert torch.equal(got, want)
    assert counts["index_copy_staged_bytes"] == 0
    assert counts["index_entries"] == idx.size


def test_staged_bytes_are_recorded_only_inside_counting(model):
    cfg, params, engine = model
    idx = _indices(engine, "skewed")
    engine.bag.apply(engine.packed, idx)
    assert tracing._COUNTS.get() is None
    with tracing.counting() as empty:
        pass
    assert "index_copy_staged_bytes" not in empty
    with tracing.counting() as counts:
        engine.bag.apply(engine.packed, idx)
    assert counts["index_copy_staged_bytes"] == 0
    assert counts["index_copy_bytes"] == idx.nbytes


READERS = ["index_pad_share", "slot_id_pad_share", "index_copy_roofline"]
REPO = Path(__file__).resolve().parents[1]
FULL = {"index_entries": 4000, "index_copy_bytes": 4 * 64_000_000, "slot_id_entries": 10_000,
        "lookups": 1000}
STRETCH = {"device_ms_per_batch": {"repro.lookup.index_copy": [2.0, 2.0, 2.0]}}


def _ctx(counts, stretch):
    """A reader's context whose program measurement is already taken:
    ``counts`` over one pass of a pool of 4 batches, the ``stretch``."""
    ctx = types.SimpleNamespace(state=types.SimpleNamespace(pool=[None] * 4))
    ctx._program = {"stretch": stretch, "counts": counts, "counting_s": 0.0}
    return ctx


def test_index_readers_read_the_counters_and_the_span():
    read = {n: spec.load_reader(REPO, n) for n in READERS}
    ctx = _ctx(FULL, STRETCH)
    assert read["index_pad_share"](ctx) == pytest.approx(75.0)
    assert read["slot_id_pad_share"](ctx) == pytest.approx(90.0)
    # 64 MB a batch at 64 GB/s is 1 ms, against 2 ms under the span
    assert read["index_copy_roofline"](ctx) == pytest.approx(50.0)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("absent", ["counts", "its_counter", "lookups", "span"])
def test_index_readers_give_nothing_where_a_counter_or_span_is_absent(name, absent):
    counts, stretch = dict(FULL), STRETCH
    if absent == "counts":
        counts = None
    elif absent == "its_counter":
        del counts[{"index_pad_share": "index_entries", "slot_id_pad_share": "slot_id_entries",
                    "index_copy_roofline": "index_copy_bytes"}[name]]
    elif absent == "lookups":
        del counts["lookups"]
        if name == "index_copy_roofline":  # reads no lookups: its span goes instead
            stretch = None
    else:
        stretch = None
        if name != "index_copy_roofline":  # reads no span: its counter goes instead
            del counts["lookups"]
    assert spec.load_reader(REPO, name)(_ctx(counts, stretch)) is None
