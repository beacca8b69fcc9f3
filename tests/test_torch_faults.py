"""The port's fault injector against the JAX package's.

For the same :class:`FaultPlan` (and seed) both injectors fire the same
sequence of events, poison the same queries with the same ids, and a
buffer fault corrupts the same element of the same packed buffer: a bit
flip flips the same bit (the port in place, on the tensor's device), and
``nan-rows`` poisons the same rows.  Unknown fault points are rejected as
in the reference.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import faults as jfaults
from repro_torch.data.distributions import Uniform, Zipf, sample_workload
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.serving import faults as tfaults

MODS = {"port": tfaults, "jax": jfaults}


def _plan(mod, specs, seed):
    return mod.FaultPlan([mod.FaultSpec(**s) for s in specs], seed=seed)


def test_fault_points_and_plan_round_trip_match_reference():
    assert tfaults.FAULT_POINTS == jfaults.FAULT_POINTS
    specs = [dict(point="query", at_batch=1, mode="oov", count=5),
             dict(point="buffer", at_batch=3, mode="bitflip", count=2)]
    plan = _plan(tfaults, specs, 7)
    assert plan.to_dict() == _plan(jfaults, specs, 7).to_dict()
    assert tfaults.FaultPlan.from_dict(plan.to_dict()) == plan


def test_injector_is_deterministic():
    """The reference scenario, and the port's poisoned ids equal the
    reference's for the same plan."""
    wl = small_workload("det", batch=8)
    idx = sample_workload(np.random.default_rng(3), wl, Uniform(), 8)
    rows = [t.rows for t in wl.tables]
    out = {}
    for name, mod in MODS.items():
        plan = _plan(mod, [dict(point="query", at_batch=1, mode="oov", count=5)], 7)
        a, na = mod.FaultInjector(plan).poison_queries(1, idx, rows)
        b, nb = mod.FaultInjector(plan).poison_queries(1, idx, rows)
        assert na == nb and np.array_equal(a, b)
        assert not np.array_equal(a, idx)  # it actually poisoned something
        out[name] = (a, na)
    assert out["port"][1] == out["jax"][1]
    assert np.array_equal(out["port"][0], out["jax"][0])


def test_injector_fires_once_per_spec():
    for mod in MODS.values():
        inj = mod.FaultInjector(mod.FaultPlan([mod.FaultSpec("step", at_batch=2)]))
        inj.fire("step", batch=0)  # below at_batch: no-op
        with pytest.raises(mod.InjectedFault):
            inj.fire("step", batch=2)
        inj.fire("step", batch=3)  # already fired: no-op
        assert len(inj.events) == 1


@pytest.mark.parametrize("point", ["gpu-on-fire", "Step", ""])
def test_unknown_fault_point_rejected(point):
    for mod in MODS.values():
        with pytest.raises(ValueError, match="unknown fault point"):
            mod.FaultSpec(point)


@pytest.mark.parametrize("seed", [0, 11, 2024])
def test_firing_sequence_equals_reference(seed):
    """A mixed plan fired through the same call sequence: the same events,
    the same raised faults, the same poisoned queries (``oov`` and
    ``negative``), and the injectors' random streams stay in step."""
    specs = [
        dict(point="step", at_batch=2, mode="crash"),
        dict(point="query", at_batch=1, mode="negative", count=4),
        dict(point="query", at_batch=3, mode="oov", count=3),
        dict(point="replan", mode="crash"),
        dict(point="buffer", at_batch=2, mode="bitflip", count=2),
        dict(point="step", at_batch=5),
    ]
    wl = small_workload("seq", batch=8)
    rows = [t.rows for t in wl.tables]
    runs = {}
    for name, mod in MODS.items():
        inj = mod.FaultInjector(_plan(mod, specs, seed))
        draws = []
        inj.arm("corrupt", lambda mode, count, rng, d=draws: d.append(
            (mode, count, rng.integers(1 << 30))))
        rng = np.random.default_rng(seed)
        trace = []
        for b in range(7):
            idx = sample_workload(rng, wl, Zipf(1.2), 8)
            idx, n = inj.poison_queries(b, idx, rows)
            trace.append(("query", n, idx.tolist()))
            inj.fire("buffer", batch=b)
            for point, kw in (("step", {"batch": b}), ("replan", {"batch": None})):
                try:
                    inj.fire(point, **kw)
                    trace.append((point, "ok"))
                except mod.InjectedFault as e:
                    trace.append((point, str(e)))
        runs[name] = (trace, inj.events, draws, inj.summary()["fired"])
    assert runs["port"] == runs["jax"]


def _engine(dtype="float32"):
    wl = small_workload("corrupt", batch=8)
    rng = np.random.default_rng(0)
    tables = [rng.standard_normal((t.rows, t.dim)).astype(np.float32) for t in wl.tables]
    return InferenceEngine.build(tables, wl, EngineConfig(
        mesh_shape=(1, 2), integrity="checksum", dtype=dtype), device="cpu")


class _Server:
    step_fn = None


@pytest.mark.parametrize("mode,count,dtype", [
    ("bitflip", 3, "float32"), ("bitflip", 5, "bfloat16"), ("nan-rows", 2, "float32"),
])
def test_buffer_corruption_equals_reference(mode, count, dtype):
    """The port's ``corrupt`` hook (in place on the engine's buffer) against
    the reference's (on a numpy copy, as the reference does it), on the
    same buffer with the same seed: the same elements change, bit for bit
    (NaN rows compared as NaN)."""
    engine = _engine(dtype)
    before = engine.packed.chunk_data.clone()
    bits = {2: np.uint16, 4: np.uint32}[before.element_size()]
    raw = before.view(torch.int16 if before.element_size() == 2 else torch.int32)

    @dataclasses.dataclass
    class JPacked:  # the fields the reference's hook reads
        chunk_data: object
        slot_table: object
        slot_row_start: object
        slot_rows: object

    class JEngine:
        packed = JPacked(jnp.asarray(before.float().numpy()).astype(dtype),
                         *(getattr(engine.packed, f).numpy()
                           for f in ("slot_table", "slot_row_start", "slot_rows")))

    out = {}
    for name, mod, eng in (("port", tfaults, engine), ("jax", jfaults, JEngine)):
        inj = mod.FaultInjector(_plan(mod, [dict(point="buffer", at_batch=0, mode=mode,
                                                count=count)], 5))
        mod.arm_buffer_corruption(inj, eng, _Server())
        inj.fire("buffer", batch=0)
        out[name] = eng.packed.chunk_data
    got = out["port"]
    want = np.array(out["jax"])
    if mode == "bitflip":
        got_bits = got.view(raw.dtype).numpy().view(bits)
        assert np.array_equal(got_bits, want.view(bits))
        flipped = got_bits != raw.numpy().view(bits)
        assert 1 <= flipped.sum() <= count
    else:
        assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
        assert np.isnan(got.numpy()).any()
    assert engine.verify_integrity()  # the damage is what the manifest sees
