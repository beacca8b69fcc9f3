"""The readers of the program's spans and counters (``portbench/spans.py``)
on the tiny cell, on the CPU: every new per-layer entry has its reader; the
device-time readers find nothing off the card; the counter shares agree
with the benchmark's own count and lie in [0, 100]; and the stretch's
bookkeeping (idle gaps by host span, device time by span and batch) on
synthetic records."""
import json
import types

import pytest
import torch

from portbench import harness, spans, spec, trace
from portbench.tests import tiny

DEVICE_READERS = ["lookup_device_ms", "index_copy_ms", "slot_ids_ms", "scatter_ms",
                  "rejoin_ms", "access_ms", "mlp_ms", "interact_ms", "lookup_idle_share"]
COUNTER_READERS = ["access_hit_share", "dedup_unique_share", "spill_share"]
CELLS = ["taobao-zipf12-b256k", "tenrec-hotset-b256k", "taobao-uniform-b256k",
         "tenrec-uniform-b256k"]


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("tiny"))
    cell = spec.load_cell(root, tiny.CELL)
    state = harness.build(cell, 2**31 + 5, torch.device("cpu"))
    batches, start = harness.run_loop(state, n_batches=3)
    return trace.Context(cell=cell, state=state, batches=batches, start=start, seconds=1.0,
                         seed=2**31 + 5)


def _read(ctx, name):
    return spec.load_reader(ctx.cell.root, name)(ctx)


@pytest.mark.parametrize("name", DEVICE_READERS + COUNTER_READERS)
def test_each_new_entry_has_its_reader(name):
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    [entry] = [m for m in bench["per_layer"] if m["name"] == name]
    assert entry["workloads"] == CELLS and entry["moves"] == "samples_per_s"
    assert entry["source"] == ("program_counter" if name in COUNTER_READERS else "device_trace")
    assert callable(spec.load_reader(tiny.REPO, name))


@pytest.mark.parametrize("name", DEVICE_READERS)
def test_device_readers_find_nothing_off_the_card(ctx, name):
    assert _read(ctx, name) is None


def test_access_hit_share_is_cache_hit_share(ctx):
    assert _read(ctx, "access_hit_share") == pytest.approx(_read(ctx, "cache_hit_share"),
                                                           abs=1e-6)


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_counter_shares_lie_in_0_to_100(ctx, name):
    assert 0.0 <= _read(ctx, name) <= 100.0


def test_one_measurement_a_run_written_beside_the_trace(ctx):
    got = spans.program(ctx)
    assert spans.program(ctx) is got
    assert got["stretch"] is None and got["counting_s"] > 0
    path = ctx.cell.root / "portbench" / "out" / f"spans-{ctx.cell.name}-{ctx.seed}.json"
    assert json.loads(path.read_text())["counts"] == got["counts"]


def test_a_program_without_spans_or_counters_gives_nothing(ctx, monkeypatch):
    bare = trace.Context(cell=ctx.cell, state=ctx.state, batches=ctx.batches, start=ctx.start,
                         seconds=ctx.seconds, seed=ctx.seed + 1)
    monkeypatch.setattr(spans, "_counts", lambda state: None)
    for name in DEVICE_READERS + COUNTER_READERS:
        assert _read(bare, name) is None


PROGRAM = [(10, 60, "repro.lookup"), (12, 20, "repro.lookup.index_copy"),
           (20, 30, "repro.lookup.slot_ids"), (62, 70, "repro.step.bottom_mlp")]
HARNESS = [(5, 80, "portbench.step"), (80, 90, "portbench.readback")]


@pytest.mark.parametrize("gap,pieces", [
    ((14, 18), [["repro.lookup.index_copy", 4]]),  # inside the innermost span
    ((18, 24), [["repro.lookup.index_copy", 2], ["repro.lookup.slot_ids", 4]]),
    ((28, 34), [["repro.lookup.slot_ids", 2], ["repro.lookup", 4]]),  # back in the parent
    ((58, 64), [["repro.lookup", 2], ["portbench.step", 2], ["repro.step.bottom_mlp", 2]]),
    ((78, 84), [["portbench.step", 2], ["portbench.readback", 4]]),  # no program span
    ((88, 95), [["portbench.readback", 2], [spans.HOST_OTHER, 5]]),  # past every range
])
def test_idle_goes_to_the_innermost_span(gap, pieces):
    assert spans.idle_by_span([gap], PROGRAM, HARNESS) == [pieces]


def _rec(name, start, end=None, *, parent=None, device=False):
    cpu = torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=name, cpu_parent=parent, is_user_annotation=name.startswith("repro."),
        device_type=torch.autograd.DeviceType.CUDA if device else cpu,
        time_range=types.SimpleNamespace(start=start, end=start if end is None else end))


def _two_batches():
    """Two batches on the host (steps at 0 and 100 us) that run on the card
    at 1000 and 2000 us: host records, device-side span records, and the
    device's operations, the harness's readback copy last."""
    steps, host, device, ops = [], [], [], []
    for b in range(2):
        step = _rec("portbench.step", 100 * b, 100 * b + 90)
        lookup = _rec("repro.lookup", 100 * b + 1, 100 * b + 50, parent=step)
        copy = _rec("repro.lookup.index_copy", 100 * b + 2, 100 * b + 10, parent=lookup)
        access = _rec("repro.lookup.access", 100 * b + 20, 100 * b + 40, parent=lookup)
        mlp = _rec("repro.step.top_mlp", 100 * b + 60, 100 * b + 80, parent=step)
        steps.append(step)
        host += [step, lookup, copy, access, mlp]
        t = 1000 * (b + 1)
        device += [_rec("repro.lookup.index_copy", t, t + 100, device=True),
                   _rec("repro.lookup.access", t + 110, t + 150 + b, device=True),
                   _rec("repro.step.top_mlp", t + 200, t + 400, device=True)]
        ops += [_rec("Memcpy HtoD", t, t + 100, device=True),
                _rec("dedup_kernel", t + 110, t + 130, device=True),
                _rec("gather_kernel", t + 135, t + 150 + b, device=True),
                _rec("gemm", t + 200, t + 400, device=True),
                _rec("Memcpy DtoH", t + 450, t + 460, device=True)]
    return steps, host, device, ops


def test_device_time_goes_to_every_enclosing_span_by_batch():
    """Each operation counts for the span whose device record holds it and
    for every span above that on the host, in its batch."""
    steps, host, device, ops = _two_batches()
    prof = types.SimpleNamespace(events=lambda: host + device)
    got = spans._device_ms(prof, steps, ops)
    want = {"repro.lookup": [0.135, 0.136], "repro.lookup.index_copy": [0.1, 0.1],
            "repro.lookup.access": [0.035, 0.036], "repro.step.top_mlp": [0.2, 0.2]}
    assert set(got) == set(want)
    assert all(got[k] == pytest.approx(want[k]) for k in want)
    assert spans._device_ms(types.SimpleNamespace(events=lambda: host + device[:-1]),
                            steps, ops) is None  # a device record without its host span


def test_a_session_reads_into_medians_and_every_gap():
    steps, host, device, ops = _two_batches()
    prof = types.SimpleNamespace(events=lambda: host + device)
    got = spans._read_session((ops, steps, prof))
    assert got["batches"] == 2
    assert got["device_ms"]["repro.lookup"] == pytest.approx(0.1355)
    gaps = [g for g, _ in got["gaps"]]
    assert gaps == sorted(gaps, reverse=True) and len(gaps) == 9  # 4 in a batch, 1 between
    idle = got["window_s"] - got["busy_s"]
    assert sum(got["idle_s"].values()) == pytest.approx(idle)
    assert sum(gaps) == pytest.approx(idle)
    assert all(name.startswith(("repro.", "portbench.")) or name == spans.HOST_OTHER
               for _, pieces in got["gaps"] for name, _ in pieces)
    json.dumps(got)
