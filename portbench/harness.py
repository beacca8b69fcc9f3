"""One run of one cell: set-up, the measured window, the traced readings,
the check against the plain reference, and the result line.

The window drives the program's DLRM serving step, the one the serve CLI's
``make_step`` builds, without its ``Server``: per batch the dense inputs go
to the card, ``repro_torch.models.dlrm.forward_packed`` runs over the
engine that ``InferenceEngine.build`` made from the configuration, and the
logits come back to the host.  The loop is closed with a fixed number of
batches in flight (the traffic file's ``in_flight``): the host releases
batch n+1 before it waits for batch n.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from portbench import reference, spec, yardstick
from portbench.traffic import generator

__all__ = ["FORBIDDEN_MODULES", "build", "check", "main", "run_cell", "run_loop"]

# top-level module names that must not be loaded in the process that prints
# a result: JAX, and the JAX package this program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _record(name: str):
    import torch

    return torch.profiler.record_function(f"portbench.{name}")


# --------------------------------------------------------------------------
# set-up
# --------------------------------------------------------------------------


@dataclasses.dataclass
class State:
    """Everything a run holds: the raw inputs the harness made (``tables``,
    ``mlp``, ``pool``), which the reference reads too, and the program's
    objects (``engine``, ``modules``), which it never reads."""

    device: object
    config: dict
    traffic: dict
    tables: list  # raw (m_i, E) f32 tables on the device
    mlp: dict  # raw {"bottom", "top"}: lists of (w (in, out), b) on the device
    pool: list  # [(indices (N, B, s) int32 numpy, dense (B, n_dense) f32 tensor on the host)]
    engine: object = None
    modules: dict = None  # the program's DLRM MLPs
    dlrm_cfg: object = None
    captured: dict = dataclasses.field(default_factory=dict)  # pool slot -> pooled
    setup_phases: dict = dataclasses.field(default_factory=dict)  # phase -> host seconds


def _raw_weights(cfg: dict, seed: int, device) -> tuple[list, dict]:
    """Tables N(0, 1/E) and He-scaled MLP weights with small biases, drawn
    on ``device`` from ``seed`` in two large calls."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    rows, e = cfg["rows"], cfg["embed_dim"]
    big = torch.randn((sum(rows), e), generator=gen, device=device).div_(math.sqrt(e))
    tables = list(torch.split(big, rows))
    mlp = {}
    shapes = [(name, a, b) for name, dims in zip(("bottom", "top"), yardstick.mlp_dims(cfg))
              for a, b in zip(dims[:-1], dims[1:])]
    flat = torch.randn(sum(a * b + b for _, a, b in shapes), generator=gen, device=device)
    at = 0
    for name, a, b in shapes:
        w = flat[at:at + a * b].view(a, b).mul_(math.sqrt(2.0 / a))
        bias = flat[at + a * b:at + a * b + b].mul_(0.05)
        at += a * b + b
        mlp.setdefault(name, []).append((w, bias))
    return tables, mlp


def _pool(cfg: dict, traffic: dict, seed: int, pinned: bool) -> list:
    import torch

    rng = np.random.default_rng(seed)
    laws = [generator.row_probs(traffic["distribution"], m) for m in cfg["rows"]]
    pool = []
    for _ in range(traffic["pool"]):
        idx = generator.sample_batch(rng, laws, cfg["seqs"], traffic["batch"])
        dense = torch.from_numpy(
            rng.standard_normal((traffic["batch"], cfg["n_dense"]), dtype=np.float32))
        pool.append((idx, dense.pin_memory() if pinned else dense))
    return pool


def build(cell: spec.Cell, seed: int, device, engine_overrides: dict | None = None) -> State:
    """The cell's inputs from ``seed`` and the program built over them."""
    t = time.perf_counter()
    import torch

    from repro_torch.core.tables import make_workload
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.models.dlrm import MLP, DLRMConfig

    cfg, traffic = cell.config, cell.traffic
    seed = seed % 2**63
    phases = {"import_program": time.perf_counter() - t}
    t = time.perf_counter()
    tables, mlp = _raw_weights(cfg, seed, device)
    phases["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = _pool(cfg, traffic, seed, pinned=device.type == "cuda")
    phases["pool"] = time.perf_counter() - t
    t = time.perf_counter()
    workload = make_workload(cfg["name"], cfg["rows"], dim=cfg["embed_dim"], seqs=cfg["seqs"],
                             batch=traffic["batch"], dtype_bytes=cfg["plan_dtype_bytes"])
    engine_cfg = EngineConfig.from_dict({**cfg["engine"], "dtype": cfg["dtype"],
                                         **(engine_overrides or {})})
    engine = InferenceEngine.build(tables, workload, engine_cfg, device=device)
    modules = {}
    with torch.no_grad():
        for name, final_act, dims in zip(("bottom", "top"), (True, False),
                                         yardstick.mlp_dims(cfg)):
            with torch.device(device):
                m = MLP(dims, final_act=final_act)
            for lin, (w, b) in zip(m.layers, mlp[name]):
                lin.weight.copy_(w.T)
                lin.bias.copy_(b)
            modules[name] = m
    dlrm_cfg = DLRMConfig(arch=cfg["name"], workload=workload, n_dense=cfg["n_dense"],
                          embed_dim=cfg["embed_dim"], bottom_mlp=tuple(cfg["bottom_mlp"]),
                          top_mlp=tuple(cfg["top_mlp"]))
    phases["engine"] = time.perf_counter() - t
    return State(device=device, config=cfg, traffic=traffic, tables=tables, mlp=mlp,
                 pool=pool, engine=engine, modules=modules, dlrm_cfg=dlrm_cfg,
                 setup_phases=phases)


# --------------------------------------------------------------------------
# the closed loop
# --------------------------------------------------------------------------


class _Capture:
    """The engine's bag, handed to ``forward_packed`` in its place, keeping
    the pooled output of the last call (a reference, no copy)."""

    def __init__(self, bag):
        self.bag = bag
        self.last = None

    def apply(self, *args, **kwargs):
        self.last = self.bag.apply(*args, **kwargs)
        return self.last


@dataclasses.dataclass
class Batch:
    slot: int  # the pool batch it carried
    released: float
    release_s: float = 0.0  # host time of the release
    done: float | None = None
    wait_s: float = 0.0  # host time waiting for its logits
    logits: np.ndarray | None = None
    error: str | None = None
    _event: object = None
    _out: object = None


def run_loop(state: State, *, seconds: float | None = None, n_batches: int | None = None,
             keep: bool = True) -> tuple[list, float]:
    """Release batches of the pool in turn, ``in_flight`` at a time, for
    ``seconds`` (or ``n_batches``), then wait for those still in flight.
    Returns every batch released and the loop's start (host clock)."""
    import torch

    from repro_torch.models import dlrm

    engine, device = state.engine, state.device
    depth = int(state.traffic["loop"]["in_flight"])
    cap = _Capture(engine.bag)
    use_kernels = "fused" if engine.config.use_kernels == "fused" else False
    on_card = device.type == "cuda"
    b = state.traffic["batch"]
    outs = ([torch.empty(b, dtype=torch.float32).pin_memory() for _ in range(depth + 1)]
            if on_card else None)
    batches, inflight = [], collections.deque()

    def release(i: int) -> Batch:
        slot = i % len(state.pool)
        idx, dense_host = state.pool[slot]
        bt = Batch(slot=slot, released=time.perf_counter())
        try:
            with _record("release"):
                dense = dense_host.to(device, non_blocking=True)
            with _record("step"):
                logits = dlrm.forward_packed(
                    state.dlrm_cfg, cap, engine.packed, state.modules,
                    {"dense": dense, "indices": idx},
                    use_kernels=use_kernels, reduce_mode=engine.config.reduce_mode)
            with _record("readback"):
                if on_card:
                    bt._out = outs[i % len(outs)]
                    bt._out.copy_(logits, non_blocking=True)
                    bt._event = torch.cuda.Event()
                    bt._event.record()
                else:
                    bt._out = logits
            if keep:
                state.captured[slot] = cap.last
        except Exception as exc:  # a failed batch is counted, and the loop goes on
            bt.error = f"{type(exc).__name__}: {exc}"
        bt.release_s = time.perf_counter() - bt.released
        return bt

    def complete(bt: Batch) -> None:
        t = time.perf_counter()
        if bt.error is None:
            try:
                with _record("wait"):
                    if bt._event is not None:
                        bt._event.synchronize()
                    arr = bt._out.numpy().copy()
                bt.done = time.perf_counter()
                if not np.isfinite(arr).all():
                    bt.error = "non-finite logits"
                if keep:
                    bt.logits = arr
            except Exception as exc:
                bt.error = f"{type(exc).__name__}: {exc}"
        bt.wait_s = time.perf_counter() - t
        bt._event = bt._out = None

    start = time.perf_counter()
    end = start + seconds if seconds is not None else math.inf
    i = 0
    while time.perf_counter() < end and (n_batches is None or i < n_batches):
        bt = release(i)
        batches.append(bt)
        inflight.append(bt)
        if len(inflight) >= depth:
            complete(inflight.popleft())
        i += 1
    while inflight:
        complete(inflight.popleft())
    return batches, start


def e2e_metrics(batches: list, start: float, seconds: float, batch: int, setup_s: float) -> dict:
    """The end-to-end metrics the benchmark can compute, by name."""
    end = start + seconds
    completed = sum(1 for bt in batches if bt.error is None and bt.done <= end)
    lat = [(bt.done - bt.released) * 1e3 for bt in batches if bt.error is None]
    return {
        "samples_per_s": completed * batch / seconds,
        "batch_p95_ms": float(np.percentile(lat, 95)) if lat else math.inf,
        "setup_s": setup_s,
    }


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------


def check(state: State, batches: list) -> dict:
    """Every window batch's logits and each pool batch's last pooled lookup
    in the window against the plain reference, worked out again from the
    raw inputs.  Returns ``{name: value}``."""
    import torch

    device = state.device
    pooled_err = logit_err = 0.0
    compared = 0
    by_slot = collections.defaultdict(list)
    for bt in batches:
        if bt.logits is not None:
            by_slot[bt.slot].append(bt.logits)
    for slot, (idx, dense) in enumerate(state.pool):
        if slot not in by_slot and slot not in state.captured:
            continue
        ref_pooled = reference.pooled(state.tables, torch.from_numpy(idx).to(device))
        if slot in state.captured:
            got = state.captured[slot]
            pooled_err = max(pooled_err, float((got.float() - ref_pooled).abs().max()))
        ref = reference.logits(state.mlp, dense.to(device), ref_pooled).cpu().numpy()
        for got in by_slot.get(slot, []):
            logit_err = max(logit_err, float(np.abs(got - ref).max()))
            compared += 1
    return {"pooled_max_abs_err": pooled_err, "logit_max_abs_err": logit_err,
            "compared_batches": compared}


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------


def _free_program(state: State) -> None:
    import torch

    state.engine = state.modules = state.dlrm_cfg = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t0: float | None = None, marks: dict | None = None,
             engine_overrides: dict | None = None) -> dict:
    """One run: returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``checks`` and, traced,
    ``breakdown``) and ``info`` for standard error.  ``marks`` holds host
    clock readings the caller took since ``t0``, by phase, in order."""
    import torch

    from portbench import trace as trace_lib

    t0 = time.perf_counter() if t0 is None else t0
    marks = dict(marks or {})
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()
        marks["cuda_init"] = time.perf_counter()
    state = build(cell, seed, device, engine_overrides)
    t = time.perf_counter()
    warm = int(cell.traffic["warmup_batches"])
    run_loop(state, n_batches=warm, keep=False)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    phases, prev = {}, t0
    for name, at in marks.items():
        phases[name] = at - prev
        prev = at
    state.setup_phases = {**phases, **state.setup_phases, "warmup": time.perf_counter() - t}
    state.captured.clear()
    setup_s = time.perf_counter() - t0
    batches, start = run_loop(state, seconds=seconds)
    if on_card:
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    b = cell.traffic["batch"]
    e2e = e2e_metrics(batches, start, seconds, b, setup_s)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"attempted": len(batches), "failed": sum(bt.error is not None for bt in batches)}
    breakdown = None
    if trace:
        ctx = trace_lib.Context(cell=cell, state=state, batches=batches, start=start,
                                seconds=seconds, seed=seed)
        stretch = ctx.stretch
        if stretch is not None:
            dev["busy_s"] = stretch["busy_s"]
            dev["window_s"] = stretch["window_s"]
            breakdown = {"device_ops": stretch["device_ops"], "idle_gaps": stretch["idle_gaps"]}
        values = {}
        for m in cell.per_layer:
            v = spec.load_reader(cell.root, m["name"])(ctx)
            if v is not None:
                values[m["name"]] = v
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in values}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    _free_program(state)
    found = check(state, batches)
    limits = cell.config["limits"]
    checks = {
        "failed_batches": {"value": result["failed"], "limit": 0},
        "pooled_max_abs_err": {"value": found["pooled_max_abs_err"],
                               "limit": limits["pooled_max_abs_err"]},
        "logit_max_abs_err": {"value": found["logit_max_abs_err"],
                              "limit": limits["logit_max_abs_err"]},
    }
    correct = found["compared_batches"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    released = [bt.release_s * 1e3 for bt in batches]
    waited = [bt.wait_s * 1e3 for bt in batches]
    out = {"correct": bool(correct), **result, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    out["info"] = {
        "cell": cell.name, "seed": seed, "batch": b, "released": len(batches),
        "compared_batches": found["compared_batches"],
        "release_ms_median": statistics.median(released) if released else None,
        "wait_ms_median": statistics.median(waited) if waited else None,
        "setup_phases_s": state.setup_phases,
        "errors": sorted({bt.error for bt in batches if bt.error})[:3],
    }
    return out


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True, help="the cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics instead of the end-to-end ones")
    return p


def _num(v):
    return v if isinstance(v, int) or math.isfinite(v) else str(v)


def main(argv, *, root: Path, t0: float, device: str = "cuda") -> int:
    """The command: one run of one cell, its result as the last line of
    standard output, and each compared number beside its limit as the last
    lines of standard error.  Without the card the cell asks for it prints
    no result and returns 2; with JAX or the JAX package loaded, 3."""
    args = _parser().parse_args(argv)
    cell = spec.load_cell(root, args.workload)
    import torch

    marks = {"import_torch": time.perf_counter()}
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: cell {cell.name} needs {cell.chips} CUDA device(s), "
                  f"found {n}", file=sys.stderr)
            return 2
        marks["cuda_query"] = time.perf_counter()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device=device, t0=t0,
                   marks=marks)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    info = out.pop("info")
    out["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                     for k, c in out["checks"].items()}
    print(f"portbench: {json.dumps(info)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
