#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py      # needs one CUDA card

Phases (any failure raises and exits non-zero):

1. environment: Python/torch/CUDA versions and the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: every kernel of ``src/repro_torch/csrc`` with nvcc, in parallel;
3. main path: the port's serve entry point on full-width taobao (15 tables,
   3,142,468 rows, E=16) at batch 8192, 16,384 requests, K=8 plan cores,
   five times, with every launch counter set to 0 just before and read
   just after each run:
   A. the default EngineConfig with the paper's LIF fallback
      (``shard_rocks`` off): nine asymmetric L1 chunks through the fused
      ragged kernel, six symmetric GM-UB tables through the UB kernel;
   B. the symmetric planner priced under the ``ascend_910`` preset: GM,
      GM-UB and L1 tables through the GM, UB and L1 kernels;
   C. the serve CLI's own defaults (``shard_rocks`` on, ``degrade_after``
      left at the config's 3): a fully asymmetric plan (15 L1 chunks, no
      symmetric group) whose big regions, too large for shared memory, run
      through the fused kernel's device-memory gather;
   D. access reduction, as the JAX package's presets serve: ``zipf:1.2``
      traffic and pricing, ``access=full`` (batch dedup + the hot-row
      cache), ``tuning=sweep`` (the block-size sweep timed on the card),
      the ``a100`` cost-model preset (whose taobao plan has GM chunks to
      cache) and the CLI's ``shard_rocks``: the fused kernel's dedup,
      cache and sparse-gather modes in every served launch;
   E. path C's plan in the legacy dense stacked-slot layout
      (``layout=dense``): 15 whole-table chunks in (8, 2) slots, every slot
      padded to 1,141,737 rows (a 1.17 GB f32 buffer), through the dense
      kernel.
   Each checks the request accounting, finite logits, the launch counters,
   that its server has no plain fallback step, and the pooled output of its
   last served batch against the same engine built on the CPU (the kernels'
   plain versions; path D's twin packs the block sizes the card's sweep
   chose);
4. kernels: each kernel against its plain version on the card, in f32,
   bf16 and f16, at the shapes the main path gave it (plus every strategy
   code, padding steps, -1 and out-of-window ids for the fused kernel, and
   for its access modes a forced spill and forced one-hot and sparse
   gathers, which must agree bitwise), timed with CUDA events (``ms``) and
   by ``torch.profiler``'s device time of its own kernels (``device_ms``)
   beside its plain version and one PyTorch library call computing the
   same lookups (``F.embedding_bag``, a yardstick only, also in device
   time); the fused base kernel (K1, paths A and C and the mixed case) and
   the dense kernel (K8, path E) bitwise equal to their plain versions in
   every dtype, each call one kernel on the card (``kernels_ms``), with its
   vector or scalar path and its queries a thread, K1 with the CTAs an SM
   its vector kernel holds and also on path A with every region gathered
   (``stage_rows=0``), and both at each count of queries a thread
   (``queries_sweep``: the wrapper's pick within 10% of the best); the L1
   kernel (K4) with its mode, cluster size, rows per CTA,
   grid and CTA width, on path B's tables (table 2 must be served by a
   thread-block cluster), on one query of table 2 (the staging alone), at
   every cluster size that schedules and beyond, and on table 2 at each
   cluster size whose slice fits one CTA and on path B's smallest table
   resident, at 256 and 1024 threads a CTA (the pick); the GM kernel (K3)
   also with s=3, -1 padding and invalid ids; the dense kernel also on a
   small single-core stack with s=3, a batch tail, the zero row, an empty
   slot and ids outside [0, R]; the UB
   kernel bitwise for s=1, on a batch of one repeated row and on a batch of
   one id (the table sweep alone), each timed over the uniform batch, and
   with s=3, invalid ids and -1 padding; the dedup kernel array-equal to
   its plain op on path D's ids and on edge cases (all padding, one id,
   cap 1, a cap above the distinct count, s=3, slots wider than its bitmap
   window); the unique-row gather array-equal to its plain version in f32,
   bf16 and f16 at path D's cap and at the spill cap of 64; the access
   calls in f32 bitwise equal to their plain versions (s = 1); path D's
   served call profiled for its launches (no sort, scan or scatter kernel
   may run in it) and its device time by kernel; its vector scatter at
   each count of queries a thread (``scatter_queries``); and
   ``access_by_block_r``: path D's plan repacked on the card at each block
   size the sweep tries, the served call's device time by kernel and its
   launches beside ``F.embedding_bag``'s, each output bitwise equal to its
   plain version.  Path D's record carries the sweep's ``device_us`` for
   every candidate, and its pick must be the least.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the JSON record of every kernel.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# f32 sums in another order; bf16/f16 rows convert exactly to f32
TOL = dict(rtol=1e-5, atol=1e-5)
# logits pass three MLP layers whose reductions also change order
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published
CLI_ARGS = ["--workload", "taobao", "--batch", "8192", "--queries", "16384",
            "--distribution", "uniform", "--set", "mesh_shape=[1,8]"]
MAIN_ARGS = CLI_ARGS + ["--set", "degrade_after=0"]
ZIPF = "zipf:1.2"
PATHS = {
    "A": MAIN_ARGS + ["--set", 'planner_options={"shard_rocks": false}'],
    "B": MAIN_ARGS + ["--set", "planner=symmetric", "--set", "hardware=ascend_910"],
    "C": CLI_ARGS,
    "D": ["--workload", "taobao", "--batch", "8192", "--queries", "16384",
          "--distribution", ZIPF, "--set", "mesh_shape=[1,8]", "--set", f"distribution={ZIPF}",
          "--set", "access=full", "--set", "tuning=sweep", "--set", "hardware=a100"],
    "E": CLI_ARGS + ["--set", "layout=dense"],
}
ACCESS_SRC = "src/repro_torch/csrc/embedding_access.cu"
KERNELS = {
    # name: (wrapper module, wrapper, launch mode counted (None = every
    # launch), source, the Pallas kernel it replaces)
    "multi_embedding_bag_ragged": (
        "embedding_multi", "multi_embedding_bag_ragged", "base",
        "src/repro_torch/csrc/embedding_multi.cu", "src/repro/kernels/embedding_multi.py:139"),
    "embedding_bag_ub": ("embedding_ub", "embedding_bag_ub", None,
                         "src/repro_torch/csrc/embedding_ub.cu",
                         "src/repro/kernels/embedding_ub.py:34"),
    "embedding_bag_gm": ("embedding_gm", "embedding_bag_gm", None,
                         "src/repro_torch/csrc/embedding_gm.cu",
                         "src/repro/kernels/embedding_gm.py:27"),
    "embedding_bag_l1": ("embedding_l1", "embedding_bag_l1", None,
                         "src/repro_torch/csrc/embedding_l1.cu",
                         "src/repro/kernels/embedding_l1.py:25"),
    "multi_embedding_bag_ragged[dedup]": (
        "embedding_multi", "multi_embedding_bag_ragged", "dedup", ACCESS_SRC,
        "src/repro/kernels/embedding_multi.py:190"),
    "multi_embedding_bag_ragged[cache]": (
        "embedding_multi", "multi_embedding_bag_ragged", "cache", ACCESS_SRC,
        "src/repro/kernels/embedding_multi.py:244"),
    "multi_embedding_bag_ragged[sparse]": (
        "embedding_multi", "multi_embedding_bag_ragged", "sparse", ACCESS_SRC,
        "src/repro/kernels/embedding_multi.py:205"),
    "multi_embedding_bag_dense": (
        "embedding_multi", "multi_embedding_bag_dense", None,
        "src/repro_torch/csrc/embedding_dense.cu", "src/repro/kernels/embedding_multi.py:506"),
    "batch_dedup": ("embedding_multi", "batch_dedup", None,
                    "src/repro_torch/csrc/embedding_dedup.cu",
                    "src/repro/kernels/embedding_multi.py:281"),
}


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def wrappers():
    import importlib

    return {
        name: getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), fn)
        for name, (mod, fn, _, _, _) in KERNELS.items()
    }


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        for counts in (getattr(fn, "modes", {}), getattr(fn, "paths", {})):
            for key in counts:
                counts[key] = 0


def read_counts() -> dict:
    return {name: fn.modes[KERNELS[name][2]] if KERNELS[name][2] else fn.launches
            for name, fn in wrappers().items()}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_calls(fn, calls: int = 10, sessions: int = 3) -> dict:
    """The card's own time for ``fn``: ``torch.profiler`` device time of the
    CUDA kernels (and copies) it launches, per call, summed over them, the
    number of such launches per call, and the time of each by name.  A
    profiler session that records no device event is run again, up to
    ``sessions`` in all."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
                  and e.self_device_time_total > 0]
        if events:
            break
    kernels = {e.key: e.self_device_time_total / calls / 1e3 for e in events}
    return {"device_ms": sum(kernels.values()) if kernels else "not measured",
            "launches_per_call": sum(e.count for e in events) / calls,
            "kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1]))}


def device_times(kernel, library=None) -> dict:
    """``device_ms`` and ``kernels_per_call`` of a kernel's wrapper call, and
    ``library_device_ms`` of its PyTorch yardstick."""
    prof = profile_calls(kernel)
    rec = {"device_ms": prof["device_ms"], "kernels_per_call": prof["launches_per_call"]}
    rec["library_device_ms"] = profile_calls(library)["device_ms"] if library else None
    return rec


def host_ms(fn, iters: int = 5) -> float:
    """Median host-clock time of ``fn`` (which ends in a synchronize)."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time on the card: bytes over HBM rate vs f32 adds over peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def environment() -> str:
    import torch

    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    return line


def build_kernels() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build()
    print(f"[build] {len(report)} kernels built in {time.perf_counter() - t0:.1f}s "
          f"into {build.build_dir()}")
    for name, rec in report.items():
        usage = [ln.split("ptxas info    : ")[-1] for ln in rec["ptxas"].splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"[build] {name} {rec['seconds']:.1f}s | " + " | ".join(usage))


def main_path(label: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.engine import InferenceEngine
    from repro_torch.launch import serve
    from repro_torch.models.dlrm import forward_packed

    print(f"[main {label}] python -m repro_torch.launch.serve {' '.join(PATHS[label])}")
    args = serve.build_parser().parse_args(PATHS[label])
    reset_counts()
    t0 = time.perf_counter()
    res = serve.main(PATHS[label])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    l1_modes = dict(wrappers()["embedding_bag_l1"].modes)
    access_paths = dict(wrappers()["multi_embedding_bag_ragged"].paths)
    dense_paths = dict(wrappers()["multi_embedding_bag_dense"].paths)
    engine, last = res["engine"], res["last"]
    s = res["stats"][args.distribution]
    check(s["submitted"] == s["served"] == args.queries,
          f"[main {label}] submitted {s['submitted']} served {s['served']}")
    check(s["batch_failures"] == 0 and s["degraded_batches"] == 0,
          f"[main {label}] failures {s['batch_failures']} degraded {s['degraded_batches']}")
    check(res["server"].fallback_step_fn is None,
          f"[main {label}] the server on the card has a plain fallback step")
    logits = last["logits"]
    check(logits.shape == (args.batch,) and np.isfinite(logits).all(),
          f"[main {label}] bad logits")

    # the same engine on the CPU (plain versions) on the last served batch;
    # a swept engine's twin packs the block sizes the card's sweep chose
    idx = last["indices"]
    cpu_config = engine.config
    tuning = engine.plan.meta.get("tuning")
    if engine.config.tuning == "sweep":
        check(tuning and tuning["backend"] == "cuda" and tuning["compiled"],
              f"[main {label}] the block-size sweep did not time the card: {tuning}")
        best = tuning["best"]
        cpu_config = dataclasses.replace(engine.config, tuning="fixed", tuning_options={
            "block_r": best["block_r"], **({"block_b": best["block_b"]} if best["block_b"] else {})})
    cpu_engine = InferenceEngine.build(res["params"]["tables"], engine.workload,
                                       cpu_config, device="cpu")
    check(cpu_engine.packed.block_r == engine.packed.block_r
          and cpu_engine.packed.unique_cap == engine.packed.unique_cap
          and cpu_engine.packed.cache_rows == engine.packed.cache_rows
          and cpu_engine.packed.kernel_path == engine.packed.kernel_path,
          f"[main {label}] the CPU twin packed another schedule")
    got = engine.lookup(idx).cpu()
    want = cpu_engine.lookup(idx)
    pooled_err = float((got - want).abs().max())
    check(torch.allclose(got, want, **TOL), f"[main {label}] pooled max err {pooled_err}")
    cpu_params = {"tables": res["params"]["tables"],
                  "bottom": copy.deepcopy(res["params"]["bottom"]).cpu(),
                  "top": copy.deepcopy(res["params"]["top"]).cpu()}
    cpu_logits = forward_packed(res["cfg"], cpu_engine.bag, cpu_engine.packed, cpu_params,
                                {"dense": torch.from_numpy(last["dense"]), "indices": idx})
    logit_err = float(np.abs(cpu_logits.numpy() - logits).max())
    check(np.allclose(logits, cpu_logits.numpy(), **LOGIT_TOL),
          f"[main {label}] logits max err {logit_err}")
    # one served batch's step alone: host clock around work ending in a
    # synchronize, and the device time the profiler attributes to it
    dense = torch.from_numpy(last["dense"]).to(engine.device)

    def forward():
        forward_packed(res["cfg"], engine.bag, engine.packed, res["params"],
                       {"dense": dense, "indices": idx})
        torch.cuda.synchronize()

    forward_ms = host_ms(forward)
    lookup_ms = host_ms(lambda: (engine.lookup(idx), torch.cuda.synchronize()))
    # kernel events only (as the profiler's own "Self CUDA time total")
    device_ms = profile_calls(forward, calls=1)["device_ms"]
    batches = args.queries // args.batch
    layout = engine.bag.layout_summary()
    rec = {
        "main_path": label, "served": s["served"], "batches": batches,
        "layout": {k: layout[k] for k in ("kind", "chunk_bytes", "dense_bytes",
                                          "bytes_vs_dense")},
        "wall_s": wall, "serve_wall_per_batch_ms": res["serve_wall_s"] / batches * 1e3,
        "p50_us": s["p50_us"], "p99_us": s["p99_us"],
        "forward_ms": forward_ms, "lookup_ms": lookup_ms,
        "forward_device_ms": device_ms,
        "plan": {"chunks": len(engine.plan.assignments),
                 "chunk_strategies": sorted(
                     {a.strategy.name for a in engine.plan.assignments}),
                 "symmetric": [[t, st.name] for t, st in zip(
                     engine.plan.symmetric_tables, engine.plan.symmetric_strategies)]},
        "launches": counts, "l1_modes": l1_modes, "access_paths": access_paths,
        "dense_paths": dense_paths,
        "pooled_max_err": pooled_err, "logit_max_err": logit_err,
    }
    if engine.packed.unique_cap or engine.packed.cache_rows:
        rec["access"] = access_summary(engine, idx)
        rec["tuning"] = {k: tuning[k] for k in ("best", "backend", "compiled", "iters")}
        rec["tuning"]["candidates"] = [
            {k: c[k] for k in ("block_r", "n_steps", "padding_frac", "wall_us", "device_us")}
            for c in tuning["candidates"]]
        times = [c["device_us"] for c in tuning["candidates"]]
        check(all(isinstance(t, float) and t > 0 for t in times),
              f"[main {label}] a sweep candidate has no device time: {times}")
        check(tuning["best"]["device_us"] == min(times),
              f"[main {label}] the sweep's pick is not its least device time: {tuning['best']}")
        rec["cache"] = engine.plan.meta["cache"]
        rec["kernel"] = engine.plan.meta["kernel"]["packed"]
    print(json.dumps(rec))
    return {"engine": engine, "indices": idx, "counts": counts, "l1_modes": l1_modes}


def access_summary(engine, idx) -> dict:
    """What the access reduction saw on one served batch: lookups, cache
    hits, distinct rows left for the gather, spilled lookups."""
    import torch

    from repro_torch.kernels.embedding_multi import dedup_indices

    lidx, hidx, _ = _access_ids(engine, idx)
    valid = int((lidx >= 0).sum()) + int((hidx >= 0).sum() if hidx is not None else 0)
    hits = int((hidx >= 0).sum()) if hidx is not None else 0
    out = {"lookups": valid, "cache_hits": hits, "cache_hit_share": hits / max(valid, 1),
           "unique_cap": engine.packed.unique_cap, "cache_rows": engine.packed.cache_rows}
    if engine.packed.unique_cap:
        uniq, _, spill = dedup_indices(lidx, engine.packed.unique_cap)
        out["unique_rows"] = int((uniq >= 0).sum())
        out["spilled_lookups"] = int((spill >= 0).sum())
        out["max_unique_per_slot"] = int((uniq >= 0).sum(dim=-1).max())
    torch.cuda.synchronize()
    return out


def _pick(engine, strategy: str, largest: bool = True) -> int:
    """The largest (or smallest) symmetric table the plan gave ``strategy``."""
    plan = engine.plan
    cands = [t for t, st in zip(plan.symmetric_tables, plan.symmetric_strategies)
             if strategy in ("any", st.name)]
    check(cands, f"the plan has no symmetric {strategy} table")
    rows = {t: engine.workload.tables[t].rows for t in cands}
    return (max if largest else min)(cands, key=lambda t: (rows[t], t))


def _sym_case(engine, idx, table):
    """A symmetric table's kernel inputs on the main path: its own rows plus
    the zero row, and the redirected (B, s) ids."""
    import torch

    packed = engine.packed
    i = packed.host["sym_table"].tolist().index(table)
    rows = int(packed.host["sym_rows"][i])
    ids = torch.as_tensor(idx[table], device=packed.device).long()
    lidx = torch.where((ids >= 0) & (ids < rows), ids, rows).to(torch.int32)
    return packed.sym_data[i, : rows + 1], lidx


def _bag_record(name, fn, table, lidx, dtype, *, bitwise=False, **kw):
    """A strategy kernel on one table (its rows plus the zero row) against
    ``bag_f32``, bitwise where ``bitwise`` (a row copy, s = 1), else within
    TOL; timed beside it and beside ``F.embedding_bag`` (ids outside the
    table go to the zero row for the library call)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ref import bag_f32

    t = table.to(dtype).contiguous()
    got = fn(t, lidx, **kw)
    torch.cuda.synchronize()
    want = bag_f32(t, lidx)
    err = float((got - want).abs().max())
    if bitwise:
        check(torch.equal(got, want), f"[kernel] {name} {dtype}: not bitwise equal, max err {err}")
    check(torch.allclose(got, want, **TOL), f"[kernel] {name} {dtype}: max err {err}")
    zero_row = t.shape[0] - 1
    ids = torch.where((lidx >= 0) & (lidx < t.shape[0]), lidx, zero_row).long()

    def kernel():
        return fn(t, lidx, **kw)

    def library():
        return F.embedding_bag(ids, t, mode="sum")

    rec = {
        "name": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": {"m": t.shape[0] - 1, "E": t.shape[1], "B": lidx.shape[0], "s": lidx.shape[1]},
        "max_err": err,
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: bag_f32(t, lidx)),
        "library_ms": time_ms(library),
        **device_times(kernel, library),
    }
    uniq = int(torch.unique(ids[ids < zero_row]).numel())
    b, s = lidx.shape
    e = t.shape[1]
    rec["bound_ms"], rec["bound_by"] = bound(
        uniq * e * t.element_size() + b * s * 4 + b * e * 4, b * s * e)
    return rec


def _dense_inputs(engine, idx):
    """Path E's dense kernel inputs: the (K, S, R+1, E) stack and the
    pre-clipped (K, S, B, s) ids."""
    import torch

    from repro_torch.core.partition import _dense_ids

    packed = engine.packed
    ids = _dense_ids(packed, torch.as_tensor(idx, device=packed.device))
    return packed.chunk_data, ids.to(torch.int32)


def _ragged_inputs(engine, idx):
    import torch

    from repro_torch.core.partition import _slot_indices

    packed = engine.packed
    local, valid = _slot_indices(packed, torch.as_tensor(idx, device=packed.device))
    lidx = torch.where(valid, local, -1).to(torch.int32)
    return packed.chunk_data, lidx, packed.step_block, packed.step_runs, packed.block_r


def _one_kernel(name: str, rec: dict) -> None:
    """K1's and K8's calls are one kernel each on the card (no fill, no copy):
    ``kernels_ms`` names one kernel and the call launches at most one (the
    profiler may drop a record, never add one)."""
    check(len(rec["kernels_ms"]) == 1 and rec["kernels_per_call"] <= 1,
          f"[kernel] {name}: not one kernel a call: {rec['kernels_ms']}")


def _ragged_ctas_per_sm(dtype, queries: int, smem_bytes: int):
    """CTAs of the base kernel's vector path an SM holds at ``queries`` a
    thread and ``smem_bytes`` of staging (the card's occupancy calculator)."""
    import ctypes

    from repro_torch.kernels import build

    fn = build.c_function("embedding_multi", "rt_ragged_ctas_per_sm",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    n = ctypes.c_int(0)
    build.check_launch(fn(queries, smem_bytes, build.dtype_code(dtype), ctypes.byref(n)),
                       "rt_ragged_ctas_per_sm")
    return n.value


def _ragged_record(buffer_full, lidx, step_block, runs, block_r, dtype, *, stage_rows=None):
    """K1 at a main path's shapes against its plain version, bitwise, timed
    beside it and beside one ``F.embedding_bag`` over the same lookups;
    ``stage_rows`` defaults to the pack's (:func:`ragged_stage_rows`), 0
    gathers every region."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_multi import (
        _queries,
        multi_embedding_bag_ragged,
        multi_embedding_bag_ragged_plain,
        ragged_stage_rows,
    )

    full = buffer_full.to(dtype)
    buf = full[:, :-1]
    k, t1, e = full.shape
    zero_row = t1 - 1
    run_list = runs.tolist()
    if stage_rows is None:
        stage_rows = ragged_stage_rows(run_list, block_r, e * full.element_size())

    def kernel():
        return multi_embedding_bag_ragged(buf, lidx, step_block, runs, block_r=block_r,
                                          stage_rows=stage_rows)

    paths = dict(multi_embedding_bag_ragged.paths)
    got = kernel()
    torch.cuda.synchronize()
    path = next(p for p in paths if multi_embedding_bag_ragged.paths[p] > paths[p])
    want = multi_embedding_bag_ragged_plain(buf, lidx, step_block, runs, block_r=block_r)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"[kernel] ragged {dtype}: not bitwise equal, max err {err}")
    # library yardstick: one embedding_bag over global buffer rows
    s_slots, b, s = lidx.shape[1:]
    flat, gl = _global_rows(full, lidx, step_block, run_list, block_r)

    def library():
        return F.embedding_bag(gl, flat, mode="sum")

    lib = library().view(k, s_slots, b, e)
    lib_err = float((lib.float() - want).abs().max())
    queries = _queries(None, path == "base_vector", b, e, full.element_size(), k * s_slots,
                       full.device)
    rec = {
        "name": "multi_embedding_bag_ragged", "dtype": str(dtype).replace("torch.", ""),
        "shape": {"K": k, "T": t1 - 1, "E": e, "S": s_slots, "B": b, "s": s,
                  "block_r": block_r, "runs": len(run_list), "stage_rows": stage_rows,
                  "codes": sorted({r[4] for r in run_list})},
        "path": path, "queries": queries,
        "ctas_per_sm": _ragged_ctas_per_sm(dtype, queries, stage_rows * e * full.element_size()),
        "max_err": err, "library_max_err": lib_err,
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: multi_embedding_bag_ragged_plain(
            buf, lidx, step_block, runs, block_r=block_r)),
        "library_ms": time_ms(library),
        **device_times(kernel, library),
        "kernels_ms": profile_calls(kernel)["kernels_ms"],
    }
    _one_kernel("ragged", rec)
    real = gl.view(k, s_slots, b, s)[[r[0] for r in run_list], [r[1] for r in run_list]]
    uniq = int(torch.unique(real[real % t1 != zero_row]).numel())
    n_runs = len(run_list)
    row_bytes = uniq * e * full.element_size()
    # the whole (K, S, B, E) output the call returns, the runs' ids, the rows
    # they hit; bound_runs_ms counts the runs' outputs only (the older figure)
    rec["bound_ms"], rec["bound_by"] = bound(
        row_bytes + n_runs * b * s * 4 + k * s_slots * b * e * 4, n_runs * b * s * e)
    rec["bound_runs_ms"] = bound(row_bytes + n_runs * b * s * 4 + n_runs * b * e * 4,
                                 n_runs * b * s * e)[0]
    return rec


def ragged_queries_sweep(buffer_full, lidx, step_block, runs, block_r) -> list:
    """K1 on path A (f32, the pack's staging) at each count of queries a
    thread (:func:`queries_sweep`)."""
    from repro_torch.kernels.embedding_multi import _launch, ragged_stage_rows

    buf = buffer_full[:, :-1]
    k, _, e = buf.shape
    stage_rows = ragged_stage_rows(runs.tolist(), block_r, e * buf.element_size())

    def call(q):
        return _launch(buf, lidx, step_block, runs, block_r, stage_rows, queries=q)

    return queries_sweep("ragged", call, call(None), lidx.shape[2], e, buf.element_size(),
                         k * lidx.shape[1])


def queries_sweep(name: str, call, want, b: int, e: int, itemsize: int, n_slots: int) -> list:
    """K1 or K8 (f32, the main path's shapes) at each count of queries a
    thread: each output bitwise equal to the wrapper's, the device time of
    its one kernel; fails unless the wrapper's pick is within 10% of the
    best."""
    import torch

    from repro_torch.kernels.embedding_multi import SCATTER_QUERIES, _queries

    pick = _queries(None, True, b, e, itemsize, n_slots, want.device)
    per_pass = 256 // (e * itemsize // 16)
    out = []
    for q in SCATTER_QUERIES:
        got = call(q)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"[kernel] {name} with {q} queries a thread differs")
        out.append({"queries": q, "picked": q == pick, "ctas": -(-b // (per_pass * q)) * n_slots,
                    "device_ms": profile_calls(lambda q=q: call(q))["device_ms"]})
    times = [r["device_ms"] for r in out]
    if all(isinstance(t, float) for t in times):
        best = min(times)
        picked = next(r["device_ms"] for r in out if r["picked"])
        check(picked <= 1.1 * best, f"[kernel] {name}: the pick ({pick} queries a thread) "
              f"is more than 10% above the best: {out}")
    return out


def _global_rows(full, lidx, step_block, run_list, block_r):
    """The fused kernel's lookups as rows of the flattened ``(K * (T+1), E)``
    buffer (invalid ones on a zero row): ``(flat, (K*S*B, s) rows)``."""
    import torch

    k, t1, e = full.shape
    zero_row = t1 - 1
    s_slots, b, s = lidx.shape[1:]
    gl = torch.full((k, s_slots, b, s), zero_row, dtype=torch.long, device=full.device)
    blocks = step_block.long()
    for core, slot, first, n, _ in run_list:
        ids = lidx[core, slot].long()
        ok = (ids >= 0) & (ids < n * block_r)
        loc = torch.where(ok, ids, 0)
        rows = blocks[core, first + loc // block_r] * block_r + loc % block_r
        gl[core, slot] = torch.where(ok, rows, zero_row)
    gl = (gl + torch.arange(k, device=full.device).view(k, 1, 1, 1) * t1).reshape(-1, s)
    return full.reshape(k * t1, e), gl


def _access_ids(engine, idx):
    """Path D's kernel inputs: the ids after the hot/cold split, the cache
    positions, and the ids before the split (every lookup on the buffer)."""
    import torch

    from repro_torch.core.partition import _fused_ids, _slot_indices

    packed = engine.packed
    ids = torch.as_tensor(idx, device=packed.device)
    lidx, hidx = _fused_ids(packed, ids)
    local, valid = _slot_indices(packed, ids)
    return lidx, hidx, torch.where(valid, local, -1).to(torch.int32)


def _access_record(case, engine, idx, dtype, *, unique_cap, cache, kpath):
    """One access-mode launch at path D's shapes against its plain version,
    timed beside it and beside one ``F.embedding_bag`` over the same
    lookups.  ``kpath``: None (no selector), "served" (the pack's own
    per-step paths), "onehot" or "sparse" (every step forced)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_multi import (
        multi_embedding_bag_ragged,
        multi_embedding_bag_ragged_plain,
    )

    packed = engine.packed
    lidx, hidx, lidx_all = _access_ids(engine, idx)
    full = packed.chunk_data.to(dtype)
    buf = full[:, :-1]
    ids = lidx if cache else lidx_all
    plain_kw = dict(block_r=packed.block_r, unique_cap=unique_cap)
    if cache:
        plain_kw.update(cache=packed.cache_data.to(dtype), hidx=hidx)
    kw = dict(plain_kw, step_slot=packed.step_slot, step_base=packed.step_base)
    if kpath == "served":
        check(packed.kernel_path != "onehot", "path D's pack has no sparse step")
        kw["step_kpath"] = packed.step_kpath
    elif kpath is not None:
        kw["step_kpath"] = torch.full_like(packed.step_kpath, int(kpath == "sparse"))
    args = (buf, ids, packed.step_block, packed.step_runs)

    def kernel():
        return multi_embedding_bag_ragged(*args, **kw)

    got = kernel()
    torch.cuda.synchronize()
    want = multi_embedding_bag_ragged_plain(*args, **plain_kw)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **TOL), f"[kernel] {case} {dtype}: max err {err}")
    k, s_slots, b, s = lidx.shape
    if dtype == torch.float32 and s == 1:  # one term per element, added in the same order
        check(torch.equal(got, want), f"[kernel] {case} f32: not bitwise equal, max err {err}")
    run_list = packed.step_runs.tolist()
    e = full.shape[-1]
    flat, gl = _global_rows(full, lidx_all, packed.step_block, run_list, packed.block_r)

    def library():
        return F.embedding_bag(gl, flat, mode="sum")

    lib = library().view(k, s_slots, b, e)
    rec = {
        "name": case, "dtype": str(dtype).replace("torch.", ""),
        "shape": {"K": k, "S": s_slots, "B": b, "s": s, "E": e, "block_r": packed.block_r,
                  "runs": len(run_list), "unique_cap": unique_cap,
                  "cache_rows": packed.cache_rows if cache else 0, "kpath": kpath},
        "max_err": err, "library_max_err": float((lib.float() - want).abs().max()),
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: multi_embedding_bag_ragged_plain(*args, **plain_kw)),
        "library_ms": time_ms(library),
        **device_times(kernel, library),
    }
    real = gl.view(k, s_slots, b, s)
    n_valid = int((lidx_all >= 0).sum())
    hit_rows = int(torch.unique(real[lidx_all >= 0]).numel())
    id_bytes = ids.numel() * 4 + (hidx.numel() * 4 if cache else 0)
    rec["bound_ms"], rec["bound_by"] = bound(
        hit_rows * e * full.element_size() + id_bytes + k * s_slots * b * e * 4, n_valid * e)
    rec["distinct_rows"] = hit_rows
    return rec, got


def _dense_record(chunks_full, lidx, dtype):
    """The dense kernel against its plain version, bitwise (both sum each
    query's rows in position order from 0.0 in f32), timed beside it and
    beside one ``F.embedding_bag`` over the same lookups."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_multi import (
        _launch_dense,
        _queries,
        multi_embedding_bag_dense,
        multi_embedding_bag_dense_plain,
    )

    chunks = chunks_full.to(dtype)
    k, s_slots, rows, e = chunks.shape
    b, s = lidx.shape[2:]

    def kernel():
        return multi_embedding_bag_dense(chunks, lidx)

    paths = dict(multi_embedding_bag_dense.paths)
    got = kernel()
    torch.cuda.synchronize()
    path = next(p for p in paths if multi_embedding_bag_dense.paths[p] > paths[p])
    want = multi_embedding_bag_dense_plain(chunks, lidx)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"[kernel] dense {dtype}: not bitwise equal, max err {err}")
    # library yardstick: one embedding_bag over the flattened (K*S*(R+1), E) stack
    flat = chunks.reshape(k * s_slots * rows, e)
    offset = torch.arange(k * s_slots, device=lidx.device).view(k, s_slots, 1, 1) * rows
    gl = (lidx.long() + offset).reshape(-1, s)

    def library():
        return F.embedding_bag(gl, flat, mode="sum")

    lib = library().view(k, s_slots, b, e)
    rec = {
        "name": "multi_embedding_bag_dense", "dtype": str(dtype).replace("torch.", ""),
        "shape": {"K": k, "S": s_slots, "R+1": rows, "E": e, "B": b, "s": s},
        "path": path,
        "queries": _queries(None, path == "vector", b, e, chunks.element_size(), k * s_slots,
                            chunks.device),
        "max_err": err,
        "library_max_err": float((lib.float() - want).abs().max()),
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: multi_embedding_bag_dense_plain(chunks, lidx)),
        "library_ms": time_ms(library),
        **device_times(kernel, library),
        "kernels_ms": profile_calls(kernel)["kernels_ms"],
    }
    _one_kernel("dense", rec)
    if dtype == torch.float32:
        rec["queries_sweep"] = queries_sweep(
            "dense", lambda q: _launch_dense(chunks, lidx, queries=q), got, b, e,
            chunks.element_size(), k * s_slots)
    # what the data needs: the distinct rows hit (a slot's zero row R holds
    # nothing to read), the ids, the (K, S, B, E) f32 output
    uniq = int(torch.unique(gl[(gl % rows) != rows - 1]).numel())
    rec["bound_ms"], rec["bound_by"] = bound(
        uniq * e * chunks.element_size() + lidx.numel() * 4 + k * s_slots * b * e * 4,
        k * s_slots * b * s * e)
    rec["distinct_rows"] = uniq
    return rec


def dense_edge_case(dtype):
    """The dense kernel on a small single-core stack: s=3, a batch that is
    no multiple of any tile, ids at 0 and at the zero row, an all-zero-row
    (empty) slot, and ids outside [0, R], which the kernel gives zero and
    the plain version refuses."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_multi import (
        multi_embedding_bag_dense,
        multi_embedding_bag_dense_plain,
    )

    rng = np.random.default_rng(5)
    s_slots, rows, b, s = 3, 1001, 1037, 3
    chunks = torch.from_numpy(rng.standard_normal((s_slots, rows, 16)).astype(np.float32))
    chunks[:, -1] = 0
    chunks[2] = 0  # an empty slot
    lidx = rng.integers(0, rows, size=(s_slots, b, s)).astype(np.int32)
    lidx[:, ::7, 0] = 0
    lidx[:, ::5, 1] = rows - 1
    lidx[2] = rows - 1
    chunks, ids = chunks.to(dtype).to(DEVICE), torch.from_numpy(lidx).to(DEVICE)
    got = multi_embedding_bag_dense(chunks, ids)
    want = multi_embedding_bag_dense_plain(chunks[None], ids[None])[0]
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"[kernel] dense edge case {dtype}: not bitwise equal")
    check(not got[2].any(), "[kernel] dense edge case: the empty slot is not zero")
    bad = ids.clone()
    bad[:, :, 2] = torch.where(bad[:, :, 2] % 2 == 0, -5, rows + 3).to(torch.int32)
    masked = multi_embedding_bag_dense_plain(
        chunks[None], torch.where(bad < 0, rows - 1, bad).clamp(max=rows - 1)[None])[0]
    got_bad = multi_embedding_bag_dense(chunks, bad)
    torch.cuda.synchronize()
    check(torch.equal(got_bad, masked), f"[kernel] dense ids outside [0, R] {dtype}")
    return float((got - want).abs().max())


def mixed_ragged_case():
    """Every strategy code, multi-step slots, padding steps (core 0 has fewer
    steps), -1 and out-of-window ids, on taobao table sizes."""
    import numpy as np
    import torch

    from repro_torch.core.partition import pack_plan
    from repro_torch.core.strategies import ChunkAssignment, Plan, Strategy
    from repro_torch.data.workloads import get_workload

    wl = get_workload("taobao", 4096)
    chunks = [(2, 0, Strategy.GM), (7, 0, Strategy.L1),
              (5, 1, Strategy.GM_UB), (14, 1, Strategy.L1_UB), (8, 1, Strategy.L1),
              (3, 1, Strategy.L1)]
    plan = Plan(workload_name="mixed", n_cores=2,
                assignments=tuple(ChunkAssignment(t, c, 0, wl.tables[t].rows, st)
                                  for t, c, st in chunks),
                symmetric_tables=(), symmetric_strategies=())
    gen = torch.Generator().manual_seed(3)
    used = {t for t, _, _ in chunks}
    tables = [torch.randn((t.rows, t.dim), generator=gen) if i in used else None
              for i, t in enumerate(wl.tables)]
    packed = pack_plan(plan, wl.tables, tables, device=DEVICE)
    runs = packed.step_runs.cpu().numpy()
    check(sorted({int(c) for c in runs[:, 4]}) == [0, 1, 2, 3], "mixed case lacks a code")
    check(int(packed.step_slot.max()) == packed.slot_table.shape[1], "no padding steps")
    rng = np.random.default_rng(4)
    k, s_slots = packed.slot_table.shape
    lidx = np.full((k, s_slots, 4096, 2), -1, np.int32)
    for core, slot, _first, n, _code in runs.tolist():
        lidx[core, slot] = rng.integers(-3, n * packed.block_r + 9, size=(4096, 2))
    return (packed.chunk_data, torch.from_numpy(lidx).to(DEVICE), packed.step_block,
            packed.step_runs, packed.block_r)


def access_phase(path_d: dict, recs: dict) -> None:
    """K5-K7 at path D's shapes in f32, bf16 and f16: as served, with the
    gather forced one-hot and sparse (bitwise equal), with a forced spill
    (a 64-wide unique cap), and the cache alone."""
    import torch

    from repro_torch.kernels.embedding_multi import dedup_indices

    engine, idx = path_d["engine"], path_d["indices"]
    cap = engine.packed.unique_cap
    check(cap > 0 and engine.packed.cache_rows > 0, "path D packed no dedup or no cache")
    spill_cap = 64
    lidx, _, _ = _access_ids(engine, idx)
    check(int((dedup_indices(lidx, spill_cap)[2] >= 0).sum()) > 0, "the spill case spills nothing")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        rec, _ = _access_record("served (dedup + cache, planned paths)", engine, idx, dtype,
                                unique_cap=cap, cache=True, kpath="served")
        recs["multi_embedding_bag_ragged[dedup]"].append(rec)
        outs = {}
        for name, case_cap in (("", cap), (" spill", spill_cap)):
            for kpath in ("onehot", "sparse"):
                rec, outs[name, kpath] = _access_record(
                    f"forced {kpath}{name} (dedup + cache)", engine, idx, dtype,
                    unique_cap=case_cap, cache=True, kpath=kpath)
                key = "sparse" if kpath == "sparse" else "dedup"
                recs[f"multi_embedding_bag_ragged[{key}]"].append(rec)
            check(torch.equal(outs[name, "onehot"], outs[name, "sparse"]),
                  f"[kernel] one-hot and sparse gathers differ{name} ({dtype})")
        rec, _ = _access_record("cache alone", engine, idx, dtype, unique_cap=0, cache=True,
                                kpath=None)
        recs["multi_embedding_bag_ragged[cache]"].append(rec)
        for case_cap in (cap, spill_cap):
            recs["multi_embedding_bag_ragged[dedup]"].append(
                _gather_record(engine, lidx, case_cap, dtype))
    recs["batch_dedup"].append(_dedup_record("path D as served", lidx, cap))
    for case, (ids, case_cap) in dedup_edge_cases().items():
        recs["batch_dedup"].append(_dedup_record(case, ids, case_cap))
    breakdown = access_breakdown(engine, idx)
    breakdown["scatter_queries"] = scatter_sweep(engine, idx)
    print(json.dumps({"breakdown": breakdown}))
    print(json.dumps({"access_by_block_r": access_by_block_r(engine, idx)}))


def _gather_record(engine, lidx, cap, dtype):
    """The unique-row gather alone on path D's unique ids at ``cap``: array-
    equal to ``gather_unique_rows_plain``, timed beside it; its bound is
    ``rows_u`` written once, the unique ids and the distinct rows read once."""
    import torch

    from repro_torch.kernels.embedding_multi import (
        batch_dedup,
        gather_unique_rows,
        gather_unique_rows_plain,
    )

    packed = engine.packed
    buf = packed.chunk_data.to(dtype)[:, :-1]
    uniq = batch_dedup(lidx, cap)[0]
    args = (buf, uniq, packed.step_block, packed.step_runs)

    def kernel():
        return gather_unique_rows(*args, block_r=packed.block_r)

    paths = dict(gather_unique_rows.paths)
    got = kernel()
    want = gather_unique_rows_plain(*args, block_r=packed.block_r)
    torch.cuda.synchronize()
    path = next(p for p in paths if gather_unique_rows.paths[p] > paths[p])
    check(torch.equal(got, want),
          f"[kernel] gather {dtype} cap {cap}: not array-equal to gather_unique_rows_plain")
    k, s_slots, u = uniq.shape
    e = buf.shape[-1]
    rows = int((got.abs().sum(dim=-1) > 0).sum())  # entries with a row (nonzero)
    rec = {
        "name": "gather_unique_rows", "case": f"the gather alone, cap {cap}",
        "dtype": str(dtype).replace("torch.", ""), "path": path,
        "shape": {"K": k, "S": s_slots, "U": u, "E": e, "block_r": packed.block_r},
        "max_err": 0.0, "rows_copied": rows,
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: gather_unique_rows_plain(*args, block_r=packed.block_r)),
        "library_ms": None, **device_times(kernel),
    }
    rec["bound_ms"], rec["bound_by"] = bound(
        got.numel() * 4 + uniq.numel() * 4 + rows * e * buf.element_size(), 0)
    return rec


def _dedup_record(case, lidx, cap):
    """The dedup kernel against ``dedup_indices`` (array-equal uniq, rank
    and spill), timed beside it; no PyTorch call computes this function."""
    import torch

    from repro_torch.kernels.embedding_multi import DEDUP_WINDOW_BITS, batch_dedup, dedup_indices

    def kernel():
        return batch_dedup(lidx, cap)

    got = kernel()
    want = dedup_indices(lidx, cap)
    torch.cuda.synchronize()
    for name, a, b in zip(("uniq", "rank", "spill"), got, want):
        check(torch.equal(a, b), f"[kernel] batch_dedup {case}: {name} differs from dedup_indices")
    *lead, b, s = lidx.shape
    rows = lidx.numel() // max(b * s, 1)
    rec = {
        "name": "batch_dedup", "case": case, "dtype": "int32",
        "shape": {"slots": rows, "B": b, "s": s, "unique_cap": cap,
                  "window_bits": DEDUP_WINDOW_BITS},
        "max_err": 0.0, "distinct_max": int((got[0] >= 0).sum(dim=-1).max()) if rows else 0,
        "spilled": int((got[2] >= 0).sum()),
        "ms": time_ms(kernel), "plain_ms": time_ms(lambda: dedup_indices(lidx, cap)),
        "library_ms": None, **device_times(kernel),
    }
    # ids read once, rank and spill and uniq written once; a few integer
    # operations per id
    rec["bound_ms"], rec["bound_by"] = bound(3 * lidx.numel() * 4 + rows * cap * 4, lidx.numel())
    return rec


def dedup_edge_cases() -> dict:
    """The dedup kernel's edge cases: all padding, one id, a cap of 1, a
    cap above the distinct count, s = 3, and slots wider than one bitmap
    window (ids up to 2^31 - 2 with empty stretches between, and the plain
    op's padding key 2^31 - 1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(9)
    wide = rng.integers(0, 3_000_000, size=(4, 8192, 1))
    wide[:, ::5] = rng.integers(2**31 - 5000, 2**31 - 1, size=wide[:, ::5].shape)
    wide[:, ::9] = 2**31 - 1
    cases = {
        "all padding": (np.full((8, 1024, 1), -1), 64),
        "one id": (np.full((8, 8192, 1), 1234), 64),
        "cap 1": (rng.integers(-1, 100_000, size=(8, 8192, 1)), 1),
        "cap above the distinct count": (rng.integers(-1, 500, size=(8, 8192, 1)), 1856),
        "s=3": (rng.integers(-3, 20_000, size=(8, 2048, 3)), 1856),
        "wider than the bitmap": (wide, 3000),
    }
    return {k: (torch.from_numpy(v.astype(np.int32)).to(DEVICE), cap)
            for k, (v, cap) in cases.items()}


def access_breakdown(engine, idx, calls: int = 10) -> dict:
    """Where path D's served launch spends its time (f32): the device time
    of each kernel per call and the launches per call (``torch.profiler``),
    the event time of the whole wrapper call, of the dedup kernel alone and
    of its plain torch op, and the host time to enqueue one call.  Fails if
    a sort, scan or scatter kernel (the plain op's) runs in the call."""
    import torch

    from repro_torch.kernels.embedding_multi import (
        batch_dedup,
        dedup_indices,
        multi_embedding_bag_ragged,
    )

    packed = engine.packed
    args, kw = _served_args(packed, idx)
    lidx = args[1]

    def served():
        return multi_embedding_bag_ragged(*args, **kw)

    prof = profile_calls(served, calls)
    plain_ops = [k for k in prof["kernels_ms"]
                 if any(w in k.lower() for w in ("sort", "scan", "scatter"))]
    check(not plain_ops, f"[access] the served call still runs the plain dedup op: {plain_ops}")
    by_pass = _by_pass(prof["kernels_ms"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        served()
    enqueue_ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return {
        "event_ms": time_ms(served),
        "dedup_kernel_event_ms": time_ms(lambda: batch_dedup(lidx, packed.unique_cap)),
        "plain_dedup_op_event_ms": time_ms(lambda: dedup_indices(lidx, packed.unique_cap)),
        "host_enqueue_ms": enqueue_ms,
        "launches_per_call": prof["launches_per_call"],
        "device_ms": prof["device_ms"],
        **{f"{name}_device_ms": ms for name, ms in by_pass.items()},
        **_pass_bounds(packed, lidx),
        "kernels_ms": prof["kernels_ms"],
    }


def _by_pass(kernels_ms: dict) -> dict:
    """Device ms of the served access call's three kernels by pass."""
    names = {"dedup": "dedup_kernel", "gather": "gather_kernel", "scatter": "access_"}
    return {name: sum(ms for k, ms in kernels_ms.items() if key in k)
            for name, key in names.items()}


def _pass_bounds(packed, lidx) -> dict:
    """The gather's and the scatter's bounds at path D's data (f32): the
    gather writes rows_u and reads the unique ids and the distinct rows; the
    scatter writes the (K, S, B, E) output and reads the rank, spill and cache
    position of every lookup and rows_u."""
    from repro_torch.kernels.embedding_multi import dedup_indices

    k, s_slots, b, s = lidx.shape
    e = packed.chunk_data.shape[-1]
    u = packed.unique_cap
    uniq = dedup_indices(lidx, u)[0]
    distinct = int((uniq >= 0).sum())
    rows_u = k * s_slots * u * e * 4
    gather = bound(rows_u + uniq.numel() * 4 + distinct * e * 4, 0)[0]
    scatter = bound(k * s_slots * b * e * 4 + 3 * lidx.numel() * 4 + rows_u, 0)[0]
    return {"gather_bound_ms": gather, "scatter_bound_ms": scatter}


def _served_args(packed, idx):
    """The served access call's arguments for a pack: (args, kwargs)."""
    import torch

    from repro_torch.core.partition import _fused_ids

    lidx, hidx = _fused_ids(packed, torch.as_tensor(idx, device=packed.device))
    kw = dict(block_r=packed.block_r, unique_cap=packed.unique_cap, cache=packed.cache_data,
              hidx=hidx, step_slot=packed.step_slot, step_base=packed.step_base,
              step_kpath=packed.step_kpath if packed.kernel_path != "onehot" else None)
    return (packed.chunk_data[:, :-1], lidx, packed.step_block, packed.step_runs), kw


def scatter_sweep(engine, idx) -> list:
    """The vector scatter of path D's served call at each count of queries a
    thread, f32 and bf16: device time of the scatter kernel (the dedup and
    gather kernels run too, unchanged), each output bitwise equal to the
    wrapper's own pick, which is marked."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_multi import (
        SCATTER_QUERIES,
        _launch_access,
        multi_embedding_bag_ragged,
        scatter_queries,
    )

    out = []
    args, kw = _served_args(engine.packed, idx)
    for dtype in (torch.float32, torch.bfloat16):
        buf = args[0].to(dtype)
        cache = kw["cache"].to(dtype)
        b, e = args[1].shape[2], buf.shape[-1]
        pick = scatter_queries(b, e, buf.element_size(), args[1].shape[0] * args[1].shape[1],
                               build.sm_count(buf.device))
        want = multi_embedding_bag_ragged(buf, *args[1:], **dict(kw, cache=cache))
        for q in SCATTER_QUERIES:
            def call(q=q):
                return _launch_access(buf, *args[1:], kw["block_r"], kw["unique_cap"], cache,
                                      kw["hidx"], kw["step_kpath"], kw["step_slot"],
                                      kw["step_base"], queries=q)

            got = call()
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"[access] scatter with {q} queries a thread differs")
            prof = profile_calls(call)
            out.append({"dtype": str(dtype).replace("torch.", ""), "queries": q,
                        "picked": q == pick,
                        "ctas": -(-b // (256 // (e * buf.element_size() // 16) * q))
                        * args[1].shape[0] * args[1].shape[1],
                        "scatter_device_ms": _by_pass(prof["kernels_ms"])["scatter"]})
    return out


def access_by_block_r(engine, idx) -> list:
    """Path D's served access call with its plan repacked on the card at each
    block size the sweep tries (f32): device time by kernel (dedup, gather,
    scatter) and launches a call, beside ``F.embedding_bag``'s device time
    over the same lookups; fails if a candidate's output is not bitwise equal
    to its plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.autotune import _BLOCK_R_CANDIDATES
    from repro_torch.core.partition import _slot_indices
    from repro_torch.kernels.embedding_multi import (
        multi_embedding_bag_ragged,
        multi_embedding_bag_ragged_plain,
    )

    meta = copy.deepcopy(engine.plan.meta)  # pack_plan rewrites plan.meta["layout"]
    ids = torch.as_tensor(idx, device=DEVICE)
    out = []
    for br in _BLOCK_R_CANDIDATES:
        packed = engine.bag.pack(engine.table_data, block_r=br, device=DEVICE)
        check((packed.unique_cap, packed.cache_rows, packed.kernel_path)
              == (engine.packed.unique_cap, engine.packed.cache_rows, engine.packed.kernel_path),
              f"[access] the repack at block_r={br} armed other access modes")
        args, kw = _served_args(packed, idx)

        def served(args=args, kw=kw):
            return multi_embedding_bag_ragged(*args, **kw)

        got = served()
        plain_kw = {k: kw[k] for k in ("block_r", "unique_cap", "cache", "hidx")}
        want = multi_embedding_bag_ragged_plain(*args, **plain_kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"[access] block_r={br}: not bitwise equal, max err {err}")
        prof = profile_calls(served)
        local, valid = _slot_indices(packed, ids)
        full = packed.chunk_data
        flat, gl = _global_rows(full, torch.where(valid, local, -1).to(torch.int32),
                                packed.step_block, packed.step_runs.tolist(), br)
        library = profile_calls(lambda: F.embedding_bag(gl, flat, mode="sum"))
        rec = {"block_r": br, "n_steps": int(packed.step_slot.shape[-1]),
               "runs": int(packed.step_runs.shape[0]), "max_err": err,
               "device_ms": prof["device_ms"], "launches_per_call": prof["launches_per_call"],
               **{f"{name}_device_ms": ms for name, ms in _by_pass(prof["kernels_ms"]).items()},
               "library_device_ms": library["device_ms"]}
        if isinstance(rec["device_ms"], float) and isinstance(rec["library_device_ms"], float):
            rec["to_library"] = rec["device_ms"] / rec["library_device_ms"]
        out.append(rec)
        del packed, args, kw
    engine.plan.meta.clear()
    engine.plan.meta.update(meta)
    return out


def ub_cases(table, ids, uniform: dict) -> list:
    """K2's extra cases at path A's shapes: a batch whose ids are all one row
    and a batch of one id (the sweep of the table alone), both bitwise and
    timed beside the uniform batch; and s = 3 with ids outside [0, m) and -1
    padding in every dtype (within TOL)."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_ub import embedding_bag_ub

    out = []
    for case, case_ids in (("one row (every id equal)", torch.full_like(ids, int(ids[0, 0]))),
                           ("one id (the table sweep alone)", ids[:1].contiguous())):
        rec = _bag_record("embedding_bag_ub", embedding_bag_ub, table, case_ids, torch.float32,
                          bitwise=True)
        rec["case"] = case
        rec["to_uniform_ms"] = rec["ms"] / uniform["ms"]
        if isinstance(rec["device_ms"], float) and isinstance(uniform["device_ms"], float):
            rec["to_uniform_device_ms"] = rec["device_ms"] / uniform["device_ms"]
        out.append(rec)
    m, b = table.shape[0], ids.shape[0]
    rng = np.random.default_rng(11)
    s3 = rng.integers(0, m, size=(b, 3))
    s3[rng.random(s3.shape) < 0.2] = -1
    s3[::7, 1] = m + 5
    s3[::11, 2] = -9
    s3 = torch.from_numpy(s3.astype(np.int32)).to(ids.device)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        rec = _bag_record("embedding_bag_ub", embedding_bag_ub, table, s3, dtype)
        rec["case"] = "s=3, ids outside [0, m) and -1 padding"
        out.append(rec)
    return out


def _l1_record(table, lidx, dtype, case=None):
    """K4 through its wrapper, bitwise at s = 1, with the mode, cluster
    size, rows per CTA, grid and CTA width its schedule gave."""
    from repro_torch.kernels.embedding_l1 import embedding_bag_l1, schedule_for

    rec = _bag_record("embedding_bag_l1", embedding_bag_l1, table, lidx, dtype,
                      bitwise=lidx.shape[1] == 1)
    sched = schedule_for(table.to(dtype).contiguous(), lidx)
    rec.update(mode=sched.mode, cluster=sched.cluster, rows_per_cta=sched.rows_per_cta,
               grid=sched.grid, threads=sched.threads)
    if case:
        rec["case"] = case
    return rec


def l1_mode_cases() -> list:
    """K4 at every cluster size ``l1_schedule`` picks and beyond: f32 tables
    of E = 16 (a zero last row) sized to the largest each size holds within
    the slice target (C x ``CLUSTER_BYTES``), ``ascend_910``'s largest L1
    table (1 MiB + the zero row: 16 CTAs past the target), and 200,000 rows
    (12.8 MB, beyond), at path B's batch shape (B = 8192, s = 1, uniform
    ids).  A size the card does not schedule (16 may not) is reported."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_l1 import CLUSTER_BYTES, CLUSTER_SIZES, schedule_for

    rng = np.random.default_rng(21)
    cases = [(c, c * (CLUSTER_BYTES // 64), f"cluster of {c}") for c in CLUSTER_SIZES]
    cases += [(16, 16_385, "cluster of 16 (ascend_910's largest L1 table)"),
              (0, 200_000, "beyond (12.8 MB, the UB kernel)")]
    out = []
    for c, m, case in cases:
        table = torch.from_numpy(rng.standard_normal((m, 16)).astype(np.float32))
        table[-1] = 0
        table = table.to(DEVICE)
        ids = torch.from_numpy(rng.integers(0, m - 1, size=(8192, 1)).astype(np.int32)).to(DEVICE)
        sched = schedule_for(table, ids)
        if c == 16 and sched.cluster != 16:
            out.append({"name": "embedding_bag_l1", "case": f"{case}: 16 not scheduled",
                        "rows": m, "mode": sched.mode, "cluster": sched.cluster})
            continue
        check((sched.mode, sched.cluster if c else 0) == ("cluster" if c else "beyond", c),
              f"[kernel] L1 at {m} rows: {sched}")
        out.append(_l1_record(table, ids, torch.float32, case))
    return out


def l1_sweep(table, lidx, small, small_ids) -> list:
    """K4 on path B's table 2 (f32) at every cluster size whose slice fits
    one CTA's shared memory, and on its smallest L1 table resident, each at
    256 and 1024 threads a CTA (one thread per item, as many CTAs or
    clusters as that needs, at most what the card holds): each held bitwise
    against ``bag_f32`` and timed; the wrapper's own pick is marked."""
    import torch

    from repro_torch.kernels.embedding_l1 import (
        CLUSTER_SIZES,
        CTA_MAX_BYTES,
        L1Schedule,
        card_clusters,
        cluster_schedule,
        ctas_per_sm,
        launch,
        schedule_for,
    )
    from repro_torch.kernels.ref import bag_f32

    out = []
    for tab, ids in ((table, lidx), (small, small_ids)):
        t = tab.float().contiguous()
        m, e = t.shape
        b = ids.shape[0]
        want = bag_f32(t, ids)
        pick = schedule_for(t, ids)
        active = card_clusters(t.device.index, 0)
        n_sms = torch.cuda.get_device_properties(t.device).multi_processor_count
        for threads in (256, 1024):
            if pick.mode == "resident":
                grid = max(1, min(-(-b * e * 4 // 16 // threads),
                                  n_sms * ctas_per_sm(m * e * 4, threads)))
                cands = [L1Schedule("resident", 1, m, grid, m * e * 4, threads)]
            else:
                cands = []
                for c in CLUSTER_SIZES:
                    smem = -(-m // c) * e * 4
                    n = active(c, smem, threads) if smem <= CTA_MAX_BYTES else 0
                    if n >= 1:
                        cands.append(cluster_schedule(m, e * 4, b, c, n, threads))
            for sched in cands:
                got = launch(t, ids, sched)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"[kernel] L1 {sched}: not bitwise")
                out.append({
                    "rows": m, "mode": sched.mode, "cluster": sched.cluster,
                    "threads": threads, "rows_per_cta": sched.rows_per_cta, "grid": sched.grid,
                    "smem": sched.smem, "picked": sched == pick,
                    "staged_bytes": sched.grid * sched.smem,
                    "ms": time_ms(lambda: launch(t, ids, sched)),
                    "device_ms": profile_calls(lambda: launch(t, ids, sched))["device_ms"]})
    print(json.dumps({"l1_sweep": out}))
    return out


def gm_pooled_case(table, ids) -> dict:
    """K3 on path B's table 0 with s = 3: uniform ids, 20% -1 padding, ids
    at and past m, within TOL of ``bag_f32`` (f32)."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_gm import embedding_bag_gm

    m, b = table.shape[0], ids.shape[0]
    rng = np.random.default_rng(22)
    s3 = rng.integers(0, m, size=(b, 3))
    s3[rng.random(s3.shape) < 0.2] = -1
    s3[::7, 1] = m + 5
    s3[::11, 2] = -9
    s3 = torch.from_numpy(s3.astype(np.int32)).to(ids.device)
    rec = _bag_record("embedding_bag_gm", embedding_bag_gm, table, s3, torch.float32)
    rec["case"] = "s=3, ids outside [0, m) and -1 padding"
    return rec


def kernel_phase(paths: dict, counts: dict) -> list:
    import torch

    from repro_torch.kernels.embedding_gm import embedding_bag_gm
    from repro_torch.kernels.embedding_ub import embedding_bag_ub

    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    recs: dict[str, list] = {name: [] for name in KERNELS}
    access_phase(paths["D"], recs)
    dense = _dense_inputs(paths["E"]["engine"], paths["E"]["indices"])
    for dtype in dtypes:
        rec = _dense_record(*dense, dtype)
        rec["edge_case_max_err"] = dense_edge_case(dtype)
        recs["multi_embedding_bag_dense"].append(rec)
    a, b, c = paths["A"], paths["B"], paths["C"]
    ragged = _ragged_inputs(a["engine"], a["indices"])
    ragged_c = _ragged_inputs(c["engine"], c["indices"])
    mixed = mixed_ragged_case()
    ub_table, ub_ids = _sym_case(a["engine"], a["indices"], _pick(a["engine"], "GM_UB"))
    l1ub_table, l1ub_ids = _sym_case(  # the smallest table, swept as one resident tile
        a["engine"], a["indices"], _pick(a["engine"], "any", largest=False))
    gm_table, gm_ids = _sym_case(b["engine"], b["indices"], _pick(b["engine"], "GM"))
    l1_big = _pick(b["engine"], "L1")
    l1_table, l1_ids = _sym_case(b["engine"], b["indices"], l1_big)
    l1r_table, l1r_ids = _sym_case(
        b["engine"], b["indices"], _pick(b["engine"], "L1", largest=False))
    for dtype in dtypes:
        recs["multi_embedding_bag_ragged"].append(
            _ragged_record(*ragged, dtype))
        recs["multi_embedding_bag_ragged"].append(dict(
            _ragged_record(*ragged_c, dtype), case="path C (shard_rocks)"))
        recs["multi_embedding_bag_ragged"].append(dict(
            _ragged_record(*mixed, dtype), case="every strategy code"))
        recs["embedding_bag_ub"].append(_bag_record(
            "embedding_bag_ub", embedding_bag_ub, ub_table, ub_ids, dtype, bitwise=True))
        recs["embedding_bag_ub"].append(dict(_bag_record(
            "embedding_bag_ub", embedding_bag_ub, l1ub_table, l1ub_ids, dtype, bitwise=True,
            persistent=True), case="persistent (L1-UB)"))
        recs["embedding_bag_gm"].append(_bag_record(
            "embedding_bag_gm", embedding_bag_gm, gm_table, gm_ids, dtype, bitwise=True))
        recs["embedding_bag_l1"].append(
            _l1_record(l1_table, l1_ids, dtype, f"path B's table {l1_big}"))
        recs["embedding_bag_l1"].append(_l1_record(l1r_table, l1r_ids, dtype, "resident"))
    head = recs["multi_embedding_bag_ragged"][0]
    gathered = dict(_ragged_record(*ragged, torch.float32, stage_rows=0),
                    case="path A, every region gathered (stage_rows=0)")
    if isinstance(gathered["device_ms"], float) and isinstance(head["device_ms"], float):
        gathered["to_staged_device_ms"] = gathered["device_ms"] / head["device_ms"]
    recs["multi_embedding_bag_ragged"].append(gathered)
    head["queries_sweep"] = ragged_queries_sweep(*ragged)
    head = recs["embedding_bag_l1"][0]
    check(head["mode"] == "cluster", f"[kernel] path B's table {l1_big} is not served by a "
          f"cluster: {head['mode']}")
    head["sweep"] = l1_sweep(l1_table, l1_ids, l1r_table, l1r_ids)
    one = _l1_record(l1_table, l1_ids[:1].contiguous(), torch.float32,
                     f"one query on table {l1_big} (the staging alone)")
    if isinstance(one["device_ms"], float) and isinstance(head["device_ms"], float):
        one["to_uniform_device_ms"] = one["device_ms"] / head["device_ms"]
    recs["embedding_bag_l1"].append(one)
    recs["embedding_bag_l1"] += l1_mode_cases()
    recs["embedding_bag_gm"].append(gm_pooled_case(gm_table, gm_ids))
    recs["embedding_bag_ub"] += ub_cases(ub_table, ub_ids, recs["embedding_bag_ub"][0])
    out = []
    for name, rs in recs.items():
        for r in rs:
            r["launches"] = counts[name]
            print(json.dumps(r))
        head = rs[0]  # f32 at the main path's shapes
        _, _, _, src, replaces = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": max(r.get("max_err", 0.0) for r in rs),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "device_ms": head["device_ms"], "library_device_ms": head["library_device_ms"],
            **{k: head[k] for k in ("mode", "cluster", "rows_per_cta", "grid", "threads")
               if k in head},
        })
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA card",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch is missing beside this script", file=sys.stderr)
        return 2
    card = environment()
    build_kernels()
    runs = {label: main_path(label) for label in PATHS}
    counts = {name: sum(r["counts"][name] for r in runs.values()) for name in KERNELS}
    check(runs["A"]["counts"]["multi_embedding_bag_ragged"] > 0, "K1 not launched on path A")
    check(runs["C"]["counts"]["multi_embedding_bag_ragged"] > 0, "K1 not launched on path C")
    check(runs["A"]["counts"]["embedding_bag_ub"] > 0, "K2 not launched on path A")
    check(runs["B"]["counts"]["embedding_bag_gm"] > 0, "K3 not launched on path B")
    check(runs["B"]["counts"]["embedding_bag_l1"] > 0, "K4 not launched on path B")
    check(runs["B"]["l1_modes"]["cluster"] > 0 and runs["B"]["l1_modes"]["resident"] > 0,
          f"K4 on path B ran no cluster or no resident launch: {runs['B']['l1_modes']}")
    for name, k in (("dedup", "K5"), ("cache", "K6"), ("sparse", "K7")):
        check(runs["D"]["counts"][f"multi_embedding_bag_ragged[{name}]"] > 0,
              f"{k} ({name}) not launched on path D")
    check(runs["E"]["counts"]["multi_embedding_bag_dense"] > 0, "K8 not launched on path E")
    check(runs["D"]["counts"]["batch_dedup"] > 0, "the dedup kernel not launched on path D")
    kernels = kernel_phase(runs, counts)
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
