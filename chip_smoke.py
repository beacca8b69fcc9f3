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
   three times, with every launch counter set to 0 just before and read
   just after each run:
   A. the default EngineConfig with the paper's LIF fallback
      (``shard_rocks`` off): nine asymmetric L1 chunks through the fused
      ragged kernel, six symmetric GM-UB tables through the UB kernel;
   B. the symmetric planner priced under the ``ascend_910`` preset: GM,
      GM-UB and L1 tables through the GM, UB and L1 kernels;
   C. the serve CLI's own defaults (``shard_rocks`` on, ``degrade_after``
      left at the config's 3): a fully asymmetric plan (15 L1 chunks, no
      symmetric group) whose big regions, too large for shared memory, run
      through the fused kernel's device-memory gather.
   Each checks the request accounting, finite logits, the launch counters,
   that its server has no plain fallback step, and the pooled output of its
   last served batch against the same engine built on the CPU (the kernels'
   plain versions);
4. kernels: each kernel against its plain version on the card, in f32,
   bf16 and f16, at the shapes the main path gave it (plus every strategy
   code, padding steps, -1 and out-of-window ids for the fused kernel),
   timed with CUDA events beside its plain version and one PyTorch library
   call computing the same lookups (``F.embedding_bag``, a yardstick only).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the JSON record of every kernel.
"""
from __future__ import annotations

import argparse
import copy
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
PATHS = {
    "A": MAIN_ARGS + ["--set", 'planner_options={"shard_rocks": false}'],
    "B": MAIN_ARGS + ["--set", "planner=symmetric", "--set", "hardware=ascend_910"],
    "C": CLI_ARGS,
}
KERNELS = {
    # name: (wrapper module, source, the Pallas kernel it replaces)
    "multi_embedding_bag_ragged": ("embedding_multi", "src/repro_torch/csrc/embedding_multi.cu",
                                   "src/repro/kernels/embedding_multi.py:139"),
    "embedding_bag_ub": ("embedding_ub", "src/repro_torch/csrc/embedding_ub.cu",
                         "src/repro/kernels/embedding_ub.py:34"),
    "embedding_bag_gm": ("embedding_gm", "src/repro_torch/csrc/embedding_gm.cu",
                         "src/repro/kernels/embedding_gm.py:27"),
    "embedding_bag_l1": ("embedding_l1", "src/repro_torch/csrc/embedding_l1.cu",
                         "src/repro/kernels/embedding_l1.py:25"),
}


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def wrappers():
    import importlib

    return {
        name: getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), name)
        for name, (mod, _, _) in KERNELS.items()
    }


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


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
    engine, last = res["engine"], res["last"]
    s = res["stats"]["uniform"]
    check(s["submitted"] == s["served"] == args.queries,
          f"[main {label}] submitted {s['submitted']} served {s['served']}")
    check(s["batch_failures"] == 0 and s["degraded_batches"] == 0,
          f"[main {label}] failures {s['batch_failures']} degraded {s['degraded_batches']}")
    check(res["server"].fallback_step_fn is None,
          f"[main {label}] the server on the card has a plain fallback step")
    logits = last["logits"]
    check(logits.shape == (args.batch,) and np.isfinite(logits).all(),
          f"[main {label}] bad logits")

    # the same engine on the CPU (plain versions) on the last served batch
    idx = last["indices"]
    cpu_engine = InferenceEngine.build(res["params"]["tables"], engine.workload,
                                       engine.config, device="cpu")
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
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        forward()
    # kernel events only (as the profiler's own "Self CUDA time total")
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation) / 1e3
    batches = args.queries // args.batch
    rec = {
        "main_path": label, "served": s["served"], "batches": batches,
        "wall_s": wall, "serve_wall_per_batch_ms": res["serve_wall_s"] / batches * 1e3,
        "p50_us": s["p50_us"], "p99_us": s["p99_us"],
        "forward_ms": forward_ms, "lookup_ms": lookup_ms,
        "forward_device_ms": device_ms if device_ms > 0 else "not measured",
        "plan": {"chunks": len(engine.plan.assignments),
                 "chunk_strategies": sorted(
                     {a.strategy.name for a in engine.plan.assignments}),
                 "symmetric": [[t, st.name] for t, st in zip(
                     engine.plan.symmetric_tables, engine.plan.symmetric_strategies)]},
        "launches": counts, "pooled_max_err": pooled_err, "logit_max_err": logit_err,
    }
    print(json.dumps(rec))
    return {"engine": engine, "indices": idx, "counts": counts}


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


def _bag_record(name, fn, table, lidx, dtype, **kw):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ref import bag_f32

    t = table.to(dtype).contiguous()
    got = fn(t, lidx, **kw)
    torch.cuda.synchronize()
    want = bag_f32(t, lidx)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **TOL), f"[kernel] {name} {dtype}: max err {err}")
    ids = lidx.long()
    rec = {
        "name": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": {"m": t.shape[0] - 1, "E": t.shape[1], "B": lidx.shape[0], "s": lidx.shape[1]},
        "max_err": err,
        "ms": time_ms(lambda: fn(t, lidx, **kw)),
        "plain_ms": time_ms(lambda: bag_f32(t, lidx)),
        "library_ms": time_ms(lambda: F.embedding_bag(ids, t, mode="sum")),
    }
    uniq = int(torch.unique(ids[ids < t.shape[0] - 1]).numel())
    b, s = lidx.shape
    e = t.shape[1]
    rec["bound_ms"], rec["bound_by"] = bound(
        uniq * e * t.element_size() + b * s * 4 + b * e * 4, b * s * e)
    return rec


def _ragged_inputs(engine, idx):
    import torch

    from repro_torch.core.partition import _slot_indices

    packed = engine.packed
    local, valid = _slot_indices(packed, torch.as_tensor(idx, device=packed.device))
    lidx = torch.where(valid, local, -1).to(torch.int32)
    return packed.chunk_data, lidx, packed.step_block, packed.step_runs, packed.block_r


def _ragged_record(buffer_full, lidx, step_block, runs, block_r, dtype):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_multi import (
        multi_embedding_bag_ragged,
        multi_embedding_bag_ragged_plain,
        ragged_stage_rows,
    )

    full = buffer_full.to(dtype)
    buf = full[:, :-1]
    k, t1, e = full.shape
    zero_row = t1 - 1
    run_list = runs.tolist()
    stage_rows = ragged_stage_rows(run_list, block_r, e * full.element_size())

    def kernel():
        return multi_embedding_bag_ragged(buf, lidx, step_block, runs, block_r=block_r,
                                          stage_rows=stage_rows)

    got = kernel()
    torch.cuda.synchronize()
    want = multi_embedding_bag_ragged_plain(buf, lidx, step_block, runs, block_r=block_r)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **TOL), f"[kernel] ragged {dtype}: max err {err}")
    # library yardstick: one embedding_bag over global buffer rows
    s_slots, b, s = lidx.shape[1:]
    gl = torch.full((k, s_slots, b, s), zero_row, dtype=torch.long, device=buf.device)
    blocks = step_block.long()
    for core, slot, first, n, _ in run_list:
        ids = lidx[core, slot].long()
        ok = (ids >= 0) & (ids < n * block_r)
        loc = torch.where(ok, ids, 0)
        rows = blocks[core, first + loc // block_r] * block_r + loc % block_r
        gl[core, slot] = torch.where(ok, rows, zero_row)
    flat = full.reshape(k * t1, e)
    gl = (gl + torch.arange(k, device=buf.device).view(k, 1, 1, 1) * t1).reshape(-1, s)
    lib = F.embedding_bag(gl, flat, mode="sum").view(k, s_slots, b, e)
    lib_err = float((lib.float() - want).abs().max())
    rec = {
        "name": "multi_embedding_bag_ragged", "dtype": str(dtype).replace("torch.", ""),
        "shape": {"K": k, "T": t1 - 1, "E": e, "S": s_slots, "B": b, "s": s,
                  "block_r": block_r, "runs": len(run_list), "stage_rows": stage_rows,
                  "codes": sorted({r[4] for r in run_list})},
        "max_err": err, "library_max_err": lib_err,
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: multi_embedding_bag_ragged_plain(
            buf, lidx, step_block, runs, block_r=block_r)),
        "library_ms": time_ms(lambda: F.embedding_bag(gl, flat, mode="sum")),
    }
    real = gl.view(k, s_slots, b, s)[[r[0] for r in run_list], [r[1] for r in run_list]]
    uniq = int(torch.unique(real[real % t1 != zero_row]).numel())
    n_runs = len(run_list)
    rec["bound_ms"], rec["bound_by"] = bound(
        uniq * e * full.element_size() + n_runs * b * s * 4 + n_runs * b * e * 4,
        n_runs * b * s * e)
    return rec


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


def kernel_phase(paths: dict, counts: dict) -> list:
    import torch

    from repro_torch.kernels.embedding_gm import embedding_bag_gm
    from repro_torch.kernels.embedding_l1 import embedding_bag_l1
    from repro_torch.kernels.embedding_ub import embedding_bag_ub

    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    recs: dict[str, list] = {name: [] for name in KERNELS}
    a, b, c = paths["A"], paths["B"], paths["C"]
    ragged = _ragged_inputs(a["engine"], a["indices"])
    ragged_c = _ragged_inputs(c["engine"], c["indices"])
    mixed = mixed_ragged_case()
    ub_table, ub_ids = _sym_case(a["engine"], a["indices"], _pick(a["engine"], "GM_UB"))
    l1ub_table, l1ub_ids = _sym_case(  # the smallest table, swept as one resident tile
        a["engine"], a["indices"], _pick(a["engine"], "any", largest=False))
    gm_table, gm_ids = _sym_case(b["engine"], b["indices"], _pick(b["engine"], "GM"))
    l1_table, l1_ids = _sym_case(b["engine"], b["indices"], _pick(b["engine"], "L1"))
    l1r_table, l1r_ids = _sym_case(
        b["engine"], b["indices"], _pick(b["engine"], "L1", largest=False))
    for dtype in dtypes:
        recs["multi_embedding_bag_ragged"].append(
            _ragged_record(*ragged, dtype))
        recs["multi_embedding_bag_ragged"].append(dict(
            _ragged_record(*ragged_c, dtype), case="path C (shard_rocks)"))
        recs["multi_embedding_bag_ragged"].append(dict(
            _ragged_record(*mixed, dtype), case="every strategy code"))
        recs["embedding_bag_ub"].append(
            _bag_record("embedding_bag_ub", embedding_bag_ub, ub_table, ub_ids, dtype))
        recs["embedding_bag_ub"].append(dict(_bag_record(
            "embedding_bag_ub", embedding_bag_ub, l1ub_table, l1ub_ids, dtype, persistent=True),
            case="persistent (L1-UB)"))
        recs["embedding_bag_gm"].append(
            _bag_record("embedding_bag_gm", embedding_bag_gm, gm_table, gm_ids, dtype))
        recs["embedding_bag_l1"].append(
            _bag_record("embedding_bag_l1", embedding_bag_l1, l1_table, l1_ids, dtype))
        recs["embedding_bag_l1"].append(dict(_bag_record(
            "embedding_bag_l1", embedding_bag_l1, l1r_table, l1r_ids, dtype),
            case="resident"))
    out = []
    for name, rs in recs.items():
        for r in rs:
            r["launches"] = counts[name]
            print(json.dumps(r))
        head = rs[0]  # f32 at the main path's shapes
        _, src, replaces = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": max(r["max_err"] for r in rs),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
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
    kernels = kernel_phase(runs, counts)
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
