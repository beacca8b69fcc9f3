"""Dry-run of every (arch x shape x mesh) cell: the step a cell runs, its
per-device bytes on the mesh and its FLOPs, with no memory and no card.

For each cell the config is built at its published size (``--smoke``: the
reduced config) on the ``meta`` device, the real step is built with a
:class:`ShardCtx` on the mesh shape (train with AdamW, prefill, or decode)
and run on ``meta`` tensors under ``torch.utils.flop_counter.FlopCounterMode``.
The record (``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``; reruns
skip existing records unless ``--force``) holds:

* ``status``: ``ok``, the JAX package's ``skipped (...)`` reason, or
  ``FAILED`` with the error;
* ``bytes_per_device``: parameters, optimizer state, batch and cache, each
  leaf's bytes divided by the product of its spec's axis sizes
  (:mod:`repro_torch.sharding`);
* ``flops``: the whole step's FLOPs as FlopCounterMode counts them (the
  matmuls, einsums and attention products, the rematerialised forward
  included), and their ratio to ``configs/base.py::flops_per_token`` x
  tokens.

The DLRM cells (``dlrm-<workload>`` x ``serve_8k``/``serve_64k``) record
each plan core's packed bytes from the port's asymmetric plan.

The JAX package's dry-run lowers each cell to XLA on 512 fake devices and
reads the compiled module's ``memory_analysis`` and its HLO
(``launch/hlo_analysis.py``); PyTorch has no compiled module or HLO text
here, so FlopCounterMode stands in for the HLO count and the spec-divided
bytes for ``memory_analysis``.  Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke --debug-mesh
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding as sh
from repro_torch.configs.base import SHAPES, ShapeCfg, flops_per_token
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.registry import ARCH_IDS, build
from repro_torch.training.optimizer import adamw

__all__ = ["ARTIFACT_DIR", "DLRM_SHAPES", "make_ctx", "run_cell", "main"]

ARTIFACT_DIR = Path("artifacts/dryrun_torch")
DLRM_SHAPES = {"serve_8k": 8192, "serve_64k": 65536}
DLRM_ARCHS = ("dlrm-criteo-1tb", "dlrm-huawei-25mb", "dlrm-avazu-ctr")
SKIPPED = "skipped (unsupported: full-attention long-context or no decode path)"


def make_ctx(mesh, shape: ShapeCfg, multi_pod: bool) -> T.ShardCtx:
    return T.ShardCtx(
        mesh=mesh,
        model_axis="model",
        data_axes=("pod", "data") if multi_pod else ("data",),
        shard_batch=shape.batch % sh.dp_size(mesh) == 0,
    )


def _meta_batch(bundle, shape: ShapeCfg) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in bundle.batch_specs(shape).items()}


def _lm_cell(arch: str, shape: ShapeCfg, mesh, multi_pod: bool, smoke: bool) -> dict | None:
    """Run one LM cell's step on ``meta`` under FlopCounterMode -> the
    record's bytes and FLOPs (``None``: the config does not run the shape)."""
    bundle = build(arch, smoke=smoke)
    cfg = bundle.cfg
    if shape.name in SHAPES and not cfg.supports(shape.name):
        return None
    ctx = make_ctx(mesh, shape, multi_pod)
    n_dp = sh.dp_size(mesh)
    batch = _meta_batch(bundle, shape)
    nbytes = {"batch": sh.per_device_bytes(batch, sh.batch_pspecs(cfg, shape, multi_pod, n_dp),
                                         mesh)}
    if shape.kind == "train":
        params = bundle.param_struct()
        opt = adamw(3e-4, moments_dtype=torch.bfloat16 if cfg.low_precision_opt else None)
        opt_state = opt.init(params)
        pspecs = sh.param_pspecs(params, multi_pod)
        nbytes["params"] = sh.per_device_bytes(params, pspecs, mesh)
        nbytes["opt_state"] = sh.per_device_bytes(opt_state, sh.opt_pspecs(opt_state, pspecs), mesh)
        step = bundle.train_step(ctx, opt, shape)
        args = (params, opt_state, batch)
        tokens = shape.batch * shape.seq
    else:
        params = bundle.param_struct(torch.bfloat16)
        nbytes["params"] = sh.per_device_bytes(params, sh.param_pspecs(params, multi_pod), mesh)
        cspecs = sh.cache_pspecs(cfg, shape, multi_pod, n_dp)
        if shape.kind == "prefill":
            step = bundle.prefill_step(ctx, shape)
            args = (params, batch)
            tokens = shape.batch * shape.seq
        else:
            cache = bundle.cache_struct(shape)
            nbytes["cache"] = sh.per_device_bytes(cache, cspecs, mesh)
            step = bundle.serve_step(ctx)
            args = (params, cache, batch)
            tokens = shape.batch
    with FlopCounterMode(display=False) as counter:
        out = step(*args)
    if shape.kind == "prefill":
        nbytes["cache"] = sh.per_device_bytes(out[1], cspecs, mesh)
    flops = counter.get_total_flops()
    model = flops_per_token(cfg, shape.seq, shape.kind) * tokens
    return {"bytes_per_device": nbytes, "flops": flops, "model_flops": model,
            "flops_ratio": flops / model if model else None, "tokens": tokens}


def _dlrm_cell(arch: str, shape_name: str, mesh) -> dict:
    """The paper's own model on the mesh: taobao-like workload ``arch[5:]``
    at the cell's batch, planned asymmetric (TPU-profile rock sharding) over
    the model axis's cores; each core's packed rows and bf16 bytes."""
    from repro_torch.core.cost_model import analytic_model
    from repro_torch.core.partition import ragged_core_rows
    from repro_torch.core.planner import plan_asymmetric
    from repro_torch.data.workloads import get_workload

    wl = get_workload(arch[len("dlrm-"):], DLRM_SHAPES[shape_name])
    k = mesh.shape["model"]
    plan = plan_asymmetric(wl, k, analytic_model(), shard_rocks=True)
    plan.validate(wl.tables)
    rows = ragged_core_rows(plan)
    row_bytes = wl.tables[0].dim * 2  # bf16
    return {"batch": wl.batch, "cores": k, "packed_rows_per_core": rows,
            "packed_bytes_per_core": [r * row_bytes for r in rows],
            "symmetric_tables": list(plan.symmetric_tables),
            "table_bytes": sum(t.rows for t in wl.tables) * row_bytes}


def run_cell(
    arch: str,
    shape_name: str | ShapeCfg,
    multi_pod: bool,
    *,
    smoke: bool = False,
    mesh=None,
    out_dir: Path = ARTIFACT_DIR,
    force: bool = False,
) -> dict:
    """Dry-run one cell and write its record (or return the one on disk);
    ``shape_name`` names a shape of ``SHAPES`` or is a :class:`ShapeCfg`."""
    shape = shape_name
    if isinstance(shape_name, ShapeCfg):
        shape_name = shape.name
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if mesh is not None:
        mesh_name = "debug" + "x".join(str(s) for s in mesh.axis_sizes)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "devices": mesh.size}
    t0 = time.perf_counter()
    try:
        if arch.startswith("dlrm-"):
            res = _dlrm_cell(arch, shape_name, mesh)
        else:
            if not isinstance(shape, ShapeCfg):
                shape = SHAPES[shape_name]
            res = _lm_cell(arch, shape, mesh, multi_pod, smoke)
        if res is None:
            record["status"] = SKIPPED
        else:
            record.update(status="ok", run_s=time.perf_counter() - t0, **res)
    except Exception as e:  # record failures: they are bugs to fix
        record.update(status="FAILED", error=f"{type(e).__name__}: {e}"[:2000],
                      traceback=traceback.format_exc()[-4000:])
    out_path.write_text(json.dumps(record, indent=2))
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    p.add_argument("--smoke", action="store_true", help="reduced configs")
    p.add_argument("--debug-mesh", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--out", default=str(ARTIFACT_DIR))
    args = p.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    if args.all and not args.smoke:
        archs += list(DLRM_ARCHS)
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]

    failures = 0
    for multi_pod in pods:
        mesh = make_debug_mesh(multi_pod=multi_pod) if args.debug_mesh else None
        for arch in archs:
            for shape in (list(DLRM_SHAPES) if arch.startswith("dlrm-") else shapes):
                rec = run_cell(arch, shape, multi_pod, smoke=args.smoke, mesh=mesh,
                               out_dir=Path(args.out), force=args.force)
                status, extra = rec["status"], ""
                if status == "ok" and "flops" in rec:
                    b = rec["bytes_per_device"]
                    extra = (f" bytes/device={sum(b.values()) / 2**30:.3g}GiB"
                             f" flops={rec['flops']:.3g} ratio={rec['flops_ratio']:.3g}"
                             f" run={rec['run_s']:.1f}s")
                elif status == "ok":
                    extra = f" packed/core={max(rec['packed_bytes_per_core']) / 2**20:.3g}MiB"
                elif status == "FAILED":
                    failures += 1
                    extra = " " + rec["error"][:160]
                print(f"[dryrun] {arch:>22s} {shape:>12s} "
                      f"{'2pod' if multi_pod else '1pod'} {status}{extra}", flush=True)
    if failures:
        print(f"[dryrun] {failures} FAILURES", flush=True)
        return 1
    print("[dryrun] all cells OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
