"""End-to-end driver: train a ~100M-parameter DLRM for a few hundred steps.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_dlrm [--steps 300] [--crash] [--device cpu]

Synthetic Criteo-like CTR data (zipf access pattern), Adagrad on the tables
(classic DLRM recipe), periodic checkpoints.  ``--crash`` injects a failure
mid-run and restarts from the last checkpoint, demonstrating the recovery
path.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core.tables import make_workload
from repro_torch.data.synthetic import ctr_batch
from repro_torch.device import resolve_device
from repro_torch.models.dlrm import (
    DLRMConfig,
    init_dlrm,
    make_dlrm_train_step,
    train_params,
)
from repro_torch.training.loop import LoopConfig, SimulatedFailure, train
from repro_torch.training.optimizer import adagrad


def build_cfg(scale: float = 1.0) -> DLRMConfig:
    # ~6.2M rows x E16 ~= 100M embedding params + MLPs
    cards = [int(c * scale) for c in
             (3_000_000, 1_500_000, 800_000, 400_000, 200_000, 100_000,
              50_000, 20_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100,
              50, 20, 10)]
    wl = make_workload("dlrm-100m", cards, dim=16, batch=256)
    return DLRMConfig(arch="dlrm-100m", workload=wl)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--crash", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_cfg(args.scale)
    n_params = cfg.param_count()
    print(f"DLRM params: {n_params/1e6:.1f}M "
          f"({len(cfg.workload.tables)} tables, batch {cfg.workload.batch})")

    opt = adagrad(5e-2)
    step_fn = make_dlrm_train_step(cfg, opt)

    def init_state():
        params = train_params(init_dlrm(cfg, torch.Generator().manual_seed(0)), device)
        return params, opt.init(params)

    def batch_fn(step):
        b = ctr_batch(np.random.default_rng(step), cfg.workload,
                      distribution="real", batch=cfg.workload.batch)
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="dlrm_ckpt_")
    loop_cfg = LoopConfig(
        total_steps=args.steps,
        checkpoint_every=max(args.steps // 6, 10),
        checkpoint_dir=ckpt_dir,
        fail_at_step=args.steps // 2 if args.crash else None,
    )
    try:
        out = train(loop_cfg, init_state=init_state, step_fn=step_fn,
                    batch_fn=batch_fn,
                    on_step=lambda s, m: s % 50 == 0 and print(
                        f"  step {s:4d} loss {m['loss']:.4f} ({m['sec']*1e3:.0f} ms)"))
    except SimulatedFailure as e:
        print(f"!! {e} — restarting from checkpoint ...")
        loop_cfg.fail_at_step = None
        out = train(loop_cfg, init_state=init_state, step_fn=step_fn,
                    batch_fn=batch_fn,
                    on_step=lambda s, m: s % 50 == 0 and print(
                        f"  step {s:4d} loss {m['loss']:.4f}"))
        print(f"resumed at step {out['start_step']}")
    print(f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"({out['mean_step_s']*1e3:.0f} ms/step, "
          f"{out['stragglers']} straggler steps)")
    assert out["final_loss"] < out["first_loss"], "loss must decrease"
    print("OK")
    return out


if __name__ == "__main__":
    main()
