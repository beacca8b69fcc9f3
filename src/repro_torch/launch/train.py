"""Training entry point: the DLRM or an LM (dense, moe, ssm, hybrid,
encdec or vlm), trained by the checkpointed loop on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-2b --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm --steps 20 --device cpu

As in the JAX package's CLI, ``--smoke`` is on and cannot be turned off:
an LM arch trains its SMOKE config.  The DLRM trains five tables (100,000
to 100 rows, E = 16) with Adagrad at ten times ``--lr``; an LM trains with
AdamW at ``--lr``.  Weights come from seed 0 and each step's batch from its
step number.  ``--device cpu`` runs the kernels' plain versions; the
default is the card, and without one the CLI raises.  A checkpoint
directory that already holds a complete checkpoint is resumed from.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ShapeCfg
from repro_torch.device import resolve_device, to_device
from repro_torch.models import registry
from repro_torch.training.loop import LoopConfig, train
from repro_torch.training.optimizer import adagrad, adamw


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="olmo-1b", choices=list(registry.ARCH_IDS) + ["dlrm"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--smoke", action="store_true", default=True,
                   help="reduced config (always on, as in the JAX package's CLI)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument("--grad-compression", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the default) runs the kernels; cpu their plain versions")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    if args.arch == "dlrm":
        from repro_torch.core.tables import make_workload
        from repro_torch.data.synthetic import ctr_batch
        from repro_torch.models.dlrm import (
            DLRMConfig,
            init_dlrm,
            make_dlrm_train_step,
            train_params,
        )

        wl = make_workload("train-cli", [100_000, 50_000, 10_000, 1_000, 100],
                           dim=16, batch=args.batch)
        cfg = DLRMConfig(arch="dlrm-cli", workload=wl)
        opt = adagrad(args.lr * 10)
        step_fn = make_dlrm_train_step(cfg, opt)

        def init_state():
            params = train_params(init_dlrm(cfg, torch.Generator().manual_seed(0)), device)
            return params, opt.init(params)

        def batch_fn(step):
            b = ctr_batch(np.random.default_rng(step), wl, batch=args.batch)
            return {k: to_device(v, device) for k, v in b.items()}
    else:
        bundle = registry.build(args.arch, smoke=args.smoke)
        shape = ShapeCfg("cli", "train", args.seq, args.batch)
        opt = adamw(args.lr)
        step_fn = bundle.train_step(None, opt, shape)

        def init_state():
            params = bundle.init(torch.Generator(device).manual_seed(0))
            return params, opt.init(params)

        def batch_fn(step):
            return bundle.make_batch(shape, torch.Generator(device).manual_seed(step))

    out = train(
        LoopConfig(
            total_steps=args.steps,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            grad_compression=args.grad_compression,
        ),
        init_state=init_state,
        step_fn=step_fn,
        batch_fn=batch_fn,
        on_step=lambda s, m: s % 10 == 0 and print(
            f"[train] step {s:5d} loss {m['loss']:.4f} ({m['sec']*1e3:.0f} ms)"),
    )
    print(f"[train] done: loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}, "
          f"{out['mean_step_s']*1e3:.0f} ms/step, resumed_from={out['start_step']} "
          f"on {device}")
    return out


if __name__ == "__main__":
    main()
