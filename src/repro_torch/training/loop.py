"""Training loop with checkpoint/restart fault tolerance.

* periodic (optionally async) checkpoints of ``(params, opt_state)``;
* crash recovery: on start, resume from the latest *complete* checkpoint
  (torn checkpoints are ignored by the manifest's commit marker);
* a failure injection hook for tests (``fail_at_step``);
* ``grad_compression`` allocates the int8 error-feedback state
  (training/compress.py), as the JAX package's loop does; neither loop
  hands it to ``step_fn`` yet (ROADMAP C);
* step times with a straggler watchdog: steps slower than
  ``straggler_factor`` x the running median are counted and reported.

``step_fn`` is called as it is given: eager PyTorch, nothing compiled.  A
step's time is taken on the host clock after its loss has been read, which
waits for the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.training import compress as compress_lib

__all__ = ["LoopConfig", "SimulatedFailure", "train"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "checkpoints"
    keep: int = 3
    async_checkpoint: bool = False
    grad_compression: bool = False
    straggler_factor: float = 3.0
    fail_at_step: int | None = None  # test hook: simulate a crash
    log_every: int = 10


class SimulatedFailure(RuntimeError):
    pass


def train(
    cfg: LoopConfig,
    *,
    init_state: Callable[[], tuple[Any, Any]],  # () -> (params, opt_state)
    step_fn: Callable,  # (params, opt_state, batch) -> (params, opt_state, metrics)
    batch_fn: Callable[[int], Any],  # step -> batch
    optimizer=None,
    on_step: Callable[[int, dict], None] | None = None,
) -> dict:
    """Run (or resume) training; returns summary metrics."""
    params, opt_state = init_state()
    start_step = 0
    err_state = None
    try:
        (params, opt_state), restored = ckpt.restore(
            cfg.checkpoint_dir, None, (params, opt_state))
        start_step = restored + 1
    except FileNotFoundError:
        pass

    if cfg.grad_compression and err_state is None:
        err_state = compress_lib.init_error_state(params)

    losses, times = [], []
    stragglers = 0
    for step in range(start_step, cfg.total_steps):
        if cfg.fail_at_step is not None and step == cfg.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")
        t0 = time.perf_counter()
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        times.append(dt)
        if len(times) > 5 and dt > cfg.straggler_factor * float(np.median(times)):
            stragglers += 1
        if step % cfg.checkpoint_every == 0 and step > start_step:
            ckpt.save(cfg.checkpoint_dir, step, (params, opt_state),
                      keep=cfg.keep, async_=cfg.async_checkpoint)
        if on_step is not None:
            on_step(step, {"loss": loss, "sec": dt})
    # final checkpoint
    last = cfg.total_steps - 1
    if last >= start_step:
        ckpt.save(cfg.checkpoint_dir, last, (params, opt_state), keep=cfg.keep)
    return {
        "params": params,
        "opt_state": opt_state,
        "start_step": start_step,
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "losses": losses,
        "stragglers": stragglers,
        "mean_step_s": float(np.mean(times)) if times else 0.0,
    }
