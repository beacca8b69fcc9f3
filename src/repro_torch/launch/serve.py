"""Serving entrypoint: engine-driven partitioned DLRM inference on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --workload taobao \
        --batch 8192 --queries 16384 --distribution uniform \
        --set "mesh_shape=[1,8]"

The pipeline is declared by an :class:`repro_torch.engine.EngineConfig` —
load one with ``--config engine.json`` (a JSON written by either package),
tweak fields with ``--set field=value`` (JSON-parsed), and persist the
resolved artifact with ``--save-config``.  ``--distribution`` picks the
query stream (``uniform`` / ``zipf:<a>`` / ``hotset:<frac>:<mass>[:<off>]``
/ preset / ``all``) and doubles as the pricing distribution unless the
config pins one.  ``--device cpu`` runs the kernels' plain versions.

As in the JAX package's CLI, the asymmetric planner gets
``shard_rocks=True`` unless the config sets it (big tables are row-sharded
instead of falling back to the symmetric group); ``--set
'planner_options={"shard_rocks": false}'`` restores the paper's LIF
fallback.  The legacy flag spellings, ``--preset`` and ``--drift`` are not
ported yet (ROADMAP A6).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.engine import EngineConfig

__all__ = ["build_parser", "config_from_args", "main"]


def _resolve_dists(spec: str) -> list[tuple[str, object]]:
    """CLI --distribution -> [(label, Distribution)]."""
    from repro_torch.data import distributions as dist_lib

    if spec == "all":
        return [
            ("uniform", dist_lib.Uniform()),
            ("real", dist_lib.Zipf(1.05, hot_prefix=False)),
            ("fixed", dist_lib.Fixed()),
        ]
    return [(spec, dist_lib.get_distribution(spec))]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="smoke")
    p.add_argument("--batch", type=int, default=None,
                   help="serving batch size (default: the config's "
                        "max_batch, 256)")
    p.add_argument("--queries", type=int, default=2048)
    p.add_argument("--distribution", default="real",
                   help="query stream: uniform | real | fixed | all | "
                        "zipf:<a> | hotset:<frac>:<mass>[:<off>] | "
                        "<workload preset>")
    p.add_argument("--config", type=Path, default=None,
                   help="EngineConfig JSON artifact to build from")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="FIELD=VALUE",
                   help="override an EngineConfig field (VALUE is JSON, "
                        "e.g. --set 'mesh_shape=[1,8]')")
    p.add_argument("--save-config", type=Path, default=None,
                   help="write the resolved EngineConfig JSON and continue")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to serve (default: the card)")
    return p


def config_from_args(args) -> EngineConfig:
    """Resolve the CLI namespace into one :class:`EngineConfig`.

    Precedence: ``--config`` base (else defaults) < ``--batch`` < ``--set``
    overrides.  Also bakes in the serve CLI's historical choice of
    ``shard_rocks=True`` for the asymmetric planner.
    """
    config = EngineConfig.load(args.config) if args.config else EngineConfig()
    if args.batch is not None:
        config.max_batch = args.batch
    for spec in args.overrides:
        field, sep, value = spec.partition("=")
        if not sep:
            raise SystemExit(f"--set expects FIELD=VALUE, got {spec!r}")
        if field not in {f.name for f in EngineConfig.__dataclass_fields__.values()}:
            raise SystemExit(f"--set: unknown EngineConfig field {field!r}")
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass  # bare strings: --set planner=symmetric
        setattr(config, field, value)
    config.__post_init__()  # normalize a --set mesh_shape list
    # the query stream doubles as the pricing distribution unless the
    # config pins its own ("all" streams start from the uniform leg)
    if config.distribution is None and args.distribution:
        config.distribution = ("uniform" if args.distribution == "all"
                               else args.distribution)
    if config.planner == "asymmetric":
        config.planner_options.setdefault("shard_rocks", True)
    config.validate()
    return config


def main(argv=None) -> dict:
    """Serve ``--queries`` requests in batches of ``max_batch`` and print the
    plan report and per-distribution latency.  Returns what a caller needs
    to check the run: the engine, the DLRM config and parameters, each
    traffic label's server stats, the last server, and the last batch
    served (its inputs and per-request logits)."""
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    from repro_torch.data.workloads import WORKLOADS

    if args.workload not in ["smoke", *WORKLOADS]:
        raise SystemExit(f"unknown workload {args.workload!r}")
    batch = config.max_batch  # precedence: --config < --batch < --set
    if args.save_config:
        config.save(args.save_config)
        print(f"[serve] wrote {args.save_config}")

    from repro_torch.data import distributions as dist_lib
    from repro_torch.data.workloads import get_workload, small_workload
    from repro_torch.device import resolve_device
    from repro_torch.engine import InferenceEngine
    from repro_torch.models.dlrm import DLRMConfig, forward_packed, init_dlrm

    device = resolve_device(args.device)
    wl = (small_workload(batch=batch) if args.workload == "smoke"
          else get_workload(args.workload, batch))
    cfg = DLRMConfig(arch=f"dlrm-{args.workload}", workload=wl)
    params = init_dlrm(cfg, torch.Generator().manual_seed(0), device)
    n_batches = max(args.queries // batch, 1)

    def make_step(engine):
        """One serving step over request payloads: the full DLRM forward on
        the engine's packed embeddings."""

        def step(payloads):
            dense = torch.as_tensor(np.stack([q["dense"] for q in payloads]), device=device)
            idx = torch.as_tensor(
                np.stack([q["indices"] for q in payloads], axis=1), device=device
            )
            logits = forward_packed(
                cfg, engine.bag, engine.packed, params,
                {"dense": dense, "indices": idx},
                use_kernels=engine._use_kernels,
                reduce_mode=engine.config.reduce_mode,
            )
            return logits.cpu().numpy()

        return step

    t0 = time.perf_counter()
    engine = InferenceEngine.build(params["tables"], wl, config, device=device)
    build_s = time.perf_counter() - t0
    for line in engine.plan_report().splitlines():
        print(f"[serve] {line}")
    print(f"[serve] built in {build_s:.2f}s on {device}")

    # (B,) logits -> one scalar per request handle
    split = lambda out, n: [out[i] for i in range(n)]  # noqa: E731
    rng = np.random.default_rng(0)
    result = {"engine": engine, "cfg": cfg, "params": params, "stats": {}}
    for label, dist in _resolve_dists(args.distribution):
        srv = engine.serve(make_step=make_step, split_fn=split)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            b = dist_lib.sample_workload(rng, wl, dist, batch)
            dense = rng.standard_normal((batch, cfg.n_dense)).astype(np.float32)
            handles = [
                srv.submit_request({"dense": dense[q], "indices": b[:, q]})
                for q in range(batch)
            ]
            srv.pump()
            assert handles[0].done()
        wall_s = time.perf_counter() - t0
        unserved = srv.drain()
        if unserved:
            print(f"[serve] WARNING: {len(unserved)} queries left unserved")
        s = srv.stats()
        result["stats"][label] = s
        result["server"] = srv
        result["serve_wall_s"] = wall_s
        result["last"] = {
            "indices": b, "dense": dense,
            "logits": np.asarray([h.result() for h in handles], np.float32),
        }
        print(f"[serve] dist={label:8s} p50={_fmt_us(s['p50_us'])} "
              f"p99={_fmt_us(s['p99_us'])} tps={s['tps']:9.0f} "
              f"wall/batch={wall_s / n_batches * 1e3:.2f}ms ({n_batches} batches)")
        _print_robustness(s)
    return result


def _fmt_us(v) -> str:
    """An idle server has no latency samples: percentiles come back None
    (not NaN) and must print cleanly."""
    return "     idle" if v is None else f"{v:9.0f}us"


def _print_robustness(s: dict) -> None:
    """One accounting line whenever the run saw any robustness event."""
    if any(s.get(k) for k in ("rejected", "shed", "deadline_misses",
                              "batch_failures", "degraded_batches",
                              "invalid")):
        print(f"[serve]   submitted={s['submitted']} served={s['served']} "
              f"shed={s['shed']} rejected={s['rejected']} "
              f"invalid={s['invalid']} "
              f"deadline_misses={s['deadline_misses']} "
              f"batch_failures={s['batch_failures']} "
              f"degraded_batches={s['degraded_batches']}")
    val = s.get("validation") or {}
    if val.get("oov_indices") or val.get("negative_indices"):
        print(f"[serve]   validation mode={val['mode']} "
              f"oov={val['oov_indices']} negative={val['negative_indices']}")


if __name__ == "__main__":
    main()
