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
``--set access=full --set tuning=sweep`` serves with batch dedup and the
hot-row cache after a block-size sweep on the device; the plan report then
prints the access-reduction and tuning records.

As in the JAX package's CLI, the asymmetric planner gets
``shard_rocks=True`` unless the config sets it (big tables are row-sharded
instead of falling back to the symmetric group); ``--set
'planner_options={"shard_rocks": false}'`` restores the paper's LIF
fallback.  ``--set layout=dense`` serves the legacy stacked-slot layout.

``--preset <name>`` loads a shipped deployment recipe
(:mod:`repro_torch.configs.presets`: ``taobao-zipf12``,
``huawei-dayparted``, ``tenrec-hotset``) as the base config and fills
``--workload``/``--distribution`` unless they are given.  ``--drift`` is a
phase schedule spec (``flip`` = uniform -> zipf-1.2 -> hot-set flip, or
``zipf:1.2@80,hotset:0.01:0.9:-1@64``) routed through the request-level
server; a day-parted traffic spec (``huawei-25mb``) and ``drift=replan``
take the same loop, which prints each replan's batch and the integrity
counters::

    PYTHONPATH=src python -m repro_torch.launch.serve --preset taobao-zipf12 \
        --drift zipf:1.2@80,hotset:0.01:0.9:-1@64 --queries 73728

Under ``torchrun`` each plan core runs on its own card (one process per
card, NCCL between them; ``--device cpu`` runs gloo between CPU
processes), the plan's core count defaulting to the number of ranks::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --workload taobao --batch 8192 --queries 16384 --distribution uniform

Every rank builds the engine from the same config and seed and keeps its
core's slice on its card; rank 0 serves, prints the report (each rank's
chunk bytes, the rejoin's modeled bytes and, after serving, the bytes it
handed the collectives) and returns the record, while the others run
each batch's lookup with it until it is done, then exit 0.  Any rank's
exception ends the run with a non-zero exit.  The presets and
``--drift``/``--set drift=replan`` run there too: a replan's shadow build
runs on every rank (each packs the whole plan on the host and keeps its
core's slice), the swap point compares the ranks' packs, the integrity
sweeps and heals check each rank's own slice, and the report prints the
replans and integrity events from rank 0, as one card does::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --preset taobao-zipf12 --drift zipf:1.2@80,hotset:0.01:0.9:-1@64 \
        --queries 73728

On the CPU (``--device cpu``, gloo) the degraded mode's fallback serves
across the ranks as well; on the card there is none.

Legacy flag spellings (``--planner``, ``--layout``, ``--kernels``,
``--reduce``, ``--autotune``, ``--dedup``, ``--cache``, ``--replan``,
``--replan-threshold``) still work: each maps onto the corresponding
``EngineConfig`` field and emits a ``DeprecationWarning`` naming its
replacement (see :func:`config_from_args`).
"""
from __future__ import annotations

import argparse
import json
import time
import warnings
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
    # --workload / --distribution default to None sentinels so a --preset
    # can fill them; without one they resolve to "smoke" / "real"
    p.add_argument("--workload", default=None)
    p.add_argument("--batch", type=int, default=None,
                   help="serving batch size (default: the config's "
                        "max_batch, 256)")
    p.add_argument("--queries", type=int, default=2048)
    p.add_argument("--distribution", default=None,
                   help="query stream: uniform | real | fixed | all | "
                        "zipf:<a> | hotset:<frac>:<mass>[:<off>] | "
                        "<workload preset> (default: real)")
    p.add_argument("--preset", default=None,
                   help="shipped preset pack (workload + traffic + "
                        "EngineConfig) from repro_torch/configs/presets, "
                        "e.g. taobao-zipf12; explicit flags still override")
    p.add_argument("--drift", default=None,
                   help="drift schedule spec routed through the Server, "
                        "e.g. 'flip' or 'uniform@8,zipf:1.2@8,"
                        "hotset:0.01:0.9:-1@8'")
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
    # legacy flag spellings: deprecated, mapped onto EngineConfig with a
    # DeprecationWarning each (None/False defaults detect explicit use)
    p.add_argument("--planner", default=None,
                   choices=["baseline", "symmetric", "asymmetric"],
                   help="[deprecated: --set planner=...]")
    p.add_argument("--layout", default=None, choices=["ragged", "dense"],
                   help="[deprecated: --set layout=...]")
    p.add_argument("--kernels", default=None, choices=["fused", "xla"],
                   help="[deprecated: --set use_kernels=...]")
    p.add_argument("--reduce", default=None,
                   choices=["sparse", "psum", "ring"],
                   help="[deprecated: --set reduce_mode=...]")
    p.add_argument("--autotune", action="store_true",
                   help="[deprecated: --set tuning=sweep]")
    p.add_argument("--dedup", action="store_true",
                   help="[deprecated: --set access=dedup|full]")
    p.add_argument("--cache", action="store_true",
                   help="[deprecated: --set access=cache|full]")
    p.add_argument("--replan", action="store_true",
                   help="[deprecated: --set drift=replan]")
    p.add_argument("--replan-threshold", type=float, default=None,
                   help="[deprecated: --set "
                        "drift_options='{\"threshold\":...}']")
    return p


def _warn_legacy(flag: str, replacement: str) -> None:
    warnings.warn(
        f"--{flag} is a deprecated spelling; set EngineConfig.{replacement} "
        f"(via --config / --set) instead",
        DeprecationWarning,
        stacklevel=4,  # the caller of config_from_args
    )


# the serve CLI's historical drift-trigger cadence, filled into
# drift_options however replanning was asked for
_CLI_DRIFT_DEFAULTS = {"check_every": 4, "patience": 2, "cooldown": 8}


def _apply_legacy_flags(args, config: EngineConfig) -> None:
    """Map the deprecated flag spellings onto ``config``, one
    :class:`DeprecationWarning` per flag given."""
    for flag, field in (("planner", "planner"), ("layout", "layout"),
                        ("kernels", "use_kernels"), ("reduce", "reduce_mode")):
        value = getattr(args, flag)
        if value is not None:
            _warn_legacy(flag, field)
            setattr(config, field, value)
    if args.autotune:
        _warn_legacy("autotune", "tuning='sweep'")
        config.tuning = "sweep"
    if args.dedup or args.cache:
        dedup = args.dedup or config.access in ("dedup", "full")
        cache = args.cache or config.access in ("cache", "full")
        if args.dedup:
            _warn_legacy("dedup", "access='dedup' (or 'full')")
        if args.cache:
            _warn_legacy("cache", "access='cache' (or 'full')")
        config.access = {(True, True): "full", (True, False): "dedup",
                         (False, True): "cache"}[(dedup, cache)]
    if args.replan:
        _warn_legacy("replan", "drift='replan'")
        config.drift = "replan"
    if args.replan_threshold is not None:
        # the threshold alone records the option but does not arm replanning
        _warn_legacy("replan-threshold", "drift_options['threshold']")
        config.drift_options["threshold"] = args.replan_threshold


def config_from_args(args) -> EngineConfig:
    """Resolve the CLI namespace into one :class:`EngineConfig`, as the JAX
    package's CLI resolves it.

    Precedence: ``--preset`` / ``--config`` base (mutually exclusive, else
    defaults) < legacy flags (each with a :class:`DeprecationWarning`) <
    ``--batch`` < ``--set`` overrides.  A preset also fills
    ``args.workload`` / ``args.distribution`` unless those flags were given.
    Also bakes in the serve CLI's historical choices: ``shard_rocks=True``
    for the asymmetric planner and the drift-trigger cadence.
    """
    preset = None
    if getattr(args, "preset", None):
        if args.config:
            raise SystemExit("--preset and --config are mutually exclusive")
        from repro_torch.configs.presets import load_preset

        preset = load_preset(args.preset)
    if preset is not None:
        config = EngineConfig.from_dict(preset["config"])
    elif args.config:
        config = EngineConfig.load(args.config)
    else:
        config = EngineConfig()
    # explicit flag > preset > historical default; main() reads the
    # resolved values back off the namespace
    if args.workload is None:
        args.workload = preset["workload"] if preset else "smoke"
    if args.distribution is None:
        args.distribution = (preset.get("distribution") if preset else None) or "real"
    _apply_legacy_flags(args, config)
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
    if config.drift == "replan":
        for k, v in _CLI_DRIFT_DEFAULTS.items():
            config.drift_options.setdefault(k, v)
    # the query stream doubles as the pricing distribution unless the
    # config pins its own ("all" streams start from the uniform leg)
    if config.distribution is None and args.distribution:
        config.distribution = ("uniform" if args.distribution == "all"
                               else args.distribution)
    if config.planner == "asymmetric":
        config.planner_options.setdefault("shard_rocks", True)
    config.validate()
    return config


def _job_mesh(device: str):
    """The device mesh of a ``torch.distributed`` job (a process group
    already started, or ``torchrun``'s environment), else ``None``."""
    import os

    import torch.distributed as dist

    if not (dist.is_initialized() or "WORLD_SIZE" in os.environ):
        return None
    from repro_torch.launch.mesh import init_card_mesh

    return init_card_mesh(device_type=device)


def main(argv=None) -> dict:
    """Serve ``--queries`` requests in batches of ``max_batch`` and print the
    plan report and per-distribution latency (or, under a drift schedule or
    ``drift=replan``, the drift loop's latency and replans).  Returns what a
    caller needs to check the run: the engine, the DLRM config and
    parameters, each traffic label's server stats, the last server, the
    serving wall time, the logits of every request the last server served,
    and the last batch submitted (its inputs and the logits of the requests
    of it that were served).

    In a ``torch.distributed`` job that holds on rank 0; every other rank
    returns ``{"engine", "rank", "followed"}`` (the lookups it ran) once
    rank 0 closes the engine, which it does on returning.  Every rank may
    then run more lookups together (:meth:`InferenceEngine.lookup_stages`)."""
    args = build_parser().parse_args(argv)
    config = config_from_args(args)  # also resolves --preset into args
    from repro_torch.data.workloads import WORKLOADS

    if args.workload not in ["smoke", *WORKLOADS]:
        raise SystemExit(f"unknown workload {args.workload!r}")
    batch = config.max_batch  # precedence: --config < --batch < --set
    mesh = _job_mesh(args.device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    if args.save_config and lead:
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

    # size "flip"-style default phases to a third of the run so every phase
    # is visited (explicit "@N" specs override per phase)
    schedule = (
        dist_lib.parse_drift(args.drift, phase_batches=max(n_batches // 3, 1))
        if args.drift else None
    )
    resolved = _resolve_dists(args.distribution)[0][1]
    if schedule is None and isinstance(resolved, dist_lib.DriftSchedule):
        # a day-parted traffic spec (e.g. huawei-25mb) routes through the
        # drift serving loop like an explicit --drift spec
        schedule = resolved
    # a schedule prices the initial plan under its phase 0 (explicit freqs,
    # like the drift engine's measured rebuilds); otherwise the engine
    # prices under config.distribution
    freqs0 = dist_lib.workload_probs(wl, schedule.at(0)) if schedule is not None else None
    dist0 = schedule.at(0) if schedule else resolved

    def make_step(engine):
        """One serving step over request payloads: the full DLRM forward on
        the engine's packed embeddings.  Re-invoked on every drift hot-swap
        and heal."""

        def step(payloads):
            dense = torch.as_tensor(np.stack([q["dense"] for q in payloads]), device=device)
            # on a device mesh: rank 0 sends the indices to the other ranks
            idx = engine.broadcast_batch(np.stack([q["indices"] for q in payloads], axis=1))
            logits = forward_packed(
                cfg, engine.bag, engine.packed, params,
                {"dense": dense, "indices": idx},
                mesh=engine.mesh,
                use_kernels=engine._use_kernels,
                reduce_mode=engine.config.reduce_mode,
            )
            return logits.cpu().numpy()

        return step

    t0 = time.perf_counter()
    engine = InferenceEngine.build(params["tables"], wl, config, device=device, freqs=freqs0,
                                   mesh=mesh)
    build_s = time.perf_counter() - t0
    if not lead:
        return {"engine": engine, "rank": engine.rank, "followed": engine.follow()}
    try:
        for line in engine.plan_report().splitlines():
            print(f"[serve] {line}")
        print(f"[serve] built in {build_s:.2f}s on {device}")

        # (B,) logits -> one scalar per request handle
        split = lambda out, n: [out[i] for i in range(n)]  # noqa: E731
        result = {"engine": engine, "cfg": cfg, "params": params, "stats": {},
                  "build_s": build_s, "n_batches": n_batches}
        if schedule is not None or config.drift != "none":
            schedule = schedule or dist_lib.DriftSchedule([(1, dist0)], cycle=True)
            return _serve(result, [("drift", schedule)], engine, make_step, split, wl,
                          batch, n_batches, drift=True)
        return _serve(result, _resolve_dists(args.distribution), engine, make_step, split,
                      wl, batch, n_batches, drift=False)
    finally:
        engine.close()


def _serve(result, legs, engine, make_step, split, wl, batch, n_batches, *, drift):
    """Serve ``n_batches`` batches of each traffic leg through a fresh
    engine-built server.  A drift leg's distribution is a schedule read at
    each batch index; its server replans per the config's drift policy."""
    from repro_torch.data import distributions as dist_lib

    from repro_torch.core.partition import COLLECTIVE_BYTES

    n_dense = result["cfg"].n_dense
    rng = np.random.default_rng(0)
    for label, dist in legs:
        srv = engine.serve(make_step=make_step, split_fn=split)
        COLLECTIVE_BYTES.clear()
        every = []
        t0 = time.perf_counter()
        for b in range(n_batches):
            idx = dist_lib.sample_workload(rng, wl, dist.at(b) if drift else dist, batch)
            dense = rng.standard_normal((batch, n_dense)).astype(np.float32)
            handles = [
                srv.submit_request({"dense": dense[q], "indices": idx[:, q]})
                for q in range(batch)
            ]
            every += handles
            srv.pump()
        wall_s = time.perf_counter() - t0
        unserved = srv.drain()
        if unserved:
            print(f"[serve] WARNING: {len(unserved)} queries left unserved")
        s = srv.stats()
        result["stats"][label] = s
        result["server"] = srv
        result["serve_wall_s"] = wall_s
        result["served_logits"] = _served(every)
        result["last"] = {"indices": idx, "dense": dense, "logits": _served(handles)}
        line = (f"[serve] dist={label:8s} p50={_fmt_us(s['p50_us'])} "
                f"p99={_fmt_us(s['p99_us'])} tps={s['tps']:9.0f} "
                f"wall/batch={wall_s / n_batches * 1e3:.2f}ms ({n_batches} batches)")
        if "replan" in s:
            r = s["replan"]
            line += (f" replans={r['replans']} parity_failures="
                     f"{r['parity_failures']} last_drift={r['last_drift']:.3f}")
        print(line)
        if engine.ranks is not None:
            _print_collectives(engine, srv.total_batches, result)
        _print_robustness(s)
        for ev in s.get("replan", {}).get("events", []):
            print(f"[serve]   replan@batch={ev['batch']} drift={ev['drift']:.3f} "
                  f"parity_ok={ev['parity_ok']}")
    return result


def _print_collectives(engine, batches: int, result: dict) -> None:
    """The bytes the rejoin handed the collectives per served batch, beside
    what ``core/traffic.py`` models for the same rejoin."""
    from repro_torch.core.partition import COLLECTIVE_BYTES

    batches = max(batches, 1)
    measured = {op: n / batches for op, n in sorted(COLLECTIVE_BYTES.items())}
    result["collective_bytes"] = measured
    modeled = engine.ranks["rejoin_modeled"]
    key = {"sparse": "sparse_bytes", "psum": "psum_bytes", "ring": "ring_bytes"}
    print(f"[serve]   collectives per batch (all ranks): "
          + " ".join(f"{op}={n:,.0f}B" for op, n in measured.items())
          + f"; rejoin modeled {modeled[key[engine.config.reduce_mode]]:,}B")


def _served(handles) -> np.ndarray:
    """The results of the handles that were served (not shed, rejected or
    failed), in submission order."""
    return np.asarray([h.result() for h in handles if h.done() and h._error is None],
                      np.float32)


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
    integ = s.get("integrity") or {}
    if integ.get("corruptions_detected") or integ.get("poisoned_batches"):
        print(f"[serve]   integrity corruptions={integ['corruptions_detected']} "
              f"heals={integ['heals']} "
              f"quarantined={integ['quarantined_regions']} "
              f"poisoned_batches={integ['poisoned_batches']}")


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
