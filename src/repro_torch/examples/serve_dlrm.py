"""Serve a DLRM through the engine's request-level API.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_dlrm [--queries 1024] [--device cpu]

Each query goes in as ``server.submit_request(payload)`` and comes back
through a Future-style handle holding *that query's* logit; the engine's
``Batcher`` microbatches behind the scenes (plan -> pack -> fused executor
-> owner-sharded rejoin over four plan cores, each a partition of one
launch on the card).  The latency tracker reports the P99/throughput
trade-off per placement plan — the card-scale analogue of the paper's
Table I measurement loop.

A second phase runs the same engine under a *bounded* admission queue with
``shed-oldest`` + per-request deadlines: a burst larger than the queue is
submitted without pumping, the stalest requests are shed with typed
``QueueFull``/``DeadlineExceeded`` errors, and the accounting identity
served + shed + rejected == submitted is checked per run.
"""
import argparse

import numpy as np
import torch

from repro_torch.data.distributions import Fixed, Uniform, Zipf
from repro_torch.data.synthetic import ctr_batch
from repro_torch.data.workloads import small_workload
from repro_torch.device import resolve_device
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.models.dlrm import DLRMConfig, forward_packed, init_dlrm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    wl = small_workload(batch=args.batch)
    cfg = DLRMConfig(arch="dlrm-serve", workload=wl, embed_dim=16)
    params = init_dlrm(cfg, torch.Generator().manual_seed(0), device)

    for planner in ("symmetric", "asymmetric"):
        config = EngineConfig(
            planner=planner,
            mesh_shape=(1, 4),
            hardware_options={"l1_bytes": 8192},
            max_batch=args.batch,
            max_wait_s=0.001,
        )
        engine = InferenceEngine.build(params["tables"], wl, config, device=device)

        def make_step(eng):
            @torch.no_grad()
            def step(payloads):
                dense = torch.as_tensor(np.stack([p["dense"] for p in payloads]),
                                        device=device)
                idx = eng.broadcast_batch(np.stack([p["indices"] for p in payloads], axis=1))
                return forward_packed(cfg, eng.bag, eng.packed, params,
                                      {"dense": dense, "indices": idx},
                                      use_kernels="fused", reduce_mode="sparse").cpu().numpy()

            return step

        # (B,) logits -> one scalar per handle
        srv = engine.serve(make_step=make_step,
                           split_fn=lambda out, n: list(out))
        rng = np.random.default_rng(0)
        handles = []
        for dist in (Uniform(), Zipf(1.05, hot_prefix=False), Fixed()):
            for i in range(args.queries // args.batch):
                b = ctr_batch(rng, wl, distribution=dist, batch=args.batch)
                handles += [
                    srv.submit_request(
                        {"dense": b["dense"][q], "indices": b["indices"][:, q]}
                    )
                    for q in range(args.batch)
                ]
                srv.pump()
            srv.drain()
        assert all(h.done() for h in handles)
        logit0 = float(handles[0].result())
        s = srv.stats()
        print(f"{planner:>10s}: p50={s['p50_us']:8.0f}us p99={s['p99_us']:8.0f}us "
              f"tps={s['tps']:8.0f} hedged={s['hedged_batches']} "
              f"logit[0]={logit0:+.3f}")

    overload_demo(engine, wl, cfg, args)
    print("OK")


def overload_demo(engine, wl, cfg, args):
    """Overload the bounded queue: shed-oldest + deadlines keep the served
    tail fresh and every submitted request is accounted for."""
    from repro_torch.serving.server import DeadlineExceeded, QueueFull, ServingError

    srv = engine.serve(
        max_batch=args.batch,
        max_queue=2 * args.batch,  # bound the admission queue
        admission="shed-oldest",
        deadline_s=30.0,  # generous: only the queue bound sheds here
    )
    rng = np.random.default_rng(1)
    b = ctr_batch(rng, wl, distribution=Zipf(1.05, hot_prefix=False),
                  batch=args.batch)
    # a 4x-overload burst submitted without a single pump: only the newest
    # 2*batch survive in the queue, the rest are shed oldest-first
    handles = [
        srv.submit_request(
            {"dense": b["dense"][q % args.batch],
             "indices": b["indices"][:, q % args.batch]}
        )
        for q in range(4 * args.batch)
    ]
    unserved = srv.drain()
    assert not unserved, f"{len(unserved)} queries left unserved"
    assert all(h.wait(timeout=0.0) for h in handles)  # all resolved
    outcomes = {"served": 0, "shed": 0}
    for h in handles:
        try:
            h.result()
            outcomes["served"] += 1
        except (QueueFull, DeadlineExceeded):
            outcomes["shed"] += 1
        except ServingError:
            raise  # batch failures would be a real bug here
    s = srv.stats()
    assert s["submitted"] == s["served"] + s["shed"] + s["rejected"] + s["failed"]
    assert outcomes["served"] == s["served"] and outcomes["shed"] == s["shed"]
    print(f"  overload: submitted={s['submitted']} served={s['served']} "
          f"shed={s['shed']} (queue bound {srv.max_queue}, "
          f"policy {srv.admission})")


if __name__ == "__main__":
    main()
