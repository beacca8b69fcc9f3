"""The readings the check's limits are set from, for one cell, in one
process: the program on a run of seeds, then the control (the program
serving bf16 tables, the nearest precision below the configuration's f32)
on more, each through a short window at the cell's own load.  Prints one
JSON line a run and a summary line last.  The benchmark's own runs never
run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        --seconds 2 --first-seed 1000003
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")

CONTROL = {"dtype": "bfloat16"}
NUMBERS = ("pooled_max_abs_err", "logit_max_abs_err")


def readings(cell, seeds, seconds, overrides, device) -> list:
    import torch

    from portbench import harness

    out = []
    for seed in seeds:
        try:
            res = harness.run_cell(cell, seed, seconds, False, device=device,
                                   engine_overrides=overrides)
            rec = {"seed": seed, "control": bool(overrides), "correct": res["correct"],
                   "attempted": res["attempted"], "failed": res["failed"],
                   **{k: res["checks"][k]["value"] for k in NUMBERS},
                   "compared_batches": res["info"]["compared_batches"]}
        except Exception as exc:  # a control that crashes has failed; record it
            rec = {"seed": seed, "control": bool(overrides), "error": f"{type(exc).__name__}: {exc}"}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None, device="cuda") -> dict:
    from portbench import spec

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=1_000_003)
    args = p.parse_args(argv)
    cell = spec.load_cell(ROOT, args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds + args.control_seeds)]
    prog = readings(cell, seeds[:args.seeds], args.seconds, None, device)
    ctrl = readings(cell, seeds[args.seeds:], args.seconds, CONTROL, device)
    summary = {"cell": cell.name, "limits": cell.config["limits"]}
    for k in NUMBERS:
        summary[k] = {
            "program_max": max((r[k] for r in prog if k in r), default=None),
            "control_min": min((r[k] for r in ctrl if k in r), default=None),
        }
    summary["program_correct"] = sum(bool(r.get("correct")) for r in prog)
    summary["control_correct"] = sum(bool(r.get("correct")) for r in ctrl)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
