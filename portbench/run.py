"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; the program (``src/repro_torch``) builds
its kernels into ``build/repro_torch/`` there, so only a cell's first run
in a checkout compiles.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], root=ROOT, t0=T0))
