"""The port's twins of the example scripts (``repro_torch.examples``), run
with ``--device cpu`` at small arguments.

Where a script's output comes from numpy alone it is held against the JAX
package's: autoplan's every line against ``examples/autoplan.py`` run as it
is (a subprocess, ``PYTHONPATH=src``), and quickstart's plans (chunks and
predicted P99 per planner) against the same ``EngineConfig`` built by the
JAX package in a subprocess; quickstart's lookup against the dense oracle
within 1e-5.  ``examples/quickstart.py`` itself stops at its first lookup
under the installed jax (its symmetric group reaches the L1 Pallas kernel,
whose ``pl.load`` jax 0.9.0 removed), so its plan lines come from the
calls it makes before that lookup.  serve_dlrm, train_dlrm and lm_smoke
are held to the originals' own checks: the accounting identity, a falling
loss, a run resumed from a checkpoint, "OK".
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.examples import autoplan, lm_smoke, quickstart, serve_dlrm, train_dlrm

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
ENV = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")

_PLAN = re.compile(r"^\s*(\w+): +(\d+) chunks asym, +(\d+) sym \| predicted P99 +([\d.]+)us"
                   r" \| max err vs dense oracle (\S+)$")

_QUICKSTART_PLANS = textwrap.dedent("""
    import os
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    from repro import compat
    from repro.data.workloads import small_workload
    from repro.engine import EngineConfig, InferenceEngine

    wl = small_workload(batch=64)
    mesh = compat.make_mesh((2, 4), ("data", "model"))
    for planner in ("baseline", "symmetric", "asymmetric"):
        config = EngineConfig(planner=planner, mesh_shape=(1, 4),
                              hardware_options={"l1_bytes": 4096})
        engine = InferenceEngine.build(None, wl, config, mesh=mesh,
                                       rng=jax.random.PRNGKey(0))
        p99 = engine.stats()["predicted_p99_us"]
        print(f"{planner} {len(engine.plan.assignments)} "
              f"{len(engine.plan.symmetric_tables)} {p99:8.1f}")
""")


@pytest.fixture(autouse=True)
def one_thread():
    """The twins' torch work on one thread: the tier-1 run's workers share
    the machine's cores, and threads beyond them slow every process."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(capsys) -> list:
    return capsys.readouterr().out.splitlines()


def test_autoplan_prints_the_original_line_for_line(capsys):
    orig = subprocess.run([sys.executable, str(ROOT / "examples" / "autoplan.py")], env=ENV,
                          capture_output=True, text=True, timeout=100)
    assert orig.returncode == 0, orig.stderr[-3000:]
    autoplan.main(["--device", "cpu"])
    got = _lines(capsys)
    want = orig.stdout.splitlines()
    assert len(want) > 40 and got == want


def test_quickstart_plans_match_the_reference_and_the_oracle(capsys):
    ref = subprocess.run([sys.executable, "-c", _QUICKSTART_PLANS], env=ENV,
                         capture_output=True, text=True, timeout=100)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = [line.split() for line in ref.stdout.splitlines()]
    quickstart.main(["--device", "cpu"])
    lines = _lines(capsys)
    plans = [m.groups() for m in map(_PLAN.match, lines) if m]
    assert [[p, asym, sym, p99] for p, asym, sym, p99, _ in plans] == want
    for *_, err in plans:
        assert float(err) <= 1e-5
    assert lines[-1].startswith("OK")


def test_serve_dlrm_accounts_for_every_request(capsys):
    serve_dlrm.main(["--device", "cpu", "--queries", "128", "--batch", "32"])
    lines = _lines(capsys)
    served = [line.split()[0].rstrip(":") for line in lines if "p99=" in line]
    assert served == ["symmetric", "asymmetric"]
    m = re.search(r"overload: submitted=(\d+) served=(\d+) shed=(\d+)", "\n".join(lines))
    submitted, n_served, shed = map(int, m.groups())
    assert submitted == 4 * 32 and n_served + shed == submitted and shed > 0
    assert lines[-1] == "OK"


def test_train_dlrm_resumes_after_the_crash(tmp_path, capsys):
    # a checkpoint every 10 steps, the crash at step 20
    out = train_dlrm.main(["--device", "cpu", "--steps", "40", "--scale", "0.1", "--crash",
                           "--ckpt-dir", str(tmp_path)])
    lines = _lines(capsys)
    assert any(line.startswith("!! injected failure at step 20") for line in lines)
    assert "resumed at step 11" in lines and out["start_step"] == 11
    assert out["final_loss"] < out["first_loss"] and lines[-1] == "OK"


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x22b", "qwen2-vl-2b"])
def test_lm_smoke_trains_and_decodes(arch, capsys):
    losses = lm_smoke.main(["--device", "cpu", "--arch", arch, "--steps", "8"])
    lines = _lines(capsys)
    assert min(losses[3:]) < losses[0]
    tokens = [line for line in lines if line.startswith("greedy tokens:")]
    assert len(tokens) == 1 and len(json.loads(tokens[0].split(":", 1)[1])) == 8
    assert lines[-1] == "OK"


@pytest.mark.parametrize("module", [autoplan, quickstart, serve_dlrm, train_dlrm, lm_smoke])
def test_the_card_is_the_default_device(module):
    """Asked for nothing, a twin runs on the card; without one it raises
    rather than continuing on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])
