"""The port's train CLI (``python -m repro_torch.launch.train``) on the CPU:
the DLRM and a dense LM train, checkpoint and resume as the JAX package's
CLI does, and the flags are the JAX package's plus ``--device``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.launch import train

SRC = Path(__file__).resolve().parent.parent / "src"


def test_dlrm_trains_and_checkpoints(tmp_path, capsys):
    out = train.main(["--arch", "dlrm", "--steps", "20", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path)])
    assert out["start_step"] == 0 and len(out["losses"]) == 20
    assert out["final_loss"] < out["first_loss"]
    assert ckpt.steps(tmp_path) == [19]
    assert "[train] done" in capsys.readouterr().out


def test_resume_from_the_latest_checkpoint(tmp_path):
    argv = ["--arch", "dlrm", "--device", "cpu", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2", "--batch", "16"]
    first = train.main(argv + ["--steps", "6"])
    assert ckpt.steps(tmp_path) == [2, 4, 5]
    again = train.main(argv + ["--steps", "9"])
    assert again["start_step"] == 6 and len(again["losses"]) == 3
    whole = train.main(["--arch", "dlrm", "--device", "cpu", "--batch", "16",
                        "--checkpoint-dir", str(tmp_path / "whole"), "--steps", "9"])
    assert first["losses"] == whole["losses"][:6]
    for a, b in zip(again["params"]["tables"], whole["params"]["tables"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmo-1b"])
def test_dense_lm_trains(tmp_path, arch, capsys):
    out = train.main(["--arch", arch, "--steps", "4", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path), "--batch", "4", "--seq", "32"])
    assert len(out["losses"]) == 4 and all(l == l for l in out["losses"])
    assert "[train] done" in capsys.readouterr().out
    assert len(out["params"]["layers"]) == 2  # the SMOKE config


def test_flags_are_the_reference_flags():
    """Every flag of the JAX package's CLI parses, ``--smoke`` stays on, and
    the default device is the card."""
    args = train.build_parser().parse_args(
        ["--arch", "dlrm", "--steps", "3", "--smoke", "--batch", "8", "--seq", "16",
         "--lr", "0.01", "--checkpoint-dir", "x", "--checkpoint-every", "2",
         "--grad-compression"])
    assert args.smoke and args.grad_compression and args.device == "cuda"
    assert train.build_parser().parse_args([]).smoke
    assert train.build_parser().parse_args([]).arch == "olmo-1b"


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "dlrm", "--steps", "1", "--checkpoint-dir", str(tmp_path)])


def test_module_entry_point(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "dlrm", "--steps", "3",
         "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck")],
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True, text=True,
        timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "[train] done" in out.stdout and "on cpu" in out.stdout
