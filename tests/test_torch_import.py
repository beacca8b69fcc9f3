"""The port stands alone: it imports without JAX and without the JAX
package, and its CUDA sources are the kernels' only implementation."""
import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"

_CHECK = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith(("jax.", "repro.")) or k == "repro")
print(len(mods), bad)
assert not bad, bad
"""


def test_import_every_submodule_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 25


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|import repro$|from repro import)", re.M)
    files = list(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    assert len(files) > 25
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_every_kernel_has_a_cuda_source_and_no_library_stand_in():
    from repro_torch.kernels import build

    for name in build.SOURCES:
        src = (PORT / "csrc" / f"{name}.cu").read_text()
        assert "Replaces the Pallas kernel src/repro/kernels/" in src
        assert "What bounds it on this card" in src
    for f in PORT.rglob("*.py"):
        text = f.read_text()
        for banned in ("embedding_bag(", "torch.compile", "import triton"):
            if banned == "embedding_bag(":
                assert "F.embedding_bag(" not in text and "functional.embedding_bag(" not in text, f
            else:
                assert banned not in text, f
