"""The port stands alone: it imports without JAX and without the JAX
package, and its CUDA sources are the kernels' only implementation."""
import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"
# kernels the port adds where the JAX package has no Pallas kernel: the
# join of the cores' partials, which the JAX package does with collectives
PORT_ONLY = {"embedding_rejoin"}

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

    assert PORT_ONLY <= set(build.SOURCES)
    for name in build.SOURCES:
        src = (PORT / "csrc" / f"{name}.cu").read_text()
        if name in PORT_ONLY:
            assert "Replaces no Pallas kernel." in src, name
        else:
            assert "Replaces the Pallas kernel src/repro/kernels/" in src, name
        assert "What bounds it on this card" in src
    for f in PORT.rglob("*.py"):
        text = f.read_text()
        for banned in ("embedding_bag(", "torch.compile", "import triton"):
            if banned == "embedding_bag(":
                assert "F.embedding_bag(" not in text and "functional.embedding_bag(" not in text, f
            else:
                assert banned not in text, f


_BLOCKED = """
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "repro") or name.startswith(("jax.", "repro.")):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
for name in ("repro_torch.training.loop", "repro_torch.training.optimizer",
             "repro_torch.training.compress", "repro_torch.checkpoint.checkpoint",
             "repro_torch.data.synthetic", "repro_torch.launch.train",
             "repro_torch.models.transformer", "repro_torch.configs.olmo_1b",
             "repro_torch.sharding", "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
             "repro_torch.sim.ascend", "repro_torch.sim.estimate"):
    assert name in mods, name
print(len(mods))
"""


def test_import_every_submodule_with_jax_blocked():
    """Every module of the port, the training side included, imports while
    any import of ``jax`` or of the JAX package raises."""
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED], env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 40
