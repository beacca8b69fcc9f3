"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by hand with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with :mod:`ctypes`
(no PyTorch headers in the build, so a library takes seconds, not minutes).
Libraries go to ``build/repro_torch/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``), named by a hash of their sources and flags, so
an edited source is rebuilt and a stale library is never loaded.  Nothing is
built at import time: the first wrapper call on a CUDA tensor builds what it
needs, and :func:`build` compiles every kernel at once, one ``nvcc`` process
per source, all started together.  In a job of one process per card,
:func:`build_ranks` has rank 0 compile while the other ranks wait, so that
W ranks do not each start every ``nvcc`` of the same sources.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "build", "build_dir", "build_ranks", "c_function", "check_launch",
           "dtype_code", "route", "sm_count", "stream_of"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("embedding_multi", "embedding_access", "embedding_dedup", "embedding_dense",
           "embedding_ub", "embedding_gm", "embedding_l1", "embedding_rejoin")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: install the CUDA toolkit or set CUDA_HOME"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, all in
    parallel.  Returns ``{name: {"seconds", "ptxas"}}`` for the ones built
    (``ptxas`` holds the compiler's register/shared-memory report)."""
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp, out, time.perf_counter(),
        )
    report = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def build_ranks(names=SOURCES) -> dict[str, dict]:
    """:func:`build` once for a ``torch.distributed`` job on one host: rank
    0 compiles what is missing while the other ranks wait at a barrier, and
    after it every rank finds the libraries built.  Every rank calls it at
    the same point (it is a collective); without a process group it is
    :func:`build`."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return build(names)
    # a failed build ends rank 0 here, and the others' barrier on its timeout
    report = build(names) if dist.get_rank() == 0 else {}
    dist.barrier()
    return report


def c_function(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of library ``name`` (built on first use),
    with its argument types set: pointers and the stream as ``c_void_p``.
    Looked up once; later calls return the same function object."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(_target(name)))
        fn = getattr(_libs[name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name, symbol] = fn
    return fn


# --------------------------------------------------------------------------
# launch plumbing shared by the kernel wrappers
# --------------------------------------------------------------------------


def dtype_code(dtype) -> int:
    """Table element type -> the kernels' dtype code (0 f32, 1 bf16, 2 f16)."""
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise TypeError(f"tables must be float32, bfloat16 or float16, got {dtype}")
    return codes[dtype]


def route(*tensors) -> str:
    """``"cpu"`` when every tensor lies on the CPU (the wrapper runs its plain
    version), ``"cuda"`` when all lie on one CUDA device (it launches its
    kernel); any other placement raises — there is no fallback."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors must share one device, got {sorted(map(str, devices))}")
    (device,) = devices
    if device.type in ("cpu", "cuda"):
        return device.type
    raise ValueError(f"no kernel and no plain version for device {device}")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
