"""The benchmark's own arithmetic: the card's published peaks, the least
time of a piece of work, the operations and bytes of a DLRM step and of its
pooled lookup, and the profiler session that reads the card's own time.

``HBM_BYTES_PER_S``, ``F32_OPS_PER_S``, :func:`bound` and
:func:`profile_calls` are frozen copies of ``chip_smoke.py`` at commit
b2230fa; the counts are this benchmark's, from shapes and the batch alone,
independent of the plan and the kernels.
"""
from __future__ import annotations

import numpy as np

__all__ = ["F32_OPS_PER_S", "HBM_BYTES_PER_S", "bound", "distinct_rows", "lookup_bytes",
           "mlp_dims", "profile_calls", "step_bytes", "step_flops"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time on the card in ms: bytes over the HBM rate against
    operations over the f32 peak, and which of the two bounds it."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def mlp_dims(cfg: dict) -> tuple[list[int], list[int]]:
    """The bottom and top MLPs' layer widths of a DLRM configuration."""
    n_int = len(cfg["rows"]) + 1
    e = cfg["embed_dim"]
    bottom = [cfg["n_dense"], *cfg["bottom_mlp"], e]
    top = [e + n_int * (n_int - 1) // 2, *cfg["top_mlp"], 1]
    return bottom, top


def step_flops(cfg: dict, batch: int) -> int:
    """Multiply-adds (two operations each) of one DLRM step: both MLPs'
    matrix products and the interaction's ``(N+1) x (N+1)`` Gram product
    of width E, a sample each.  Biases, ReLUs and the pooling's adds are
    left out."""
    bottom, top = mlp_dims(cfg)
    mlp = sum(a * b for dims in (bottom, top) for a, b in zip(dims[:-1], dims[1:]))
    n_int = len(cfg["rows"]) + 1
    return 2 * batch * (mlp + n_int * n_int * cfg["embed_dim"])


def distinct_rows(indices: np.ndarray) -> int:
    """Distinct rows a batch reads, summed over its tables (``-1`` padding
    left out)."""
    total = 0
    for t in indices:
        ids = t[t >= 0]
        total += int(np.unique(ids).size)
    return total


def lookup_bytes(cfg: dict, indices: np.ndarray) -> int:
    """Least bytes of the pooled lookup of one batch: its int32 indices
    read, each distinct row read once, and the pooled ``(N, B, E)`` f32
    output written."""
    n, b, _ = indices.shape
    row = cfg["embed_dim"] * np.dtype(cfg["dtype"]).itemsize
    return indices.size * 4 + distinct_rows(indices) * row + n * b * cfg["embed_dim"] * 4


def step_bytes(cfg: dict, indices: np.ndarray) -> int:
    """Least bytes of one DLRM step: the indices, the f32 dense inputs, the
    f32 MLP weights and biases, each distinct embedding row once, and the
    f32 logits."""
    _, b, _ = indices.shape
    bottom, top = mlp_dims(cfg)
    params = sum(a * c + c for dims in (bottom, top) for a, c in zip(dims[:-1], dims[1:]))
    row = cfg["embed_dim"] * np.dtype(cfg["dtype"]).itemsize
    return (indices.size * 4 + b * cfg["n_dense"] * 4 + params * 4
            + distinct_rows(indices) * row + b * 4)


# the markers around the calls of each profiler session: a spin kernel of
# ATen's that nothing else in the port launches.  A session on the card can
# lose its first records, so a long marker (~5 ms) and eight short ones
# open a session and one closes it, and a session counts only when its
# recorded markers bracket the calls
OPEN_CYCLES = (10_000_000,) + (1_000,) * 8
MARK = "spin_kernel"


def device_events(prof):
    """The device's records of a profiler session (kernels, copies, sets),
    without user annotations."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def profile_calls(fn, calls: int = 10, sessions: int = 3) -> dict:
    """The card's own time for ``fn``: ``torch.profiler`` device time of the
    CUDA kernels (and copies) it launches on the current stream, per call,
    summed over them, the number of such launches per call, and the time of
    each by name.  A session whose recorded markers do not bracket the
    calls, whose launches are no multiple of the calls, or that records no
    device time, is run again, up to ``sessions`` in all; then
    ``device_ms`` is ``None``."""
    import torch

    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    ours = []
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for cycles in OPEN_CYCLES:
                torch.cuda._sleep(cycles)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1_000)
            stream.synchronize()
        events = device_events(prof)
        marks = [e.time_range.start for e in events if MARK in e.name]
        ids = {e.device_resource_id for e in events if MARK in e.name}
        ours = [e for e in events if e.device_resource_id in ids and MARK not in e.name]
        starts = [e.time_range.start for e in ours]
        if (len(ids) == 1 and ours and len(ours) % calls == 0
                and min(marks) <= min(starts) <= max(starts) <= max(marks)
                and sum(e.self_device_time_total for e in ours) > 0):
            break
        ours = []
    kernels: dict = {}
    for e in ours:
        kernels[e.name] = kernels.get(e.name, 0.0) + e.self_device_time_total / calls / 1e3
    return {"device_ms": sum(kernels.values()) if kernels else None,
            "launches_per_call": len(ours) / calls,
            "kernels_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1]))}
