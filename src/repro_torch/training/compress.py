"""Gradient compression with error feedback.

int8 per-leaf-scale quantization of gradients before the data-parallel
reduction, with residual error feedback (Seide et al. / Karimireddy et al.):
the quantization error is added back to the next step's gradient, preserving
convergence.  On the wire this cuts data-parallel gradient traffic 4x against
f32; here the quantize/dequantize pair runs in the train step.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten

__all__ = ["compress_grads", "dequantize", "init_error_state", "quantize", "wire_bytes"]


def init_error_state(params: Any) -> Any:
    return tree_map(torch.zeros_like, params)


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: Any, error: Any) -> tuple[Any, Any]:
    """``(dequantized grads as they would arrive after the reduction, new
    error)``: the optimizer sees what a real deployment would apply, and the
    residual feeds the next step."""
    flat, treedef = flatten(grads)
    deq, err = [], []
    for g, e in zip(flat, leaves(error)):
        corrected = g + e
        d = dequantize(*quantize(corrected))
        deq.append(d)
        err.append(corrected - d)
    return unflatten(treedef, deq), unflatten(treedef, err)


def wire_bytes(params: Any) -> tuple[int, int]:
    """(f32 bytes, int8 bytes) a data-parallel gradient reduction would move."""
    flat = leaves(params)
    n = sum(int(x.numel()) for x in flat)
    return 4 * n, n + 4 * len(flat)
