"""Layer initializers shared by the port's models (this slice: the DLRM's)."""
from __future__ import annotations

import math

import torch

__all__ = ["dense_init"]


def dense_init(
    generator: torch.Generator | None, shape, in_axis: int = 0, dtype=torch.float32
) -> torch.Tensor:
    """Truncated-normal (±2σ) weights scaled by ``1/sqrt(fan_in)``, the
    JAX package's initializer; ``shape[in_axis]`` is the fan-in."""
    fan_in = shape[in_axis]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)
