"""The production and debug mesh shapes, as the JAX package's constructors
give them.

One card holds the whole model, so a mesh here is a shape: axis names and
their sizes, with no devices behind it.  A :class:`ShardCtx
<repro_torch.models.transformer.ShardCtx>` reads the model axis's size
from it (the vocab shards of the embedding) and the data axes' sizes (the
batch-split knobs), and :mod:`repro_torch.sharding` and the dry-run divide
each leaf's bytes by it.  Single pod: 16 x 16 = 256 chips (data x model);
multi-pod: 2 pods x 256 = 512 chips with a leading "pod" axis.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["Mesh", "make_debug_mesh", "make_production_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``shape`` maps each name to its size (the JAX
    package's ``Mesh.shape``)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} and {self.axis_sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_debug_mesh(*, multi_pod: bool = False) -> Mesh:
    """The same axes at 8 or 16 chips, for tests."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 2, 4))
    return Mesh(("data", "model"), (2, 4))
