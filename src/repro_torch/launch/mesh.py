"""The production and debug mesh shapes, as the JAX package's constructors
give them, and the device mesh of the cards a ``torchrun`` job holds.

:class:`Mesh` is a shape: axis names and their sizes, with no devices
behind it.  A :class:`ShardCtx
<repro_torch.models.transformer.ShardCtx>` reads the model axis's size
from it (the vocab shards of the embedding) and the data axes' sizes (the
batch-split knobs), and :mod:`repro_torch.sharding` and the dry-run divide
each leaf's bytes by it.  Single pod: 16 x 16 = 256 chips (data x model);
multi-pod: 2 pods x 256 = 512 chips with a leading "pod" axis.

:func:`init_card_mesh` is the device mesh the partitioned lookup and the
sharded LMs run on across cards (the JAX package's ``("data", "model")``
device mesh): a ``torch.distributed``
:class:`~torch.distributed.device_mesh.DeviceMesh` over one process per
card, NCCL between cards, or gloo between CPU processes::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --workload taobao

A ``ShardCtx`` over it places every LM leaf by the sharding rules
(:func:`repro_torch.sharding.with_sharding`).  Both kinds of mesh answer
:func:`axis_sizes`/:func:`axis_size`.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os

__all__ = ["Mesh", "all_gather_cat", "axis_rank", "axis_size", "axis_sizes", "init_card_mesh",
           "is_device_mesh", "local_rank", "make_debug_mesh", "make_production_mesh"]


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


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK`` as ``torchrun`` sets
    it, else its rank in the process group (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def init_card_mesh(
    data: int = 1,
    model: int | None = None,
    *,
    device_type: str = "cuda",
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    timeout_s: float = 300.0,
):
    """A ``(data, model)`` :class:`~torch.distributed.device_mesh.DeviceMesh`
    with dims ``("data", "model")`` over the job's processes.

    Without a process group, one is started: ``rank``/``world_size``
    default to ``RANK``/``WORLD_SIZE`` (what ``torchrun`` sets) and
    ``init_method`` to ``env://``; an existing group (the caller's) is used
    as it is.  ``device_type="cuda"`` binds this process to card
    ``LOCAL_RANK`` before any collective (NCCL refuses two ranks on one
    card) and raises when there are fewer cards than ranks on the host;
    ``"cpu"`` runs gloo.  ``timeout_s`` bounds every collective, so a dead
    rank fails the others instead of hanging them.  ``model`` defaults to
    ``world_size // data``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.mesh import MeshShapeError

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}: use 'cuda' or 'cpu'")
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        world_size = (int(os.environ.get("WORLD_SIZE", 1))
                      if world_size is None else world_size)
        if init_method is None:
            init_method = "env://"
            os.environ.setdefault("MASTER_ADDR", "localhost")
            os.environ.setdefault("MASTER_PORT", "29500")
    else:
        rank, world_size = dist.get_rank(), dist.get_world_size()
    device_id = None
    if device_type == "cuda":
        lr = int(os.environ.get("LOCAL_RANK", rank))
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if lr >= n_cards:
            raise RuntimeError(
                f"rank {rank} needs card {lr} but this host has {n_cards} CUDA "
                f"card(s): start at most {n_cards} ranks per host, or pass "
                "device_type='cpu' for gloo"
            )
        torch.cuda.set_device(lr)
        device_id = torch.device("cuda", lr)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", init_method=init_method,
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s), device_id=device_id,
        )
    model = world_size // data if model is None else model
    if data < 1 or model < 1 or data * model != world_size:
        raise MeshShapeError(
            f"a ({data}, {model}) mesh needs {data * model} ranks, the job has "
            f"{world_size}"
        )
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` (ranks behind its axes), not a
    :class:`Mesh` shape."""
    return not isinstance(mesh, Mesh) and hasattr(mesh, "mesh_dim_names")


def axis_sizes(mesh) -> dict[str, int]:
    """Each axis name of ``mesh`` mapped to its size, for a :class:`Mesh`
    (its ``shape``) and for a ``DeviceMesh`` (its ``mesh_dim_names``)."""
    if is_device_mesh(mesh):
        return {n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)}
    return dict(mesh.shape)


def axis_size(mesh, axis: str) -> int:
    """The size of one named axis of a :class:`Mesh` or a ``DeviceMesh``."""
    return axis_sizes(mesh)[axis]


def axis_rank(mesh, axis: str) -> int:
    """This process's coordinate along one named dim of a ``DeviceMesh``."""
    return int(mesh.get_local_rank(axis))


def all_gather_cat(x, group=None):
    """The ranks' ``x`` of ``group`` (``None``: the whole job) concatenated
    along dim 0, in rank order (gloo takes no stacked output)."""
    import torch.distributed as dist

    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x.contiguous(), group=group)
    return out
