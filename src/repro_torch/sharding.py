"""Logical sharding rules: parameter, optimizer, batch and cache specs, the
JAX package's rules returning its axis tuples.

Scheme (MaxText-style TP + ZeRO-3):

* ``model`` axis: tensor parallelism over heads, ff, expert-ff and vocab;
  the embedding table is vocab(row)-sharded (the paper's chunked table
  placement) and looked up vocab-parallel;
* ``fsdp`` axes (``data``, plus ``pod`` when multi-pod): parameters,
  gradients and optimizer moments are also sharded over the batch axes on
  a non-TP dimension;
* batch dims shard over (pod, data); KV caches and SSM states shard their
  sequence or head dims over ``model``.

On a ``torch.distributed`` ``DeviceMesh``
(:func:`repro_torch.launch.mesh.init_card_mesh`) :func:`with_sharding`
places each leaf by its spec as a ``DTensor`` (:func:`placements`: an
entry naming a mesh axis shards that tensor dim over it, every other axis
replicates), and each rank holds :func:`per_device_bytes` of the tree
(:func:`local_bytes`).  On a :class:`~repro_torch.launch.mesh.Mesh`
shape, one card holds the whole model and the specs place nothing: they
are the record of where each leaf would live, and the dry-run divides each
leaf's bytes by them.  The port keeps each
layer as its own entry of ``params["layers"]`` (no leading layer axis), so
a layer leaf's spec is the JAX package's without its leading ``None``; the
rules go by leaf name and trailing rank, so this falls out.  The MoE expert
axis keeps the JAX package's ``"data"`` spec although the port keeps whole
experts (see ROADMAP C, "Whole experts").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import axis_sizes, is_device_mesh
from repro_torch.tree import is_dtensor

__all__ = [
    "P",
    "Placement",
    "axes_for",
    "batch_pspecs",
    "cache_pspecs",
    "dp_size",
    "is_dtensor",
    "local_bytes",
    "map_with_path",
    "opt_pspecs",
    "param_pspecs",
    "param_spec",
    "per_device_bytes",
    "placements",
    "spec_shards",
    "with_sharding",
]


class P:
    """A partition spec: one entry per dim, each ``None``, an axis name or a
    tuple of axis names (a 1-tuple reads as its name, as in the JAX
    package's ``PartitionSpec``).  A leaf of a tree, not a node."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes)

    def __iter__(self):
        return iter(self.axes)

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.axes == other.axes

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"P{self.axes!r}"


def map_with_path(fn, tree: Any, path: tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, ``path``
    the names of the keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _at(tree: Any, path: tuple[str, ...]) -> Any:
    for n in path:
        tree = tree[int(n)] if isinstance(tree, (list, tuple)) else tree[n]
    return tree


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else 0


def axes_for(multi_pod: bool) -> dict:
    return {
        "model": "model",
        "fsdp": ("pod", "data") if multi_pod else ("data",),
        "dp": ("pod", "data") if multi_pod else ("data",),
    }


def param_spec(path_names: tuple[str, ...], ndim: int, ax) -> P:
    """The rule for one parameter leaf, by name and rank: written for the
    trailing dims, padded with ``None`` on the left."""
    name = path_names[-1]
    in_moe = "moe" in path_names
    model, fsdp = ax["model"], ax["fsdp"]

    def pad(spec: tuple) -> P:
        return P(*([None] * (ndim - len(spec)) + list(spec)))

    if name == "embed":
        return P(model, None)  # the paper's row-chunked table placement
    if name == "lm_head":
        return P(fsdp, model)
    if name == "pos_emb":
        return P(model, None)
    if name in ("wq", "wk", "wv"):
        return pad((fsdp, model))
    if name == "wo" and in_moe:
        return pad(("data", model, None))  # (E, ff, d): EP + TP
    if name == "wo":  # attention output (h*dh, d) or the mlp down-projection (ff, d)
        return pad((model, fsdp))
    if name in ("wi", "wg") and in_moe:
        return pad(("data", None, model))  # (E, d, ff): EP + TP
    if name in ("wi", "wg"):
        return pad((fsdp, model))
    if name == "router":
        return pad((fsdp, None))
    if name == "in_proj":
        return pad((fsdp, model))
    if name == "out_proj":
        return pad((model, fsdp))
    if name == "proj_out":  # zamba2 shared-block output projection (2d, d)
        return pad((model, fsdp))
    if name == "conv_w":
        return pad((None, model))
    if name == "conv_b":
        return pad((model,))
    if name == "norm_scale":
        return pad((model,))
    if name in ("A_log", "D", "dt_bias"):
        return pad(())
    if name == "w":  # dlrm mlp
        return pad((fsdp, model)) if ndim >= 2 else pad(())
    # norms (scale/bias/q_norm/k_norm), biases, scalars: replicated
    return P(*([None] * ndim))


def param_pspecs(params_struct: Any, multi_pod: bool) -> Any:
    ax = axes_for(multi_pod)
    return map_with_path(lambda path, leaf: param_spec(path, _ndim(leaf), ax), params_struct)


def opt_pspecs(opt_struct: Any, params_specs: Any) -> Any:
    """Optimizer state mirrors the parameters' specs (moments like
    params); anything else (the step) is replicated."""

    def build(names, leaf):
        if names and names[0] in ("m", "v", "mu", "acc"):
            return _at(params_specs, names[1:])
        return P(*([None] * _ndim(leaf)))

    return map_with_path(build, opt_struct)


def dp_size(mesh) -> int:
    return math.prod(size for name, size in axis_sizes(mesh).items() if name != "model")


def batch_pspecs(cfg: ArchConfig, shape: ShapeCfg, multi_pod: bool, n_dp: int = 16) -> dict:
    ax = axes_for(multi_pod)
    dp = ax["dp"]
    # the batch is replicated when it cannot divide the dp axes (long_500k b=1)
    bspec = dp if shape.batch % n_dp == 0 else None
    out = {}
    if shape.kind in ("train", "prefill"):
        if cfg.input_kind == "embeds":
            out["embeds"] = P(bspec, None, None)
            out["positions"] = P(None, bspec, None)
        elif cfg.input_kind == "frames_tokens":
            out["frames"] = P(bspec, None, None)
            out["tokens"] = P(bspec, None)
        else:
            out["tokens"] = P(bspec, None)
        if shape.kind == "train":
            out["labels"] = P(bspec, None)
        return out
    if cfg.input_kind == "embeds":
        out["embeds"] = P(bspec, None, None)
        out["positions"] = P(None, bspec, None)
    else:
        out["tokens"] = P(bspec, None)
    return out


def cache_pspecs(cfg: ArchConfig, shape: ShapeCfg, multi_pod: bool, n_dp: int = 16) -> dict:
    """The serve cache's specs (its leaves keep the leading layer axis in
    both packages)."""
    ax = axes_for(multi_pod)
    dp, model = ax["dp"], ax["model"]
    b = dp if shape.batch % n_dp == 0 else None
    kv = P(None, b, model, None, None)  # sequence-sharded cache
    out: dict[str, P] = {"pos": P()}
    if cfg.family in ("dense", "moe", "vlm"):
        out.update(k=kv, v=kv)
    elif cfg.family == "ssm":
        out.update(conv=P(None, b, model, None), ssm=P(None, b, model, None, None))
    elif cfg.family == "hybrid":
        out.update(conv=P(None, b, model, None), ssm=P(None, b, model, None, None),
                   shared_k=kv, shared_v=kv)
    elif cfg.family == "encdec":
        out.update(k=kv, v=kv, ck=kv, cv=kv)
    return out


def spec_shards(spec: P, mesh) -> int:
    """How many pieces a leaf with ``spec`` is cut into on ``mesh``: the
    product of the sizes of every axis its entries name."""
    sizes = axis_sizes(mesh)
    n = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n *= sizes[a]
    return n


def per_device_bytes(tree: Any, specs: Any, mesh) -> float:
    """The bytes one device of ``mesh`` holds of ``tree``: each tensor
    leaf's bytes over its spec's :func:`spec_shards`, summed."""
    total = 0.0

    def add(path, leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size() / spec_shards(_at(specs, path), mesh)

    map_with_path(add, tree)
    return total


def local_bytes(tree: Any) -> int:
    """The bytes this rank holds of ``tree``: a ``DTensor`` leaf's local
    shard, any other tensor whole."""
    total = 0

    def add(path, leaf):
        nonlocal total
        if is_dtensor(leaf):
            leaf = leaf.to_local()
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()

    map_with_path(add, tree)
    return total


def placements(spec: P, mesh) -> list:
    """``spec`` as ``DTensor`` placements on the ``DeviceMesh`` ``mesh``,
    one per mesh dim: ``Shard(d)`` on each mesh dim that entry ``d`` names
    (alone or in a tuple), ``Replicate()`` on every other."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is None:
                continue
            if a not in names:
                raise ValueError(f"{spec} names axis {a!r}, the mesh has {names}")
            out[names.index(a)] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives: on one card, ``device``; ``spec`` and ``mesh``
    record where it would live on the mesh."""

    device: torch.device
    spec: P
    mesh: Any = None


def with_sharding(mesh, tree: Any, specs: Any, device=None) -> Any:
    """``tree`` placed by ``specs`` (its structure, a :class:`P` per leaf).

    On a ``DeviceMesh``: each tensor leaf as a ``DTensor`` on this rank's
    device (``distribute_tensor``: every rank passes the same values, rank
    0's are scattered), sharded by :func:`placements`; a ``meta`` leaf
    stays on ``meta`` with its placements (the elastic restore's
    target).  On a :class:`~repro_torch.launch.mesh.Mesh` shape: a
    :class:`Placement` for each leaf, the device (``None`` = the card) plus
    its spec for the record."""
    if not is_device_mesh(mesh):
        dev = resolve_device(device)
        return map_with_path(lambda path, leaf: Placement(dev, _at(specs, path), mesh), tree)
    from torch.distributed.tensor import distribute_tensor

    dev = resolve_device(mesh.device_type)

    def place(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        x = leaf.detach() if leaf.is_meta else leaf.detach().to(dev)
        return distribute_tensor(x, mesh, placements(_at(specs, path), mesh))

    return map_with_path(place, tree)
