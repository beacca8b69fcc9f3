"""Resumable checkpoints of trees of tensors (numpy files, the JAX package's
layout).

Layout::

    <dir>/step_00000120/
        manifest.json      # tree structure, shapes, dtypes, step
        leaf_00000.npy ... # one file per leaf, in repro_torch.tree's order
        _COMPLETE          # commit marker (atomic finish)

* ``save`` is atomic (tmp dir + rename) and optionally asynchronous: the
  leaves are copied to the host before the writer thread starts, so the
  caller may go on updating its tensors;
* ``restore`` validates the manifest and each leaf's shape, and places each
  leaf on its placement's device, or as its ``DTensor`` placement on a
  device mesh (``shardings``, the elastic restart), or on the device of the
  leaf it replaces;
* a state placed on a device mesh (``DTensor`` leaves) is saved whole:
  every rank calls ``save`` (each leaf's ``full_tensor()`` is a
  collective), rank 0 alone writes, in the same format, so one process or
  another mesh restores it;
* ``latest_step``/``cleanup`` implement keep-last-N retention;
* a torn checkpoint (no ``_COMPLETE``) is ignored by restore; the loop's
  crash recovery (training/loop.py) relies on this.

bf16 leaves are stored as their 16-bit patterns (numpy has no bfloat16);
the manifest's ``dtype`` names the tensor's own dtype.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten, is_dtensor, unflatten

__all__ = ["cleanup", "latest_step", "restore", "save", "steps"]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(x) -> np.ndarray:
    if is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    return np.array(x)


def save(
    directory: str | Path,
    step: int,
    tree: Any,
    *,
    keep: int = 3,
    async_: bool = False,
) -> Path:
    """Write ``tree`` as checkpoint ``step``; with ``async_`` the files are
    written by a thread (returned path exists once it has finished).  With
    ``DTensor`` leaves every rank of their mesh calls this, and only rank 0
    writes (the others return the path without waiting for it)."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"

    flat, treedef = flatten(tree)
    dtypes = [_dtype_name(x.dtype) if isinstance(x, torch.Tensor) else str(np.asarray(x).dtype)
              for x in flat]
    host_leaves = [_to_host(x) for x in flat]  # copied before any thread starts
    if any(is_dtensor(x) for x in flat) and torch.distributed.get_rank() != 0:
        return final
    directory.mkdir(parents=True, exist_ok=True)

    def _write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "treedef": str(treedef), "leaves": []}
        for i, (arr, dtype) in enumerate(zip(host_leaves, dtypes)):
            np.save(tmp / f"leaf_{i:05d}.npy", arr)
            manifest["leaves"].append(
                {"shape": list(arr.shape), "dtype": dtype, "nbytes": int(arr.nbytes)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "_COMPLETE").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        cleanup(directory, keep=keep)

    if async_:
        threading.Thread(target=_write, daemon=True).start()
        return final
    _write()
    return final


def steps(directory: str | Path) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                  if (p / "_COMPLETE").exists())


def latest_step(directory: str | Path) -> int | None:
    s = steps(directory)
    return s[-1] if s else None


def restore(directory: str | Path, step: int | None, tree_like: Any, *,
            shardings: Any = None) -> tuple[Any, int]:
    """Load checkpoint ``step`` (or the latest complete one) into the
    structure of ``tree_like``.  Each leaf goes where its entry in
    ``shardings`` (the same structure, as
    :func:`repro_torch.sharding.with_sharding` builds it: the elastic
    restart, structure from ``param_struct``, placement from the new
    topology) says: a ``DTensor`` entry (a device mesh; ``meta`` or not)
    makes it a ``DTensor`` of that mesh and those placements, on this
    rank's device; a :class:`~repro_torch.sharding.Placement`, its
    ``device``.  Without ``shardings``, to the device of the ``tree_like``
    leaf it replaces, or the CPU for a ``meta`` or non-tensor leaf.
    Raises ``FileNotFoundError`` without a complete checkpoint and
    ``ValueError`` on a leaf count or shape that differs."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    d = directory / f"step_{step:08d}"
    if not (d / "_COMPLETE").exists():
        raise FileNotFoundError(f"checkpoint {d} incomplete")
    manifest = json.loads((d / "manifest.json").read_text())
    like_leaves, treedef = flatten(tree_like)
    if len(manifest["leaves"]) != len(like_leaves):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"the tree {len(like_leaves)}")
    placements = [None] * len(like_leaves)
    if shardings is not None:
        placements, shard_def = flatten(shardings)
        if shard_def != treedef:
            raise ValueError("shardings do not have the structure of tree_like")
    loaded = []
    for i, (meta, like, placed) in enumerate(zip(manifest["leaves"], like_leaves, placements)):
        arr = np.load(d / f"leaf_{i:05d}.npy")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != expected "
                             f"{tuple(like.shape)}")
        t = torch.from_numpy(arr)
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if is_dtensor(placed):
            from torch.distributed.tensor import distribute_tensor

            from repro_torch.device import resolve_device

            dev = resolve_device(placed.device_mesh.device_type)
            loaded.append(distribute_tensor(t.to(dev), placed.device_mesh, placed.placements))
            continue
        if placed is not None:
            device = placed.device
        elif isinstance(like, torch.Tensor) and like.device.type != "meta":
            device = like.device
        else:
            device = "cpu"
        loaded.append(t.to(device))
    return unflatten(treedef, loaded), step


def cleanup(directory: str | Path, keep: int = 3) -> None:
    for s in steps(directory)[:-keep]:
        shutil.rmtree(Path(directory) / f"step_{s:08d}", ignore_errors=True)
