"""Trees of tensors: nested dicts, lists and tuples, flattened in the JAX
package's leaf order (dict keys sorted, sequences in order; ``None`` is an
empty node).

The optimizers, the checkpoint and the train steps walk parameters and
optimizer state through these functions, so a leaf's number is the one the
JAX package's ``jax.tree_util.tree_flatten`` gives the same tree.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch

__all__ = ["flatten", "is_dtensor", "leaves", "plain_as_replicated", "tree_map", "unflatten",
           "value_and_grad"]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed`` ``DTensor`` (a leaf placed
    on a device mesh)."""
    if not isinstance(x, torch.Tensor) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


# how deep plain_as_replicated() is nested: it mirrors DTensor's own flag,
# which is global to the process, not to a caller
_REPLICATED_DEPTH = [0]


@contextlib.contextmanager
def plain_as_replicated():
    """``DTensor``'s ``implicit_replication()`` (a plain tensor met by a
    ``DTensor`` op counts as replicated), re-entrant: that context clears
    its global flag on every exit, so here only the outermost exit does
    (the model nests it: a step, its forward, a rematerialised layer)."""
    if _REPLICATED_DEPTH[0]:
        _REPLICATED_DEPTH[0] += 1
        try:
            yield
        finally:
            _REPLICATED_DEPTH[0] -= 1
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        _REPLICATED_DEPTH[0] = 1
        try:
            yield
        finally:
            _REPLICATED_DEPTH[0] = 0


class _Leaf:
    __slots__ = ()

    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


def flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)``: the leaves in order and the tree's structure
    with each leaf replaced by a marker (``str(treedef)`` prints it)."""
    out: list = []

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if x is None:
            return None
        out.append(x)
        return _LEAF

    return out, walk(tree)


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def unflatten(treedef: Any, new_leaves) -> Any:
    """The tree ``treedef`` describes, holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(d):
        if isinstance(d, dict):
            return {k: build(v) for k, v in d.items()}
        if isinstance(d, (list, tuple)):
            return type(d)(build(v) for v in d)
        if d is None:
            return None
        return next(it)

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure)."""
    flat, treedef = flatten(tree)
    others = []
    for r in rest:
        r_flat, r_def = flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {r_def}")
        others.append(r_flat)
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def value_and_grad(fn: Callable, tree: Any, *args, has_aux: bool = False):
    """``(fn(tree, *args), grads)`` with ``grads`` shaped like ``tree``: the
    leaves are detached copies that require grad, so ``tree`` itself is not
    touched.  ``fn`` returns a scalar loss, or ``(loss, aux)`` with
    ``has_aux``; the returned values are detached.  A leaf the loss does
    not read gets a zero gradient, as under ``jax.grad``.  A ``DTensor``
    leaf's gradient comes back with the leaf's placements: where autograd
    left it partial (a sum over the ranks of an axis that splits the batch
    still owed), that sum is made here, the data-parallel reduction."""
    flat, treedef = flatten(tree)
    with torch.enable_grad():
        live = [x.detach().requires_grad_() for x in flat]
        out = fn(unflatten(treedef, live), *args)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else _placed_as(g, x) for x, g in zip(live, grads)]
    out = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, out)
    return out, unflatten(treedef, grads)


def _placed_as(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``g`` with ``x``'s placements where both are ``DTensor`` objects."""
    if is_dtensor(x) and is_dtensor(g) and tuple(g.placements) != tuple(x.placements):
        return g.redistribute(x.device_mesh, x.placements)
    return g
