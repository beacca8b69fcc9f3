"""Trees of tensors: nested dicts, lists and tuples, flattened in the JAX
package's leaf order (dict keys sorted, sequences in order; ``None`` is an
empty node).

The optimizers, the checkpoint and the train steps walk parameters and
optimizer state through these functions, so a leaf's number is the one the
JAX package's ``jax.tree_util.tree_flatten`` gives the same tree.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["flatten", "leaves", "tree_map", "unflatten", "value_and_grad"]


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
    not read gets a zero gradient, as under ``jax.grad``."""
    flat, treedef = flatten(tree)
    with torch.enable_grad():
        live = [x.detach().requires_grad_() for x in flat]
        out = fn(unflatten(treedef, live), *args)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(live, grads)]
    out = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, out)
    return out, unflatten(treedef, grads)
