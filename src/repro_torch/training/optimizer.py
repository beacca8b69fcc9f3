"""Optimizers over trees of tensors (no ``torch.optim``): SGD, Adagrad (the
DLRM standard) and AdamW, as the JAX package writes them.

``update(grads, state, params)`` returns new trees and leaves its arguments
alone; it runs under ``torch.no_grad()``.  State mirrors the parameter tree,
and every walk over leaves follows :mod:`repro_torch.tree`'s order (the JAX
package's), so AdamW's global norm sums the leaves in the same order.

Parameters placed on a device mesh (``DTensor`` leaves,
:func:`repro_torch.sharding.with_sharding`) get moments placed as they
are (``opt_pspecs``: the moments mirror the parameters), the step counter
and the scalars of the update count as replicated, and AdamW's global norm
sums each leaf's square over its own placement into one replicated
scalar.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.tree import is_dtensor, leaves, plain_as_replicated, tree_map

__all__ = ["Optimizer", "adagrad", "adamw", "sgd"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)
    name: str = "opt"


def _no_grad_on_mesh(update):
    """``update`` under ``torch.no_grad()`` and, where the parameters are
    ``DTensor`` objects, ``implicit_replication()`` (the counter and the
    bias corrections are plain tensors)."""
    @functools.wraps(update)
    def run(grads, state, params):
        on_mesh = any(is_dtensor(p) for p in leaves(params))
        with torch.no_grad(), plain_as_replicated() if on_mesh else contextlib.nullcontext():
            return update(grads, state, params)

    return run


def _step0(params) -> torch.Tensor:
    """The int32 step counter, on the parameters' device."""
    first = leaves(params)
    device = first[0].device if first else None
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: float = 1e-2, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return {"mu": tree_map(torch.zeros_like, params), "step": _step0(params)}
        return {"step": _step0(params)}

    @_no_grad_on_mesh
    def update(grads, state, params):
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            new = tree_map(lambda p, m: p - lr * m, params, mu)
            return new, {"mu": mu, "step": state["step"] + 1}
        new = tree_map(lambda p, g: p - lr * g, params, grads)
        return new, {"step": state["step"] + 1}

    return Optimizer(init, update, "sgd")


def adagrad(lr: float = 1e-2, eps: float = 1e-10) -> Optimizer:
    """The classic DLRM embedding optimizer (per-coordinate adaptive)."""

    def init(params):
        return {"acc": tree_map(torch.zeros_like, params), "step": _step0(params)}

    @_no_grad_on_mesh
    def update(grads, state, params):
        acc = tree_map(lambda a, g: a + g * g, state["acc"], grads)
        new = tree_map(lambda p, g, a: p - lr * g / (torch.sqrt(a) + eps), params, grads, acc)
        return new, {"acc": acc, "step": state["step"] + 1}

    return Optimizer(init, update, "adagrad")


def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float | None = 1.0,
    moments_dtype: torch.dtype | None = None,
) -> Optimizer:
    """AdamW with global-norm clipping; ``moments_dtype`` (e.g.
    ``torch.bfloat16``) stores the moments narrower, the moment math still
    runs in f32."""

    def init(params):
        def z(p):
            return torch.zeros_like(p, dtype=moments_dtype or p.dtype)

        return {"m": tree_map(z, params), "v": tree_map(z, params), "step": _step0(params)}

    @_no_grad_on_mesh
    def update(grads, state, params):
        step = state["step"] + 1
        if grad_clip is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(grads)))
            scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

        def mom(m_, g):
            return (b1 * m_.float() + (1 - b1) * g.float()).to(m_.dtype)

        def vel(v_, g):
            g32 = g.float()
            return (b2 * v_.float() + (1 - b2) * g32 * g32).to(v_.dtype)

        m = tree_map(mom, state["m"], grads)
        v = tree_map(vel, state["v"], grads)
        stepf = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

        def upd(p, m_, v_):
            u = (m_.float() / bc1) / (torch.sqrt(v_.float() / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new = tree_map(upd, params, m, v)
        return new, {"m": m, "step": step, "v": v}

    return Optimizer(init, update, "adamw")
