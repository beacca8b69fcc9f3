"""Capacity-based top-k routed MoE (GShard/Mixtral style), the JAX
package's formulation in PyTorch.

Dispatch and combine are dense one-hot einsums over fixed-size token groups;
tokens beyond an expert's capacity are dropped.  Capacity positions come
from an f32 cumulative sum of the routing one-hots in ``(G, T*k, E)``
layout, as in the JAX package, so that the same routing gives the same
positions.  ``constrain(name, x)`` is the JAX package's hook for sharding
annotations, called where it calls it: on the dispatched tokens ``xe``,
the expert hidden ``h`` and the expert outputs ``ye``.  A sharded LM on a
``DeviceMesh`` passes ``transformer._moe_constrain``'s redistributes (the
expert-parallel all-to-alls); without one (``None``) nothing is called.

The JAX package can store each expert as ``virtual_factor`` slices of its
ff columns (``E * v`` virtual experts, routed alike); the port keeps whole
experts, and :func:`merge_virtual_experts` carries such parameters across.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, rows

__all__ = ["MoESpec", "merge_virtual_experts", "moe_apply", "moe_init"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """The JAX package's spec without its expert-parallel knobs
    (``virtual_factor``, ``tokens_per_call``): they split work over a
    device mesh, and on one device both stay at their defaults."""

    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    group_size: int = 2048  # tokens per routing group


def moe_init(generator: torch.Generator | None, d_model: int, spec: MoESpec) -> dict:
    e, f = spec.n_experts, spec.d_ff
    return {
        "router": dense_init(generator, (d_model, e)),
        "wi": dense_init(generator, (e, d_model, f), in_axis=1),
        "wg": dense_init(generator, (e, d_model, f), in_axis=1),
        "wo": dense_init(generator, (e, f, d_model), in_axis=1),
    }


def merge_virtual_experts(params: Params, n_experts: int) -> dict:
    """The JAX package's MoE parameters with ``E * v`` virtual experts of
    ``f / v`` columns each, as ``E`` whole experts: virtual expert
    ``e * v + j`` holds columns ``j * f / v`` to ``(j + 1) * f / v`` of
    expert ``e``, so ``wi`` and ``wg`` concatenate along their last axis
    and ``wo`` along axis 1.  The gate is elementwise in the ff columns and
    the slices' outputs sum through ``wo``, so the merged layer computes
    what the split one does (to f32 reduction order).  ``v`` is read from
    the shapes; ``v = 1`` returns the tensors as they are."""
    ev, d, fv = params["wi"].shape
    if ev % n_experts:
        raise ValueError(f"{ev} virtual experts do not split into {n_experts} experts")
    v = ev // n_experts

    def cols(w):  # (E*v, d, f/v) -> (E, d, f)
        return w.reshape(n_experts, v, d, fv).permute(0, 2, 1, 3).reshape(n_experts, d, v * fv)

    return {"router": params["router"], "wi": cols(params["wi"]), "wg": cols(params["wg"]),
            "wo": params["wo"].reshape(n_experts, v * fv, d)}


def moe_apply(
    params: Params, x: torch.Tensor, spec: MoESpec, constrain=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., T, d) -> (out (..., T, d), aux_loss scalar); ``constrain``
    as the module docstring says."""
    lead, (t, d) = x.shape[:-2], x.shape[-2:]
    xf = rows(x).reshape(-1, t, d)  # (G, T, d): groups = flattened leading dims
    if t > spec.group_size and t % spec.group_size == 0:
        xf = xf.reshape(-1, spec.group_size, d)
    out, aux = _moe_groups(params, xf, spec, constrain)
    return out.reshape(*lead, t, d), aux


def _moe_groups(params: Params, xf: torch.Tensor, spec: MoESpec, constrain=None):
    """Route and compute one batch of token groups (G, gs, d)."""
    dt = xf.dtype
    g, t = xf.shape[0], xf.shape[-2]
    e, k = spec.n_experts, spec.top_k
    cap = max(int(math.ceil(t * k / e * spec.capacity_factor)), 1)

    logits = (xf @ params["router"].to(dt)).float()  # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # (G, T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch): e * sum_e f_e * p_e
    me = probs.mean(dim=1)
    ce = F.one_hot(gate_idx[..., 0], e).float().mean(dim=1)
    aux = (me * ce).sum(dim=-1).mean() * e

    onehot = F.one_hot(gate_idx, e).float()  # (G, T, k, E)
    # position of each (token, slot) in its expert's buffer: f32 cumsum
    pos = torch.cumsum(onehot.reshape(g, t * k, e), dim=1).reshape(g, t, k, e)
    pos = pos * onehot - 1.0  # -1 where not routed
    keep = (pos >= 0) & (pos < cap)
    pos = torch.clamp(pos, 0, cap - 1)
    cap_oh = F.one_hot(pos.to(torch.int64), cap).to(dt)
    routed = (onehot * keep).to(dt)
    dispatch = (routed[..., None] * cap_oh).sum(dim=2)  # (G, T, E, C)
    combine = ((gate_vals.to(dt)[..., None] * routed)[..., None] * cap_oh).sum(dim=2)

    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(dt), xf)  # (G, E, C, d)
    if constrain is not None:
        xe = constrain("xe", xe)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, params["wg"].to(dt)))
    h = h * torch.einsum("gecd,edf->gecf", xe, params["wi"].to(dt))
    if constrain is not None:
        h = constrain("h", h)
    ye = torch.einsum("gecf,efd->gecd", h, params["wo"].to(dt))  # (G, E, C, d)
    if constrain is not None:
        ye = constrain("ye", ye)
    out = torch.einsum("gtec,gecd->gtd", combine.to(dt), ye)
    return out, aux.float()

