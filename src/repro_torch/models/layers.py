"""Model primitives shared by the port's towers: params are mappings of
tensors (``dict`` or ``nn.ParameterDict``), as the JAX package's are nested
dicts of arrays.

This module holds what the scenario towers run: the JAX package's
initializer, RMS norm, grouped-query attention in its non-causal, rope-free,
uncached form (the transformer tower's; other cases raise), and the SwiGLU
MLP.  Each formula is written as the JAX package writes it, reductions in
the same order, so that the CPU comparison against it is close; no fused
attention kernel is used.  KV caches, masks and rotary embeddings belong to
the LM side.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

__all__ = [
    "AttnSpec",
    "Params",
    "attention",
    "attn_init",
    "dense_init",
    "mlp_apply",
    "mlp_init",
    "rms_norm",
]

Params = Mapping[str, Any]


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


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale=None, eps: float = 1e-6) -> torch.Tensor:
    """The mean square in f32, the normalized activation in ``x``'s dtype;
    ``scale`` is zero-initialized (the output is scaled by ``1 + scale``)."""
    dt = x.dtype
    msq = torch.einsum("...d,...d->...", x.float(), x.float()) / x.shape[-1]
    r = torch.rsqrt(msq + eps)[..., None].to(dt)
    y = x * r
    if scale is not None:
        y = y * (1.0 + scale).to(dt)
    return y


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """The JAX package's attention spec, field for field (so a tower's spec
    reads alike in both); :func:`attention` runs the towers' case only."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None  # sliding-window size (None = full)
    qk_norm: bool = False
    rope: str | None = "std"  # None | "std" | "partial" | "mrope"
    rope_base: float = 10000.0
    rotary_frac: float = 1.0
    mrope_sections: tuple[int, ...] | None = None
    attn_block: int = 1024  # KV-chunk size of the online softmax


def attn_init(generator: torch.Generator | None, d_model: int, spec: AttnSpec) -> dict:
    h, kv, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    return {
        "wq": dense_init(generator, (d_model, h * dh)),
        "wk": dense_init(generator, (d_model, kv * dh)),
        "wv": dense_init(generator, (d_model, kv * dh)),
        "wo": dense_init(generator, (h * dh, d_model)),
    }


_NEG = -1e30


def _online_softmax_attn(q, k, v, *, block: int) -> torch.Tensor:
    """Flash-style attention over KV blocks, as the JAX package's
    ``lax.scan``: a running max, normalizer and accumulator per query;
    only the padding of the last block is masked.
    q (B, Sq, KV, G, dh), k/v (B, Skv, KV, dh) -> (B, Sq, KV*G, dh)."""
    b, sq, kvh, g, dh = q.shape
    skv = k.shape[1]
    block = min(block, skv)
    pad = (-skv) % block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nblk = (skv + pad) // block
    k = k.reshape(b, nblk, block, kvh, dh).permute(1, 0, 2, 3, 4)
    v = v.reshape(b, nblk, block, kvh, dh).permute(1, 0, 2, 3, 4)
    qf = (q * (1.0 / math.sqrt(dh))).float()
    m = torch.full((b, kvh, g, sq), _NEG, device=q.device)
    l = torch.zeros((b, kvh, g, sq), device=q.device)
    acc = torch.zeros((b, kvh, g, sq, dh), device=q.device)
    for blk_i in range(nblk):
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, k[blk_i].float())
        if pad:
            kv_pos = blk_i * block + torch.arange(block, device=q.device)
            s = torch.where(kv_pos < skv, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, v[blk_i].float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)  # (B, KV, G, Sq, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, kvh * g, dh)


def attention(params: Params, x: torch.Tensor, spec: AttnSpec):
    """GQA self-attention, x (B, Sq, d) -> (out (B, Sq, d), None); the
    ``None`` stands where the JAX package returns a KV cache.  The port
    runs the case its towers use: non-causal, no window, no qk-norm, no
    rotary embedding, at least two query positions (the JAX package's
    online-softmax path)."""
    if spec.causal or spec.window is not None or spec.qk_norm or spec.rope is not None:
        raise NotImplementedError(
            "the port's attention is non-causal, window-free, qk-norm-free and rope-free")
    b, sq, _ = x.shape
    if sq < 2:
        raise NotImplementedError("the port's attention takes at least two query positions")
    h, kvh, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(b, sq, kvh, h // kvh, dh)
    k = (x @ params["wk"].to(dt)).reshape(b, sq, kvh, dh)
    v = (x @ params["wv"].to(dt)).reshape(b, sq, kvh, dh)
    out = _online_softmax_attn(q, k, v, block=spec.attn_block)
    out = out.reshape(b, sq, h * dh).to(dt)
    return out @ params["wo"].to(dt), None


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_init(generator: torch.Generator | None, d_model: int, d_ff: int) -> dict:
    """The SwiGLU MLP's weights (the JAX package's ``kind="swiglu"``)."""
    return {
        "wi": dense_init(generator, (d_model, d_ff)),
        "wg": dense_init(generator, (d_model, d_ff)),
        "wo": dense_init(generator, (d_ff, d_model)),
    }


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x wg) * (x wi)) wo``."""
    dt = x.dtype
    h = F.silu(x @ params["wg"].to(dt)) * (x @ params["wi"].to(dt))
    return h @ params["wo"].to(dt)
