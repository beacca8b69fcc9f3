"""Model primitives of the port's towers and LMs: params are mappings of
tensors (``dict`` or ``nn.ParameterDict``), as the JAX package's are
nested dicts of arrays.

The JAX package's initializers, RMS / layer / non-parametric norms, rotary
embeddings (standard, partial and M-RoPE sections), whisper's sinusoidal
positions, grouped-query attention with causal and sliding-window masks, a
linear or rolling KV cache, cross-attention (K/V from another sequence, or
given), query chunks and the online softmax over KV blocks, and the SwiGLU
and GELU MLPs.  Each formula is
written as the JAX package writes it, reductions in the same order, and
parameters are cast to the activations' dtype at each use, as there; no
fused attention kernel is used.  :func:`attention` is the scenario towers' entry (their
non-causal, rope-free, uncached case); :func:`lm_attention` is the LM's.

The LM layers also take ``DTensor`` activations and caches (a sharded LM
on a ``DeviceMesh``): matmuls take :func:`rows` and :func:`tp_weight`
(each weight whole over the data axes), heads stay whole
(:func:`whole_heads`), row-wise work and the attention core run on each
rank's local shard (:func:`per_shard`, :func:`_per_shard_heads`), and a
cache whose slots lie split over a mesh axis is written and read
rank-locally (:func:`_cache_attend_split`; a given cross-attention cache
is only read).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from repro_torch.tree import is_dtensor

__all__ = [
    "AttnSpec",
    "Params",
    "apply_rope",
    "attention",
    "attn_init",
    "dense_init",
    "embed_init",
    "layer_norm",
    "lm_attention",
    "make_norm",
    "mlp_apply",
    "mlp_init",
    "per_shard",
    "rows",
    "rms_norm",
    "rope_inv_freq",
    "sinusoidal_positions",
    "tp_weight",
    "whole_heads",
]

Params = Mapping[str, Any]


def dense_init(
    generator: torch.Generator | None, shape, in_axis: int = 0, dtype=torch.float32
) -> torch.Tensor:
    """Truncated-normal (±2σ) weights scaled by ``1/sqrt(fan_in)``, the
    JAX package's initializer; ``shape[in_axis]`` is the fan-in."""
    fan_in = shape[in_axis]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=_device_of(generator))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def embed_init(generator: torch.Generator | None, shape, dtype=torch.float32) -> torch.Tensor:
    """N(0, 0.02^2) rows, the JAX package's embedding initializer."""
    w = torch.randn(shape, generator=generator, device=_device_of(generator))
    return (w * 0.02).to(dtype)


def _device_of(generator: torch.Generator | None):
    """A tensor drawn from ``generator`` is made on its device."""
    return generator.device if generator is not None else None


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale=None, eps: float = 1e-6) -> torch.Tensor:
    """The mean square in f32, the normalized activation in ``x``'s dtype;
    ``scale`` is zero-initialized (the output is scaled by ``1 + scale``)."""
    dt = x.dtype

    def normalize(x):
        msq = torch.einsum("...d,...d->...", x.float(), x.float()) / x.shape[-1]
        r = torch.rsqrt(msq + eps)[..., None].to(dt)
        return x * r

    y = per_shard(normalize, x)
    if scale is not None:
        y = y * (1.0 + scale).to(dt)
    return y


def layer_norm(x: torch.Tensor, scale=None, bias=None, eps: float = 1e-5) -> torch.Tensor:
    """Parametric or non-parametric (OLMo-style) LayerNorm; the mean and
    mean square in f32, the normalized activation in ``x``'s dtype."""
    dt = x.dtype
    d = x.shape[-1]

    def normalize(x):
        xf = x.float()
        mu = torch.einsum("...d->...", xf) / d
        msq = torch.einsum("...d,...d->...", xf, xf) / d
        var = torch.clamp(msq - torch.square(mu), min=0.0)
        r = torch.rsqrt(var + eps)
        return (x - mu[..., None].to(dt)) * r[..., None].to(dt)

    y = per_shard(normalize, x)
    if scale is not None:
        y = y * scale.to(dt)
    if bias is not None:
        y = y + bias.to(dt)
    return y


def per_shard(fn, x: torch.Tensor, dims: tuple = (-1,)) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that treats each slice along every dim but
    ``dims`` on its own and keeps those other dims' sizes.  A ``DTensor``
    runs it on its local shard, as one card would, once ``dims`` are
    whole and no sum is owed on any rank (a partial or split ``dims`` is
    replicated first); the result keeps those placements, and its local
    gradient is its shard's.  Any other tensor runs it as it is."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate

    whole = {d % x.ndim for d in dims}
    pl = [Replicate() if p.is_partial() or any(p.is_shard(d) for d in whole) else p
          for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    out = fn(x.to_local())
    shape = [x.shape[d] if any(p.is_shard(d) for p in pl) else n
             for d, n in enumerate(out.shape)]
    return DTensor.from_local(out, x.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., d) ready to multiply a weight: a ``DTensor`` owes no sum
    and keeps each row's leading dims whole but the first (a split
    sequence, Megatron's sequence parallelism, is gathered here), so a
    matmul's flattening of the leading dims splits only the first.  Any
    other tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_partial() or any(p.is_shard(d) for d in range(1, x.ndim - 1))
          else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def tp_weight(w: torch.Tensor) -> torch.Tensor:
    """A weight as a matmul takes it: a ``DTensor`` whole over every mesh
    dim but ``"model"``, the tensor-parallel split it keeps (ZeRO-3's
    gather of a weight split over the data axes, made here: left to
    ``DTensor``, a wide weight's product can come out owing a sum over
    the data axes, whose backward some torch versions cannot place).  Any
    other tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    pl = [p if names[i] == "model" else Replicate() for i, p in enumerate(w.placements)]
    return w if pl == list(w.placements) else w.redistribute(w.device_mesh, pl)


def make_norm(kind: str, d: int):
    """``(init_fn, apply_fn)`` for a norm kind: ``rms`` (zero-initialized
    scale), ``ln`` (scale and bias) or ``ln_nonparam`` (no parameters)."""
    if kind == "rms":
        return (lambda generator=None: {"scale": torch.zeros(d, device=_device_of(generator))},
                lambda p, x: rms_norm(x, p["scale"]))
    if kind == "ln":
        return (lambda generator=None: {"scale": torch.ones(d, device=_device_of(generator)),
                                        "bias": torch.zeros(d, device=_device_of(generator))},
                lambda p, x: layer_norm(x, p["scale"], p["bias"]))
    if kind == "ln_nonparam":
        return (lambda generator=None: {}, lambda p, x: layer_norm(x, None, None))
    raise ValueError(f"unknown norm {kind!r}")


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def rope_inv_freq(rotary_dim: int, base: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (base ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                        device=device) / rotary_dim))


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    base: float = 10000.0,
    rotary_frac: float = 1.0,
    mrope_sections=None,
) -> torch.Tensor:
    """Rotary embedding, half-rotation convention.  x (B, S, H, dh),
    positions (B, S) int, or (3, B, S) with ``mrope_sections`` (Qwen2-VL's
    M-RoPE: frequency band ``i`` of the ``rot/2`` takes its angle from
    position component ``i``, over ``mrope_sections[i]`` frequencies).
    ``rotary_frac < 1`` rotates only the leading fraction of dh (ChatGLM's
    partial "2d" RoPE)."""
    dh = x.shape[-1]
    rot = int(dh * rotary_frac)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv = rope_inv_freq(rot, base, device=x.device)  # (rot/2,)
    if mrope_sections is not None:
        if positions.ndim != 3 or sum(mrope_sections) != rot // 2:
            raise ValueError(f"M-RoPE needs (3, B, S) positions and sections summing to "
                             f"{rot // 2}: got {tuple(positions.shape)}, {mrope_sections}")
        sec = torch.cat([torch.full((n,), i, device=x.device)
                         for i, n in enumerate(mrope_sections)])  # (rot/2,) component of each band
        angles = positions.float()[sec].movedim(0, -1) * inv  # (B, S, rot/2)
    else:
        angles = positions.float()[..., None] * inv  # (B, S, rot/2)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)  # (B, S, 1, rot/2)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, x_pass], dim=-1) if rot < dh else out


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Whisper's fixed encoder positions (S, d): ``[sin | cos]`` of
    ``pos / 10000^(2i/d)``, computed in f32, then cast."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (dim / d))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


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
    p = {
        "wq": dense_init(generator, (d_model, h * dh)),
        "wk": dense_init(generator, (d_model, kv * dh)),
        "wv": dense_init(generator, (d_model, kv * dh)),
        "wo": dense_init(generator, (h * dh, d_model)),
    }
    if spec.qk_norm:
        p["q_norm"] = torch.zeros(dh, device=_device_of(generator))
        p["k_norm"] = torch.zeros(dh, device=_device_of(generator))
    return p


_NEG = -1e30


def _online_softmax_attn(q, k, v, *, block: int, q_positions=None, causal: bool = False,
                         window: int | None = None,
                         kv_valid_len: int | None = None) -> torch.Tensor:
    """Flash-style attention over KV blocks, as the JAX package's
    ``lax.scan``: a running max, normalizer and accumulator per query.
    KV slot ``j`` is masked where ``causal`` and ``j > q_positions``, where
    a ``window`` is set and ``j <= q_positions - window``, where
    ``j >= kv_valid_len`` (a cache's unfilled slots), and in the padding of
    the last block.  q (B, Sq, KV, G, dh), k/v (B, Skv, KV, dh) ->
    (B, Sq, KV*G, dh)."""
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
    masked = causal or window is not None or kv_valid_len is not None
    for blk_i in range(nblk):
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, k[blk_i].float())
        kv_pos = blk_i * block + torch.arange(block, device=q.device)
        if masked:
            mask = _kv_mask(kv_pos, q_positions, causal, window, kv_valid_len)
            if pad:
                mask = mask & (kv_pos < skv)
            s = torch.where(mask[:, None, None], s, _NEG)
        elif pad:
            s = torch.where(kv_pos < skv, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, v[blk_i].float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)  # (B, KV, G, Sq, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, kvh * g, dh)


def _kv_mask(kv_pos, q_positions, causal: bool, window, kv_valid_len) -> torch.Tensor:
    """(B, Sq, C) keep-mask of KV slots ``kv_pos`` (C,) for each query."""
    b, sq = q_positions.shape
    mask = torch.ones((b, sq, kv_pos.shape[0]), dtype=torch.bool, device=kv_pos.device)
    if causal:
        mask = mask & (kv_pos[None, None, :] <= q_positions[:, :, None])
    if window is not None:
        mask = mask & (kv_pos[None, None, :] > q_positions[:, :, None] - window)
    if kv_valid_len is not None:
        mask = mask & (kv_pos[None, None, :] < kv_valid_len)
    return mask


def _single_shot_attn(q, k, v, *, q_positions, causal: bool, window,
                      kv_valid_len) -> torch.Tensor:
    """One query position (decode): one softmax over every KV slot, the
    JAX package's fast path.  Shapes and masks as
    :func:`_online_softmax_attn`."""
    b, sq, kvh, g, dh = q.shape
    qf = (q * (1.0 / math.sqrt(dh))).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = _kv_mask(kv_pos, q_positions, causal, window, kv_valid_len)
    s = torch.where(mask[:, None, None], s, _NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, kvh * g, dh)


def attention(params: Params, x: torch.Tensor, spec: AttnSpec):
    """The scenario towers' GQA self-attention, x (B, Sq, d) -> (out
    (B, Sq, d), None); the ``None`` stands where the JAX package returns a
    KV cache.  Their case only: non-causal, no window, no qk-norm, no
    rotary embedding, at least two query positions (the JAX package's
    online-softmax path); :func:`lm_attention` computes it."""
    if spec.causal or spec.window is not None or spec.qk_norm or spec.rope is not None:
        raise NotImplementedError(
            "the towers' attention is non-causal, window-free, qk-norm-free and rope-free")
    if x.shape[1] < 2:
        raise NotImplementedError("the towers' attention takes at least two query positions")
    return lm_attention(params, x, spec, positions=None)


def lm_attention(
    params: Params,
    x: torch.Tensor,
    spec: AttnSpec,
    *,
    positions: torch.Tensor | None,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_pos: int | None = None,
    cache_mode: str = "linear",
    kv_x: torch.Tensor | None = None,
    precomputed_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
    q_chunk: int | None = None,
):
    """GQA attention with the JAX package's ``attention`` semantics:
    qk-norm, rotary embedding at ``positions`` (B, Sq), or (3, B, Sq) for
    M-RoPE (applied to K before it is cached), causal and sliding-window
    (``spec.window``) masks in token order, and a KV cache ``(k, v)`` of
    (B, Smax, KV, dh) at ``cache_pos`` (a Python int).
    ``cache_mode="linear"`` writes slot ``cache_pos``; ``"rolling"`` (a
    sliding window's cache of Smax slots) writes slot ``cache_pos % Smax``
    and attends to every filled slot, all of which lie inside the window,
    with neither mask.  Cross-attention: K and V projected from ``kv_x``
    (B, Skv, d), or ``precomputed_kv`` (B, Skv, KV, dh) as given; either
    way no rotary embedding and no causal mask.  Query chunks of
    ``q_chunk`` positions attend one at a time when they divide Sq.
    Returns (out (B, Sq, d), the new cache or None; the cache passed in is
    not written)."""
    if cache_mode not in ("linear", "rolling"):
        raise ValueError(f"unknown cache_mode {cache_mode!r}")
    b, sq, _ = x.shape
    h, kvh, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    dt = x.dtype
    cross = kv_x is not None or precomputed_kv is not None
    q = whole_heads(rows(x) @ tp_weight(params["wq"]).to(dt), kvh).reshape(b, sq, h, dh)
    if precomputed_kv is None:
        src = x if kv_x is None else kv_x
        k, v = (whole_heads(rows(src) @ tp_weight(params[w]).to(dt), kvh)
                .reshape(b, src.shape[1], kvh, dh) for w in ("wk", "wv"))
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"])
        if precomputed_kv is None:
            k = rms_norm(k, params["k_norm"])
    if spec.rope is not None and not cross:
        rope = dict(base=spec.rope_base, rotary_frac=spec.rotary_frac,
                    mrope_sections=spec.mrope_sections)
        q = apply_rope(q, positions, **rope)
        k = apply_rope(k, positions, **rope)

    new_cache = None
    kv_valid = None
    causal, window = spec.causal and not cross, spec.window
    if precomputed_kv is not None:
        k, v = precomputed_kv
        if _slot_split(k) is not None:  # given K/V split over a mesh axis (a cross cache)
            out, _ = _cache_attend_split(q, None, None, k, v, 0, kvh=kvh, causal=False,
                                         window=None, kv_valid=None, base=0)
            return rows(out.to(dt)) @ tp_weight(params["wo"]).to(dt), None
    elif kv_cache is not None:
        if cache_pos is None:
            raise ValueError("kv_cache needs cache_pos")
        ck, cv = kv_cache
        smax = ck.shape[1]
        if cache_mode == "rolling":
            slot = cache_pos % smax
            causal, window = False, None
            kv_valid = min(cache_pos + sq, smax)
        else:
            slot = cache_pos
            kv_valid = cache_pos + sq
        slot = min(slot, smax - sq)  # as dynamic_update_slice clamps
        if _slot_split(ck) is not None:
            out, new_cache = _cache_attend_split(
                q, k, v, ck, cv, slot, kvh=kvh, causal=causal, window=window,
                kv_valid=kv_valid, base=cache_pos)
            return rows(out.to(dt)) @ tp_weight(params["wo"]).to(dt), new_cache
        ck, cv = ck.clone(), cv.clone()
        ck[:, slot:slot + sq] = k.to(ck.dtype)
        cv[:, slot:slot + sq] = v.to(cv.dtype)
        new_cache = (ck, cv)
        k, v = ck, cv

    # masks follow token order (the cache slot), not M-RoPE's position
    # values, as the JAX package's do
    base = cache_pos if cache_pos is not None else 0

    def attend_all(q, k, v):
        bl, hl, kvl = q.shape[0], q.shape[2], k.shape[2]
        qg = q.reshape(bl, sq, kvl, hl // kvl, dh)
        qidx = (base + torch.arange(sq, device=q.device))[None, :].expand(bl, sq)

        def attend(qg_c, qpos_c):
            if qg_c.shape[1] == 1:
                return _single_shot_attn(qg_c, k, v, q_positions=qpos_c, causal=causal,
                                         window=window, kv_valid_len=kv_valid)
            return _online_softmax_attn(qg_c, k, v, block=spec.attn_block, q_positions=qpos_c,
                                        causal=causal, window=window, kv_valid_len=kv_valid)

        if q_chunk is not None and sq > q_chunk and sq % q_chunk == 0:
            out = torch.cat([attend(qg[:, i:i + q_chunk], qidx[:, i:i + q_chunk])
                             for i in range(0, sq, q_chunk)], dim=1)
        else:
            out = attend(qg, qidx)
        return out.reshape(bl, sq, hl * dh)

    out = _per_shard_heads(attend_all, q, k, v).to(dt)
    return rows(out) @ tp_weight(params["wo"]).to(dt), new_cache


def whole_heads(t: torch.Tensor, n_kv: int) -> torch.Tensor:
    """A projection (B, S, heads * dh) before its head reshape.  A
    ``DTensor`` whose last dim a mesh axis splits but whose ``n_kv`` KV
    heads that axis does not divide is replicated over that axis, so no
    rank holds part of a head (GSPMD splits inside a head there, with the
    same values); q, k and v alike, so each rank's query heads are the
    groups of its KV heads."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_shard(t.ndim - 1) and n_kv % size else p
          for p, size in zip(t.placements, t.device_mesh.shape)]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh, pl)


def _per_shard_heads(fn, q, k, v):
    """``fn(q, k, v)`` -> (B, Sq, H * dh), attention over whole sequences
    (q (B, Sq, H, dh), k and v (B, Skv, KV, dh)).  ``DTensor`` inputs run
    it on each rank's own batch rows and heads, as one card would: every
    mesh dim keeps q's split of the batch (dim 0) or of the heads (dim 2)
    and replicates the rest, k and v placed alike (their heads split with
    q's, as :func:`whole_heads` left them)."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = q.device_mesh
    pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in q.placements]
    out = fn(*(_local_as(t, mesh, pl) for t in (q, k, v)))
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _local_as(t, mesh, pl) -> torch.Tensor:
    """This rank's shard of ``t`` placed as ``pl`` (a plain ``t`` counts
    as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, pl).to_local()


def _slot_split(cache: torch.Tensor) -> int | None:
    """The mesh dim that splits a ``DTensor`` cache's slots (dim 1), or
    ``None``."""
    if not is_dtensor(cache):
        return None
    dims = [i for i, p in enumerate(cache.placements) if p.is_shard(1)]
    if len(dims) > 1:
        raise NotImplementedError("a cache's slots split over more than one mesh axis")
    return dims[0] if dims else None


def _cache_attend_split(q, k, v, ck, cv, slot: int, *, kvh: int, causal: bool, window,
                        kv_valid: int | None, base: int):
    """Attention against a cache whose slots a mesh axis splits
    (``cache_pspecs``' ``P(None, b, model, None, None)``), flash-decoding
    style: q, k and v are replicated over that axis; each rank writes the
    new K/V into the slots it holds (the others write nothing; with ``k``
    and ``v`` ``None``, a cross cache given as it is, nothing is written),
    scores its own slots, and the ranks' partial softmaxes meet by their
    log-sum-exp: the axis's max, then one sum of each rank's ``exp(s -
    max)`` and its products with V.  Each term equals one card's; only the
    sums' order differs.  -> (out (B, Sq, H * dh) placed as the cache's
    batch, (ck, cv) new, placed as the old)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    mesh, ax = ck.device_mesh, _slot_split(ck)
    group = mesh.get_group(ax)
    pl = [Replicate() if i == ax else p for i, p in enumerate(ck.placements)]
    q_l = _local_as(q, mesh, pl)
    ck_l, cv_l = ck.to_local(), cv.to_local()
    b, sq, h, dh = q_l.shape
    smax = ck.shape[1]
    off = mesh.get_local_rank(ax) * -(-smax // mesh.size(ax))  # torch.chunk's split
    n = ck_l.shape[1]
    lo, hi = max(slot, off), min(slot + sq, off + n)
    if k is not None:
        k_l, v_l = _local_as(k, mesh, pl), _local_as(v, mesh, pl)  # collectives: every rank
        ck_l, cv_l = ck_l.clone(), cv_l.clone()
    if k is not None and lo < hi:
        ck_l[:, lo - off:hi - off] = k_l[:, lo - slot:hi - slot].to(ck_l.dtype)
        cv_l[:, lo - off:hi - off] = v_l[:, lo - slot:hi - slot].to(cv_l.dtype)

    g = h // kvh
    qf = (q_l.reshape(b, sq, kvh, g, dh) * (1.0 / math.sqrt(dh))).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, ck_l.float())
    qpos = (base + torch.arange(sq, device=q_l.device))[None, :].expand(b, sq)
    mask = _kv_mask(off + torch.arange(n, device=q_l.device), qpos, causal, window, kv_valid)
    s = torch.where(mask[:, None, None], s, _NEG)
    m = s.amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, cv_l.float())
    both = torch.cat([acc, p.sum(dim=-1)[..., None]], dim=-1)
    dist.all_reduce(both, group=group)
    out = both[..., :dh] / torch.clamp(both[..., dh:], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h * dh)
    new = tuple(DTensor.from_local(t, mesh, ck.placements, run_check=False,
                                   shape=ck.shape, stride=ck.stride()) for t in (ck_l, cv_l))
    return DTensor.from_local(out, mesh, pl, run_check=False), new


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_init(generator: torch.Generator | None, d_model: int, d_ff: int,
             kind: str = "swiglu") -> dict:
    """The MLP's weights: ``wi``, ``wg``, ``wo`` for SwiGLU; ``wi``, ``wo``
    and zero biases ``bi``, ``bo`` for GELU."""
    if kind == "swiglu":
        return {
            "wi": dense_init(generator, (d_model, d_ff)),
            "wg": dense_init(generator, (d_model, d_ff)),
            "wo": dense_init(generator, (d_ff, d_model)),
        }
    if kind == "gelu":
        return {
            "wi": dense_init(generator, (d_model, d_ff)),
            "wo": dense_init(generator, (d_ff, d_model)),
            "bi": torch.zeros(d_ff, device=_device_of(generator)),
            "bo": torch.zeros(d_model, device=_device_of(generator)),
        }
    raise ValueError(f"unknown mlp {kind!r}")


def mlp_apply(params: Params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """SwiGLU, ``(silu(x wg) * (x wi)) wo``, or GELU, ``gelu(x wi + bi) wo +
    bo`` with the tanh approximation (``jax.nn.gelu``'s default)."""
    dt = x.dtype
    if kind == "swiglu":
        x = rows(x)
        h = F.silu(x @ tp_weight(params["wg"]).to(dt)) * (x @ tp_weight(params["wi"]).to(dt))
        return rows(h) @ tp_weight(params["wo"]).to(dt)
    if kind == "gelu":
        h = F.gelu(rows(x) @ tp_weight(params["wi"]).to(dt) + params["bi"].to(dt),
                   approximate="tanh")
        return rows(h) @ tp_weight(params["wo"]).to(dt) + params["bo"].to(dt)
    raise ValueError(f"unknown mlp {kind!r}")
