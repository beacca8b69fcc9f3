"""The dense LM family (olmo, qwen3, chatglm3): train, prefill and decode.

The JAX package's ``models/transformer.py`` for ``family == "dense"``, in
eager PyTorch on one device:

* each layer's parameters are their own entry of ``params["layers"]`` (the
  JAX package stacks them along a leading ``n_layers`` axis and scans;
  :func:`params_from_jax` splits the stack), and the layers run in a Python
  loop;
* the token embedding is a plain gather (the JAX package's path without a
  shard context; its vocab-parallel embedding is ROADMAP A10);
* the serve cache is linear: ``{"k", "v": (L, B, cap, KV, dh), "pos": int}``;
* parameters are cast to ``cfg.compute_dtype`` where the JAX package casts
  them, so a ``bfloat16`` run rounds where the reference rounds; the loss
  runs in f32 over the padded vocab.

The other families (moe, ssm, hybrid, encdec, vlm) raise
``NotImplementedError`` naming ROADMAP A10.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnSpec, Params
from repro_torch.tree import tree_map, value_and_grad

__all__ = [
    "AUX_LOSS_WEIGHT",
    "attn_spec",
    "ce_loss",
    "decode_step",
    "dense_block",
    "embed_tokens",
    "forward_seq",
    "init_cache",
    "init_params",
    "lm_logits",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "params_from_jax",
]

AUX_LOSS_WEIGHT = 0.01


def _dense_only(cfg: ArchConfig, ctx=None) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.arch}) is not ported yet: ROADMAP A10")
    if ctx is not None:
        raise NotImplementedError("sharded LMs (a ShardCtx) are not ported yet: ROADMAP A10")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def attn_spec(cfg: ArchConfig, *, causal: bool = True, window_on: bool = True) -> AttnSpec:
    return AttnSpec(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        causal=causal,
        window=cfg.window if window_on else None,
        qk_norm=cfg.qk_norm,
        rope=cfg.rope,
        rope_base=cfg.rope_base,
        rotary_frac=cfg.rotary_frac,
        mrope_sections=cfg.mrope_sections,
        attn_block=cfg.attn_block,
    )


# ==========================================================================
# parameters
# ==========================================================================


def _dense_layer_init(cfg: ArchConfig, generator) -> Params:
    norm_init, _ = L.make_norm(cfg.norm, cfg.d_model)
    return {
        "ln1": norm_init(generator),
        "attn": L.attn_init(generator, cfg.d_model, attn_spec(cfg)),
        "ln2": norm_init(generator),
        "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None) -> Params:
    """Fresh f32 parameters drawn from ``generator``, on its device (the JAX
    package's initializers; the values differ from ``jax.random``'s)."""
    _dense_only(cfg)
    if cfg.mlp != "swiglu":
        raise NotImplementedError(f"mlp {cfg.mlp!r}: the dense family's port runs SwiGLU")
    norm_init, _ = L.make_norm(cfg.norm, cfg.d_model)
    vpad, d = cfg.vocab_padded, cfg.d_model
    return {
        "embed": L.embed_init(generator, (vpad, d)),
        "final_norm": norm_init(generator),
        "layers": [_dense_layer_init(cfg, generator) for _ in range(cfg.n_layers)],
        "lm_head": L.dense_init(generator, (d, vpad)),
    }


def params_from_jax(cfg: ArchConfig, params_np: dict, device="cpu") -> Params:
    """The JAX package's ``init_params`` tree, as numpy arrays, in the port's
    form: each stacked ``layers`` leaf (leading ``n_layers`` axis) split
    into per-layer entries, every leaf an f32 tensor on ``device``."""
    _dense_only(cfg)

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    out = {k: tree_map(t, v) for k, v in params_np.items() if k != "layers"}
    stacked = params_np["layers"]
    out["layers"] = [tree_map(lambda a, i=i: t(np.asarray(a)[i]), stacked)
                     for i in range(cfg.n_layers)]
    return out


# ==========================================================================
# embedding, head and loss
# ==========================================================================


def embed_tokens(cfg: ArchConfig, params: Params, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
    _dense_only(cfg, ctx)
    return params["embed"][tokens.long()]


def lm_logits(cfg: ArchConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    return h @ params["lm_head"].to(h.dtype)


def ce_loss(cfg: ArchConfig, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked cross-entropy in f32 over the padded vocab (padding logits set
    to -1e30); labels < 0 are ignored."""
    logits = logits.float()
    vpad = logits.shape[-1]
    if vpad != cfg.vocab:
        vmask = torch.arange(vpad, device=logits.device) < cfg.vocab
        logits = torch.where(vmask, logits, -1e30)
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ==========================================================================
# blocks and the full-sequence forward
# ==========================================================================


def _norm(cfg: ArchConfig, p, x):
    _, apply = L.make_norm(cfg.norm, cfg.d_model)
    return apply(p, x)


def dense_block(cfg: ArchConfig, p: Params, h, positions, *, cache=None, cache_pos=None,
                q_chunk=None):
    """Pre-norm attention + SwiGLU block -> (h, new cache or None)."""
    a, new_cache = L.lm_attention(p["attn"], _norm(cfg, p["ln1"], h), attn_spec(cfg),
                                  positions=positions, kv_cache=cache, cache_pos=cache_pos,
                                  q_chunk=q_chunk)
    h = h + a
    return h + L.mlp_apply(p["mlp"], _norm(cfg, p["ln2"], h)), new_cache


def _positions(bsz: int, seq: int, offset: int, device) -> torch.Tensor:
    return (torch.arange(seq, dtype=torch.int32, device=device) + offset)[None].expand(bsz, seq)


def forward_seq(cfg: ArchConfig, params: Params, batch: dict, ctx=None, *,
                want_cache: ShapeCfg | None = None):
    """Full-sequence forward -> (hidden (B, S, d), aux loss, caches or None);
    ``want_cache`` (a decode ShapeCfg) builds the serve caches (prefill)."""
    _dense_only(cfg, ctx)
    tokens = batch["tokens"]
    bsz, seq = tokens.shape
    h = embed_tokens(cfg, params, tokens).to(_dtype(cfg.compute_dtype))
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(bsz, seq, 0, h.device)
    q_chunk = cfg.q_chunk if seq > cfg.q_chunk else None
    cap = _cache_capacity(cfg, want_cache) if want_cache is not None else 0
    ks, vs = [], []
    for lp in params["layers"]:
        if want_cache is not None:
            k, v = _extract_kv(cfg, lp["attn"], _norm(cfg, lp["ln1"], h), positions, cap)
            ks.append(k)
            vs.append(v)
        h, _ = dense_block(cfg, lp, h, positions, q_chunk=q_chunk)
    caches = None
    if want_cache is not None:
        caches = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": seq}
    h = _norm(cfg, params["final_norm"], h)
    return h, torch.zeros((), device=h.device), caches


def _cache_capacity(cfg: ArchConfig, shape: ShapeCfg) -> int:
    return shape.seq  # linear caches; the windowed (rolling) ones are ROADMAP A10's


def _extract_kv(cfg: ArchConfig, attn_p: Params, x, positions, cap: int):
    """One layer's cache-ready K/V (rope-rotated), padded to ``cap`` slots;
    recomputes the projections, as the JAX package does."""
    spec = attn_spec(cfg)
    bsz, seq, dt = x.shape[0], x.shape[1], x.dtype
    kvh, dh = spec.n_kv_heads, spec.head_dim
    k = (x @ attn_p["wk"].to(dt)).reshape(bsz, seq, kvh, dh)
    v = (x @ attn_p["wv"].to(dt)).reshape(bsz, seq, kvh, dh)
    if spec.qk_norm:
        k = L.rms_norm(k, attn_p["k_norm"])
    if spec.rope is not None:
        k = L.apply_rope(k, positions, base=spec.rope_base, rotary_frac=spec.rotary_frac,
                         mrope_sections=spec.mrope_sections)
    return _pack_cache(k, cap), _pack_cache(v, cap)


def _pack_cache(kv: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, cap, KV, dh), zero slots after the sequence."""
    seq = kv.shape[1]
    if seq == cap:
        return kv
    out = torch.zeros((kv.shape[0], cap, *kv.shape[2:]), dtype=kv.dtype, device=kv.device)
    out[:, :seq] = kv
    return out


# ==========================================================================
# decode
# ==========================================================================


def init_cache(cfg: ArchConfig, shape: ShapeCfg, dtype=torch.bfloat16, pos: int | None = None,
               device=None) -> dict:
    """Zero serve cache of ``shape.seq`` slots per layer; ``pos`` (default
    ``shape.seq - 1``) is the slot the next decode step writes."""
    _dense_only(cfg)
    cap = _cache_capacity(cfg, shape)
    size = (cfg.n_layers, shape.batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(size, dtype=dtype, device=device),
            "v": torch.zeros(size, dtype=dtype, device=device),
            "pos": shape.seq - 1 if pos is None else pos}


def decode_step(cfg: ArchConfig, params: Params, cache: dict, batch: dict, ctx=None):
    """One-token decode -> (logits (B, 1, Vpad), new cache); ``cache`` is
    not written."""
    _dense_only(cfg, ctx)
    pos = cache["pos"]
    tokens = batch["tokens"]  # (B, 1)
    h = embed_tokens(cfg, params, tokens).to(_dtype(cfg.compute_dtype))
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(tokens.shape[0], 1, pos, h.device)
    ks, vs = [], []
    for i, lp in enumerate(params["layers"]):
        h, (k, v) = dense_block(cfg, lp, h, positions, cache=(cache["k"][i], cache["v"][i]),
                                cache_pos=pos)
        ks.append(k)
        vs.append(v)
    h = _norm(cfg, params["final_norm"], h)
    return lm_logits(cfg, params, h), {"k": torch.stack(ks), "v": torch.stack(vs),
                                       "pos": pos + 1}


# ==========================================================================
# step builders
# ==========================================================================


_BATCH_AXIS = {"positions": 1}  # every other batch leaf has its batch on axis 0


def _split_microbatches(batch: dict, accum: int) -> dict:
    """The batch as ``accum`` microbatches along a new leading axis, strided
    over the batch (sample ``j * accum + i`` goes to microbatch ``i``), as
    the JAX package splits it."""
    out = {}
    for key, x in batch.items():
        ax = _BATCH_AXIS.get(key, 0)
        b = x.shape[ax]
        if b % accum:
            raise ValueError(f"{key}: batch {b} does not split into {accum} microbatches")
        shp = list(x.shape)
        shp[ax:ax + 1] = [b // accum, accum]
        out[key] = x.reshape(shp).movedim(ax + 1, 0)
    return out


def make_train_step(cfg: ArchConfig, ctx, optimizer, shape: ShapeCfg):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "aux"})``: the f32 parameters cast to ``cfg.compute_dtype`` for
    the forward, the loss in f32, gradients accumulated over
    ``cfg.grad_accum[shape.name]`` strided microbatches (in the compute dtype
    with ``low_precision_opt``)."""
    _dense_only(cfg, ctx)
    accum = max(min(cfg.grad_accum.get(shape.name, 1), shape.batch), 1)
    cdt = _dtype(cfg.compute_dtype)

    def loss_fn(params, mb):
        params_c = tree_map(lambda p: p.to(cdt) if p.dtype == torch.float32 else p, params)
        h, aux, _ = forward_seq(cfg, params_c, mb)
        loss = ce_loss(cfg, lm_logits(cfg, params_c, h), mb["labels"])
        return loss + AUX_LOSS_WEIGHT * aux, (loss, aux)

    def train_step(params, opt_state, batch):
        if accum == 1:
            (_, (loss, aux)), grads = value_and_grad(loss_fn, params, batch, has_aux=True)
        else:
            mbs = _split_microbatches(batch, accum)
            acc_dt = cdt if cfg.low_precision_opt else None
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt or p.dtype,
                                                  device=p.device), params)
            lsum = asum = torch.zeros((), device=params["embed"].device)
            for i in range(accum):
                (_, (l, a)), g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in mbs.items()}, has_aux=True)
                gsum = tree_map(lambda a_, g_: a_ + g_.to(a_.dtype), gsum, g)
                lsum, asum = lsum + l, asum + a
            grads = tree_map(lambda g: g / accum, gsum)
            loss, aux = lsum / accum, asum / accum
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "aux": aux}

    return train_step


def make_prefill_step(cfg: ArchConfig, ctx, shape: ShapeCfg):
    """``prefill(params, batch) -> (last position's logits (B, 1, Vpad),
    caches for ``shape``)``.  The batch-split prefill of
    ``cfg.serve_microbatch`` belongs to the MoE archs (ROADMAP A10)."""
    _dense_only(cfg, ctx)
    if cfg.serve_microbatch.get(shape.name, 1) > 1:
        raise NotImplementedError("batch-split prefill (serve_microbatch) is ROADMAP A10's")

    def prefill_step(params, batch):
        h, _, caches = forward_seq(cfg, params, batch, want_cache=shape)
        return lm_logits(cfg, params, h[:, -1:, :]), caches

    return prefill_step


def make_serve_step(cfg: ArchConfig, ctx):
    _dense_only(cfg, ctx)

    def serve_step(params, cache, batch):
        return decode_step(cfg, params, cache, batch)

    return serve_step

