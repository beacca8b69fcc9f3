"""The LM families of the port: dense (olmo, qwen3, chatglm3), moe
(granite, mixtral with its sliding window), ssm (mamba2), hybrid (zamba2),
encdec (whisper) and vlm (qwen2-vl), through train, prefill and decode.

The JAX package's ``models/transformer.py`` in eager PyTorch on one device:

* each layer's parameters are their own entry of ``params["layers"]``
  (and of ``params["enc_layers"]``, whisper's encoder; the JAX package
  stacks them along a leading layer axis and scans; :func:`params_from_jax`
  splits the stacks), and the layers run in a Python loop;
* the token embedding is a plain gather, or with a :class:`ShardCtx` the
  JAX package's vocab-parallel embedding
  (:func:`repro_torch.core.partition.vocab_parallel_embed`): the model
  axis's row shards of ``embed`` looked up one after another and summed;
* the inputs: token ids, or for vlm the frontend's embeds (B, S, d) with
  M-RoPE positions (3, B, S), or for encdec the frontend's frames (B,
  S_enc, d) beside the decoder's tokens (both frontends are stubbed, as in
  the JAX package);
* the serve caches: ``{"k", "v": (L, B, cap, KV, dh)}`` for dense, moe and
  vlm, linear, or rolling over ``min(window, seq)`` slots for a sliding
  window; those plus the cross-attention's ``{"ck", "cv": (L, B, S_enc,
  KV, dh)}`` for encdec; ``{"conv", "ssm"}`` per mamba layer for ssm; and
  for hybrid those plus ``{"shared_k", "shared_v"}`` per invocation of the
  shared block; each with ``"pos"``, a Python int;
* the MoE layers hold whole experts (see :func:`moe.merge_virtual_experts`);
* parameters are cast to ``cfg.compute_dtype`` where the JAX package casts
  them, so a ``bfloat16`` run rounds where the reference rounds; the loss
  runs in f32 over the padded vocab;
* the train step rematerialises each layer (``forward_seq(remat=True)``,
  ``torch.utils.checkpoint`` where the JAX package calls
  ``jax.checkpoint``): the backward keeps each layer's input and recomputes
  the rest.

A :class:`ShardCtx` is accepted wherever the JAX package accepts one, over
either kind of mesh (:mod:`repro_torch.launch.mesh`):

* a :class:`~repro_torch.launch.mesh.Mesh` shape, one card holding the
  whole model: the embedding runs vocab-parallel over the model axis's row
  shards in turn, the batch-split knobs clamp by the data axes
  (:func:`_dp_size`), and the sharding constraints change no value;
* a ``DeviceMesh`` over one rank per card, the leaves placed as
  ``DTensor`` objects by the sharding rules
  (:func:`repro_torch.sharding.with_sharding`; batches by
  ``batch_pspecs``, caches by ``cache_pspecs``): ``DTensor`` propagates
  the placements through every op as GSPMD does in the JAX package, with
  the plain tensors the model makes (positions, masks, zeros) read as
  replicated (``implicit_replication``).  The embedding is the JAX
  package's ``shard_map`` form (each rank's row shard, summed over the
  model axis), and so are whisper's decoder position rows; the
  sequence-parallel and expert-parallel constraints are ``redistribute``
  calls, a residual branch owing a sum takes the stream's placements
  before it is added (:func:`_placed_like`), attention keeps heads whole
  (:func:`repro_torch.models.layers.lm_attention`), a mamba layer runs on
  each rank's conv channels and heads (:mod:`repro_torch.models.mamba2`),
  and decode writes and reads the sequence-sharded caches rank-locally
  (whisper's frame-split ``ck``/``cv`` too).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.core.partition import vocab_parallel_embed, vocab_parallel_embed_shard
from repro_torch.launch.mesh import axis_size, is_device_mesh
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnSpec, Params
from repro_torch.models.mamba2 import (
    mamba_apply,
    mamba_decode_step,
    mamba_init,
    mamba_init_state,
)
from repro_torch.models.moe import merge_virtual_experts, moe_apply, moe_init
from repro_torch.sharding import P, cache_pspecs, is_dtensor, placements
from repro_torch.tree import plain_as_replicated, tree_map, value_and_grad

__all__ = [
    "AUX_LOSS_WEIGHT",
    "ShardCtx",
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
    "shared_block",
]

AUX_LOSS_WEIGHT = 0.01
_ATTN_FAMILIES = ("dense", "moe", "vlm")  # a stack of dense_block layers


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The mesh context threaded through the model code (``None`` = one
    device, no mesh): ``mesh`` is a :class:`repro_torch.launch.mesh.Mesh`
    shape or a ``DeviceMesh`` over the cards (see the module docstring)."""

    mesh: Any
    model_axis: str = "model"
    data_axes: tuple[str, ...] = ("data",)
    shard_batch: bool = True

    @property
    def batch_spec(self):
        return self.data_axes if self.shard_batch else None


def _on_cards(ctx) -> bool:
    """Whether ``ctx``'s mesh is a ``DeviceMesh``: the leaves are placed."""
    return ctx is not None and is_device_mesh(ctx.mesh)


def _scope(ctx):
    """On a ``DeviceMesh``, ``implicit_replication()`` (re-entrant,
    :func:`repro_torch.tree.plain_as_replicated`): a plain tensor the
    model makes (positions, masks, zeros) joins the ``DTensor`` objects as
    replicated; else nothing."""
    return plain_as_replicated() if _on_cards(ctx) else contextlib.nullcontext()


def _constrain(ctx, x, spec: P):
    """``x`` redistributed to ``spec`` on a ``DeviceMesh`` (the JAX
    package's ``with_sharding_constraint``); a plain tensor, or a shape
    mesh, as it is."""
    if not _on_cards(ctx) or not is_dtensor(x):
        return x
    return _ContiguousGrad.apply(x).redistribute(ctx.mesh, placements(spec, ctx.mesh))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    ``redistribute``'s backward can give a strided one, which the view in
    the backward of the einsum before it cannot take."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


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
    p = {
        "ln1": norm_init(generator),
        "attn": L.attn_init(generator, cfg.d_model, attn_spec(cfg)),
        "ln2": norm_init(generator),
    }
    if cfg.moe is not None:
        p["moe"] = moe_init(generator, cfg.d_model, cfg.moe)
    else:
        p["mlp"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp)
    return p


def _mamba_layer_init(cfg: ArchConfig, generator) -> Params:
    norm_init, _ = L.make_norm(cfg.norm, cfg.d_model)
    return {"ln": norm_init(generator), "mamba": mamba_init(generator, cfg.ssm)}


def _shared_block_init(cfg: ArchConfig, generator) -> Params:
    """Zamba2's shared attention block at width 2d (on ``concat(h, emb0)``)."""
    d2 = 2 * cfg.d_model
    norm_init, _ = L.make_norm(cfg.norm, d2)
    return {
        "ln1": norm_init(generator),
        "attn": L.attn_init(generator, d2, attn_spec(cfg)),
        "ln2": norm_init(generator),
        "mlp": L.mlp_init(generator, d2, cfg.d_ff, cfg.mlp),
        "proj_out": L.dense_init(generator, (d2, cfg.d_model)),
    }


def _encdec_layer_init(cfg: ArchConfig, generator, *, cross: bool) -> Params:
    """Whisper's encoder layer, or (``cross``) its decoder layer, which adds
    the cross-attention and its norm."""
    norm_init, _ = L.make_norm(cfg.norm, cfg.d_model)
    p = {
        "ln1": norm_init(generator),
        "attn": L.attn_init(generator, cfg.d_model, attn_spec(cfg)),
        "ln2": norm_init(generator),
        "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp),
    }
    if cross:
        p["ln_x"] = norm_init(generator)
        p["xattn"] = L.attn_init(generator, cfg.d_model, attn_spec(cfg, causal=False))
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None) -> Params:
    """Fresh f32 parameters drawn from ``generator``, on its device (the JAX
    package's initializers; the values differ from ``jax.random``'s)."""
    norm_init, _ = L.make_norm(cfg.norm, cfg.d_model)
    vpad, d = cfg.vocab_padded, cfg.d_model
    p = {"embed": L.embed_init(generator, (vpad, d)), "final_norm": norm_init(generator)}
    if cfg.family in _ATTN_FAMILIES:
        p["layers"] = [_dense_layer_init(cfg, generator) for _ in range(cfg.n_layers)]
    elif cfg.family in ("ssm", "hybrid"):
        p["layers"] = [_mamba_layer_init(cfg, generator) for _ in range(cfg.n_layers)]
    elif cfg.family == "encdec":
        p["enc_layers"] = [_encdec_layer_init(cfg, generator, cross=False)
                           for _ in range(cfg.enc_layers)]
        p["layers"] = [_encdec_layer_init(cfg, generator, cross=True)
                       for _ in range(cfg.n_layers)]
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    p["lm_head"] = L.dense_init(generator, (d, vpad))
    if cfg.family == "hybrid":
        p["shared"] = _shared_block_init(cfg, generator)
    if cfg.family == "encdec":
        p["enc_final_norm"] = norm_init(generator)
        p["pos_emb"] = L.embed_init(generator, (cfg.max_target_positions, d))
    return p


def params_from_jax(cfg: ArchConfig, params_np: dict, device="cpu") -> Params:
    """The JAX package's ``init_params`` tree, as numpy arrays, in the port's
    form: each stacked ``layers`` and ``enc_layers`` leaf (leading layer
    axis) split into per-layer entries, an MoE layer's virtual experts
    merged into whole ones (:func:`moe.merge_virtual_experts`), every other
    leaf (``shared``, ``pos_emb``, ``enc_final_norm``, ...) as it is, each
    an f32 tensor on ``device``."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.enc_layers}
    out = {}
    for key, v in params_np.items():
        if key in stacks:
            out[key] = [tree_map(lambda a, i=i: t(np.asarray(a)[i]), v)
                        for i in range(stacks[key])]
        else:
            out[key] = tree_map(t, v)
    if cfg.moe is not None:
        for lp in out["layers"]:
            lp["moe"] = merge_virtual_experts(lp["moe"], cfg.moe.n_experts)
    return out


# ==========================================================================
# embedding, head and loss
# ==========================================================================


def embed_tokens(cfg: ArchConfig, params: Params, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
    """The rows of ``embed`` at ``tokens``; with a ``ctx``, vocab-parallel
    over the model axis's row shards (the same values: each token's row
    plus zeros): in turn on a shape mesh, one shard a rank on a
    ``DeviceMesh`` (:func:`_embed_on_cards`)."""
    if ctx is None:
        return params["embed"][tokens.long()]
    if _on_cards(ctx):
        return _embed_on_cards(ctx, params["embed"], tokens)
    return vocab_parallel_embed(params["embed"], tokens, axis_size(ctx.mesh, ctx.model_axis))


def _embed_on_cards(ctx, table, tokens):
    """The JAX package's ``shard_map`` embedding on a ``DeviceMesh``: the
    table's rows split over the model axis (``P(model, None)``), the tokens
    as they come (split over the data axes, replicated over the model
    axis), each rank's masked gather of its own shard summed over the model
    axis (:func:`vocab_parallel_embed_shard`) -> (B, S, d) placed as the
    tokens.  The table's gradient is partial over every axis that splits
    the tokens, so ``value_and_grad`` sums it there (the data-parallel
    reduction)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, m = ctx.mesh, ctx.mesh.mesh_dim_names.index(ctx.model_axis)
    n = mesh.ndim
    if not is_dtensor(table):
        table = DTensor.from_local(table, mesh, [Replicate()] * n, run_check=False)
    table = table.redistribute(mesh, placements(P(ctx.model_axis, None), mesh))
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * n, run_check=False)
    tok_pl = list(tokens.placements)
    tok_pl[m] = Replicate()
    tokens = tokens.redistribute(mesh, tok_pl)
    grad_pl = [Partial() if tp.is_shard() else p for tp, p in zip(tok_pl, table.placements)]
    out = vocab_parallel_embed_shard(table.to_local(grad_placements=grad_pl),
                                     tokens.to_local(), mesh.get_local_rank(m),
                                     mesh.get_group(m))
    return DTensor.from_local(out, mesh, tok_pl, run_check=False)


def _position_rows(ctx, table, tokens, start: int):
    """Whisper's learned decoder positions ``start, start + 1, ...`` for
    ``tokens`` (B, S): the slice (1, S, d) of ``table``; on a ``DeviceMesh``
    the rows at those ids through the token embedding's gather form
    (:func:`_embed_on_cards`), placed as the tokens: each rank looks up its
    own row shard and the model axis sums, so no rank holds the whole
    table.  Each row has one non-zero term: bitwise the slice."""
    seq = tokens.shape[1]
    if not _on_cards(ctx):
        return table[None, start:start + seq]
    ids = torch.zeros_like(tokens) + (torch.arange(seq, dtype=tokens.dtype,
                                                   device=tokens.device) + start)
    return _embed_on_cards(ctx, table, ids)


def lm_logits(cfg: ArchConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    return L.rows(h) @ L.tp_weight(params["lm_head"]).to(h.dtype)


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
    lab = torch.clamp(labels, min=0)
    if is_dtensor(logits):
        # the vocab dim may lie split over the model axis: the label's logit
        # as a masked sum (one term, so exact), which a split dim allows
        vocab = torch.arange(vpad, device=logits.device)
        ll = torch.where(vocab == lab[..., None], logits, 0.0).sum(dim=-1)
    else:
        ll = torch.gather(logits, -1, lab[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ==========================================================================
# blocks and the full-sequence forward
# ==========================================================================


def _norm(cfg: ArchConfig, p, x):
    _, apply = L.make_norm(cfg.norm, x.shape[-1])
    return apply(p, x)


def _sp_constrain(ctx, h, cfg: ArchConfig | None = None):
    """The JAX package's sequence-parallel constraint on the residual stream
    (batch x seq/TP x d between layers, under remat), under its conditions:
    ``cfg.seq_parallel``, a 3-d ``h`` and the sequence divisible by the
    model axis.  On a ``DeviceMesh`` a ``redistribute``; on a shape mesh one
    card holds the whole stream, and ``h`` is returned as it is."""
    if not _on_cards(ctx) or h.ndim != 3 or (cfg is not None and not cfg.seq_parallel):
        return h
    if h.shape[1] % axis_size(ctx.mesh, ctx.model_axis):
        return h
    return _constrain(ctx, h, P(ctx.batch_spec, ctx.model_axis, None))


def _moe_constrain(ctx):
    """The JAX package's expert-parallel constraints for the expert GEMMs
    (``None`` without a ctx), the hook ``moe_apply`` takes.  On a
    ``DeviceMesh``: ``xe`` goes from token-sharded to expert-sharded over
    ``"data"`` (an all-to-all, the EP dispatch), ``h`` expert- and
    ff-sharded, ``ye`` back to token-sharded (the EP return).  Two
    constraints back to back, as in the JAX package, whose docstring
    records that one alone gathered the one-hots to global size.  On a
    shape mesh one card holds every expert: each tensor as it is."""
    if ctx is None:
        return None
    if not _on_cards(ctx):
        return lambda name, x: x
    pod = "pod" if "pod" in ctx.data_axes else None
    g_shard = tuple(ctx.data_axes) if ctx.shard_batch else None
    specs = {
        "xe": [P(g_shard, None, None, None), P(pod, "data", None, None)],
        "h": [P(pod, "data", None, ctx.model_axis)],
        "ye": [P(pod, "data", None, None), P(g_shard, None, None, None)],
    }

    def constrain(name, x):
        for spec in specs[name]:
            x = _constrain(ctx, x, spec)
        return x

    return constrain


def _checkpointed(fn, ctx=None):
    """``fn`` rematerialised in the backward (the JAX package's
    ``jax.checkpoint``): autograd keeps its inputs and recomputes its
    activations, in ``ctx``'s :func:`_scope` wherever the backward runs."""
    @functools.wraps(fn)
    def scoped(*args):
        with _scope(ctx):
            return fn(*args)

    def run(*args):
        return torch.utils.checkpoint.checkpoint(scoped, *args, use_reentrant=False)

    return run


def dense_block(cfg: ArchConfig, p: Params, h, positions, *, cache=None, cache_pos=None,
                cache_mode="linear", q_chunk=None, ctx=None):
    """Pre-norm attention, then the MLP or (``cfg.moe``) the routed experts
    -> (h, new cache or None, the MoE aux loss or 0).  On a ``DeviceMesh``
    each branch's output takes the residual stream's placements before it
    is added (:func:`_placed_like`)."""
    a, new_cache = L.lm_attention(p["attn"], _norm(cfg, p["ln1"], h), attn_spec(cfg),
                                  positions=positions, kv_cache=cache, cache_pos=cache_pos,
                                  cache_mode=cache_mode, q_chunk=q_chunk)
    h = h + _placed_like(a, h)
    m_in = _norm(cfg, p["ln2"], h)
    if cfg.moe is not None:
        mo, aux = moe_apply(p["moe"], m_in, cfg.moe, constrain=_moe_constrain(ctx))
    else:
        mo, aux = L.mlp_apply(p["mlp"], m_in, cfg.mlp), torch.zeros((), device=h.device)
    return h + _placed_like(mo, h), new_cache, aux


def _placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements where both are
    ``DTensor`` objects that differ (a sequence-parallel residual: the
    branch's sums are reduce-scattered over the sequence, and in the
    backward the stream's gradient is gathered before the branch's last
    matmul, which takes no split sequence); else ``x``."""
    if is_dtensor(x) and is_dtensor(ref) and tuple(x.placements) != tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def shared_block(cfg: ArchConfig, p: Params, h, emb0, positions, *, cache=None,
                 cache_pos=None, q_chunk=None):
    """Zamba2's shared attention block at width 2d on ``concat(h, emb0)``,
    projected back to d and added to ``h`` -> (h, new cache or None)."""
    g = torch.cat([h, emb0], dim=-1)
    a, new_cache = L.lm_attention(p["attn"], _norm(cfg, p["ln1"], g), attn_spec(cfg),
                                  positions=positions, kv_cache=cache, cache_pos=cache_pos,
                                  q_chunk=q_chunk)
    g = g + _placed_like(a, g)
    g = g + _placed_like(L.mlp_apply(p["mlp"], _norm(cfg, p["ln2"], g), cfg.mlp), g)
    return h + _placed_like(L.rows(g) @ L.tp_weight(p["proj_out"]).to(h.dtype), h), new_cache


def _positions(bsz: int, seq: int, offset: int, device) -> torch.Tensor:
    return (torch.arange(seq, dtype=torch.int32, device=device) + offset)[None].expand(bsz, seq)


def forward_seq(cfg: ArchConfig, params: Params, batch: dict, ctx=None, *,
                want_cache: ShapeCfg | None = None, remat: bool = False):
    """Full-sequence forward -> (hidden (B, S, d), aux loss, caches or None);
    ``want_cache`` (a decode ShapeCfg) builds the serve caches (prefill).
    ``remat`` checkpoints each layer body where the JAX package does: not
    while building a cache, except whisper's encoder layers, always; for
    zamba2 each group of mamba layers with its shared block, and within it
    each mamba layer."""
    with _scope(ctx):
        return _forward_seq(cfg, params, batch, ctx, want_cache, remat)


def _forward_seq(cfg: ArchConfig, params: Params, batch: dict, ctx, want_cache, remat):
    build = want_cache is not None
    cap = _cache_capacity(cfg, want_cache) if build else 0
    if cfg.family == "encdec":
        return _encdec_forward(cfg, params, batch, build, cap, ctx=ctx, remat=remat)
    h = _embed_input(cfg, params, batch, ctx)
    bsz, seq = h.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(bsz, seq, 0, h.device)
    q_chunk = cfg.q_chunk if seq > cfg.q_chunk else None
    aux = torch.zeros((), device=h.device)
    if cfg.family in ("ssm", "hybrid"):
        h, caches = _mamba_forward(cfg, params, h, positions, build, cap, q_chunk=q_chunk,
                                   ctx=ctx, remat=remat)
    else:
        def body(h, lp):
            h = _sp_constrain(ctx, h, cfg) if remat else h
            h, _, aux_l = dense_block(cfg, lp, h, positions, q_chunk=q_chunk, ctx=ctx)
            h = _sp_constrain(ctx, h, cfg) if remat else h
            return h, aux_l

        blk = _checkpointed(body, ctx) if remat and not build else body
        ks, vs = [], []
        for lp in params["layers"]:
            if build:
                k, v = _extract_kv(cfg, lp["attn"], _norm(cfg, lp["ln1"], h), positions, cap)
                ks.append(k)
                vs.append(v)
            h, aux_l = blk(h, lp)
            aux = aux + aux_l
        caches = {"k": torch.stack(ks), "v": torch.stack(vs)} if build else None
    if caches is not None:
        caches["pos"] = seq
    h = _norm(cfg, params["final_norm"], h)
    return h, aux, caches


def _embed_input(cfg: ArchConfig, params: Params, batch: dict, ctx=None) -> torch.Tensor:
    """The stack's input in the compute dtype: ``batch["embeds"]`` for an
    embeds config (vlm; ``params["embed"]`` is not read), else the token
    embedding."""
    if cfg.input_kind == "embeds":
        h = batch["embeds"]
    else:
        h = embed_tokens(cfg, params, batch["tokens"], ctx)
    return h.to(_dtype(cfg.compute_dtype))


def _encdec_forward(cfg: ArchConfig, params: Params, batch: dict, build_cache: bool, cap: int,
                    *, ctx=None, remat: bool = False):
    """Whisper: the frames plus sinusoidal positions through the non-causal
    encoder and ``enc_final_norm``; the token embedding plus ``pos_emb``
    through the decoder (causal self-attention, cross-attention on the
    encoder's output, the MLP).  The frames' length S_enc and the tokens'
    S_dec are independent; with ``build_cache`` each decoder layer's
    ``k``/``v`` fill ``cap`` slots and ``ck``/``cv`` (the encoder output's
    cross K/V) S_enc -> (h, 0, caches or None).  With ``remat`` the encoder
    layers are checkpointed, and the decoder layers unless ``build_cache``."""
    cdt = _dtype(cfg.compute_dtype)
    frames = batch["frames"].to(cdt)
    bsz, s_enc = frames.shape[:2]
    enc_h = frames + L.sinusoidal_positions(s_enc, cfg.d_model, cdt, frames.device)[None]
    enc_pos = _positions(bsz, s_enc, 0, frames.device)
    enc_spec = xspec = attn_spec(cfg, causal=False)

    def enc_body(h, lp):
        h = _sp_constrain(ctx, h, cfg) if remat else h
        a, _ = L.lm_attention(lp["attn"], _norm(cfg, lp["ln1"], h), enc_spec,
                              positions=enc_pos, q_chunk=cfg.q_chunk)
        h = h + _placed_like(a, h)
        return h + _placed_like(L.mlp_apply(lp["mlp"], _norm(cfg, lp["ln2"], h), cfg.mlp), h)

    eb = _checkpointed(enc_body, ctx) if remat else enc_body
    for lp in params["enc_layers"]:
        enc_h = eb(enc_h, lp)
    enc_h = _norm(cfg, params["enc_final_norm"], enc_h)

    tokens = batch["tokens"]
    s_dec = tokens.shape[1]
    h = (embed_tokens(cfg, params, tokens, ctx).to(cdt)
         + _position_rows(ctx, params["pos_emb"], tokens, 0).to(cdt))
    pos = _positions(bsz, s_dec, 0, h.device)
    spec = attn_spec(cfg)
    kvh, dh = spec.n_kv_heads, spec.head_dim

    def dec_body(h, lp):
        h = _sp_constrain(ctx, h, cfg) if remat else h
        a, _ = L.lm_attention(lp["attn"], _norm(cfg, lp["ln1"], h), spec, positions=pos,
                              q_chunk=cfg.q_chunk)
        h = h + _placed_like(a, h)
        xa, _ = L.lm_attention(lp["xattn"], _norm(cfg, lp["ln_x"], h), xspec, positions=pos,
                               kv_x=enc_h, q_chunk=cfg.q_chunk)
        h = h + _placed_like(xa, h)
        return h + _placed_like(L.mlp_apply(lp["mlp"], _norm(cfg, lp["ln2"], h), cfg.mlp), h)

    db = _checkpointed(dec_body, ctx) if remat and not build_cache else dec_body
    caches = {"k": [], "v": [], "ck": [], "cv": []}
    for lp in params["layers"]:
        if build_cache:
            k, v = _extract_kv(cfg, lp["attn"], _norm(cfg, lp["ln1"], h), pos, cap)
            caches["k"].append(k)
            caches["v"].append(v)
            for key, w in (("ck", "wk"), ("cv", "wv")):
                kv = L.rows(enc_h) @ L.tp_weight(lp["xattn"][w]).to(cdt)
                caches[key].append(L.whole_heads(kv, kvh).reshape(bsz, s_enc, kvh, dh))
        h = db(h, lp)
    caches = ({k: torch.stack(v) for k, v in caches.items()} | {"pos": s_dec}
              if build_cache else None)
    h = _norm(cfg, params["final_norm"], h)
    return h, torch.zeros((), device=h.device), caches


def _mamba_layer(cfg: ArchConfig, lp: Params, h, want_state: bool):
    """One pre-norm residual mamba layer -> (h, final state or None)."""
    state = mamba_init_state(cfg.ssm, h.shape[0], h.dtype, h.device) if want_state else None
    out, st = mamba_apply(lp["mamba"], _norm(cfg, lp["ln"], h), cfg.ssm, state=state)
    return h + _placed_like(out, h), st


def _mamba_caches(states: list) -> dict:
    return {"conv": torch.stack([c for c, _ in states]),
            "ssm": torch.stack([s for _, s in states])}


def _shared_after(cfg: ArchConfig, i: int) -> bool:
    """Whether the hybrid family's shared block follows mamba layer ``i``:
    after each whole group of ``shared_attn_every`` layers, not after the
    trailing ``n_layers % shared_attn_every``."""
    if cfg.family != "hybrid":
        return False
    every = cfg.shared_attn_every
    return i < (cfg.n_layers // every) * every and (i + 1) % every == 0


def _mamba_forward(cfg: ArchConfig, params: Params, h, positions, build_cache: bool, cap: int,
                   *, q_chunk, ctx=None, remat: bool = False):
    """The ssm and hybrid stacks: mamba layers and, for zamba2, the shared
    block after each group of ``shared_attn_every`` of them (weights
    shared, cache per invocation) -> (h before the final norm, caches or
    None).  With ``remat`` and no cache to build, each mamba layer is
    checkpointed and, for zamba2, each group with its shared block too
    (the JAX package's ``mamba_body`` and ``super_body``)."""
    emb0 = h
    shared = params.get("shared")

    def mamba_body(h, lp):
        h = _sp_constrain(ctx, h, cfg) if remat else h
        return _mamba_layer(cfg, lp, h, build_cache)

    ckpt = remat and not build_cache
    mb = _checkpointed(mamba_body, ctx) if ckpt else mamba_body

    def group_body(h, lps):
        states = []
        for lp in lps:
            h, st = mb(h, lp)
            states.append(st)
        kv = None
        if build_cache:
            x = _norm(cfg, shared["ln1"], torch.cat([h, emb0], dim=-1))
            kv = _extract_kv(cfg, shared["attn"], x, positions, cap)
        h, _ = shared_block(cfg, shared, h, emb0, positions, q_chunk=q_chunk)
        return h, states, kv

    gb = _checkpointed(group_body, ctx) if ckpt else group_body
    layers = params["layers"]
    every = cfg.shared_attn_every if cfg.family == "hybrid" else 0
    n_groups = len(layers) // every if every else 0
    states, ks, vs = [], [], []
    for g in range(n_groups):
        h, st, kv = gb(h, layers[g * every:(g + 1) * every])
        states += st
        if build_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    for lp in layers[n_groups * every:]:
        h, st = mb(h, lp)
        states.append(st)
    if not build_cache:
        return h, None
    caches = _mamba_caches(states)
    if cfg.family == "hybrid":
        caches.update(shared_k=torch.stack(ks), shared_v=torch.stack(vs))
    return h, caches


def _cache_capacity(cfg: ArchConfig, shape: ShapeCfg) -> int:
    if cfg.window is not None:
        return min(cfg.window, shape.seq)
    return shape.seq


def _extract_kv(cfg: ArchConfig, attn_p: Params, x, positions, cap: int):
    """One layer's cache-ready K/V (rope-rotated at ``positions``, (B, S) or
    M-RoPE's (3, B, S)) in ``cap`` slots; recomputes the projections, as the
    JAX package does."""
    spec = attn_spec(cfg)
    bsz, seq, dt = x.shape[0], x.shape[1], x.dtype
    kvh, dh = spec.n_kv_heads, spec.head_dim
    k, v = (L.whole_heads(L.rows(x) @ L.tp_weight(attn_p[w]).to(dt), kvh)
            .reshape(bsz, seq, kvh, dh) for w in ("wk", "wv"))
    if spec.qk_norm:
        k = L.rms_norm(k, attn_p["k_norm"])
    if spec.rope is not None:
        k = L.apply_rope(k, positions, base=spec.rope_base, rotary_frac=spec.rotary_frac,
                         mrope_sections=spec.mrope_sections)
    return _pack_cache(cfg, k, cap), _pack_cache(cfg, v, cap)


def _pack_cache(cfg: ArchConfig, kv: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, cap, KV, dh): zero slots after the sequence, or
    for a sliding window longer than ``cap`` the rolling layout, where slot
    ``j`` holds the last position ``p < S`` with ``p % cap == j`` (on each
    rank's shard, where one holds whole sequences)."""
    return L.per_shard(lambda t: _pack_slots(cfg, t, cap), kv, dims=(1,))


def _pack_slots(cfg: ArchConfig, kv: torch.Tensor, cap: int) -> torch.Tensor:
    seq = kv.shape[1]
    if cfg.window is None or seq <= cap:
        if seq == cap:
            return kv
        return torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, cap - seq))
    j = torch.arange(cap, device=kv.device)
    return kv[:, seq - 1 - ((seq - 1 - j) % cap)]


# ==========================================================================
# decode
# ==========================================================================


def init_cache(cfg: ArchConfig, shape: ShapeCfg, dtype=torch.bfloat16, pos: int | None = None,
               device=None) -> dict:
    """Zero serve cache for a decode shape: ``min(window, shape.seq)`` KV
    slots per attention layer (``shape.seq`` without a window), for encdec
    also ``shape.seq`` cross K/V slots per decoder layer (a prefill's
    ``ck``/``cv`` have the frames' own length), a zero mamba state per
    mamba layer; ``pos`` (default ``shape.seq - 1``) is the position the
    next decode step takes."""
    cap, b = _cache_capacity(cfg, shape), shape.batch
    pos = shape.seq - 1 if pos is None else pos

    def zeros(*size):
        return torch.zeros(size, dtype=dtype, device=device)

    kv = (b, cap, cfg.n_kv_heads, cfg.head_dim)
    if cfg.family in _ATTN_FAMILIES:
        return {"k": zeros(cfg.n_layers, *kv), "v": zeros(cfg.n_layers, *kv), "pos": pos}
    if cfg.family == "encdec":
        xkv = (b, shape.seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": zeros(cfg.n_layers, *kv), "v": zeros(cfg.n_layers, *kv),
                "ck": zeros(cfg.n_layers, *xkv), "cv": zeros(cfg.n_layers, *xkv), "pos": pos}
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")
    conv, ssm = mamba_init_state(cfg.ssm, b, dtype, device)
    cache = {"conv": zeros(cfg.n_layers, *conv.shape), "ssm": zeros(cfg.n_layers, *ssm.shape),
             "pos": pos}
    if cfg.family == "hybrid":
        n_inv = cfg.n_layers // cfg.shared_attn_every
        cache.update(shared_k=zeros(n_inv, *kv), shared_v=zeros(n_inv, *kv))
    return cache


def decode_step(cfg: ArchConfig, params: Params, cache: dict, batch: dict, ctx=None):
    """One-token decode -> (logits (B, 1, Vpad), new cache); ``cache`` is
    not written.  ``batch`` holds ``tokens`` (B, 1), or for vlm ``embeds``
    (B, 1, d) and M-RoPE ``positions`` (3, B, 1).  Whisper's decoder adds
    ``pos_emb`` at ``pos`` (clamped to the table, as the JAX package's
    ``dynamic_slice``) and attends across to the cache's ``ck``/``cv``,
    which it carries over as they are.  On a ``DeviceMesh`` the cache is
    placed by ``cache_pspecs`` (its slots split over the model axis) and
    the new one comes back so placed."""
    with _scope(ctx):
        return _decode_step(cfg, params, cache, batch, ctx)


def _decode_step(cfg: ArchConfig, params: Params, cache: dict, batch: dict, ctx):
    pos = cache["pos"]
    h = _embed_input(cfg, params, batch, ctx)  # (B, 1, d)
    positions = batch.get("positions")
    if positions is None or cfg.family == "encdec":
        positions = _positions(h.shape[0], 1, pos, h.device)
    if cfg.family == "encdec":
        row = min(max(pos, 0), params["pos_emb"].shape[0] - 1)
        h = h + _position_rows(ctx, params["pos_emb"], batch["tokens"], row).to(h.dtype)
        spec, xspec = attn_spec(cfg), attn_spec(cfg, causal=False)
        ks, vs = [], []
        for i, lp in enumerate(params["layers"]):
            a, (k, v) = L.lm_attention(lp["attn"], _norm(cfg, lp["ln1"], h), spec,
                                       positions=positions, cache_pos=pos,
                                       kv_cache=(cache["k"][i], cache["v"][i]))
            h = h + _placed_like(a, h)
            xa, _ = L.lm_attention(lp["xattn"], _norm(cfg, lp["ln_x"], h), xspec,
                                   positions=positions,
                                   precomputed_kv=(cache["ck"][i], cache["cv"][i]))
            h = h + _placed_like(xa, h)
            h = h + _placed_like(L.mlp_apply(lp["mlp"], _norm(cfg, lp["ln2"], h), cfg.mlp), h)
            ks.append(k)
            vs.append(v)
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs), "ck": cache["ck"],
                     "cv": cache["cv"]}
    elif cfg.family in _ATTN_FAMILIES:
        mode = "rolling" if cfg.window is not None else "linear"
        ks, vs = [], []
        for i, lp in enumerate(params["layers"]):
            h, (k, v), _ = dense_block(cfg, lp, h, positions,
                                       cache=(cache["k"][i], cache["v"][i]), cache_pos=pos,
                                       cache_mode=mode, ctx=ctx)
            ks.append(k)
            vs.append(v)
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    else:
        emb0 = h
        states, ks, vs = [], [], []
        for i, lp in enumerate(params["layers"]):
            out, st = mamba_decode_step(lp["mamba"], _norm(cfg, lp["ln"], h), cfg.ssm,
                                        (cache["conv"][i], cache["ssm"][i]))
            h = h + _placed_like(out, h)
            states.append(st)
            if _shared_after(cfg, i):
                g = len(ks)
                h, (k, v) = shared_block(cfg, params["shared"], h, emb0, positions,
                                         cache=(cache["shared_k"][g], cache["shared_v"][g]),
                                         cache_pos=pos)
                ks.append(k)
                vs.append(v)
        new_cache = _mamba_caches(states)
        if cfg.family == "hybrid":
            new_cache.update(shared_k=torch.stack(ks), shared_v=torch.stack(vs))
    new_cache["pos"] = pos + 1
    h = _norm(cfg, params["final_norm"], h)
    return lm_logits(cfg, params, h), new_cache


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


def _dp_size(ctx) -> int:
    """How many ways the batch is split over the data axes (1 without a
    ctx or with ``shard_batch`` off)."""
    if ctx is None or not ctx.shard_batch:
        return 1
    n = 1
    for a in ctx.data_axes:
        n *= axis_size(ctx.mesh, a)
    return n


def make_train_step(cfg: ArchConfig, ctx, optimizer, shape: ShapeCfg):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "aux"})``: every f32 parameter cast to ``cfg.compute_dtype``
    for the forward, each layer rematerialised in the backward, the loss in
    f32 plus ``AUX_LOSS_WEIGHT`` times the MoE aux loss, gradients
    accumulated over ``cfg.grad_accum[shape.name]`` strided microbatches
    (no more than the batch over the data axes allows; in the compute dtype
    with ``low_precision_opt``)."""
    accum = max(min(cfg.grad_accum.get(shape.name, 1), shape.batch // max(_dp_size(ctx), 1)), 1)
    cdt = _dtype(cfg.compute_dtype)

    def loss_fn(params, mb):
        params_c = tree_map(lambda p: p.to(cdt) if p.dtype == torch.float32 else p, params)
        h, aux, _ = forward_seq(cfg, params_c, mb, ctx, remat=True)
        loss = ce_loss(cfg, lm_logits(cfg, params_c, h), mb["labels"])
        return loss + AUX_LOSS_WEIGHT * aux, (loss, aux)

    def train_step(params, opt_state, batch):
        with _scope(ctx):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if accum == 1:
            (_, (loss, aux)), grads = value_and_grad(loss_fn, params, batch, has_aux=True)
        else:
            mbs = _split_microbatches(batch, accum)
            acc_dt = cdt if cfg.low_precision_opt else None
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt or p.dtype), params)
            lsum = asum = 0.0
            for i in range(accum):
                (_, (l, a)), g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in mbs.items()}, has_aux=True)
                gsum = tree_map(lambda a_, g_: a_ + g_.to(a_.dtype), gsum, g)
                lsum, asum = l + lsum, a + asum
            grads = tree_map(lambda g: g / accum, gsum)
            loss, aux = lsum / accum, asum / accum
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "aux": aux}

    return train_step


def make_prefill_step(cfg: ArchConfig, ctx, shape: ShapeCfg):
    """``prefill(params, batch) -> (last position's logits (B, 1, Vpad),
    caches for ``shape``)``.  With ``cfg.serve_microbatch[shape.name] = mb
    > 1`` the batch is prefilled as ``mb`` strided sub-batches (``v[i::mb]``,
    ``positions`` on its axis 1), and the logits and every cache leaf are
    interleaved back into the batch's order, as in the JAX package.  ``mb``
    is clamped to the batch over the data axes.  On a ``DeviceMesh`` the
    caches come out placed by ``cache_pspecs``, and a batch split over the
    data axes is split on each rank's own rows (:func:`_strided`)."""
    mb = max(min(cfg.serve_microbatch.get(shape.name, 1), shape.batch // max(_dp_size(ctx), 1)),
             1)
    specs = None
    if _on_cards(ctx):
        n_dp = math.prod(axis_size(ctx.mesh, a) for a in ctx.data_axes)
        specs = cache_pspecs(cfg, shape, "pod" in ctx.data_axes, n_dp)

    def one(params, batch):
        h, _, caches = forward_seq(cfg, params, batch, ctx, want_cache=shape)
        return lm_logits(cfg, params, h[:, -1:, :]), caches

    def place(logits, caches):
        if specs is not None:
            caches = {k: v if k == "pos" else _constrain(ctx, v, specs[k])
                      for k, v in caches.items()}
        return logits, caches

    def prefill_step(params, batch):
        with _scope(ctx):
            if mb == 1:
                return place(*one(params, batch))
            outs = [one(params, {k: _strided(v, _BATCH_AXIS.get(k, 0), i, mb)
                                 for k, v in batch.items()}) for i in range(mb)]
            # merged[j * mb + i] = outs[i][j]; a cache leaf's batch is axis 1
            caches = {k: v if k == "pos" else _interleave([o[1][k] for o in outs], 1)
                      for k, v in outs[0][1].items()}
            return place(_interleave([o[0] for o in outs], 0), caches)

    return prefill_step


def _strided(x, ax: int, i: int, mb: int):
    """``x``'s rows ``i::mb`` along ``ax``.  A ``DTensor`` split along
    ``ax`` into shards whose rows divide by ``mb`` takes them from its local
    rows: they are the global sub-batch's own shard (and ``torch.stack``
    then ``reshape`` interleave such shards back where they came from)."""
    sl = [slice(None)] * x.ndim
    sl[ax] = slice(i, None, mb)
    if is_dtensor(x):
        n = 1
        for p, size in zip(x.placements, x.device_mesh.shape):
            n *= size if p.is_shard(ax) else 1
        if n > 1 and x.shape[ax] % (n * mb) == 0:
            from torch.distributed.tensor import DTensor

            return DTensor.from_local(x.to_local()[tuple(sl)], x.device_mesh, x.placements,
                                      run_check=False)
    return x[tuple(sl)]


def _interleave(parts: list, ax: int):
    """``merged[j * mb + i] = parts[i][j]`` along ``ax``, ``mb = len(parts)``."""
    st = torch.stack(parts, dim=ax + 1)
    return st.reshape(*st.shape[:ax], -1, *st.shape[ax + 2:])


def make_serve_step(cfg: ArchConfig, ctx):
    def serve_step(params, cache, batch):
        return decode_step(cfg, params, cache, batch, ctx)

    return serve_step
