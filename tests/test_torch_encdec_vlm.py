"""The encdec (whisper-small) and vlm (qwen2-vl-2b) LM families at their
SMOKE configs: the port's layers (whisper's sinusoidal positions, the GELU
MLP, M-RoPE, cross-attention and given K/V) and its forward, loss, train
updates, prefill caches and decode against the JAX package's, on the JAX
package's parameters (carried across by ``params_from_jax``, which splits
both of whisper's stacks) and the same numpy inputs; decode against the
forward, the batch-split prefill, the train CLI and a checkpoint round trip.

Whisper runs with frames of another length than its tokens (24 frames
against 16 to 128 tokens; 72 frames split the 32-slot KV blocks with
padding).  qwen2-vl's M-RoPE positions follow Qwen2-VL's layout: a text
token at index ``i`` gets ``(i, i, i)``, an image of ``gh x gw`` patches
starting at ``s`` gets ``(s, s + r, s + c)``, and the text after it
resumes at ``s + max(gh, gw)``; so the three components differ and the
position values run behind the token order, which the masks follow.

Tolerances: the layers within rtol = atol = 1e-6; logits, losses, caches
and decode logits within rtol = atol = 1e-5 in f32 (the same math; XLA and
torch sum the matmuls, norms and softmax in another order).  One SGD
update at lr 1 (so every gradient) and one AdamW update within 1e-5.
Decode against the full forward within ``2e-3 * max(|ref|, 1)``, the JAX
package's own bound (tests/test_models.py).  bf16 losses within rtol 2e-2,
as in tests/test_torch_lm.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCfg as JShapeCfg
from repro.models import layers as JL
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro.training.optimizer import adamw as jadamw
from repro.training.optimizer import sgd as jsgd
from repro_torch import tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import train
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import adamw, sgd

ARCHS = ["whisper-small", "qwen2-vl-2b"]
TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
B, S = 2, 64
S_ENC = 24  # whisper's frames: another length than the tokens'


def _setup(arch, **replace):
    jcfg = dataclasses.replace(jreg.build(arch, smoke=True).cfg, **replace)
    cfg = dataclasses.replace(registry.build(arch, smoke=True).cfg, **replace)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, params


def qwen2vl_positions(rows) -> np.ndarray:
    """(3, B, S) M-RoPE positions of Qwen2-VL's layout; each row a list of
    segments, ``("text", n)`` or ``("image", gh, gw)``."""
    out = []
    for segments in rows:
        pos, nxt = [], 0
        for seg in segments:
            if seg[0] == "text":
                pos += [(nxt + i,) * 3 for i in range(seg[1])]
                nxt += seg[1]
            else:
                _, gh, gw = seg
                pos += [(nxt, nxt + r, nxt + c) for r in range(gh) for c in range(gw)]
                nxt += max(gh, gw)
        out.append(pos)
    return np.asarray(out, np.int32).transpose(2, 0, 1)


def _batch(cfg, seq=S, seed=1, batch=B, s_enc=S_ENC):
    """numpy inputs of ``seq`` positions and labels: whisper's frames and
    tokens, or qwen2-vl's embeds with Qwen2-VL's positions (even rows: a
    few text tokens, a 4 x 6 image (2 x 3 below 32 positions), text; odd
    rows: the image first)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        inputs = {"frames": rng.standard_normal((batch, s_enc, cfg.d_model)).astype(np.float32),
                  "tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    else:
        gh, gw = (4, 6) if seq >= 32 else (2, 3)
        lead = seq // 8
        rows = [[("text", lead), ("image", gh, gw), ("text", seq - lead - gh * gw)] if i % 2 == 0
                else [("image", gh, gw), ("text", seq - gh * gw)] for i in range(batch)]
        inputs = {"embeds": rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32),
                  "positions": qwen2vl_positions(rows)}
    labels = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    labels[0, :5] = -1  # ignored positions
    return inputs, labels


def _prefix(inputs, n):
    """The inputs of the first ``n`` positions (whisper's frames whole)."""
    return {k: v if k == "frames" else v[..., :n] if k == "positions" else v[:, :n]
            for k, v in inputs.items()}


def _step(inputs, t):
    """One decode step's inputs at position ``t``."""
    return {k: v[..., t:t + 1] if k == "positions" else v[:, t:t + 1]
            for k, v in inputs.items() if k != "frames"}


def _t(inputs):
    return {k: torch.tensor(v) for k, v in inputs.items()}


def _j(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def _tree_close(got, want, **tol):
    g_flat, g_def = tree.flatten(got)
    w_flat, w_def = tree.flatten(want)
    assert g_def == w_def
    for g, w in zip(g_flat, w_flat):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **tol)


def _caches_close(cache, jcache, **tol):
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        if k == "pos":
            assert cache[k] == int(jcache[k])
        else:
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), **tol, err_msg=k)


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("seq,d", [(1, 8), (S_ENC, 64), (1500, 64), (1500, 768)])
def test_sinusoidal_positions_match_reference(seq, d):
    """``[sin | cos]`` (not interleaved) of ``pos / 10000^(2i/d)`` in f32;
    1500 is whisper's encoder length at 30 s, 768 its width.  At 768 the
    two packages' f32 ``pow`` round a few of the 384 denominators to
    neighbouring floats (torch's CPU ``pow`` is not correctly rounded, XLA's
    is off in one), so an angle may differ by its relative rounding,
    ``pos * 2^-23``: held to that, plus 1e-6.  Both are held to the f64
    formula within the same (an f32 angle is rounded twice)."""
    got = L.sinusoidal_positions(seq, d)
    want = np.asarray(JL.sinusoidal_positions(seq, d))
    pos, i = np.arange(seq)[:, None], np.arange(0, d, 2)[None, :]
    angle = pos / 10000.0 ** (i / d)
    exact = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    rounding = 1e-6 + (seq - 1) * 2.0 ** -23  # the f32 angle's two roundings
    for table in (got.numpy(), want):
        assert float(np.abs(table - exact).max()) <= rounding
    assert float(np.abs(got.numpy() - want).max()) <= (rounding if d > 64 else 1e-6)
    half = L.sinusoidal_positions(seq, d, torch.bfloat16)
    assert half.dtype == torch.bfloat16
    torch.testing.assert_close(half, got.to(torch.bfloat16), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_reference(kind):
    """GELU with tanh (``jax.nn.gelu``'s default; the exact erf differs by
    up to about 5e-4) and biases; SwiGLU, the default kind, as before."""
    jp = JL.mlp_init(jax.random.PRNGKey(0), 64, 128, kind)
    jp = jax.tree.map(lambda a: a + 0.1, jp)  # nonzero biases
    p = {k: torch.tensor(np.asarray(a)) for k, a in jp.items()}
    assert sorted(p) == sorted(L.mlp_init(None, 64, 128, kind))
    x = (np.random.default_rng(1).standard_normal((2, 16, 64)) * 2).astype(np.float32)
    want = np.asarray(JL.mlp_apply(jp, jnp.asarray(x), kind))
    args = (kind,) if kind == "gelu" else ()
    np.testing.assert_allclose(L.mlp_apply(p, torch.tensor(x), *args).numpy(), want, **LAYER_TOL)


@pytest.mark.parametrize("dh,sections,base", [(16, (2, 3, 3), 10000.0),
                                              (128, (16, 24, 24), 1e6)])
def test_mrope_matches_reference(dh, sections, base):
    """M-RoPE on Qwen2-VL's layout (three components that differ) against
    the reference; with equal components it is the standard rotation, and
    another section selector gives another result."""
    pos = qwen2vl_positions([[("text", 5), ("image", 3, 4), ("text", 7)],
                             [("image", 6, 2), ("text", 12)]])
    x = np.random.default_rng(2).standard_normal((2, pos.shape[2], 3, dh)).astype(np.float32)
    got = L.apply_rope(torch.tensor(x), torch.tensor(pos), base=base, mrope_sections=sections)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), base=base, mrope_sections=sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    same = np.broadcast_to(pos[:1], pos.shape)
    torch.testing.assert_close(
        L.apply_rope(torch.tensor(x), torch.tensor(same), base=base, mrope_sections=sections),
        L.apply_rope(torch.tensor(x), torch.tensor(pos[0]), base=base), rtol=0, atol=0)
    other = L.apply_rope(torch.tensor(x), torch.tensor(pos), base=base,
                         mrope_sections=sections[::-1])
    assert float((other - got).abs().max()) > 1e-2


def test_mrope_needs_three_position_components():
    x = torch.zeros(2, 4, 1, 16)
    with pytest.raises(ValueError, match="M-RoPE"):
        L.apply_rope(x, torch.zeros(2, 4, dtype=torch.int32), mrope_sections=(2, 3, 3))
    with pytest.raises(AssertionError, match="M-RoPE"):  # the reference asserts
        JL.apply_rope(jnp.zeros((2, 4, 1, 16)), jnp.zeros((2, 4), jnp.int32),
                      mrope_sections=(2, 3, 3))


def _attn_pair(kv_heads=2):
    spec = L.AttnSpec(n_heads=4, n_kv_heads=kv_heads, head_dim=16, attn_block=16)
    jspec = JL.AttnSpec(n_heads=4, n_kv_heads=kv_heads, head_dim=16, attn_block=16)
    jp = JL.attn_init(jax.random.PRNGKey(3), 64, jspec)
    return spec, jspec, {k: torch.tensor(np.asarray(a)) for k, a in jp.items()}, jp


@pytest.mark.parametrize("sq,skv,q_chunk", [(16, 24, None), (64, 40, 32), (1, 24, None)])
def test_cross_attention_matches_reference(sq, skv, q_chunk):
    """K/V from ``kv_x`` of another length: no rope and no causal mask
    although the spec is causal with rope; 24 and 40 keys pad the last
    16-slot block, 64 queries run as two chunks, 1 query the one-shot
    softmax."""
    spec, jspec, p, jp = _attn_pair()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, sq, 64)).astype(np.float32)
    kv = rng.standard_normal((B, skv, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (B, sq))
    got, cache = L.lm_attention(p, torch.tensor(x), spec, positions=torch.tensor(pos),
                                kv_x=torch.tensor(kv), q_chunk=q_chunk)
    want, _ = JL.attention(jp, jnp.asarray(x), jspec, positions=jnp.asarray(pos),
                           kv_x=jnp.asarray(kv), q_chunk=q_chunk)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("sq", [1, 16])
def test_precomputed_kv_matches_reference(sq):
    """Given K/V (whisper's decode on ``ck``/``cv``): no projection of
    them, no rope, no mask."""
    spec, jspec, p, jp = _attn_pair()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, sq, 64)).astype(np.float32)
    k, v = (rng.standard_normal((B, 24, 2, 16)).astype(np.float32) for _ in range(2))
    pos = np.full((B, sq), 30, np.int32)
    got, _ = L.lm_attention(p, torch.tensor(x), spec, positions=torch.tensor(pos),
                            precomputed_kv=(torch.tensor(k), torch.tensor(v)))
    want, _ = JL.attention(jp, jnp.asarray(x), jspec, positions=jnp.asarray(pos),
                           precomputed_kv=(jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_unread_leaf_gets_a_zero_gradient():
    """As under ``jax.grad``; the leaves the loss reads are unchanged."""
    params = {"a": torch.arange(3.0), "b": torch.ones(2), "c": [torch.ones(4)]}
    loss, grads = tree.value_and_grad(lambda p: (p["a"] ** 2).sum() + p["c"][0].sum(), params)
    assert float(loss) == 9.0
    torch.testing.assert_close(grads["a"], 2 * params["a"], rtol=0, atol=0)
    torch.testing.assert_close(grads["b"], torch.zeros(2), rtol=0, atol=0)
    torch.testing.assert_close(grads["c"][0], torch.ones(4), rtol=0, atol=0)


# ----------------------------------------------------------------- params


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_splits_the_stacks(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    fresh = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert tree.flatten(fresh)[1] == tree.flatten(params)[1]  # same structure as init
    for a, b in zip(tree.leaves(fresh), tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    n = sum(int(x.numel()) for x in tree.leaves(params))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.enc_layers}
    for key, jv in jparams.items():
        if key in stacks:
            assert len(params[key]) == stacks[key]
            for i, lp in enumerate(params[key]):
                for a, b in zip(tree.leaves(lp), jax.tree_util.tree_leaves(jv)):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b)[i])
        else:
            for a, b in zip(tree.leaves(params[key]), jax.tree_util.tree_leaves(jv)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if cfg.family == "encdec":
        assert params["pos_emb"].shape == (cfg.max_target_positions, cfg.d_model)
        assert sorted(params["layers"][0]) == ["attn", "ln1", "ln2", "ln_x", "mlp", "xattn"]
        assert sorted(params["enc_layers"][0]) == ["attn", "ln1", "ln2", "mlp"]
        assert sorted(params["layers"][0]["mlp"]) == ["bi", "bo", "wi", "wo"]
        torch.testing.assert_close(fresh["enc_final_norm"]["scale"], torch.ones(cfg.d_model))


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("arch,seq,s_enc", [("whisper-small", 16, S_ENC),
                                            ("whisper-small", 128, 72),
                                            ("qwen2-vl-2b", S, None),
                                            ("qwen2-vl-2b", 128, None)])
def test_forward_logits_and_loss_match_reference(arch, seq, s_enc):
    """forward_seq + lm_logits + ce_loss; 128 positions run as two query
    chunks of 64 and 72 frames pad the encoder's last KV block."""
    jcfg, cfg, jparams, params = _setup(arch)
    inputs, labels = _batch(cfg, seq=seq, s_enc=s_enc)
    h, aux, caches = T.forward_seq(cfg, params, _t(inputs))
    logits = T.lm_logits(cfg, params, h)
    jh, _, _ = JT.forward_seq(jcfg, jparams, _j(inputs), None)
    jlogits = JT.lm_logits(jcfg, jparams, jh)
    assert logits.shape == (B, seq, cfg.vocab_padded) and caches is None and float(aux) == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(T.ce_loss(cfg, logits, torch.tensor(labels))),
                               float(JT.ce_loss(jcfg, jlogits, jnp.asarray(labels))), **TOL)


@pytest.mark.parametrize("arch,opt_name,accum", [(a, o, n) for a in ARCHS
                                                 for o, n in (("sgd", 1), ("sgd", 2),
                                                              ("adamw", 1))])
def test_train_update_matches_reference(arch, opt_name, accum):
    """One update from the same parameters: the loss and every updated
    parameter within 1e-5; SGD at lr 1 (so every gradient), AdamW at lr
    1e-3 with eps 1e-6 (its first step moves an element by ``lr * g /
    (|g| + eps)``: at the default eps 1e-8 a gradient that is zero but for
    rounding, as some attention weights' are, turns the two packages'
    summation orders into an O(lr) difference; at 1e-6 it cannot);
    ``accum=2`` runs the strided microbatch split (qwen2-vl's positions on
    their axis 1).  qwen2-vl's ``embed``, which the loss never reads, gets a
    zero gradient: both optimizers leave it exactly as it was, in both
    packages."""
    jcfg, cfg, jparams, params = _setup(arch, grad_accum={"smoke": accum})
    shape, jshape = ShapeCfg("smoke", "train", S, B), JShapeCfg("smoke", "train", S, B)
    inputs, labels = _batch(cfg)
    if opt_name == "sgd":
        opt, jopt = sgd(1.0), jsgd(1.0)
    else:
        opt, jopt = adamw(1e-3, eps=1e-6), jadamw(1e-3, eps=1e-6)
    new, state, m = T.make_train_step(cfg, None, opt, shape)(
        params, opt.init(params), _t(inputs) | {"labels": torch.tensor(labels)})
    jnew, _, jm = jax.jit(JT.make_train_step(jcfg, None, jopt, jshape))(
        jparams, jopt.init(jparams), _j(inputs) | {"labels": jnp.asarray(labels)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    _tree_close(new, T.params_from_jax(cfg, jax.tree.map(np.asarray, jnew)), **TOL)
    assert int(state["step"]) == 1
    if cfg.input_kind == "embeds":
        np.testing.assert_array_equal(new["embed"].numpy(), np.asarray(jnew["embed"]))
        torch.testing.assert_close(new["embed"], params["embed"], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_reference(arch):
    jcfg, cfg, jparams, params = _setup(arch, compute_dtype="bfloat16")
    inputs, labels = _batch(cfg)
    h, _, _ = T.forward_seq(cfg, tree.tree_map(lambda p: p.to(torch.bfloat16), params),
                            _t(inputs))
    assert h.dtype == torch.bfloat16
    loss = T.ce_loss(cfg, T.lm_logits(cfg, params, h), torch.tensor(labels))
    jp = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jparams)
    jh, _, _ = JT.forward_seq(jcfg, jp, _j(inputs), None)
    jloss = JT.ce_loss(jcfg, JT.lm_logits(jcfg, jparams, jh), jnp.asarray(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)


# ---------------------------------------------------------- prefill/decode


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_decode_step_match_reference(arch):
    """The prefill's logits and caches leaf by leaf (``k``, ``v`` over the
    decode shape's slots; whisper's ``ck``, ``cv`` over its 24 frames, not
    the shape's 46), then each decode step's logits and cache against the
    reference's decode of the same cache; the cache passed in is not
    written."""
    s0, extra = 40, 6
    seq = s0 + extra
    jcfg, cfg, jparams, params = _setup(arch)
    inputs, _ = _batch(cfg, seq=seq)
    logits, cache = T.make_prefill_step(cfg, None, ShapeCfg("t", "decode", seq, B))(
        params, _t(_prefix(inputs, s0)))
    jlogits, jcache = JT.make_prefill_step(jcfg, None, JShapeCfg("t", "decode", seq, B))(
        jparams, _j(_prefix(inputs, s0)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _caches_close(cache, jcache, **TOL)
    assert cache["k"].shape[2] == seq
    if cfg.family == "encdec":
        assert cache["ck"].shape == (cfg.n_layers, B, S_ENC, cfg.n_kv_heads, cfg.head_dim)
    serve = T.make_serve_step(cfg, None)
    jserve = jax.jit(JT.make_serve_step(jcfg, None))
    for t in range(s0, seq):
        before = {k: v.clone() for k, v in cache.items() if k != "pos"}
        lg, new_cache = serve(params, cache, _t(_step(inputs, t)))
        for k, v in before.items():
            torch.testing.assert_close(cache[k], v, rtol=0, atol=0)  # not written
        jlg, jcache = jserve(jparams, jcache, _j(_step(inputs, t)))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        _caches_close(new_cache, jcache, **TOL)
        cache = new_cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The JAX package's test: 16 prefilled positions and 4 decode steps
    against the full forward (whisper's over the same 24 frames)."""
    s0, seq = 16, 20
    _, cfg, _, params = _setup(arch)
    inputs, _ = _batch(cfg, seq=seq)
    logits, cache = T.make_prefill_step(cfg, None, ShapeCfg("t", "decode", seq, B))(
        params, _t(_prefix(inputs, s0)))
    dec = [logits]
    for t in range(s0, seq):
        lg, cache = T.decode_step(cfg, params, cache, _t(_step(inputs, t)))
        dec.append(lg)
    dec = torch.cat(dec[:-1], dim=1).numpy()
    h, _, _ = T.forward_seq(cfg, params, _t(inputs))
    ref = T.lm_logits(cfg, params, h)[:, s0 - 1:seq - 1].numpy()
    err = float(np.abs(dec - ref).max())
    assert err < 2e-3 * max(float(np.abs(ref).max()), 1.0), (arch, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_prefill_matches_reference_and_unsplit(arch):
    """``serve_microbatch`` 2 at batch 4: whisper's frames and qwen2-vl's
    embeds split on axis 0, its positions on axis 1; logits and caches
    interleaved back, against the reference's split prefill and the
    port's unsplit one."""
    jcfg, cfg, jparams, params = _setup(arch, serve_microbatch={"t": 2})
    inputs, _ = _batch(cfg, seq=40, batch=4)
    shape, jshape = ShapeCfg("t", "decode", 44, 4), JShapeCfg("t", "decode", 44, 4)
    logits, cache = T.make_prefill_step(cfg, None, shape)(params, _t(inputs))
    jlogits, jcache = JT.make_prefill_step(jcfg, None, jshape)(jparams, _j(inputs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _caches_close(cache, jcache, **TOL)
    whole = dataclasses.replace(cfg, serve_microbatch={})
    w_logits, w_cache = T.make_prefill_step(whole, None, shape)(params, _t(inputs))
    np.testing.assert_allclose(logits.numpy(), w_logits.numpy(), **TOL)
    assert sorted(cache) == sorted(w_cache) and cache["pos"] == w_cache["pos"] == 40
    for k in cache:
        if k != "pos":
            np.testing.assert_allclose(cache[k].numpy(), w_cache[k].numpy(), **TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference_layout(arch):
    """whisper's ``ck``/``cv`` hold ``shape.seq`` slots here, as the
    reference's ``init_cache`` sizes them."""
    cfg, jcfg = registry.build(arch, smoke=True).cfg, jreg.build(arch, smoke=True).cfg
    cache = T.init_cache(cfg, ShapeCfg("t", "decode", 48, 3))
    jcache = JT.init_cache(jcfg, JShapeCfg("t", "decode", 48, 3))
    assert sorted(cache) == sorted(jcache) and cache["pos"] == int(jcache["pos"]) == 47
    for k in cache:
        if k != "pos":
            assert tuple(cache[k].shape) == jcache[k].shape, k
            assert cache[k].dtype == torch.bfloat16 and not cache[k].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_a_zero_cache_matches_reference(arch):
    """Three decode steps from ``init_cache``'s zero bf16 cache under the
    f32 SMOKE config, from position 10 (whisper's ``pos_emb`` row follows
    it), against the reference's decode from its own ``init_cache``: logits
    within 1e-5, the bf16 caches within bf16's rounding, each leaf in the
    reference's dtype."""
    jcfg, cfg, jparams, params = _setup(arch)
    cache = T.init_cache(cfg, ShapeCfg("t", "decode", 40, B), pos=10)
    jcache = JT.init_cache(jcfg, JShapeCfg("t", "decode", 40, B), pos=10)
    inputs, _ = _batch(cfg, seq=40)
    for t in range(3):
        step = _step(inputs, 10 + t)
        lg, cache = T.decode_step(cfg, params, cache, _t(step))
        jlg, jcache = JT.decode_step(jcfg, jparams, jcache, _j(step), None)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        for k in cache:
            if k != "pos":
                assert str(cache[k].dtype) == f"torch.{jcache[k].dtype}", k
                np.testing.assert_allclose(cache[k].float().numpy(),
                                           np.asarray(jcache[k], np.float32),
                                           rtol=2 ** -8, atol=1e-5, err_msg=k)
    assert cache["pos"] == int(jcache["pos"]) == 13


def test_decode_past_the_position_table_clamps():
    """Whisper's decode at and past ``max_target_positions`` adds its last
    ``pos_emb`` row, as the reference's ``dynamic_slice`` clamps."""
    jcfg, cfg, jparams, params = _setup("whisper-small")
    n = cfg.max_target_positions
    cache = T.init_cache(cfg, ShapeCfg("t", "decode", n + 2, B), dtype=torch.float32, pos=n - 1)
    jcache = JT.init_cache(jcfg, JShapeCfg("t", "decode", n + 2, B), dtype=jnp.float32, pos=n - 1)
    inputs, _ = _batch(cfg, seq=3)
    for t in range(3):
        lg, cache = T.decode_step(cfg, params, cache, _t(_step(inputs, t)))
        jlg, jcache = JT.decode_step(jcfg, jparams, jcache, _j(_step(inputs, t)), None)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    assert cache["pos"] == n + 2


# ------------------------------------------------------ CLI and checkpoint


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(tmp_path, arch, capsys):
    out = train.main(["--arch", arch, "--steps", "2", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path), "--batch", "4", "--seq", "32"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "[train] done" in capsys.readouterr().out
    cfg = registry.get_config(arch, smoke=True)
    assert len(out["params"]["layers"]) == cfg.n_layers
    assert len(out["params"].get("enc_layers", [])) == cfg.enc_layers


def test_whisper_checkpoint_round_trip(tmp_path):
    """A whisper tree with its AdamW state: both stacks, ``pos_emb`` and
    the GELU biases saved and restored bitwise, leaf for leaf."""
    _, cfg, _, params = _setup("whisper-small")
    opt = adamw(1e-3)
    state = {"params": params, "opt": opt.init(params)}
    ckpt.save(tmp_path, 3, state)
    like = tree.tree_map(torch.zeros_like, state)
    restored, step = ckpt.restore(tmp_path, None, like)
    assert step == 3 and tree.flatten(restored)[1] == tree.flatten(state)[1]
    for a, b in zip(tree.leaves(restored), tree.leaves(state)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(restored["params"]["enc_layers"]) == cfg.enc_layers
