"""The dense LM family (olmo-1b, qwen3-0.6b, qwen3-1.7b, chatglm3-6b) at
their SMOKE configs: the port's forward, loss, train update, prefill and
decode against the JAX package's on the JAX package's parameters (carried
across by ``params_from_jax``: the two packages' inits draw other values)
and the same numpy tokens; and the ten configs' data (``param_count``,
``supports``) against the JAX package's.

Tolerances: logits and losses within rtol = atol = 1e-5 in f32 (the same
math; XLA and torch sum the matmuls, norms and softmax in another order).
One SGD update at lr 1 (so every gradient) within rtol = atol = 1e-5.  Decode
against the full forward within ``2e-3 * max(|ref|, 1)``, the JAX
package's own bound (tests/test_models.py).  At ``compute_dtype =
"bfloat16"`` the loss within rtol = 2e-2: both round activations to bf16
where the reference does, but bf16 keeps 8 bits and the matmuls round their
outputs after summing in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCfg as JShapeCfg
from repro.configs.base import flops_per_token as jflops_per_token
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro.training.optimizer import sgd as jsgd
from repro_torch import tree
from repro_torch.configs.base import SHAPES, ShapeCfg, flops_per_token
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import sgd

DENSE = ["olmo-1b", "qwen3-0.6b", "qwen3-1.7b", "chatglm3-6b"]
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 64


def _setup(arch, **replace):
    jcfg = dataclasses.replace(jreg.get_config(arch, smoke=True), **replace)
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), **replace)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, params


def _tokens(cfg, seq=S, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(B, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, seq)).astype(np.int32)
    labels[0, :5] = -1  # ignored positions
    return tokens, labels


def _jax_tree_close(got, want, **tol):
    """The port's per-layer tree against the JAX package's stacked one."""
    want = jax.tree.map(np.asarray, want)
    stacked = want.pop("layers")
    got = dict(got)
    layers = got.pop("layers")
    for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)
    for i, lp in enumerate(layers):
        for g, w in zip(tree.leaves(lp), jax.tree_util.tree_leaves(stacked)):
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w[i], np.float32), **tol)


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_jax_splits_the_stack(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    assert len(params["layers"]) == cfg.n_layers
    _jax_tree_close(params, jparams, rtol=0, atol=0)
    n = sum(int(x.numel()) for x in tree.leaves(params))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    fresh = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert tree.flatten(fresh)[1] == tree.flatten(params)[1]  # same structure as init


@pytest.mark.parametrize("q_chunk", [None, 32])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_and_loss_match_reference(arch, q_chunk):
    """forward_seq + lm_logits + ce_loss; ``q_chunk=32`` splits the 64
    queries into two chunks (and ``attn_block`` 32 splits the keys)."""
    kw = {} if q_chunk is None else {"q_chunk": q_chunk}
    jcfg, cfg, jparams, params = _setup(arch, **kw)
    tokens, labels = _tokens(cfg)
    h, _, _ = T.forward_seq(cfg, params, {"tokens": torch.tensor(tokens)})
    logits = T.lm_logits(cfg, params, h)
    jh, _, _ = JT.forward_seq(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, None)
    jlogits = JT.lm_logits(jcfg, jparams, jh)
    assert logits.shape == (B, S, cfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    loss = T.ce_loss(cfg, logits, torch.tensor(labels))
    jloss = JT.ce_loss(jcfg, jlogits, jnp.asarray(labels))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", DENSE)
def test_train_update_matches_reference(arch, accum):
    """One SGD step at lr 1 from the same parameters: the loss and every
    updated parameter, so every gradient within 1e-5; ``accum=2`` runs the
    strided microbatch accumulation.  (AdamW's first step divides each
    gradient by its own magnitude, so an element whose gradient is at the
    rounding level turns a reordered sum into an O(lr) difference; its
    update formula is held on fixed gradients in test_torch_training.py.)"""
    jcfg, cfg, jparams, params = _setup(arch, grad_accum={"smoke": accum})
    shape, jshape = ShapeCfg("smoke", "train", S, B), JShapeCfg("smoke", "train", S, B)
    tokens, labels = _tokens(cfg)
    opt, jopt = sgd(1.0), jsgd(1.0)
    new, state, m = T.make_train_step(cfg, None, opt, shape)(
        params, opt.init(params), {"tokens": torch.tensor(tokens), "labels": torch.tensor(labels)})
    jnew, jstate, jm = jax.jit(JT.make_train_step(jcfg, None, jopt, jshape))(
        jparams, jopt.init(jparams), {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    _jax_tree_close(new, jnew, **TOL)
    assert int(state["step"]) == 1


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_loss_matches_reference(arch):
    jcfg, cfg, jparams, params = _setup(arch, compute_dtype="bfloat16")
    tokens, labels = _tokens(cfg)
    h, _, _ = T.forward_seq(cfg, tree.tree_map(lambda p: p.to(torch.bfloat16), params),
                            {"tokens": torch.tensor(tokens)})
    assert h.dtype == torch.bfloat16
    loss = T.ce_loss(cfg, T.lm_logits(cfg, params, h), torch.tensor(labels))
    jp = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jparams)
    jh, _, _ = JT.forward_seq(jcfg, jp, {"tokens": jnp.asarray(tokens)}, None)
    jloss = JT.ce_loss(jcfg, JT.lm_logits(jcfg, jparams, jh), jnp.asarray(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Teacher-forced decode through the serve cache against the full
    forward (the JAX package's test), and the prefill logits and cache
    against the JAX package's prefill."""
    s0, extra = 16, 4
    seq = s0 + extra
    jcfg, cfg, jparams, params = _setup(arch)
    tokens, _ = _tokens(cfg, seq=seq)
    cache_shape = ShapeCfg("t", "decode", seq, B)
    logits_p, cache = T.make_prefill_step(cfg, None, cache_shape)(
        params, {"tokens": torch.tensor(tokens[:, :s0])})
    jlogits_p, jcache = JT.make_prefill_step(jcfg, None, JShapeCfg("t", "decode", seq, B))(
        jparams, {"tokens": jnp.asarray(tokens[:, :s0])})
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(jlogits_p), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]), **TOL)
    assert cache["pos"] == int(jcache["pos"]) == s0
    serve = T.make_serve_step(cfg, None)
    dec = [logits_p]
    for t in range(s0, seq):
        before = cache["k"].clone()
        lg, new_cache = serve(params, cache, {"tokens": torch.tensor(tokens[:, t:t + 1])})
        torch.testing.assert_close(cache["k"], before, rtol=0, atol=0)  # not written
        cache = new_cache
        dec.append(lg)
    dec = torch.cat(dec[:-1], dim=1).numpy()
    h, _, _ = T.forward_seq(cfg, params, {"tokens": torch.tensor(tokens)})
    ref = T.lm_logits(cfg, params, h)[:, s0 - 1:seq - 1].numpy()
    err = float(np.abs(dec - ref).max())
    assert err < 2e-3 * max(float(np.abs(ref).max()), 1.0), (arch, err)


def test_init_cache_layout():
    cfg = registry.get_config("qwen3-0.6b", smoke=True)
    cache = T.init_cache(cfg, ShapeCfg("t", "decode", 32, 3))
    assert cache["k"].shape == (cfg.n_layers, 3, 32, cfg.n_kv_heads, cfg.head_dim)
    assert cache["k"].dtype == torch.bfloat16 and cache["pos"] == 31


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_configs_match_reference(arch):
    """The ten configs' data: every field but the specs' types, param counts,
    FLOPs per token and shape support, full and SMOKE."""
    for smoke in (False, True):
        cfg, jcfg = registry.get_config(arch, smoke), jreg.get_config(arch, smoke)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.vocab_padded == jcfg.vocab_padded
        for name, shape in SHAPES.items():
            assert cfg.supports(name) == jcfg.supports(name)
            assert flops_per_token(cfg, shape.seq, shape.kind) == pytest.approx(
                jflops_per_token(jcfg, shape.seq, shape.kind), rel=1e-12)
        for f in dataclasses.fields(cfg):
            if f.name not in ("moe", "ssm"):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert registry.build(arch).cfg.input_kind == jreg.build(arch).cfg.input_kind


def test_long_500k_applicability():
    runs = {a for a in registry.ARCH_IDS if registry.build(a).cfg.supports("long_500k")}
    assert runs == {"mamba2-780m", "mixtral-8x22b", "zamba2-1.2b"}


def test_make_batch_from_generator():
    bundle = registry.build("olmo-1b", smoke=True)
    shape = ShapeCfg("t", "train", 8, 2)
    a = bundle.make_batch(shape, torch.Generator().manual_seed(3))
    b = bundle.make_batch(shape, torch.Generator().manual_seed(3))
    assert sorted(a) == ["labels", "tokens"]
    for k in a:
        assert a[k].dtype == torch.int32 and a[k].shape == (2, 8)
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        assert int(a[k].min()) >= 0 and int(a[k].max()) < bundle.cfg.vocab
