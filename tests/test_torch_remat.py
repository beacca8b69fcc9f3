"""Rematerialisation of the LM train step, every family at its SMOKE
config: ``forward_seq(remat=True)`` checkpoints each layer body where the
JAX package calls ``jax.checkpoint``, so the loss and every gradient equal
the plain forward's bitwise on the CPU (the backward recomputes the same
ops), the train step (which runs with remat) equals the JAX package's
within rtol = atol = 1e-5 (one SGD step at lr 1: every gradient), and the
tensors autograd keeps for the backward (counted with
``torch.autograd.graph.saved_tensors_hooks``) take fewer bytes with remat.
Inputs are numpy draws from fixed seeds, fed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCfg as JShapeCfg
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro.training.optimizer import sgd as jsgd
from repro_torch import tree
from repro_torch.configs.base import ShapeCfg
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import sgd

TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 32


def _setup(arch):
    jcfg = jreg.build(arch, smoke=True).cfg
    cfg = registry.build(arch, smoke=True).cfg
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, params


def _batch(cfg, seed=1):
    """One train batch as numpy arrays: tokens (or vlm's embeds with M-RoPE
    positions, or whisper's frames and tokens) and labels, some ignored."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_kind == "embeds":
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        out["positions"] = np.broadcast_to(
            rng.integers(0, S, size=(3, B, S)).astype(np.int32), (3, B, S)).copy()
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
        if cfg.input_kind == "frames_tokens":
            out["frames"] = rng.standard_normal((B, S + 8, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels[0, :3] = -1
    out["labels"] = labels
    return out


def _loss_fn(cfg, batch, remat):
    def loss(params):
        h, aux, _ = T.forward_seq(cfg, params, batch, remat=remat)
        ce = T.ce_loss(cfg, T.lm_logits(cfg, params, h), batch["labels"])
        return ce + T.AUX_LOSS_WEIGHT * aux, (ce, aux)

    return loss


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_remat_equal_and_matches_reference(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    nb = _batch(cfg)
    batch = {k: torch.tensor(v) for k, v in nb.items()}
    (l0, (ce0, a0)), g0 = tree.value_and_grad(_loss_fn(cfg, batch, False), params, has_aux=True)
    (l1, (ce1, a1)), g1 = tree.value_and_grad(_loss_fn(cfg, batch, True), params, has_aux=True)
    assert torch.equal(l0, l1) and torch.equal(ce0, ce1) and torch.equal(a0, a1)
    for x, y in zip(tree.leaves(g0), tree.leaves(g1), strict=True):
        assert torch.equal(x, y)
    assert any(float(x.abs().max()) > 0 for x in tree.leaves(g1))

    shape = ShapeCfg("t", "train", S, B)
    new, _, m = T.make_train_step(cfg, None, sgd(1.0), shape)(params, sgd(1.0).init(params), batch)
    jstep = jax.jit(JT.make_train_step(jcfg, None, jsgd(1.0), JShapeCfg("t", "train", S, B)))
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    jnew, _, jm = jstep(jparams, jsgd(1.0).init(jparams), jbatch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), **TOL)
    want = T.params_from_jax(cfg, jax.tree.map(np.asarray, jnew))
    for x, y in zip(tree.leaves(new), tree.leaves(want), strict=True):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


def _saved_bytes(fn) -> int:
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_remat_saves_fewer_bytes(arch):
    """The bytes autograd keeps for the backward, with remat below without;
    the backward then recomputes each checkpointed body."""
    _, cfg, _, params = _setup(arch)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    live = tree.tree_map(lambda p: p.detach().requires_grad_(), params)
    plain = _saved_bytes(lambda: _loss_fn(cfg, batch, False)(live))
    remat = _saved_bytes(lambda: _loss_fn(cfg, batch, True)(live))
    assert 0 < remat < plain, (arch, remat, plain)


def test_train_step_remats_and_serve_steps_do_not(monkeypatch):
    """``make_train_step`` runs ``forward_seq(remat=True)``; the prefill
    builds its cache without remat."""
    cfg = registry.build("zamba2-1.2b", smoke=True).cfg
    seen = []
    orig = T.forward_seq

    def spy(*args, remat=False, **kw):
        seen.append(remat)
        return orig(*args, remat=remat, **kw)

    monkeypatch.setattr(T, "forward_seq", spy)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    T.make_train_step(cfg, None, sgd(0.1), ShapeCfg("t", "train", S, B))(
        params, sgd(0.1).init(params), batch)
    T.make_prefill_step(cfg, None, ShapeCfg("t", "decode", S + 4, B))(
        params, {"tokens": batch["tokens"]})
    assert seen == [True, False]


def test_encoder_remat_even_with_a_cache(monkeypatch):
    """Whisper's encoder layers are checkpointed whenever remat is on, a
    cache being built or not (the JAX package's ``enc_body``); the values
    stay those of the plain forward."""
    cfg = registry.build("whisper-small", smoke=True).cfg
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items() if k != "labels"}
    want = T.forward_seq(cfg, params, batch, want_cache=ShapeCfg("t", "decode", S, B))
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return orig(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    got = T.forward_seq(cfg, params, batch, want_cache=ShapeCfg("t", "decode", S, B),
                        remat=True)
    assert calls == ["enc_body"] * cfg.enc_layers
    assert torch.equal(got[0], want[0])
    for k in want[2]:
        assert got[2][k] == want[2][k] if k == "pos" else torch.equal(got[2][k], want[2][k])
