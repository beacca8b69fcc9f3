"""The moe (granite, mixtral), ssm (mamba2) and hybrid (zamba2) LM families
at their SMOKE configs: the port's forward, loss, aux loss, train update,
prefill caches and decode against the JAX package's on the JAX package's
parameters (carried across by ``params_from_jax``, which also merges the
reference's virtual experts) and the same numpy tokens; the sliding window
rolled past, the batch-split prefill, the virtual-expert merge, the mamba
decode state at its edges, and the train CLI.

Tolerances: logits, losses, aux losses, caches and decode logits within
rtol = atol = 1e-5 in f32 (the same math; XLA and torch sum the matmuls,
norms, softmax and SSD einsums in another order).  One SGD update at lr 1
(so every gradient) within rtol = atol = 1e-5.  Decode against the full
forward within ``2e-3 * max(|ref|, 1)``, the JAX package's own bound
(tests/test_models.py), with the MoE capacity raised so that the forward
drops no token, as that test does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCfg as JShapeCfg
from repro.models import mamba2 as JM
from repro.models import moe as JMoE
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro.training.optimizer import sgd as jsgd
from repro_torch import tree
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import train
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MoE
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import sgd

ARCHS = ["granite-moe-3b-a800m", "mixtral-8x22b", "mamba2-780m", "zamba2-1.2b"]
MOE_ARCHS = ARCHS[:2]
TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 64


def _setup(arch, moe=None, **replace):
    """The reference's and the port's SMOKE configs with the same fields
    replaced (``moe``: fields of the reference's MoESpec, those the port's
    spec also has applied to it), and the reference's parameters in both
    packages' forms."""
    jcfg = dataclasses.replace(jreg.get_config(arch, smoke=True), **replace)
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True), **replace)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        ported = {k: v for k, v in moe.items() if k != "virtual_factor"}
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **ported))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, params


def _no_drops(arch):
    """A capacity at which no routing group drops a token (the JAX
    package's decode test sets the same)."""
    cfg = registry.get_config(arch, smoke=True)
    return {"capacity_factor": float(cfg.moe.n_experts)} if cfg.moe is not None else None


def _tokens(cfg, seq=S, seed=1, batch=B):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    labels[0, :5] = -1  # ignored positions
    return tokens, labels


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


# ----------------------------------------------------------------- params


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_splits_and_merges(arch):
    jcfg, cfg, jparams, params = _setup(arch)
    assert len(params["layers"]) == cfg.n_layers
    fresh = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert tree.flatten(fresh)[1] == tree.flatten(params)[1]  # same structure as init
    for a, b in zip(tree.leaves(fresh), tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    n = sum(int(x.numel()) for x in tree.leaves(params))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jparams))
    if cfg.family == "hybrid":
        for a, b in zip(tree.leaves(params["shared"]),
                        jax.tree_util.tree_leaves(jparams["shared"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("v", [2, 3])
def test_virtual_expert_merge_unit(v):
    """The reference's layer with ``E * v`` virtual experts against the
    port's layer on the merged parameters, with drops (capacity 1.0)."""
    jspec = JMoE.MoESpec(n_experts=4, top_k=2, d_ff=24 * v, capacity_factor=1.0,
                         virtual_factor=v)
    spec = MoE.MoESpec(n_experts=4, top_k=2, d_ff=24 * v, capacity_factor=1.0)
    jp = JMoE.moe_init(jax.random.PRNGKey(0), 32, jspec)
    assert jp["wi"].shape == (4 * v, 32, 24)
    p = MoE.merge_virtual_experts(
        {k: torch.tensor(np.asarray(a)) for k, a in jp.items()}, spec.n_experts)
    assert p["wi"].shape == (4, 32, 24 * v) and p["wo"].shape == (4, 24 * v, 32)
    # virtual expert e*v + j holds columns j*f/v .. (j+1)*f/v of expert e
    np.testing.assert_array_equal(p["wi"][1, :, 24:48].numpy(), np.asarray(jp["wi"][v + 1]))
    np.testing.assert_array_equal(p["wo"][3, :24].numpy(), np.asarray(jp["wo"][3 * v]))
    x = np.random.default_rng(1).standard_normal((2, 16, 32)).astype(np.float32)
    jy, jaux = JMoE.moe_apply(jp, jnp.asarray(x), jspec)
    y, aux = MoE.moe_apply(p, torch.tensor(x), spec)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("v", [2, 3])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_virtual_expert_merge_in_the_model(arch, v):
    """The SMOKE model with the reference's ``virtual_factor`` = v (the
    published configs ship 2): logits and aux loss of the merged port."""
    jcfg, cfg, jparams, params = _setup(arch, moe={"virtual_factor": v, "d_ff": 48 * v})
    assert jparams["layers"]["moe"]["wi"].shape[1] == cfg.moe.n_experts * v
    assert params["layers"][0]["moe"]["wi"].shape == (cfg.moe.n_experts, cfg.d_model, 48 * v)
    tokens, _ = _tokens(cfg)
    h, aux, _ = T.forward_seq(cfg, params, {"tokens": torch.tensor(tokens)})
    jh, jaux, _ = JT.forward_seq(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, None)
    np.testing.assert_allclose(T.lm_logits(cfg, params, h).numpy(),
                               np.asarray(JT.lm_logits(jcfg, jparams, jh)), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("seq", [S, 24])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_loss_and_aux_match_reference(arch, seq):
    """forward_seq + lm_logits + ce_loss and the summed MoE aux loss; at 64
    positions mixtral's 32-token window masks and the smoke configs' query
    chunks and KV blocks split; 24 is not a multiple of the SSD chunk."""
    jcfg, cfg, jparams, params = _setup(arch)
    tokens, labels = _tokens(cfg, seq=seq)
    h, aux, _ = T.forward_seq(cfg, params, {"tokens": torch.tensor(tokens)})
    logits = T.lm_logits(cfg, params, h)
    jh, jaux, _ = JT.forward_seq(jcfg, jparams, {"tokens": jnp.asarray(tokens)}, None)
    jlogits = JT.lm_logits(jcfg, jparams, jh)
    assert logits.shape == (B, seq, cfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(T.ce_loss(cfg, logits, torch.tensor(labels))),
                               float(JT.ce_loss(jcfg, jlogits, jnp.asarray(labels))), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch,accum", [(a, 1) for a in ARCHS] + [("granite-moe-3b-a800m", 2),
                                                                   ("zamba2-1.2b", 2)])
def test_train_update_matches_reference(arch, accum):
    """One SGD step at lr 1 from the same parameters: the loss, the aux
    loss and every updated parameter, so every gradient, within 1e-5;
    ``accum=2`` runs the strided microbatch accumulation with the config's
    ``low_precision_opt``."""
    jcfg, cfg, jparams, params = _setup(arch, grad_accum={"smoke": accum})
    shape, jshape = ShapeCfg("smoke", "train", S, B), JShapeCfg("smoke", "train", S, B)
    tokens, labels = _tokens(cfg)
    opt, jopt = sgd(1.0), jsgd(1.0)
    new, state, m = T.make_train_step(cfg, None, opt, shape)(
        params, opt.init(params), {"tokens": torch.tensor(tokens), "labels": torch.tensor(labels)})
    jnew, _, jm = jax.jit(JT.make_train_step(jcfg, None, jopt, jshape))(
        jparams, jopt.init(jparams), {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), **TOL)
    _tree_close(new, T.params_from_jax(cfg, jax.tree.map(np.asarray, jnew)), **TOL)
    assert int(state["step"]) == 1


# ---------------------------------------------------------- prefill/decode


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_decode_step_match_reference(arch):
    """The prefill's logits and caches leaf by leaf (mixtral's rolling
    ``k``/``v`` past its 32-slot window, ``conv``/``ssm``, ``shared_k``/
    ``shared_v``), then each decode step's logits and cache against the
    reference's decode of the same cache."""
    s0, extra = 40, 6
    seq = s0 + extra
    jcfg, cfg, jparams, params = _setup(arch)
    tokens, _ = _tokens(cfg, seq=seq)
    logits, cache = T.make_prefill_step(cfg, None, ShapeCfg("t", "decode", seq, B))(
        params, {"tokens": torch.tensor(tokens[:, :s0])})
    jlogits, jcache = JT.make_prefill_step(jcfg, None, JShapeCfg("t", "decode", seq, B))(
        jparams, {"tokens": jnp.asarray(tokens[:, :s0])})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _caches_close(cache, jcache, **TOL)
    if cfg.window is not None:
        assert cache["k"].shape[2] == cfg.window < s0
    serve = T.make_serve_step(cfg, None)
    jserve = jax.jit(JT.make_serve_step(jcfg, None))
    for t in range(s0, seq):
        before = {k: v.clone() for k, v in cache.items() if k != "pos"}
        lg, new_cache = serve(params, cache, {"tokens": torch.tensor(tokens[:, t:t + 1])})
        for k, v in before.items():
            torch.testing.assert_close(cache[k], v, rtol=0, atol=0)  # not written
        jlg, jcache = jserve(jparams, jcache, {"tokens": jnp.asarray(tokens[:, t:t + 1])})
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        _caches_close(new_cache, jcache, **TOL)
        cache = new_cache


def _decode_against_forward(cfg, params, tokens, s0):
    """Teacher-forced decode from a prefill of ``s0`` tokens -> (its logits,
    the full forward's logits at the same positions)."""
    seq = tokens.shape[1]
    logits_p, cache = T.make_prefill_step(cfg, None, ShapeCfg("t", "decode", seq, B))(
        params, {"tokens": torch.tensor(tokens[:, :s0])})
    serve = T.make_serve_step(cfg, None)
    dec = [logits_p]
    for t in range(s0, seq):
        lg, cache = serve(params, cache, {"tokens": torch.tensor(tokens[:, t:t + 1])})
        dec.append(lg)
    h, _, _ = T.forward_seq(cfg, params, {"tokens": torch.tensor(tokens)})
    return torch.cat(dec[:-1], dim=1).numpy(), T.lm_logits(cfg, params, h)[:, s0 - 1:seq - 1].numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The JAX package's test: 16 prefilled tokens and 4 decode steps
    against the full forward, MoE capacity raised so nothing drops."""
    _, cfg, _, params = _setup(arch, moe=_no_drops(arch))
    tokens, _ = _tokens(cfg, seq=20)
    dec, ref = _decode_against_forward(cfg, params, tokens, 16)
    err = float(np.abs(dec - ref).max())
    assert err < 2e-3 * max(float(np.abs(ref).max()), 1.0), (arch, err)


def test_rolling_cache_past_the_window():
    """The JAX package's SWA test: window 8, prefill 12, 6 more steps, so
    the prefill packs the rolling layout and every step overwrites a slot;
    decode within its bound of the windowed forward, and every step's
    logits and cache within 1e-5 of the reference's decode."""
    arch = "mixtral-8x22b"
    jcfg, cfg, jparams, params = _setup(arch, moe=_no_drops(arch), window=8)
    s0, seq = 12, 18
    tokens, _ = _tokens(cfg, seq=seq)
    dec, ref = _decode_against_forward(cfg, params, tokens, s0)
    err = float(np.abs(dec - ref).max())
    assert err < 2e-3 * max(float(np.abs(ref).max()), 1.0), err
    _, cache = T.make_prefill_step(cfg, None, ShapeCfg("t", "decode", seq, B))(
        params, {"tokens": torch.tensor(tokens[:, :s0])})
    _, jcache = JT.make_prefill_step(jcfg, None, JShapeCfg("t", "decode", seq, B))(
        jparams, {"tokens": jnp.asarray(tokens[:, :s0])})
    assert cache["k"].shape[2] == 8
    _caches_close(cache, jcache, **TOL)
    # slot j holds the last position p < 12 with p % 8 == j: 8, 9, 10, 11, 4, ..., 7
    full = T._extract_kv(cfg, params["layers"][0]["attn"],
                         T._norm(cfg, params["layers"][0]["ln1"],
                                 T.embed_tokens(cfg, params, torch.tensor(tokens[:, :s0]))),
                         T._positions(B, s0, 0, "cpu"), s0)[0]
    torch.testing.assert_close(cache["k"][0], full[:, [8, 9, 10, 11, 4, 5, 6, 7]],
                               rtol=0, atol=0)
    for t in range(s0, seq):
        step = {"tokens": tokens[:, t:t + 1]}
        lg, cache = T.decode_step(cfg, params, cache, {"tokens": torch.tensor(step["tokens"])})
        jlg, jcache = JT.decode_step(jcfg, jparams, jcache,
                                     {"tokens": jnp.asarray(step["tokens"])}, None)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        _caches_close(cache, jcache, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_prefill_matches_reference_and_unsplit(arch):
    """``serve_microbatch`` 2 at batch 4: the strided sub-batches' logits
    and caches interleaved back into the batch's order, against the
    reference's split prefill and the port's own unsplit one."""
    jcfg, cfg, jparams, params = _setup(arch, serve_microbatch={"t": 2})
    tokens, _ = _tokens(cfg, seq=24, batch=4)
    shape, jshape = ShapeCfg("t", "decode", 30, 4), JShapeCfg("t", "decode", 30, 4)
    logits, cache = T.make_prefill_step(cfg, None, shape)(params, {"tokens": torch.tensor(tokens)})
    jlogits, jcache = JT.make_prefill_step(jcfg, None, jshape)(
        jparams, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _caches_close(cache, jcache, **TOL)
    whole = dataclasses.replace(cfg, serve_microbatch={})
    w_logits, w_cache = T.make_prefill_step(whole, None, shape)(
        params, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(logits.numpy(), w_logits.numpy(), **TOL)
    assert sorted(cache) == sorted(w_cache) and cache["pos"] == w_cache["pos"] == 24
    for k in cache:
        if k != "pos":
            np.testing.assert_allclose(cache[k].numpy(), w_cache[k].numpy(), **TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference_layout(arch):
    cfg, jcfg = registry.get_config(arch, smoke=True), jreg.get_config(arch, smoke=True)
    shape = ShapeCfg("t", "decode", 48, 3)
    cache = T.init_cache(cfg, shape)
    jcache = JT.init_cache(jcfg, JShapeCfg("t", "decode", 48, 3))
    assert sorted(cache) == sorted(jcache) and cache["pos"] == int(jcache["pos"]) == 47
    for k in cache:
        if k != "pos":
            assert tuple(cache[k].shape) == jcache[k].shape, k
            assert cache[k].dtype == torch.bfloat16 and not cache[k].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_a_zero_cache_matches_reference(arch):
    """Three decode steps from ``init_cache``'s zero bf16 cache under the
    f32 SMOKE config (the caches' dtype and the activations' differ, as in
    a serve that starts without a prefill): logits and caches against the
    reference's decode from its own ``init_cache``, within 1e-5 (the
    caches within bf16's rounding, 2^-8 relative), each cache leaf in the
    reference's dtype (KV slots stay bf16; a mamba state comes back in the
    activations' f32)."""
    jcfg, cfg, jparams, params = _setup(arch)
    cache = T.init_cache(cfg, ShapeCfg("t", "decode", 40, B), pos=10)
    jcache = JT.init_cache(jcfg, JShapeCfg("t", "decode", 40, B), pos=10)
    tokens, _ = _tokens(cfg, seq=3)
    for t in range(3):
        lg, cache = T.decode_step(cfg, params, cache, {"tokens": torch.tensor(tokens[:, t:t + 1])})
        jlg, jcache = JT.decode_step(jcfg, jparams, jcache,
                                     {"tokens": jnp.asarray(tokens[:, t:t + 1])}, None)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        for k in cache:
            if k != "pos":
                assert str(cache[k].dtype) == f"torch.{jcache[k].dtype}", k
                np.testing.assert_allclose(cache[k].float().numpy(),
                                           np.asarray(jcache[k], np.float32),
                                           rtol=2 ** -8, atol=1e-5, err_msg=k)
    assert cache["pos"] == int(jcache["pos"]) == 13


def test_sharded_and_other_families_raise():
    """A ``ShardCtx`` no longer raises: mamba2's and granite's serve steps
    on the debug mesh shape equal the ``ctx=None`` ones bitwise (logits and
    every cache leaf; the vocab-parallel embedding adds zeros)."""
    ctx = T.ShardCtx(mesh=make_debug_mesh())
    for arch in ("mamba2-780m", "granite-moe-3b-a800m"):
        cfg = registry.get_config(arch, smoke=True)
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        cache = T.init_cache(cfg, ShapeCfg("t", "decode", 16, B), dtype=torch.float32, pos=3)
        tokens = {"tokens": torch.tensor(_tokens(cfg, seq=1)[0])}
        lg, new = T.make_serve_step(cfg, ctx)(params, cache, tokens)
        lg0, new0 = T.make_serve_step(cfg, None)(params, cache, tokens)
        assert torch.equal(lg, lg0), arch
        assert sorted(new) == sorted(new0)
        for k in new:
            assert new[k] == new0[k] if k == "pos" else torch.equal(new[k], new0[k]), (arch, k)


# ------------------------------------------------------------------ mamba2


def _mamba_pair(seq, chunk=16, batch=2):
    spec = M.MambaSpec(d_model=32, d_state=8, d_conv=4, expand=2, head_dim=8, chunk=chunk)
    jspec = JM.MambaSpec(d_model=32, d_state=8, d_conv=4, expand=2, head_dim=8, chunk=chunk)
    jp = JM.mamba_init(jax.random.PRNGKey(0), jspec)
    p = {k: torch.tensor(np.asarray(a)) for k, a in jp.items()}
    u = (np.random.default_rng(1).standard_normal((batch, seq, 32)) * 0.5).astype(np.float32)
    return spec, jspec, p, jp, u


@pytest.mark.parametrize("seq", [2, 16 + 3, 32])
def test_mamba_final_state_matches_reference(seq):
    """The state ``mamba_apply`` returns: 2 tokens (the conv state keeps a
    pad zero), ``chunk + 3`` (the SSD's padded tail must leave the state as
    it was) and two whole chunks."""
    spec, jspec, p, jp, u = _mamba_pair(seq)
    out, (conv, ssm) = M.mamba_apply(p, torch.tensor(u), spec,
                                     state=M.mamba_init_state(spec, 2))
    jout, (jconv, jssm) = JM.mamba_apply(jp, jnp.asarray(u), jspec,
                                         state=JM.mamba_init_state(jspec, 2))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(ssm.numpy(), np.asarray(jssm), **TOL)
    assert conv.shape == (2, spec.d_inner + 2 * spec.d_state, spec.d_conv - 1)
    if seq < spec.d_conv - 1:
        assert not conv[:, :, : spec.d_conv - 1 - seq].any()  # the pad zeros
    # without a state the output is the same and no state comes back
    plain, none = M.mamba_apply(p, torch.tensor(u), spec)
    assert none is None
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


def test_mamba_decode_step_matches_ssd_forward_and_reference():
    """The JAX package's test: 50 single-token steps from the zero state
    against the chunked SSD forward; each step also against the
    reference's decode step."""
    spec, jspec, p, jp, u = _mamba_pair(50)
    out, st = M.mamba_apply(p, torch.tensor(u), spec, state=M.mamba_init_state(spec, 2))
    state, jstate = M.mamba_init_state(spec, 2), JM.mamba_init_state(jspec, 2)
    outs = []
    for t in range(u.shape[1]):
        o, state = M.mamba_decode_step(p, torch.tensor(u[:, t:t + 1]), spec, state)
        jo, jstate = JM.mamba_decode_step(jp, jnp.asarray(u[:, t:t + 1]), jspec, jstate)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        for a, b in zip(state, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        outs.append(o)
    np.testing.assert_allclose(out.numpy(), torch.cat(outs, dim=1).numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st[1].numpy(), state[1].numpy(), rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(st[0], state[0], rtol=1e-6, atol=1e-6)


def test_ssd_gradient_finite_at_the_published_chunk():
    """A held difference: at chunk 256 (the published configs') the JAX
    package's SSD gradient is not finite (its mask follows an exp that
    overflows above the diagonal), the port's is, and it equals the JAX
    package's gradient at chunk 16, where that one is finite (the chunked
    SSD computes the same function at any chunk size).  The forward is the
    same in both packages at either chunk."""
    spec, jspec, p, jp, u = _mamba_pair(512, chunk=256)
    jspec16 = dataclasses.replace(jspec, chunk=16)

    def jloss(params, s):
        return jnp.sum(JM.mamba_apply(params, jnp.asarray(u), s)[0] ** 2)

    jgrad = jax.grad(jloss)(jp, jspec)
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jgrad))
    jgrad16 = jax.grad(jloss)(jp, jspec16)
    live = {k: v.clone().requires_grad_() for k, v in p.items()}
    out, _ = M.mamba_apply(live, torch.tensor(u), spec)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(JM.mamba_apply(jp, jnp.asarray(u), jspec)[0]),
                               rtol=2e-4, atol=2e-5)
    for k, g in jgrad16.items():  # chunks of 16 and 256 sum in another order
        want = np.asarray(g)
        err = float(np.abs(live[k].grad.numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (k, err)


# -------------------------------------------------------------------- CLI


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(tmp_path, arch, capsys):
    out = train.main(["--arch", arch, "--steps", "2", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path), "--batch", "4", "--seq", "32"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "[train] done" in capsys.readouterr().out
    assert len(out["params"]["layers"]) == registry.get_config(arch, smoke=True).n_layers
