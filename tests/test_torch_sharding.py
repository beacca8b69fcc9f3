"""Sharded LMs in the port (``ShardCtx``, ``repro_torch.sharding``, the
vocab-parallel embedding, the meta-device structs and the elastic restore)
against the JAX package.

* The sharding rules equal ``repro.sharding``'s leaf by leaf (the JAX
  package's leading layer-axis ``None`` dropped: the port keeps each layer
  as its own entry), for the ten configs on both production meshes, and so
  do the optimizer, batch and cache specs.
* The divisibility checks of ``tests/test_data_sharding.py`` on the port's
  structs; the MoE expert axis is checked as the JAX package's ``E * v``
  virtual experts (the port keeps ``E`` whole ones, ROADMAP C).
* ``vocab_parallel_embed`` equals a plain take within 1e-6; a sharded
  qwen3-0.6b smoke train step, prefill and decode equal the ``ctx=None``
  ones within 1e-6 (bitwise expected: the shards add zeros) and the JAX
  package's unsharded ones within 1e-5; one subprocess holds the port to
  the JAX package's ``shard_map`` embedding (1e-6) and its sharded
  train-step loss (rtol 5e-3, that test's own bound) on 8 host devices.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sharding as jsh
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro.training.optimizer import adamw as jadamw
from repro_torch import sharding as sh
from repro_torch import tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import SHAPES, ShapeCfg
from repro_torch.core.partition import vocab_parallel_embed
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import adamw

SRC = str(Path(__file__).resolve().parent.parent / "src")
SIZES = {"pod": 2, "data": 16, "model": 16}
STACKS = ("layers", "enc_layers")


def _names(path) -> tuple:
    return tuple(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)


def _ref_leaves(tree_, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree_, is_leaf=is_leaf)
    return [(_names(path), leaf) for path, leaf in flat]


def _at(node, names):
    for n in names:
        node = node[int(n)] if isinstance(node, (list, tuple)) else node[n]
    return node


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _port_twin(ref_names, port_tree, n_layers):
    """The port leaves that stand for one reference leaf: per layer for a
    stacked leaf (with a flag), else the same path."""
    if ref_names[0] in STACKS:
        return [_at(port_tree, (ref_names[0], str(i)) + ref_names[1:])
                for i in range(n_layers[ref_names[0]])], True
    return [_at(port_tree, ref_names)], False


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_rules_equal_reference(arch, multi_pod):
    b, jb = registry.build(arch), jreg.build(arch)
    struct, jstruct = b.param_struct(), jb.param_struct()
    specs, jspecs = sh.param_pspecs(struct, multi_pod), jsh.param_pspecs(jstruct, multi_pod)
    n_layers = {"layers": b.cfg.n_layers, "enc_layers": b.cfg.enc_layers}
    ref = _ref_leaves(jspecs, _is_spec)
    assert len(tree.leaves(specs)) == sum(
        n_layers[n[0]] if n[0] in STACKS else 1 for n, _ in ref)
    for names, jspec in ref:
        want = tuple(jspec)
        twins, stacked = _port_twin(names, specs, n_layers)
        for spec in twins:
            assert tuple(spec) == (want[1:] if stacked else want), (arch, names)
    # the optimizer state mirrors the parameters', the step replicated
    opt = adamw(moments_dtype=torch.bfloat16 if b.cfg.low_precision_opt else None)
    ostate = opt.init(struct)
    ospecs = sh.opt_pspecs(ostate, specs)
    jostate = jax.eval_shape(jadamw(3e-4).init, jstruct)
    jospecs = jsh.opt_pspecs(jostate, jspecs)
    assert tuple(ospecs["step"]) == tuple(jospecs["step"]) == ()
    for key in ("m", "v"):
        assert tree.flatten(ospecs[key])[0] == tree.flatten(specs)[0]
        for names, jspec in _ref_leaves(jospecs[key], _is_spec):
            assert tuple(_port_twin(names, ospecs[key], n_layers)[0][0]) == \
                (tuple(jspec)[1:] if names[0] in STACKS else tuple(jspec))
    # batch and cache specs, every shape
    for name, shape in SHAPES.items():
        for n_dp in (16, 32):
            got = sh.batch_pspecs(b.cfg, shape, multi_pod, n_dp)
            want = jsh.batch_pspecs(jb.cfg, JSHAPES[name], multi_pod, n_dp)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (arch, name)
            got = sh.cache_pspecs(b.cfg, shape, multi_pod, n_dp)
            want = jsh.cache_pspecs(jb.cfg, JSHAPES[name], multi_pod, n_dp)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (arch, name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert sh.dp_size(mesh) == (32 if multi_pod else 16)


def _check_divisible(dim, ax, what):
    axes = ax if isinstance(ax, tuple) else (ax,)
    k = 1
    for a in axes:
        k *= SIZES[a]
    assert dim % k == 0, what


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_specs_divisible(arch, multi_pod):
    """Every parameter's sharded dims divide the production mesh axes; the
    MoE expert axis (the port's whole experts) as the JAX package's
    ``E * virtual_factor`` virtual experts."""
    b = registry.build(arch)
    struct = b.param_struct()
    specs = sh.param_pspecs(struct, multi_pod)
    jmoe = jreg.build(arch).cfg.moe

    def check(path, leaf):
        spec = _at(specs, path)
        for i, (dim, ax) in enumerate(zip(leaf.shape, spec)):
            if ax is None:
                continue
            if "moe" in path and path[-1] in ("wi", "wg", "wo") and i == 0:
                assert dim == jmoe.n_experts
                dim = jmoe.n_experts * jmoe.virtual_factor  # the reference's E * v
            _check_divisible(dim, ax, (arch, path, tuple(leaf.shape), spec))

    sh.map_with_path(check, struct)


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x22b", "chatglm3-6b", "mamba2-780m",
                                  "zamba2-1.2b", "whisper-small"])
def test_cache_specs_divisible(arch):
    b = registry.build(arch)
    for shape_name in ("decode_32k", "long_500k"):
        if not b.cfg.supports(shape_name):
            continue
        shape = SHAPES[shape_name]
        struct = b.cache_struct(shape)
        for key, spec in sh.cache_pspecs(b.cfg, shape, False, 16).items():
            if key == "pos":
                continue
            assert struct[key].device.type == "meta"
            for dim, ax in zip(struct[key].shape, spec):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                k = 16 ** len([a for a in axes if a in ("data", "model")])
                assert dim % k == 0, (arch, shape_name, key, struct[key].shape, spec)


def test_embed_is_vocab_sharded():
    specs = sh.param_pspecs(registry.build("qwen3-0.6b").param_struct(), False)
    assert specs["embed"] == sh.P("model", None)  # the paper's row-chunked table
    assert sh.P(("data",), "model") == sh.P("data", "model")


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_structs_match_reference_eval_shape(arch):
    """``param_struct`` and ``cache_struct`` (meta tensors) against the JAX
    package's ``eval_shape``: a stacked leaf's shape without its layer
    axis on every layer (an MoE layer's experts merged), dtypes as asked."""
    b, jb = registry.build(arch), jreg.build(arch)
    struct = b.param_struct(torch.bfloat16)
    n_layers = {"layers": b.cfg.n_layers, "enc_layers": b.cfg.enc_layers}
    jstruct = jb.param_struct()
    assert all(x.device.type == "meta" and x.dtype == torch.bfloat16
               for x in tree.leaves(struct))
    for names, leaf in _ref_leaves(jstruct):
        want = tuple(leaf.shape)
        twins, stacked = _port_twin(names, struct, n_layers)
        if stacked:
            want = want[1:]
        if "moe" in names and names[-1] in ("wi", "wg", "wo"):
            ev, d1, d2 = want
            v = ev // b.cfg.moe.n_experts
            want = (ev // v, d1, d2 * v) if names[-1] != "wo" else (ev // v, d1 * v, d2)
        for t in twins:
            assert tuple(t.shape) == want, (arch, names)
    for name, shape in SHAPES.items():
        if shape.kind != "decode" or not b.cfg.supports(name):
            continue
        cache, jcache = b.cache_struct(shape), jb.cache_struct(JSHAPES[name])
        assert sorted(cache) == sorted(jcache)
        for k, v in cache.items():
            if k != "pos":
                assert tuple(v.shape) == tuple(jcache[k].shape) and v.dtype == torch.bfloat16


def test_restore_places_leaves_from_a_meta_tree(tmp_path):
    """The elastic restart: structure from ``param_struct`` (meta),
    placement from ``with_sharding``; without shardings a meta leaf loads
    to the CPU, never to meta."""
    b = registry.build("qwen3-0.6b", smoke=True)
    params = b.init(torch.Generator().manual_seed(0))
    ckpt.save(tmp_path, 3, params)
    struct = b.param_struct()
    mesh = make_debug_mesh()
    placed = sh.with_sharding(mesh, struct, sh.param_pspecs(struct, False), device="cpu")
    assert placed["embed"] == sh.Placement(torch.device("cpu"), sh.P("model", None), mesh)
    for shardings in (placed, None):
        got, step = ckpt.restore(tmp_path, None, struct, shardings=shardings)
        assert step == 3
        for x, y in zip(tree.leaves(got), tree.leaves(params), strict=True):
            assert x.device.type == "cpu" and torch.equal(x, y)
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(tmp_path, None, struct, shardings={"embed": placed["embed"]})


def test_vocab_parallel_embed_matches_take():
    mesh = make_debug_mesh()  # (2, 4): four vocab shards
    rng = np.random.default_rng(0)
    v, d, bsz, s = 64, 16, 8, 12
    table = rng.standard_normal((v, d)).astype(np.float32)
    toks = rng.integers(0, v, size=(bsz, s)).astype(np.int32)
    toks[0, :4] = [0, 15, 16, v - 1]  # each shard's edges
    got = vocab_parallel_embed(torch.tensor(table), torch.tensor(toks), mesh.shape["model"])
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(toks), axis=0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="shards"):
        vocab_parallel_embed(torch.tensor(table), torch.tensor(toks), 5)


def _same(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_sharded_qwen3_steps_match_unsharded_and_reference():
    arch = "qwen3-0.6b"
    jcfg, cfg = jreg.build(arch, smoke=True).cfg, registry.build(arch, smoke=True).cfg
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = T.params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    mesh = make_debug_mesh()
    ctx = T.ShardCtx(mesh=mesh, shard_batch=True)
    rng = np.random.default_rng(1)
    bsz, s = 8, 32
    tokens = rng.integers(0, cfg.vocab, size=(bsz, s + 4)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(bsz, s)).astype(np.int32)
    batch = {"tokens": torch.tensor(tokens[:, :s]), "labels": torch.tensor(labels)}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    shape = ShapeCfg("t", "train", s, bsz)
    opt = adamw(1e-3)
    p1, _, m1 = T.make_train_step(cfg, ctx, opt, shape)(params, opt.init(params), batch)
    p0, _, m0 = T.make_train_step(cfg, None, opt, shape)(params, opt.init(params), batch)
    _same(m1["loss"], m0["loss"], 1e-6)
    for x, y in zip(tree.leaves(p1), tree.leaves(p0), strict=True):
        _same(x, y, 1e-6)
    jopt = jadamw(1e-3)
    _, _, jm = jax.jit(JT.make_train_step(jcfg, None, jopt, JShapeCfg("t", "train", s, bsz)))(
        jparams, jopt.init(jparams), jbatch)
    _same(m1["loss"], jm["loss"], 1e-5)

    dshape = ShapeCfg("t", "decode", s + 4, bsz)
    lg1, c1 = T.make_prefill_step(cfg, ctx, dshape)(params, {"tokens": batch["tokens"]})
    lg0, c0 = T.make_prefill_step(cfg, None, dshape)(params, {"tokens": batch["tokens"]})
    jlg, jc = JT.make_prefill_step(jcfg, None, JShapeCfg("t", "decode", s + 4, bsz))(
        jparams, {"tokens": jbatch["tokens"]})
    _same(lg1, lg0, 1e-6)
    _same(lg1, jlg, 1e-5)
    for k in ("k", "v"):
        _same(c1[k], c0[k], 1e-6)
        _same(c1[k], jc[k], 1e-5)
    serve, serve0 = T.make_serve_step(cfg, ctx), T.make_serve_step(cfg, None)
    jserve = JT.make_serve_step(jcfg, None)
    for t in range(s, s + 4):
        one = {"tokens": torch.tensor(tokens[:, t:t + 1])}
        lg1, c1 = serve(params, c1, one)
        lg0, c0 = serve0(params, c0, one)
        jlg, jc = jserve(jparams, jc, {"tokens": jnp.asarray(tokens[:, t:t + 1])})
        _same(lg1, lg0, 1e-6)
        _same(lg1, jlg, 1e-5)
    assert c1["pos"] == int(jc["pos"]) == s + 4


def test_dp_size_clamps_the_batch_split(monkeypatch):
    """``grad_accum`` and ``serve_microbatch`` are clamped to the batch over
    the data axes, as in the JAX package."""
    mesh = make_debug_mesh(multi_pod=True)  # data 2 x pod 2
    ctx = T.ShardCtx(mesh=mesh, data_axes=("pod", "data"))
    assert T._dp_size(ctx) == JT._dp_size(JT.ShardCtx(mesh=mesh, data_axes=("pod", "data"))) == 4
    assert T._dp_size(T.ShardCtx(mesh=mesh, shard_batch=False)) == T._dp_size(None) == 1
    assert ctx.batch_spec == ("pod", "data")
    assert T.ShardCtx(mesh=mesh, shard_batch=False).batch_spec is None
    cfg = dataclasses.replace(registry.build("mixtral-8x22b", smoke=True).cfg,
                              serve_microbatch={"t": 4})
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (8, 6), generator=torch.Generator().manual_seed(1))
    seen = []
    orig = T.forward_seq

    def spy(*args, **kw):
        seen.append(args[2]["tokens"].shape[0])
        return orig(*args, **kw)

    monkeypatch.setattr(T, "forward_seq", spy)
    T.make_prefill_step(cfg, ctx, ShapeCfg("t", "decode", 8, 8))(params, {"tokens": tokens})
    assert seen == [4, 4]  # min(4, 8 // 4) = 2 strided halves


_SUBPROCESS = """
import jax, jax.numpy as jnp, numpy as np, torch
from jax.sharding import PartitionSpec as P
from repro.core.partition import vocab_parallel_embed as jvpe
from repro.launch.mesh import make_debug_mesh as jmesh
from repro.models import registry as jreg, transformer as JT
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.training.optimizer import adamw as jadamw
import repro.sharding as jsh
from repro_torch.core.partition import vocab_parallel_embed
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import registry, transformer as T
from repro_torch.configs.base import ShapeCfg
from repro_torch.training.optimizer import adamw

mesh, pmesh = jmesh(), make_debug_mesh()
rng = np.random.default_rng(0)
V, D, B, S = 64, 16, 8, 12
table = rng.standard_normal((V, D)).astype(np.float32)
toks = rng.integers(0, V, size=(B, S)).astype(np.int32)
fn = jax.shard_map(lambda t, x: jvpe(t, x, "model"), mesh=mesh,
                   in_specs=(P("model", None), P("data", None)),
                   out_specs=P("data", None, None), check_vma=False)
want = np.asarray(fn(jnp.asarray(table), jnp.asarray(toks)))
got = vocab_parallel_embed(torch.tensor(table), torch.tensor(toks), pmesh.shape["model"])
np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

arch = "qwen3-0.6b"
jb, b = jreg.build(arch, smoke=True), registry.build(arch, smoke=True)
shape = JShapeCfg("t", "train", 64, 8)
jparams = jb.init(jax.random.PRNGKey(0))
batch = jb.make_batch(shape, jax.random.PRNGKey(1), act_dtype=jnp.float32)
jopt = jadamw(1e-3)
jctx = JT.ShardCtx(mesh=mesh, model_axis="model", data_axes=("data",),
                   shard_batch=shape.batch % 2 == 0)
named = jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s),
                     jsh.param_pspecs(jparams, False),
                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
jparams_s = jax.device_put(jparams, named)
_, _, jm = jax.jit(jb.train_step(jctx, jopt, shape))(jparams_s, jopt.init(jparams_s), batch)

params = T.params_from_jax(b.cfg, jax.tree.map(np.asarray, jparams))
ctx = T.ShardCtx(mesh=pmesh, shard_batch=True)
opt = adamw(1e-3)
pbatch = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
_, _, m = b.train_step(ctx, opt, ShapeCfg("t", "train", 64, 8))(params, opt.init(params), pbatch)
np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=5e-3)
print("OK", float(m["loss"]), float(jm["loss"]))
"""


def _run_py(code: str, devices: int = 8, timeout: int = 600) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_port_against_reference_shard_map_on_eight_devices():
    out = _run_py(_SUBPROCESS)
    assert out.startswith("OK"), out
