"""Sharded LMs across ranks: a ``ShardCtx`` over a ``DeviceMesh`` of gloo
ranks, every leaf placed by the sharding rules as a ``DTensor``.

Three spawns (``test_torch_multicard.spawn``, one per rank count, each
under its own timeout) run the dense and MoE families through train,
prefill and decode:

- 8 ranks on the debug mesh ``(data 2, model 4)``: qwen3-0.6b's smoke
  config at 8 x 64, the JAX package's ``test_sharded_train_step_runs``
  case, against the JAX package's sharded train step on 8 forced host
  devices (one subprocess, the same parameters and batch): the loss within
  1e-5 relative, the gradients within 1e-5.  Its 2 KV heads lie below the
  model axis of 4 (the port keeps heads whole, GSPMD splits one), and the
  same run holds prefill and decode against the one-process port;
- 4 ranks on ``(2, 2)``: qwen3-smoke with two accumulated microbatches
  and two strided prefill sub-batches, and granite-moe-smoke with its
  sequence-parallel residual (the full config's ``seq_parallel``); the
  sharded embedding against a plain gather, bitwise with its gradient; a
  checkpoint of the placed parameters and AdamW state, restored on one
  process and on a ``(1, 4)`` mesh of the same ranks;
- 2 ranks on ``(1, 2)``: granite-moe-smoke.

Against the one-process port (``ctx=None``) on the same parameters and
batches: the loss within 1e-5 relative, each gradient leaf, the prefill's
logits, the caches after prefill and every decode step's logits within
``1e-5 * max(|ref|, 1)`` (the ranks' sums run in gloo's and ``DTensor``'s
order).  On every rank the local bytes of the parameters, AdamW's moments
and the caches equal ``per_device_bytes`` of their specs: the leaves are
split, not replicated.  The ranks import no JAX: the reference runs in its
subprocess.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import sharding as sh
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ShapeCfg
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.models.moe import moe_apply
from repro_torch.training.optimizer import Optimizer, adamw
from repro_torch.tree import flatten, leaves, unflatten
from test_torch_multicard import SPAWN_S, SRC, spawn

TOL = 1e-5
DECODE = 4
QWEN = "qwen3-0.6b"
GRANITE = "granite-moe-3b-a800m"
TRAIN, PREFILL = (8, 64), (8, 32)  # (batch, seq)
SEEDS = {"params": 0, "batch": 1}


def _cfg(arch: str, variant: str):
    """The smoke config of ``arch`` as a case runs it: ``accum`` adds two
    accumulated microbatches and two strided prefill sub-batches, ``sp``
    the sequence-parallel residual."""
    cfg = registry.build(arch, smoke=True).cfg
    if variant == "accum":
        return dataclasses.replace(cfg, grad_accum={"t": 2}, serve_microbatch={"p": 2})
    if variant == "sp":
        return dataclasses.replace(cfg, seq_parallel=True)
    return cfg


CASES = {  # name -> (ranks, (data, model), arch, variant)
    "qwen3_2x4": (8, (2, 4), QWEN, "plain"),
    "qwen3_2x2": (4, (2, 2), QWEN, "accum"),
    "granite_2x2": (4, (2, 2), GRANITE, "sp"),
    "granite_1x2": (2, (1, 2), GRANITE, "sp"),
}


def _shapes(prefill=PREFILL, cap=None):
    """The train, prefill and decode shapes; the caches hold ``cap`` slots
    (default: the prompt and the ``DECODE`` steps)."""
    (b, s), (pb, ps) = TRAIN, prefill
    cap = ps + DECODE if cap is None else cap
    return (ShapeCfg("t", "train", s, b), ShapeCfg("p", "prefill", cap, pb),
            ShapeCfg("d", "decode", cap, pb))


def _inputs(cfg, prefill=PREFILL):
    """The parameters (the port's init, seeded) and the batches, from
    numpy: a train batch, a ``prefill`` (batch, seq) batch and ``DECODE``
    decode steps, each of the config's input kind (token ids; embeds with
    M-RoPE positions ``(3, B, S)``; frames beside token ids)."""
    params = registry.Bundle(cfg).init(torch.Generator().manual_seed(SEEDS["params"]))
    rng = np.random.default_rng(SEEDS["batch"])
    (b, s), (pb, ps) = TRAIN, prefill

    def ids(*shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(np.int32))

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def batch(bsz, seq, labels):
        if cfg.input_kind == "embeds":
            out = {"embeds": normal(bsz, seq, cfg.d_model),
                   "positions": torch.from_numpy(rng.integers(0, seq, (3, bsz, seq))
                                                 .astype(np.int32))}
        elif cfg.input_kind == "frames_tokens":
            out = {"frames": normal(bsz, seq, cfg.d_model), "tokens": ids(bsz, seq)}
        else:
            out = {"tokens": ids(bsz, seq)}
        return out | ({"labels": ids(bsz, seq)} if labels else {})

    train, prefill = batch(b, s, True), batch(pb, ps, False)
    if cfg.input_kind == "embeds":  # text positions after the prompt's
        steps = [{"embeds": normal(pb, 1, cfg.d_model),
                  "positions": torch.full((3, pb, 1), ps + t, dtype=torch.int32)}
                 for t in range(DECODE)]
    else:
        steps = [{"tokens": tok} for tok in ids(pb, DECODE).split(1, dim=1)]
    return params, train, prefill, steps


def _grads_optimizer():
    """An "optimizer" whose update returns the gradients: the train step's
    own gradients, exactly."""
    return Optimizer(lambda p: {}, lambda g, state, p: (g, state), "grads")


def _run(cfg, params, train, prefill, steps, ctx=None, mesh=None, shapes=None):
    """Train (loss and gradients), prefill (logits and caches) and decode
    (every step's logits, one a batch of ``steps``) of ``cfg`` at
    ``shapes`` (default ``_shapes()``); on ``mesh`` every input placed by
    its specs first.  -> the results (``DTensor`` leaves on a mesh) and, on a
    mesh, the placed parameters, AdamW state and caches."""
    shape_t, shape_p, shape_d = shapes or _shapes()
    n_dp = sh.dp_size(mesh) if mesh is not None else 1

    def place(tree, specs):
        return sh.with_sharding(mesh, tree, specs) if mesh is not None else tree

    params = place(params, sh.param_pspecs(params, False))
    train = place(train, sh.batch_pspecs(cfg, shape_t, False, n_dp))
    prefill = place(prefill, sh.batch_pspecs(cfg, shape_p, False, n_dp))
    tok_spec = sh.batch_pspecs(cfg, shape_d, False, n_dp)
    step = T.make_train_step(cfg, ctx, _grads_optimizer(), shape_t)
    grads, _, metrics = step(params, {}, train)
    logits, cache = T.make_prefill_step(cfg, ctx, shape_p)(params, prefill)
    serve = T.make_serve_step(cfg, ctx)
    dec, c = [], cache
    for batch in steps:
        lg, c = serve(params, c, place(batch, tok_spec))
        dec.append(lg)
    out = {"loss": metrics["loss"], "grads": grads, "prefill": logits,
           "cache": {k: v for k, v in cache.items() if k != "pos"}, "decode": dec,
           "cache_out": {k: v for k, v in c.items() if k != "pos"}}
    if mesh is None:
        return out
    opt = adamw(1e-3)
    new, state = opt.update(grads, opt.init(params), params)
    return out, {"params": params, "state": state, "new_params": new, "cache": cache,
                 "cache_out": c}


def _full(tree):
    """Every ``DTensor`` leaf whole (a collective: every rank calls it)."""
    flat, treedef = flatten(tree)
    return unflatten(treedef, [x.full_tensor() if sh.is_dtensor(x) else x for x in flat])


def _bytes(cfg, mesh, placed, shapes=None) -> dict:
    """This rank's local bytes of each placed tree beside ``per_device_bytes``
    of its specs."""
    _, _, shape_d = shapes or _shapes()
    pspecs = sh.param_pspecs(placed["params"], False)
    cspecs = sh.cache_pspecs(cfg, shape_d, False, sh.dp_size(mesh))
    out = {}
    for name, tree, specs in (
            ("params", placed["params"], pspecs),
            ("moments", {"m": placed["state"]["m"], "v": placed["state"]["v"]},
             sh.opt_pspecs({"m": placed["state"]["m"], "v": placed["state"]["v"]},
                           pspecs)),
            ("new_params", placed["new_params"], pspecs),
            ("cache", placed["cache"], cspecs),
            ("cache_out", placed["cache_out"], cspecs)):
        out[name] = (sh.local_bytes(tree), sh.per_device_bytes(tree, specs, mesh))
    return out


def _case(name, rank, mesh, tmp, spec=None):
    """Case ``name`` (``spec`` or its ``CASES`` entry) on ``mesh``: rank 0
    saves the whole results, every rank its bytes, to ``tmp``."""
    from repro_torch.launch.dryrun import make_ctx

    _, _, arch, variant = spec or CASES[name]
    cfg = _cfg(arch, variant)
    params, train, prefill, steps = _inputs(cfg)
    if name == "qwen3_2x4":  # the JAX package's parameters, from the test's file
        params = T.params_from_jax(cfg, dict(np.load(f"{tmp}/../params.npz",
                                                     allow_pickle=True))["tree"].item())
    ctx = make_ctx(mesh, _shapes()[0], False)
    out, placed = _run(cfg, params, train, prefill, steps, ctx, mesh)
    rec = {"bytes": _bytes(cfg, mesh, placed), "shard_batch": ctx.shard_batch}
    full = _full(out)
    if rank == 0:
        rec.update(full)
    torch.save(rec, f"{tmp}/{name}_{rank}.pt")
    return placed


def _embed_case(rank, mesh, tmp):
    """The sharded embedding on each rank's own tokens, against a plain
    gather of the same tokens: the rows and the shard's gradient."""
    from repro_torch.core.partition import vocab_parallel_embed_shard

    m = mesh.mesh_dim_names.index("model")
    k, me = mesh.size(m), mesh.get_local_rank(m)
    g = torch.Generator().manual_seed(3)
    table = torch.randn(64, 8, generator=g)
    tokens = torch.randint(0, 64, (2 + mesh.get_local_rank(0), 5), generator=g)
    shard = table.chunk(k)[me].clone().requires_grad_()
    got = vocab_parallel_embed_shard(shard, tokens, me, mesh.get_group(m))
    cot = torch.randn(got.shape, generator=g)
    (grad,) = torch.autograd.grad(got, shard, cot)
    plain = table.clone().requires_grad_()
    want = plain[tokens.long()]
    (pgrad,) = torch.autograd.grad(want, plain, cot)
    return {"rows": torch.equal(got.detach(), want.detach()),
            "grad": torch.equal(grad, pgrad.chunk(k)[me])}


def _ranks_4(rank, tmp):
    from repro_torch.launch.mesh import init_card_mesh

    mesh = init_card_mesh(data=2, device_type="cpu")
    for name in ("qwen3_2x2", "granite_2x2"):
        placed = _case(name, rank, mesh, tmp)
    rec = {"embed": _embed_case(rank, mesh, tmp)}
    # the placed granite parameters and AdamW state, saved from (2, 2) and
    # restored on a (1, 4) mesh of the same ranks
    tree = {"params": placed["params"], "state": placed["state"]}
    ckpt.save(f"{tmp}/ck", 1, tree)
    torch.distributed.barrier()
    mesh14 = init_card_mesh(data=1, device_type="cpu")
    saved = _full(tree)
    # the elastic restore: the structure on meta, placed on the new mesh
    struct = registry.Bundle(_cfg(GRANITE, "sp")).param_struct()
    like = {"params": struct, "state": adamw(1e-3).init(struct)}
    pspecs = sh.param_pspecs(struct, False)
    specs = {"params": pspecs, "state": sh.opt_pspecs(like["state"], pspecs)}
    target = sh.with_sharding(mesh14, like, specs)
    got, step = ckpt.restore(f"{tmp}/ck", None, like, shardings=target)
    rec["restore"] = {
        "step": step, "bytes": (sh.local_bytes(got), sh.per_device_bytes(got, specs, mesh14)),
        "equal": all(torch.equal(a, b) for a, b in zip(leaves(_full(got)), leaves(saved))),
        "placements": all(a.placements == b.placements
                          for a, b in zip(leaves(got), leaves(target)) if sh.is_dtensor(b))}
    torch.save(rec, f"{tmp}/extra_{rank}.pt")


def _ranks_8(rank, tmp):
    from repro_torch.launch.mesh import init_card_mesh

    _case("qwen3_2x4", rank, init_card_mesh(data=2, device_type="cpu"), tmp)


def _ranks_2(rank, tmp):
    from repro_torch.launch.mesh import init_card_mesh

    _case("granite_1x2", rank, init_card_mesh(data=1, device_type="cpu"), tmp)


# --------------------------------------------------------------------------
# the JAX package's sharded step, on 8 forced host devices
# --------------------------------------------------------------------------


_REFERENCE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import ShapeCfg
    from repro.launch.dryrun import make_ctx
    from repro.launch.mesh import make_debug_mesh
    from repro.models import registry
    from repro.training.optimizer import sgd
    import repro.sharding as sh

    tmp = sys.argv[1]
    mesh = make_debug_mesh()
    b = registry.build("qwen3-0.6b", smoke=True)
    d = np.load(tmp + "/params.npz", allow_pickle=True)
    params = jax.tree.map(jnp.asarray, d["tree"].item())
    batch = {k: jnp.asarray(d[k]) for k in ("tokens", "labels")}
    shape = ShapeCfg("t", "train", batch["tokens"].shape[1], batch["tokens"].shape[0])
    ctx = make_ctx(mesh, shape, False)
    named = jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s),
                         sh.param_pspecs(params, False),
                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    params_s = jax.device_put(params, named)
    opt = sgd(1.0)  # new = p - g: the gradient, at the parameters' rounding
    new, _, m = jax.jit(b.train_step(ctx, opt, shape))(params_s, opt.init(params_s), batch)
    grads = jax.tree.map(lambda p, q: np.asarray(p) - np.asarray(q), params, new)
    flat, _ = jax.tree_util.tree_flatten_with_path(grads)
    out = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v
           for path, v in flat}
    np.savez(tmp + "/ref.npz", loss=np.asarray(m["loss"]), **out)
    print("OK")
""")


def _jax_layout(params) -> dict:
    """The port's parameters as the JAX package's tree of numpy arrays:
    each layer leaf (of ``layers`` and ``enc_layers``) stacked along a
    leading layer axis."""
    def conv(*xs):
        if isinstance(xs[0], dict):
            return {k: conv(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack([x.numpy() for x in xs]) if len(xs) > 1 else xs[0].numpy()

    return {k: conv(*v) if k in ("layers", "enc_layers") else conv(v)
            for k, v in params.items()}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The module's directory, holding qwen3-smoke's parameters in the JAX
    package's layout and its train batch (``params.npz``)."""
    tmp = tmp_path_factory.mktemp("sharded_lm")
    params, train, _, _ = _inputs(_cfg(QWEN, "plain"))
    np.savez(tmp / "params.npz", tree=np.array(_jax_layout(params), dtype=object),
             **{k: v.numpy() for k, v in train.items()})
    return tmp


@pytest.fixture(scope="module")
def reference(workdir):
    """The JAX package's sharded step in its subprocess, started before
    the spawns and run beside them; the fixture's value waits for it."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(workdir)], env=env,
                            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def wait():
        if proc.returncode is None:
            so, se = proc.communicate(timeout=100)
            assert proc.returncode == 0 and so.startswith("OK"), so[-3000:] + se[-3000:]
        return dict(np.load(workdir / "ref.npz"))

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _spawned(workdir, world: int, fn) -> dict:
    """``fn`` on ``world`` gloo ranks -> ``{case: [rank records]}`` for the
    cases of that rank count (and ``"extra"`` where the ranks wrote it)."""
    sub = workdir / f"w{world}"
    sub.mkdir()
    # 8 ranks share the test's cores: a longer bound, still inside pytest's 120 s
    codes, errors = spawn(fn, sub, world=world, timeout_s=100.0 if world > 4 else SPAWN_S)
    assert codes == [0] * world, errors
    names = [n for n, (w, _, _, _) in CASES.items() if w == world]
    if (sub / "extra_0.pt").exists():
        names.append("extra")
    return {n: [torch.load(sub / f"{n}_{r}.pt", weights_only=False) for r in range(world)]
            for n in names}


@pytest.fixture(scope="module")
def ranks8(workdir, reference):
    return _spawned(workdir, 8, _ranks_8)


@pytest.fixture(scope="module")
def ranks4(workdir):
    return _spawned(workdir, 4, _ranks_4)


@pytest.fixture(scope="module")
def ranks2(workdir):
    return _spawned(workdir, 2, _ranks_2)


@pytest.fixture
def case(request):
    """``(name, every rank's records)`` of the parametrized case, from its
    rank count's spawn."""
    name = request.param
    return name, request.getfixturevalue(f"ranks{CASES[name][0]}")[name]


@pytest.fixture(scope="module")
def one_process():
    """Each case's config run with ``ctx=None`` in this process."""
    out = {}
    for name, (_, _, arch, variant) in CASES.items():
        cfg = _cfg(arch, variant)
        out[name] = _run(cfg, *_inputs(cfg))
    return out


def _paths(tree) -> list:
    """``(path, leaf)`` for each leaf of ``tree``, the path joined by "/"."""
    out = []
    sh.map_with_path(lambda p, x: out.append(("/".join(p), x)), tree)
    return out


def _close(got, want, what):
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)
    assert err <= TOL, f"{what}: {err} relative"


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------


def test_debug_mesh_loss_matches_reference(ranks8, reference):
    got = float(ranks8["qwen3_2x4"][0]["loss"])
    want = float(reference()["loss"])
    assert abs(got - want) <= TOL * abs(want), (got, want)


def test_debug_mesh_grads_match_reference(ranks8, reference):
    ref = reference()
    grads = ranks8["qwen3_2x4"][0]["grads"]
    names = [k for k in ref if k != "loss"]
    n_layers = len(grads["layers"])
    assert sum(n_layers if k.startswith("layers/") else 1 for k in names) == len(leaves(grads))
    for key in names:
        parts = key.split("/")
        if parts[0] == "layers":
            got = torch.stack([sh._at(grads, ("layers", str(i), *parts[1:]))
                               for i in range(len(grads["layers"]))])
        else:
            got = sh._at(grads, tuple(parts))
        np.testing.assert_allclose(got.numpy(), ref[key], rtol=TOL, atol=TOL, err_msg=key)


# --------------------------------------------------------------------------
# against the one-process port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_loss_and_grads_match_one_process(case, one_process):
    name, recs = case
    got, want = recs[0], one_process[name]
    assert abs(float(got["loss"]) - float(want["loss"])) <= TOL * abs(float(want["loss"]))
    for (path, g), w in zip(_paths(got["grads"]), leaves(want["grads"])):
        _close(g, w, path)


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_prefill_and_caches_match_one_process(case, one_process):
    name, recs = case
    got, want = recs[0], one_process[name]
    _close(got["prefill"], want["prefill"], "prefill logits")
    for key in want["cache"]:
        _close(got["cache"][key], want["cache"][key], f"cache {key}")


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_decode_matches_one_process(case, one_process):
    name, recs = case
    got, want = recs[0], one_process[name]
    for t, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        _close(g, w, f"decode step {t}")
    for key in want["cache_out"]:
        _close(got["cache_out"][key], want["cache_out"][key], f"cache {key} after decode")


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_local_bytes_are_per_device_bytes(case):
    """Parameters, AdamW moments (before and after a step) and caches
    (after prefill and after decode) hold ``per_device_bytes`` on every
    rank, fewer parameter bytes than the whole model's."""
    _, recs = case
    for r, rec in enumerate(recs):
        for what, (local, per_device) in rec["bytes"].items():
            assert local == per_device, (r, what, local, per_device)
        assert rec["shard_batch"]
    whole = sum(x.numel() * x.element_size() for x in leaves(recs[0]["grads"]))
    assert recs[0]["bytes"]["params"][0] < whole


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------


def test_sharded_embed_is_a_plain_gather_bitwise(ranks4):
    for r, rec in enumerate(ranks4["extra"]):
        assert rec["embed"] == {"rows": True, "grad": True}, (r, rec["embed"])


def test_checkpoint_from_2x2_restores_on_1x4(ranks4):
    for r, rec in enumerate(ranks4["extra"]):
        res = rec["restore"]
        assert res["step"] == 1 and res["equal"] and res["placements"], (r, res)
        assert res["bytes"][0] == res["bytes"][1], (r, res["bytes"])


def test_checkpoint_from_2x2_restores_on_one_process(ranks4, workdir):
    """The checkpoint the ranks wrote holds the placed parameters whole:
    one process restores them to the granite case's initial values."""
    ck = workdir / "w4" / "ck"
    cfg = _cfg(GRANITE, "sp")
    params, _, _, _ = _inputs(cfg)
    opt = adamw(1e-3)
    like = {"params": params, "state": opt.init(params)}
    got, step = ckpt.restore(ck, None, like)
    assert step == 1
    for a, b in zip(leaves(got["params"]), leaves(params)):
        assert torch.equal(a, b)


def test_moe_constrain_none_is_unchanged():
    """``moe_apply`` with ``constrain=None`` equals it with a hook that
    changes nothing, bitwise, and the hook sees ``xe``, ``h`` and ``ye``."""
    cfg = registry.build(GRANITE, smoke=True).cfg
    params = registry.Bundle(cfg).init(torch.Generator().manual_seed(0))["layers"][0]["moe"]
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    seen = []

    def hook(name, t):
        seen.append((name, tuple(t.shape)))
        return t

    out, aux = moe_apply(params, x, cfg.moe)
    out2, aux2 = moe_apply(params, x, cfg.moe, constrain=hook)
    assert torch.equal(out, out2) and torch.equal(aux, aux2)
    e, f = cfg.moe.n_experts, cfg.moe.d_ff
    assert [n for n, _ in seen] == ["xe", "h", "ye"]
    assert seen[1][1][1:2] == (e,) and seen[1][1][3] == f
