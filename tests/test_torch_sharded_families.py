"""The ssm (mamba2), hybrid (zamba2), encdec (whisper) and vlm (qwen2-vl)
LM families across ranks: a ``ShardCtx`` over a ``DeviceMesh`` of gloo
ranks, every leaf placed by the sharding rules as a ``DTensor``, through
the train step, prefill and decode (``test_torch_sharded_lm``'s harness).

Each family at its smoke config, with the published config's
``seq_parallel`` (whisper and qwen2-vl run the sequence-parallel residual);
the inputs of its kind from numpy: token ids, frames beside token ids, or
embeds with M-RoPE positions ``(3, B, S)``.  Three spawns
(``test_torch_multicard.spawn``, each under its own timeout):

- 8 ranks on the debug mesh ``(data 2, model 4)``: one train step of each
  family against the JAX package's sharded train step on 8 forced host
  devices (one subprocess beside the spawn; the parameters carried across
  by ``params_from_jax``): the loss within 1e-5 relative, the gradients
  within 1e-5;
- 4 ranks on ``(2, 2)`` and 4 on ``(1, 4)``: train, prefill and decode
  against the one-process port (``ctx=None``): the loss within 1e-5
  relative, each gradient leaf, the prefill's logits and caches and every
  decode step's logits within ``1e-5 * max(|ref|, 1)``; on every rank the
  local bytes of the parameters, AdamW's moments and the caches equal to
  ``per_device_bytes`` of their specs.  On ``(1, 4)`` the all-gathers are
  recorded: one decode step of mamba2 makes at most two a layer (the
  projection's output and the conv's, each once), and whisper's forward
  and decode never gather ``pos_emb`` whole; its rows come through the
  embedding's gather form, bitwise a plain slice.

The ranks import no JAX: the reference runs in its subprocess.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import sharding as sh
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.tree import leaves
from test_torch_multicard import SPAWN_S, SRC, spawn
from test_torch_sharded_lm import (
    TOL,
    _bytes,
    _close,
    _full,
    _grads_optimizer,
    _inputs,
    _jax_layout,
    _paths,
    _run,
    _shapes,
)

FAMILIES = {"mamba2": "mamba2-780m", "zamba2": "zamba2-1.2b", "whisper": "whisper-small",
            "qwen2vl": "qwen2-vl-2b"}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}  # the one-process comparison's meshes
GATHERS_A_LAYER = 2  # a mamba decode step: the projection's output and the conv's


def _cfg(arch: str):
    """``arch``'s smoke config with its published config's ``seq_parallel``."""
    cfg = registry.build(arch, smoke=True).cfg
    return dataclasses.replace(cfg, seq_parallel=registry.build(arch).cfg.seq_parallel)


class _Gathers(TorchDispatchMode):
    """The all-gathers run while it is on: the shape each one returns, the
    ranks' shards stacked or concatenated (``DTensor`` ops are let through
    to desugar into their collectives first, as ``CommDebugMode`` does)."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if "allgather" in str(func).replace("_", ""):
            if isinstance(out, torch.Tensor):  # the functional collective
                self.shapes.append(tuple(out.shape))
            else:  # c10d's allgather_ fills its output lists, one per input
                parts = args[0][0]
                self.shapes.append((len(parts), *parts[0].shape))
        return out


def _counts(cfg, mesh):
    """On ``mesh``: the all-gathers of one train step, one prefill and one
    decode step after it (their shapes), and for whisper whether its
    position rows are bitwise a plain slice of ``pos_emb``."""
    from repro_torch.launch.dryrun import make_ctx

    shape_t, shape_p, shape_d = _shapes()
    n_dp = sh.dp_size(mesh)
    params, train, prefill, steps = _inputs(cfg)
    params = sh.with_sharding(mesh, params, sh.param_pspecs(params, False))
    train = sh.with_sharding(mesh, train, sh.batch_pspecs(cfg, shape_t, False, n_dp))
    prefill = sh.with_sharding(mesh, prefill, sh.batch_pspecs(cfg, shape_p, False, n_dp))
    step = sh.with_sharding(mesh, steps[0], sh.batch_pspecs(cfg, shape_d, False, n_dp))
    ctx = make_ctx(mesh, shape_t, False)
    out = {}
    with _Gathers() as rec:
        T.make_train_step(cfg, ctx, _grads_optimizer(), shape_t)(params, {}, train)
    out["train"] = rec.shapes
    with _Gathers() as rec:
        _, cache = T.make_prefill_step(cfg, ctx, shape_p)(params, prefill)
    out["prefill"] = rec.shapes
    with _Gathers() as rec:
        T.make_serve_step(cfg, ctx)(params, cache, step)
    out["decode"] = rec.shapes
    if cfg.family == "encdec":
        table = params["pos_emb"]
        out["pos_emb"] = table.numel()
        with _Gathers() as rec, T._scope(ctx):
            rows = T._position_rows(ctx, table, _positions(6, 5, 0), 7)
            last = T._position_rows(ctx, table, _positions(6, 1, 0), table.shape[0] - 1)
        out["pos_rows_gathers"] = rec.shapes
        whole = table.full_tensor()
        out["pos_rows"] = (torch.equal(_full(rows), whole[7:12].expand(6, 5, -1))
                           and torch.equal(_full(last), whole[-1:].expand(6, 1, -1)))
    return out


def _positions(bsz, seq, offset):
    return (torch.arange(seq, dtype=torch.int32) + offset)[None].expand(bsz, seq)


def _ranks_mesh(rank, tmp, mesh_name):
    """Every family on ``MESHES[mesh_name]``: rank 0 saves the whole
    results, every rank its bytes (and on ``(1, 4)`` the gathers)."""
    from repro_torch.launch.dryrun import make_ctx
    from repro_torch.launch.mesh import init_card_mesh

    data, model = MESHES[mesh_name]
    mesh = init_card_mesh(data, model, device_type="cpu")
    for fam, arch in FAMILIES.items():
        cfg = _cfg(arch)
        ctx = make_ctx(mesh, _shapes()[0], False)
        out, placed = _run(cfg, *_inputs(cfg), ctx, mesh)
        rec = {"bytes": _bytes(cfg, mesh, placed), "shard_batch": ctx.shard_batch}
        if mesh_name == "1x4" and fam in ("mamba2", "whisper"):
            rec["gathers"] = _counts(cfg, mesh)
        full = _full(out)
        if rank == 0:
            rec.update(full)
        torch.save(rec, f"{tmp}/{fam}_{rank}.pt")


def _ranks_2x2(rank, tmp):
    _ranks_mesh(rank, tmp, "2x2")


def _ranks_1x4(rank, tmp):
    _ranks_mesh(rank, tmp, "1x4")


def _ranks_8(rank, tmp):
    """One train step of every family on the debug mesh, on the JAX
    package's parameters: rank 0 saves the loss and the gradients."""
    from repro_torch.launch.dryrun import make_ctx
    from repro_torch.launch.mesh import init_card_mesh

    mesh = init_card_mesh(data=2, device_type="cpu")
    shape_t = _shapes()[0]
    for fam, arch in FAMILIES.items():
        cfg = _cfg(arch)
        _, train, _, _ = _inputs(cfg)
        tree = dict(np.load(f"{tmp}/../{fam}.npz", allow_pickle=True))["tree"].item()
        params = T.params_from_jax(cfg, tree)
        ctx = make_ctx(mesh, shape_t, False)
        params = sh.with_sharding(mesh, params, sh.param_pspecs(params, False))
        train = sh.with_sharding(mesh, train, sh.batch_pspecs(cfg, shape_t, False,
                                                              sh.dp_size(mesh)))
        grads, _, m = T.make_train_step(cfg, ctx, _grads_optimizer(), shape_t)(params, {},
                                                                              train)
        full = _full({"loss": m["loss"], "grads": grads})
        if rank == 0:
            torch.save(full, f"{tmp}/{fam}_0.pt")


# --------------------------------------------------------------------------
# the JAX package's sharded step, on 8 forced host devices
# --------------------------------------------------------------------------


_REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import ShapeCfg
    from repro.launch.dryrun import make_ctx
    from repro.launch.mesh import make_debug_mesh
    from repro.models import registry
    from repro.training.optimizer import sgd
    import repro.sharding as sh

    tmp, families = sys.argv[1], sys.argv[2:]
    mesh = make_debug_mesh()
    for fam_arch in families:
        fam, arch = fam_arch.split("=")
        cfg = registry.build(arch, smoke=True).cfg
        cfg = dataclasses.replace(cfg, seq_parallel=registry.build(arch).cfg.seq_parallel)
        b = registry.Bundle(cfg)
        d = np.load(f"{tmp}/{fam}.npz", allow_pickle=True)
        params = jax.tree.map(jnp.asarray, d["tree"].item())
        batch = {k: jnp.asarray(d[k]) for k in d.files if k != "tree"}
        shape = ShapeCfg("t", "train", batch["labels"].shape[1], batch["labels"].shape[0])
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
        np.savez(f"{tmp}/{fam}_ref.npz", loss=np.asarray(m["loss"]), **out)
    print("OK")
""")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The module's directory, holding each family's parameters in the JAX
    package's layout and its train batch (``<family>.npz``)."""
    tmp = tmp_path_factory.mktemp("sharded_families")
    for fam, arch in FAMILIES.items():
        params, train, _, _ = _inputs(_cfg(arch))
        np.savez(tmp / f"{fam}.npz", tree=np.array(_jax_layout(params), dtype=object),
                 **{k: v.numpy() for k, v in train.items()})
    return tmp


@pytest.fixture(scope="module")
def reference(workdir):
    """The JAX package's sharded steps in their subprocess, started before
    the spawns and run beside them; the fixture's value waits for it."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(workdir),
         *(f"{fam}={arch}" for fam, arch in FAMILIES.items())],
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def wait():
        if proc.returncode is None:
            so, se = proc.communicate(timeout=100)
            assert proc.returncode == 0 and so.startswith("OK"), so[-3000:] + se[-3000:]
        return {fam: dict(np.load(workdir / f"{fam}_ref.npz")) for fam in FAMILIES}

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _spawned(workdir, name: str, world: int, fn) -> dict:
    """``fn`` on ``world`` gloo ranks -> ``{family: [rank records]}`` (rank
    0's alone where only rank 0 writes)."""
    sub = workdir / name
    sub.mkdir()
    # 8 ranks share the test's cores: a longer bound, still inside pytest's 120 s
    codes, errors = spawn(fn, sub, world=world, timeout_s=100.0 if world > 4 else SPAWN_S)
    assert codes == [0] * world, errors
    return {fam: [torch.load(p, weights_only=False)
                  for p in sorted(sub.glob(f"{fam}_*.pt"))] for fam in FAMILIES}


@pytest.fixture(scope="module")
def ranks8(workdir, reference):
    return _spawned(workdir, "w8", 8, _ranks_8)


@pytest.fixture(scope="module")
def ranks_2x2(workdir):
    return _spawned(workdir, "2x2", 4, _ranks_2x2)


@pytest.fixture(scope="module")
def ranks_1x4(workdir):
    return _spawned(workdir, "1x4", 4, _ranks_1x4)


@pytest.fixture
def mesh_ranks(request):
    """Every family's records on the parametrized mesh, from its spawn."""
    return request.getfixturevalue(f"ranks_{request.param}")


@pytest.fixture(scope="module")
def one_process():
    """Each family run with ``ctx=None`` in this process."""
    return {fam: _run(_cfg(arch), *_inputs(_cfg(arch))) for fam, arch in FAMILIES.items()}


CASES = [(m, f) for m in MESHES for f in FAMILIES]


def _case_ids():
    return [f"{f}-{m}" for m, f in CASES]


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_debug_mesh_loss_matches_reference(fam, ranks8, reference):
    got = float(ranks8[fam][0]["loss"])
    want = float(reference()[fam]["loss"])
    assert abs(got - want) <= TOL * abs(want), (got, want)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_debug_mesh_grads_match_reference(fam, ranks8, reference):
    ref = reference()[fam]
    grads = ranks8[fam][0]["grads"]
    names = [k for k in ref if k != "loss"]
    stacks = {k: len(grads[k]) for k in ("layers", "enc_layers") if k in grads}
    assert sum(stacks.get(k.split("/")[0], 1) for k in names) == len(leaves(grads))
    for key in names:
        parts = key.split("/")
        if parts[0] in stacks:
            got = torch.stack([sh._at(grads, (parts[0], str(i), *parts[1:]))
                               for i in range(stacks[parts[0]])])
        else:
            got = sh._at(grads, tuple(parts))
        np.testing.assert_allclose(got.numpy(), ref[key], rtol=TOL, atol=TOL, err_msg=key)


# --------------------------------------------------------------------------
# against the one-process port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_ranks,fam", CASES, ids=_case_ids(), indirect=["mesh_ranks"])
def test_loss_and_grads_match_one_process(mesh_ranks, fam, one_process):
    got, want = mesh_ranks[fam][0], one_process[fam]
    assert abs(float(got["loss"]) - float(want["loss"])) <= TOL * abs(float(want["loss"]))
    for (path, g), w in zip(_paths(got["grads"]), leaves(want["grads"])):
        _close(g, w, path)


@pytest.mark.parametrize("mesh_ranks,fam", CASES, ids=_case_ids(), indirect=["mesh_ranks"])
def test_prefill_and_caches_match_one_process(mesh_ranks, fam, one_process):
    got, want = mesh_ranks[fam][0], one_process[fam]
    _close(got["prefill"], want["prefill"], "prefill logits")
    assert set(got["cache"]) == set(want["cache"])
    for key in want["cache"]:
        _close(got["cache"][key], want["cache"][key], f"cache {key}")


@pytest.mark.parametrize("mesh_ranks,fam", CASES, ids=_case_ids(), indirect=["mesh_ranks"])
def test_decode_matches_one_process(mesh_ranks, fam, one_process):
    got, want = mesh_ranks[fam][0], one_process[fam]
    for t, (g, w) in enumerate(zip(got["decode"], want["decode"], strict=True)):
        _close(g, w, f"decode step {t}")
    for key in want["cache_out"]:
        _close(got["cache_out"][key], want["cache_out"][key], f"cache {key} after decode")


@pytest.mark.parametrize("mesh_ranks,fam", CASES, ids=_case_ids(), indirect=["mesh_ranks"])
def test_local_bytes_are_per_device_bytes(mesh_ranks, fam):
    """Parameters, AdamW moments (before and after a step) and caches
    (after prefill and after decode) hold ``per_device_bytes`` on every
    rank, fewer parameter bytes than the whole model's."""
    recs = mesh_ranks[fam]
    assert len(recs) == 4
    for r, rec in enumerate(recs):
        for what, (local, per_device) in rec["bytes"].items():
            assert local == per_device, (r, what, local, per_device)
        assert rec["shard_batch"]
    whole = sum(x.numel() * x.element_size() for x in leaves(recs[0]["grads"]))
    assert recs[0]["bytes"]["params"][0] < whole


# --------------------------------------------------------------------------
# the collectives
# --------------------------------------------------------------------------


def test_mamba_decode_gathers_each_tensor_once(ranks_1x4):
    """One mamba2 decode step on ``(1, 4)`` makes at most two all-gathers a
    layer on every rank: the projection's output and the conv's."""
    n_layers = _cfg(FAMILIES["mamba2"]).n_layers
    for r, rec in enumerate(ranks_1x4["mamba2"]):
        shapes = rec["gathers"]["decode"]
        assert 0 < len(shapes) <= GATHERS_A_LAYER * n_layers, (r, shapes)


def test_whisper_never_gathers_pos_emb(ranks_1x4):
    """Whisper's train step, prefill and decode on ``(1, 4)`` gather no
    tensor of ``pos_emb``'s size on any rank, and its position rows (the
    embedding's gather form, a sum over ``"model"``) equal a plain slice
    bitwise, the last row too."""
    for r, rec in enumerate(ranks_1x4["whisper"]):
        g = rec["gathers"]
        for what in ("train", "prefill", "decode"):
            sizes = [int(np.prod(s)) for s in g[what]]
            assert g["pos_emb"] not in sizes, (r, what, g[what])
        assert g["pos_rows_gathers"] == [], (r, g["pos_rows_gathers"])
        assert g["pos_rows"], r
