"""Mixtral's sliding window with its rolling cache, and chatglm3's partial
RoPE with 2 KV heads, across ranks: a ``ShardCtx`` over a ``DeviceMesh``
of gloo ranks, every leaf placed by the sharding rules as a ``DTensor``,
through the train step, prefill and decode (``test_torch_sharded_lm``'s
harness).

mixtral-8x22b's smoke config with the published ``seq_parallel`` (window
32) and chatglm3-6b's (8 heads, 2 KV heads, ``rotary_frac`` 0.5).  Inputs
from numpy with the harness's seeds: a train batch of 8 x 64 (mixtral's
window binds in train), a prefill of 8 x 38 and 4 decode steps at
positions 38-41.  The caches hold 44 slots, which the model axis of 4
divides; mixtral's window cuts them to 32, so its prefill is packed in the
rolling layout and decode writes rolling slots 6-9, which cross from rank
0's slots to rank 1's on ``(1, 4)``.  One spawn of four ranks
(``test_torch_multicard.spawn``, under its own timeout), on ``(2, 2)`` and
then on ``(1, 4)``, against the one-process port (``ctx=None``): the loss,
each gradient leaf, the prefill's logits and caches, every decode step's
logits and every slot of the cache after the last decode step within
``1e-5 * max(|ref|, 1)``; on every rank the local bytes of the parameters,
AdamW's moments and the caches equal to ``per_device_bytes`` of their
specs.  On ``(1, 4)`` one rolling decode step's all-gathers are recorded:
none returns a whole layer's cache.

``test_torch_sharded_swa_glm_reference.py`` holds the same configs and
inputs on 8 ranks against the JAX package's sharded steps (a file of its
own, so that the tier-1 run's ``--dist loadfile`` gives it another
worker).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import sharding as sh
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.tree import leaves
from test_torch_multicard import spawn
from test_torch_sharded_families import _Gathers
from test_torch_sharded_lm import (
    DECODE,
    TOL,
    _bytes,
    _close,
    _full,
    _inputs,
    _paths,
    _run,
    _shapes,
)

ARCHS = {"mixtral": "mixtral-8x22b", "chatglm3": "chatglm3-6b"}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}  # the one-process comparison's meshes
PREFILL = (8, 38)  # past mixtral-smoke's window of 32
CAP = 44  # cache slots: the prompt, the decode steps and two more, 11 a rank on (1, 4)
SHAPES = _shapes(PREFILL, CAP)


def _cfg(arch: str):
    """``arch``'s smoke config with its published config's ``seq_parallel``."""
    cfg = registry.build(arch, smoke=True).cfg
    return dataclasses.replace(cfg, seq_parallel=registry.build(arch).cfg.seq_parallel)


def _data(arch: str):
    return _inputs(_cfg(arch), PREFILL)


def _whole_cache_sizes(cfg) -> set:
    """The elements of one layer's whole cache ``(B, cap, KV, dh)`` and of
    every layer's."""
    one = SHAPES[1].batch * T._cache_capacity(cfg, SHAPES[1]) * cfg.n_kv_heads * cfg.head_dim
    return {one, cfg.n_layers * one}


def _decode_gathers(cfg, mesh, params, prefill, step) -> list:
    """The all-gathers (their shapes) of one decode step after the prefill
    on ``mesh``."""
    from repro_torch.launch.dryrun import make_ctx

    shape_t, shape_p, shape_d = SHAPES
    n_dp = sh.dp_size(mesh)
    params = sh.with_sharding(mesh, params, sh.param_pspecs(params, False))
    prefill = sh.with_sharding(mesh, prefill, sh.batch_pspecs(cfg, shape_p, False, n_dp))
    step = sh.with_sharding(mesh, step, sh.batch_pspecs(cfg, shape_d, False, n_dp))
    ctx = make_ctx(mesh, shape_t, False)
    _, cache = T.make_prefill_step(cfg, ctx, shape_p)(params, prefill)
    with _Gathers() as rec:
        T.make_serve_step(cfg, ctx)(params, cache, step)
    return rec.shapes


def _ranks_4(rank, tmp):
    """Both configs on each mesh of ``MESHES``, the same four ranks: rank 0
    saves the whole results, every rank its bytes (and on ``(1, 4)`` a
    decode step's gathers)."""
    from repro_torch.launch.dryrun import make_ctx
    from repro_torch.launch.mesh import init_card_mesh

    for mesh_name, (data, model) in MESHES.items():
        mesh = init_card_mesh(data, model, device_type="cpu")
        for name, arch in ARCHS.items():
            cfg = _cfg(arch)
            params, train, prefill, steps = _data(arch)
            ctx = make_ctx(mesh, SHAPES[0], False)
            out, placed = _run(cfg, params, train, prefill, steps, ctx, mesh, SHAPES)
            rec = {"bytes": _bytes(cfg, mesh, placed, SHAPES), "shard_batch": ctx.shard_batch}
            if mesh_name == "1x4":
                rec["gathers"] = _decode_gathers(cfg, mesh, params, prefill, steps[0])
            full = _full(out)
            if rank == 0:
                rec.update(full)
            torch.save(rec, f"{tmp}/{mesh_name}_{name}_{rank}.pt")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded_swa_glm")


def _spawned(workdir, sub: str, world: int, fn, timeout_s: float, prefixes) -> dict:
    """``fn`` on ``world`` gloo ranks -> ``{prefix: {name: [rank records]}}``
    (rank 0's alone where only rank 0 writes)."""
    path = workdir / sub
    path.mkdir()
    codes, errors = spawn(fn, path, world=world, timeout_s=timeout_s)
    assert codes == [0] * world, errors
    return {pre: {name: [torch.load(p, weights_only=False)
                         for p in sorted(path.glob(f"{pre}{name}_*.pt"))] for name in ARCHS}
            for pre in prefixes}


@pytest.fixture(scope="module")
def ranks4(workdir):
    """Both meshes of ``MESHES`` on one spawn of four ranks; two meshes'
    work: a longer bound than one mesh's, still inside pytest's 120 s."""
    return _spawned(workdir, "w4", 4, _ranks_4, 110.0, [f"{m}_" for m in MESHES])


@pytest.fixture
def mesh_ranks(request, ranks4):
    """Both configs' records on the parametrized mesh."""
    return ranks4[f"{request.param}_"]


@pytest.fixture(scope="module")
def one_process():
    """Each config run with ``ctx=None`` in this process, on one thread (the
    tier-1 run's workers share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: _run(_cfg(arch), *_data(arch), shapes=SHAPES)
                for name, arch in ARCHS.items()}
    finally:
        torch.set_num_threads(threads)


CASES = [(m, n) for m in MESHES for n in ARCHS]


def _case_ids():
    return [f"{n}-{m}" for m, n in CASES]


# --------------------------------------------------------------------------
# the shapes
# --------------------------------------------------------------------------


def test_mixtral_decode_writes_rolling_slots_across_ranks():
    """The prompt outruns mixtral-smoke's window, so the cache is the
    window's 32 slots in the rolling layout; the decode steps write slots
    6-9, which lie on two ranks of a model axis of 4; chatglm3 keeps 44
    linear slots, 11 a rank."""
    cfg = _cfg(ARCHS["mixtral"])
    shape_p = SHAPES[1]
    cap = T._cache_capacity(cfg, shape_p)
    assert (cap, cfg.window) == (32, 32) and PREFILL[1] > cap
    slots = [(PREFILL[1] + t) % cap for t in range(DECODE)]
    assert slots == [6, 7, 8, 9]
    per_rank = cap // MESHES["1x4"][1]
    assert {s // per_rank for s in slots} == {0, 1}
    glm = _cfg(ARCHS["chatglm3"])
    assert T._cache_capacity(glm, shape_p) == CAP and CAP % MESHES["1x4"][1] == 0
    assert (glm.n_kv_heads, glm.rotary_frac) == (2, 0.5)


# --------------------------------------------------------------------------
# against the one-process port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_ranks,name", CASES, ids=_case_ids(), indirect=["mesh_ranks"])
def test_loss_and_grads_match_one_process(mesh_ranks, name, one_process):
    got, want = mesh_ranks[name][0], one_process[name]
    assert abs(float(got["loss"]) - float(want["loss"])) <= TOL * abs(float(want["loss"]))
    for (path, g), w in zip(_paths(got["grads"]), leaves(want["grads"]), strict=True):
        _close(g, w, path)


@pytest.mark.parametrize("mesh_ranks,name", CASES, ids=_case_ids(), indirect=["mesh_ranks"])
def test_prefill_and_caches_match_one_process(mesh_ranks, name, one_process):
    got, want = mesh_ranks[name][0], one_process[name]
    _close(got["prefill"], want["prefill"], "prefill logits")
    assert set(got["cache"]) == set(want["cache"]) == {"k", "v"}
    for key in want["cache"]:
        _close(got["cache"][key], want["cache"][key], f"cache {key}")


@pytest.mark.parametrize("mesh_ranks,name", CASES, ids=_case_ids(), indirect=["mesh_ranks"])
def test_decode_and_cache_after_decode_match_one_process(mesh_ranks, name, one_process):
    """Every decode step's logits, and every slot of the cache after the
    last step (mixtral's rolling slots 6-9 among them)."""
    got, want = mesh_ranks[name][0], one_process[name]
    for t, (g, w) in enumerate(zip(got["decode"], want["decode"], strict=True)):
        _close(g, w, f"decode step {t}")
    for key in ("k", "v"):
        g, w = got["cache_out"][key], want["cache_out"][key]
        assert g.shape == w.shape
        _close(g, w, f"cache {key} after decode")
        assert not torch.equal(w, want["cache"][key])  # decode wrote slots


@pytest.mark.parametrize("mesh_ranks,name", CASES, ids=_case_ids(), indirect=["mesh_ranks"])
def test_local_bytes_are_per_device_bytes(mesh_ranks, name):
    """Parameters, AdamW moments (before and after a step) and caches
    (after prefill and after decode) hold ``per_device_bytes`` on every
    rank, fewer parameter bytes than the whole model's."""
    recs = mesh_ranks[name]
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


@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_never_gathers_a_whole_cache(name, ranks4):
    """One decode step on ``(1, 4)`` writes the sequence-split cache
    rank-locally (mixtral's rolling slot too): no all-gather on any rank
    returns one layer's whole cache or every layer's."""
    whole = _whole_cache_sizes(_cfg(ARCHS[name]))
    for r, rec in enumerate(ranks4["1x4_"][name]):
        shapes = rec["gathers"]
        assert shapes, r  # the recorder saw the step's gathers (the logits' at least)
        assert not [s for s in shapes if int(np.prod(s)) in whole], (r, shapes)
