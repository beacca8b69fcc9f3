"""Training: the port's optimizers, gradient compression, checkpoints, loop
and DLRM train step against the JAX package's (``tests/test_training_serving.py``
for the loop's and checkpoint's behaviour), on the same seeded trees.

Tolerances: the optimizers' updates within rtol = atol = 1e-6 (the same f32
formulas on the same inputs; ``pow`` and ``sqrt`` may differ in the last
bit).  The DLRM train step within rtol = 1e-5 on the losses and rtol = atol
= 1e-5 on the parameters after 3 steps: both sides differentiate the same
f32 forward, whose reductions (MLP products, pairwise dots, the gather's
scatter-add) sum in another order in XLA and in torch.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core.tables import make_workload as jmake_workload
from repro.data.synthetic import ctr_batch as jctr_batch
from repro.models import dlrm as jdlrm
from repro.training import compress as jcompress
from repro.training import optimizer as jopt
from repro_torch import tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.tables import make_workload
from repro_torch.data.synthetic import ctr_batch
from repro_torch.models import dlrm
from repro_torch.training import compress
from repro_torch.training import optimizer as topt
from repro_torch.training.loop import LoopConfig, SimulatedFailure, train

OPT_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
ROWS, SEQS = [100, 50, 1000, 20, 333], [1, 2, 1, 3, 1]


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": [rng.standard_normal(5).astype(np.float32),
                  rng.standard_normal((2, 3)).astype(np.float32)],
            "a": rng.standard_normal((3, 4)).astype(np.float32)}


def _torch(t):
    return tree.tree_map(lambda x: torch.tensor(np.asarray(x)), t)


def _assert_trees_close(got, want, **tol):
    g_leaves, g_def = tree.flatten(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)


# ------------------------------------------------------------------- trees


def test_tree_order_matches_jax():
    t = {"z": [1, (2, 3)], "a": {"y": 4, "b": None, "c": 5}}
    leaves, treedef = tree.flatten(t)
    assert leaves == jax.tree_util.tree_leaves(t) == [5, 4, 1, 2, 3]
    assert tree.unflatten(treedef, [x * 10 for x in leaves]) == {
        "a": {"b": None, "c": 50, "y": 40}, "z": [10, (20, 30)]}
    with pytest.raises(ValueError):
        tree.tree_map(lambda a, b: a, t, {"z": [1, 2], "a": {}})


# --------------------------------------------------------------- optimizers


OPTS = {
    "sgd": (lambda: topt.sgd(0.1), lambda: jopt.sgd(0.1)),
    "sgd-momentum": (lambda: topt.sgd(0.1, 0.9), lambda: jopt.sgd(0.1, 0.9)),
    "adagrad": (lambda: topt.adagrad(0.5), lambda: jopt.adagrad(0.5)),
    "adamw": (lambda: topt.adamw(0.05, weight_decay=0.01), lambda: jopt.adamw(0.05, weight_decay=0.01)),
    "adamw-clipped": (lambda: topt.adamw(0.05, grad_clip=0.1), lambda: jopt.adamw(0.05, grad_clip=0.1)),
    "adamw-bf16-moments": (lambda: topt.adamw(0.05, moments_dtype=torch.bfloat16),
                           lambda: jopt.adamw(0.05, moments_dtype=jnp.bfloat16)),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_updates_match_reference(name):
    """Three updates on the same tree and gradients: parameters and every
    state leaf (moments, accumulators, the step) as the JAX package's."""
    make, jmake = OPTS[name]
    opt, jo = make(), jmake()
    p_np = _np_tree(0)
    params, jparams = _torch(p_np), jax.tree.map(jnp.asarray, p_np)
    state, jstate = opt.init(params), jo.init(jparams)
    for k in range(3):
        g_np = jax.tree.map(lambda x: 3.0 * x, _np_tree(k + 1))
        params, state = opt.update(_torch(g_np), state, params)
        jparams, jstate = jo.update(jax.tree.map(jnp.asarray, g_np), jstate, jparams)
    _assert_trees_close(params, jparams, **OPT_TOL)
    _assert_trees_close(state, jstate, **OPT_TOL)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 3


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizers_minimize_quadratic(name):
    opt = OPTS[name][0]()
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update(tree.tree_map(lambda w: 2 * w, params), state, params)
    assert float(params["w"].abs().max()) < 0.05


# -------------------------------------------------------------- compression


def test_compress_grads_match_reference():
    g_np, e_np = _np_tree(1), jax.tree.map(lambda x: 0.01 * x, _np_tree(2))
    got, err = compress.compress_grads(_torch(g_np), _torch(e_np))
    want, jerr = jcompress.compress_grads(jax.tree.map(jnp.asarray, g_np),
                                          jax.tree.map(jnp.asarray, e_np))
    _assert_trees_close(got, want, **OPT_TOL)
    _assert_trees_close(err, jerr, **OPT_TOL)
    q, _ = compress.quantize(torch.tensor(g_np["a"]))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127


def test_int8_compression_error_feedback_converges():
    """Quantized-gradient descent with error feedback reaches the optimum."""
    w_true = torch.tensor([1.5, -2.0, 0.25, 3.0])
    params = {"w": torch.zeros(4)}
    err = compress.init_error_state(params)
    opt = topt.sgd(0.1)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(0)
    for _ in range(300):
        x = torch.randn((64, 4), generator=gen)
        y = x @ w_true
        _, grads = tree.value_and_grad(lambda p: torch.mean((x @ p["w"] - y) ** 2), params)
        grads, err = compress.compress_grads(grads, err)
        params, state = opt.update(grads, state, params)
    assert float((params["w"] - w_true).abs().max()) < 0.05


def test_compression_wire_bytes():
    params = {"w": torch.zeros(1000), "b": torch.zeros(10)}
    fp32, int8 = compress.wire_bytes(params)
    assert (fp32, int8) == jcompress.wire_bytes({"w": jnp.zeros(1000), "b": jnp.zeros(10)})
    assert fp32 == 4 * 1010 and int8 < fp32 / 3.5


# --------------------------------------------------------------- checkpoint


def test_checkpoint_roundtrip(tmp_path):
    t = {"a": torch.arange(12.0).reshape(3, 4), "b": [torch.ones(5), torch.zeros(2)],
         "h": torch.arange(4.0).to(torch.bfloat16), "n": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(tmp_path, 7, t)
    restored, step = ckpt.restore(tmp_path, None, t)
    assert step == 7
    for x, y in zip(tree.leaves(t), tree.leaves(restored)):
        assert x.dtype == y.dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "float32", "float32", "float32", "bfloat16", "int32"]


def test_checkpoint_keeps_last_n(tmp_path):
    for s in range(6):
        ckpt.save(tmp_path, s, {"x": torch.zeros(3)}, keep=2)
    assert ckpt.steps(tmp_path) == [4, 5]


def test_torn_checkpoint_ignored(tmp_path):
    t = {"x": torch.ones(3)}
    ckpt.save(tmp_path, 1, t)
    torn = tmp_path / "step_00000002"  # a torn write: no commit marker
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert ckpt.latest_step(tmp_path) == 1
    _, step = ckpt.restore(tmp_path, None, t)
    assert step == 1
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, 2, t)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ckpt.save(tmp_path, 0, {"x": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, 0, {"x": torch.zeros((3, 3))})
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, 0, {"x": torch.zeros((2, 2)), "y": torch.zeros(1)})


def test_async_save_copies_before_the_thread(tmp_path):
    """The async save snapshots the leaves: updating them in place after
    ``save`` returns does not reach the files."""
    x = torch.arange(6.0)
    path = ckpt.save(tmp_path, 3, {"x": x}, async_=True)
    x.add_(100.0)
    for _ in range(200):
        if ckpt.latest_step(tmp_path) == 3:
            break
        time.sleep(0.01)
    assert path.exists()
    restored, _ = ckpt.restore(tmp_path, 3, {"x": x})
    torch.testing.assert_close(restored["x"], torch.arange(6.0))


def test_checkpoint_format_shared_with_reference(tmp_path):
    """The same tree's checkpoint, written by either package, restores in
    the other with the same leaves (same file names, order and manifest)."""
    t_np = {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3), "s": [np.ones(4, np.float32)]}
    jckpt.save(tmp_path / "jax", 4, jax.tree.map(jnp.asarray, t_np))
    got, step = ckpt.restore(tmp_path / "jax", None, _torch(t_np))
    assert step == 4
    _assert_trees_close(got, t_np, rtol=0, atol=0)
    ckpt.save(tmp_path / "torch", 5, _torch(t_np))
    want, _ = jckpt.restore(tmp_path / "torch", None, t_np)
    _assert_trees_close(_torch(t_np), want, rtol=0, atol=0)


# --------------------------------------------------------------- train loop


def _toy_problem():
    w_true = torch.tensor([2.0, -1.0, 0.5])
    opt = topt.adamw(5e-2)

    def init_state():
        params = {"w": torch.zeros(3)}
        return params, opt.init(params)

    def step_fn(params, opt_state, batch):
        loss, grads = tree.value_and_grad(
            lambda p: torch.mean((batch["x"] @ p["w"] - batch["y"]) ** 2), params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    def batch_fn(step):
        x = torch.randn((32, 3), generator=torch.Generator().manual_seed(step))
        return {"x": x, "y": x @ w_true}

    return init_state, step_fn, batch_fn


def test_train_loop_loss_decreases(tmp_path):
    init_state, step_fn, batch_fn = _toy_problem()
    out = train(LoopConfig(total_steps=60, checkpoint_every=20, checkpoint_dir=str(tmp_path)),
                init_state=init_state, step_fn=step_fn, batch_fn=batch_fn)
    assert out["final_loss"] < 0.1 * out["first_loss"]
    assert ckpt.steps(tmp_path) == [20, 40, 59]


def test_crash_recovery_resumes(tmp_path):
    """Kill mid-run; restart resumes from the checkpoint, not step 0, and
    ends where an uninterrupted run ends."""
    init_state, step_fn, batch_fn = _toy_problem()
    cfg = LoopConfig(total_steps=60, checkpoint_every=10, checkpoint_dir=str(tmp_path / "a"),
                     fail_at_step=35)
    with pytest.raises(SimulatedFailure):
        train(cfg, init_state=init_state, step_fn=step_fn, batch_fn=batch_fn)
    assert ckpt.latest_step(tmp_path / "a") == 30
    cfg.fail_at_step = None
    out = train(cfg, init_state=init_state, step_fn=step_fn, batch_fn=batch_fn)
    assert out["start_step"] == 31  # resumed, not restarted
    assert out["final_loss"] < 0.5
    whole = train(LoopConfig(total_steps=60, checkpoint_every=10,
                             checkpoint_dir=str(tmp_path / "b")),
                  init_state=init_state, step_fn=step_fn, batch_fn=batch_fn)
    torch.testing.assert_close(out["params"]["w"], whole["params"]["w"], rtol=0, atol=0)


# --------------------------------------------------------- DLRM train step


def _dlrm_cfgs(batch=32):
    jcfg = jdlrm.DLRMConfig(arch="t", workload=jmake_workload(
        "t", ROWS, dim=16, seqs=SEQS, batch=batch), bottom_mlp=(64, 32), top_mlp=(64,))
    tcfg = dlrm.DLRMConfig(arch="t", workload=make_workload(
        "t", ROWS, dim=16, seqs=SEQS, batch=batch), bottom_mlp=(64, 32), top_mlp=(64,))
    return jcfg, tcfg


def test_ctr_batch_matches_reference():
    jcfg, tcfg = _dlrm_cfgs()
    got = ctr_batch(np.random.default_rng(3), tcfg.workload, batch=32)
    want = jctr_batch(np.random.default_rng(3), jcfg.workload, batch=32)
    assert sorted(got) == sorted(want) == ["dense", "indices", "labels"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("opt_name", ["adagrad", "adamw"])
def test_dlrm_train_steps_match_reference(opt_name):
    """Three train steps from the JAX package's parameters on the same
    batches: every loss and, after the steps, every parameter (tables and
    MLPs) and optimizer-state leaf."""
    jcfg, tcfg = _dlrm_cfgs()
    jparams = jdlrm.init_dlrm(jcfg, jax.random.PRNGKey(0))
    params = dlrm.train_params(dlrm.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams)))
    _assert_trees_close(params, jparams, rtol=0, atol=0)  # the same tree, leaf for leaf
    make = {"adagrad": (lambda: topt.adagrad(0.05), lambda: jopt.adagrad(0.05)),
            "adamw": (lambda: topt.adamw(1e-3), lambda: jopt.adamw(1e-3))}[opt_name]
    opt, jo = make[0](), make[1]()
    step, jstep = dlrm.make_dlrm_train_step(tcfg, opt), jax.jit(jdlrm.make_dlrm_train_step(jcfg, jo))
    state, jstate = opt.init(params), jo.init(jparams)
    for k in range(3):
        b = ctr_batch(np.random.default_rng(k), tcfg.workload, batch=32)
        params, state, m = step(params, state, {k_: torch.tensor(v) for k_, v in b.items()})
        jparams, jstate, jm = jstep(jparams, jstate, {k_: jnp.asarray(v) for k_, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_trees_close(params, jparams, **STEP_TOL)
    _assert_trees_close(state, jstate, **STEP_TOL)


def test_dlrm_train_params_keep_serving_forward():
    """train_params is the serving parameters' tree: forward_train on it
    computes forward_dense's logits, and the serving parameters are left
    as they are by a train step."""
    _, tcfg = _dlrm_cfgs()
    serving = dlrm.init_dlrm(tcfg, torch.Generator().manual_seed(0))
    before = [t.clone() for t in serving["tables"]]
    params = dlrm.train_params(serving)
    b = ctr_batch(np.random.default_rng(1), tcfg.workload, batch=32)
    batch = {"dense": torch.tensor(b["dense"]), "indices": torch.tensor(b["indices"]),
             "labels": torch.tensor(b["labels"])}
    torch.testing.assert_close(dlrm.forward_train(tcfg, params, batch),
                               dlrm.forward_dense(tcfg, serving, batch), rtol=1e-5, atol=1e-5)
    opt = topt.adagrad(0.05)
    dlrm.make_dlrm_train_step(tcfg, opt)(params, opt.init(params), batch)
    for t, t0 in zip(serving["tables"], before):
        torch.testing.assert_close(t, t0, rtol=0, atol=0)


def test_bce_loss_matches_reference():
    z = np.random.default_rng(4).standard_normal(64).astype(np.float32) * 30
    y = (np.arange(64) % 3 == 0).astype(np.float32)
    np.testing.assert_allclose(float(dlrm.bce_loss(torch.tensor(z), torch.tensor(y))),
                               float(jdlrm.bce_loss(jnp.asarray(z), jnp.asarray(y))), rtol=1e-6)
