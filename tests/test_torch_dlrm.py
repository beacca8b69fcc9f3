"""DLRM parity: the port's forward passes against the JAX package's on the
JAX package's parameters (carried across by ``params_from_jax``).

Tolerance: rtol = atol = 1e-4 on the logits.  Both sides run the same f32
math, but the MLP products (512- and 256-wide reductions) and the pairwise
dots sum in another order in XLA and in torch, which moves the last bits of
each layer; 1e-5 holds for the pooled embeddings that feed them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.core.tables import make_workload as jmake_workload
from repro.engine import EngineConfig as JEngineConfig, InferenceEngine as JEngine
from repro.models import dlrm as jdlrm
from repro_torch.core.tables import make_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.models import dlrm

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ROWS, SEQS = [100, 50, 1000, 20, 333], [1, 2, 1, 3, 1]


def _cfgs(batch=32, **mlp):
    jcfg = jdlrm.DLRMConfig(arch="t", workload=jmake_workload(
        "t", ROWS, dim=16, seqs=SEQS, batch=batch), **mlp)
    tcfg = dlrm.DLRMConfig(arch="t", workload=make_workload(
        "t", ROWS, dim=16, seqs=SEQS, batch=batch), **mlp)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jparams = jdlrm.init_dlrm(jcfg, jax.random.PRNGKey(seed))
    params_np = jax.tree.map(np.asarray, jparams)
    return jparams, params_np, dlrm.params_from_jax(tcfg, params_np)


def _batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    b = cfg.workload.batch
    idx = np.full((len(ROWS), b, max(SEQS)), -1, np.int32)
    for i, (r, s) in enumerate(zip(ROWS, SEQS)):
        idx[i, :, :s] = rng.integers(0, r, size=(b, s))
    dense = rng.standard_normal((b, 13)).astype(np.float32)
    return dense, idx


def test_params_from_jax_transposes_non_square_layers():
    jcfg, tcfg = _cfgs()
    _, params_np, params = _params(jcfg, tcfg)
    for side in ("bottom", "top"):
        for lin, layer in zip(params[side].layers, params_np[side]):
            w = layer["w"]  # (in, out), never square in these stacks
            assert w.shape[0] != w.shape[1]
            assert tuple(lin.weight.shape) == (w.shape[1], w.shape[0])
            np.testing.assert_array_equal(lin.weight.detach().numpy(), w.T)
            x = np.random.default_rng(1).standard_normal((3, w.shape[0])).astype(np.float32)
            np.testing.assert_allclose(
                lin(torch.from_numpy(x)).detach().numpy(), x @ w + layer["b"], rtol=1e-5, atol=1e-5)
    for got, want in zip(params["tables"], params_np["tables"]):
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match=r"\(in, out\)"):
        dlrm.MLP([13, 7]).load_xw([{"w": np.zeros((7, 13)), "b": np.zeros(7)}])


def test_forward_dense_matches_reference():
    jcfg, tcfg = _cfgs()
    jparams, _, params = _params(jcfg, tcfg)
    dense, idx = _batch(tcfg)
    want = jdlrm.forward_dense(jcfg, jparams, {"dense": jnp.asarray(dense), "indices": jnp.asarray(idx)})
    got = dlrm.forward_dense(tcfg, params, {"dense": torch.from_numpy(dense), "indices": idx})
    assert got.shape == (tcfg.workload.batch,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_interact_matches_reference():
    rng = np.random.default_rng(2)
    bot = rng.standard_normal((3, 8)).astype(np.float32)
    emb = rng.standard_normal((4, 3, 8)).astype(np.float32)
    want = jdlrm.interact(jnp.asarray(bot), jnp.asarray(emb))
    got = dlrm.interact(torch.from_numpy(bot), torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 4)])
def test_forward_packed_matches_reference(mesh_shape):
    """The port's partitioned forward (fused kernels' plain versions, K
    cores on the CPU) against the JAX package's forward_packed on a
    one-device mesh and its forward_dense."""
    jcfg, tcfg = _cfgs()
    jparams, params_np, params = _params(jcfg, tcfg)
    dense, idx = _batch(tcfg)
    config = dict(mesh_shape=mesh_shape, distribution="uniform")
    engine = InferenceEngine.build(params["tables"], tcfg.workload, EngineConfig(**config), device="cpu")
    got = dlrm.forward_packed(tcfg, engine.bag, engine.packed, params,
                              {"dense": torch.from_numpy(dense), "indices": idx})
    batch = {"dense": jnp.asarray(dense), "indices": jnp.asarray(idx)}
    want = np.asarray(jdlrm.forward_dense(jcfg, jparams, batch))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    if mesh_shape == (1, 1):
        jeng = JEngine.build(jparams["tables"], jcfg.workload, JEngineConfig(**config))
        jgot = jdlrm.forward_packed(
            jcfg, jeng.bag, jeng.packed, jparams, batch,
            mesh=compat.make_mesh((1, 1), ("data", "model")), use_kernels="fused",
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **LOGIT_TOL)


def test_init_dlrm_shapes_and_count():
    _, tcfg = _cfgs(bottom_mlp=(32, 16), top_mlp=(32,))
    params = dlrm.init_dlrm(tcfg, torch.Generator().manual_seed(0))
    n = sum(t.numel() for t in params["tables"])
    n += sum(p.numel() for side in ("bottom", "top") for p in params[side].parameters())
    assert n == tcfg.param_count()
    w = params["bottom"].layers[0].weight.detach()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(13) + 1e-6  # truncated at 2 std
    dense, idx = _batch(tcfg)
    logits = dlrm.forward_dense(tcfg, params, {"dense": torch.from_numpy(dense), "indices": idx})
    assert torch.isfinite(logits).all()
