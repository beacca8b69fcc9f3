"""The strategy kernels' gradient: the port's ``ops.embedding_bag`` under
autograd against ``jax.grad`` of the JAX package's, on the same seeded
tables, ids and cotangent weights (plain versions on CPU tensors).

Tolerance: rtol = atol = 1e-5.  Both backwards scatter-add the same f32
cotangents; only the order of the adds into a shared row differs.  The L1
strategy is held against ``jax.grad`` of ``kernels/ref.py``'s lookup in f32
(the JAX package's custom VJP scatters in f32 and casts): the JAX package's
L1 Pallas kernel does not trace under the installed jax.

Ids outside ``[0, m)`` are where the two packages differ on purpose: the
port's backward is the adjoint of its own forward (those ids read zero and
get no gradient), while the JAX package's ``.at[flat].add`` sends ``-1``'s
gradient to the last row and drops ids >= m (ROADMAP C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.strategies import Strategy as JStrategy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.strategies import ALL_STRATEGIES, Strategy
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(m=64, e=16, b=8, s=3, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((m, e)).astype(np.float32)
    idx = rng.integers(0, m, size=(b, s)).astype(np.int32)
    w = rng.standard_normal((b, e)).astype(np.float32)
    return table, idx, w


def _port_grad(table, idx, w, strategy, pooling="sum", dtype=torch.float32):
    t = torch.tensor(table).to(dtype).requires_grad_()
    out = ops.embedding_bag(t, torch.tensor(idx), strategy, pooling=pooling)
    (out.float() * torch.tensor(w)).sum().backward()
    return t.grad


def _jax_grad(table, idx, w, strategy, pooling="sum", dtype=jnp.float32):
    if strategy == "L1":  # the reference's L1 kernel fails to trace (see above);
        # its custom VJP scatters in f32 and casts, as this lookup in f32 does
        fn = lambda t: jref.embedding_bag_ref(  # noqa: E731
            t.astype(jnp.float32), jnp.asarray(idx), pooling=pooling).astype(t.dtype)
    else:
        fn = lambda t: jops.embedding_bag(  # noqa: E731
            t, jnp.asarray(idx), JStrategy(strategy), pooling=pooling, interpret=True)
    t = jnp.asarray(table).astype(dtype)
    return jax.grad(lambda t: jnp.sum(fn(t).astype(jnp.float32) * jnp.asarray(w)))(t)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("strategy", [s.value for s in ALL_STRATEGIES])
def test_embedding_bag_grad_matches_reference(strategy, pooling, dtype):
    tdt, jdt = DTYPES[dtype]
    table, idx, w = _inputs()
    got = _port_grad(table, idx, w, strategy, pooling, tdt)
    want = _jax_grad(table, idx, w, strategy, pooling, jdt)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL)


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_grad_equals_plain_autograd(strategy):
    """The kernel path's gradient equals autograd through the plain lookup
    (``ref.embedding_bag_ref``), repeated ids included."""
    table, idx, w = _inputs(m=5, b=16, s=4, seed=3)  # many repeats per row
    got = _port_grad(table, idx, w, strategy)
    t = torch.tensor(table).requires_grad_()
    (ref.embedding_bag_ref(t, torch.tensor(idx)) * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got.numpy(), t.grad.numpy(), **TOL)


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_grad_is_adjoint_of_forward_for_out_of_range_ids(strategy):
    """-1 and ids >= m read zero in the forward and get no gradient: the
    gradient equals a finite-difference-free adjoint, <grad, dT> == <w, d out>
    for a random table direction dT."""
    table, idx, w = _inputs(m=6, b=4, s=3, seed=4)
    idx[0, 1], idx[1, 0], idx[2, 2] = -1, 6, 1000
    got = _port_grad(table, idx, w, strategy)
    keep = (idx >= 0) & (idx < 6)
    want = np.zeros_like(table)
    for b, j in zip(*np.nonzero(keep)):
        want[idx[b, j]] += w[b]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    d = np.random.default_rng(9).standard_normal(table.shape).astype(np.float32)
    d_out = ops.embedding_bag(torch.tensor(d), torch.tensor(idx), strategy).numpy()
    np.testing.assert_allclose((got.numpy() * d).sum(), (w * d_out).sum(), rtol=1e-5)


def test_reference_scatter_differs_for_out_of_range_ids():
    """Pins the JAX package's backward on ids outside [0, m) (the documented
    difference): -1's cotangent lands on the last row, ids >= m are dropped,
    where the port gives neither row anything."""
    table = np.zeros((4, 2), np.float32)
    idx = np.array([[0, -1], [5, 1]], np.int32)
    w = np.ones((2, 2), np.float32)
    want = np.asarray(_jax_grad(table, idx, w, Strategy.GM_UB.value))
    np.testing.assert_array_equal(want, [[1, 1], [1, 1], [0, 0], [1, 1]])
    got = _port_grad(table, idx, w, Strategy.GM_UB).numpy()
    np.testing.assert_array_equal(got, [[1, 1], [1, 1], [0, 0], [0, 0]])


@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("lo,hi", [(0, 20), (20, 50), (50, 64)])
def test_chunk_bag_matches_reference(lo, hi, pooling):
    """chunk_bag's output and its gradient in the chunk, padding and ids
    outside the chunk included."""
    table, idx, w = _inputs(seed=6)
    idx[:, -1] = -1
    chunk = table[lo:hi]
    t = torch.tensor(chunk).requires_grad_()
    out = ops.chunk_bag(t, torch.tensor(idx), lo, pooling=pooling)
    (out * torch.tensor(w)).sum().backward()
    jfn = lambda c: jops.chunk_bag(c, jnp.asarray(idx), jnp.asarray(lo), pooling=pooling)  # noqa: E731
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jfn(jnp.asarray(chunk))), **TOL)
    jg = jax.grad(lambda c: jnp.sum(jfn(c) * jnp.asarray(w)))(jnp.asarray(chunk))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("lo,hi", [(0, 20), (20, 64)])
def test_chunk_gather_matches_reference(lo, hi):
    table, _, _ = _inputs(seed=7)
    ids = np.random.default_rng(8).integers(-1, 70, size=(5, 7)).astype(np.int32)
    chunk = table[lo:hi]
    t = torch.tensor(chunk).requires_grad_()
    out = ops.chunk_gather(t, torch.tensor(ids), lo)
    gw = np.random.default_rng(2).standard_normal(out.shape).astype(np.float32)
    (out * torch.tensor(gw)).sum().backward()
    want = jops.chunk_gather(jnp.asarray(chunk), jnp.asarray(ids), lo)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    jg = jax.grad(lambda c: jnp.sum(
        jops.chunk_gather(c, jnp.asarray(ids), lo) * jnp.asarray(gw)))(jnp.asarray(chunk))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **TOL)
