"""Mixtral's rolling cache and chatglm3's partial RoPE with 2 KV heads on
8 gloo ranks on the debug mesh ``(data 2, model 4)``, against the JAX
package's sharded train, prefill and decode steps on 8 forced host devices
(``b.train_step``, ``b.prefill_step`` and ``b.serve_step`` under
``jax.jit``, the parameters placed by ``param_pspecs``; one subprocess,
started before the spawn and run beside it).  The configs, inputs and
shapes are ``test_torch_sharded_swa_glm``'s: a train batch of 8 x 64, a
prefill of 8 x 38 into 44 cache slots (mixtral's rolling 32), 4 decode
steps through mixtral's rolling slots 6-9.  The JAX package's parameters
are carried across by ``params_from_jax``.  Held: the loss within 1e-5
relative, the gradients within 1e-5, the prefill's and every decode step's
logits within ``1e-5 * max(|ref|, 1)``.  The ranks import no JAX.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.tree import leaves
from test_torch_multicard import SRC
from test_torch_sharded_lm import DECODE, TOL, _close, _full, _jax_layout, _run
from test_torch_sharded_swa_glm import ARCHS, CAP, SHAPES, _cfg, _data, _spawned


def _ranks_8(rank, tmp):
    """Train, prefill and decode of both configs on the debug mesh, on the
    JAX package's parameters: rank 0 saves the loss, the gradients and the
    logits."""
    from repro_torch.launch.dryrun import make_ctx
    from repro_torch.launch.mesh import init_card_mesh

    mesh = init_card_mesh(data=2, device_type="cpu")
    for name, arch in ARCHS.items():
        cfg = _cfg(arch)
        _, train, prefill, steps = _data(arch)
        tree = dict(np.load(f"{tmp}/../{name}.npz", allow_pickle=True))["tree"].item()
        params = T.params_from_jax(cfg, tree)
        ctx = make_ctx(mesh, SHAPES[0], False)
        out, _ = _run(cfg, params, train, prefill, steps, ctx, mesh, SHAPES)
        full = _full({k: out[k] for k in ("loss", "grads", "prefill", "decode")})
        if rank == 0:
            torch.save(full, f"{tmp}/{name}_0.pt")


# --------------------------------------------------------------------------
# the JAX package's sharded steps, on 8 forced host devices
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

    tmp, cap, archs = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
    mesh = make_debug_mesh()
    for name_arch in archs:
        name, arch = name_arch.split("=")
        cfg = registry.build(arch, smoke=True).cfg
        cfg = dataclasses.replace(cfg, seq_parallel=registry.build(arch).cfg.seq_parallel)
        b = registry.Bundle(cfg)
        d = np.load(f"{tmp}/{name}.npz", allow_pickle=True)
        params = jax.tree.map(jnp.asarray, d["tree"].item())
        train = {"tokens": jnp.asarray(d["tokens"]), "labels": jnp.asarray(d["labels"])}
        shape = ShapeCfg("t", "train", train["tokens"].shape[1], train["tokens"].shape[0])
        ctx = make_ctx(mesh, shape, False)
        named = jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s),
                             sh.param_pspecs(params, False),
                             is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        params_s = jax.device_put(params, named)
        opt = sgd(1.0)  # new = p - g: the gradient, at the parameters' rounding
        new, _, m = jax.jit(b.train_step(ctx, opt, shape))(params_s, opt.init(params_s), train)
        grads = jax.tree.map(lambda p, q: np.asarray(p) - np.asarray(q), params, new)
        flat, _ = jax.tree_util.tree_flatten_with_path(grads)
        out = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v
               for path, v in flat}
        prompt = jnp.asarray(d["prompt"])
        pshape = ShapeCfg("p", "prefill", cap, prompt.shape[0])
        logits, cache = jax.jit(b.prefill_step(ctx, pshape))(params_s, {"tokens": prompt})
        serve = jax.jit(b.serve_step(ctx))
        dec = []
        for tok in d["steps"]:
            lg, cache = serve(params_s, cache, {"tokens": jnp.asarray(tok)})
            dec.append(np.asarray(lg))
        np.savez(f"{tmp}/{name}_ref.npz", loss=np.asarray(m["loss"]),
                 prefill_logits=np.asarray(logits), decode_logits=np.stack(dec), **out)
    print("OK")
""")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The module's directory, holding each config's parameters in the JAX
    package's layout, its train batch, prompt and decode tokens
    (``<name>.npz``)."""
    tmp = tmp_path_factory.mktemp("sharded_swa_glm_reference")
    for name, arch in ARCHS.items():
        params, train, prefill, steps = _data(arch)
        np.savez(tmp / f"{name}.npz", tree=np.array(_jax_layout(params), dtype=object),
                 prompt=prefill["tokens"].numpy(),
                 steps=np.stack([s["tokens"].numpy() for s in steps]),
                 **{k: v.numpy() for k, v in train.items()})
    return tmp


@pytest.fixture(scope="module")
def reference(workdir):
    """The JAX package's sharded steps in their subprocess, started before
    the spawn and run beside it; the fixture's value waits for it."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(workdir), str(CAP),
         *(f"{name}={arch}" for name, arch in ARCHS.items())],
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def wait():
        if proc.returncode is None:
            so, se = proc.communicate(timeout=100)
            assert proc.returncode == 0 and so.startswith("OK"), so[-3000:] + se[-3000:]
        return {name: dict(np.load(workdir / f"{name}_ref.npz")) for name in ARCHS}

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks8(workdir, reference):
    # 8 ranks share the test's cores: a longer bound, still inside pytest's 120 s
    return _spawned(workdir, "w8", 8, _ranks_8, 100.0, [""])[""]


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ARCHS))
def test_debug_mesh_loss_matches_reference(name, ranks8, reference):
    got = float(ranks8[name][0]["loss"])
    want = float(reference()[name]["loss"])
    assert abs(got - want) <= TOL * abs(want), (got, want)


@pytest.mark.parametrize("name", list(ARCHS))
def test_debug_mesh_grads_match_reference(name, ranks8, reference):
    ref = reference()[name]
    grads = ranks8[name][0]["grads"]
    names = [k for k in ref if k not in ("loss", "prefill_logits", "decode_logits")]
    n_layers = len(grads["layers"])
    assert sum(n_layers if k.startswith("layers/") else 1 for k in names) == len(leaves(grads))
    for key in names:
        parts = key.split("/")
        if parts[0] == "layers":
            got = torch.stack([sh._at(grads, ("layers", str(i), *parts[1:]))
                               for i in range(n_layers)])
        else:
            got = sh._at(grads, tuple(parts))
        np.testing.assert_allclose(got.numpy(), ref[key], rtol=TOL, atol=TOL, err_msg=key)


@pytest.mark.parametrize("name", list(ARCHS))
def test_debug_mesh_prefill_and_decode_match_reference(name, ranks8, reference):
    ref = reference()[name]
    got = ranks8[name][0]
    _close(got["prefill"], torch.from_numpy(ref["prefill_logits"]), "prefill logits")
    assert len(got["decode"]) == len(ref["decode_logits"]) == DECODE
    for t, (g, w) in enumerate(zip(got["decode"], ref["decode_logits"])):
        _close(g, torch.from_numpy(w), f"decode step {t}")
