"""The partitioned lookup across ranks: each plan core in its own process,
the rejoin over ``torch.distributed`` (gloo here; NCCL between cards).

Four gloo ranks, spawned with ``torch.multiprocessing`` (each spawn joined
under its own timeout, its process group started from a file under the
test's own directory), serve the smoke workload with one plan core each:

- against the one-process port on the same config, tables and indices:
  ``sparse`` and ``ring`` bitwise (the CPU sums in a fixed order; ring on
  rank 0, whose order is the one-card ring's), ``psum`` within rtol = atol
  = 1e-5 (gloo's ``all_reduce`` sums in its own order), as is every other
  rank's ring output;
- against the JAX package's ``shard_map`` on 4 forced host devices, in
  one subprocess started with the first test and read by the last ones
  (``use_kernels="xla"`` there: its fused mode cannot trace L1 on the CPU),
  within 1e-5: ``asymmetric`` with each rejoin, on tables that each lie on
  one core and on tables split over all four (so the rejoin adds partials
  that ranks send each other), ``symmetric``, ``layout=dense`` and the
  hierarchical ``[2,2]`` plan with ``access=dedup``.

Also held: each rank keeps only its core's slice of the buffer; a plan
whose core count is not the ``"model"`` size raises, a ``simulate=True``
build refuses to execute; the block-size sweep picks the same sizes on
every rank; a ``data=2, model=2`` mesh splits the batch; the serve CLI
under 4 ranks gives the one-process CLI's logits; one rank's failure ends
every rank with a non-zero exit.  This file imports no JAX (the reference
runs in its subprocess), so a rank imports only PyTorch.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core.mesh import MeshShapeError
from repro_torch.core.partition import partitioned_lookup
from repro_torch.data.distributions import Uniform
from repro_torch.data.workloads import small_workload
from repro_torch.engine import EngineConfig, InferenceEngine
from repro_torch.models.registry import SCENARIOS

SRC = str(Path(__file__).resolve().parent.parent / "src")
WORLD = 4
BATCH = 64
TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_S = 75.0  # each spawn, within pytest.ini's 120 s
SMOKE = dict(distribution="uniform", planner_options={"shard_rocks": False})
# every table's rows split over the four cores: each owner sums partials
# that the other ranks send it
SPLIT = dict(distribution="uniform", planner_options={"shard_rocks": True, "rock_theta": 0.5})
CASES = {
    "sparse": dict(SMOKE, reduce_mode="sparse"),
    "psum": dict(SMOKE, reduce_mode="psum"),
    "ring": dict(SMOKE, reduce_mode="ring"),
    "split_sparse": dict(SPLIT, reduce_mode="sparse"),
    "split_psum": dict(SPLIT, reduce_mode="psum"),
    "split_ring": dict(SPLIT, reduce_mode="ring"),
    "symmetric": dict(distribution="uniform", planner="symmetric"),
    "dense": dict(SMOKE, layout="dense"),
    "hier_dedup": dict(distribution="zipf:1.2", planner="hierarchical", mesh_shape=[2, 2],
                       access="dedup"),
}
SCENARIO = SCENARIOS["transformer"].default_config
BITWISE = ("sparse", "ring", "split_sparse", "split_ring", "symmetric", "dense", "hier_dedup")
CLI = ["--device", "cpu", "--workload", "smoke", "--batch", str(BATCH), "--queries", "256",
       "--distribution", "uniform", "--set", 'planner_options={"shard_rocks": false}']


def _inputs():
    """The smoke workload's tables and one batch of (N, B, s_max) ids."""
    wl = small_workload(batch=BATCH)
    rng = np.random.default_rng(7)
    tables = [(rng.standard_normal((t.rows, t.dim)) / 4).astype(np.float32) for t in wl.tables]
    s_max = max(t.seq for t in wl.tables)
    idx = np.full((len(wl.tables), BATCH, s_max), -1, np.int32)
    for i, t in enumerate(wl.tables):
        idx[i, :, : t.seq] = rng.integers(0, t.rows, (BATCH, t.seq))
    return wl, tables, idx


def _one_process(cfg: dict) -> InferenceEngine:
    wl, tables, _ = _inputs()
    cfg = dict(cfg)
    cfg.setdefault("mesh_shape", [1, WORLD])
    return InferenceEngine.build(tables, wl, EngineConfig(**cfg), device="cpu")


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------


def _entry(rank, fn, world, tmp, device, group_timeout_s):
    """One rank: its process group started from a file in ``tmp`` (gloo on
    the CPU with one thread, as 4 ranks share the test's cores; NCCL on
    card ``rank``), then ``fn(rank, tmp)``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_card_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    init_card_mesh(device_type=device, init_method=f"file://{tmp}/group", rank=rank,
                   world_size=world, timeout_s=group_timeout_s)
    fn(rank, tmp)
    dist.destroy_process_group()


def spawn(fn, tmp, *, world=WORLD, device="cpu", timeout_s=SPAWN_S, group_timeout_s=30.0):
    """Run ``fn(rank, tmp)`` on ``world`` ranks (gloo, or NCCL with
    ``device="cuda"``); returns each rank's exit code and, for a failed
    rank, its traceback.  A rank still running after ``timeout_s`` is killed
    and fails the test."""
    ctx = mp.start_processes(_entry, args=(fn, world, str(tmp), device, group_timeout_s),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    for p in ctx.processes:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {timeout_s}s"
    errors = {}
    for r, p in enumerate(ctx.processes):
        path = ctx.error_files[r]
        if p.exitcode and os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                errors[r] = pickle.load(f)
    return [p.exitcode for p in ctx.processes], errors


def _mesh_cases(rank, tmp):
    from repro_torch.core.partition import COLLECTIVE_BYTES
    from repro_torch.launch.mesh import init_card_mesh
    from repro_torch.models.dlrm import DLRMConfig, forward_packed, init_dlrm

    mesh = init_card_mesh(device_type="cpu")
    wl, tables, idx = _inputs()
    out = {}
    for name, cfg in CASES.items():
        eng = InferenceEngine.build(tables, wl, EngineConfig(**cfg), device="cpu", mesh=mesh)
        COLLECTIVE_BYTES.clear()
        if rank == 0:
            served = eng.lookup(idx)
            eng.close()
        else:
            served = eng.follow()
        sent = dict(COLLECTIVE_BYTES)
        # the library entry point, called by every rank
        own = eng.bag.apply(eng.packed, torch.from_numpy(idx), mesh=mesh,
                            reduce_mode=eng.config.reduce_mode)
        # its stages, every rank together, as chip_smoke.py's MC times them
        stages = eng.lookup_stages(idx)
        staged = stages["rejoin"]() + (stages["sym"]() if "sym" in stages else 0)
        out[name] = {"served": served, "own": own, "chunk": eng.packed.chunk_data.clone(),
                     "ranks": eng.ranks, "n_cores": eng.packed.n_cores, "sent": sent,
                     "staged": staged, "whole": stages["whole"](), "stage_names": sorted(stages)}
    # the sweep: each rank times its own core, every rank picks the slowest's best
    eng = InferenceEngine.build(tables, wl, EngineConfig(**SMOKE, tuning="sweep"),
                                device="cpu", mesh=mesh)
    tuning = eng.plan.meta["tuning"]
    out["sweep"] = {"block_r": eng.packed.block_r, "block_b": eng.packed.block_b,
                    "wall_us": [c["wall_us"] for c in tuning["candidates"]],
                    "rank_wall_us": [c["rank_wall_us"] for c in tuning["candidates"]]}
    # a plan of 8 cores on 4 ranks: refused, or with simulate=True built and
    # refused at execution on every rank
    try:
        InferenceEngine.build(tables, wl, EngineConfig(**SMOKE, mesh_shape=[1, 8]),
                              device="cpu", mesh=mesh)
        out["k_differs"] = None
    except MeshShapeError as e:
        out["k_differs"] = str(e)
    sim = InferenceEngine.build(tables, wl, EngineConfig(**SMOKE, mesh_shape=[1, 8],
                                                         simulate=True), device="cpu", mesh=mesh)
    try:
        sim.lookup(idx) if rank == 0 else sim.follow()
        out["simulate"] = None
    except MeshShapeError as e:
        out["simulate"] = str(e)
    # a scenario tower on rank 0 over the lookup across the ranks
    eng = InferenceEngine.build_scenario("transformer", EngineConfig(**SCENARIO), device="cpu",
                                         mesh=mesh, batch=BATCH)
    if rank == 0:
        sc = eng.scenario
        batch = sc.sample_batch(np.random.default_rng(5), Uniform(), BATCH)
        out["scenario"] = sc.make_step(eng)(sc.payloads(batch))
        eng.close()
    else:
        eng.follow()
    # a data=2 x model=2 mesh: two plan cores, the batch split over "data"
    mesh2 = init_card_mesh(data=2, device_type="cpu")
    eng = InferenceEngine.build(tables, wl, EngineConfig(**SMOKE), device="cpu", mesh=mesh2)
    cfg = DLRMConfig(arch="dlrm-smoke", workload=wl)
    params = init_dlrm(cfg, torch.Generator().manual_seed(0))
    dense = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (BATCH, cfg.n_dense)).astype(np.float32))
    batch = {"dense": dense, "indices": torch.from_numpy(idx)}
    out["data2"] = {
        "pooled": eng.bag.apply(eng.packed, batch["indices"], mesh=mesh2, batch_axes=("data",)),
        "logits": forward_packed(cfg, eng.bag, eng.packed, params, batch, mesh=mesh2,
                                 batch_axes=("data",)),
    }
    torch.save(out, f"{tmp}/cases_{rank}.pt")


def _serve_cli(rank, tmp):
    from repro_torch.launch import serve

    res = serve.main(CLI)
    if rank == 0:
        s = res["stats"]["uniform"]
        res = {"logits": res["served_logits"], "submitted": s["submitted"],
               "served": s["served"], "collective_bytes": res["collective_bytes"],
               "report": res["engine"].plan_report()}
    else:
        res = {"followed": res["followed"]}
    torch.save(res, f"{tmp}/cli_{rank}.pt")


def _serve_cli_bad_rank(rank, tmp):
    """Rank 2 asks for another plan than the others: its build raises."""
    from repro_torch.launch import serve

    serve.main(CLI + (["--set", "mesh_shape=[1,8]"] if rank == 2 else []))


# --------------------------------------------------------------------------
# the reference's shard_map, on 4 forced host devices in one subprocess
# --------------------------------------------------------------------------

_REFERENCE = """
import json, sys
import numpy as np, jax.numpy as jnp
from repro.engine import EngineConfig, InferenceEngine
from repro.data.workloads import small_workload

data = np.load(sys.argv[1])
cases = json.loads(sys.argv[2])
tables = [jnp.asarray(data[f"t{i}"]) for i in range(int(data["n"]))]
idx = jnp.asarray(data["idx"])
wl = small_workload(batch=idx.shape[1])
out = {}
for name, cfg in cases.items():
    cfg = dict(cfg)
    xla = cfg.get("access", "none") == "none"
    if xla:
        cfg["use_kernels"] = "xla"
    if "mesh_shape" in cfg:
        cfg["mesh_shape"] = tuple(cfg["mesh_shape"])
    eng = InferenceEngine.build(tables, wl, EngineConfig(**cfg))
    # access reduction needs the fused config; its lookup runs the XLA path
    got = eng.lookup(idx) if xla else eng.bag.apply(
        eng.packed, idx, mesh=eng.mesh, use_kernels=False, reduce_mode=eng.config.reduce_mode)
    out[name] = np.asarray(got)
np.savez(sys.argv[3], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Starts the reference at once, the cases split over three subprocesses;
    the returned function waits for their outputs."""
    tmp = tmp_path_factory.mktemp("reference")
    _, tables, idx = _inputs()
    np.savez(tmp / "inputs.npz", idx=idx, n=len(tables),
             **{f"t{i}": t for i, t in enumerate(tables)})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    names = list(CASES)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(tmp / "inputs.npz"),
             json.dumps({n: CASES[n] for n in part}), str(tmp / f"out{i}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i, part in enumerate((names[:3], names[3:6], names[6:]))
    ]
    result = {}

    def wait():
        for i, proc in enumerate(procs):
            if proc.returncode is None:
                out, err = proc.communicate(timeout=100)
                assert proc.returncode == 0 and out.startswith("OK"), out[-3000:] + err[-3000:]
                result.update(np.load(tmp / f"out{i}.npz"))
        return result

    yield wait
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def cases(tmp_path_factory, reference):
    tmp = tmp_path_factory.mktemp("cases")
    codes, errors = spawn(_mesh_cases, tmp)
    assert codes == [0] * WORLD, errors
    return [torch.load(tmp / f"cases_{r}.pt", weights_only=False) for r in range(WORLD)]


# --------------------------------------------------------------------------
# against the one-process port
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_one_process(cases, name):
    _, _, idx = _inputs()
    want = _one_process(CASES[name]).lookup(idx)
    served = cases[0][name]["served"]
    if name in BITWISE:
        assert torch.equal(served, want), float((served - want).abs().max())
    else:
        torch.testing.assert_close(served, want, **TOL)
    for r in range(WORLD):
        own = cases[r][name]["own"]
        if CASES[name].get("reduce_mode") == "ring" and r:
            # rank r sums in its own ring order: r, r-1, ...
            torch.testing.assert_close(own, want, **TOL)
        elif name in BITWISE:
            assert torch.equal(own, want), (r, float((own - want).abs().max()))
        else:
            torch.testing.assert_close(own, want, **TOL)
    assert cases[0][name]["ranks"]["world"] == WORLD


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_only_its_core(cases, name):
    whole = _one_process(CASES[name]).packed
    for r in range(WORLD):
        rec = cases[r][name]
        assert rec["n_cores"] == 1
        assert torch.equal(rec["chunk"][0], whole.chunk_data[r])
        assert rec["ranks"]["chunk_bytes"] == [whole.chunk_bytes // WORLD] * WORLD
        assert rec["ranks"]["whole_chunk_bytes"] == whole.chunk_bytes


@pytest.mark.parametrize("name", list(CASES))
def test_lookup_stages_make_up_the_lookup(cases, name):
    """``engine.lookup_stages``: the rejoin of this rank's core partial plus
    the symmetric group (where the plan has one) is the lookup, on every
    rank."""
    names = ["lookup", "rejoin", "whole"]
    if _one_process(CASES[name]).packed.sym_data.shape[0]:
        names = sorted(names + ["sym"])
    for r in range(WORLD):
        rec = cases[r][name]
        assert rec["stage_names"] == names
        assert torch.equal(rec["whole"], rec["own"]), r
        assert torch.equal(rec["staged"], rec["own"]), r


@pytest.mark.parametrize("name", ["split_sparse", "split_psum", "split_ring"])
def test_split_tables_send_partials_between_ranks(cases, name):
    """Each table's rows lie on all four cores, so the rejoin adds partials
    that other ranks computed: the sparse rejoin's owners each receive
    rows from three senders, and the one-process port and the reference
    agree with what the ranks sum (the tests above)."""
    from repro_torch.core.traffic import modeled_rejoin_traffic

    packed = _one_process(CASES[name]).packed
    cores_of = {}
    for t, c in zip(packed.slot_table.reshape(-1).tolist(),
                    np.repeat(np.arange(WORLD), packed.slot_table.shape[1]).tolist()):
        if t >= 0:
            cores_of.setdefault(t, set()).add(c)
    assert all(len(c) == WORLD for c in cores_of.values()) and len(cores_of) == 6, cores_of
    mod = modeled_rejoin_traffic(packed, batch=BATCH, n_tables=6)
    assert mod["sparse_all_to_all_bytes"] > 0
    sent = cases[0][name]["sent"]
    if name == "split_sparse":
        assert sent["all_to_all"] >= mod["sparse_all_to_all_bytes"] > 0
        assert sent["all_gather"] == mod["sparse_all_gather_bytes"]
    else:
        assert sent[{"split_psum": "all_reduce", "split_ring": "send"}[name]] > 0


def test_k_other_than_model_size_raises(cases):
    for r in range(WORLD):
        msg = cases[r]["k_differs"]
        assert msg is not None and "plan spans 8 cores" in msg and "4 card(s)" in msg


def test_simulate_builds_and_refuses_to_execute(cases):
    for r in range(WORLD):
        msg = cases[r]["simulate"]
        assert msg is not None and msg.startswith("cannot execute"), msg


def test_sweep_picks_the_same_block_sizes_on_every_rank(cases):
    picks = {(c["sweep"]["block_r"], c["sweep"]["block_b"]) for c in cases}
    assert len(picks) == 1, picks
    # each candidate is ranked by the slowest rank's time, the same on all
    for c in cases:
        assert c["sweep"]["wall_us"] == cases[0]["sweep"]["wall_us"]
        assert all(w >= own for w, own in zip(c["sweep"]["wall_us"], c["sweep"]["rank_wall_us"]))
    slowest = [max(c["sweep"]["rank_wall_us"][i] for c in cases)
               for i in range(len(cases[0]["sweep"]["wall_us"]))]
    assert slowest == cases[0]["sweep"]["wall_us"]


def test_data_by_model_mesh_splits_the_batch(cases):
    """data=2, model=2: ranks (d, m) hold core m of a 2-core plan and serve
    batch share d; each share equals the one-process port's rows."""
    from repro_torch.models.dlrm import DLRMConfig, forward_packed, init_dlrm

    wl, _, idx = _inputs()
    eng = _one_process(dict(SMOKE, mesh_shape=[1, 2]))
    cfg = DLRMConfig(arch="dlrm-smoke", workload=wl)
    params = init_dlrm(cfg, torch.Generator().manual_seed(0))
    dense = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (BATCH, cfg.n_dense)).astype(np.float32))
    pooled = eng.lookup(idx)
    logits = forward_packed(cfg, eng.bag, eng.packed, params,
                            {"dense": dense, "indices": torch.from_numpy(idx)})
    half = BATCH // 2
    for r in range(WORLD):
        d = r // 2
        got = cases[r]["data2"]
        assert got["pooled"].shape == (len(wl.tables), half, 16)
        assert torch.equal(got["pooled"], pooled[:, d * half:(d + 1) * half])
        assert torch.equal(got["logits"], logits[d * half:(d + 1) * half])


def test_scenario_tower_over_four_ranks(cases):
    eng = InferenceEngine.build_scenario("transformer", EngineConfig(**SCENARIO, mesh_shape=[1, 4]),
                                         device="cpu", batch=BATCH)
    sc = eng.scenario
    batch = sc.sample_batch(np.random.default_rng(5), Uniform(), BATCH)
    want = sc.make_step(eng)(sc.payloads(batch))
    assert np.array_equal(cases[0]["scenario"], want)


def test_pack_of_one_core_refuses_to_run_without_a_mesh():
    _, _, idx = _inputs()
    eng = _one_process(CASES["sparse"])
    with pytest.raises(MeshShapeError, match="one core's slice"):
        partitioned_lookup(eng.packed.strip_core(1), torch.from_numpy(idx),
                           n_tables=eng.bag.n_tables)


def test_cuda_mesh_without_cards_raises():
    from repro_torch.launch.mesh import init_card_mesh

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        init_card_mesh(device_type="cuda", rank=0, world_size=1,
                       init_method="tcp://localhost:1")


# --------------------------------------------------------------------------
# against the reference's shard_map
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_reference_shard_map(cases, reference, name):
    want = reference()[name]
    np.testing.assert_allclose(cases[0][name]["served"].numpy(), want, **TOL)


# --------------------------------------------------------------------------
# the serve CLI under four ranks
# --------------------------------------------------------------------------


def test_serve_cli_under_four_ranks(tmp_path):
    from repro_torch.launch import serve

    codes, errors = spawn(_serve_cli, tmp_path)
    assert codes == [0] * WORLD, errors
    lead = torch.load(tmp_path / "cli_0.pt", weights_only=False)
    one = serve.main(CLI + ["--set", f"mesh_shape=[1,{WORLD}]"])
    assert lead["submitted"] == lead["served"] == 256
    assert np.array_equal(lead["logits"], one["served_logits"])
    for r in range(1, WORLD):
        assert torch.load(tmp_path / f"cli_{r}.pt", weights_only=False)["followed"] == 256 // BATCH
    # the report: each rank's chunk bytes, the rejoin's modeled bytes; the
    # all_gather of the owner buckets moves what the model says
    assert "cards: 4 ranks (gloo)" in lead["report"] and "rejoin modeled" in lead["report"]
    modeled = one["engine"].packed
    from repro_torch.core.traffic import modeled_rejoin_traffic

    mod = modeled_rejoin_traffic(modeled, batch=BATCH, n_tables=modeled.rejoin_owned_pos.shape[0])
    assert lead["collective_bytes"]["all_gather"] == mod["sparse_all_gather_bytes"]
    assert lead["collective_bytes"]["all_to_all"] >= mod["sparse_all_to_all_bytes"]


def test_one_failing_rank_fails_the_run(tmp_path):
    codes, errors = spawn(_serve_cli_bad_rank, tmp_path, group_timeout_s=20.0)
    assert all(codes), codes
    assert "MeshShapeError" in errors[2], errors
