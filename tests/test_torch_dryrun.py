"""The port's dry-run (``repro_torch.launch.dryrun``): each cell's step run
on ``meta`` tensors with a ``ShardCtx`` on the mesh shape, counted by
``torch.utils.flop_counter.FlopCounterMode``, its bytes divided over the
mesh by the sharding rules; the port's versions of
``tests/test_multidevice.py::test_dryrun_cells_debug_mesh`` and
``tests/test_hlo_analysis.py::test_grad_flops_about_3x_forward``.

The SMOKE configs' train cells run at a 256-token train shape here, not at
``train_4k``: their 32-slot KV blocks and 64-query chunks make the port's
eager attention loop about 10^6 ``meta`` ops at 4,096 positions (minutes
on a CPU for olmo-1b's), where the JAX package lowers one scan.  The
published configs' 1,024-slot blocks keep their own cells small.
"""
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding as sh
from repro_torch.configs.base import ShapeCfg, flops_per_token
from repro_torch.data.workloads import get_workload
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import registry
from repro_torch.tree import leaves

TRAIN_SMOKE = ShapeCfg("train_smoke", "train", 256, 4)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-780m"])
@pytest.mark.parametrize("shape", [TRAIN_SMOKE, "decode_32k"])
def test_dryrun_cells_debug_mesh(arch, shape, tmp_path):
    """The dry-run end to end on the debug mesh (SMOKE configs)."""
    mesh = make_debug_mesh()
    rec = dryrun.run_cell(arch, shape, False, smoke=True, mesh=mesh, out_dir=tmp_path)
    assert rec["status"] == "ok", rec
    assert rec["flops"] > 0 and rec["flops_ratio"] > 0
    assert rec["mesh"] == "debug2x4" and rec["devices"] == 8
    name = shape if isinstance(shape, str) else shape.name
    on_disk = json.loads((tmp_path / f"{arch}__{name}__debug2x4.json").read_text())
    assert on_disk["flops"] == rec["flops"]
    kind = "train" if name == TRAIN_SMOKE.name else "decode"
    b = rec["bytes_per_device"]
    assert set(b) == ({"batch", "params", "opt_state"} if kind == "train"
                      else {"batch", "params", "cache"})
    assert all(v > 0 for v in b.values())
    # a second call reads the record back
    assert dryrun.run_cell(arch, shape, False, smoke=True, mesh=mesh, out_dir=tmp_path) == on_disk


def test_train_cell_counts_the_remat_forward(tmp_path):
    """A train step's count holds the forward, its recomputation under remat
    and the backward: above 6 N per token, well under twice that."""
    rec = dryrun.run_cell("olmo-1b", TRAIN_SMOKE, False, smoke=True, mesh=make_debug_mesh(),
                          out_dir=tmp_path)
    cfg = registry.build("olmo-1b", smoke=True).cfg
    assert rec["model_flops"] == flops_per_token(cfg, 256, "train") * 4 * 256
    assert 1.0 < rec["flops_ratio"] < 2.5


def test_published_decode_cell_bytes(tmp_path):
    """olmo-1b at its published size on the production mesh: the parameter
    bytes per device are each bf16 leaf over its shards, as the rules say."""
    rec = dryrun.run_cell("olmo-1b", "decode_32k", False, out_dir=tmp_path)
    assert rec["status"] == "ok" and rec["flops"] > 0, rec
    mesh = make_production_mesh()
    struct = registry.build("olmo-1b").param_struct(torch.bfloat16)
    specs = sh.param_pspecs(struct, False)
    want = sum(x.numel() * 2 / sh.spec_shards(s, mesh)
               for x, s in zip(leaves(struct), leaves(specs), strict=True))
    assert rec["bytes_per_device"]["params"] == pytest.approx(want, rel=1e-12)
    assert rec["bytes_per_device"]["params"] < sum(x.numel() * 2 for x in leaves(struct)) / 16


def test_skipped_failed_and_dlrm_cells(tmp_path):
    mesh = make_debug_mesh()
    rec = dryrun.run_cell("olmo-1b", "long_500k", False, smoke=True, mesh=mesh, out_dir=tmp_path)
    assert rec["status"].startswith("skipped (unsupported")
    rec = dryrun.run_cell("olmo-1b", "no_such_shape", False, smoke=True, mesh=mesh,
                          out_dir=tmp_path)
    assert rec["status"] == "FAILED" and "no_such_shape" in rec["error"]
    rec = dryrun.run_cell("dlrm-taobao", "serve_8k", False, mesh=mesh, out_dir=tmp_path)
    assert rec["status"] == "ok", rec
    assert rec["cores"] == 4 and len(rec["packed_bytes_per_core"]) == 4
    tables = get_workload("taobao").tables
    asym_rows = sum(t.rows for i, t in enumerate(tables) if i not in rec["symmetric_tables"])
    # every asymmetric row is packed at least once, with its region's padding
    assert sum(rec["packed_rows_per_core"]) > asym_rows
    assert rec["packed_bytes_per_core"] == [r * 16 * 2 for r in rec["packed_rows_per_core"]]


def test_cli_debug_mesh(tmp_path, capsys):
    rc = dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k", "--smoke",
                      "--debug-mesh", "--out", str(tmp_path)])
    assert rc == 0
    assert "[dryrun] all cells OK" in capsys.readouterr().out


def test_grad_flops_about_3x_forward():
    with torch.device("meta"):
        w = torch.empty(256, 256, requires_grad=True)
        x = torch.empty(32, 256)

    def fwd():
        return torch.tanh(x @ w).sum()

    with FlopCounterMode(display=False) as cf:
        fwd()
    with FlopCounterMode(display=False) as cg:
        torch.autograd.grad(fwd(), w)
    assert 1.6 < cg.get_total_flops() / cf.get_total_flops() < 4.5
