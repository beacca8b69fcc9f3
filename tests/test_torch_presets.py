"""The three shipped presets in the port, against the JAX package.

* The preset JSON files are byte-equal copies of the reference's, and the
  loaders return the same packs.
* ``config_from_args(["--preset", name, ...])`` resolves to the reference's
  ``EngineConfig`` (``to_dict()`` equal) and fills the same workload and
  traffic flags; explicit flags still override, and ``--preset`` with
  ``--config`` is refused as in the reference.
* ``--drift`` specs (and the day-parted traffic presets) parse to the same
  ``DriftSchedule``.
* The serve CLI serves each preset at the smoke workload on the CPU: every
  request accounted for, finite logits, and the drift presets replan at
  the reference CLI's batches.
"""
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.configs import presets as jpresets
from repro.data import distributions as jdist
from repro.launch import serve as jserve
from repro_torch.configs import presets
from repro_torch.data import distributions as tdist
from repro_torch.launch import serve

NAMES = ["huawei-dayparted", "taobao-zipf12", "tenrec-hotset"]
ROOT = Path(__file__).resolve().parent.parent


def _resolve(cli, argv):
    args = cli.build_parser().parse_args(argv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cfg = cli.config_from_args(args)
    return cfg, args


def test_preset_files_are_byte_equal_copies():
    assert presets.list_presets() == jpresets.list_presets() == NAMES
    for name in NAMES:
        got = ROOT / "src/repro_torch/configs/presets" / f"{name}.json"
        want = ROOT / "src/repro/configs/presets" / f"{name}.json"
        assert got.read_bytes() == want.read_bytes(), name


@pytest.mark.parametrize("name", NAMES)
def test_load_preset_like_reference(name):
    assert presets.load_preset(name) == jpresets.load_preset(name)


@pytest.mark.parametrize("extra", [
    [], ["--batch", "64"], ["--workload", "smoke"], ["--distribution", "uniform"],
    ["--set", "access=dedup"], ["--set", "drift=none"], ["--replan"],
])
@pytest.mark.parametrize("name", NAMES)
def test_preset_resolves_like_reference(name, extra):
    cfg, args = _resolve(serve, ["--preset", name, *extra])
    jcfg, jargs = _resolve(jserve, ["--preset", name, *extra])
    assert cfg.to_dict() == jcfg.to_dict()
    assert (args.workload, args.distribution) == (jargs.workload, jargs.distribution)


def test_preset_and_config_are_exclusive(tmp_path):
    path = tmp_path / "eng.json"
    path.write_text("{}")
    for cli in (serve, jserve):
        with pytest.raises(SystemExit):
            _resolve(cli, ["--preset", "taobao-zipf12", "--config", str(path)])


def test_unknown_preset_rejected():
    for mod in (presets, jpresets):
        with pytest.raises(ValueError, match="unknown preset"):
            mod.load_preset("nope")


@pytest.mark.parametrize("spec,phase_batches", [
    ("zipf:1.2@80,hotset:0.01:0.9:-1@64", 8),
    ("flip", 8), ("flip", 48),
    ("uniform@8,zipf:1.2@8,hotset:0.01:0.9:-1@8", 1),
])
def test_drift_specs_parse_like_reference(spec, phase_batches):
    got = tdist.parse_drift(spec, phase_batches=phase_batches)
    want = jdist.parse_drift(spec, phase_batches=phase_batches)
    assert isinstance(got, tdist.DriftSchedule)
    assert got.spec() == want.spec() and got.period == want.period
    assert [got.at(b).spec() for b in range(2 * got.period)] == [
        want.at(b).spec() for b in range(2 * want.period)]


@pytest.mark.parametrize("spec", ["huawei-25mb", "tenrec-qb", "zipf:1.2"])
def test_preset_traffic_like_reference(spec):
    """Each preset's traffic spec resolves to the same distribution (the
    day-parted ``huawei-25mb`` to the same schedule)."""
    got, want = tdist.get_distribution(spec), jdist.get_distribution(spec)
    assert type(got).__name__ == type(want).__name__
    assert got.spec() == want.spec()


def _lines(out, key):
    return [ln for ln in out.splitlines() if key in ln]


@pytest.mark.parametrize("name,extra", [
    ("taobao-zipf12", ["--drift", "zipf:1.2@8,hotset:0.01:0.9:-1@8",
                       "--set", 'drift_options={"overlap": false}']),
    ("huawei-dayparted", ["--set", 'drift_options={"overlap": false}',
                          "--set", "deadline_s=null"]),
    ("tenrec-hotset", []),
])
def test_serve_cli_runs_preset_on_cpu(name, extra, capsys):
    """Each preset at the smoke workload (batch 64, 24 batches, a checksum
    sweep every 8) on the CPU: every request served, finite logits, the
    integrity cadence running and finding nothing on clean buffers, and
    the drift presets (replanned inline) replanning at the reference CLI's
    batches (taobao-zipf12 at least once)."""
    argv = ["--preset", name, "--workload", "smoke", "--batch", "64", "--queries", "1536",
            "--set", "tuning=none", "--set", 'integrity_options={"check_every": 8}', *extra]
    res = serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    (s,) = res["stats"].values()
    assert s["submitted"] == s["served"] == 1536
    assert s["batch_failures"] == s["degraded_batches"] == 0
    assert np.isfinite(res["last"]["logits"]).all() and len(res["last"]["logits"]) == 64
    assert s["integrity"]["checks"] >= 1 and s["integrity"]["corruptions_detected"] == 0
    jserve.main(argv)
    jout = capsys.readouterr().out
    assert _lines(out, "replan@batch") == _lines(jout, "replan@batch")
    if name != "tenrec-hotset":
        assert s["replan"]["drift_checks"] >= 1
        assert s["replan"]["replan_errors"] == s["replan"]["parity_failures"] == 0
    if name == "taobao-zipf12":  # its drift spec flips the traffic at batch 8
        assert s["replan"]["replans"] >= 1 and _lines(out, "replan@batch")
