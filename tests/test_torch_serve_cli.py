"""The port's serve CLI resolves every legacy flag spelling as the JAX
package's does: the same ``EngineConfig`` (``to_dict()`` equal across the
two packages, and equal to the canonical ``--set`` spelling) with the same
number of ``DeprecationWarning``s.  ``--replan`` resolves like the JAX
package's and serves through the drift loop."""
import warnings

import pytest

from repro.launch import serve as jserve
from repro_torch.launch import serve

# the JAX package's LEGACY_CASES (tests/test_serve_cli.py): every legacy
# spelling beside its canonical --set equivalent and its warning count
LEGACY_CASES = [
    (["--planner", "symmetric"], ["--set", "planner=symmetric"], 1),
    (["--planner", "asymmetric"], [], 1),
    (["--layout", "dense"], ["--set", "layout=dense"], 1),
    (["--kernels", "xla"], ["--set", "use_kernels=xla"], 1),
    (["--reduce", "psum"], ["--set", "reduce_mode=psum"], 1),
    (["--reduce", "ring"], ["--set", "reduce_mode=ring"], 1),
    (["--autotune"], ["--set", "tuning=sweep"], 1),
    (["--dedup"], ["--set", "access=dedup"], 1),
    (["--cache"], ["--set", "access=cache"], 1),
    (["--dedup", "--cache"], ["--set", "access=full"], 2),
    (["--replan"], ["--set", "drift=replan"], 1),
    (
        ["--replan", "--replan-threshold", "0.3"],
        ["--set", "drift=replan", "--set", 'drift_options={"threshold": 0.3}'],
        2,
    ),
    (
        ["--replan-threshold", "0.3"],
        ["--set", 'drift_options={"threshold": 0.3}'],
        1,
    ),
]


def _resolve(cli, argv):
    args = cli.build_parser().parse_args(argv)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cfg = cli.config_from_args(args)
    return cfg, [w for w in rec if issubclass(w.category, DeprecationWarning)]


@pytest.mark.parametrize("legacy,canonical,n_warnings", LEGACY_CASES,
                         ids=[" ".join(c[0]) for c in LEGACY_CASES])
def test_legacy_flag_resolves_like_reference(legacy, canonical, n_warnings):
    cfg, dep = _resolve(serve, legacy)
    jcfg, jdep = _resolve(jserve, legacy)
    assert len(dep) == len(jdep) == n_warnings
    assert [str(w.message) for w in dep] == [str(w.message) for w in jdep]
    assert all(w.filename == __file__ for w in dep)  # points at the caller
    assert cfg.to_dict() == jcfg.to_dict()
    canonical_cfg, dep_canon = _resolve(serve, canonical)
    assert not dep_canon
    assert cfg == canonical_cfg


def test_defaults_and_replan_cadence_like_reference():
    for argv in ([], ["--replan"], ["--set", "drift=replan",
                                   "--set", 'drift_options={"patience": 5}']):
        cfg, dep = _resolve(serve, argv)
        jcfg, _ = _resolve(jserve, argv)
        assert cfg.to_dict() == jcfg.to_dict()
        assert not dep or argv == ["--replan"]
    assert cfg.drift_options == {"patience": 5, "check_every": 4, "cooldown": 8}


def test_replan_serves_through_drift_loop():
    """``--replan`` once refused to build (drift serving was not ported);
    now it builds and serves through the drift loop, with the CLI's
    historical trigger cadence."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = serve.main(["--device", "cpu", "--workload", "smoke", "--batch", "8",
                          "--queries", "64", "--replan"])
    (label,) = res["stats"]
    s = res["stats"][label]
    assert label == "drift" and s["served"] == s["submitted"] == 64
    assert s["replan"]["drift_checks"] == 2 and s["replan"]["replan_errors"] == 0
    assert res["engine"].config.drift_options == {"check_every": 4, "patience": 2, "cooldown": 8}


def test_legacy_layout_dense_serves_on_cpu():
    with pytest.warns(DeprecationWarning, match="--layout"):
        res = serve.main(["--device", "cpu", "--workload", "smoke", "--batch", "16",
                          "--queries", "32", "--distribution", "uniform",
                          "--set", "mesh_shape=[1,4]", "--layout", "dense"])
    engine = res["engine"]
    assert engine.config.layout == engine.packed.layout == "dense"
    s = res["stats"]["uniform"]
    assert s["served"] == s["submitted"] == 32 and s["batch_failures"] == 0
