"""The port's console entry points and harness on the CPU, f64, against
the JAX package's: `kwvariations` and `apply_overrides`; `run_experiment`'s
run directory (config.json equal to JAX's for the same overrides, the
obstacles included; metrics.jsonl with JAX's tags and trajectory);
`cli.main` with --cpu, --set and --sweep, its rejections; the named
runs through `main` (the MVGP-against-CoGP and Monte-Carlo entries at
small sizes); `filter_runs` and `load_metrics`.
"""
import json
import math
import os.path as osp

import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.experiments import harness as jh
from bayesian_cbf_tpu.observability import logger as jl
from bayesian_cbf_tpu_torch import cli
from bayesian_cbf_tpu_torch.experiments import harness as th
from bayesian_cbf_tpu_torch.observability import logger as tl

F64 = torch.float64
NAME = "unicycle_bayes_cbf_safe_obstacle"
# a short episode without learning (the Bayes-CBF experiment learns
# nothing), so the trajectories agree to the solver's roundoff
SETS = dict(numSteps=20, dt=0.01, max_train=8, training_iter=2)
SET_ARGS = [a for k, v in SETS.items() for a in ("--set", f"{k}={v}")]


def _close(a, b, tol):
    """Nested JSON values equal, numbers within tol."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (a, b)
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= tol * (1.0 + abs(b)), (a, b)
    else:
        assert a == b, (a, b)


def test_kwvariations_and_apply_overrides_match_jax():
    axes = dict(a=[1, 2], b=["x", "y"], c=[0.5])
    assert th.kwvariations(**axes) == jh.kwvariations(**axes)
    assert th.kwvariations() == jh.kwvariations() == [{}]
    base = {"controller": {"max_risk": 0.5, "iters": 3}, "c": 2}
    over = {"controller.max_risk": 0.01, "new.deep.key": [1, 2], "c": 5}
    assert th.apply_overrides(base, over) == jh.apply_overrides(base, over)
    assert th.apply_overrides({}, {"a.b": 1}) == {"a": {"b": 1}}
    assert base["controller"]["max_risk"] == 0.5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdir = jh.run_experiment(NAME, runs_dir=str(tmp_path_factory.mktemp(
        "jax")), **SETS)[2]
    tdir = th.run_experiment(NAME, runs_dir=str(tmp_path_factory.mktemp(
        "port")), device="cpu", dtype=F64, **SETS)[2]
    return jdir, tdir


def test_run_experiment_config_matches_jax(runs):
    """The same keys and values in config.json, the obstacle list, the
    goal, dt and numSteps included; the version stamp is the same
    string."""
    jdir, tdir = runs
    for d in runs:
        assert osp.basename(d).startswith(NAME + "_")
    with open(osp.join(jdir, "config.json")) as f:
        want = json.load(f)
    with open(osp.join(tdir, "config.json")) as f:
        got = json.load(f)
    assert len(got["obstacles"]) == 2
    assert got["name"] == NAME and got["numSteps"] == SETS["numSteps"]
    _close(got, want, 1e-12)


def test_run_experiment_metrics_match_jax(runs):
    """metrics.jsonl holds JAX's tags with a record per step, and the
    logged trajectory is JAX's (the mean- and Bayes-CBF experiments'
    episode bar, tests/test_torch_outcomes.py: 2e-3 in X)."""
    jdir, tdir = runs
    want, got = jl.load_metrics(jdir), tl.load_metrics(tdir)
    assert sorted(got) == sorted(want)
    for tag in got:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
    X = np.array([v for _, v in got["vis/state"]])
    Xw = np.array([v for _, v in want["vis/state"]])
    assert X.shape == (SETS["numSteps"], 3)
    np.testing.assert_allclose(X, Xw, atol=2e-3)
    np.testing.assert_allclose(
        np.array([v for _, v in got["vis/plan_x"]]),
        np.array([v for _, v in want["vis/plan_x"]]), atol=1e-12)
    assert tl.filter_runs(osp.dirname(tdir)) == [tdir]
    assert tl.filter_runs(osp.dirname(tdir),
                          lambda c: c.get("name") == "other") == []


def test_main_prints_json_and_writes_run(tmp_path, capsys):
    rc = cli.main([NAME, "--cpu", *SET_ARGS, "--runs-dir", str(tmp_path)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0.0 <= out["feasible_frac"] <= 1.0
    assert len(out["final_state"]) == 3
    assert all(math.isfinite(v) for v in out["final_state"])
    assert osp.exists(osp.join(out["run_dir"], "metrics.jsonl"))
    with open(osp.join(out["run_dir"], "config.json")) as f:
        cfg = json.load(f)
    assert {k: cfg[k] for k in SETS} == SETS


def test_main_sweep(tmp_path, capsys):
    rc = cli.main([NAME, "--cpu", "--sweep", "max_risk=[0.01,0.4999]",
                   "--set", "numSteps=5", "--set", "dt=0.01",
                   "--runs-dir", str(tmp_path)])
    assert rc == 0
    lines = [json.loads(l) for l in
             capsys.readouterr().out.strip().splitlines()]
    assert {l["overrides"]["max_risk"] for l in lines} == {0.01, 0.4999}
    assert len({l["run_dir"] for l in lines}) == 2
    for l in lines:
        assert osp.isdir(l["run_dir"])


def test_main_rejects_unknown_experiment_and_needs_a_card():
    with pytest.raises(SystemExit):
        cli.main(["not_an_experiment", "--cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--cpu"):
            cli.main([NAME, *SET_ARGS])


def test_named_entries(capsys):
    """The named runs are experiments of `main`: they take --set and
    --cpu, print their result, and reject --sweep."""
    assert cli.main(["pendulum_control_ground_truth", "--cpu",
                     "--set", "numSteps=4"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["damage_fraction"] == 0.0 and res["max_pres"] < 1e-6
    assert cli.main(["pendulum_control_online_learning", "--cpu",
                     "--set", "numSteps=4", "--set", "max_train=4"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert len(res["final_state"]) == 2 and 0.0 <= res["damage_fraction"]
    assert cli.main(["car_learn_dynamics", "--cpu", "--set", "max_train=12",
                     "--set", "training_iter=2"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert math.isfinite(res["rmse"])
    with pytest.raises(SystemExit):
        cli.main(["car_learn_dynamics", "--cpu", "--sweep", "seed=[0,1]"])


@pytest.mark.parametrize("name, sets, check", [
    ("pendulum_learn_dynamics",
     ["max_train=16", "training_iter=2", "n_test=8", "tries=2"],
     lambda r: sorted(r) == ["matrix", "vector"]
     and all(math.isfinite(v) for v in r.values())),
    ("speed_test_matrix_vector",
     ["max_train_list=(6,)", "grid=3", "ntimes=1", "repeat=1",
      "training_iter=2"],
     lambda r: sorted(r) == ["matrix", "matrixdiag", "vector", "vectordiag"]
     and all(sorted(v) == ["6"] and v["6"]["elapsed"] > 0
             and math.isfinite(v["6"]["error"]) for v in r.values())),
    ("unicycle_speed_test",
     ["numSteps=12", "max_train_list=(6,)", "ntimes=1", "repeat=1",
      "training_iter=2", "regressors=('matrix','vectordiag')"],
     lambda r: sorted(r) == ["matrix", "vectordiag"]
     and all(math.isfinite(v["6"]["error"]) for v in r.values())),
    ("monte_carlo_unicycle",
     ["n_rollouts=2", "numSteps=6", "max_train=4", "training_iter=2"],
     lambda r: sorted(r) == ["collision_fraction", "feasible_fraction",
                             "mean_goal_distance", "min_clearance"]
     and all(isinstance(v, float) and math.isfinite(v)
             for v in r.values())),
])
def test_named_experiments_of_the_cogp_and_monte_carlo_slice(
        name, sets, check, capsys):
    """The dynamics-learning, speed-test and Monte-Carlo entries on the
    CPU at small sizes print their JSON (the speed tests keyed by k)."""
    args = [a for v in sets for a in ("--set", v)]
    assert cli.main([name, "--cpu", *args]) == 0
    res = json.loads(capsys.readouterr().out)
    assert check(res), res


def test_metrics_logger_roundtrip(tmp_path):
    lg = tl.MetricsLogger(runs_dir=str(tmp_path), exp_tags=["a", "b"],
                          stamp="s", config={"k": (1, 2),
                                             "t": torch.tensor([0.5])})
    lg.add_scalar("x", torch.tensor(2.5, dtype=F64), 3)
    lg.add_rows("rows", torch.arange(6.0).reshape(3, 2), every=2)
    lg.dump_config({"extra": np.float64(1.5)})
    lg.close()
    assert lg.dir == osp.join(str(tmp_path), "a_b_s")
    got = tl.load_metrics(lg.dir)
    assert got == {"x": [(3, 2.5)], "rows": [(0, [0.0, 1.0]),
                                             (2, [4.0, 5.0])]}
    with open(osp.join(lg.dir, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["k"] == [1, 2] and cfg["t"] == [0.5] and cfg["extra"] == 1.5
    assert cfg["_version"] == tl.version_stamp() == jl.version_stamp()
