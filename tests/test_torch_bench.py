"""bench_torch.py's timing protocol, driven on the CPU at a tiny size (f64,
two episodes, a few dozen steps, two repetitions): the record's fields,
the first rollout kept out of the reported wall, equal outcomes across
the rollouts of one workload, no kernel launch on the CPU, and the outcome
gates.  The timed runs themselves happen on the card (`bench_torch.py`,
`chip_smoke.py`)."""
import json

import pytest
import torch

import bench_torch as bt

BENCH_FIELDS = ("metric", "value", "unit", "finite", "platform",
                "episode_steps", "max_train", "warm_start",
                "training_iter_warm", "first_fit_coarse_stride",
                "wall_s_per_batch")
TINY = {
    "unicycle": dict(steps=36, max_train=8, training_iter=3,
                     train_every_n_steps=12, training_iter_warm=2,
                     first_fit_coarse_stride=2, first_fit_refine_iter=2),
    "pendulum continuous": dict(steps=24, max_train=8, training_iter=3,
                                train_every_n_steps=8),
    "pendulum reference schedule": dict(steps=24, max_train=8,
                                        training_iter=3,
                                        train_every_n_steps=8),
}


@pytest.fixture(scope="module", params=bt.WORKLOADS)
def record(request):
    return bt.run_protocol(request.param, "cpu", batch=2, reps=2,
                           dtype=torch.float64, **TINY[request.param])


def test_record_has_bench_fields_and_the_ports_own(record):
    line = json.loads(bt.json_line(record))
    for field in BENCH_FIELDS + ("card", "walls_s", "walls_spread",
                                 "first_wall_s", "launches", "refresh_rungs",
                                 "outcomes", "gate_failures"):
        assert field in line
    assert "vs_baseline" not in line and "mfu" not in line
    assert line["platform"] == "cpu" and line["unit"] == "steps/sec"
    assert line["episode_steps"] == TINY[record["workload"]]["steps"]
    assert line["max_train"] == 8 and line["batch"] == 2
    assert line["finite"] is True and line["dtype"] == "float64"


def test_first_rollout_is_not_in_the_reported_wall(record):
    walls = record["walls_s"]
    assert len(walls) == 2 and len(record["rollouts"]) == 3
    assert walls == [r["wall_s"] for r in record["rollouts"][1:]]
    assert record["first_wall_s"] == record["rollouts"][0]["wall_s"]
    want = sum(walls) / 2 if record["workload"] == "unicycle" else min(walls)
    assert record["wall_s_per_batch"] == want
    steps = TINY[record["workload"]]["steps"]
    assert record["value"] == pytest.approx(2 * steps / want)
    assert ("mean" if record["workload"] == "unicycle" else "best") \
        in record["wall_is"]
    assert record["walls_spread"] == pytest.approx(
        (max(walls) - min(walls)) / (sum(walls) / 2))


def test_rollouts_of_one_workload_repeat_their_outcomes(record):
    first = record["rollouts"][0]
    for r in record["rollouts"][1:]:
        assert r["outcomes"] == first["outcomes"]
    assert record["outcomes"] == first["outcomes"]


def test_no_kernel_is_launched_on_the_cpu(record):
    assert set(record["launches"]) == set(bt.counters())
    assert all(r["launches"][k] == 0 for r in record["rollouts"]
               for k in r["launches"])


def test_every_rollout_counts_a_rung_per_episode_and_refresh(record):
    """`refresh_rungs` is the `refresh.rung<i>` counters of one rollout's
    recording: every cache refresh adds each of the 2 episodes to the rung
    it accepted, and
    these well-conditioned f64 Grams all take the first."""
    steps, every = (TINY[record["workload"]][k]
                    for k in ("steps", "train_every_n_steps"))
    refreshes = len(range(every, steps, every))
    assert refreshes == 2
    for r in record["rollouts"]:
        assert r["refresh_rungs"] == [2 * refreshes, 0, 0]
    assert record["refresh_rungs"] == [2 * refreshes, 0, 0]


def test_pendulum_record_carries_its_configuration(record):
    name = record["workload"]
    if name == "unicycle":
        assert record["config"] == {} and record["warm_start"] is True
    else:
        assert record["config"] == bt.PENDULUM_CONFIGS[
            name[len("pendulum "):]]
        assert record["warm_start"] is False


def test_gates_read_the_outcomes():
    good = dict(finite=True, min_clearance=0.1, mean_goal_distance=0.5,
                frac_within_1=1.0, feasible=1.0)
    assert bt.gate_failures("unicycle", good) == []
    assert len(bt.gate_failures("unicycle", dict(good, min_clearance=-0.1,
                                                 frac_within_1=0.5))) == 2
    pend = dict(finite=True, certified=0.5, feasible=0.99, mean_damage=0.0,
                frac_damaged=0.0, frac_wedge_gt_2pct=0.0,
                min_final_theta=1.0)
    assert bt.gate_failures("pendulum continuous", pend) == []
    assert bt.gate_failures("pendulum continuous", pend,
                            continuous=True) != []
    assert bt.gate_failures("pendulum reference schedule",
                            dict(pend, feasible=0.9)) == ["feasible >= 0.95"]


def test_unknown_workload_and_missing_card_are_refused():
    with pytest.raises(ValueError):
        bt.run_protocol("car", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bt.require_card("test")
