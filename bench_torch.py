#!/usr/bin/env python3
"""Timing protocol of the PyTorch/CUDA port on one NVIDIA card: the two
workloads of the JAX package's bench.py, timed as bench.py times them.

    python3 bench_torch.py

  * unicycle: the batched Ackermann tracking loop with online learning
    (B=256 episodes, 2000 steps, max_train 200, bench.py's configuration):
    one warm-up rollout, then three timed rollouts, each ended by
    `torch.cuda.synchronize()`; `value` is B x T over their MEAN wall.
  * pendulum continuous / pendulum reference schedule: the batched
    pendulum online-learning loop (B=256, 250 steps, max_train 200) in
    bench.py's two configurations: a first run, then the BEST of three.

Every rollout of a workload starts from the same states and the same
generator seed, so its repetitions must give the same outcomes; the run
raises if they differ or if an outcome gate of scripts/check_outcomes.py
fails.  One JSON line per workload, with bench.py's field names where they
apply, the card's name and power limit, every repetition's wall and their
spread, the kernels' launch counts and the cache refreshes' accepted rungs
per rollout and the outcomes the gates read.  It takes no options: numbers
of two commits compare only under this one protocol.  It refuses to run
without CUDA; nothing is caught; exit code 1 on failure.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

WORKLOADS = ("unicycle", "pendulum continuous", "pendulum reference schedule")

# bench.py's pendulum configurations (bench.py:300-318)
PENDULUM_CONFIGS = {
    "continuous": dict(continuous_updates=True, train_every_n_steps=100,
                       training_iter_warm=5, first_fit_coarse_stride=3,
                       first_fit_refine_iter=5),
    "reference schedule": dict(training_iter_warm=10),
}


def require_card(what):
    """Refuse to run without CUDA; print the card's line; TF32 off for
    matmuls and cuDNN.  Returns (device, card line)."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: CUDA is not available; this run needs an "
                         f"NVIDIA card and never runs on the CPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return torch.device("cuda"), card


def unicycle_sim(dev, dtype=torch.float32, gp_options=None, **options):
    """bench.py's flagship configuration (bench.py:70-77) with its
    defaults; `options` override single keywords of the factory,
    `gp_options` fields of the learner's MVGP (`fit_inverse`,
    `linv_assembly`, `fused_gram`, ...)."""
    from bayesian_cbf_tpu_torch.experiments.unicycle import (
        make_ackermann_tracking_sim)
    cfg = dict(dt=0.001, numSteps=2000, true_L=1.0, mean_L=12.0,
               kernel_diag_A=(1.0, 1.0, 1.0), max_risk=0.01,
               enable_learning=True, train_every_n_steps=400,
               max_train=200, training_iter=100,
               socp_iters=25, warm_start=True, socp_iters_warm=15,
               training_iter_warm=10,
               first_fit_coarse_stride=4, first_fit_refine_iter=15)
    cfg.update(options)
    sim = make_ackermann_tracking_sim(**cfg, device=dev, dtype=dtype)
    lrn = sim.learned_dynamics
    return sim._replace(learned_dynamics=lrn._replace(
        gp=lrn.gp._replace(**(gp_options or {}))))


def unicycle_x0s(dev, B=256, dtype=torch.float32):
    """STATE_START + 0.01 N(0, 1) (bench.py's perturbation, from a numpy
    seed)."""
    from bayesian_cbf_tpu_torch.experiments.unicycle import STATE_START
    rng = np.random.default_rng(0)
    x0 = np.asarray(STATE_START)[None] + 0.01 * rng.normal(size=(B, 3))
    return torch.tensor(x0, dtype=dtype, device=dev)


def pendulum_sim(dev, dtype=torch.float32, **options):
    """bench.py's pendulum (bench.py:260-319): max_train 200, 250 steps,
    dt 2e-3, with the configuration's keywords."""
    from bayesian_cbf_tpu_torch.experiments.pendulum import (
        make_pendulum_online_sim)
    cfg = dict(max_train=200)
    cfg.update(options)
    return make_pendulum_online_sim(**cfg, device=dev, dtype=dtype)


def pendulum_x0s(dev, B=256, dtype=torch.float32):
    """theta0 = 7 pi / 12 and omega0 = 0, each + 0.05 N(0, 1) (bench.py's
    perturbation, from a numpy seed)."""
    from bayesian_cbf_tpu_torch.experiments.pendulum import THETA0
    rng = np.random.default_rng(7)
    x0 = np.array([THETA0, 0.0])[None] + 0.05 * rng.normal(size=(B, 2))
    return torch.tensor(x0, dtype=dtype, device=dev)


# the kernels' short names -> their wrappers, whose launches a recording
# counts as `launches.<wrapper>` (`observability/tracing.py`)
KERNELS = dict(ipm="ipm", kinv_logdet="kinv_logdet", chol_linv="chol_linv",
               chol_dinv="chol_dinv", sweep="batched_kinv_logdet",
               gram="fused_gram_kb", cholsolve_logdet="cholsolve_logdet",
               solve_with_factor="solve_with_factor", fit_gram="fit_gram",
               fit_gram_backward="fit_gram_backward")


def counters():
    """The kernels' short names, the keys of a record's `launches`."""
    return tuple(KERNELS)


def launch_counts(report):
    """{short name: launches} of a `tracing.report()`."""
    c = report["counters"]
    return {k: c.get(f"launches.{w}", 0) for k, w in KERNELS.items()}


def counter_list(report, prefix, n):
    """The counters `<prefix>0` .. `<prefix><n - 1>` of a
    `tracing.report()` (0 where one was never counted)."""
    return [report["counters"].get(f"{prefix}{i}", 0) for i in range(n)]


def unicycle_outcomes(sim, out):
    """What the batched-learning gate reads, and the feasible fraction."""
    from bayesian_cbf_tpu_torch.experiments.unicycle import (
        STATE_GOAL, goal_distance, min_obstacle_clearance)
    gd = goal_distance(out, STATE_GOAL)
    return dict(finite=bool(torch.isfinite(out.X).all()),
                min_clearance=float(min_obstacle_clearance(sim, out).min()),
                mean_goal_distance=float(gd.mean()),
                frac_within_1=float((gd < 1.0).to(gd.dtype).mean()),
                feasible=float(out.info.feasible.to(gd.dtype).mean()))


def pendulum_outcomes(sim, out):
    """What the pendulum batch gates read (pendulum_batched_safe and
    pendulum_batched_cu_safe of scripts/check_outcomes.py)."""
    from bayesian_cbf_tpu_torch.experiments.pendulum import (
        pendulum_damage_fraction, pendulum_wedge_fraction)
    th = out.X[..., 0]
    dmg = pendulum_damage_fraction(th)
    wdg = pendulum_wedge_fraction(th)
    return dict(finite=bool(torch.isfinite(out.X).all()),
                certified=float(out.info.certified.to(th.dtype).mean()),
                feasible=float(out.info.feasible.to(th.dtype).mean()),
                mean_damage=float(dmg.mean()),
                frac_damaged=float((dmg > 0).to(th.dtype).mean()),
                frac_wedge_gt_2pct=float((wdg > 0.02).to(th.dtype).mean()),
                min_final_theta=float(out.X[:, -1, 0].min()))


def gate_failures(workload, outcomes, continuous=False):
    """The outcome gates of scripts/check_outcomes.py that `outcomes`
    fails, as a list of texts (empty: every gate holds)."""
    o = outcomes
    if workload == "unicycle":
        checks = {"finite": o["finite"],
                  "min clearance > 0": o["min_clearance"] > 0,
                  "mean goal distance < 1.5": o["mean_goal_distance"] < 1.5,
                  "more than 0.7 within 1.0 of the goal":
                      o["frac_within_1"] > 0.7}
    else:
        checks = {"finite": o["finite"],
                  "mean damage <= 0.01": o["mean_damage"] <= 0.01,
                  "damaged episodes <= 5%": o["frac_damaged"] <= 0.05,
                  "episodes > 2% in the wedge <= 5%":
                      o["frac_wedge_gt_2pct"] <= 0.05,
                  "feasible >= 0.95": o["feasible"] >= 0.95}
        if continuous:
            checks["every episode ends above the wedge edge"] = \
                o["min_final_theta"] > math.pi / 4 + math.pi / 8
    return [text for text, ok in checks.items() if not ok]


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def run_protocol(workload, device, batch=256, steps=None, reps=3,
                 dtype=torch.float32, card=None, **sim_options):
    """bench.py's protocol for one of WORKLOADS on `device`: a first
    rollout (the warm-up; its wall is kept apart and is the reported one
    only when `reps` is 0), then `reps` timed rollouts of `steps` steps
    (None: the workload's own) for `batch` episodes, every one from the
    same start states and generator seed and ended by a device
    synchronization.  Unicycle: `value` is batch x steps
    over the MEAN of the timed walls (bench.py:85-104); pendulum: over
    their BEST (bench.py:260-284); `walls_spread` is (max - min) / mean of
    the timed walls.  Raises RuntimeError when two rollouts' outcomes,
    launch counts or accepted rungs differ.  Returns the JSON record;
    `rollouts` holds every rollout's wall, launches, accepted rungs
    (the `refresh.rung<i>` counters: episodes per rung of the cache
    refreshes' jitter ladder, first / + 1e-5 scale / + 1e-2 scale) and
    outcomes, the last output is under "out" (dropped by `json_line`).
    Every rollout runs inside a `tracing.recording()`, which counts them."""
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r}; one of {WORKLOADS}")
    dev = torch.device(device)
    if steps is not None:
        sim_options["numSteps"] = steps
    if workload == "unicycle":
        from bayesian_cbf_tpu_torch.sim.rollout import simulate_unicycle_batch
        sim = unicycle_sim(dev, dtype, **sim_options)
        x0s, seed = unicycle_x0s(dev, batch, dtype), 1
        lrn, run, read = (sim.learned_dynamics, simulate_unicycle_batch,
                          unicycle_outcomes)
        config = {}
    else:
        from bayesian_cbf_tpu_torch.experiments.pendulum import (
            run_pendulum_online_batch)
        config = dict(PENDULUM_CONFIGS[workload[len("pendulum "):]])
        sim = pendulum_sim(dev, dtype, **{**config, **sim_options})
        x0s, seed = pendulum_x0s(dev, batch, dtype), 5
        lrn, run, read = sim.learned, run_pendulum_online_batch, \
            pendulum_outcomes
    from bayesian_cbf_tpu_torch.observability import tracing
    T = sim.numSteps
    rollouts = []
    for _ in range(1 + reps):
        gen = torch.Generator(device=dev).manual_seed(seed)
        _sync(dev)
        with tracing.recording():
            t0 = time.perf_counter()
            out = run(sim, x0s, generator=gen)
            _sync(dev)
            wall = time.perf_counter() - t0
        rep = tracing.report()
        rollouts.append(dict(
            wall_s=wall, launches=launch_counts(rep),
            refresh_rungs=counter_list(rep, "refresh.rung", 3),
            outcomes=read(sim, out)))
    first, timed = rollouts[0], rollouts[1:]
    same = ("outcomes", "launches", "refresh_rungs")
    for r in timed:
        if any(r[k] != first[k] for k in same):
            raise RuntimeError(
                f"{workload}: two rollouts of the same inputs differ: "
                f"{[first[k] for k in same]} against {[r[k] for k in same]}")
    walls = [r["wall_s"] for r in timed]
    if workload == "unicycle":
        metric = ("unicycle Bayes-CBF control steps/sec (online MVGP + CBC "
                  "SOCP, batch=%d)" % batch)
        how, reduce = f"mean of {reps} after a warm-up", \
            lambda w: sum(w) / len(w)
    else:
        metric = ("pendulum rel-deg-2 online-learning control steps/sec "
                  "(%s, batch=%d)" % (workload[len("pendulum "):], batch))
        how, reduce = f"best of {reps} after a first run", min
    if walls:
        wall = reduce(walls)
        spread = (max(walls) - min(walls)) * len(walls) / sum(walls)
    else:
        how, wall, spread = "the first rollout alone", first["wall_s"], None
    ctrl = getattr(sim.controller, "warm_start", False)
    return dict(
        workload=workload, metric=metric, value=batch * T / wall,
        unit="steps/sec",
        finite=first["outcomes"]["finite"],
        platform="gpu" if dev.type == "cuda" else dev.type,
        card=card, dtype=str(dtype).replace("torch.", ""), batch=batch,
        episode_steps=T, max_train=lrn.max_train, warm_start=bool(ctrl),
        training_iter_warm=lrn.training_iter_warm,
        first_fit_coarse_stride=lrn.first_fit_coarse_stride,
        config=config, wall_s_per_batch=wall, wall_is=how, walls_s=walls,
        walls_spread=spread, first_wall_s=first["wall_s"],
        launches=first["launches"], refresh_rungs=first["refresh_rungs"],
        outcomes=first["outcomes"],
        gate_failures=gate_failures(workload, first["outcomes"],
                                    lrn.continuous_updates),
        rollouts=rollouts, out=out, sim=sim)


def json_line(record):
    """The record as one JSON line, without the tensors and the sim."""
    return json.dumps({k: v for k, v in record.items()
                       if k not in ("out", "sim", "rollouts")})


def main():
    dev, card = require_card("bench_torch")
    from bayesian_cbf_tpu_torch.ops import _build
    _build.build_all(_build.KERNEL_SOURCES)
    failed = []
    for workload in WORKLOADS:
        record = run_protocol(workload, dev, card=card)
        print(json_line(record), flush=True)
        failed += [f"{workload}: {text}" for text in record["gate_failures"]]
    if failed:
        raise RuntimeError(f"outcome gates failed: {failed}")


if __name__ == "__main__":
    main()
