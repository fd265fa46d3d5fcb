#!/usr/bin/env python3
"""The outcome gate of the PyTorch/CUDA port on one NVIDIA card: the
qualitative outcomes of scripts/check_outcomes.py, with its thresholds,
on the port.

    python3 scripts/check_outcomes_torch.py

Runs, at the experiments' full configurations (f32 on the card):
  * the four README unicycle experiments, one episode each (2000 steps,
    dt 0.001, K = 200, 100 Adam iterations, a refit every 400), and the
    chance-constraint audit of the Bayes-CBF episode;
  * a batch of 32 unicycle episodes with learning, starts perturbed by
    0.05 N(0, 1) from STATE_START;
  * one pendulum episode (`make_pendulum_online_sim(max_train=200)`: 250
    steps, a refit every 10, 25 Adam iterations) and batches of 64
    episodes, starts perturbed by 0.05 N(0, 1) from (7 pi / 12, 0), on the
    reference schedule and with continuous updates (bench.py's
    configuration);
  * the pendulum's ground-truth CLF-CBF QP episode
    (`run_pendulum_ground_truth`: 400 steps, dt 0.01, from (5 pi / 12, 0)).

Prints one JSON object: `results`, `verdicts` (every verdict of
scripts/check_outcomes.py but kernel_parity, which chip_smoke.py holds),
`all_pass` and `wall_s`.  Results are not rounded before the thresholds.
Exit code 1 when a verdict fails.  It refuses to run without CUDA, takes
no options and catches nothing.  `chip_smoke.py` loads this file by
path and runs the single episodes through its functions.
"""
import json
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench_torch as bt  # noqa: E402

UNICYCLE_RUNS = {
    "mean_cbf": "unicycle_mean_cbf_collides_obstacle",
    "bayes_cbf": "unicycle_bayes_cbf_safe_obstacle",
    "learning": "unicycle_learning_helps_avoid_getting_stuck",
    "no_learning": "unicycle_no_learning_gets_stuck",
}

def unicycle_run(name, device, dtype=torch.float32):
    """(sim, outputs (T, ...)) of one README experiment, seed 0."""
    from bayesian_cbf_tpu_torch.experiments import unicycle as tu
    return getattr(tu, UNICYCLE_RUNS[name])(device=device, dtype=dtype)


def unicycle_result(name, sim, out):
    """What the verdicts read of one unicycle episode; for the Bayes-CBF
    run also its chance-constraint audit: the worst realized CBC margin
    over the steps marked feasible and the median |margin|."""
    from bayesian_cbf_tpu_torch.experiments import unicycle as tu
    feas = out.info.feasible
    res = dict(min_clearance=float(tu.min_obstacle_clearance(sim, out).min()),
               goal_dist=float(tu.goal_distance(out)),
               feasible=float(feas.to(out.X.dtype).mean()))
    if name == "bayes_cbf":
        mg = tu.realized_cbc_margins(sim, out)
        res["min_feasible_cbc_margin"] = (float(mg[feas].min())
                                          if bool(feas.any()) else math.nan)
        res["cbc_margin_scale"] = float(torch.quantile(
            mg.abs().flatten().double(), 0.5)) or 1.0
    return res


def pendulum_run(device, closed_form=True):
    """(sim, outputs (T, ...)) of one pendulum episode from
    (7 pi / 12, 0), seed 0; closed_form=False builds its CBC2 cones
    through the GP expression path."""
    from bayesian_cbf_tpu_torch.experiments import pendulum as tp
    sim = tp.make_pendulum_online_sim(max_train=200, device=device)
    sim = sim._replace(controller=sim.controller._replace(
        closed_form=closed_form))
    return sim, tp.run_pendulum_online_learning(
        sim, generator=torch.Generator(device=device).manual_seed(0))


def pendulum_prerefit_run(device, closed_form=True, dtype=torch.float32,
                          delta=0.0, seed=0):
    """(sim, outputs (T, ...)) of the steps of `pendulum_run`'s episode
    before its first refit (T = train_every_n_steps + 1), in `dtype` on
    `device`.  delta > 0 moves each closed-form CBC2 term t to
    t + delta (1 + |t|) xi, xi uniform on [-1, 1) from a generator seeded
    with `seed` on `device`: the closed form's cones with their data
    changed by about delta."""
    from bayesian_cbf_tpu_torch.control import learned_socp_controller as lsc
    from bayesian_cbf_tpu_torch.experiments import pendulum as tp
    sim = tp.make_pendulum_online_sim(max_train=200, device=device,
                                      dtype=dtype)
    sim = sim._replace(
        numSteps=sim.learned.train_every_n_steps + 1,
        controller=sim.controller._replace(closed_form=closed_form))
    terms = lsc.cbc2_closed_form_terms
    gen = torch.Generator(device=device).manual_seed(seed)

    def moved(*args):
        (bfe, e), (V, bfv, v), mean, var = terms(*args)
        mv = lambda t: t + delta * (1.0 + t.abs()) * (2.0 * torch.rand(
            t.shape, generator=gen, dtype=t.dtype, device=t.device) - 1.0)
        return (mv(bfe), mv(e)), (mv(V), mv(bfv), mv(v)), mean, var

    if delta > 0:
        lsc.cbc2_closed_form_terms = moved
    try:
        return sim, tp.run_pendulum_online_learning(
            sim, generator=torch.Generator(device=device).manual_seed(0))
    finally:
        lsc.cbc2_closed_form_terms = terms


def learner_state_from_episode(lrn, X, U, n):
    """A learner state for n episodes from one episode's states X (T, n)
    and controls U (T, m): with learning, fitted (`fit_now_first`) on its
    first K + 1 steps; else the initial one.  Seed 0 on X's device."""
    from bayesian_cbf_tpu_torch.models.dynamics import _map
    gen = torch.Generator(device=X.device).manual_seed(0)
    st = lrn.init_state(1, gen, X.device, X.dtype)
    if lrn.enable_learning:
        for t in range(lrn.max_train + 1):
            st = lrn.record(st, X[t:t + 1], U[t:t + 1], generator=gen)
        st = lrn.fit_now_first(st)
    return _map(lambda a: a.expand(n, *a.shape[1:]).contiguous(), st)


def cbc2_term_distance(terms, ref):
    """Per episode, the largest |t - r| / (1 + |r|) over the CBC2 terms
    ((bfe, e), (V, bfv, v), mean, var) against ref's, in f64."""
    flat = lambda t: [t[0][0], t[0][1], t[1][0], t[1][1], t[1][2]]
    return torch.stack([
        ((a.double() - r.double()).abs() / (1.0 + r.double().abs()))
        .reshape(a.shape[0], -1).amax(-1)
        for a, r in zip(flat(terms), flat(ref))]).amax(0)


def pendulum_prerefit_terms(sim, X):
    """The CBC2 terms at the states X (T, 2) of `pendulum_prerefit_run`'s
    episode, u0 = 0.5, under the learner state those steps read (the
    initial one: the posterior first changes at the refit): (GP path,
    closed form) in X's dtype and the closed form in f64."""
    from bayesian_cbf_tpu_torch.models.dynamics import _map
    from bayesian_cbf_tpu_torch.safety import cbc as tcbc
    lrn, cbf, k_alpha = sim.learned, sim.cbf, sim.controller.k_alpha
    T = X.shape[0]
    st = lrn.init_state(1, torch.Generator(device=X.device).manual_seed(0),
                        X.device, X.dtype)
    st = _map(lambda a: a.expand(T, *a.shape[1:]).contiguous(), st)
    st64 = _map(lambda a: a.double() if a.is_floating_point() else a, st)
    u0 = torch.full((T, 1), 0.5, dtype=X.dtype, device=X.device)
    closed = lambda s, x, u: tcbc.cbc2_closed_form_terms(
        cbf, k_alpha, lrn.moment_derivatives(s, x), x, u)
    return (tcbc.cbc2_gp_terms(cbf, k_alpha, lrn.f_gp_and_fu_gp, st, X, u0),
            closed(st, X, u0), closed(st64, X.double(), u0.double()))


def pendulum_result(out):
    from bayesian_cbf_tpu_torch.experiments import pendulum as tp
    th = out.X[:, 0]
    return dict(damage=float(tp.pendulum_damage_fraction(th)),
                wedge_frac=float(tp.pendulum_wedge_fraction(th)),
                theta_end=float(th[-1]),
                feasible=float(out.info.feasible.to(th.dtype).mean()),
                certified=float(out.info.certified.to(th.dtype).mean()),
                finite=bool(torch.isfinite(out.X).all()))


def ground_truth_run(device):
    """(X (T, 2), U (T, 1), pres (T,)) of the ground-truth QP episode."""
    from bayesian_cbf_tpu_torch.experiments import pendulum as tp
    return tp.run_pendulum_ground_truth(device=device)


def ground_truth_result(X, pres):
    from bayesian_cbf_tpu_torch.experiments import pendulum as tp
    th = X[:, 0]
    return dict(damage=float(tp.pendulum_damage_fraction(th)),
                wedge_frac=float(tp.pendulum_wedge_fraction(th)),
                theta_end=float(th[-1]), max_pres=float(pres.max()))


def batched_learning_result(device, B=32):
    """`bench_torch.unicycle_outcomes` of B learning episodes."""
    from bayesian_cbf_tpu_torch.experiments import unicycle as tu
    from bayesian_cbf_tpu_torch.sim.rollout import simulate_unicycle_batch
    sim = tu.make_ackermann_tracking_sim(**tu.EXPERIMENTS["learning"],
                                         device=device)
    x0 = np.asarray(tu.STATE_START)[None] + 0.05 * \
        np.random.default_rng(0).normal(size=(B, 3))
    out = simulate_unicycle_batch(
        sim, torch.tensor(x0, dtype=torch.float32, device=device),
        generator=torch.Generator(device=device).manual_seed(1))
    return dict(B=B, **bt.unicycle_outcomes(sim, out))


def pendulum_batched_result(device, continuous, B=64):
    """`bench_torch.pendulum_outcomes` of B episodes on the reference
    schedule or with continuous updates."""
    from bayesian_cbf_tpu_torch.experiments.pendulum import (
        run_pendulum_online_batch)
    options = bt.PENDULUM_CONFIGS["continuous"] if continuous else {}
    sim = bt.pendulum_sim(device, **options)
    out = run_pendulum_online_batch(
        sim, bt.pendulum_x0s(device, B),
        generator=torch.Generator(device=device).manual_seed(5))
    return dict(B=B, **bt.pendulum_outcomes(sim, out))


def _pendulum_batch_safe(r):
    return (r["mean_damage"] <= 0.01 and r["frac_damaged"] <= 0.05
            and r["frac_wedge_gt_2pct"] <= 0.05 and r["finite"])


# (verdict, the results it reads, the test), thresholds as in
# scripts/check_outcomes.py
VERDICTS = (
    ("collides", ("mean_cbf",), lambda r: r["mean_cbf"]["min_clearance"] < 0),
    ("safe", ("bayes_cbf",), lambda r: r["bayes_cbf"]["min_clearance"] > 0),
    # the f32 feasibility gate must not admit a control that violates a
    # safety cone beyond 1% of the typical margin
    ("feasible_steps_respect_cbc", ("bayes_cbf",),
     lambda r: r["bayes_cbf"]["min_feasible_cbc_margin"]
     > -0.01 * r["bayes_cbf"]["cbc_margin_scale"]),
    ("learning_passes", ("learning", "no_learning"),
     lambda r: r["learning"]["goal_dist"] < r["no_learning"]["goal_dist"] - 1.0
     and r["learning"]["goal_dist"] < 1.5),
    ("no_learning_stuck", ("no_learning",),
     lambda r: r["no_learning"]["goal_dist"] > 2.5),
    ("batched_learning_passes", ("batched_learning",),
     lambda r: r["batched_learning"]["mean_goal_distance"] < 1.5
     and r["batched_learning"]["frac_within_1"] > 0.7
     and r["batched_learning"]["min_clearance"] > 0
     and r["batched_learning"]["finite"]),
    ("pendulum_online_no_damage", ("pendulum_online",),
     lambda r: r["pendulum_online"]["damage"] == 0.0
     and r["pendulum_online"]["finite"]
     and r["pendulum_online"]["wedge_frac"] <= 0.02
     and (math.pi / 4 + math.pi / 8 - 0.02
          < r["pendulum_online"]["theta_end"] < 1.9)),
    # the ground-truth QP holds the barrier exactly: it parks at the wedge
    # edge, never enters, and every solve is clean
    ("pendulum_gt_safe", ("pendulum_ground_truth",),
     lambda r: r["pendulum_ground_truth"]["wedge_frac"] == 0.0
     and r["pendulum_ground_truth"]["damage"] == 0.0
     and r["pendulum_ground_truth"]["max_pres"] < 1e-4
     and (math.pi / 4 + math.pi / 8 - 0.05
          < r["pendulum_ground_truth"]["theta_end"] < 1.45)),
    ("pendulum_batched_safe", ("pendulum_batched",),
     lambda r: _pendulum_batch_safe(r["pendulum_batched"])),
    ("pendulum_batched_cu_safe", ("pendulum_batched_cu",),
     lambda r: _pendulum_batch_safe(r["pendulum_batched_cu"])
     and r["pendulum_batched_cu"]["feasible"] >= 0.95
     and r["pendulum_batched_cu"]["min_final_theta"]
     > math.pi / 4 + math.pi / 8),
    ("feasibility_floor",
     ("bayes_cbf", "learning", "pendulum_online", "pendulum_batched"),
     lambda r: r["bayes_cbf"]["feasible"] >= 0.95
     and r["learning"]["feasible"] >= 0.95
     and r["pendulum_online"]["feasible"] >= 0.95
     and r["pendulum_batched"]["feasible"] >= 0.95),
)


def verdicts(results):
    """Each verdict whose results are all present, as a bool."""
    return {name: bool(test(results)) for name, needs, test in VERDICTS
            if all(k in results for k in needs)}


def main():
    dev, _ = bt.require_card("check_outcomes_torch")
    from bayesian_cbf_tpu_torch.ops import _build
    _build.build_all(_build.KERNEL_SOURCES)
    t0 = time.perf_counter()
    res = {name: unicycle_result(name, *unicycle_run(name, dev))
           for name in UNICYCLE_RUNS}
    res["batched_learning"] = batched_learning_result(dev)
    res["pendulum_online"] = pendulum_result(pendulum_run(dev)[1])
    X, _, pres = ground_truth_run(dev)
    res["pendulum_ground_truth"] = ground_truth_result(X, pres)
    res["pendulum_batched"] = pendulum_batched_result(dev, False)
    res["pendulum_batched_cu"] = pendulum_batched_result(dev, True)
    v = verdicts(res)
    out = dict(results=res, verdicts=v,
               all_pass=all(v.values()) and len(v) == len(VERDICTS),
               wall_s=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return 0 if out["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
