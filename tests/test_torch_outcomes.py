"""Parity of the port's outcome-gate slice against the JAX package on the
CPU, f64: the four README unicycle experiments and the single pendulum
episode (one episode each, the batched runners at B = 1), the chance-
constraint audit, the moment derivatives without learning, the pendulum
data samplers and error measure, and the verdicts of
scripts/check_outcomes_torch.py at their thresholds' edges.

The port is fed JAX's random numbers: the initial parameters and the
reservoir draws of `init_state(PRNGKey(0))` and `record`'s key chain, and
for the pendulum `kd, ks = split(PRNGKey(0))` with one exploration chain
`key, ke = split(key)` per step from `ks`.  The bars are those of
tests/test_torch_e2e.py and tests/test_torch_pendulum_e2e.py: the
reference's own roundoff sensitivity.
"""
import importlib.util
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.control import bayes_controller as jbc
from bayesian_cbf_tpu.experiments import pendulum as jp
from bayesian_cbf_tpu.experiments import unicycle as ju
from bayesian_cbf_tpu.models import dynamics as jd
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.control import bayes_controller as tbc
from bayesian_cbf_tpu_torch.experiments import pendulum as tp
from bayesian_cbf_tpu_torch.experiments import unicycle as tu
from bayesian_cbf_tpu_torch.models import dynamics as td
from bayesian_cbf_tpu_torch.sim.rollout import (RolloutOutputs,
                                                simulate_unicycle,
                                                simulate_unicycle_batch,
                                                simulate_unicycle_with_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
T, K = 40, 24
X_ATOL = 2e-3
U_REL = 1e-2
# the first 6 steps: roundoff amplified by the IPM's floor.  On seed 0 the
# learning runs' step-3 solve sits between two floors: a 3e-15 change of
# the start moves JAX's own episode by 7.8e-9 in X and 8.7e-7 relative in
# U there (1e-14 moves it by 6e-14 and 5e-12), so the bars sit at twice that
FIRST_X = 2e-8
FIRST_U = 2e-6
EXPERIMENTS = {
    "mean_cbf": "unicycle_mean_cbf_collides_obstacle",
    "bayes_cbf": "unicycle_bayes_cbf_safe_obstacle",
    "learning": "unicycle_learning_helps_avoid_getting_stuck",
    "no_learning": "unicycle_no_learning_gets_stuck",
}


def _small(name):
    """numSteps 40, dt 0.01, K 24, 10 Adam iterations, a refit every 15
    (the no-learning run keeps its refit every 2000: none falls in)."""
    kw = dict(numSteps=T, dt=0.01, max_train=K, training_iter=10)
    if name != "no_learning":
        kw["train_every_n_steps"] = 15
    return kw


def _key_chain_draws(lrn, key, steps):
    """The reservoir draws of `record`'s key chain from `key` (split,
    randint on [0, count_res], the reservoir's accept rule)."""
    cr, draws = 0, []
    for t in range(steps):
        key, kslot = jax.random.split(key)
        j = int(jax.random.randint(kslot, (), 0, max(cr + 1, 1)))
        draws.append(j)
        cr += int(t > 0 and (cr < lrn.max_train or j < lrn.max_train))
    return draws


def _jax_start(lrn, key, steps):
    """JAX's initial parameters (episode axis 1) and reservoir draws of
    one episode."""
    st = lrn.init_state(key, dtype=jnp.float64)
    params = {f: np.asarray(getattr(st.params, f))[None]
              for f in st.params._fields}
    return params, _key_chain_draws(lrn, st.key, steps)


def _u_rel(U, ref):
    return np.abs(U - ref).max(-1) / (1.0 + np.abs(ref).max(-1))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module", params=list(EXPERIMENTS))
def experiment(request):
    name = request.param
    jsim, jout = getattr(ju, EXPERIMENTS[name])(**_small(name))
    params, draws = _jax_start(jsim.learned_dynamics, jax.random.PRNGKey(0),
                               T)
    kw = dict(_small(name), device="cpu", dtype=F64)
    tsim = tu.make_ackermann_tracking_sim(**{**tu.EXPERIMENTS[name], **kw})
    state0 = interop.learned_state_from_numpy(tsim.learned_dynamics, params,
                                              "cpu", F64)
    sim, out = getattr(tu, EXPERIMENTS[name])(
        **kw, state0=state0, draws=torch.tensor(draws))
    return name, jsim, jout, sim, out, state0


def test_experiment_matches_jax(experiment):
    """Each README experiment through `simulate_unicycle` against JAX's
    `simulate_unicycle` from the same initial parameters and draws."""
    name, jsim, jout, sim, out, _ = experiment
    X, U = out.X.numpy(), out.U.numpy()
    Xw, Uw = np.asarray(jout.X), np.asarray(jout.U)
    assert X.shape == Xw.shape == (T, 3) and U.shape == Uw.shape == (T, 2)
    assert np.abs(X[:6] - Xw[:6]).max() < FIRST_X
    assert _u_rel(U[:6], Uw[:6]).max() < FIRST_U
    assert np.abs(X - Xw).max() < X_ATOL
    assert _u_rel(U, Uw).max() < U_REL
    np.testing.assert_array_equal(out.info.feasible.numpy(),
                                  np.asarray(jout.info.feasible) > 0.5)
    # the outcome functions take one episode's (T, n) outputs
    np.testing.assert_allclose(
        tu.min_obstacle_clearance(sim, out).numpy(),
        np.asarray(ju.min_obstacle_clearance(jsim, jout)), atol=X_ATOL)
    assert abs(float(tu.goal_distance(out))
               - float(ju.goal_distance(jout))) < X_ATOL


def test_realized_cbc_margins_match_jax(experiment):
    """The audit on JAX's own X and U, under the same initial state:
    relative 1e-9."""
    name, jsim, jout, sim, _, state0 = experiment
    want = np.asarray(ju.realized_cbc_margins(jsim, jout))
    same = RolloutOutputs(X=torch.tensor(np.asarray(jout.X)),
                          U=torch.tensor(np.asarray(jout.U)), Xdot=None,
                          info=None)
    got = tu.realized_cbc_margins(sim, same, state0=state0)
    assert got.shape == want.shape == (T, 2)
    assert _rel(got.numpy(), want) < 1e-9
    if not sim.learned_dynamics.enable_learning:
        # without learning the state does not enter: the seed's is as good
        assert _rel(tu.realized_cbc_margins(sim, same).numpy(), want) < 1e-9


def test_chance_constraint_margins_match_jax(experiment):
    """The batched margins against JAX's vmapped function on one (x, u, t)
    batch: relative 1e-10, the CLC row included."""
    name, jsim, jout, sim, _, state0 = experiment
    X, U = np.asarray(jout.X), np.asarray(jout.U)
    ts = np.arange(T)
    jlrn = jsim.learned_dynamics
    jstate = jlrn.init_state(jax.random.PRNGKey(0), dtype=jnp.float64)

    def one(x, u, t):
        mom = jlrn.moments(jstate, x)
        return jbc.chance_constraint_margins(jsim.controller, jsim.clf,
                                             jsim.cbfs, jsim.planner, mom,
                                             x, t, u)

    want = np.asarray(jax.vmap(one)(jnp.asarray(X), jnp.asarray(U),
                                    jnp.asarray(ts)))
    lrn = sim.learned_dynamics
    Xt = torch.tensor(X)
    state = td._map(lambda a: a.expand((T,) + a.shape[1:]), state0)
    got = tbc.chance_constraint_margins(
        sim.controller, sim.clf, sim.cbfs, sim.planner,
        lrn.moments(state, Xt), Xt, torch.arange(T), torch.tensor(U))
    assert got.shape == want.shape == (T, 3)
    assert _rel(got.numpy(), want) < 1e-10
    # a step index as an int gives the rows of that step
    t = 17
    one_step = tbc.chance_constraint_margins(
        sim.controller, sim.clf, sim.cbfs, sim.planner,
        lrn.moments(state, Xt), Xt, t, torch.tensor(U))
    assert _rel(one_step[t].numpy(), want[t]) < 1e-10


def test_mean_cbf_emits_half_spaces():
    """max_risk 0.4999 takes the mean-only branch: the CLC and both CBCs
    are 1-dimensional cones beside the objective's, dims (4, 1, 1, 1),
    and the controller solves them cold."""
    sim = tu.make_ackermann_tracking_sim(**tu.EXPERIMENTS["mean_cbf"],
                                         device="cpu", dtype=F64)
    assert sim.controller.rho < 1e-3
    x = torch.tensor([tu.STATE_START], dtype=F64)
    mom = sim.learned_dynamics.moments(None, x)
    *_, dims, _ = tbc.controller_socp(sim.controller, sim.clf, sim.cbfs,
                                      sim.planner, mom, x, 0)
    assert dims == (4, 1, 1, 1)
    assert tbc.warm_cone_count(sim.controller, len(sim.cbfs)) == 4
    assert jbc.warm_cone_count(None, 2) == 4


def test_single_episode_is_the_batch_runner_at_one():
    """`simulate_unicycle` is `simulate_unicycle_batch` at B = 1 without
    the batch axis, and `simulate_unicycle_with_state` returns the final
    learner state that the same loop ends in."""
    kw = dict(_small("learning"), device="cpu", dtype=F64)
    sim = tu.make_ackermann_tracking_sim(**kw)
    gen = lambda: torch.Generator().manual_seed(3)
    batch = simulate_unicycle_batch(
        sim, torch.tensor([tu.STATE_START], dtype=F64), generator=gen())
    one = simulate_unicycle(sim, tu.STATE_START, generator=gen())
    out, state = simulate_unicycle_with_state(sim, tu.STATE_START,
                                              generator=gen())
    for a, b, c in ((batch.X[0], one.X, out.X), (batch.U[0], one.U, out.U),
                    (batch.info.feasible[0], one.info.feasible,
                     out.info.feasible),
                    (batch.knl.lengthscale[0], one.knl.lengthscale,
                     out.knl.lengthscale)):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert int(state.count_pairs[0]) == T


def test_single_episode_fit_schedule():
    """JAX's single-episode schedule: a fit after every step t > 0 with
    t % train_every_n_steps == 0, the first by `fit_now_first`, later ones
    by `fit_now_warm`: the hyperparameters that the steps see change
    exactly at t = 16 and 31, and the second fit runs the warm budget."""
    kw = dict(_small("learning"), device="cpu", dtype=F64,
              training_iter_warm=3)
    sim = tu.make_ackermann_tracking_sim(**kw)
    lrn = sim.learned_dynamics
    calls = []
    fits = {name: getattr(lrn, name)
            for name in ("fit_now_first", "fit_now_warm")}

    class Learner(type(lrn)):
        def fit_now_first(self, state):
            calls.append("first")
            return fits["fit_now_first"](state)

        def fit_now_warm(self, state):
            calls.append("warm")
            return fits["fit_now_warm"](state)

    sim = sim._replace(learned_dynamics=Learner(*lrn))
    out = simulate_unicycle(sim, tu.STATE_START,
                            generator=torch.Generator().manual_seed(0))
    ls = out.knl.lengthscale
    moved = [t for t in range(1, T) if not torch.equal(ls[t], ls[t - 1])]
    assert moved == [16, 31]
    assert calls == ["first", "warm"]


def _pendulum_randoms(lrn, steps, seed=0):
    """JAX's single-episode random numbers: `kd, ks = split(PRNGKey(seed))`,
    the initial parameters and reservoir draws from `init_state(kd)`, and
    one exploration uniform per step from the chain `key, ke = split(key)`
    from ks."""
    kd, ks = jax.random.split(jax.random.PRNGKey(seed))
    params, draws = _jax_start(lrn, kd, steps)
    key, noise = ks, []
    for _ in range(steps):
        key, ke = jax.random.split(key)
        noise.append(np.asarray(jax.random.uniform(ke, (1,), jnp.float64)))
    return params, draws, np.array(noise)


def test_pendulum_single_episode_matches_jax():
    """`run_pendulum_online_learning` against JAX's at T 30, K 12, a refit
    every 10, with the single-episode key chains."""
    steps = 30
    kw = dict(numSteps=steps, max_train=12, training_iter=10)
    jsim = jp.make_pendulum_online_sim(**kw)
    X, U, _, info = jp.run_pendulum_online_learning(jsim)
    params, draws, noise = _pendulum_randoms(jsim.learned, steps)
    sim = tp.make_pendulum_online_sim(**kw, device="cpu", dtype=F64)
    state0 = interop.learned_state_from_numpy(sim.learned, params, "cpu",
                                              F64)
    out = tp.run_pendulum_online_learning(
        sim, state0=state0, draws=torch.tensor(draws),
        noise=torch.tensor(noise))
    Xw, Uw = np.asarray(X), np.asarray(U)
    assert out.X.shape == (steps, 2) and out.U.shape == (steps, 1)
    first = sim.learned.train_every_n_steps + 1
    Xp, Up = out.X.numpy(), out.U.numpy()
    assert np.abs(Xp[:first] - Xw[:first]).max() < 1e-4
    assert np.abs(Xp - Xw).max() < X_ATOL
    assert _u_rel(Up, Uw).max() < U_REL
    for field in ("feasible", "certified"):
        np.testing.assert_array_equal(
            getattr(out.info, field).numpy()[:first],
            np.asarray(info[field])[:first])
    assert float(tp.pendulum_damage_fraction(out.X[:, 0])) == 0.0


@pytest.mark.parametrize("model", ["ackermann", "pendulum", "zero"])
def test_moment_derivatives_without_learning_match_jax(model):
    """The mean dynamics' F and Jacobian, Bk = I, zero D1 and D2,
    A = diag(kernel_diag_A or 1), against JAX's (jacfwd of F): 1e-12."""
    from bayesian_cbf_tpu.models.mvgp import make_mvgp as jmake
    from bayesian_cbf_tpu_torch.models.mvgp import make_mvgp as tmake
    n, m = (3, 2) if model != "pendulum" else (2, 1)
    jmean, tmean = {
        "ackermann": (jd.AckermannDrive(L=1.0, kernel_diag_A=(1e-2, 2e-2,
                                                              3e-2)),
                      td.AckermannDrive(L=1.0, kernel_diag_A=(1e-2, 2e-2,
                                                              3e-2))),
        "pendulum": (jd.PendulumDynamics(), td.PendulumDynamics()),
        "zero": (jd.ZeroDynamics(state_size=3, ctrl_size=2),
                 td.ZeroDynamics(state_size=3, ctrl_size=2)),
    }[model]
    common = dict(max_train=8, enable_learning=False, shift_invariant=False)
    jlrn = jd.LearnedShiftInvariantDynamics(gp=jmake(n, m),
                                            mean_dynamics=jmean, **common)
    tlrn = td.LearnedShiftInvariantDynamics(gp=tmake(n, m),
                                            mean_dynamics=tmean, **common)
    x = np.random.default_rng(0).normal(size=(5, n))
    jstate = jlrn.init_state(jax.random.PRNGKey(0), dtype=jnp.float64)
    want = jax.vmap(lambda xx: jlrn.moment_derivatives(jstate, xx))(
        jnp.asarray(x))
    got = tlrn.moment_derivatives(None, torch.tensor(x))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def test_sample_iid_pendulum_matches_jax():
    """Given JAX's uniforms: the same X and U to a few ulps (XLA fuses
    the scaling into one multiply-add), the exact xdot to 1e-12; from a
    generator, the shapes and ranges."""
    n = 50
    key = jax.random.PRNGKey(4)
    Xw, Uw, Xdw = jp.sample_iid_pendulum(key, n)
    uni = np.stack([np.asarray(jax.random.uniform(k, (n,), jnp.float64))
                    for k in jax.random.split(key, 3)], -1)
    X, U, Xdot = tp.sample_iid_pendulum(None, n, uniforms=torch.tensor(uni))
    np.testing.assert_allclose(X.numpy(), np.asarray(Xw), rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_allclose(U.numpy(), np.asarray(Uw), rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_allclose(Xdot.numpy(), np.asarray(Xdw), rtol=1e-12,
                               atol=1e-12)
    X, U, Xdot = tp.sample_iid_pendulum(torch.Generator().manual_seed(0),
                                        n, dtype=F64)
    assert X.shape == (n, 2) and U.shape == (n, 1) and Xdot.shape == (n, 2)
    assert float(X[:, 0].abs().max()) <= math.pi
    assert float(X[:, 1].abs().max()) <= 3.0
    assert float(U.abs().max()) <= 10.0


def test_sample_pendulum_data_matches_jax():
    """Given JAX's uniforms (one per step from the chain `key, ku =
    split(key)`): the rollout's X, U and exact xdot to 1e-12."""
    steps = 60
    Xw, Uw, Xdw = jp.sample_pendulum_data(numSteps=steps, seed=2)
    key, uni = jax.random.PRNGKey(2), []
    for _ in range(steps):
        key, ku = jax.random.split(key)
        uni.append(float(jax.random.uniform(ku, (), jnp.float64)))
    X, U, Xdot = tp.sample_pendulum_data(numSteps=steps,
                                         uniforms=torch.tensor(uni, dtype=F64))
    assert X.shape == (steps, 2) and U.shape == (steps, 1)
    for got, want in ((X, Xw), (U, Uw), (Xdot, Xdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
    X, U, Xdot = tp.sample_pendulum_data(numSteps=5, device="cpu", dtype=F64)
    assert X.shape == (5, 2) and U.dtype == F64


def test_variance_weighted_error_matches_jax():
    rng = np.random.default_rng(5)
    N, D = 7, 6
    A = rng.normal(size=(N, D, D))
    var = A @ A.transpose(0, 2, 1) + D * np.eye(D)
    mean, true = rng.normal(size=N * D), rng.normal(size=(N, D))
    want = float(jp.variance_weighted_error(jnp.asarray(mean),
                                            jnp.asarray(var),
                                            jnp.asarray(true)))
    got = float(tp.variance_weighted_error(torch.tensor(mean),
                                           torch.tensor(var),
                                           torch.tensor(true)))
    assert abs(got - want) < 1e-12 * abs(want)


def _gate():
    spec = importlib.util.spec_from_file_location(
        "check_outcomes_torch",
        os.path.join(REPO, "scripts", "check_outcomes_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _passing():
    """Results on which every verdict holds."""
    edge = math.pi / 4 + math.pi / 8
    return {
        "mean_cbf": dict(min_clearance=-0.25, goal_dist=0.4, feasible=1.0),
        "bayes_cbf": dict(min_clearance=0.33, goal_dist=0.5, feasible=1.0,
                          min_feasible_cbc_margin=0.0, cbc_margin_scale=1.0),
        "learning": dict(min_clearance=0.2, goal_dist=0.5, feasible=1.0),
        "no_learning": dict(min_clearance=0.9, goal_dist=3.2, feasible=1.0),
        "batched_learning": dict(B=32, finite=True, min_clearance=0.1,
                                 mean_goal_distance=0.5, frac_within_1=1.0,
                                 feasible=1.0),
        "pendulum_online": dict(damage=0.0, wedge_frac=0.0, theta_end=1.5,
                                feasible=1.0, certified=0.5, finite=True),
        "pendulum_batched": dict(B=64, finite=True, certified=0.7,
                                 feasible=0.99, mean_damage=0.0,
                                 frac_damaged=0.0, frac_wedge_gt_2pct=0.0,
                                 min_final_theta=edge + 0.1),
        "pendulum_batched_cu": dict(B=64, finite=True, certified=0.04,
                                    feasible=0.99, mean_damage=0.0,
                                    frac_damaged=0.0, frac_wedge_gt_2pct=0.0,
                                    min_final_theta=edge + 0.1),
        "pendulum_ground_truth": dict(damage=0.0, wedge_frac=0.0,
                                      theta_end=1.28, max_pres=3e-7),
    }


EDGE = math.pi / 4 + math.pi / 8
# (verdict, run, result, a value on the passing side of the threshold, the
# threshold's own value or a value past it)
EDGES = [
    ("collides", "mean_cbf", "min_clearance", -1e-9, 0.0),
    ("safe", "bayes_cbf", "min_clearance", 1e-9, 0.0),
    ("feasible_steps_respect_cbc", "bayes_cbf", "min_feasible_cbc_margin",
     -0.0099, -0.01),
    ("learning_passes", "learning", "goal_dist", 1.4999, 1.5),
    ("learning_passes", "no_learning", "goal_dist", 1.5001, 1.5),
    ("no_learning_stuck", "no_learning", "goal_dist", 2.5001, 2.5),
    ("batched_learning_passes", "batched_learning", "mean_goal_distance",
     1.4999, 1.5),
    ("batched_learning_passes", "batched_learning", "frac_within_1",
     0.7001, 0.7),
    ("batched_learning_passes", "batched_learning", "min_clearance",
     1e-9, 0.0),
    ("batched_learning_passes", "batched_learning", "finite", True, False),
    ("pendulum_online_no_damage", "pendulum_online", "damage", 0.0, 1e-9),
    ("pendulum_online_no_damage", "pendulum_online", "wedge_frac", 0.02,
     0.0201),
    ("pendulum_online_no_damage", "pendulum_online", "theta_end",
     EDGE - 0.0199, EDGE - 0.02),
    ("pendulum_online_no_damage", "pendulum_online", "theta_end", 1.8999,
     1.9),
    ("pendulum_online_no_damage", "pendulum_online", "finite", True, False),
    ("pendulum_batched_safe", "pendulum_batched", "mean_damage", 0.01,
     0.0101),
    ("pendulum_batched_safe", "pendulum_batched", "frac_damaged", 0.05,
     0.0501),
    ("pendulum_batched_safe", "pendulum_batched", "frac_wedge_gt_2pct",
     0.05, 0.0501),
    ("pendulum_batched_cu_safe", "pendulum_batched_cu", "feasible", 0.95,
     0.9499),
    ("pendulum_batched_cu_safe", "pendulum_batched_cu", "min_final_theta",
     EDGE + 1e-9, EDGE),
    ("pendulum_batched_cu_safe", "pendulum_batched_cu", "mean_damage", 0.01,
     0.0101),
    ("pendulum_gt_safe", "pendulum_ground_truth", "wedge_frac", 0.0,
     0.0025),
    ("pendulum_gt_safe", "pendulum_ground_truth", "damage", 0.0, 0.0025),
    ("pendulum_gt_safe", "pendulum_ground_truth", "max_pres", 0.99e-4,
     1e-4),
    ("pendulum_gt_safe", "pendulum_ground_truth", "theta_end",
     EDGE - 0.0499, EDGE - 0.05),
    ("pendulum_gt_safe", "pendulum_ground_truth", "theta_end", 1.4499, 1.45),
    ("feasibility_floor", "bayes_cbf", "feasible", 0.95, 0.9499),
    ("feasibility_floor", "learning", "feasible", 0.95, 0.9499),
    ("feasibility_floor", "pendulum_online", "feasible", 0.95, 0.9499),
    ("feasibility_floor", "pendulum_batched", "feasible", 0.95, 0.9499),
]


@pytest.mark.parametrize("verdict,run,field,good,bad", EDGES)
def test_verdict_threshold_edge(verdict, run, field, good, bad):
    gate = _gate()
    res = _passing()
    assert all(gate.verdicts(res).values())
    res[run][field] = good
    assert gate.verdicts(res)[verdict] is True
    res[run][field] = bad
    got = gate.verdicts(res)
    assert got[verdict] is False
    # the verdicts that do not read this run are untouched
    reads = {name: needs for name, needs, _ in gate.VERDICTS}
    assert all(v for k, v in got.items() if run not in reads[k])


def test_verdict_set_and_not_ported():
    """Every verdict of scripts/check_outcomes.py but kernel_parity (the
    card run of chip_smoke.py holds the kernels); none is left unported,
    so all of them count toward all_pass; a verdict is decided only when
    its results are all present."""
    gate = _gate()
    names = {"collides", "safe", "feasible_steps_respect_cbc",
             "learning_passes", "no_learning_stuck", "batched_learning_passes",
             "pendulum_online_no_damage", "pendulum_gt_safe",
             "pendulum_batched_safe", "pendulum_batched_cu_safe",
             "feasibility_floor"}
    assert set(gate.verdicts(_passing())) == names
    assert len(gate.VERDICTS) == len(names)
    assert not hasattr(gate, "NOT_PORTED")
    assert set(gate.verdicts({"pendulum_ground_truth": _passing()[
        "pendulum_ground_truth"]})) == {"pendulum_gt_safe"}
    single = {k: v for k, v in _passing().items()
              if k in ("mean_cbf", "bayes_cbf", "learning", "no_learning",
                       "pendulum_online")}
    assert set(gate.verdicts(single)) == {
        "collides", "safe", "feasible_steps_respect_cbc", "learning_passes",
        "no_learning_stuck", "pendulum_online_no_damage"}


def test_check_outcomes_refuses_cpu():
    """Without a card the gate exits non-zero and prints no result."""
    code = ("import runpy, torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['scripts/check_outcomes_torch.py']\n"
            "runpy.run_path('scripts/check_outcomes_torch.py', "
            "run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"verdicts"' not in res.stdout
    assert "CUDA is not available" in res.stderr


def test_pendulum_prerefit_run_moves_only_its_own_terms():
    """`pendulum_prerefit_run` (the witnesses of chip_smoke.py phase 10)
    runs the pendulum episode's steps before its first refit; with delta
    it moves the closed form's CBC2 terms by about delta for that run
    only: the episode's u moves, the module's function is restored, and
    an unmoved run afterwards repeats the first.  Its term helper gives
    the episode's own CBC2 means at u0 (to roundoff: a batch of all the
    states against one state a step) and a GP path at the closed form's
    roundoff."""
    from bayesian_cbf_tpu_torch.control import learned_socp_controller as lsc
    co = _gate()
    terms = lsc.cbc2_closed_form_terms
    sim, base = co.pendulum_prerefit_run("cpu", dtype=torch.float64)
    assert base.U.shape == (sim.learned.train_every_n_steps + 1, 1)
    _, moved = co.pendulum_prerefit_run("cpu", dtype=torch.float64,
                                        delta=1e-3, seed=1)
    assert lsc.cbc2_closed_form_terms is terms
    assert float((moved.U - base.U).abs().max()) > 1e-6
    _, again = co.pendulum_prerefit_run("cpu", dtype=torch.float64)
    assert torch.equal(again.U, base.U)
    gp, closed, ref = co.pendulum_prerefit_terms(sim, base.X)
    np.testing.assert_allclose(closed[2].numpy(),
                               base.info.cbc_mean[:, 0].numpy(), rtol=1e-14)
    assert float(co.cbc2_term_distance(gp, ref).max()) < 1e-12
