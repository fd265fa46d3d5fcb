"""Parity of the port's car slice against the JAX package on the CPU,
f64: f, g and step of the second-order unicycle and the Hyundai Genesis
model, the circular-obstacle CBC's A and b, the ground-truth CBC QP's
150-step episode through the plain IPM at (3, 5, 4), `car_learn_dynamics`
on JAX's data and initial weights, and the racecar environment.
Inputs come from numpy with a seed.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.experiments import car as jx
from bayesian_cbf_tpu.models import car as jc
from bayesian_cbf_tpu.models.mvgp import make_mvgp_rank1 as j_rank1
from bayesian_cbf_tpu.models.racecar import RacecarDynamics as JRacecar
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.experiments import car as tx
from bayesian_cbf_tpu_torch.models import car as tc
from bayesian_cbf_tpu_torch.models.racecar import (RacecarDynamics,
                                                   RacecarEnv)
from bayesian_cbf_tpu_torch.solvers.socp import _pad_cones

F64 = torch.float64
# the models are the same expressions: roundoff only
MODEL_TOL = 1e-12


def _rows(fn, X, *rest):
    """A JAX single-state function over the rows of X (and of rest), as
    one jitted vmap."""
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(X),
                                           *map(jnp.asarray, rest)))


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(0)
    X6 = rng.normal(size=(16, 6))
    X9 = rng.normal(size=(16, 9))
    # half of the Genesis states roll faster than 1 m/s (tire forces on)
    X9[:, 3] = rng.uniform(-5.0, 5.0, 16)
    return X6, rng.normal(size=(16, 2)), X9, rng.normal(size=(16, 3))


def test_second_order_unicycle_matches_jax(states):
    X, U, _, _ = states
    jm, tm = jc.SecondOrderUnicycle(), tc.SecondOrderUnicycle()
    Xt, Ut = torch.tensor(X), torch.tensor(U)
    np.testing.assert_allclose(tm.f_func(Xt).numpy(), _rows(jm.f_func, X),
                               atol=MODEL_TOL)
    np.testing.assert_allclose(tm.g_func(Xt).numpy(), _rows(jm.g_func, X),
                               atol=MODEL_TOL)
    Xn, xdot = tm.step(Xt, Ut, 0.01)
    np.testing.assert_allclose(
        Xn.numpy(), _rows(lambda x, u: jm.step(x, u, 0.01)[0], X, U),
        atol=MODEL_TOL)
    np.testing.assert_allclose(
        xdot.numpy(), _rows(lambda x, u: jm.step(x, u, 0.01)[1], X, U),
        atol=MODEL_TOL)


def test_genesis_matches_jax(states):
    """f, g (tire forces on and off), and a step with the control delay
    and ten sub-steps."""
    _, _, X, U = states
    jm, tm = jc.HyundaiGenesisDynamics(), tc.HyundaiGenesisDynamics()
    Xt, Ut = torch.tensor(X), torch.tensor(U)
    np.testing.assert_allclose(tm.f_func(Xt).numpy(), _rows(jm.f_func, X),
                               atol=MODEL_TOL)
    np.testing.assert_allclose(tm.g_func(Xt).numpy(), _rows(jm.g_func, X),
                               atol=MODEL_TOL)
    Xn, xdot = tm.step(Xt, Ut)
    np.testing.assert_allclose(Xn.numpy(),
                               _rows(lambda x, u: jm.step(x, u)[0], X, U),
                               atol=MODEL_TOL)
    np.testing.assert_allclose(xdot.numpy(),
                               _rows(lambda x, u: jm.step(x, u)[1], X, U),
                               atol=1e-10)
    x0 = tm.init_state(2, "cpu", F64)
    np.testing.assert_array_equal(x0.numpy(),
                                  np.stack([np.asarray(jm.init_state())] * 2))


@pytest.mark.parametrize("model", ["unicycle", "genesis"])
def test_circular_cbc_matches_jax(states, model):
    """A (-L_g L_f h) and b (L_f^2 h + k . (h, L_f h)) through
    torch.func.grad against jax.grad, on each car model."""
    X6, _, X9, _ = states
    if model == "unicycle":
        X, jm, tm, idx = X6, jc.SecondOrderUnicycle(), \
            tc.SecondOrderUnicycle(), (3, 4)
    else:
        X, jm, tm, idx = X9, jc.HyundaiGenesisDynamics(), \
            tc.HyundaiGenesisDynamics(), (0, 1)
    jcb = jc.CircularObstacleCBC(center=jnp.array([1.0, -1.0]), radius=0.8,
                                 pos_idx=idx)
    tcb = tc.CircularObstacleCBC(center=torch.tensor([1.0, -1.0],
                                                     dtype=F64),
                                 radius=0.8, pos_idx=idx)
    Xt = torch.tensor(X)
    A, b = tcb.A_b(tm, Xt)
    A_want = _rows(lambda x: jcb.A(jm, x), X)
    b_want = _rows(lambda x: jcb.b(jm, x), X)
    scale = 1.0 + np.abs(b_want).max()
    np.testing.assert_allclose(A.numpy(), A_want, atol=MODEL_TOL * scale)
    np.testing.assert_allclose(b.numpy(), b_want, atol=MODEL_TOL * scale)
    np.testing.assert_allclose(tcb.A(tm, Xt).numpy(), A.numpy(), atol=0)
    np.testing.assert_allclose(tcb.lie_g_lie_f(tm, Xt).numpy(),
                               -A.numpy(), atol=0)
    # relative degree 2 on the unicycle: L_g h = 0
    if model == "unicycle":
        Lg_h = (tcb.grad_cbf(Xt)[:, None] @ tm.g_func(Xt))[:, 0]
        assert float(Lg_h.abs().max()) == 0.0


def test_car_qp_cones_are_354():
    """The ground-truth QP's cones pad to the IPM shape (3, 5, 4)."""
    cbcs = tx.car_obstacles(device="cpu", dtype=F64)
    x = torch.tensor([tx.CAR_START] * 3, dtype=F64)
    cobj, G, h, dims = tx.car_ground_truth_socp(
        x, cbcs, torch.zeros(2, dtype=F64))
    Gp, hp = _pad_cones(G, h, dims)
    assert dims == (4, 1, 1, 1, 1)
    assert tuple(Gp.shape) == (3, 5, 4, 3) and tuple(hp.shape) == (3, 5, 4)


@pytest.fixture(scope="module")
def ground_truth():
    jout = jx.run_car_control_ground_truth(numSteps=150, dt=0.02)
    tout = tx.run_car_control_ground_truth(numSteps=150, dt=0.02,
                                           device="cpu", dtype=F64)
    return jout, tout


def test_car_ground_truth_matches_jax(ground_truth):
    """150 steps at dt 0.02 (JAX's test), through the plain IPM at
    (3, 5, 4).  Measured: 7.3e-10 in X and 1.0e-8 in U at most; the bars
    are 100 times that."""
    (jcbcs, Xj, Uj, pj), (tcbcs, X, U, pres) = ground_truth
    assert X.shape == (150, 6) and U.shape == (150, 2) and pres.shape == (150,)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(U.numpy(), np.asarray(Uj), rtol=0, atol=1e-6)
    clear = tx.min_car_clearance(tcbcs, X)
    np.testing.assert_allclose(clear.numpy(),
                               np.asarray(jx.min_car_clearance(jcbcs, Xj)),
                               atol=1e-7)
    # JAX's own assertions
    assert bool(torch.isfinite(X).all())
    assert float(clear.min()) > -0.05


def test_car_learn_dynamics_matches_jax():
    """JAX's data (its uniforms passed as draws) and initial weights,
    K = 24, 8 Adam iterations (JAX's test size): the fitted parameters, the
    posterior cache and the held-out RMSE.  Measured: parameters within
    9e-10, RMSE within 6e-14; the bars are 100 times that."""
    X, U, Xdot = jx.sample_car_data(jax.random.PRNGKey(0))
    U = np.asarray(U)
    draws = np.stack([U[:, 0], (U[:, 1] + math.pi) / (2 * math.pi)], -1)
    jgp = j_rank1(6, 2)
    p0 = jgp.init_params(jax.random.PRNGKey(0))
    data = jgp.make_data(X[:24], U[:24], Xdot[:24])
    params = jax.jit(lambda p, d: jgp.fit(p, d, training_iter=8))(p0, data)
    cache = jax.jit(jgp.refresh_cache)(params, data)
    pred = jax.jit(jax.vmap(lambda x, u: jgp.fu_mean(params, data, cache,
                                                     u, x)))(
        X[24:124], U[24:124])
    rmse = float(jnp.sqrt(jnp.mean((pred - Xdot[24:124]) ** 2)))

    start = interop.mvgp_params_from_numpy(
        {f: np.asarray(getattr(p0, f))[None] for f in p0._fields}, "cpu",
        F64)
    gp, tparams, tdata, tcache, trmse = tx.car_learn_dynamics(
        max_train=24, training_iter=8, device="cpu", dtype=F64,
        draws=torch.tensor(draws), params=start)
    np.testing.assert_allclose(tdata.X[0].numpy(), np.asarray(X[:24]),
                               atol=1e-14)
    for f in params._fields:
        np.testing.assert_allclose(getattr(tparams, f)[0].numpy(),
                                   np.asarray(getattr(params, f)),
                                   rtol=0, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(tcache.alpha[0].numpy(),
                               np.asarray(cache.alpha), rtol=1e-6,
                               atol=1e-6)
    assert abs(trmse - rmse) < 1e-11
    assert np.isfinite(trmse) and trmse < 5.0


def test_sample_car_data_shapes_and_generator():
    X, U, Xdot = tx.sample_car_data(
        torch.Generator().manual_seed(0), numSteps=60, device="cpu",
        dtype=F64)
    assert X.shape == (60, 6) and U.shape == (60, 2) and Xdot.shape == (60, 6)
    assert float(U[:, 0].min()) >= 0.0 and float(U[:, 0].max()) < 1.0
    assert float(U[:, 1].abs().max()) <= math.pi
    # x_{t+1} = x_t + dt xdot_t
    np.testing.assert_allclose(X[1:].numpy(),
                               (X[:-1] + 0.01 * Xdot[:-1]).numpy(),
                               atol=1e-14)


def test_racecar_matches_jax():
    """The functional core against JAX's over 50 steps, and the
    environment's surface (JAX's test: throttle advances x, steering
    turns the car)."""
    jd, td = JRacecar(), RacecarDynamics()
    rng = np.random.default_rng(3)
    acts = rng.uniform(-1.2, 1.2, size=(50, 2))
    js = jd.init_state(jnp.array([0.1, -0.2, 0.3]))
    ts = td.init_state(torch.tensor([[0.1, -0.2, 0.3]], dtype=F64))
    jstep = jax.jit(lambda s, a: jd.step(s, a, 0.01))
    for a in acts:
        js, jxd = jstep(js, jnp.asarray(a))
        ts, txd = td.step(ts, torch.tensor(a[None]), 0.01)
        np.testing.assert_allclose(ts.pose[0].numpy(), np.asarray(js.pose),
                                   atol=MODEL_TOL)
        np.testing.assert_allclose(txd[0].numpy(), np.asarray(jxd),
                                   atol=1e-10)
    env = RacecarEnv(obstacle_centers=[(2.0, 0.0)], obstacle_radii=[0.5],
                     device="cpu", dtype=F64)
    assert env.state_size == 3 and env.ctrl_size == 2
    env.set_init_state([0.0, 0.0, 0.0])
    for _ in range(100):
        obs = env.step([1.0, 0.0], 0.01)
    x = obs["x"].numpy()
    assert x[0] > 0.5 and abs(x[1]) < 1e-6 and abs(x[2]) < 1e-6
    assert float(obs["xdot"][0]) <= env.dynamics.max_speed
    env.set_init_state([0.0, 0.0, 0.0])
    for _ in range(150):
        obs = env.step([0.6, 0.8], 0.01)
    assert abs(float(obs["x"][2])) > 0.3
