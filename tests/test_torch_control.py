"""Control-layer parity of the PyTorch port against the JAX package on
CPU, f64: small linear algebra, CLF/CBF values and gradients (against
`jax.grad`), the planner, the SOCP solver on the stored oracle, and the
Bayesian CLF controller (against a `vmap` of the JAX controller)."""
import math
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.control import bayes_controller as jbc
from bayesian_cbf_tpu.control import clf_cbf as jcc
from bayesian_cbf_tpu.control.planner import PiecewiseLinearPlanner as JPlan
from bayesian_cbf_tpu.utils import func as jfunc
from bayesian_cbf_tpu.utils import linalg as jla
from bayesian_cbf_tpu_torch.control import bayes_controller as tbc
from bayesian_cbf_tpu_torch.control import clf_cbf as tcc
from bayesian_cbf_tpu_torch.control.planner import PiecewiseLinearPlanner
from bayesian_cbf_tpu_torch.solvers.socp import solve_socp
from bayesian_cbf_tpu_torch.utils import func as tfunc
from bayesian_cbf_tpu_torch.utils import linalg as tla

START = np.array([-3.0, -1.0, -math.pi / 4])
GOAL = np.array([0.0, 0.0, math.pi / 4])


def _states(seed, B=6):
    rng = np.random.default_rng(seed)
    return START + rng.uniform(0.0, 1.0, size=(B, 1)) * (GOAL - START) \
        + 0.3 * rng.normal(size=(B, 3))


# ---- utils ----------------------------------------------------------------

def test_small_linalg_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 3, 3))
    K = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)
    K[0] = np.diag([1.0, 0.0, -1e-9])          # exercises the ladder rungs
    Bm = rng.normal(size=(5, 3, 2))
    Kt = torch.tensor(K)
    for got, want in (
            (tla.chol_small_unrolled(Kt), jax.vmap(jla.chol_small_unrolled)(K)),
            (tla.chol_small_unrolled(Kt, jitter=1e-3),
             jax.vmap(lambda k: jla.chol_small_unrolled(k, 1e-3))(K)),
            (tla.psd_chol_small_ladder(Kt, init_jitter=1e-10),
             jax.vmap(lambda k: jla.psd_chol_small_ladder(k, 1e-10))(K)),
            (tla.kron(Kt, torch.tensor(Bm)), jax.vmap(jla.kron)(K, Bm))):
        # f64, identical scalar arithmetic
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-14)
    L = tla.chol_small_unrolled(Kt[1:])
    np.testing.assert_allclose(
        tla.cho_solve_small_unrolled(L, torch.tensor(Bm[1:])).numpy(),
        np.asarray(jax.vmap(jla.cho_solve_small_unrolled)(
            jnp.asarray(L.numpy()), Bm[1:])), rtol=1e-12, atol=1e-14)


def test_normalize_radians_matches_jax():
    th = np.linspace(-10.0, 10.0, 41)
    np.testing.assert_allclose(tfunc.normalize_radians(torch.tensor(th)).numpy(),
                               np.asarray(jfunc.normalize_radians(th)),
                               rtol=0, atol=1e-15)


# ---- CLF / CBF --------------------------------------------------------------

def test_clf_value_and_gradients_match_jax_grad():
    x = _states(1)
    goal = np.stack([GOAL + 0.1 * i for i in range(x.shape[0])])
    jclf, tclf = jcc.CLFCartesian(Kp=(0.9, 1.5, 0.7)), tcc.CLFCartesian(
        Kp=(0.9, 1.5, 0.7))
    xt, gt = torch.tensor(x), torch.tensor(goal)
    # closed-form gradients vs autodiff in f64: roundoff-level agreement
    np.testing.assert_allclose(tclf.clf(xt, gt).numpy(),
                               np.asarray(jax.vmap(jclf.clf)(x, goal)),
                               rtol=1e-12)
    np.testing.assert_allclose(tclf.grad_clf(xt, gt).numpy(),
                               np.asarray(jax.vmap(jclf.grad_clf)(x, goal)),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        tclf.grad_clf_wrt_goal(xt, gt).numpy(),
        np.asarray(jax.vmap(jclf.grad_clf_wrt_goal)(x, goal)),
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        tcc.cartesian2polar(xt, gt).numpy(),
        np.asarray(jax.vmap(jcc.cartesian2polar)(x, goal)), rtol=1e-12,
        atol=1e-14)


def test_cbf_value_and_gradient_match_jax_grad():
    x = _states(2)
    jobs = jcc.obstacles_at_mid_from_start_and_goal(
        jnp.asarray(START), jnp.asarray(GOAL), term_weights=(0.7, 0.3))
    tobs = tcc.obstacles_at_mid_from_start_and_goal(
        torch.tensor(START), torch.tensor(GOAL), term_weights=(0.7, 0.3))
    xt = torch.tensor(x)
    for jo, to in zip(jobs, tobs):
        np.testing.assert_allclose(to.center.numpy(), np.asarray(jo.center),
                                   rtol=1e-15)
        assert to.radius == pytest.approx(float(jo.radius), rel=1e-15)
        np.testing.assert_allclose(to.cbf(xt).numpy(),
                                   np.asarray(jax.vmap(jo.cbf)(x)), rtol=1e-12)
        np.testing.assert_allclose(to.grad_cbf(xt).numpy(),
                                   np.asarray(jax.vmap(jo.grad_cbf)(x)),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("t", [0, 5, 1699, 1700, 1899, 1999])
def test_planner_matches_jax(t):
    jp = JPlan.create(jnp.asarray(START), jnp.asarray(GOAL), 2000, 0.001,
                      frac_time_to_reach_goal=0.95)
    tp = PiecewiseLinearPlanner.create(torch.tensor(START), torch.tensor(GOAL),
                                       2000, 0.001,
                                       frac_time_to_reach_goal=0.95)
    np.testing.assert_allclose(tp.plan(t).numpy(), np.asarray(jp.plan(t)),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(tp.dot_plan(t).numpy(),
                               np.asarray(jp.dot_plan(t)), rtol=1e-13,
                               atol=1e-15)


# ---- SOCP -------------------------------------------------------------------

def test_solve_socp_matches_stored_oracle():
    """The 12 controller-shaped problems of tests/data/socp_oracle.npz,
    solved as one batch, at the JAX test's tolerance (2e-4 x scale)."""
    data = np.load(osp.join(osp.dirname(__file__), "data",
                            "socp_oracle.npz"))
    dims = tuple(int(d) for d in data["dims"])
    sol = solve_socp(torch.tensor(data["c"]), torch.tensor(data["G"]),
                     torch.tensor(data["h"]), dims, iters=40)
    for i in range(data["c"].shape[0]):
        xe = data["x_expected"][i]
        scale = max(1.0, float(np.max(np.abs(xe))))
        assert np.max(np.abs(sol.x[i].numpy() - xe)) < 2e-4 * scale, i
        assert abs(float(sol.pcost[i]) - data["cost_expected"][i]) \
            < 2e-4 * scale


# ---- controller -------------------------------------------------------------

def _controller_case(seed, B=6):
    rng = np.random.default_rng(seed)
    x = _states(seed, B)
    th = x[:, 2]
    FT = np.zeros((B, 3, 3))
    FT[:, 0, 1], FT[:, 1, 1], FT[:, 2, 2] = np.cos(th), np.sin(th), 1.0 / 12
    FT += 0.05 * rng.normal(size=FT.shape)
    W = rng.normal(size=(B, 3, 3))
    Bk = W @ W.transpose(0, 2, 1) * 0.05 + 0.01 * np.eye(3)
    A = np.eye(3) + 0.1 * np.diag(rng.uniform(size=3))
    return x, FT, Bk, np.broadcast_to(A, (B, 3, 3)).copy()


@pytest.mark.parametrize("max_risk", [0.01, 0.4999])
def test_constraint_cone_terms_match_jax(max_risk):
    x, FT, Bk, A = _controller_case(3)
    cfg_kw = dict(u_dim=2, max_risk=max_risk, cbf_gammas=(5.0, 5.0))
    jcfg, tcfg = (jbc.BayesCLFControllerConfig(**cfg_kw),
                  tbc.BayesCLFControllerConfig(**cfg_kw))
    jobs = tuple(jcc.obstacles_at_mid_from_start_and_goal(
        jnp.asarray(START), jnp.asarray(GOAL), (0.7, 0.3)))
    tobs = tuple(tcc.obstacles_at_mid_from_start_and_goal(
        torch.tensor(START), torch.tensor(GOAL), (0.7, 0.3)))
    jp = JPlan.create(jnp.asarray(START), jnp.asarray(GOAL), 2000, 0.001, 0.95)
    tp = PiecewiseLinearPlanner.create(torch.tensor(START), torch.tensor(GOAL),
                                       2000, 0.001, 0.95)
    t = 123
    got = tbc.constraint_cone_terms(
        tcfg, tcc.CLFCartesian(), tobs, tp,
        tuple(torch.tensor(a) for a in (FT, Bk, A)), torch.tensor(x), t)
    want = jax.vmap(lambda xx, f, b, a: jbc.constraint_cone_terms(
        jcfg, jcc.CLFCartesian(), jobs, jp, (f, b, a), xx, t))(x, FT, Bk, A)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0])[0])
    for g, w in zip(got[1:], want[1:]):
        # f64, same algebra with closed-form CLF/CBF gradients
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("max_risk,warm", [(0.01, False), (0.01, True),
                                           (0.4999, False)])
def test_bayes_clf_control_matches_jax_vmap(max_risk, warm):
    x, FT, Bk, A = _controller_case(4)
    B = x.shape[0]
    cfg_kw = dict(u_dim=2, max_risk=max_risk, cbf_gammas=(5.0, 5.0),
                  socp_iters=40, socp_iters_warm=40, warm_start=warm)
    jcfg, tcfg = (jbc.BayesCLFControllerConfig(**cfg_kw),
                  tbc.BayesCLFControllerConfig(**cfg_kw))
    jobs = tuple(jcc.obstacles_at_mid_from_start_and_goal(
        jnp.asarray(START), jnp.asarray(GOAL), (0.7, 0.3)))
    tobs = tuple(tcc.obstacles_at_mid_from_start_and_goal(
        torch.tensor(START), torch.tensor(GOAL), (0.7, 0.3)))
    jp = JPlan.create(jnp.asarray(START), jnp.asarray(GOAL), 2000, 0.001, 0.95)
    tp = PiecewiseLinearPlanner.create(torch.tensor(START), torch.tensor(GOAL),
                                       2000, 0.001, 0.95)
    t = 321
    w0 = tbc.warm_init(tcfg, 2, B, "cpu", torch.float64) if warm else None
    got = tbc.bayes_clf_control(tcfg, tcc.CLFCartesian(), tobs, tp,
                                tuple(torch.tensor(a) for a in (FT, Bk, A)),
                                torch.tensor(x), t, warm=w0)

    def one(xx, f, b, a):
        w = jbc.warm_init(jcfg, 2, xx.dtype) if warm else None
        return jbc.bayes_clf_control(jcfg, jcc.CLFCartesian(), jobs, jp,
                                     lambda _: (f, b, a), xx, t, warm=w)
    want = jax.vmap(one)(x, FT, Bk, A)
    # the IPM's own floor: its iterates are settled to ~1e-6 relative
    # (roundoff steers the last digits near the optimum), so the solve
    # outputs get that bar; the cone statistics do not pass through the
    # solver and must agree to roundoff
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for f in tbc.ControlInfo._fields:
        g = getattr(got[1], f).numpy()
        w = np.asarray(getattr(want[1], f))
        if f == "feasible":
            np.testing.assert_array_equal(g, w)
        elif f in ("pres", "dres"):
            # residuals sit at the f64 IPM floor (~1e-8) on both sides
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7, err_msg=f)
        elif f in ("relax", "pcost"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12,
                                       err_msg=f)
    if warm:
        for g, w in zip(got[2], want[2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
