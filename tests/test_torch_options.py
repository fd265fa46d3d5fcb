"""Parity of the port's remaining controller and solver options against
the JAX package, on the CPU in f64: the learned SOCP controller with hard
CBC2 cones (cbc_relax=False), a CLC stability cone (clc_fn) and its
debug_cones capture; the plain IPM at the kernel's four new shapes;
`solve_qp_active_set` (against JAX and SLSQP); `SplinePlanner`; the two
sample generators; and the debug sanitizers.

The control step ends at the IPM's KKT floor after a fixed number of
iterations, so it is held at that floor (1e-6, as
tests/test_torch_pendulum.py holds the relaxed step) with the flags
equal; the cone data at roundoff (1e-9).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from bayesian_cbf_tpu.control import learned_socp_controller as jlsc
from bayesian_cbf_tpu.control import planner as jplan
from bayesian_cbf_tpu.gp.algebra import DeterministicGP as JDet
from bayesian_cbf_tpu.models import dynamics as jdyn
from bayesian_cbf_tpu.models import mvgp as jmvgp
from bayesian_cbf_tpu.sim import rollout as jroll
from bayesian_cbf_tpu.solvers.qp import solve_qp_active_set as jqp
from bayesian_cbf_tpu.solvers.socp import _solve_padded_plain
from bayesian_cbf_tpu.utils import debug as jdebug
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.control import learned_socp_controller as tlsc
from bayesian_cbf_tpu_torch.control import planner as tplan
from bayesian_cbf_tpu_torch.models import dynamics as tdyn
from bayesian_cbf_tpu_torch.models import mvgp as tmvgp
from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
from bayesian_cbf_tpu_torch.sim import rollout as troll
from bayesian_cbf_tpu_torch.solvers.qp import solve_qp_active_set
from bayesian_cbf_tpu_torch.utils import debug as tdebug
from test_torch_pendulum import _close, _learned_case

F64 = torch.float64
# the CLC of V(x) = SCALE ||x||^2 (learned_socp_controller.norm2_clc)
GAMMA, SCALE = 1.0, 1e-3


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _jax_clc(jl, gamma=GAMMA, scale=SCALE):
    """norm2_clc built with the JAX package's GP algebra, for one
    episode's learner state."""
    V = JDet(lambda x: jnp.reshape(scale * (x @ x), (1,)), dim=1)
    grad_V = JDet(lambda x: 2.0 * scale * x, dim=2)

    def clc(st, u):
        f, fu = jl.f_gp_and_fu_gp(st, u)
        return (grad_V.t() @ f + grad_V.t() @ fu + V * gamma) * -1.0
    return clc


@pytest.fixture(scope="module")
def case():
    """A learner with 11 of 12 reservoir rows filled (random
    hyperparameters, its cache refreshed), states about 7 pi / 12."""
    jsim, sim, jst, tst = _learned_case(3, filled=11)
    rng = np.random.default_rng(10)
    x = np.stack([7 * math.pi / 12 + 0.2 * rng.normal(size=4),
                  0.3 * rng.normal(size=4)], -1)
    return jsim, sim, jst, tst, x


# ---- the learned SOCP controller's options ---------------------------------

@pytest.mark.parametrize("relax,with_clc", [(False, False), (True, True),
                                            (False, True)])
def test_learned_socp_options_match_jax(case, relax, with_clc):
    """One control step under cbc_relax and clc_fn (the stability cone
    through the GP algebra, per episode), with debug_cones: u, delta and
    pres at the IPM floor, feasible and certified equal (certified is
    feasible without cbc_relax, the slack zeros), the captured G and h at
    roundoff, u_ref as given, the solution x at the floor."""
    jsim, sim, jst, tst, x = case
    jl = jsim.learned
    mder = jax.vmap(jl.moment_derivatives)(jst, x)
    rng = np.random.default_rng(11)
    u_ref = rng.uniform(-3, 3, (4, 1))
    u_fb = rng.uniform(-1, 1, (4, 1))
    jcfg = jsim.controller._replace(cbc_relax=relax, debug_cones=True)
    jclc = _jax_clc(jl)

    def one(md, st, xx, ur, uf):
        return jlsc.learned_socp_control(
            jcfg, jsim.cbf.cbf, jsim.cbf.grad_cbf, None, None, ur, xx,
            clc_fn=(lambda u: jclc(st, u)) if with_clc else None,
            moment_deriv_fn=lambda _: md, u_fallback=uf)

    uw, iw = jax.jit(jax.vmap(one))(mder, jst, x, u_ref, u_fb)
    cfg = sim.controller._replace(cbc_relax=relax, debug_cones=True)
    clc = tlsc.norm2_clc(sim.learned.f_gp_and_fu_gp, 2, GAMMA, SCALE)
    u, info = tlsc.learned_socp_control(
        cfg, (sim.cbf,), tuple(_t(a) for a in mder), _t(u_ref), _t(x),
        _t(u_fb), state=tst, clc_fn=clc if with_clc else None)
    dims = 3 + int(relax) + 3 * int(with_clc)
    assert tuple(info.G.shape) == (4, 3 + dims, 3 + int(relax))
    _close(info.G, iw["G"], 1e-9)
    _close(info.h, iw["h"], 1e-9)
    assert torch.equal(info.u_ref, _t(u_ref))
    for key in ("feasible", "certified"):
        np.testing.assert_array_equal(getattr(info, key).numpy(),
                                      np.asarray(iw[key]))
    assert info.feasible.any()
    if not relax:
        assert torch.equal(info.certified, info.feasible)
        assert not info.cbc_slack.any()
    else:
        _close(info.cbc_slack, iw["cbc_slack"], 1e-6)
    _close(u, uw, 1e-6)
    _close(info.x_sol, iw["x_sol"], 1e-6)
    for key in ("delta", "pres"):
        _close(getattr(info, key), iw[key], 1e-6)
    _close(info.cbc_mean, iw["cbc_mean"])
    _close(info.cbc_var, iw["cbc_var"])


def test_options_off_leave_the_debug_fields_empty(case):
    """Without debug_cones the info's G, h, u_ref and x_sol are None, and
    the relaxed layout keeps its four variables (m + 3)."""
    _, sim, _, tst, x = case
    mder = sim.learned.moment_derivatives(tst, _t(x))
    _, info = tlsc.learned_socp_control(sim.controller, (sim.cbf,), mder,
                                        _t(np.zeros((4, 1))), _t(x),
                                        _t(np.zeros((4, 1))))
    assert info.G is None and info.h is None and info.x_sol is None
    assert tlsc.n_vars(sim.controller) == 4
    assert tlsc.n_vars(sim.controller._replace(cbc_relax=False)) == 3


# ---- the plain IPM at the kernel's four new shapes -------------------------

@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("nx,dims", [(3, (3, 3)), (3, (3, 3, 3)),
                                     (4, (3, 3, 1, 3)), (3, (4, 1, 1))])
def test_ipm_plain_option_shapes_match_jax_plain(nx, dims, iters):
    """(3, 2, 3), (3, 3, 3), (4, 4, 3), (3, 3, 4): the same operations in
    f64, so the iterates agree to roundoff amplified by the steps taken
    (1e-7, as tests/test_torch_deterministic.py holds the other shapes)."""
    rng = np.random.default_rng(7 + len(dims))
    B, C, d = 6, len(dims), max(dims)
    c = rng.normal(size=(B, nx))
    G, h = np.zeros((B, C, d, nx)), np.zeros((B, C, d))
    for ci, dd in enumerate(dims):
        G[:, ci, 0] = -rng.normal(size=(B, nx)) * 0.2
        G[:, ci, 1:dd] = -rng.normal(size=(B, dd - 1, nx)) * 0.5
        h[:, ci, 0] = 1.5 + rng.uniform(size=B)
        h[:, ci, 1:dd] = rng.normal(size=(B, dd - 1)) * 0.1
    e = np.zeros((B, C, d))
    e[..., 0] = 1.0
    args = (c, G, h, np.zeros((B, nx)), e, e)
    got = ik.ipm_plain(*(_t(a) for a in args), iters, 1e-10)
    want = jax.vmap(lambda *a: _solve_padded_plain(*a, iters, 1e-10))(
        *(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7,
                                   atol=1e-7)


# ---- solve_qp_active_set ----------------------------------------------------

def _qps(B, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 3, 2)), rng.normal(size=(B, 3)),
            np.broadcast_to(np.eye(2), (B, 2, 2)).copy(),
            rng.uniform(0.2, 0.8, (B, 2)))


def test_qp_matches_jax():
    """A batch of six QPs at (3, 3, 4) against JAX's one at a time: u
    and the lifted solution at the IPM's floor, which the flat optimum of
    the epigraph cone leaves wider than the controllers' (1.5e-6 apart
    measured on these six; held at 1e-5)."""
    qps = _qps(6, 2)
    u, sol = solve_qp_active_set(*(_t(a) for a in qps))
    uw, solw = jax.vmap(jqp)(*(jnp.asarray(a) for a in qps))
    _close(u, uw, 1e-5)
    _close(sol.x, solw.x, 1e-5)
    _close(sol.pres, solw.pres, 1e-6)
    assert tuple(sol.s.shape) == (6, 3, 4)


@pytest.mark.parametrize("batched", [False, True])
def test_qp_epigraph_matches_slsqp(batched):
    """JAX's test (tests/test_socp.py:74-86): min ||A u + b||^2 s.t.
    u >= -0.5 against SLSQP at atol 1e-4, unbatched (B = 1 inside, the
    outputs without the axis) and as a row of a batch."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(3, 2))
    b = rng.normal(size=3)
    cs, ds = np.eye(2), np.array([0.5, 0.5])
    if batched:
        u, sol = solve_qp_active_set(*(_t(a)[None].repeat(
            (3,) + (1,) * a.ndim) for a in (A, b, cs, ds)))
        assert tuple(u.shape) == (3, 2)
        u = u[1]
    else:
        u, sol = solve_qp_active_set(_t(A), _t(b), _t(cs), _t(ds))
        assert tuple(u.shape) == (2,) and tuple(sol.x.shape) == (3,)
    res = minimize(lambda v: np.sum((A @ v + b) ** 2), np.zeros(2),
                   method="SLSQP",
                   constraints=[{"type": "ineq", "fun": lambda v: v + 0.5}])
    np.testing.assert_allclose(u.numpy(), res.x, atol=1e-4)


# ---- SplinePlanner ----------------------------------------------------------

@pytest.mark.parametrize("t", [0.0, 3, 10.5, 47.0, 89.9, 100.0,
                               np.arange(0.0, 101.0, 7.0)])
def test_spline_planner_matches_jax(t):
    """plan and dot_plan at scalar steps (the knots' ends among them) and
    at a tensor of steps, at 1e-10."""
    x0, xg = np.array([-3.0, -1.0, -math.pi / 4]), np.array([0, 0,
                                                              math.pi / 4])
    jsp = jplan.SplinePlanner.create(x0, xg, 100, 0.01)
    sp = tplan.SplinePlanner.create(x0, xg, 100, 0.01, device="cpu",
                                    dtype=F64)
    tt = torch.as_tensor(t, dtype=F64) if isinstance(t, np.ndarray) else t
    plan = jax.vmap(jsp.plan) if isinstance(t, np.ndarray) else jsp.plan
    dplan = (jax.vmap(jsp.dot_plan) if isinstance(t, np.ndarray)
             else jsp.dot_plan)
    _close(sp.plan(tt), plan(jnp.asarray(t)))
    _close(sp.dot_plan(tt), dplan(jnp.asarray(t)))
    if not isinstance(t, np.ndarray) and t in (0.0, 100.0):
        _close(sp.plan(t), x0 if t == 0.0 else xg)


# ---- the sample generators --------------------------------------------------

def test_sample_generator_trajectory_matches_jax():
    """The pendulum under u = -2 theta + sin(0.1 t) for 40 steps: X, U and
    Xdot at 1e-12."""
    x0 = np.array([2.0, -0.3])
    Xdot, X, U = troll.sample_generator_trajectory(
        tdyn.PendulumDynamics(),
        lambda x, t: -2.0 * x[:1] + math.sin(0.1 * t), _t(x0), 40, 0.01)
    want = jroll.sample_generator_trajectory(
        jdyn.PendulumDynamics(),
        lambda x, t: -2.0 * x[:1] + jnp.sin(0.1 * t), jnp.asarray(x0), 40,
        0.01)
    for g, w in zip((Xdot, X, U), want):
        assert tuple(g.shape) == np.shape(w)
        _close(g, w, 1e-12)


def test_sample_generator_independent_matches_jax():
    """256 draws of the unicycle's (x, u) boxes from a torch generator;
    JAX's f(x) + g(x) u on the same X and U gives the same Xdot."""
    lo, hi, ulo, uhi = (-2, -2, -math.pi), (2, 2, math.pi), (-1, -1), (1, 1)
    Xdot, X, U = troll.sample_generator_independent(
        tdyn.AckermannDrive(), torch.Generator().manual_seed(0), 256, lo, hi,
        ulo, uhi, dtype=F64)
    assert bool((X >= _t(lo)).all() and (X <= _t(hi)).all())
    assert bool((U >= _t(ulo)).all() and (U <= _t(uhi)).all())
    jd = jdyn.AckermannDrive()
    want = jax.vmap(lambda x, u: jd.f_func(x) + jd.g_func(x) @ u)(
        jnp.asarray(X.numpy()), jnp.asarray(U.numpy()))
    _close(Xdot, want, 1e-14)


# ---- the debug sanitizers ---------------------------------------------------

@pytest.mark.parametrize("op,fn,x", [
    ("aten.log", lambda x: torch.log(x - 2.0).sum(), [1.0, 4.0]),
    ("aten.sqrt", lambda x: torch.sqrt(x - 2.0).sum(), [3.0, 1.0]),
    ("division by zero in aten.div", lambda x: (x / (x - 1.0)).sum(),
     [1.0, 3.0]),
])
def test_checkify_nan_raises_at_the_op(op, fn, x):
    """A clean input passes; a NaN, an infinity or a division by zero
    raises FloatingPointError naming the operation that made it, as
    JAX's checkify raises for the log."""
    wrapped = tdebug.checkify_nan(fn)
    assert math.isfinite(float(wrapped(torch.tensor([3.0, 4.0]))))
    with pytest.raises(FloatingPointError, match=op):
        wrapped(torch.tensor(x))
    if op == "aten.log":
        with pytest.raises(Exception, match="nan"):
            jdebug.checkify_nan(lambda a: jnp.log(a - 2.0).sum())(
                jnp.asarray(x))


def _mvgp_case(seed, n):
    """JAX's rank-1 MVGP (2, 1), its initial parameters and n random rows,
    and the same in the port."""
    gp = jmvgp.make_mvgp_rank1(2, 1)
    params = gp.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    X, U, Xdot = (rng.normal(size=s) for s in ((n, 2), (n, 1), (n, 2)))
    tgp = tmvgp.make_mvgp_rank1(2, 1, fit_inverse="cholk")
    tparams = interop.mvgp_params_from_numpy(
        {f: np.asarray(getattr(params, f))[None] for f in params._fields},
        "cpu", F64)
    tdata = tgp.make_data(*(_t(a)[None] for a in (X, U, Xdot)))
    return (gp, params, gp.make_data(*(jnp.asarray(a) for a in (X, U, Xdot))),
            tgp, tparams, tdata)


def test_checkify_clean_on_mll():
    """The MVGP's MLL makes no non-finite value on healthy data, and its
    value is JAX's."""
    gp, params, data, tgp, tparams, tdata = _mvgp_case(0, 16)
    val = tdebug.checkify_nan(lambda p: tgp.mll(p, tdata))(tparams)
    assert math.isfinite(float(val[0]))
    _close(val[0], jdebug.checkify_nan(lambda p: gp.mll(p, data))(params))


def test_gradcheck_mll():
    """Autograd's gradient of the MLL against central differences over
    every hyperparameter leaf, as JAX's gradcheck passes on its own."""
    gp, params, data, tgp, tparams, tdata = _mvgp_case(1, 8)
    assert tdebug.gradcheck(lambda p, d: tgp.mll(p, d)[0], (tparams, tdata),
                            eps=1e-6, rtol=5e-4, atol=1e-6)
    assert jdebug.gradcheck(lambda p, d: gp.mll(p, d), (params, data),
                            eps=1e-6, rtol=5e-4, atol=1e-6)


class _WrongSquare(torch.autograd.Function):
    """sum(x^2) with the gradient 3 x instead of 2 x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x ** 2).sum()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return 3.0 * g * x


@pytest.mark.parametrize("params", [{"a": [1.0, 2.0]}, ([1.0, 2.0],)])
def test_gradcheck_catches_a_wrong_gradient(params):
    """Over a dict and over a tuple: a correct function passes, a wrong
    custom gradient raises AssertionError naming its leaf."""
    tree = ({k: _t(v) for k, v in params.items()} if isinstance(params, dict)
            else tuple(_t(v) for v in params))
    leaf = (lambda p: p["a"]) if isinstance(params, dict) else (
        lambda p: p[0])
    assert tdebug.gradcheck(lambda p: (leaf(p) ** 2).sum(), (tree,))
    with pytest.raises(AssertionError, match="leaf 0"):
        tdebug.gradcheck(lambda p: _WrongSquare.apply(leaf(p)), (tree,))


def test_gradgradcheck_quadratic():
    """JAX's case: the Hessian-vector product of sum(x^3) + x0 x1 along
    the tangent of default_rng(0), and the same check in JAX."""
    f = lambda p: torch.sum(p["x"] ** 3) + p["x"][0] * p["x"][1]
    assert tdebug.gradgradcheck(f, ({"x": _t([0.7, -0.3, 1.1])},))
    jf = lambda p: jnp.sum(p["x"] ** 3) + jnp.sum(p["x"][0] * p["x"][1])
    assert jdebug.gradgradcheck(jf, ({"x": jnp.asarray([0.7, -0.3, 1.1])},))
