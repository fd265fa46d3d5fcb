"""Module parity of the port's pendulum slice against the JAX package on
CPU, f64: the pendulum model and barriers, the learned model's moment
derivatives, the closed-form CBC2 terms and their cone, the LQR and
epsilon-greedy references, the rank-1 cache append over a filling
reservoir, and one learned-SOCP control step.

Every module computes the JAX function's arithmetic in another order (or
in closed form where JAX differentiates), so the bars are roundoff:
1e-10 relative to the magnitude of each output.  The control step ends at
the IPM's KKT floor after a fixed number of iterations; it is held at
that floor (1e-6) with the flags equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.control import learned_socp_controller as jlsc
from bayesian_cbf_tpu.control import pendulum_safety as jps
from bayesian_cbf_tpu.control import secondary as jsec
from bayesian_cbf_tpu.experiments import pendulum as jp
from bayesian_cbf_tpu.models import mvgp as jmvgp
from bayesian_cbf_tpu.safety import cbc as jcbc
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.control import learned_socp_controller as tlsc
from bayesian_cbf_tpu_torch.control import pendulum_safety as tps
from bayesian_cbf_tpu_torch.control import secondary as tsec
from bayesian_cbf_tpu_torch.experiments import pendulum as tp
from bayesian_cbf_tpu_torch.models.mvgp import MVGPCache, MVGPData
from bayesian_cbf_tpu_torch.safety import cbc as tcbc

F64 = torch.float64
B, K = 4, 12


def _close(got, want, rtol=1e-10):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def _states(seed, n=B):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-math.pi, math.pi, n),
                     rng.normal(0.0, 2.0, n)], -1)


def _learned_case(seed, filled=9):
    """Batched JAX learner states (random hyperparameters, a reservoir
    with `filled` of K rows along a pendulum-like trajectory, its fitted
    cache) and the same state in the port."""
    jsim = jp.make_pendulum_online_sim(max_train=K)
    sim = tp.make_pendulum_online_sim(max_train=K, device="cpu", dtype=F64)
    jl = jsim.learned
    rng = np.random.default_rng(seed)
    params = dict(
        raw_lengthscale=rng.normal(0.0, 0.3, (B, 2)),
        raw_outputscale=rng.normal(0.5, 0.3, B),
        W_A=0.3 * rng.normal(size=(B, 2, 2)),
        raw_vA=rng.normal(0.0, 0.3, (B, 2)),
        W_B=0.3 * rng.normal(size=(B, 2, 2)),
        raw_vB=rng.normal(0.0, 0.3, (B, 2)),
        mean_M=0.1 * rng.normal(size=(B, 2, 2)))
    X = np.stack([7 * math.pi / 12 + np.cumsum(0.05 * rng.normal(
        size=(B, K)), 1), rng.normal(0.0, 0.5, (B, K))], -1)
    mask = (np.arange(K) < filled).astype(float)[None].repeat(B, 0)
    data = dict(X=X * mask[..., None],
                UH=np.concatenate([np.ones((B, K, 1)), rng.uniform(
                    -15, 15, (B, K, 1))], -1) * mask[..., None],
                Xdot=rng.normal(size=(B, K, 2)) * mask[..., None], mask=mask)
    jparams = jmvgp.MVGPParams(**{k: jnp.asarray(v)
                                  for k, v in params.items()})
    jdata = jmvgp.MVGPData(**{k: jnp.asarray(v) for k, v in data.items()})
    jcache = jax.vmap(jl.gp.refresh_cache)(jparams, jdata)
    st = jax.vmap(jl.init_state)(jax.random.split(jax.random.PRNGKey(1), B))
    jst = st._replace(params=jparams, buf=jdata, data=jdata, cache=jcache)
    cache = {f: np.asarray(getattr(jcache, f)) for f in MVGPCache._fields}
    tst = interop.learned_state_from_numpy(
        sim.learned, params, "cpu", F64, buf=data, data=data, cache=cache)
    return jsim, sim, jst, tst


@pytest.fixture(scope="module")
def case():
    return _learned_case(0)


# ---- the pendulum and its barriers ----------------------------------------

def test_pendulum_model_and_barriers_match_jax():
    x = _states(1, 6)
    xt = torch.tensor(x)
    u = np.random.default_rng(2).uniform(-15, 15, (6, 1))
    pend, tpend = jp.PendulumDynamics(), tp.PendulumDynamics()
    step = jax.vmap(lambda a, b: pend.step(a, b, 0.01))(x, u)
    for got, want in zip(tpend.step(xt, torch.tensor(u), 0.01), step):
        _close(got, want, 1e-14)
    clf, tclf = jps.EnergyCLF(), tps.EnergyCLF()
    rad, trad = jps.RadialCBF(), tps.RadialCBF()
    cbf2, tcbf2 = jps.RadialCBFRelDegree2(), tps.RadialCBFRelDegree2()
    pairs = [(tclf.V_clf, clf.V_clf), (tclf.grad_V_clf, clf.grad_V_clf),
             (tclf.A, clf.A), (tclf.b, clf.b),
             (trad.h_col, rad.h_col), (trad.grad_h_col, rad.grad_h_col),
             (trad.A, rad.A), (trad.b, rad.b),
             (tcbf2.cbf, cbf2.cbf), (tcbf2.grad_cbf, cbf2.grad_cbf),
             (tcbf2.hess_cbf, jax.jacfwd(cbf2.grad_cbf)),
             (tcbf2.A, cbf2.A), (tcbf2.b, cbf2.b)]
    for tfn, jfn in pairs:
        _close(tfn(xt), jax.vmap(jfn)(x), 1e-13)


# ---- learned model ----------------------------------------------------------

@pytest.mark.parametrize("shift_invariant", [False, True])
def test_moment_derivatives_match_jax(case, shift_invariant):
    """The pendulum's learner, and the same with the shift invariance the
    unicycle uses (theta zeroed before the kernel: no derivative)."""
    jsim, sim, jst, tst = case
    jl = jsim.learned._replace(shift_invariant=shift_invariant)
    tl = sim.learned._replace(shift_invariant=shift_invariant)
    x = _states(3)
    x[:2] = np.asarray(jst.data.X[:2, 4])     # on a training point
    want = jax.vmap(jl.moment_derivatives)(jst, x)
    got = tl.moment_derivatives(tst, torch.tensor(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_cbc2_terms_and_cone_match_jax(case):
    jsim, sim, jst, tst = case
    x = _states(4)
    mder = jax.vmap(jsim.learned.moment_derivatives)(jst, x)
    cbf, tcbf = jsim.cbf, sim.cbf
    u0 = np.full((B, 1), 0.5)
    want = jax.vmap(lambda md, xx, uu: jcbc.cbc2_closed_form_terms(
        cbf.cbf, cbf.grad_cbf, cbf.k_alpha, md, xx, uu))(mder, x, u0)
    tmder = tuple(torch.tensor(np.asarray(a)) for a in mder)
    got = tcbc.cbc2_closed_form_terms(
        tcbf, tcbf.k_alpha, tmder, torch.tensor(x), torch.tensor(u0))
    flat = lambda t: [a for part in t for a in (part if isinstance(
        part, tuple) else (part,))]
    for g, w in zip(flat(got), flat(want)):
        _close(g, w)
    (bfe, e), (V, bfv, v), _, _ = got
    cone = tcbc.cbc_to_socp_cone(bfe, e, V, bfv, v, extravars=3, relax_col=2)
    jcone = jax.vmap(lambda a, b_, c, d, f: jcbc.cbc_to_socp_cone(
        a, b_, c, d, f, extravars=3, relax_col=2))(*(np.asarray(w) for w in (
            want[0][0], want[0][1], want[1][0], want[1][1], want[1][2])))
    for g, w in zip(cone, jcone):
        _close(g, w)


@pytest.mark.parametrize("eigs", [(1.0, 2.0), (-1e-3, 2.0), (-1.0, -1e-3),
                                  (-1e-3, -5e-4), (-5e-4, -5e-4),
                                  (-1.0, 3.0), (-1e-3, 0.5, 2.0)])
def test_eig_clamp_matches_eigh(eigs):
    """The closed-form 2 x 2 clamp (and torch's eigh for other orders)
    against numpy's eigh with the same rule: only eigenvalues in (-EPS, 0)
    are set to zero."""
    Vm, _ = np.linalg.qr(np.random.default_rng(len(eigs)).normal(
        size=(len(eigs), len(eigs))))
    Km = Vm @ np.diag(eigs) @ Vm.T
    w, v = np.linalg.eigh(Km)
    w = np.where((w < 0) & (w > -tcbc.EPS), 0.0, w)
    got = tcbc._clamp_small_negative_eigs(torch.tensor(Km)[None])[0]
    _close(got, (v * w) @ v.T, 1e-13)


# ---- references -------------------------------------------------------------

@pytest.mark.parametrize("gain", [1.0, 1e12])
def test_lqr_and_egreedy_match_jax(gain):
    """LQR on the true pendulum's linearization (gain 1) and on a linear
    drift so steep that the Riccati recursion overflows even in f64
    (gain 1e12: u is not finite, so both fall back to 0)."""
    x = _states(5, 6)
    dt = 2e-3
    jlqr = jsec.LQRController(Q=jnp.eye(2), R=jnp.eye(1), x_goal=jnp.zeros(2),
                              horizon=20, dt=dt)
    tlqr = tp.make_pendulum_online_sim(dt=dt, device="cpu").lqr
    pend = jp.PendulumDynamics()
    if gain == 1.0:
        f_func, g_func = pend.f_func, pend.g_func
        dfdx = np.stack([np.stack([np.zeros(6), np.ones(6)], -1),
                         np.stack([-10.0 * np.cos(x[:, 0]), np.zeros(6)],
                                  -1)], 1)
    else:
        f_func, g_func = (lambda xx: gain * xx), pend.g_func
        dfdx = np.broadcast_to(gain * np.eye(2), (6, 2, 2))
    gx = np.broadcast_to(np.array([[0.0], [1.0]]), (6, 2, 1))
    want = jax.vmap(lambda xx: jlqr.control_with_model(
        f_func, g_func, xx, 0))(x)
    got = tlqr.control_with_model(torch.tensor(dfdx), torch.tensor(gx),
                                  torch.tensor(x))
    _close(got, want)
    if gain != 1.0:
        assert float(got.abs().max()) == 0.0
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    uni = np.stack([np.asarray(jax.random.uniform(k, (1,), jnp.float64))
                    for k in keys])
    jeg = jsec.EpsilonGreedyController(numSteps=250)
    teg = tsec.EpsilonGreedyController(numSteps=250)
    for t in (0, 17, 249):
        w = jax.vmap(lambda u, k: jeg.perturb(u, t, k))(np.asarray(want),
                                                         keys)
        _close(teg.perturb(got, t, torch.tensor(uni)), w, 1e-14)


# ---- rank-1 cache append ----------------------------------------------------

def test_cache_append_row_over_filling_reservoir():
    """Rows 3..K-1 appended one at a time from the fitted prefix of 3
    rows, with one episode's write gated off at each step and one row
    whose residual is insane (1e16: alpha leaves the sane range, so the
    cache must stay as it was, in JAX and in the port alike)."""
    jsim2, sim2, jst, tst = _learned_case(1, filled=3)
    jgp, tgp = jsim2.learned.gp, sim2.learned.gp
    rng = np.random.default_rng(7)
    jcache, tcache = jst.cache, tst.cache
    jdata, tdata = jst.data, tst.data
    rejected = 0
    for slot in range(3, K):
        row = dict(X=np.stack([7 * math.pi / 12 + rng.normal(0, 0.2, B),
                               rng.normal(0, 0.5, B)], -1),
                   UH=np.stack([np.ones(B), rng.uniform(-15, 15, B)], -1),
                   Xdot=rng.normal(size=(B, 2)), mask=np.ones(B))
        if slot == 7:
            row["Xdot"][2] = 1e16
        new = {f: np.asarray(getattr(jdata, f)).copy()
               for f in MVGPData._fields}
        for f in MVGPData._fields:
            new[f][:, slot] = row[f]
        jdata = jdata._replace(**{f: jnp.asarray(v) for f, v in new.items()})
        tdata = MVGPData(*(torch.tensor(new[f]) for f in MVGPData._fields))
        write = np.arange(B) != slot % B
        slots = np.full(B, slot)
        jnew = jax.vmap(jgp.cache_append_row)(jst.params, jdata, jcache,
                                              slots, write)
        tnew = tgp.cache_append_row(tst.params, tdata, tcache,
                                    torch.tensor(slots), torch.tensor(write))
        for g, w in zip(tnew, jnew):
            _close(g, w)
        same = np.all(np.asarray(jnew.alpha) == np.asarray(jcache.alpha),
                      (1, 2))
        rejected += int(same[2] and write[2])
        jcache, tcache = jnew, tnew
    assert rejected >= 1
    # the appended factor of the active prefix is a Cholesky factor of the
    # masked Gram (up to the episodes whose rows were gated off)
    assert torch.isfinite(tcache.L).all()


# ---- one control step -------------------------------------------------------

def test_learned_socp_control_step_matches_jax(case):
    jsim, sim, jst, tst = case
    x = _states(6)
    x[:, 0] = 7 * math.pi / 12 + 0.3 * np.random.default_rng(8).normal(size=B)
    mder = jax.vmap(jsim.learned.moment_derivatives)(jst, x)
    rng = np.random.default_rng(9)
    u_ref = rng.uniform(-15, 15, (B, 1))
    u_fb = rng.uniform(-1, 1, (B, 1))
    cbf = jsim.cbf

    def one(md, xx, ur, uf):
        return jlsc.learned_socp_control(
            jsim.controller, cbf.cbf, cbf.grad_cbf, None, None, ur, xx,
            moment_deriv_fn=lambda _: md, u_fallback=uf)

    uw, iw = jax.vmap(one)(mder, x, u_ref, u_fb)
    tmder = tuple(torch.tensor(np.asarray(a)) for a in mder)
    u, info = tlsc.learned_socp_control(sim.controller, (sim.cbf,), tmder,
                                        torch.tensor(u_ref), torch.tensor(x),
                                        torch.tensor(u_fb))
    _close(u, uw, 1e-6)
    for key in ("feasible", "certified"):
        np.testing.assert_array_equal(getattr(info, key).numpy(),
                                      np.asarray(iw[key]))
    for key in ("delta", "cbc_slack"):
        _close(getattr(info, key), iw[key], 1e-6)
    _close(info.cbc_mean, iw["cbc_mean"])
    _close(info.cbc_var, iw["cbc_var"])
    _close(info.pres, iw["pres"], 1e-6)
