"""The port's GP expression path against the JAX package on the CPU, f64:
CBC2 built as a GP and its terms extracted by differentiating in u
(`safety/cbc.cbc2_gp_terms`, vectorized over episodes), the pendulum
episode with `closed_form=False`, `bayes_clf_control_gp`, the model API
the path reads (`MVGP.f_mean` ... `predict_fullmat`, the dynamics'
`fu_func_gp`, the learner's `f_gp_and_fu_gp`, `f_func`, `g_func`,
`predict_fullmat`), the helpers of `utils/linalg`, `control/clf_cbf` and
`solvers/socp` that came with it, and the controller's step SOCP
against JAX's `debug_cones` capture.

Bars.  The CBC2 terms are the same algebra on the same posterior in
both libraries (1e-9, relative to each term's magnitude) and equal the
port's closed form at JAX's own `rtol=1e-9, atol=1e-10`
(tests/test_pendulum_exp.py).  The pendulum episode (JAX's small
configuration: 40 steps, max_train 12, 6 Adam iterations, a refit every
10, 20 IPM iterations, fed JAX's random numbers) ends each step at
the IPM's floor, so its bars are measured on these inputs: a 1e-14 change
of theta0 or omega0 moves the port's closed-form episode by up to 8.4e-5
in U and 1.6e-7 in X, and its GP-path episode by up to 7.3e-4 and
1.4e-6, above JAX's own bars of 1e-6 and 1e-7 between its two routes
(tests/test_pendulum_exp.py).  So the GP path is held to the closed form
at that floor, rounded up: 8e-4 in U and 2e-6 in X (the two differ by
5.2e-5 and 9.5e-8).  Against JAX's GP-path episode the bars are those of
tests/test_torch_pendulum_e2e.py.  `bayes_clf_control_gp` is held to
JAX's and to the port's closed-form controller at JAX's `rtol=1e-3,
atol=1e-4` (tests/test_components.py), its cone terms to JAX's at 1e-9.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.control import bayes_controller as jbc
from bayesian_cbf_tpu.control import clf_cbf as jcc
from bayesian_cbf_tpu.control import learned_socp_controller as jlsc
from bayesian_cbf_tpu.experiments import pendulum as jp
from bayesian_cbf_tpu.experiments import unicycle as ju
from bayesian_cbf_tpu.models import dynamics as jd
from bayesian_cbf_tpu.models import mvgp as jmvgp
from bayesian_cbf_tpu.safety import cbc as jcbc
from bayesian_cbf_tpu.solvers import socp as jsocp
from bayesian_cbf_tpu.utils import linalg as jla
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.control import bayes_controller as tbc
from bayesian_cbf_tpu_torch.control import clf_cbf as tcc
from bayesian_cbf_tpu_torch.control import learned_socp_controller as tlsc
from bayesian_cbf_tpu_torch.experiments import pendulum as tp
from bayesian_cbf_tpu_torch.experiments import unicycle as tu
from bayesian_cbf_tpu_torch.models import dynamics as td
from bayesian_cbf_tpu_torch.models import mvgp as tmvgp
from bayesian_cbf_tpu_torch.models.mvgp import MVGPCache, MVGPData
from bayesian_cbf_tpu_torch.safety import cbc as tcbc
from bayesian_cbf_tpu_torch.solvers import socp as tsocp
from bayesian_cbf_tpu_torch.utils import linalg as tla

F64 = torch.float64
B = 3
SMALL = dict(numSteps=40, max_train=12, training_iter=6,
             train_every_n_steps=10, socp_iters=20)
U_FLOOR = 8e-4
X_FLOOR = 2e-6
X_ATOL = 2e-3
U_REL = 1e-2


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol=1e-10):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def _leaves(tree):
    return jax.tree.leaves(tree) if not isinstance(tree, torch.Tensor) \
        else [tree]


def _torch_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [a for t in tree for a in _torch_leaves(t)]


def _numpy_fields(tup):
    return {f: np.asarray(getattr(tup, f)) for f in tup._fields}


def _port_state(lrn, jst):
    """The port's learner state of the batched JAX state jst."""
    return interop.learned_state_from_numpy(
        lrn, _numpy_fields(jst.params), "cpu", F64,
        buf=_numpy_fields(jst.buf), data=_numpy_fields(jst.data),
        cache=_numpy_fields(jst.cache))


def _fitted_jax_states(jl, step, dt, x0s, us):
    """Batched JAX learner states: init_state(PRNGKey(0)), a record per
    step of the controls us (B, T, m) along the true dynamics from x0s
    (B, n), then fit_now (tests/test_pendulum_exp.py's construction)."""
    def build(x0, useq):
        st = jl.init_state(jax.random.PRNGKey(0), dtype=jnp.float64)
        x = x0
        for t in range(useq.shape[0]):
            st = jl.record(st, x, useq[t])
            x, _ = step(x, useq[t], dt)
        return jl.fit_now(st)
    return jax.jit(jax.vmap(build))(jnp.asarray(x0s), jnp.asarray(us))


# ---- CBC2 terms at a fitted learner state -----------------------------------

@pytest.fixture(scope="module")
def fitted():
    """JAX's small pendulum learner fitted on 10 recorded steps per
    episode (three episodes), its state in the port, query states and
    JAX's GP-path CBC2 terms at u0 = 0.5."""
    jsim = jp.make_pendulum_online_sim(**SMALL)
    sim = tp.make_pendulum_online_sim(**SMALL, device="cpu", dtype=F64)
    x0s = np.array([[7 * math.pi / 12 + 0.1 * b, 0.05 * b]
                    for b in range(B)])
    us = np.array([[[1.5 - 0.1 * t + 0.3 * b] for t in range(10)]
                   for b in range(B)])
    jst = _fitted_jax_states(jsim.learned, jsim.true_dynamics.step, jsim.dt,
                             x0s, us)
    xq = np.array([[1.9, 0.4], [2.3, -0.7], [1.2, 1.1]])
    cbf, k_alpha = jsim.cbf, jsim.controller.k_alpha

    def terms(st, x):
        pair = {}

        def fu_gp_fn(u):
            pair["p"] = jsim.learned.f_gp_and_fu_gp(st, u)
            return pair["p"][1]

        return jcbc.cbc2_quadratic_terms(
            lambda uu: jcbc.cbc2_gp(cbf.cbf, cbf.grad_cbf,
                                    lambda: pair["p"][0], fu_gp_fn, 2,
                                    k_alpha, uu),
            x, jnp.full((1,), 0.5))

    want = jax.jit(jax.vmap(terms))(jst, jnp.asarray(xq))
    tst = _port_state(sim.learned, jst)
    return jsim, sim, jst, tst, xq, want


def _gp_terms(sim, tst, xq):
    u0 = torch.full((xq.shape[0], 1), 0.5, dtype=F64)
    return tcbc.cbc2_gp_terms(sim.cbf, sim.controller.k_alpha,
                              sim.learned.f_gp_and_fu_gp, tst, _t(xq), u0)


def test_cbc2_gp_terms_match_jax(fitted):
    jsim, sim, jst, tst, xq, want = fitted
    got = _gp_terms(sim, tst, xq)
    for g, w in zip(_torch_leaves(got), _leaves(want)):
        _close(g, w, 1e-9)


def test_cbc2_gp_terms_match_the_closed_form(fitted):
    """The two routes to the CBC2 terms: the GP expression path against
    the port's hand-derived closed form."""
    jsim, sim, jst, tst, xq, want = fitted
    got = _gp_terms(sim, tst, xq)
    mder = sim.learned.moment_derivatives(tst, _t(xq))
    cf = tcbc.cbc2_closed_form_terms(sim.cbf, sim.controller.k_alpha, mder,
                                     _t(xq), torch.full((B, 1), 0.5,
                                                        dtype=F64))
    for g, w in zip(_torch_leaves(got), _torch_leaves(cf)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-10)


def test_fu_leaf_same_in_both_builders(fitted):
    """The learner's Fu GP is the same GP whether it comes alone
    (`fu_func_gp`, its leaf independent of every other) or paired with f
    (`f_gp_and_fu_gp`, cov(Fu, f) registered): equal means and kernels,
    and only the pair's leaf covaries with f."""
    jsim, sim, jst, tst, xq, want = fitted
    lrn = sim.learned
    u = _t([0.7])
    for b in range(B):
        st = td._map(lambda a: a[b], tst)
        alone = lrn.fu_func_gp(st, u)
        f, paired = lrn.f_gp_and_fu_gp(st, u)
        x, xp = _t(xq[b]), _t(xq[(b + 1) % B])
        _close(alone.mean(x), paired.mean(x).numpy(), 1e-13)
        _close(alone.knl(x, xp), paired.knl(x, xp).numpy(), 1e-13)
        assert float(paired.covar(f, x, xp).abs().max()) > 0.0
        assert float(alone.covar(f, x, xp).abs().max()) == 0.0


def test_vmapped_batch_equals_episode_loop(fitted):
    """`cbc2_gp_terms` over the batch against `cbc2_quadratic_terms(
    cbc2_gp(...))` of each episode's own state, one at a time, without
    vmap."""
    jsim, sim, jst, tst, xq, want = fitted
    got = _torch_leaves(_gp_terms(sim, tst, xq))
    lrn, cbf = sim.learned, sim.cbf
    h = lambda x: cbf.cbf(x[None])[0]
    gh = lambda x: cbf.grad_cbf(x[None])[0]
    for b in range(B):
        st = td._map(lambda a: a[b], tst)
        one = tcbc.cbc2_quadratic_terms(
            lambda u: tcbc.cbc2_gp(h, gh,
                                   lambda v: lrn.f_gp_and_fu_gp(st, v), 2,
                                   sim.controller.k_alpha, u),
            _t(xq[b]), torch.full((1,), 0.5, dtype=F64))
        for g, w in zip(got, _torch_leaves(one)):
            _close(g[b], w.numpy(), 1e-13)


# ---- the pendulum episode with closed_form=False ----------------------------

def _pendulum_randoms(lrn, steps):
    """JAX's single-episode random numbers (tests/test_torch_outcomes.py):
    kd, ks = split(PRNGKey(0)); the initial parameters and reservoir
    draws from init_state(kd), one exploration uniform per step from
    the chain key, ke = split(key) from ks."""
    kd, ks = jax.random.split(jax.random.PRNGKey(0))
    st = lrn.init_state(kd, dtype=jnp.float64)
    params = {f: np.asarray(getattr(st.params, f))[None]
              for f in st.params._fields}
    key, cr, draws = st.key, 0, []
    for t in range(steps):
        key, kslot = jax.random.split(key)
        j = int(jax.random.randint(kslot, (), 0, max(cr + 1, 1)))
        draws.append(j)
        cr += int(t > 0 and (cr < lrn.max_train or j < lrn.max_train))
    key, noise = ks, []
    for _ in range(steps):
        key, ke = jax.random.split(key)
        noise.append(np.asarray(jax.random.uniform(ke, (1,), jnp.float64)))
    return params, draws, np.array(noise)


@pytest.fixture(scope="module")
def episodes():
    """JAX's GP-path episode, and the port's GP-path and closed-form
    episodes, all three from JAX's random numbers."""
    jsim = jp.make_pendulum_online_sim(**SMALL)
    jsim = jsim._replace(controller=jsim.controller._replace(
        closed_form=False))
    X, U, _, info = jp.run_pendulum_online_learning(jsim)
    want = dict(X=np.asarray(X), U=np.asarray(U),
                feasible=np.asarray(info["feasible"]),
                certified=np.asarray(info["certified"]))
    params, draws, noise = _pendulum_randoms(jsim.learned, SMALL["numSteps"])
    simc = tp.make_pendulum_online_sim(**SMALL, device="cpu", dtype=F64)
    simg = simc._replace(controller=simc.controller._replace(
        closed_form=False))
    outs = {}
    for name, sim in (("closed", simc), ("gp", simg)):
        state0 = interop.learned_state_from_numpy(sim.learned, params, "cpu",
                                                  F64)
        outs[name] = tp.run_pendulum_online_learning(
            sim, state0=state0, draws=torch.tensor(draws),
            noise=torch.tensor(noise))
    return simg, outs, want


def test_gp_episode_matches_the_closed_form(episodes):
    sim, outs, _ = episodes
    gp, cf = outs["gp"], outs["closed"]
    assert torch.isfinite(gp.X).all() and torch.isfinite(gp.U).all()
    assert float((gp.U - cf.U).abs().max()) < U_FLOOR
    assert float((gp.X - cf.X).abs().max()) < X_FLOOR
    assert torch.equal(gp.info.feasible, cf.info.feasible)


def test_gp_episode_matches_jax(episodes):
    sim, outs, want = episodes
    Xp, Up = outs["gp"].X.numpy(), outs["gp"].U.numpy()
    first = sim.learned.train_every_n_steps + 1
    assert np.abs(Xp[:first] - want["X"][:first]).max() < 1e-4
    assert np.abs(Xp - want["X"]).max() < X_ATOL
    u_rel = (np.abs(Up - want["U"]).max(-1)
             / (1.0 + np.abs(want["U"]).max(-1)))
    assert u_rel.max() < U_REL
    for field in ("feasible", "certified"):
        np.testing.assert_array_equal(
            getattr(outs["gp"].info, field).numpy()[:first],
            want[field][:first])
    assert float(tp.pendulum_damage_fraction(outs["gp"].X[:, 0])) == 0.0


def test_debug_cones(fitted):
    """The step SOCP of `learned_socp_cones` equals the one JAX's
    controller captures with its `debug_cones` (G and h at the same
    step), and `learned_socp_control`'s u is that SOCP's solution where
    the step is feasible."""
    jsim, sim, jst, tst, xq, want = fitted
    x = _t(xq)
    u_ref = _t([[0.3], [-1.2], [2.0]])
    mder = sim.learned.moment_derivatives(tst, x)
    cfg = sim.controller
    u, info = tlsc.learned_socp_control(cfg, (sim.cbf,), mder, u_ref, x,
                                        u_fallback=u_ref)
    cobj, G, h, dims, _, _ = tlsc.learned_socp_cones(cfg, (sim.cbf,), mder,
                                                     u_ref, x)
    sol = tsocp.solve_socp(cobj, G, h, dims, iters=cfg.socp_iters)
    feas = info.feasible
    assert feas.any() and torch.equal(sol.x[feas, :1], u[feas])
    for b in range(B):
        st = jax.tree.map(lambda a: a[b], jst)
        _, jinfo = jax.jit(lambda s, xx, ur: jlsc.learned_socp_control(
            jsim.controller._replace(debug_cones=True), jsim.cbf.cbf,
            jsim.cbf.grad_cbf, None, None, ur, xx,
            moment_deriv_fn=lambda z: jsim.learned.moment_derivatives(s, z),
            u_fallback=ur))(st, jnp.asarray(xq[b]), jnp.asarray(
                u_ref[b].numpy()))
        _close(G[b], jinfo["G"], 1e-9)
        _close(h[b], jinfo["h"], 1e-9)


# ---- bayes_clf_control_gp ---------------------------------------------------

UNI = dict(numSteps=50, dt=0.01, true_L=12.0, mean_L=1.0,
           kernel_diag_A=(1e-2,) * 3, max_train=12, training_iter=5)


@pytest.fixture(scope="module", params=["no_learning", "learning"])
def unicycle_case(request):
    """The JAX test's configuration (tests/test_components.py: no learning,
    the Ackermann prior with kernel_diag_A 1e-2, step 3) and the same
    learning from scratch, fitted on 12 recorded steps; three states about
    the start; JAX's bayes_clf_control_gp per state."""
    learn = request.param == "learning"
    jsim = ju.make_ackermann_tracking_sim(**UNI, enable_learning=learn)
    sim = tu.make_ackermann_tracking_sim(**UNI, enable_learning=learn,
                                         device="cpu", dtype=F64)
    rng = np.random.default_rng(4)
    x = np.array(ju.STATE_START) + 0.05 * rng.normal(size=(B, 3))
    jl = jsim.learned_dynamics
    if learn:
        jst = _fitted_jax_states(
            jl, jsim.true_dynamics.step, jsim.dt, x,
            rng.normal(size=(B, 12, 2)))
    else:
        jst = jax.vmap(jl.init_state)(
            jax.random.split(jax.random.PRNGKey(0), B))
    tst = _port_state(sim.learned_dynamics, jst)
    t = 3

    def one(st, xx):
        return jbc.bayes_clf_control_gp(
            jsim.controller, jsim.clf, jsim.cbfs, jsim.planner,
            lambda u: jl.fu_func_gp(st, u), xx, jnp.asarray(t))

    want = jax.jit(jax.vmap(one))(jst, jnp.asarray(x))
    return jsim, jst, sim, tst, x, t, want


def test_bayes_clf_control_gp_matches_jax(unicycle_case):
    _, _, sim, tst, x, t, (wu, winfo) = unicycle_case
    lrn = sim.learned_dynamics
    u, info = tbc.bayes_clf_control_gp(sim.controller, sim.clf, sim.cbfs,
                                       sim.planner, lrn.fu_func_gp, tst,
                                       _t(x), t)
    np.testing.assert_allclose(u.numpy(), np.asarray(wu), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(info.relax.numpy(), np.asarray(winfo.relax),
                               rtol=1e-3, atol=1e-4)
    assert info.feasible.all() and np.asarray(winfo.feasible).all()
    for f in ("clc_mean", "clc_var", "cbc_means", "cbc_vars"):
        _close(getattr(info, f), getattr(winfo, f), 1e-9)


def test_bayes_clf_control_gp_matches_the_closed_form(unicycle_case):
    """The GP route against the port's closed-form controller on the same
    states (the closed form reports the cones' means at u = 0, the GP
    route at u0: only u and relax are compared)."""
    _, _, sim, tst, x, t, _ = unicycle_case
    lrn = sim.learned_dynamics
    u, info = tbc.bayes_clf_control_gp(sim.controller, sim.clf, sim.cbfs,
                                       sim.planner, lrn.fu_func_gp, tst,
                                       _t(x), t)
    uc, infoc = tbc.bayes_clf_control(sim.controller, sim.clf, sim.cbfs,
                                      sim.planner, lrn.moments(tst, _t(x)),
                                      _t(x), t)
    np.testing.assert_allclose(u.numpy(), uc.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(info.relax.numpy(), infoc.relax.numpy(),
                               rtol=1e-3, atol=1e-4)
    # without CBFs the cones are (objective, CLC): no CBC terms
    free = sim.controller._replace(cbf_gammas=())
    u2, info2 = tbc.bayes_clf_control_gp(free, sim.clf, (), sim.planner,
                                         lrn.fu_func_gp, tst, _t(x), t)
    assert info2.cbc_means.shape == (B, 0) and torch.isfinite(u2).all()


# ---- the model API of the path ----------------------------------------------

@pytest.fixture(scope="module")
def posterior():
    """A JAX MVGP posterior of three episodes (random hyperparameters, a
    reservoir of 9 of 12 rows, its cache) and the same in the port."""
    K, n, m = 12, 2, 1
    rng = np.random.default_rng(8)
    params = dict(
        raw_lengthscale=rng.normal(0.0, 0.3, (B, n)),
        raw_outputscale=rng.normal(0.5, 0.3, B),
        W_A=0.3 * rng.normal(size=(B, n, n)),
        raw_vA=rng.normal(0.0, 0.3, (B, n)),
        W_B=0.3 * rng.normal(size=(B, 1 + m, 1 + m)),
        raw_vB=rng.normal(0.0, 0.3, (B, 1 + m)),
        mean_M=0.1 * rng.normal(size=(B, 1 + m, n)))
    mask = (np.arange(K) < 9).astype(float)[None].repeat(B, 0)
    data = dict(X=rng.normal(size=(B, K, n)) * mask[..., None],
                UH=np.concatenate([np.ones((B, K, 1)), rng.uniform(
                    -3, 3, (B, K, m))], -1) * mask[..., None],
                Xdot=rng.normal(size=(B, K, n)) * mask[..., None], mask=mask)
    jgp = jmvgp.make_mvgp(n, m)
    jparams = jmvgp.MVGPParams(**{k: jnp.asarray(v)
                                  for k, v in params.items()})
    jdata = jmvgp.MVGPData(**{k: jnp.asarray(v) for k, v in data.items()})
    jcache = jax.vmap(jgp.refresh_cache)(jparams, jdata)
    tgp = tmvgp.make_mvgp(n, m)
    tparams = interop.mvgp_params_from_numpy(params, "cpu", F64)
    tdata = MVGPData(*(_t(data[f]) for f in MVGPData._fields))
    tcache = MVGPCache(*(_t(np.asarray(getattr(jcache, f)))
                         for f in MVGPCache._fields))
    x, xp = rng.normal(size=(B, n)), rng.normal(size=(B, n))
    u = rng.normal(size=(B, m))
    return (jgp, (jparams, jdata, jcache), tgp, (tparams, tdata, tcache),
            x, xp, u, rng.normal(size=(B, 4, n)), rng.normal(size=(B, 3, n)))


@pytest.mark.parametrize("name", ["f_mean", "g_mean", "f_knl", "fu_knl",
                                  "covar_fu_f"])
def test_mvgp_pointwise_match_jax(posterior, name):
    jgp, jpost, tgp, tpost, x, xp, u, _, _ = posterior
    args = {"f_mean": (x,), "g_mean": (x,), "f_knl": (x, xp),
            "fu_knl": (u, x, xp), "covar_fu_f": (u, x, xp)}[name]
    want = jax.vmap(getattr(jgp, name))(*jpost, *map(jnp.asarray, args))
    _close(getattr(tgp, name)(*tpost, *map(_t, args)), want)


def test_mvgp_predict_match_jax(posterior):
    """predict_matrix with and without Xtestp and compute_cov, and
    predict_fullmat."""
    jgp, jpost, tgp, tpost, _, _, _, Xt, Xtp = posterior
    for Xp, cov in ((Xt, True), (Xtp, True), (Xt, False)):
        want = jax.vmap(lambda p, d, c, X, Y: jgp.predict_matrix(
            p, d, c, X, Y, compute_cov=cov))(*jpost, jnp.asarray(Xt),
                                             jnp.asarray(Xp))
        got = tgp.predict_matrix(*tpost, _t(Xt),
                                 None if Xp is Xt else _t(Xp), cov)
        for g, w in zip(got, want):
            _close(g, w)
    want = jax.vmap(jgp.predict_fullmat)(*jpost, jnp.asarray(Xt))
    for g, w in zip(tgp.predict_fullmat(*tpost, _t(Xt)), want):
        _close(g, w)


def test_make_mvgp_diag_matches_jax():
    """Diagonal task covariances: no W factors, A and B diagonal; the same
    MLL as JAX's on the same data."""
    jgp, tgp = jmvgp.make_mvgp_diag(2, 1), tmvgp.make_mvgp_diag(2, 1)
    assert (tgp.rank_A, tgp.rank_B) == (jgp.rank_A, jgp.rank_B) == (0, 0)
    p = tgp.init_params(2, torch.Generator().manual_seed(0), "cpu", F64)
    assert p.W_A.shape == (2, 2, 0) and p.W_B.shape == (2, 2, 0)
    assert torch.equal(p.A, torch.diag_embed(torch.diagonal(
        p.A, dim1=-2, dim2=-1)))
    jp_ = jgp.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    X, U, Xd = (rng.normal(size=(10, 2)), rng.normal(size=(10, 1)),
                rng.normal(size=(10, 2)))
    want = jgp.mll(jp_, jgp.make_data(X, U, Xd))
    tp_ = interop.mvgp_params_from_numpy(
        {f: np.asarray(getattr(jp_, f))[None] for f in jp_._fields}, "cpu",
        F64)
    got = tgp.mll(
        tp_, tgp.make_data(_t(X)[None], _t(U)[None], _t(Xd)[None]))
    _close(got[0], want, 1e-9)


@pytest.mark.parametrize("model", ["cartesian", "ackermann", "zero",
                                   "pendulum"])
def test_dynamics_fu_func_gp_match_jax(model):
    jm, tm, n, m = {
        "cartesian": (jd.CartesianDynamics(), td.CartesianDynamics(), 3, 2),
        "ackermann": (jd.AckermannDrive(kernel_diag_A=(0.5, 1.0, 2.0)),
                      td.AckermannDrive(kernel_diag_A=(0.5, 1.0, 2.0)), 3, 2),
        "zero": (jd.ZeroDynamics(), td.ZeroDynamics(), 3, 2),
        "pendulum": (jd.PendulumDynamics(), td.PendulumDynamics(), 2, 1),
    }[model]
    rng = np.random.default_rng(6)
    x, xp, u = rng.normal(size=n), rng.normal(size=n), rng.normal(size=m)
    jg, tg = jm.fu_func_gp(jnp.asarray(u)), tm.fu_func_gp(_t(u))
    assert tg.assume_independence and tg.dim == jg.dim
    _close(tg.mean(_t(x)), jg.mean(jnp.asarray(x)), 1e-13)
    _close(tg.knl(_t(x), _t(xp)), jg.knl(jnp.asarray(x), jnp.asarray(xp)),
           1e-13)


def test_ackermann_predict_fullmat_matches_jax():
    jm = jd.AckermannDrive(kernel_diag_A=(0.5, 1.0, 2.0))
    tm = td.AckermannDrive(kernel_diag_A=(0.5, 1.0, 2.0))
    Xt = np.random.default_rng(1).normal(size=(2, 4, 3))
    for b in range(2):
        want = jm.predict_fullmat(jnp.asarray(Xt[b]))
        got = tm.predict_fullmat(_t(Xt))
        for g, w in zip(got, want):
            _close(g[b], w, 1e-13)


def test_learner_mean_functions_match_jax(unicycle_case):
    """f_func, g_func and predict_fullmat of the unicycle's learner
    (shift invariance, the Ackermann prior), learning on (fitted) and off
    (the prior's predict_fullmat)."""
    jsim, jst, sim, tst, x, _, _ = unicycle_case
    jl, tl = jsim.learned_dynamics, sim.learned_dynamics
    Xq = x[:, None] + 0.1 * np.random.default_rng(9).normal(size=(B, 4, 3))
    _close(tl.f_func(tst, _t(x)), jax.vmap(jl.f_func)(jst, jnp.asarray(x)))
    _close(tl.g_func(tst, _t(x)), jax.vmap(jl.g_func)(jst, jnp.asarray(x)))
    want = jax.vmap(jl.predict_fullmat)(jst, jnp.asarray(Xq))
    for g, w in zip(tl.predict_fullmat(tst, _t(Xq)), want):
        _close(g, w)


def test_learner_gp_leaves_match_jax(fitted):
    """The leaves of one episode's learner (f_gp_and_fu_gp and
    fu_func_gp): mean, knl and the registered covariance against JAX's."""
    jsim, sim, jst, tst, xq, _ = fitted
    b = 1
    jst1 = jax.tree.map(lambda a: a[b], jst)
    tst1 = td._map(lambda a: a[b], tst)
    u, x, xp = np.array([0.7]), xq[b], xq[0]
    jl, tl = jsim.learned, sim.learned
    jf, jfu = jl.f_gp_and_fu_gp(jst1, jnp.asarray(u))
    tf, tfu = tl.f_gp_and_fu_gp(tst1, _t(u))
    jx, jxp, tx, txp = jnp.asarray(x), jnp.asarray(xp), _t(x), _t(xp)
    for tg, jg in ((tf, jf), (tfu, jfu)):
        _close(tg.mean(tx), jg.mean(jx))
        _close(tg.knl(tx, txp), jg.knl(jx, jxp))
    _close(tfu.covar(tf, tx, txp), jfu.covar(jf, jx, jxp))
    _close(tf.covar(tfu, tx, txp), jf.covar(jfu, jx, jxp))
    for learn in (True, False):
        jl2 = jl._replace(enable_learning=learn)
        tl2 = tl._replace(enable_learning=learn)
        jg, tg = jl2.fu_func_gp(jst1, jnp.asarray(u)), tl2.fu_func_gp(
            tst1, _t(u))
        _close(tg.mean(tx), jg.mean(jx))
        _close(tg.knl(tx, txp), jg.knl(jx, jxp))


# ---- utils/linalg, control/clf_cbf, solvers/socp ----------------------------

def test_psd_cholesky_and_clamp_match_jax():
    """The ladder on a PD, a slightly indefinite and a strongly indefinite
    matrix (no rung succeeds: L = 0), one at a time and as a batch; the
    eigenvalue clamp; the masked Gram."""
    rng = np.random.default_rng(3)
    G = rng.normal(size=(4, 4))
    pd = G @ G.T + 0.1 * np.eye(4)
    w, v = np.linalg.eigh(pd)
    slight = (v * np.array([-1e-4, 0.5, 1.0, 2.0])) @ v.T
    bad = (v * np.array([-50.0, 0.5, 1.0, 2.0])) @ v.T
    mats = np.stack([pd, slight, bad])
    for K in mats:
        for g, w_ in zip(tla.psd_cholesky(_t(K)), jla.psd_cholesky(
                jnp.asarray(K))):
            _close(g, w_, 1e-12)
    for g, w_ in zip(tla.psd_cholesky(_t(mats)),
                     jax.vmap(jla.psd_cholesky)(jnp.asarray(mats))):
        _close(g, w_, 1e-12)
    for eps in (0.0, 0.3):
        _close(tla.psd_clamp_eigh(_t(mats), eps),
               jla.psd_clamp_eigh(jnp.asarray(mats), eps), 1e-12)
    mask = np.array([1.0, 0.0, 1.0, 1.0])
    for g, w_ in zip(tla.masked_cholesky(_t(pd), _t(mask)),
                     jla.masked_cholesky(jnp.asarray(pd), jnp.asarray(mask))):
        _close(g, w_, 1e-12)


def test_clf_terms_isconverged_single_obstacle_match_jax():
    rng = np.random.default_rng(11)
    goal = np.array([0.0, 0.0, math.pi / 4])
    states = np.concatenate([rng.normal(size=(4, 3)),
                             [[1e-4, -2e-4, 0.3]]])
    for jc, tcl in ((jcc.CLFCartesian(), tcc.CLFCartesian()),
                    (jcc.CLFPolar(Kp=(0.6, 1.5, 4.0, 0.7)),
                     tcc.CLFPolar(Kp=(0.6, 1.5, 4.0, 0.7)))):
        want = jax.vmap(lambda s: jc.clf_terms(s, jnp.asarray(goal)))(
            jnp.asarray(states))
        _close(tcl.clf_terms(_t(states), _t(goal)), want, 1e-13)
        conv = jax.vmap(lambda s: jc.isconverged(s, jnp.asarray(goal)))(
            jnp.asarray(states))
        np.testing.assert_array_equal(
            tcl.isconverged(_t(states), _t(goal)).numpy(), np.asarray(conv))
        assert bool(tcl.isconverged(_t(states), _t(goal))[-1])
    x0, xg = np.array([-3.0, -1.0, -math.pi / 4]), goal
    (jo,) = jcc.single_obstacle_at_mid_from_start_and_goal(
        jnp.asarray(x0), jnp.asarray(xg), term_weights=(0.7, 0.3))
    (to,) = tcc.single_obstacle_at_mid_from_start_and_goal(
        _t(x0), _t(xg), term_weights=(0.7, 0.3))
    _close(to.center, jo.center, 1e-14)
    assert abs(to.radius - float(jo.radius)) < 1e-14
    assert to.term_weights == (0.7, 0.3)
    _close(to.cbf(_t(states)), jax.vmap(jo.cbf)(jnp.asarray(states)), 1e-13)


def test_socp_helpers_match_jax():
    """cones_from_constraints builds G, h and dims as JAX's (per problem),
    and its cones solve to JAX's solution; socp_residuals flags the
    solutions whose both residuals are below tol."""
    rng = np.random.default_rng(12)
    nx = 4
    cons = [(rng.normal(size=(B, k, nx)), rng.normal(size=(B, k)),
             rng.normal(size=(B, nx)), 5.0 + rng.uniform(size=B))
            for k in (3, 0, 2)]
    G, h, dims = tsocp.cones_from_constraints(
        [tuple(map(_t, c)) for c in cons])
    for b in range(B):
        jG, jh, jdims = jsocp.cones_from_constraints(
            [tuple(jnp.asarray(a[b]) for a in c) for c in cons])
        assert dims == jdims == (4, 1, 3)
        _close(G[b], jG, 0.0)
        _close(h[b], jh, 0.0)
    c = _t([0.3, -0.2, 0.1, 1.0])
    sol = tsocp.solve_socp(c, G, h, dims, iters=25)
    ok = tsocp.socp_residuals(sol, tol=1e-6)
    want = (sol.pres < 1e-6) & (sol.dres < 1e-6)
    assert torch.equal(ok, want)
    jsol = jsocp.solve_socp(jnp.asarray(c.numpy()), jnp.asarray(G[0].numpy()),
                            jnp.asarray(h[0].numpy()), dims, iters=25)
    assert bool(jsocp.socp_residuals(jsol, tol=1e-6)) == bool(ok[0])
    assert not tsocp.socp_residuals(sol, tol=0.0).any()
