"""The Monte-Carlo batch, the mesh functions and the self-triggered
intervals of the PyTorch port against the JAX package on the CPU, f64.

The interval math (`lipschitz_bound_f`, `per_step_cbf_grad_max`,
`trigger_intervals`, the sweep along an episode) gets the same inputs and
JAX's Gaussian draws, and agrees to roundoff (1e-10 relative).
`monte_carlo_unicycle` at JAX's test size (8 episodes, 40 steps, one
refit after step 20) and `trigger_analysis_learning_run` in miniature
start from JAX's perturbed starts, initial hyperparameters and reservoir
draws; their episodes end each step at the IPM's KKT floor, so states
are held at the reference's own sensitivity (a 1e-14 start change moves
its golden episode by 7e-4, see tests/test_torch_e2e.py), the
statistics to 1e-3, the fitted hyperparameters of the logged `knl`
channels to 1e-6 relative and the state-dependent posterior variances
and the sweep along the port's own episode to 5e-3 relative.  The mesh functions
run on a mesh of four CPU devices against one: the blocks of a batch see
other batch sizes in the same operations, which moves the IPM's floor
by ~1e-6 over an episode; the posteriors are the same sums in another
grouping (1e-10).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.experiments import montecarlo as jmc
from bayesian_cbf_tpu.experiments import unicycle as ju
from bayesian_cbf_tpu.models import mvgp as jm
from bayesian_cbf_tpu.observability import trigger as jt
from bayesian_cbf_tpu.parallel import mesh as jmesh
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.experiments import montecarlo as tmc
from bayesian_cbf_tpu_torch.experiments import unicycle as tu
from bayesian_cbf_tpu_torch.models import mvgp as tm
from bayesian_cbf_tpu_torch.observability import trigger as tt
from bayesian_cbf_tpu_torch.parallel import mesh as tmesh

F64 = torch.float64
MC = dict(numSteps=40, dt=0.01, max_train=12, training_iter=3,
          train_every_n_steps=20)


def _close(got, want, rtol=1e-10):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def _keys_and_draws(seed, T, E, N):
    """JAX's per-step keys and the Gaussian draws (T, E, N) each makes."""
    keys = jax.random.split(jax.random.PRNGKey(seed), T)
    return keys, np.stack([np.asarray(jax.random.normal(k, (E, N),
                                                        jnp.float64))
                           for k in keys])


def _trajectory(T, seed):
    rng = np.random.default_rng(seed)
    n, m = 3, 2
    X = np.cumsum(0.05 * rng.normal(size=(T, n)), 0) + [-2.0, -1.0, 0.3]
    G = rng.normal(size=(T, n, n)) * 0.3
    H = rng.normal(size=(T, m + 1, m + 1)) * 0.3
    return dict(X=X, Xdot=rng.normal(size=(T, n)) * 0.5,
                U=rng.normal(size=(T, m)),
                sf=1.0 + 0.3 * rng.random(T),
                ls=0.5 + rng.random((T, n)),
                A=G @ G.transpose(0, 2, 1) + np.eye(n),
                B=H @ H.transpose(0, 2, 1) + np.eye(m + 1))


def test_lipschitz_bound_and_cbf_grad_max_match_jax():
    """A batch of steps at the default 10^3 grid (its first step against
    JAX) and at 4^3 (each step against JAX), with JAX's draws; the barriers' signed gradient
    maximum over each step's local grid."""
    T = 3
    tr = _trajectory(T, 0)
    A_diag = np.diagonal(tr["A"], axis1=1, axis2=2)
    uBu = np.array([0.5, 1.0, 2.0])
    ins = [tr["X"], tr["sf"], tr["ls"], A_diag, uBu]
    for grid_pts in (10, 4):
        keys, draws = _keys_and_draws(grid_pts, T, 3, grid_pts ** 3)
        got = tt.lipschitz_bound_f(*(torch.tensor(a) for a in ins),
                                   grid_pts=grid_pts,
                                   draws=torch.tensor(draws))
        for t in range(T if grid_pts == 4 else 1):
            want = jt.lipschitz_bound_f(*(jnp.asarray(a[t]) for a in ins),
                                        keys[t], grid_pts=grid_pts)
            for g, w in zip(got, want):
                _close(g[t], w)
    jsim = ju.make_ackermann_tracking_sim()
    sim = tu.make_ackermann_tracking_sim(device="cpu", dtype=F64)
    _close(tt.per_step_cbf_grad_max(torch.tensor(tr["X"]), sim.cbfs),
           jt.per_step_cbf_grad_max(jnp.asarray(tr["X"]), jsim.cbfs))


@pytest.mark.parametrize("per_step_lh", [False, True])
def test_trigger_intervals_match_jax(per_step_lh):
    """A scalar Lh and a per-step one; tau falls where Lfh rises."""
    T = 6
    tr = _trajectory(T, 1)
    keys, draws = _keys_and_draws(7, T, 3, 6 ** 3)
    lh = np.linspace(0.5, 2.0, T) if per_step_lh else 2.0
    order = ("X", "Xdot", "U", "sf", "ls", "A", "B")
    want = jt.trigger_intervals(*(jnp.asarray(tr[k]) for k in order),
                                jnp.asarray(lh), jax.random.PRNGKey(7))
    got = tt.trigger_intervals(*(torch.tensor(tr[k]) for k in order),
                               torch.tensor(lh), draws=torch.tensor(draws))
    for g, w in zip(got, want):
        _close(g, w)
    tau, Lfh = got[0].numpy(), got[2].numpy()
    assert np.all(tau > 0) and np.all(Lfh > 0)
    gen = torch.Generator().manual_seed(0)
    again = tt.trigger_intervals(*(torch.tensor(tr[k]) for k in order),
                                 torch.tensor(lh), gen)
    _close(again[0], want[0])
    assert torch.isfinite(again[1]).all()


def test_rollout_safety_stats_match_jax():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(5, 7, 3))
    feas = rng.random((5, 7)) > 0.3

    class Outs:
        pass
    jo, to = Outs(), Outs()
    jo.X, to.X = jnp.asarray(X), torch.tensor(X)
    jo.info, to.info = Outs(), Outs()
    jo.info.feasible, to.info.feasible = jnp.asarray(feas), torch.tensor(feas)
    centers = np.array([[0.3, -0.2], [-1.0, 0.5]])
    radii = np.array([0.8, 0.4])
    goal = np.array([0.0, 0.0, math.pi / 4])
    want = jmesh.rollout_safety_stats(jo, jnp.asarray(centers),
                                      jnp.asarray(radii), jnp.asarray(goal))
    got = tmesh.rollout_safety_stats(to, torch.tensor(centers),
                                     torch.tensor(radii), torch.tensor(goal))
    assert sorted(got) == sorted(want)
    assert 0.0 < float(got["collision_fraction"]) < 1.0
    for k in got:
        _close(got[k], want[k], 1e-14)


def _jax_starts(lrn, keys, steps):
    """JAX's initial hyperparameters (B, ...) and reservoir draws (T, B)
    of a batch of episodes: the key chain of `init_state` and `record`."""
    params, draws = [], []
    for key in keys:
        st = lrn.init_state(key, dtype=jnp.float64)
        params.append({f: np.asarray(getattr(st.params, f))
                       for f in st.params._fields})
        key, cr, d = st.key, 0, []
        for t in range(steps):
            key, kslot = jax.random.split(key)
            j = int(jax.random.randint(kslot, (), 0, max(cr + 1, 1)))
            d.append(j)
            cr += int(t > 0 and (cr < lrn.max_train or j < lrn.max_train))
        draws.append(d)
    return ({f: np.stack([p[f] for p in params]) for f in params[0]},
            torch.tensor(draws).T)


@pytest.fixture(scope="module")
def monte_carlo():
    """JAX's and the port's Monte-Carlo batch at JAX's test size from
    JAX's starts, hyperparameters and draws."""
    jsim, jouts, jstats = jmc.monte_carlo_unicycle(n_rollouts=8, **MC)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    x0s = np.asarray(ju.STATE_START)[None] + 0.05 * np.asarray(
        jax.random.normal(k1, (8, 3), jnp.float64))
    params, draws = _jax_starts(jsim.learned_dynamics,
                                jax.random.split(k2, 8), MC["numSteps"])
    lrn = tu.make_ackermann_tracking_sim(
        **MC, device="cpu", dtype=F64).learned_dynamics
    state0 = interop.learned_state_from_numpy(lrn, params, "cpu", F64)
    sim, outs, stats = tmc.monte_carlo_unicycle(
        n_rollouts=8, x0s=x0s, state0=state0, draws=draws, **MC,
        device="cpu", dtype=F64)
    return (jsim, jouts, jstats), (sim, outs, stats)


def test_monte_carlo_matches_jax(monte_carlo):
    (_, jouts, jstats), (_, outs, stats) = monte_carlo
    assert outs.X.shape == (8, MC["numSteps"], 3)
    assert torch.isfinite(outs.X).all()
    assert np.abs(outs.X.numpy() - np.asarray(jouts.X)).max() < 2e-3
    np.testing.assert_array_equal(outs.info.feasible.numpy(),
                                  np.asarray(jouts.info.feasible))
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        assert abs(float(stats[k]) - float(jstats[k])) < 1e-3, k
    assert float(stats["collision_fraction"]) == 0.0
    _knl_match(outs.knl, jouts.knl, MC["train_every_n_steps"], 1)


def _knl_match(knl, jknl, refit_at, step_axis):
    """The logged kernel channels (steps on `step_axis`) against JAX's:
    the fitted hyperparameters to 1e-6 relative, the posterior
    variances, which also follow the state, to 5e-3; the refit moved
    every hyperparameter."""
    for f in knl._fields:
        got, want = getattr(knl, f).numpy(), np.asarray(getattr(jknl, f))
        assert got.shape == want.shape, f
        rel = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert rel.max() < (5e-3 if f.endswith("_var") else 1e-6), \
            (f, rel.max())
        if not f.endswith("_var"):
            moved = np.abs(np.take(got, refit_at + 1, step_axis)
                           - np.take(got, 0, step_axis))
            assert moved.max() > 1e-3, (f, moved.max())


def test_trigger_sweep_matches_jax_on_its_episode(monte_carlo):
    """The sweep along JAX's own episode 0 (its X, U, Xdot and knl
    channels) with JAX's draws; then along the port's episode, the
    identity-prior fallback warns."""
    (jsim, jouts, _), (sim, outs, _) = monte_carlo
    want = jmc.trigger_sweep_for_rollout(jsim, jouts, rollout_idx=0,
                                         stride=10, seed=0)
    jo = outs._replace(
        X=torch.tensor(np.asarray(jouts.X)),
        U=torch.tensor(np.asarray(jouts.U)),
        Xdot=torch.tensor(np.asarray(jouts.Xdot)),
        knl=type(outs.knl)(*(torch.tensor(np.asarray(a))
                             for a in jouts.knl)))
    _, draws = _keys_and_draws(0, 4, 3, 6 ** 3)
    got = tmc.trigger_sweep_for_rollout(sim, jo, rollout_idx=0, stride=10,
                                        draws=torch.tensor(draws))
    for g, w in zip(got, want):
        assert g.shape == (4,)
        _close(g, w)
    assert np.all(got[2].numpy() > 0)
    with pytest.warns(UserWarning, match="identity-prior"):
        tau = tmc.trigger_sweep_for_rollout(sim, outs._replace(knl=None))[0]
    assert tau.shape == (4,) and torch.isfinite(tau).all()


def test_trigger_analysis_learning_run_shapes():
    """The learning episode in miniature (30 steps, refits after steps
    12 and 24) from JAX's initial hyperparameters and reservoir draws,
    swept with JAX's draws: its `knl` channels against JAX's episode's,
    then tau, Lfh and their sampled versions along each package's own
    episode, and the summary over the moving steps."""
    kw = dict(numSteps=30, dt=0.01, max_train=10, training_iter=3,
              train_every_n_steps=12)
    jsim, jout, jst = jmc.trigger_analysis_learning_run(stride=5, **kw)
    params, draws = _jax_starts(jsim.learned_dynamics,
                                [jax.random.PRNGKey(0)], kw["numSteps"])
    state0 = interop.learned_state_from_numpy(
        tu.make_ackermann_tracking_sim(**kw, device="cpu",
                                       dtype=F64).learned_dynamics,
        params, "cpu", F64)
    _, sweep = _keys_and_draws(0, 6, 3, 6 ** 3)
    sim, out, st = tmc.trigger_analysis_learning_run(
        stride=5, sweep_draws=torch.tensor(sweep), state0=state0,
        draws=draws[:, 0], **kw, device="cpu", dtype=F64)
    assert np.abs(out.X.numpy() - np.asarray(jout.X)).max() < 2e-3
    _knl_match(out.knl, jout.knl, kw["train_every_n_steps"], 0)
    for k in ("tau", "tau_num", "Lfh", "Lfh_num"):
        assert st[k].shape == (6,), k
        rel = np.abs(st[k] - jst[k]) / np.abs(jst[k])
        assert rel.max() < 5e-3, (k, rel.max())
    np.testing.assert_array_equal(st["moving"], jst["moving"])
    for k in ("tau_min", "tau_median", "tau_max", "Lfh_min", "Lfh_median",
              "Lfh_max"):
        assert math.isfinite(st[k]) and st[k] > 0, k
        assert abs(st[k] - jst[k]) <= 5e-3 * jst[k], k
    assert st["tau_min"] <= st["tau_median"] <= st["tau_max"]


def test_xy_lengthscales_follow_the_lengthscale_prior_alone():
    """The shift-invariant learner zeroes the x and y of its inputs, so
    the data leave those two lengthscales unconstrained: their MLL
    gradient is the near-flat Gamma prior's alone (0 without the prior),
    which pushes them down at every refit.  The same in JAX to 1e-10."""
    from bayesian_cbf_tpu_torch.sim.rollout import (
        simulate_unicycle_with_state)
    sim = tu.make_ackermann_tracking_sim(
        numSteps=40, dt=0.01, max_train=20, training_iter=3,
        train_every_n_steps=20, device="cpu", dtype=F64)
    _, st = simulate_unicycle_with_state(sim, tu.STATE_START,
                                         torch.Generator().manual_seed(0))
    assert float(st.data.X[..., :2].abs().max()) == 0.0
    gp = sim.learned_dynamics.gp
    raw = st.params.raw_lengthscale.detach().requires_grad_(True)
    grad = lambda g: torch.autograd.grad(
        g.mll(st.params._replace(raw_lengthscale=raw), st.data).sum(),
        raw)[0][0]
    with_prior, without = grad(gp), grad(gp._replace(gamma_prior=None))
    assert torch.equal(without[:2], torch.zeros(2, dtype=F64))
    assert float(without[2]) != 0.0
    assert (with_prior[:2] < 0).all()
    jgp = jm.make_mvgp_rank1(3, 2)
    jparams = jm.MVGPParams(**{k: jnp.asarray(v[0]) for k, v in
                               interop.mvgp_params_to_numpy(
                                   st.params).items()})
    jdata = jm.MVGPData(*(jnp.asarray(a[0].numpy()) for a in st.data))
    jgrad = jax.grad(lambda r: jgp.mll(jparams._replace(raw_lengthscale=r),
                                       jdata))(jparams.raw_lengthscale)
    _close(with_prior, jgrad)


def test_episode_replays_from_its_initial_state_and_uniforms():
    """A generator's episode is the episode of the initial state and the
    per-step uniforms that the same generator draws in the same order, so
    a learning episode can be replayed elsewhere (in f64 on the host)."""
    sim = tu.make_ackermann_tracking_sim(
        numSteps=14, dt=0.01, max_train=6, training_iter=3,
        train_every_n_steps=6, device="cpu", dtype=F64)
    want = tu._run(sim, seed=5)
    gen = torch.Generator().manual_seed(5)
    state0 = sim.learned_dynamics.init_state(1, gen, "cpu", F64)
    uniforms = torch.stack([torch.rand((1,), generator=gen, dtype=F64)
                            for _ in range(sim.numSteps)])[:, 0]
    got = tu._run(sim, state0=state0, draws=uniforms)
    assert torch.equal(got.X, want.X) and torch.equal(got.U, want.U)
    for g, w in zip(got.knl, want.knl):
        assert torch.equal(g, w)


def test_batched_rollouts_on_four_devices_match_one():
    """The same whole-batch draws give the same episodes on a mesh of
    four CPU devices as on one; an indivisible batch raises."""
    sim = tu.make_ackermann_tracking_sim(
        numSteps=12, dt=0.01, max_train=8, training_iter=3,
        train_every_n_steps=6, socp_iters=12, device="cpu", dtype=F64)
    x0s = torch.tensor(tu.STATE_START, dtype=F64)[None] + 0.02 * torch.randn(
        (8, 3), generator=torch.Generator().manual_seed(0), dtype=F64)
    run = lambda mesh: tmesh.batched_rollouts(
        sim, x0s, torch.Generator().manual_seed(1), mesh)
    one, four = run(tmesh.make_mesh(1, "cpu")), run(tmesh.make_mesh(4, "cpu"))
    assert four.X.shape == (8, 12, 3)
    assert torch.isfinite(four.X).all()
    assert (four.X - one.X).abs().max() < 1e-6
    assert torch.equal(four.info.feasible, one.info.feasible)
    with pytest.raises(ValueError, match="divisible"):
        tmesh.batched_rollouts(sim, x0s[:5], torch.Generator(),
                               tmesh.make_mesh(4, "cpu"))


def test_record_draws_from_uniforms_by_the_accept_rule():
    """Uniforms on [0, 1) handed to `record` become the draws of Algorithm
    R: j = floor(r (count + 1)), written at slot count while the
    reservoir fills and at slot j < capacity once full; a uniform and
    the generator that drew it give the same state."""
    cap, B = 5, 4
    lrn = tu.make_ackermann_tracking_sim(
        max_train=cap, device="cpu", dtype=F64).learned_dynamics
    st = lrn.init_state(B, torch.Generator().manual_seed(0), "cpu", F64)
    r = torch.rand((30, B), generator=torch.Generator().manual_seed(3),
                   dtype=F64)
    xs = torch.randn((30, B, 3), generator=torch.Generator().manual_seed(4),
                     dtype=F64)
    cr = np.zeros(B, int)
    for t in range(30):
        j = np.minimum(np.floor(r[t].numpy() * (cr + 1)).astype(int), cr)
        new = lrn.record(st, xs[t], xs[t, :, :2], j=r[t])
        gen = torch.Generator().manual_seed(int(t))
        same = lrn.record(st, xs[t], xs[t, :, :2], j=torch.rand(
            (B,), generator=gen, dtype=F64))
        again = lrn.record(st, xs[t], xs[t, :, :2],
                           generator=torch.Generator().manual_seed(int(t)))
        assert torch.equal(same.buf.X, again.buf.X)
        assert torch.equal(same.count_res, again.count_res)
        accept = (cr < cap) | (j < cap) if t else np.zeros(B, bool)
        slot = np.where(cr < cap, cr, j)
        written = (new.buf.X != st.buf.X).any(-1).numpy()     # (B, K)
        for b in range(B):
            want = np.zeros(cap, bool)
            if accept[b]:
                want[slot[b]] = True
            np.testing.assert_array_equal(written[b], want)
        cr += accept
        np.testing.assert_array_equal(new.count_res.numpy(), cr)
        st = new


def _posterior_case(K, b, seed, masked_tail=0):
    rng = np.random.default_rng(seed)
    gp = tm.make_mvgp(3, 2)
    jgp = jm.make_mvgp(3, 2)
    X, U, Xdot = (rng.normal(size=(1, K, d)) for d in (3, 2, 3))
    data = gp.make_data(*(torch.tensor(a) for a in (X, U, Xdot)))
    if masked_tail:
        data = data._replace(mask=torch.cat([
            torch.ones(1, K - masked_tail, dtype=F64),
            torch.zeros(1, masked_tail, dtype=F64)], 1))
    params = gp.init_params(1, torch.Generator().manual_seed(0), "cpu", F64)
    cache = gp.refresh_cache(params, data)
    Xtest = torch.tensor(rng.normal(size=(1, b, 3)))
    return gp, params, data, cache, Xtest


@pytest.mark.parametrize("fn", ["sharded", "trainaxis"])
def test_sharded_posteriors_match_one_device(fn):
    """Both splits of `predict_fullmat` on four CPU devices (K = 24 with
    five masked rows): b = 7 (blocks of 2, 2, 2, 1 test points) against
    the port's one device, b = 8 against JAX's split on a mesh of four
    CPU devices from the same hyperparameters and data (1e-10); K = 21
    cannot split the training axis four ways."""
    f = dict(sharded=tmesh.sharded_predict_fullmat,
             trainaxis=tmesh.trainaxis_sharded_predict_fullmat)[fn]
    mesh = tmesh.make_mesh(4, "cpu")
    gp, params, data, cache, Xtest = _posterior_case(24, 7, 5, masked_tail=5)
    mean, var = gp.predict_fullmat(params, data, cache, Xtest)
    got_mean, got_var = f(gp, params, data, cache, Xtest, mesh)
    _close(got_mean, mean.numpy())
    _close(got_var, var.numpy())
    gp, params, data, cache, Xtest = _posterior_case(24, 8, 5, masked_tail=5)
    jgp = jm.make_mvgp(3, 2)
    jparams = jm.MVGPParams(**{k: jnp.asarray(v[0]) for k, v in
                               interop.mvgp_params_to_numpy(params).items()})
    jdata = jm.MVGPData(*(jnp.asarray(a[0].numpy()) for a in data))
    jcache = jgp.refresh_cache(jparams, jdata)
    jf = dict(sharded=jmesh.sharded_predict_fullmat,
              trainaxis=jmesh.trainaxis_sharded_predict_fullmat)[fn]
    want = jf(jgp, jparams, jdata, jcache, jnp.asarray(Xtest[0].numpy()),
              jmesh.make_mesh(4, axis_names=("tp",)))
    for g, w in zip(f(gp, params, data, cache, Xtest, mesh), want):
        _close(g[0], w)
    if fn == "trainaxis":
        with pytest.raises(ValueError, match="divisible"):
            f(*_posterior_case(21, 3, 6), mesh)


def test_make_mesh():
    assert tmesh.make_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert tmesh.make_mesh(device_type="cpu") == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            tmesh.make_mesh()
