"""Parity of the port's serving controller against the JAX package on the
CPU, f64: `deploy.CompiledController` ticks against JAX's on JAX's
`_small_sim` configuration (tests/test_deploy.py) across its refit at
t = 10, fed JAX's initial carry (`interop.serving_carry_from_numpy`) and
reservoir draws; tick by tick from JAX's carry (the serving `record`'s
rank-1 appends and full refreshes against JAX's); against the port's own
`simulate_unicycle`; measured-state injection; checkpoints (the port's
round trip and a JAX-saved one carried across); snapshots and the failed
tick; the continuous serving updates against the port's own
`refresh_cache` at JAX's bars; and the pendulum factory's row-gated
branch.

Bars.  The first control differs from JAX's by 3e-12; the second by
7.8e-6 (the IPM's floor: JAX's own change under a 1e-14 start move is
1e-14 there, so the two solvers stop at different points of the floor).
Without continuous updates that difference stays below 1e-4 through the
refit (JAX's own tick-against-scan bar is 1e-3).  With continuous
updates the sample recorded the next tick carries it into a near-
duplicate Gram row (|Linv| ~ 800) and the controls drift to 3e-3; from
the same carry, one tick's cache agrees with JAX's to 3e-9 of its size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.deploy import CompiledController as JController
from bayesian_cbf_tpu.experiments import unicycle as ju
from bayesian_cbf_tpu.observability.logger import \
    save_checkpoint as j_save_checkpoint
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.deploy import CompiledController
from bayesian_cbf_tpu_torch.experiments import pendulum as tp
from bayesian_cbf_tpu_torch.experiments import unicycle as tu
from bayesian_cbf_tpu_torch.models import dynamics as td
from bayesian_cbf_tpu_torch.observability.logger import (load_checkpoint,
                                                         save_checkpoint)
from bayesian_cbf_tpu_torch.sim.rollout import simulate_unicycle

F64 = torch.float64
TICKS = 14
# JAX's _small_sim (tests/test_deploy.py:13-16): a refit at t = 10
SMALL = dict(numSteps=24, dt=0.01, max_train=16, training_iter=5,
             train_every_n_steps=10)
# continuous updates: the reservoir fills at t = 9 and a refit runs at
# t = 8, so the ticks cross appends, a refit and full refreshes
CONTINUOUS = dict(numSteps=24, dt=0.01, max_train=8, training_iter=5,
                  train_every_n_steps=8)


def _key_chain_draws(lrn, key, steps):
    """The reservoir draws of JAX's `record` key chain from `key`."""
    cr, draws = 0, []
    for t in range(steps):
        key, kslot = jax.random.split(key)
        j = int(jax.random.randint(kslot, (), 0, max(cr + 1, 1)))
        draws.append(j)
        cr += int(t > 0 and (cr < lrn.max_train or j < lrn.max_train))
    return draws


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _port(kw, continuous=None):
    sim = tu.make_ackermann_tracking_sim(**kw, device="cpu", dtype=F64)
    return CompiledController(sim, tu.STATE_START, device="cpu",
                              continuous_updates=continuous)


class _JaxRun:
    """JAX's controller ticked TICKS times: its carry before every tick
    (as numpy leaves), its controls, its reservoir draws, and the
    checkpoint its save_checkpoint wrote after 5 ticks."""

    def __init__(self, kw, ckpt, continuous=None):
        self.sim = ju.make_ackermann_tracking_sim(**kw)
        ctl = JController(self.sim, ju.STATE_START,
                          continuous_updates=continuous)
        self.draws = _key_chain_draws(self.sim.learned_dynamics,
                                      ctl.state()[1].key, TICKS + 1)
        self.carries, self.U = [], []
        for t in range(TICKS):
            if t == 5:
                j_save_checkpoint(ckpt, ctl.state())
            self.carries.append(_leaves(ctl.state()))
            self.U.append(ctl.tick()[0])
        self.carries.append(_leaves(ctl.state()))
        self.ctl, self.ckpt = ctl, ckpt


@pytest.fixture(scope="module")
def jax_small(tmp_path_factory):
    return _JaxRun(SMALL, str(tmp_path_factory.mktemp("jax") / "c.npz"))


@pytest.fixture(scope="module")
def jax_continuous(tmp_path_factory):
    return _JaxRun(CONTINUOUS, str(tmp_path_factory.mktemp("jax") / "c.npz"),
                   continuous=True)


def _from_jax(ctl, run, t):
    ctl.restore(interop.serving_carry_from_numpy(ctl.sim, run.carries[t]))
    ctl._t = t


def _rel(a, b):
    return np.abs(a - b).max() / (1.0 + np.abs(b).max())


def test_ticks_match_jax_controller(jax_small):
    """14 ticks from JAX's initial carry with its draws, across the refit
    at t = 10 (JAX's fit_now at the full budget inside the tick)."""
    ctl = _port(SMALL)
    _from_jax(ctl, jax_small, 0)
    for t in range(TICKS):
        u, info = ctl.tick(draw=jax_small.draws[t])
        assert u.shape == (2,) and info.pres.shape == ()
        bar = 1e-10 if t == 0 else 1e-4
        assert _rel(u, jax_small.U[t]) < bar, (t, u, jax_small.U[t])
    assert ctl.t == TICKS
    st, want = ctl.state()[1], jax_small.ctl.state()[1]
    assert int(st.count_res) == int(want.count_res)
    assert int(st.count_pairs) == int(want.count_pairs) == TICKS
    # the refit moved the hyperparameters as JAX's did
    np.testing.assert_allclose(st.params.raw_lengthscale[0].numpy(),
                               np.asarray(want.params.raw_lengthscale),
                               rtol=1e-3)


@pytest.mark.parametrize("which", ["small", "continuous"])
def test_tick_by_tick_from_jax_carry(jax_small, jax_continuous, which):
    """Each tick from JAX's carry before it: the next carry (the recorded
    sample, the refit, the rank-1 appends and full refreshes) against
    JAX's after it.  The recorded sample is the carry's, so the cache
    sees the same inputs; the state after the tick moves with u."""
    run, kw, cu = ((jax_small, SMALL, None) if which == "small"
                   else (jax_continuous, CONTINUOUS, True))
    ctl = _port(kw, cu)
    for t in range(TICKS):
        _from_jax(ctl, run, t)
        u, _ = ctl.tick(draw=run.draws[t])
        assert _rel(u, run.U[t]) < 1e-4, (t, u, run.U[t])
        got = ctl.state()
        want = interop.serving_carry_from_numpy(ctl.sim, run.carries[t + 1])
        # x moves with u over dt 0.01: |du| < 1e-4 (1 + |u|), |u| < 10
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                   atol=1e-5)
        g, w = got[1], want[1]
        for name in ("count_pairs", "count_res", "have_prev"):
            assert torch.equal(getattr(g, name), getattr(w, name)), (t, name)
        # alpha = Kb^-1 Y: roundoff times cond(Kb) ~ |Linv|^2 ~ 1e6 here
        for part, bar in (("buf", 1e-12), ("data", 1e-12), ("cache", 1e-7)):
            for a, b in zip(getattr(g, part), getattr(w, part)):
                scale = 1.0 + float(b.abs().max())
                assert float((a - b).abs().max()) < bar * scale, (t, part)
        for a, b in zip(g.params, w.params):
            assert float((a - b).abs().max()) < 1e-7, (t, "params")


def test_ticks_match_simulate_unicycle():
    """12 ticks against the port's own rollout from the same generator
    (the tick's refit is fit_now, the rollout's fit_now_first: the same
    program at this configuration) at JAX's bar of 1e-3."""
    sim = tu.make_ackermann_tracking_sim(**SMALL, device="cpu", dtype=F64)
    out = simulate_unicycle(sim, tu.STATE_START,
                            torch.Generator().manual_seed(0))
    ctl = CompiledController(sim, tu.STATE_START,
                             torch.Generator().manual_seed(0), device="cpu")
    for t in range(12):
        u, _ = ctl.tick()
        np.testing.assert_allclose(u, out.U[t].numpy(), rtol=1e-3, atol=1e-3,
                                   err_msg="tick %d" % t)
    assert ctl.t == 12


def test_measured_state_injection():
    """An injected plant state replaces the propagated one: the next
    carry is one Euler step from it."""
    ctl = _port(SMALL)
    ctl.tick()
    x_meas = np.asarray(tu.STATE_START) + np.array([0.3, -0.2, 0.1])
    u, _ = ctl.tick(x_measured=x_meas)
    x_next = ctl.state()[0]
    x_ref, _ = ctl.sim.true_dynamics.step(
        torch.tensor(x_meas[None]), torch.tensor(u[None]), ctl.sim.dt)
    np.testing.assert_allclose(x_next.numpy(), x_ref.numpy(), rtol=1e-12)


def test_checkpoint_roundtrip(tmp_path):
    """The port's save and load: the next tick from the restored carry is
    the live controller's, bit for bit; a wrong target raises."""
    ctl = _port(SMALL)
    for _ in range(5):
        ctl.tick(draw=0)
    snap = ctl.state()
    path = str(tmp_path / "carry.npz")
    save_checkpoint(path, snap)
    u6, _ = ctl.tick(draw=3)
    ctl2 = _port(SMALL)
    ctl2.restore(load_checkpoint(path, like=ctl2.state()))
    ctl2._t = 5
    u6b, _ = ctl2.tick(draw=3)
    np.testing.assert_array_equal(u6b, u6)
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, like=(snap[0],))
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(path, like=(snap[0], snap[1]._replace(
            params=tuple(snap[1].params))))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, like=(snap[0][:, :2],) + snap[1:])


def test_jax_checkpoint_carried_across(jax_small):
    """A checkpoint JAX saved after 5 ticks, read with numpy and carried
    across: the port's next ticks follow JAX's (same bar as the ticks)."""
    with np.load(jax_small.ckpt) as z:
        leaves = [z["arr_%d" % i] for i in range(len(z.files))]
    ctl = _port(SMALL)
    ctl.restore(interop.serving_carry_from_numpy(ctl.sim, leaves))
    ctl._t = 5
    for t in range(5, 9):
        u, _ = ctl.tick(draw=jax_small.draws[t])
        assert _rel(u, jax_small.U[t]) < 1e-4, (t, u, jax_small.U[t])


def test_state_snapshot_survives_next_tick():
    ctl = _port(SMALL)
    ctl.tick()
    snap = ctl.state()
    before = [a.clone() for a in td._leaves(snap)]
    ctl.tick()
    assert all(torch.equal(a, b) for a, b in zip(td._leaves(snap), before))
    assert all(bool(torch.isfinite(a).all()) for a in td._leaves(snap)
               if a.is_floating_point())
    # restore clones in: ticking on does not touch the installed carry
    ctl.restore(snap)
    ctl.tick()
    assert all(torch.equal(a, b) for a, b in zip(td._leaves(snap), before))


def test_failed_tick_leaves_explicit_needs_restore_state():
    ctl = _port(SMALL)
    ctl.tick()
    snap = ctl.state()

    class _Boom(RuntimeError):
        pass

    real = ctl._step

    def boom(*a, **k):
        raise _Boom("transient device error")

    ctl._step = boom
    with pytest.raises(_Boom):
        ctl.tick()
    ctl._step = real
    with pytest.raises(RuntimeError, match="restore"):
        ctl.tick()
    with pytest.raises(RuntimeError, match="restore"):
        ctl.state()
    ctl.restore(snap)
    u, _ = ctl.tick()
    assert np.all(np.isfinite(u))


def test_serving_continuous_updates_tracks_refresh():
    """JAX's test: 12 ticks with no refit in the window, every accepted
    sample appended; the cache then equals a full refresh of the same
    buffer (L at rtol 2e-5 / atol 1e-6, alpha at 1e-6: the nugget drift
    of the appends) and the posterior mean through it equals the
    refresh's."""
    sim = tu.make_ackermann_tracking_sim(
        numSteps=40, dt=0.01, max_train=32, training_iter=4,
        train_every_n_steps=1000, device="cpu", dtype=F64)
    ctl = CompiledController(sim, tu.STATE_START, device="cpu",
                             continuous_updates=True)
    for _ in range(12):
        u, _ = ctl.tick()
        assert np.all(np.isfinite(u))
    x, st = ctl.state()[:2]
    gp = sim.learned_dynamics.gp
    full = gp.refresh_cache(st.params, st.buf)
    assert float(st.buf.mask.sum()) >= 10
    np.testing.assert_allclose(st.cache.L.numpy(), full.L.numpy(),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(st.cache.alpha.numpy(), full.alpha.numpy(),
                               rtol=1e-6, atol=1e-6)
    u0 = torch.zeros((1, 2), dtype=F64)
    m1 = gp.fu_mean(st.params, st.buf, st.cache, u0, x)
    m2 = gp.fu_mean(st.params, st.buf, full, u0, x)
    np.testing.assert_allclose(m1.numpy(), m2.numpy(), rtol=1e-6)


def test_serving_continuous_updates_with_refit_crossing(jax_continuous):
    """Appends, the refit at t = 8 and the full refreshes once the
    reservoir is full: after 14 ticks the cache is a full refresh of the
    snapshot under the current parameters (JAX's bar), the snapshot is
    the reservoir, and the controls follow JAX's within the drift the
    module docstring measures (3e-3)."""
    ctl = _port(CONTINUOUS, continuous=True)
    _from_jax(ctl, jax_continuous, 0)
    for t in range(TICKS):
        u, _ = ctl.tick(draw=jax_continuous.draws[t])
        assert _rel(u, jax_continuous.U[t]) < 5e-3, (t, u)
    st = ctl.state()[1]
    assert int(st.count_res) > CONTINUOUS["max_train"]
    gp = ctl.sim.learned_dynamics.gp
    full = gp.refresh_cache(st.params, st.data)
    np.testing.assert_allclose(st.cache.L.numpy(), full.L.numpy(),
                               rtol=1e-6, atol=1e-8)
    for a, b in zip(st.data, st.buf):
        assert torch.equal(a, b)


def test_serving_refreshes_once_full_and_counts_them():
    """Once the reservoir is full each accepted replacement refreshes the
    whole cache (one refresh_cache: its rungs add one episode), a
    rejected one leaves it; while it fills no refresh runs."""
    from bayesian_cbf_tpu_torch.observability import tracing
    sim = tu.make_ackermann_tracking_sim(
        numSteps=40, dt=0.01, max_train=4, training_iter=2,
        train_every_n_steps=1000, device="cpu", dtype=F64)
    ctl = CompiledController(sim, tu.STATE_START, device="cpu",
                             continuous_updates=True)
    gp = sim.learned_dynamics.gp
    refreshes, rungs = 0, 0
    for t in range(14):
        before = ctl.state()[1]
        with tracing.recording():
            ctl.tick(draw=(0, 9, 2)[t % 3] if t >= 5 else None)
        rungs += sum(v for k, v in tracing.report()["counters"].items()
                     if k.startswith("refresh.rung"))
        after = ctl.state()[1]
        accepted = int(after.count_res) > int(before.count_res)
        if accepted and int(before.count_res) >= 4:
            refreshes += 1
            full = gp.refresh_cache(after.params, after.buf)
            for a, b in zip(after.cache, full):
                assert torch.equal(a, b)
        elif not accepted:
            for a, b in zip(after.cache, before.cache):
                assert torch.equal(a, b)
    assert refreshes >= 3
    assert rungs == refreshes


def test_should_fit_at_and_observe():
    """should_fit_at is the schedule; observe records, then refits the
    episodes whose pair count was on it (with a non-empty reservoir)."""
    lrn = tu.make_ackermann_tracking_sim(
        max_train=8, training_iter=2, train_every_n_steps=3, device="cpu",
        dtype=F64).learned_dynamics
    counts = torch.tensor([0, 1, 3, 6, 7])
    assert lrn.should_fit_at(counts).tolist() == [False, False, True, True,
                                                  False]
    assert lrn.should_fit_at(3) and not lrn.should_fit_at(4)
    off = lrn._replace(enable_learning=False)
    assert not bool(off.should_fit_at(counts).any())
    gen = torch.Generator().manual_seed(0)
    st = lrn.init_state(2, gen, "cpu", F64)
    x = torch.tensor([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]], dtype=F64)
    u = torch.tensor([[0.5, 0.1], [0.2, -0.1]], dtype=F64)
    for _ in range(3):
        st = lrn.observe(st, x, u, generator=gen)
        x = x + 0.01
    # episode 0 on the schedule, episode 1 not
    st = st._replace(count_pairs=torch.tensor([3, 4], dtype=torch.int32))
    new = lrn.observe(st, x, u, generator=gen)
    assert not torch.equal(new.params.raw_lengthscale[0],
                           st.params.raw_lengthscale[0])
    assert torch.equal(new.params.raw_lengthscale[1],
                       st.params.raw_lengthscale[1])


def test_pendulum_factory_keeps_row_gated_branch():
    """The pendulum factory turns the serving branch off with continuous
    updates, as JAX's does: its record is the row-gated append (the same
    result with the flag set by hand) and never reads the host; a
    pendulum sim cannot be served, as in the JAX package."""
    sim = tp.make_pendulum_online_sim(max_train=6, continuous_updates=True,
                                      device="cpu", dtype=F64)
    lrn = sim.learned
    assert lrn.continuous_updates and not lrn.continuous_full_refresh
    assert tp.make_pendulum_online_sim(device="cpu",
                                       dtype=F64).learned.continuous_full_refresh
    gen = torch.Generator().manual_seed(1)
    st = lrn.init_state(3, gen, "cpu", F64)
    rng = np.random.default_rng(0)
    called = []
    real = td.LearnedShiftInvariantDynamics._serving_update
    td.LearnedShiftInvariantDynamics._serving_update = \
        lambda *a: called.append(1) or real(*a)
    try:
        for t in range(9):
            x = torch.tensor(rng.normal(size=(3, 2)))
            u = torch.tensor(rng.normal(size=(3, 1)))
            j = torch.tensor(rng.integers(0, t + 1, size=3))
            a = lrn.record(st, x, u, j=j)
            b = lrn._replace(continuous_full_refresh=False).record(st, x, u,
                                                                   j=j)
            assert all(torch.equal(p, q) for p, q in
                       zip(td._leaves(a), td._leaves(b)))
            st = a
    finally:
        td.LearnedShiftInvariantDynamics._serving_update = real
    assert not called
    with pytest.raises(NotImplementedError,
                       match="cannot serve a pendulum sim"):
        CompiledController(sim, [1.0, 0.0], device="cpu")


def test_controller_runs_on_the_card_by_default():
    """The default device is the card: without CUDA it raises unless the
    caller asks for the CPU."""
    sim = tu.make_ackermann_tracking_sim(**SMALL, device="cpu", dtype=F64)
    # with a card, the CPU sim is refused for living elsewhere
    with pytest.raises(ValueError if torch.cuda.is_available()
                       else RuntimeError, match="cpu"):
        CompiledController(sim, tu.STATE_START)
