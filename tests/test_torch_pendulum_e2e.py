"""End-to-end parity of the port's batched pendulum loop against the JAX
package's `run_pendulum_online_batch` on CPU, f64, in the two forms
`bench.py` runs, scaled to a short run: continuous rank-1 updates with a
sparse two-stage first fit and reduced warm refits, and the reference
schedule (a refit every 10 steps).

The port is fed JAX's random numbers (initial weights, reservoir draws
and exploration uniforms from the JAX key chain) and JAX's start states.
The loop amplifies roundoff: each step ends at the IPM's KKT floor after
a fixed number of iterations, and with continuous updates each step's
control enters the next step's posterior at once.  Measured on the JAX
reference itself, a 1e-14 perturbation of the start states moves the
continuous-updates run by 2.5e-5 in X and 9.6e-3 in U before its first
refit (the reference schedule: 1e-8 and 6e-6), and by 2.5e-5 / 1.1e-5
in X over the whole run.  So the states are held at 1e-4 before the first
refit and every run at the bars of tests/test_torch_e2e.py; the
feasibility and certification flags must agree exactly before the first
refit.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.experiments import pendulum as jp
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.experiments import pendulum as tp
from bayesian_cbf_tpu_torch.experiments import unicycle as tu

F64 = torch.float64
B, T, K = 3, 30, 12
X_ATOL = 2e-3
U_REL = 1e-2
CONFIGS = {
    "continuous": dict(continuous_updates=True, train_every_n_steps=12,
                       training_iter_warm=5, first_fit_coarse_stride=3,
                       first_fit_refine_iter=5),
    "reference_schedule": dict(train_every_n_steps=10, training_iter_warm=4),
}


def _jax_randoms(lrn, seed=0):
    """The random numbers of JAX's `run_pendulum_online_batch`: per
    episode, the initial parameters (`init_state`), the reservoir draws
    (`record`: split, randint on [0, count_res]) and the exploration
    uniforms (`perturb`: split, uniform on [0, 1) before scaling)."""
    kd, ks = jax.random.split(jax.random.PRNGKey(seed))
    params, draws, noise = [], [], []
    for kb, ke in zip(jax.random.split(kd, B), jax.random.split(ks, B)):
        st = lrn.init_state(kb, dtype=jnp.float64)
        params.append({f: np.asarray(getattr(st.params, f))
                       for f in st.params._fields})
        key, cr, d = st.key, 0, []
        for t in range(T):
            key, kslot = jax.random.split(key)
            j = int(jax.random.randint(kslot, (), 0, max(cr + 1, 1)))
            d.append(j)
            cr += int(t > 0 and (cr < lrn.max_train or j < lrn.max_train))
        draws.append(d)
        u = []
        for t in range(T):
            ke, kt = jax.random.split(ke)
            u.append(np.asarray(jax.random.uniform(kt, (1,), jnp.float64)))
        noise.append(u)
    return ({f: np.stack([p[f] for p in params]) for f in params[0]},
            np.array(draws).T, np.array(noise).transpose(1, 0, 2))


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    kw = dict(numSteps=T, max_train=K, training_iter=10,
              **CONFIGS[request.param])
    x0s = np.array([tp.THETA0, 0.0]) + 0.05 * np.random.default_rng(0) \
        .normal(size=(B, 2))
    jsim = jp.make_pendulum_online_sim(**kw)
    X, U, Xdot, info = jp.run_pendulum_online_batch(jsim, jnp.asarray(x0s))
    want = dict(X=np.asarray(X), U=np.asarray(U),
                feasible=np.asarray(info["feasible"]),
                certified=np.asarray(info["certified"]))
    params, draws, noise = _jax_randoms(jsim.learned)
    sim = tp.make_pendulum_online_sim(**kw, device="cpu", dtype=F64)
    state0 = interop.learned_state_from_numpy(sim.learned, params, "cpu",
                                              F64)
    out = tp.run_pendulum_online_batch(
        sim, x0s, state0=state0, draws=torch.tensor(draws),
        noise=torch.tensor(noise))
    return sim, out, want


def _u_rel(U, ref):
    return np.abs(U - ref).max(-1) / (1.0 + np.abs(ref).max(-1))


def test_states_and_controls_match_jax(runs):
    sim, out, want = runs
    X, U = out.X.numpy(), out.U.numpy()
    first = sim.learned.train_every_n_steps + 1
    assert np.abs(X[:, :first] - want["X"][:, :first]).max() < 1e-4
    assert np.abs(X - want["X"]).max() < X_ATOL
    assert _u_rel(U, want["U"]).max() < U_REL


def test_flags_match_jax(runs):
    sim, out, want = runs
    first = sim.learned.train_every_n_steps + 1
    np.testing.assert_array_equal(out.info.feasible.numpy()[:, :first],
                                  want["feasible"][:, :first])
    np.testing.assert_array_equal(out.info.certified.numpy()[:, :first],
                                  want["certified"][:, :first])
    assert out.info.feasible.numpy().mean() >= 0.95
    # certified fractions over the whole run agree to one step in ten
    assert abs(out.info.certified.numpy().mean()
               - want["certified"].mean()) <= 0.1
    assert float(tp.pendulum_damage_fraction(out.X[..., 0]).max()) == 0.0


def test_defaults_name_the_card():
    """Both experiment entry points run on the card in f32 unless the
    caller asks for the CPU; read off without building on the card."""
    for fn in (tu.make_ackermann_tracking_sim, tp.make_pendulum_online_sim):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda"
        assert params["dtype"].default is torch.float32
    sim = tp.make_pendulum_online_sim()
    assert sim.device == torch.device("cuda") and sim.dtype is torch.float32
