"""End-to-end parity of the PyTorch port's learn-and-control loop against
the JAX package on CPU, f64, plus the port's import hygiene and the smoke
script's refusal to run without a card.

The loop amplifies roundoff: each step's SOCP is solved by a fixed number
of IPM iterations that end at a KKT floor where the last digits of the
iterate depend on the summation order, and the Adam refits (whose first
steps are sign-like) amplify that further.  Measured on the JAX reference
itself, a 1e-14 perturbation of the start state moves the golden
episode's states by 7e-4 and its controls by 3.5e-3 relative.  The
end-to-end bars below sit at that floor; the first steps must agree to
roundoff as amplified by one IPM solve, and the feasibility flags exactly.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bayesian_cbf_tpu.experiments import unicycle as ju
from bayesian_cbf_tpu.sim.rollout import _simulate_unicycle_batch
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.experiments import unicycle as tu
from bayesian_cbf_tpu_torch.sim.rollout import simulate_unicycle_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
# the reference's own roundoff sensitivity (module docstring), with margin
X_ATOL = 2e-3
U_REL = 1e-2


def _jax_start(lrn, key, steps):
    """JAX's initial parameters and reservoir draws for one episode: the
    key chain of `init_state` and `record` (split, randint on
    [0, count_res], the accept rule of the reservoir)."""
    st = lrn.init_state(key, dtype=jnp.float64)
    params = {f: np.asarray(getattr(st.params, f)) for f in st.params._fields}
    key, cr, draws = st.key, 0, []
    for t in range(steps):
        key, kslot = jax.random.split(key)
        j = int(jax.random.randint(kslot, (), 0, max(cr + 1, 1)))
        draws.append(j)
        cr += int(t > 0 and (cr < lrn.max_train or j < lrn.max_train))
    return params, draws


def _u_rel(U, ref):
    return np.abs(U - ref).max(-1) / (1.0 + np.abs(ref).max(-1))


def test_golden_episode_reproduced():
    """tests/data/golden_e2e_unicycle.npz: 40 steps, dt 0.01, K=24, 10
    Adam iterations, refit every 15 steps, PRNGKey(7)."""
    ref = np.load(os.path.join(REPO, "tests", "data",
                               "golden_e2e_unicycle.npz"))
    kw = dict(numSteps=40, dt=0.01, max_train=24, training_iter=10,
              train_every_n_steps=15)
    jsim = ju.make_ackermann_tracking_sim(**kw)
    params, draws = _jax_start(jsim.learned_dynamics, jax.random.PRNGKey(7),
                               40)
    sim = tu.make_ackermann_tracking_sim(**kw, device="cpu", dtype=F64)
    state0 = interop.learned_state_from_numpy(
        sim.learned_dynamics, {k: v[None] for k, v in params.items()},
        "cpu", F64)
    out = simulate_unicycle_batch(
        sim, torch.tensor([tu.STATE_START], dtype=F64), state0=state0,
        draws=torch.tensor(draws)[:, None])
    X, U = out.X[0].numpy(), out.U[0].numpy()
    # the first steps: roundoff, amplified only by the IPM's floor (a gain
    # of ~1e7 per solve, measured)
    assert np.abs(X[:6] - ref["X"][:6]).max() < 1e-9
    assert _u_rel(U[:6], ref["U"][:6]).max() < 1e-7
    assert np.abs(X - ref["X"]).max() < X_ATOL
    assert _u_rel(U, ref["U"]).max() < U_REL
    np.testing.assert_array_equal(out.info.feasible[0].numpy(),
                                  ref["feasible"] > 0.5)


def test_batched_episodes_match_jax_batch_runner():
    """B=3 with warm-started SOCPs, the two-stage first fit (stride 2)
    and a reduced warm-refit budget, against `_simulate_unicycle_batch`."""
    kw = dict(numSteps=40, dt=0.01, max_train=24, training_iter=10,
              train_every_n_steps=15, warm_start=True, training_iter_warm=4,
              first_fit_coarse_stride=2, first_fit_refine_iter=3)
    B = 3
    jsim = ju.make_ackermann_tracking_sim(**kw)
    x0s = np.asarray(ju.STATE_START)[None] + 0.05 * \
        np.random.default_rng(0).normal(size=(B, 3))
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    want = jax.jit(lambda a, k: _simulate_unicycle_batch(jsim, a, k))(
        jnp.asarray(x0s), keys)
    starts = [_jax_start(jsim.learned_dynamics, k, 40) for k in keys]
    sim = tu.make_ackermann_tracking_sim(**kw, device="cpu", dtype=F64)
    state0 = interop.learned_state_from_numpy(
        sim.learned_dynamics,
        {f: np.stack([p[f] for p, _ in starts]) for f in starts[0][0]},
        "cpu", F64)
    draws = torch.tensor([d for _, d in starts]).T
    out = simulate_unicycle_batch(sim, torch.tensor(x0s), state0=state0,
                                  draws=draws)
    X, U = out.X.numpy(), out.U.numpy()
    Xw, Uw = np.asarray(want.X), np.asarray(want.U)
    # before the first refit only the warm-started IPM floor separates them
    assert np.abs(X[:, :16] - Xw[:, :16]).max() < 1e-6
    assert _u_rel(U[:, :16], Uw[:, :16]).max() < 1e-4
    assert np.abs(X - Xw).max() < X_ATOL
    assert _u_rel(U, Uw).max() < U_REL
    np.testing.assert_array_equal(out.info.feasible.numpy(),
                                  np.asarray(want.info.feasible))


def test_port_imports_no_jax():
    """Every module of the port, and the port's outcome gate
    scripts/check_outcomes_torch.py, import with JAX made unimportable."""
    code = (
        "import sys, pkgutil, importlib, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['bayesian_cbf_tpu'] = None\n"
        "import bayesian_cbf_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'bayesian_cbf_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "spec = importlib.util.spec_from_file_location('gate', "
        "'scripts/check_outcomes_torch.py')\n"
        "gate = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(gate)\n"
        "assert callable(gate.main) and callable(gate.verdicts)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20


def test_chip_smoke_refuses_cpu():
    """Without a card the smoke script exits non-zero before building
    anything and prints no result line."""
    code = ("import runpy, torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "[build]" not in res.stdout and '"ok"' not in res.stdout
    assert "CUDA is not available" in res.stderr
