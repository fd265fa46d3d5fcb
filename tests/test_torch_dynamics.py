"""The port's mean-dynamics classes and the learner's prior moments
(models/dynamics.py) against the JAX package on CPU, f64, on inputs made
with numpy from a seed: closed-form arithmetic in the same order, so the
bars are roundoff (1e-14 relative to each output's magnitude)."""
import math

import jax
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.experiments import pendulum as jp
from bayesian_cbf_tpu.models import dynamics as jd
from bayesian_cbf_tpu_torch.experiments import pendulum as tp
from bayesian_cbf_tpu_torch.models import dynamics as td

F64 = torch.float64


def _close(got, want, rtol=1e-14):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rtol * scale


def _states(seed, n=6):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-math.pi, math.pi, n),
                     rng.normal(0.0, 2.0, n)], -1)


MEANS = {"zero": (jd.ZeroDynamics(state_size=2, ctrl_size=1),
                  td.ZeroDynamics(state_size=2, ctrl_size=1)),
         "pendulum": (jd.PendulumDynamics(mass=1.3, gravity=9.0, length=0.7),
                      td.PendulumDynamics(mass=1.3, gravity=9.0, length=0.7))}


@pytest.mark.parametrize("mean", sorted(MEANS))
def test_moments_without_learning_default_to_unit_prior_covariance(mean):
    """A mean model without `kernel_diag_A` gives A = I, as in JAX."""
    jmd, tmd = MEANS[mean]
    jl = jp.make_pendulum_online_sim(max_train=8).learned._replace(
        mean_dynamics=jmd, enable_learning=False)
    tl = tp.make_pendulum_online_sim(
        max_train=8, device="cpu", dtype=F64).learned._replace(
        mean_dynamics=tmd, enable_learning=False)
    x = _states(0)
    want = jax.vmap(lambda xi: jl.moments(None, xi))(x)
    got = tl.moments(None, torch.tensor(x))
    for g, w in zip(got, want):
        _close(g, w)
    assert torch.equal(got[2][0], torch.eye(2, dtype=F64))


def test_pendulum_F_func_matches_jax():
    jmd, tmd = MEANS["pendulum"]
    x = _states(1)
    _close(tmd.F_func(torch.tensor(x)), jax.vmap(jmd.F_func)(x))


def test_zero_dynamics_step_matches_jax():
    jmd, tmd = MEANS["zero"]
    x = _states(2)
    u = np.random.default_rng(3).uniform(-15, 15, (6, 1))
    want = jax.vmap(lambda a, b: jmd.step(a, b, 0.01))(x, u)
    got = tmd.step(torch.tensor(x), torch.tensor(u), 0.01)
    for g, w in zip(got, want):
        _close(g, w)
