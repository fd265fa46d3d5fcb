"""The one-sweep fit inverse (`"sweep_full"`, ops/sweep_kernels with
base = full_base(n)) against the JAX package's Pallas kernel in interpret
mode at base 256, and the shape dispatch between csrc/sweep.cu's two
kernels.  The kernels themselves are tested on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.ops import pallas_sweep as jps
from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.ops import sweep_kernels as sk


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(2, n, n))
    return (A @ A.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)


def _trajectory_gram(n, seed, step=0.02, nug=2.5e-4):
    """A random-walk RBF Gram: the conditioning of a real fit buffer."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(step * rng.normal(size=(n, 3)), 0)
    d = X[:, None, :] - X[None, :, :]
    return (np.exp(-0.5 * np.sum(d * d, -1)) + nug * np.eye(n)).astype(
        np.float32)[None]


@pytest.mark.parametrize("kind", ["spd", "trajectory"])
@pytest.mark.parametrize("n", [50, 70, 200])
def test_sweep_full_plain_matches_pallas_interpret(n, kind):
    """The TPU kernel sweeps the identity-padded 256 x 256 block; its pad
    pivots (d = 1, no coupling) are exact no-ops on the n x n block, which
    the plain version sweeps alone.  f32 on both sides: the inverse within
    1e-5 of its largest entry, the logdet within 1e-5 relative."""
    K = _spd(n, n) if kind == "spd" else _trajectory_gram(n, n + 3)
    assert sk.full_base(n) == 256
    Kinv, ld = sk.batched_kinv_logdet_plain(torch.tensor(K), sk.full_base(n))
    jKinv, jld = jps.batched_kinv_logdet(jnp.asarray(K), interpret=True,
                                         chunk=1, base=256)
    jKinv, jld = np.asarray(jKinv), np.asarray(jld)
    assert np.all(np.isfinite(Kinv.numpy()))
    np.testing.assert_allclose(Kinv.numpy(), jKinv, rtol=0,
                               atol=1e-5 * np.abs(jKinv).max())
    np.testing.assert_allclose(ld.numpy(), jld, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n,base,route", [
    (1, 256, ("regs", 0)), (50, 256, ("regs", 0)), (64, 256, ("regs", 0)),
    (65, 256, ("regs", 1)), (200, 256, ("regs", 1)),
    (224, 256, ("regs", 1)), (225, 256, ("events", None)),
    (1024, 1024, ("events", None)), (200, 8, ("events", None)),
    (50, 8, ("events", None)), (300, 16, ("events", None)),
    # a recursive schedule at n <= base is one sweep of all n pivots
    (5, 8, ("regs", 0))])
def test_sweep_route_picks_the_kernel_by_shape(n, base, route):
    """One SWEEP of all n pivots with n within an instance's limit takes the
    register kernel's smallest instance that holds n; every other schedule
    takes the event kernel."""
    events = sk.schedule(n, base)
    assert sk.sweep_route(n, events) == route
    assert sk._route(n, base) == route
    if route[0] == "regs":
        assert n <= sk.REGS_LIMITS[route[1]]
        assert route[1] == 0 or n > sk.REGS_LIMITS[route[1] - 1]


def test_sweep_route_is_the_full_sweep_of_the_fit():
    """`"sweep_full"` at the fit's orders (the unicycle's coarse first
    stage n = 50 and its buffer n = 200) is one sweep, the register
    kernel's; a sweep of part of the pivots is not."""
    assert sk.sweep_route(50, sk.schedule(50, sk.full_base(50)))[0] == "regs"
    assert sk.sweep_route(200, sk.schedule(200, sk.full_base(200)))[0] == \
        "regs"
    assert sk.sweep_route(50, [(sk.SWEEP, 0, 40, 0)]) == ("events", None)
    assert sk.sweep_route(50, [(sk.SWEEP, 0, 25, 0), (sk.SWEEP, 25, 25, 0)]) \
        == ("events", None)


@pytest.mark.parametrize("n", [50, 200])
def test_sweep_full_cpu_tensor_takes_the_plain_version(n):
    """A CPU tensor runs the plain version and counts no launch, at the
    full base too; the private launchers and another device raise."""
    K = torch.tensor(_spd(n, 1))
    with tracing.recording():
        got = sk.batched_kinv_logdet(K, sk.full_base(n))
    want = sk.batched_kinv_logdet_plain(K, sk.full_base(n))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert "launches.batched_kinv_logdet" not in tracing.report()["counters"]
    with pytest.raises(ValueError):
        sk._launch_regs(K, 0)
    with pytest.raises(ValueError):
        sk._launch_events(K, sk.full_base(n))
    with pytest.raises(ValueError):
        sk.batched_kinv_logdet(torch.empty((2, n, n), device="meta"),
                               sk.full_base(n))
