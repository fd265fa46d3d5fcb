"""Parity of the port's blocked factor-and-solve ops (TPU kernels 6 and
7: `cholsolve_logdet`, `solve_with_factor`) against the JAX package's
Pallas kernels in interpret mode, on CPU.

On a CPU tensor the ops run their plain versions: cuSOLVER's factor of
the identity-padded K with triangular-solved diagonal-block inverses,
then the block sweeps.  In f32 they are held to the JAX kernels at the
bars of tests/test_ops.py (2e-4; the factors are the same unique factor,
computed in another order), and in f64 to numpy's solve at roundoff.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.ops.pallas_chol import (batched_cholsolve_logdet,
                                              batched_solve_with_factor)
from bayesian_cbf_tpu_torch.ops import chol_kernels as ck


def _case(B, n, r, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    K = (A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(n)).astype(dtype)
    return K, rng.normal(size=(B, n, r)).astype(dtype)


@pytest.mark.parametrize("B,n,r,nb", [(3, 50, 11, 16), (2, 32, 1, 16),
                                      (2, 7, 3, 32)])
def test_cholsolve_logdet_matches_jax_kernel(B, n, r, nb):
    K, R = _case(B, n, r, seed=n)
    want = batched_cholsolve_logdet(jnp.asarray(K), jnp.asarray(R),
                                    interpret=True, nb=nb)
    got = ck.cholsolve_logdet(torch.tensor(K), torch.tensor(R), nb)
    N = ck.padded_order(n, nb)
    for g, w, shape in zip(got, want, ((B, n, r), (B, N, N), (B, N, nb),
                                       (B,))):
        assert tuple(g.shape) == shape == w.shape
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5, atol=1e-4)
    # the saved factor, the port's and JAX's, solves a narrower RHS
    sub = np.ascontiguousarray(R[:, :, :max(1, r // 3)])
    want2 = batched_solve_with_factor(want[1], want[2], jnp.asarray(sub),
                                      interpret=True, nb=nb)
    got2 = ck.solve_with_factor(got[1], got[2], torch.tensor(sub), nb)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("n,nb", [(50, 16), (64, 32), (1, 32)])
def test_cholsolve_f64_is_exact_to_roundoff(n, nb):
    K, R = _case(3, n, 5, seed=n + 1, dtype=np.float64)
    sol, L, Dinv, ld = ck.cholsolve_logdet(torch.tensor(K), torch.tensor(R),
                                           nb)
    exact = np.linalg.solve(K, R)
    scale = np.abs(exact).max()
    assert np.abs(sol.numpy() - exact).max() < 1e-10 * scale
    assert np.abs(ld.numpy() - np.linalg.slogdet(K)[1]).max() < 1e-10
    sol2 = ck.solve_with_factor(L, Dinv, torch.tensor(R), nb)
    assert np.abs(sol2.numpy() - exact).max() < 1e-10 * scale
    # L is the identity-padded factor: zero above the diagonal, identity
    # beyond n, and Dinv holds the inverses of its diagonal blocks
    Ln = L.numpy()
    N = Ln.shape[-1]
    assert np.all(np.triu(Ln, 1) == 0)
    np.testing.assert_allclose(Ln[:, n:, n:], np.broadcast_to(
        np.eye(N - n), (3, N - n, N - n)), atol=0)
    for o in range(0, N, nb):
        blk = Dinv.numpy()[:, o:o + nb] @ Ln[:, o:o + nb, o:o + nb]
        np.testing.assert_allclose(blk, np.broadcast_to(np.eye(nb), blk.shape),
                                   atol=1e-10)


def test_cholsolve_cuda_checks_fail_without_a_card():
    """A non-CPU tensor never takes the plain version: the checks run
    before any build (a meta tensor stands in for a card's)."""
    K = torch.empty((2, 4, 4), device="meta")
    with pytest.raises(ValueError):
        ck.cholsolve_logdet(K, torch.empty((2, 4, 1), device="meta"))
    with pytest.raises(ValueError):
        ck.solve_with_factor(torch.empty((2, 32, 32), device="meta"),
                             torch.empty((2, 32, 32), device="meta"),
                             torch.empty((2, 4, 1), device="meta"))
