"""The cache refresh's factorization on CUDA (ops/chol_kernels.chol_linv:
blocked factor, L copied out, L^{-1} by block rows in place, copied out),
step by step in plain PyTorch on the CPU (`chol_linv_blocked_plain`),
against the JAX package's Pallas kernel of the same algorithm in interpret
mode; the kernel's two copy-outs written as tensor code on its working
matrix; and the wrapper's dispatch.  The CUDA kernel itself is tested on
the card by tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.ops.pallas_chol import batched_chol_with_inv
from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.ops import chol_kernels as ck


def _trajectory_gram(k, seed, step=0.02, nug=2.5e-4):
    """Random-walk RBF Gram: the conditioning of a real fit buffer."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(step * rng.normal(size=(k, 3)), 0)
    d = X[:, None, :] - X[None, :, :]
    return np.exp(-0.5 * np.sum(d * d, -1)) + nug * np.eye(k)


def _masked(K, filled):
    """The refresh's masked Gram of a reservoir with `filled` rows in use:
    identity rows and columns for the empty slots (`MVGP.masked_kb`)."""
    m = (np.arange(K.shape[-1]) < filled).astype(K.dtype)
    return K * (m[:, None] * m[None, :]) + np.diag(1.0 - m)


def _spd(n, seed):
    A = np.random.default_rng(seed).normal(size=(n, n))
    return A @ A.T / n + np.eye(n)


def _grams(n, seed):
    """A well-conditioned SPD matrix, two full trajectory Grams and one of
    a partly filled buffer."""
    return np.stack([_spd(n, seed), _trajectory_gram(n, seed),
                     _trajectory_gram(n, seed + 1),
                     _masked(_trajectory_gram(n, seed + 2), (2 * n) // 3)]
                    ).astype(np.float32)


@pytest.mark.parametrize("nb", [8, 16, 32])
@pytest.mark.parametrize("n", [50, 70, 200])
def test_chol_linv_steps_match_pallas_interpret(n, nb):
    K = _grams(n, 5 * n + nb)
    L, Linv = ck.chol_linv_blocked_plain(torch.tensor(K), nb)
    assert tuple(L.shape) == (4, n, n) and tuple(Linv.shape) == (4, n, n)
    assert L.is_contiguous() and Linv.is_contiguous()
    jL, jLinv = batched_chol_with_inv(jnp.asarray(K), interpret=True, nb=nb,
                                      assembly="kernel")
    K64 = K.astype(np.float64)
    L64 = np.linalg.cholesky(K64)
    rel = lambda a, b: (np.abs(a - b).max((-1, -2))
                        / np.abs(b).max((-1, -2)))
    for got, want, exact in ((L.numpy(), np.asarray(jL), L64),
                             (Linv.numpy(), np.asarray(jLinv),
                              np.linalg.inv(L64))):
        assert np.all(np.triu(got, 1) == 0.0)
        assert np.all(np.triu(want, 1) == 0.0)
        # well-conditioned SPD: two f32 roundings of one algorithm agree
        # to 1e-4 of the largest entry
        assert rel(got, want)[0] < 1e-4
        # trajectory Grams (condition number 1e5 to 8e5, so ~4e2 to 9e2 for
        # L): f32 roundoff reaches 1e-3 to 4e-3 of L^{-1}'s largest entry
        # in either version, more at a larger block (the explicit inverses
        # of the diagonal blocks); both are held to 1e-2 of the f64 factor
        # and of each other
        for a, b in ((got, want), (got, exact), (want, exact)):
            assert np.all(rel(a, b)[1:] < 1e-2)
    # L itself is within 2e-4 on every matrix
    assert np.all(rel(L.numpy(), np.asarray(jL)) < 2e-4)
    Ld = L.numpy().astype(np.float64)
    eye = np.eye(n)
    # the f32 refresh bars of the JAX package's kernel tests
    assert np.abs(Linv.numpy().astype(np.float64) @ Ld - eye).max() < 5e-2
    assert (np.abs(Ld @ Ld.transpose(0, 2, 1) - K64).max()
            / np.abs(K64).max()) < 1e-5


def _store_lower(A, n):
    """`store_lower` of csrc/chol.cu as tensor code: the leading n x n of
    the working matrix, zero above the diagonal."""
    return torch.tril(A[:, :n, :n]).contiguous()


@pytest.mark.parametrize("n,nb", [(1, 16), (17, 16), (70, 8), (70, 32),
                                  (200, 16)])
def test_copy_outs_of_the_working_matrix(n, nb):
    """The kernel's working matrix after the factor holds L in its lower
    block triangle and anything above the diagonal inside the diagonal
    blocks; after the row assembly its lower triangle holds L^{-1}.  Both
    copy-outs cut to (n, n) and zero the upper triangle."""
    K = torch.tensor(_grams(n, n + nb)).double()
    L, Dinv = ck.chol_dinv_plain(K, nb)
    N = L.shape[-1]
    junk = torch.triu(torch.full((N, N), 7.0, dtype=K.dtype), 1)
    blocks = torch.block_diag(*[torch.ones(nb, nb, dtype=K.dtype)] * (N // nb))
    A = L + junk * blocks            # as factor<W, false> may leave it
    want_L, want_Linv = ck.chol_linv_blocked_plain(K, nb)
    assert torch.equal(_store_lower(A, n), want_L)
    A = ck.assemble_linv(L, Dinv, nb, "row")
    assert torch.equal(_store_lower(A, n), want_Linv)
    assert float(torch.triu(want_L, 1).abs().max()) == 0.0
    assert float(torch.triu(want_Linv, 1).abs().max()) == 0.0
    eye = torch.eye(n, dtype=K.dtype)
    assert float((want_Linv @ want_L - eye).abs().max()) < 1e-9


def test_blocked_plain_default_is_the_wrappers_block_size():
    K = torch.tensor(_grams(40, 0))
    for g, w in zip(ck.chol_linv_blocked_plain(K),
                    ck.chol_linv_blocked_plain(K, ck.LINV_NB)):
        assert torch.equal(g, w)
    assert ck.LINV_NB in (8, 16, 32)


@pytest.mark.parametrize("nb", [8, 16, 32])
def test_chol_linv_cpu_dispatch_ignores_block_size(nb):
    """On the CPU the wrapper takes `chol_linv_plain`, whatever nb, and
    counts no launch."""
    K = torch.tensor(_grams(9, 1)).double()
    with tracing.recording():
        for g, w in zip(ck.chol_linv(K, nb), ck.chol_linv_plain(K)):
            assert torch.equal(g, w)
    assert "launches.chol_linv" not in tracing.report()["counters"]


def test_chol_linv_raises_off_cpu_and_cuda():
    K = torch.empty((2, 4, 4), device="meta")
    with pytest.raises(ValueError):
        ck.chol_linv(K)
    with pytest.raises(ValueError):
        ck.chol_linv(K, 8)
