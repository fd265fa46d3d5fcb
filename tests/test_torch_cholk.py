"""The fit inverse's algorithm on CUDA (ops/chol_kernels.kinv_logdet:
blocked factor, L^{-1} by block rows, L^{-T} L^{-1}, logdet), step by step
in plain PyTorch on the CPU, against the JAX package's Pallas kernel of
the same algorithm in interpret mode and against the port's dispatch
target `kinv_logdet_plain`; and the kernel's in-place row assembly,
written as tensor code on one matrix in the kernel's order of reads and
writes, against `assemble_linv`.  The CUDA kernel itself is tested on the
card by tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.ops.pallas_chol import batched_kinv_logdet_chol
from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.ops import chol_kernels as ck


def _trajectory_gram(k, seed, step=0.02, nug=2.5e-4):
    """Random-walk RBF Gram: the conditioning of a real fit buffer."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(step * rng.normal(size=(k, 3)), 0)
    d = X[:, None, :] - X[None, :, :]
    return np.exp(-0.5 * np.sum(d * d, -1)) + nug * np.eye(k)


def _spd(n, seed):
    A = np.random.default_rng(seed).normal(size=(n, n))
    return A @ A.T / n + np.eye(n)


@pytest.mark.parametrize("nb", [16, 32])
@pytest.mark.parametrize("n", [1, 17, 50, 70, 200])
def test_kinv_logdet_steps_match_pallas_interpret_and_plain(n, nb):
    K = np.stack([_spd(n, 3 * n), _trajectory_gram(n, 3 * n)]).astype(
        np.float32)
    Kinv, ld = ck.kinv_logdet_blocked_plain(torch.tensor(K), nb)
    assert tuple(Kinv.shape) == (2, n, n) and tuple(ld.shape) == (2,)
    jKinv, jld = batched_kinv_logdet_chol(jnp.asarray(K), interpret=True,
                                          nb=nb)
    pKinv, pld = ck.kinv_logdet_plain(torch.tensor(K))
    Kinv, ld = Kinv.numpy().astype(np.float64), ld.numpy()
    # well-conditioned SPD: f32 factorizations agree elementwise
    for other in (np.asarray(jKinv, np.float64), pKinv.numpy()):
        np.testing.assert_allclose(Kinv[0], other[0], rtol=1e-4, atol=1e-5)
    K64 = K.astype(np.float64)
    ld64 = np.linalg.slogdet(K64)[1]
    eye = np.eye(n)
    for Ki, l in ((Kinv, ld), (np.asarray(jKinv, np.float64),
                               np.asarray(jld)),
                  (pKinv.numpy().astype(np.float64), pld.numpy())):
        # the f32 fit-path bars: resid < 5e-2, logdet within 0.5
        assert np.abs(Ki[1] @ K64[1] - eye).max() < 5e-2
        assert np.all(np.abs(l - ld64) < 0.5)
    np.testing.assert_allclose(ld, np.asarray(jld), rtol=0, atol=1e-2)


def _linv_rows_in_place(L, Dinv, nb):
    """`chol_blocked::linv_rows` as tensor code: A holds L on entry (zero
    above the diagonal blocks) and L^{-1} on return.  Per block row r,
    T = L[r, :r] L^{-1}[:r, :r] overwrites L[r, :r] by 32-column tiles in
    ascending order, each reading L[r, k] from its first column on; then
    -Dinv_r T overwrites T by 8-row tiles in descending order, each
    reading the rows of T at and above its own."""
    A = L.clone()
    N = A.shape[-1]
    A[:, :nb, :nb] = Dinv[:, :nb]
    for R0 in range(nb, N, nb):
        Dr = Dinv[:, R0:R0 + nb]
        for c0 in range(0, R0, 32):
            c1 = min(c0 + 32, R0)
            A[:, R0:R0 + nb, c0:c1] = (A[:, R0:R0 + nb, c0:R0]
                                       @ A[:, c0:R0, c0:c1])
        for i0 in reversed(range(0, nb, 8)):
            i1 = min(i0 + 8, nb)
            A[:, R0 + i0:R0 + i1, :R0] = -(Dr[:, i0:i1, :i1]
                                           @ A[:, R0:R0 + i1, :R0])
        A[:, R0:R0 + nb, R0:R0 + nb] = Dr
    return A


@pytest.mark.parametrize("n,nb", [(17, 32), (70, 16), (70, 32), (200, 32),
                                  (200, 16), (100, 64), (44, 4)])
def test_in_place_row_assembly_matches_assemble_linv(n, nb):
    K = torch.tensor(np.stack([_spd(n, n + nb), _trajectory_gram(n, n + nb)]))
    L, Dinv = ck.chol_dinv_plain(K, nb)
    want = ck.assemble_linv(L, Dinv, nb, "row")
    got = _linv_rows_in_place(L, Dinv, nb)
    # f64, the same products in the same grouping, cut at the zeros
    scale = want.abs().amax((-1, -2), keepdim=True)
    assert float(((got - want).abs() / scale).max()) < 1e-12
    assert float(torch.triu(got, 1).abs().max()) == 0.0
    eye = torch.eye(L.shape[-1], dtype=K.dtype)
    assert float((got[0] @ L[0] - eye).abs().max()) < 1e-10


def test_kinv_logdet_cpu_dispatch_ignores_block_size():
    """On the CPU the wrapper takes `kinv_logdet_plain`, whatever nb."""
    K = torch.tensor(_spd(9, 0))[None]
    with tracing.recording():
        for nb in (8, 32):
            for g, w in zip(ck.kinv_logdet(K, nb), ck.kinv_logdet_plain(K)):
                assert torch.equal(g, w)
    assert "launches.kinv_logdet" not in tracing.report()["counters"]
