"""Kernel modules of the PyTorch port (ops/chol_kernels.py,
ops/ipm_kernel.py): each plain version against the JAX reference on CPU
(f64) and against the JAX Pallas kernel in interpret mode (f32, small
sizes, including a trajectory Gram); and the CPU/CUDA dispatch of the
wrappers.  The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.ops.cholinv import _kinv_logdet_ref, _ref_fwd
from bayesian_cbf_tpu.ops.pallas_chol import (batched_chol_with_inv,
                                              batched_kinv_logdet_chol)
from bayesian_cbf_tpu.ops.pallas_ipm import batched_ipm
from bayesian_cbf_tpu.solvers.socp import _pad_cones, _solve_padded_plain
from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik


def _trajectory_gram(k, seed, step=0.02, nug=2.5e-4):
    """Random-walk RBF Gram: the conditioning of a real fit buffer."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(step * rng.normal(size=(k, 3)), 0)
    d = X[:, None, :] - X[None, :, :]
    return np.exp(-0.5 * np.sum(d * d, -1)) + nug * np.eye(k)


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    return A @ A.transpose(0, 2, 1) / n + np.eye(n)


def _mixed_cones(seed, B=8, nx=4, dims=(4, 4, 4, 1)):
    rng = np.random.default_rng(seed)
    cs, Gs, hs = [], [], []
    for _ in range(B):
        c = rng.normal(size=nx)
        blocks, hrows = [], []
        for dd in dims:
            A = (rng.normal(size=(dd - 1, nx)) * 0.5 if dd > 1
                 else np.zeros((0, nx)))
            cv = rng.normal(size=nx) * 0.2
            blocks.append(np.concatenate([-cv[None, :], -A], 0))
            hrows.append(np.concatenate([[1.5 + rng.uniform()],
                                         rng.normal(size=dd - 1) * 0.1]))
        Gp, hp = _pad_cones(jnp.asarray(c), jnp.asarray(np.concatenate(blocks)),
                            jnp.asarray(np.concatenate(hrows)), dims)
        cs.append(c)
        Gs.append(np.asarray(Gp))
        hs.append(np.asarray(hp))
    C, d = len(dims), max(dims)
    e = np.zeros((B, C, d))
    e[..., 0] = 1.0
    return np.stack(cs), np.stack(Gs), np.stack(hs), np.zeros((B, nx)), e


# ---- Cholesky: plain version vs the JAX reference (f64) -------------------

def test_chol_linv_plain_matches_jax_reference():
    K = _spd(3, 12, 0)
    L, Linv = ck.chol_linv_plain(torch.tensor(K))
    for b in range(3):
        jL, jLinv = _ref_fwd(jnp.asarray(K[b]))
        # f64 LAPACK-class factorizations of a well-conditioned matrix
        np.testing.assert_allclose(L[b].numpy(), np.asarray(jL), rtol=1e-12,
                                   atol=1e-13)
        np.testing.assert_allclose(Linv[b].numpy(), np.asarray(jLinv),
                                   rtol=1e-11, atol=1e-13)


def test_kinv_logdet_plain_matches_jax_reference():
    K = np.stack([_spd(1, 16, 1)[0], _trajectory_gram(16, 2)])
    Kinv, ld = ck.kinv_logdet_plain(torch.tensor(K))
    for b in range(2):
        jKinv, jld = _kinv_logdet_ref(jnp.asarray(K[b]))
        scale = float(np.abs(np.asarray(jKinv)).max())
        # f64; the trajectory Gram is kappa ~ 1e5, so compare against scale
        np.testing.assert_allclose(Kinv[b].numpy(), np.asarray(jKinv),
                                   rtol=0, atol=1e-9 * scale)
        np.testing.assert_allclose(float(ld[b]), float(jld), rtol=1e-11)


def test_chol_plain_marks_failure_as_nan():
    """Like the JAX reference, a non-PD input yields NaN (the refresh
    ladder's sanity check relies on it)."""
    K = torch.tensor([[[1.0, 2.0], [2.0, 1.0]]], dtype=torch.float64)
    L, Linv = ck.chol_linv_plain(K)
    assert torch.isnan(L).all() and torch.isnan(Linv).all()


# ---- Cholesky: plain version vs the Pallas kernels in interpret mode ------

@pytest.mark.parametrize("n", [40, 64])
def test_chol_linv_plain_matches_pallas_interpret(n):
    K = np.stack([_spd(1, n, n)[0], _trajectory_gram(n, n)]).astype(np.float32)
    L, Linv = ck.chol_linv_plain(torch.tensor(K))
    jL, jLinv = batched_chol_with_inv(jnp.asarray(K), interpret=True)
    jL, jLinv = np.asarray(jL, np.float64), np.asarray(jLinv, np.float64)
    # well-conditioned SPD: both f32 factorizations agree elementwise
    np.testing.assert_allclose(L[0].numpy(), jL[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Linv[0].numpy(), jLinv[0], rtol=1e-4,
                               atol=1e-5)
    # trajectory Gram (kappa ~ 1e5): both meet the Cholesky-class bars
    K64 = K[1].astype(np.float64)
    eye = np.eye(n)
    for Lb, Lib in ((L[1].numpy().astype(np.float64),
                     Linv[1].numpy().astype(np.float64)), (jL[1], jLinv[1])):
        assert np.abs(Lib @ Lb - eye).max() < 5e-2
        assert np.abs(Lb @ Lb.T - K64).max() / np.abs(K64).max() < 1e-5


@pytest.mark.parametrize("n", [40, 64])
def test_kinv_logdet_plain_matches_pallas_interpret(n):
    K = np.stack([_spd(1, n, 2 * n)[0],
                  _trajectory_gram(n, 2 * n)]).astype(np.float32)
    Kinv, ld = ck.kinv_logdet_plain(torch.tensor(K))
    jKinv, jld = batched_kinv_logdet_chol(jnp.asarray(K), interpret=True)
    jKinv = np.asarray(jKinv, np.float64)
    np.testing.assert_allclose(Kinv[0].numpy(), jKinv[0], rtol=1e-4,
                               atol=1e-5)
    K64 = K.astype(np.float64)
    ld64 = np.linalg.slogdet(K64)[1]
    eye = np.eye(n)
    for Ki, l in ((Kinv.numpy().astype(np.float64), ld.numpy()),
                  (jKinv, np.asarray(jld))):
        # the f32 fit-path bars: resid < 5e-2, logdet within 0.5
        assert np.abs(Ki[1] @ K64[1] - eye).max() < 5e-2
        assert np.all(np.abs(l - ld64) < 0.5)


# ---- IPM: plain version vs the JAX plain IPM (f64) and the Pallas kernel --

@pytest.mark.parametrize("iters", [1, 3, 6])
def test_ipm_plain_matches_jax_plain_step_for_step(iters):
    """f64, same operations: the iterates agree to roundoff while the IPM
    is still far from its floor (by ~10 iterations both sit at a KKT
    score ~1e-8 where roundoff steers the last digits of S and Z)."""
    c, G, h, sx, e = _mixed_cones(0)
    got = ik.ipm_plain(*(torch.tensor(a) for a in (c, G, h, sx, e, e)),
                       iters, 1e-10)
    want = jax.vmap(lambda *a: _solve_padded_plain(*a, iters, 1e-10))(
        *(jnp.asarray(a) for a in (c, G, h, sx, e, e)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-9)


def test_ipm_plain_converges_like_jax_plain_f64():
    c, G, h, sx, e = _mixed_cones(0)
    args_t = [torch.tensor(a) for a in (c, G, h, sx, e, e)]
    got = ik.ipm_plain(*args_t, 20, 1e-10)
    want = jax.vmap(lambda *a: _solve_padded_plain(*a, 20, 1e-10))(
        *(jnp.asarray(a) for a in (c, G, h, sx, e, e)))
    s_got = ik.score_padded(*args_t[:3], *got).numpy()
    s_want = ik.score_padded(*args_t[:3], *(torch.tensor(np.asarray(w))
                                            for w in want)).numpy()
    assert np.all(s_got < 1e-6) and np.all(s_want < 1e-6)
    # optimal values agree to the score floor
    np.testing.assert_allclose(np.sum(c * got[0].numpy(), -1),
                               np.sum(c * np.asarray(want[0]), -1),
                               rtol=1e-6, atol=1e-7)


def test_ipm_plain_matches_pallas_interpret_scores():
    c, G, h, sx, e = (a.astype(np.float32) for a in _mixed_cones(1))
    args_t = [torch.tensor(a) for a in (c, G, h, sx, e, e)]
    got = ik.ipm_plain(*args_t, 20, 1e-10)
    want = batched_ipm(*(jnp.asarray(a) for a in (c, G, h, sx, e, e)),
                       iters=20, tol=1e-10, interpret=True)
    s_got = ik.score_padded(*args_t[:3], *got).numpy()
    s_want = ik.score_padded(*args_t[:3], *(torch.tensor(np.asarray(w))
                                            for w in want)).numpy()
    # f32 trajectories diverge near the optimum, so the KKT score is the
    # oracle: the median no worse than 2x, and the optimal values agree
    # wherever both solves converged below 1e-3
    assert np.median(s_got) <= 2.0 * np.median(s_want), (s_got, s_want)
    both = (s_got < 1e-3) & (s_want < 1e-3)
    assert both.sum() >= 4
    np.testing.assert_allclose(np.sum(c * got[0].numpy(), -1)[both],
                               np.sum(c * np.asarray(want[0]), -1)[both],
                               rtol=5e-3, atol=5e-3)


# ---- dispatch ---------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    K = torch.tensor(_spd(2, 6, 3))
    args = [torch.tensor(a) for a in _mixed_cones(2, B=2)]
    args.append(args[-1])
    with tracing.recording():
        for got, want in ((ck.chol_linv(K), ck.chol_linv_plain(K)),
                          (ck.kinv_logdet(K), ck.kinv_logdet_plain(K)),
                          (ik.ipm(*args, 5, 1e-10),
                           ik.ipm_plain(*args, 5, 1e-10))):
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert not any(k.startswith("launches.")
                   for k in tracing.report()["counters"])


def test_other_devices_raise():
    K = torch.empty((2, 4, 4), device="meta")
    with pytest.raises(ValueError):
        ck.chol_linv(K)
    with pytest.raises(ValueError):
        ck.kinv_logdet(K)
