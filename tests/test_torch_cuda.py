"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA card, in f32.  Marked `cuda`; without a card every test skips.

This file imports no JAX, so that it runs where the card is (that
machine has no JAX) without the JAX-loading conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
from bayesian_cbf_tpu_torch.ops import gram as gm
from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
from bayesian_cbf_tpu_torch.ops import sweep_kernels as sk


def _trajectory_grams(B, k, seed, step=0.02, nug=2.5e-4):
    """Random-walk RBF Grams: the conditioning of real fit buffers."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(step * rng.normal(size=(B, k, 3)), 1)
    d = X[:, :, None, :] - X[:, None, :, :]
    return np.exp(-0.5 * np.sum(d * d, -1)) + nug * np.eye(k)


def _mixed_cones(B, seed, nx=4, dims=(4, 4, 4, 1)):
    """Random feasible padded problems: c (B, nx), G (B, C, d, nx),
    h (B, C, d), plus the cold start (x, S, Z)."""
    rng = np.random.default_rng(seed)
    C, d = len(dims), max(dims)
    c = rng.normal(size=(B, nx))
    G = np.zeros((B, C, d, nx))
    h = np.zeros((B, C, d))
    for ci, dd in enumerate(dims):
        G[:, ci, 0] = -rng.normal(size=(B, nx)) * 0.2
        G[:, ci, 1:dd] = -rng.normal(size=(B, dd - 1, nx)) * 0.5
        h[:, ci, 0] = 1.5 + rng.uniform(size=B)
        h[:, ci, 1:dd] = rng.normal(size=(B, dd - 1)) * 0.1
    e = np.zeros((B, C, d))
    e[..., 0] = 1.0
    return c, G, h, np.zeros((B, nx)), e, e


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 50, 200, 241, 242, 300])
def test_chol_kernels_match_plain(cuda, n):
    """Both sides of the shared-memory limit (n <= 241 in shared memory)."""
    K = torch.tensor(_trajectory_grams(5, n, n), dtype=torch.float32,
                     device=cuda)
    L, Linv = ck.chol_linv(K)
    Kinv, ld = ck.kinv_logdet(K)
    torch.cuda.synchronize()
    K64 = K.double()
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    # the f32 fit-path bars of the JAX package's kernel tests
    assert float((Linv.double() @ L.double() - eye).abs().max()) < 5e-2
    assert float((L.double() @ L.double().transpose(-1, -2) - K64).abs().max()
                 / K64.abs().max()) < 1e-5
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    assert float((Kinv.double() @ K64 - eye).abs().max()) < 5e-2
    assert float((ld.double() - torch.linalg.slogdet(K64)[1]).abs().max()) \
        < 0.5


@pytest.mark.cuda
def test_chol_kernels_agree_with_plain_elementwise(cuda):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(8, 64, 64))
    S = torch.tensor(A @ A.transpose(0, 2, 1) / 64 + np.eye(64),
                     dtype=torch.float32, device=cuda)
    for got, want in ((ck.chol_linv(S), ck.chol_linv_plain(S)),
                      (ck.kinv_logdet(S), ck.kinv_logdet_plain(S))):
        for g, w in zip(got, want):
            # well-conditioned SPD in f32: relative agreement 1e-4
            assert float((g - w).abs().max() / w.abs().max()) < 1e-4


@pytest.mark.cuda
def test_kernels_count_launches_and_reject_bad_input(cuda):
    K = torch.eye(4, device=cuda).expand(2, 4, 4).contiguous()
    before = ck.chol_linv.launches
    ck.chol_linv(K)
    assert ck.chol_linv.launches == before + 1
    with pytest.raises(ValueError):
        ck.chol_linv(K.double())
    with pytest.raises(ValueError):
        ck.kinv_logdet(K.transpose(-1, -2)[:, :, :3].contiguous())
    with pytest.raises(ValueError):
        ck.kinv_logdet(torch.eye(1025, device=cuda)[None].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64, 300])
def test_ipm_kernel_matches_plain_scores(cuda, B):
    args = [torch.tensor(a, dtype=torch.float32, device=cuda)
            for a in _mixed_cones(B, B)]
    got = ik.ipm(*args, 25, 1e-10)
    want = ik.ipm_plain(*args, 25, 1e-10)
    torch.cuda.synchronize()
    sg = ik.score_padded(*args[:3], *got)
    sw = ik.score_padded(*args[:3], *want)
    # f32 trajectories of the two diverge near the optimum: the KKT score
    # is the oracle (median no worse than 2x)
    assert float(sg.median()) <= 2.0 * float(sw.median()) + 1e-6
    assert bool(torch.isfinite(got[0]).all())
    with pytest.raises(ValueError):
        ik.ipm(*(a.double() for a in args), 5, 1e-10)


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    return A @ A.transpose(0, 2, 1) / n + np.eye(n)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n,base", [(9, 0), (33, 0), (200, 0), (214, 0),
                                    (215, 0), (300, 0), (50, 256),
                                    (200, 256), (240, 256)])
def test_sweep_kernel_matches_plain(cuda, n, base):
    """Both sides of the shared-memory limit, recursive and one-sweep;
    well-conditioned SPD in f32: relative agreement 1e-4, and both within
    1e-3 of the f64 inverse."""
    K = torch.tensor(_spd(6, n, n), dtype=torch.float32, device=cuda)
    got = sk.batched_kinv_logdet(K, base)
    want = sk.batched_kinv_logdet_plain(K, base)
    torch.cuda.synchronize()
    exact = torch.linalg.inv(K.double())
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-4
    assert _rel(got[0].double(), exact) < 1e-3
    assert float((got[1].double() - torch.linalg.slogdet(K.double())[1])
                 .abs().max()) < 1e-3


@pytest.mark.cuda
def test_sweep_full_is_finite_on_trajectory_grams(cuda):
    """The one-sweep fit inverse meets the fit-path bars where the
    recursion fails (tests/test_fit_inverse.py)."""
    K = torch.tensor(_trajectory_grams(8, 200, 3), dtype=torch.float32,
                     device=cuda)
    Kinv, ld = sk.batched_kinv_logdet(K, sk.full_base(200))
    torch.cuda.synchronize()
    K64 = K.double()
    eye = torch.eye(200, dtype=torch.float64, device=cuda)
    assert bool(torch.isfinite(Kinv).all() & torch.isfinite(ld).all())
    assert float((Kinv.double() @ K64 - eye).abs().max()) < 5e-2
    assert float((ld.double() - torch.linalg.slogdet(K64)[1]).abs().max()) \
        < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb", [(1, 32), (50, 16), (50, 32), (200, 32),
                                  (238, 32), (239, 32), (300, 32)])
def test_chol_dinv_kernel_matches_plain(cuda, n, nb):
    """Both sides of the shared-memory limit (N <= 238 at nb = 32)."""
    S = torch.tensor(_spd(4, n, n), dtype=torch.float32, device=cuda)
    got, want = ck.chol_dinv(S, nb), ck.chol_dinv_plain(S, nb)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        # well-conditioned SPD in f32: relative agreement 1e-4
        assert _rel(g, w) < 1e-4
    K = torch.tensor(_trajectory_grams(4, n, n + 1), dtype=torch.float32,
                     device=cuda)
    L, Dinv = ck.chol_dinv(K, nb)
    torch.cuda.synchronize()
    N = L.shape[-1]
    Kp = torch.eye(N, dtype=torch.float64, device=cuda).repeat(4, 1, 1)
    Kp[:, :n, :n] = K.double()
    Ld = L.double()
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    assert float((Ld @ Ld.transpose(-1, -2) - Kp).abs().max()
                 / Kp.abs().max()) < 1e-5
    for assembly in ("row", "col"):
        Linv = ck.assemble_linv(L, Dinv, nb, assembly)
        eye = torch.eye(N, dtype=torch.float64, device=cuda)
        assert float((Linv.double() @ Ld - eye).abs().max()) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,n,mh", [(1, 1, 1, 1), (3, 33, 3, 3),
                                      (4, 200, 3, 3), (2, 70, 16, 16)])
def test_gram_kernel_matches_plain(cuda, B, K, n, mh):
    rng = np.random.default_rng(K)
    args = [rng.normal(size=(B, K, n)), rng.normal(size=(B, K, mh)),
            (rng.uniform(size=(B, K)) > 0.5).astype(float),
            rng.uniform(0.5, 2.0, size=B)]
    args = [torch.tensor(a, dtype=torch.float32, device=cuda) for a in args]
    got = gm.fused_gram_kb(*args, 1e-6)
    want = gm.fused_gram_kb_plain(*args, 1e-6)
    torch.cuda.synchronize()
    # f32, one exp and a few multiply-adds per entry: relative 1e-5
    assert _rel(got, want) < 1e-5


def near_duplicate_case(B=4, k=40, seed=0):
    """Consecutive states 1e-3 apart around a common offset (a training
    buffer's near-duplicate rows), random UH chol(B) rows, outputscale 1.3,
    and the f64 truth by the exact difference form
    (tests/test_ops.py::test_fused_gram_accurate_for_near_duplicate_points,
    batched)."""
    rng = np.random.default_rng(seed)
    X = np.array([2.0, -1.5, 0.7]) + np.cumsum(
        0.001 * rng.normal(size=(B, k, 3)), 1)
    UHB = rng.normal(size=(B, k, 3))
    d = X[:, :, None, :] - X[:, None, :, :]
    truth = (1.3 * np.exp(-0.5 * (d ** 2).sum(-1)) * (UHB @ UHB.transpose(
        0, 2, 1)) + 1e-6 * np.eye(k))
    return X, UHB, np.ones((B, k)), np.full(B, 1.3), truth


@pytest.mark.cuda
def test_gram_kernel_exact_on_near_duplicate_points(cuda):
    """The dot-product distance form cancels here in f32; the kernel's
    exact differences keep the JAX test's bar (atol = rtol = 2e-5)."""
    *args, truth = near_duplicate_case()
    t = [torch.tensor(a, dtype=torch.float32, device=cuda) for a in args]
    got = gm.fused_gram_kb(*t, 1e-6).double().cpu().numpy()
    np.testing.assert_allclose(got, truth, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_new_kernels_count_launches_and_reject_bad_input(cuda):
    K = torch.eye(8, device=cuda).expand(2, 8, 8).contiguous()
    before = (sk.batched_kinv_logdet.launches, ck.chol_dinv.launches,
              gm.fused_gram_kb.launches)
    sk.batched_kinv_logdet(K)
    ck.chol_dinv(K)
    gm.fused_gram_kb(K[:, :, :3].contiguous(), K[:, :, :3].contiguous(),
                     K[:, 0].contiguous(), K[:, 0, 0].contiguous(), 0.0)
    assert (sk.batched_kinv_logdet.launches, ck.chol_dinv.launches,
            gm.fused_gram_kb.launches) == tuple(b + 1 for b in before)
    with pytest.raises(ValueError):
        sk.batched_kinv_logdet(K.double())
    with pytest.raises(ValueError):
        ck.chol_dinv(K, nb=65)
    wide = torch.zeros((2, 8, 17), device=cuda)
    with pytest.raises(ValueError):
        gm.fused_gram_kb(wide, K, K[:, 0].contiguous(),
                         K[:, 0, 0].contiguous(), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,r,nb", [(3, 50, 11, 16), (4, 200, 16, 32),
                                      (2, 200, 64, 32), (2, 1024, 16, 32),
                                      (2, 1024, 64, 32), (2, 1, 1, 32)])
def test_cholsolve_kernels_match_plain(cuda, B, n, r, nb):
    """Every shared-memory plan: the factor's matrix and the RHS in shared
    memory, the matrix in global scratch, both in global scratch."""
    rng = np.random.default_rng(n + r)
    R = torch.tensor(rng.normal(size=(B, n, r)), dtype=torch.float32,
                     device=cuda)
    S = torch.tensor(_spd(B, n, n), dtype=torch.float32, device=cuda)
    got = ck.cholsolve_logdet(S, R, nb)
    want = ck.cholsolve_logdet_plain(S, R, nb)
    again = ck.solve_with_factor(got[1], got[2], R, nb)
    plain_again = ck.solve_with_factor_plain(got[1], got[2], R, nb)
    dinv = ck.chol_dinv(S, nb)
    torch.cuda.synchronize()
    # well-conditioned SPD in f32: relative agreement 1e-4
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-4
    assert _rel(again, plain_again) < 1e-4
    assert float((again - got[0]).abs().max()) == 0.0
    # the factor is kernel 8's, from the same device code
    assert float((dinv[0] - got[1]).abs().max()) == 0.0
    assert float((dinv[1] - got[2]).abs().max()) == 0.0
    exact = torch.linalg.solve(S.double(), R.double())
    assert _rel(got[0].double(), exact) < 1e-4


@pytest.mark.cuda
def test_cholsolve_on_trajectory_grams(cuda):
    """The fit buffers' conditioning (kappa ~1e6): no farther from the f64
    solve than the plain f32 version, with a little margin."""
    K = torch.tensor(_trajectory_grams(8, 200, 5), dtype=torch.float32,
                     device=cuda)
    R = torch.tensor(np.random.default_rng(5).normal(size=(8, 200, 16)),
                     dtype=torch.float32, device=cuda)
    exact = torch.linalg.solve(K.double(), R.double())
    got = ck.cholsolve_logdet(K, R)
    want = ck.cholsolve_logdet_plain(K, R)
    torch.cuda.synchronize()
    assert _rel(got[0].double(), exact) <= 3.0 * _rel(want[0].double(),
                                                      exact) + 1e-3
    ld64 = torch.linalg.slogdet(K.double())[1]
    assert float((got[3].double() - ld64).abs().max()) < 0.5


@pytest.mark.cuda
def test_cholsolve_counts_launches_and_rejects_bad_input(cuda):
    K = torch.eye(8, device=cuda).expand(2, 8, 8).contiguous()
    R = torch.ones((2, 8, 3), device=cuda)
    before = (ck.cholsolve_logdet.launches, ck.solve_with_factor.launches)
    _, L, Dinv, _ = ck.cholsolve_logdet(K, R)
    ck.solve_with_factor(L, Dinv, R)
    assert (ck.cholsolve_logdet.launches,
            ck.solve_with_factor.launches) == (before[0] + 1, before[1] + 1)
    for bad in (R.double(), torch.ones((2, 8, 65), device=cuda),
                R.transpose(1, 2).contiguous().transpose(1, 2),
                torch.ones((2, 7, 3), device=cuda)):
        with pytest.raises(ValueError):
            ck.cholsolve_logdet(K, bad)
    with pytest.raises(ValueError):
        ck.cholsolve_logdet(K, R, nb=65)
    with pytest.raises(ValueError):
        ck.solve_with_factor(L, Dinv[:, :, :16].contiguous(), R)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 256, 300])
def test_ipm_kernel_pendulum_shape_matches_plain(cuda, B):
    """(nx, C, d) = (4, 3, 3): two 3-dimensional cones and a ray padded
    to 3, as the pendulum controller builds them; the ray's padded tail
    stays zero."""
    args = [torch.tensor(a, dtype=torch.float32, device=cuda)
            for a in _mixed_cones(B, B + 1, dims=(3, 3, 1))]
    got = ik.ipm(*args, 25, 1e-10)
    want = ik.ipm_plain(*args, 25, 1e-10)
    torch.cuda.synchronize()
    sg = ik.score_padded(*args[:3], *got)
    sw = ik.score_padded(*args[:3], *want)
    assert float(sg.median()) <= 2.0 * float(sw.median()) + 1e-6
    assert bool(torch.isfinite(got[0]).all())
    assert float(got[1][:, 2, 1:].abs().max()) == 0.0
    assert float(got[2][:, 2, 1:].abs().max()) == 0.0
