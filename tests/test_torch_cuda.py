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
from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik


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
