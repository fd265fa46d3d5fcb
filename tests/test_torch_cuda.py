"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA card, in f32.  Marked `cuda`; without a card every test skips.

This file imports no JAX, so that it runs where the card is (that
machine has no JAX) without the JAX-loading conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
from bayesian_cbf_tpu_torch.ops import gram as gm
from bayesian_cbf_tpu_torch.ops import gramsolve as gs
from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
from bayesian_cbf_tpu_torch.ops import sweep_kernels as sk


def _launches():
    """{kernel wrapper: launches} that the last recording counted."""
    return {k.split(".", 1)[1]: v
            for k, v in tracing.report()["counters"].items()
            if k.startswith("launches.")}


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
@pytest.mark.parametrize("n,B", [(1, 5), (17, 5), (50, 5), (200, 5),
                                 (224, 5), (225, 5), (232, 5), (233, 5),
                                 (240, 5), (241, 5), (300, 5), (200, 300)])
def test_chol_kernels_match_plain(cuda, n, B):
    """Both sides of the shared-memory limits (the working matrix of
    `chol_linv` and `kinv_logdet` fits at a padded order of 224 at nb 16
    and 32 and of 232 at nb 8, beyond that it lives in a global scratch),
    and a batch of more thread blocks than two waves of the card's SMs."""
    K = torch.tensor(_trajectory_grams(B, n, n), dtype=torch.float32,
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
    assert torch.equal(Kinv, Kinv.transpose(-1, -2))


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb", [(1, 32), (17, 32), (50, 32), (200, 32),
                                  (224, 32), (225, 32), (203, 32), (50, 16),
                                  (200, 16), (200, 8), (100, 64), (300, 64)])
def test_kinv_logdet_matches_its_steps(cuda, n, nb):
    """Kernel 1 against the plain version of its own steps (blocked factor,
    "row" assembly, product, logdet), in shared memory and in the global
    scratch, n a multiple of 4 or not: elementwise on well-conditioned SPD
    (f32, relative 1e-4), and by the fit-path residual bars on a batch of
    64 trajectory Grams."""
    S = torch.tensor(_spd(4, n, n + nb), dtype=torch.float32, device=cuda)
    got, want = ck.kinv_logdet(S, nb), ck.kinv_logdet_blocked_plain(S, nb)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-4
    K = torch.tensor(_trajectory_grams(64, n, n + 1), dtype=torch.float32,
                     device=cuda)
    Kinv, ld = ck.kinv_logdet(K, nb)
    torch.cuda.synchronize()
    K64 = K.double()
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    assert float((Kinv.double() @ K64 - eye).abs().max()) < 5e-2
    assert float((ld.double() - torch.linalg.slogdet(K64)[1]).abs().max()) \
        < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 200, 260])
def test_kinv_logdet_nan_stays_in_its_matrix(cuda, n):
    """A NaN pivot is not floored: that matrix's inverse and logdet come
    back non-finite (the fit's guard reads finiteness), and the other
    matrices of the batch are the bits of a run without it."""
    S = torch.tensor(_spd(3, n, n), dtype=torch.float32, device=cuda)
    clean = ck.kinv_logdet(S)
    S[1, 0, 0] = float("nan")
    Kinv, ld = ck.kinv_logdet(S)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(ld[1]))
    assert not bool(torch.isfinite(Kinv[1]).any())
    for b in (0, 2):
        assert torch.equal(Kinv[b], clean[0][b])
        assert torch.equal(ld[b], clean[1][b])


@pytest.mark.cuda
def test_kinv_logdet_same_bits_twice(cuda):
    """No atomics and one fixed order of every sum: two launches on the
    same input give the same bits."""
    K = torch.tensor(_trajectory_grams(300, 200, 9), dtype=torch.float32,
                     device=cuda)
    first, again = ck.kinv_logdet(K), ck.kinv_logdet(K)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb,B", [(1, 16, 4), (17, 16, 4), (50, 8, 4),
                                    (50, 32, 4), (203, 16, 4), (200, 8, 256),
                                    (200, 16, 256), (200, 32, 256),
                                    (232, 8, 4), (233, 8, 4), (224, 32, 4),
                                    (225, 32, 4), (100, 64, 4), (300, 64, 4)])
def test_chol_linv_matches_its_steps(cuda, n, nb, B):
    """Kernel 2 against the plain version of its own steps (blocked factor,
    "row" assembly, both cut to n), in shared memory and in the global
    scratch, n a multiple of 4 or not, at the main path's (256, 200):
    elementwise on well-conditioned SPD (f32, relative 1e-4); its L is
    kernel 8's bit for bit (the same device code); exactly lower
    triangular, contiguous outputs; and the refresh bars on trajectory
    Grams with a partly filled buffer among them (identity rows for the
    empty slots)."""
    S = torch.tensor(_spd(B, n, n + nb), dtype=torch.float32, device=cuda)
    got, want = ck.chol_linv(S, nb), ck.chol_linv_blocked_plain(S, nb)
    L8, _ = ck.chol_dinv(S, nb)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B, n, n) and g.is_contiguous()
        assert _rel(g, w) < 1e-4
        assert float(torch.triu(g, 1).abs().max()) == 0.0
    assert torch.equal(got[0], L8[:, :n, :n])
    K = _trajectory_grams(8, n, n + 1)
    m = (np.arange(n) < (2 * n) // 3).astype(float)
    K[1] = K[1] * (m[:, None] * m[None, :]) + np.diag(1.0 - m)
    K = torch.tensor(K, dtype=torch.float32, device=cuda)
    L, Linv = ck.chol_linv(K, nb)
    torch.cuda.synchronize()
    K64, Ld = K.double(), L.double()
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    assert float((Linv.double() @ Ld - eye).abs().max()) < 5e-2
    assert float((Ld @ Ld.transpose(-1, -2) - K64).abs().max()
                 / K64.abs().max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 200, 260])
def test_chol_linv_nan_stays_in_its_matrix(cuda, n):
    """A NaN pivot is not floored: that matrix's L^{-1} comes back
    non-finite (the refresh ladder reads finiteness), and the other
    matrices of the batch are the bits of a run without it."""
    S = torch.tensor(_spd(3, n, n), dtype=torch.float32, device=cuda)
    clean = ck.chol_linv(S)
    S[1, 0, 0] = float("nan")
    L, Linv = ck.chol_linv(S)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(L[1]).all())
    assert not bool(torch.isfinite(Linv[1]).all())
    for b in (0, 2):
        assert torch.equal(L[b], clean[0][b])
        assert torch.equal(Linv[b], clean[1][b])


@pytest.mark.cuda
def test_chol_linv_same_bits_twice(cuda):
    """No atomics and one fixed order of every sum: two launches on the
    same input give the same bits."""
    K = torch.tensor(_trajectory_grams(300, 200, 9), dtype=torch.float32,
                     device=cuda)
    first, again = ck.chol_linv(K), ck.chol_linv(K)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


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
    with tracing.recording():
        ck.chol_linv(K)
    assert _launches() == {"chol_linv": 1}
    with pytest.raises(ValueError):
        ck.chol_linv(K.double())
    with pytest.raises(ValueError):
        ck.kinv_logdet(K.transpose(-1, -2)[:, :, :3].contiguous())
    with pytest.raises(ValueError):
        ck.kinv_logdet(torch.eye(1025, device=cuda)[None].contiguous())
    with pytest.raises(ValueError):
        ck.kinv_logdet(K, nb=6)
    with pytest.raises(ValueError):
        ck.chol_linv(K, nb=6)
    with tracing.recording():
        ck.kinv_logdet(K)
    assert _launches() == {"kinv_logdet": 1}


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
                                    (215, 0), (300, 0), (1, 256), (17, 256),
                                    (50, 256), (64, 256), (65, 256),
                                    (200, 256), (224, 256), (225, 256),
                                    (240, 256)])
def test_sweep_kernel_matches_plain(cuda, n, base):
    """Both sides of the shared-memory limit, recursive and one-sweep, and
    both sides of each limit of the register kernel's instances (64, 224);
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


def _bits(x):
    """The float32 tensor's bits, NaNs as one pattern (a NaN's payload is
    not part of what the kernels compute)."""
    return torch.where(torch.isnan(x), torch.nan, x).view(torch.int32)


def _same_bits(got, want):
    return all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


@pytest.mark.cuda
def test_sweep_regs_instances_match_the_wrapper_table(cuda):
    from bayesian_cbf_tpu_torch.ops import _build
    lib = _build.load("sweep")
    limits = tuple(lib.sweep_regs_limit(i) for i in range(len(sk.REGS_LIMITS)))
    assert limits == sk.REGS_LIMITS
    assert lib.sweep_regs_limit(len(sk.REGS_LIMITS)) == 0
    K = torch.eye(65, device=cuda)[None].contiguous()
    with pytest.raises(RuntimeError):
        sk._launch_regs(K, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["spd", "trajectory"])
@pytest.mark.parametrize("n", [50, 200])
def test_sweep_regs_kernel_gives_the_event_kernels_bits(cuda, n, kind):
    """The one-sweep route's two kernels do the same arithmetic element for
    element: inverse and logdet equal bit for bit at the fit's (256, n)."""
    K = _spd(256, n, n) if kind == "spd" else _trajectory_grams(256, n, n + 5)
    K = torch.tensor(K, dtype=torch.float32, device=cuda)
    full = sk.full_base(n)
    kernel, instance = sk.sweep_route(n, sk.schedule(n, full))
    assert kernel == "regs"
    got = sk._launch_regs(K, instance)
    want = sk._launch_events(K, full)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[0]).all())
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 200])
def test_sweep_regs_nan_stays_in_its_matrix_and_floors_as_before(cuda, n):
    """A NaN pivot stays NaN in its matrix only; a zero and a negative
    first pivot are floored at 1e-12 as the event kernel floors them: every
    matrix's bits equal the event kernel's, and the clean ones a run
    without the bad ones."""
    S = torch.tensor(_spd(4, n, n), dtype=torch.float32, device=cuda)
    full = sk.full_base(n)
    clean = sk.batched_kinv_logdet(S, full)
    S[1, 0, 0] = float("nan")
    S[2, 0, 0] = 0.0
    S[3, 0, 0] = -1.0
    got = sk.batched_kinv_logdet(S, full)
    want = sk._launch_events(S, full)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(got[1][1]))
    assert not bool(torch.isfinite(got[0][1]).any())
    assert _same_bits(got, want)
    assert torch.equal(got[0][0], clean[0][0])
    assert torch.equal(got[1][0], clean[1][0])


@pytest.mark.cuda
def test_sweep_regs_same_bits_twice(cuda):
    """No atomics and one fixed order of every sum: two launches on the
    same input give the same bits, one count each."""
    K = torch.tensor(_trajectory_grams(300, 200, 9), dtype=torch.float32,
                     device=cuda)
    with tracing.recording():
        first = sk.batched_kinv_logdet(K, sk.full_base(200))
        again = sk.batched_kinv_logdet(K, sk.full_base(200))
    torch.cuda.synchronize()
    assert _launches() == {"batched_kinv_logdet": 2}
    assert _same_bits(first, again)


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
@pytest.mark.parametrize("nb", [8, 32, 64])
@pytest.mark.parametrize("n", [1, 31, 50, 200, 260])
def test_chol_dinv_block_sizes_and_plans(cuda, n, nb):
    """One and two warps on the diagonal block (nb <= 32, nb = 64), tiles
    cut by nb, the working matrix in shared memory (n <= 200) and in the
    global scratch (n = 260); kernel 6 returns the same L and Dinv bit
    for bit."""
    S = torch.tensor(_spd(3, n, n + nb), dtype=torch.float32, device=cuda)
    R = torch.ones((3, n, 2), dtype=torch.float32, device=cuda)
    got, want = ck.chol_dinv(S, nb), ck.chol_dinv_plain(S, nb)
    six = ck.cholsolve_logdet(S, R, nb)
    torch.cuda.synchronize()
    N = ck.padded_order(n, nb)
    assert tuple(got[0].shape) == (3, N, N)
    assert tuple(got[1].shape) == (3, N, nb)
    for g, w in zip(got, want):
        # well-conditioned SPD in f32: relative agreement 1e-4
        assert _rel(g, w) < 1e-4
    assert float(torch.triu(got[0], 1).abs().max()) == 0.0
    assert torch.equal(six[1], got[0]) and torch.equal(six[2], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb", [(50, 32), (200, 32), (260, 32), (100, 64)])
def test_chol_dinv_passes_nan_through(cuda, n, nb):
    """A NaN pivot is not floored: the episode's factor and block
    inverses come back NaN, as the plain version marks a failed
    factorization, and the other episodes are untouched."""
    S = torch.tensor(_spd(3, n, n), dtype=torch.float32, device=cuda)
    clean = ck.chol_dinv(S, nb)
    S[1, 0, 0] = float("nan")
    L, Dinv = ck.chol_dinv(S, nb)
    Lp, _ = ck.chol_dinv_plain(S, nb)
    torch.cuda.synchronize()
    low = torch.tril(torch.ones_like(L[1])).bool()
    assert bool(torch.isnan(L[1][low]).all() and torch.isnan(Dinv[1]).all())
    assert bool(torch.isnan(Lp[1][low]).all())
    for b in (0, 2):
        assert torch.equal(L[b], clean[0][b])
        assert torch.equal(Dinv[b], clean[1][b])


def _gram_args(cuda, B, K, n, mh, seed):
    rng = np.random.default_rng(seed)
    args = [rng.normal(size=(B, K, n)), rng.normal(size=(B, K, mh)),
            (rng.uniform(size=(B, K)) > 0.5).astype(float),
            rng.uniform(0.5, 2.0, size=B)]
    return [torch.tensor(a, dtype=torch.float32, device=cuda) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,n,mh", [(1, 1, 1, 1), (3, 33, 3, 3),
                                      (4, 200, 3, 3), (2, 70, 16, 16),
                                      (5, 201, 3, 3), (5, 203, 3, 3),
                                      (2, 1024, 16, 16), (1000, 200, 3, 3),
                                      (1, 5000, 3, 3), (1, 9000, 3, 3),
                                      (1, 2000, 16, 16), (1, 2051, 3, 3),
                                      (1, 1027, 16, 16), (3, 200, 2, 2),
                                      (2, 201, 2, 2), (2, 70, 2, 3)])
def test_gram_kernel_matches_plain(cuda, B, K, n, mh):
    """Also K % 4 != 0 (rows that start off 16-byte alignment: partial
    chunks; at K = 2051 and 1027 fewer than 4 row groups, so that a
    thread's rows change alignment and one thread has two chunks), B =
    1000 (more items than resident blocks), large K (5000, 9000 at n =
    1+m = 3; 2000 at 16), at the three instances (n = 1+m = 3, n = 1+m =
    2 and any other)."""
    args = _gram_args(cuda, B, K, n, mh, K)
    got = gm.fused_gram_kb(*args, 1e-6)
    want = gm.fused_gram_kb_plain(*args, 1e-6)
    torch.cuda.synchronize()
    # f32, one exp and a few multiply-adds per entry: relative 1e-5
    assert _rel(got, want) < 1e-5


@pytest.mark.cuda
def test_gram_same_bits_twice(cuda):
    args = _gram_args(cuda, 300, 201, 3, 3, 9)
    first = gm.fused_gram_kb(*args, 1e-6)
    again = gm.fused_gram_kb(*args, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,n,mh", [(256, 200, 3, 3), (2, 1024, 16, 16),
                                      (1, 2000, 16, 16), (256, 200, 2, 2)])
def test_gram_rows_per_thread_give_the_same_bits(cuda, B, K, n, mh):
    """The cut into items moves no bit: every entry is computed alone."""
    args = _gram_args(cuda, B, K, n, mh, K + 1)
    want = gm._launch(*args, 1e-6)
    for r in (1, 2, 8):
        got = gm._launch(*args, 1e-6, rows_per_thread=r)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
    with tracing.recording():
        sk.batched_kinv_logdet(K)
        ck.chol_dinv(K)
        gm.fused_gram_kb(K[:, :, :3].contiguous(), K[:, :, :3].contiguous(),
                         K[:, 0].contiguous(), K[:, 0, 0].contiguous(), 0.0)
    assert _launches() == {"batched_kinv_logdet": 1, "chol_dinv": 1,
                           "fused_gram_kb": 1}
    with pytest.raises(ValueError):
        sk.batched_kinv_logdet(K.double())
    with pytest.raises(ValueError):
        ck.chol_dinv(K, nb=65)
    wide = torch.zeros((2, 8, 17), device=cuda)
    with pytest.raises(ValueError):
        gm.fused_gram_kb(wide, K, K[:, 0].contiguous(),
                         K[:, 0, 0].contiguous(), 0.0)


def _fit_gram_case(dev, B, K, xd, mh, n, seed, dtype=torch.float32):
    """The fit-Gram's inputs as the MLL makes them: random-walk states (a
    training buffer), UH = [1, u], UB = UH (s B), inverse lengthscales, a
    nugget whose diagonal mean is above 1 (so the MLL's nugget carries a
    gradient), a quarter of the rows masked; Kinv the f64 inverse of Km,
    S = Kinv Y, dY = Kinv dS and dlogdet, as the backward receives them."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(0.3 * rng.normal(size=(B, K, xd)), 1)
    UH = np.concatenate([np.ones((B, K, 1)),
                         1.5 * rng.normal(size=(B, K, mh - 1))], -1)
    sB = np.eye(mh) + 0.2 * rng.normal(size=(mh, mh))
    UB = UH @ (sB @ sB.T)
    il = rng.uniform(0.5, 2.0, size=(B, xd))
    nug = 0.05 + 10 * K * 1.2e-7 * np.mean(np.sum(UB * UH, -1), -1)
    mask = (rng.uniform(size=(B, K)) > 0.25).astype(float)
    ins = [torch.tensor(a, dtype=torch.float64)
           for a in (X, UB, UH, il, nug, mask)]
    Km = gs.km_expr(*ins)
    Kinv = torch.linalg.inv(Km)
    Y = torch.tensor(rng.normal(size=(B, K, n))) * ins[5][..., None]
    dS = torch.tensor(rng.normal(size=(B, K, n)))
    extra = [Kinv, Kinv @ dS, Kinv @ Y, torch.tensor(rng.normal(size=B))]
    return [t.to(dtype=dtype, device=dev).contiguous() for t in ins + extra]


# the cells' shapes, K % 4 != 0, each instance's edges in K (a lane holds 2
# columns to K = 64, 7 to 224, reads them at each entry beyond), widths of
# 16, mixed widths, B past one wave of blocks
FIT_GRAM_SHAPES = [(1, 200, 2, 2, 2), (64, 200, 2, 2, 2), (256, 64, 3, 3, 3),
                   (5, 37, 3, 3, 3), (3, 37, 2, 2, 2), (3, 65, 3, 3, 3),
                   (2, 224, 3, 3, 3), (2, 225, 2, 2, 2), (2, 50, 16, 16, 16),
                   (3, 41, 16, 3, 5), (4, 70, 1, 1, 1), (300, 64, 3, 3, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,xd,mh,n", FIT_GRAM_SHAPES)
def test_fit_gram_kernel_matches_km_expr(cuda, B, K, xd, mh, n):
    """The forward kernel against `km_expr` in f32 and f64, masked rows
    at the shapes of FIT_GRAM_SHAPES: within 1e-5 of each entry's
    magnitude of f32 `km_expr`, and no farther from f64 than twice f32
    `km_expr` is (exp amplifies the distance's rounding by d2 / 2, so the
    f32 floor itself reaches 1e-5 where d2 is large)."""
    X, UB, UH, il, nug, mask = _fit_gram_case(cuda, B, K, xd, mh, n, K)[:6]
    got = gs.fit_gram(X, UB, UH, il, nug, mask)
    plain = gs.km_expr(X, UB, UH, il, nug, mask)
    ins64 = [t.double() for t in (X, UB, UH, il, nug, mask)]
    want = gs.km_expr(*ins64)
    scale = gs.km_expr(ins64[0], ins64[1].abs(), ins64[2].abs(), *ins64[3:])
    torch.cuda.synchronize()
    # f32: mh multiply-adds, xd squared differences and one expf an entry,
    # each rounded: 1e-5 of the entry's magnitude
    scale = scale + 1e-30  # masked entries are exact zeros
    floor = float(((plain.double() - want).abs() / scale).max())
    assert float(((got.double() - want).abs() / scale).max()) <= 2 * floor
    assert float(((got.double() - plain.double()).abs() / scale).max()) \
        < 1e-5


def _fit_backward_want(ins):
    """(dUB, d inv_ell, d nug) by autograd of `km_expr` in f64 from the
    f32 inputs, and the magnitude each is a sum of (the same pull-back of
    |dKm| with |UB|, |UH|)."""
    X, UB, UH, il, nug, mask, Kinv, dY, S, dl = [t.double() for t in ins]
    leaves = [a.clone().requires_grad_(True) for a in (UB, il, nug)]
    Km = gs.km_expr(X, leaves[0], UH, leaves[1], leaves[2], mask)
    dKm = dl[:, None, None] * Kinv - dY @ S.transpose(-1, -2)
    want = torch.autograd.grad(Km, leaves, dKm)
    mag = gs.km_backward_plain(X, UB.abs(), UH.abs(), il, mask, Kinv.abs(),
                               -dY.abs(), S.abs(), dl.abs())
    return want, [m.abs() for m in mag]


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,xd,mh,n", FIT_GRAM_SHAPES)
def test_fit_gram_backward_matches_autograd_f64(cuda, B, K, xd, mh, n):
    """The backward kernel against autograd of `km_expr` in f64, each
    output within 1e-5 of the magnitude of the terms it sums (f32: each
    term rounded a few times, sums of at most K^2 terms in trees)."""
    ins = _fit_gram_case(cuda, B, K, xd, mh, n, K + 1)
    got = gs.fit_gram_backward(*ins[:4], *ins[5:])
    want, mag = _fit_backward_want(ins)
    torch.cuda.synchronize()
    for name, g, w, m in zip(("dUB", "d inv_ell", "d nug"), got, want, mag):
        err = float(((g.double() - w).abs() / (m + 1e-30)).max())
        assert err < 1e-5, (name, err)


@pytest.mark.cuda
def test_fit_gram_kernels_same_bits_twice(cuda):
    ins = _fit_gram_case(cuda, 300, 200, 2, 2, 2, 3)
    km = [gs.fit_gram(*ins[:6]) for _ in range(2)]
    back = [gs.fit_gram_backward(*ins[:4], *ins[5:]) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(km[0].view(torch.int32), km[1].view(torch.int32))
    for a, b in zip(*back):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_fit_gram_kernels_count_launches_and_reject_bad_input(cuda):
    ins = _fit_gram_case(cuda, 2, 20, 3, 3, 3, 4)
    with tracing.recording():
        gs.fit_gram(*ins[:6])
        gs.fit_gram_backward(*ins[:4], *ins[5:])
    assert _launches() == {"fit_gram": 1, "fit_gram_backward": 1}
    # what the kernels do not take goes to the plain versions, uncounted
    ins64 = [t.double() for t in ins]
    wide = _fit_gram_case(cuda, 2, 20, 17, 3, 3, 4)
    with tracing.recording():
        km64 = gs.fit_gram(*ins64[:6])
        back64 = gs.fit_gram_backward(*ins64[:4], *ins64[5:])
        km_wide = gs.fit_gram(*wide[:6])
    assert _launches() == {}
    assert torch.equal(km64, gs.km_expr(*ins64[:6]))
    assert all(torch.equal(a, b) for a, b in zip(
        back64, gs.km_backward_plain(*ins64[:4], *ins64[5:])))
    assert torch.equal(km_wide, gs.km_expr(*wide[:6]))
    with pytest.raises(ValueError):
        gs.fit_gram_backward(*ins[:4], ins[5], ins[6][:, :, :19], *ins[7:])


def _rollout_fit_data(dev, B, K, seed):
    """A pendulum-like training buffer (x_dim 2, u_dim 1) from random-walk
    trajectories with controls of a few units, as a rollout fills it."""
    from bayesian_cbf_tpu_torch.models.mvgp import MVGPData
    rng = np.random.default_rng(seed)
    X = np.cumsum(0.05 * rng.normal(size=(B, K, 2)), 1) + [2.0, 0.0]
    U = 3.0 * rng.normal(size=(B, K, 1))
    Xdot = np.stack([X[..., 1], -10 * np.sin(X[..., 0]) + U[..., 0]], -1)
    t = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (X, U,
                                                                     Xdot)]
    return MVGPData(X=t[0], UH=torch.cat([torch.ones_like(t[1]), t[1]], -1),
                    Xdot=t[2] + 0.01 * torch.randn(
                        t[2].shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed)),
                    mask=torch.ones((B, K), device=dev))


@pytest.mark.cuda
def test_mvgp_fit_runs_the_fit_gram_kernels_and_moves_the_learner(cuda):
    """A recorded `MVGP.fit` at (64, 200) on rollout-like Grams: one launch
    of each fit-Gram kernel per Adam iteration, no recomputed backward,
    every episode's hyperparameters moved and finite, the loss lower; and
    its first gradient (the nugget carrying one: the Gram's diagonal mean
    is above 1) within 1e-3 of the recompute route's (taken where X wants
    a gradient)."""
    from bayesian_cbf_tpu_torch.models.mvgp import make_mvgp
    gp = make_mvgp(2, 1, fit_inverse="sweep_full")
    data = _rollout_fit_data(cuda, 64, 200, 5)
    gen = torch.Generator(device=cuda).manual_seed(1)
    p0 = gp.init_params(64, gen, cuda, torch.float32)
    diag = torch.sum((data.UH @ (p0.outputscale[:, None, None] * p0.B))
                     * data.UH, -1).abs().mean(-1)
    assert bool((diag > 1).all())
    iters = 25
    with tracing.recording():
        p1 = gp.fit(p0, data, training_iter=iters)
    counters = tracing.report()["counters"]
    assert counters.get("launches.fit_gram") == iters
    assert counters.get("launches.fit_gram_backward") == iters
    assert counters.get("gramsolve.recompute", 0) == 0
    for a, b in zip(p0, p1):
        assert bool(torch.isfinite(b).all())
        moved = (a - b).abs().reshape(a.shape[0], -1).amax(-1)
        assert bool((moved > 0).all())
    assert float(gp.mll(p1, data).mean()) > float(gp.mll(p0, data).mean())

    def grads(data):
        leaves = [a.clone().requires_grad_(True) for a in p0]
        loss = -gp.mll(type(p0)(*leaves), data).sum()
        return torch.autograd.grad(loss, leaves)

    fused = grads(data)
    with tracing.recording():
        plain = grads(data._replace(X=data.X.clone().requires_grad_(True)))
    assert tracing.report()["counters"].get("gramsolve.recompute") == 1
    for g, h in zip(fused, plain):
        assert _rel(g, h) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,r,nb", [(3, 50, 11, 16), (4, 200, 16, 32),
                                      (2, 200, 64, 32), (2, 1024, 16, 32),
                                      (2, 1024, 64, 32), (2, 1, 1, 32),
                                      (5, 200, 1, 32), (5, 200, 3, 32),
                                      (1, 201, 16, 32), (2, 1000, 3, 32),
                                      (3, 200, 16, 16), (3, 200, 16, 64),
                                      (2, 300, 64, 64), (1, 70, 11, 12),
                                      (2, 45, 5, 6)])
def test_cholsolve_kernels_match_plain(cuda, B, n, r, nb):
    """Every shared-memory plan of kernel 6: the factor's matrix and the
    RHS in shared memory, the matrix in global scratch, both in global
    scratch ((2, 1024, 64)); kernel 7's column groups (several at a small
    batch, one not dividing r at r = 3, 5 and 11), block sizes 6 and 12
    (scalar tile loads), 16, 32 and 64 (kernel 6 runs <64, 256>), ragged
    n and B = 1."""
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
@pytest.mark.parametrize("B,n,r,groups", [(4, 200, 16, 1), (4, 200, 16, 2),
                                          (4, 200, 16, 4), (2, 130, 11, 2),
                                          (2, 130, 11, 3), (2, 1024, 64, 2),
                                          (2, 1024, 64, 16)])
def test_solve_with_factor_column_groups_keep_bits(cuda, B, n, r, groups):
    """However kernel 7 cuts the columns into blocks, each entry's sums run
    in one thread in the same order: kernel 6's solution, bit for bit."""
    rng = np.random.default_rng(n + r)
    R = torch.tensor(rng.normal(size=(B, n, r)), dtype=torch.float32,
                     device=cuda)
    S = torch.tensor(_trajectory_grams(B, n, n), dtype=torch.float32,
                     device=cuda)
    sol, L, Dinv, _ = ck.cholsolve_logdet(S, R)
    got = ck._launch_solve(L, Dinv, R, ck.NB_BLK, groups)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), sol.view(torch.int32))


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
    with tracing.recording():
        _, L, Dinv, _ = ck.cholsolve_logdet(K, R)
        ck.solve_with_factor(L, Dinv, R)
    assert _launches() == {"cholsolve_logdet": 1, "solve_with_factor": 1}
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


def _in_cone(U, slack):
    """Per problem: every cone block of U (B, C, d) in its second-order
    cone, within `slack` of the block's scale (f32 roundoff of the head
    against the tail's norm)."""
    tail = torch.linalg.vector_norm(U[..., 1:], dim=-1)
    return (U[..., 0] - tail >= -slack * (1.0 + U[..., 0].abs())).all(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(4, 4, 4, 1), (3, 3, 1)])
@pytest.mark.parametrize("B", [1, 5, 33, 1000, 1003])
def test_ipm_lane_per_cone_any_batch(cuda, B, dims):
    """Batches that fill no block, one block and many (8 problems of 4
    lanes per block), at both instantiations, cut from one set of 1003
    random problems: contiguous finite outputs in the callers' layout,
    bit for bit the rows of the whole set's solve, and the optimal values
    of the plain version wherever both converge.  The large batches are
    also held to the plain version's statistics: a few iterations as close
    to an f64 run, the full solve's scores and converged count, S and Z in
    their cones wherever both converged (the lanes of a problem took the
    same branches)."""
    whole = [torch.tensor(a, dtype=torch.float32, device=cuda)
             for a in _mixed_cones(1003, len(dims), dims=dims)]
    args = [a[:B].contiguous() for a in whole]
    C, d = len(dims), max(dims)
    got = ik.ipm(*args, 25, 1e-10)
    want = ik.ipm_plain(*args, 25, 1e-10)
    torch.cuda.synchronize()
    assert [tuple(t.shape) for t in got] == [(B, 4), (B, C, d), (B, C, d)]
    assert all(t.is_contiguous() and t.dtype == torch.float32
               and bool(torch.isfinite(t).all()) for t in got)
    for g, w in zip(got, ik.ipm(*whole, 25, 1e-10)):
        assert torch.equal(g, w[:B])
    sg = ik.score_padded(*args[:3], *got)
    sw = ik.score_padded(*args[:3], *want)
    both = (sg < 1e-3) & (sw < 1e-3)
    cost = lambda x: (args[0] * x).sum(-1)
    # f32 optimal values of two roundings of one algorithm: 1e-3 relative
    assert bool(((cost(got[0]) - cost(want[0])).abs()
                 <= 1e-3 * (1.0 + cost(want[0]).abs()))[both].all())
    if B < 1000:
        return
    assert int(both.sum()) >= B // 2
    assert float(sg.median()) <= 2.0 * float(sw.median()) + 1e-6
    assert int((sg < 1e-3).sum()) >= int((sw < 1e-3).sum()) - B // 20
    # an unsolvable random problem's f32 iterates leave the cones, in both
    # versions; the converged ones stay inside
    for g, w in zip(got[1:], want[1:]):
        ok = _in_cone(w, 1e-5) & both
        assert bool(_in_cone(g, 1e-5)[ok].all())
    # three iterations from the cold start: f32 roundoff already separates
    # the two chains on ill-conditioned problems, so each is held against
    # the f64 run of the same iterations: over the problems, the kernel's
    # median distance no more than twice the plain f32 version's
    few = ik.ipm(*args, 3, 1e-10)
    few_plain = ik.ipm_plain(*args, 3, 1e-10)
    exact = ik.ipm_plain(*(a.double() for a in args), 3, 1e-10)
    dist = lambda out: torch.stack([
        ((o.double() - x).abs() / (1.0 + x.abs())).flatten(1).amax(-1)
        for o, x in zip(out, exact)]).amax(0).median()
    assert float(dist(few)) <= 2.0 * float(dist(few_plain)) + 1e-6


@pytest.mark.cuda
def test_ipm_problems_do_not_depend_on_their_neighbours(cuda):
    """A problem's answer is the same bits whatever shares its warp: alone,
    in a batch, and at another place in the batch."""
    args = [torch.tensor(a, dtype=torch.float32, device=cuda)
            for a in _mixed_cones(37, 11, dims=(3, 3, 1))]
    full = ik.ipm(*args, 25, 1e-10)
    perm = torch.randperm(37, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda)
    moved = ik.ipm(*(a[perm].contiguous() for a in args), 25, 1e-10)
    for b in (0, 7, 36):
        one = ik.ipm(*(a[b:b + 1].contiguous() for a in args), 25, 1e-10)
        for f, o in zip(full, one):
            assert torch.equal(f[b:b + 1], o)
    for f, m in zip(full, moved):
        assert torch.equal(f[perm], m)


@pytest.mark.cuda
def test_ipm_rejects_what_the_kernel_cannot_read(cuda):
    args = [torch.tensor(a, dtype=torch.float32, device=cuda)
            for a in _mixed_cones(4, 0)]
    with pytest.raises(ValueError):
        ik.ipm(args[0], args[1].transpose(-1, -2), *args[2:], 5, 1e-10)
    with pytest.raises(ValueError):
        ik.ipm(*(a.movedim(0, -1).contiguous().movedim(-1, 0) for a in args),
               5, 1e-10)
    with pytest.raises(ValueError):
        ik.ipm(*(torch.tensor(a, dtype=torch.float32, device=cuda)
                 for a in _mixed_cones(4, 0, nx=5)), 5, 1e-10)


# the instantiations added with the group width: (3, 5, 3), (4, 6, 4) and
# the car QP's (3, 5, 4) at eight lanes a problem (four problems a block),
# (4, 2, 4) at four
WIDE_SHAPES = [(3, (3, 1, 1, 1, 1)), (4, (4, 1, 1, 1, 1, 1)), (4, (4, 4)),
               (3, (4, 1, 1, 1, 1))]
# the options' instantiations, four lanes a problem: the pendulum
# controller with hard CBC2 cones (3, 2, 3), with a CLC (3, 3, 3), relaxed
# with a CLC (4, 4, 3), and solve_qp_active_set's lifted QP (3, 3, 4)
OPTION_SHAPES = [(3, (3, 3)), (3, (3, 3, 3)), (4, (3, 3, 1, 3)),
                 (3, (4, 1, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("nx,dims", WIDE_SHAPES + OPTION_SHAPES)
@pytest.mark.parametrize("B", [1, 3, 256, 1003])
def test_ipm_group_width_shapes_match_plain(cuda, B, nx, dims):
    """Batches cut from one set of 1003 random problems of the shape, one
    problem to many blocks and a ragged last block: contiguous finite
    outputs, the rows of the whole set's solve bit for bit, the plain
    version's optimal values wherever both converge (1e-3 relative, two
    f32 roundings), padded ray tails exactly 0; the large batches also
    within 2x plain's median score and 5% of its converged count."""
    whole = [torch.tensor(a, dtype=torch.float32, device=cuda)
             for a in _mixed_cones(1003, 20 + len(dims), nx=nx, dims=dims)]
    args = [a[:B].contiguous() for a in whole]
    C, d = len(dims), max(dims)
    got = ik.ipm(*args, 25, 1e-10)
    want = ik.ipm_plain(*args, 25, 1e-10)
    torch.cuda.synchronize()
    assert [tuple(t.shape) for t in got] == [(B, nx), (B, C, d), (B, C, d)]
    assert all(t.is_contiguous() and bool(torch.isfinite(t).all())
               for t in got)
    for g, w in zip(got, ik.ipm(*whole, 25, 1e-10)):
        assert torch.equal(g, w[:B])
    for ci, dd in enumerate(dims):
        if dd < d:
            assert not bool(got[1][:, ci, dd:].any())
            assert not bool(got[2][:, ci, dd:].any())
    sg = ik.score_padded(*args[:3], *got)
    sw = ik.score_padded(*args[:3], *want)
    both = (sg < 1e-3) & (sw < 1e-3)
    cost = lambda x: (args[0] * x).sum(-1)
    assert bool(((cost(got[0]) - cost(want[0])).abs()
                 <= 1e-3 * (1.0 + cost(want[0]).abs()))[both].all())
    if B >= 256:
        assert int(both.sum()) >= B // 2
        assert float(sg.median()) <= 2.0 * float(sw.median()) + 1e-6
        assert int((sg < 1e-3).sum()) >= int((sw < 1e-3).sum()) - B // 20


@pytest.mark.cuda
def test_ipm_raises_on_an_uninstantiated_shape(cuda):
    """(4, 9, 4) has no instantiation: ValueError naming the ones there
    are, and no launch; the library lists the shapes the port's paths
    solve, each with a group width that holds its cones, and its entry
    point refuses any other shape itself."""
    from bayesian_cbf_tpu_torch.ops import _build
    args = [torch.tensor(a, dtype=torch.float32, device=cuda)
            for a in _mixed_cones(4, 0, dims=(4,) + (1,) * 8)]
    with tracing.recording():
        with pytest.raises(ValueError, match="instantiated"):
            ik.ipm(*args, 5, 1e-10)
    assert _launches() == {}
    lib = _build.load("ipm")
    shapes = ik.instantiated_shapes()
    assert {(4, 4, 4), (4, 3, 3), (3, 5, 3), (4, 6, 4), (4, 2, 4),
            (3, 5, 4), (3, 2, 3), (3, 3, 3), (4, 4, 3), (3, 3, 4)} \
        <= set(shapes)
    for nx, C, d in shapes:
        assert ik.group_width(nx, C, d) in (4, 8)
        assert C <= ik.group_width(nx, C, d)
    assert ik.group_width(4, 9, 4) == 0
    out = [torch.empty_like(a) for a in args[3:]]
    assert lib.ipm_launch(*(a.data_ptr() for a in args + out), 4, 4, 9, 4,
                          5, 1e-10,
                          torch.cuda.current_stream(cuda).cuda_stream) != 0


@pytest.mark.cuda
def test_qp_and_option_controllers_on_the_card(cuda):
    """solve_qp_active_set at (3, 3, 4) and one pendulum control step with
    hard cones and a CLC at (3, 3, 3) on the card, in f32 against the same
    in f64 on the CPU: the QP's u within 1e-2 (f32 IPM on the epigraph
    cone), the control step's u where both are feasible within 1e-2
    relative, one IPM launch each."""
    from bayesian_cbf_tpu_torch.control import learned_socp_controller as lsc
    from bayesian_cbf_tpu_torch.experiments import pendulum as tp
    from bayesian_cbf_tpu_torch.solvers.qp import solve_qp_active_set
    rng = np.random.default_rng(3)
    qp = (rng.normal(size=(8, 3, 2)), rng.normal(size=(8, 3)),
          np.broadcast_to(np.eye(2), (8, 2, 2)).copy(), np.full((8, 2), 0.5))
    with tracing.recording():
        u, sol = solve_qp_active_set(*(torch.tensor(a, dtype=torch.float32,
                                                    device=cuda) for a in qp))
    assert _launches() == {"ipm": 1}
    assert tuple(sol.z.shape) == (8, 3, 4)
    u64, _ = solve_qp_active_set(*(torch.tensor(a) for a in qp))
    assert float((u.double().cpu() - u64).abs().max()) < 1e-2
    out = {}
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        sim = tp.make_pendulum_online_sim(max_train=8, device=dev, dtype=dt)
        lrn = sim.learned
        st = _to(lrn.init_state(4, torch.Generator().manual_seed(0), "cpu",
                                dt), dev)
        x = torch.tensor([[2.0, 0.1], [1.9, -0.3], [2.2, 0.5], [1.7, 0.0]],
                         dtype=dt, device=dev)
        cfg = sim.controller._replace(cbc_relax=False, debug_cones=True)
        u_ref = torch.full((4, 1), 0.3, dtype=dt, device=dev)
        out[dt] = lsc.learned_socp_control(
            cfg, (sim.cbf,), lrn.moment_derivatives(st, x), u_ref, x, u_ref,
            state=st, clc_fn=lsc.norm2_clc(lrn.f_gp_and_fu_gp, 2, 1.0, 0.01))
    (u32, i32), (u64, i64) = out[torch.float32], out[torch.float64]
    assert tuple(i32.G.shape) == (4, 9, 3)
    both = i32.feasible.cpu() & i64.feasible
    assert bool(torch.equal(i32.certified.cpu(), i32.feasible.cpu()))
    assert float(((u32.double().cpu() - u64).abs()
                  / (1.0 + u64.abs()))[both].max(initial=0.0)) < 1e-2


def _to(tree, dev):
    """A tree of tensors (NamedTuples, tuples; None leaves) on `dev`."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.to(dev)
    return type(tree)(*(_to(a, dev) for a in tree)) \
        if hasattr(tree, "_fields") else type(tree)(_to(a, dev) for a in tree)


def _car_cones(cuda, B, seed):
    """The car's ground-truth QP at B states about its start, + 0.3 N(0, 1)
    in position and 0.1 N(0, 1) elsewhere, padded to (3, 5, 4), with the
    cold start."""
    from bayesian_cbf_tpu_torch.experiments import car as tx
    from bayesian_cbf_tpu_torch.solvers.socp import _pad_cones
    rng = np.random.default_rng(seed)
    x = np.asarray(tx.CAR_START)[None] + rng.normal(size=(B, 6)) * np.array(
        [0.1, 0.1, 0.1, 0.3, 0.3, 0.1])
    x = torch.tensor(x, dtype=torch.float32, device=cuda)
    cobj, G, h, dims = tx.car_ground_truth_socp(
        x, tx.car_obstacles(device=cuda), torch.zeros(2, device=cuda))
    Gp, hp = _pad_cones(G, h, dims)
    e = torch.zeros_like(hp)
    e[..., 0] = 1.0
    return [cobj.expand(B, -1).contiguous(), Gp, hp,
            torch.zeros_like(cobj.expand(B, -1)).contiguous(), e, e.clone()]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 256, 1003])
def test_ipm_car_shape_on_car_cones(cuda, B):
    """(3, 5, 4) on the car QP's real cones, cold (25 iterations) and
    warm-started from plain's solution shifted inside its cones on data
    moved by 1e-3 (15 iterations), each against an f64 solve of the same
    iterations: at least as many converged problems as plain f32 within
    5%, and on the problems all three converge, the kernel's relative
    cost error's median and 90th percentile no more than twice plain
    f32's (plain f32 itself is up to 2.4e-3 off the f64 cost there on the
    CPU, so the two f32 costs are not held to each other); one problem
    alone gives the bits of the batched launch."""
    from bayesian_cbf_tpu_torch.solvers.socp import _interior_shift
    args = _car_cones(cuda, B, 7)
    assert tuple(args[1].shape) == (B, 5, 4, 3)
    cost = lambda x: (args[0].double() * x.double()).sum(-1)
    q = lambda v: torch.quantile(v, torch.tensor([0.5, 0.9], device=cuda,
                                                 dtype=v.dtype))
    start = args[3:]
    for iters in (25, 15):
        if iters == 15:
            x, S, Z = ik.ipm_plain(*args[:3], *args[3:], 25, 1e-10)
            start = [x, _interior_shift(S), _interior_shift(Z)]
            args = args[:2] + [args[2] + 1e-3 * args[4]] + args[3:]
        got = ik.ipm(*args[:3], *start, iters, 1e-10)
        want = ik.ipm_plain(*args[:3], *start, iters, 1e-10)
        exact = ik.ipm_plain(*(a.double() for a in args[:3] + start), iters,
                             1e-10)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t).all()) for t in got)
        sg = ik.score_padded(*args[:3], *got)
        sw = ik.score_padded(*args[:3], *want)
        se = ik.score_padded(*(a.double() for a in args[:3]), *exact)
        assert int((sg < 1e-3).sum()) >= int((sw < 1e-3).sum()) - B // 20
        all3 = (sg < 1e-3) & (sw < 1e-3) & (se < 1e-6)
        assert int(all3.sum()) >= (B + 1) // 2
        ref = cost(exact[0])
        err = lambda x: ((cost(x) - ref).abs() / (1.0 + ref.abs()))[all3]
        ek, ep = q(err(got[0])), q(err(want[0]))
        assert bool((ek <= 2.0 * ep + 1e-6).all()), (iters, ek, ep)
        if B > 1:
            one = ik.ipm(*(a[:1].contiguous() for a in args[:3] + start),
                         iters, 1e-10)
            for g, w in zip(one, got):
                assert torch.equal(g, w[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("continuous", [False, True])
def test_serving_ticks_on_the_card_follow_the_cpu(cuda, continuous):
    """12 serving ticks of a small unicycle configuration (K = 8, a refit
    at t = 8) on the card against the same ticks on the CPU in f32, from
    the same initial weights and draws: every control within 5e-2 relative
    (the IPM's f32 floor, amplified by the refit), the same reservoir
    counts, and the launches the schedule implies: one IPM a tick, the
    refit's Adam iterations through kernel 1, three factorizations through
    kernel 2 per cache refresh (the refit's and, with continuous updates,
    each accepted replacement once the reservoir is full)."""
    from bayesian_cbf_tpu_torch.deploy import CompiledController
    from bayesian_cbf_tpu_torch.experiments import unicycle as tu
    from bayesian_cbf_tpu_torch.models.dynamics import _map
    kw = dict(numSteps=24, dt=0.01, max_train=8, training_iter=5,
              train_every_n_steps=8)
    draws = [0, 0, 1, 2, 3, 4, 5, 6, 7, 3, 9, 5]
    runs = {}
    for dev in ("cpu", "cuda"):
        sim = tu.make_ackermann_tracking_sim(**kw, device=dev)
        ctl = CompiledController(sim, tu.STATE_START,
                                 torch.Generator(device=dev).manual_seed(0),
                                 continuous_updates=continuous, device=dev)
        if dev == "cuda":
            ctl.restore(_map(lambda a: a.to(cuda), runs["cpu"][2]))
        start = ctl.state()
        refreshes = 0
        U = []
        with tracing.recording():
            for j in draws:
                before = int(ctl.state()[1].count_res)
                U.append(ctl.tick(draw=j)[0])
                after = int(ctl.state()[1].count_res)
                refreshes += int(continuous and after > before
                                 and before >= kw["max_train"])
        launched = _launches()
        counts = tuple(launched.get(k, 0)
                       for k in ("ipm", "kinv_logdet", "chol_linv"))
        runs[dev] = (np.array(U), int(ctl.state()[1].count_res), start,
                     counts, refreshes)
    (Uc, nc, _, cc, rc), (Ug, ng, _, cg, rg) = runs["cpu"], runs["cuda"]
    assert np.all(np.isfinite(Ug)) and ng == nc
    assert np.abs(Ug - Uc).max() / (1.0 + np.abs(Uc).max()) < 5e-2
    assert cg == (len(draws), kw["training_iter"], 3 * (1 + rg))


@pytest.mark.cuda
def test_spans_read_the_streams_time(cuda):
    """On the card every span of a 3-step pendulum batch carries the
    stream's time between its two events: non-null, non-negative, the
    phases of a step within the step's; the launch counters count the
    batch's kernels."""
    from bayesian_cbf_tpu_torch.experiments import pendulum as tp
    sim = tp.make_pendulum_online_sim(numSteps=3, max_train=8,
                                      training_iter=2, train_every_n_steps=1,
                                      device=cuda)
    x0s = torch.tensor([[tp.THETA0, 0.0]] * 4)
    tp.run_pendulum_online_batch(sim, x0s, torch.Generator(
        device=cuda).manual_seed(0))
    with tracing.recording():
        tp.run_pendulum_online_batch(sim, x0s, torch.Generator(
            device=cuda).manual_seed(0))
    spans = tracing.report()["spans"]
    assert set(spans) == {"step", "step/moments", "step/lqr", "step/cones",
                          "step/socp", "fit"}
    for row in spans.values():
        assert row["device_ns"] is not None and row["device_ns"] >= 0
        assert row["self_device_ns"] is not None
    phases = sum(spans[p]["device_ns"] for p in spans
                 if p.startswith("step/"))
    assert phases <= spans["step"]["device_ns"] + 1000 * 3
    assert _launches()["ipm"] == 3
