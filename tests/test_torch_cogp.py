"""The CoGP and the MVGP-against-CoGP experiments of the PyTorch port
against the JAX package on the CPU, f64: the CoGP's kernel, Gram, MLL and
its gradient, a short fit from the same initial hyperparameters, the
cache and the posterior (the full-rank and the rank-0 task covariance, on
half-masked data); `_block_diag_vars`; `learn_dynamics_matrix_vector` and
`speed_test_matrix_vector` on JAX's pendulum data and
`unicycle_speed_test`, from JAX's initial hyperparameters.  Also the bits of `MVGP.fit` against the loop it had
before the fits shared `adam_fit`.

The CoGP computes JAX's expressions in the same order, so its bars are
roundoff (1e-10 relative); a fit is a few Adam steps on gradients that
agree to ~1e-12, held at 1e-8; the experiments' errors sum over test
subsets, held at 1e-7 relative.  Inputs are made with numpy from a seed;
the two sides exchange numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.experiments import pendulum as jp
from bayesian_cbf_tpu.experiments import unicycle as ju
from bayesian_cbf_tpu.models import cogp as jc
from bayesian_cbf_tpu.models.mvgp import MVGPData as JData
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.experiments import pendulum as tp
from bayesian_cbf_tpu_torch.experiments import unicycle as tu
from bayesian_cbf_tpu_torch.models import cogp as tc
from bayesian_cbf_tpu_torch.models import mvgp as tm
from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.utils import linalg as tla

F64 = torch.float64
N, M, K = 2, 1, 16
MAKERS = [("full", jc.make_cogp, tc.make_cogp),
          ("diag", jc.make_cogp_diag, tc.make_cogp_diag)]


def _close(got, want, rtol=1e-10):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not want.size:
        return
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def _case(rank, seed=0):
    """A half-masked trajectory data set and random hyperparameters."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(0.2 * rng.normal(size=(K, N)), 0)
    U = rng.normal(size=(K, M))
    data = dict(X=X, UH=np.concatenate([np.ones((K, 1)), U], 1),
                Xdot=rng.normal(size=(K, N)),
                mask=np.r_[np.ones(K // 2), np.zeros(K // 2)])
    t = (1 + M) * N
    params = dict(raw_lengthscale=0.5 + 0.2 * rng.normal(size=N),
                  raw_outputscale=np.asarray(0.3 + 0.1 * rng.normal()),
                  raw_linscale=np.asarray(-1.5 + 0.1 * rng.normal()),
                  W_S=0.3 * rng.normal(size=(t, rank)),
                  raw_vS=0.5 + 0.1 * rng.normal(size=t),
                  mean_M=0.1 * rng.normal(size=(1 + M, N)))
    return data, params


def _jax_pair(data, params):
    return (jc.CoGPParams(**{k: jnp.asarray(v) for k, v in params.items()}),
            JData(**{k: jnp.asarray(v) for k, v in data.items()}))


def _torch_pair(data, params):
    return (interop.cogp_params_from_numpy(params, "cpu", F64),
            tm.MVGPData(*(torch.tensor(data[f]) for f in tm.MVGPData._fields)))


@pytest.mark.parametrize("name, jmake, tmake", MAKERS)
def test_kernel_gram_mll_and_gradient_match_jax(name, jmake, tmake):
    jgp, gp = jmake(N, M), tmake(N, M)
    data, params = _case(gp.rank)
    jpar, jdat = _jax_pair(data, params)
    tpar, tdat = _torch_pair(data, params)
    _close(gp.k_xx(tpar, tdat.X, tdat.X[:5]), jgp.k_xx(jpar, jdat.X,
                                                       jdat.X[:5]))
    _close(gp.gram(tpar, tdat), jgp.gram(jpar, jdat))
    _close(tpar.Sigma, jpar.Sigma)
    leaves = [a.clone().requires_grad_(True) for a in tpar]
    ll = gp.mll(tc.CoGPParams(*leaves), tdat)
    grads = torch.autograd.grad(ll, leaves)
    jll, jg = jax.value_and_grad(lambda p: jgp.mll(p, jdat))(jpar)
    _close(ll, jll)
    for f, g in zip(tc.CoGPParams._fields, grads):
        _close(g, getattr(jg, f), 1e-9)


@pytest.mark.parametrize("name, jmake, tmake", MAKERS)
def test_fit_cache_and_posterior_match_jax(name, jmake, tmake):
    """Six Adam steps (the schedule's boundaries at 1, 3, 4, 5) from the
    same hyperparameters; the rank-0 W_S (4, 0) passes through the fit.
    The fit moves every scale, and each factorization accepts the first
    rung of the ladder."""
    jgp, gp = jmake(N, M), tmake(N, M)
    data, params = _case(gp.rank, seed=1)
    jpar, jdat = _jax_pair(data, params)
    tpar, tdat = _torch_pair(data, params)
    with tracing.recording():
        fitted = gp.fit(tpar, tdat, training_iter=6)
        cache = gp.refresh_cache(fitted, tdat)
    rungs = [tracing.report()["counters"].get(f"psd_cholesky.rung{i}", 0)
             for i in range(10)]
    jfit = jgp.fit(jpar, jdat, training_iter=6)
    assert fitted.W_S.shape == ((1 + M) * N, gp.rank)
    for f in tc.CoGPParams._fields:
        _close(getattr(fitted, f), getattr(jfit, f), 1e-8)
    for f in ("raw_lengthscale", "raw_outputscale", "raw_linscale",
              "raw_vS"):
        assert (getattr(fitted, f) - getattr(tpar, f)).abs().min() > 1e-3, f
    jcache = jgp.refresh_cache(jfit, jdat)
    _close(cache.L, jcache.L, 1e-9)
    _close(cache.alpha, jcache.alpha, 1e-8)
    Xtest = np.random.default_rng(2).normal(size=(5, N))
    mean, var = gp.predict_fullmat(fitted, tdat, cache, torch.tensor(Xtest))
    jmean, jvar = jgp.predict_fullmat(jfit, jdat, jcache, jnp.asarray(Xtest))
    _close(mean, jmean, 1e-8)
    _close(var, jvar, 1e-8)
    assert torch.equal(var, var.T)
    # 6 steps + the refresh, one matrix each, all on rung 0
    assert rungs == [7] + [0] * 9


def test_init_params_shapes_and_failed_ladder_counted():
    """init_params draws W_S from the generator; a matrix no rung of the
    ladder factors gives L = 0 and counts in the last bin."""
    gen = torch.Generator().manual_seed(0)
    p = tc.make_cogp(2, 1).init_params(gen, "cpu", F64)
    assert p.W_S.shape == (4, 4) and p.W_S.std() > 0.05
    assert tc.make_cogp_diag(3, 2).init_params(
        gen, "cpu", torch.float32).W_S.shape == (9, 0)
    np.testing.assert_allclose(float(p.linscale), 0.1)
    mats = torch.tensor([[[1.0, 0.0], [0.0, 1.0]],
                         [[0.0, 100.0], [100.0, 0.0]]], dtype=F64)
    with tracing.recording():
        _, L = tla.psd_cholesky(mats)
    assert torch.equal(L[1], torch.zeros(2, 2, dtype=F64))
    assert tracing.report()["counters"] == {"psd_cholesky.rung0": 1,
                                            "psd_cholesky.rung9": 1,
                                            **{f"psd_cholesky.rung{i}": 0
                                               for i in range(1, 9)}}


def test_psd_cholesky_gradient_flows_through_the_accepted_rung():
    """A slightly indefinite matrix fails the unjittered rung: the factor
    and its gradient are those of the accepted rung's matrix alone, with
    the jitter's dependence on the diagonal scale."""
    rng = np.random.default_rng(6)
    G = rng.normal(size=(5, 5))
    w, v = np.linalg.eigh(G @ G.T)
    K = torch.tensor((v * np.array([-1e-4, 0.5, 1.0, 2.0, 3.0])) @ v.T,
                     requires_grad=True)
    W = torch.tensor(rng.normal(size=(5, 5)))
    with tracing.recording():
        Kj, L = tla.psd_cholesky(K)
    counts = tracing.report()["counters"]
    rung = max(range(10), key=lambda i: counts[f"psd_cholesky.rung{i}"])
    assert 0 < rung < 9
    (g,) = torch.autograd.grad((L * W).sum(), K)
    Ks = 0.5 * (K + K.T)
    scale = torch.clamp(torch.diagonal(Ks).abs().mean(), min=1.0)
    Kref = Ks + 1e-6 * 10.0 ** (rung - 1) * scale * torch.eye(5, dtype=F64)
    Lref = torch.linalg.cholesky(Kref)
    (gref,) = torch.autograd.grad((Lref * W).sum(), K)
    _close(Kj, Kref.detach().numpy(), 1e-15)
    _close(L, Lref.detach().numpy(), 1e-14)
    assert torch.isfinite(g).all()
    _close(g, gref.numpy(), 1e-12)
    # without autograd the factor is the accepting batch's own
    with torch.no_grad():
        Kn, Ln = tla.psd_cholesky(K)
    assert torch.equal(Ln, L.detach()) and torch.equal(Kn, Kj.detach())


def _fit_before_shared_adam(gp, params, data, training_iter, lr=0.1):
    """`MVGP.fit` as it was before it called `adam_fit`, verbatim."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    boundaries = sorted({int(f * training_iter): 0.1
                         for f in (0.3, 0.6, 0.8, 0.9)}.items())
    p = [a.detach() for a in params]
    mu = [torch.zeros_like(a) for a in p]
    nu = [torch.zeros_like(a) for a in p]
    batch = p[0].shape[0]
    dtype = p[0].dtype
    count = torch.zeros((batch,), dtype=torch.int32, device=p[0].device)

    def per_ep(mask_b, a):
        return mask_b.reshape(mask_b.shape + (1,) * (a.ndim - 1))

    def all_finite(a):
        return torch.isfinite(a).reshape(a.shape[0], -1).all(-1)

    for _ in range(training_iter):
        leaves = [a.clone().requires_grad_(True) for a in p]
        with torch.enable_grad():
            loss = -gp.mll(tm.MVGPParams(*leaves), data)
            grads = torch.autograd.grad(loss.sum(), leaves)
        loss = loss.detach()
        count_inc = count + 1
        cf = count_inc.to(dtype)
        bc1 = 1 - torch.pow(torch.full_like(cf, b1), cf)
        bc2 = 1 - torch.pow(torch.full_like(cf, b2), cf)
        step = torch.full((batch,), lr, dtype=dtype, device=cf.device)
        for threshold, scale in boundaries:
            ind = torch.clamp(torch.sign(
                (threshold - count).to(dtype)), min=0.0)
            step = step * ind + (1 - ind) * scale * step
        ok = torch.isfinite(loss)
        new = []
        for a, g, m_, v_ in zip(p, grads, mu, nu):
            m_n = (1 - b1) * g + b1 * m_
            v_n = (1 - b2) * g ** 2 + b2 * v_
            upd = ((m_n / per_ep(bc1, m_n))
                   / (torch.sqrt(v_n / per_ep(bc2, v_n)) + eps))
            upd = -(per_ep(step, upd) * upd)
            a_n = torch.clamp(a + upd, -60.0, 60.0)
            new.append((a_n, m_n, v_n))
            ok = ok & all_finite(g) & all_finite(a_n)
        p = [torch.where(per_ep(ok, a), a_n, a)
             for a, (a_n, _, _) in zip(p, new)]
        mu = [torch.where(per_ep(ok, m_), m_n, m_)
              for m_, (_, m_n, _) in zip(mu, new)]
        nu = [torch.where(per_ep(ok, v_), v_n, v_)
              for v_, (_, _, v_n) in zip(nu, new)]
        count = torch.where(ok, count_inc, count)
    return tm.MVGPParams(*p)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_mvgp_fit_keeps_its_bits_through_adam_fit(dtype):
    """Three episodes (the last with a NaN target, whose steps are all
    rejected), 10 iterations across every schedule boundary."""
    rng = np.random.default_rng(4)
    Bsz, k = 3, 14
    X = torch.tensor(np.cumsum(0.1 * rng.normal(size=(Bsz, k, 3)), 1),
                     dtype=dtype)
    U = torch.tensor(rng.normal(size=(Bsz, k, 2)), dtype=dtype)
    Xdot = torch.tensor(rng.normal(size=(Bsz, k, 3)), dtype=dtype)
    Xdot[2, 0, 0] = float("nan")
    gp = tm.make_mvgp_rank1(3, 2)
    data = gp.make_data(X, U, Xdot)
    params = gp.init_params(Bsz, torch.Generator().manual_seed(1), "cpu",
                            dtype)
    got = gp.fit(params, data, training_iter=10)
    want = _fit_before_shared_adam(gp, params, data, 10)
    for f, g, w in zip(tm.MVGPParams._fields, got, want):
        assert torch.equal(g, w), f
    assert torch.equal(got.W_A[2], params.W_A[2])
    assert not torch.equal(got.W_A[0], params.W_A[0])


def test_block_diag_vars_matches_jax():
    rng = np.random.default_rng(5)
    b, D = 4, 3
    G = rng.normal(size=(b * D, b * D))
    var = G @ G.T
    _close(tp._block_diag_vars(torch.tensor(var), b),
           jp._block_diag_vars(jnp.asarray(var), b), 1e-14)
    got = tp._block_diag_vars(torch.tensor(var, dtype=torch.float32), b)
    want = np.stack([var[i * D:(i + 1) * D, i * D:(i + 1) * D]
                     for i in range(b)]) + 1e-4 * np.eye(D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.fixture(scope="module")
def pendulum_data():
    """JAX's 2048-step pendulum trajectory (seed 0) and its initial
    hyperparameters of the four regressors (PRNGKey(0))."""
    X, U, Xdot = (np.array(a) for a in jp.sample_pendulum_data(
        numSteps=2048, seed=0))
    return (X, U, Xdot), _jax_init(2, 1)


def _jax_init(n, m):
    """JAX's initial hyperparameters of the four regressors (PRNGKey(0))
    in the port's types."""
    init = {}
    for name, maker in jp._REGRESSORS.items():
        p = maker(n, m).init_params(jax.random.PRNGKey(0))
        arrays = {f: np.asarray(getattr(p, f)) for f in p._fields}
        if name.startswith("matrix"):
            init[name] = interop.mvgp_params_from_numpy(
                {f: a[None] for f, a in arrays.items()}, "cpu", F64)
        else:
            init[name] = interop.cogp_params_from_numpy(arrays, "cpu", F64)
    return init


def test_learn_dynamics_matches_jax(pendulum_data):
    """At a reduced size (24 training rows, 8 iterations, 3 tries of 32),
    and the fit moves both models."""
    data, init = pendulum_data
    kw = dict(max_train=24, training_iter=8, n_test=32, tries=3, seed=0)
    fitted = {}
    got = tp.learn_dynamics_matrix_vector(
        **kw, data=data, params0=init, params_out=fitted, device="cpu",
        dtype=F64)
    want = jp.learn_dynamics_matrix_vector(**kw)
    assert sorted(got) == ["matrix", "vector"]
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-7)
        p0, p1 = fitted[name]
        assert (p1.raw_lengthscale - p0.raw_lengthscale).abs().min() > 1e-3


def test_speed_test_miniature_matches_jax(pendulum_data):
    """Every regressor at k = 10 on a 4 x 4 lattice: finite times, and
    JAX's errors."""
    (X, U, Xdot), init = pendulum_data
    th = np.linspace(X[:, 0].min(), X[:, 0].max(), 4)
    om = np.linspace(X[:, 1].min(), X[:, 1].max(), 4)
    Xtest = np.stack(np.meshgrid(th, om), -1).reshape(-1, 2)
    Ftrue = tp._pendulum_F_true(torch.tensor(Xtest)).numpy()
    kw = dict(max_train_list=(10,), ntimes=1, repeat=1, training_iter=3,
              seed=0)
    got = tp.speed_test_matrix_vector(
        **kw, data=(X, U, Xdot), Xtest=Xtest, Ftrue=Ftrue, params0=init,
        device="cpu", dtype=F64)
    want = jp.speed_test_matrix_vector(
        **kw, data=tuple(jnp.asarray(a) for a in (X, U, Xdot)),
        Xtest=jnp.asarray(Xtest), Ftrue=jnp.asarray(Ftrue))
    assert sorted(got) == sorted(want)
    for name in got:
        for k in (10,):
            assert 0 < got[name][k]["elapsed"] < 10
            np.testing.assert_allclose(got[name][k]["error"],
                                       want[name][k]["error"], rtol=1e-7)


def test_unicycle_speed_test_matches_jax():
    """A 16-step episode without learning, k = 8, the 11 x 11 x 4
    lattice (D = 9), one regressor of each family from JAX's initial
    hyperparameters.  The episode ends each step at the IPM's floor: a
    1e-14 change of the start moves JAX's own episode by 6.5e-7 in X, and
    the port's lies 3.8e-7 from it, which moves the errors by 5e-6
    relative (measured); held at 1e-4."""
    kw = dict(max_train_list=(8,), ntimes=1, repeat=1, training_iter=2,
              regressors=("matrix", "vectordiag"), numSteps=16)
    got = tu.unicycle_speed_test(**kw, params0=_jax_init(3, 2), device="cpu",
                                 dtype=F64)
    want = ju.unicycle_speed_test(**kw)
    for name in kw["regressors"]:
        np.testing.assert_allclose(got[name][8]["error"],
                                   want[name][8]["error"], rtol=1e-4)
