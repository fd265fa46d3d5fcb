"""The fit-inverse and L^{-1}-assembly configurations of the PyTorch port
against the JAX package: the plain Schur/sweep inverse (ops/sweep_kernels)
and the plain blocked factor with diagonal-block inverses
(ops/chol_kernels.chol_dinv, "row"/"col" assembly) against the Pallas
kernels in interpret mode (f32); `batched_kinv_logdet_fit` under each
method against the JAX function under the same `FIT_INVERSE`; the MLL with
`fused_fit=False`; the recursion's failure pin on trajectory Grams
(tests/test_fit_inverse.py); and f32 fits that must move the
hyperparameters.  The CUDA kernels are tested on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_cbf_tpu.models.mvgp as jmv
from bayesian_cbf_tpu.models.mvgp import (MVGPData as JData,
                                          MVGPParams as JParams)
from bayesian_cbf_tpu.ops import cholinv as jci
from bayesian_cbf_tpu.ops import pallas_chol as jpc
from bayesian_cbf_tpu.ops import pallas_sweep as jps
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.models.mvgp import MVGPData, make_mvgp_rank1
from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
from bayesian_cbf_tpu_torch.ops import cholinv
from bayesian_cbf_tpu_torch.ops import sweep_kernels as sk


def _trajectory_gram(k=200, seed=42, step=0.02, nug=2.5e-4):
    """tests/test_fit_inverse.py's random-walk RBF Gram (kappa ~8e5 in
    f32): the conditioning of a real flagship fit buffer."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(step * rng.normal(size=(k, 3)), 0).astype(np.float32)
    d = X[:, None, :] - X[None, :, :]
    return (np.exp(-0.5 * np.sum(d * d, -1)) + nug * np.eye(k)).astype(
        np.float32)


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    return (A @ A.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)


# ---- the Schur/sweep inverse ------------------------------------------------

@pytest.mark.parametrize("B,n", [(3, 200), (2, 33), (1, 32), (1, 9)])
def test_sweep_plain_matches_pallas_interpret(B, n):
    """n = 33 and 9 pad to N = 40 and 16: the split points of the padded
    recursion decide the rounding, so both sides agree to f32 roundoff."""
    K = _spd(B, n, n)
    Kinv, ld = sk.batched_kinv_logdet_plain(torch.tensor(K))
    jKinv, jld = jps.batched_kinv_logdet(jnp.asarray(K), interpret=True,
                                         chunk=1)
    jKinv = np.asarray(jKinv)
    # the same recursion and association in f32 (measured 1.7e-7)
    np.testing.assert_allclose(Kinv.numpy(), jKinv, rtol=0,
                               atol=1e-5 * np.abs(jKinv).max())
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=1e-5,
                               atol=1e-3)


def test_schedule_splits_like_the_jax_recursion():
    """The events walk the padded recursion: base 8 up to n = 256, 16
    above; the first split of N at h = (N // (2 base)) base."""
    for n, base, first_h in ((200, 8, 96), (33, 8, 16), (300, 16, 144)):
        assert sk.pick_base(n) == jps._pick_base(n) == base
        N = jps._padded_size(n, base)
        assert sk.padded_order(n, base) == N
        pre = [e for e in sk.schedule(n, base) if e[0] == sk.PRE]
        assert (0, first_h) in [(o, h) for _, o, h, _ in pre]
        assert (N // (2 * base)) * base == first_h
    assert sk.schedule(50, sk.full_base(50)) == [(sk.SWEEP, 0, 50, 0)]


def test_sweep_recursion_fails_on_trajectory_gram_pinned():
    """JAX behaviour kept, not repaired: every recursive split of the
    trajectory Gram goes non-finite in f32."""
    K = torch.tensor(_trajectory_gram())[None]
    Kinv, ld = sk.batched_kinv_logdet_plain(K)
    assert not (bool(torch.isfinite(Kinv).all())
                and bool(torch.isfinite(ld).all()))


def test_sweep_full_is_finite_on_trajectory_gram():
    """tests/test_fit_inverse.py's bars for FIT_INVERSE = "sweep_full"."""
    Km = _trajectory_gram()
    M64 = Km.astype(np.float64)
    Kinv, ld = cholinv.batched_kinv_logdet_fit(torch.tensor(Km)[None],
                                               method="sweep_full")
    Kinv = Kinv[0].numpy().astype(np.float64)
    assert np.all(np.isfinite(Kinv))
    assert np.max(np.abs(Kinv @ M64 - np.eye(200))) < 5e-2
    assert abs(float(ld[0]) - np.linalg.slogdet(M64)[1]) < 0.5


# ---- the blocked factor with diagonal-block inverses ------------------------

@pytest.mark.parametrize("assembly", ["row", "col"])
def test_chol_dinv_assembly_matches_pallas_interpret(assembly):
    n, nb = 50, 16
    K = np.stack([_spd(1, n, 5)[0], _trajectory_gram(n, 3), _spd(1, n, 6)[0]])
    L, Linv = ck.chol_linv_assembled(torch.tensor(K), assembly, nb)
    jL, jLinv = jpc.batched_chol_with_inv(jnp.asarray(K), interpret=True,
                                          nb=nb, assembly=assembly)
    jL, jLinv = np.asarray(jL, np.float64), np.asarray(jLinv, np.float64)
    for b in (0, 2):
        # well-conditioned SPD: both f32 factorizations agree elementwise
        np.testing.assert_allclose(L[b].numpy(), jL[b], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(Linv[b].numpy(), jLinv[b], rtol=1e-4,
                                   atol=1e-5)
    # trajectory Gram (kappa ~1e5): both meet the Cholesky-class bars
    K64 = K[1].astype(np.float64)
    for Lb, Lib in ((L[1].numpy().astype(np.float64),
                     Linv[1].numpy().astype(np.float64)), (jL[1], jLinv[1])):
        assert np.abs(Lib @ Lb - np.eye(n)).max() < 5e-2
        assert np.abs(Lb @ Lb.T - K64).max() / np.abs(K64).max() < 1e-5


def test_chol_dinv_plain_blocks_invert_the_diagonal():
    K = torch.tensor(_spd(2, 40, 7), dtype=torch.float64)
    L, Dinv = ck.chol_dinv_plain(K, 16)
    assert L.shape == (2, 48, 48) and Dinv.shape == (2, 48, 16)
    assert torch.equal(L[:, 40:, 40:], torch.eye(8, dtype=K.dtype).expand(
        2, 8, 8))
    for o in range(0, 48, 16):
        prod = Dinv[:, o:o + 16] @ L[:, o:o + 16, o:o + 16]
        torch.testing.assert_close(prod, torch.eye(16, dtype=K.dtype).expand(
            2, 16, 16), rtol=0, atol=1e-12)


# ---- routing by method, against the JAX function ---------------------------

@pytest.mark.parametrize("method,assembly", [
    ("cholk", ""), ("chol", "kernel"), ("chol", "row"), ("chol", "col"),
    ("sweep", ""), ("sweep_full", "")])
def test_fit_inverse_matches_jax_under_the_same_flag(monkeypatch, method,
                                                      assembly):
    monkeypatch.setattr(jci, "FIT_INVERSE", method)
    if assembly:
        monkeypatch.setattr(jpc, "LINV_ASSEMBLY", assembly)
    K = _spd(2, 40, 11)
    Kinv, ld = cholinv.batched_kinv_logdet_fit(
        torch.tensor(K), method=method, assembly=assembly or "kernel")
    jKinv, jld = jci.batched_kinv_logdet_fit(jnp.asarray(K), interpret=True)
    # f32, well-conditioned: the same algorithm to roundoff, Cholesky by
    # LAPACK against the TPU kernel's blocked Cholesky
    np.testing.assert_allclose(Kinv.numpy(), np.asarray(jKinv), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jKinv)).max())
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=1e-5,
                               atol=1e-4)


def test_xla_fit_inverse_is_not_ported():
    K = torch.tensor(_spd(1, 4, 0))
    with pytest.raises(ValueError, match="not ported"):
        cholinv.batched_kinv_logdet_fit(K, method="xla")
    gp = make_mvgp_rank1(3, 2, fit_inverse="xla")
    rng = np.random.default_rng(0)
    data = MVGPData(*(torch.tensor(a) for a in (
        rng.normal(size=(1, 5, 3)), rng.normal(size=(1, 5, 3)),
        rng.normal(size=(1, 5, 3)), np.ones((1, 5)))))
    params = gp.init_params(1, torch.Generator().manual_seed(0), "cpu",
                            torch.float64)
    with pytest.raises(ValueError, match="not ported"):
        gp.mll(params, data)
    with pytest.raises(ValueError, match="not ported"):
        interop.mvgp_from_jax(jmv.make_mvgp_rank1(3, 2), fit_inverse="xla")
    with pytest.raises(ValueError):
        cholinv.chol_inv_fwd(K, assembly="diag")


def test_mvgp_from_jax_carries_the_globals():
    gp = interop.mvgp_from_jax(jmv.make_mvgp_rank1(3, 2, use_pallas=True),
                               fit_inverse="chol", fit_chol_assembly="col",
                               linv_assembly="row", fused_fit=False)
    assert (gp.fit_inverse, gp.fit_assembly, gp.linv_assembly,
            gp.fused_gram, gp.fused_fit) == ("chol", "col", "row", True,
                                             False)
    assert gp.gamma_prior == (1e-3, 1e-3) and gp.rank_A == 1
    assert make_mvgp_rank1(3, 2).fit_assembly == "kernel"


# ---- the MLL on the gram_kb + solve_and_logdet branch -----------------------

def _mll_case(seed, B=2, k=12):
    rng = np.random.default_rng(seed)
    X = np.cumsum(0.1 * rng.normal(size=(B, k, 3)), 1)
    UH = np.concatenate([np.ones((B, k, 1)), rng.normal(size=(B, k, 2))], -1)
    mask = np.ones((B, k))
    mask[:, -3:] = 0.0
    data = dict(X=X, UH=UH, Xdot=rng.normal(size=(B, k, 3)), mask=mask)
    params = dict(raw_lengthscale=0.5 + 0.2 * rng.normal(size=(B, 3)),
                  raw_outputscale=0.3 + 0.1 * rng.normal(size=B),
                  W_A=0.3 * rng.normal(size=(B, 3, 1)),
                  raw_vA=0.5 + 0.1 * rng.normal(size=(B, 3)),
                  W_B=0.3 * rng.normal(size=(B, 3, 1)),
                  raw_vB=0.5 + 0.1 * rng.normal(size=(B, 3)),
                  mean_M=0.1 * rng.normal(size=(B, 3, 3)))
    return data, params


@pytest.mark.parametrize("method", ["cholk", "chol", "sweep_full"])
def test_unfused_mll_and_gradient_match_jax(monkeypatch, method):
    """f64.  The JAX side runs its own unfused branch (FUSED_FIT False);
    on the CPU its unbatched inverse is the Cholesky reference, so each
    of the port's methods must give the same MLL: 1e-10 relative for the
    value, 1e-8 for the gradient (a well-conditioned Gram)."""
    monkeypatch.setattr(jmv, "FUSED_FIT", False)
    data_np, params_np = _mll_case(0)
    jgp = jmv.make_mvgp_rank1(3, 2)
    gp = interop.mvgp_from_jax(jgp, fit_inverse=method, fused_fit=False)
    params = interop.mvgp_params_from_numpy(params_np, "cpu", torch.float64)
    leaves = [p.clone().requires_grad_(True) for p in params]
    data = MVGPData(*(torch.tensor(data_np[f]) for f in MVGPData._fields))
    ll = gp.mll(type(params)(*leaves), data)
    grads = torch.autograd.grad(ll.sum(), leaves)
    for b in range(2):
        jp = JParams(**{k: jnp.asarray(v[b]) for k, v in params_np.items()})
        jd = JData(**{k: jnp.asarray(v[b]) for k, v in data_np.items()})
        jll, jg = jax.value_and_grad(lambda p: jgp.mll(p, jd))(jp)
        np.testing.assert_allclose(float(ll[b].detach()), float(jll),
                                   rtol=1e-10)
        for f, g in zip(JParams._fields, grads):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(getattr(jg, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)


# ---- f32 fits on trajectory data --------------------------------------------

@pytest.mark.parametrize("fit_inverse,linv_assembly", [
    ("chol", "row"), ("sweep_full", "kernel")])
def test_f32_fit_moves_hyperparameters(fit_inverse, linv_assembly):
    """tests/test_fit_inverse.py::test_fused_f32_fit_moves_hyperparameters_
    on_trajectory_data under the alternative fit inverses: a B = 2 f32 fit
    of 8 Adam iterations on a trajectory buffer must train (a NaN guard
    rejecting every step would leave the parameters at their start)."""
    k, xd, m, B = 64, 3, 2, 2
    rng = np.random.default_rng(0)
    X = np.cumsum(0.02 * rng.normal(size=(k, xd)), 0)
    UH = np.concatenate([np.ones((k, 1)), rng.normal(size=(k, m))], 1)
    Xdot = np.cumsum(0.1 * rng.normal(size=(k, xd)), 0)
    rep = lambda a: torch.tensor(np.broadcast_to(a, (B,) + a.shape).copy(),
                                 dtype=torch.float32)
    data = MVGPData(X=rep(X), UH=rep(UH), Xdot=rep(Xdot),
                    mask=torch.ones((B, k)))
    gp = make_mvgp_rank1(xd, m, fit_inverse=fit_inverse,
                         linv_assembly=linv_assembly)
    params = gp.init_params(B, torch.Generator().manual_seed(0), "cpu",
                            torch.float32)
    out = gp.fit(params, data, training_iter=8)
    assert bool(torch.isfinite(gp.mll(out, data)).all())
    moved = (out.lengthscale - params.lengthscale).abs().amax(-1)
    assert bool((moved > 1e-4).all()), "fit never moved a hyperparameter"
    cache = gp.refresh_cache(out, data)
    assert all(bool(torch.isfinite(a).all()) for a in cache)


# ---- dispatch ---------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    K = torch.tensor(_spd(2, 20, 3))
    with tracing.recording():
        for got, want in ((sk.batched_kinv_logdet(K),
                           sk.batched_kinv_logdet_plain(K)),
                          (ck.chol_dinv(K, 8), ck.chol_dinv_plain(K, 8))):
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    counted = tracing.report()["counters"]
    assert "launches.batched_kinv_logdet" not in counted
    assert "launches.chol_dinv" not in counted
    meta = torch.empty((2, 4, 4), device="meta")
    with pytest.raises(ValueError):
        sk.batched_kinv_logdet(meta)
    with pytest.raises(ValueError):
        ck.chol_dinv(meta)
