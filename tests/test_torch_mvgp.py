"""MVGP parity of the PyTorch port against the JAX package on CPU, f64:
the MLL value and gradient, a 10-iteration Adam fit (schedule boundaries
included), the refreshed posterior cache and the posterior moments; plus
an f32 fit on trajectory data that must move the hyperparameters.
Inputs are made with numpy from a seed; the two sides exchange numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.models.mvgp import (MVGPData as JData,
                                          MVGPParams as JParams,
                                          make_mvgp_rank1 as j_rank1)
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.models.mvgp import MVGPData, make_mvgp_rank1
from bayesian_cbf_tpu_torch.observability import tracing

B, K, N, MH = 2, 12, 3, 3
F64 = torch.float64


def _episode(rng, K=K, step=0.1):
    X = np.cumsum(step * rng.normal(size=(K, N)), 0)
    U = rng.normal(size=(K, MH - 1))
    UH = np.concatenate([np.ones((K, 1)), U], 1)
    Xdot = rng.normal(size=(K, N))
    mask = np.ones(K)
    mask[-3:] = 0.0
    return dict(X=X, UH=UH, Xdot=Xdot, mask=mask)


def _params(rng):
    return dict(raw_lengthscale=0.5 + 0.2 * rng.normal(size=N),
                raw_outputscale=np.asarray(0.3 + 0.1 * rng.normal()),
                W_A=0.3 * rng.normal(size=(N, 1)),
                raw_vA=0.5 + 0.1 * rng.normal(size=N),
                W_B=0.3 * rng.normal(size=(MH, 1)),
                raw_vB=0.5 + 0.1 * rng.normal(size=MH),
                mean_M=0.1 * rng.normal(size=(MH, N)))


def _case(seed=0):
    rng = np.random.default_rng(seed)
    eps = [_episode(rng) for _ in range(B)]
    ps = [_params(rng) for _ in range(B)]
    stack = lambda ds: {k: np.stack([d[k] for d in ds]) for k in ds[0]}
    return eps, ps, stack(eps), stack(ps)


def _jax(d, cls):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch_data(d, dtype=F64):
    return MVGPData(*(torch.tensor(d[f], dtype=dtype) for f in MVGPData._fields))


def test_mll_value_and_gradient_match_jax():
    eps, ps, data_np, params_np = _case(0)
    jgp = j_rank1(3, 2)
    gp = make_mvgp_rank1(3, 2)
    params = interop.mvgp_params_from_numpy(params_np, "cpu", F64)
    leaves = [p.clone().requires_grad_(True) for p in params]
    ll = gp.mll(type(params)(*leaves), _torch_data(data_np))
    grads = torch.autograd.grad(ll.sum(), leaves)
    for b in range(B):
        jp, jd = _jax(ps[b], JParams), _jax(eps[b], JData)
        jll, jg = jax.value_and_grad(lambda p: jgp.mll(p, jd))(jp)
        # f64, same algebra: agreement to roundoff
        np.testing.assert_allclose(float(ll[b].detach()), float(jll),
                                   rtol=1e-10)
        for f, g in zip(JParams._fields, grads):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(getattr(jg, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)


@pytest.mark.parametrize("iters", [10, 4])
def test_fit_matches_optax_adam(iters):
    """10 iterations cross the 30/60/80/90% boundaries at 3, 6, 8, 9;
    4 iterations merge them into {1: 0.1, 2: 0.1, 3: 0.1}."""
    eps, ps, data_np, params_np = _case(1)
    jgp = j_rank1(3, 2)
    gp = make_mvgp_rank1(3, 2)
    params = interop.mvgp_params_from_numpy(params_np, "cpu", F64)
    got = interop.mvgp_params_to_numpy(
        gp.fit(params, _torch_data(data_np), training_iter=iters))
    for b in range(B):
        want = jgp.fit(_jax(ps[b], JParams), _jax(eps[b], JData),
                       training_iter=iters)
        for f in JParams._fields:
            # f64 Adam on identical gradients: roundoff-level agreement
            np.testing.assert_allclose(got[f][b], np.asarray(getattr(want, f)),
                                       rtol=1e-8, atol=1e-10, err_msg=f)


def test_fit_rejects_nonfinite_episode_only():
    """An episode whose MLL is not finite keeps its parameters; the other
    episode of the batch still trains."""
    eps, ps, data_np, params_np = _case(2)
    data_np = {k: v.copy() for k, v in data_np.items()}
    data_np["Xdot"][1, 0, 0] = np.nan
    gp = make_mvgp_rank1(3, 2)
    params = interop.mvgp_params_from_numpy(params_np, "cpu", F64)
    new = gp.fit(params, _torch_data(data_np), training_iter=3)
    assert torch.equal(new.W_A[1], params.W_A[1])
    assert not torch.equal(new.W_A[0], params.W_A[0])


def test_refresh_cache_and_moments_match_jax():
    eps, ps, data_np, params_np = _case(3)
    jgp = j_rank1(3, 2)
    gp = make_mvgp_rank1(3, 2)
    params = interop.mvgp_params_from_numpy(params_np, "cpu", F64)
    data = _torch_data(data_np)
    cache = gp.refresh_cache(params, data)
    x = torch.tensor(np.random.default_rng(4).normal(size=(B, N)))
    FT = gp.fT_post(params, data, cache, x)
    Bk = gp.Bk_single(params, data, cache, x, x)
    for b in range(B):
        jp, jd = _jax(ps[b], JParams), _jax(eps[b], JData)
        jc = jgp.refresh_cache(jp, jd)
        for f in ("L", "alpha", "Linv"):
            np.testing.assert_allclose(getattr(cache, f)[b].numpy(),
                                       np.asarray(getattr(jc, f)),
                                       rtol=1e-9, atol=1e-11, err_msg=f)
        xb = jnp.asarray(x[b].numpy())
        np.testing.assert_allclose(FT[b].numpy(),
                                   np.asarray(jgp.fT_post(jp, jd, jc, xb)),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(Bk[b].numpy(),
                                   np.asarray(jgp.Bk_single(jp, jd, jc, xb, xb)),
                                   rtol=1e-9, atol=1e-11)


def test_refresh_ladder_rejects_garbage_factor():
    """A duplicate-row Gram makes the unbumped factor fail; the ladder
    must land on a bumped rung with a sane inverse, per episode."""
    eps, ps, data_np, params_np = _case(5)
    data_np = {k: v.copy() for k, v in data_np.items()}
    data_np["X"][0, 1] = data_np["X"][0, 0]
    data_np["UH"][0, 1] = data_np["UH"][0, 0]
    gp = make_mvgp_rank1(3, 2, jitter=-1e-3)   # force an indefinite Gram
    params = interop.mvgp_params_from_numpy(params_np, "cpu", F64)
    cache = gp.refresh_cache(params, _torch_data(data_np))
    assert torch.isfinite(cache.Linv).all()
    assert float(cache.Linv.abs().max()) < 1e12


def _ladder_batch(k=6):
    """Three Grams, one for each rung: SPD; singular (all ones: + 1e-5
    factors); one eigenvalue at -1e-3 (only + 1e-2 factors)."""
    eye, ones = torch.eye(k, dtype=F64), torch.ones((k, k), dtype=F64)
    return torch.stack([2.0 * eye + 0.1 * ones, ones, ones - 1e-3 * eye])


@pytest.mark.parametrize("assembly", ["kernel", "row"])
def test_factor_ladder_reports_the_rung_each_episode_accepted(assembly):
    gp = make_mvgp_rank1(3, 2, linv_assembly=assembly)
    K = _ladder_batch()
    L, Linv, rungs = gp.factor_ladder(torch.cat([K, K[:1]]))
    assert rungs.tolist() == [2, 1, 1]
    assert torch.isfinite(L).all() and torch.isfinite(Linv).all()
    eye = torch.eye(K.shape[-1], dtype=F64)
    bumps = torch.tensor([0.0, 1e-5, 1e-5 + 1e-2, 0.0], dtype=F64)
    want = torch.cat([K, K[:1]]) + bumps[:, None, None] * eye
    assert torch.allclose(L @ L.transpose(-1, -2), want, atol=1e-12)
    assert torch.allclose(Linv @ L, eye.expand_as(L), atol=1e-6)


def test_refresh_cache_adds_its_rungs_to_the_count():
    eps, ps, data_np, params_np = _case(5)
    params = interop.mvgp_params_from_numpy(params_np, "cpu", F64)
    data = _torch_data(data_np)
    rungs = lambda: [tracing.report()["counters"].get(f"refresh.rung{i}", 0)
                     for i in range(3)]
    with tracing.recording():
        make_mvgp_rank1(3, 2).refresh_cache(params, data)
        assert rungs() == [B, 0, 0]
        data_np = {k: v.copy() for k, v in data_np.items()}
        data_np["X"][0, 1] = data_np["X"][0, 0]
        data_np["UH"][0, 1] = data_np["UH"][0, 0]
        make_mvgp_rank1(3, 2, jitter=-1e-3).refresh_cache(
            params, _torch_data(data_np))
    seen = rungs()
    assert sum(seen) == 2 * B and seen[0] < 2 * B
    # no recording open: nothing is counted
    make_mvgp_rank1(3, 2).refresh_cache(params, data)
    assert rungs() == seen


def test_f32_fit_moves_hyperparameters_on_trajectory_data():
    """The f32 fit on a real-looking trajectory buffer (consecutive states
    dt apart: a near-singular Gram) must move the hyperparameters; a NaN
    guard that silently rejects every step would leave them unchanged."""
    rng = np.random.default_rng(6)
    k = 40
    X = np.cumsum(0.01 * rng.normal(size=(B, k, N)), 1)
    UH = np.concatenate([np.ones((B, k, 1)), rng.normal(size=(B, k, 2))], -1)
    data_np = dict(X=X, UH=UH, Xdot=np.sin(X) + UH[..., 1:2],
                   mask=np.ones((B, k)))
    gp = make_mvgp_rank1(3, 2)
    params = interop.mvgp_params_from_numpy(
        {f: np.stack([p[f] for p in _case(7)[1]]) for f in JParams._fields},
        "cpu", torch.float32)
    new = gp.fit(params, _torch_data(data_np, torch.float32),
                 training_iter=20)
    moved = (new.raw_lengthscale - params.raw_lengthscale).abs().amax(-1)
    assert bool((moved > 1e-2).all()), moved
    assert all(bool(torch.isfinite(a).all()) for a in new)
