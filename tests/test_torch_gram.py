"""The fused masked Gram of the PyTorch port (ops/gram.py) against the JAX
package: its plain version against `fused_gram_kb_reference` (f64) and
against the Pallas kernel in interpret mode (f32), the near-duplicate
accuracy pin, and `MVGP.masked_kb` / `refresh_cache` with `fused_gram`
against the JAX model with `use_pallas=True`.  The CUDA kernel itself is
tested on the card by tests/test_torch_cuda.py and chip_smoke.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_cbf_tpu.ops.gram as jgram
from bayesian_cbf_tpu.models.mvgp import (MVGPData as JData,
                                          MVGPParams as JParams,
                                          make_mvgp_rank1 as j_rank1)
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.models.mvgp import MVGPData
from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.ops import cholinv
from bayesian_cbf_tpu_torch.ops import gram as gm
from test_torch_cuda import near_duplicate_case

B, K, N, MH = 2, 12, 3, 3


def _inputs(seed, B=3, k=20, n=3, mh=3):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(B, k)) > 0.4).astype(float)
    return (rng.normal(size=(B, k, n)), rng.normal(size=(B, k, mh)), mask,
            rng.uniform(0.5, 2.0, size=B))


def test_plain_matches_jax_reference_f64():
    Xs, U, m, s = _inputs(0)
    got = gm.fused_gram_kb_plain(*(torch.tensor(a) for a in (Xs, U, m, s)),
                                 1e-6).numpy()
    for b in range(3):
        want = jgram.fused_gram_kb_reference(
            *(jnp.asarray(a[b]) for a in (Xs, U, m, s)), 1e-6)
        # f64, the same expression: roundoff
        np.testing.assert_allclose(got[b], np.asarray(want), rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("k,n,mh", [(20, 3, 3), (9, 16, 16)])
def test_plain_matches_pallas_interpret_f32(k, n, mh):
    Xs, U, m, s = (a.astype(np.float32) for a in _inputs(k, k=k, n=n, mh=mh))
    got = gm.fused_gram_kb_plain(*(torch.tensor(a) for a in (Xs, U, m, s)),
                                 1e-6).numpy()
    for b in range(3):
        want = jgram.fused_gram_kb(*(jnp.asarray(a[b]) for a in (Xs, U, m)),
                                   float(s[b]), 1e-6, interpret=True)
        # f32: one exp and n + 1+m products per entry, summed in another
        # order (the TPU kernel's matmul vs the plain version's)
        np.testing.assert_allclose(got[b], np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_plain_exact_on_near_duplicate_points():
    """tests/test_ops.py's pin for the fused Gram, on the plain version and
    the Pallas kernel alike (the dot-product form fails it in f32)."""
    *args, truth = near_duplicate_case(B=2)
    f32 = [a.astype(np.float32) for a in args]
    got = gm.fused_gram_kb_plain(*(torch.tensor(a) for a in f32), 1e-6)
    np.testing.assert_allclose(got.double().numpy(), truth, atol=2e-5,
                               rtol=2e-5)
    for b in range(2):
        want = jgram.fused_gram_kb(*(jnp.asarray(a[b]) for a in f32[:3]),
                                   float(f32[3][b]), 1e-6, interpret=True)
        np.testing.assert_allclose(np.asarray(want, np.float64), truth[b],
                                   atol=2e-5, rtol=2e-5)


def _case(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, K, N))
    UH = np.concatenate([np.ones((B, K, 1)), rng.normal(size=(B, K, 2))], -1)
    mask = np.ones((B, K))
    mask[:, -3:] = 0.0
    data = dict(X=X, UH=UH, Xdot=rng.normal(size=(B, K, N)), mask=mask)
    params = dict(raw_lengthscale=0.5 + 0.2 * rng.normal(size=(B, N)),
                  raw_outputscale=0.3 + 0.1 * rng.normal(size=B),
                  W_A=0.3 * rng.normal(size=(B, N, 1)),
                  raw_vA=0.5 + 0.1 * rng.normal(size=(B, N)),
                  W_B=0.3 * rng.normal(size=(B, MH, 1)),
                  raw_vB=0.5 + 0.1 * rng.normal(size=(B, MH)),
                  mean_M=0.1 * rng.normal(size=(B, MH, N)))
    return ({k: v.astype(np.float32) for k, v in data.items()},
            {k: v.astype(np.float32) for k, v in params.items()})


@pytest.fixture
def jax_fused_gram_interpret(monkeypatch):
    """The JAX `masked_kb` calls the Pallas kernel without `interpret`,
    which has no CPU lowering: run it in interpret mode instead."""
    monkeypatch.setattr(jgram, "fused_gram_kb", functools.partial(
        jgram.fused_gram_kb, interpret=True))


def _both(seed):
    data_np, params_np = _case(seed)
    jgp = j_rank1(3, 2, use_pallas=True)
    gp = interop.mvgp_from_jax(jgp)
    assert gp.fused_gram
    params = interop.mvgp_params_from_numpy(params_np, "cpu", torch.float32)
    data = MVGPData(*(torch.tensor(data_np[f]) for f in MVGPData._fields))
    jaxs = [(JParams(**{k: jnp.asarray(v[b]) for k, v in params_np.items()}),
             JData(**{k: jnp.asarray(v[b]) for k, v in data_np.items()}))
            for b in range(B)]
    return jgp, gp, params, data, jaxs


def test_masked_kb_fused_matches_jax_use_pallas(jax_fused_gram_interpret):
    jgp, gp, params, data, jaxs = _both(0)
    got = gp.masked_kb(params, data).numpy()
    for b, (jp, jd) in enumerate(jaxs):
        # f32, the same expression on both sides (UH chol(B) by the same
        # unrolled ladder): a few ulps of entries of size ~1
        np.testing.assert_allclose(got[b], np.asarray(jgp.masked_kb(jp, jd)),
                                   rtol=1e-5, atol=1e-5)


def test_refresh_cache_fused_matches_jax_use_pallas(jax_fused_gram_interpret):
    jgp, gp, params, data, jaxs = _both(1)
    cache = gp.refresh_cache(params, data)
    for b, (jp, jd) in enumerate(jaxs):
        jc = jgp.refresh_cache(jp, jd)
        for f in ("L", "alpha", "Linv"):
            want = np.asarray(getattr(jc, f))
            # f32 Cholesky of a Gram with kappa ~1e2 by LAPACK on both
            # sides (torch and XLA): relative 1e-4 of the largest entry
            np.testing.assert_allclose(getattr(cache, f)[b].numpy(), want,
                                       rtol=0, atol=1e-4 * np.abs(want).max(),
                                       err_msg=f)


def test_refresh_cache_fused_takes_the_bump_rung_like_jax(
        jax_fused_gram_interpret):
    """JAX behaviour kept, not repaired: the fused Gram carries only the
    1e-6 jitter (no dtype-aware nugget), so on a trajectory buffer (one
    varying coordinate, consecutive states 0.02 apart) its f32 Gram is
    indefinite and both packages reject the first rung of the refresh
    ladder and factor K + 1e-5 scale I in every episode."""
    rng = np.random.default_rng(0)
    k = 64
    X = np.zeros((B, k, N))
    X[..., 2] = np.cumsum(0.02 * rng.normal(size=(B, k)), 1)
    data_np = dict(X=X, UH=np.concatenate(
        [np.ones((B, k, 1)), rng.normal(size=(B, k, 2))], -1),
        Xdot=rng.normal(size=(B, k, N)), mask=np.ones((B, k)))
    params_np = dict(raw_lengthscale=np.ones((B, N)),
                     raw_outputscale=np.ones(B),
                     W_A=0.3 * rng.normal(size=(B, N, 1)),
                     raw_vA=np.full((B, N), 0.5),
                     W_B=0.3 * rng.normal(size=(B, MH, 1)),
                     raw_vB=np.full((B, MH), 0.5),
                     mean_M=0.1 * rng.normal(size=(B, MH, N)))
    data_np = {f: v.astype(np.float32) for f, v in data_np.items()}
    params_np = {f: v.astype(np.float32) for f, v in params_np.items()}
    jgp = j_rank1(3, 2, use_pallas=True)
    gp = interop.mvgp_from_jax(jgp)
    params = interop.mvgp_params_from_numpy(params_np, "cpu", torch.float32)
    data = MVGPData(*(torch.tensor(data_np[f]) for f in MVGPData._fields))
    Kf = gp.masked_kb(params, data)
    L1, _ = cholinv.chol_inv_fwd(Kf)
    assert not bool(torch.isfinite(L1).any())
    scale = torch.clamp(torch.diagonal(Kf, dim1=-2, dim2=-1).abs().mean(-1),
                        min=1.0)
    bumped = torch.sqrt(Kf[:, 0, 0] + 1e-5 * scale)
    cache = gp.refresh_cache(params, data)
    for b in range(B):
        jc = jgp.refresh_cache(
            JParams(**{f: jnp.asarray(v[b]) for f, v in params_np.items()}),
            JData(**{f: jnp.asarray(v[b]) for f, v in data_np.items()}))
        jL = np.asarray(jc.L)
        # the bump moves L[0, 0] by ~1e-5, a hundred f32 ulps: both sides
        # sit on the bumped value
        gap = float(bumped[b] - torch.sqrt(Kf[b, 0, 0]))
        assert abs(float(jL[0, 0]) - float(bumped[b])) < 0.1 * gap
        assert abs(float(cache.L[b, 0, 0]) - float(bumped[b])) < 0.1 * gap
        # f32 Cholesky of K + 1e-5 scale I (kappa ~1e6) by LAPACK on both
        # sides: relative 1e-3 of the largest entry
        np.testing.assert_allclose(cache.L[b].numpy(), jL, rtol=0,
                                   atol=1e-3 * np.abs(jL).max())


@pytest.mark.parametrize("B", [1, 7, 256, 1000])
@pytest.mark.parametrize("K", [1, 33, 200, 201, 1024])
def test_gram_plan_covers_every_row_once(B, K):
    """The kernel's cut into items: block g of `grid` walks the items
    [g N / grid, (g + 1) N / grid) of N = B ceil(K / R) (csrc/gram.cu
    `first_item`), item it the rows [(it % bands) R, + R) of matrix
    it / bands.  Every row of every matrix in exactly one item of exactly
    one block, no more blocks than the SMs hold, every block with an
    item.  Also with row groups of one warp (csrc/fit_gram.cu)."""
    for P, sms, per_sm, group in ((2, 132, 2, 0), (1, 132, 1, 0),
                                  (2, 5, 3, 0), (1, 132, 4, 32)):
        R, G, grid = gm.gram_plan(B, K, P, sms, per_sm, group=group)
        assert 1 <= R <= K and 1 <= grid <= sms * per_sm
        if group:
            assert G == gm.THREADS // group
            assert R == min(K, G * gm.ROWS_PER_THREAD)
        else:
            assert G * -(-gm.row_chunks(K) // P) <= gm.THREADS or G == 1
        if K % 4 and G >= 4 and not group:
            assert G % 4 == 0
        bands = -(-K // R)
        assert (bands - 1) * R < K <= bands * R
        first = [g * B * bands // grid for g in range(grid + 1)]
        assert first[0] == 0 and first[-1] == B * bands
        assert all(a < b for a, b in zip(first, first[1:]))


def test_ptxas_usage_names_bool_template_arguments():
    from bayesian_cbf_tpu_torch.ops import _build
    report = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111gram_"
        "kernelILi4ELb1EEEvNS_8GramArgsE' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, 380 bytes cmem[0]\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111gram_"
        "kernelILi16ELb0EEEvNS_8GramArgsE' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, 380 bytes cmem[0]\n")
    assert _build.parse_ptxas_usage(report) == [
        dict(kernel="gram_kernel<4, 1>", registers=40, stack_bytes=0,
             spill_store_bytes=0, spill_load_bytes=0),
        dict(kernel="gram_kernel<16, 0>", registers=168, stack_bytes=8,
             spill_store_bytes=4, spill_load_bytes=4)]


def test_cpu_tensors_take_the_plain_version():
    args = [torch.tensor(a, dtype=torch.float32) for a in _inputs(3)]
    with tracing.recording():
        assert torch.equal(gm.fused_gram_kb(*args, 1e-6),
                           gm.fused_gram_kb_plain(*args, 1e-6))
    assert "launches.fused_gram_kb" not in tracing.report()["counters"]
    with pytest.raises(ValueError):
        gm.fused_gram_kb(*(a.to("meta") for a in args), 1e-6)
