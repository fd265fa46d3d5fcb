"""Backward passes of the port's differentiable ops (`chol_with_inv`,
`solve_and_logdet`, `gram_solve_logdet`) against `jax.vjp` of the JAX
package's custom-VJP ops, on the same f64 inputs and cotangents."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from bayesian_cbf_tpu.ops import cholinv as jci
from bayesian_cbf_tpu.ops import gramsolve as jgs
from bayesian_cbf_tpu_torch.ops import cholinv, gramsolve

# f64, identical algebra: roundoff-level agreement
RTOL, ATOL = 1e-9, 1e-11


def _spd(rng, B, n):
    A = rng.normal(size=(B, n, n))
    return A @ A.transpose(0, 2, 1) / n + np.eye(n)


def _vjp_torch(fn, inputs, cts):
    leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
    outs = fn(*leaves)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cts])
    return [a.grad.numpy() for a in leaves], [o.detach().numpy() for o in outs]


def test_chol_with_inv_backward_matches_jax():
    rng = np.random.default_rng(0)
    B, n = 3, 7
    K = _spd(rng, B, n)
    dL = np.tril(rng.normal(size=(B, n, n)))
    dLinv = np.tril(rng.normal(size=(B, n, n)))
    (gK,), outs = _vjp_torch(cholinv.chol_with_inv, [K], [dL, dLinv])
    for b in range(B):
        jout, vjp = jax.vjp(jci.chol_with_inv, jnp.asarray(K[b]))
        (jgK,) = vjp((jnp.asarray(dL[b]), jnp.asarray(dLinv[b])))
        np.testing.assert_allclose(outs[1][b], np.asarray(jout[1]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gK[b], np.asarray(jgK), rtol=RTOL,
                                   atol=ATOL)


def test_solve_and_logdet_backward_matches_jax():
    rng = np.random.default_rng(1)
    B, k, n = 2, 9, 3
    K = _spd(rng, B, k)
    Y = rng.normal(size=(B, k, n))
    dS = rng.normal(size=(B, k, n))
    dld = rng.normal(size=(B,))
    (gK, gY), _ = _vjp_torch(cholinv.solve_and_logdet, [K, Y], [dS, dld])
    for b in range(B):
        _, vjp = jax.vjp(jci.solve_and_logdet, jnp.asarray(K[b]),
                         jnp.asarray(Y[b]))
        jgK, jgY = vjp((jnp.asarray(dS[b]), jnp.asarray(dld[b])))
        np.testing.assert_allclose(gK[b], np.asarray(jgK), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(gY[b], np.asarray(jgY), rtol=RTOL,
                                   atol=ATOL)


def test_gram_solve_logdet_backward_matches_jax():
    rng = np.random.default_rng(2)
    B, k, xd, mh, n = 2, 10, 3, 3, 3
    X = np.cumsum(0.2 * rng.normal(size=(B, k, xd)), 1)
    UH = np.concatenate([np.ones((B, k, 1)),
                         rng.normal(size=(B, k, mh - 1))], -1)
    sB = np.eye(mh) + 0.1 * rng.normal(size=(mh, mh))
    sB = sB @ sB.T
    UB = UH @ sB
    inv_ell = 1.0 + 0.2 * rng.normal(size=(B, xd))
    nug = np.full((B,), 1e-3)
    mask = np.ones((B, k))
    mask[:, -2:] = 0.0
    Y = rng.normal(size=(B, k, n)) * mask[..., None]
    dS = rng.normal(size=(B, k, n))
    dld = rng.normal(size=(B,))
    ins = [X, UB, UH, inv_ell, nug, mask, Y]
    grads, outs = _vjp_torch(gramsolve.gram_solve_logdet, ins, [dS, dld])
    for b in range(B):
        jout, vjp = jax.vjp(jgs.gram_solve_logdet,
                            *(jnp.asarray(a[b]) for a in ins))
        jgrads = vjp((jnp.asarray(dS[b]), jnp.asarray(dld[b])))
        np.testing.assert_allclose(outs[0][b], np.asarray(jout[0]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(outs[1][b], np.asarray(jout[1]),
                                   rtol=RTOL, atol=ATOL)
        for name, g, jg in zip(("X", "UB", "UH", "inv_ell", "nug", "mask",
                                "Y"), grads, jgrads):
            np.testing.assert_allclose(g[b], np.asarray(jg), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


def test_km_expr_matches_jax():
    rng = np.random.default_rng(3)
    B, k = 2, 8
    X = rng.normal(size=(B, k, 3))
    UH = rng.normal(size=(B, k, 3))
    UB = UH @ np.diag([1.0, 2.0, 0.5])
    inv_ell = rng.uniform(0.5, 2.0, size=(B, 3))
    nug = np.array([1e-4, 1e-2])
    mask = (rng.uniform(size=(B, k)) > 0.3).astype(np.float64)
    got = gramsolve.km_expr(*(torch.tensor(a) for a in
                              (X, UB, UH, inv_ell, nug, mask)))
    for b in range(B):
        want = jgs.km_expr(*(jnp.asarray(a[b]) for a in
                             (X, UB, UH, inv_ell, nug, mask)))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-13, atol=1e-15)
