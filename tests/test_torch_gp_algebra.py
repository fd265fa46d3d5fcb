"""The port's GP expression algebra (`bayesian_cbf_tpu_torch/gp/algebra.py`)
and its term extraction (`utils/func`) on the CPU, f64:

- the seven analytic and Monte-Carlo oracles of tests/test_gp_algebra.py,
  run against the port's nodes (the same numbers and bars);
- each node's mean, knl and covar against the JAX node's, built from the
  same closures (written once for each library) on the same seeded
  inputs, at 1e-10 relative to each output's magnitude: the two compute
  the same expressions, autodiff included, so they differ by roundoff;
- the eigenvalue clamp of `GradientGP.knl` at a repeated eigenvalue:
  finite Hessians in u of a clamped kernel that does not depend on u, and
  the NaN that JAX gives where the clamped kernel depends on u, pinned;
- `GP.sample` with an explicit generator, `affine_terms` and
  `quadratic_terms`.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.gp import algebra as ja
from bayesian_cbf_tpu.utils import func as jfunc
from bayesian_cbf_tpu_torch.control import pendulum_safety as tps
from bayesian_cbf_tpu_torch.gp import algebra as ta
from bayesian_cbf_tpu_torch.models import dynamics as td
from bayesian_cbf_tpu_torch.safety import cbc as tcbc
from bayesian_cbf_tpu_torch.utils import func as tfunc

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol=1e-10):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


# ---- the oracles of tests/test_gp_algebra.py -------------------------------

def _rbf_scalar_gp(ell=0.8, s=1.3, dim=2):
    """Scalar GP with mean m(x) = 1/2 x^T Q x and an RBF kernel."""
    Q = torch.eye(dim, dtype=F64) * 0.7
    mean = lambda x: 0.5 * x @ Q @ x
    knl = lambda x, xp: s * torch.exp(-0.5 * torch.sum((x - xp) ** 2)
                                      / ell ** 2)
    return ta.LeafGP(mean=mean, knl=knl, dim=1, name="simple"), Q, ell, s


def test_gradient_gp_mean_and_hessian():
    """Mean Q x; kernel s/l^2 e^{-r/2} (I - d d^T / l^2); s/l^2 I at x = x'
    (through the clamp)."""
    gp, Q, ell, s = _rbf_scalar_gp()
    ggp = ta.GradientGP(gp, x_dim=2)
    x = _t([0.3, -0.5])
    xp = _t([0.9, 0.1])
    np.testing.assert_allclose(ggp.mean(x).numpy(), (Q @ x).numpy(),
                               atol=1e-10)
    d = ((x - xp) / ell).numpy()
    expected = (s / ell ** 2) * math.exp(-0.5 * float(d @ d)) * (
        np.eye(2) - np.outer(d, d))
    np.testing.assert_allclose(ggp.knl(x, xp).numpy(), expected, atol=1e-10)
    np.testing.assert_allclose(ggp.knl(x, x).numpy(),
                               (s / ell ** 2) * np.eye(2), atol=1e-10)


def test_det_dot_gp():
    """h^T f for deterministic h: exact mean and kernel."""
    n = 3
    A = _t([[1.0, 0.2, 0.0], [0.0, 0.8, 0.1], [0.3, 0.0, 1.2]])
    f = ta.LeafGP(lambda x: A @ x,
                  lambda x, xp: (x @ xp + 1.0) * torch.eye(n, dtype=F64),
                  dim=n)
    h = ta.DeterministicGP(torch.sin, dim=n)
    expr = h.t() @ f
    x = _t([0.1, -0.7, 0.4])
    np.testing.assert_allclose(float(expr.mean(x)),
                               float(torch.sin(x) @ (A @ x)), atol=1e-12)
    want = float(torch.sin(x) @ ((x @ x + 1.0) * torch.eye(n, dtype=F64))
                 @ torch.sin(x))
    np.testing.assert_allclose(float(expr.knl(x, x).reshape(())), want,
                               atol=1e-12)


def test_add_with_registered_covar():
    """Var(X + Y) = Kx + Ky + Cxy + Cxy^T with the covariance registered."""
    Kx = _t([[1.0, 0.1], [0.1, 2.0]])
    Ky = _t([[0.5, 0.0], [0.0, 0.5]])
    Cxy = _t([[0.2, 0.0], [0.0, -0.1]])
    X = ta.LeafGP(lambda x: x, lambda x, xp: Kx, dim=2, name="X")
    Y = ta.LeafGP(lambda x: 2 * x, lambda x, xp: Ky, dim=2, name="Y")
    X.register_covar(Y, lambda x, xp: Cxy)
    x = _t([1.0, 2.0])
    np.testing.assert_allclose((X + Y).knl(x, x).numpy(),
                               (Kx + Ky + Cxy + Cxy.T).numpy(), atol=1e-12)


def test_random_dot_monte_carlo():
    """X^T Y moments against 200k Monte-Carlo samples (independent X, Y
    with x-independent covariances)."""
    n = 2
    mx, my = _t([1.0, -0.5]), _t([0.3, 0.8])
    Kx = _t([[0.4, 0.1], [0.1, 0.3]])
    Ky = _t([[0.2, 0.0], [0.0, 0.5]])
    X = ta.LeafGP(lambda x: mx, lambda x, xp: Kx, dim=n, name="X")
    Y = ta.LeafGP(lambda x: my, lambda x, xp: Ky, dim=n, name="Y")
    X.register_covar(Y, lambda x, xp: torch.zeros((n, n), dtype=F64))
    expr = X.t() @ Y
    x = torch.zeros(2, dtype=F64)
    mean = float(expr.mean(x))
    var = float(expr.knl(x, x).reshape(()))
    rng = np.random.default_rng(0)
    Lx = np.linalg.cholesky(Kx.numpy())
    Ly = np.linalg.cholesky(Ky.numpy())
    Xs = mx.numpy() + rng.normal(size=(200000, n)) @ Lx.T
    Ys = my.numpy() + rng.normal(size=(200000, n)) @ Ly.T
    prods = np.sum(Xs * Ys, axis=1)
    np.testing.assert_allclose(mean, prods.mean(), atol=3e-3)
    np.testing.assert_allclose(var, prods.var(), rtol=0.05)


def test_cbc2_matches_analytic_lie_derivatives():
    """CBC2 of a near-deterministic pendulum GP equals the analytic
    A(x) u <= b(x) form, mean(CBC2) = -A u + b, and so does the affine
    mean that cbc2_quadratic_terms extracts."""
    pend = td.PendulumDynamics()
    cbf = tps.RadialCBFRelDegree2(model=pend)
    x = _t([3 * math.pi / 4, -0.2])
    u = _t([0.3])
    eps = 1e-8
    one = lambda fn: (lambda x_: fn(x_[None])[0])
    f_fn, g_fn = one(pend.f_func), one(pend.g_func)
    f_gp_fn = lambda: ta.LeafGP(
        f_fn, lambda x_, xp_: eps * torch.eye(2, dtype=F64), dim=2,
        assume_independence=True, name="f")
    fu_gp_fn = lambda uu: ta.LeafGP(
        lambda x_: f_fn(x_) + g_fn(x_) @ uu,
        lambda x_, xp_: eps * torch.eye(2, dtype=F64), dim=2,
        assume_independence=True, name="fu")
    pair_fn = lambda uu: (f_gp_fn(), fu_gp_fn(uu))
    h, gh = one(cbf.cbf), one(cbf.grad_cbf)
    cbc = tcbc.cbc2_gp(h, gh, pair_fn, 2, cbf.k_alpha, u)
    A, b = one(cbf.A)(x), one(cbf.b)(x)
    expected = float(-A @ u + b)
    np.testing.assert_allclose(float(cbc.mean(x).reshape(())), expected,
                               rtol=1e-5, atol=1e-6)
    (bfe, e), _, _, _ = tcbc.cbc2_quadratic_terms(
        lambda uu: tcbc.cbc2_gp(h, gh, pair_fn, 2, cbf.k_alpha, uu), x, u)
    np.testing.assert_allclose(float(bfe @ u + e), expected, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bfe.numpy(), (-A).numpy(), rtol=1e-4,
                               atol=1e-6)


def test_gradient_gp_covar():
    """cov(grad f, g) = d/dx cov(f, g) for a registered cross-covariance
    x^T diag(xp): diag(xp)."""
    f = ta.LeafGP(lambda x: torch.sum(x ** 2),
                  lambda x, xp: torch.exp(-0.5 * torch.sum((x - xp) ** 2)),
                  dim=1, name="f")
    g = ta.LeafGP(lambda x: x, lambda x, xp: torch.eye(2, dtype=F64), dim=2,
                  name="g")
    f.register_covar(g, lambda x, xp: (x * xp)[None, :])
    x, xp = _t([0.5, -1.0]), _t([2.0, 3.0])
    np.testing.assert_allclose(ta.GradientGP(f, x_dim=2).covar(g, x, xp)
                               .numpy(), np.diag(xp.numpy()), atol=1e-10)


def test_gradient_gp_covar_rectangular_z():
    """A cross-covariance with dz = 3 != dx = 2 comes back (dx, dz) in the
    right orientation for both child layouts ((1, dz) and (dz,)), and a
    child whose element count is not Z.dim raises."""
    W = _t([[1.0, -2.0], [0.5, 4.0], [3.0, 0.25]])

    def make_f(layout):
        f = ta.LeafGP(lambda x: torch.sum(x ** 2),
                      lambda x, xp: torch.exp(-0.5 * torch.sum((x - xp) ** 2)),
                      dim=1, name="f")
        z = ta.LeafGP(lambda x: torch.zeros(3, dtype=F64),
                      lambda x, xp: torch.eye(3, dtype=F64), dim=3, name="z")
        if layout == "contract":
            f.register_covar(
                z, lambda x, xp: (W @ x * torch.sum(xp ** 2))[None, :])
        else:
            f.register_covar(z, lambda x, xp: W @ x * torch.sum(xp ** 2))
        return f, z

    x, xp = _t([0.5, -1.0]), _t([2.0, 3.0])
    expect = (torch.sum(xp ** 2) * W).T.numpy()
    for layout in ("contract", "sloppy"):
        f, z = make_f(layout)
        got = ta.GradientGP(f, x_dim=2).covar(z, x, xp).numpy()
        assert got.shape == (2, 3)
        np.testing.assert_allclose(got, expect, atol=1e-10)
    f, z = make_f("contract")
    bad = ta.LeafGP(lambda x: torch.zeros(4, dtype=F64),
                    lambda x, xp: torch.eye(4, dtype=F64), dim=4, name="bad")
    f.register_covar(bad, lambda x, xp: (W @ x)[None, :])
    with pytest.raises(ValueError, match="expected Z.dim"):
        ta.GradientGP(f, x_dim=2).covar(bad, x, xp)


# ---- each node against the JAX node, on the same closures -----------------

def _closures(lib, P):
    """The leaves of the comparison, written for `lib` (jnp or torch) from
    the numpy arrays P: a vector leaf X (dim 3) with an RBF x kernel, a
    vector leaf Y with a polynomial kernel and a registered
    cross-covariance with X (independent of the others), a scalar leaf s
    with a registered cross-covariance with X, and a deterministic vector
    d."""
    if lib is jnp:
        arr, alg = jnp.asarray, ja
        eye = lambda n: jnp.eye(n)
    else:
        arr, alg = _t, ta
        eye = lambda n: torch.eye(n, dtype=F64)
    A, Ky, C, w, v = (arr(P[k]) for k in ("A", "Ky", "C", "w", "v"))
    rbf = lambda x, xp: lib.exp(-0.5 * lib.sum((x - xp) ** 2) / 0.7)
    X = alg.LeafGP(lambda x: lib.sin(A @ x), lambda x, xp: rbf(x, xp) * Ky,
                   dim=3, name="X")
    Y = alg.LeafGP(lambda x: A.T @ x * x[0],
                   lambda x, xp: (1.0 + x @ xp) ** 2 * eye(3), dim=3,
                   assume_independence=True, name="Y")
    X.register_covar(Y, lambda x, xp: rbf(x, xp) * C * (1.0 + x[1] * xp[2]))
    s = alg.LeafGP(lambda x: lib.cos(w @ x) + x @ x,
                   lambda x, xp: rbf(x, xp) * 1.5, dim=1, name="s")
    s.register_covar(X, lambda x, xp: (rbf(x, xp) * (v * lib.tanh(x)))
                     [None, :])
    d = alg.DeterministicGP(lambda x: lib.tanh(A @ x) + v, dim=3, name="d")
    return X, Y, s, d


def _nodes(lib, P):
    """name -> (node, the node its covar is taken with)."""
    X, Y, s, d = _closures(lib, P)
    gs = (s * 0.7 + (d.t() @ X)) * 1.3          # scalar, random
    return {
        "deterministic": (d, X),
        "leaf": (X, Y),
        "leaf_scalar": (s, X),
        "add": (X + Y, X),
        "scale": (X * -1.7, Y),
        "transpose": (X.t(), Y),
        "dot_det": (d.t() @ X, s),
        "dot_det_right": (X.t() @ d, s),
        "dot": (X.t() @ Y, s),
        "gradient": (ta.GradientGP(gs, 3) if lib is torch
                     else ja.GradientGP(gs, 3), X),
        "gradient_of_dot": ((ta.GradientGP if lib is torch
                             else ja.GradientGP)(X.t() @ Y, 3), X),
    }


@pytest.fixture(scope="module")
def node_inputs():
    rng = np.random.default_rng(3)
    Ky = rng.normal(size=(3, 3))
    P = dict(A=rng.normal(size=(3, 3)), Ky=Ky @ Ky.T + np.eye(3),
             C=0.3 * rng.normal(size=(3, 3)), w=rng.normal(size=3),
             v=rng.normal(size=3))
    return P, rng.normal(size=3), rng.normal(size=3)


@pytest.mark.parametrize("name", ["deterministic", "leaf", "leaf_scalar",
                                  "add", "scale", "transpose", "dot_det",
                                  "dot_det_right", "dot", "gradient",
                                  "gradient_of_dot"])
def test_node_matches_jax(node_inputs, name):
    """mean(x), knl(x, x'), knl(x, x) (the clamp's side) and
    covar(Z, x, x') of the node against the JAX node's."""
    P, x, xp = node_inputs
    jn, jz = _nodes(jnp, P)[name]
    tn, tz = _nodes(torch, P)[name]
    assert tn.dim == jn.dim
    xt, xpt = _t(x), _t(xp)
    _close(tn.mean(xt), jn.mean(jnp.asarray(x)))
    _close(tn.knl(xt, xpt), jn.knl(jnp.asarray(x), jnp.asarray(xp)))
    _close(tn.knl(xt, xt), jn.knl(jnp.asarray(x), jnp.asarray(x)))
    _close(tn.covar(tz, xt, xpt),
           jn.covar(jz, jnp.asarray(x), jnp.asarray(xp)))


def test_unregistered_leaves_raise_unless_independent():
    f = ta.LeafGP(lambda x: x, lambda x, xp: torch.eye(2, dtype=F64), 2,
                  name="f")
    g = ta.LeafGP(lambda x: x, lambda x, xp: torch.eye(2, dtype=F64), 2,
                  name="g")
    x = _t([0.1, 0.2])
    with pytest.raises(ValueError, match="No covariance registered"):
        f.covar(g, x, x)
    g.assume_independence = True
    assert torch.equal(f.covar(g, x, x), torch.zeros((2, 2), dtype=F64))
    with pytest.raises(ValueError):
        f + ta.LeafGP(lambda x: x[:1], lambda x, xp: x[:1], 1)


# ---- the clamp at a repeated eigenvalue -------------------------------------

def _grad_gp_of_u(lib, u_in_knl):
    """u (1,) -> a quadratic in u of knl(x, x) of the gradient of a scalar
    RBF leaf with an isotropic lengthscale (mixed Hessian s / l^2 I at
    x = x': a repeated eigenvalue); the leaf's kernel is scaled by
    (1 + u^T u) when u_in_knl, else only its mean carries u."""
    alg = ja if lib is jnp else ta
    x = jnp.asarray([0.3, -0.4]) if lib is jnp else _t([0.3, -0.4])

    def fn(u):
        scale = (1.0 + u @ u) if u_in_knl else 1.0
        f = alg.LeafGP(lambda x_: lib.sum(x_ ** 2) * u[0],
                       lambda x_, xp_: scale * lib.exp(
                           -0.5 * lib.sum((x_ - xp_) ** 2) / 0.5), dim=1)
        K = alg.GradientGP(f, 2).knl(x, x)
        return (K[0, 0] + K[1, 1]) * u[0] ** 2 + K[0, 1] * u[0]

    return fn


@pytest.mark.parametrize("u_in_knl", [False, True])
def test_clamp_at_repeated_eigenvalue_pinned_to_jax(u_in_knl):
    """quadratic_terms in u of a function of the clamped gradient kernel
    at x = x', whose eigenvalue s / l^2 is repeated: where the kernel does
    not depend on u the terms are finite and JAX's; where it does, JAX
    gives NaN (the eigenvectors' derivative at a repeated eigenvalue), and
    so does the port."""
    u0 = np.array([0.5])
    want = jfunc.quadratic_terms(_grad_gp_of_u(jnp, u_in_knl),
                                 jnp.asarray(u0))
    got = tfunc.quadratic_terms(_grad_gp_of_u(torch, u_in_knl), _t(u0))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all() == (not u_in_knl)
        if u_in_knl:
            assert np.isnan(w).any() and torch.isnan(g).any()
            np.testing.assert_array_equal(np.isfinite(g.numpy()),
                                          np.isfinite(w))
        else:
            _close(g, w)


# ---- sample, term extraction ------------------------------------------------

def test_sample_uses_the_given_generator():
    """A draw is m + V sqrt(max(w, 0)) z with z the generator's next
    normals: the same seed gives the same draw, and 4000 draws have the
    node's mean and covariance."""
    K = _t([[0.5, 0.2], [0.2, 0.3]])
    leaf = ta.LeafGP(lambda x: torch.sin(x), lambda x, xp: K, dim=2)
    x = _t([0.4, -1.1])
    a = leaf.sample(torch.Generator().manual_seed(7), x)
    b = leaf.sample(torch.Generator().manual_seed(7), x)
    assert torch.equal(a, b)
    w, v = torch.linalg.eigh(K)
    z = torch.randn((2,), generator=torch.Generator().manual_seed(7),
                    dtype=F64)
    _close(a, (torch.sin(x) + (v * torch.sqrt(w)) @ z).numpy(), 1e-14)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([leaf.sample(gen, x) for _ in range(4000)])
    np.testing.assert_allclose(draws.mean(0).numpy(), torch.sin(x).numpy(),
                               atol=0.05)
    np.testing.assert_allclose(np.cov(draws.numpy().T), K.numpy(), atol=0.05)
    scalar = ta.DeterministicGP(lambda x: x[:1] * 2.0, dim=1)
    assert torch.equal(scalar.sample(gen, x), x[:1] * 2.0)


def test_term_extraction_matches_jax():
    """affine_terms and quadratic_terms of an affine and a quadratic
    function of u (m = 3) against JAX's."""
    rng = np.random.default_rng(5)
    a, Q, p = rng.normal(size=3), rng.normal(size=(3, 3)), rng.normal(size=3)
    u = rng.normal(size=3)
    lin = lambda lib: (lambda v: math.sin(1.3) * (v @ (a if lib is jnp
                                                       else _t(a))) + 0.7)
    quad = lambda lib: (lambda v: v @ (Q if lib is jnp else _t(Q)) @ v
                        + (p if lib is jnp else _t(p)) @ v - 2.0)
    for got, want in zip(tfunc.affine_terms(lin(torch), _t(u)),
                         jfunc.affine_terms(lin(jnp), jnp.asarray(u))):
        _close(got, want)
    for got, want in zip(tfunc.quadratic_terms(quad(torch), _t(u)),
                         jfunc.quadratic_terms(quad(jnp), jnp.asarray(u))):
        _close(got, want)
