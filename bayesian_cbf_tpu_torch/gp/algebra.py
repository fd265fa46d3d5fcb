"""Expressions over Gaussian processes, evaluated at one state.

Every node exposes

    mean(x)          -> (d,) or a scalar
    knl(x, xp)       -> (d, d) or a scalar   (its covariance with itself)
    covar(Z, x, xp)  -> (d, dz)              (cov(self(x), Z(xp)))

as pure functions of tensors, so an expression can be differentiated and
vectorized with `torch.func` (`grad`, `jacfwd`, `vmap`) and is rebuilt for
each evaluation, never stored.  Cross-covariances between random leaves
are a registry on the leaf, keyed by the other leaf's `id()`.  The
product of two random nodes has the exact Isserlis second moment, and the
gradient of a scalar GP is differentiated with `torch.func.grad` and
`jacfwd`, its covariance at x == x' with small negative eigenvalues
(above -EPS) set to zero.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

EPS = 2e-3  # eigenvalues in (-EPS, 0) of a gradient's covariance are roundoff


def _as_matrix(k, d):
    k = torch.as_tensor(k)
    if k.ndim == 0:
        return k.reshape(1, 1) if d == 1 else k * torch.eye(
            d, dtype=k.dtype, device=k.device)
    return k


def _zeros(rows, cols, x):
    return torch.zeros((rows, cols), dtype=x.dtype, device=x.device)


class GP:
    """Base node.  `dim` is the output dimension (1 for scalar GPs)."""

    dim: int = 1

    def mean(self, x):
        raise NotImplementedError

    def knl(self, x, xp):
        raise NotImplementedError

    def covar(self, Z: "GP", x, xp):
        """cov(self(x), Z(xp)): (self.dim, Z.dim)."""
        raise NotImplementedError

    def sample(self, generator: torch.Generator, x):
        """One draw of self(x), with the normal deviates from `generator`
        (on x's device)."""
        m = torch.atleast_1d(self.mean(x))
        K = _as_matrix(self.knl(x, x), self.dim)
        w, v = torch.linalg.eigh(0.5 * (K + K.T))
        L = v * torch.sqrt(torch.clamp(w, min=0.0))[None, :]
        return m + L @ torch.randn((self.dim,), generator=generator,
                                   dtype=m.dtype, device=m.device)

    # -- operators --------------------------------------------------------
    def __add__(self, Y):
        return AddGP(self, Y)

    def __mul__(self, a):
        return ScaleGP(self, a)

    __rmul__ = __mul__

    def t(self):
        return TransposeGP(self)

    def __matmul__(self, Y):
        base = self.base if isinstance(self, TransposeGP) else self
        if isinstance(base, DeterministicGP):
            return DotDetGP(base, Y)
        if isinstance(Y, DeterministicGP):
            return DotDetGP(Y, base)
        return DotGP(base, Y)


class DeterministicGP(GP):
    """A deterministic vector function as a GP of zero covariance."""

    def __init__(self, fn: Callable, dim: int, name: str = "det"):
        self.fn = fn
        self.dim = dim
        self.name = name

    def mean(self, x):
        return self.fn(x)

    def knl(self, x, xp):
        return _zeros(self.dim, self.dim, x)

    def covar(self, Z, x, xp):
        if isinstance(Z, DeterministicGP):
            return _zeros(self.dim, Z.dim, x)
        return Z.covar(self, xp, x).T


class LeafGP(GP):
    """A random leaf given by mean and kernel closures, with a registry of
    its cross-covariances with other leaves.  A leaf marked
    `assume_independence` has zero covariance with every leaf it has no
    registered covariance with; otherwise such a pair raises."""

    def __init__(self, mean: Callable, knl: Callable, dim: int,
                 assume_independence: bool = False, name: str = "gp"):
        self._mean = mean
        self._knl = knl
        self.dim = dim
        self.name = name
        self.assume_independence = assume_independence
        self._covars: Dict[int, Callable] = {id(self): knl}

    def register_covar(self, other: "LeafGP", covar_fn: Callable,
                       covar_fn_rev: Optional[Callable] = None):
        """Register cov(self(x), other(xp)) = covar_fn(x, xp) (and its
        reverse, by default covar_fn(xp, x).T)."""
        self._covars[id(other)] = covar_fn
        rev = (covar_fn_rev if covar_fn_rev is not None
               else lambda x, xp: covar_fn(xp, x).T)
        other._covars[id(self)] = rev

    def mean(self, x):
        return self._mean(x)

    def knl(self, x, xp):
        return self._knl(x, xp)

    def covar(self, Z, x, xp):
        if isinstance(Z, LeafGP):
            if id(Z) in self._covars:
                return self._covars[id(Z)](x, xp)
            if self.assume_independence or Z.assume_independence:
                return _zeros(self.dim, Z.dim, x)
            raise ValueError(
                f"No covariance registered between leaf GPs {self.name} "
                f"and {Z.name}")
        if isinstance(Z, DeterministicGP):
            return _zeros(self.dim, Z.dim, x)
        return Z.covar(self, xp, x).T


class AddGP(GP):
    def __init__(self, X: GP, Y: GP):
        if X.dim != Y.dim:
            raise ValueError(f"AddGP of dims {X.dim} and {Y.dim}")
        self.lhs, self.rhs = X, Y
        self.dim = X.dim

    def mean(self, x):
        return self.lhs.mean(x) + self.rhs.mean(x)

    def knl(self, x, xp):
        X, Y = self.lhs, self.rhs
        return (X.knl(x, xp) + Y.knl(x, xp)
                + X.covar(Y, x, xp) + Y.covar(X, x, xp))

    def covar(self, Z, x, xp):
        return self.lhs.covar(Z, x, xp) + self.rhs.covar(Z, x, xp)


class ScaleGP(GP):
    def __init__(self, X: GP, a):
        self.base = X
        self.a = a
        self.dim = X.dim

    def mean(self, x):
        return self.a * self.base.mean(x)

    def knl(self, x, xp):
        return (self.a ** 2) * self.base.knl(x, xp)

    def covar(self, Z, x, xp):
        return self.a * self.base.covar(Z, x, xp)


class TransposeGP(GP):
    """Marks the left factor of `h.t() @ f`; the same GP otherwise."""

    def __init__(self, X: GP):
        self.base = X
        self.dim = X.dim

    def mean(self, x):
        return self.base.mean(x)

    def knl(self, x, xp):
        return self.base.knl(x, xp)

    def covar(self, Z, x, xp):
        return self.base.covar(Z, x, xp)


class DotDetGP(GP):
    """h(x)^T f(x) for deterministic h and random f, exact.  Scalar."""

    dim = 1

    def __init__(self, h: DeterministicGP, f: GP):
        if h.dim != f.dim:
            raise ValueError(f"DotDetGP of dims {h.dim} and {f.dim}")
        self.h, self.f = h, f

    def mean(self, x):
        return self.h.mean(x) @ self.f.mean(x)

    def knl(self, x, xp):
        return self.h.mean(x) @ self.f.knl(x, xp) @ self.h.mean(xp)

    def covar(self, Z, x, xp):
        return (self.h.mean(x) @ self.f.covar(Z, x, xp)).reshape(1, -1)


class DotGP(GP):
    """X(x)^T Y(x) for jointly Gaussian X, Y, with exact second moments:

        mean = mu_x^T mu_y + tr cov(X, Y)
        knl  = mu_x1 Ky12 mu_x2 + mu_y1 Kx12 mu_y2
               + mu_x1 Cyx12^T mu_y2 + mu_y1 Cxy12^T mu_x2
               + sum(Kx12 * Ky12) + sum(Cxy12 * Cyx12^T)    (Isserlis)

    Scalar."""

    dim = 1

    def __init__(self, X: GP, Y: GP):
        if X.dim != Y.dim:
            raise ValueError(f"DotGP of dims {X.dim} and {Y.dim}")
        self.X, self.Y = X, Y

    def mean(self, x):
        X, Y = self.X, self.Y
        return X.mean(x) @ Y.mean(x) + torch.trace(X.covar(Y, x, x))

    def knl(self, x, xp):
        X, Y = self.X, self.Y
        mx1, my1 = X.mean(x), Y.mean(x)
        mx2, my2 = X.mean(xp), Y.mean(xp)
        Kx12 = X.knl(x, xp)
        Ky12 = Y.knl(x, xp)
        Cxy12 = X.covar(Y, x, xp)   # cov(X(x), Y(xp))
        Cyx12 = Y.covar(X, x, xp)   # cov(Y(x), X(xp))
        mean_terms = (mx1 @ Ky12 @ mx2 + my1 @ Kx12 @ my2
                      + mx1 @ Cyx12.T @ my2 + my1 @ Cxy12.T @ mx2)
        quartic = torch.sum(Kx12 * Ky12) + torch.sum(Cxy12 * Cyx12.T)
        return mean_terms + quartic

    def covar(self, Z, x, xp):
        X, Y = self.X, self.Y
        c = X.mean(x) @ Y.covar(Z, x, xp) + Y.mean(x) @ X.covar(Z, x, xp)
        return c.reshape(1, -1)


class GradientGP(GP):
    """The GP of the gradient of a scalar GP f, (grad f)(x):

        mean  = grad_x f.mean                 (torch.func.grad)
        knl   = d^2 k_f / dx dx'              (jacfwd of grad)
        covar = d/dx cov(f, Z), transposed    (jacfwd)

    At x == x' the kernel's eigenvalues in (-EPS, 0) are set to zero.  The
    choice between the clamped and the raw kernel is a `torch.where` over
    both, so that it holds under `torch.func` transforms: a Hessian in u
    of a clamped kernel that depends on u, at a repeated eigenvalue, is not
    finite, as the eigenvector derivative is not."""

    def __init__(self, f: GP, x_dim: int):
        if f.dim != 1:
            raise ValueError(f"GradientGP of a GP of dim {f.dim}, not 1")
        self.f = f
        self.dim = x_dim

    def _scalar_mean(self, x):
        return self.f.mean(x).reshape(())

    def _scalar_knl(self, x, xp):
        return self.f.knl(x, xp).reshape(())

    def mean(self, x):
        return torch.func.grad(self._scalar_mean)(x)

    def knl(self, x, xp):
        H = torch.func.jacfwd(torch.func.grad(self._scalar_knl, argnums=0),
                              argnums=1)(x, xp)
        same = torch.all(torch.abs(x - xp) < 1e-12)
        Hs = 0.5 * (H + H.T)
        w, v = torch.linalg.eigh(Hs)
        w = torch.where((w < 0) & (w > -EPS), torch.zeros_like(w), w)
        return torch.where(same, (v * w[None, :]) @ v.T, H)

    def covar(self, Z, x, xp):
        # f is scalar, so cov(f(x), Z(xp)) has Z.dim elements whatever
        # singleton layout the child gives ((1, dz) or (dz,)): flatten
        # before differentiating, so that the Jacobian is (dz, dx)
        def cflat(xs):
            return self.f.covar(Z, xs, xp).reshape(-1)

        J = torch.func.jacfwd(cflat)(x)      # (dz, dx)
        if J.shape[0] != Z.dim:
            raise ValueError(
                f"cov(f, {getattr(Z, 'name', type(Z).__name__)}) has "
                f"{J.shape[0]} elements, expected Z.dim={Z.dim} for scalar f")
        return J.T                           # (dx, dz)
