"""Coregionalization (vector-variate) GP of control-affine dynamics: the
CoGP baseline of the MVGP-against-CoGP experiments.

Instead of the Kronecker structure B kron A of the MVGP, one dense task
covariance Sigma of order (1+m) n lies over vec F:

    vec F(x) ~ GP(vec M, k(x, x') Sigma),   k = RBF (ARD) + linear

An observation y_i = F(x_i)^T uh_i projects with H_i = uh_i^T kron I_n,
so the training Gram has order K n,

    G[(i, a), (j, c)] = k(x_i, x_j) (H_i Sigma H_j^T)[a, c],

and every factorization costs O(K^3 n^3), where the MVGP's costs O(K^3).
vec F is ordered as (1+m, n) flattened: index r n + a for the control
channel r and the output a.  Unbatched: one training set, one set of
hyperparameters.  The Gram is factored by `masked_cholesky`, a library
Cholesky with a jitter ladder.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.linalg import masked_cholesky
from .mvgp import (_SQRT2PI_LOG, MVGPData, _inv_softplus, _softplus,
                   adam_fit)


class CoGPParams(NamedTuple):
    """Trainable hyperparameters: Sigma = W_S W_S^T + diag(softplus(raw_vS));
    k(x, x') = softplus(raw_outputscale) exp(-1/2 |(x - x') / l|^2)
    + softplus(raw_linscale) x^T x', l = softplus(raw_lengthscale)."""
    raw_lengthscale: torch.Tensor   # (n,)
    raw_outputscale: torch.Tensor   # ()
    raw_linscale: torch.Tensor      # ()
    W_S: torch.Tensor               # ((1+m) n, rank)
    raw_vS: torch.Tensor            # ((1+m) n,)
    mean_M: torch.Tensor            # (1+m, n)

    @property
    def lengthscale(self):
        return _softplus(self.raw_lengthscale)

    @property
    def outputscale(self):
        return _softplus(self.raw_outputscale)

    @property
    def linscale(self):
        return _softplus(self.raw_linscale)

    @property
    def Sigma(self):
        return self.W_S @ self.W_S.T + torch.diag(_softplus(self.raw_vS))


class CoGPCache(NamedTuple):
    L: torch.Tensor       # (K n, K n) factor of the masked Gram
    alpha: torch.Tensor   # (K n,) = G^{-1} vec(Y)


class CoGP(NamedTuple):
    x_dim: int
    u_dim: int
    rank: int
    jitter: float = 1e-6

    @property
    def tasks(self):
        return (1 + self.u_dim) * self.x_dim

    def init_params(self, generator: torch.Generator, device,
                    dtype) -> CoGPParams:
        """Unit scales, linear variance 0.1, W_S ~ 0.3 N(0, 1) drawn from
        `generator` (on `device`), a zero mean."""
        raw1 = _inv_softplus(1.0)
        t = self.tasks
        kw = dict(dtype=dtype, device=device)
        return CoGPParams(
            raw_lengthscale=torch.full((self.x_dim,), raw1, **kw),
            raw_outputscale=torch.tensor(raw1, **kw),
            raw_linscale=torch.tensor(_inv_softplus(0.1), **kw),
            W_S=0.3 * torch.randn((t, self.rank), generator=generator, **kw),
            raw_vS=torch.full((t,), raw1, **kw),
            mean_M=torch.zeros((1 + self.u_dim, self.x_dim), **kw))

    def make_data(self, X, U, Xdot) -> MVGPData:
        """A training set of k rows, all valid: X (k, n), U (k, m),
        Xdot (k, n)."""
        ones = torch.ones_like(X[:, :1])
        return MVGPData(X=X, UH=torch.cat([ones, U], -1), Xdot=Xdot,
                        mask=torch.ones_like(X[:, 0]))

    # ---------------------------------------------------------- kernel

    def k_xx(self, params: CoGPParams, X1, X2):
        d = (X1[:, None, :] - X2[None, :, :]) / params.lengthscale
        rbf = params.outputscale * torch.exp(-0.5 * torch.sum(d * d, -1))
        return rbf + params.linscale * (X1 @ X2.T)

    def _HSH(self, params: CoGPParams, UH1, UH2):
        """(k1, k2, n, n) blocks H_i Sigma H_j^T = sum_{r,s} uh1_r uh2_s
        Sigma[r, :, s, :]."""
        n, mh = self.x_dim, 1 + self.u_dim
        S = params.Sigma.reshape(mh, n, mh, n)
        return torch.einsum('ir,rasc,js->ijac', UH1, S, UH2)

    def gram(self, params: CoGPParams, data: MVGPData):
        """The (K n, K n) Gram plus jitter I (unmasked)."""
        K, n = data.X.shape[0], self.x_dim
        Kxx = self.k_xx(params, data.X, data.X)
        blocks = self._HSH(params, data.UH, data.UH)            # (K, K, n, n)
        G = (Kxx[:, :, None, None] * blocks).permute(0, 2, 1, 3)
        G = G.reshape(K * n, K * n)
        return G + self.jitter * torch.eye(K * n, dtype=G.dtype,
                                           device=G.device)

    def residual_Y(self, params: CoGPParams, data: MVGPData):
        return (data.Xdot - data.UH @ params.mean_M) * data.mask[:, None]

    def _scalar_mask(self, data: MVGPData):
        return torch.repeat_interleave(data.mask, self.x_dim)

    def _factor(self, params: CoGPParams, data: MVGPData):
        return masked_cholesky(self.gram(params, data),
                               self._scalar_mask(data),
                               init_jitter=self.jitter)[1]

    # ---------------------------------------------------------- MLL / fit

    def mll(self, params: CoGPParams, data: MVGPData):
        """Exact marginal log likelihood per valid scalar observation."""
        y = self.residual_Y(params, data).reshape(-1)
        smask = self._scalar_mask(data)
        L = self._factor(params, data)
        Kinv_y = torch.linalg.solve_triangular(L, y[:, None], upper=False)
        quad = torch.sum(Kinv_y * Kinv_y)
        logdet = 2.0 * torch.sum(torch.log(torch.clamp(
            torch.diagonal(L), min=1e-20)))
        cnt = torch.sum(smask)
        ll = -0.5 * (quad + logdet + cnt * _SQRT2PI_LOG)
        return ll / torch.clamp(cnt, min=1.0)

    def fit(self, params: CoGPParams, data: MVGPData,
            training_iter: int = 50, lr: float = 0.1) -> CoGPParams:
        """Adam on the negative MLL (`mvgp.adam_fit`, unbatched)."""
        return adam_fit(lambda p: -self.mll(p, data), params, training_iter,
                        lr, batched=False)

    # ---------------------------------------------------------- posterior

    def refresh_cache(self, params: CoGPParams, data: MVGPData) -> CoGPCache:
        L = self._factor(params, data)
        y = self.residual_Y(params, data).reshape(-1, 1)
        return CoGPCache(L=L, alpha=torch.cholesky_solve(y, L)[:, 0])

    def predict_fullmat(self, params: CoGPParams, data: MVGPData,
                        cache: CoGPCache, Xtest):
        """The posterior over vec F at test states Xtest (b, n): (mean
        (b (1+m) n,), var (b (1+m) n, b (1+m) n)), ordered by state, then
        the control channel, then the output."""
        b = Xtest.shape[0]
        n, mh = self.x_dim, 1 + self.u_dim
        K = data.X.shape[0]
        Kxs = self.k_xx(params, Xtest, data.X)                   # (b, K)
        Sigma = params.Sigma
        S = Sigma.reshape(mh, n, mh, n)
        UHm = data.UH * data.mask[:, None]
        SH = torch.einsum('rasc,js->rajc', S, UHm)               # (mh, n, K, n)
        # cross[(b p), (j c)] = Kxs[b, j] SH[p, j, c]
        cross = (Kxs[:, None, :, None]
                 * SH.reshape(mh * n, K, n)[None]).reshape(b * mh * n, K * n)
        mean = (params.mean_M.reshape(-1)[None].expand(b, mh * n).reshape(-1)
                + cross @ cache.alpha)
        Kss = self.k_xx(params, Xtest, Xtest)                    # (b, b)
        prior = (Kss[:, None, :, None] * Sigma[None, :, None, :]).reshape(
            b * mh * n, b * mh * n)
        # prior - V^T V with V = L^{-1} cross^T: in f32 the subtracted
        # term is then a Gram whose roundoff grows with cond(L), not with
        # cond(G) as in cross G^{-1} cross^T (on the unicycle speed test's
        # CoGP fits the blocks' least eigenvalue, f32 on a CPU, is -4e-7 at
        # worst against -5e-6 that way)
        V = torch.linalg.solve_triangular(cache.L, cross.T, upper=False)
        var = prior - V.T @ V
        return mean, 0.5 * (var + var.T)


def make_cogp(x_dim: int, u_dim: int, **kw) -> CoGP:
    """Full-rank task covariance (rank (1+m) n)."""
    return CoGP(x_dim, u_dim, rank=(1 + u_dim) * x_dim, **kw)


def make_cogp_diag(x_dim: int, u_dim: int, **kw) -> CoGP:
    """Diagonal task covariance (rank 0: W_S is ((1+m) n, 0))."""
    return CoGP(x_dim, u_dim, rank=0, **kw)
