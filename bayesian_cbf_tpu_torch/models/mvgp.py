"""Matrix-variate Gaussian process regression of control-affine dynamics,
batched over episodes.

    xdot = F(x)^T u_hom,   u_hom = [1; u],   F(x) ~ MN(M, B k(x, x'), A)

so a training observation y_i = F(x_i)^T uh_i has
cov(y_i, y_j) = k(x_i, x_j) (uh_i^T B uh_j) A.  Every tensor carries a
leading episode axis B; the training buffer has fixed capacity K with a
validity mask.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..utils.linalg import (cho_solve_small_unrolled, kron,
                            psd_chol_small_ladder)

_SQRT2PI_LOG = math.log(2.0 * math.pi)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y: float) -> float:
    return float(math.log(math.expm1(y))) if y < 20 else float(y)


def _eye_like(n, t):
    return torch.eye(n, dtype=t.dtype, device=t.device)


class MVGPParams(NamedTuple):
    """Trainable hyperparameters, each with a leading episode axis.

    A = W_A W_A^T + diag(softplus(raw_vA));  B = W_B W_B^T + diag(softplus(raw_vB));
    k(x, x') = softplus(raw_outputscale) exp(-1/2 sum_d (dx_d / l_d)^2),
    l = softplus(raw_lengthscale); mean_M (1+m, n) the prior mean of F."""
    raw_lengthscale: torch.Tensor   # (B, n)
    raw_outputscale: torch.Tensor   # (B,)
    W_A: torch.Tensor               # (B, n, rank_A)
    raw_vA: torch.Tensor            # (B, n)
    W_B: torch.Tensor               # (B, 1+m, rank_B)
    raw_vB: torch.Tensor            # (B, 1+m)
    mean_M: torch.Tensor            # (B, 1+m, n)

    @property
    def lengthscale(self):
        return _softplus(self.raw_lengthscale)

    @property
    def outputscale(self):
        return _softplus(self.raw_outputscale)

    @property
    def A(self):
        return (self.W_A @ self.W_A.transpose(-1, -2)
                + torch.diag_embed(_softplus(self.raw_vA)))

    @property
    def B(self):
        return (self.W_B @ self.W_B.transpose(-1, -2)
                + torch.diag_embed(_softplus(self.raw_vB)))


class MVGPData(NamedTuple):
    """Fixed-shape training buffer.  Rows with mask = 0 are inert."""
    X: torch.Tensor      # (B, K, n)
    UH: torch.Tensor     # (B, K, 1+m) homogenized controls [1, u]
    Xdot: torch.Tensor   # (B, K, n) observed residual state derivatives
    mask: torch.Tensor   # (B, K)


class MVGPCache(NamedTuple):
    """Posterior cache: L = chol(masked Kb), alpha = Kb^{-1} Y, Linv = L^{-1}."""
    L: torch.Tensor      # (B, K, K)
    alpha: torch.Tensor  # (B, K, n)
    Linv: torch.Tensor   # (B, K, K)


class MVGP(NamedTuple):
    """Static model description (shapes and options only).

    The JAX package selects its kernel paths with module globals; here they
    are fields, so that configurations can differ within one process:

    fit_inverse: the fit's (K^{-1}, logdet K), `cholinv.FIT_INVERSE`:
        "cholk" (fused factor + inverse kernel), "chol" (blocked factor,
        L^{-1}, then Linv^T Linv), "sweep" (recursive Schur/sweep; not
        finite on trajectory Grams in f32), "sweep_full" (one sweep).
    fit_chol_assembly: the L^{-1} assembly of "chol",
        `cholinv.FIT_CHOL_ASSEMBLY`; "" takes `linv_assembly`.
    linv_assembly: the refresh's L^{-1}, `pallas_chol.LINV_ASSEMBLY`:
        "kernel" (inside the Cholesky kernel), "row" or "col" (the blocked
        factor with diagonal-block inverses, assembled with matmuls).
    fused_gram: build the refresh Gram with the fused kernel,
        `MVGP.use_pallas`.
    fused_fit: the MLL through the fused Gram + inverse op
        (`ops/gramsolve`), `mvgp.FUSED_FIT`; False builds `gram_kb` and
        calls `solve_and_logdet`.
    """
    x_dim: int
    u_dim: int
    rank_A: int
    rank_B: int
    jitter: float = 1e-6
    gamma_prior: Optional[tuple] = None   # (concentration, rate) on lengthscale
    fit_inverse: str = "cholk"
    fit_chol_assembly: str = ""
    linv_assembly: str = "kernel"
    fused_gram: bool = False
    fused_fit: bool = True

    @property
    def fit_assembly(self) -> str:
        """The L^{-1} assembly of the "chol" fit inverse."""
        return self.fit_chol_assembly or self.linv_assembly

    # ---------------------------------------------------------- init

    def init_params(self, batch: int, generator: torch.Generator,
                    device, dtype) -> MVGPParams:
        n, mh = self.x_dim, 1 + self.u_dim
        raw1 = _inv_softplus(1.0)
        kw = dict(dtype=dtype, device=device)
        return MVGPParams(
            raw_lengthscale=torch.full((batch, n), raw1, **kw),
            raw_outputscale=torch.full((batch,), raw1, **kw),
            W_A=0.3 * torch.randn((batch, n, self.rank_A),
                                  generator=generator, **kw),
            raw_vA=torch.full((batch, n), raw1, **kw),
            W_B=0.3 * torch.randn((batch, mh, self.rank_B),
                                  generator=generator, **kw),
            raw_vB=torch.full((batch, mh), raw1, **kw),
            mean_M=torch.zeros((batch, mh, n), **kw))

    def empty_data(self, batch: int, capacity: int, device, dtype) -> MVGPData:
        n, mh = self.x_dim, 1 + self.u_dim
        kw = dict(dtype=dtype, device=device)
        return MVGPData(X=torch.zeros((batch, capacity, n), **kw),
                        UH=torch.zeros((batch, capacity, mh), **kw),
                        Xdot=torch.zeros((batch, capacity, n), **kw),
                        mask=torch.zeros((batch, capacity), **kw))

    def empty_cache(self, batch: int, capacity: int, device,
                    dtype) -> MVGPCache:
        """Closed-form cache of an empty buffer: L = Linv = I, alpha = 0."""
        eye = torch.eye(capacity, dtype=dtype, device=device).expand(
            batch, capacity, capacity).clone()
        return MVGPCache(L=eye, alpha=torch.zeros(
            (batch, capacity, self.x_dim), dtype=dtype, device=device),
            Linv=eye.clone())

    def make_data(self, X, U, Xdot) -> MVGPData:
        """A training set of (B, k) rows, all valid: X (B, k, n),
        U (B, k, m), Xdot (B, k, n)."""
        return MVGPData(X=X, UH=torch.cat([torch.ones_like(U[..., :1]), U],
                                          -1),
                        Xdot=Xdot, mask=torch.ones(X.shape[:-1],
                                                   dtype=X.dtype,
                                                   device=X.device))

    # ---------------------------------------------------------- kernel

    def k_xx(self, params: MVGPParams, X1, X2):
        """ARD RBF Gram (B, b1, b2) in the broadcast-difference form (the
        dot-product form cancels catastrophically for nearby points)."""
        ell = params.lengthscale[:, None, None, :]
        d = (X1[:, :, None, :] - X2[:, None, :, :]) / ell
        return params.outputscale[:, None, None] * torch.exp(
            -0.5 * torch.sum(d * d, -1))

    def k_xx_single(self, params: MVGPParams, x, xp):
        d = (x - xp) / params.lengthscale
        return params.outputscale * torch.exp(-0.5 * torch.sum(d * d, -1))

    def gram_kb(self, params: MVGPParams, data: MVGPData):
        """Kb = Kxx o (UH B UH^T) + nugget I, with the dtype-aware nugget
        jitter + 10 k eps mean|diag|."""
        Kxx = self.k_xx(params, data.X, data.X)
        uBu = data.UH @ params.B @ data.UH.transpose(-1, -2)
        Kb = Kxx * uBu
        k = Kb.shape[-1]
        eps = torch.finfo(Kb.dtype).eps
        scale = torch.clamp(torch.mean(torch.abs(
            torch.diagonal(Kb, dim1=-2, dim2=-1)), -1), min=1.0)
        nug = self.jitter + 10.0 * k * eps * scale
        return Kb + nug[:, None, None] * _eye_like(k, Kb)

    def residual_Y(self, params: MVGPParams, data: MVGPData):
        """Y_i = xdot_i - M^T uh_i, zeroed on invalid rows.  (B, K, n)"""
        return (data.Xdot - data.UH @ params.mean_M) * data.mask[..., None]

    # ---------------------------------------------------------- MLL / fit

    def mll(self, params: MVGPParams, data: MVGPData):
        """Exact matrix-normal marginal log likelihood per scalar
        observation, (B,): through the fused Gram + inverse op, or with
        `fused_fit=False` through `gram_kb` and `solve_and_logdet`; either
        way the inverse is the `fit_inverse` kernel."""
        n = self.x_dim
        kcnt = torch.sum(data.mask, -1)
        Y = self.residual_Y(params, data)
        m = data.mask.to(Y.dtype)
        how = dict(method=self.fit_inverse, assembly=self.fit_assembly)
        if self.fused_fit:
            from ..ops.gramsolve import gram_solve_logdet
            k = data.X.shape[1]
            eps = torch.finfo(Y.dtype).eps
            UB = data.UH @ (params.outputscale[:, None, None] * params.B)
            diagKb = torch.sum(UB * data.UH, -1)
            scale = torch.clamp(torch.mean(torch.abs(diagKb), -1), min=1.0)
            nug = self.jitter + 10.0 * k * eps * scale
            S, logdet_Kb = gram_solve_logdet(
                data.X, UB, data.UH, 1.0 / params.lengthscale, nug, m, Y,
                **how)
        else:
            from ..ops.cholinv import solve_and_logdet
            eye = _eye_like(data.X.shape[1], Y)
            Km = (self.gram_kb(params, data) * (m[:, :, None] * m[:, None, :])
                  + eye * (1.0 - m)[:, :, None])
            S, logdet_Kb = solve_and_logdet(Km, Y, **how)
        LA = psd_chol_small_ladder(params.A, init_jitter=self.jitter)
        G = Y.transpose(-1, -2) @ S
        quad = torch.diagonal(cho_solve_small_unrolled(LA, G),
                              dim1=-2, dim2=-1).sum(-1)
        logdet_A = 2.0 * torch.sum(torch.log(torch.clamp(
            torch.diagonal(LA, dim1=-2, dim2=-1), min=1e-20)), -1)
        ll = -0.5 * (quad + n * logdet_Kb + kcnt * logdet_A
                     + kcnt * n * _SQRT2PI_LOG)
        if self.gamma_prior is not None:
            conc, rate = self.gamma_prior
            ell = params.lengthscale
            ll = ll + torch.sum((conc - 1.0) * torch.log(ell) - rate * ell, -1)
        return ll / torch.clamp(kcnt * n, min=1.0)

    def fit(self, params: MVGPParams, data: MVGPData,
            training_iter: int = 50, lr: float = 0.1) -> MVGPParams:
        """Adam on the negative MLL, per episode: the optax chain
        scale_by_adam -> piecewise_constant_schedule (x0.1 at 30/60/80/90%)
        -> scale(-1), parameters clipped to +-60, and a step rejected per
        episode (with its Adam state rolled back) when the loss, the
        gradient or the new parameters are not finite."""
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
                loss = -self.mll(MVGPParams(*leaves), data)
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
        return MVGPParams(*p)

    # ---------------------------------------------------------- posterior

    def masked_kb(self, params: MVGPParams, data: MVGPData):
        """Masked + jittered Gram; with `fused_gram`, built by the fused
        kernel (ops/gram.py) from Xs = X / lengthscale and UH chol(B)."""
        if self.fused_gram:
            from ..ops.gram import fused_gram_kb
            LB = psd_chol_small_ladder(params.B, init_jitter=1e-10)
            Xs = data.X / params.lengthscale[:, None, :]
            return fused_gram_kb(Xs, data.UH @ LB, data.mask.contiguous(),
                                 params.outputscale, self.jitter)
        Kb = self.gram_kb(params, data)
        m = data.mask.to(Kb.dtype)
        eye = _eye_like(Kb.shape[-1], Kb)
        return Kb * (m[:, :, None] * m[:, None, :]) + eye * (1.0 - m)[:, :, None]

    def factor_ladder(self, K):
        """(L, L^{-1}) of the masked Gram K (B, k, k) by the three-rung
        scale-aware jitter ladder (K, + 1e-5 scale, + 1e-2 scale more),
        selected per episode: a rung is accepted only when its factor is
        finite and max|Linv| < 1e6 (f32) / 1e12 (f64).  Also returns the
        episodes per accepted rung, a (3,) integer tensor on K's device."""
        from ..ops.cholinv import chol_inv_fwd
        eye = _eye_like(K.shape[-1], K)
        scale = torch.clamp(torch.mean(torch.abs(torch.diagonal(
            K, dim1=-2, dim2=-1)), -1), min=1.0)[:, None, None]
        lim = 1e6 if K.dtype == torch.float32 else 1e12

        def sane(Lk, Linvk):
            return (torch.isfinite(Lk).all(-1).all(-1)
                    & torch.isfinite(Linvk).all(-1).all(-1)
                    & (torch.amax(torch.abs(Linvk), (-2, -1)) < lim)
                    )[:, None, None]

        asm = self.linv_assembly
        L, Linv = chol_inv_fwd(K, asm)
        ok = sane(L, Linv)
        zero = torch.zeros_like(scale)
        bump1 = torch.where(ok, zero, 1e-5 * scale)
        L2, Linv2 = chol_inv_fwd(K + bump1 * eye, asm)
        L = torch.where(ok, L, L2)
        Linv = torch.where(ok, Linv, Linv2)
        ok2 = sane(L, Linv)
        bump2 = torch.where(ok2, zero, 1e-2 * scale)
        L3, Linv3 = chol_inv_fwd(K + (bump1 + bump2) * eye, asm)
        L = torch.where(ok2, L, L3)
        Linv = torch.where(ok2, Linv, Linv3)
        # ok implies ok2: an accepted first rung is kept as it is
        n_ok, n_ok2 = ok.sum(), ok2.sum()
        return L, Linv, torch.stack([n_ok, n_ok2 - n_ok,
                                     ok2.numel() - n_ok2])

    def refresh_cache(self, params: MVGPParams, data: MVGPData) -> MVGPCache:
        """Factor the masked Gram (`factor_ladder`) and precompute
        alpha = Kb^{-1} Y and Linv = L^{-1}.  The episodes per accepted rung
        are added to `MVGP.refresh_cache.rungs`, a (3,) tensor (None until
        the first refresh), without a host sync: set it to None before a
        run and read it after, like a kernel wrapper's `launches`."""
        L, Linv, rungs = self.factor_ladder(self.masked_kb(params, data))
        seen = MVGP.refresh_cache.rungs
        MVGP.refresh_cache.rungs = rungs if seen is None \
            else seen + rungs.to(seen.device)
        Y = self.residual_Y(params, data)
        alpha = Linv.transpose(-1, -2) @ (Linv @ Y)
        return MVGPCache(L=L, alpha=alpha, Linv=Linv)

    def _kb_star(self, params: MVGPParams, data: MVGPData, Xtest):
        """Cross-covariance block (B, b, K, 1+m), masked."""
        Kxs = self.k_xx(params, Xtest, data.X)                    # (B, b, K)
        UB = (data.UH @ params.B) * data.mask[..., None]          # (B, K, 1+m)
        return Kxs[..., None] * UB[:, None]

    def fT_post(self, params, data, cache, x):
        """Posterior mean of F^T(x): (B, n, 1+m) for states x (B, n)."""
        kb = self._kb_star(params, data, x[:, None])[:, 0]        # (B, K, 1+m)
        return (params.mean_M.transpose(-1, -2)
                + cache.alpha.transpose(-1, -2) @ kb)

    def Bk_single(self, params, data, cache, x, xp):
        """Posterior row covariance Bk(x, x'): (B, 1+m, 1+m), as matmuls
        against the cached L^{-1}."""
        kb = self._kb_star(params, data, x[:, None])[:, 0]
        prior = self.k_xx_single(params, x, xp)[:, None, None] * params.B
        vb = cache.Linv @ kb
        if xp is x:
            vbp = vb
        else:
            kbp = self._kb_star(params, data, xp[:, None])[:, 0]
            vbp = cache.Linv @ kbp
        return prior - vb.transpose(-1, -2) @ vbp

    def fu_mean(self, params, data, cache, u, x):
        """Posterior mean of F(x)^T [1; u]: (B, n) for controls u (B, m)
        and states x (B, n)."""
        uh = torch.cat([torch.ones_like(u[:, :1]), u], -1)
        return (self.fT_post(params, data, cache, x) @ uh[..., None])[..., 0]

    def fu_knl(self, params, data, cache, u, x, xp):
        """cov(F(x)^T uh, F(x')^T uh) = (uh^T Bk(x, x') uh) A: (B, n, n)."""
        uh = torch.cat([torch.ones_like(u[:, :1]), u], -1)
        s = torch.einsum('bi,bij,bj->b', uh,
                         self.Bk_single(params, data, cache, x, xp), uh)
        return s[:, None, None] * params.A

    def f_mean(self, params, data, cache, x):
        """Posterior mean of f(x) = F(x)^T e0: (B, n)."""
        return self.fT_post(params, data, cache, x)[..., 0]

    def g_mean(self, params, data, cache, x):
        """Posterior mean of g(x) = F(x)^T[:, 1:]: (B, n, m)."""
        return self.fT_post(params, data, cache, x)[..., 1:]

    def f_knl(self, params, data, cache, x, xp):
        """cov(f(x), f(x')) = Bk(x, x')[0, 0] A: (B, n, n)."""
        return (self.Bk_single(params, data, cache, x, xp)[:, 0, 0, None,
                                                            None]
                * params.A)

    def covar_fu_f(self, params, data, cache, u, x, xp):
        """cov(F(x)^T uh, f(x')) = (uh^T Bk(x, x') e0) A: (B, n, n)."""
        uh = torch.cat([torch.ones_like(u[:, :1]), u], -1)
        s = (uh[:, None] @ self.Bk_single(params, data, cache, x, xp))[:, 0,
                                                                       0]
        return s[:, None, None] * params.A

    def predict_matrix(self, params, data, cache, Xtest, Xtestp=None,
                       compute_cov: bool = True):
        """The posterior of F at test states Xtest (B, b, n) (and Xtestp
        (B, b', n), by default Xtest): (meanFT (B, b, n, 1+m), A (B, n, n),
        Bk (B, b, b', 1+m, 1+m)) with cov(vec F(x_i), vec F(x'_j)) =
        Bk[i, j] kron A; without compute_cov, Bk is zero.  Solves against
        the cached factor L."""
        Xp = Xtest if Xtestp is None else Xtestp
        Bsz, b = Xtest.shape[:2]
        bp = Xp.shape[1]
        mh = 1 + self.u_dim
        kb = self._kb_star(params, data, Xtest)               # (B, b, K, 1+m)
        meanFT = (params.mean_M.transpose(-1, -2)[:, None]
                  + torch.einsum('bkn,bskj->bsnj', cache.alpha, kb))
        if not compute_cov:
            return meanFT, params.A, Xtest.new_zeros((Bsz, b, bp, mh, mh))
        kbp = kb if Xtestp is None else self._kb_star(params, data, Xp)
        prior = (self.k_xx(params, Xtest, Xp)[..., None, None]
                 * params.B[:, None, None])
        K = cache.L.shape[-1]
        rhs = kbp.transpose(1, 2).reshape(Bsz, K, bp * mh)
        sol = torch.cholesky_solve(rhs, cache.L).reshape(Bsz, K, bp, mh)
        return meanFT, params.A, prior - torch.einsum('bski,bkcj->bscij',
                                                      kb, sol)

    def predict_fullmat(self, params, data, cache, Xtest):
        """The posterior over vec F at test states Xtest (B, b, n):
        (mean (B, b (1+m) n), var (B, b (1+m) n, b (1+m) n)), ordered by
        state, then the column j of F^T, then the output i; var =
        sym(Bk) kron A."""
        meanFT, A, Bk = self.predict_matrix(params, data, cache, Xtest)
        Bsz, b = Xtest.shape[:2]
        mh = 1 + self.u_dim
        BkXX = Bk.transpose(2, 3).reshape(Bsz, b * mh, b * mh)
        BkXX = 0.5 * (BkXX + BkXX.transpose(-1, -2))
        return (meanFT.transpose(-1, -2).reshape(Bsz, -1),
                kron(BkXX, A))

    def posterior_derivatives(self, params, data, cache, x):
        """The posterior at states x (B, n) with its x-derivatives, in
        closed form from the RBF cross-covariance (the JAX package takes
        nested `jacfwd` through `fT_post` and `Bk_single`):

            fT (B, n, 1+m)            posterior mean of F^T(x)
            dfT (B, n, 1+m, n)        dfT[..., i, j, a] = d fT[i, j] / d x_a
            Bk (B, 1+m, 1+m)          Bk(x, x)
            D1 (B, n, 1+m, 1+m)       d Bk(x, x') / d x_a        at x' = x
            D2 (B, n, n, 1+m, 1+m)    d^2 Bk / d x_a d x'_b      at x' = x

        With k_i = k(x, X_i), d k_i / d x_a = -k_i (x_a - X_ia) / l_a^2,
        and Bk(x, x') = k(x, x') B - vb(x)^T vb(x'), vb = Linv kb, whose
        prior term has zero first derivative and second derivative
        outputscale delta_ab / l_a^2 at x' = x."""
        ell2 = params.lengthscale ** 2                             # (B, n)
        kx = self.k_xx(params, x[:, None], data.X)[:, 0]          # (B, K)
        UB = (data.UH @ params.B) * data.mask[..., None]          # (B, K, 1+m)
        dk = -kx[..., None] * (x[:, None, :] - data.X) / ell2[:, None]
        fT = (params.mean_M.transpose(-1, -2)
              + cache.alpha.transpose(-1, -2) @ (kx[..., None] * UB))
        dfT = torch.einsum('bki,bka,bkj->bija', cache.alpha, dk, UB)
        vb = cache.Linv @ (kx[..., None] * UB)                    # (B, K, 1+m)
        Bsz, K, mh = UB.shape
        n = x.shape[-1]
        dvb = (cache.Linv @ (dk[..., None] * UB[:, :, None]).reshape(
            Bsz, K, n * mh)).reshape(Bsz, K, n, mh)
        Bk = params.outputscale[:, None, None] * params.B \
            - vb.transpose(-1, -2) @ vb
        D1 = -torch.einsum('bkaj,bkl->bajl', dvb, vb)
        prior2 = torch.diag_embed(params.outputscale[:, None] / ell2)
        D2 = (prior2[..., None, None] * params.B[:, None, None]
              - torch.einsum('bkaj,bkcl->bacjl', dvb, dvb))
        return fT, dfT, Bk, D1, D2

    def cache_append(self, params: MVGPParams, data: MVGPData,
                     cache: MVGPCache, slot) -> MVGPCache:
        """O(K^2) prefix append of row `slot` (B,) to the posterior cache
        of the serving path: the active rows form the prefix [0, slot) and
        `data` already holds the new row.  With the masked Gram's row c
        before `slot` and its diagonal d, l21 = Linv c and l22 = sqrt(
        max(d - |l21|^2, jitter)); L's row becomes [l21, l22], Linv's
        [-(l21^T Linv) / l22, 1 / l22] (the rows past the prefix are the
        identity's), and alpha is solved against the new L.  Each appended
        row keeps the Gram nugget of its own step, so the factor tracks a
        full `refresh_cache` of the same buffer up to that drift."""
        Kb = self.masked_kb(params, data)
        batch, K = Kb.shape[0], Kb.shape[-1]
        bi = torch.arange(batch, device=Kb.device)
        before = torch.arange(K, device=Kb.device)[None] < slot[:, None]
        c = Kb[bi, slot] * before
        d = Kb[bi, slot, slot]
        l21 = (cache.Linv @ c[..., None])[..., 0]
        l22 = torch.sqrt(torch.clamp(d - torch.sum(l21 * l21, -1),
                                     min=self.jitter))
        L = cache.L.clone()
        L[bi, slot] = l21
        L[bi, slot, slot] = l22
        Linv = cache.Linv.clone()
        Linv[bi, slot] = -(l21[:, None] @ cache.Linv)[:, 0] / l22[:, None]
        Linv[bi, slot, slot] = 1.0 / l22
        alpha = torch.cholesky_solve(self.residual_Y(params, data), L)
        return MVGPCache(L=L, alpha=alpha, Linv=Linv)

    def cache_append_row(self, params: MVGPParams, data: MVGPData,
                         cache: MVGPCache, slot, write) -> MVGPCache:
        """O(K^2) prefix append of row `slot` (B,) to the posterior cache,
        applied where `write` (B,) holds: with the new Gram row c (the
        active rows before `slot`) and diagonal d (with `gram_kb`'s
        dtype-aware nugget), l21 = Linv c, l22 = sqrt(max(d - |l21|^2,
        jitter)); L's row becomes [l21, l22], Linv's row
        [-(l21^T Linv) / l22, 1 / l22], and alpha follows the rank-1 (RLS)
        block-inverse identity.  A row whose results are not finite, whose
        inverse row reaches 1e6 (f32; 1e12 f64) or whose alpha reaches 1e8
        (f32; 1e14 f64) leaves the cache as it was.  `data` must already
        hold the new row at `slot`.  Rows are written with a one-hot
        select, so nothing is read back to the host."""
        K = data.X.shape[1]
        dtype = data.X.dtype
        hot = torch.arange(K, device=slot.device)[None] == slot[:, None]
        sel = hot.to(dtype)
        x_s = torch.einsum('bk,bkn->bn', sel, data.X)
        uh_s = torch.einsum('bk,bkj->bj', sel, data.UH)
        UHB = data.UH @ params.B                                  # (B, K, 1+m)
        kx = self.k_xx(params, x_s[:, None], data.X)[:, 0]        # (B, K)
        uBu_diag = torch.sum(UHB * data.UH, -1)
        eps = torch.finfo(dtype).eps
        scale = torch.clamp(torch.mean(torch.abs(
            params.outputscale[:, None] * uBu_diag), -1), min=1.0)
        nug = self.jitter + 10.0 * K * eps * scale
        before = torch.arange(K, device=slot.device)[None] < slot[:, None]
        c = kx * (UHB @ uh_s[..., None])[..., 0] * data.mask * before
        d = params.outputscale * torch.einsum(
            'bi,bij,bj->b', uh_s, params.B, uh_s) + nug
        l21 = (cache.Linv @ c[..., None])[..., 0]
        s2 = torch.clamp(d - torch.sum(l21 * l21, -1), min=self.jitter)
        l22 = torch.sqrt(s2)
        w = (l21[:, None] @ cache.Linv)[:, 0]                    # (B, K)
        inv_row = -w / l22[:, None]
        lim = 1e6 if dtype == torch.float32 else 1e12
        alim = 1e8 if dtype == torch.float32 else 1e14
        Y = self.residual_Y(params, data)
        y_s = torch.einsum('bk,bkn->bn', sel, Y)
        gain = ((c[:, None] @ cache.alpha)[:, 0] - y_s) / s2[:, None]
        alpha_cand = torch.where(hot[..., None], -gain[:, None],
                                 cache.alpha + w[..., None] * gain[:, None])
        ok = (torch.isfinite(l21).all(-1) & torch.isfinite(l22)
              & (torch.amax(torch.abs(inv_row), -1) < lim)
              & torch.isfinite(alpha_cand).all(-1).all(-1)
              & (torch.amax(torch.abs(alpha_cand), (-2, -1)) < alim))
        wr = ok & write
        row = (hot & wr[:, None])[..., None]                      # (B, K, 1)
        L = torch.where(row, torch.where(hot, l22[:, None], l21)[:, None],
                        cache.L)
        Linv = torch.where(row, torch.where(hot, 1.0 / l22[:, None],
                                            inv_row)[:, None], cache.Linv)
        alpha = torch.where(wr[:, None, None], alpha_cand, cache.alpha)
        return MVGPCache(L=L, alpha=alpha, Linv=Linv)


MVGP.refresh_cache.rungs = None


def make_mvgp(x_dim: int, u_dim: int, **kw) -> MVGP:
    """Full-rank task factors (rank_A = n, rank_B = 1 + m)."""
    return MVGP(x_dim, u_dim, rank_A=x_dim, rank_B=1 + u_dim, **kw)


def make_mvgp_rank1(x_dim: int, u_dim: int, **kw) -> MVGP:
    """Rank-1 task factors + near-flat Gamma lengthscale prior."""
    kw.setdefault("gamma_prior", (1e-3, 1e-3))
    return MVGP(x_dim, u_dim, rank_A=1, rank_B=1, **kw)


def make_mvgp_diag(x_dim: int, u_dim: int, **kw) -> MVGP:
    """Diagonal task covariances (rank_A = rank_B = 0)."""
    return MVGP(x_dim, u_dim, rank_A=0, rank_B=0, **kw)
