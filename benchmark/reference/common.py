"""Plain building blocks of the reference: the precision a computation
runs in, the matrix-variate GP learner (kernel, marginal likelihood, the
fits' Adam, the posterior cache and moments), the small Cholesky ladder,
and the batched interior-point SOCP solve.

Written from the published method (Dhiman et al., Bayesian CBF, and the
`Bayesian_CBF` reference code) in plain PyTorch. Nothing here imports
the program under test: the benchmark hands this module the same inputs
it hands the program, and this module works everything out again.

Every constant of the semantics that depends on the configuration's
number type (the Gram nugget's machine epsilon, the inverse-factor
sanity limit, the solver's feasibility gate) is taken from the
configuration's stated type, `Precision.stated`, whatever type the
arithmetic runs in.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

_LOG2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """a (float32) rounded to TF32's 10-bit mantissa, to nearest: what a
    TF32 tensor-core product reads of each operand.  The gradient passes
    through unchanged."""
    bits = a.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return a + (r - a).detach() if a.requires_grad else r


class Precision:
    """How the reference computes: "f64" (the judge), "f32" (plain
    float32, TF32 off) or "tf32" (float32 whose matrix products read
    their operands in TF32: the control one step below float32).

    stated: the configuration's number type, which fixes the semantics'
    constants (`eps`, `linv_limit`, `feas_tol`)."""

    def __init__(self, name: str, stated: torch.dtype = torch.float32):
        if name not in ("f64", "f32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32
        self.stated = stated

    @property
    def eps(self) -> float:
        return torch.finfo(self.stated).eps

    @property
    def linv_limit(self) -> float:
        return 1e6 if self.stated == torch.float32 else 1e12

    @property
    def leaf_limit(self) -> float:
        return 1e8 if self.stated == torch.float32 else 1e14

    def feas_tol(self, tol: float) -> float:
        return max(tol, 5e-3) if self.stated == torch.float32 else tol

    def ein(self, eq: str, *ops):
        """einsum, its operands read in TF32 under "tf32"."""
        if self.name == "tf32":
            ops = [round_tf32(o) for o in ops]
        return torch.einsum(eq, *ops)

    def mm(self, a, b):
        """a @ b, its operands read in TF32 under "tf32"."""
        if self.name == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    def cast(self, a):
        return a.to(self.dtype)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: float) -> float:
    return float(math.log(math.expm1(y))) if y < 20 else float(y)


# ---------------------------------------------------------------------------
# small factors
# ---------------------------------------------------------------------------

def chol_ladder(K, init_jitter: float, num_tries: int = 8,
                growth: float = 10.0):
    """Lower factor of sym(K) + j s I (s = max(1, mean |diag K|)) for the
    first j of [0, init_jitter growth^r, r < num_tries] whose factor has
    positive pivots; the last rung is taken unconditionally."""
    K = 0.5 * (K + K.transpose(-1, -2))
    n = K.shape[-1]
    scale = torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1).abs().mean(-1),
                        min=1.0)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    jits = [0.0] + [init_jitter * growth ** r for r in range(num_tries)]
    out = torch.zeros_like(K)
    done = torch.zeros(K.shape[:-2], dtype=torch.bool, device=K.device)
    for i, j in enumerate(jits):
        L, info = torch.linalg.cholesky_ex(
            K + (j * scale)[..., None, None] * eye)
        take = ~done & ((info == 0) | (i == len(jits) - 1))
        out = torch.where(take[..., None, None], torch.nan_to_num(L), out)
        done = done | take
    return out


# ---------------------------------------------------------------------------
# the matrix-variate GP learner
# ---------------------------------------------------------------------------

class GPParams(NamedTuple):
    """Raw hyperparameters, each (E, ...) over episodes: l = softplus(
    raw_ls), sigma^2 = softplus(raw_os), A = W_A W_A^T + diag softplus(
    raw_vA), B likewise, M the prior mean of F (1+m, n)."""
    raw_ls: torch.Tensor
    raw_os: torch.Tensor
    W_A: torch.Tensor
    raw_vA: torch.Tensor
    W_B: torch.Tensor
    raw_vB: torch.Tensor
    mean_M: torch.Tensor

    def lengthscale(self):
        return softplus(self.raw_ls)

    def outputscale(self):
        return softplus(self.raw_os)

    def A(self, P: Precision):
        return (P.mm(self.W_A, self.W_A.transpose(-1, -2))
                + torch.diag_embed(softplus(self.raw_vA)))

    def B(self, P: Precision):
        return (P.mm(self.W_B, self.W_B.transpose(-1, -2))
                + torch.diag_embed(softplus(self.raw_vB)))


class GPData(NamedTuple):
    """A fixed-capacity training set (E, K, ...) with a validity mask."""
    X: torch.Tensor      # (E, K, n) kernel inputs
    UH: torch.Tensor     # (E, K, 1+m) [1, u]
    Y: torch.Tensor      # (E, K, n) observed residual derivatives
    mask: torch.Tensor   # (E, K)


class GPLearner(NamedTuple):
    """Static description: kernel jitter and the Gamma prior on the
    lengthscales (None: none)."""
    jitter: float = 1e-6
    gamma_prior: tuple = None

    def k_xx(self, p: GPParams, X1, X2):
        ell = p.lengthscale()[:, None, None, :]
        d = (X1[:, :, None, :] - X2[:, None, :, :]) / ell
        return p.outputscale()[:, None, None] * torch.exp(
            -0.5 * (d * d).sum(-1))

    def masked_gram(self, p: GPParams, data: GPData, P: Precision):
        """k(X, X) o (UH B UH^T) + nugget I on the valid rows, the identity
        on the others; nugget = jitter + 10 K eps max(1, mean |diag|)."""
        Kb = self.k_xx(p, data.X, data.X) * P.mm(
            P.mm(data.UH, p.B(P)), data.UH.transpose(-1, -2))
        k = Kb.shape[-1]
        scale = torch.clamp(torch.diagonal(Kb, dim1=-2, dim2=-1).abs()
                            .mean(-1), min=1.0)
        nug = self.jitter + 10.0 * k * P.eps * scale
        eye = torch.eye(k, dtype=Kb.dtype, device=Kb.device)
        m = data.mask
        return ((Kb + nug[:, None, None] * eye) * (m[:, :, None]
                                                   * m[:, None, :])
                + eye * (1.0 - m)[:, :, None])

    def residual(self, p: GPParams, data: GPData, P: Precision):
        return (data.Y - P.mm(data.UH, p.mean_M)) * data.mask[..., None]

    def neg_mll(self, p: GPParams, data: GPData, P: Precision):
        """Negative matrix-normal log marginal likelihood per scalar
        observation (E,), with the Gamma prior on the lengthscales."""
        n = data.X.shape[-1]
        kcnt = data.mask.sum(-1)
        Y = self.residual(p, data, P)
        # a Gram that is not positive definite in this precision gives a
        # non-finite loss, and the fit rejects that episode's step
        L, info = torch.linalg.cholesky_ex(self.masked_gram(p, data, P))
        L = torch.where((info == 0)[:, None, None], L, torch.nan)
        S = torch.cholesky_solve(Y, L)
        logdet_K = 2.0 * torch.log(torch.diagonal(L, dim1=-2,
                                                  dim2=-1)).sum(-1)
        LA = chol_ladder(p.A(P), self.jitter)
        G = P.mm(Y.transpose(-1, -2), S)
        quad = torch.diagonal(torch.cholesky_solve(G, LA), dim1=-2,
                              dim2=-1).sum(-1)
        logdet_A = 2.0 * torch.log(torch.clamp(
            torch.diagonal(LA, dim1=-2, dim2=-1), min=1e-20)).sum(-1)
        ll = -0.5 * (quad + n * logdet_K + kcnt * logdet_A
                     + kcnt * n * _LOG2PI)
        if self.gamma_prior is not None:
            conc, rate = self.gamma_prior
            ell = p.lengthscale()
            ll = ll + ((conc - 1.0) * torch.log(ell) - rate * ell).sum(-1)
        return -ll / torch.clamp(kcnt * n, min=1.0)

    def fit(self, p: GPParams, data: GPData, iters: int, P: Precision,
            lr: float = 0.1) -> GPParams:
        """Adam on the negative MLL per episode: learning rate lr, x0.1 at
        30 / 60 / 80 / 90% of the budget, parameters clipped to +-60, and
        an episode's step rejected (its Adam state kept) where the loss,
        a gradient or a new parameter is not finite."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        cuts = sorted({int(f * iters) for f in (0.3, 0.6, 0.8, 0.9)})
        leaves = [a.detach().clone() for a in p]
        mu = [torch.zeros_like(a) for a in leaves]
        nu = [torch.zeros_like(a) for a in leaves]
        E = leaves[0].shape[0]
        count = torch.zeros(E, dtype=torch.int64, device=leaves[0].device)

        def ep(v, a):
            return v.reshape((E,) + (1,) * (a.ndim - 1))

        for _ in range(iters):
            req = [a.clone().requires_grad_(True) for a in leaves]
            with torch.enable_grad():
                loss = self.neg_mll(GPParams(*req), data, P)
                grads = torch.autograd.grad(loss.sum(), req)
            c1 = (count + 1).to(leaves[0].dtype)
            lr_e = torch.full((E,), lr, dtype=leaves[0].dtype,
                              device=leaves[0].device)
            for cut in cuts:
                lr_e = torch.where(count >= cut, 0.1 * lr_e, lr_e)
            ok = torch.isfinite(loss.detach())
            new = []
            for a, g, m_, v_ in zip(leaves, grads, mu, nu):
                m_n = b1 * m_ + (1 - b1) * g
                v_n = b2 * v_ + (1 - b2) * g * g
                mh = m_n / ep(1 - b1 ** c1, m_n)
                vh = v_n / ep(1 - b2 ** c1, v_n)
                a_n = torch.clamp(a - ep(lr_e, a) * mh / (torch.sqrt(vh)
                                                          + eps),
                                  -60.0, 60.0)
                ok = (ok & torch.isfinite(g).reshape(E, -1).all(-1)
                      & torch.isfinite(a_n).reshape(E, -1).all(-1))
                new.append((a_n, m_n, v_n))
            leaves = [torch.where(ep(ok, a), a_n, a)
                      for a, (a_n, _, _) in zip(leaves, new)]
            mu = [torch.where(ep(ok, m_), m_n, m_)
                  for m_, (_, m_n, _) in zip(mu, new)]
            nu = [torch.where(ep(ok, v_), v_n, v_)
                  for v_, (_, _, v_n) in zip(nu, new)]
            count = torch.where(ok, count + 1, count)
        return GPParams(*leaves)

    def cache(self, p: GPParams, data: GPData, P: Precision):
        """(Linv, alpha) of the masked Gram: a factor L accepted on the
        first rung of (K, + 1e-5 s, + 1e-2 s more) whose L and L^-1 are
        finite and max |L^-1| below the stated type's limit; alpha =
        K^-1 Y."""
        K = self.masked_gram(p, data, P)
        k = K.shape[-1]
        eye = torch.eye(k, dtype=K.dtype, device=K.device)
        scale = torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1).abs()
                            .mean(-1), min=1.0)[:, None, None]
        out = None
        done = torch.zeros(K.shape[0], dtype=torch.bool, device=K.device)
        bump = torch.zeros_like(scale)
        for step in (0.0, 1e-5, 1e-2):
            bump = bump + torch.where(done[:, None, None],
                                      torch.zeros_like(scale), step * scale)
            L, _ = torch.linalg.cholesky_ex(K + bump * eye)
            Linv = torch.linalg.solve_triangular(L, eye.expand_as(L),
                                                 upper=False)
            sane = (torch.isfinite(L).flatten(1).all(-1)
                    & torch.isfinite(Linv).flatten(1).all(-1)
                    & (Linv.abs().flatten(1).amax(-1) < P.linv_limit))
            take = ~done & (sane | (step == 1e-2))
            out = Linv if out is None else torch.where(
                take[:, None, None], Linv, out)
            done = done | take
        Y = self.residual(p, data, P)
        alpha = P.mm(out.transpose(-1, -2), P.mm(out, Y))
        return out, alpha

    def derivatives(self, p: GPParams, data: GPData, Linv, alpha, x,
                    P: Precision):
        """The posterior and its x-derivatives at states x (E, S, n), S
        states of each episode, in closed form from the RBF kernel:
        fT (E, S, n, 1+m) the mean of F^T, dfT (E, S, n, 1+m, n) its
        derivative (last axis: x_a), Bk (E, S, 1+m, 1+m) = Bk(x, x), D1
        (E, S, n, 1+m, 1+m) = d Bk(x, x') / d x_a and D2 (E, S, n, n, 1+m,
        1+m) = d^2 Bk / d x_a d x'_c, both at x' = x."""
        ell2 = p.lengthscale() ** 2                              # (E, n)
        os_ = p.outputscale()
        B = p.B(P)
        diff = x[:, :, None, :] - data.X[:, None]                # (E, S, K, n)
        kx = os_[:, None, None] * torch.exp(
            -0.5 * (diff * diff / ell2[:, None, None]).sum(-1))  # (E, S, K)
        UB = P.mm(data.UH, B) * data.mask[..., None]             # (E, K, 1+m)
        dk = -kx[..., None] * diff / ell2[:, None, None]         # (E, S, K, n)
        kb = kx[..., None] * UB[:, None]                       # (E, S, K, 1+m)
        fT = p.mean_M.transpose(-1, -2)[:, None] + P.ein(
            'eki,eskj->esij', alpha, kb)
        dfT = P.ein('eki,eska,ekj->esija', alpha, dk, UB)
        vb = P.ein('ekl,eslj->eskj', Linv, kb)
        dvb = P.ein('ekl,esla,elj->eskaj', Linv, dk, UB)
        Bk = (os_[:, None, None, None] * B[:, None]
              - P.ein('eskj,eskl->esjl', vb, vb))
        D1 = -P.ein('eskaj,eskl->esajl', dvb, vb)
        prior2 = torch.diag_embed(os_[:, None] / ell2)           # (E, n, n)
        D2 = (prior2[:, None, :, :, None, None] * B[:, None, None, None]
              - P.ein('eskaj,eskcl->esacjl', dvb, dvb))
        return fT, dfT, Bk, D1, D2

    def moments(self, p: GPParams, data: GPData, Linv, alpha, xs,
                P: Precision):
        """Posterior of the residual at kernel inputs xs (E, n): (mean of
        F^T (E, n, 1+m), row covariance Bk (E, 1+m, 1+m))."""
        B = p.B(P)
        kx = self.k_xx(p, xs[:, None], data.X)[:, 0]            # (E, K)
        UB = P.mm(data.UH, B) * data.mask[..., None]           # (E, K, 1+m)
        kb = kx[..., None] * UB
        fT = p.mean_M.transpose(-1, -2) + P.mm(alpha.transpose(-1, -2), kb)
        vb = P.mm(Linv, kb)
        Bk = p.outputscale()[:, None, None] * B - P.mm(vb.transpose(-1, -2),
                                                       vb)
        return fT, Bk


def reservoir(X, U, draws, upto: int, K: int, P: Precision, resid_fn,
              inputs_fn):
    """The training set after the records of steps 0..upto, rebuilt from
    recorded states X (E, T, n), controls U (E, T, m) and reservoir
    uniforms draws (T, E): at step t >= 1 the pair of step t - 1 is
    offered, with kernel input inputs_fn(x_{t-1}) and observation
    resid_fn(x_{t-1}, u_{t-1}, x_t); it takes row `count` while the
    reservoir fills, else row j = floor(r (count + 1)) if j < K, where
    count is the number of pairs taken so far and r the step's uniform
    (the slot worked out in the configuration's number type)."""
    E, _, n = X.shape
    m = U.shape[-1]
    Xs, Us, Ys, Ms = empty_data(E, K, n, m + 1, P.dtype, X.device)
    count = torch.zeros(E, dtype=torch.int64, device=X.device)
    rows = torch.arange(K, device=X.device)
    xp, up = X[:, :upto], U[:, :upto]
    res = resid_fn(xp, up, X[:, 1:upto + 1])
    xs = inputs_fn(xp)
    uh = torch.cat([torch.ones_like(up[..., :1]), up], -1)
    r_all = draws.to(P.stated)
    for t in range(1, upto + 1):
        hi = (count + 1).to(P.stated)
        j = torch.minimum(torch.floor(r_all[t] * hi).to(torch.int64), count)
        slot = torch.where(count < K, count, j)
        take = (count < K) | (j < K)
        hit = (rows[None] == slot[:, None]) & take[:, None]        # (E, K)
        h = hit[..., None]
        Xs = torch.where(h, xs[:, t - 1, None], Xs)
        Us = torch.where(h, uh[:, t - 1, None], Us)
        Ys = torch.where(h, res[:, t - 1, None], Ys)
        Ms = torch.where(hit, torch.ones_like(Ms), Ms)
        count = count + take.to(count.dtype)
    return GPData(X=Xs, UH=Us, Y=Ys, mask=Ms)


def empty_cache(E, K, n, dtype, device):
    """(Linv, alpha) of an empty training set: the identity and zeros."""
    return (torch.eye(K, dtype=dtype, device=device).expand(E, K, K),
            torch.zeros((E, K, n), dtype=dtype, device=device))


def fit_steps(cfg):
    """The steps after which the learner refits: positive multiples of
    train_every_n_steps before the last step."""
    te = cfg["train_every_n_steps"]
    if not cfg["enable_learning"] or te <= 0:
        return []
    return list(range(te, cfg["numSteps"], te))


def refit(learner: GPLearner, p, buf, iters, P: Precision, old):
    """Adam on the reservoir, then the posterior cache; an episode whose
    hyperparameters or cache are not finite (or beyond the stated type's
    sane magnitude) keeps `old` = (params, data, Linv, alpha)."""
    new_p = learner.fit(p, buf, iters, P)
    Linv, alpha = learner.cache(new_p, buf, P)
    ok = finite_leaves(tuple(new_p) + (Linv, alpha), P.leaf_limit)
    E = ok.shape[0]
    keep = lambda a, b: torch.where(ok.reshape((E,) + (1,) * (a.ndim - 1)),
                                    a, b)
    return (GPParams(*(keep(a, b) for a, b in zip(new_p, old[0]))),
            GPData(*(keep(a, b) for a, b in zip(buf, old[1]))),
            keep(Linv, old[2]), keep(alpha, old[3]))


def empty_data(E, K, n, mh, dtype, device):
    z = lambda *s: torch.zeros((E, K) + s, dtype=dtype, device=device)
    return GPData(X=z(n), UH=z(mh), Y=z(n), mask=z())


def finite_leaves(tree, limit) -> torch.Tensor:
    """(E,) every leaf finite and below `limit` in magnitude."""
    ok = None
    for a in tree:
        flat = a.reshape(a.shape[0], -1)
        good = torch.isfinite(flat).all(-1) & (flat.abs().amax(-1) < limit)
        ok = good if ok is None else ok & good
    return ok


# ---------------------------------------------------------------------------
# the SOCP solve
# ---------------------------------------------------------------------------

_EPS = 1e-14
_BIG = 1e10


def _jdot(U):
    return U[..., 0] ** 2 - (U[..., 1:] ** 2).sum(-1)


def _jflip(U):
    return torch.cat([U[..., :1], -U[..., 1:]], -1)


def _jmul(U, V):
    head = (U * V).sum(-1, keepdim=True)
    return torch.cat([head, U[..., :1] * V[..., 1:] + V[..., :1] * U[..., 1:]],
                     -1)


def _jinv_mul(L, V):
    det = _jdot(L)
    det = torch.where(det.abs() < _EPS, torch.full_like(det, _EPS), det)
    L0 = L[..., 0]
    l0 = torch.where(L0.abs() < _EPS, torch.full_like(L0, _EPS), L0)
    u0 = (L0 * V[..., 0] - (L[..., 1:] * V[..., 1:]).sum(-1)) / det
    u1 = (V[..., 1:] - u0[..., None] * L[..., 1:]) / l0[..., None]
    return torch.cat([u0[..., None], u1], -1)


def _nt(S, Z):
    ss = torch.sqrt(torch.clamp(_jdot(S), min=_EPS))
    zz = torch.sqrt(torch.clamp(_jdot(Z), min=_EPS))
    Sb, Zb = S / ss[..., None], Z / zz[..., None]
    gam = torch.sqrt(torch.clamp((1.0 + (Sb * Zb).sum(-1)) * 0.5, min=_EPS))
    return (Sb + _jflip(Zb)) / (2.0 * gam[..., None]), torch.sqrt(ss / zz)


def _w(Wb, eta, V):
    w0, w1 = Wb[..., :1], Wb[..., 1:]
    dot = (w1 * V[..., 1:]).sum(-1, keepdim=True)
    return eta[..., None] * torch.cat(
        [w0 * V[..., :1] + dot,
         V[..., :1] * w1 + V[..., 1:] + w1 * (dot / (1.0 + w0))], -1)


def _winv(Wb, eta, V):
    return _jflip(_w(Wb, torch.ones_like(eta), _jflip(V))) / eta[..., None]


def _winv2(Wb, eta, V):
    Jw = _jflip(Wb)
    return (2.0 * Jw * (Jw * V).sum(-1, keepdim=True) - _jflip(V)) \
        / (eta ** 2)[..., None]


def _max_step(P_, D):
    a = _jdot(D)
    b = 2.0 * (P_[..., 0] * D[..., 0] - (P_[..., 1:] * D[..., 1:]).sum(-1))
    cq = torch.clamp(_jdot(P_), min=_EPS)
    disc = b * b - 4.0 * a * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    big = torch.full_like(a, _BIG)
    den = torch.where(a.abs() > _EPS, 2.0 * a, torch.full_like(a, _EPS))
    r1, r2 = (-b - sq) / den, (-b + sq) / den
    lo, hi = torch.minimum(r1, r2), torch.maximum(r1, r2)
    root = torch.where(lo > 0, lo, torch.where(hi > 0, hi, big))
    lin = torch.where(b < 0, -cq / torch.where(b < 0, b, -torch.ones_like(b)),
                      big)
    tq = torch.where(a.abs() > _EPS, torch.where(disc > 0, root, big), lin)
    D0 = D[..., 0]
    th = torch.where(D0 < 0, -P_[..., 0] / torch.where(
        D0 < 0, D0, -torch.ones_like(D0)), big)
    return torch.clamp(torch.minimum(tq, th), 0.0, _BIG)


class SOCPResult(NamedTuple):
    x: torch.Tensor      # (N, nx)
    pres: torch.Tensor   # (N,) |G x + s - h| / max(1, |h|)


def solve_socp(c, Gp, hp, iters: int, P: Precision, tol: float = 1e-10
               ) -> SOCPResult:
    """Batched min c^T x s.t. G x + s = h, s in a product of C second-order
    cones of dimension d (padded blocks Gp (N, C, d, nx), hp (N, C, d)),
    by `iters` Mehrotra predictor-corrector iterations with Nesterov-Todd
    scaling from the cold start x = 0, s = z = e; the iterate with the
    best scale-relative KKT score is returned.  A problem whose score is
    below tol stops moving."""
    N, C, d, nx = Gp.shape
    c = c.expand(N, nx)
    nu = float(C)
    e = torch.zeros((N, C, d), dtype=Gp.dtype, device=Gp.device)
    e[..., 0] = 1.0
    eye = torch.eye(nx, dtype=Gp.dtype, device=Gp.device)
    hnorm = torch.clamp(torch.linalg.vector_norm(hp, dim=(-2, -1)), min=1.0)
    cnorm = torch.clamp(torch.linalg.vector_norm(c, dim=-1), min=1.0)
    Gx = lambda x: P.ein('bcdn,bn->bcd', Gp, x)
    GtZ = lambda Z: P.ein('bcdn,bcd->bn', Gp, Z)

    def score(x, S, Z):
        return torch.maximum(torch.maximum(
            torch.linalg.vector_norm(Gx(x) + S - hp, dim=(-2, -1)) / hnorm,
            torch.linalg.vector_norm(c + GtZ(Z), dim=-1) / cnorm),
            torch.abs((S * Z).sum((-2, -1))) / nu)

    def sel(m, a, b):
        return torch.where(m.reshape(m.shape + (1,) * (a.ndim - 1)), a, b)

    x = torch.zeros((N, nx), dtype=Gp.dtype, device=Gp.device)
    S, Z = e, e
    bx, bS, bZ = x, e, e
    best = torch.full((N,), float("inf"), dtype=Gp.dtype, device=Gp.device)
    for _ in range(iters):
        sc = score(x, S, Z)
        better = sc < best
        bx, bS, bZ = sel(better, x, bx), sel(better, S, bS), sel(better, Z, bZ)
        best = torch.minimum(sc, best)
        done = sc < tol
        rx = c + GtZ(Z)
        rz = Gx(x) + S - hp
        mu = (S * Z).sum((-2, -1)) / nu
        Wb, eta = _nt(S, Z)
        lam = _w(Wb, eta, Z)
        Jw = _jflip(Wb)
        dots = P.ein('bcd,bcdn->bcn', Jw, Gp)
        JG = torch.cat([Gp[..., :1, :], -Gp[..., 1:, :]], -2)
        W2G = ((2.0 * Jw[..., None] * dots[..., None, :] - JG)
               / (eta ** 2)[..., None, None])
        H = P.ein('bcdn,bcdm->bnm', Gp, W2G)
        H = H + 1e-12 * torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)[
            :, None, None] * eye
        LH = _chol_clamped(H)

        def kkt(D):
            rcd = rz - _w(Wb, eta, D)
            rhs = -rx - GtZ(_winv2(Wb, eta, rcd))
            dx = torch.cholesky_solve(rhs[..., None], LH)[..., 0]
            Gdx = Gx(dx)
            return dx, -rz - Gdx, _winv2(Wb, eta, Gdx + rcd)

        dxa, dSa, dZa = kkt(lam)
        aa = torch.clamp(torch.minimum(_max_step(S, dSa).amin(-1),
                                       _max_step(Z, dZa).amin(-1)), max=1.0)
        mua = ((S + aa[:, None, None] * dSa) * (Z + aa[:, None, None] * dZa)
               ).sum((-2, -1)) / nu
        sigma = torch.clamp((mua / torch.clamp(mu, min=_EPS)) ** 3, 0.0, 1.0)
        corr = _jmul(_winv(Wb, eta, dSa), _w(Wb, eta, dZa))
        rs = _jmul(lam, lam) + corr - (sigma * mu)[:, None, None] * e
        dx, dS, dZ = kkt(_jinv_mul(lam, rs))
        al = torch.clamp(0.99 * torch.minimum(_max_step(S, dS).amin(-1),
                                              _max_step(Z, dZ).amin(-1)),
                         max=1.0)
        xn = x + al[:, None] * dx
        Sn = S + al[:, None, None] * dS
        Zn = Z + al[:, None, None] * dZ
        fin = (torch.isfinite(xn).all(-1) & torch.isfinite(Sn).all((-2, -1))
               & torch.isfinite(Zn).all((-2, -1)))
        keep = done | ~fin
        x, S, Z = sel(keep, x, xn), sel(keep, S, Sn), sel(keep, Z, Zn)
    sc = score(x, S, Z)
    better = sc < best
    x, S = sel(better, x, bx), sel(better, S, bS)
    pres = torch.linalg.vector_norm(Gx(x) + S - hp, dim=(-2, -1)) / hnorm
    return SOCPResult(x=x, pres=pres)


def _chol_clamped(H):
    """Cholesky factor of small SPD H with each pivot clamped at _EPS
    before its square root (never NaN)."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = H[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = (torch.sqrt(torch.clamp(acc, min=_EPS)) if i == j
                       else acc / L[j][j])
    zero = torch.zeros_like(H[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(n)], -1)
                        for i in range(n)], -2)


def pad_cones(rows_G, rows_h, dims):
    """Cone blocks (lists of (N, d_i, nx) / (N, d_i)) zero-padded to the
    largest d: (N, C, d, nx), (N, C, d)."""
    d = max(dims)
    Gs, hs = [], []
    for G, h, di in zip(rows_G, rows_h, dims):
        if di < d:
            G = torch.cat([G, G.new_zeros((G.shape[0], d - di, G.shape[2]))],
                          1)
            h = torch.cat([h, h.new_zeros((h.shape[0], d - di))], 1)
        Gs.append(G)
        hs.append(h)
    return torch.stack(Gs, 1), torch.stack(hs, 1)
