"""Control-affine dynamics: the unicycle (cartesian and polar), Ackermann
and pendulum ground truths, the zero prior mean, and the online-learned
residual MVGP with shift invariance, batched over episodes.  The state of
the learner is a NamedTuple of tensors with a leading episode axis.

The GP expressions of the dynamics (`fu_func_gp`, `f_gp_and_fu_gp`) are
leaves of `gp.algebra` at one state x (n,) and one control u (m,); the
learner's take one episode's state, its leaves without the episode axis
(what `torch.func.vmap` over a batched state hands its function).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..gp.algebra import DeterministicGP, LeafGP
from ..utils.func import normalize_radians
from ..utils.linalg import kron
from .mvgp import MVGP, MVGPCache, MVGPData, MVGPParams


def _tree_finite(tree) -> torch.Tensor:
    """(B,) bool: every floating leaf is finite and of sane magnitude
    (max|a| < 1e8 in f32, 1e14 in f64) in each episode."""
    ok = None
    for leaf in _leaves(tree):
        if not torch.is_floating_point(leaf):
            continue
        lim = 1e8 if leaf.dtype == torch.float32 else 1e14
        flat = leaf.reshape(leaf.shape[0], -1)
        good = (torch.isfinite(flat).all(-1)
                & (torch.amax(torch.abs(flat), -1) < lim))
        ok = good if ok is None else ok & good
    return ok


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for t in tree:
        out.extend(_leaves(t))
    return out


def _map(fn, *trees):
    """Apply fn leafwise over NamedTuples / tuples of tensors."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    vals = [_map(fn, *parts) for parts in zip(*trees)]
    return type(t0)(*vals) if hasattr(t0, "_fields") else type(t0)(vals)


def _unit(tree):
    """tree with a unit episode axis in front of every leaf."""
    return _map(lambda a: a[None], tree)


def _fu_at(model, x, u):
    """f(x) + g(x) u of a batch-first model at one state x (n,) and
    control u (m,)."""
    xb = x[None]
    return model.f_func(xb)[0] + model.g_func(xb)[0] @ u


def _unit_gain_gp(model, u, name):
    """The Fu leaf of a known model: mean f(x) + g(x) u, covariance
    (u^T u + 1) I, independent of every other leaf."""
    n = model.state_size
    return LeafGP(
        mean=lambda x: _fu_at(model, x, u),
        knl=lambda x, xp: (u @ u + 1.0) * torch.eye(n, dtype=u.dtype,
                                                    device=u.device),
        dim=n, assume_independence=True, name=name)


def where_tree(keep: torch.Tensor, a_tree, b_tree):
    """Per-episode select over batched trees (keep: (B,) bool)."""
    def sel(a, b):
        return torch.where(keep.reshape(keep.shape + (1,) * (a.ndim - 1)),
                           a, b)
    return _map(sel, a_tree, b_tree)


def _write_row(data: MVGPData, hit, x, uh, xdot) -> MVGPData:
    """data with row k of episode b replaced by (x, uh, xdot, 1) where
    hit (B, K) holds."""
    h = hit[..., None]
    return MVGPData(X=torch.where(h, x[:, None], data.X),
                    UH=torch.where(h, uh[:, None], data.UH),
                    Xdot=torch.where(h, xdot[:, None], data.Xdot),
                    mask=torch.where(hit, torch.ones_like(data.mask),
                                     data.mask))


class CartesianDynamics(NamedTuple):
    """Unicycle: xdot = [v cos th, v sin th, omega], u = [v, omega];
    f = 0."""
    state_size: int = 3
    ctrl_size: int = 2

    def f_func(self, x):
        return torch.zeros_like(x)

    def g_func(self, x):
        th = x[:, 2]
        z, o = torch.zeros_like(th), torch.ones_like(th)
        return torch.stack([torch.stack([torch.cos(th), z], -1),
                            torch.stack([torch.sin(th), z], -1),
                            torch.stack([z, o], -1)], -2)

    def F_func(self, x):
        return torch.cat([self.f_func(x)[..., None], self.g_func(x)], -1)

    def fu_func_gp(self, u):
        return _unit_gain_gp(self, u, "CartesianDynamics")

    def step(self, x, u, dt):
        xdot = self.f_func(x) + (self.g_func(x) @ u[..., None])[..., 0]
        return x + xdot * dt, xdot


class PolarDynamics(NamedTuple):
    """The unicycle in polar coordinates about its goal, x = (rho, alpha,
    beta): rho_dot = -v cos alpha, alpha_dot = -v sin alpha / rho + omega,
    beta_dot = -v sin alpha / rho; f = 0.  The 1 / rho grows without bound
    at the goal: a caller that drives rho to 0 gets an infinite g there."""
    state_size: int = 3
    ctrl_size: int = 2

    def f_func(self, x):
        return torch.zeros_like(x)

    def g_func(self, x):
        rho, alpha = x[:, 0], x[:, 1]
        z, o = torch.zeros_like(rho), torch.ones_like(rho)
        sr = -torch.sin(alpha) / rho
        return torch.stack([torch.stack([-torch.cos(alpha), z], -1),
                            torch.stack([sr, o], -1),
                            torch.stack([sr, z], -1)], -2)

    def step(self, x, u, dt):
        xdot = self.f_func(x) + (self.g_func(x) @ u[..., None])[..., 0]
        return x + xdot * dt, xdot


class AckermannDrive(NamedTuple):
    """Ackermann car with wheelbase L: xdot = [v cos th, v sin th, w / L],
    u = [v, w]; f = 0.  `kernel_diag_A` is the prior output covariance."""
    L: float = 0.2
    kernel_diag_A: Tuple[float, ...] = (1.0, 1.0, 1.0)
    state_size: int = 3
    ctrl_size: int = 2

    def f_func(self, x):
        return torch.zeros_like(x)

    def g_func(self, x):
        th = x[:, 2]
        z = torch.zeros_like(th)
        inv_l = torch.full_like(th, 1.0 / self.L)
        return torch.stack([torch.stack([torch.cos(th), z], -1),
                            torch.stack([torch.sin(th), z], -1),
                            torch.stack([z, inv_l], -1)], -2)

    def F_func(self, x):
        return torch.cat([self.f_func(x)[..., None], self.g_func(x)], -1)

    def F_jac(self, x):
        """d F[i, j] / d x_a: (B, n, 1+m, n); only theta enters F."""
        J = x.new_zeros((x.shape[0], 3, 3, 3))
        th = x[:, 2]
        J[:, 0, 1, 2] = -torch.sin(th)
        J[:, 1, 1, 2] = torch.cos(th)
        return J

    def fu_func_gp(self, u):
        """The prior Fu leaf: mean f(x) + g(x) u, covariance
        (uh^T uh) diag(kernel_diag_A), uh = [1; u]."""
        A = torch.diag(torch.tensor(self.kernel_diag_A, dtype=u.dtype,
                                    device=u.device))
        uh = torch.cat([torch.ones_like(u[:1]), u])
        return LeafGP(mean=lambda x: _fu_at(self, x, u),
                      knl=lambda x, xp: (uh @ uh) * A, dim=self.state_size,
                      assume_independence=True, name="AckermannDrive")

    def predict_fullmat(self, Xtest):
        """The exact prior over vec F at states Xtest (B, b, n): (mean
        (B, b (1+m) n), ordered as the learner's, var I_b kron (I kron
        diag(kernel_diag_A)) (B, b (1+m) n, b (1+m) n))."""
        Bsz, b, n = Xtest.shape
        kw = dict(dtype=Xtest.dtype, device=Xtest.device)
        A = torch.diag(torch.tensor(self.kernel_diag_A, **kw))
        var = kron(torch.eye(b, **kw),
                   kron(torch.eye(self.ctrl_size + 1, **kw), A))
        mean = self.F_func(Xtest.reshape(-1, n)).transpose(-1, -2)
        return mean.reshape(Bsz, -1), var.expand(Bsz, -1, -1)

    def step(self, x, u, dt):
        xdot = self.f_func(x) + (self.g_func(x) @ u[..., None])[..., 0]
        return x + xdot * dt, xdot


class ZeroDynamics(NamedTuple):
    """Zero drift and actuation: the prior mean of a model learned from
    scratch."""
    state_size: int = 3
    ctrl_size: int = 2

    def f_func(self, x):
        return torch.zeros_like(x)

    def g_func(self, x):
        return x.new_zeros((x.shape[0], self.state_size, self.ctrl_size))

    def F_func(self, x):
        return x.new_zeros((x.shape[0], self.state_size, 1 + self.ctrl_size))

    def F_jac(self, x):
        """d F[i, j] / d x_a: (B, n, 1+m, n)."""
        return x.new_zeros((x.shape[0], self.state_size, 1 + self.ctrl_size,
                            self.state_size))

    def fu_func_gp(self, u):
        return _unit_gain_gp(self, u, "Zero")

    def step(self, x, u, dt):
        return x, torch.zeros_like(x)


class PendulumDynamics(NamedTuple):
    """Inverted pendulum, x = (theta, omega): f = [omega, -(g/l) sin theta],
    g = [0, 1/(m l)]; the step wraps theta to [-pi, pi)."""
    mass: float = 1.0
    gravity: float = 10.0
    length: float = 1.0
    state_size: int = 2
    ctrl_size: int = 1

    def f_func(self, x):
        th, w = x[:, 0], x[:, 1]
        return torch.stack([w, -(self.gravity / self.length) * torch.sin(th)],
                           -1)

    def g_func(self, x):
        g = x.new_zeros((x.shape[0], 2, 1))
        g[:, 1, 0] = 1.0 / (self.mass * self.length)
        return g

    def F_func(self, x):
        return torch.cat([self.f_func(x)[..., None], self.g_func(x)], -1)

    def F_jac(self, x):
        """d F[i, j] / d x_a: (B, n, 1+m, n); g is constant."""
        J = x.new_zeros((x.shape[0], 2, 2, 2))
        J[:, 0, 0, 1] = 1.0
        J[:, 1, 0, 0] = -(self.gravity / self.length) * torch.cos(x[:, 0])
        return J

    def fu_func_gp(self, u):
        return _unit_gain_gp(self, u, "Pendulum")

    def step(self, x, u, dt):
        xdot = self.f_func(x) + (self.g_func(x) @ u[..., None])[..., 0]
        x_next = x + xdot * dt
        x_next = torch.stack([normalize_radians(x_next[:, 0]), x_next[:, 1]],
                             -1)
        return x_next, xdot


class LearnedDynState(NamedTuple):
    """Carry state of the online learner, each leaf (B, ...).  `buf` is
    the live reservoir; `data` the snapshot the GP was last fitted on."""
    params: MVGPParams
    buf: MVGPData
    data: MVGPData
    cache: MVGPCache
    prev_x: torch.Tensor       # (B, n)
    prev_u: torch.Tensor       # (B, m)
    have_prev: torch.Tensor    # (B,) bool
    count_pairs: torch.Tensor  # (B,) int32
    count_res: torch.Tensor    # (B,) int32


class KernelChannels(NamedTuple):
    """Per-step kernel hyperparameters and posterior variances."""
    lengthscale: torch.Tensor   # (B, n)
    outputscale: torch.Tensor   # (B,)
    A: torch.Tensor             # (B, n, n)
    B: torch.Tensor             # (B, 1+m, 1+m)
    Fx_var: torch.Tensor        # (B,)
    Fxu_var: torch.Tensor       # (B,)


class LearnedShiftInvariantDynamics(NamedTuple):
    """Mean dynamics + learned MVGP residual with translation invariance
    (x, y zeroed before entering the kernel).  The training set is a
    fixed-capacity reservoir (Algorithm R); refits run between segments
    of the rollout on a static schedule."""
    gp: MVGP
    mean_dynamics: NamedTuple = AckermannDrive()
    max_train: int = 200
    training_iter: int = 100
    shift_invariant: bool = True
    train_every_n_steps: int = 20
    enable_learning: bool = True
    dt: float = 0.01
    training_iter_warm: int = 0
    first_fit_coarse_stride: int = 0
    first_fit_refine_iter: int = 15
    # rank-1 posterior appends: each accepted sample enters the cache the
    # step it is recorded, while the reservoir fills; the scheduled refits
    # still own the hyperparameters
    continuous_updates: bool = False
    # with continuous_updates, what happens once the reservoir is full:
    # True (serving, deploy.CompiledController) refreshes the whole cache
    # on every accepted replacement; False (the batched rollouts) leaves
    # the cache to the scheduled refits
    continuous_full_refresh: bool = True

    # ------------------------------------------------------------ state

    def init_state(self, batch: int, generator: torch.Generator, device,
                   dtype) -> LearnedDynState:
        params = self.gp.init_params(batch, generator, device, dtype)
        data = self.gp.empty_data(batch, self.max_train, device, dtype)
        cache = self.gp.empty_cache(batch, self.max_train, device, dtype)
        n, m = self.gp.x_dim, self.gp.u_dim
        kw = dict(device=device)
        return LearnedDynState(
            params=params, buf=data, data=data, cache=cache,
            prev_x=torch.zeros((batch, n), dtype=dtype, **kw),
            prev_u=torch.zeros((batch, m), dtype=dtype, **kw),
            have_prev=torch.zeros((batch,), dtype=torch.bool, **kw),
            count_pairs=torch.zeros((batch,), dtype=torch.int32, **kw),
            count_res=torch.zeros((batch,), dtype=torch.int32, **kw))

    def _shift_inv(self, x):
        if not self.shift_invariant:
            return x
        return torch.cat([torch.zeros_like(x[..., :-1]), x[..., -1:]], -1)

    # ------------------------------------------------------------ predict

    def moments(self, state: LearnedDynState, x):
        """Posterior moments (FT (B, n, 1+m), Bk (B, 1+m, 1+m), A (B, n, n))
        with vec F(x) ~ N(vec FT^T, Bk kron A)."""
        md = self.mean_dynamics
        if not self.enable_learning:
            Bk, A = self._prior_covariances(x)
            return md.F_func(x), Bk, A
        xs = self._shift_inv(x)
        FT = md.F_func(x) + self.gp.fT_post(state.params, state.data,
                                            state.cache, xs)
        Bk = self.gp.Bk_single(state.params, state.data, state.cache, xs, xs)
        return FT, Bk, state.params.A

    def _prior_covariances(self, x):
        """(Bk = I (B, 1+m, 1+m), A = diag(kernel_diag_A) (B, n, n)) of
        the mean dynamics alone (A = I where they name no kernel_diag_A)."""
        batch = x.shape[0]
        diag_A = getattr(self.mean_dynamics, "kernel_diag_A",
                         (1.0,) * self.gp.x_dim)
        A = torch.diag(torch.tensor(diag_A, dtype=x.dtype, device=x.device))
        Bk = torch.eye(1 + self.gp.u_dim, dtype=x.dtype, device=x.device)
        return Bk.expand(batch, -1, -1), A.expand(batch, -1, -1)

    def moment_derivatives(self, state: LearnedDynState, x):
        """Posterior moments with their x-derivatives at states x (B, n),
        everything a relative-degree-2 chance constraint needs, from one
        posterior evaluation:

            M  (B, n, 1+m)          posterior mean of F^T (with the mean
                                    dynamics)
            dM (B, n, 1+m, n)       dM[..., i, j, a] = d M[i, j] / d x_a
            Bk (B, 1+m, 1+m)        posterior row covariance at (x, x)
            D1 (B, n, 1+m, 1+m)     d Bk(x, x') / d x_a          at x' = x
            D2 (B, n, n, 1+m, 1+m)  d^2 Bk / d x_a d x'_b        at x' = x
            A  (B, n, n)            task output covariance

        The mean dynamics supply F_func and its Jacobian F_jac.  With shift
        invariance the zeroed coordinates carry no derivative.  Without
        learning: the mean dynamics' F and F_jac, Bk = I, zero D1 and D2,
        A = diag(kernel_diag_A)."""
        md = self.mean_dynamics
        if not self.enable_learning:
            Bk, A = self._prior_covariances(x)
            n, mh = self.gp.x_dim, 1 + self.gp.u_dim
            return (md.F_func(x), md.F_jac(x), Bk,
                    x.new_zeros((x.shape[0], n, mh, mh)),
                    x.new_zeros((x.shape[0], n, n, mh, mh)), A)
        fT, dfT, Bk, D1, D2 = self.gp.posterior_derivatives(
            state.params, state.data, state.cache, self._shift_inv(x))
        if self.shift_invariant:
            keep = self._shift_inv(torch.ones_like(x[:1]))[0]      # (n,)
            dfT = dfT * keep
            D1 = D1 * keep[:, None, None]
            D2 = D2 * (keep[:, None] * keep)[..., None, None]
        return (md.F_func(x) + fT, md.F_jac(x) + dfT, Bk, D1, D2,
                state.params.A)

    def f_func(self, state: LearnedDynState, x):
        """The learned model's mean drift at states x (B, n): (B, n)."""
        learned = self.gp.f_mean(state.params, state.data, state.cache,
                                 self._shift_inv(x))
        return self.mean_dynamics.f_func(x) + learned

    def g_func(self, state: LearnedDynState, x):
        """The learned model's mean actuation at states x (B, n):
        (B, n, m)."""
        learned = self.gp.g_mean(state.params, state.data, state.cache,
                                 self._shift_inv(x))
        return self.mean_dynamics.g_func(x) + learned

    def predict_fullmat(self, state: LearnedDynState, Xtest):
        """The posterior over vec F at states Xtest (B, b, n), the mean
        dynamics' F added to the mean: (mean (B, b (1+m) n), var (B,
        b (1+m) n, b (1+m) n)); without learning, the mean dynamics'
        prior (`AckermannDrive.predict_fullmat`)."""
        md = self.mean_dynamics
        if not self.enable_learning:
            return md.predict_fullmat(Xtest)
        dmean, dvar = self.gp.predict_fullmat(
            state.params, state.data, state.cache, self._shift_inv(Xtest))
        Bsz, b, n = Xtest.shape
        mmean = md.F_func(Xtest.reshape(-1, n)).transpose(-1, -2)
        return mmean.reshape(Bsz, -1) + dmean, dvar

    # ------------------------------------------ GP expressions, one episode

    def _learned_fu_gp(self, state: LearnedDynState, u,
                       assume_independence=True):
        """The learned residual's Fu leaf of one episode's `state` at the
        control u (m,); with assume_independence, independent of every
        other leaf."""
        gp, si, st = self.gp, self._shift_inv, _unit(state)
        ub = u[None]
        return LeafGP(
            mean=lambda x: gp.fu_mean(st.params, st.data, st.cache, ub,
                                      si(x)[None])[0],
            knl=lambda x, xp: gp.fu_knl(st.params, st.data, st.cache, ub,
                                        si(x)[None], si(xp)[None])[0],
            dim=gp.x_dim, assume_independence=assume_independence,
            name="learned_fu")

    def fu_func_gp(self, state: LearnedDynState, u):
        """The mean dynamics' f + g u as a deterministic GP plus the
        learned residual's leaf (one episode); without learning, the mean
        dynamics' own `fu_func_gp`."""
        md = self.mean_dynamics
        if not self.enable_learning:
            return md.fu_func_gp(u)
        det = DeterministicGP(lambda x: _fu_at(md, x, u), dim=self.gp.x_dim,
                              name="mean_dyn")
        return det + self._learned_fu_gp(state, u)

    def f_gp_and_fu_gp(self, state: LearnedDynState, u):
        """(f, Fu) of one episode's `state` at the control u (m,), as the
        learned leaves with cov(Fu(x), f(x')) = covar_fu_f registered,
        each plus the mean dynamics' part when learning is on."""
        gp, md, si, st = self.gp, self.mean_dynamics, self._shift_inv, \
            _unit(state)
        ub = u[None]
        f_leaf = LeafGP(
            mean=lambda x: gp.f_mean(st.params, st.data, st.cache,
                                     si(x)[None])[0],
            knl=lambda x, xp: gp.f_knl(st.params, st.data, st.cache,
                                       si(x)[None], si(xp)[None])[0],
            dim=gp.x_dim, name="learned_f")
        fu_leaf = self._learned_fu_gp(state, u, assume_independence=False)
        fu_leaf.register_covar(
            f_leaf,
            lambda x, xp: gp.covar_fu_f(st.params, st.data, st.cache, ub,
                                        si(x)[None], si(xp)[None])[0])
        if not self.enable_learning:
            return f_leaf, fu_leaf
        f_det = DeterministicGP(lambda x: md.f_func(x[None])[0],
                                dim=gp.x_dim, name="mean_f")
        fu_det = DeterministicGP(lambda x: _fu_at(md, x, u), dim=gp.x_dim,
                                 name="mean_fu")
        return f_det + f_leaf, fu_det + fu_leaf

    def kernel_channels(self, state: LearnedDynState, moments, u
                        ) -> KernelChannels:
        _, Bk, A = moments
        uh = torch.cat([torch.ones_like(u[:, :1]), u], -1)
        trA = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
        if self.enable_learning:
            p = state.params
            ls, os_, B = p.lengthscale, p.outputscale, p.B
        else:
            batch = u.shape[0]
            ls = torch.ones((batch, self.gp.x_dim), dtype=A.dtype,
                            device=A.device)
            os_ = torch.ones((batch,), dtype=A.dtype, device=A.device)
            B = torch.eye(1 + self.gp.u_dim, dtype=A.dtype,
                          device=A.device).expand(batch, -1, -1)
        uBu = (uh[:, None, :] @ Bk @ uh[:, :, None])[:, 0, 0]
        return KernelChannels(lengthscale=ls, outputscale=os_, A=A, B=B,
                              Fx_var=Bk[:, 0, 0] * trA, Fxu_var=uBu * trA)

    # ------------------------------------------------------------ learn

    def record(self, state: LearnedDynState, x, u,
               j: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None
               ) -> LearnedDynState:
        """Push the finite-difference residual of the previous pair into
        the reservoir and remember (x, u).  `j` (B,) int is the reservoir
        draw, uniform on [0, count_res]; when absent it is drawn from
        `generator`."""
        md = self.mean_dynamics
        xdot = (x - state.prev_x) / self.dt
        xprev_si = self._shift_inv(state.prev_x)
        xdot_mean = md.f_func(xprev_si) + (
            md.g_func(xprev_si) @ state.prev_u[..., None])[..., 0]
        resid = xdot - xdot_mean

        cap = self.max_train
        cr = state.count_res
        if j is None:
            hi = torch.clamp(cr + 1, min=1).to(x.dtype)
            r = torch.rand(cr.shape, generator=generator, dtype=x.dtype,
                           device=x.device)
            j = torch.minimum(torch.floor(r * hi).to(torch.int32),
                              (hi - 1).to(torch.int32))
        j = j.to(cr.dtype)
        slot = torch.where(cr < cap, cr, j)
        accept = state.have_prev & ((cr < cap) | (j < cap))
        slot = torch.clamp(slot, 0, cap - 1)

        uh = torch.cat([torch.ones_like(state.prev_u[:, :1]), state.prev_u],
                       -1)
        hit = (torch.arange(cap, device=x.device)[None, :] == slot[:, None]
               ) & accept[:, None]                                  # (B, K)
        buf = _write_row(state.buf, hit, xprev_si, uh, resid)
        new = state._replace(
            buf=buf, prev_x=x, prev_u=u,
            have_prev=torch.ones_like(state.have_prev),
            count_pairs=state.count_pairs + 1,
            count_res=cr + accept.to(cr.dtype))
        if not self.continuous_updates:
            return new
        if self.continuous_full_refresh:
            return self._serving_update(new, slot, accept, cr < cap)
        # row-gated rank-1 append while the reservoir fills; once it is
        # full the scheduled refits own the cache.  The fitted snapshot
        # `data` takes the row where the cache does.
        wr = accept & (cr < cap)
        cache = self.gp.cache_append_row(new.params, buf, state.cache, slot,
                                         wr)
        data = _write_row(state.data, hit & wr[:, None], xprev_si, uh, resid)
        return new._replace(data=data, cache=cache)

    def _serving_update(self, new: LearnedDynState, slot, accept, filling
                        ) -> LearnedDynState:
        """The serving semantics of an accepted sample: while the reservoir
        fills (`filling`, the count before this sample below capacity) a
        rank-1 `cache_append` of its row, once it is full a whole
        `refresh_cache`; either way the fitted snapshot `data` becomes the
        reservoir.  An episode whose new cache is not finite keeps its old
        cache and snapshot.  Which episodes take which branch is read on
        the host, so each branch runs only on its own episodes."""
        acc, fill = torch.stack([accept, filling]).tolist()
        for branch in (True, False):
            rows = [b for b, (a, f) in enumerate(zip(acc, fill))
                    if a and f == branch]
            if not rows:
                continue
            idx = torch.tensor(rows, device=slot.device)
            part = _map(lambda a: a[idx], new)
            with torch.no_grad():
                cache = (self.gp.cache_append(part.params, part.buf,
                                              part.cache, slot[idx])
                         if branch else
                         self.gp.refresh_cache(part.params, part.buf))
            data, cache = where_tree(_tree_finite(cache), (part.buf, cache),
                                     (part.data, part.cache))
            put = lambda a, p: a.index_copy(0, idx, p)
            new = new._replace(data=_map(put, new.data, data),
                               cache=_map(put, new.cache, cache))
        return new

    def _refit(self, state: LearnedDynState, params: MVGPParams
               ) -> LearnedDynState:
        with torch.no_grad():
            cache = self.gp.refresh_cache(params, state.buf)
        new = state._replace(params=params, data=state.buf, cache=cache)
        ok = _tree_finite((new.params, new.cache))
        return where_tree(ok, new, state)

    def fit_now(self, state: LearnedDynState,
                training_iter: Optional[int] = None) -> LearnedDynState:
        """Refit on the current reservoir and refresh the cache; an
        episode whose result is not finite keeps its previous state."""
        params = self.gp.fit(state.params, state.buf,
                             training_iter=(self.training_iter
                                            if training_iter is None
                                            else training_iter))
        return self._refit(state, params)

    @property
    def first_fit_twostage(self) -> bool:
        return self.first_fit_coarse_stride >= 2

    def fit_now_first(self, state: LearnedDynState) -> LearnedDynState:
        """The first scheduled fit.  Two-stage when first_fit_coarse_stride
        >= 2: the full Adam budget on buf[::stride], then
        first_fit_refine_iter iterations on the full buffer."""
        if not self.first_fit_twostage:
            return self.fit_now(state)
        stride = self.first_fit_coarse_stride
        sub = MVGPData(*(a[:, ::stride] for a in state.buf))
        params = self.gp.fit(state.params, sub,
                             training_iter=self.training_iter)
        params = self.gp.fit(params, state.buf,
                             training_iter=self.first_fit_refine_iter)
        return self._refit(state, params)

    @property
    def first_fit_differs(self) -> bool:
        return self.warm_refits_differ or self.first_fit_twostage

    @property
    def warm_refits_differ(self) -> bool:
        return self.training_iter_warm not in (0, self.training_iter)

    def fit_now_warm(self, state: LearnedDynState) -> LearnedDynState:
        if not self.warm_refits_differ:
            return self.fit_now(state)
        return self.fit_now(state, training_iter=self.training_iter_warm)

    def should_fit_at(self, t):
        """The reference's refit schedule: a positive multiple of
        train_every_n_steps, with learning on.  `t` is an int or a tensor
        of step counts."""
        if not self.enable_learning or self.train_every_n_steps <= 0:
            return t < 0
        return (t > 0) & (t % self.train_every_n_steps == 0)

    def observe(self, state: LearnedDynState, x, u,
                j: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> LearnedDynState:
        """`record`, then a refit at the full Adam budget (`fit_now`) of
        each episode whose pair count before this record is on the
        schedule and whose reservoir is not empty: the serving tick's
        learning step."""
        do_fit = self.should_fit_at(state.count_pairs) & (state.count_res > 0)
        state = self.record(state, x, u, j=j, generator=generator)
        if not bool(do_fit.any()):
            return state
        return where_tree(do_fit, self.fit_now(state), state)
