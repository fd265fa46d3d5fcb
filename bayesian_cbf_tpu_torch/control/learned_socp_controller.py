"""SOCP controller over learned relative-degree-2 chance constraints (the
pendulum stack), batched over episodes.

  variables [u (m), delta, y, s]          (cbc_relax; [u, delta, y] without)
  minimize  y + cbc_relax_weight s
  s.t.  || [sqrt(Q) (u - u_ref); sqrt(lambda) delta] || <= y   (objective)
        rho || A_k u + b_k || <= c_k^T u + s + d_k              (CBC2 cones)
        s >= 0                                                  (cbc_relax)
        || A u + b || <= c^T u + delta + d                      (clc_fn)

The CBC2 cones come in closed form from one posterior moment-derivative
evaluation per step, or with `closed_form=False` through the GP
expression path (`safety/cbc.cbc2_gp_terms`: the CBC2 built as a GP of
each episode's learned (f, Fu) pair, its terms extracted by
differentiating in u); each is scaled by 1 / max(1, max |entry|) (same
feasible set, better conditioned for the f32 IPM).  The slack s with its
exact penalty keeps every problem feasible: a step is `certified` when
s is ~0.  Without `cbc_relax` the CBC2 cones are hard and `certified`
is `feasible`.  The optional stability cone relaxes a CLC GP (`clc_fn`,
per episode) by delta; it is not rescaled.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..gp.algebra import DeterministicGP
from ..observability import tracing
from ..safety.cbc import (cbc2_closed_form_terms, cbc2_gp_terms,
                          cbc2_safety_factor, cbc_to_socp_cone,
                          gp_quadratic_terms)
from ..solvers.socp import solve_socp
from .bayes_controller import count_gate


class LearnedSOCPControllerConfig(NamedTuple):
    u_dim: int = 1
    x_dim: int = 2
    ctrl_reg: float = 1.0            # Q (control effort weight)
    clf_relax_weight: float = 100.0  # lambda (delta penalty)
    max_unsafe_prob: float = 0.01
    k_alpha: Tuple[float, float] = (1.0, 3.0)
    socp_iters: int = 25
    cbc_relax_weight: float = 100.0
    # CBC2 terms from the moment derivatives (True) or through the GP
    # expression path (False, `cbc2_gp_terms`)
    closed_form: bool = True
    # G, h, u_ref and the solution x in the info (LearnedSOCPInfo)
    debug_cones: bool = False
    # a shared slack s >= 0 on the CBC2 cones, penalized by
    # cbc_relax_weight: a step whose posterior is too wide for any u to
    # satisfy the cone takes the least-violating u, uncertified
    cbc_relax: bool = True

    @property
    def safety_factor(self) -> float:
        return cbc2_safety_factor(self.max_unsafe_prob)


class LearnedSOCPInfo(NamedTuple):
    delta: torch.Tensor      # (B,)
    pres: torch.Tensor       # (B,)
    dres: torch.Tensor       # (B,)
    feasible: torch.Tensor   # (B,) bool
    cbc_mean: torch.Tensor   # (B, n_cbfs) at u0
    cbc_var: torch.Tensor    # (B, n_cbfs) at u0
    cbc_slack: torch.Tensor  # (B,) (zeros without cbc_relax)
    certified: torch.Tensor  # (B,) bool: feasible and slack ~ 0
    # with cfg.debug_cones: the step's SOCP and its solution
    G: Optional[torch.Tensor] = None      # (B, M, nvar)
    h: Optional[torch.Tensor] = None      # (B, M)
    u_ref: Optional[torch.Tensor] = None  # (B, m)
    x_sol: Optional[torch.Tensor] = None  # (B, nvar)


def n_vars(cfg: LearnedSOCPControllerConfig) -> int:
    """The SOCP's variable count: [u (m), delta, y] and, with cbc_relax,
    the slack s."""
    return cfg.u_dim + (3 if cfg.cbc_relax else 2)


@lru_cache(maxsize=16)
def _constants(cfg: LearnedSOCPControllerConfig, dtype, device):
    """(objective vector (nvar,), objective cone rows [-c_obj; -A_obj]
    (m+2, nvar), the s >= 0 row (1, nvar) or None without cbc_relax,
    u0 (m,))."""
    m = cfg.u_dim
    nvar = n_vars(cfg)
    G_obj = [[0.0] * nvar for _ in range(m + 2)]
    G_obj[0][m + 1] = -1.0
    for i in range(m):
        G_obj[1 + i][i] = -math.sqrt(cfg.ctrl_reg)
    G_obj[m + 1][m] = -math.sqrt(cfg.clf_relax_weight)
    cobj = [0.0] * nvar
    cobj[m + 1] = 1.0
    kw = dict(dtype=dtype, device=device)
    s_row = None
    if cfg.cbc_relax:
        cobj[m + 2] = cfg.cbc_relax_weight
        s_row = [[0.0] * nvar]
        s_row[0][m + 2] = -1.0
        s_row = torch.tensor(s_row, **kw)
    return (torch.tensor(cobj, **kw), torch.tensor(G_obj, **kw), s_row,
            torch.full((m,), 0.5, **kw))


def _cone(A, b, bfc, d):
    """G rows [-bfc; -A] and h [d; b] of ||A x + b|| <= bfc^T x + d."""
    return (torch.cat([-bfc[:, None], -A], 1), torch.cat([d[:, None], b], 1))


def norm2_clc(pair_fn: Callable, x_dim: int, gamma: float = 1.0,
              scale: float = 1.0):
    """A CLC for `clc_fn`: (state, u) -> the negated stability condition
    of V(x) = scale ||x||^2 as a GP of one episode's learned (f, Fu) pair
    (pair_fn(state, u), e.g. `LearnedShiftInvariantDynamics.
    f_gp_and_fu_gp`):

        -(grad V^T (f + F u) + gamma V),

    so that the controller's cone asks grad V^T (f + F u) + gamma V <= delta
    with a margin of one standard deviation.  The stability cone is not
    rescaled (JAX's layout), so `scale` sets the size of its data and of
    delta, and with it how many IPM iterations the step needs."""
    V = DeterministicGP(lambda x: (scale * (x @ x)).reshape(1), dim=1,
                        name="V")
    grad_V = DeterministicGP(lambda x: (2.0 * scale) * x, dim=x_dim,
                             name="grad_V")

    def clc(state, u):
        f, fu = pair_fn(state, u)
        return (grad_V.t() @ f + grad_V.t() @ fu + V * gamma) * -1.0
    return clc


@tracing.spanned("cones")
def learned_socp_cones(cfg: LearnedSOCPControllerConfig, cbfs, mder,
                       u_ref, x, pair_fn: Optional[Callable] = None,
                       state=None, clc_fn: Optional[Callable] = None):
    """The batch of step SOCPs: (cobj (nvar,), G (B, M, nvar), h (B, M),
    dims, CBC2 means (B, n_cbfs), variances (B, n_cbfs)) at u0 = 0.5.
    cbfs: barriers with cbf / grad_cbf / hess_cbf; mder: the step's
    moment derivatives (read when cfg.closed_form); u_ref (B, m): the
    reference control.  Without cfg.closed_form the CBC2 terms come from
    `cbc2_gp_terms` with pair_fn (one episode's state, u) -> its (f, Fu)
    GPs and the learner `state` (B, ...).  clc_fn (state, u) -> GP: the
    CLC of one episode (its learner state from `state`), whose terms
    (`gp_quadratic_terms`) give the stability cone, relaxed by delta.

    The cones follow JAX's order: the objective (m + 2), each CBC2 (m +
    2), the s >= 0 ray with cbc_relax, the stability cone (m + 2)."""
    if not cfg.closed_form and (pair_fn is None or state is None):
        raise ValueError("closed_form=False needs pair_fn and state")
    if clc_fn is not None and state is None:
        raise ValueError("clc_fn needs the learner state")
    m = cfg.u_dim
    B = x.shape[0]
    extravars = n_vars(cfg) - m
    cobj, G_obj, s_row, u0 = _constants(cfg, x.dtype, x.device)
    u0 = u0.expand(B, m)
    factor = cfg.safety_factor
    sq = math.sqrt(cfg.ctrl_reg)
    Gs = [G_obj.expand(B, -1, -1)]
    hs = [torch.cat([x.new_zeros((B, 1)), -sq * u_ref, x.new_zeros((B, 1))],
                    1)]
    dims = [m + 2]
    means, variances = [], []
    for cbf in cbfs:
        if cfg.closed_form:
            terms = cbc2_closed_form_terms(cbf, cfg.k_alpha, mder, x, u0)
        else:
            terms = cbc2_gp_terms(cbf, cfg.k_alpha, pair_fn, state, x, u0)
        (bfe, e), (V, bfv, v), mean, var = terms
        A, b, bfc, d = cbc_to_socp_cone(
            bfe, e, V, bfv, v, extravars=extravars,
            relax_col=2 if cfg.cbc_relax else -1)
        Gk, hk = _cone(factor * A, factor * b, bfc, d)
        scale = torch.clamp(torch.maximum(torch.amax(torch.abs(Gk), (-2, -1)),
                                          torch.amax(torch.abs(hk), -1)),
                            min=1.0)
        Gs.append(Gk / scale[:, None, None])
        hs.append(hk / scale[:, None])
        dims.append(m + 2)
        means.append(mean)
        variances.append(var)
    if cfg.cbc_relax:
        Gs.append(s_row.expand(B, -1, -1))
        hs.append(x.new_zeros((B, 1)))
        dims.append(1)
    if clc_fn is not None:
        (bfe, e), (V, bfv, v), _, _ = gp_quadratic_terms(clc_fn, state, x,
                                                         u0)
        Gk, hk = _cone(*cbc_to_socp_cone(bfe, e, V, bfv, v,
                                         extravars=extravars, relax_col=0))
        Gs.append(Gk)
        hs.append(hk)
        dims.append(m + 2)
    return (cobj, torch.cat(Gs, 1), torch.cat(hs, 1), tuple(dims),
            torch.stack(means, 1), torch.stack(variances, 1))


def learned_socp_control(cfg: LearnedSOCPControllerConfig, cbfs, mder,
                         u_ref, x, u_fallback,
                         pair_fn: Optional[Callable] = None, state=None,
                         clc_fn: Optional[Callable] = None):
    """One control step for a batch of episodes: u (B, m) and
    LearnedSOCPInfo, from the SOCPs of `learned_socp_cones` (pair_fn,
    state and clc_fn as there); u_fallback (B, m) is the control of an
    episode whose solve failed (the clean reference, never an
    exploration-perturbed one)."""
    m = cfg.u_dim
    cobj, G, h, dims, means, variances = learned_socp_cones(
        cfg, cbfs, mder, u_ref, x, pair_fn, state, clc_fn)
    sol = solve_socp(cobj, G, h, dims, iters=cfg.socp_iters)
    f64 = x.dtype == torch.float64
    feasible = (sol.pres < (1e-4 if f64 else 5e-3)) \
        & torch.isfinite(sol.x).all(-1)
    count_gate(feasible)
    u = torch.where(feasible[:, None], sol.x[:, :m], u_fallback)
    if cfg.cbc_relax:
        slack = sol.x[:, m + 2]
        certified = feasible & (slack < (1e-6 if f64 else 1e-2))
    else:
        slack = torch.zeros_like(sol.pres)
        certified = feasible
    debug = (dict(G=G, h=h, u_ref=u_ref, x_sol=sol.x) if cfg.debug_cones
             else {})
    return u, LearnedSOCPInfo(
        delta=sol.x[:, m], pres=sol.pres, dres=sol.dres, feasible=feasible,
        cbc_mean=means, cbc_var=variances, cbc_slack=slack,
        certified=certified, **debug)
