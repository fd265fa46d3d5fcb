"""Probabilistic CLF tracking with Bayes-CBF safety cones, solved as one
small SOCP per episode per step, batched over episodes; and its
deterministic baseline on a known model, the mean-CLF/CBF QP
(`mean_clf_control`).

With the posterior moments vec F(x) ~ N(vec FT^T, Bk kron A), a linear
functional w of the dynamics has
    mean  w^T F u_hom = (w^T FT) u_hom,   var = (u_hom^T Bk u_hom)(w^T A w),
so one posterior evaluation per step yields every cone in closed form
(`bayes_clf_control`).  `bayes_clf_control_gp` builds the same cones
through the GP expression path instead: the CLC and CBCs as GPs of the
model's Fu, their terms extracted by differentiating in u.

  variables x = [u (m), relax, t]
  minimize  t
  s.t.  || W^(1/2) ([u; relax] - [u_ref; 0]) ||  <=  t          (objective)
        rho ||A_clc u + b_clc|| <= c_clc^T u + d_clc + relax    (CLC cone)
        rho ||A_k u + b_k||     <= c_k^T u + d_k                (CBC cones)
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from ..gp.algebra import DeterministicGP
from ..observability import tracing
from ..safety.cbc import (cbc1_safety_factor, cbc2_quadratic_terms,
                          cbc_to_socp_cone)
from ..solvers.socp import solve_socp
from ..utils.linalg import psd_chol_small_ladder


class BayesCLFControllerConfig(NamedTuple):
    u_dim: int = 2
    clf_gamma: float = 10.0
    cost_weights: Tuple[float, ...] = (0.33, 0.33, 0.33)
    ctrl_ref: Tuple[float, ...] = (0.0, 0.0)
    max_risk: float = 1e-2
    cbf_gammas: Tuple[float, ...] = ()
    socp_iters: int = 25
    feas_tol: float = 1e-4
    warm_start: bool = False
    socp_iters_warm: int = 15

    @property
    def rho(self) -> float:
        """sqrt(2) erfinv(1 - 2 max_risk)."""
        return cbc1_safety_factor(self.max_risk)


class ControlInfo(NamedTuple):
    rho: torch.Tensor        # (B,)
    relax: torch.Tensor      # (B,)
    pcost: torch.Tensor      # (B,)
    pres: torch.Tensor       # (B,)
    dres: torch.Tensor       # (B,)
    feasible: torch.Tensor   # (B,) bool
    clc_mean: torch.Tensor   # (B,)
    clc_var: torch.Tensor    # (B,)
    cbc_means: torch.Tensor  # (B, n_cbfs)
    cbc_vars: torch.Tensor   # (B, n_cbfs)


def warm_cone_count(cfg: BayesCLFControllerConfig, n_cbfs: int) -> int:
    """Cones of the controller's SOCP (objective, CLC, CBCs): the leading
    dimension of the warm-start slack and dual blocks."""
    return 2 + n_cbfs


def warm_init(cfg: BayesCLFControllerConfig, n_cbfs: int, batch: int,
              device, dtype):
    """Cold (x, S, Z) warm-start state, identical to the solver's own
    cold start: x = 0, S = Z = e per cone."""
    nvar = cfg.u_dim + 2
    C, dmax = warm_cone_count(cfg, n_cbfs), cfg.u_dim + 2
    e = torch.zeros((batch, C, dmax), dtype=dtype, device=device)
    e[..., 0] = 1.0
    return (torch.zeros((batch, nvar), dtype=dtype, device=device), e,
            e.clone())


@lru_cache(maxsize=16)
def _constants(cfg: BayesCLFControllerConfig, n_cbfs: int, dtype, device):
    """Per-config constants, made once so the step loop copies nothing
    from the host: (rho, CLC/CBC signs (C,), u_ref (m,), objective vector
    (nvar,), objective cone rows [-c_obj; -A_obj] (nvar, nvar) and h)."""
    m = cfg.u_dim
    nvar = m + 2
    wcost = [math.sqrt(w) for w in cfg.cost_weights]
    G_obj = [[0.0] * nvar for _ in range(nvar)]
    G_obj[0][m + 1] = -1.0
    for i in range(m):
        G_obj[1 + i][i] = -wcost[i]
    G_obj[m + 1][m] = -wcost[m]
    h_obj = [0.0] + [-w * r for w, r in zip(wcost[:m], cfg.ctrl_ref)] + [0.0]
    cobj = [0.0] * (m + 1) + [1.0]
    kw = dict(dtype=dtype, device=device)
    return (cfg.rho, torch.tensor([-1.0] + [1.0] * n_cbfs, **kw),
            torch.tensor(cfg.ctrl_ref, **kw), torch.tensor(cobj, **kw),
            torch.tensor(G_obj, **kw), torch.tensor(h_obj, **kw))


def constraint_cone_terms(cfg: BayesCLFControllerConfig, clf, cbfs,
                          planner, moments, x, t):
    """(sgn (C,), const (B, C), m_aff (B, C, 1+m), s (B, C), LbT
    (B, 1+m, 1+m)) of the CLC (row 0, sign -1) and the CBC cones.  The
    step t is an int, or a (B,) tensor of one step per row."""
    FT, Bk, A = moments
    Lb = psd_chol_small_ladder(Bk, init_jitter=1e-10)
    LbT = Lb.transpose(-1, -2)
    V, gclf, ggoal = clf.value_and_grads(x, planner.plan(t))
    dplan = planner.dot_plan(t)
    consts = [cfg.clf_gamma * V + (ggoal @ dplan if dplan.ndim == 1 else
                                   (ggoal * dplan).sum(-1))]
    ws = [gclf]
    for cbf, gamma in zip(cbfs, cfg.cbf_gammas):
        h, gh = cbf.value_and_grad(x)
        ws.append(gh)
        consts.append(gamma * h)
    W = torch.stack(ws, 1)                                   # (B, C, n)
    sgn = _constants(cfg, len(ws) - 1, x.dtype, x.device)[1]
    const = torch.stack(consts, 1)                           # (B, C)
    m_aff = W @ FT                                           # (B, C, 1+m)
    s = torch.einsum('bci,bij,bcj->bc', W, A, W)
    return sgn, const, m_aff, s, LbT


def chance_constraint_margins(cfg: BayesCLFControllerConfig, clf, cbfs,
                              planner, moments, x, t, u):
    """Realized chance-constraint margins at applied controls u (B, m),
    (B, 1 + n_cbfs):

        margin_c = sgn_c (m_aff_c [1; u] + const_c)
                   - rho sqrt(s_c) || LbT[:, 1:] u + LbT[:, 0] ||

    >= 0 means Pr[violation] <= max_risk under the posterior.  Row 0 is
    the CLC without its relax slack (it may go negative); rows 1.. are the
    CBCs.  Built from `constraint_cone_terms`, the controller's own cone
    terms, so the audit and the controller cannot drift apart."""
    sgn, const, m_aff, s, LbT = constraint_cone_terms(
        cfg, clf, cbfs, planner, moments, x, t)
    lin = sgn * (m_aff[..., 0] + (m_aff[..., 1:] @ u[:, :, None])[..., 0]
                 + const)
    nv = (LbT[:, :, 1:] @ u[:, :, None])[..., 0] + LbT[:, :, 0]
    return lin - cfg.rho * torch.sqrt(torch.clamp(s, min=0.0)) \
        * torch.linalg.vector_norm(nv, dim=-1)[:, None]


@tracing.spanned("cones")
def controller_socp(cfg: BayesCLFControllerConfig, clf, cbfs, planner,
                    moments, x, t: int):
    """The batch of step-t SOCPs: (cobj (nvar,), G (B, M, nvar), h (B, M),
    dims, terms) with terms = constraint_cone_terms(...)."""
    m = cfg.u_dim
    batch = x.shape[0]
    nvar = m + 2
    terms = constraint_cone_terms(cfg, clf, cbfs, planner, moments, x, t)
    sgn, const, m_aff, s, LbT = terms
    sqrt_s = torch.sqrt(torch.clamp(s, min=0.0))
    ncon = sgn.shape[0]
    rho, _, _, cobj, G_obj, h_obj = _constants(cfg, ncon - 1, x.dtype,
                                               x.device)
    # a near-zero safety factor degenerates the SOCs to half-spaces,
    # emitted as 1-dim cones
    mean_only = rho < 1e-3
    zeros = x.new_zeros
    A_norm = zeros((batch, ncon, m + 1, nvar))
    A_norm[..., :m] = rho * sqrt_s[..., None, None] * LbT[:, None, :, 1:]
    b_norm = rho * sqrt_s[..., None] * LbT[:, None, :, 0]
    bfc = zeros((batch, ncon, nvar))
    bfc[..., :m] = sgn[:, None] * m_aff[..., 1:]
    bfc[:, 0, m] = 1.0
    d = sgn * (m_aff[..., 0] + const)

    G_rows = [G_obj.expand(batch, -1, -1)]
    h_rows = [h_obj.expand(batch, -1)]
    dims = [m + 2]
    for ci in range(ncon):
        if mean_only:
            G_rows.append(-bfc[:, ci, None])
            h_rows.append(d[:, ci, None])
            dims.append(1)
        else:
            G_rows.append(torch.cat([-bfc[:, ci, None], -A_norm[:, ci]], 1))
            h_rows.append(torch.cat([d[:, ci, None], b_norm[:, ci]], 1))
            dims.append(m + 2)
    return cobj, torch.cat(G_rows, 1), torch.cat(h_rows, 1), tuple(dims), terms


def count_gate(feasible) -> None:
    """The feasibility gate's counters: episode-steps gated, and those
    that took the fallback control."""
    tracing.count("controller.episodes", feasible.shape[0])
    tracing.count("controller.fallbacks", torch.logical_not, feasible)


def bayes_clf_control(cfg: BayesCLFControllerConfig, clf, cbfs, planner,
                      moments, x, t: int, warm=None):
    """One control step for a batch of episodes via closed-form cones.

    moments: (FT (B, n, 1+m), Bk (B, 1+m, 1+m), A (B, n, n)).  Returns
    (u (B, m), ControlInfo); with `warm` (previous (x, S, Z)) returns
    (u, ControlInfo, warm_next) and runs cfg.socp_iters_warm iterations."""
    m = cfg.u_dim
    dtype, device = x.dtype, x.device
    batch = x.shape[0]
    Bk = moments[1]
    cobj, G, h, dims, (sgn, const, m_aff, s, _) = controller_socp(
        cfg, clf, cbfs, planner, moments, x, t)
    rho, _, uref = _constants(cfg, sgn.shape[0] - 1, dtype, device)[:3]
    mean_only = rho < 1e-3
    # mean-only problems are tiny LPs: solved cold at full iterations
    use_warm = None if mean_only else warm
    iters = cfg.socp_iters if use_warm is None else cfg.socp_iters_warm
    sol = solve_socp(cobj, G, h, dims, iters=iters, warm=use_warm)
    # f32 IPMs plateau near 1e-4 relative primal residual: gate at 5e-3
    feas_tol = (cfg.feas_tol if dtype == torch.float64
                else max(cfg.feas_tol, 5e-3))
    feasible = (sol.pres < feas_tol) & torch.isfinite(sol.x).all(-1)
    count_gate(feasible)
    u_opt = torch.where(feasible[:, None], sol.x[:, :m],
                        uref.expand(batch, m))
    info = ControlInfo(
        rho=torch.full((batch,), rho, dtype=dtype, device=device),
        relax=sol.x[:, m], pcost=sol.pcost, pres=sol.pres, dres=sol.dres,
        feasible=feasible,
        clc_mean=sgn[0] * (m_aff[:, 0, 0] + const[:, 0]),
        clc_var=s[:, 0] * Bk[:, 0, 0],
        cbc_means=m_aff[:, 1:, 0] + const[:, 1:],
        cbc_vars=s[:, 1:] * Bk[:, 0, 0, None])
    if warm is None:
        return u_opt, info
    return u_opt, info, (sol.x, sol.s, sol.z)


def _clc_gp(cfg: BayesCLFControllerConfig, clf, fu_gp_fn, x_dim,
            state_goal, dplan, u):
    """The CLC as a GP at one state: grad_V^T (F u) + grad_goal_V^T
    dot_plan + gamma V, for the goal state_goal (n,) and its rate dplan
    (n,)."""
    clfgp = DeterministicGP(
        lambda x: (cfg.clf_gamma * clf.clf(x, state_goal)).reshape(1),
        dim=1, name="gammaV")
    gclf = DeterministicGP(lambda x: clf.grad_clf(x, state_goal),
                           dim=x_dim, name="gradV")
    gclf_goal = DeterministicGP(lambda x: clf.grad_clf_wrt_goal(x, state_goal),
                                dim=x_dim, name="gradV_goal")
    dplan_gp = DeterministicGP(lambda x: dplan, dim=x_dim, name="dot_plan")
    return gclf.t() @ fu_gp_fn(u) + gclf_goal.t() @ dplan_gp + clfgp


def _cbc_gp(cbf, gamma, fu_gp_fn, x_dim, u):
    """The relative-degree-1 CBC as a GP at one state:
    grad_h^T (F u) + gamma h."""
    hgp = DeterministicGP(lambda x: (gamma * cbf.cbf(x)).reshape(1), dim=1,
                          name="gamma_h")
    ghgp = DeterministicGP(cbf.grad_cbf, dim=x_dim, name="grad_h")
    return ghgp.t() @ fu_gp_fn(u) + hgp


def bayes_clf_control_gp(cfg: BayesCLFControllerConfig, clf, cbfs, planner,
                         fu_gp_fn, state, x, t):
    """One control step for a batch of episodes through the GP expression
    path: the CLC and CBC cones of `bayes_clf_control`, each built as a GP
    of the model's Fu and its terms extracted by differentiating in u at
    u0 = 0.5 (`cbc2_quadratic_terms`), vectorized over the episodes with
    `torch.func.vmap`; solved cold at cfg.socp_iters iterations (no warm
    start, no mean-only half-spaces).

    fu_gp_fn(state_b, u): the Fu GP of one episode's learner state at
    control u (m,), e.g. `LearnedShiftInvariantDynamics.fu_func_gp`;
    state: the learner state (B, ...), or None where fu_gp_fn reads none.
    x (B, n); t an int or a (B,) tensor of steps.  Returns (u (B, m),
    ControlInfo) with the CLC's and CBCs' mean and variance at u0."""
    m = cfg.u_dim
    dtype, device = x.dtype, x.device
    batch, n = x.shape
    rho, _, uref, cobj, G_obj, h_obj = _constants(cfg, len(cbfs), dtype,
                                                  device)
    with tracing.span("cones"):
        goal = planner.plan(t).expand(batch, n)
        dplan = planner.dot_plan(t).expand(batch, n)
        u0 = torch.full((m,), 0.5, dtype=dtype, device=device)

        def one(x1, goal1, dplan1, st):
            fu = lambda u: fu_gp_fn(st, u)
            clc = cbc2_quadratic_terms(
                lambda u: _clc_gp(cfg, clf, fu, n, goal1, dplan1, u) * (-1.0),
                x1, u0)
            cbcs = [cbc2_quadratic_terms(
                lambda u, cbf=cbf, gamma=gamma: _cbc_gp(cbf, gamma, fu, n, u),
                x1, u0) for cbf, gamma in zip(cbfs, cfg.cbf_gammas)]
            return clc, cbcs

        clc, cbcs = torch.func.vmap(
            one, in_dims=(0, 0, 0, None if state is None else 0))(
                x, goal, dplan, state)
        G_rows = [G_obj.expand(batch, -1, -1)]
        h_rows = [h_obj.expand(batch, -1)]
        dims = [m + 2]
        for i, ((bfe, e), (V, bfv, v), _, _) in enumerate([clc] + cbcs):
            # the CLC (first) takes the relax slack
            A, b, bfc, d = cbc_to_socp_cone(bfe, e, V, bfv, v, extravars=2,
                                            relax_col=0 if i == 0 else -1)
            G_rows.append(torch.cat([-bfc[:, None], -rho * A], 1))
            h_rows.append(torch.cat([d[:, None], rho * b], 1))
            dims.append(m + 2)
    sol = solve_socp(cobj, torch.cat(G_rows, 1), torch.cat(h_rows, 1),
                     tuple(dims), iters=cfg.socp_iters)
    feas_tol = (cfg.feas_tol if dtype == torch.float64
                else max(cfg.feas_tol, 5e-3))
    feasible = (sol.pres < feas_tol) & torch.isfinite(sol.x).all(-1)
    count_gate(feasible)
    u_opt = torch.where(feasible[:, None], sol.x[:, :m],
                        uref.expand(batch, m))
    stack = lambda i: (torch.stack([c[i] for c in cbcs], 1) if cbcs
                       else x.new_zeros((batch, 0)))
    info = ControlInfo(
        rho=torch.full((batch,), rho, dtype=dtype, device=device),
        relax=sol.x[:, m], pcost=sol.pcost, pres=sol.pres, dres=sol.dres,
        feasible=feasible, clc_mean=clc[2], clc_var=clc[3],
        cbc_means=stack(2), cbc_vars=stack(3))
    return u_opt, info


class MeanCLFControllerConfig(NamedTuple):
    """The deterministic mean-CLF/CBF QP on a known control-affine model."""
    u_dim: int = 2
    clf_gamma: float = 10.0
    clf_relax_weight: float = 10.0
    cbf_gammas: Tuple[float, ...] = ()
    ctrl_lo: Tuple[float, ...] = (-10.0, -math.pi * 5)
    ctrl_hi: Tuple[float, ...] = (10.0, math.pi * 5)
    socp_iters: int = 25


@lru_cache(maxsize=16)
def _mean_clf_constants(cfg: MeanCLFControllerConfig, dtype, device):
    """(objective vector (nvar,), the epigraph cone's rows G (m+2, nvar)
    and h (m+2,), the box rows G (2m, nvar) and h (2m,)) over the
    variables [u (m), relax, t]."""
    m = cfg.u_dim
    nvar = m + 2
    # ||[2u; t - 1]|| <= t + 1, as rows h - G x = [t + 1; 2u; t - 1]
    G_obj = [[0.0] * nvar for _ in range(m + 2)]
    G_obj[0][m + 1] = G_obj[m + 1][m + 1] = -1.0
    for i in range(m):
        G_obj[1 + i][i] = -2.0
    h_obj = [1.0] + [0.0] * m + [-1.0]
    # u_i - lo_i >= 0, hi_i - u_i >= 0
    G_box, h_box = [], []
    for i, (lo, hi) in enumerate(zip(cfg.ctrl_lo, cfg.ctrl_hi)):
        G_box += [[-1.0 if j == i else 0.0 for j in range(nvar)],
                  [1.0 if j == i else 0.0 for j in range(nvar)]]
        h_box += [-lo, hi]
    cobj = [0.0] * m + [cfg.clf_relax_weight, 1.0]
    kw = dict(dtype=dtype, device=device)
    return tuple(torch.tensor(a, **kw)
                 for a in (cobj, G_obj, h_obj, G_box, h_box))


def mean_clf_socp(cfg: MeanCLFControllerConfig, clf, cbfs, planner,
                  f_func, g_func, x, t):
    """The batch of step-t mean-CLF SOCPs of states x (B, n) of the model
    (f_func, g_func): (cobj (nvar,), G (B, M, nvar), h (B, M), dims) over
    [u (m), relax, t], with

        CLC:  grad V (f + g u) + grad_goal V dot_plan + gamma V <= relax,
        CBC:  grad h_k (f + g u) + gamma_k h_k >= 0,

    the box, and the rotated-cone epigraph u^T u <= t  <=>
    ||[2u; t - 1]|| <= t + 1: cones of dimensions (m + 2, 1, ...), one ray
    for the CLC, each CBF and each bound."""
    m = cfg.u_dim
    batch = x.shape[0]
    goal = planner.plan(t)
    fx, gx = f_func(x), g_func(x)
    V, gclf, ggoal = clf.value_and_grads(x, goal)
    clc_a = (gclf[:, None] @ gx)[:, 0]
    clc_b = ((gclf * fx).sum(-1) + (ggoal * planner.dot_plan(t)).sum(-1)
             + cfg.clf_gamma * V)
    cobj, G_obj, h_obj, G_box, h_box = _mean_clf_constants(cfg, x.dtype,
                                                           x.device)
    zero, one = x.new_zeros((batch, 1)), x.new_ones((batch, 1))
    G_rows = [G_obj.expand(batch, -1, -1),
              torch.cat([clc_a, -one, zero], -1)[:, None]]
    h_rows = [h_obj.expand(batch, -1), -clc_b[:, None]]
    for cbf, gamma in zip(cbfs, cfg.cbf_gammas):
        h, gh = cbf.value_and_grad(x)
        G_rows.append(torch.cat([-(gh[:, None] @ gx)[:, 0], zero, zero],
                                -1)[:, None])
        h_rows.append(((gh * fx).sum(-1) + gamma * h)[:, None])
    G_rows.append(G_box.expand(batch, -1, -1))
    h_rows.append(h_box.expand(batch, -1))
    G, h = torch.cat(G_rows, 1), torch.cat(h_rows, 1)
    return cobj, G, h, (m + 2,) + (1,) * (G.shape[1] - m - 2)


def mean_clf_control(cfg: MeanCLFControllerConfig, clf, cbfs, planner,
                     f_func, g_func, x, t):
    """min ||u||^2 + w_relax relax  s.t.  CLC <= relax, CBC_k >= 0, box
    (`mean_clf_socp`), solved cold at cfg.socp_iters iterations.  Returns
    (u (B, m), the SOCPSolution)."""
    cobj, G, h, dims = mean_clf_socp(cfg, clf, cbfs, planner, f_func,
                                     g_func, x, t)
    sol = solve_socp(cobj, G, h, dims, iters=cfg.socp_iters)
    return sol.x[:, :cfg.u_dim], sol
