"""Batched Monte-Carlo episodes of the unicycle Bayes-CBF experiment, and
the self-triggered-interval sweep along an episode.

N episodes from perturbed starts run as one batch split over the mesh's
devices, with aggregate safety statistics; the sweep turns an episode's
logged kernel hyperparameters (its `knl` channels) into the Lipschitz
bound and the interval tau of each step it samples.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..observability.trigger import per_step_cbf_grad_max, trigger_intervals
from ..parallel.mesh import batched_rollouts, make_mesh, rollout_safety_stats
from .unicycle import (STATE_GOAL, STATE_START, make_ackermann_tracking_sim,
                       unicycle_learning_helps_avoid_getting_stuck)


def monte_carlo_unicycle(n_rollouts: int = 1024, start_noise: float = 0.05,
                         seed: int = 0, mesh: Optional[tuple] = None,
                         x0s=None, state0=None, draws=None, **sim_kw):
    """n_rollouts Bayes-CBF episodes from STATE_START + start_noise
    N(0, 1) starts, split over the mesh (default: `make_mesh` of the
    sim's device type).  The sim's defaults here: 500 steps, dt 0.004,
    max_train 64, 30 Adam iterations; the other keywords go to
    `make_ackermann_tracking_sim` (device and dtype among them).

    The start noise, then the initial learner state and the reservoir
    draws, come from a generator seeded with `seed` on the sim's device,
    unless given as x0s (B, 3), state0 and draws (T, B)
    (`batched_rollouts`).  Returns (sim, outputs (B, T, ...), stats: the
    0-d tensors of `rollout_safety_stats`)."""
    sim_kw.setdefault("numSteps", 500)
    sim_kw.setdefault("dt", 0.004)
    sim_kw.setdefault("max_train", 64)
    sim_kw.setdefault("training_iter", 30)
    sim = make_ackermann_tracking_sim(**sim_kw)
    p0 = sim.planner.p0
    gen = torch.Generator(device=p0.device).manual_seed(seed)
    start = torch.tensor(STATE_START, dtype=p0.dtype, device=p0.device)
    if x0s is None:
        x0s = start[None] + start_noise * torch.randn(
            (n_rollouts, 3), generator=gen, dtype=p0.dtype, device=p0.device)
    else:
        x0s = torch.as_tensor(x0s).to(device=p0.device, dtype=p0.dtype)
    if mesh is None:
        mesh = make_mesh(device_type=p0.device.type)
    outs = batched_rollouts(sim, x0s, gen, mesh, state0, draws)
    centers = torch.stack([c.center for c in sim.cbfs])
    radii = torch.tensor([c.radius for c in sim.cbfs], dtype=p0.dtype,
                         device=p0.device)
    stats = rollout_safety_stats(outs, centers, radii, torch.tensor(
        STATE_GOAL, dtype=p0.dtype, device=p0.device))
    return sim, outs, stats


def trigger_sweep_for_rollout(sim, outs, rollout_idx: int = 0,
                              stride: int = 10, seed: int = 0,
                              lengthscale=None, outputscale=None, A=None,
                              B=None, draws: Optional[torch.Tensor] = None):
    """The self-triggered interval tau along every `stride`-th step of
    episode `rollout_idx` of a batch of outputs (B, T, ...): returns
    (tau, tau_num, Lfh, Lfh_num, |xdot|), each (ceil(T / stride),).

    The kernel hyperparameters come from the explicit arguments (per
    sampled step), else from the outputs' `knl` channels (sf = sqrt of
    the MVGP's outputscale, which is a variance), else unit scales and
    identity A and B, with a warning: then tau reflects no learned model.
    Lh is `per_step_cbf_grad_max` of the sim's barriers.  The Gaussian
    draws of Lfh_num come from a generator seeded with `seed` on the
    outputs' device, or are `draws` (T', E, N)."""
    sel = lambda a: a[rollout_idx][::stride]
    X, U, Xdot = sel(outs.X), sel(outs.U), sel(outs.Xdot)
    T, n = X.shape
    mh = U.shape[-1] + 1
    kw = dict(dtype=X.dtype, device=X.device)
    knl = getattr(outs, "knl", None)
    if knl is not None and lengthscale is None:
        lengthscale = sel(knl.lengthscale)
        outputscale = torch.sqrt(sel(knl.outputscale))
        A, B = sel(knl.A), sel(knl.B)
    if lengthscale is None:
        warnings.warn(
            "trigger_sweep_for_rollout: no kernel channels on the rollout "
            "and none passed; falling back to identity-prior "
            "hyperparameters, so tau does not reflect a learned model.")
    ls = torch.ones((T, n), **kw) if lengthscale is None else lengthscale
    sf = torch.ones((T,), **kw) if outputscale is None else outputscale
    A_ = torch.eye(n, **kw).expand(T, n, n) if A is None else A
    B_ = torch.eye(mh, **kw).expand(T, mh, mh) if B is None else B
    gen = None
    if draws is None:
        gen = torch.Generator(device=X.device).manual_seed(seed)
    return trigger_intervals(X, Xdot, U, sf, ls, A_, B_,
                             per_step_cbf_grad_max(X, sim.cbfs), gen,
                             draws=draws)


def trigger_analysis_learning_run(stride: int = 10, seed: int = 0,
                                  sweep_draws: Optional[torch.Tensor] = None,
                                  **exp_kw):
    """The self-triggered analysis of the learning episode: run
    `unicycle_learning_helps_avoid_getting_stuck(**exp_kw)` and sweep its
    logged kernel hyperparameters (`trigger_sweep_for_rollout`, draws
    from `seed`, or `sweep_draws`).  Returns (sim, outputs (T, ...), stats): tau, tau_num,
    Lfh, Lfh_num and the moving-step mask as numpy arrays, and the min /
    median / max of tau and Lfh over the moving steps (|xdot| > 1e-8; a
    stationary step has tau -> inf)."""
    sim, out = unicycle_learning_helps_avoid_getting_stuck(**exp_kw)
    batch1 = out._replace(X=out.X[None], U=out.U[None], Xdot=out.Xdot[None],
                          knl=type(out.knl)(*(a[None] for a in out.knl)))
    tau, tau_num, Lfh, Lfh_num, xvel = trigger_sweep_for_rollout(
        sim, batch1, rollout_idx=0, stride=stride, seed=seed,
        draws=sweep_draws)
    t, L = tau.cpu().numpy(), Lfh.cpu().numpy()
    moving = xvel.cpu().numpy() > 1e-8
    stats = {
        "tau": t, "tau_num": tau_num.cpu().numpy(),
        "Lfh": L, "Lfh_num": Lfh_num.cpu().numpy(), "moving": moving,
        "tau_min": float(np.min(t[moving])),
        "tau_median": float(np.median(t[moving])),
        "tau_max": float(np.max(t[moving])),
        "Lfh_min": float(np.min(L[moving])),
        "Lfh_median": float(np.median(L[moving])),
        "Lfh_max": float(np.max(L[moving])),
    }
    return sim, out, stats
