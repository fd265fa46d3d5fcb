#!/usr/bin/env python3
"""Where the learning episode's self-triggered intervals come from, on
one NVIDIA card and its host.

  seeds   the learning episode (`unicycle_learning_helps_avoid_getting_
          stuck` at its defaults, f32 on the card) from the generator
          seeded 0, as `chip_smoke.py` phase 11 (e) runs it, and a batch
          of 8 more from the generator seeded 1 (eight other initial
          hyperparameters and reservoir draws);
  replay  the seed-0 episode again from the same initial learner state
          and per-step uniforms (its generator draws the state, then one
          uniform a step): first on the card, which must give the same
          bits, then in f64 on the host, with each logged kernel
          channel's largest relative distance from the card's and the
          hyperparameters after each refit.

    python3 probe_trigger_learning.py [seeds] [replay]

For every episode it prints one JSON object: the final distance to the
goal; the fitted lengthscale and outputscale after the last refit; the
median over the moving steps of the learned amplitude
max_ij A_ii uBu sf^2 / ls_j^2, the quantity the Lipschitz bound Lfh of
Eq. 11 grows with; and the min / median / max of tau and Lfh over the
moving steps (`trigger_sweep_for_rollout`, stride 10, draws from seed 0).
The host replay takes ~5 min of an 8-core CPU.
"""
import json
import sys
import time

import torch

from chip_smoke import _require, phase_device

F32, F64 = torch.float32, torch.float64


def episode_readings(sim, out, b=0, stride=10):
    """The readings of episode b of a batch of outputs (B, T, ...)."""
    from bayesian_cbf_tpu_torch.experiments import montecarlo as mc
    from bayesian_cbf_tpu_torch.experiments.unicycle import STATE_GOAL
    tau, _, Lfh, _, xvel = mc.trigger_sweep_for_rollout(
        sim, out, rollout_idx=b, stride=stride, seed=0)
    moving = xvel > 1e-8
    sel = lambda a: a[b][::stride]
    knl = out.knl
    ls, os_, A = sel(knl.lengthscale), sel(knl.outputscale), sel(knl.A)
    U, Bm = sel(out.U), sel(knl.B)
    uh = torch.cat([torch.ones_like(U[:, :1]), U], 1)
    uBu = torch.einsum("ti,tij,tj->t", uh, Bm, uh)
    Aii = torch.diagonal(A, dim1=-2, dim2=-1)
    amp = (Aii[:, :, None] * (uBu * os_)[:, None, None]
           / ls[:, None, :] ** 2).amax((-2, -1))
    q = lambda a: [float(a[moving].min()), float(a[moving].median()),
                   float(a[moving].max())]
    goal = torch.tensor(STATE_GOAL, dtype=out.X.dtype, device=out.X.device)
    return dict(
        goal_distance=float(torch.linalg.vector_norm(
            out.X[b, -1, :2] - goal[:2])),
        lengthscale_end=knl.lengthscale[b, -1].tolist(),
        outputscale_end=float(knl.outputscale[b, -1]),
        amplitude_median=float(amp[moving].median()),
        moving=int(moving.sum()), tau=q(tau), Lfh=q(Lfh))


def _batch_of_one(out):
    one = lambda a: a[None]
    return out._replace(X=one(out.X), U=one(out.U), Xdot=one(out.Xdot),
                        knl=type(out.knl)(*(one(a) for a in out.knl)))


def _print(tag, card, **fields):
    print(json.dumps(dict(probe=tag, card=card, **fields)), flush=True)


def seeds(dev, card, batch=8, **exp_kw):
    from bayesian_cbf_tpu_torch.experiments import unicycle as tu
    from bayesian_cbf_tpu_torch.sim.rollout import simulate_unicycle_batch
    t0 = time.perf_counter()
    sim, out = tu.unicycle_learning_helps_avoid_getting_stuck(device=dev,
                                                              **exp_kw)
    _print("seed 0", card, wall_s=time.perf_counter() - t0,
           **episode_readings(sim, _batch_of_one(out)))
    x0s = torch.tensor(tu.STATE_START, dtype=F32, device=dev).expand(
        batch, 3).contiguous()
    t0 = time.perf_counter()
    outs = simulate_unicycle_batch(
        sim, x0s, torch.Generator(device=dev).manual_seed(1))
    outs.X.sum().item()
    wall = time.perf_counter() - t0
    for b in range(batch):
        _print(f"seed 1, episode {b}", card, wall_s=wall,
               **episode_readings(sim, outs, b))
    return sim, out


def replay(dev, card, sim, out, **exp_kw):
    from bayesian_cbf_tpu_torch.experiments import unicycle as tu
    from bayesian_cbf_tpu_torch.models.dynamics import _map
    gen = torch.Generator(device=dev).manual_seed(0)
    state0 = sim.learned_dynamics.init_state(1, gen, dev, F32)
    uniforms = torch.stack([torch.rand((1,), generator=gen, dtype=F32,
                                       device=dev)
                            for _ in range(sim.numSteps)])[:, 0]
    _, again = tu.unicycle_learning_helps_avoid_getting_stuck(
        device=dev, state0=state0, draws=uniforms, **exp_kw)
    same = torch.equal(again.X, out.X) and torch.equal(again.U, out.U)
    _print("replay on the card", card, same_bits=same)
    _require(same, "the card's replay left the episode's bits")
    host = lambda a: a.to("cpu", F64) if a.is_floating_point() else a.cpu()
    t0 = time.perf_counter()
    # the uniforms stay f32, so the reservoir draws are the card's
    sim64, out64 = tu.unicycle_learning_helps_avoid_getting_stuck(
        device="cpu", dtype=F64, state0=_map(host, state0),
        draws=uniforms.cpu(), **exp_kw)
    wall = time.perf_counter() - t0
    dist = {}
    for f in out.knl._fields:
        a, b = getattr(out.knl, f).cpu().double(), getattr(out64.knl, f)
        dist[f] = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
    T, every = sim.numSteps, sim.learned_dynamics.train_every_n_steps
    refits = {t + 1: dict(
        card=[float(out.knl.outputscale[t + 1])]
        + out.knl.lengthscale[t + 1].tolist(),
        host=[float(out64.knl.outputscale[t + 1])]
        + out64.knl.lengthscale[t + 1].tolist())
        for t in range(every, T - 1, every)}
    _print("replay in f64 on the host", card, wall_s=wall,
           max_abs_dX=float((out.X.cpu().double() - out64.X).abs().max()),
           knl_max_rel_distance=dist,
           outputscale_lengthscale_after_refits=refits,
           **episode_readings(sim64, _batch_of_one(out64)))


def main():
    what = sys.argv[1:] or ["seeds", "replay"]
    dev, card = phase_device()
    from bayesian_cbf_tpu_torch.ops import _build
    _build.build_all(_build.KERNEL_SOURCES)
    sim, out = seeds(dev, card) if "seeds" in what else (None, None)
    if "replay" in what:
        if sim is None:
            from bayesian_cbf_tpu_torch.experiments import unicycle as tu
            sim, out = tu.unicycle_learning_helps_avoid_getting_stuck(
                device=dev)
        replay(dev, card, sim, out)


if __name__ == "__main__":
    main()
