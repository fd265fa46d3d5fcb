"""Batched rollout of the learn-and-control loop.

Each step runs, for every episode of the batch at once: posterior
moments -> closed-form cones -> SOCP (one IPM launch) -> reservoir record
-> Euler step of the true dynamics.  The rollout is cut into segments at
the static refit steps (`fit_segments`); between segments the learner
refits every episode with a non-empty reservoir.  Nothing in the step
loop reads a device value on the host, unless the learner makes the
serving updates (`continuous_updates` with `continuous_full_refresh`),
which read their branch per episode there.  `UnicycleSim.step` is the
serving tick's step (`deploy.CompiledController`): the refit runs inside
it, through `observe`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..control.bayes_controller import (BayesCLFControllerConfig,
                                        ControlInfo, bayes_clf_control,
                                        warm_init)
from ..models.dynamics import (KernelChannels, LearnedDynState,
                               LearnedShiftInvariantDynamics, where_tree)
from ..observability import tracing


class RolloutOutputs(NamedTuple):
    X: torch.Tensor        # (B, T, n) states before each step
    U: torch.Tensor        # (B, T, m) applied controls
    Xdot: torch.Tensor     # (B, T, n)
    info: ControlInfo      # per-step controller diagnostics, (B, T, ...)
    knl: Optional[KernelChannels] = None


class UnicycleSim(NamedTuple):
    """Static description of a unicycle tracking experiment."""
    true_dynamics: NamedTuple
    learned_dynamics: LearnedShiftInvariantDynamics
    controller: BayesCLFControllerConfig
    clf: NamedTuple
    cbfs: tuple
    planner: NamedTuple
    dt: float
    numSteps: int

    def init_state(self, x0s, generator: torch.Generator):
        """(x0s, learner state, IPM warm state) for a batch x0s (B, n)."""
        dyn = self.learned_dynamics.init_state(
            x0s.shape[0], generator, x0s.device, x0s.dtype)
        return x0s, dyn, self._warm0(x0s, dyn)

    def _warm0(self, x0s, dyn_state: LearnedDynState):
        """IPM start for step 0: a cold solve at the full iteration count
        when warm starts are on, else the cold point itself."""
        w0 = warm_init(self.controller, len(self.cbfs), x0s.shape[0],
                       x0s.device, x0s.dtype)
        if not self.controller.warm_start:
            return w0
        cfg_full = self.controller._replace(
            socp_iters_warm=self.controller.socp_iters)
        mom = self.learned_dynamics.moments(dyn_state, x0s)
        return bayes_clf_control(cfg_full, self.clf, self.cbfs, self.planner,
                                 mom, x0s, 0, warm=w0)[2]

    @tracing.spanned("step")
    def _step_impl(self, carry, t: int, learn_fn, j, generator):
        x, dyn = carry[0], carry[1]
        warm = carry[2] if len(carry) == 3 else None
        lrn = self.learned_dynamics
        mom = lrn.moments(dyn, x)
        out = bayes_clf_control(self.controller, self.clf, self.cbfs,
                                self.planner, mom, x, t, warm=warm)
        u, info = out[0], out[1]
        knl = lrn.kernel_channels(dyn, mom, u)
        dyn = learn_fn(dyn, x, u, j=j, generator=generator)
        x_next, xdot = self.true_dynamics.step(x, u, self.dt)
        new = (x_next, dyn) if warm is None else (x_next, dyn, out[2])
        return new, (x, u, xdot, info, knl)

    def step(self, carry, t: int, j: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        """One control step of every episode: posterior moments -> cones
        -> SOCP -> `observe` (record, and the scheduled refit at the full
        budget) -> Euler step of the true dynamics.  carry is (x (B, n),
        learner state), ending with the IPM warm state (x, S, Z) when
        the controller warm-starts.  j (B,): the reservoir draws, else
        drawn from `generator`.  Returns (carry, (x, u, xdot, info,
        kernel channels))."""
        return self._step_impl(carry, t, self.learned_dynamics.observe, j,
                               generator)

    def step_no_fit(self, carry, t: int, j: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """`step` with `record` in place of `observe`: no refit."""
        return self._step_impl(carry, t, self.learned_dynamics.record, j,
                               generator)


def fit_segments(numSteps: int, train_every: int, enable: bool):
    """Static refit schedule [(start, end_exclusive, fit_after), ...]: a
    fit after every step t that is a positive multiple of train_every."""
    if not enable or train_every <= 0:
        return [(0, numSteps, False)]
    segs = []
    start = 0
    for b in range(train_every, numSteps, train_every):
        segs.append((start, b + 1, True))
        start = b + 1
    if start < numSteps:
        segs.append((start, numSteps, False))
    return segs


def _stack_steps(ys):
    """Per-step trees stacked on a new step axis 1 (None leaves stay
    None)."""
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(ys, 1)
    vals = [_stack_steps([y[i] for y in ys]) for i in range(len(first))]
    return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)


def first_episode(tree):
    """Episode 0 of a batched tree of tensors (None leaves stay None)."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree[0]
    vals = [first_episode(v) for v in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def _rollout(sim: UnicycleSim, x0s, generator, state0, draws):
    """The batched loop: (RolloutOutputs (B, T, ...), final learner
    state)."""
    lrn = sim.learned_dynamics
    if state0 is None:
        _, states, warms = sim.init_state(x0s, generator)
    else:
        states, warms = state0, sim._warm0(x0s, state0)
    warm_on = sim.controller.warm_start

    carry = (x0s, states) + ((warms,) if warm_on else ())
    ys = []
    fit_event = 0
    for (s, e, do_fit) in fit_segments(sim.numSteps, lrn.train_every_n_steps,
                                       lrn.enable_learning):
        for t in range(s, e):
            carry, y = sim.step_no_fit(carry, t,
                                       None if draws is None else draws[t],
                                       generator)
            ys.append(y)
        if do_fit:
            # the first event runs the first-fit program, later ones the
            # warm refit; episodes with an empty reservoir keep their state
            fit = lrn.fit_now_first if fit_event == 0 else lrn.fit_now_warm
            states = carry[1]
            with tracing.span("fit"):
                states = where_tree(states.count_res > 0, fit(states),
                                    states)
            carry = (carry[0], states) + carry[2:]
            fit_event += 1
    Xs, U, Xdot, info, knl = _stack_steps(ys)
    return (RolloutOutputs(X=Xs, U=U, Xdot=Xdot, info=info, knl=knl),
            carry[1])


def simulate_unicycle_batch(sim: UnicycleSim, x0s: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            state0: Optional[LearnedDynState] = None,
                            draws: Optional[torch.Tensor] = None
                            ) -> RolloutOutputs:
    """Run B episodes from x0s (B, n).

    generator: the source of the initial weights and the reservoir draws.
    state0: an initial learner state to start from instead of a fresh one.
    draws: (T, B) reservoir draws to use instead of `generator`: ints, or
    uniforms that the learner's `record` turns into draws."""
    return _rollout(sim, x0s, generator, state0, draws)[0]


def simulate_unicycle_with_state(sim: UnicycleSim, x0,
                                 generator: Optional[torch.Generator] = None,
                                 state0: Optional[LearnedDynState] = None,
                                 draws: Optional[torch.Tensor] = None):
    """One episode from x0 (n,) (on the planner's device, in its dtype),
    run as `simulate_unicycle_batch` at B = 1: (RolloutOutputs (T, ...)
    without the batch axis, the final learner state with its episode axis
    of 1, which `state0` takes back).  The refits follow the batched
    schedule: a fit after every step t that is a positive multiple of
    train_every_n_steps, for a non-empty reservoir, the first event
    `fit_now_first`, later ones `fit_now_warm`.

    generator: the initial weights and the reservoir draws (default: a
    generator seeded with 0 on the planner's device).  state0: an initial
    learner state (episode axis 1) instead of a fresh one.  draws: (T,)
    reservoir draws to use instead of `generator`'s, as `record` takes
    them."""
    p0 = sim.planner.p0
    x0s = torch.as_tensor(x0, dtype=p0.dtype, device=p0.device)[None]
    if generator is None:
        generator = torch.Generator(device=p0.device).manual_seed(0)
    out, state = _rollout(sim, x0s, generator, state0,
                          None if draws is None else draws[:, None])
    return first_episode(out), state


def simulate_unicycle(sim: UnicycleSim, x0,
                      generator: Optional[torch.Generator] = None,
                      state0: Optional[LearnedDynState] = None,
                      draws: Optional[torch.Tensor] = None
                      ) -> RolloutOutputs:
    """One episode from x0 (n,): `simulate_unicycle_with_state` without
    the final learner state; outputs (T, ...)."""
    return simulate_unicycle_with_state(sim, x0, generator, state0,
                                        draws)[0]


def sample_generator_trajectory(dynamics, controller_fn, x0, numSteps: int,
                                dt: float):
    """A rollout of any control-affine model (batch-first, as the port's
    models are): u = controller_fn(x, t), (x', xdot) = dynamics.step(x, u,
    dt), for t < numSteps, from x0 (n,) or a batch (B, n); the controller
    sees x as x0 is shaped.  Returns (Xdot, X, U) stacked on a new
    leading step axis (the reference's sampling.py:49-75)."""
    single = x0.ndim == 1
    x = x0[None] if single else x0
    Xdot, X, U = [], [], []
    for t in range(numSteps):
        u = controller_fn(x[0] if single else x, t)
        x_next, xdot = dynamics.step(x, u[None] if single else u, dt)
        Xdot.append(xdot)
        X.append(x)
        U.append(u[None] if single else u)
        x = x_next
    out = (torch.stack(Xdot), torch.stack(X), torch.stack(U))
    return tuple(a[:, 0] for a in out) if single else out


def sample_generator_independent(dynamics, generator: torch.Generator,
                                 n: int, x_lo, x_hi, u_lo, u_hi,
                                 dtype=torch.float32):
    """n independent (x, u) pairs drawn uniformly from the boxes [x_lo,
    x_hi] and [u_lo, u_hi] (from `generator`, on its device) and their
    xdot = f(x) + g(x) u: (Xdot, X, U) (the reference's
    sampling.py:78-90)."""
    kw = dict(dtype=dtype, device=generator.device)

    def uniform(lo, hi):
        lo, hi = torch.as_tensor(lo, **kw), torch.as_tensor(hi, **kw)
        return lo + (hi - lo) * torch.rand((n, lo.shape[0]),
                                           generator=generator, **kw)

    X = uniform(x_lo, x_hi)
    U = uniform(u_lo, u_hi)
    Xdot = dynamics.f_func(X) + (dynamics.g_func(X) @ U[..., None])[..., 0]
    return Xdot, X, U
