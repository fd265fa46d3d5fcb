"""The serving controller: one control evaluation per plant tick.

`CompiledController(sim, x0)` holds the carry of one episode (the state,
the learner state with its reservoir and posterior cache, and the IPM
warm state when the controller warm-starts) on the device.  Each
`tick(x_measured)` optionally replaces the propagated state by the
measured one, runs plan -> cones -> SOCP -> record -> scheduled refit
(`UnicycleSim.step`, through `observe`: the refit spends the full Adam
budget) and returns the control as a host array with the step's
`ControlInfo`.  The learner lives in the carry, so online learning needs
no host round trip beyond u.

The step runs eagerly: nothing is captured or compiled ahead of the
first tick.  The carry is never donated, but the tick replaces the
tensors the controller owns, so `state()` returns clones and `restore`
clones in.
"""
from __future__ import annotations

from typing import Optional

import torch

from .models.dynamics import _map
from .sim.rollout import first_episode


def _learner(sim):
    """The sim's learned dynamics: only the unicycle sim is served.  The
    JAX package's CompiledController cannot serve a pendulum sim either:
    it calls `sim.init_state(x0, key)` (bayesian_cbf_tpu/deploy.py:80),
    which `PendulumOnlineSim` lacks, and unpacks five step outputs
    (:118) where the pendulum's step returns four
    (experiments/pendulum.py:51-75)."""
    lrn = getattr(sim, "learned_dynamics", None)
    if lrn is not None:
        return lrn
    if getattr(sim, "learned", None) is not None:
        raise NotImplementedError(
            "the serving controller cannot serve a pendulum sim, as the "
            "JAX package's cannot: the pendulum sim has no init_state and "
            "its step returns four outputs, not the unicycle step's five")
    raise ValueError("sim has no learned-dynamics field with a "
                     "continuous_updates flag")


def _with_continuous_updates(sim, flag: bool):
    """`sim` with its learner's continuous_updates flag set."""
    return sim._replace(learned_dynamics=_learner(sim)._replace(
        continuous_updates=flag))


def _clone(tree):
    return _map(lambda a: a.clone(), tree)


class CompiledController:
    """Per-tick controller for serving one episode of a `UnicycleSim`."""

    def __init__(self, sim, x0, generator: Optional[torch.Generator] = None,
                 continuous_updates: Optional[bool] = None, device="cuda"):
        """sim: a `UnicycleSim` whose tensors live on `device`.  x0 (n,):
        the start state.  generator: the initial weights and every
        reservoir draw the ticks do not get (default: seeded with 0 on
        `device`).  continuous_updates=True appends every accepted sample
        to the posterior cache in the tick while the reservoir fills, and
        refreshes the whole cache on each accepted replacement once it is
        full; the scheduled refits still run.  None keeps the sim's own
        flag.  The device is the card unless the caller asks for the
        CPU."""
        _learner(sim)
        if continuous_updates is not None:
            sim = _with_continuous_updates(sim, continuous_updates)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CompiledController runs on the card by "
                               "default and no CUDA device is available; "
                               "pass device=\"cpu\" to run on the CPU")
        p0 = sim.planner.p0
        if p0.device.type != device.type:
            raise ValueError(f"the sim lives on {p0.device}, not on "
                             f"{device}: build it with device={device}")
        self.sim = sim
        self.device = p0.device
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        x0s = torch.as_tensor(x0, dtype=p0.dtype,
                              device=self.device).reshape(1, -1)
        with torch.no_grad():
            x, dyn, warm = sim.init_state(x0s, generator)
        self._carry = (x, dyn) + ((warm,) if sim.controller.warm_start
                                  else ())
        self._step = sim.step
        self._t = 0

    @property
    def t(self) -> int:
        return self._t

    @property
    def x(self):
        """A copy of the state the next tick starts from, (1, n)."""
        return self._live()[0].clone()

    def _live(self):
        if self._carry is None:
            raise RuntimeError(
                "controller state was dropped by a failed tick; call "
                "restore(checkpoint) first")
        return self._carry

    def tick(self, x_measured=None, draw: Optional[int] = None):
        """One control tick.  Returns (u (m,) numpy, ControlInfo of this
        step without the episode axis).

        x_measured (n,): the plant state observed this tick; it replaces
        the propagated state, so the loop stays closed on the real plant.
        None keeps the Euler-propagated one.  draw: this tick's reservoir
        draw (an int on [0, count_res]) instead of the generator's."""
        carry = self._live()
        if x_measured is not None:
            x = torch.as_tensor(x_measured, dtype=carry[0].dtype,
                                device=carry[0].device).reshape(1, -1)
            carry = (x,) + carry[1:]
        j = None if draw is None else torch.tensor(
            [draw], dtype=torch.int32, device=self.device)
        # drop the carry first: a tick that raises leaves an explicit
        # needs-restore state, not a half-updated one
        self._carry = None
        with torch.no_grad():
            new_carry, (_, u, _, info, _) = self._step(
                carry, self._t, j, self.generator)
        self._carry = new_carry
        self._t += 1
        return u[0].cpu().numpy(), first_episode(info)

    def state(self):
        """A copy of the carry (x (1, n), learner state[, warm state]),
        tensors with the episode axis of 1; `observability.logger.
        save_checkpoint` writes it for a warm restart."""
        return _clone(self._live())

    def restore(self, carry) -> None:
        """Install a copy of a carry taken from `state()` (or loaded with
        `observability.logger.load_checkpoint`)."""
        self._carry = _clone(carry)
