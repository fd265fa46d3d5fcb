"""The racecar environment: a dynamic bicycle whose observed state is the
2D pose (x, y, theta), with hidden speed and steering-servo angle,
first-order motor and servo responses and drag.  Controls are normalized
(target wheel speed, steering angle) in [-1, 1].  Its dynamics are not
control-affine in the observed pose, which is the role it plays for the
learning stack.  `RacecarEnv` is a stateful wrapper with
state_size / ctrl_size / step(action, dt) -> dict(x, xdot) /
set_init_state.  States are batched: pose (B, 3), v and delta (B,).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class RacecarState(NamedTuple):
    pose: torch.Tensor    # (B, 3) x, y, theta: the observed state
    v: torch.Tensor       # (B,) longitudinal speed (hidden)
    delta: torch.Tensor   # (B,) steering angle (hidden servo state)


class RacecarDynamics(NamedTuple):
    """Dynamic bicycle with motor and servo lag."""
    wheelbase: float = 0.325
    max_speed: float = 4.0          # action[0] = 1 -> 4 m/s target
    max_steer: float = 0.5          # rad at action[1] = 1
    motor_gain: float = 8.0         # 1/s first-order speed response
    servo_gain: float = 20.0        # 1/s steering servo response
    accel_limit: float = 10.0       # m/s^2 motor force limit
    drag: float = 0.15              # 1/s speed decay

    state_size: int = 3
    ctrl_size: int = 2

    def init_state(self, x0) -> RacecarState:
        """At rest with the wheels straight, at poses x0 (B, 3)."""
        z = torch.zeros_like(x0[:, 0])
        return RacecarState(pose=x0, v=z, delta=z.clone())

    def derivs(self, s: RacecarState, action):
        a = torch.clamp(action, -1.0, 1.0)
        v_t = a[:, 0] * self.max_speed
        d_t = a[:, 1] * self.max_steer
        th = s.pose[:, 2]
        dv = torch.clamp(self.motor_gain * (v_t - s.v), -self.accel_limit,
                         self.accel_limit) - self.drag * s.v
        dd = self.servo_gain * (d_t - s.delta)
        dpose = torch.stack([s.v * torch.cos(th), s.v * torch.sin(th),
                             s.v * torch.tan(s.delta) / self.wheelbase], -1)
        return dpose, dv, dd

    def step(self, s: RacecarState, action, dt,
             substeps: int = 4) -> Tuple[RacecarState, torch.Tensor]:
        """Advance by dt in Euler substeps: (state', the finite-difference
        pose rate (B, 3))."""
        h = dt / substeps
        pose0 = s.pose
        for _ in range(substeps):
            dpose, dv, dd = self.derivs(s, action)
            s = RacecarState(pose=s.pose + h * dpose, v=s.v + h * dv,
                             delta=s.delta + h * dd)
        return s, (s.pose - pose0) / dt


class RacecarEnv:
    """One racecar with a stateful host-side surface; obstacles are
    carried as plain geometry."""

    def __init__(self, dynamics: RacecarDynamics = RacecarDynamics(),
                 obstacle_centers=(), obstacle_radii=(), device="cuda",
                 dtype=torch.float32):
        self.dynamics = dynamics
        self._kw = dict(device=device, dtype=dtype)
        self.obstacle_centers = [torch.tensor(c, **self._kw)
                                 for c in obstacle_centers]
        self.obstacle_radii = list(obstacle_radii)
        self._state = dynamics.init_state(torch.zeros((1, 3), **self._kw))

    @property
    def state_size(self):
        return self.dynamics.state_size

    @property
    def ctrl_size(self):
        return self.dynamics.ctrl_size

    def set_init_state(self, x0):
        self._state = self.dynamics.init_state(
            torch.as_tensor(x0, **self._kw).reshape(1, 3))

    def get2DObs(self):
        return self._state.pose[0]

    def step(self, action, dt):
        """Apply action (2,) for dt: dict(x=pose (3,), xdot=(3,))."""
        self._state, xdot = self.dynamics.step(
            self._state, torch.as_tensor(action, **self._kw).reshape(1, 2),
            dt)
        return dict(x=self._state.pose[0], xdot=xdot[0])
