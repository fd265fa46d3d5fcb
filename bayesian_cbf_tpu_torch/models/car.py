"""Car models, batched over states: the second-order unicycle, the 9-state
Hyundai Genesis linear-tire Ackermann model, and the relative-degree-2
circular-obstacle CBC.

Genesis state X = [x, y, th, vx, vy, w, a, cos d, sin d], control
U = [accel, cos steer, sin steer].  Every function takes a leading batch
axis.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class SecondOrderUnicycle(NamedTuple):
    """X = [vx, vy, w, x, y, th], u = [a, alpha]:
    dX = [0, 0, 0, vx, vy, w] + [[cos th, 0], [sin th, 0], [0, 1], 0...] u.
    """
    state_size: int = 6
    ctrl_size: int = 2

    def f_func(self, X):
        z = torch.zeros_like(X[:, :3])
        return torch.cat([z, X[:, :3]], -1)

    def g_func(self, X):
        th = X[:, 5]
        z, o = torch.zeros_like(th), torch.ones_like(th)
        rows = [(torch.cos(th), z), (torch.sin(th), z), (z, o)] + [(z, z)] * 3
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    def F_func(self, X):
        return torch.cat([self.f_func(X)[..., None], self.g_func(X)], -1)

    def step(self, X, u, dt):
        xdot = self.f_func(X) + (self.g_func(X) @ u[..., None])[..., 0]
        return X + xdot * dt, xdot


class HyundaiGenesisParams(NamedTuple):
    lf: float = 1.5213
    lr: float = 1.4987
    half_width: float = 0.945
    mass: float = 2303.1
    Iz: float = 5520.1
    C_alpha_f: float = 7.6419e4 * 2
    C_alpha_r: float = 13.4851e4 * 2
    accel_tc: float = 0.4
    steer_tc: float = 0.1


def _unit_angle(c, s):
    """(cos a, sin a) of a = atan2(s, c): the pair put back on the unit
    circle."""
    ang = torch.atan2(s, c)
    return torch.cos(ang), torch.sin(ang)


class HyundaiGenesisDynamics(NamedTuple):
    """The 9-state control-affine form of the linear-tire Ackermann car.
    `step` applies the first-order control delay once, then `disc_steps`
    Euler sub-steps with the held internal control, the steering encoding
    put back on the unit circle after each."""
    param: HyundaiGenesisParams = HyundaiGenesisParams()
    dt: float = 0.01
    disc_steps: int = 10
    state_size: int = 9
    ctrl_size: int = 3

    def _tire_forces(self, X):
        """Linear tire model; zero at |vx| <= 1 m/s."""
        p = self.param
        vx, vy, w = X[:, 3], X[:, 4], X[:, 5]
        steer = torch.atan2(X[:, 8], X[:, 7])
        moving = torch.abs(vx) > 1.0
        zero = torch.zeros_like(vx)
        alpha_f = torch.where(moving,
                              steer - torch.atan2(vy + p.lf * w, vx), zero)
        alpha_r = torch.where(moving, -torch.atan2(vy - p.lr * w, vx), zero)
        return p.C_alpha_f * alpha_f, p.C_alpha_r * alpha_r

    def f_func(self, X):
        p = self.param
        th, vx, vy, w = X[:, 2], X[:, 3], X[:, 4], X[:, 5]
        _, Fyr = self._tire_forces(X)
        z = torch.zeros_like(th)
        return torch.stack([
            vx * torch.cos(th) - vy * torch.sin(th),
            vx * torch.sin(th) + vy * torch.cos(th),
            w, w * vy, Fyr / p.mass - w * vx, -p.lr * Fyr / p.Iz,
            z, z, z], -1)

    def g_func(self, X):
        p = self.param
        Fyf, _ = self._tire_forces(X)
        z, o = torch.zeros_like(Fyf), torch.ones_like(Fyf)
        rows = [(z, z, z)] * 3 + [
            (o, z, -Fyf / p.mass), (z, Fyf / p.mass, z),
            (z, p.lf * Fyf / p.Iz, z), (o, z, z), (z, o, z), (z, z, o)]
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    def F_func(self, X):
        return torch.cat([self.f_func(X)[..., None], self.g_func(X)], -1)

    def _control_delay(self, X, U):
        """The first-order lag toward the commanded (accel, steer), as dU
        in the [da, cos ds, sin ds] encoding."""
        p = self.param
        sd = torch.atan2(U[:, 2], U[:, 1])
        steer = torch.atan2(X[:, 8], X[:, 7])
        da = self.dt / (self.dt + p.accel_tc) * (U[:, 0] - X[:, 6])
        ds = self.dt / (self.dt + p.steer_tc) * (sd - steer)
        return torch.stack([da, torch.cos(ds), torch.sin(ds)], -1)

    def _apply_inc(self, X, dU):
        c, s = _unit_angle(X[:, 7] + dU[:, 1], X[:, 8] + dU[:, 2])
        return torch.cat([X[:, :6], torch.stack([X[:, 6] + dU[:, 0], c, s],
                                                -1)], -1)

    def step(self, X, U, dt=None):
        """One control period: (X', (X' - X) / dt), where X is the state
        after the control delay."""
        dt = self.dt if dt is None else dt
        h = dt / self.disc_steps
        X = self._apply_inc(X, self._control_delay(X, U))
        Ut = X[:, 6:9]
        Xn = X
        for _ in range(self.disc_steps):
            xdot = self.f_func(Xn) + (self.g_func(Xn) @ Ut[..., None])[..., 0]
            Xn = Xn + xdot * h
            c, s = _unit_angle(Xn[:, 7], Xn[:, 8])
            Xn = torch.cat([Xn[:, :7], torch.stack([c, s], -1)], -1)
        return Xn, (Xn - X) / dt

    def init_state(self, batch: int = 1, device="cuda",
                   dtype=torch.float32):
        """At rest at the origin, steering angle 0: (batch, 9)."""
        X = torch.zeros((batch, 9), dtype=dtype, device=device)
        X[:, 7] = 1.0
        return X


class CircularObstacleCBC(NamedTuple):
    """Relative-degree-2 CBC of a circular obstacle for car states whose
    position is X[:, pos_idx]: h = |pos - center|^2 - radius^2, with its
    Lie derivatives along a model's f and g by `torch.func.grad`.  The
    constraint is A(X) u <= b(X)."""
    center: torch.Tensor               # (2,)
    radius: float
    k_alpha: Tuple[float, float] = (2.0, 3.0)
    pos_idx: Tuple[int, int] = (0, 1)
    max_unsafe_prob: float = 0.01

    def cbf(self, X):
        pos = X[:, list(self.pos_idx)]
        return torch.sum((pos - self.center) ** 2, -1) - self.radius ** 2

    def grad_cbf(self, X):
        return torch.func.grad(lambda Z: self.cbf(Z).sum())(X)

    def lie_f(self, model, X):
        return torch.sum(self.grad_cbf(X) * model.f_func(X), -1)

    def grad_lie_f(self, model, X):
        return torch.func.grad(lambda Z: self.lie_f(model, Z).sum())(X)

    def lie2_f(self, model, X):
        return torch.sum(self.grad_lie_f(model, X) * model.f_func(X), -1)

    def lie_g_lie_f(self, model, X):
        return (self.grad_lie_f(model, X)[:, None] @ model.g_func(X))[:, 0]

    def A(self, model, X):
        return -self.lie_g_lie_f(model, X)

    def b(self, model, X):
        return self.A_b(model, X)[1]

    def A_b(self, model, X):
        """(A (B, m), b (B,)) from one evaluation of the Lie derivatives:
        A = -L_g L_f h, b = L_f^2 h + k_alpha . (h, L_f h)."""
        def lie(Z):
            lf = self.lie_f(model, Z)
            return lf.sum(), lf
        glf, lf = torch.func.grad(lie, has_aux=True)(X)
        k0, k1 = self.k_alpha
        A = -(glf[:, None] @ model.g_func(X))[:, 0]
        b = (torch.sum(glf * model.f_func(X), -1)
             + (k0 * self.cbf(X) + k1 * lf))
        return A, b
