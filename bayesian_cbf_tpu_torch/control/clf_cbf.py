"""Unicycle CLF / CBF function objects, batched over a leading axis.

Gradients are closed forms of the scalar definitions (the tests hold them
against `jax.grad` of the JAX package's definitions).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.func import normalize_radians


def angdiff(a, b):
    return normalize_radians(a - b)


def _polar_parts(state, state_goal):
    dx = state_goal[..., 0] - state[..., 0]
    dy = state_goal[..., 1] - state[..., 1]
    rho = torch.sqrt(dx * dx + dy * dy)
    phi = torch.atan2(dy, dx)
    alpha = angdiff(state[..., 2], phi)
    beta = angdiff(state_goal[..., 2], phi)
    return dx, dy, rho, alpha, beta


def _position_gap(state, state_goal):
    return torch.linalg.vector_norm(state_goal[..., :2] - state[..., :2],
                                    dim=-1)


def cartesian2polar(state, state_goal):
    """(x, y, theta), goal -> (rho, alpha, beta), (..., 3)."""
    _, _, rho, alpha, beta = _polar_parts(state, state_goal)
    return torch.stack([rho, alpha, beta], -1)


def polar2cartesian(polar, state_goal):
    """(rho, alpha, beta), goal -> (x, y, theta), (..., 3)."""
    rho, alpha, beta = polar[..., 0], polar[..., 1], polar[..., 2]
    phi = angdiff(state_goal[..., 2], beta)
    theta = normalize_radians(phi + alpha)
    return torch.stack([state_goal[..., 0] - rho * torch.cos(phi),
                        state_goal[..., 1] - rho * torch.sin(phi), theta], -1)


class CLFCartesian(NamedTuple):
    """V(x; x_g) = 1/2 Kp0 rho^2 + Kp1 (1 - cos alpha) + Kp2 (1 - cos beta)."""
    Kp: tuple = (0.9, 1.5, 0.0)

    def clf_terms(self, state, state_goal):
        """The three terms of V, (..., 3)."""
        _, _, rho, alpha, beta = _polar_parts(state, state_goal)
        K0, K1, K2 = self.Kp
        return torch.stack([0.5 * K0 * rho ** 2,
                            K1 * (1.0 - torch.cos(alpha)),
                            K2 * (1.0 - torch.cos(beta))], -1)

    def isconverged(self, state, state_goal, tol=1e-3):
        """Within tol of the goal's position, (...,) bool."""
        return _position_gap(state, state_goal) < tol

    def value_and_grads(self, state, state_goal):
        """(V, dV/d state, dV/d goal), each over the leading axes."""
        dx, dy, rho, alpha, beta = _polar_parts(state, state_goal)
        K0, K1, K2 = self.Kp
        sa, sb = torch.sin(alpha), torch.sin(beta)
        V = (0.5 * K0 * rho ** 2 + K1 * (1.0 - torch.cos(alpha))
             + K2 * (1.0 - torch.cos(beta)))
        # d alpha / d(x, y) = d beta / d(x, y) = (-dy, dx) / rho^2
        ang = (K1 * sa + K2 * sb) / (rho * rho)
        gx = torch.stack([-K0 * dx - ang * dy, -K0 * dy + ang * dx, K1 * sa],
                         -1)
        gg = torch.stack([K0 * dx + ang * dy, K0 * dy - ang * dx, K2 * sb], -1)
        return V, gx, gg

    def clf(self, state, state_goal):
        return self.value_and_grads(state, state_goal)[0]

    def grad_clf(self, state, state_goal):
        """dV / d state, (..., 3)."""
        return self.value_and_grads(state, state_goal)[1]

    def grad_clf_wrt_goal(self, state, state_goal):
        """dV / d goal, (..., 3)."""
        return self.value_and_grads(state, state_goal)[2]


class CLFPolar(NamedTuple):
    """V(polar) = 1/2 Kp0 rho^2 + Kp1 (1 - cos alpha) + Kp2 (1 - cos beta)
    + Kp3 (1 - cos(beta - alpha)) on polar states (rho, alpha, beta); the
    goal enters only through the polar coordinates."""
    Kp: tuple = (0.6, 1.5, 4.0, 0.0)

    def clf_terms(self, polar, state_goal):
        """The four terms of V, (..., 4)."""
        rho, alpha, beta = polar[..., 0], polar[..., 1], polar[..., 2]
        K0, K1, K2, K3 = self.Kp
        return torch.stack([0.5 * K0 * rho ** 2,
                            K1 * (1.0 - torch.cos(alpha)),
                            K2 * (1.0 - torch.cos(beta)),
                            K3 * (1.0 - torch.cos(beta - alpha))], -1)

    def isconverged(self, state, state_goal, tol=1e-3):
        """Within tol of the goal's position, (...,) bool (the first two
        coordinates of both, as the JAX package reads them)."""
        return _position_gap(state, state_goal) < tol

    def value_and_grads(self, polar, state_goal):
        """(V, dV/d polar, dV/d goal = 0), each over the leading axes."""
        rho, alpha, beta = polar[..., 0], polar[..., 1], polar[..., 2]
        K0, K1, K2, K3 = self.Kp
        V = (0.5 * K0 * rho ** 2 + K1 * (1.0 - torch.cos(alpha))
             + K2 * (1.0 - torch.cos(beta))
             + K3 * (1.0 - torch.cos(beta - alpha)))
        sba = K3 * torch.sin(beta - alpha)
        gx = torch.stack([K0 * rho, K1 * torch.sin(alpha) - sba,
                          K2 * torch.sin(beta) + sba], -1)
        return V, gx, torch.zeros_like(polar)

    def clf(self, polar, state_goal):
        return self.value_and_grads(polar, state_goal)[0]

    def grad_clf(self, polar, state_goal):
        """dV / d polar, (..., 3)."""
        return self.value_and_grads(polar, state_goal)[1]

    def grad_clf_wrt_goal(self, polar, state_goal):
        """Zero, (..., 3)."""
        return self.value_and_grads(polar, state_goal)[2]


class ObstacleCBF(NamedTuple):
    """Circular-obstacle barrier
    h(x) = w0 (|p - c|^2 - r^2) + w1 cos(angle(heading, p - c))."""
    center: torch.Tensor     # (2,)
    radius: float
    term_weights: tuple = (0.5, 0.5)

    def value_and_grad(self, state):
        """(h, dh / d state) over the leading axes."""
        d = state[..., :2] - self.center
        nrm = torch.linalg.vector_norm(d, dim=-1)
        th = state[..., 2]
        c, s = torch.cos(th), torch.sin(th)
        w0, w1 = self.term_weights
        cos_ang = (c * d[..., 0] + s * d[..., 1]) / nrm
        h = w0 * (torch.sum(d * d, -1) - self.radius ** 2) + w1 * cos_ang
        ud = cos_ang / (nrm * nrm)
        g = torch.stack([
            2.0 * w0 * d[..., 0] + w1 * (c / nrm - ud * d[..., 0]),
            2.0 * w0 * d[..., 1] + w1 * (s / nrm - ud * d[..., 1]),
            w1 * (-s * d[..., 0] + c * d[..., 1]) / nrm], -1)
        return h, g

    def cbf(self, state):
        return self.value_and_grad(state)[0]

    def grad_cbf(self, state):
        return self.value_and_grad(state)[1]


def _R90(x):
    return torch.tensor([[0.0, -1.0], [1.0, 0.0]], dtype=x.dtype,
                        device=x.device)


def obstacles_at_mid_from_start_and_goal(x, x_g, term_weights=(0.5, 0.5)):
    """Two obstacles flanking the midpoint of the start -> goal segment.
    x, x_g are (3,) tensors; the centers keep their dtype and device."""
    mid = (x[:2] + x_g[:2]) / 2.0
    off = _R90(x) @ (x[:2] - x_g[:2]) / 3.0
    r = float(torch.linalg.vector_norm(x[:2] - x_g[:2]) / 4.0)
    return [ObstacleCBF(mid + off, r, term_weights),
            ObstacleCBF(mid - off, r, term_weights)]


def single_obstacle_at_mid_from_start_and_goal(x, x_g,
                                               term_weights=(0.5, 0.5)):
    """One obstacle beside the midpoint of the start -> goal segment
    (a tenth of the segment off it, radius an eighth of it)."""
    mid = (x[:2] + x_g[:2]) / 2.0 + _R90(x) @ (x[:2] - x_g[:2]) / 10.0
    r = float(torch.linalg.vector_norm(x[:2] - x_g[:2]) / 8.0)
    return [ObstacleCBF(mid, r, term_weights)]
