"""Pendulum CLF/CBF function objects with analytic gradients and Lie
derivatives, batched over states x (B, 2) = (theta, omega)."""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..models.dynamics import PendulumDynamics


class EnergyCLF(NamedTuple):
    """V = l omega^2 / 2 + g (1 - cos theta); affine constraint
    A(x) u <= b(x) with A = grad_V g, b = -grad_V f - c V."""
    model: PendulumDynamics = PendulumDynamics()
    clf_c: float = 1.0

    def V_clf(self, x):
        g, l = self.model.gravity, self.model.length
        return l * x[:, 1] ** 2 / 2.0 + g * (1.0 - torch.cos(x[:, 0]))

    def grad_V_clf(self, x):
        g, l = self.model.gravity, self.model.length
        return torch.stack([g * torch.sin(x[:, 0]), l * x[:, 1]], -1)

    def A(self, x):
        return (self.grad_V_clf(x)[:, None] @ self.model.g_func(x))[:, 0]

    def b(self, x):
        return (-torch.sum(self.grad_V_clf(x) * self.model.f_func(x), -1)
                - self.clf_c * self.V_clf(x))


class RadialCBF(NamedTuple):
    """Relative-degree-1 collision barrier
    h = (cos delta - cos(theta - theta_c)) (omega^2 + 1)."""
    model: PendulumDynamics = PendulumDynamics()
    cbf_col_gamma: float = 1.0
    cbf_col_delta: float = math.pi / 8
    cbf_col_theta: float = math.pi / 4

    def h_col(self, x):
        return ((math.cos(self.cbf_col_delta)
                 - torch.cos(x[:, 0] - self.cbf_col_theta))
                * (x[:, 1] ** 2 + 1.0))

    def grad_h_col(self, x):
        d = x[:, 0] - self.cbf_col_theta
        w = x[:, 1]
        return torch.stack([torch.sin(d) * (w ** 2 + 1.0),
                            2.0 * w * (math.cos(self.cbf_col_delta)
                                       - torch.cos(d))], -1)

    def A(self, x):
        return -(self.grad_h_col(x)[:, None] @ self.model.g_func(x))[:, 0]

    def b(self, x):
        return (torch.sum(self.grad_h_col(x) * self.model.f_func(x), -1)
                + self.cbf_col_gamma * self.h_col(x))


class RadialCBFRelDegree2(NamedTuple):
    """Relative-degree-2 collision barrier h = cos delta - cos(theta -
    theta_c) with its gradient, Hessian and analytic Lie derivatives."""
    model: PendulumDynamics = PendulumDynamics()
    k_alpha: Tuple[float, float] = (1.0, 3.0)
    cbf_col_delta: float = math.pi / 8
    cbf_col_theta: float = math.pi / 4
    max_unsafe_prob: float = 0.01

    def cbf(self, x):
        return math.cos(self.cbf_col_delta) - torch.cos(
            x[:, 0] - self.cbf_col_theta)

    def grad_cbf(self, x):
        s = torch.sin(x[:, 0] - self.cbf_col_theta)
        return torch.stack([s, torch.zeros_like(s)], -1)

    def hess_cbf(self, x):
        H = x.new_zeros((x.shape[0], 2, 2))
        H[:, 0, 0] = torch.cos(x[:, 0] - self.cbf_col_theta)
        return H

    def lie_f_cbf(self, x):
        return x[:, 1] * torch.sin(x[:, 0] - self.cbf_col_theta)

    def lie2_f_h_col(self, x):
        th, w = x[:, 0], x[:, 1]
        g, l = self.model.gravity, self.model.length
        return (w ** 2 * torch.cos(th - self.cbf_col_theta)
                - (g / l) * torch.sin(th - self.cbf_col_theta)
                * torch.sin(th))

    def lie_g_lie_f_h_col(self, x):
        m, l = self.model.mass, self.model.length
        return (1.0 / (m * l)) * torch.sin(x[:, 0] - self.cbf_col_theta)

    def A(self, x):
        """Ground-truth affine CBC2: A(x) u <= b(x); (B, 1)."""
        return -self.lie_g_lie_f_h_col(x)[:, None]

    def b(self, x):
        ka0, ka1 = self.k_alpha
        return (self.lie2_f_h_col(x) + ka0 * self.cbf(x)
                + ka1 * self.lie_f_cbf(x))
