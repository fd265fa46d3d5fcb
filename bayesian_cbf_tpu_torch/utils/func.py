"""Scalar helpers and the term extraction of functions affine or quadratic
in u (`torch.func.grad` / `torch.func.jacfwd`)."""
from __future__ import annotations

import math

import torch


def affine_terms(func, u):
    """For func affine in u (m,) with a scalar value: (a (m,), b) with
    func(u) = a @ u + b, from one evaluation of func and its gradient at
    u."""
    a, val = torch.func.grad_and_value(func)(u)
    return a, val - a @ u


def quadratic_terms(func, u):
    """For func quadratic in u (m,) with a scalar value: (Q (m, m), p (m,),
    r) with func(u) = u Q u + p u + r, from one forward-over-reverse
    evaluation of func at u."""
    def grad_with_aux(v):
        g, val = torch.func.grad_and_value(func)(v)
        return g, (g, val)

    H, (g, val) = torch.func.jacfwd(grad_with_aux, has_aux=True)(u)
    Q = 0.5 * H
    p = g - 2.0 * Q @ u
    return Q, p, val - u @ Q @ u - p @ u


def normalize_radians(theta):
    """Wrap an angle to [-pi, pi) with a floor-mod, as the JAX package does."""
    return (theta + math.pi) % (2 * math.pi) - math.pi


def epsilon_interp(i, start=(0, 1.0), end=(1000, 0.01)) -> float:
    """Log-linear schedule between (step si, value sv) and (step ei, value
    ev), evaluated at a Python step index i (the exploration rate of
    `EpsilonGreedyController`)."""
    (si, sv), (ei, ev) = start, end
    return math.exp((i - si) / (ei - si) * (math.log(ev) - math.log(sv))
                    + math.log(sv))
