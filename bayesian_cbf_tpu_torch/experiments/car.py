"""Car experiments on the second-order unicycle: MVGP learning of its
dynamics from a random-control rollout, and a ground-truth relative-
degree-2 CBC QP that drives it to the goal between four circular
obstacles.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.car import CircularObstacleCBC, SecondOrderUnicycle
from ..models.dynamics import _map
from ..models.mvgp import make_mvgp_rank1
from ..sim.rollout import _stack_steps, first_episode
from ..solvers.socp import solve_socp

CAR_START = (0.0, 0.0, 0.0, -2.5, -2.5, 0.0)
CENTERS = ((1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0))


def sample_car_data(generator: Optional[torch.Generator] = None,
                    numSteps: int = 500, dt: float = 0.01,
                    draws: Optional[torch.Tensor] = None, device="cuda",
                    dtype=torch.float32):
    """A random-control rollout of the 6-state unicycle from rest at the
    origin: each step the acceleration is uniform on [0, 1) and the
    heading input uniform on [-pi, pi).  draws (T, 2): the uniforms on
    [0, 1) to use instead of `generator`'s.  Returns X (T, 6) the states
    before each step, U (T, 2), Xdot (T, 6)."""
    car = SecondOrderUnicycle()
    x = torch.zeros((1, 6), dtype=dtype, device=device)
    ys = []
    for t in range(numSteps):
        r = (draws[t].to(device=device, dtype=dtype) if draws is not None
             else torch.rand((2,), generator=generator, dtype=dtype,
                             device=device))
        u = torch.stack([r[0], -math.pi + 2.0 * math.pi * r[1]])[None]
        x_next, xdot = car.step(x, u, dt)
        ys.append((x, u, xdot))
        x = x_next
    return first_episode(_stack_steps(ys))


def car_learn_dynamics(max_train: int = 100, training_iter: int = 40,
                       seed: int = 0, device="cuda", dtype=torch.float32,
                       draws: Optional[torch.Tensor] = None, params=None):
    """Fit a rank-1 MVGP to the first `max_train` samples of a 500-step
    `sample_car_data` rollout and predict xdot on the next 100 samples.
    Returns (gp, params, data, cache, rmse) with one episode's axis of 1;
    rmse, a float, over those 100 samples.  A generator seeded with `seed`
    makes the rollout and then the initial weights; `draws` (500, 2)
    replaces the rollout's uniforms and `params` (MVGPParams, axis 1) the
    initial weights."""
    gen = torch.Generator(device=device).manual_seed(seed)
    X, U, Xdot = sample_car_data(gen, draws=draws, device=device,
                                 dtype=dtype)
    gp = make_mvgp_rank1(6, 2)
    if params is None:
        params = gp.init_params(1, gen, device, dtype)
    data = gp.make_data(X[None, :max_train], U[None, :max_train],
                        Xdot[None, :max_train])
    params = gp.fit(params, data, training_iter=training_iter)
    with torch.no_grad():
        cache = gp.refresh_cache(params, data)
        ev = slice(max_train, max_train + 100)
        n = X[ev].shape[0]
        wide = _map(lambda a: a.expand((n,) + a.shape[1:]),
                    (params, data, cache))
        pred = gp.fu_mean(*wide, U[ev], X[ev])
        rmse = float(torch.sqrt(torch.mean((pred - Xdot[ev]) ** 2)))
    return gp, params, data, cache, rmse


def car_obstacles(centers=CENTERS, radii=(0.8,) * 4, device="cuda",
                  dtype=torch.float32):
    """The ground-truth QP's CBCs, one per obstacle, on the position
    (X[:, 3], X[:, 4])."""
    return [CircularObstacleCBC(center=torch.tensor(c, dtype=dtype,
                                                    device=device),
                                radius=r, pos_idx=(3, 4))
            for c, r in zip(centers, radii)]


def car_reference_control(x, x_goal):
    """Accelerate toward the goal position x_goal (2,) and damp the
    rotation, each clipped to [-2, 2]: (B, 2) for states x (B, 6)."""
    d = x_goal - x[:, 3:5]
    heading = torch.atan2(d[:, 1], d[:, 0])
    a = torch.clamp(torch.linalg.vector_norm(d, dim=-1)
                    - torch.linalg.vector_norm(x[:, :2], dim=-1), -2.0, 2.0)
    alpha = torch.clamp(2.0 * (heading - x[:, 5]) - x[:, 2], -2.0, 2.0)
    return torch.stack([a, alpha], -1)


def car_ground_truth_socp(x, cbcs, x_goal):
    """The CBC QP at states x (B, 6): minimize |u - u_ref|^2 subject to
    A_k(x) u <= b_k(x) for each obstacle's CBC, over [u (2), t] with the
    objective as the cone 1 + t >= |[2 (u - u_ref); t - 1]| (t >= |u -
    u_ref|^2).  Returns (cobj (3,), G (B, 4 + k, 3), h (B, 4 + k), dims
    (4, 1, ..., 1))."""
    car = SecondOrderUnicycle()
    batch, dtype, device = x.shape[0], x.dtype, x.device
    uref = car_reference_control(x, x_goal)
    one = x.new_ones((batch, 1))
    # the rows of [-c; -A] with A = [[2 I, 0], [0, 1]], c = e_t
    G_obj = torch.tensor([[0.0, 0.0, -1.0], [-2.0, 0.0, 0.0],
                          [0.0, -2.0, 0.0], [0.0, 0.0, -1.0]], dtype=dtype,
                         device=device)
    # every obstacle's CBC at once: row b k + i is state b, obstacle i
    k = len(cbcs)
    if len({(c.k_alpha, c.pos_idx) for c in cbcs}) != 1:
        raise ValueError("the CBCs differ in k_alpha or pos_idx")
    rows = cbcs[0]._replace(
        center=torch.stack([c.center for c in cbcs]).repeat(batch, 1),
        radius=torch.tensor([c.radius for c in cbcs], dtype=dtype,
                            device=device).repeat(batch))
    A, b = rows.A_b(car, x.repeat_interleave(k, 0))
    G = torch.cat([G_obj.expand(batch, -1, -1),
                   torch.cat([A, A.new_zeros((batch * k, 1))], -1).reshape(
                       batch, k, 3)], 1)
    h = torch.cat([one, -2.0 * uref, -one, b.reshape(batch, k)], -1)
    cobj = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    return cobj, G, h, (4,) + (1,) * k


def run_car_control_ground_truth_batch(x0s, numSteps: int = 300,
                                       dt: float = 0.01, centers=CENTERS,
                                       radii=(0.8,) * 4, x_goal=(0.0, 0.0),
                                       socp_iters: int = 20, device="cuda",
                                       dtype=torch.float32):
    """B episodes of the second-order unicycle from x0s (B, 6) under the
    CBC QP (`car_ground_truth_socp`, solved cold, one IPM launch a step):
    a solve whose relative primal residual is not below 1e-4 (f64; 5e-3
    in f32, where the IPM plateaus near 1e-4) or whose solution is not
    finite gives u = 0.  Returns (cbcs, X (B, T, 6) the states before each
    step, U (B, T, 2), pres (B, T))."""
    car = SecondOrderUnicycle()
    cbcs = car_obstacles(centers, radii, device, dtype)
    xg = torch.tensor(x_goal, dtype=dtype, device=device)
    feas_tol = 1e-4 if dtype == torch.float64 else 5e-3
    X = torch.as_tensor(x0s, dtype=dtype, device=device)
    ys = []
    for _ in range(numSteps):
        sol = solve_socp(*car_ground_truth_socp(X, cbcs, xg),
                         iters=socp_iters)
        ok = (sol.pres < feas_tol) & torch.isfinite(sol.x).all(-1)
        u = torch.where(ok[:, None], sol.x[:, :2],
                        torch.zeros_like(sol.x[:, :2]))
        X_next, _ = car.step(X, u, dt)
        ys.append((X, u, sol.pres))
        X = X_next
    return (cbcs,) + tuple(_stack_steps(ys))


def run_car_control_ground_truth(numSteps: int = 300, dt: float = 0.01,
                                 centers=CENTERS, radii=(0.8,) * 4,
                                 x_goal=(0.0, 0.0), socp_iters: int = 20,
                                 device="cuda", dtype=torch.float32):
    """One episode from CAR_START (at rest at (-2.5, -2.5)), run as
    `run_car_control_ground_truth_batch` at B = 1: (cbcs, X (T, 6),
    U (T, 2), pres (T,))."""
    cbcs, *out = run_car_control_ground_truth_batch(
        [CAR_START], numSteps, dt, centers, radii, x_goal, socp_iters,
        device, dtype)
    return (cbcs,) + tuple(first_episode(out))


def min_car_clearance(cbcs, X):
    """Minimum over time of each obstacle's clearance (distance to its
    center less its radius; negative inside): (k,) for (T, 6) states,
    (B, k) for (B, T, 6)."""
    return torch.stack([
        torch.amin(torch.linalg.vector_norm(X[..., 3:5] - cbc.center, dim=-1),
                   -1) - cbc.radius for cbc in cbcs], -1)
