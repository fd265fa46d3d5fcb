"""Figures on matplotlib and numpy: trajectories with their obstacles,
covariance ellipses, the speed test, and the learned-against-true
pendulum dynamics contours.

The reference's bayes_cbf/plotting.py (draw_ellipse, var_to_scale_theta,
speed_test_matrix_vector_plot) and its trajectory rendering
(unicycle_move_to_pose.py:1088-1256).  matplotlib is imported inside the
functions that draw: without it they raise ImportError.  Only the
contour figure computes on tensors (its fits), on the device it is given.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _host(a):
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def var_to_scale_theta(V):
    """2x2 covariance -> (axis scales, rotation angle)
    (plotting.py:203-212)."""
    w, v = np.linalg.eigh(np.asarray(V))
    theta = math.atan2(v[1, -1], v[0, -1])
    return np.sqrt(np.maximum(w[::-1], 0.0)), theta


def draw_ellipse(ax, V, center, scale=1.0, **kw):
    from matplotlib.patches import Ellipse
    scales, theta = var_to_scale_theta(V)
    e = Ellipse(xy=np.asarray(center), width=2 * scale * scales[0],
                height=2 * scale * scales[1],
                angle=math.degrees(theta), fill=False, **kw)
    ax.add_patch(e)
    return e


def plot_unicycle_run(out, cbfs=None, x_goal=None, ax=None, title=None,
                      savefile: Optional[str] = None):
    """Trajectory + obstacles figure for a RolloutOutputs."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    X = _host(out.X)
    ax.plot(X[:, 0], X[:, 1], "-", lw=1.5, label="trajectory")
    ax.plot(X[0, 0], X[0, 1], "go", label="start")
    if x_goal is not None:
        g = _host(x_goal)
        ax.plot(g[0], g[1], "r*", ms=12, label="goal")
    for cbf in (cbfs or []):
        c = _host(cbf.center)
        circ = plt.Circle(c, float(cbf.radius), color="k", alpha=0.3)
        ax.add_patch(circ)
    ax.set_aspect("equal")
    ax.legend(fontsize=7)
    if title:
        ax.set_title(title)
    if savefile:
        ax.figure.savefig(savefile, bbox_inches="tight", dpi=120)
    return ax


def plot_speed_test(results, savefile: Optional[str] = None):
    """Two-panel (inference time, variance-weighted error) figure over
    max_train, per regressor (plotting.py:219-252)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8, 3))
    for name, per_k in results.items():
        ks = sorted(per_k)
        ax1.plot(ks, [per_k[k]["elapsed"] for k in ks], "o-", label=name)
        ax2.plot(ks, [per_k[k]["error"] for k in ks], "o-", label=name)
    ax1.set_xlabel("training points k")
    ax1.set_ylabel("inference time (s)")
    ax1.set_yscale("log")
    ax2.set_xlabel("training points k")
    ax2.set_ylabel("variance-weighted error")
    ax1.legend(fontsize=7)
    fig.tight_layout()
    if savefile:
        fig.savefig(savefile, bbox_inches="tight", dpi=120)
    return fig


def plot_learned_dynamics_contours(regressors=("matrix", "vector"),
                                   max_train=120, training_iter=50,
                                   grid=25, seed=0, data=None, params0=None,
                                   savefile: Optional[str] = None,
                                   device="cuda", dtype=None):
    """The learned-against-true pendulum dynamics contour grid (the
    reference's pendulum.py:1108-1240): rows [ground truth, MVGP
    ("matrix"), CoGP ("vector")], columns [f(x)_1, f(x)_2, g(x)_{1,1},
    g(x)_{2,1}] over the (theta, omega) plane with the training points,
    contour levels shared by each column over all rows.

    The data: a 1024-step pendulum rollout (`sample_pendulum_data` from a
    generator seeded with `seed`), or data=(X, U, Xdot); `max_train` of its
    rows (np.random.default_rng(seed)) fit each regressor for
    `training_iter` Adam iterations from its initial hyperparameters
    (drawn, or params0[regressor]), on `device` in `dtype` (default f32
    on the card, f64 on the CPU).  Returns the figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from ..experiments.pendulum import (_REGRESSORS, _fit, _init_params,
                                        _posterior, sample_pendulum_data)
    from ..models.dynamics import PendulumDynamics

    if dtype is None:
        dtype = torch.float64 if torch.device(device).type == "cpu" \
            else torch.float32
    if data is None:
        X, U, Xdot = sample_pendulum_data(
            numSteps=1024, generator=torch.Generator(device=device)
            .manual_seed(seed), device=device, dtype=dtype)
    else:
        X, U, Xdot = (torch.as_tensor(a).to(device=device, dtype=dtype)
                      for a in data)
    rng = np.random.default_rng(seed)
    tr = rng.permutation(X.shape[0])[:max_train]
    tr_t = torch.as_tensor(tr, device=X.device)
    Xn = _host(X)
    th = np.linspace(Xn[:, 0].min(), Xn[:, 0].max(), grid)
    om = np.linspace(Xn[:, 1].min(), Xn[:, 1].max(), grid)
    TH, OM = np.meshgrid(th, om)
    Xtest = torch.tensor(np.stack([TH, OM], -1).reshape(-1, 2),
                         dtype=dtype, device=device)
    # (b, 1+m, n): the column blocks [f; g] of F^T
    rows = [("Ground Truth",
             _host(PendulumDynamics().F_func(Xtest).transpose(-1, -2)))]
    for name in regressors:
        gp = _REGRESSORS[name](2, 1)
        params = _init_params(gp, name, params0, seed, device, dtype)
        fitted, d = _fit(gp, X[tr_t], U[tr_t], Xdot[tr_t], params,
                         training_iter)
        mean, _ = _posterior(gp, fitted, d, Xtest)
        rows.append((name, _host(mean).reshape(Xtest.shape[0], 2, 2)))

    cols = [("$f(x)_1$", 0, 0), ("$f(x)_2$", 0, 1),
            ("$g(x)_{1,1}$", 1, 0), ("$g(x)_{2,1}$", 1, 1)]
    fig, axs = plt.subplots(len(rows), 4,
                            figsize=(12, 2.6 * len(rows)), squeeze=False)
    # levels over the combined range of all rows: the true g columns are
    # constant, so levels of the truth alone would be roundoff-wide
    levels = []
    for (_, mi, ni) in cols:
        vals = np.concatenate([F[:, mi, ni] for _, F in rows])
        lo, hi = float(vals.min()), float(vals.max())
        if hi - lo < 1e-9:
            lo, hi = lo - 0.5, hi + 0.5
        levels.append(np.linspace(lo, hi, 13))
    for r, (label, F) in enumerate(rows):
        for c, (title, mi, ni) in enumerate(cols):
            Z = F[:, mi, ni].reshape(grid, grid)
            cs = axs[r][c].contourf(TH, OM, Z, levels=levels[c],
                                    cmap="viridis", extend="both")
            if r == 0:
                axs[r][c].set_title(title)
            else:
                axs[r][c].plot(Xn[tr, 0], Xn[tr, 1], "r+", ms=3,
                               linestyle="")
            fig.colorbar(cs, ax=axs[r][c], shrink=0.85)
            axs[r][c].set_xlabel(r"$\theta$")
        axs[r][0].set_ylabel("%s\n$\\omega$" % label)
    fig.tight_layout()
    if savefile:
        fig.savefig(savefile, bbox_inches="tight", dpi=120)
    return fig
