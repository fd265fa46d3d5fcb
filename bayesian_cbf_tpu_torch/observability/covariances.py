"""Posterior covariance-ellipse figures of the unicycle's learned
dynamics (the reference's visualize/unicycle_covariances.py:33-282).

`unicycle_covariances_exp` fits the MVGP ("matrix") and the CoGP
("vector") on a unicycle CLF rollout and returns each model's posterior
covariance block ((1+m) n square) at a few test states; the `_vis`
functions draw its 3-sigma ellipses projected on the x-y, y-theta and
theta-x planes, on matplotlib (imported inside them).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch


def unicycle_covariances_exp(max_train: int = 200, numSteps: int = 512,
                             dt: float = 0.01, training_iter: int = 50,
                             seed: int = 0, n_test: int = 4, data=None,
                             params0=None, device="cuda",
                             dtype=torch.float32):
    """Fit the MVGP (matrix) and the CoGP (vector) on a unicycle CLF
    rollout and return each one's posterior covariance blocks at the test
    states, {name: (b, (1+m) n, (1+m) n)} as numpy, and the test states
    (b, n) (the reference's unicycle_plot_covariances_exp).

    The rollout: `numSteps` steps of the Ackermann tracking sim without
    learning (true and prior L 1, a generator seeded with `seed`), or
    data=(X, U, Xdot) (T, ...).  The rows: a permutation from
    np.random.default_rng(seed), the first `max_train` to fit, the next
    `n_test` to test.  Each fit starts from hyperparameters drawn from a
    generator seeded with `seed`, or from params0[name] (an MVGP's with
    the episode axis of 1), on `device` in `dtype`."""
    from ..experiments.pendulum import (_block_diag_vars, _fit, _init_params,
                                        _posterior)
    from ..experiments.unicycle import _run, make_ackermann_tracking_sim
    from ..models.cogp import make_cogp
    from ..models.mvgp import make_mvgp

    if data is None:
        sim = make_ackermann_tracking_sim(numSteps=numSteps, dt=dt,
                                          enable_learning=False, true_L=1.0,
                                          mean_L=1.0, device=device,
                                          dtype=dtype)
        out = _run(sim, seed=seed)
        X, U, Xdot = out.X, out.U, out.Xdot
    else:
        X, U, Xdot = (torch.as_tensor(a).to(device=device, dtype=dtype)
                      for a in data)
    rng = np.random.default_rng(seed)
    order = rng.permutation(X.shape[0])
    tr = torch.as_tensor(order[:max_train], device=X.device)
    te = torch.as_tensor(order[max_train:max_train + n_test],
                         device=X.device)
    Xtest = X[te]
    results: Dict[str, np.ndarray] = {}
    for name, maker in (("matrix", make_mvgp), ("vector", make_cogp)):
        gp = maker(3, 2)
        params = _init_params(gp, name, params0, seed, device, dtype)
        fitted, d = _fit(gp, X[tr], U[tr], Xdot[tr], params, training_iter)
        _, var = _posterior(gp, fitted, d, Xtest)
        results[name] = _block_diag_vars(
            var, Xtest.shape[0]).detach().cpu().numpy()
    return results, Xtest.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# rendering (host-side matplotlib)
# ---------------------------------------------------------------------------


def _cov_ellipse(ax, cov, n_std=3.0, scale=1.0):
    """3-sigma ellipse + principal-axis arrows for a 2x2 covariance
    (plot_covariance, visualize/unicycle_covariances.py:215-233)."""
    from matplotlib.patches import Arrow, Ellipse
    eigval, eigvec = np.linalg.eigh(cov)
    width, height = np.sqrt(np.maximum(eigval, 0.0)) * n_std
    angle = math.degrees(math.atan2(eigvec[1, 0], eigvec[0, 0]))
    ax.set_aspect("equal")
    ax.add_patch(Ellipse((0, 0), width, height, angle=angle, fill=False,
                         color="b", linewidth=2 * scale))
    for vec, length in ((eigvec[:, 0], width), (eigvec[:, 1], height)):
        pt = vec * length / 2
        ax.add_patch(Arrow(0, 0, pt[0], pt[1], color="g",
                           width=0.05 * max(width, height)))
    return max(width, height)


def plot_covariance_projections(axes, cov3D, axtitle, scale=1.0):
    """Project a 3x3 covariance onto the x-y, y-theta, theta-x planes
    (visualize/unicycle_covariances.py:235-249)."""
    names = (("x", "y"), ("y", "theta"), ("theta", "x"))
    covs = (cov3D[:2, :2], cov3D[1:, 1:],
            cov3D[np.ix_([2, 0], [2, 0])])
    heights = []
    for ax, axname, cov in zip(axes, names, covs):
        ax.set_title(f"{axtitle} on {axname[0]}-{axname[1]}",
                     fontsize=10 * scale)
        ax.set_xlabel(axname[0])
        ax.set_ylabel(axname[1])
        heights.append(_cov_ellipse(ax, cov, n_std=3.0, scale=scale))
    lim = max(heights) * 1.3 / 2 + 1e-12
    for ax in axes:
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)


def unicycle_covariances_vis(results: Dict[str, np.ndarray],
                             savedir: Optional[str] = None,
                             test_idx: int = 0):
    """Render the MVGP/CoGP 3x3 projection grids
    (unicycle_plot_covariances_vis, visualize/unicycle_covariances.py:252-276).
    Returns the figure paths (or figures if savedir is None)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    out = []
    pretty = {"matrix": "MVGP", "vector": "CoGP"}
    for name, var_blocks in results.items():
        fig, axes = plt.subplots(3, 3, figsize=(7, 7.5), sharey="row")
        fig.suptitle(pretty.get(name, name))
        D = var_blocks.shape[-1]
        n = 3
        for i in range(3):
            cov3D = var_blocks[test_idx, i * n:(i + 1) * n,
                               i * n:(i + 1) * n]
            title = ("Var(f(x))" if i == 0 else f"Var(g(x)[:, {i}])")
            plot_covariance_projections(axes[i, :], cov3D, title)
        fig.tight_layout()
        if savedir is not None:
            import os.path as osp
            path = osp.join(savedir,
                            f"{pretty.get(name, name)}_covariances_proj.png")
            fig.savefig(path, dpi=120)
            plt.close(fig)
            out.append(path)
        else:
            out.append(fig)
    return out
