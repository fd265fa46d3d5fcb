"""Monte-Carlo rollouts and posteriors split over a mesh of devices.

A mesh is a tuple of `torch.device`s used by one process, not a
`torch.distributed` process group: the target is one card, where the
mesh is (cuda:0,), and the CPU tests build a mesh of several CPU devices.
Each function splits its sharded axis into one contiguous block per
device, runs each block on its device, and combines the partial results
on the mesh's first device; a sum over blocks stands in for a psum.  The
blocks run one after another from this process.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..sim.rollout import UnicycleSim, simulate_unicycle_batch
from ..utils.linalg import kron


def make_mesh(n_devices: Optional[int] = None,
              device_type: str = "cuda") -> tuple:
    """The first `n_devices` devices of `device_type` (default: every
    CUDA device).  The CPU is one device; a CPU mesh of n_devices repeats
    it, so its blocks run one after another on the host."""
    if device_type == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    count = torch.cuda.device_count()
    if not count:
        raise RuntimeError("make_mesh: no CUDA device; pass "
                           "device_type='cpu' for a CPU mesh")
    n = n_devices or count
    return tuple(torch.device("cuda", i) for i in range(n))


def _move(tree, device):
    """A copy of a tree of NamedTuples, tuples and lists with every tensor
    on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (tuple, list)):
        vals = [_move(v, device) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return tree


def _split(tree, n):
    """n trees of contiguous blocks of every tensor's leading axis."""
    if isinstance(tree, torch.Tensor):
        return torch.tensor_split(tree, n)
    if tree is None:
        return [None] * n
    parts = [_split(v, n) for v in tree]
    build = ((lambda vals: type(tree)(*vals)) if hasattr(tree, "_fields")
             else type(tree))
    return [build([p[i] for p in parts]) for i in range(n)]


def _gather(trees, device):
    """The blocks `trees` joined along the leading axis on `device`."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([t.to(device) for t in trees])
    if first is None:
        return None
    vals = [_gather([t[i] for t in trees], device) for i in range(len(first))]
    return type(first)(*vals) if hasattr(first, "_fields") else \
        type(first)(vals)


def batched_rollouts(sim: UnicycleSim, x0s,
                     generator: Optional[torch.Generator] = None,
                     mesh: Optional[tuple] = None, state0=None, draws=None):
    """Episodes from x0s (B, n), one block of the batch per device of the
    mesh (default `make_mesh()`); B must be divisible by the mesh's size.
    The initial learner state and the reservoir draws of the whole batch
    come from `generator` first (the state as `init_state(B)` makes it,
    then uniforms (T, B), which the learner's `record` turns into
    draws), unless given as `state0` / `draws` (T, B), so a block's
    episodes are the same whatever the mesh.  On a mesh of one device this is
    `simulate_unicycle_batch`.  Returns RolloutOutputs (B, T, ...) on the
    mesh's first device."""
    if mesh is None:
        mesh = make_mesh()
    n = len(mesh)
    B = x0s.shape[0]
    if B % n != 0:
        raise ValueError(
            "batched_rollouts: batch size B=%d is not divisible by the "
            "mesh's %d devices; pad the batch to a multiple of %d or pass "
            "a smaller mesh (make_mesh(n_devices=...))" % (B, n, n))
    lrn = sim.learned_dynamics
    if state0 is None:
        state0 = lrn.init_state(B, generator, x0s.device, x0s.dtype)
    if draws is None:
        draws = torch.rand((sim.numSteps, B), generator=generator,
                           dtype=x0s.dtype, device=x0s.device)
    blocks = zip(mesh, torch.tensor_split(x0s, n), _split(state0, n),
                 torch.tensor_split(draws, n, dim=1))
    outs = [simulate_unicycle_batch(_move(sim, dev), x.to(dev),
                                    state0=_move(st, dev), draws=d.to(dev))
            for dev, x, st, d in blocks]
    return _gather(outs, mesh[0])


def sharded_predict_fullmat(gp, params, data, cache, Xtest,
                            mesh: Optional[tuple] = None):
    """`gp.predict_fullmat` of an MVGP with the test-point axis split
    over the mesh (default `make_mesh()`): each device computes its block
    of rows of Bk (its test points against all of Xtest (B, b, n)) with
    `predict_matrix`; the blocks are joined on the first device into the
    mean (B, b (1+m) n) and the covariance sym(Bk) kron A."""
    if mesh is None:
        mesh = make_mesh()
    home = mesh[0]
    blocks = []
    for dev, Xb in zip(mesh, torch.tensor_split(Xtest, len(mesh), dim=1)):
        p, d, c = _move((params, data, cache), dev)
        blocks.append(gp.predict_matrix(p, d, c, Xb.to(dev),
                                        Xtestp=Xtest.to(dev)))
    meanFT = torch.cat([m.to(home) for m, _, _ in blocks], 1)
    Bk = torch.cat([k.to(home) for _, _, k in blocks], 1)
    Bsz, b = Xtest.shape[:2]
    mh = 1 + gp.u_dim
    BkXX = Bk.transpose(2, 3).reshape(Bsz, b * mh, b * mh)
    BkXX = 0.5 * (BkXX + BkXX.transpose(-1, -2))
    return (meanFT.transpose(-1, -2).reshape(Bsz, -1),
            kron(BkXX, params.A.to(home)))


def trainaxis_sharded_predict_fullmat(gp, params, data, cache, Xtest,
                                      mesh: Optional[tuple] = None):
    """`gp.predict_fullmat` of an MVGP with the training-point axis K
    split over the mesh (default `make_mesh()`): every K-contraction
    decomposes over row blocks of the cached Linv,

        z* = Linv kb*,  zY = Linv Y,
        Bk = prior - sum_r z*_r^T z*_r,   mean = M^T + sum_r z*_r^T zY_r,

    so each device holds a (K / d, K) row block of Linv and adds two
    partial products; the sums are taken on the first device.  K must be
    divisible by the mesh's size."""
    if mesh is None:
        mesh = make_mesh()
    n_dev = len(mesh)
    K = cache.Linv.shape[-1]
    if K % n_dev != 0:
        raise ValueError(
            "trainaxis_sharded_predict_fullmat: train capacity K=%d is not "
            "divisible by the mesh's %d devices; pick a max_train that is "
            "a multiple of the mesh's size" % (K, n_dev))
    home = mesh[0]
    Bsz, b = Xtest.shape[:2]
    mh = 1 + gp.u_dim
    kb = gp._kb_star(params, data, Xtest)                   # (B, b, K, 1+m)
    kb_flat = kb.permute(0, 2, 1, 3).reshape(Bsz, K, b * mh)
    Y = gp.residual_Y(params, data)                         # (B, K, n)
    Kss = gp.k_xx(params, Xtest, Xtest)                     # (B, b, b)
    prior = (Kss[..., None, None] * params.B[:, None, None]).permute(
        0, 1, 3, 2, 4).reshape(Bsz, b * mh, b * mh)
    cross, madj = 0, 0
    for dev, Linv_r in zip(mesh, torch.tensor_split(cache.Linv, n_dev,
                                                    dim=1)):
        Linv_r = Linv_r.to(dev)
        z = Linv_r @ kb_flat.to(dev)                        # (B, K/d, b(1+m))
        zY = Linv_r @ Y.to(dev)                             # (B, K/d, n)
        cross = cross + (z.transpose(-1, -2) @ z).to(home)
        madj = madj + (z.transpose(-1, -2) @ zY).to(home)
    BkXX = prior.to(home) - cross
    BkXX = 0.5 * (BkXX + BkXX.transpose(-1, -2))
    meanFT = (params.mean_M.transpose(-1, -2)[:, None].to(home)
              + madj.reshape(Bsz, b, mh, -1).transpose(-1, -2))
    return (meanFT.transpose(-1, -2).reshape(Bsz, -1),
            kron(BkXX, params.A.to(home)))


def rollout_safety_stats(outs, cbf_centers, cbf_radii, x_goal):
    """Aggregates over a batch of rollouts (B, T, n): the fraction of
    episodes that entered an obstacle, the mean final distance to the
    goal, the least clearance, and (when the outputs carry it) the
    fraction of feasible steps.  Each a 0-d tensor on X's device."""
    X = outs.X
    pos = X[..., :2]
    d = torch.linalg.vector_norm(pos[:, :, None, :] - cbf_centers[None, None],
                                 dim=-1)
    min_clear = torch.amin(d - cbf_radii[None, None, :], (1, 2))   # (B,)
    goal_dist = torch.linalg.vector_norm(X[:, -1, :2] - x_goal[None, :2],
                                         dim=-1)
    stats = {
        "collision_fraction": torch.mean((min_clear < 0.0).to(X.dtype)),
        "mean_goal_distance": torch.mean(goal_dist),
        "min_clearance": torch.amin(min_clear),
    }
    feas = getattr(getattr(outs, "info", None), "feasible", None)
    if feas is not None:
        stats["feasible_fraction"] = torch.mean(feas.to(X.dtype))
    return stats
