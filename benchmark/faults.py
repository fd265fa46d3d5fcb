"""Faults planted under a run, each of which `correct` has to refuse: a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced, and refits that leave the learner's
hyperparameters where they were, in every episode or in a few.  Each is
`fault(fam)`: it swaps the family's rollout for one whose program has
the fault (one card: there is no exchange between cards to leave out).
Read by the CPU tests and by `calibrate.py --fault`; never by a run of
the benchmark."""
from __future__ import annotations

import contextlib

import torch


def _swapped(fam, patches):
    """fam.rollout with each (object, attribute, value) of `patches` set
    for the duration of a call."""
    rollout = fam.rollout

    def run(inputs, sim=None):
        with contextlib.ExitStack() as stack:
            for obj, name, value in patches:
                old = getattr(obj, name)
                setattr(obj, name, value)
                stack.callback(setattr, obj, name, old)
            return rollout(inputs, sim)
    fam.rollout = run


def state_unchanged(fam):
    """The true dynamics' step returns the state it was given."""
    dyn = fam.sim.true_dynamics
    _swapped(fam, [(type(dyn), "step",
                    lambda self, x, u, dt: (x, torch.zeros_like(x)))])


def half_batch(fam):
    """Only the first half of the episodes run; the second half reports
    their outputs again."""
    rollout = fam.rollout

    def half(inputs, sim=None):
        h = fam.B // 2
        sub = dict(inputs, x0s=inputs["x0s"][:h],
                   draws=inputs["draws"][:, :h],
                   state0=_head(inputs["state0"], h))
        if "noise" in inputs:
            sub["noise"] = inputs["noise"][:, :h]
        return _twice(rollout(sub, sim))
    fam.rollout = half


def _head(tree, n):
    if isinstance(tree, torch.Tensor):
        return tree[:n]
    return type(tree)(*(_head(a, n) for a in tree))


def _twice(tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return torch.cat([tree, tree])
    return type(tree)(*(_twice(a) for a in tree))


def answer_altered(fam):
    """Every control is moved by 0.5 where the controller produces it."""
    import bayesian_cbf_tpu_torch.experiments.pendulum as pend
    import bayesian_cbf_tpu_torch.sim.rollout as roll
    mod, name = ((roll, "bayes_clf_control") if hasattr(fam.sim, "clf")
                 else (pend, "learned_socp_control"))
    orig = getattr(mod, name)

    def altered(*a, **k):
        out = orig(*a, **k)
        return (out[0] + 0.5,) + tuple(out[1:])
    _swapped(fam, [(mod, name, altered)])


def _learner_kept(fam, episodes):
    """The learner's fit returns its input hyperparameters in `episodes`
    (a boolean mask over the batch, None: every episode); the cache is
    still refreshed on the new reservoir."""
    from bayesian_cbf_tpu_torch.models.mvgp import MVGP
    fit = MVGP.fit

    def kept(self, params, data, *a, **k):
        new = fit(self, params, data, *a, **k)
        if episodes is None:
            return params
        m = episodes.to(params[0].device)
        return type(new)(*(torch.where(m.reshape((-1,) + (1,) * (o.ndim - 1)),
                                       o, n) for o, n in zip(params, new)))
    _swapped(fam, [(MVGP, "fit", kept)])


def learner_unchanged(fam):
    """Every refit leaves every episode's hyperparameters unmoved."""
    _learner_kept(fam, None)


def learner_unchanged_few(fam):
    """Every refit leaves the hyperparameters of a few episodes (one in
    512, at least 2, at fixed places) unmoved."""
    n = max(2, fam.B // 512)
    mask = torch.zeros(fam.B, dtype=torch.bool)
    mask[torch.randperm(fam.B, generator=torch.Generator().manual_seed(7))
         [:n]] = True
    _learner_kept(fam, mask)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  answer_altered, learner_unchanged,
                                  learner_unchanged_few)}
