"""Experiment harness: the registry, run directories, config dumps and
sweeps.

Every run gets a directory <runs_dir>/<name>_<stamp> with a config.json
of its keyword overrides (plus the obstacles, dt, numSteps and goal) and
its logged rollout (`observability.logger.MetricsLogger`, on any of its
backends), and optionally the run drawn again from its log.  `kwvariations`
grid-expands keyword axes; `apply_overrides` sets dotted keys of a nested
config.  The experiments run on the card unless the caller passes
device="cpu".
"""
from __future__ import annotations

import itertools
import json
import os
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch

from ..observability.logger import MetricsLogger, replay_run


def _registry() -> Dict[str, Callable]:
    """The experiments that return (sim, one episode's RolloutOutputs):
    the four README unicycle experiments."""
    from . import unicycle
    return {
        "unicycle_mean_cbf_collides_obstacle":
            unicycle.unicycle_mean_cbf_collides_obstacle,
        "unicycle_bayes_cbf_safe_obstacle":
            unicycle.unicycle_bayes_cbf_safe_obstacle,
        "unicycle_learning_helps_avoid_getting_stuck":
            unicycle.unicycle_learning_helps_avoid_getting_stuck,
        "unicycle_no_learning_gets_stuck":
            unicycle.unicycle_no_learning_gets_stuck,
    }


def experiment_names() -> List[str]:
    return sorted(_registry())


def kwvariations(**axes: Iterable) -> List[Dict[str, Any]]:
    """Grid-expand keyword axes into a list of override dicts.

    >>> kwvariations(a=[1, 2], b=['x'])
    [{'a': 1, 'b': 'x'}, {'a': 2, 'b': 'x'}]
    """
    keys = list(axes)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(axes[k] for k in keys))]


def apply_overrides(base: Dict[str, Any],
                    overrides: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of `base` with dotted-key overrides set in its nested dicts.

    >>> apply_overrides({'a': {'b': 1}, 'c': 2}, {'a.b': 9})['a']['b']
    9
    """
    out = json.loads(json.dumps(base)) if base else {}
    for path, value in overrides.items():
        d = out
        parts = path.split(".")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = value
    return out


def run_experiment(name: str, runs_dir: str = "data/runs",
                   log_every: int = 1, plot: bool = False,
                   animate: bool = False, backend: str = "jsonl",
                   device="cuda", dtype=torch.float32,
                   **overrides) -> Tuple[Any, Any, str]:
    """Run a registered experiment on `device` in `dtype` with a run
    directory, its config.json and the logged rollout (through the
    logger's `backend`: "jsonl", "binary" or "tensorboard").  The
    overrides go to the experiment (and into config.json); device and
    dtype do not enter the config.  plot: the trajectory drawn again from
    the log into <run_dir>/trajectory.png; animate: the animation into
    <run_dir>/animation.gif (`observability.logger.replay_run`; both need
    matplotlib and raise ImportError without it).  Returns (sim, outputs,
    run_dir)."""
    fn = _registry()[name]
    if plot or animate:
        import matplotlib  # noqa: F401  (ImportError before the run)
    logger = MetricsLogger(runs_dir=runs_dir, exp_tags=[name],
                           backend=backend,
                           config={"name": name, **overrides})
    sim, out = fn(**overrides, device=device, dtype=dtype)
    logger.log_rollout(out, every=log_every, sim=sim)
    logger.close()
    if plot:
        replay_run(logger.dir,
                   savefile=os.path.join(logger.dir, "trajectory.png"))
    if animate:
        replay_run(logger.dir, animate=True)
    return sim, out, logger.dir


def run_experiment_mult(name: str, variations: List[Dict[str, Any]],
                        runs_dir: str = "data/runs", **common
                        ) -> List[Tuple[Dict[str, Any], str]]:
    """`run_experiment` once per override dict of `variations` (each over
    the `common` keywords), one run directory each: [(overrides,
    run_dir), ...]."""
    results = []
    for var in variations:
        _, _, run_dir = run_experiment(name, runs_dir=runs_dir,
                                       **{**common, **var})
        results.append((var, run_dir))
    return results
