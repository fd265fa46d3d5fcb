"""Metrics logging, config dumps and checkpoints.

  * `MetricsLogger` writes newline-delimited JSON (one record per tag and
    step) beside a config.json, in <runs_dir>/<tags>_<stamp>/; it is fed
    from tensors after a rollout returns;
  * `save_checkpoint` / `load_checkpoint` write any tree (NamedTuples and
    tuples) of tensors to one .npz with a JSON manifest beside it, which
    is validated on load;
  * `filter_runs` and `load_metrics` find logged runs and read them back.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import subprocess
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_host(v):
    """Tensors and arrays as Python numbers or nested lists; containers
    mapped through; anything else as it is."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.ndarray, np.generic)):
        return v.item() if v.ndim == 0 else v.tolist()
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_host(x) for x in v)
    return v


def _rows(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values)


class MetricsLogger:
    """JSONL scalar / tensor logger with a config dump (the JSONL backend
    only: the binary and tensorboard writers are not ported).

    Run directory: <runs_dir>/<exp_tags joined by _>_<stamp>/ (a new one
    each time) holding config.json and metrics.jsonl."""

    def __init__(self, runs_dir="data/runs", exp_tags=(), config=None,
                 stamp: Optional[str] = None):
        stamp = stamp or time.strftime("%Y%m%d-%H%M%S")
        base = osp.join(runs_dir, "_".join(list(exp_tags) + [stamp]))
        # runs started within the same second get _1, _2, ... appended
        self.dir, n = base, 0
        while True:
            try:
                os.makedirs(self.dir)
                break
            except FileExistsError:
                n += 1
                self.dir = f"{base}_{n}"
        self._fh = open(osp.join(self.dir, "metrics.jsonl"), "a")
        if config is not None:
            self.dump_config(config)

    def dump_config(self, config: Dict[str, Any]):
        """Write, or merge into, the run's config.json, stamped with the
        package version (`version_stamp`) on its first write."""
        path = osp.join(self.dir, "config.json")
        merged = {}
        if osp.exists(path):
            with open(path) as f:
                merged = json.load(f)
        merged.setdefault("_version", version_stamp())
        merged.update(_to_host(config))
        with open(path, "w") as f:
            json.dump(merged, f, indent=1, skipkeys=True, default=str)

    def add_scalar(self, tag, value, step):
        self._fh.write(json.dumps(
            {"tag": tag, "step": int(step), "value": _to_host(value)}) + "\n")

    def add_rows(self, tag, values, every: int = 1):
        """Log a whole (T, ...) channel: row t at step t, every `every`-th
        row."""
        a = _rows(values)
        for t in range(0, a.shape[0], every):
            self.add_scalar(tag, a[t], t)

    def log_rollout(self, outs, every: int = 1, sim=None):
        """Log one episode's outputs (T, ...) per step: the state, the
        control, the controller's diagnostics and, where the outputs have
        them, the kernel channels.  With `sim`, the obstacles, dt,
        numSteps, the goal and the plan too."""
        X = _rows(outs.X)
        self.add_rows("vis/state", X, every)
        self.add_rows("vis/uopt", outs.U, every)
        info = outs.info
        chans = [("opt/rho", info.rho), ("opt/relax", info.relax),
                 ("opt/value", info.pcost),
                 ("opt/feasible", info.feasible),
                 ("vis/clc_mean", info.clc_mean),
                 ("vis/cbc_mean", info.cbc_means),
                 ("vis/cbc_var", info.cbc_vars)]
        knl = getattr(outs, "knl", None)
        if knl is not None:
            chans += [("vis/knl_lengthscale", knl.lengthscale),
                      ("vis/knl_scalefactor", knl.outputscale),
                      ("vis/knl_A", knl.A), ("vis/knl_B", knl.B),
                      ("vis/Fx_var", knl.Fx_var),
                      ("vis/Fxu_var", knl.Fxu_var)]
        for tag, arr in chans:
            self.add_rows(tag, arr, every)
        if sim is not None:
            geom = {
                "obstacles": [{"center": _to_host(c.center),
                               "radius": float(c.radius)}
                              for c in sim.cbfs],
                "dt": float(sim.dt), "numSteps": int(sim.numSteps),
            }
            planner = getattr(sim, "planner", None)
            if planner is not None:
                steps = torch.arange(X.shape[0], device=outs.X.device)
                plan = _rows(planner.plan(steps))
                geom["goal"] = plan[-1].tolist()
                self.add_rows("vis/plan_x", plan[:X.shape[0]], every)
            self.dump_config(geom)
        self.flush()

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.close()


def version_stamp() -> str:
    """The package version, with `git describe` appended when run from a
    checkout."""
    from .. import __version__
    try:
        desc = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            cwd=osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
            capture_output=True, text=True, timeout=5)
        if desc.returncode == 0 and desc.stdout.strip():
            return "%s+g%s" % (__version__, desc.stdout.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    return __version__


def filter_runs(runs_dir, predicate=None, newest_first=True):
    """The logged run directories under `runs_dir` (those holding a
    metrics.jsonl), newest first, optionally only those whose config.json
    satisfies `predicate`."""
    hits = []
    if not osp.isdir(runs_dir):
        return hits
    for name in os.listdir(runs_dir):
        d = osp.join(runs_dir, name)
        if not osp.exists(osp.join(d, "metrics.jsonl")):
            continue
        cfg = {}
        cfg_path = osp.join(d, "config.json")
        if osp.exists(cfg_path):
            try:
                with open(cfg_path) as f:
                    cfg = json.load(f)
            except json.JSONDecodeError:
                pass
        if predicate is None or predicate(cfg):
            hits.append((osp.getmtime(d), d))
    hits.sort(reverse=newest_first)
    return [d for _, d in hits]


def load_metrics(path):
    """A metrics.jsonl (or the run directory holding one) read back as
    {tag: [(step, value), ...]}."""
    grouped: Dict[str, list] = {}
    with open(path if path.endswith(".jsonl")
              else osp.join(path, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            grouped.setdefault(rec["tag"], []).append(
                (rec["step"], rec["value"]))
    return grouped


# -- checkpointing -----------------------------------------------------------

def _flatten(tree):
    """(leaves depth first, a string of the tree's structure)."""
    if isinstance(tree, torch.Tensor):
        return [tree], "*"
    if tree is None:
        return [], "None"
    leaves, parts = [], []
    for v in tree:
        sub, spec = _flatten(v)
        leaves += sub
        parts.append(spec)
    if hasattr(tree, "_fields"):
        return leaves, "%s(%s)" % (type(tree).__name__, ", ".join(
            "%s=%s" % fs for fs in zip(tree._fields, parts)))
    return leaves, "(%s)" % ", ".join(parts)


def _unflatten(like, leaves):
    """`leaves` (an iterator) put into the structure of `like`."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if like is None:
        return None
    vals = [_unflatten(v, leaves) for v in like]
    return type(like)(*vals) if hasattr(like, "_fields") else type(like)(vals)


def save_checkpoint(path: str, tree) -> None:
    """Write a tree of tensors (NamedTuples, tuples) to `path` (.npz, its
    leaves arr_0, arr_1, ... depth first) and the JSON manifest
    `<path>.tree`: the tree's structure, each leaf's shape and dtype, and
    the package version."""
    leaves, spec = _flatten(tree)
    arrs = [a.detach().cpu().numpy() for a in leaves]
    np.savez(path, *arrs)
    manifest = {
        "version": version_stamp(),
        "treedef": spec,
        "shapes": [list(a.shape) for a in arrs],
        "dtypes": [str(a.dtype) for a in arrs],
    }
    with open(path + ".tree", "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str, like, strict: bool = True):
    """Read a checkpoint back into the structure of `like`, each tensor on
    the device of `like`'s leaf in its saved dtype.

    Raises ValueError when the leaf counts differ, when the archive's leaf
    shapes disagree with its own manifest, when (with `strict`) the saved
    structure is not `like`'s, or when a leaf's shape is not `like`'s.
    strict=False restores by position into a structure of other names but
    the same leaves."""
    base = path[:-4] if path.endswith(".npz") else path
    data = np.load(base + ".npz")
    leaves = [data[k] for k in sorted(data.files,
                                      key=lambda s: int(s.split("_")[1]))]
    like_leaves, spec = _flatten(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(
            "checkpoint %s holds %d leaves but the target structure has "
            "%d: wrong checkpoint for this tree"
            % (path, len(leaves), len(like_leaves)))
    manifest = None
    # save_checkpoint("c.npz") writes c.npz.tree, save_checkpoint("c") c.tree
    for side in (base + ".npz.tree", base + ".tree"):
        if osp.exists(side):
            with open(side) as f:
                try:
                    manifest = json.load(f)
                except json.JSONDecodeError:
                    manifest = None
            break
    if manifest is not None:
        shapes = [tuple(s) for s in manifest.get("shapes", [])]
        got = [tuple(a.shape) for a in leaves]
        if shapes and shapes != got:
            raise ValueError(
                "checkpoint %s: archive leaf shapes %s disagree with its "
                "own manifest %s: corrupt or mixed checkpoint files"
                % (path, got, shapes))
        if strict and manifest.get("treedef") not in (None, spec):
            raise ValueError(
                "checkpoint %s was saved for the structure\n  %s\n"
                "but the target structure is\n  %s\n(saved by version %s; "
                "pass strict=False to restore by position anyway)"
                % (path, manifest.get("treedef"), spec,
                   manifest.get("version", "?")))
    for i, (a, want) in enumerate(zip(leaves, like_leaves)):
        if tuple(a.shape) != tuple(want.shape):
            raise ValueError(
                "checkpoint %s: leaf %d has shape %s but the target "
                "expects %s" % (path, i, tuple(a.shape), tuple(want.shape)))
    return _unflatten(like, iter(
        torch.from_numpy(np.array(a)).to(w.device)
        for a, w in zip(leaves, like_leaves)))
