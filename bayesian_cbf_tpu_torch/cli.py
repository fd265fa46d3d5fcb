"""Console entry point.

    bayes-cbf-tpu-torch <experiment> [--set k=v ...] [--sweep k=[...]]
    python -m bayesian_cbf_tpu_torch.cli <experiment> ...

It runs one of the registered experiments (the four README unicycle
experiments) through `experiments.harness`, or one of the named runs
`pendulum_control_online_learning`, `pendulum_control_ground_truth` and
`car_learn_dynamics`, which print their result as JSON and take --set
but not --sweep.  Everything runs on the card in float32; --cpu runs on
the CPU in float64.  Without --cpu and without a CUDA device the command
raises.
"""
from __future__ import annotations

import argparse
import ast
import json
import sys

import torch


def _device(cpu: bool):
    """(device, dtype): the CPU in float64 when asked, else the card in
    float32."""
    if cpu:
        return "cpu", torch.float64
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the experiments run on the card; "
                           "pass --cpu to run them on the CPU")
    return "cuda", torch.float32


def _parse_sets(pairs):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def main(argv=None):
    from .experiments.harness import (experiment_names, kwvariations,
                                      run_experiment, run_experiment_mult)
    parser = argparse.ArgumentParser(
        prog="bayes-cbf-tpu-torch",
        description="Bayesian-CBF safe-learning-control experiments "
                    "(the PyTorch/CUDA port)")
    parser.add_argument("experiment",
                        choices=tuple(experiment_names()) + tuple(NAMED))
    parser.add_argument("--set", dest="sets", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="override an experiment keyword (repeatable); "
                             "values parse as Python literals")
    parser.add_argument("--sweep", dest="sweeps", action="append",
                        default=[], metavar="KEY=[v1,v2,...]",
                        help="sweep a keyword over a list of values "
                             "(repeatable; grid product of all sweeps)")
    parser.add_argument("--runs-dir", default="data/runs")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU in float64")
    args = parser.parse_args(argv)
    if args.experiment in NAMED and args.sweeps:
        parser.error(f"--sweep runs the registered experiments only, not "
                     f"{args.experiment}")
    device, dtype = _device(args.cpu)
    overrides = _parse_sets(args.sets)
    if args.experiment in NAMED:
        print(json.dumps(NAMED[args.experiment](device, dtype, **overrides)))
        return 0
    if args.sweeps:
        variations = kwvariations(**_parse_sets(args.sweeps))
        results = run_experiment_mult(args.experiment, variations,
                                      runs_dir=args.runs_dir, device=device,
                                      dtype=dtype, **overrides)
        for var, run_dir in results:
            print(json.dumps({"overrides": var, "run_dir": run_dir}))
        return 0
    _, out, run_dir = run_experiment(args.experiment, runs_dir=args.runs_dir,
                                     device=device, dtype=dtype, **overrides)
    print(json.dumps({
        "run_dir": run_dir,
        "feasible_frac": float(out.info.feasible.double().mean()),
        "final_state": out.X[-1].tolist(),
    }))
    return 0


def _pendulum_online(device, dtype, **kw):
    from .experiments.pendulum import (make_pendulum_online_sim,
                                       pendulum_damage_fraction,
                                       run_pendulum_online_learning)
    sim = make_pendulum_online_sim(**kw, device=device, dtype=dtype)
    out = run_pendulum_online_learning(sim)
    return {"damage_fraction": float(pendulum_damage_fraction(out.X[:, 0])),
            "final_state": out.X[-1].tolist()}


def _pendulum_ground_truth(device, dtype, **kw):
    from .experiments.pendulum import (pendulum_damage_fraction,
                                       run_pendulum_ground_truth)
    X, _, pres = run_pendulum_ground_truth(**kw, device=device, dtype=dtype)
    return {"damage_fraction": float(pendulum_damage_fraction(X[:, 0])),
            "max_pres": float(pres.max())}


def _car_learn(device, dtype, **kw):
    from .experiments.car import car_learn_dynamics
    return {"rmse": car_learn_dynamics(**kw, device=device, dtype=dtype)[-1]}


# the named runs: run(device, dtype, **keywords) -> a JSON-serializable
# result
NAMED = {"pendulum_control_online_learning": _pendulum_online,
         "pendulum_control_ground_truth": _pendulum_ground_truth,
         "car_learn_dynamics": _car_learn}


if __name__ == "__main__":
    sys.exit(main())
