#!/usr/bin/env python3
"""What the port's tracer (`observability/tracing.py`) costs, in one
benchmark cell on one NVIDIA card.

    python3 scripts/tracing_cost.py --workload <cell> --seed <n>

Sets the cell up as `benchmark/run.py` does (its configuration, traffic,
inputs from the seed and warm-up), then times whole rollouts of the same
inputs in turns: tracing off, inside `tracing.recording()`, inside
`tracing.recording()`, off; each ended by a synchronize.  Then one
rollout under `torch.profiler`, as the benchmark's traced run makes it.
Prints one JSON object: the card, each rollout's wall, the recordings'
spans and counters (`tracing.report()`), the profiled rollout's wall and
the spans of its session, and for each recording the `step` and `fit`
spans' summed stream time over the rollout's wall.  Refuses to run
without a card.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness as H  # noqa: E402
from benchmark.run import card_line  # noqa: E402


def covered(rep, wall_s):
    """(step + fit) stream seconds of a report over a rollout's wall."""
    s = rep["spans"]
    dev = sum(s[p]["device_ns"] for p in ("step", "fit") if p in s)
    return dev / 1e9 / wall_s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    spec = H.bench_spec()
    cell = H.find_cell(spec, args.workload)
    cfg, traffic = H.cell_files(spec, cell)
    H.cache_dirs()
    import torch
    from bayesian_cbf_tpu_torch.observability import tracing
    dev = H.require_card(cell["chips"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["matmul_tf32"])
    fam = H.family_class(cfg)(cfg, traffic, dev)
    inputs = fam.make_inputs(args.seed)
    fam.warmup(inputs)
    H.sync(dev)

    runs = []
    for mode in ("off", "recording", "recording", "off"):
        H.sync(dev)
        with (tracing.recording() if mode == "recording"
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            out = fam.rollout(inputs)
            H.sync(dev)
            wall = time.perf_counter() - t0
        del out
        run = dict(mode=mode, wall_s=wall)
        if mode == "recording":
            rep = tracing.report()
            run.update(report=rep, step_fit_over_wall=covered(rep, wall))
        runs.append(run)
        print(f"{mode}: {wall:.4f} s", file=sys.stderr, flush=True)
    summary, *_ = H.traced_rollout(fam, inputs, args.seed,
                                   traffic["check_episodes_per_rollout"])
    rep = tracing.report()
    print(json.dumps(dict(
        workload=args.workload, seed=args.seed, card=card_line(), runs=runs,
        profiled=dict(wall_s=summary["wall_s"], spans=rep["spans"],
                      step_fit_over_wall=covered(rep, summary["wall_s"]),
                      busy_s=summary["busy_ns"] / 1e9,
                      window_s=summary["window_ns"] / 1e9))), flush=True)


if __name__ == "__main__":
    main()
