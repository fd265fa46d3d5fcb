#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--rollouts 6] [--fault <name>] [--no-control]

For each seed, in one process on the card: the cell's inputs, one
rollout of the program at the cell's size, and the reference's judgement
of every episode and of as many replayed episodes as a run of
`--rollouts` rollouts samples; then the control, the reference itself
computed one precision below the configuration's (float32 whose matrix
products read TF32), put in the program's place at the same recorded
states.  With `--fault` the program runs with that fault of
`faults.py` planted.  One JSON line per seed with both sets of compared
numbers: the program's readings give each limit's lower end, the
control's and the faults' its upper end.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness as H  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402


def control_numbers(fam, inputs, ctrl: dict, ref64: dict) -> dict:
    """The control's compared numbers: its controls of the replayed
    sample, and its next states and learner products of every episode,
    judged as the program's are (it starts where it was handed)."""
    cand = dict(ctrl, x0=inputs["x0s"])
    return fam.numbers(inputs["x0s"], cand, ctrl["us"], ref64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rollouts", type=int, default=6)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--no-control", action="store_true",
                    help="read the program only")
    args = ap.parse_args(argv)
    spec = H.bench_spec()
    cell = H.find_cell(spec, args.workload)
    cfg, traffic = H.cell_files(spec, cell)
    H.cache_dirs()
    import torch
    dev = H.require_card(cell["chips"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["matmul_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["matmul_tf32"])
    fam = H.family_class(cfg)(cfg, traffic, dev)
    if args.fault:
        FAULTS[args.fault](fam)
    n = traffic["check_episodes_per_rollout"]
    precisions = ("f64",) if args.no_control else ("f64", "tf32")
    for i, seed in enumerate(args.seeds):
        inputs = fam.make_inputs(seed)
        if i == 0:
            fam.warmup(inputs)
        t0 = time.perf_counter()
        out = fam.rollout(inputs)
        H.sync(dev)
        roll_s = time.perf_counter() - t0
        kept = [fam.keep(out, H.sample_idx(fam.B, n, seed, k, dev))
                for k in range(args.rollouts)]
        full = fam.keep_all(out)
        bad = int(fam.nonfinite(out))
        del out
        t0 = time.perf_counter()
        prog, ok, rec, refs = H.judge(fam, inputs, kept, full,
                                      cfg["limits"], precisions)
        line = dict(seed=seed, fault=args.fault, rollout_s=roll_s,
                    judge_s=time.perf_counter() - t0,
                    episodes=int(rec["idx"].numel()), nonfinite=bad,
                    correct=ok and bad == 0, program=prog)
        if not args.no_control:
            line["control"] = control_numbers(fam, inputs, refs["tf32"],
                                              refs["f64"])
        print(json.dumps(line), flush=True)
        del inputs, kept, full, rec, refs
    return 0


if __name__ == "__main__":
    sys.exit(main())
