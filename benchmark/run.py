#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, the card, the kernels from the compile cache in
`build/kernels/`, the inputs made from the seed on the card, a warm-up
of the cell's own shapes) is `setup_s`.  With --trace 0 the window runs
whole batched rollouts back to back for --seconds and reports the
cell's end-to-end metrics; with --trace 1 it runs one rollout under
`torch.profiler` and reports the per-layer metrics.  Either way the
reference then reads every episode of the window's first rollout (its
starts, steps and refits) and replays a sample of the window's episodes
drawn from the seed, and `correct` says whether every compared number is
within its limit.  The last line of standard output is the result's JSON object;
the last lines of standard error are the compared numbers with their
limits.  Without a card, or with the JAX stack loaded, it exits with a
code other than 0 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness as H  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    args = parse(argv)
    spec = H.bench_spec()
    cell = H.find_cell(spec, args.workload)
    cfg, traffic = H.cell_files(spec, cell)
    H.cache_dirs()
    import torch
    dev = H.require_card(cell["chips"])
    tf32 = bool(cfg["matmul_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    print(f"{card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)

    fam = H.family_class(cfg)(cfg, traffic, dev)
    inputs = fam.make_inputs(args.seed)
    fam.warmup(inputs)
    H.sync(dev)
    setup_s = time.perf_counter() - T_START

    n_check = traffic["check_episodes_per_rollout"]
    if args.trace:
        summary, kept, full, fp, nf, read_s = H.traced_rollout(
            fam, inputs, args.seed, n_check)
        kept, prints, bad, n_roll = [kept], [fp], [nf], 1
        metrics = {}
        for m in spec["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            v = H.metric_reader(m["name"])(summary)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        print(f"trace: {summary['events']} events read in {read_s:.3f} s; "
              f"rollout {summary['wall_s']:.4f} s; {summary['kernels']} "
              f"kernels, {summary['launches_matched']} of "
              f"{summary['device_events']} device operations matched to "
              f"their launch", file=sys.stderr)
    else:
        times, kept, full, prints, bad = H.window(
            fam, inputs, args.seconds, args.seed, n_check)
        n_roll = len(times)
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        metrics = {fam.metric: dict(value=H.rate(times,
                                                 fam.steps_per_rollout()),
                                    unit=units[fam.metric]),
                   "setup_s": dict(value=setup_s, unit=units["setup_s"])}
        walls = [b - a for a, b in times]
        print(f"window: {n_roll} rollouts, walls {walls}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev)
    found = H.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4

    prints = torch.stack(prints)
    differ = int((prints != prints[0]).any(-1).sum())
    failed = int(sum(int(b) for b in bad))
    del inputs["state0"]
    torch.cuda.empty_cache()
    r0 = time.perf_counter()
    limits = cfg["limits"]
    nums, ok, _, _ = H.judge(fam, inputs, kept, full, limits)
    ref_s = time.perf_counter() - r0
    checks = {k: dict(value=nums[k], limit=limits[k]) for k in limits}
    checks["rollouts_differ"] = dict(value=differ, limit=0)
    checks["episodes_failed"] = dict(value=failed, limit=0)
    correct = ok and differ == 0 and failed == 0

    result = dict(correct=correct, attempted=n_roll * fam.B, failed=failed,
                  metrics=metrics,
                  device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(dev),
                              count=cell["chips"], memory_peak_bytes=peak))
    if args.trace:
        result["device"].update(busy_s=summary["busy_ns"] / 1e9,
                                window_s=summary["window_ns"] / 1e9)
        result["breakdown"] = dict(device_ops=summary["device_ops"],
                                   idle_gaps=summary["idle_gaps"])
    result["checks"] = checks
    info = {k: v for k, v in nums.items() if k not in limits}
    print(f"reference: {ref_s:.3f} s; {sum(len(k['idx']) for k in kept)} "
          f"episodes replayed, {fam.B} read; not compared: {info}",
          file=sys.stderr)
    for k, v in checks.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
