"""What `run.py` and `calibrate.py` share: finding a cell's files by name,
the card check, the family that drives the program, the measured
window, the traced rollout and the judgement.

A cell (`BENCHMARK.json` "workloads") names a configuration (its file,
`configs/<config>.json`, names the family module `families/<family>.py`
that drives it) and a traffic mix (`traffic/<traffic>.json`); a
per-layer metric `<quantity>.<family>` is read by
`metrics/<quantity>.py`.  A later cell, configuration or metric is a new
file and a new entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# modules that must never be loaded: the JAX stack and the JAX package,
# compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "bayesian_cbf_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in spec['workloads']]}")


def cell_files(spec: dict, cell: dict, root: Path = ROOT):
    """(configuration, traffic) of a cell, read from their files."""
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(root / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cfg, traffic


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_class(cfg: dict):
    """The family module that drives a configuration's program."""
    import importlib
    return importlib.import_module(f"benchmark.families.{cfg['family']}"
                                   ).Family


def metric_reader(name: str):
    """`read(summary)` of the per-layer metric `name`, from
    `metrics/<quantity>.py`, the quantity being the name before its first
    dot: `control_ms_per_step.unicycle` reads `control_ms_per_step.py`
    (the part after the dot names the family whose end-to-end metric the
    split moves)."""
    quantity = name.split(".")[0]
    return load_module(HERE / "metrics" / f"{quantity}.py",
                       "benchmark_metric_" + quantity).read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program's own kernels build into `build/kernels/` there."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(root / "build" / "bench_cache" / sub)


def require_card(chips: int):
    """The card, or SystemExit: this benchmark never runs on the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("benchmark: CUDA is not available; the benchmark "
                         "runs only on an NVIDIA card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"benchmark: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

def sample_idx(B: int, n: int, seed: int, k: int, device):
    """The k-th rollout's sample of n episodes: the k-th slice of one
    permutation of the batch drawn from the seed, so the samples of the
    first B / n rollouts are distinct episodes."""
    import torch
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(seed))
    start = (k * n) % B
    return perm[start:start + n].sort().values.to(device)


def window(fam, inputs, seconds: float, seed: int, n_check: int):
    """Whole rollouts back to back, each ended by a synchronize; a new one
    starts only while the mean rollout so far fits in the time left.
    Returns (rollout (start, end) host times, each rollout's sample of
    kept records, the first rollout's records of every episode, each
    rollout's fingerprint and non-finite episode count)."""
    times, kept, prints, bad = [], [], [], []
    full = None
    t_first = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out = fam.rollout(inputs)
        prints.append(fam.fingerprint(out))
        bad.append(fam.nonfinite(out))
        kept.append(fam.keep(out, sample_idx(fam.B, n_check, seed,
                                             len(kept), fam.dev)))
        if full is None:
            full = _own(fam.keep_all(out))
        del out
        sync(fam.dev)
        t1 = time.perf_counter()
        times.append((t0, t1))
        mean = statistics.fmean(b - a for a, b in times)
        if t1 - t_first + mean > seconds:
            return times, kept, full, prints, bad


def _own(tree):
    """Copies of the tensors of a record, so that it keeps nothing else of
    the rollout's outputs alive."""
    if isinstance(tree, dict):
        return {k: _own(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_own(v) for v in tree)
    return tree.clone()


def rate(times, steps_per_rollout: int) -> float:
    """Episode-steps of every whole rollout over the time from the first
    rollout's start to the last one's end."""
    return len(times) * steps_per_rollout / (times[-1][1] - times[0][0])


def traced_rollout(fam, inputs, seed: int, n_check: int):
    """One rollout under `torch.profiler` (host and device activity),
    read in memory: (summary, the sample's kept records, the records of
    every episode, fingerprint, non-finite count, seconds the trace took
    to read)."""
    import torch
    from benchmark.yardstick.trace import summarize
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.rollout"):
            t0 = time.perf_counter()
            out = fam.rollout(inputs)
            sync(fam.dev)
            t1 = time.perf_counter()
    r0 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    mark = [e for e in events if e.name() == "bench.rollout"
            and e.is_user_annotation()][0]
    s = summarize(events, mark.start_ns(), mark.end_ns())
    n_events = len(events)
    del events, prof
    fp, nf = fam.fingerprint(out), fam.nonfinite(out)
    kept = fam.keep(out, sample_idx(fam.B, n_check, seed, 0, fam.dev))
    full = _own(fam.keep_all(out))
    del out
    s.update(family=fam.cfg["family"], steps=fam.T, batch=fam.B,
             wall_s=t1 - t0, adam_iterations=fam.adam_iterations(),
             shapes=fam.roofline_shapes(), events=n_events)
    return s, kept, full, fp, nf, time.perf_counter() - r0


def judge(fam, inputs, kept: list, full: dict, limits: dict,
          precisions=("f64",)):
    """The program's compared numbers against the f64 reference, each
    with its limit, and whether all hold; also the gathered sample and
    the reference in each of `precisions`."""
    rec = fam.gather(kept)
    refs = {p: fam.reference(inputs, rec, full, p) for p in precisions}
    nums = fam.numbers(inputs["x0s"], fam.candidate(full), rec["U"],
                       refs["f64"])
    ok = all(nums[k] <= limits[k] for k in limits)
    return nums, ok, rec, refs
