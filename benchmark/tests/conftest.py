"""Shared fixtures of the benchmark's CPU tests: each cell's program and
reference at a size a test run holds (plain kernels on the CPU)."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness as H  # noqa: E402

# a configuration cut to a CPU test's size: (steps, refit every,
# reservoir rows, Adam iterations), and the episodes a rollout holds
SMALL = {"unicycle_mc_sweep": (60, 40, 16, 30),
         "pendulum_online_sweep": (30, 10, 16, 25)}
BATCH = 8


def small_cell(config, dtype="float32"):
    """(family, cfg) of the first cell of configuration `config` at the
    test size on the CPU."""
    spec = H.bench_spec()
    cell = next(w for w in spec["workloads"] if w["config"] == config)
    cfg, traffic = H.cell_files(spec, cell)
    T, te, K, it = SMALL[config]
    cfg = dict(cfg, numSteps=T, train_every_n_steps=te, max_train=K,
               training_iter=it, dtype=dtype)
    traffic = dict(traffic, batch=BATCH, check_episodes_per_rollout=4)
    return H.family_class(cfg)(cfg, traffic, torch.device("cpu")), cfg


def run_small(fam, seed, n_rollouts=2):
    """A rehearsal of set-up and window: the warm-up, then n_rollouts
    rollouts of the same inputs, each with its sample of kept episodes,
    and the first one's records of every episode, as `harness.window`
    keeps them."""
    inputs = fam.make_inputs(seed)
    fam.warmup(inputs)
    kept, prints, bad, full = [], [], [], None
    for k in range(n_rollouts):
        out = fam.rollout(inputs)
        prints.append(fam.fingerprint(out))
        bad.append(int(fam.nonfinite(out)))
        kept.append(fam.keep(out, H.sample_idx(fam.B, 4, seed, k,
                                               fam.dev)))
        full = full or fam.keep_all(out)
    return inputs, kept, full, prints, bad


@pytest.fixture(scope="session", params=sorted(SMALL))
def cell_name(request):
    return request.param


@pytest.fixture(scope="session")
def small_run(cell_name):
    """One rehearsal per cell, judged by the f64 reference and the TF32
    control."""
    fam, cfg = small_cell(cell_name)
    inputs, kept, full, prints, bad = run_small(fam, 2 ** 31 + 77)
    nums, ok, rec, refs = H.judge(fam, inputs, kept, full, cfg["limits"],
                                  ("f64", "tf32"))
    return dict(fam=fam, cfg=cfg, inputs=inputs, kept=kept, full=full,
                prints=prints, bad=bad, nums=nums, ok=ok, rec=rec,
                refs=refs)
