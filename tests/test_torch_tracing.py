"""The port's tracer (`observability/tracing.py`) on the CPU: span paths
and self times; nothing dispatched with no recording open; spans on the
profiler's timeline and clock; the spans and counters of the unicycle and
pendulum batches, whose outputs recording leaves bit for bit; and
`decompose_trace`'s split by span.
"""
import json
import math
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bayesian_cbf_tpu_torch.experiments import pendulum as tp
from bayesian_cbf_tpu_torch.experiments import unicycle as tu
from bayesian_cbf_tpu_torch.observability import profiling as tprof
from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.sim.rollout import simulate_unicycle_batch

F64 = torch.float64
B = 2


def _unicycle(train_every=2):
    """3 steps, a refit of 2 Adam iterations after each positive multiple
    of train_every below 3."""
    sim = tu.make_ackermann_tracking_sim(numSteps=3, dt=0.01, max_train=4,
                                         training_iter=2, device="cpu",
                                         dtype=F64)
    sim = sim._replace(learned_dynamics=sim.learned_dynamics._replace(
        train_every_n_steps=train_every))
    x0s = torch.tensor([tu.STATE_START] * B, dtype=F64)
    return sim, lambda: simulate_unicycle_batch(
        sim, x0s, torch.Generator().manual_seed(0))


def _pendulum(closed_form=True, train_every=1):
    """3 steps, a refit of 2 Adam iterations after each positive multiple
    of train_every below 3."""
    sim = tp.make_pendulum_online_sim(numSteps=3, max_train=4,
                                      training_iter=2,
                                      train_every_n_steps=train_every,
                                      device="cpu", dtype=F64)
    sim = sim._replace(controller=sim.controller._replace(
        closed_form=closed_form))
    x0s = torch.tensor([[tp.THETA0, 0.0]] * B, dtype=F64)
    return sim, lambda: tp.run_pendulum_online_batch(
        sim, x0s, torch.Generator().manual_seed(0))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None or isinstance(tree, (int, float, str)):
        return []
    return [a for t in tree for a in _leaves(t)]


def _same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---- the tracer -------------------------------------------------------------

def test_nested_spans_give_paths_and_self_times():
    """Paths are the names of the open spans; a span's self time is its
    time less its direct children's; counters take ints, tensors (their
    sums) and functions of tensors, summed and called at report, on the
    tensors as they were counted; report is idempotent and reset
    forgets."""
    with tracing.recording():
        with tracing.span("a"):
            time.sleep(0.002)
            for _ in range(2):
                with tracing.span("b"):
                    with tracing.span("c"):
                        time.sleep(0.001)
            tracing.count("n", 2)
            tracing.count("n", torch.tensor(3))
            mask = torch.tensor([True, False, False])
            tracing.count("n", torch.logical_not, mask)
            mask = torch.tensor([True, True, True])
        with tracing.span("b"):
            pass
    rep = tracing.report()
    assert rep == tracing.report()
    s = rep["spans"]
    assert set(s) == {"a", "a/b", "a/b/c", "b"}
    assert [s[p]["n"] for p in ("a", "a/b", "a/b/c", "b")] == [1, 2, 2, 1]
    assert all(v["device_ns"] is None and v["self_device_ns"] is None
               for v in s.values())
    assert s["a"]["self_host_ns"] == s["a"]["host_ns"] - s["a/b"]["host_ns"]
    assert s["a/b"]["self_host_ns"] == (s["a/b"]["host_ns"]
                                        - s["a/b/c"]["host_ns"])
    assert s["a/b/c"]["self_host_ns"] == s["a/b/c"]["host_ns"] >= 2e6
    assert s["a"]["self_host_ns"] >= 2e6
    assert rep["counters"] == {"n": 7}
    tracing.count("n", 5)
    assert tracing.report()["counters"] == {"n": 7}
    tracing.reset()
    assert tracing.report() == {"spans": {}, "counters": {}}


def test_nothing_is_counted_or_spanned_without_a_recording():
    called = []
    assert not tracing.enabled()
    assert tracing.span("x") is tracing.span("y")
    tracing.count("x", lambda: called.append(1) or torch.tensor(1))
    with tracing.recording():
        assert tracing.enabled()
    assert not called and tracing.report() == {"spans": {}, "counters": {}}


class _Ops(TorchDispatchMode):
    """The names of the ATen operations dispatched while active."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family", ["unicycle", "pendulum"])
def test_no_recording_dispatches_exactly_the_untraced_ops(family,
                                                          monkeypatch):
    """With no recording open, the 3-step batch dispatches the same ATen
    operations, in the same order, as with `span` and `count` replaced by
    no-ops, and records no CUDA event."""
    run = (_unicycle if family == "unicycle" else _pendulum)()[1]
    run()

    def no_event():
        raise AssertionError("a CUDA event was recorded")

    monkeypatch.setattr(tracing, "_event", no_event)
    with _Ops() as traced:
        out = run()
    monkeypatch.setattr(tracing, "span",
                        lambda name: tracing.contextlib.nullcontext())
    monkeypatch.setattr(tracing, "count", lambda name, value=1, *args: None)
    with _Ops() as bare:
        again = run()
    assert len(traced.names) > 100
    assert traced.names == bare.names
    assert _same_bits(out, again)


@pytest.mark.parametrize("family", ["unicycle", "pendulum"])
def test_a_recording_adds_no_operation_to_the_steps(family):
    """With a recording open, 3 steps without a refit dispatch the ATen
    operations they dispatch with none open, and the spans' own
    `record_function` operations: the step's counters read their tensors
    at `report()`."""
    run = (_unicycle if family == "unicycle" else _pendulum)(
        train_every=100)[1]
    with _Ops() as off:
        run()
    with tracing.recording():
        with _Ops() as on:
            run()
    kept = [n for n in on.names if not n.startswith("profiler.")]
    assert len(kept) < len(on.names)
    assert kept == off.names
    assert tracing.report()["counters"]["controller.episodes"] == 3 * B


def test_spans_lie_on_the_profilers_timeline_and_clock():
    """Under torch.profiler every span is a user annotation of its name,
    and the tracer's host start lies within 200 us of the annotation's
    (the same Unix-epoch clock); a profiler session starts a fresh
    recording, which report gives after it ends."""
    sim, run = _pendulum()
    with tracing.recording():
        run()                          # the first record_function's set-up
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        starts = [(p.rpartition("/")[2], t0)
                  for p, t0, *_ in tracing._rec.spans]
    events = prof.profiler.kineto_results.events()
    marks = {}
    for e in events:
        if e.is_user_annotation():
            marks.setdefault(e.name(), []).append(e.start_ns())
    names = {"step", "moments", "lqr", "cones", "socp", "fit"}
    assert {n for n, _ in starts} == names
    for name in names:
        mine = sorted(t for n, t in starts if n == name)
        theirs = sorted(marks[name])
        assert len(mine) == len(theirs)
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 200_000
    rep = tracing.report()
    assert rep["spans"]["step"]["n"] == sim.numSteps
    assert rep["counters"]["controller.episodes"] == B * sim.numSteps


def test_unicycle_batch_spans_and_counters():
    sim, run = _unicycle()
    out = run()
    with tracing.recording():
        traced = run()
    assert _same_bits(out, traced)
    rep = tracing.report()
    s, c = rep["spans"], rep["counters"]
    T, iters = sim.numSteps, sim.learned_dynamics.training_iter
    assert set(s) == {"step", "step/moments", "step/cones", "step/socp",
                      "fit"}
    assert all(s[p]["n"] == T for p in s if p.startswith("step"))
    assert s["fit"]["n"] == 1
    assert all(s[p]["host_ns"] <= s["step"]["host_ns"]
               for p in ("step/moments", "step/cones", "step/socp"))
    assert c["controller.episodes"] == B * T
    assert 0 <= c["controller.fallbacks"] <= B * T
    assert c["adam.episode_iters"] == B * iters * 1
    assert 0 <= c["adam.rejected"] <= c["adam.episode_iters"]
    assert sum(c[f"refresh.rung{i}"] for i in range(3)) == B
    assert not any(k.startswith("launches.") for k in c)


@pytest.mark.parametrize("closed_form", [True, False])
def test_pendulum_batch_spans_and_counters(closed_form):
    sim, run = _pendulum(closed_form)
    out = run()
    with tracing.recording():
        traced = run()
    assert _same_bits(out, traced)
    rep = tracing.report()
    s, c = rep["spans"], rep["counters"]
    T, iters = sim.numSteps, sim.learned.training_iter
    assert set(s) == {"step", "step/moments", "step/lqr", "step/cones",
                      "step/socp", "fit"}
    assert all(s[p]["n"] == T for p in s if p.startswith("step"))
    assert s["fit"]["n"] == 2
    assert c["controller.episodes"] == B * T
    assert c["adam.episode_iters"] == B * iters * 2
    assert sum(c[f"refresh.rung{i}"] for i in range(3)) == 2 * B


# ---- decompose_trace by span ------------------------------------------------

def test_decompose_trace_by_span_synthetic(tmp_path):
    """Kernels under the innermost span holding their launch, idle
    stretches under the innermost span holding their middle, the region's
    own path for the rest; to the microsecond."""
    X = lambda cat, name, ts, dur, corr=None: dict(
        ph="X", cat=cat, name=name, ts=ts, dur=dur,
        **({"args": {"correlation": corr}} if corr is not None else {}))
    evs = [X("user_annotation", "steps", 0, 1000),
           X("user_annotation", "step", 10, 400),
           X("user_annotation", "cones", 20, 100),
           X("user_annotation", "socp", 200, 100),
           X("user_annotation", "step", 500, 300),
           X("user_annotation", "cones", 510, 50),
           X("user_annotation", "fit", 900, 90),
           X("user_annotation", "step", 2000, 50),
           X("cuda_runtime", "cudaLaunchKernel", 30, 5, 1),
           X("kernel", "elementwise_kernel", 40, 60, 1),
           X("cuda_runtime", "cudaLaunchKernel", 210, 5, 2),
           X("kernel", "ipm_kernel", 220, 200, 2),
           X("cuda_runtime", "cudaLaunchKernel", 350, 5, 3),
           X("kernel", "gemm", 430, 20, 3),
           X("cuda_runtime", "cudaLaunchKernel", 520, 5, 4),
           X("kernel", "elementwise_kernel", 600, 100, 4),
           X("cuda_runtime", "cudaLaunchKernel", 905, 5, 5),
           X("kernel", "sweep_regs_kernel", 910, 150, 5),
           X("cuda_runtime", "cudaLaunchKernel", 2010, 5, 6),
           X("kernel", "ipm_kernel", 2020, 10, 6)]
    p = str(tmp_path / "trace.json")
    with open(p, "w") as f:
        json.dump({"traceEvents": evs}, f)
    d = tprof.decompose_trace(p, top_level="steps")
    by = d["by_span"]
    us = 1e-6
    assert set(by) == {"steps", "steps/step", "steps/step/cones",
                       "steps/step/socp", "steps/fit"}
    assert by["steps/step/cones"]["launches"] == 2
    assert by["steps/step/cones"]["device_s"] == pytest.approx(160 * us)
    assert by["steps/step/socp"]["device_s"] == pytest.approx(200 * us)
    assert by["steps/step"]["device_s"] == pytest.approx(20 * us)
    assert by["steps/fit"]["device_s"] == pytest.approx(150 * us)
    assert by["steps"]["launches"] == 0
    # idle: [0, 40) middle 20 -> cones; [100, 220) middle 160 -> step;
    # [420, 430) middle 425 -> steps; [450, 600) middle 525 -> cones;
    # [700, 910) middle 805 -> steps; the span runs to the last kernel's
    # end at 1060
    assert by["steps/step/cones"]["idle_s"] == pytest.approx(190 * us)
    assert by["steps/step"]["idle_s"] == pytest.approx(120 * us)
    assert by["steps"]["idle_s"] == pytest.approx(220 * us)
    assert by["steps/step/socp"]["idle_s"] == 0.0
    assert by["steps/fit"]["idle_s"] == 0.0
    assert math.isclose(sum(r["idle_s"] for r in by.values()),
                        d["dispatch_gap_s"])
    assert math.isclose(sum(r["device_s"] for r in by.values()),
                        sum(d["by_bucket"].values()))
