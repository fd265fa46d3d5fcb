"""The readers of the program's own spans and counters
(`yardstick/spans.py`): each on a synthetic report, each None where the
program has no tracer or recorded nothing it reads, and each on a real
CPU recording of the program."""
import sys

import pytest
import torch

from benchmark import harness as H
from benchmark.yardstick import spans as S

SPAN_READERS = {"moments_ms_per_step": ("step/moments", "device_ns"),
                "cones_ms_per_step": ("step/cones", "device_ns"),
                "socp_ms_per_step": ("step/socp", "device_ns"),
                "lqr_ms_per_step": ("step/lqr", "device_ns"),
                "step_host_ms_per_step": ("step", "host_ns")}
COUNTER_READERS = {"controller_fallback_pct": ("controller.fallbacks",
                                               "controller.episodes"),
                   "adam_rejected_pct": ("adam.rejected",
                                         "adam.episode_iters")}
NEW = sorted(SPAN_READERS) + sorted(COUNTER_READERS)


def _row(host, dev):
    return dict(n=100, host_ns=host, device_ns=dev, self_host_ns=host,
                self_device_ns=dev)


REPORT = {"spans": {"step": _row(900e6, 2000e6),
                    "step/moments": _row(100e6, 500e6),
                    "step/cones": _row(200e6, 300e6),
                    "step/socp": _row(300e6, 700e6),
                    "step/lqr": _row(50e6, 150e6),
                    "fit": _row(10e6, 800e6)},
          "counters": {"controller.episodes": 4000,
                       "controller.fallbacks": 10,
                       "adam.episode_iters": 600, "adam.rejected": 3}}
STEPS = dict(steps=100)


@pytest.mark.parametrize("quantity", NEW)
def test_reader_on_a_synthetic_report(quantity, monkeypatch):
    monkeypatch.setattr(S, "report", lambda: REPORT)
    got = H.metric_reader(f"{quantity}.unicycle")(STEPS)
    if quantity in SPAN_READERS:
        path, key = SPAN_READERS[quantity]
        want = REPORT["spans"][path][key] / 1e6 / 100
    else:
        part, whole = COUNTER_READERS[quantity]
        c = REPORT["counters"]
        want = 100.0 * c[part] / c[whole]
    assert got == pytest.approx(want)


@pytest.mark.parametrize("quantity", NEW)
def test_reader_without_a_tracer_or_a_reading(quantity, monkeypatch):
    read = H.metric_reader(f"{quantity}.pendulum")
    monkeypatch.setattr(S, "report", lambda: {"spans": {}, "counters": {}})
    assert read(STEPS) is None
    monkeypatch.setattr(S, "report", lambda: {
        "spans": {p: _row(1, None) for p, _ in SPAN_READERS.values()},
        "counters": {"controller.episodes": 0}})
    if quantity != "step_host_ms_per_step":
        assert read(STEPS) is None
    monkeypatch.undo()
    # a program without the tracer module (an earlier commit)
    import bayesian_cbf_tpu_torch.observability as obs
    monkeypatch.delattr(obs, "tracing", raising=False)
    monkeypatch.setitem(sys.modules,
                        "bayesian_cbf_tpu_torch.observability.tracing", None)
    assert S.report() is None
    assert read(STEPS) is None


def test_readers_on_a_recording_of_the_program():
    """A 3-step pendulum batch on the CPU under `recording()`: every new
    reader but the stream times (None on the CPU) reads it."""
    from bayesian_cbf_tpu_torch.experiments import pendulum as tp
    from bayesian_cbf_tpu_torch.observability import tracing
    sim = tp.make_pendulum_online_sim(numSteps=3, max_train=4,
                                      training_iter=2, train_every_n_steps=1,
                                      device="cpu", dtype=torch.float64)
    x0s = torch.tensor([[tp.THETA0, 0.0]] * 2, dtype=torch.float64)
    with tracing.recording():
        tp.run_pendulum_online_batch(sim, x0s,
                                     torch.Generator().manual_seed(0))
    read = lambda q: H.metric_reader(f"{q}.pendulum")(dict(steps=3))
    assert read("step_host_ms_per_step") > 0
    assert 0 <= read("controller_fallback_pct") <= 100
    assert 0 <= read("adam_rejected_pct") <= 100
    for q in SPAN_READERS:
        if q != "step_host_ms_per_step":
            assert read(q) is None
