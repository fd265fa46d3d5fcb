"""The yardstick: the frozen rooflines at the shapes whose bounds the
port's table of kernels gives, the trace arithmetic, and the per-layer
readers."""
import pytest

from benchmark import harness as H
from benchmark.yardstick import roofline as R
from benchmark.yardstick import trace as T


def test_roofline_copies_give_the_table_bounds():
    # PERF.md's table of kernels (PRs 3, 13): kernel 1 at (256, 200)
    # 0.0306 ms by operations; kernel 3 at (4, 4, 4), B = 256, 25
    # iterations, 0.00037 ms
    s, by = R.kinv_logdet_bound(256, 200)
    assert s * 1e3 == pytest.approx(0.0306, abs=5e-5) and by == "operations"
    s, by = R.ipm_bound(256, 4, (4, 4, 4, 4))
    assert s * 1e3 == pytest.approx(0.00037, abs=5e-6)
    s, by = R.chol_linv_bound(256, 200)
    assert s * 1e3 == pytest.approx(0.0306, abs=5e-4) and by == "bytes"


class Ev:
    """A stand-in for a kineto event."""

    def __init__(self, name, start, end, device="CPU", corr=0,
                 annotation=False):
        self._n, self._s, self._e = name, start, end
        self._d, self._c, self._a = device, corr, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType." + self._d

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._a


def test_trace_summary_arithmetic():
    evs = [Ev("bench.rollout", 0, 1000, annotation=True),
           Ev("fit", 600, 800, annotation=True),
           Ev("fit", 600, 800, device="CUDA", annotation=True),
           Ev("aten::mm", 0, 400),
           Ev("cudaLaunchKernel", 100, 110, corr=1),
           Ev("cudaLaunchKernel", 200, 210, corr=2),
           Ev("cudaLaunchKernel", 650, 660, corr=3),
           Ev("ipm_kernel<4>", 150, 350, device="CUDA", corr=1),
           Ev("ipm_kernel<4>", 300, 400, device="CUDA", corr=2),
           Ev("kinv_logdet_kernel", 700, 900, device="CUDA", corr=3),
           Ev("Memset (Device)", 950, 960, device="CUDA", corr=99)]
    s = T.summarize(evs, 0, 1000)
    assert s["kernels"] == 3 and s["kernels_in_region"] == 1
    assert s["region_ns"] == 200
    # busy: [150, 400] + [700, 900] + [950, 960]
    assert s["busy_ns"] == 250 + 200 + 10
    assert s["window_ns"] == 1000
    assert s["by_kernel"]["ipm_kernel<4>"] == (2, 300)
    assert s["launches_matched"] == 3
    assert dict(s["idle_gaps"])["aten::mm"] == 150e-9
    assert T.union_ns([(0, 10), (5, 20), (30, 40)]) == 30


def test_readers():
    """Each quantity's reader, found by the metric's name whatever family
    it is split by."""
    s = dict(family="unicycle", wall_s=2.0, region_ns=0.5e9, steps=100,
             kernels=5000, kernels_in_region=1000, adam_iterations=30,
             by_kernel={"ipm_kernel<4, 4, 4, 4>": (100, 100 * 400_000),
                        "sweep_regs_kernel": (30, 30 * 200_000)},
             shapes={"ipm": (4096, 4, (4, 4, 4, 4)),
                     "kinv_logdet": (4096, 64)},
             busy_ns=0.5e9, window_ns=2.0e9)
    read = lambda name: H.metric_reader(name)(s)
    assert read("control_ms_per_step.unicycle") == pytest.approx(15.0)
    assert read("control_ms_per_step.pendulum") == pytest.approx(15.0)
    assert read("launches_per_step.unicycle") == pytest.approx(40.0)
    assert read("fit_ms_per_iter.unicycle") == pytest.approx(500 / 30)
    ipm = R.ipm_bound(4096, 4, (4, 4, 4, 4))[0]
    assert read("ipm_roofline.unicycle") == pytest.approx(100 * ipm / 4e-4)
    fit = R.kinv_logdet_bound(4096, 64)[0]
    assert read("fit_inverse_roofline.unicycle") == pytest.approx(
        100 * fit / 2e-4)
    assert read("device_idle_pct.unicycle") == pytest.approx(75.0)
    s["by_kernel"] = {}
    assert read("fit_inverse_roofline.unicycle") is None
    assert read("ipm_roofline.pendulum") is None
    s["adam_iterations"] = 0
    assert read("fit_ms_per_iter.unicycle") is None
