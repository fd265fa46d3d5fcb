"""The port's observability on the CPU, against the JAX package where it
has a counterpart: the binary log (the native and the Python writer give
JAX's bytes; each package reads the other's files; ragged and corrupt
files raise), tfevents both ways, `load_metrics` and `replay_run` on each
backend, the console's --log-backend binary and --plot, `decompose_trace`
on a synthetic and on a real CPU trace, `CompiledController.
cost_analysis`, `unicycle_covariances_exp` against JAX on JAX's rollout
and initial weights (f64 roundoff), and the matplotlib figures.
"""
import json
import math
import os
import os.path as osp
import struct

import jax
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.experiments import unicycle as ju
from bayesian_cbf_tpu.models import cogp as jcogp
from bayesian_cbf_tpu.models import mvgp as jmvgp
from bayesian_cbf_tpu.observability import covariances as jcov
from bayesian_cbf_tpu.observability import fastlog as jfl
from bayesian_cbf_tpu_torch import cli, interop
from bayesian_cbf_tpu_torch.deploy import CompiledController
from bayesian_cbf_tpu_torch.experiments import unicycle as tu
from bayesian_cbf_tpu_torch.observability import covariances as tcov
from bayesian_cbf_tpu_torch.observability import fastlog as tfl
from bayesian_cbf_tpu_torch.observability import logger as tl
from bayesian_cbf_tpu_torch.observability import profiling as tprof

F64 = torch.float64
NAME = "unicycle_bayes_cbf_safe_obstacle"
SETS = dict(numSteps=20, dt=0.01, max_train=8, training_iter=2)


# ---- the binary log ---------------------------------------------------------

def _records(w):
    """The same records through any writer: scalars, a vector, a (T, d)
    channel with a stride, a (T, 2, 2) channel flattened, one bool."""
    w.write("opt/value", 0, 1.25)
    w.write("vis/state", 3, np.array([0.5, -1.0, 2.0]))
    w.write_rows("vis/uopt", np.arange(12.0).reshape(6, 2) / 7.0, 10, 3)
    w.write_rows("vis/knl_A", np.arange(16.0).reshape(4, 2, 2), 0, 1)
    w.write("opt/feasible", 4, True)
    w.write("opt/value", 1, -3.5e-7)
    w.close()


def _write(pkg, path, native):
    mod = jfl if pkg == "jax" else tfl
    w = mod.FastLogWriter(path, force_python=not native)
    assert w.native == native
    _records(w)
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def flogs(tmp_path_factory):
    """The records written by JAX's Python writer, the port's native and
    the port's Python writer: {name: (path, bytes)}."""
    d = tmp_path_factory.mktemp("flog")
    out = {}
    for name, pkg, native in (("jax", "jax", False), ("native", "torch", True),
                              ("python", "torch", False)):
        p = str(d / f"{name}.flog")
        out[name] = (p, _write(pkg, p, native))
    return out


@pytest.mark.parametrize("name", ["native", "python"])
def test_fastlog_writers_give_jax_bytes(flogs, name):
    assert flogs[name][1] == flogs["jax"][1]
    assert flogs[name][1][:8] == b"FLOG0001"


@pytest.mark.parametrize("writer,reader", [("native", "jax"),
                                           ("jax", "torch")])
def test_fastlog_files_read_across_packages(flogs, writer, reader):
    """Each package reads the other's file to the same steps and float32
    values: the channel rows flattened, the strided steps."""
    got = (jfl if reader == "jax" else tfl).read_fastlog(flogs[writer][0])
    want = tfl.read_fastlog(flogs["python"][0])
    assert sorted(got) == sorted(want)
    for tag in want:
        np.testing.assert_array_equal(got[tag][0], want[tag][0])
        np.testing.assert_array_equal(got[tag][1], want[tag][1])
    assert want["vis/uopt"][0].tolist() == [10, 13, 16, 19, 22, 25]
    assert want["vis/knl_A"][1].shape == (4, 4)
    assert want["opt/value"][1].dtype == np.float32


def test_fastlog_ragged_and_corrupt_files_raise(tmp_path):
    """A tag whose records differ in length, a wrong magic, an unknown
    record kind and a record cut short each raise ValueError."""
    p = str(tmp_path / "ragged.flog")
    with tfl.FastLogWriter(p) as w:
        w.write("a", 0, [1.0, 2.0])
        w.write("a", 1, [1.0])
    with pytest.raises(ValueError, match="ragged"):
        tfl.read_fastlog(p)
    good = _write("torch", str(tmp_path / "good.flog"), True)
    for name, blob in (("magic", b"FLOG0002" + good[8:]),
                       ("kind", good + b"\x07"),
                       ("cut", good[:-3]),
                       ("tagdef", good + struct.pack("<BHH", 1, 9, 40) + b"x")):
        p = str(tmp_path / f"{name}.flog")
        with open(p, "wb") as f:
            f.write(blob)
        with pytest.raises(ValueError):
            tfl.read_fastlog(p)


def test_fastlog_native_build_lives_under_build(tmp_path):
    """The native writer is built from the package's source into the
    ignored build/ tree (keyed by a hash of source and flags)."""
    tfl.load_native()
    path = tfl.native_library_path()
    assert path.exists() and path.parent.name == "kernels"
    assert path.parent.parent.name == "build"
    assert tfl.NATIVE_SRC.read_bytes() != b""


# ---- the logger's backends, load_metrics, replay ---------------------------

@pytest.fixture(scope="module")
def episode():
    """A 20-step Bayes-CBF episode on the CPU in f64 and its sim."""
    return tu.unicycle_bayes_cbf_safe_obstacle(**SETS, device="cpu",
                                               dtype=F64)


def _log(tmp, backend, episode):
    sim, out = episode
    lg = tl.MetricsLogger(str(tmp), [backend], backend=backend,
                          config={"name": NAME})
    lg.log_rollout(out, sim=sim)
    lg.close()
    return lg.dir


@pytest.mark.parametrize("backend", ["jsonl", "binary", "tensorboard"])
def test_backends_read_back_the_same_channels(tmp_path, episode, backend):
    """Every backend's run directory reads back through load_metrics with
    the JSONL tags and steps and the float32 of its values (a binary or
    tensorboard record holds the value flattened or shaped); filter_runs
    finds it."""
    if backend == "tensorboard":
        pytest.importorskip("tensorboard")
    ref = tl.load_metrics(_log(tmp_path / "ref", "jsonl", episode))
    run = _log(tmp_path, backend, episode)
    got = tl.load_metrics(run)
    assert sorted(got) == sorted(ref)
    for tag in ref:
        s_r, v_r = zip(*ref[tag])
        s_g, v_g = zip(*sorted(got[tag], key=lambda sv: sv[0]))
        assert s_r == s_g
        flat = lambda v: np.asarray([np.asarray(a, np.float32).reshape(-1)
                                     for a in v])
        np.testing.assert_array_equal(flat(v_g), flat(v_r))
    assert tl.filter_runs(str(tmp_path)) == [run]


def test_binary_backend_and_unknown_backend(tmp_path, episode):
    """add_tensor and add_rows on the binary backend write what the
    Python writer would; an unknown backend raises."""
    lg = tl.MetricsLogger(str(tmp_path), ["t"], backend="binary")
    lg.add_tensor("x", np.eye(2), 5)
    lg.add_rows("y", torch.arange(6.0).reshape(3, 2), every=2)
    lg.close()
    got = tfl.read_fastlog(osp.join(lg.dir, "metrics.flog"))
    assert got["x"][0].tolist() == [5] and got["x"][1].shape == (1, 4)
    assert got["y"][0].tolist() == [0, 2] and got["y"][1].tolist() == [
        [0.0, 1.0], [4.0, 5.0]]
    with pytest.raises(ValueError, match="backend"):
        tl.MetricsLogger(str(tmp_path), ["u"], backend="csv")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tfevents_read_across_packages(tmp_path, writer):
    """Scalars and float tensors written by one package's
    TensorboardWriter read back through the other's
    load_tensorboard_scalars (tensors as float_val)."""
    pytest.importorskip("tensorboard")
    from bayesian_cbf_tpu.observability import tbwriter as jtb
    from bayesian_cbf_tpu_torch.observability import tbwriter as ttb
    w = (jtb if writer == "jax" else ttb).TensorboardWriter(str(tmp_path))
    w.add_scalar("opt/value", 1.5, 0)
    w.add_scalar("opt/value", torch.tensor(-2.0, dtype=F64), 1)
    w.add_tensor("vis/state", np.array([[1.0, 2.0], [3.0, 4.5]]), 2)
    w.add_tensor("vis/uopt", torch.tensor([0.25, 0.5]), 3)
    w.close()
    got = (ttb if writer == "jax" else jtb).load_tensorboard_scalars(
        str(tmp_path))
    assert [s for s, _ in got["opt/value"]] == [0, 1]
    assert [v for _, v in got["opt/value"]] == [1.5, -2.0]
    step, v = got["vis/state"][0]
    assert step == 2 and v.dtype == np.float32
    np.testing.assert_array_equal(v, [[1.0, 2.0], [3.0, 4.5]])
    np.testing.assert_array_equal(got["vis/uopt"][0][1], [0.25, 0.5])


@pytest.mark.parametrize("backend", ["jsonl", "binary", "tensorboard"])
def test_replay_run_from_each_backend(tmp_path, episode, backend):
    """A static PNG from every backend's log; an animation from the
    binary one."""
    pytest.importorskip("matplotlib")
    if backend == "tensorboard":
        pytest.importorskip("tensorboard")
    run = _log(tmp_path, backend, episode)
    png = osp.join(run, "replay.png")
    ax = tl.replay_run(run, savefile=png)
    assert osp.getsize(png) > 1000
    X = np.asarray(ax.lines[0].get_xydata())
    np.testing.assert_allclose(X, episode[1].X[:, :2].numpy(), rtol=1e-6)
    if backend == "binary":
        gif = tl.replay_run(run, animate=True, frame_stride=5)
        assert gif == osp.join(run, "animation.gif") and osp.getsize(gif) > 0


# ---- the console ------------------------------------------------------------

def test_cli_binary_backend_and_plot(tmp_path, capsys):
    """--log-backend binary writes metrics.flog (the native writer) and no
    JSONL; --plot draws trajectory.png from it."""
    pytest.importorskip("matplotlib")
    args = [a for k, v in SETS.items() for a in ("--set", f"{k}={v}")]
    assert cli.main([NAME, "--cpu", *args, "--runs-dir", str(tmp_path),
                     "--log-backend", "binary", "--plot"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run = out["run_dir"]
    files = sorted(os.listdir(run))
    assert "metrics.flog" in files and "metrics.jsonl" not in files
    assert osp.getsize(osp.join(run, "trajectory.png")) > 1000
    assert len(tl.load_metrics(run)["vis/state"]) == SETS["numSteps"]


def test_cli_plot_needs_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib, --plot raises ImportError before the run."""
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        cli.main([NAME, "--cpu", "--runs-dir", str(tmp_path), "--plot"])
    assert os.listdir(tmp_path) == []


# ---- profiling ---------------------------------------------------------------

def _synthetic_trace(path):
    """Two "steps" regions (the longer one read), a "fit" region inside
    it, kernels launched inside and outside, one launch record missing."""
    X = lambda cat, name, ts, dur, corr=None: dict(
        ph="X", cat=cat, name=name, ts=ts, dur=dur,
        **({"args": {"correlation": corr}} if corr is not None else {}))
    evs = [X("user_annotation", "steps", 100, 1000),
           X("user_annotation", "steps", 5000, 200),
           X("user_annotation", "fit", 600, 300),
           X("cuda_runtime", "cudaLaunchKernel", 150, 5, 1),
           X("kernel", "void ipm_kernel<4, 4, 4, 4>(float*)", 200, 100, 1),
           X("cuda_runtime", "cudaLaunchKernel", 650, 5, 2),
           X("kernel", "kinv_logdet_kernel", 700, 150, 2),
           X("cuda_runtime", "cudaLaunchKernel", 1050, 5, 3),
           X("kernel", "elementwise_kernel", 1080, 100, 3),
           X("cuda_runtime", "cudaLaunchKernel", 4000, 5, 4),
           X("kernel", "void ipm_kernel<4, 4, 4, 4>(float*)", 4010, 50, 4),
           X("kernel", "gram_kernel", 300, 50),
           {"ph": "M", "name": "process_name", "pid": 0}]
    with open(path, "w") as f:
        json.dump({"traceEvents": evs}, f)


def test_decompose_trace_synthetic(tmp_path):
    """The longest region; kernels by their launch; the span to the last
    kernel's end; busy, gap, buckets, fit and scan to the microsecond."""
    p = str(tmp_path / "trace.json")
    _synthetic_trace(p)
    d = tprof.decompose_trace(p, top_level="steps")
    assert math.isclose(d["span_s"], 1080e-6)
    assert math.isclose(d["leaf_busy_s"], 400e-6)
    assert math.isclose(d["dispatch_gap_s"], 680e-6)
    assert d["by_bucket"] == pytest.approx(
        {"kinv_logdet": 150e-6, "ipm": 100e-6, "other": 100e-6,
         "gram": 50e-6})
    assert d["fit"] == pytest.approx({"kinv_logdet": 150e-6})
    assert sorted(d["scan"]) == ["gram", "ipm", "other"]
    assert sorted(tprof.kernel_summary(p)) == [
        "elementwise_kernel", "gram_kernel", "kinv_logdet_kernel",
        "void ipm_kernel<4, 4, 4, 4>(float*)"]
    with pytest.raises(ValueError, match="ticks"):
        tprof.decompose_trace(p, top_level="ticks")


def test_trace_of_a_cpu_rollout(tmp_path):
    """A real torch.profiler trace of a 3-step batch with a refit after
    step 2: the "steps" region is found, its refit region is in the
    trace, and without a card no kernel runs (the whole span is gap)."""
    from bayesian_cbf_tpu_torch.sim.rollout import simulate_unicycle_batch
    sim = tu.make_ackermann_tracking_sim(numSteps=3, dt=0.01, max_train=4,
                                         training_iter=2, device="cpu",
                                         dtype=F64)
    sim = sim._replace(learned_dynamics=sim.learned_dynamics._replace(
        train_every_n_steps=2))
    x0s = torch.tensor([tu.STATE_START] * 2, dtype=F64)
    with tprof.trace(str(tmp_path)) as path:
        with tprof.annotate("steps"):
            simulate_unicycle_batch(sim, x0s, torch.Generator().manual_seed(0))
    d = tprof.decompose_trace(path, top_level="steps")
    names = {e.get("name") for e in tprof.load_trace_events(path)
             if e.get("cat") == "user_annotation"}
    assert {"steps", "fit"} <= names
    assert d["span_s"] > 0 and d["by_bucket"] == {}
    assert d["dispatch_gap_s"] == d["span_s"]
    assert tprof.trace.last is not None


def test_elapsed_channel(tmp_path):
    lg = tl.MetricsLogger(str(tmp_path), ["t"])
    tprof.elapsed_channel(lg, "exp", 0.25, 2)
    tprof.elapsed_channel(lg, "exp/elapsed", 0.5, 3)
    lg.close()
    assert tl.load_metrics(lg.dir) == {"exp/elapsed": [(2, 0.25), (3, 0.5)]}


def test_cost_analysis_leaves_the_controller_as_it_was():
    """cost_analysis profiles one tick and puts the carry, the step count
    and the generator back: the next tick is the one a controller that
    never profiled takes."""
    sim = tu.make_ackermann_tracking_sim(**SETS, device="cpu", dtype=F64)
    a, b = (CompiledController(sim, tu.STATE_START,
                               torch.Generator().manual_seed(0), device="cpu")
            for _ in range(2))
    for ctl in (a, b):
        ctl.tick()
    cost = a.cost_analysis()
    assert sorted(cost) == ["device_ms", "flops", "kernels", "launches",
                            "wall_ms"]
    assert cost["wall_ms"] > 0 and cost["kernels"] == {} and a.t == 1
    for _ in range(3):
        ua, _ = a.tick()
        ub, _ = b.tick()
        np.testing.assert_array_equal(ua, ub)


# ---- covariance ellipses and figures ---------------------------------------

@pytest.fixture(scope="module")
def covariances():
    """JAX's experiment at its test's size (tests/test_experiments_misc.py:
    115-134) and the port's on JAX's rollout and initial weights."""
    kw = dict(max_train=24, numSteps=96, dt=0.01, training_iter=8, n_test=2)
    want, Xw = jcov.unicycle_covariances_exp(**kw)
    jsim = ju.make_ackermann_tracking_sim(numSteps=96, dt=0.01,
                                          enable_learning=False, true_L=1.0,
                                          mean_L=1.0)
    out = ju._run(jsim, seed=0)
    key = jax.random.PRNGKey(0)
    pm = jmvgp.make_mvgp(3, 2).init_params(key)
    pc = jcogp.make_cogp(3, 2).init_params(key)
    params0 = {
        "matrix": interop.mvgp_params_from_numpy(
            {f: np.asarray(getattr(pm, f))[None] for f in pm._fields},
            "cpu", F64),
        "vector": interop.cogp_params_from_numpy(
            {f: np.asarray(getattr(pc, f)) for f in pc._fields}, "cpu", F64)}
    got, Xg = tcov.unicycle_covariances_exp(
        **kw, data=tuple(np.asarray(a) for a in (out.X, out.U, out.Xdot)),
        params0=params0, device="cpu", dtype=F64)
    return got, Xg, want, Xw


def test_unicycle_covariances_match_jax(covariances):
    """The MVGP's and the CoGP's posterior covariance blocks at the same
    test states equal JAX's to f64 roundoff of an 8-iteration fit (1e-7
    of the largest entry), finite and PSD (MVGP blocks are Bk kron A)."""
    got, Xg, want, Xw = covariances
    np.testing.assert_array_equal(Xg, Xw)
    assert sorted(got) == ["matrix", "vector"]
    for name in got:
        assert got[name].shape == (2, 9, 9)
        scale = np.abs(want[name]).max()
        assert np.abs(got[name] - want[name]).max() <= 1e-7 * scale
        w = np.linalg.eigvalsh(0.5 * (got[name][0] + got[name][0].T))
        assert w.min() > -1e-6


def test_covariance_and_speed_figures_render(tmp_path, covariances):
    pytest.importorskip("matplotlib")
    from bayesian_cbf_tpu_torch.observability import plotting as tplot
    paths = tcov.unicycle_covariances_vis(covariances[0],
                                          savedir=str(tmp_path))
    assert len(paths) == 2 and all(osp.getsize(p) > 1000 for p in paths)
    res = {"matrix": {8: {"elapsed": 1e-3, "error": 0.5},
                      16: {"elapsed": 2e-3, "error": 0.4}},
           "vector": {8: {"elapsed": 3e-3, "error": 0.6},
                      16: {"elapsed": 9e-3, "error": 0.3}}}
    p = str(tmp_path / "speed.png")
    tplot.plot_speed_test(res, savefile=p)
    assert osp.getsize(p) > 1000
    scales, theta = tplot.var_to_scale_theta(np.array([[4.0, 0.0],
                                                       [0.0, 1.0]]))
    np.testing.assert_allclose(scales, [2.0, 1.0])
    assert abs(math.sin(theta)) < 1e-12


def test_learned_dynamics_contours_render(tmp_path):
    """The learned-against-true contour grid at a small size on the CPU:
    three rows of four panels, written to a file."""
    pytest.importorskip("matplotlib")
    from bayesian_cbf_tpu_torch.observability import plotting as tplot
    p = str(tmp_path / "contours.png")
    fig = tplot.plot_learned_dynamics_contours(
        max_train=16, training_iter=2, grid=6, savefile=p, device="cpu")
    assert len(fig.axes) == 24 and osp.getsize(p) > 1000


def test_carworld_renders(tmp_path):
    pytest.importorskip("matplotlib")
    from bayesian_cbf_tpu_torch.observability import carworld
    world = carworld.CarWorld()
    world.setCarPose(1.0, 2.0, 0.3)
    world.setGoal(5.0, 5.0)
    p = world.show(savefile=str(tmp_path / "car.png"))
    world.close()
    assert osp.getsize(p) > 1000
    gif = carworld.render_car_trajectory(
        torch.tensor([[0.1 * t, 0.05 * t, 0.01 * t] for t in range(9)]),
        obstacles=[(1.0, 1.0, 0.3)], goal=(2.0, 1.0),
        savefile=str(tmp_path / "car.gif"), stride=4)
    assert osp.getsize(gif) > 0
