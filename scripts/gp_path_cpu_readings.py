#!/usr/bin/env python3
"""The CPU readings behind the bars of `chip_smoke.py` phase 10 (the GP
expression path), with the kernels' plain versions:

  terms     the CBC2 terms of B = 64 pendulum episodes (K = 60: a learner
            fitted on the first 61 steps of an 80-step batch, the terms
            at step 60) through `cbc2_gp_terms` in f32 and the closed form
            in f32, each against the closed form in f64: median / p90 /
            max per-episode distance;
  bayes     `bayes_clf_control_gp` against `bayes_clf_control` at 256
            states of the bayes_cbf episode (2000 steps) and at its
            start, in f32 and f64: how many states agree to rtol 1e-3,
            atol 1e-4, and each route's distance from the f64 closed form;
  bayes_learning  the same on the learning episode, under a learner
            fitted on its first 201 steps (the learned Fu leaf);
  prerefit  the pendulum episode's 11 steps before its first refit (K =
            200, full size): max |dU| of the GP path against the closed
            form in f32 and f64, the CBC2 terms at its states against
            f64, and the closed form with its terms moved by the GP
            path's gap (8 seeds; `check_outcomes_torch.
            pendulum_prerefit_run`);
  counts    the ATen operations of one `cbc2_gp_terms` call at B = 4
            (K = 12, a learner fitted on 10 recorded steps) and how often
            it evaluates the posterior.

    python3 scripts/gp_path_cpu_readings.py [terms|bayes|bayes_learning|
                                             prerefit|counts ...]

Prints one JSON object per reading.  CPU only, ~20 min in all on 8
cores (most of it the unicycle episodes and the learning fits).
"""
import collections
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench_torch as bt  # noqa: E402
import check_outcomes_torch as co  # noqa: E402
from bayesian_cbf_tpu_torch.control import bayes_controller as tbc  # noqa
from bayesian_cbf_tpu_torch.experiments import pendulum as tp  # noqa: E402
from bayesian_cbf_tpu_torch.experiments import unicycle as tu  # noqa: E402
from bayesian_cbf_tpu_torch.models import mvgp as tmvgp  # noqa: E402
from bayesian_cbf_tpu_torch.models.dynamics import _map  # noqa: E402
from bayesian_cbf_tpu_torch.safety import cbc as tcbc  # noqa: E402

F32, F64 = torch.float32, torch.float64


def _terms(terms):
    (bfe, e), (V, bfv, v), _, _ = terms
    return [bfe, e, V, bfv, v]


def _quantiles(d):
    d = d.double()
    return [float(d.median()), float(d.quantile(0.9)), float(d.max())]


def terms(B=64, K=60, T=80):
    sim = tp.make_pendulum_online_sim(max_train=K, numSteps=T,
                                      device="cpu", dtype=F32)
    gen = torch.Generator().manual_seed(5)
    out = tp.run_pendulum_online_batch(sim, bt.pendulum_x0s("cpu", B),
                                       generator=gen)
    lrn, cbf, k_alpha = sim.learned, sim.cbf, sim.controller.k_alpha
    st = lrn.init_state(B, gen, "cpu", F32)
    for t in range(K + 1):
        st = lrn.record(st, out.X[:, t], out.U[:, t], generator=gen)
    st = lrn.fit_now_first(st)
    xq, u0 = out.X[:, K], torch.full((B, 1), 0.5)
    gp = tcbc.cbc2_gp_terms(cbf, k_alpha, lrn.f_gp_and_fu_gp, st, xq, u0)
    closed = lambda s, x, u: tcbc.cbc2_closed_form_terms(
        cbf, k_alpha, lrn.moment_derivatives(s, x), x, u)
    st64 = _map(lambda a: a.double() if a.is_floating_point() else a, st)
    ref = closed(st64, xq.double(), u0.double())

    def dist(t):
        return torch.stack([
            ((a.double() - r).abs() / (1.0 + r.abs())).reshape(B, -1)
            .amax(-1) for a, r in zip(_terms(t), _terms(ref))]).amax(0)

    return dict(reading="terms", B=B, K=K, gp_f32=_quantiles(dist(gp)),
                closed_f32=_quantiles(dist(closed(st, xq, u0))))


def bayes(name="bayes_cbf"):
    res = dict(reading="bayes", configuration=name)
    sim64 = tu.make_ackermann_tracking_sim(**tu.EXPERIMENTS[name],
                                           device="cpu", dtype=F64)
    for dtype in (F32, F64):
        sim, out = co.unicycle_run(name, "cpu", dtype=dtype)
        steps = torch.linspace(0, out.X.shape[0] - 1, 256).round().long()
        x = out.X[steps]
        st, st0 = (co.learner_state_from_episode(
            sim.learned_dynamics, out.X, out.U, n) for n in (256, 1))
        st64 = _map(lambda a: a.double() if a.is_floating_point() else a,
                    st)

        def run(s, state, xx, t, gp):
            lrn = s.learned_dynamics
            args = (s.controller, s.clf, s.cbfs, s.planner)
            if gp:
                return tbc.bayes_clf_control_gp(*args, lrn.fu_func_gp, state,
                                                xx, t)[0]
            return tbc.bayes_clf_control(*args, lrn.moments(state, xx), xx,
                                         t)[0]

        ug, uc = run(sim, st, x, steps, True), run(sim, st, x, steps, False)
        u64 = run(sim64, st64, x.double(), steps, False)
        rel = lambda u: ((u.double() - u64).abs()
                         / (1.0 + u64.abs())).amax(-1)
        within = ((ug - uc).abs() <= 1e-4 + 1e-3 * uc.abs()).all(-1)
        x0 = torch.tensor([tu.STATE_START], dtype=dtype)
        g0, c0 = run(sim, st0, x0, 0, True), run(sim, st0, x0, 0, False)
        st0_64 = _map(lambda a: a.double() if a.is_floating_point() else a,
                      st0)
        u64_0 = run(sim64, st0_64, x0.double(), 0, False)
        rel0 = lambda u: float(((u.double() - u64_0).abs()
                                / (1.0 + u64_0.abs())).max())
        res[str(dtype).split(".")[-1]] = dict(
            within_rtol=int(within.sum()),
            max_rel_to_closed=float(((ug - uc).abs()
                                     / (1e-4 + uc.abs())).max()),
            gp_from_f64=_quantiles(rel(ug)),
            closed_from_f64=_quantiles(rel(uc)),
            start_gap=float((g0 - c0).abs().max()),
            start_from_f64=[rel0(g0), rel0(c0)],
            start_within_rtol=bool(((g0 - c0).abs()
                                    <= 1e-4 + 1e-3 * c0.abs()).all()))
    return res


def bayes_learning():
    return bayes("learning")


def prerefit(seeds=8):
    """The pendulum episode's steps before its first refit (K = 200): the
    GP path against the closed form in f32 and in f64 (max |dU|), the
    CBC2 terms at the GP episode's states (the f32 GP path and closed
    form against the f64 closed form), and the closed form's episode with
    its terms moved by the GP path's largest distance from it, one per
    seed (max |dU| against the closed form, fallback steps)."""
    res = dict(reading="prerefit")
    eps = {}
    for dtype in (F32, F64):
        for closed in (True, False):
            eps[dtype, closed] = co.pendulum_prerefit_run(
                "cpu", closed_form=closed, dtype=dtype)
    du = lambda a, b: float((a.U - b.U).abs().max())
    sim, cl = eps[F32, True]
    gp = eps[F32, False][1]
    t_gp, t_cl, t_64 = co.pendulum_prerefit_terms(sim, gp.X)
    delta = float(co.cbc2_term_distance(t_gp, t_cl).max())
    moved = [co.pendulum_prerefit_run("cpu", delta=delta, seed=s)[1]
             for s in range(seeds)]
    res.update(
        steps=int(cl.U.shape[0]), du_f32=du(gp, cl),
        du_f32_per_step=(gp.U - cl.U).abs()[:, 0].tolist(),
        du_f64=du(eps[F64, False][1], eps[F64, True][1]),
        gp_terms_from_f64=_quantiles(co.cbc2_term_distance(t_gp, t_64)),
        closed_terms_from_f64=_quantiles(co.cbc2_term_distance(t_cl, t_64)),
        delta=delta, moved_du=[du(m, cl) for m in moved],
        moved_fallbacks=[int((~m.info.feasible).sum()) for m in moved])
    return res


def counts(B=4):
    sim = tp.make_pendulum_online_sim(numSteps=40, max_train=12,
                                      training_iter=6, train_every_n_steps=8,
                                      device="cpu", dtype=F64)
    lrn = sim.learned
    st = lrn.init_state(B, torch.Generator().manual_seed(0), "cpu", F64)
    x = torch.tensor([[7 * math.pi / 12, 0.0]] * B, dtype=F64) \
        + 0.01 * torch.arange(B, dtype=F64)[:, None]
    for t in range(10):
        u = torch.full((B, 1), 1.5 - 0.1 * t, dtype=F64)
        st = lrn.record(st, x, u, generator=torch.Generator().manual_seed(t))
        x, _ = sim.true_dynamics.step(x, u, sim.dt)
    st = lrn.fit_now(st)
    xq = torch.tensor([[1.9, 0.4]] * B, dtype=F64)
    u0 = torch.full((B, 1), 0.5, dtype=F64)
    run = lambda: tcbc.cbc2_gp_terms(sim.cbf, sim.controller.k_alpha,
                                     lrn.f_gp_and_fu_gp, st, xq, u0)
    run()
    calls = collections.Counter()
    real = {name: getattr(tmvgp.MVGP, name) for name in
            ("Bk_single", "fT_post")}
    for name, fn in real.items():
        def counted(self, *a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(self, *a, **k)
        setattr(tmvgp.MVGP, name, counted)
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
    finally:
        for name, fn in real.items():
            setattr(tmvgp.MVGP, name, fn)
    aten = sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::"))
    return dict(reading="counts", B=B, aten_ops=aten, posterior_calls=dict(
        calls))


READINGS = dict(terms=terms, bayes=bayes, bayes_learning=bayes_learning,
                prerefit=prerefit, counts=counts)


def main(argv):
    for name in argv or list(READINGS):
        print(json.dumps(READINGS[name]()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
