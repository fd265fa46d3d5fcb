"""The pendulum family: the program's batched online-learning episodes
(`experiments.pendulum.run_pendulum_online_batch`) and their judgement
against the plain reference (`reference/pendulum.py`)."""
from __future__ import annotations

import math

import torch

from benchmark.families.base import FamilyBase, rel_gap
from benchmark.reference import pendulum as ref
from benchmark.reference.common import GPParams

# the keywords of `make_pendulum_online_sim` that a configuration file
# sets
FACTORY_KEYS = ("numSteps", "dt", "max_train", "training_iter",
                "train_every_n_steps", "max_unsafe_prob", "k_alpha",
                "ctrl_range", "egreedy_scheme", "socp_iters",
                "training_iter_warm", "continuous_updates",
                "first_fit_coarse_stride", "first_fit_refine_iter")


class Family(FamilyBase):
    metric = "pendulum_steps_per_s"
    n, m = 2, 1
    ref = ref
    judge_block = 1024

    def __init__(self, cfg: dict, traffic: dict, device):
        super().__init__(cfg, traffic, device)
        ctl, lrn, lqr = self.sim.controller, self.sim.learned, self.sim.lqr
        pend, cbf = self.sim.true_dynamics, self.sim.cbf
        self.check_fixed(dict(
            ctrl_reg=ctl.ctrl_reg, clf_relax_weight=ctl.clf_relax_weight,
            cbc_relax_weight=ctl.cbc_relax_weight, cbc_relax=ctl.cbc_relax,
            closed_form=ctl.closed_form, feas_tol=1e-4,
            gp_jitter=lrn.gp.jitter, gamma_prior=list(lrn.gp.gamma_prior),
            rank_A=lrn.gp.rank_A, rank_B=lrn.gp.rank_B,
            shift_invariant=lrn.shift_invariant,
            lqr=dict(Q=[list(r) for r in lqr.Q], R=[list(r) for r in lqr.R],
                     x_goal=list(lqr.x_goal), horizon=lqr.horizon),
            pendulum=dict(mass=pend.mass, gravity=pend.gravity,
                          length=pend.length),
            cbf=dict(delta=cbf.cbf_col_delta, theta=cbf.cbf_col_theta)))

    def build_sim(self, **override):
        from bayesian_cbf_tpu_torch.experiments.pendulum import (
            make_pendulum_online_sim)
        cfg = dict(self.cfg, **override)
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in cfg.items() if k in FACTORY_KEYS}
        sim = make_pendulum_online_sim(**kw, device=self.dev,
                                       dtype=self.dtype)
        return sim._replace(learned=self.gp_options(sim.learned))

    def make_inputs(self, seed: int) -> dict:
        """The starts, the learner's initial values, the reservoir
        uniforms and the exploration uniforms, from `seed`, on the
        device, in a few large calls."""
        g = torch.Generator(device=self.dev).manual_seed(seed)
        kw = dict(dtype=self.dtype, device=self.dev)
        x0s = torch.tensor(self.cfg["x0"], **kw) + self.traffic[
            "start_noise"] * torch.randn((self.B, 2), generator=g, **kw)
        params0 = self.params0(g)
        u = torch.rand((self.T, self.B, 2), generator=g, **kw)
        return dict(x0s=x0s, params0=params0, draws=u[..., 0].contiguous(),
                    noise=u[..., 1:].contiguous(),
                    state0=self.state0(params0))

    def rollout(self, inputs, sim=None):
        from bayesian_cbf_tpu_torch.experiments.pendulum import (
            run_pendulum_online_batch)
        return run_pendulum_online_batch(
            sim or self.sim, inputs["x0s"], state0=inputs["state0"],
            draws=inputs["draws"], noise=inputs["noise"])

    def roofline_shapes(self) -> dict:
        return dict(ipm=(self.B, 4, (3, 3, 1)),
                    kinv_logdet=(self.B, self.cfg["max_train"]))

    def state_gap(self, a, b):
        d = (a - b).abs()
        th = torch.remainder(d[..., :1], 2 * math.pi)
        return torch.cat([torch.minimum(th, 2 * math.pi - th), d[..., 1:]],
                         -1)

    # -------------------------------------------------------------- judge

    def learner_records(self, out) -> dict:
        """The chance constraint's mean and variance that the program
        reports at each step (`info.cbc_mean`, `info.cbc_var`, at u =
        report_u) over the steps that read the first refit's posterior."""
        t0, t1 = ref.first_fit_window(self.cfg)
        return dict(post=(out.info.cbc_mean[:, t0:t1 + 1, 0],
                          out.info.cbc_var[:, t0:t1 + 1, 0]))

    def replay(self, inputs, idx, X, U, P):
        return ref.replay(self.cfg, P, inputs["x0s"][idx],
                          GPParams(*(a[idx] for a in inputs["params0"])),
                          inputs["draws"][:, idx], inputs["noise"][:, idx],
                          X, U, self.dev)

    def reference_learner(self, inputs, blk, X, U, P) -> dict:
        last = ref.first_fit_window(self.cfg)[1] + 1
        return dict(post=ref.first_fit_moments(
            self.cfg, P, GPParams(*(a[blk] for a in inputs["params0"])),
            inputs["draws"][:, blk], X[:, :last], U[:, :last], self.dev))

    def learner_numbers(self, cand: dict, ref_out: dict) -> dict:
        """post_gap: over every episode, the median over the steps that
        read the first refit's posterior of the chance constraint's
        moments' gap, the larger of the mean's and the variance's, each
        relative to max(1, |reference|); the widest over the episodes."""
        (m, v), (mr, vr) = cand["post"], ref_out["post"]
        gap = torch.maximum(rel_gap(m, mr), rel_gap(v, vr))
        return dict(post_gap=float(gap.median(-1).values.max()))
