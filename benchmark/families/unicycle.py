"""The unicycle Monte-Carlo family: the program's batched Bayes-CBF
rollouts (`parallel.mesh.batched_rollouts` on the one-device mesh) and
their judgement against the plain reference (`reference/unicycle.py`).
"""
from __future__ import annotations

import torch

from benchmark.families.base import FamilyBase
from benchmark.reference import unicycle as ref
from benchmark.reference.common import GPParams

# the keywords of `make_ackermann_tracking_sim` that a configuration
# file sets; every other key is a constant the factory fixes (checked
# against the built sim) or the benchmark's own
FACTORY_KEYS = ("dt", "numSteps", "true_L", "mean_L", "kernel_diag_A",
                "max_risk", "enable_learning", "train_every_n_steps",
                "max_train", "training_iter", "term_weights", "cbf_gammas",
                "Kp", "frac_time_to_reach_goal", "socp_iters", "warm_start",
                "socp_iters_warm", "training_iter_warm",
                "first_fit_coarse_stride", "first_fit_refine_iter")


class Family(FamilyBase):
    metric = "unicycle_steps_per_s"
    n, m = 3, 2
    ref = ref
    judge_block = 8192

    def __init__(self, cfg: dict, traffic: dict, device):
        super().__init__(cfg, traffic, device)
        from bayesian_cbf_tpu_torch.parallel.mesh import make_mesh
        ctl, lrn = self.sim.controller, self.sim.learned_dynamics
        self.check_fixed(dict(
            clf_gamma=ctl.clf_gamma, cost_weights=list(ctl.cost_weights),
            ctrl_ref=list(ctl.ctrl_ref), feas_tol=ctl.feas_tol,
            gp_jitter=lrn.gp.jitter, gamma_prior=list(lrn.gp.gamma_prior),
            rank_A=lrn.gp.rank_A, rank_B=lrn.gp.rank_B,
            shift_invariant=lrn.shift_invariant))
        self.mesh = (make_mesh(1, "cpu") if device.type == "cpu"
                     else (device,))

    def build_sim(self, **override):
        from bayesian_cbf_tpu_torch.experiments.unicycle import (
            make_ackermann_tracking_sim)
        cfg = dict(self.cfg, **override)
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in cfg.items() if k in FACTORY_KEYS}
        sim = make_ackermann_tracking_sim(
            x0=tuple(cfg["x0"]), x_goal=tuple(cfg["x_goal"]), **kw,
            device=self.dev, dtype=self.dtype)
        return sim._replace(
            learned_dynamics=self.gp_options(sim.learned_dynamics))

    def make_inputs(self, seed: int) -> dict:
        """The starts, the learner's initial values and the reservoir
        uniforms, from `seed`, on the device, in a few large calls."""
        g = torch.Generator(device=self.dev).manual_seed(seed)
        kw = dict(dtype=self.dtype, device=self.dev)
        x0s = torch.tensor(self.cfg["x0"], **kw) + self.traffic[
            "start_noise"] * torch.randn((self.B, 3), generator=g, **kw)
        params0 = self.params0(g)
        draws = torch.rand((self.T, self.B), generator=g, **kw)
        return dict(x0s=x0s, params0=params0, draws=draws,
                    state0=self.state0(params0))

    def rollout(self, inputs, sim=None):
        from bayesian_cbf_tpu_torch.parallel.mesh import batched_rollouts
        return batched_rollouts(sim or self.sim, inputs["x0s"],
                                mesh=self.mesh, state0=inputs["state0"],
                                draws=inputs["draws"])

    def roofline_shapes(self) -> dict:
        C = 2 + len(self.cfg["cbf_gammas"])
        return dict(ipm=(self.B, 4, (4,) * C),
                    kinv_logdet=(self.B, self.cfg["max_train"]))

    # -------------------------------------------------------------- judge

    def learner_records(self, out) -> dict:
        """The hyperparameters each refit left (the program's kernel
        channels of the step after it), [(lengthscale, outputscale, A,
        B)] over the refits."""
        k = out.knl
        return dict(fit=[(k.lengthscale[:, t + 1], k.outputscale[:, t + 1],
                          k.A[:, t + 1], k.B[:, t + 1])
                         for t in self.fit_events()])

    def replay(self, inputs, idx, X, U, P):
        return ref.replay(self.cfg, P, inputs["x0s"][idx],
                          GPParams(*(a[idx] for a in inputs["params0"])),
                          inputs["draws"][:, idx], X, U, self.dev)

    def reference_learner(self, inputs, blk, X, U, P) -> dict:
        last = self.fit_events()[-1] + 2 if self.fit_events() else 1
        return dict(fit=ref.refits(
            self.cfg, P, GPParams(*(a[blk] for a in inputs["params0"])),
            inputs["draws"][:, blk], X[:, :last], U[:, :last], self.dev))

    def learner_numbers(self, cand: dict, ref_out: dict) -> dict:
        """fit_gap: the widest relative gap, ||got - want|| / ||want|| per
        leaf (lengthscales, outputscale, A, B), of a refit's
        hyperparameters over every episode and refit."""
        fit_gap = 0.0
        for got_ev, want_ev in zip(cand["fit"], ref_out["fit"]):
            for got, want in zip(got_ev, want_ev):
                w = want.reshape(want.shape[0], -1)
                g = got.double().reshape(w.shape)
                rel = (g - w).norm(dim=-1) / w.norm(dim=-1)
                fit_gap = max(fit_gap, float(torch.nan_to_num(
                    rel, nan=float("inf")).max()))
        return dict(fit_gap=fit_gap)
