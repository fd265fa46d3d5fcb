"""What the families share: the learner's initial values and the
program's learner state holding them, the warm-up, the records the
judge reads and the compared numbers."""
from __future__ import annotations

import math

import torch

from benchmark.reference.common import GPParams, Precision, inv_softplus


class FamilyBase:
    """A family drives one of the program's batch entries.  Subclasses set
    `metric`, `n`, `m` and `ref` (the reference module) and implement
    `build_sim`, `make_inputs`, `rollout`, `replay`, and the learner's
    records, reference and numbers (`learner_records`,
    `reference_learner`, `learner_numbers`)."""
    metric = ""
    n = m = 0

    def __init__(self, cfg: dict, traffic: dict, device):
        self.cfg, self.traffic, self.dev = cfg, traffic, device
        self.dtype = getattr(torch, cfg["dtype"])
        self.B, self.T = traffic["batch"], cfg["numSteps"]
        self.sim = self.build_sim()

    def check_fixed(self, got: dict):
        """The constants the program's factory fixes are the
        configuration's."""
        for k, v in got.items():
            if self.cfg[k] != v:
                raise ValueError(f"configuration {self.cfg['name']}: {k} is "
                                 f"{self.cfg[k]!r}, the program builds {v!r}")

    def gp_options(self, learned):
        """The learner with the configuration's MVGP options (the fit
        inverse's route and the like) set."""
        return learned._replace(gp=learned.gp._replace(
            **self.cfg.get("gp_options", {})))

    # ------------------------------------------------------------ inputs

    def params0(self, g) -> GPParams:
        """The learner's initial values: lengthscales, outputscale and the
        task covariances' diagonals at softplus^-1(init_softplus), the
        task factors init_weight_scale N(0, 1), the prior mean zero."""
        B, n, mh, c = self.B, self.n, self.m + 1, self.cfg
        ra, rb = c["rank_A"], c["rank_B"]
        kw = dict(dtype=self.dtype, device=self.dev)
        W = c["init_weight_scale"] * torch.randn((B, n * ra + mh * rb),
                                                 generator=g, **kw)
        r1 = inv_softplus(c["init_softplus"])
        full = lambda *s: torch.full((B,) + s, r1, **kw)
        return GPParams(
            raw_ls=full(n), raw_os=full(),
            W_A=W[:, :n * ra].reshape(B, n, ra).contiguous(), raw_vA=full(n),
            W_B=W[:, n * ra:].reshape(B, mh, rb).contiguous(),
            raw_vB=full(mh), mean_M=torch.zeros((B, mh, n), **kw))

    def state0(self, p: GPParams):
        """The program's learner state holding the initial values, with an
        empty training set."""
        from bayesian_cbf_tpu_torch.models.dynamics import LearnedDynState
        from bayesian_cbf_tpu_torch.models.mvgp import (MVGPCache,
                                                        MVGPData, MVGPParams)
        B, K, n, mh = self.B, self.cfg["max_train"], self.n, self.m + 1
        kw = dict(dtype=self.dtype, device=self.dev)
        data = MVGPData(X=torch.zeros((B, K, n), **kw),
                        UH=torch.zeros((B, K, mh), **kw),
                        Xdot=torch.zeros((B, K, n), **kw),
                        mask=torch.zeros((B, K), **kw))
        eye = torch.eye(K, **kw).expand(B, K, K)
        cache = MVGPCache(L=eye.clone(), alpha=torch.zeros((B, K, n), **kw),
                          Linv=eye.clone())
        zi = torch.zeros((B,), dtype=torch.int32, device=self.dev)
        return LearnedDynState(
            params=MVGPParams(*p), buf=data, data=data, cache=cache,
            prev_x=torch.zeros((B, n), **kw),
            prev_u=torch.zeros((B, self.m), **kw),
            have_prev=torch.zeros((B,), dtype=torch.bool, device=self.dev),
            count_pairs=zi, count_res=zi.clone())

    # ---------------------------------------------------------- the path

    def build_sim(self, **override):
        """The program's sim of the configuration, with keys of the
        configuration overridden."""
        raise NotImplementedError

    def warmup(self, inputs):
        """One rollout of the cell's own inputs through the program's
        entry, its refits cut to `warm_iters` Adam iterations each: every
        kernel and shape of the window, and the allocator grown to a whole
        rollout's records, so the window's first rollout runs as the
        rest, at a fraction of a rollout's fit time."""
        sim = self.build_sim(training_iter=self.cfg["warm_iters"])
        out = self.rollout(inputs, sim)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        del out

    def steps_per_rollout(self) -> int:
        return self.B * self.T

    def fit_events(self) -> list:
        return self.ref.fit_steps(self.cfg)

    def adam_iterations(self) -> int:
        return len(self.fit_events()) * self.cfg["training_iter"]

    # ------------------------------------------------------------ records

    @staticmethod
    def fingerprint(out):
        X, U = out.X.double(), out.U.double()
        return torch.stack([X.sum(), U.sum(), (X * X).sum()])

    @staticmethod
    def nonfinite(out):
        bad = ~(torch.isfinite(out.X).flatten(1).all(-1)
                & torch.isfinite(out.U).flatten(1).all(-1))
        return bad.sum()

    def keep(self, out, idx):
        """The records of episodes idx whose steps the reference replays."""
        return dict(idx=idx, X=out.X[idx], U=out.U[idx])

    def keep_all(self, out) -> dict:
        """What the reference reads of every episode: the recorded states
        and controls, and the learner's products (`learner_records`)."""
        return dict(X=out.X, U=out.U, **self.learner_records(out))

    @staticmethod
    def gather(kept: list) -> dict:
        return dict(idx=torch.cat([k["idx"] for k in kept]),
                    X=torch.cat([k["X"] for k in kept]),
                    U=torch.cat([k["U"] for k in kept]))

    # -------------------------------------------------------------- judge

    judge_block = 4096   # episodes the reference reads at a time

    def reference(self, inputs, rec: dict, full: dict, prec: str) -> dict:
        """The reference in precision `prec`: the controls of the replayed
        sample `rec` (us), and for every episode of `full` the true next
        state of each recorded (x, u) (x_next) and the learner's products
        (`reference_learner`), in blocks of `judge_block` episodes."""
        P = Precision(prec, self.dtype)
        us = self.replay(inputs, rec["idx"], rec["X"], rec["U"], P)
        parts = []
        for lo in range(0, self.B, self.judge_block):
            blk = slice(lo, min(lo + self.judge_block, self.B))
            X, U = full["X"][blk], full["U"][blk]
            parts.append(dict(
                x_next=self.ref.true_next(self.cfg, P, X, U, self.dev),
                **self.reference_learner(inputs, blk, X, U, P)))
        out = {k: _cat([p[k] for p in parts]) for k in parts[0]}
        return dict(out, us=us)

    def candidate(self, full: dict) -> dict:
        """The program's records in the reference's layout."""
        return dict(x0=full["X"][:, 0], x_next=full["X"][:, 1:],
                    **{k: v for k, v in full.items() if k not in ("X", "U")})

    def state_gap(self, a, b):
        """|a - b| per state coordinate (angles wrapped where the family
        wraps them)."""
        return (a - b).abs()

    def numbers(self, x0s, cand: dict, U, ref: dict) -> dict:
        """The compared numbers of a candidate (the program's records, or
        the control's) against the f64 reference's:

        start_gap: the widest gap of an episode's first recorded state
            from the start the benchmark handed over (exact);
        step_gap: the widest gap of a recorded next state from the true
            dynamics' step of the recorded state and control, relative to
            max(1, |x|), over every episode;
        u_gap_p50: the median over the replayed sample's episode-steps of
            the control's gap, max |u - u_ref| / max(1, max |u_ref|);
        u_off_share: the share of the sample's episode-steps whose
            control's gap is over 0.05;
        and the learner's numbers of every episode (`learner_numbers`)."""
        us = ref["us"]
        U = U.double()
        gap = ((U - us).abs().amax(-1)
               / torch.clamp(us.abs().amax(-1), min=1.0)).flatten()
        gap = torch.nan_to_num(gap, nan=math.inf)
        xn, got = ref["x_next"], cand["x_next"].double()
        xs = (self.state_gap(got, xn).amax(-1)
              / torch.clamp(xn.abs().amax(-1), min=1.0))
        q = torch.quantile(gap, torch.tensor([0.5, 0.99], dtype=gap.dtype,
                                             device=gap.device))
        out = dict(
            start_gap=float(self.state_gap(cand["x0"].double(),
                                           x0s.double()).max()),
            step_gap=float(torch.nan_to_num(xs, nan=math.inf).max()),
            u_gap_p50=float(q[0]), u_gap_p99=float(q[1]),
            u_gap_max=float(gap.max()),
            u_off_share=float((gap > 0.05).double().mean()))
        out.update(self.learner_numbers(cand, ref))
        return out


def _cat(parts):
    """Concatenate blocks along the episode axis: tensors, or lists /
    tuples of them."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return type(parts[0])(_cat(list(z)) for z in zip(*parts))


def rel_gap(got, want):
    """|got - want| / max(1, |want|), NaN read as infinite."""
    g = (got.double() - want).abs() / torch.clamp(want.abs(), min=1.0)
    return torch.nan_to_num(g, nan=math.inf)
