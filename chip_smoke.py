#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. device   -- refuse to run without CUDA; print the card's name and
                 power limit; TF32 off for matmuls and cuDNN.
  2. build    -- compile the CUDA kernels from csrc/ and print ptxas's
                 register / shared-memory / spill report.
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 in f32, at the main path's shapes, with CUDA-event times.
  4. main     -- the batched learn-and-control loop (B=256 episodes, K=200,
                 2000 steps, bench.py's configuration), with launch counts
                 and the batched-learning outcome gate.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def _cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _trajectory_grams(B, k, seed, step=0.02, nug=2.5e-4):
    """Random-walk RBF Grams: the conditioning of real fit buffers."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(step * rng.normal(size=(B, k, 3)), 1)
    d = X[:, :, None, :] - X[:, None, :, :]
    return np.exp(-0.5 * np.sum(d * d, -1)) + nug * np.eye(k)


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    return A @ A.transpose(0, 2, 1) / n + np.eye(n)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke run "
                         "needs an NVIDIA card and never runs on the CPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return torch.device("cuda"), card


def phase_build():
    from bayesian_cbf_tpu_torch.ops import _build
    for name in ("chol", "ipm"):
        t0 = time.perf_counter()
        _build.load(name)
        print(f"[build] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        print(_build.ptxas_report(name), flush=True)


def _check_chol_kernels(dev):
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    out = {}
    f64 = torch.float64
    for n, B in ((200, 256), (50, 256), (1024, 4)):
        K = torch.tensor(_trajectory_grams(B, n, seed=n), dtype=torch.float32,
                         device=dev)
        K64 = K.double()
        eye = torch.eye(n, dtype=f64, device=dev)
        ld64 = torch.linalg.slogdet(K64)[1]
        bar = 0.1 if n == 1024 else 5e-2
        for name, fn in (("kernel", ck.kinv_logdet),
                         ("plain", ck.kinv_logdet_plain)):
            Kinv, ld = fn(K)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(Kinv).all() & torch.isfinite(ld).all())
            resid = float((Kinv.double() @ K64 - eye).abs().max())
            lderr = float((ld.double() - ld64).abs().max())
            print(f"[kinv_logdet {name}] B={B} n={n} finite={finite} "
                  f"max|Kinv K - I|={resid:.3e} logdet err={lderr:.3e}",
                  flush=True)
            if name == "kernel" or n < 1024:
                _require(finite and resid < bar,
                         f"kinv_logdet {name} n={n} resid {resid}")
                _require(n == 1024 or lderr < 0.5,
                         f"kinv_logdet {name} n={n} logdet err {lderr}")
        for name, fn in (("kernel", ck.chol_linv),
                         ("plain", ck.chol_linv_plain)):
            L, Linv = fn(K)
            torch.cuda.synchronize()
            Ld = L.double()
            finite = bool(torch.isfinite(L).all() & torch.isfinite(Linv).all())
            r_inv = float((Linv.double() @ Ld - eye).abs().max())
            r_fac = float((Ld @ Ld.transpose(-1, -2) - K64).abs().max()
                          / K64.abs().max())
            print(f"[chol_linv {name}] B={B} n={n} finite={finite} "
                  f"max|Linv L - I|={r_inv:.3e} max|LL^T-K|/max|K|="
                  f"{r_fac:.3e}", flush=True)
            if name == "kernel" or n < 1024:
                _require(finite and r_inv < bar and r_fac < 1e-5,
                         f"chol_linv {name} n={n} resid {r_inv} {r_fac}")
    # elementwise agreement on well-conditioned SPD at the main-path shape
    S = torch.tensor(_spd(256, 200, 1), dtype=torch.float32, device=dev)
    for key, fn, plain in (("kinv_logdet", ck.kinv_logdet,
                            ck.kinv_logdet_plain),
                           ("chol_linv", ck.chol_linv, ck.chol_linv_plain)):
        got, want = fn(S), plain(S)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        rel = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        print(f"[{key}] SPD (256, 200): max abs err vs plain {err:.3e}, "
              f"relative {rel:.3e}", flush=True)
        _require(rel < 1e-4, f"{key} disagrees with plain: {rel}")
        K = torch.tensor(_trajectory_grams(256, 200, seed=7),
                         dtype=torch.float32, device=dev)
        ms = _cuda_ms(lambda: fn(K), 20)
        plain_ms = _cuda_ms(lambda: plain(K), 20)
        print(f"[{key}] (256, 200): kernel {ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms", flush=True)
        out[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return out


def _random_cones(B, seed, nx=4, dims=(4, 4, 4, 1)):
    rng = np.random.default_rng(seed)
    C, d = len(dims), max(dims)
    c = rng.normal(size=(B, nx))
    G = np.zeros((B, C, d, nx))
    h = np.zeros((B, C, d))
    for ci, dd in enumerate(dims):
        A = rng.normal(size=(B, dd - 1, nx)) * 0.5
        G[:, ci, 0] = -rng.normal(size=(B, nx)) * 0.2
        G[:, ci, 1:dd] = -A
        h[:, ci, 0] = 1.5 + rng.uniform(size=B)
        h[:, ci, 1:dd] = rng.normal(size=(B, dd - 1)) * 0.1
    return c, G, h


def _step0_cones(dev, x0s, seed):
    """The main path's real step-0 SOCPs (prior model, fresh weights)."""
    from bayesian_cbf_tpu_torch.control.bayes_controller import controller_socp
    from bayesian_cbf_tpu_torch.solvers.socp import _pad_cones
    sim = _main_sim(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = sim.learned_dynamics.init_state(x0s.shape[0], gen, dev,
                                            torch.float32)
    mom = sim.learned_dynamics.moments(state, x0s)
    cobj, G, h, dims, _ = controller_socp(sim.controller, sim.clf, sim.cbfs,
                                          sim.planner, mom, x0s, 0)
    Gp, hp = _pad_cones(G, h, dims)
    return cobj.expand(x0s.shape[0], -1).contiguous(), Gp, hp


def _check_ipm_kernel(dev, x0s):
    from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
    from bayesian_cbf_tpu_torch.solvers.socp import _interior_shift
    B = 256
    f32 = torch.float32
    rand = [torch.tensor(a, dtype=f32, device=dev) for a in _random_cones(B, 0)]
    real = list(_step0_cones(dev, x0s, 1))
    C, d, nx = 4, 4, 4
    e = torch.zeros((B, C, d), dtype=f32, device=dev)
    e[..., 0] = 1.0
    cold = [torch.zeros((B, nx), dtype=f32, device=dev), e, e]
    worst_err = 0.0
    for label, prob in (("random", rand), ("step-0", real)):
        for iters in (25, 15):
            if iters == 25:
                start = cold
            else:
                # a warm start: the cold solution of the problem, shifted
                # into the interior, applied to data moved by 1e-3
                x, S, Z = ik.ipm_plain(*prob, *cold, 25, 1e-10)
                start = [x, _interior_shift(S), _interior_shift(Z)]
                prob = [prob[0], prob[1], prob[2] + 1e-3 * e]
            got = ik.ipm(*prob, *start, iters, 1e-10)
            want = ik.ipm_plain(*prob, *start, iters, 1e-10)
            exact = ik.ipm_plain(*(a.double() for a in prob + start), iters,
                                 1e-10)
            torch.cuda.synchronize()
            sg = ik.score_padded(*prob, *got)
            sw = ik.score_padded(*prob, *want)
            both = (sg < 1e-3) & (sw < 1e-3)
            rel = lambda a, b: (a - b).abs() / (1.0 + b.abs())
            rel_x = float(rel(got[0], want[0]).amax(-1)[both].max())
            cost = lambda x: (prob[0] * x).sum(-1)
            rel_c = float(rel(cost(got[0]), cost(want[0]))[both].max())
            # f32 against the f64 solve of the same problems (converged
            # there): the kernel must be no farther from it than the f32
            # plain version is
            conv = ik.score_padded(*(a.double() for a in prob),
                                   *exact) < 1e-6
            err_k = float(rel(got[0].double(), exact[0]).amax(-1)[conv].max())
            err_p = float(rel(want[0].double(), exact[0]).amax(-1)[conv]
                          .max())
            print(f"[ipm {label} iters={iters}] median KKT score kernel "
                  f"{float(sg.median()):.3e} plain {float(sw.median()):.3e}; "
                  f"{int(both.sum())}/{B} both < 1e-3: max rel |dx| "
                  f"{rel_x:.3e}, max rel |d cost| {rel_c:.3e}; vs f64 on "
                  f"{int(conv.sum())} converged: kernel {err_k:.3e}, plain "
                  f"f32 {err_p:.3e}", flush=True)
            _require(float(sg.median()) <= 2.0 * float(sw.median()),
                     f"ipm {label} {iters}: kernel score above 2x plain")
            _require(int(both.sum()) >= B // 2,
                     f"ipm {label} {iters}: too few converged problems")
            _require(rel_c < 1e-3, f"ipm {label} {iters}: optimal value "
                     f"disagrees ({rel_c})")
            # the controller's SOCPs have a unique optimum; random ones may
            # have an optimal face, where only the value is determined
            if label == "step-0":
                _require(err_k <= max(2.0 * err_p, 1e-3),
                         f"ipm {label} {iters}: x farther from f64 than "
                         f"plain f32 ({err_k} vs {err_p})")
                worst_err = max(worst_err, float(
                    (got[0] - want[0]).abs()[both].max()))
    ms = _cuda_ms(lambda: ik.ipm(*real, *cold, 25, 1e-10), 50)
    plain_ms = _cuda_ms(lambda: ik.ipm_plain(*real, *cold, 25, 1e-10), 5)
    print(f"[ipm] B=256, 25 iterations: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms", flush=True)
    return dict(max_abs_err=worst_err, ms=ms, plain_ms=plain_ms)


def _main_sim(dev):
    from bayesian_cbf_tpu_torch.experiments.unicycle import (
        make_ackermann_tracking_sim)
    # bench.py's configuration (bench.py:70-77) with its defaults
    return make_ackermann_tracking_sim(
        dt=0.001, numSteps=2000, true_L=1.0, mean_L=12.0,
        kernel_diag_A=(1.0, 1.0, 1.0), max_risk=0.01,
        enable_learning=True, train_every_n_steps=400,
        max_train=200, training_iter=100,
        socp_iters=25, warm_start=True, socp_iters_warm=15,
        training_iter_warm=10,
        first_fit_coarse_stride=4, first_fit_refine_iter=15,
        device=dev, dtype=torch.float32)


def _x0s(dev, B=256):
    from bayesian_cbf_tpu_torch.experiments.unicycle import STATE_START
    rng = np.random.default_rng(0)
    x0 = np.asarray(STATE_START)[None] + 0.01 * rng.normal(size=(B, 3))
    return torch.tensor(x0, dtype=torch.float32, device=dev)


def phase_main(dev, x0s, card):
    from bayesian_cbf_tpu_torch.experiments.unicycle import (
        STATE_GOAL, goal_distance, min_obstacle_clearance)
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
    from bayesian_cbf_tpu_torch.sim.rollout import simulate_unicycle_batch
    sim = _main_sim(dev)
    B, T = x0s.shape[0], sim.numSteps
    gen = torch.Generator(device=dev).manual_seed(1)
    ck.chol_linv.launches = ck.kinv_logdet.launches = ik.ipm.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = simulate_unicycle_batch(sim, x0s, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ipm=ik.ipm.launches, kinv_logdet=ck.kinv_logdet.launches,
                    chol_linv=ck.chol_linv.launches)
    print(f"[main] B={B} K=200 T={T}: wall {wall:.3f} s, "
          f"{B * T / wall:.1f} steps/s on {card}", flush=True)
    print(f"[main] launches {launches}", flush=True)
    _require(bool(torch.isfinite(out.X).all()), "non-finite state")
    lrn = sim.learned_dynamics
    n_fits = len(range(lrn.train_every_n_steps, T, lrn.train_every_n_steps))
    want = dict(ipm=T + 1,
                kinv_logdet=(lrn.training_iter + lrn.first_fit_refine_iter
                             + (n_fits - 1) * lrn.training_iter_warm),
                chol_linv=3 * n_fits)
    _require(launches == want, f"launch counts {launches} != {want}")
    clear = float(min_obstacle_clearance(sim, out).min())
    gd = goal_distance(out, STATE_GOAL)
    mean_gd = float(gd.mean())
    frac = float((gd < 1.0).float().mean())
    feas = float(out.info.feasible.float().mean())
    print(f"[main] min clearance {clear:.4f}, mean goal distance "
          f"{mean_gd:.4f}, fraction within 1.0 of goal {frac:.4f}, "
          f"feasible fraction {feas:.4f}", flush=True)
    _require(clear > 0 and mean_gd < 1.5 and frac > 0.7,
             "batched-learning outcome gate failed")
    return launches


def main():
    dev, card = phase_device()
    phase_build()
    x0s = _x0s(dev)
    chol = _check_chol_kernels(dev)
    ipm = _check_ipm_kernel(dev, x0s)
    launches = phase_main(dev, x0s, card)
    kernels = [
        dict(name="kinv_logdet", route="cuda",
             source="bayesian_cbf_tpu_torch/csrc/chol.cu",
             replaces="bayesian_cbf_tpu/ops/pallas_chol.py:202",
             launches=launches["kinv_logdet"], **chol["kinv_logdet"]),
        dict(name="chol_linv", route="cuda",
             source="bayesian_cbf_tpu_torch/csrc/chol.cu",
             replaces="bayesian_cbf_tpu/ops/pallas_chol.py:191",
             launches=launches["chol_linv"], **chol["chol_linv"]),
        dict(name="ipm", route="cuda",
             source="bayesian_cbf_tpu_torch/csrc/ipm.cu",
             replaces="bayesian_cbf_tpu/ops/pallas_ipm.py:48",
             launches=launches["ipm"], **ipm),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
