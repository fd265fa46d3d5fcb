#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. device   -- refuse to run without CUDA; print the card's name and
                 power limit; TF32 off for matmuls and cuDNN.
  2. build    -- compile the CUDA kernels from csrc/ (one nvcc per source,
                 all at once) and print ptxas's register / shared-memory /
                 spill report.
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 in f32, at the main path's shapes, with CUDA-event times.
  4. main     -- the batched learn-and-control loop (B=256 episodes, K=200,
                 2000 steps, bench.py's configuration), with launch counts
                 and the batched-learning outcome gate.
  5. configs  -- the same loop under three other MVGP configurations:
                 (a) fit_inverse "chol" with linv_assembly "row",
                 (b) fit_inverse "sweep_full", (c) fused_gram; each with
                 launch counts, moved hyperparameters, the outcome gate,
                 and the ms per Adam iteration of its fit.
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
    t0 = time.perf_counter()
    _build.build_all(_build.KERNEL_SOURCES)
    print(f"[build] {', '.join(_build.KERNEL_SOURCES)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
        print(f"[build] {name}:\n{_build.ptxas_report(name)}", flush=True)


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


def _near_duplicate_case(B=4, k=40, seed=0):
    """Consecutive states 1e-3 apart around a common offset, random
    UH chol(B) rows, outputscale 1.3, and the f64 truth by the exact
    difference form (the JAX package's near-duplicate Gram test)."""
    rng = np.random.default_rng(seed)
    X = np.array([2.0, -1.5, 0.7]) + np.cumsum(
        0.001 * rng.normal(size=(B, k, 3)), 1)
    UHB = rng.normal(size=(B, k, 3))
    d = X[:, :, None, :] - X[:, None, :, :]
    truth = (1.3 * np.exp(-0.5 * (d ** 2).sum(-1))
             * (UHB @ UHB.transpose(0, 2, 1)) + 1e-6 * np.eye(k))
    return X, UHB, np.ones((B, k)), np.full(B, 1.3), truth


def _check_gram_kernel(dev):
    from bayesian_cbf_tpu_torch.ops import gram as gm
    rng = np.random.default_rng(3)
    B, K = 256, 200
    mask = np.ones((B, K))
    mask[:, K // 2:] = 0.0
    args = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        np.cumsum(0.02 * rng.normal(size=(B, K, 3)), 1),
        rng.normal(size=(B, K, 3)), mask, rng.uniform(0.5, 2.0, size=B))]
    got = gm.fused_gram_kb(*args, 1e-6)
    want = gm.fused_gram_kb_plain(*args, 1e-6)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    print(f"[gram] (256, 200, n=3, 1+m=3), half the rows masked: max abs err "
          f"vs plain {err:.3e}, relative {rel:.3e}", flush=True)
    _require(rel < 1e-5, f"gram disagrees with plain: {rel}")
    *near, truth = _near_duplicate_case()
    near = [torch.tensor(a, dtype=torch.float32, device=dev) for a in near]
    got = gm.fused_gram_kb(*near, 1e-6).double().cpu().numpy()
    excess = float(np.max(np.abs(got - truth) - 2e-5 * np.abs(truth)))
    print(f"[gram] near-duplicate points vs f64 truth: max |err| - 2e-5|truth|"
          f" = {excess:.3e} (must be < 2e-5)", flush=True)
    _require(excess < 2e-5, "gram loses the near-duplicate distances")
    ms = _cuda_ms(lambda: gm.fused_gram_kb(*args, 1e-6), 50)
    plain_ms = _cuda_ms(lambda: gm.fused_gram_kb_plain(*args, 1e-6), 50)
    print(f"[gram] (256, 200): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _check_sweep_kernel(dev):
    from bayesian_cbf_tpu_torch.ops import sweep_kernels as sk
    f64 = torch.float64
    for B, n in ((256, 200), (256, 50), (4, 1024)):
        K = torch.tensor(_trajectory_grams(B, n, seed=n + 1),
                         dtype=torch.float32, device=dev)
        K64 = K.double()
        eye = torch.eye(n, dtype=f64, device=dev)
        ld64 = torch.linalg.slogdet(K64)[1]
        for name, fn in (("kernel", sk.batched_kinv_logdet),
                         ("plain", sk.batched_kinv_logdet_plain)):
            Kinv, ld = fn(K, sk.full_base(n))
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(Kinv).all() & torch.isfinite(ld).all())
            resid = float((Kinv.double() @ K64 - eye).abs().max())
            lderr = float((ld.double() - ld64).abs().max())
            print(f"[sweep_full {name}] trajectory Grams B={B} n={n}: finite="
                  f"{finite} max|Kinv K - I|={resid:.3e} logdet err="
                  f"{lderr:.3e}", flush=True)
            if name == "kernel":
                _require(finite and lderr < 0.5,
                         f"sweep_full n={n}: finite {finite}, logdet {lderr}")
                _require(n > 200 or resid < 5e-2,
                         f"sweep_full n={n}: resid {resid}")
    S = torch.tensor(_spd(256, 200, 2), dtype=torch.float32, device=dev)
    got = sk.batched_kinv_logdet(S)
    want = sk.batched_kinv_logdet_plain(S)
    exact = torch.linalg.inv(S.double())
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    rel64 = float((got[0].double() - exact).abs().max() / exact.abs().max())
    print(f"[sweep recursive] SPD (256, 200): max abs err vs plain {err:.3e}, "
          f"relative {rel:.3e}; relative to the f64 inverse {rel64:.3e}",
          flush=True)
    _require(rel < 1e-4 and rel64 < 1e-3, "recursive sweep disagrees")
    T = torch.tensor(_trajectory_grams(256, 200, seed=11),
                     dtype=torch.float32, device=dev)
    for name, fn in (("kernel", sk.batched_kinv_logdet),
                     ("plain", sk.batched_kinv_logdet_plain)):
        Kinv, ld = fn(T)
        bad = int((~(torch.isfinite(Kinv).all(-1).all(-1)
                     & torch.isfinite(ld))).sum())
        print(f"[sweep recursive {name}] trajectory Grams (256, 200): {bad} "
              f"of 256 episodes non-finite", flush=True)
    full = sk.full_base(200)
    ms = _cuda_ms(lambda: sk.batched_kinv_logdet(T, full), 20)
    plain_ms = _cuda_ms(lambda: sk.batched_kinv_logdet_plain(T, full), 5)
    rec_ms = _cuda_ms(lambda: sk.batched_kinv_logdet(S), 20)
    rec_plain_ms = _cuda_ms(lambda: sk.batched_kinv_logdet_plain(S), 5)
    print(f"[sweep] (256, 200): sweep_full kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; recursive kernel {rec_ms:.3f} ms, plain "
          f"{rec_plain_ms:.3f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                recursive_ms=rec_ms, recursive_plain_ms=rec_plain_ms)


def _check_chol_dinv_kernel(dev):
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    f64 = torch.float64
    nb = ck.NB_BLK
    for B, n in ((256, 200), (4, 1024)):
        K = torch.tensor(_trajectory_grams(B, n, seed=n + 2),
                         dtype=torch.float32, device=dev)
        for name, fn in (("kernel", ck.chol_dinv),
                         ("plain", ck.chol_dinv_plain)):
            L, Dinv = fn(K, nb)
            torch.cuda.synchronize()
            N = L.shape[-1]
            Kp = torch.eye(N, dtype=f64, device=dev).repeat(B, 1, 1)
            Kp[:, :n, :n] = K.double()
            Ld = L.double()
            finite = bool(torch.isfinite(L).all() & torch.isfinite(Dinv).all())
            r_fac = float((Ld @ Ld.transpose(-1, -2) - Kp).abs().max()
                          / Kp.abs().max())
            eye_nb = torch.eye(nb, dtype=f64, device=dev)
            r_blk = max(float((Dinv[:, o:o + nb].double()
                               @ Ld[:, o:o + nb, o:o + nb] - eye_nb)
                              .abs().max()) for o in range(0, N, nb))
            eye = torch.eye(N, dtype=f64, device=dev)
            r_asm = {a: float((ck.assemble_linv(L, Dinv, nb, a).double() @ Ld
                               - eye).abs().max()) for a in ("row", "col")}
            print(f"[chol_dinv {name}] trajectory Grams B={B} n={n} nb={nb}: "
                  f"finite={finite} max|LL^T-K|/max|K|={r_fac:.3e} "
                  f"max|Dinv_j L_jj - I|={r_blk:.3e} max|Linv L - I| row "
                  f"{r_asm['row']:.3e} col {r_asm['col']:.3e}", flush=True)
            if name == "kernel":
                _require(finite and r_fac < 1e-5 and r_blk < 1e-2,
                         f"chol_dinv n={n}: {r_fac} {r_blk}")
                _require(n > 200 or max(r_asm.values()) < 5e-2,
                         f"chol_dinv n={n}: assembled L^-1 resid {r_asm}")
    S = torch.tensor(_spd(256, 200, 3), dtype=torch.float32, device=dev)
    got, want = ck.chol_dinv(S, nb), ck.chol_dinv_plain(S, nb)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    print(f"[chol_dinv] SPD (256, 200): max abs err vs plain {err:.3e}, "
          f"relative {rel:.3e}", flush=True)
    _require(rel < 1e-4, f"chol_dinv disagrees with plain: {rel}")
    K = torch.tensor(_trajectory_grams(256, 200, seed=7),
                     dtype=torch.float32, device=dev)
    ms = _cuda_ms(lambda: ck.chol_dinv(K, nb), 20)
    plain_ms = _cuda_ms(lambda: ck.chol_dinv_plain(K, nb), 20)
    print(f"[chol_dinv] (256, 200): kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


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


def _counters():
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    from bayesian_cbf_tpu_torch.ops import gram as gm
    from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
    from bayesian_cbf_tpu_torch.ops import sweep_kernels as sk
    return dict(ipm=ik.ipm, kinv_logdet=ck.kinv_logdet,
                chol_linv=ck.chol_linv, chol_dinv=ck.chol_dinv,
                sweep=sk.batched_kinv_logdet, gram=gm.fused_gram_kb)


def _expected_launches(sim):
    """Launches of each kernel that one rollout of `sim` implies: one IPM
    per step plus the step-0 warm start; one fit inverse per Adam
    iteration; three factorizations (the jitter ladder) and, with
    fused_gram, one Gram per cache refresh."""
    lrn, T = sim.learned_dynamics, sim.numSteps
    gp = lrn.gp
    n_fits = len(range(lrn.train_every_n_steps, T, lrn.train_every_n_steps))
    iters = (lrn.training_iter + lrn.first_fit_refine_iter
             + (n_fits - 1) * lrn.training_iter_warm)
    want = dict.fromkeys(_counters(), 0)
    want["ipm"] = T + 1
    chol = "chol_linv" if gp.fit_assembly == "kernel" else "chol_dinv"
    want[dict(cholk="kinv_logdet", chol=chol, sweep="sweep",
              sweep_full="sweep")[gp.fit_inverse]] += iters
    want["chol_linv" if gp.linv_assembly == "kernel" else "chol_dinv"] += \
        3 * n_fits
    want["gram"] += n_fits if gp.fused_gram else 0
    return want


def _fit_buffer(sim, out, K=200):
    """A (B, K) training buffer from the rollout's trajectory: every
    (T // K)-th state (shift-invariant), its control and state change."""
    lrn = sim.learned_dynamics
    K = min(K, sim.numSteps)
    idx = torch.arange(0, sim.numSteps, sim.numSteps // K,
                       device=out.X.device)[:K]
    from bayesian_cbf_tpu_torch.models.mvgp import MVGPData
    U = out.U[:, idx]
    return MVGPData(X=lrn._shift_inv(out.X[:, idx]),
                    UH=torch.cat([torch.ones_like(U[..., :1]), U], -1),
                    Xdot=out.Xdot[:, idx],
                    mask=torch.ones(U.shape[:2], dtype=U.dtype,
                                    device=U.device))


def _adam_ms(gp, data, iters=10):
    """ms per Adam iteration of `gp.fit` on `data` from fresh weights."""
    gen = torch.Generator(device=data.X.device).manual_seed(2)
    params = gp.init_params(data.X.shape[0], gen, data.X.device,
                            data.X.dtype)
    gp.fit(params, data, training_iter=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp.fit(params, data, training_iter=iters)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def run_config(dev, x0s, card, label, **gp_options):
    """One rollout of the flagship batch with the MVGP options; launch
    counts, finiteness, moved hyperparameters and the outcome gate."""
    from bayesian_cbf_tpu_torch.experiments.unicycle import (
        STATE_GOAL, goal_distance, min_obstacle_clearance)
    from bayesian_cbf_tpu_torch.sim.rollout import simulate_unicycle_batch
    sim = _main_sim(dev)
    lrn = sim.learned_dynamics
    sim = sim._replace(learned_dynamics=lrn._replace(
        gp=lrn.gp._replace(**gp_options)))
    B, T = x0s.shape[0], sim.numSteps
    gen = torch.Generator(device=dev).manual_seed(1)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = simulate_unicycle_batch(sim, x0s, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"[{label}] {gp_options or 'default MVGP'}: B={B} K={lrn.max_train} T={T}: "
          f"wall {wall:.3f} s, {B * T / wall:.1f} steps/s on {card}",
          flush=True)
    print(f"[{label}] launches {launches}", flush=True)
    _require(bool(torch.isfinite(out.X).all()), f"{label}: non-finite state")
    want = _expected_launches(sim)
    _require(launches == want, f"{label}: launch counts {launches} != {want}")
    ls = out.knl.lengthscale
    moved = float(((ls[:, -1] - ls[:, 0]).abs().amax(-1) > 1e-4)
                  .float().mean())
    clear = float(min_obstacle_clearance(sim, out).min())
    gd = goal_distance(out, STATE_GOAL)
    mean_gd = float(gd.mean())
    frac = float((gd < 1.0).float().mean())
    feas = float(out.info.feasible.float().mean())
    print(f"[{label}] min clearance {clear:.4f}, mean goal distance "
          f"{mean_gd:.4f}, fraction within 1.0 of goal {frac:.4f}, "
          f"feasible fraction {feas:.4f}, episodes whose lengthscale moved "
          f"{moved:.4f}", flush=True)
    _require(moved > 0.9, f"{label}: the fit did not move the hyperparameters")
    _require(clear > 0 and mean_gd < 1.5 and frac > 0.7,
             f"{label}: batched-learning outcome gate failed")
    return launches, out


def phase_fit_timing(dev, out, configs):
    """ms per Adam iteration of each configuration's fit on one (256, 200)
    buffer cut from the flagship trajectories, timed in turns (forward
    order, then reversed) so that clock drift hits every configuration
    alike."""
    sim = _main_sim(dev)
    data = _fit_buffer(sim, out)
    gp = sim.learned_dynamics.gp
    gps = {label: gp._replace(**opts) for label, opts in configs.items()}
    times = {label: [] for label in gps}
    for label in list(gps) + list(reversed(gps)):
        times[label].append(_adam_ms(gps[label], data))
    ms = {label: sum(t) / len(t) for label, t in times.items()}
    B, K = data.mask.shape
    for label, t in times.items():
        print(f"[fit] {label} {configs[label] or 'default MVGP'}: "
              f"{ms[label]:.3f} ms per Adam iteration at (B, K) = ({B}, {K})"
              f" (turns: {', '.join(f'{x:.3f}' for x in t)})", flush=True)
    return ms


def main():
    dev, card = phase_device()
    phase_build()
    x0s = _x0s(dev)
    chol = _check_chol_kernels(dev)
    ipm = _check_ipm_kernel(dev, x0s)
    gram = _check_gram_kernel(dev)
    sweep = _check_sweep_kernel(dev)
    dinv = _check_chol_dinv_kernel(dev)
    main_path, out = run_config(dev, x0s, card, "main")
    configs = dict(main={}, a=dict(fit_inverse="chol", linv_assembly="row"),
                   b=dict(fit_inverse="sweep_full"), c=dict(fused_gram=True))
    runs = {k: run_config(dev, x0s, card, f"config {k}", **configs[k])[0]
            for k in "abc"}
    phase_fit_timing(dev, out, configs)

    def entry(name, source, replaces, run, stats):
        per_run = {"main": main_path[name]}
        per_run.update({k: v[name] for k, v in runs.items()})
        return dict(name=name, route="cuda",
                    source=f"bayesian_cbf_tpu_torch/csrc/{source}",
                    replaces=f"bayesian_cbf_tpu/ops/{replaces}",
                    launches=per_run[run], launches_per_run=per_run, **stats)

    kernels = [
        entry("kinv_logdet", "chol.cu", "pallas_chol.py:202", "main",
              chol["kinv_logdet"]),
        entry("chol_linv", "chol.cu", "pallas_chol.py:191", "main",
              chol["chol_linv"]),
        entry("ipm", "ipm.cu", "pallas_ipm.py:48", "main", ipm),
        entry("chol_dinv", "chol_blocked.cu", "pallas_chol.py:105", "a", dinv),
        entry("sweep", "sweep.cu", "pallas_sweep.py:203", "b", sweep),
        entry("gram", "gram.cu", "gram.py:54", "c", gram),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
