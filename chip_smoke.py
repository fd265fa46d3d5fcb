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
                 in f32, at the main path's shapes, with CUDA-event times
                 of the kernel, the plain version and (where one PyTorch
                 call computes the same function) that call, and the
                 kernel's bound from its bytes and operations.  The IPM
                 runs at both instantiations: (4, 4, 4) on the unicycle's
                 cones and (4, 3, 3) on the pendulum's.
  4. main     -- the batched unicycle learn-and-control loop (B=256
                 episodes, K=200, 2000 steps, bench.py's configuration),
                 with launch counts and the batched-learning outcome gate.
  5. configs  -- the same loop under three other MVGP configurations:
                 (a) fit_inverse "chol" with linv_assembly "row",
                 (b) fit_inverse "sweep_full", (c) fused_gram; each with
                 launch counts, moved hyperparameters, the outcome gate,
                 and the ms per Adam iteration of its fit.
  6. pendulum -- the batched pendulum online-learning loop (B=256, K=200,
                 250 steps, dt 2e-3, bench.py's two configurations:
                 continuous rank-1 updates with sparse refits, and the
                 reference schedule), with launch counts, the outcome
                 gates of scripts/check_outcomes.py, and ms and device
                 operations per step.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch


# one H100 SXM (NVIDIA's data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def _bound(flops, nbytes):
    """The least time the card could take for work of `flops` f32
    operations that must move `nbytes` (each input read once, each output
    written once): the larger of the two times, and which one it is."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _tri(n):
    """Entries of a triangle of order n, its diagonal included."""
    return n * (n + 1) / 2


def _block_rows(n, nb):
    """Rows below order n in each nb-row block of the padded order."""
    return [min(nb, n - o) for o in range(0, n, nb)]


# Work counts of the factor kernels, as the function needs it at the
# unpadded order n (flops, a multiply-add counting two): a Cholesky factor
# n^3/3, a triangular inverse n^3/3, the symmetric product Linv^T Linv
# n^3/3, two triangular solves of r right-hand sides 2 n^2 r, the inverses
# of the diagonal blocks m^3/3 each.  A symmetric input is read as its
# lower triangle; a dense output is written whole.

def _dinv_flops(n, nb):
    return sum(m ** 3 / 3 for m in _block_rows(n, nb))


def _kinv_logdet_bound(B, n):
    """K^{-1} and logdet through a Cholesky: factor, triangular inverse,
    Linv^T Linv; reads K's lower triangle, writes K^{-1} and the logdet."""
    return _bound(B * n ** 3, F32 * B * (_tri(n) + n * n + 1))


def _chol_linv_bound(B, n):
    """L and L^{-1}: factor and triangular inverse."""
    return _bound(B * (2 / 3) * n ** 3, F32 * B * (_tri(n) + 2 * n * n))


def _chol_dinv_bound(B, n, N, nb):
    """L at the padded order N and the diagonal-block inverses Dinv."""
    return _bound(B * (n ** 3 / 3 + _dinv_flops(n, nb)),
                  F32 * B * (_tri(n) + N * N + N * nb))


def _cholsolve_bound(B, n, r, N, nb):
    """Kernel 6: kernel 8's factor, two triangular solves and the logdet;
    writes the solution, L, Dinv and the logdet."""
    return _bound(B * (n ** 3 / 3 + _dinv_flops(n, nb) + 2 * n * n * r),
                  F32 * B * (_tri(n) + 2 * n * r + N * N + N * nb + 1))


def _solve_with_factor_bound(B, n, r, nb):
    """Kernel 7: two triangular solves against a saved factor; reads only
    the strictly-lower block panels of L and the lower triangles of the
    diagonal-block inverses, in the rows below n."""
    rows = _block_rows(n, nb)
    panels = sum(m * i * nb for i, m in enumerate(rows))
    dinv = sum(_tri(m) for m in rows)
    return _bound(B * 2 * n * n * r, F32 * B * (panels + dinv + 2 * n * r))


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
        B, n = 256, 200
        if key == "kinv_logdet":
            bound = _kinv_logdet_bound(B, n)
            # K^{-1} only: no single call also returns the logdet
            library_ms = _cuda_ms(lambda: torch.linalg.inv_ex(K), 20)
        else:
            bound = _chol_linv_bound(B, n)
            library_ms = None
        print(f"[{key}] (256, 200): kernel {ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms, library {library_ms} ms, bound {bound['bound_ms']:.4f} "
              f"ms ({bound['bound_by']})", flush=True)
        out[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, **bound)
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


def _ipm_flops(B, nx, C, d, iters):
    """f32 operations of `iters` IPM iterations on B problems, counted
    from the loops of csrc/ipm.cu (a multiply-add counts two): the
    residuals, the normal matrix G^T W^-2 G and its factor, two KKT
    solves, the cone algebra (scaling, step lengths, corrector)."""
    per_iter = (10 * C * d * nx + 2.5 * C * d * nx * (nx + 1)
                + (2 / 3) * nx ** 3 + 4 * nx * nx + 120 * C * d + 100 * C)
    return B * (iters * per_iter + 4 * C * d * nx)


def _check_ipm_kernel(dev, label, rand, real):
    """The IPM kernel at the instantiation of the problems' shape, on
    random cones of that structure (`rand`) and on a path's real cones
    (`real`), cold (25 iterations, each path's start) and warm-started
    (15), against the plain version and an f64 solve."""
    from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
    from bayesian_cbf_tpu_torch.solvers.socp import _interior_shift
    B, C, d, nx = real[1].shape
    f32, f64 = torch.float32, torch.float64
    e = torch.zeros((B, C, d), dtype=f32, device=dev)
    e[..., 0] = 1.0
    cold = [torch.zeros((B, nx), dtype=f32, device=dev), e, e]
    rel = lambda a, b: (a - b).abs() / (1.0 + b.abs())
    # median and 90th percentile over problems
    quant = lambda v: [float(t) for t in torch.quantile(
        v.double(), torch.tensor([0.5, 0.9], dtype=f64, device=dev))]
    worst_err = 0.0
    for kind, prob in (("random", rand), ("real", real)):
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
            torch.cuda.synchronize()
            sg = ik.score_padded(*prob, *got)
            sw = ik.score_padded(*prob, *want)
            n_k, n_p = int((sg < 1e-3).sum()), int((sw < 1e-3).sum())
            both = (sg < 1e-3) & (sw < 1e-3)
            dx = rel(got[0], want[0]).amax(-1)
            tag = f"[ipm {label} {kind} iters={iters}]"
            line = [f"{tag} median KKT score kernel {float(sg.median()):.3e} "
                    f"plain {float(sw.median()):.3e}; score < 1e-3: kernel "
                    f"{n_k}/{B}, plain {n_p}/{B}, both {int(both.sum())}"]
            _require(float(sg.median()) <= 2.0 * float(sw.median()),
                     f"{tag}: kernel score above 2x plain")
            # the score's complementarity term is absolute, so f32 stalls
            # above 1e-3 where the optimal cost is large: the kernel must
            # converge wherever the plain version does, within 5%
            _require(n_k >= n_p - B // 20,
                     f"{tag}: fewer converged problems than plain")
            # the optimal values agree where both converge, held wherever
            # the plain version converges on half the problems (in f32 it
            # does not on the pendulum's real cones: 5 of 256, cold)
            if n_p >= B // 2:
                _require(int(both.sum()) >= B // 2,
                         f"{tag}: both converge on fewer than half")
                cost = lambda x: (prob[0] * x).sum(-1)
                rel_c = float(rel(cost(got[0]), cost(want[0]))[both].max())
                line.append(f"on those both: max rel |dx| "
                            f"{float(dx[both].max()):.3e}, max rel |d cost| "
                            f"{rel_c:.3e}")
                _require(rel_c < 1e-3, f"{tag}: optimal value disagrees "
                         f"({rel_c})")
                if kind == "real":
                    worst_err = max(worst_err, float(
                        (got[0] - want[0]).abs().amax(-1)[both].max()))
            else:
                line.append("values not compared: the plain version "
                            "converges on fewer than half")
            if iters == 25:
                # from the cold start, f32 roundoff soon separates the two
                # iterates; each is held against the f64 run of the same
                # iterations where that converged: the kernel's median and
                # 90th-percentile distance no farther than twice the plain
                # f32 version's
                exact = ik.ipm_plain(*(a.double() for a in prob + start),
                                     iters, 1e-10)
                conv = ik.score_padded(*(a.double() for a in prob),
                                       *exact) < 1e-6
                _require(int(conv.sum()) >= B // 2,
                         f"{tag}: the f64 reference converged on fewer than "
                         f"half")
                dk = quant(rel(got[0].double(), exact[0]).amax(-1)[conv])
                dp = quant(rel(want[0].double(), exact[0]).amax(-1)[conv])
                qx = quant(dx)
                qs = quant((sg.double() / sw.double()).log10().abs())
                line.append(f"kernel vs plain over all {B}, median / 90%: rel "
                            f"|dx| {qx[0]:.3e} / {qx[1]:.3e}, |log10 score "
                            f"ratio| {qs[0]:.3e} / {qs[1]:.3e}")
                line.append(f"rel |x - x_f64| on the {int(conv.sum())} f64-"
                            f"converged, median / 90%: kernel {dk[0]:.3e} / "
                            f"{dk[1]:.3e}, plain f32 {dp[0]:.3e} / "
                            f"{dp[1]:.3e}")
                _require(all(k <= max(2.0 * p, 1e-4) for k, p in zip(dk, dp)),
                         f"{tag}: x farther from f64 than plain f32 "
                         f"({dk} vs {dp})")
            else:
                # from a warm start the two iterates stay together: held
                # problem by problem, on all B; the controllers' SOCPs have
                # a unique optimum, random ones may have an optimal face
                q = quant(dx)
                line.append(f"rel |dx| over all {B}, median / 90% / max: "
                            f"{q[0]:.3e} / {q[1]:.3e} / {float(dx.max()):.3e}")
                _require(q[1] < 1e-3, f"{tag}: iterates disagree ({q})")
                if kind == "real":
                    _require(float(dx.max()) < 1e-2,
                             f"{tag}: iterates disagree ({float(dx.max())})")
                    worst_err = max(worst_err,
                                    float((got[0] - want[0]).abs().max()))
            print("; ".join(line), flush=True)
    ms = _cuda_ms(lambda: ik.ipm(*real, *cold, 25, 1e-10), 50)
    plain_ms = _cuda_ms(lambda: ik.ipm_plain(*real, *cold, 25, 1e-10), 5)
    bound = _bound(_ipm_flops(B, nx, C, d, 25),
                   F32 * B * (3 * nx + C * d * nx + 5 * C * d))
    print(f"[ipm {label}] (nx, C, d) = ({nx}, {C}, {d}), B={B}, 25 "
          f"iterations: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}; the kernel is "
          f"bound by the latency of its serial per-thread chain)", flush=True)
    return dict(max_abs_err=worst_err, ms=ms, plain_ms=plain_ms,
                library_ms=None, **bound)


def _pendulum_step0_cones(dev, x0s):
    """The pendulum path's real step-0 SOCPs (fresh weights, the
    epsilon-greedy reference at its widest), padded."""
    from bayesian_cbf_tpu_torch.control.learned_socp_controller import (
        learned_socp_cones)
    from bayesian_cbf_tpu_torch.solvers.socp import _pad_cones
    sim = _pendulum_sim(dev)
    lrn = sim.learned
    gen = torch.Generator(device=dev).manual_seed(3)
    state = lrn.init_state(x0s.shape[0], gen, dev, torch.float32)
    mder = lrn.moment_derivatives(state, x0s)
    u_lqr = sim.lqr.control_with_model(mder[1][:, :, 0, :], mder[0][:, :, 1:],
                                       x0s)
    u_ref = sim.egreedy.perturb(u_lqr, 0, torch.rand(
        u_lqr.shape, generator=gen, device=dev))
    cobj, G, h, dims, _, _ = learned_socp_cones(sim.controller, (sim.cbf,),
                                                mder, u_ref, x0s)
    Gp, hp = _pad_cones(G, h, dims)
    return cobj.expand(x0s.shape[0], -1).contiguous(), Gp, hp


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
    n, mh = 3, 3
    # per entry of the symmetric result's lower triangle: n differences,
    # squares and sums, one exp, the 1+m dot product and the scalings
    bound = _bound((3 * n + 2 * mh + 4) * _tri(K) * B,
                   F32 * (B * K * (n + mh + 1) + B + B * K * K))
    print(f"[gram] (256, 200): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound)


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
    # K^{-1} only: no single call also returns the logdet
    library_ms = _cuda_ms(lambda: torch.linalg.inv_ex(T), 20)
    # the same function as kernel 1, bounded as a Cholesky route does it
    bound = _kinv_logdet_bound(256, 200)
    print(f"[sweep] (256, 200): sweep_full kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); recursive "
          f"kernel {rec_ms:.3f} ms, plain {rec_plain_ms:.3f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **bound,
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
    B, n, N = 256, 200, ck.padded_order(200, nb)
    Kp = torch.eye(N, device=dev).repeat(B, 1, 1)
    Kp[:, :n, :n] = K
    # L of the padded K only, without the diagonal-block inverses
    library_ms = _cuda_ms(lambda: torch.linalg.cholesky_ex(Kp), 20)
    bound = _chol_dinv_bound(B, n, N, nb)
    print(f"[chol_dinv] (256, 200): kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, library {library_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **bound)


def _check_cholsolve_kernels(dev):
    """Kernel 6 (factor + solve + logdet) and kernel 7 (solve with the
    saved factor) against their plain versions and an f64 solve, on
    trajectory Grams, at (B, n, r) = (256, 200, 16) and (4, 1024, 16)."""
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    nb = ck.NB_BLK
    rel = lambda a, b: float((a.double() - b.double()).abs().max()
                             / b.double().abs().max())
    out = {}
    for B, n, r in ((256, 200, 16), (4, 1024, 16)):
        K = torch.tensor(_trajectory_grams(B, n, seed=n + 3),
                         dtype=torch.float32, device=dev)
        R = torch.tensor(np.random.default_rng(n).normal(size=(B, n, r)),
                         dtype=torch.float32, device=dev)
        exact = torch.linalg.solve(K.double(), R.double())
        ld64 = torch.linalg.slogdet(K.double())[1]
        got = ck.cholsolve_logdet(K, R, nb)
        want = ck.cholsolve_logdet_plain(K, R, nb)
        again = ck.solve_with_factor(got[1], got[2], R, nb)
        again_plain = ck.solve_with_factor_plain(got[1], got[2], R, nb)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(a).all()) for a in got + (again,))
        e_k, e_p = rel(got[0], exact), rel(want[0], exact)
        ld_err = float((got[3].double() - ld64).abs().max())
        print(f"[cholsolve] trajectory Grams (B, n, r) = ({B}, {n}, {r}): "
              f"finite={finite}; sol vs f64: kernel {e_k:.3e}, plain "
              f"{e_p:.3e}; vs plain: sol {rel(got[0], want[0]):.3e}, L "
              f"{rel(got[1], want[1]):.3e}, Dinv {rel(got[2], want[2]):.3e};"
              f" logdet err {ld_err:.3e}; solve_with_factor vs kernel 6's "
              f"sol {rel(again, got[0]):.3e}, vs its plain "
              f"{rel(again, again_plain):.3e}", flush=True)
        _require(finite and e_k <= max(3.0 * e_p, 1e-3) and ld_err < 0.5,
                 f"cholsolve ({B}, {n}, {r}): {e_k} vs plain {e_p}, logdet "
                 f"{ld_err}")
        _require(rel(again, again_plain) < 1e-4,
                 f"solve_with_factor ({B}, {n}, {r}) disagrees with plain")
        if n > 200:
            continue
        S = torch.tensor(_spd(B, n, 4), dtype=torch.float32, device=dev)
        g6, w6 = ck.cholsolve_logdet(S, R, nb), ck.cholsolve_logdet_plain(
            S, R, nb)
        g7 = ck.solve_with_factor(g6[1], g6[2], R, nb)
        w7 = ck.solve_with_factor_plain(g6[1], g6[2], R, nb)
        torch.cuda.synchronize()
        err6 = max(float((g - w).abs().max()) for g, w in zip(g6, w6))
        rel6 = max(rel(g, w) for g, w in zip(g6, w6))
        err7, rel7 = float((g7 - w7).abs().max()), rel(g7, w7)
        print(f"[cholsolve] SPD ({B}, {n}, {r}): max abs err vs plain "
              f"{err6:.3e} (relative {rel6:.3e}); solve_with_factor "
              f"{err7:.3e} ({rel7:.3e})", flush=True)
        _require(rel6 < 1e-4 and rel7 < 1e-4, "cholsolve disagrees on SPD")
        N = ck.padded_order(n, nb)
        L, Dinv = got[1], got[2]
        Ln = L[:, :n, :n].contiguous()
        t6 = dict(ms=_cuda_ms(lambda: ck.cholsolve_logdet(K, R, nb), 20),
                  plain_ms=_cuda_ms(lambda: ck.cholsolve_logdet_plain(
                      K, R, nb), 20),
                  # the solution only, without L, Dinv and the logdet
                  library_ms=_cuda_ms(lambda: torch.linalg.solve_ex(K, R),
                                      20))
        t7 = dict(ms=_cuda_ms(lambda: ck.solve_with_factor(L, Dinv, R, nb),
                              20),
                  plain_ms=_cuda_ms(lambda: ck.solve_with_factor_plain(
                      L, Dinv, R, nb), 20),
                  library_ms=_cuda_ms(lambda: torch.cholesky_solve(R, Ln),
                                      20))
        b6 = _cholsolve_bound(B, n, r, N, nb)
        b7 = _solve_with_factor_bound(B, n, r, nb)
        for name, t, b in (("cholsolve_logdet", t6, b6),
                           ("solve_with_factor", t7, b7)):
            print(f"[{name}] ({B}, {n}, {r}): kernel {t['ms']:.3f} ms, plain "
                  f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms,"
                  f" bound {b['bound_ms']:.4f} ms ({b['bound_by']})",
                  flush=True)
        out["cholsolve_logdet"] = dict(max_abs_err=err6, **t6, **b6)
        out["solve_with_factor"] = dict(max_abs_err=err7, **t7, **b7)
    return out


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
                sweep=sk.batched_kinv_logdet, gram=gm.fused_gram_kb,
                cholsolve_logdet=ck.cholsolve_logdet,
                solve_with_factor=ck.solve_with_factor)


def _expected_launches(lrn, T, warm_start):
    """Launches of each kernel that one rollout of T steps with learner
    `lrn` implies: one IPM per step, plus the step-0 warm start when the
    controller warm-starts; one fit inverse per Adam iteration (the first
    fit's, with its refine stage when two-stage, then the warm refits');
    three factorizations (the jitter ladder) and, with fused_gram, one
    Gram per cache refresh."""
    gp = lrn.gp
    n_fits = len(range(lrn.train_every_n_steps, T, lrn.train_every_n_steps))
    first = lrn.training_iter + (lrn.first_fit_refine_iter
                                 if lrn.first_fit_twostage else 0)
    warm = (lrn.training_iter_warm if lrn.warm_refits_differ
            else lrn.training_iter)
    iters = first + (n_fits - 1) * warm if n_fits else 0
    want = dict.fromkeys(_counters(), 0)
    want["ipm"] = T + int(warm_start)
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
    want = _expected_launches(sim.learned_dynamics, T,
                              sim.controller.warm_start)
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


def _pendulum_sim(dev, **kw):
    from bayesian_cbf_tpu_torch.experiments.pendulum import (
        make_pendulum_online_sim)
    # bench.py's pendulum (bench.py:260-319): max_train 200, 250 steps,
    # dt 2e-3, f32, with the configuration's keywords
    return make_pendulum_online_sim(max_train=200, device=dev,
                                    dtype=torch.float32, **kw)


def _pendulum_x0s(dev, B=256):
    """theta0 = 7 pi / 12 and omega0 = 0, each + 0.05 N(0, 1) (bench.py's
    perturbation, from a numpy seed)."""
    from bayesian_cbf_tpu_torch.experiments.pendulum import THETA0
    rng = np.random.default_rng(7)
    x0 = np.array([THETA0, 0.0])[None] + 0.05 * rng.normal(size=(B, 2))
    return torch.tensor(x0, dtype=torch.float32, device=dev)


PENDULUM_CONFIGS = {
    "continuous": dict(continuous_updates=True, train_every_n_steps=100,
                       training_iter_warm=5, first_fit_coarse_stride=3,
                       first_fit_refine_iter=5),
    "reference schedule": dict(training_iter_warm=10),
}


def run_pendulum(dev, x0s, card, label):
    """One batch of pendulum episodes in a configuration of
    PENDULUM_CONFIGS: launch counts, finiteness, moved hyperparameters, the
    outcome gates of scripts/check_outcomes.py (pendulum_batched_safe and
    pendulum_batched_cu_safe, with feasible >= 0.95 for both)."""
    from bayesian_cbf_tpu_torch.experiments.pendulum import (
        pendulum_damage_fraction, pendulum_wedge_fraction,
        run_pendulum_online_batch)
    sim = _pendulum_sim(dev, **PENDULUM_CONFIGS[label])
    lrn = sim.learned
    B, T = x0s.shape[0], sim.numSteps
    gen = torch.Generator(device=dev).manual_seed(5)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_pendulum_online_batch(sim, x0s, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    tag = f"[pendulum {label}]"
    print(f"{tag} {PENDULUM_CONFIGS[label]}: B={B} K={lrn.max_train} T={T}: "
          f"wall {wall:.3f} s, {B * T / wall:.1f} steps/s, "
          f"{wall * 1e3 / T:.3f} ms per step (fits included) on {card}",
          flush=True)
    print(f"{tag} launches {launches}", flush=True)
    want = _expected_launches(lrn, T, warm_start=False)
    _require(launches == want, f"{tag}: launch counts {launches} != {want}")
    th = out.X[..., 0]
    dmg = pendulum_damage_fraction(th)
    wdg = pendulum_wedge_fraction(th)
    finite = bool(torch.isfinite(out.X).all())
    feas = float(out.info.feasible.float().mean())
    cert = float(out.info.certified.float().mean())
    th_end = float(out.X[:, -1, 0].min())
    gates = dict(mean_damage=float(dmg.mean()),
                 frac_damaged=float((dmg > 0).float().mean()),
                 frac_wedge_gt_2pct=float((wdg > 0.02).float().mean()),
                 finite=finite, feasible=feas, certified=cert,
                 min_final_theta=th_end)
    print(f"{tag} outcomes {gates}", flush=True)
    _require(gates["mean_damage"] <= 0.01 and gates["frac_damaged"] <= 0.05
             and gates["frac_wedge_gt_2pct"] <= 0.05 and finite
             and feas >= 0.95, f"{tag}: outcome gate failed")
    if lrn.continuous_updates:
        _require(th_end > math.pi / 4 + math.pi / 8,
                 f"{tag}: an episode ended at theta {th_end}, inside or "
                 f"below the wedge edge")
    return launches, dict(wall_s=wall, steps_per_s=B * T / wall, **gates)


def _aten_ops(fn):
    """fn() and the number of ATen operations it dispatched."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def phase_pendulum_profile(dev, x0s, steps=20):
    """Host and device time of the pendulum step loop alone, in the
    continuous configuration before its first refit: `steps` steps timed
    unprofiled (with any implicit host synchronization an error), once
    more under torch.profiler for the device operations
    (kernels and copies) and their device time, then each part of the
    step (as `run_pendulum_online_batch` calls them) timed between two
    synchronizations, with the ATen operations it dispatches."""
    from torch.profiler import ProfilerActivity, profile
    from bayesian_cbf_tpu_torch.control.learned_socp_controller import (
        learned_socp_control)
    from bayesian_cbf_tpu_torch.experiments.pendulum import (
        run_pendulum_online_batch)
    sim = _pendulum_sim(dev, **PENDULUM_CONFIGS["continuous"])._replace(
        numSteps=steps)
    run = lambda: run_pendulum_online_batch(
        sim, x0s, generator=torch.Generator(device=dev).manual_seed(6))
    run()
    torch.cuda.synchronize()
    # the step loop reads nothing back to the host: an implicit
    # synchronization in the timed run raises
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    run()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time for e in dev_events) / 1e3 / steps
    ops = len(dev_events) / steps
    print(f"[pendulum profile] B={x0s.shape[0]}, {steps} steps without a "
          f"refit: {wall_ms:.3f} ms per step, {ops:.1f} device operations "
          f"and {dev_ms:.3f} ms of device time per step (device idle "
          f"{100 * (1 - dev_ms / wall_ms):.1f}% of the unprofiled step)",
          flush=True)
    lrn = sim.learned
    gen = torch.Generator(device=dev).manual_seed(6)
    state, X = lrn.init_state(x0s.shape[0], gen, dev, x0s.dtype), x0s
    ms, aten = {}, {}
    # `steps` timed steps, then one more, untimed, that counts ATen
    # operations (the counting dispatches every operation through Python)
    for t in range(steps + 1):

        def timed(name, fn):
            if t == steps:
                out, aten[name] = _aten_ops(fn)
                return out
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t1) * 1e3
            return out

        mder = timed("moment derivatives",
                     lambda: lrn.moment_derivatives(state, X))
        u_lqr = timed("LQR", lambda: sim.lqr.control_with_model(
            mder[1][:, :, 0, :], mder[0][:, :, 1:], X))
        u_ref = timed("exploration", lambda: sim.egreedy.perturb(
            u_lqr, t, torch.rand(u_lqr.shape, generator=gen, device=dev)))
        u, _ = timed("cones + SOCP", lambda: learned_socp_control(
            sim.controller, (sim.cbf,), mder, u_ref, X, u_lqr))
        state = timed("record + rank-1 append",
                      lambda: lrn.record(state, X, u, generator=gen))
        X = timed("pendulum step",
                  lambda: sim.true_dynamics.step(X, u, sim.dt)[0])
    breakdown = {name: dict(ms_per_step=ms[name] / steps,
                            aten_ops_per_step=aten[name]) for name in ms}
    for name, b in breakdown.items():
        print(f"[pendulum profile] {name}: {b['ms_per_step']:.3f} ms per "
              f"step (synchronized), {b['aten_ops_per_step']} ATen "
              f"operations", flush=True)
    return dict(ms_per_step=wall_ms, device_ops_per_step=ops,
                device_ms_per_step=dev_ms, parts=breakdown)


def main():
    dev, card = phase_device()
    phase_build()
    x0s = _x0s(dev)
    px0s = _pendulum_x0s(dev)
    chol = _check_chol_kernels(dev)
    ipm = _check_ipm_kernel(dev, "(4, 4, 4)", [
        torch.tensor(a, dtype=torch.float32, device=dev)
        for a in _random_cones(256, 0)], list(_step0_cones(dev, x0s, 1)))
    ipm_p = _check_ipm_kernel(dev, "(4, 3, 3)", [
        torch.tensor(a, dtype=torch.float32, device=dev)
        for a in _random_cones(256, 2, dims=(3, 3, 1))],
        list(_pendulum_step0_cones(dev, px0s)))
    gram = _check_gram_kernel(dev)
    sweep = _check_sweep_kernel(dev)
    dinv = _check_chol_dinv_kernel(dev)
    solve = _check_cholsolve_kernels(dev)
    main_path, out = run_config(dev, x0s, card, "main")
    configs = dict(main={}, a=dict(fit_inverse="chol", linv_assembly="row"),
                   b=dict(fit_inverse="sweep_full"), c=dict(fused_gram=True))
    runs = {k: run_config(dev, x0s, card, f"config {k}", **configs[k])[0]
            for k in "abc"}
    phase_fit_timing(dev, out, configs)
    pend = {label: run_pendulum(dev, px0s, card, label)
            for label in PENDULUM_CONFIGS}
    runs.update({f"pendulum {k}": v[0] for k, v in pend.items()})
    profile_stats = phase_pendulum_profile(dev, px0s)

    def entry(name, source, replaces, run, stats, counter=None):
        counter = counter or name
        per_run = {"main": main_path[counter]}
        per_run.update({k: v[counter] for k, v in runs.items()})
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
        entry("ipm (4, 3, 3)", "ipm.cu", "pallas_ipm.py:48",
              "pendulum continuous", ipm_p, counter="ipm"),
        entry("chol_dinv", "chol_blocked.cu", "pallas_chol.py:105", "a", dinv),
        entry("sweep", "sweep.cu", "pallas_sweep.py:203", "b", sweep),
        entry("gram", "gram.cu", "gram.py:54", "c", gram),
        entry("cholsolve_logdet", "cholsolve.cu", "pallas_chol.py:242",
              "main", solve["cholsolve_logdet"]),
        entry("solve_with_factor", "cholsolve.cu", "pallas_chol.py:284",
              "main", solve["solve_with_factor"]),
    ]
    print(json.dumps({"pendulum": {k: v[1] for k, v in pend.items()},
                      "pendulum_profile": profile_stats}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
