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
                 cones and (4, 3, 3) on the pendulum's, each also on 1003
                 random cones (no whole number of blocks).  The blocked
                 factor's kernels (the fit inverse among them), the IPM,
                 both kernels of csrc/sweep.cu and the three instances of
                 the fused Gram print their registers, stack and spill
                 bytes beside their times (the Gram's device time per
                 launch too, at (256, 200), (4, 1024) and the pendulum's
                 n = 1+m = 2 at (256, 200)); the fit inverse
                 and the refresh factorization also their times and
                 accuracy at other block sizes and beside the routes that
                 compute the same through several launches; the one-sweep
                 fit inverse's register kernel is held bit for bit to the
                 event kernel at n = 200 and 50, and timed beside it.
                 Run (c) must repeat its accepted rungs and outcomes to
                 the digit (REPEATED): the Gram gives the same bits.
  4. main     -- the batched unicycle learn-and-control loop (B=256
                 episodes, K=200, 2000 steps, bench.py's configuration)
                 through bench_torch.py's protocol: a cold rollout and a
                 warm one of the same inputs, each with its wall and its
                 launch counts, the batched-learning outcome gate, and
                 the accepted rungs of its cache refreshes.
  5. configs  -- the same loop under three other MVGP configurations:
                 (a) fit_inverse "chol" with linv_assembly "row",
                 (b) fit_inverse "sweep_full", (c) fused_gram; each with
                 launch counts, moved hyperparameters, the outcome gate,
                 and the ms per Adam iteration of its fit.
  6. pendulum -- the batched pendulum online-learning loop (B=256, K=200,
                 250 steps, dt 2e-3, bench.py's two configurations:
                 continuous rank-1 updates with sparse refits, and the
                 reference schedule), cold and warm like main, with launch
                 counts, the outcome gates of scripts/check_outcomes.py,
                 the accepted rungs, and ms and device operations per step.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.
"""
import json
import time

import numpy as np
import torch

import bench_torch as bt


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


def _device_ms(fn, name, reps):
    """Device time per call of fn() spent in kernels whose name holds
    `name`, from torch.profiler: a kernel's own time where the host's
    launches are slower than the kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.name) / 1e3 / reps


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
    return bt.require_card("chip_smoke")


def phase_build():
    from bayesian_cbf_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all(_build.KERNEL_SOURCES)
    print(f"[build] {', '.join(_build.KERNEL_SOURCES)}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
        print(f"[build] {name}:\n{_build.ptxas_report(name)}", flush=True)


def _usage(source, kernel):
    """Registers, stack and spill bytes (stores + loads) that ptxas reports
    for `kernel` (its name with its template arguments) in this run's build
    of csrc/`source`.cu."""
    from bayesian_cbf_tpu_torch.ops import _build
    hits = [u for u in _build.ptxas_usage(source) if u["kernel"] == kernel]
    _require(len(hits) == 1 and hits[0]["registers"],
             f"no ptxas report for {kernel} in {source}")
    u = hits[0]
    return dict(registers=u["registers"], stack_bytes=u["stack_bytes"],
                spill_bytes=u["spill_store_bytes"] + u["spill_load_bytes"])


def _usage_text(u):
    return (f"{u['registers']} registers, {u['stack_bytes']} bytes of stack, "
            f"{u['spill_bytes']} bytes of spills")


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
        print(f"[kinv_logdet] ({B}, {n}): kernel "
              f"{_cuda_ms(lambda: ck.kinv_logdet(K), 5):.3f} ms, plain "
              f"{_cuda_ms(lambda: ck.kinv_logdet_plain(K), 5):.3f} ms",
              flush=True)
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
        print(f"[chol_linv] ({B}, {n}): kernel "
              f"{_cuda_ms(lambda: ck.chol_linv(K), 5):.3f} ms, plain "
              f"{_cuda_ms(lambda: ck.chol_linv_plain(K), 5):.3f} ms",
              flush=True)
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
    out["kinv_logdet"].update(_kinv_logdet_design(dev, S, K))
    out["chol_linv"].update(_chol_linv_design(dev, S, K))
    return out


# kernel 1 at (256, 200) before it was rebuilt on the blocked factor (one
# column at a time, three block-wide barriers each), NVIDIA H100 80GB HBM3
# at 700 W
KINV_LOGDET_EARLIER_MS = 4.315


def _kinv_logdet_design(dev, S, K):
    """What the fit inverse's design rests on, at (256, 200): agreement
    with the plain version of its own steps on the SPD batch S; on the
    trajectory Grams K its time at each block size and the times of the
    routes that compute the same function through several launches
    (kernel 8 + the "row" assembly in matmuls, and the "chol" fit inverse
    on top of it); registers and spills."""
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    from bayesian_cbf_tpu_torch.ops import cholinv
    got, want = ck.kinv_logdet(S), ck.kinv_logdet_blocked_plain(S)
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    print(f"[kinv_logdet] SPD (256, 200): relative error vs the plain "
          f"version of its own steps {rel:.3e}", flush=True)
    _require(rel < 1e-4, f"kinv_logdet disagrees with its steps: {rel}")
    by_nb = {nb: _cuda_ms(lambda: ck.kinv_logdet(K, nb), 20)
             for nb in (8, 16, 32, 64)}
    # each block size is another rounding: its distance from the f64
    # inverse on the trajectory Grams, beside the plain version's
    exact = torch.linalg.inv(K.double())
    far = lambda Kinv: float(((Kinv.double() - exact).abs().amax((-1, -2))
                              / exact.abs().amax((-1, -2))).max())
    err_by_nb = {nb: far(ck.kinv_logdet(K, nb)[0]) for nb in by_nb}
    err_plain = far(ck.kinv_logdet_plain(K)[0])
    routes = dict(
        chol_dinv_ms=_cuda_ms(lambda: ck.chol_dinv(K), 20),
        chol_linv_assembled_row_ms=_cuda_ms(
            lambda: ck.chol_linv_assembled(K, "row"), 20),
        fit_chol_row_ms=_cuda_ms(
            lambda: cholinv.batched_kinv_logdet_fit(K, "chol", "row"), 20),
        blocked_plain_ms=_cuda_ms(
            lambda: ck.kinv_logdet_blocked_plain(K), 20))
    usage = _usage("chol", "kinv_logdet_kernel<32, 512>")
    print(f"[kinv_logdet] (256, 200): ms by block size "
          f"{ {nb: round(t, 4) for nb, t in by_nb.items()} } (the wrapper's: "
          f"{ck.KINV_NB}); max relative distance from the f64 inverse by "
          f"block size { {nb: f'{e:.3e}' for nb, e in err_by_nb.items()} }, "
          f"plain {err_plain:.3e}; other routes {routes}; before "
          f"the rebuild {KINV_LOGDET_EARLIER_MS} ms; {_usage_text(usage)}",
          flush=True)
    return dict(ms_by_nb=by_nb, rel_err_vs_f64_by_nb=err_by_nb, **routes,
                **usage)


# kernel 2 at (256, 200) before it was rebuilt on the blocked factor (one
# column at a time, L^{-1} eliminated in global memory), NVIDIA H100 80GB
# HBM3 at 700 W
CHOL_LINV_EARLIER_MS = 3.978


def _chol_linv_design(dev, S, K):
    """What the refresh factorization's design rests on, at (256, 200):
    agreement with the plain version of its own steps on the SPD batch S;
    the Gram of a partly filled reservoir (identity rows for the empty
    slots); on the trajectory Grams K, per block size, its time, the
    distance of L^{-1} from the f64 L^{-1} (relative to its largest entry,
    the largest over the batch) and max|Linv L - I|, beside the plain
    version's and the route through kernel 8 and the "row" assembly in
    matmuls; registers and spills."""
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    got, want = ck.chol_linv(S), ck.chol_linv_blocked_plain(S)
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    print(f"[chol_linv] SPD (256, 200): relative error vs the plain version "
          f"of its own steps {rel:.3e}", flush=True)
    _require(rel < 1e-4, f"chol_linv disagrees with its steps: {rel}")
    n, filled = K.shape[-1], 130
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    resid = lambda L, Linv: float((Linv.double() @ L.double() - eye)
                                  .abs().max())
    m = (torch.arange(n, device=dev) < filled).to(K.dtype)
    Km = K * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
    L, Linv = ck.chol_linv(Km)
    r_fac = float((L.double() @ L.double().transpose(-1, -2) - Km.double())
                  .abs().max())
    tail = bool((L[:, filled:] == eye[filled:].float()).all()
                & (Linv[:, filled:] == eye[filled:].float()).all())
    print(f"[chol_linv] (256, 200) with {filled} of {n} slots filled: "
          f"max|Linv L - I| {resid(L, Linv):.3e}, max|LL^T - K| {r_fac:.3e}, "
          f"the empty slots' rows are the identity's: {tail}", flush=True)
    _require(resid(L, Linv) < 5e-2 and r_fac < 1e-5 and tail,
             "chol_linv fails on a partly filled reservoir")
    L64 = torch.linalg.cholesky(K.double())
    exact = torch.linalg.solve_triangular(L64, eye.expand_as(L64),
                                          upper=False)
    far = lambda Linv: float(((Linv.double() - exact).abs().amax((-1, -2))
                              / exact.abs().amax((-1, -2))).max())
    by_nb = {}
    for nb in (8, 16, 32):
        L, Linv = ck.chol_linv(K, nb)
        by_nb[nb] = dict(ms=_cuda_ms(lambda: ck.chol_linv(K, nb), 20),
                         rel_err_vs_f64=far(Linv), resid=resid(L, Linv))
    L, Linv = ck.chol_linv_plain(K)
    plain = dict(ms=_cuda_ms(lambda: ck.chol_linv_plain(K), 20),
                 rel_err_vs_f64=far(Linv), resid=resid(L, Linv))
    L, Linv = ck.chol_linv_assembled(K, "row")
    composed = dict(ms=_cuda_ms(lambda: ck.chol_linv_assembled(K, "row"), 20),
                    rel_err_vs_f64=far(Linv), resid=resid(L, Linv))
    usage = _usage("chol", "chol_linv_kernel<32, 512>")
    row = lambda d: (f"{d['ms']:.4f} ms, {d['rel_err_vs_f64']:.3e} from the "
                     f"f64 L^-1, max|Linv L - I| {d['resid']:.3e}")
    print(f"[chol_linv] (256, 200) by block size (the wrapper's: "
          f"{ck.LINV_NB}): " + "; ".join(f"nb {nb}: {row(d)}"
                                         for nb, d in by_nb.items())
          + f"; plain: {row(plain)}; kernel 8 + \"row\" assembly in matmuls "
          f"(nb {ck.NB_BLK}): {row(composed)}; before the rebuild "
          f"{CHOL_LINV_EARLIER_MS} ms; {_usage_text(usage)}", flush=True)
    return dict(by_nb=by_nb, plain=plain, chol_linv_assembled_row=composed,
                **usage)


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
    sim = bt.unicycle_sim(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = sim.learned_dynamics.init_state(x0s.shape[0], gen, dev,
                                            torch.float32)
    mom = sim.learned_dynamics.moments(state, x0s)
    cobj, G, h, dims, _ = controller_socp(sim.controller, sim.clf, sim.cbfs,
                                          sim.planner, mom, x0s, 0)
    Gp, hp = _pad_cones(G, h, dims)
    return cobj.expand(x0s.shape[0], -1).contiguous(), Gp, hp


def _ipm_flops(B, nx, C, d, iters):
    """f32 operations that `iters` IPM iterations on B problems need (a
    multiply-add counts two): the residuals, the normal matrix
    G^T W^-2 G and its factor, two KKT solves, the cone algebra (scaling,
    step lengths, corrector), each once per problem.  What the kernel
    repeats on every lane of a problem (the factor and its solves, the
    chained sums) is its own cost and does not enter."""
    per_iter = (10 * C * d * nx + 2.5 * C * d * nx * (nx + 1)
                + (2 / 3) * nx ** 3 + 4 * nx * nx + 120 * C * d + 100 * C)
    return B * (iters * per_iter + 4 * C * d * nx)


def _check_ipm_kernel(dev, label, rand, real, many):
    """The IPM kernel at the instantiation of the problems' shape, on
    random cones of that structure (`rand`) and on a path's real cones
    (`real`), cold (25 iterations, each path's start) and warm-started
    (15), against the plain version and an f64 solve; then on `many`, a
    larger batch of random cones that fills no whole number of blocks."""
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
                far_k = rel(got[0].double(), exact[0]).amax(-1)[conv]
                far_p = rel(want[0].double(), exact[0]).amax(-1)[conv]
                dk, dp = quant(far_k), quant(far_p)
                qx = quant(dx)
                qs = quant((sg.double() / sw.double()).log10().abs())
                line.append(f"kernel vs plain over all {B}, median / 90%: rel "
                            f"|dx| {qx[0]:.3e} / {qx[1]:.3e}, |log10 score "
                            f"ratio| {qs[0]:.3e} / {qs[1]:.3e}")
                line.append(f"rel |x - x_f64| on the {int(conv.sum())} f64-"
                            f"converged, median / 90%: kernel {dk[0]:.3e} / "
                            f"{dk[1]:.3e}, plain f32 {dp[0]:.3e} / "
                            f"{dp[1]:.3e}; farther than 0.1 (stalled): "
                            f"kernel {int((far_k > 0.1).sum())}, plain "
                            f"{int((far_p > 0.1).sum())}")
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
    _check_ipm_ragged_batch(dev, label, many)
    ms = _cuda_ms(lambda: ik.ipm(*real, *cold, 25, 1e-10), 50)
    plain_ms = _cuda_ms(lambda: ik.ipm_plain(*real, *cold, 25, 1e-10), 5)
    bound = _bound(_ipm_flops(B, nx, C, d, 25),
                   F32 * B * (3 * nx + C * d * nx + 5 * C * d))
    usage = _usage("ipm", f"ipm_kernel<{nx}, {C}, {d}>")
    print(f"[ipm {label}] (nx, C, d) = ({nx}, {C}, {d}), B={B}, 25 "
          f"iterations: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}; the kernel is "
          f"bound by the latency of its serial per-lane chain); "
          f"{_usage_text(usage)}", flush=True)
    _require(usage["spill_bytes"] == 0 and usage["stack_bytes"] == 0,
             f"[ipm {label}]: the kernel spills ({usage})")
    return dict(max_abs_err=worst_err, ms=ms, plain_ms=plain_ms,
                library_ms=None, **bound, **usage)


def _check_ipm_ragged_batch(dev, label, prob):
    """A batch that is no multiple of the kernel's block (8 problems of 4
    lanes), on random cones, cold, 25 iterations, against the plain
    version: contiguous finite outputs in the callers' layout, the score's
    median within twice plain's, as many converged problems within 5%, and
    the optimal values equal where both converge; then the kernel's time
    on the batch and on one problem of it."""
    from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
    B, C, d, nx = prob[1].shape
    _require(B % 8 != 0, "the ragged batch fills whole blocks")
    e = torch.zeros((B, C, d), dtype=torch.float32, device=dev)
    e[..., 0] = 1.0
    cold = [torch.zeros((B, nx), dtype=torch.float32, device=dev), e, e]
    got = ik.ipm(*prob, *cold, 25, 1e-10)
    want = ik.ipm_plain(*prob, *cold, 25, 1e-10)
    torch.cuda.synchronize()
    tag = f"[ipm {label} random B={B}]"
    _require([tuple(t.shape) for t in got] == [(B, nx), (B, C, d), (B, C, d)]
             and all(t.is_contiguous() and bool(torch.isfinite(t).all())
                     for t in got), f"{tag}: outputs malformed")
    sg = ik.score_padded(*prob, *got)
    sw = ik.score_padded(*prob, *want)
    n_k, n_p = int((sg < 1e-3).sum()), int((sw < 1e-3).sum())
    both = (sg < 1e-3) & (sw < 1e-3)
    cost = lambda x: (prob[0] * x).sum(-1)
    rel_c = float(((cost(got[0]) - cost(want[0])).abs()
                   / (1.0 + cost(want[0]).abs()))[both].max())
    print(f"{tag} median KKT score kernel {float(sg.median()):.3e} plain "
          f"{float(sw.median()):.3e}; score < 1e-3: kernel {n_k}, plain "
          f"{n_p}, both {int(both.sum())}; max rel |d cost| on those "
          f"{rel_c:.3e}", flush=True)
    _require(float(sg.median()) <= 2.0 * float(sw.median()),
             f"{tag}: kernel score above 2x plain")
    _require(n_k >= n_p - B // 20, f"{tag}: fewer converged than plain")
    _require(int(both.sum()) >= B // 2 and rel_c < 1e-3,
             f"{tag}: optimal value disagrees ({rel_c})")
    # latency against throughput: the whole batch, and one problem alone
    one = [a[:1].contiguous() for a in prob + cold]
    ms_all = _cuda_ms(lambda: ik.ipm(*prob, *cold, 25, 1e-10), 50)
    ms_one = _cuda_ms(lambda: ik.ipm(*one, 25, 1e-10), 50)
    print(f"{tag} 25 iterations: {ms_all:.3f} ms; one problem of them "
          f"alone {ms_one:.3f} ms", flush=True)


def _pendulum_step0_cones(dev, x0s):
    """The pendulum path's real step-0 SOCPs (fresh weights, the
    epsilon-greedy reference at its widest), padded."""
    from bayesian_cbf_tpu_torch.control.learned_socp_controller import (
        learned_socp_cones)
    from bayesian_cbf_tpu_torch.solvers.socp import _pad_cones
    sim = bt.pendulum_sim(dev)
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


def _gram_bound(B, K, n, mh):
    """Per entry of the symmetric result's lower triangle: n differences,
    squares and sums, one exp, the 1+m dot product and the scalings; reads
    the inputs, writes the whole (B, K, K)."""
    return _bound((3 * n + 2 * mh + 4) * _tri(K) * B,
                  F32 * (B * K * (n + mh + 1) + B + B * K * K))


def _gram_inputs(dev, B, K, n, mh, seed, half_masked=False):
    rng = np.random.default_rng(seed)
    if half_masked:
        mask = np.ones((B, K))
        mask[:, K // 2:] = 0.0
    else:
        mask = (rng.uniform(size=(B, K)) > 0.5).astype(float)
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        np.cumsum(0.02 * rng.normal(size=(B, K, n)), 1),
        rng.normal(size=(B, K, mh)), mask, rng.uniform(0.5, 2.0, size=B))]


def _check_gram_kernel(dev):
    """Kernel 4 against plain at (256, 200, 3, 3) with half the rows
    masked, at a ragged K (201: misaligned rows), at (4, 1024, 3, 3) and
    at the pendulum's n = 1+m = 2 (256, 200); the near-duplicate bar;
    times per call and device times per launch at the three full shapes;
    registers, stack and spills of every instance (0 bytes of stack and
    spills required)."""
    from bayesian_cbf_tpu_torch.ops import gram as gm
    stats = {}
    for B, K, n, mh in ((256, 200, 3, 3), (5, 201, 3, 3), (4, 1024, 3, 3),
                        (256, 200, 2, 2)):
        unicycle = (K, n) == (200, 3)
        args = _gram_inputs(dev, B, K, n, mh, 3 if unicycle else K,
                            half_masked=unicycle)
        got = gm.fused_gram_kb(*args, 1e-6)
        want = gm.fused_gram_kb_plain(*args, 1e-6)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        masked = ", half the rows masked" if unicycle else ""
        print(f"[gram] ({B}, {K}, n={n}, 1+m={mh}){masked}: max abs err vs "
              f"plain {err:.3e}, relative {rel:.3e}", flush=True)
        _require(rel < 1e-5, f"gram disagrees with plain at K={K}, n={n}: "
                 f"{rel}")
        if K == 201:
            continue
        fn = lambda: gm.fused_gram_kb(*args, 1e-6)
        ms = _cuda_ms(fn, 50)
        device_ms = _device_ms(fn, "gram_kernel", 50)
        plain_ms = _cuda_ms(lambda: gm.fused_gram_kb_plain(*args, 1e-6), 20)
        bound = _gram_bound(B, K, n, mh)
        print(f"[gram] ({B}, {K}, n={n}, 1+m={mh}): kernel {ms:.4f} ms per "
              f"call, {device_ms:.4f} ms of device time per launch, plain "
              f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})", flush=True)
        stats[(B, K, n)] = dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                                plain_ms=plain_ms, **bound)
    *near, truth = _near_duplicate_case()
    near = [torch.tensor(a, dtype=torch.float32, device=dev) for a in near]
    got = gm.fused_gram_kb(*near, 1e-6).double().cpu().numpy()
    excess = float(np.max(np.abs(got - truth) - 2e-5 * np.abs(truth)))
    print(f"[gram] near-duplicate points vs f64 truth: max |err| - 2e-5|truth|"
          f" = {excess:.3e} (must be < 2e-5)", flush=True)
    _require(excess < 2e-5, "gram loses the near-duplicate distances")
    usage = {f"<{d}>": _usage("gram", f"gram_kernel<{d}>") for d in (3, 2, 0)}
    for inst, u in usage.items():
        print(f"[gram] gram_kernel{inst}: {_usage_text(u)}", flush=True)
        _require(u["stack_bytes"] == 0 and u["spill_bytes"] == 0,
                 f"gram_kernel{inst} uses local memory: {u}")
    return dict(**stats[(256, 200, 3)], library_ms=None, usage=usage,
                k1024=stats[(4, 1024, 3)], pendulum=stats[(256, 200, 2)])


def _same_bits(got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def _check_sweep_kernel(dev):
    """Kernel 5's two CUDA kernels: the register kernel of the one-sweep
    route ("sweep_full" at n = 200 and 50) bit for bit against the event
    kernel on the same schedule, with both kernels', plain's and inv_ex's
    times and the bound at both orders, and each kernel's registers; the
    fit-path bars on trajectory Grams, (4, 1024) on the event kernel; the
    recursive route against plain."""
    from bayesian_cbf_tpu_torch.ops import _build
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
            print(f"[sweep_full {name}] trajectory Grams B={B} n={n} "
                  f"({sk.sweep_route(n, sk.schedule(n, sk.full_base(n)))[0]}"
                  f" route): finite={finite} max|Kinv K - I|={resid:.3e} "
                  f"logdet err={lderr:.3e}", flush=True)
            if name == "kernel":
                _require(finite and lderr < 0.5,
                         f"sweep_full n={n}: finite {finite}, logdet {lderr}")
                _require(n > 200 or resid < 5e-2,
                         f"sweep_full n={n}: resid {resid}")
    # K is the (4, 1024) batch: one sweep there runs on the event kernel
    large_ms = _cuda_ms(lambda: sk.batched_kinv_logdet(K, sk.full_base(1024)),
                        1)
    usage = {u["kernel"]: _usage("sweep", u["kernel"])
             for u in _build.ptxas_usage("sweep")}
    for kernel, u in usage.items():
        print(f"[sweep] {kernel}: {_usage_text(u)}", flush=True)
    regs = [u for k, u in usage.items() if k.startswith("sweep_regs_kernel")]
    _require(len(regs) == len(sk.REGS_LIMITS)
             and all(u["stack_bytes"] == 0 for u in regs),
             "a register kernel instance keeps a stack frame")
    one_sweep = {}
    for n in (200, 50):
        full = sk.full_base(n)
        kernel, instance = sk.sweep_route(n, sk.schedule(n, full))
        _require(kernel == "regs", f"n={n} does not take the register kernel")
        S = torch.tensor(_spd(256, n, 2), dtype=torch.float32, device=dev)
        T = torch.tensor(_trajectory_grams(256, n, seed=11),
                         dtype=torch.float32, device=dev)
        same = {name: _same_bits(sk._launch_regs(K, instance),
                                 sk._launch_events(K, full))
                for name, K in (("SPD", S), ("trajectory", T))}
        got = sk.batched_kinv_logdet(T, full)
        want = sk.batched_kinv_logdet_plain(T, full)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        rel = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        ms = _cuda_ms(lambda: sk.batched_kinv_logdet(T, full), 20)
        device_ms = _device_ms(lambda: sk._launch_regs(T, instance),
                               "sweep_regs_kernel", 20)
        events_ms = _cuda_ms(lambda: sk._launch_events(T, full), 5)
        plain_ms = _cuda_ms(lambda: sk.batched_kinv_logdet_plain(T, full), 5)
        # K^{-1} only: no single call also returns the logdet
        library_ms = _cuda_ms(lambda: torch.linalg.inv_ex(T), 20)
        # the same function as kernel 1, bounded as a Cholesky route does it
        bound = _kinv_logdet_bound(256, n)
        print(f"[sweep] (256, {n}) one sweep: register kernel (instance "
              f"{instance}) {ms:.4f} ms per call ({device_ms:.4f} ms of "
              f"device time), event kernel {events_ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}); bits equal "
              f"to the event kernel's {same}; trajectory Grams vs plain: max "
              f"abs err {err:.3e}, relative {rel:.3e}", flush=True)
        _require(all(same.values()),
                 f"n={n}: the register kernel's bits differ from the event "
                 f"kernel's: {same}")
        _require(rel < 1e-4, f"sweep_full n={n} disagrees with plain: {rel}")
        one_sweep[n] = dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                            events_ms=events_ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bits_equal=same, **bound)
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
    rec_ms = _cuda_ms(lambda: sk.batched_kinv_logdet(S), 20)
    rec_plain_ms = _cuda_ms(lambda: sk.batched_kinv_logdet_plain(S), 5)
    print(f"[sweep] recursive (256, 200): kernel {rec_ms:.3f} ms, plain "
          f"{rec_plain_ms:.3f} ms; one sweep (4, 1024) on the event kernel "
          f"{large_ms:.3f} ms", flush=True)
    return dict(**one_sweep[200], n50=one_sweep[50], usage=usage,
                recursive_ms=rec_ms, recursive_plain_ms=rec_plain_ms,
                events_4x1024_ms=large_ms)


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
    usage = _usage("chol_blocked", "chol_dinv_kernel<32, 512>")
    print(f"[chol_dinv] (256, 200): kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, library {library_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); {_usage_text(usage)}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, **bound, **usage)


def _check_cholsolve_kernels(dev):
    """Kernel 6 (factor + solve + logdet) and kernel 7 (solve with the
    saved factor) against their plain versions and an f64 solve, on
    trajectory Grams and on SPD matrices, at (B, n, r) = (256, 200, 16) and
    (4, 1024, 16), with times per call and device times per launch."""
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    nb = ck.NB_BLK
    rel = lambda a, b: float((a.double() - b.double()).abs().max()
                             / b.double().abs().max())
    stats = {}
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
        _require(torch.equal(again, got[0]),
                 f"kernels 6 and 7 differ at ({B}, {n}, {r})")
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
        run6 = lambda: ck.cholsolve_logdet(K, R, nb)
        run7 = lambda: ck.solve_with_factor(L, Dinv, R, nb)
        t6 = dict(ms=_cuda_ms(run6, 20),
                  device_ms=_device_ms(run6, "cholsolve_kernel", 20),
                  plain_ms=_cuda_ms(lambda: ck.cholsolve_logdet_plain(
                      K, R, nb), 20),
                  # the solution only, without L, Dinv and the logdet
                  library_ms=_cuda_ms(lambda: torch.linalg.solve_ex(K, R),
                                      20))
        t7 = dict(ms=_cuda_ms(run7, 20),
                  device_ms=_device_ms(run7, "solve_with_factor_kernel", 20),
                  plain_ms=_cuda_ms(lambda: ck.solve_with_factor_plain(
                      L, Dinv, R, nb), 20),
                  library_ms=_cuda_ms(lambda: torch.cholesky_solve(R, Ln),
                                      20))
        b6 = _cholsolve_bound(B, n, r, N, nb)
        b7 = _solve_with_factor_bound(B, n, r, nb)
        for name, t, b, err in (("cholsolve_logdet", t6, b6, err6),
                                ("solve_with_factor", t7, b7, err7)):
            print(f"[{name}] ({B}, {n}, {r}): kernel {t['ms']:.4f} ms per "
                  f"call, {t['device_ms']:.4f} ms of device time per launch, "
                  f"plain {t['plain_ms']:.3f} ms, library "
                  f"{t['library_ms']:.3f} ms, bound {b['bound_ms']:.4f} ms "
                  f"({b['bound_by']})", flush=True)
            stats[(name, n)] = dict(max_abs_err=err, **t, **b)
    # <..., 1>: nb a multiple of 4 (L read as float4), the one that runs
    usage = {k: _usage("cholsolve", k) for k in (
        "cholsolve_kernel<32, 512, 1>", "cholsolve_kernel<32, 512, 0>",
        "cholsolve_kernel<64, 256, 1>", "cholsolve_kernel<64, 256, 0>",
        "solve_with_factor_kernel<1>", "solve_with_factor_kernel<0>")}
    for kernel, u in usage.items():
        print(f"[cholsolve] {kernel}: {_usage_text(u)}", flush=True)
    for kernel in ("cholsolve_kernel<32, 512, 1>",
                   "solve_with_factor_kernel<1>",
                   "solve_with_factor_kernel<0>"):
        _require(usage[kernel]["stack_bytes"] == 0
                 and usage[kernel]["spill_bytes"] == 0,
                 f"{kernel} uses local memory: {usage[kernel]}")
    return {name: dict(**stats[(name, 200)], **usage[kernel],
                       k1024=stats[(name, 1024)])
            for name, kernel in (
                ("cholsolve_logdet", "cholsolve_kernel<32, 512, 1>"),
                ("solve_with_factor", "solve_with_factor_kernel<1>"))}


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
    want = dict.fromkeys(bt.counters(), 0)
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


# Outcomes of the same runs before the refresh factorization (kernel 2) was
# rebuilt on the blocked factor, on an NVIDIA H100 80GB HBM3 at 700 W,
# printed beside this run's: kernel 2 now rounds as the blocked factor
# does, so every run that refreshes its cache through it moves within the
# reference's roundoff sensitivity; run (a) does not launch it.
EARLIER_OUTCOMES = {
    "main": "min clearance 0.1449, mean goal distance 0.5231, fraction "
            "within 1.0 of goal 1.0000",
    "config a": "min clearance 0.1013, mean goal distance 0.5340, fraction "
                "within 1.0 of goal 0.9922",
    "config b": "min clearance 0.1449, mean goal distance 0.5232, fraction "
                "within 1.0 of goal 1.0000",
    "config c": "min clearance 0.1477, mean goal distance 0.5239, fraction "
                "within 1.0 of goal 1.0000, feasible fraction 1.0000",
    "pendulum continuous": "certified 0.0411, feasible 0.9971, min final "
                           "theta 1.6326, no damage, no wedge entry",
    "pendulum reference schedule": "certified 0.7370, feasible 0.9953, min "
                                   "final theta 1.380, no damage, no wedge "
                                   "entry",
}


# Run (c)'s accepted rungs and outcomes since the refresh factorization was
# rebuilt on the blocked factor (NVIDIA H100 80GB HBM3, 700 W).  Kernel 4
# has given the same bits since, so they repeat to the digit.
REPEATED = {
    "config c": ([437, 561, 26],
                 "min clearance 0.1484, mean goal distance 0.5253, fraction "
                 "within 1.0 of goal 1.0000, feasible fraction 0.9984"),
}


def _check_rollouts(label, record, warm_start):
    """Print the cold (first) and the warm (second, same inputs) wall of a
    protocol record and hold every rollout's launch counts to the
    schedule's, and its accepted rungs to one per episode and refresh."""
    sim = record["sim"]
    lrn = getattr(sim, "learned_dynamics", None) or sim.learned
    B, T = record["batch"], record["episode_steps"]
    cold = record["first_wall_s"]
    line = (f"[{label}] B={B} K={lrn.max_train} T={T}: cold wall (the "
            f"process's first rollout of this configuration) {cold:.3f} s, "
            f"{B * T / cold:.1f} steps/s, {cold * 1e3 / T:.3f} ms per step")
    for w in record["walls_s"]:
        line += (f"; warm wall (the same inputs again) {w:.3f} s, "
                 f"{B * T / w:.1f} steps/s, {w * 1e3 / T:.3f} ms per step")
    print(f"{line} (fits included) on {record['card']}", flush=True)
    print(f"[{label}] launches {record['launches']}; episodes per accepted "
          f"rung of the cache refreshes' jitter ladder (first / + 1e-5 scale "
          f"/ + 1e-2 scale) {record['refresh_rungs']}", flush=True)
    want = _expected_launches(lrn, T, warm_start)
    refreshes = len(range(lrn.train_every_n_steps, T,
                          lrn.train_every_n_steps))
    for r in record["rollouts"]:
        _require(r["launches"] == want,
                 f"{label}: launch counts {r['launches']} != {want}")
        _require(sum(r["refresh_rungs"]) == B * refreshes,
                 f"{label}: accepted rungs {r['refresh_rungs']} do not add "
                 f"up to {B} episodes x {refreshes} cache refreshes")


def run_config(dev, card, label, reps=0, **gp_options):
    """Rollouts of the flagship batch with the MVGP options through
    bench_torch's protocol (a cold one, then `reps` warm ones of the same
    inputs, with equal outcomes or it raises); launch counts, finiteness,
    moved hyperparameters and the outcome gate.  Returns the launch
    counts, the accepted rungs and the last output."""
    print(f"[{label}] {gp_options or 'default MVGP'}", flush=True)
    record = bt.run_protocol("unicycle", dev, reps=reps, card=card,
                             gp_options=gp_options)
    sim, out = record["sim"], record["out"]
    _check_rollouts(label, record, sim.controller.warm_start)
    ls = out.knl.lengthscale
    moved = float(((ls[:, -1] - ls[:, 0]).abs().amax(-1) > 1e-4)
                  .float().mean())
    o = record["outcomes"]
    outcomes = (f"min clearance {o['min_clearance']:.4f}, mean goal "
                f"distance {o['mean_goal_distance']:.4f}, fraction within "
                f"1.0 of goal {o['frac_within_1']:.4f}, feasible fraction "
                f"{o['feasible']:.4f}")
    print(f"[{label}] {outcomes}, episodes whose lengthscale moved "
          f"{moved:.4f}", flush=True)
    print(f"[{label}] before kernel 2 was rebuilt: "
          f"{EARLIER_OUTCOMES[label]}", flush=True)
    if label in REPEATED:
        rungs, digits = REPEATED[label]
        same = record["refresh_rungs"] == rungs and outcomes == digits
        print(f"[{label}] accepted rungs and outcomes repeat {rungs}, "
              f"{digits}: {same}", flush=True)
        _require(same, f"{label}: rungs or outcomes moved")
    _require(moved > 0.9, f"{label}: the fit did not move the hyperparameters")
    _require(not record["gate_failures"],
             f"{label}: batched-learning outcome gate failed: "
             f"{record['gate_failures']}")
    return record["launches"], record["refresh_rungs"], out


def _adam_device_ms(gp, data, iters=5):
    """Device operations (kernels and copies) and ms of device time per
    Adam iteration of `gp.fit` on `data`, and the fit inverse kernel's part
    of that time, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=data.X.device).manual_seed(2)
    params = gp.init_params(data.X.shape[0], gen, data.X.device,
                            data.X.dtype)
    gp.fit(params, data, training_iter=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gp.fit(params, data, training_iter=iters)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    inverse = sum(e.device_time for e in events
                  if "kinv_logdet_kernel" in e.name)
    return (len(events) / iters, sum(e.device_time for e in events) / 1e3
            / iters, inverse / 1e3 / iters)


def phase_fit_timing(dev, out, configs):
    """ms per Adam iteration of each configuration's fit on one (256, 200)
    buffer cut from the flagship trajectories, timed in turns (forward
    order, then reversed) so that clock drift hits every configuration
    alike; then the default configuration's device time per iteration."""
    sim = bt.unicycle_sim(dev)
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
    ops, dev_ms, inverse_ms = _adam_device_ms(gps["main"], data)
    print(f"[fit] main: {ops:.1f} device operations and {dev_ms:.3f} ms of "
          f"device time per Adam iteration, of which the fit inverse kernel "
          f"{inverse_ms:.3f} ms", flush=True)
    _require(inverse_ms > 0, "the profile shows no fit inverse kernel")
    return ms


def run_pendulum(dev, card, label):
    """The pendulum batch in a configuration of bench_torch's
    PENDULUM_CONFIGS through its protocol (a cold rollout, then a warm one
    of the same inputs, with equal outcomes or it raises): launch counts,
    finiteness, the outcome gates of scripts/check_outcomes.py
    (pendulum_batched_safe and pendulum_batched_cu_safe, with feasible >=
    0.95 for both).  Returns the launch counts, the accepted rungs and
    the walls with the outcomes."""
    tag = f"pendulum {label}"
    print(f"[{tag}] {bt.PENDULUM_CONFIGS[label]}", flush=True)
    record = bt.run_protocol(tag, dev, reps=1, card=card)
    _check_rollouts(tag, record, warm_start=False)
    gates = record["outcomes"]
    print(f"[{tag}] outcomes {gates}", flush=True)
    print(f"[{tag}] before kernel 2 was rebuilt: {EARLIER_OUTCOMES[tag]}",
          flush=True)
    _require(not record["gate_failures"],
             f"{tag}: outcome gate failed: {record['gate_failures']}")
    B, T = record["batch"], record["episode_steps"]
    cold, warm_s = record["first_wall_s"], record["walls_s"][0]
    return record["launches"], record["refresh_rungs"], dict(
        wall_s=cold, steps_per_s=B * T / cold, warm_wall_s=warm_s,
        warm_steps_per_s=B * T / warm_s, **gates)


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
    sim = bt.pendulum_sim(dev, **bt.PENDULUM_CONFIGS["continuous"])._replace(
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
    ipm_ms = sum(e.device_time for e in dev_events
                 if "ipm_kernel" in e.name) / 1e3 / steps
    print(f"[pendulum profile] B={x0s.shape[0]}, {steps} steps without a "
          f"refit: {wall_ms:.3f} ms per step, {ops:.1f} device operations "
          f"and {dev_ms:.3f} ms of device time per step, of which the IPM "
          f"kernel {ipm_ms:.3f} ms (device idle "
          f"{100 * (1 - dev_ms / wall_ms):.1f}% of the unprofiled step)",
          flush=True)
    _require(ipm_ms > 0, "the profile shows no IPM kernel on the device")
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
                device_ms_per_step=dev_ms, ipm_device_ms_per_step=ipm_ms,
                parts=breakdown)


def main():
    dev, card = phase_device()
    phase_build()
    x0s = bt.unicycle_x0s(dev)
    px0s = bt.pendulum_x0s(dev)
    chol = _check_chol_kernels(dev)
    cones = lambda B, seed, **kw: [
        torch.tensor(a, dtype=torch.float32, device=dev)
        for a in _random_cones(B, seed, **kw)]
    ipm = _check_ipm_kernel(dev, "(4, 4, 4)", cones(256, 0),
                            list(_step0_cones(dev, x0s, 1)), cones(1003, 4))
    ipm_p = _check_ipm_kernel(dev, "(4, 3, 3)",
                              cones(256, 2, dims=(3, 3, 1)),
                              list(_pendulum_step0_cones(dev, px0s)),
                              cones(1003, 6, dims=(3, 3, 1)))
    gram = _check_gram_kernel(dev)
    sweep = _check_sweep_kernel(dev)
    dinv = _check_chol_dinv_kernel(dev)
    solve = _check_cholsolve_kernels(dev)
    main_path, main_rungs, out = run_config(dev, card, "main", reps=1)
    configs = dict(main={}, a=dict(fit_inverse="chol", linv_assembly="row"),
                   b=dict(fit_inverse="sweep_full"), c=dict(fused_gram=True))
    abc = {k: run_config(dev, card, f"config {k}", **configs[k])
           for k in "abc"}
    runs = {k: v[0] for k, v in abc.items()}
    phase_fit_timing(dev, out, configs)
    pend = {label: run_pendulum(dev, card, label)
            for label in bt.PENDULUM_CONFIGS}
    runs.update({f"pendulum {k}": v[0] for k, v in pend.items()})
    # (a) refreshes through kernel 8 and the "row" assembly, not kernel 2
    chol["chol_linv"]["accepted_rungs"] = {
        "main": main_rungs, "b": abc["b"][1], "c": abc["c"][1],
        **{f"pendulum {k}": v[1] for k, v in pend.items()}}
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
    print(json.dumps({"pendulum": {k: v[2] for k, v in pend.items()},
                      "pendulum_profile": profile_stats}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
