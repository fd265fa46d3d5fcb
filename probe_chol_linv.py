#!/usr/bin/env python3
"""One-off measurements of the cache refresh's factorization kernel
(`chol_linv`, csrc/chol.cu) on one NVIDIA card, beyond what chip_smoke.py
holds it to.

    python3 probe_chol_linv.py [--earlier-csrc DIR]

  1. stages -- ms of the kernel's stages at (256, 200), by difference:
               three copies of csrc/chol.cu, cut after the factor, after
               L's copy-out and after the row assembly, are built and
               launched on the wrapper's buffers like the whole kernel.  A
               cut copy is another compilation, so the shares are those of
               the cut kernels, not a clock inside the shipped one.
  2. ladder -- trajectory Grams (256, 200) at falling nuggets (rising
               condition numbers): for each block size and for the plain
               version, how many matrices the refresh's ladder would
               accept (L and L^{-1} finite, max|L^{-1}| < 1e6), and on
               those the distance of L^{-1} from the f64 L^{-1}.
  3. rungs  -- the flagship batch and both pendulum batches once each (as
               chip_smoke.py runs them), keeping the Gram of every cache
               refresh; then, on those Grams, the episodes per accepted
               rung of the jitter ladder under each block size and under
               the plain version.
With --earlier-csrc DIR, DIR holds chol.cu, chol_blocked.cu,
chol_blocked.cuh and cholsolve.cu as they were before kernel 2 was rebuilt
on the blocked factor (one column at a time; entry point
chol_linv_launch(K, L, Linv, a_scratch, B, n, stream)).  Its kernel 2 is
built too, is timed, and joins 2 and 3; and
  4. bits   -- kernels 1, 8 and 6 (`kinv_logdet`, `chol_dinv`,
               `cholsolve_logdet`) built from DIR and from csrc/: their
               outputs compared bit for bit.
"""
import argparse
import contextlib
import ctypes
from pathlib import Path

import numpy as np
import torch

import bench_torch as bt
from chip_smoke import (_cuda_ms, _require, _spd, _trajectory_grams,
                        phase_device)
from probe_kinv_logdet import LADDER, _nvcc, _wait

NBS = (8, 16, 32)


def stage_ms(K, nb):
    from bayesian_cbf_tpu_torch.ops import _build
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    src = (_build.CSRC / "chol.cu").read_text()
    lines = dict(
        l_out="    store_lower(A, ld, n, L + b * n * n);\n",
        assembly="    chol_blocked::linv_rows(A, ld, D, N, nb, small);\n",
        linv_out="    store_lower(A, ld, n, Linv + b * n * n);\n")
    _require(all(src.count(t) == 1 for t in lines.values()),
             "csrc/chol.cu no longer calls its stages as this probe cuts them")

    def without(*names):
        text = src
        for k in names:
            text = text.replace(lines[k], "")
        return text

    cuts = {"factor": without("l_out", "assembly", "linv_out"),
            "l_out": without("assembly", "linv_out"),
            "assembly": without("linv_out")}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in cuts.items():
        path = _build.BUILD_DIR / f"chol_linv_cut_{name}.cu"
        path.write_text(text)
        procs[name] = _nvcc(path, path.with_suffix(".so"), _build.CSRC)
    libs = {"whole": _build.load("chol")}
    for name, proc in procs.items():
        _wait(proc, f"the {name} cut")
        libs[name] = ctypes.CDLL(
            str(_build.BUILD_DIR / f"chol_linv_cut_{name}.so"))
    B, n, _ = K.shape
    N = ck.padded_order(n, nb)
    L, Linv = torch.empty_like(K), torch.empty_like(K)
    dinv = K.new_empty((B, N, nb))
    stream = torch.cuda.current_stream(K.device).cuda_stream
    ms = {}
    for name, lib in libs.items():
        fn = lib.chol_linv_launch
        fn.argtypes = _build._SIGNATURES["chol"]["chol_linv_launch"]
        fn.restype = ctypes.c_int

        def launch():
            _build.check(fn(K.data_ptr(), L.data_ptr(), Linv.data_ptr(),
                            dinv.data_ptr(), None, B, n, N, nb, stream),
                         f"chol_linv_launch ({name})")

        ms[name] = _cuda_ms(launch, 20)
    return dict(factor=ms["factor"], l_copy_out=ms["l_out"] - ms["factor"],
                row_assembly=ms["assembly"] - ms["l_out"],
                linv_copy_out=ms["whole"] - ms["assembly"], whole=ms["whole"])


def earlier_libs(csrc: Path):
    """chol, chol_blocked and cholsolve as they were, built from `csrc`
    and loaded beside this checkout's."""
    from bayesian_cbf_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = ("chol", "chol_blocked", "cholsolve")
    outs = {k: _build.BUILD_DIR / f"{k}_earlier.so" for k in names}
    procs = {k: _nvcc(csrc / f"{k}.cu", outs[k], csrc) for k in names}
    libs = {}
    for k in names:
        _wait(procs[k], f"the earlier {k}.cu")
        libs[k] = ctypes.CDLL(str(outs[k]))
        for fn, argtypes in _build._SIGNATURES[k].items():
            if hasattr(libs[k], fn) and "chol_linv" not in fn:
                getattr(libs[k], fn).argtypes = argtypes
                getattr(libs[k], fn).restype = ctypes.c_int
    # the wrappers ask the library by today's name
    libs["chol"].chol_matrix_in_smem = libs["chol"].kinv_logdet_uses_smem
    libs["chol"].chol_matrix_in_smem.argtypes = [ctypes.c_int] * 2
    return libs


def earlier_chol_linv(lib):
    """Kernel 2 as it was, as a function K -> (L, Linv)."""
    from bayesian_cbf_tpu_torch.ops import _build
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.chol_linv_launch.argtypes = [vp] * 4 + [i, i, vp]
    lib.chol_linv_launch.restype = i
    lib.chol_uses_smem.argtypes = [i]

    def fn(K):
        B, n, _ = K.shape
        L, Linv = torch.empty_like(K), torch.empty_like(K)
        a = None if lib.chol_uses_smem(n) else torch.empty_like(K)
        _build.check(lib.chol_linv_launch(
            K.data_ptr(), L.data_ptr(), Linv.data_ptr(),
            None if a is None else a.data_ptr(), B, n,
            torch.cuda.current_stream(K.device).cuda_stream),
            "chol_linv_launch (earlier)")
        return L, Linv

    return fn


@contextlib.contextmanager
def loaded(libs):
    """While active, the wrappers of ops/chol_kernels.py launch `libs`."""
    from bayesian_cbf_tpu_torch.ops import _build
    kept = {k: _build.load(k) for k in libs}
    _build._LIBS.update(libs)
    try:
        yield
    finally:
        _build._LIBS.update(kept)


def bits(dev, libs):
    """Kernels 1, 8 and 6 from the earlier sources against this
    checkout's, bit for bit: in shared memory and in the global scratch,
    on well-conditioned SPD and on trajectory Grams."""
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    for B, n in ((256, 200), (64, 50), (4, 260)):
        for what, M in (("SPD", _spd(B, n, n)),
                        ("trajectory Grams", _trajectory_grams(B, n, n))):
            K = torch.tensor(M, dtype=torch.float32, device=dev)
            R = torch.tensor(np.random.default_rng(n).normal(size=(B, n, 16)),
                             dtype=torch.float32, device=dev)
            calls = dict(
                kinv_logdet=lambda: ck.kinv_logdet(K),
                kinv_logdet_nb32=lambda: ck.kinv_logdet(K, 32),
                chol_dinv=lambda: ck.chol_dinv(K),
                chol_dinv_nb16=lambda: ck.chol_dinv(K, 16),
                cholsolve_logdet=lambda: ck.cholsolve_logdet(K, R))
            now = {k: f() for k, f in calls.items()}
            with loaded(libs):
                then = {k: f() for k, f in calls.items()}
            torch.cuda.synchronize()
            same = {k: all(torch.equal(a, b) for a, b in zip(now[k], then[k]))
                    for k in calls}
            print(f"[bits] ({B}, {n}) {what}: outputs equal bit for bit to "
                  f"the earlier sources' build: {same}", flush=True)
            _require(all(same.values()), f"bits moved: {same}")


def ladder(dev, routes):
    B, n = 256, 200
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    for step, nug in LADDER:
        K = torch.tensor(_trajectory_grams(B, n, seed=7, step=step, nug=nug),
                         dtype=torch.float32, device=dev)
        K64 = K.double()
        eig = torch.linalg.eigvalsh(K64)
        kappa = eig[:, -1] / eig[:, 0]
        L64 = torch.linalg.cholesky(K64)
        exact = torch.linalg.solve_triangular(L64, eye.expand_as(L64),
                                              upper=False)
        print(f"[ladder] step {step} nugget {nug}: condition number median "
              f"{float(kappa.median()):.2e} max {float(kappa.max()):.2e}",
              flush=True)
        for name, fn in routes.items():
            L, Linv = fn(K)
            finite = (torch.isfinite(L).all(-1).all(-1)
                      & torch.isfinite(Linv).all(-1).all(-1))
            ok = finite & (Linv.abs().amax((-1, -2)) < 1e6)
            line = (f"[ladder]   {name}: finite {int(finite.sum())}/{B}, "
                    f"accepted {int(ok.sum())}/{B}")
            if ok.any():
                Ld = Linv.double()[ok]
                rel = ((Ld - exact[ok]).abs().amax((-1, -2))
                       / exact[ok].abs().amax((-1, -2)))
                res = (Ld @ L.double()[ok] - eye).abs().amax((-1, -2))
                line += (f"; on those: distance from the f64 L^-1 / its "
                         f"largest entry median {float(rel.median()):.2e} max "
                         f"{float(rel.max()):.2e}, max|Linv L - I| median "
                         f"{float(res.median()):.2e} max {float(res.max()):.2e}")
            print(line, flush=True)


@contextlib.contextmanager
def refresh_grams(into):
    """While active, append to the list `into` the masked Gram of every
    cache refresh: the argument of `MVGP.factor_ladder`."""
    from bayesian_cbf_tpu_torch.models.mvgp import MVGP
    inner = MVGP.factor_ladder

    def recording(self, K):
        into.append(K)
        return inner(self, K)

    MVGP.factor_ladder = recording
    try:
        yield
    finally:
        MVGP.factor_ladder = inner


@contextlib.contextmanager
def refreshing_through(fn):
    """While active, the "kernel" assembly of `cholinv.chol_inv_fwd`, which
    the refresh's ladder factors through, computes K -> (L, L^{-1}) by
    `fn`."""
    from bayesian_cbf_tpu_torch.ops import cholinv
    kept = cholinv.chol_linv
    cholinv.chol_linv = fn
    try:
        yield
    finally:
        cholinv.chol_linv = kept


def rungs(dev, card, routes):
    from bayesian_cbf_tpu_torch.ops.chol_kernels import LINV_NB
    runs = [("main", "unicycle")] + [(f"pendulum {k}", f"pendulum {k}")
                                     for k in bt.PENDULUM_CONFIGS]
    for label, workload in runs:
        grams = []
        with refresh_grams(grams):
            record = bt.run_protocol(workload, dev, reps=0, card=card)
        sim = record["sim"]
        gp = (getattr(sim, "learned_dynamics", None) or sim.learned).gp
        counts = {}
        for name, fn in routes.items():
            with refreshing_through(fn):
                counts[name] = sum(gp.factor_ladder(K)[2]
                                   for K in grams).tolist()
        _require(counts[f"nb {LINV_NB}"] == record["refresh_rungs"],
                 f"{label}: the run counted {record['refresh_rungs']}, its "
                 f"Grams give {counts}")
        print(f"[rungs] {label}: {len(grams)} cache refreshes of "
              f"{record['batch']} episodes (outcomes {record['outcomes']}); "
              f"episodes per accepted rung (first / + 1e-5 scale / + 1e-2 "
              f"scale): {counts}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier-csrc", type=Path, default=None)
    args = ap.parse_args()
    dev, card = phase_device()
    from bayesian_cbf_tpu_torch.ops import _build
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    _build.build_all(_build.KERNEL_SOURCES)
    K = torch.tensor(_trajectory_grams(256, 200, seed=7),
                     dtype=torch.float32, device=dev)
    for nb in NBS:
        print(f"[stages] (256, 200) nb {nb}: ms {stage_ms(K, nb)}", flush=True)
    routes = {f"nb {nb}": (lambda K, nb=nb: ck.chol_linv(K, nb))
              for nb in NBS}
    routes["plain"] = ck.chol_linv_plain
    if args.earlier_csrc:
        libs = earlier_libs(args.earlier_csrc)
        bits(dev, libs)
        routes["earlier kernel"] = earlier_chol_linv(libs["chol"])
    ladder(dev, routes)
    big = torch.tensor(_trajectory_grams(4, 1024, seed=1024),
                       dtype=torch.float32, device=dev)
    for shape, M in (("(256, 200)", K), ("(4, 1024)", big)):
        ms = {name: round(_cuda_ms(lambda: fn(M), 5), 4)
              for name, fn in routes.items()}
        print(f"[large] {shape}: ms {ms}", flush=True)
    rungs(dev, card, routes)


if __name__ == "__main__":
    main()
