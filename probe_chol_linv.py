#!/usr/bin/env python3
"""One-off measurements of the cache refresh's factorization kernel
(`chol_linv`, csrc/chol.cu) and of the solve kernels 6 and 7
(csrc/cholsolve.cu) on one NVIDIA card, beyond what chip_smoke.py holds
them to.

    python3 probe_chol_linv.py [--earlier-csrc DIR] [--solve-only]

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
chol_blocked.cuh and cholsolve.cu of an earlier commit, built beside this
checkout's; and
  4. bits   -- kernels 1, 8 and 6 (`kinv_logdet`, `chol_dinv`,
               `cholsolve_logdet`) built from DIR and from csrc/: their
               outputs compared bit for bit, but for kernel 6's solution,
               held to a tolerance when the earlier sweeps summed in
               another order (`solve_within_bar`);
  5. solve  -- kernel 7 (`solve_with_factor`) and kernel 6 at (256, 200,
               16) and (4, 1024, 16) on trajectory Grams: each solution's
               distance from the f64 solve, ms per call and device ms per
               launch, for this checkout's kernels, DIR's and the kernel-7
               designs measured and dropped (SOLVE_VARIANTS, and other
               column groups than `solve_groups` picks);
  6. phases -- kernel 7 by phase: a copy that stamps one block's warps at
               every tile it takes (globaltimer), and cut copies without
               the triangles, the updates or the tile copies;
  7. usage  -- registers, stack and spills of kernel 6 in DIR's and this
               checkout's cholsolve.cu, with and without its sweeps (cut
               copies): where its local memory comes from.
If DIR's chol.cu still has the column-at-a-time kernel 2 (entry point
chol_linv_launch(K, L, Linv, a_scratch, B, n, stream), before kernel 2 was
rebuilt on the blocked factor), that kernel is built too, is timed, and
joins 2 and 3.  --solve-only runs 5-7 alone (with 4 for kernel 6).
"""
import argparse
import contextlib
import ctypes
from pathlib import Path

import numpy as np
import torch

import bench_torch as bt
from chip_smoke import (_cuda_ms, _device_ms, _require, _spd,
                        _trajectory_grams, phase_device)
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
    and loaded beside this checkout's; where an entry point has changed
    since, the wrappers' name or arguments call the earlier one."""
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
    if not hasattr(libs["chol"], "chol_matrix_in_smem"):
        libs["chol"].chol_matrix_in_smem = libs["chol"].kinv_logdet_uses_smem
        libs["chol"].chol_matrix_in_smem.argtypes = [ctypes.c_int] * 2
    cs = libs["cholsolve"]
    if not hasattr(cs, "solve_with_factor_width"):
        # a plan for both kernels (last argument: 1 for kernel 6)
        plan = cs.cholsolve_plan
        plan.argtypes = [ctypes.c_int] * 4
        cs.cholsolve_plan = lambda N, nb, r: plan(N, nb, r, 1)
        cs.earlier_plan = plan
    return libs


def earlier_solve_with_factor(lib):
    """Kernel 7 as it was before column groups (one block per matrix, the
    RHS in a global scratch where it did not fit), as a function
    (L, Dinv, RHS, nb) -> solution."""
    from bayesian_cbf_tpu_torch.ops import _build
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.solve_with_factor_launch
    fn.argtypes = [vp] * 5 + [i] * 5 + [vp]
    fn.restype = i

    def solve(L, Dinv, R, nb):
        B, N = L.shape[0], L.shape[-1]
        n, r = R.shape[1:]
        sol = torch.empty((B, n, r), dtype=L.dtype, device=L.device)
        x = None if lib.earlier_plan(N, nb, r, 0) & 2 else \
            torch.empty((B, N, r), dtype=L.dtype, device=L.device)
        _build.check(fn(L.data_ptr(), Dinv.data_ptr(), R.data_ptr(),
                        sol.data_ptr(), None if x is None else x.data_ptr(),
                        B, n, N, nb, r,
                        torch.cuda.current_stream(L.device).cuda_stream),
                     "solve_with_factor_launch (earlier)")
        return sol

    return solve


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


# Kernel 6's and 7's solution against an earlier build whose sweeps summed
# in another order (this checkout's backward sweep adds the blocks from
# the last one down, the left-looking one from the first one up): on SPD
# (condition ~10) relative 1e-4, as against plain; on trajectory Grams
# (condition ~1e6, where roundoff is amplified) no farther from the f64
# solve than 3x the earlier build's, with 1e-3 of slack, as
# chip_smoke.py holds the kernels against plain.
def solve_within_bar(got, then, exact, what):
    rel = float((got.double() - then.double()).abs().max()
                / then.double().abs().max())
    d_now = float((got.double() - exact).abs().max() / exact.abs().max())
    d_then = float((then.double() - exact).abs().max() / exact.abs().max())
    ok = rel < 1e-4 if what == "SPD" else d_now <= 3.0 * d_then + 1e-3
    return ok, dict(relative=f"{rel:.2e}", from_f64=f"{d_now:.3e}",
                    earlier_from_f64=f"{d_then:.3e}")


def bits(dev, libs, kernels=("kinv_logdet", "kinv_logdet_nb32", "chol_dinv",
                             "chol_dinv_nb16", "cholsolve_logdet")):
    """Kernels 1, 8 and 6 from the earlier sources against this
    checkout's, bit for bit (kernel 6's solution and kernel 7's to
    `solve_within_bar`): in shared memory and in the global scratch, on
    well-conditioned SPD and on trajectory Grams."""
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    earlier7 = earlier_solve_with_factor(libs["cholsolve"]) \
        if hasattr(libs["cholsolve"], "earlier_plan") else None
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
            calls = {k: calls[k] for k in kernels}
            now = {k: f() for k, f in calls.items()}
            with loaded(libs):
                then = {k: f() for k, f in calls.items()}
            torch.cuda.synchronize()
            same = {k: all(torch.equal(a, b) for a, b in zip(now[k], then[k]))
                    for k in calls}
            near = {}
            if "cholsolve_logdet" in calls:
                exact = torch.linalg.solve(K.double(), R.double())
                same["cholsolve_logdet"] = all(
                    torch.equal(a, b) for a, b in
                    zip(now["cholsolve_logdet"][1:], then["cholsolve_logdet"][1:]))
                near["cholsolve_logdet sol"] = solve_within_bar(
                    now["cholsolve_logdet"][0], then["cholsolve_logdet"][0],
                    exact, what)
                if earlier7 is not None:
                    L, Dinv = now["cholsolve_logdet"][1:3]
                    near["solve_with_factor"] = solve_within_bar(
                        ck.solve_with_factor(L, Dinv, R),
                        earlier7(L, Dinv, R, ck.NB_BLK), exact, what)
            print(f"[bits] ({B}, {n}) {what}: outputs equal bit for bit to "
                  f"the earlier sources' build: {same}; solutions: {near}",
                  flush=True)
            _require(all(same.values()), f"bits moved: {same}")
            _require(all(ok for ok, _ in near.values()),
                     f"solutions beyond the bar: {near}")


# Kernel 7 designs measured and dropped, as text changes to a copy of
# csrc/cholsolve.cu (each pair: text, replacement).
SOLVE_VARIANTS = {
    "3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "4 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    "128 threads": [("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 128;")],
    "512 threads": [("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 512;")],
    # ring slots sized so that three blocks share an SM's 228 KB (the
    # runtime keeps 1 KB of it per block)
    "tiles for 3 blocks per SM": [
        ("((long long)kMaxSmemBytes / (long long)sizeof(float) -",
         "((long long)(233472 / 3 - 1024) / (long long)sizeof(float) -")],
}
SOLVE_SHAPES = ((256, 200, 16), (4, 1024, 16))


def _build_copies(texts):
    """Compile each {name: source text} into build/kernels/ (one nvcc each,
    all at once); return {name: (library, ptxas report)}."""
    from bayesian_cbf_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        slug = "".join(ch if ch.isalnum() else "_" for ch in name)
        path = _build.BUILD_DIR / f"cholsolve_{slug}.cu"
        path.write_text(text)
        procs[name] = (path.with_suffix(".so"),
                       _nvcc(path, path.with_suffix(".so"), _build.CSRC))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        _require(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        out[name] = (ctypes.CDLL(str(so)), log)
    return out


def variant_libs():
    from bayesian_cbf_tpu_torch.ops import _build
    src = (_build.CSRC / "cholsolve.cu").read_text()
    texts = {}
    for name, edits in SOLVE_VARIANTS.items():
        text = src
        for a, b in edits:
            _require(text.count(a) == 1, f"variant {name}: no '{a}'")
            text = text.replace(a, b)
        texts[name] = text
    libs = {}
    for name, (lib, _) in _build_copies(texts).items():
        for fn, argtypes in _build._SIGNATURES["cholsolve"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def solve(dev, libs=None):
    """Kernels 7 and 6 on trajectory Grams at SOLVE_SHAPES: distance from
    the f64 solve, ms per call and device ms per launch, against the
    earlier build's (libs) and the dropped designs."""
    from bayesian_cbf_tpu_torch.ops import _build
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    nb = ck.NB_BLK
    variants = variant_libs()
    earlier7 = earlier_solve_with_factor(libs["cholsolve"]) \
        if libs and hasattr(libs["cholsolve"], "earlier_plan") else None
    name7, name6 = "solve_with_factor_kernel", "cholsolve_kernel"
    for B, n, r in SOLVE_SHAPES:
        K = torch.tensor(_trajectory_grams(B, n, seed=n + 3),
                         dtype=torch.float32, device=dev)
        R = torch.tensor(np.random.default_rng(n).normal(size=(B, n, r)),
                         dtype=torch.float32, device=dev)
        exact = torch.linalg.solve(K.double(), R.double())
        sol6, L, Dinv, _ = ck.cholsolve_logdet(K, R, nb)
        width = _build.load("cholsolve").solve_with_factor_width(
            ck.padded_order(n, nb), nb)
        groups = ck.solve_groups(B, r, ck._sm_count(dev), width)[0]
        routes = {"kernel 7": (name7, lambda: ck._launch_solve(
            L, Dinv, R, nb))}
        for g in (1, 2, 4):
            if g != groups:
                routes[f"kernel 7, {g} column groups"] = (
                    name7, lambda g=g: ck._launch_solve(L, Dinv, R, nb, g))
        for vname, lib in variants.items():
            def run(lib=lib):
                with loaded({"cholsolve": lib}):
                    return ck._launch_solve(L, Dinv, R, nb)
            routes[vname] = (name7, run)
        if earlier7 is not None:
            routes["earlier kernel 7"] = (
                name7, lambda: earlier7(L, Dinv, R, nb))
        routes["kernel 6"] = (name6, lambda: ck.cholsolve_logdet(K, R, nb)[0])
        if libs:
            def run6():
                with loaded(libs):
                    return ck.cholsolve_logdet(K, R, nb)[0]
            routes["earlier kernel 6"] = (name6, run6)
        stats = {}
        for rname, (kname, fn) in routes.items():
            got = fn()
            torch.cuda.synchronize()
            d = float((got.double() - exact).abs().max() / exact.abs().max())
            same = torch.equal(got.view(torch.int32), sol6.view(torch.int32))
            ms = _cuda_ms(fn, 20)
            dev_ms = _device_ms(fn, kname, 20)
            stats[rname] = dict(ms=round(ms, 4), device_ms=round(dev_ms, 4),
                                from_f64=f"{d:.3e}", kernel6_bits=same)
            print(f"[solve] ({B}, {n}, {r}) {rname}: {stats[rname]}",
                  flush=True)
            if "earlier" not in rname:
                _require(same, f"{rname} moved kernel 6's bits")


def _gt():
    return ("([]() { unsigned long long t; asm volatile(\"mov.u64 %0, "
            "%%globaltimer;\" : \"=l\"(t)); return t; })()")


def phases(dev):
    """Kernel 7's time by phase: a copy of cholsolve.cu that stamps, in
    block `g_probe`, each warp's arrival at every take, the end of its
    cp.async wait and the block's release (globaltimer, ns); and cut
    copies without the triangles, the updates or the tile copies."""
    from bayesian_cbf_tpu_torch.ops import _build
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    src = (_build.CSRC / "cholsolve.cu").read_text()
    take = ("    __device__ const float* take() {\n"
            "        cp_async_wait<kStages - 2>();\n"
            "        __syncthreads();\n")
    head = ("    const int b = blockIdx.x / groups, g = blockIdx.x - b * "
            "groups;\n")
    tail = "    float* S = sol + (size_t)b * n * r + c0;\n"
    for t in (take, head, tail):
        _require(src.count(t) == 1, f"cholsolve.cu changed: no '{t}'")
    stamped = (
        "    __device__ const float* take() {\n"
        f"        const unsigned long long ta = {_gt()};\n"
        "        cp_async_wait<kStages - 2>();\n"
        f"        const unsigned long long tw = {_gt()};\n"
        "        __syncthreads();\n"
        f"        const unsigned long long tp = {_gt()};\n"
        "        if (blockIdx.x == g_probe && (threadIdx.x & 31) == 0 &&\n"
        "            taken < 64) {\n"
        "            unsigned long long* q =\n"
        "                g_ph + (taken * 8 + (threadIdx.x >> 5)) * 3;\n"
        "            q[0] = ta; q[1] = tw; q[2] = tp;\n        }\n")
    text = src.replace("namespace {\n", "__device__ unsigned long long "
                       "g_ph[64 * 8 * 3 + 2];\n__device__ int g_probe;\n"
                       "namespace {\n", 1).replace(take, stamped)
    text = text.replace(head, head + "    if (blockIdx.x == g_probe && "
                        f"threadIdx.x == 0) g_ph[64 * 8 * 3] = {_gt()};\n")
    text = text.replace(tail, "    if (blockIdx.x == g_probe && "
                        f"threadIdx.x == 0) g_ph[64 * 8 * 3 + 1] = {_gt()};\n"
                        + tail)
    text += ('\nextern "C" int phases_read(void* d) { return (int)'
             'cudaMemcpyFromSymbol(d, g_ph, sizeof(g_ph)); }\n'
             'extern "C" int phases_probe(int b) { return (int)'
             'cudaMemcpyToSymbol(g_probe, &b, sizeof(int)); }\n')
    tri = "for (int it = threadIdx.x; it < nb * nq; it += blockDim.x)"
    upd = "for (int it = threadIdx.x; it < G * nq; it += blockDim.x)"
    cpy = "    while (i < rows) {"
    for t in (tri, upd, cpy):
        _require(t in src, f"cholsolve.cu changed: no '{t}'")
    no_tri = (tri, tri.replace("it < nb * nq", "it < 0"))
    no_upd = (upd, upd.replace("it < G * nq", "it < 0"))
    no_cpy = (cpy, "    while (i < rows && false) {")
    cuts = {"whole": [], "no triangles": [no_tri], "no updates": [no_upd],
            "no triangles, no updates": [no_tri, no_upd],
            "no tile copies": [no_cpy],
            "no tile copies, triangles, updates": [no_cpy, no_tri, no_upd]}
    texts = {"stamped": text}
    for name, edits in cuts.items():
        t = src
        for a, b in edits:
            t = t.replace(a, b)
        texts[f"cut: {name}"] = t
    libs = {}
    for name, (lib, _) in _build_copies(texts).items():
        for fn, argtypes in _build._SIGNATURES["cholsolve"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    stamped_lib = libs.pop("stamped")
    stamped_lib.phases_read.argtypes = [ctypes.c_void_p]
    stamped_lib.phases_probe.argtypes = [ctypes.c_int]
    for B, n, r in SOLVE_SHAPES:
        K = torch.tensor(_trajectory_grams(B, n, seed=n + 3),
                         dtype=torch.float32, device=dev)
        R = torch.tensor(np.random.default_rng(n).normal(size=(B, n, r)),
                         dtype=torch.float32, device=dev)
        _, L, Dinv, _ = ck.cholsolve_logdet(K, R)
        ms = {}
        for name, lib in libs.items():
            with loaded({"cholsolve": lib}):
                ms[name] = round(_device_ms(
                    lambda: ck._launch_solve(L, Dinv, R, ck.NB_BLK),
                    "solve_with_factor_kernel", 20), 4)
        print(f"[phases] ({B}, {n}, {r}) device ms of cut copies: {ms}",
              flush=True)
        stamped_lib.phases_probe(0)
        with loaded({"cholsolve": stamped_lib}):
            for _ in range(3):
                ck._launch_solve(L, Dinv, R, ck.NB_BLK)
            torch.cuda.synchronize()
        buf = np.zeros(64 * 8 * 3 + 2, dtype=np.uint64)
        stamped_lib.phases_read(buf.ctypes.data)
        t0, t1 = int(buf[-2]), int(buf[-1])
        ph = buf[:-2].reshape(64, 8, 3).astype(np.int64)
        ntake = int(np.sum(ph[:, 0, 2] > 0))
        rows, last = [], t0
        for k in range(ntake):
            a, w, p = ph[k, :, 0], ph[k, :, 1], ph[k, :, 2]
            ok = a > 0
            rows.append(f"{(a[ok].max() - last) / 1e3:.2f}/"
                        f"{(a[ok].min() - last) / 1e3:.2f}/"
                        f"{(w[ok] - a[ok]).max() / 1e3:.2f}")
            last = p[ok].max()
        print(f"[phases] ({B}, {n}, {r}) block 0: {(t1 - t0) / 1e3:.2f} us, "
              f"{ntake} takes recorded; per phase, us: slowest warp / "
              f"fastest warp / longest cp.async wait: {'; '.join(rows)}",
              flush=True)


def usage(csrc_then=None):
    """Kernel 6's registers, stack and spills, with and without its sweeps
    (cut copies of cholsolve.cu), in this checkout and in `csrc_then`."""
    from bayesian_cbf_tpu_torch.ops import _build
    cuts = {"now": ((_build.CSRC / "cholsolve.cu").read_text(),
                    "        sweeps_in_place<VEC>(A, ld, Db, N, nb, ts, X, T);\n")}
    if csrc_then is not None:
        cuts["earlier"] = ((csrc_then / "cholsolve.cu").read_text(),
                           "    sweeps(A, ld, Db, N, nb, r, X, T);\n")
    texts = {}
    for when, (text, call) in cuts.items():
        _require(call in text, f"the {when} cholsolve.cu calls no '{call}'")
        texts[f"{when}, whole"] = text
        texts[f"{when}, without sweeps"] = text.replace(call, "")
    for name, (_, log) in _build_copies(texts).items():
        for u in _build.parse_ptxas_usage(log):
            if u["kernel"].startswith("cholsolve_kernel"):
                print(f"[usage] {name}: {u}", flush=True)


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

    def recording(self, K, **kw):
        into.append(K)
        return inner(self, K, **kw)

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
    ap.add_argument("--solve-only", action="store_true")
    args = ap.parse_args()
    dev, card = phase_device()
    from bayesian_cbf_tpu_torch.ops import _build
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    _build.build_all(_build.KERNEL_SOURCES)
    libs = earlier_libs(args.earlier_csrc) if args.earlier_csrc else None
    if args.solve_only:
        if libs:
            bits(dev, libs, kernels=("cholsolve_logdet",))
        solve(dev, libs)
        phases(dev)
        usage(args.earlier_csrc)
        return
    K = torch.tensor(_trajectory_grams(256, 200, seed=7),
                     dtype=torch.float32, device=dev)
    for nb in NBS:
        print(f"[stages] (256, 200) nb {nb}: ms {stage_ms(K, nb)}", flush=True)
    routes = {f"nb {nb}": (lambda K, nb=nb: ck.chol_linv(K, nb))
              for nb in NBS}
    routes["plain"] = ck.chol_linv_plain
    if libs:
        bits(dev, libs)
        if hasattr(libs["chol"], "chol_uses_smem"):
            routes["earlier kernel"] = earlier_chol_linv(libs["chol"])
    solve(dev, libs)
    phases(dev)
    usage(args.earlier_csrc)
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
