#!/usr/bin/env python3
"""One-off measurements of the fit inverse kernel (`kinv_logdet`,
csrc/chol.cu) on one NVIDIA card, beyond what chip_smoke.py holds it to.

    python3 probe_kinv_logdet.py [--earlier-csrc DIR]

  1. stages  -- ms of the kernel's stages at (256, 200), by difference:
                two copies of csrc/chol.cu, cut after the factor and logdet
                and after the row assembly, are built and launched on the
                wrapper's buffers like the whole kernel.  A cut copy is
                another compilation, so the shares are those of the cut
                kernels, not a clock inside the shipped one.
  2. ladder  -- trajectory Grams (256, 200) at falling nuggets (rising
                condition numbers): for each block size and for the plain
                version, how many matrices come out finite, and on those
                the distance from the f64 inverse and max|Kinv K - I|.
  3. large   -- ms at (4, 1024), where the working matrix lives in a
                global scratch.
With --earlier-csrc DIR, DIR/chol.cu is a copy of the source as it was
before the kernel was rebuilt on the blocked factor (one column at a
time; entry point kinv_logdet_launch(K, Kinv, logdet, X, A, B, n,
stream)); it is built too and joins 2 and 3.

This probe covers kernel 1 only; the refresh factorization (`chol_linv`,
the other kernel of csrc/chol.cu) has probe_chol_linv.py.
"""
import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from chip_smoke import _cuda_ms, _require, _trajectory_grams, phase_device

NBS = (8, 16, 32, 64)
# (step, nugget): the first is the fit's own conditioning at K = 200 in f32
# (MVGP's nugget is jitter + 10 K eps scale = 2.4e-4 scale)
LADDER = ((0.02, 2.5e-4), (0.02, 1e-4), (0.02, 5e-5), (0.02, 3e-5),
          (0.02, 2e-5), (0.02, 1e-5))


def _nvcc(src: Path, out: Path, include: Path):
    from bayesian_cbf_tpu_torch.ops import _build
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(include), "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _wait(proc, what):
    log, _ = proc.communicate()
    _require(proc.returncode == 0, f"nvcc failed for {what}:\n{log}")


def stage_ms(K, nb):
    from bayesian_cbf_tpu_torch.ops import _build
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    src = (_build.CSRC / "chol.cu").read_text()
    assembly = ("    chol_blocked::linv_rows(A, ld, dinv + b * N * nb, N, nb, "
                "small);\n")
    product = "    chol_blocked::gram_of_rows(A, ld, n, Kinv + b * n * n);\n"
    _require(src.count(assembly) == 1 and src.count(product) == 1,
             "csrc/chol.cu no longer calls its stages as this probe cuts them")
    cuts = {"factor": src.replace(assembly, "").replace(product, ""),
            "assembly": src.replace(product, "")}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in cuts.items():
        path = _build.BUILD_DIR / f"chol_cut_{name}.cu"
        path.write_text(text)
        procs[name] = _nvcc(path, path.with_suffix(".so"), _build.CSRC)
    libs = {"whole": _build.load("chol")}
    for name, proc in procs.items():
        _wait(proc, f"the {name} cut")
        libs[name] = ctypes.CDLL(str(_build.BUILD_DIR / f"chol_cut_{name}.so"))
    B, n, _ = K.shape
    N = ck.padded_order(n, nb)
    Kinv, logdet = torch.empty_like(K), K.new_empty((B,))
    dinv = K.new_empty((B, N, nb))
    stream = torch.cuda.current_stream(K.device).cuda_stream
    ms = {}
    for name, lib in libs.items():
        fn = lib.kinv_logdet_launch
        fn.argtypes = _build._SIGNATURES["chol"]["kinv_logdet_launch"]
        fn.restype = ctypes.c_int

        def launch():
            _build.check(fn(K.data_ptr(), Kinv.data_ptr(), logdet.data_ptr(),
                            dinv.data_ptr(), None, B, n, N, nb, stream),
                         f"kinv_logdet_launch ({name})")

        ms[name] = _cuda_ms(launch, 20)
    return dict(factor_logdet=ms["factor"],
                row_assembly=ms["assembly"] - ms["factor"],
                product=ms["whole"] - ms["assembly"], whole=ms["whole"])


def earlier_kernel(csrc: Path):
    """The kernel as it was before the rebuild, from csrc/chol.cu, as a
    function K -> (Kinv, logdet)."""
    from bayesian_cbf_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "chol_earlier.so"
    _wait(_nvcc(csrc / "chol.cu", out, csrc), "the earlier chol.cu")
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.kinv_logdet_launch.argtypes = [vp] * 5 + [i, i, vp]
    lib.kinv_logdet_launch.restype = i
    lib.chol_uses_smem.argtypes = [i]

    def fn(K):
        B, n, _ = K.shape
        Kinv, logdet, X = torch.empty_like(K), K.new_empty((B,)), \
            torch.empty_like(K)
        a = None if lib.chol_uses_smem(n) else torch.empty_like(K)
        _build.check(lib.kinv_logdet_launch(
            K.data_ptr(), Kinv.data_ptr(), logdet.data_ptr(), X.data_ptr(),
            None if a is None else a.data_ptr(), B, n,
            torch.cuda.current_stream(K.device).cuda_stream),
            "kinv_logdet_launch (earlier)")
        return Kinv, logdet

    return fn


def ladder(dev, routes):
    B, n = 256, 200
    for step, nug in LADDER:
        K = torch.tensor(_trajectory_grams(B, n, seed=7, step=step, nug=nug),
                         dtype=torch.float32, device=dev)
        K64 = K.double()
        eig = torch.linalg.eigvalsh(K64)
        kappa = eig[:, -1] / eig[:, 0]
        exact = torch.linalg.inv(K64)
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        print(f"[ladder] step {step} nugget {nug}: condition number median "
              f"{float(kappa.median()):.2e} max {float(kappa.max()):.2e}",
              flush=True)
        for name, fn in routes.items():
            Kinv, ld = fn(K)
            ok = torch.isfinite(Kinv).all(-1).all(-1) & torch.isfinite(ld)
            line = f"[ladder]   {name}: finite {int(ok.sum())}/{B}"
            if ok.any():
                Kd = Kinv.double()[ok]
                rel = ((Kd - exact[ok]).abs().amax((-1, -2))
                       / exact[ok].abs().amax((-1, -2)))
                res = (Kd @ K64[ok] - eye).abs().amax((-1, -2))
                line += (f"; on those: distance from the f64 inverse / its "
                         f"largest entry median {float(rel.median()):.2e} max "
                         f"{float(rel.max()):.2e}, max|Kinv K - I| median "
                         f"{float(res.median()):.2e} max {float(res.max()):.2e}")
            print(line, flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier-csrc", type=Path, default=None)
    args = ap.parse_args()
    dev, _ = phase_device()
    from bayesian_cbf_tpu_torch.ops import chol_kernels as ck
    K = torch.tensor(_trajectory_grams(256, 200, seed=7),
                     dtype=torch.float32, device=dev)
    for nb in (16, 32):
        print(f"[stages] (256, 200) nb {nb}: ms {stage_ms(K, nb)}", flush=True)
    routes = {f"nb {nb}": (lambda K, nb=nb: ck.kinv_logdet(K, nb))
              for nb in NBS}
    routes["plain"] = ck.kinv_logdet_plain
    if args.earlier_csrc:
        routes["earlier kernel"] = earlier_kernel(args.earlier_csrc)
    ladder(dev, routes)
    big = torch.tensor(_trajectory_grams(4, 1024, seed=1024),
                       dtype=torch.float32, device=dev)
    for shape, M in (("(256, 200)", K), ("(4, 1024)", big)):
        ms = {name: round(_cuda_ms(lambda: fn(M), 5), 4)
              for name, fn in routes.items()}
        print(f"[large] {shape}: ms {ms}", flush=True)


if __name__ == "__main__":
    main()
