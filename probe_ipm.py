#!/usr/bin/env python3
"""Kernel 3, the IPM (csrc/ipm.cu), against an earlier build of itself on
one NVIDIA card: the instantiations the two builds share must give the
same bits.

    python3 probe_ipm.py --earlier-csrc DIR
    python3 probe_ipm.py --contraction

DIR holds an earlier ipm.cu with the same entry points (ipm_launch,
ipm_group_width).  It is built beside this checkout's kernel into
build/kernels/ and loaded with ctypes.  For each shape both instantiate,
both builds solve the same problems and their x, S and Z are held equal
bit for bit (torch.equal on the int32 views): random cones of the shape
at B = 256 and 1003, the paths' real cones at B = 256 (the flagship's,
the mean CBF's half-spaces, the pendulum's and the obstacle-free step-0
cones, the ground-truth and mean-CLF QPs' cones), each cold (25
iterations) and warm (15, from the plain version's cold solution shifted
into the interior, on data moved by 1e-3), and the first 32 real problems
launched one at a time.  Then both kernels are timed in turns (earlier,
this, this, earlier; CUDA events, 50 launches each) on the real cones.

--contraction builds csrc/ipm_exact.cu (the car QP's shape, built with
-fmad=false) a second time with contracted multiply-adds and prints, for
five sets of 256 car-QP problems about the car's start, each build's
median distance from an f64 solve (25 cold iterations) over the plain
f32 version's: the measurement behind building that shape without
contraction.
"""
import argparse
import ctypes
from pathlib import Path

import torch

import bench_torch as bt
from chip_smoke import (_cuda_ms, _random_cones, _require, _step0_cones,
                        _pendulum_step0_cones, phase_device)
from probe_kinv_logdet import _nvcc, _wait

_VP, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_earlier(csrc: Path):
    """The earlier ipm.cu built with this checkout's flags, loaded."""
    from bayesian_cbf_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "ipm_earlier.so"
    proc = _nvcc(csrc / "ipm.cu", out, csrc)
    _wait(proc, "the earlier ipm.cu")
    lib = ctypes.CDLL(str(out))
    lib.ipm_launch.argtypes = [_VP] * 9 + [_INT] * 5 + [_F32, _VP]
    lib.ipm_launch.restype = _INT
    return lib


def _shapes_of(lib):
    """The (nx, C, d) of the paths that `lib` instantiates (before the
    group width became a template parameter: (4, 4, 4) and (4, 3, 3))."""
    paths = ((4, 4, 4), (4, 3, 3), (3, 5, 3), (4, 6, 4), (4, 2, 4),
             (3, 5, 4))
    if not hasattr(lib, "ipm_group_width"):
        return paths[:2]
    lib.ipm_group_width.argtypes = [_INT] * 3
    lib.ipm_group_width.restype = _INT
    return tuple(s for s in paths if lib.ipm_group_width(*s))


def earlier_route(lib):
    """The earlier kernel as a function of `ipm_kernel.ipm`'s arguments."""
    from bayesian_cbf_tpu_torch.ops import _build
    from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik

    def solve(c, Gp, hp, sx, sS, sZ, iters, tol):
        B, C, d, nx = ik.check_ipm_args(c, Gp, hp, sx, sS, sZ)
        x, S, Z = (torch.empty_like(sx), torch.empty_like(sS),
                   torch.empty_like(sZ))
        rc = lib.ipm_launch(c.data_ptr(), Gp.data_ptr(), hp.data_ptr(),
                            sx.data_ptr(), sS.data_ptr(), sZ.data_ptr(),
                            x.data_ptr(), S.data_ptr(), Z.data_ptr(), B, nx,
                            C, d, int(iters), float(tol),
                            torch.cuda.current_stream(c.device).cuda_stream)
        _build.check(rc, "ipm_launch (earlier)")
        return x, S, Z
    solve.shared = _shapes_of(lib)
    return solve


def _same_bits(got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def _starts(prob):
    """The cold start and a warm start of `prob` (with its moved data)."""
    from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
    from bayesian_cbf_tpu_torch.solvers.socp import _interior_shift
    B, C, d, nx = prob[1].shape
    e = torch.zeros((B, C, d), dtype=torch.float32, device=prob[0].device)
    e[..., 0] = 1.0
    cold = [torch.zeros_like(prob[0]), e, e]
    x, S, Z = ik.ipm_plain(*prob, *cold, 25, 1e-10)
    moved = [prob[0], prob[1], prob[2] + 1e-3 * e]
    return ((prob, cold, 25),
            (moved, [x, _interior_shift(S), _interior_shift(Z)], 15))


def bits(dev, earlier):
    """Both builds on every case; raises on the first difference."""
    from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
    from bayesian_cbf_tpu_torch.experiments import unicycle as tu
    cones = lambda B, seed, **kw: [
        torch.tensor(a, dtype=torch.float32, device=dev)
        for a in _random_cones(B, seed, **kw)]
    x0s = bt.unicycle_x0s(dev)
    collide = tu.make_ackermann_tracking_sim(**tu.EXPERIMENTS["mean_cbf"],
                                             device=dev)
    cases = {
        "(4, 4, 4) random B=256": cones(256, 0),
        "(4, 4, 4) random B=1003": cones(1003, 4),
        "(4, 4, 4) flagship step 0": list(_step0_cones(dev, x0s, 1)),
        "(4, 4, 4) mean CBF step 0": list(_step0_cones(
            dev, x0s, 1, collide, want_dims=(4, 1, 1, 1))),
        "(4, 3, 3) random B=256": cones(256, 2, dims=(3, 3, 1)),
        "(4, 3, 3) random B=1003": cones(1003, 6, dims=(3, 3, 1)),
        "(4, 3, 3) pendulum step 0": list(_pendulum_step0_cones(
            dev, bt.pendulum_x0s(dev), want_dims=(3, 3, 1))),
    }
    shared = earlier.shared
    cases.update({k: v for k, v in _real_cases(dev).items()
                  if tuple(v[1].shape[3:4] + v[1].shape[1:3]) in shared})
    for name, prob in cases.items():
        for args, start, iters in _starts(prob):
            same = _same_bits(ik.ipm(*args, *start, iters, 1e-10),
                              earlier(*args, *start, iters, 1e-10))
            print(f"[bits] {name}, {iters} iterations: the earlier build's "
                  f"bits {same}", flush=True)
            _require(same, f"{name}: bits differ from the earlier build")
        if "step 0" in name:
            (args, start, iters), _ = _starts(prob)
            one = [[a[i:i + 1].contiguous() for a in args + start]
                   for i in range(32)]
            same = all(_same_bits(ik.ipm(*o, iters, 1e-10),
                                  earlier(*o, iters, 1e-10)) for o in one)
            print(f"[bits] {name}, 32 problems launched alone: the earlier "
                  f"build's bits {same}", flush=True)
            _require(same, f"{name} at B = 1: bits differ")
    return cases


def _real_cases(dev):
    """Every earlier shape's real cones, as in chip_smoke.py."""
    import chip_smoke as cs
    x0s = bt.unicycle_x0s(dev)
    cones = lambda B, seed, **kw: [
        torch.tensor(a, dtype=torch.float32, device=dev)
        for a in _random_cones(B, seed, **kw)]
    return {
        "(3, 5, 3) random B=256": cones(256, 13, nx=3,
                                        dims=(3, 1, 1, 1, 1)),
        "(3, 5, 3) ground truth": cs._ground_truth_cones(dev),
        "(4, 6, 4) random B=256": cones(256, 15, dims=(4, 1, 1, 1, 1, 1)),
        "(4, 6, 4) mean CLF": cs._mean_clf_cones(dev),
        "(4, 2, 4) random B=256": cones(256, 17, dims=(4, 4)),
        "(4, 2, 4) no obstacles step 0": list(_step0_cones(
            dev, x0s, 1, cs._no_obstacle_sim(dev), want_dims=(4, 4))),
    }


def contraction(dev, card):
    """ipm_exact.cu with and without contraction against plain, by their
    median distance from f64 on the car QP's cones."""
    import subprocess
    import chip_smoke as cs
    from bayesian_cbf_tpu_torch.ops import _build
    from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
    _build.build_all(("ipm_exact",))
    out = _build.BUILD_DIR / "ipm_exact_contracted.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
         str(_build.CSRC / "ipm_exact.cu")], capture_output=True, text=True)
    _require(proc.returncode == 0, f"nvcc failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(out))
    lib.ipm_launch.argtypes = [_VP] * 9 + [_INT] * 5 + [_F32, _VP]
    lib.ipm_launch.restype = _INT
    contracted = earlier_route(lib)
    rel = lambda a, b: (a - b).abs() / (1.0 + b.abs())
    for seed, scale in ((21, 0.1), (22, 0.1), (23, 0.1), (24, 0.1),
                        (21, 0.05)):
        prob = cs._car_cones(dev, seed=seed, scale=scale)
        cold = cs._ipm_cold(dev, prob)
        exact = ik.ipm_plain(*(a.double() for a in prob + cold), 25, 1e-10)
        conv = ik.score_padded(*(a.double() for a in prob), *exact) < 1e-6
        med = {}
        for who, fn in (("plain", ik.ipm_plain), ("ipm_exact", ik.ipm),
                        ("contracted", contracted)):
            got = fn(*prob, *cold, 25, 1e-10)
            torch.cuda.synchronize()
            med[who] = float(rel(got[0].double(), exact[0]).amax(-1)[conv]
                             .median())
        print(f"[contraction] car cones, seed {seed}, 256 states + {scale} "
              f"N(0, 1): median distance from f64 over plain's "
              f"({med['plain']:.4e}): -fmad=false build "
              f"{med['ipm_exact'] / med['plain']:.3f}, contracted build "
              f"{med['contracted'] / med['plain']:.3f} on {card}",
              flush=True)


def times(card, earlier, cases):
    from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
    for name in ("(4, 4, 4) flagship step 0", "(4, 3, 3) pendulum step 0"):
        (args, start, iters), _ = _starts(cases[name])
        routes = (("earlier", earlier), ("this", ik.ipm), ("this", ik.ipm),
                  ("earlier", earlier))
        ms = [(who, _cuda_ms(lambda f=f: f(*args, *start, iters, 1e-10), 50))
              for who, f in routes]
        print(f"[times] {name}, B=256, 25 iterations, in turns: "
              + ", ".join(f"{who} {t:.4f} ms" for who, t in ms)
              + f" on {card}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier-csrc", type=Path)
    ap.add_argument("--contraction", action="store_true")
    args = ap.parse_args()
    dev, card = phase_device()
    if args.contraction:
        contraction(dev, card)
    if args.earlier_csrc is None:
        return
    from bayesian_cbf_tpu_torch.ops import _build
    _build.build_all(("ipm",))
    earlier = earlier_route(build_earlier(args.earlier_csrc))
    cases = bits(dev, earlier)
    times(card, earlier, cases)
    print("[probe_ipm] every shared instantiation gives the earlier build's "
          "bits", flush=True)


if __name__ == "__main__":
    main()
