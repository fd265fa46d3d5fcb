#!/usr/bin/env python3
"""One-off measurements of kernel 5's one-sweep route (csrc/sweep.cu
`sweep_regs_kernel`, the `"sweep_full"` fit inverse) on one NVIDIA card,
beyond what chip_smoke.py holds it to.

    python3 probe_sweep.py

  1. instances -- a copy of csrc/sweep.cu that also exports other
                  instances of sweep_regs_kernel (thread grid TY x TX, row
                  and column slots RA x CA) is built beside the shipped
                  source; for each instance at the fit's two orders (200
                  and 50): registers, stack and spill bytes, whether its
                  inverse and logdet equal the event kernel's bit for bit
                  on (256, n) SPD and trajectory Grams, and its time on the
                  trajectory Grams beside the event kernel's.
  2. update    -- the event kernel's rank-1 update as nvcc compiled it:
                  the FFMA, FMUL and FADD instructions of sweep_kernel's
                  SASS (cuobjdump), to show which rounding the register
                  kernel must repeat.
"""
import ctypes
import subprocess
from pathlib import Path

import torch

from chip_smoke import _cuda_ms, _require, _spd, _trajectory_grams, phase_device
from probe_kinv_logdet import _nvcc

# (TY, TX, RA, CA) of each instance tried, by the order it serves; the
# first of each is the one csrc/sweep.cu ships
INSTANCES = {200: ((16, 32, 14, 7), (16, 32, 13, 7)),
             50: ((16, 16, 4, 4), (8, 16, 8, 4), (16, 32, 4, 2), (8, 8, 8, 8))}


def _name(inst):
    return "probe_regs_" + "_".join(map(str, inst))


def build_instances():
    """The shipped source plus one exported launcher per instance, built
    into build/kernels/; returns the library and its ptxas usage."""
    from bayesian_cbf_tpu_torch.ops import _build
    src = (_build.CSRC / "sweep.cu").read_text()
    for insts in INSTANCES.values():
        for inst in insts:
            src += (f'\nextern "C" int {_name(inst)}(const float* K, float* '
                    f'Kinv, float* logdet, int B, int n, void* stream) {{\n'
                    f'    return launch_regs<{", ".join(map(str, inst))}>('
                    f'K, Kinv, logdet, B, n, (cudaStream_t)stream);\n}}\n')
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "sweep_probe.cu"
    path.write_text(src)
    proc = _nvcc(path, path.with_suffix(".so"), _build.CSRC)
    log, _ = proc.communicate()
    _require(proc.returncode == 0, f"nvcc failed for the probe copy:\n{log}")
    return ctypes.CDLL(str(path.with_suffix(".so"))), \
        _build.parse_ptxas_usage(log)


def update_sass():
    from bayesian_cbf_tpu_torch.ops import _build
    lib = _build.build("sweep")
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs = sass.split("Function : ")
    body = [f for f in funcs if "12sweep_kernelE" in f.split("\n", 1)[0]]
    _require(len(body) == 1, "no SASS for sweep_kernel")
    lines = body[0].splitlines()
    counts = {op: sum(f" {op} " in ln or f" {op}." in ln for ln in lines)
              for op in ("FFMA", "FMUL", "FADD")}
    print(f"[update] sweep_kernel SASS: {counts}", flush=True)
    for ln in lines:
        if " FFMA " in ln and "-" in ln.split("FFMA", 1)[1]:
            print(f"[update] {ln.strip()}", flush=True)


def main():
    from bayesian_cbf_tpu_torch.ops import sweep_kernels as sk
    dev, card = phase_device()
    lib, usage = build_instances()
    update_sass()
    for n, insts in INSTANCES.items():
        full = sk.full_base(n)
        grams = {"spd": _spd(256, n, 3), "trajectory": _trajectory_grams(
            256, n, seed=n + 1)}
        grams = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                 for k, v in grams.items()}
        want = {k: sk._launch_events(K, full) for k, K in grams.items()}
        T = grams["trajectory"]
        ev_ms = _cuda_ms(lambda: sk._launch_events(T, full), 10)
        print(f"[instances] ({256}, {n}) event kernel {ev_ms:.4f} ms on "
              f"{card}", flush=True)
        for inst in insts:
            fn = getattr(lib, _name(inst))
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]

            def run(K):
                Kinv = torch.empty_like(K)
                ld = K.new_empty((K.shape[0],))
                rc = fn(K.data_ptr(), Kinv.data_ptr(), ld.data_ptr(),
                        K.shape[0], n, torch.cuda.current_stream().cuda_stream)
                _require(rc == 0, f"{inst}: CUDA error {rc}")
                return Kinv, ld

            same = {}
            for k, K in grams.items():
                got = run(K)
                torch.cuda.synchronize()
                same[k] = all(torch.equal(g.view(torch.int32),
                                          w.view(torch.int32))
                              for g, w in zip(got, want[k]))
            ms = _cuda_ms(lambda: run(T), 50)
            targs = ", ".join(map(str, inst))
            u = [x for x in usage
                 if x["kernel"] == f"sweep_regs_kernel<{targs}>"]
            print(f"[instances] ({256}, {n}) {inst[0]} x {inst[1]} threads, "
                  f"{inst[2]} x {inst[3]} slots: {ms:.4f} ms, bits equal to "
                  f"the event kernel {same}; {u}", flush=True)


if __name__ == "__main__":
    main()
