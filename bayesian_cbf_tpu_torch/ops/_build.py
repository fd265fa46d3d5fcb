"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with `nvcc` into its own shared library with a
plain C interface, which is loaded with `ctypes`.  The build happens at
first use (never at import), goes into `build/kernels/` at the root of the
checkout, and is keyed by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  The `-Xptxas -v`
report of each build (registers, shared memory, spills) is kept beside
the library and returned by `ptxas_report`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# per source: nvcc flags beyond NVCC_FLAGS, and the .cu files it includes
_EXTRA_FLAGS = {"ipm_exact": ("-fmad=false",)}
_INCLUDES = {"ipm_exact": ("ipm.cu",)}

_LIBS: dict = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from the toolkit at $CUDA_HOME (default
    /usr/local/cuda, the toolkit's standard prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + _EXTRA_FLAGS.get(name, ())


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(_flags(src.stem)).encode())
    deps = [CSRC / f for f in _INCLUDES.get(src.stem, ())]
    for dep in sorted(CSRC.glob("*.cuh")) + deps + [src]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    return BUILD_DIR / f"{name}_{_digest(src)}.so"


def _start(name: str, out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, out: Path, proc, tmp: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out.with_suffix(".ptxas.txt").write_text(log)
    os.replace(tmp, out)


def build_all(names) -> None:
    """Compile every `csrc/<name>.cu` that needs it, one nvcc process per
    source, all running at once."""
    todo = [(name, _target(name)) for name in names]
    running = [(name, out, *_start(name, out)) for name, out in todo
               if not out.exists()]
    for name, out, proc, tmp in running:
        _finish(name, out, proc, tmp)


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` if needed; return the library's path."""
    build_all([name])
    return _target(name)


def ptxas_report(name: str) -> str:
    """The ptxas resource lines of the current build of `name`."""
    path = build(name).with_suffix(".ptxas.txt")
    if not path.exists():
        return "(library was built by an earlier process; no report kept)"
    return "\n".join(line for line in path.read_text().splitlines()
                     if "ptxas" in line or "bytes stack frame" in line)


def ptxas_usage(name: str) -> list:
    """Registers, stack and spill bytes of each kernel in the current
    build of `name`, read from its ptxas report: a list of dicts with the
    keys kernel (its name with its integer and bool template arguments,
    a bool as 0 or 1),
    registers, stack_bytes, spill_store_bytes and spill_load_bytes."""
    return parse_ptxas_usage(ptxas_report(name))


def parse_ptxas_usage(report: str) -> list:
    """`ptxas_usage` of any `-Xptxas -v` report."""
    out = []
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?",
                          entry.group(1))
            targs = re.findall(r"L[ib](\d+)E", m.group(2) or "") if m else []
            kernel = (m.group(1) if m else entry.group(1)) + (
                f"<{', '.join(targs)}>" if targs else "")
            out.append(dict(kernel=kernel, registers=None, stack_bytes=0,
                            spill_store_bytes=0, spill_load_bytes=0))
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if spill and out:
            out[-1].update(stack_bytes=int(spill.group(1)),
                           spill_store_bytes=int(spill.group(2)),
                           spill_load_bytes=int(spill.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used and out:
            out[-1]["registers"] = int(used.group(1))
    return out


_VP, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "chol": {
        "chol_matrix_in_smem": [_INT, _INT],
        "chol_linv_launch": [_VP] * 5 + [_INT] * 4 + [_VP],
        "kinv_logdet_launch": [_VP] * 5 + [_INT] * 4 + [_VP],
    },
    "ipm": {
        "ipm_group_width": [_INT, _INT, _INT],
        "ipm_shapes": [_VP, _INT],
        "ipm_launch": [_VP] * 9 + [_INT] * 5 + [_F32, _VP],
    },
    "sweep": {
        "sweep_uses_smem": [_INT, _INT],
        "sweep_launch": [_VP] * 4 + [_INT, _VP] + [_INT] * 3 + [_VP],
        "sweep_regs_limit": [_INT],
        "sweep_regs_launch": [_VP] * 3 + [_INT] * 3 + [_VP],
    },
    "chol_blocked": {
        "chol_dinv_uses_smem": [_INT, _INT],
        "chol_dinv_launch": [_VP] * 4 + [_INT] * 4 + [_VP],
    },
    "cholsolve": {
        "cholsolve_plan": [_INT] * 3,
        "cholsolve_logdet_launch": [_VP] * 8 + [_INT] * 5 + [_VP],
        "solve_with_factor_width": [_INT] * 2,
        "solve_with_factor_launch": [_VP] * 4 + [_INT] * 7 + [_VP],
    },
    "gram": {
        "gram_thread_chunks": [_INT] * 2,
        "gram_blocks_per_sm": [_INT] * 2,
        "gram_launch": [_VP] * 4 + [_F32, _VP] + [_INT] * 7 + [_VP],
    },
}
_SIGNATURES["ipm_exact"] = _SIGNATURES["ipm"]
KERNEL_SOURCES = tuple(_SIGNATURES)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`, with typed entry points."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
