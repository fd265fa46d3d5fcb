#!/usr/bin/env python3
"""One-off measurements of kernel 4, the fused masked Gram (csrc/gram.cu),
on one NVIDIA card, beyond what chip_smoke.py holds it to.

    python3 probe_gram.py [--earlier-csrc DIR]

  1. routes -- at (256, 200, n=3, 1+m=3), (4, 1024, 3, 3),
               (2, 1024, 16, 16) and the pendulum's n = 1+m = 2 at
               (256, 200) and (256, 512): the shipped kernel (16-byte
               streaming stores, inputs read in place through L1) at 2, 4
               and 8 rows per thread, and copies of csrc/gram.cu changed
               as VARIANTS says, built beside it: the other store route
               (each band built in shared memory and written by one bulk
               TMA store, double-buffered), every shape on the instance
               for any n, 1+m, and two cut copies (stores only,
               arithmetic only) that split the time.  For each: device
               time per launch (torch.profiler), time per call (CUDA
               events), registers, stack and spill bytes, and whether the
               output has the shipped kernel's bits.
  2. bits   -- with --earlier-csrc DIR, DIR holding gram.cu as it was
               before this redesign (one 32 x 32 tile per block; entry
               point gram_launch(Xs, UHB, mask, s, jitter, out, B, K, n,
               mh, stream)): its kernel, built from DIR, is timed beside
               the others and held to this checkout's bit for bit
               (torch.equal on the int32 view) at (256, 200, 3, 3) with
               half the rows masked, (1, 1, 1, 1), (3, 33, 3, 3),
               (5, 201, 3, 3), (2, 70, 16, 16), (4, 1024, 3, 3),
               (2, 1024, 16, 16), (1000, 200, 3, 3), (1, 2051, 3, 3),
               (1, 1027, 16, 16), (256, 200, 2, 2), (256, 512, 2, 2),
               (2, 201, 2, 2), (2, 70, 2, 3), the near-duplicate case and
               the refresh inputs of run (c) (the arguments of every
               launch in one rollout of the flagship batch with
               fused_gram=True).
"""
import argparse
import contextlib
import ctypes
from pathlib import Path

import numpy as np
import torch

import bench_torch as bt
from chip_smoke import (_cuda_ms, _device_ms, _near_duplicate_case,
                        _require, phase_device)
from probe_kinv_logdet import _nvcc

TIMED = ((256, 200, 3, 3), (4, 1024, 3, 3), (2, 1024, 16, 16),
         (256, 200, 2, 2), (256, 512, 2, 2))

_VP, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _inputs(dev, B, K, n, mh, seed, half_masked=False):
    """Random-walk Xs (a training buffer's rows), random UHB rows, a
    random or half-zero mask and outputscales, f32 on `dev`."""
    rng = np.random.default_rng(seed)
    if half_masked:
        mask = np.ones((B, K))
        mask[:, K // 2:] = 0.0
    else:
        mask = (rng.uniform(size=(B, K)) > 0.5).astype(float)
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        np.cumsum(0.02 * rng.normal(size=(B, K, n)), 1),
        rng.normal(size=(B, K, mh)), mask, rng.uniform(0.5, 2.0, size=B))]


# Changes to csrc/gram.cu that make each variant timed beside the shipped
# kernel: (old text, new text) or (old text, new text, times it occurs).
# The other store route: each band is built in shared memory (two band
# buffers of 32 KB, so R K <= 8192) and written with one bulk (TMA) store,
# cp.async.bulk.global.shared::cta.bulk_group, of its 16-byte aligned
# part; a buffer is written again once the store two bands back has read
# it (cp.async.bulk.wait_group.read).
TMA_HELPERS = r"""// One band buffer: R K <= 8192 floats at any 16-byte offset.
constexpr int kBandFloats = 8192 + 4;
constexpr int kBandSmem = 2 * kBandFloats * sizeof(float);

__device__ inline void wait_band_buffer() {
    if (threadIdx.x == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncthreads();
}

__device__ void flush_band(float* gb, const float* sbp, int total, int pad) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int head = min(total, (4 - pad) & 3);
    const int body = (total - head) & ~3;
    const int tail = total - head - body;
    if (threadIdx.x == 0 && body > 0) {
        const unsigned src = (unsigned)__cvta_generic_to_shared(sbp + head);
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
            :: "l"(gb + head), "r"(src), "r"(body * 4) : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    const int t = threadIdx.x - 32;
    if ((int)threadIdx.x < head) __stcs(gb + threadIdx.x, sbp[threadIdx.x]);
    if (t >= 0 && t < tail)
        __stcs(gb + head + body + t, sbp[head + body + t]);
}

"""
TMA = (
    ("// One matrix's inputs, read through L1.",
     TMA_HELPERS + "// One matrix's inputs, read through L1."),
    ("                     float* ob, int i0, int rows) {\n"
     "    constexpr int P = Dims<N>::P, W = Dims<N>::W;\n"
     "    const int K = g.K, n = g.n, mh = g.mh, G = g.G;\n",
     "                     float* ob, int i0, int rows, float* sb) {\n"
     "    constexpr int P = Dims<N>::P, W = Dims<N>::W;\n"
     "    const int K = g.K, n = g.n, mh = g.mh, G = g.G;\n"
     "    float* gb = ob + (size_t)i0 * K;\n"
     "    const int pad = (int)((uintptr_t)gb >> 2) & 3;\n"
     "    float* sbp = sb + pad;\n"),
    ("                float* dst = row + j0[p];\n",
     "                float* dst = sbp + (size_t)r * K + j0[p];\n"),
    ("                    __stcs(reinterpret_cast<float4*>(dst),\n"
     "                           make_float4(w[0], w[1], w[2], w[3]));\n",
     "                    *reinterpret_cast<float4*>(dst) =\n"
     "                        make_float4(w[0], w[1], w[2], w[3]);\n"),
    ("                            __stcs(dst + q, w[q]);\n",
     "                            dst[q] = w[q];\n"),
    ("    }\n}\n\n// Block g's items",
     "    }\n    flush_band(gb, sbp, rows * K, pad);\n}\n\n// Block g's items"),
    ("    const int last = first_item(blockIdx.x + 1, gridDim.x, g.items);\n",
     "    extern __shared__ __align__(16) float smem[];\n    int k = 0;\n"
     "    const int last = first_item(blockIdx.x + 1, gridDim.x, g.items);\n"),
    ("                min(g.R, g.K - i0));\n    }\n}\n",
     "                min(g.R, g.K - i0), smem + k * kBandFloats);\n"
     "        k ^= 1;\n    }\n    if (threadIdx.x == 0)\n"
     "        asm volatile(\"cp.async.bulk.wait_group 0;\\n\" ::: \"memory\");\n"
     "}\n"),
    ("        band<N>(g, src,",
     "        wait_band_buffer();\n        band<N>(g, src,"),
    ("    if (!c.kernel || cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
     "                         &blocks, c.kernel, kThreads, 0))\n",
     "    if (!c.kernel || cudaFuncSetAttribute((const void*)c.kernel,\n"
     "            cudaFuncAttributeMaxDynamicSharedMemorySize, kBandSmem) ||\n"
     "        cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
     "                         &blocks, c.kernel, kThreads, kBandSmem))\n"),
    ("    c.kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(g);\n",
     "    if ((long long)R * K > 8192) return -1;\n"
     "    c.kernel<<<grid, kThreads, kBandSmem, (cudaStream_t)stream>>>(g);\n"),
)
STORES_ONLY = (("            entries<N>(ri, c, n, mh, s, v);\n",
                "#pragma unroll\n            for (int q = 0; q < W; ++q) v[q] = s;\n"),)
COMPUTE_ONLY = (
    ("                    __stcs(reinterpret_cast<float4*>(dst),\n"
     "                           make_float4(w[0], w[1], w[2], w[3]));\n",
     "                    if (w[0] + w[1] + w[2] + w[3] == -1.0f) dst[0] = w[0];\n"),)
# every (n, 1+m) on the instance for any n, 1+m <= 16
GENERIC = (("    if (n == mh && n == 3) return instance<3>();\n"
            "    if (n == mh && n == 2) return instance<2>();\n", ""),)
# name: (changes, rows per thread timed); the cut copies (stores or
# compute only) give no Gram and are not compared
VARIANTS = {
    "streaming stores": ((), (2, 4, 8)),
    "TMA band stores": (TMA, (2, 4)),
    "generic instance only": (GENERIC, (8,)),
    "cut: stores only": (STORES_ONLY, (8,)),
    "cut: compute only": (COMPUTE_ONLY, (8,)),
}


def _changed(src, changes, name):
    for change in changes:
        old, new, times = (change + (1,))[:3]
        _require(src.count(old) == times, f"{name}: the source no longer "
                 f"holds {old!r} {times} time(s)")
        src = src.replace(old, new)
    return src


def build(earlier: Path = None):
    """Every variant (and with `earlier`, the earlier gram.cu), built beside
    the shipped source into build/kernels/; returns {name: (library, its
    ptxas usage)}."""
    from bayesian_cbf_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    shipped = (_build.CSRC / "gram.cu").read_text()
    procs = {}
    for k, (name, (changes, _)) in enumerate(VARIANTS.items()):
        src = _changed(shipped, changes, name)
        path = _build.BUILD_DIR / f"gram_probe_{k}.cu"
        path.write_text(src)
        out = path.with_suffix(".so")
        procs[name] = (_nvcc(path, out, _build.CSRC), out)
    if earlier:
        out = _build.BUILD_DIR / "gram_earlier.so"
        procs["earlier kernel"] = (_nvcc(earlier / "gram.cu", out, earlier),
                                   out)
    _build.build_all(("gram",))
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        _require(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        if name == "earlier kernel":
            lib.gram_launch.argtypes = [_VP] * 4 + [_F32, _VP] + [
                _INT] * 4 + [_VP]
        else:
            for fn, argtypes in _build._SIGNATURES["gram"].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, _build.parse_ptxas_usage(log))
    return libs


_SHAPES = {}


@contextlib.contextmanager
def loaded(lib):
    """While active, ops/gram.py launches the kernel of `lib` (with its own
    cache of what it asks the library per shape)."""
    from bayesian_cbf_tpu_torch.ops import _build
    from bayesian_cbf_tpu_torch.ops import gram as gm
    kept = _build.load("gram"), gm._SHAPES
    _build._LIBS["gram"] = lib
    gm._SHAPES = _SHAPES.setdefault(id(lib), {})
    try:
        yield
    finally:
        _build._LIBS["gram"], gm._SHAPES = kept


def variant_route(lib, rows_per_thread):
    """A variant's kernel through ops/gram.py's launch."""
    from bayesian_cbf_tpu_torch.ops import gram as gm

    def fn(*args):
        with loaded(lib):
            return gm._launch(*args, rows_per_thread=rows_per_thread)

    return fn


def earlier_route(lib):
    """The earlier kernel as a function of fused_gram_kb's arguments."""
    from bayesian_cbf_tpu_torch.ops import _build

    def fn(Xs, U, mask, s, jitter):
        B, K, n = Xs.shape
        out = torch.empty((B, K, K), dtype=Xs.dtype, device=Xs.device)
        _build.check(lib.gram_launch(
            Xs.data_ptr(), U.data_ptr(), mask.data_ptr(), s.data_ptr(),
            float(jitter), out.data_ptr(), B, K, n, U.shape[-1],
            torch.cuda.current_stream(Xs.device).cuda_stream),
            "gram_launch (earlier)")
        return out

    return fn


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def routes(dev, card, libs):
    from bayesian_cbf_tpu_torch.ops import gram as gm
    for name, (lib, usage) in libs.items():
        print(f"[routes] {name}: {usage} on {card}", flush=True)
    for B, K, n, mh in TIMED:
        args = _inputs(dev, B, K, n, mh, K, half_masked=True)
        want = gm.fused_gram_kb(*args, 1e-6)
        for name, (lib, _) in libs.items():
            if name == "earlier kernel":
                fns = {"": (earlier_route(lib), "gram_kernel")}
            else:
                fns = {f", {r} rows per thread": (variant_route(lib, r),
                                                   "gram_kernel")
                       for r in VARIANTS[name][1]}
            for rows, (fn, kernel) in fns.items():
                same = _same_bits(fn(*args, 1e-6), want)
                dev_ms = _device_ms(lambda: fn(*args, 1e-6), kernel, 20)
                ms = _cuda_ms(lambda: fn(*args, 1e-6), 50)
                print(f"[routes] ({B}, {K}, {n}, {mh}) {name}{rows}: device "
                      f"{dev_ms:.4f} ms per launch, {ms:.4f} ms per call, "
                      f"bits equal to the shipped kernel's {same}",
                      flush=True)


@contextlib.contextmanager
def recorded_launches(into):
    """While active, append the arguments of every launch of the Gram
    kernel (`ops/gram._launch`, which `fused_gram_kb` calls) to `into`."""
    from bayesian_cbf_tpu_torch.ops import gram as gm
    inner = gm._launch

    def recording(*args, **kw):
        into.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return inner(*args, **kw)

    gm._launch = recording
    try:
        yield
    finally:
        gm._launch = inner


def bits(dev, card, lib):
    from bayesian_cbf_tpu_torch.ops import gram as gm
    earlier = earlier_route(lib)
    cases = {"(256, 200, 3, 3), half the rows masked":
             _inputs(dev, 256, 200, 3, 3, 3, half_masked=True)}
    for shape in ((1, 1, 1, 1), (3, 33, 3, 3), (5, 201, 3, 3),
                  (2, 70, 16, 16), (4, 1024, 3, 3), (2, 1024, 16, 16),
                  (1000, 200, 3, 3), (1, 2051, 3, 3), (1, 1027, 16, 16),
                  (256, 200, 2, 2), (256, 512, 2, 2), (2, 201, 2, 2),
                  (2, 70, 2, 3)):
        cases[str(shape)] = _inputs(dev, *shape, seed=shape[1])
    *near, _ = _near_duplicate_case()
    cases["near-duplicate (4, 40, 3, 3)"] = [
        torch.tensor(a, dtype=torch.float32, device=dev) for a in near]
    for name, args in cases.items():
        same = _same_bits(gm.fused_gram_kb(*args, 1e-6), earlier(*args, 1e-6))
        print(f"[bits] {name}: equal to the earlier kernel {same}",
              flush=True)
        _require(same, f"{name}: bits differ from the earlier kernel")
    seen = []
    with recorded_launches(seen):
        record = bt.run_protocol("unicycle", dev, reps=0, card=card,
                                 gp_options=dict(fused_gram=True))
    _require(len(seen) == record["launches"]["gram"] == 4,
             f"run (c) launched the Gram {record['launches']['gram']} times, "
             f"{len(seen)} recorded")
    same = [_same_bits(gm.fused_gram_kb(*a), earlier(*a)) for a in seen]
    print(f"[bits] run (c)'s {len(seen)} refresh Grams "
          f"{[tuple(a[0].shape) for a in seen]} (outcomes "
          f"{record['outcomes']}, accepted rungs {record['refresh_rungs']}): "
          f"equal to the earlier kernel {same}", flush=True)
    _require(all(same), "run (c): bits differ from the earlier kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier-csrc", type=Path, default=None)
    args = ap.parse_args()
    dev, card = phase_device()
    libs = build(args.earlier_csrc)
    routes(dev, card, libs)
    if args.earlier_csrc:
        bits(dev, card, libs["earlier kernel"][0])


if __name__ == "__main__":
    main()
