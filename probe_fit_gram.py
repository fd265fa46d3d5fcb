#!/usr/bin/env python3
"""The refit that the fit-Gram kernels (csrc/fit_gram.cu) serve, on one
NVIDIA card, against the recompute route they replaced (`km_expr` and
autograd through it, the route taken where X wants a gradient).  The
kernels themselves are checked and timed by chip_smoke.py
(`_check_fit_gram_kernel`).

    python3 probe_fit_gram.py

  1. adam    -- ms per Adam iteration of `MVGP.fit` (fit_inverse
                "sweep_full", the cells' route; no recording open, the
                launch counters from a recorded 2-iteration fit before
                it) on rollout-like buffers
                at (1, 200), (4096, 200) (x_dim 2, u_dim 1) and
                (131072, 64) (x_dim 3, u_dim 2), on the kernel route and
                on the recompute route, with each route's peak device
                memory, and whether the two fits move the hyperparameters
                alike.
  2. trace   -- one Adam iteration at (4096, 200) and at (131072, 64)
                under torch.profiler: its device operations by time, the
                device time against the iteration's wall time (without the
                profiler), and every ATen operation that takes a
                (B, K, K, x_dim) tensor (none on the kernel route).

One JSON object a line on stdout.
"""
import json
import sys
import time

import torch

import bench_torch as bt
from bayesian_cbf_tpu_torch.models.mvgp import MVGPData, make_mvgp
from bayesian_cbf_tpu_torch.observability import tracing
from bayesian_cbf_tpu_torch.ops import _build


def emit(record):
    print(json.dumps(record), flush=True)


def buffer(dev, B, K, xd, mh, seed):
    """A rollout-like training buffer: random-walk states, controls of a
    few units, a smooth state derivative plus noise, every row valid."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.cumsum(0.05 * torch.randn((B, K, xd), generator=g, device=dev),
                     1) + 1.0
    U = 3.0 * torch.randn((B, K, mh - 1), generator=g, device=dev)
    Xdot = (torch.sin(X).roll(1, -1) + U.sum(-1, keepdim=True)
            + 0.01 * torch.randn((B, K, xd), generator=g, device=dev))
    return MVGPData(X=X, UH=torch.cat([torch.ones_like(U[..., :1]), U], -1),
                    Xdot=Xdot, mask=torch.ones((B, K), device=dev))


def adam(dev, card, B, K, xd, mh, iters):
    """ms per Adam iteration and peak memory of `MVGP.fit` on both
    routes; the fitted lengthscales' widest relative gap between them."""
    gp = make_mvgp(xd, mh - 1, fit_inverse="sweep_full")
    data = buffer(dev, B, K, xd, mh, 3)
    p0 = gp.init_params(B, torch.Generator(device=dev).manual_seed(4), dev,
                        torch.float32)
    rec = {"section": "adam", "shape": [B, K, xd, mh], "iters": iters,
           "card": card}
    fitted = {}
    for route in ("kernels", "recompute"):
        if route == "recompute":
            data = data._replace(X=data.X.requires_grad_(True))
        with tracing.recording():
            gp.fit(p0, data, training_iter=2)
        c = tracing.report()["counters"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        p1 = gp.fit(p0, data, training_iter=iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec[route] = dict(
            ms_per_iter=wall * 1e3 / iters,
            peak_bytes=torch.cuda.max_memory_allocated() - base,
            fit_gram_2iters=c.get("launches.fit_gram", 0),
            fit_gram_backward_2iters=c.get("launches.fit_gram_backward", 0),
            recompute_2iters=c.get("gramsolve.recompute", 0),
            moved_share=float(((p1.raw_lengthscale - p0.raw_lengthscale)
                               .abs().amax(-1) > 0).float().mean()),
            finite=bool(all(torch.isfinite(a).all() for a in p1)))
        fitted[route] = p1
        torch.cuda.empty_cache()
    a, b = fitted["kernels"].lengthscale, fitted["recompute"].lengthscale
    rec["lengthscale_rel_gap_max"] = float(((a - b).abs() / b.abs()).max())
    rec["lengthscale_rel_gap_median"] = float(((a - b).abs() / b.abs())
                                              .median())
    emit(rec)


def trace(dev, card, B=4096, K=200, xd=2, mh=2):
    from torch.profiler import ProfilerActivity, profile
    gp = make_mvgp(xd, mh - 1, fit_inverse="sweep_full")
    data = buffer(dev, B, K, xd, mh, 3)
    p0 = gp.init_params(B, torch.Generator(device=dev).manual_seed(4), dev,
                        torch.float32)
    gp.fit(p0, data, training_iter=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp.fit(p0, data, training_iter=5)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        gp.fit(p0, data, training_iter=1)
        torch.cuda.synchronize()
    dev_ops = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ops[e.name] = dev_ops.get(e.name, 0.0) + e.device_time / 1e3
    big = sorted({e.name for e in prof.events()
                  if any(list(s) == [B, K, K, xd]
                         for s in (e.input_shapes or []))})
    top = sorted(dev_ops.items(), key=lambda kv: -kv[1])[:12]
    emit({"section": "trace", "shape": [B, K, xd, mh], "card": card,
          "device_ms": sum(dev_ops.values()), "wall_ms": wall_ms,
          "device_ops": len(dev_ops),
          "top_ms": [[n[:80], round(t, 4)] for n, t in top],
          "ops_on_BKKx": big})


def main():
    dev, card = bt.require_card("probe_fit_gram")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(("fit_gram", "sweep"))
    adam(dev, card, 1, 200, 2, 2, 25)
    adam(dev, card, 4096, 200, 2, 2, 10)
    adam(dev, card, 131072, 64, 3, 3, 5)
    trace(dev, card)
    trace(dev, card, 131072, 64, 3, 3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
