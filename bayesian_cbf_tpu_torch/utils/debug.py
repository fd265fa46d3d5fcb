"""Debug sanitizers: where a NaN first appears, and gradient checks.

  * `checkify_nan(fn)` wraps `fn` so that the first ATen operation whose
    floating output holds a NaN or an infinity that none of its inputs
    held raises, naming that operation (and, with `also_div`, a division
    by zero); a non-finite value asked for as an argument (a NaN marker
    filled in on purpose) is an input, as a literal is to JAX's checkify,
    and so is one passed on from an earlier operation.  Run a failing
    configuration once under it to find where the first non-finite value
    is made.  It checks the forward computation, as the JAX package's
    checkify does; `torch.autograd.detect_anomaly` checks only backward.
  * `gradcheck(fn, args)`: central differences against autograd's
    gradient over every float leaf of args[0] (a dict or a tuple of
    tensors, nested as the caller likes);
  * `gradgradcheck(fn, args)`: the same for the Hessian-vector product
    along a fixed pseudo-random tangent.

Leaves are taken in the JAX package's order (dict keys sorted, tuples in
order), so a leaf index in a message names the same leaf in both.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# operations whose outputs are uninitialised memory, never checked
_UNINITIALISED = ("empty", "new_empty", "empty_like", "empty_strided")
_DIVISIONS = ("div", "div_", "floor_divide", "floor_divide_", "remainder",
              "remainder_", "fmod", "fmod_", "true_divide", "true_divide_")


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    else:
        yield tree


def _tensors(tree):
    return (t for t in _leaves(tree) if isinstance(t, torch.Tensor))


def _non_finite(a) -> bool:
    if isinstance(a, torch.Tensor):
        return (a.dtype.is_floating_point or a.dtype.is_complex) \
            and a.numel() > 0 and not bool(torch.isfinite(a).all())
    return isinstance(a, float) and not math.isfinite(a)


class _NonFiniteMode(TorchDispatchMode):
    """Raises FloatingPointError at the first operation that makes a
    non-finite floating value from finite inputs (or divides by zero,
    with also_div)."""

    def __init__(self, also_div: bool):
        super().__init__()
        self.also_div = also_div

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if self.also_div and name in _DIVISIONS and len(args) > 1:
            den = args[1]
            zero = (bool((den == 0).any()) if isinstance(den, torch.Tensor)
                    else den == 0)
            if zero:
                raise FloatingPointError(f"division by zero in {func}")
        if self.also_div and name in ("reciprocal", "reciprocal_"):
            if bool((args[0] == 0).any()):
                raise FloatingPointError(f"division by zero in {func}")
        out = func(*args, **kwargs)
        if name in _UNINITIALISED:
            return out
        bad = [t for t in _tensors(out) if _non_finite(t)]
        if bad and not any(_non_finite(a) for a in _leaves((args, kwargs))):
            t = bad[0]
            what = "nan" if bool(torch.isnan(t).any()) else "inf"
            raise FloatingPointError(
                f"{what} generated by {func}: a non-finite value in its "
                f"output of shape {tuple(t.shape)}")
        return out


def checkify_nan(fn: Callable, also_div: bool = True) -> Callable:
    """`fn` wrapped so that a NaN or an infinity made by any operation
    inside (or, with also_div, a division by zero) raises
    FloatingPointError naming that operation."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _NonFiniteMode(also_div):
            return fn(*args, **kwargs)

    return wrapped


# ---- gradient checks --------------------------------------------------------

def _flatten(tree):
    """(leaves, rebuild) with leaves in the JAX package's order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda ls: ls[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [l for p in parts for l in p[0]]

    def rebuild(ls):
        vals, off = [], 0
        for (_, rb), n in zip(parts, sizes):
            vals.append(rb(ls[off:off + n]))
            off += n
        if keys is not None:
            return dict(zip(keys, vals))
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)

    return leaves, rebuild


def _is_float(leaf):
    return isinstance(leaf, torch.Tensor) and leaf.dtype.is_floating_point


def _grads(fn, leaves, rebuild, rest, create_graph=False):
    """fn's gradient at `leaves` for each float leaf (None elsewhere)."""
    live = [l.detach().requires_grad_(True) if _is_float(l) else l
            for l in leaves]
    idx = [i for i, l in enumerate(live) if _is_float(l)]
    with torch.enable_grad():
        val = fn(rebuild(live), *rest)
        got = torch.autograd.grad(val, [live[i] for i in idx],
                                  create_graph=create_graph,
                                  allow_unused=True)
    out = [None] * len(live)
    for i, g in zip(idx, got):
        out[i] = torch.zeros_like(live[i]) if g is None else g
    return out, live


def gradcheck(fn: Callable, args, eps: float = 1e-6, rtol: float = 1e-4,
              atol: float = 1e-6) -> bool:
    """Central differences against autograd's gradient of
    `fn(params, *rest) -> scalar` over every float leaf of params =
    args[0], coordinate by coordinate.  Returns True; raises
    AssertionError naming the leaf and coordinate of a mismatch."""
    params, *rest = args
    leaves, rebuild = _flatten(params)
    grads, _ = _grads(fn, leaves, rebuild, rest)
    with torch.no_grad():
        for i, leaf in enumerate(leaves):
            if not _is_float(leaf):
                continue
            flat = leaf.detach().cpu().numpy().astype(np.float64).reshape(-1)
            g = grads[i].detach().cpu().numpy().astype(np.float64).reshape(-1)
            for j in range(flat.size):
                def at(v):
                    f2 = flat.copy()
                    f2[j] = v
                    ls = list(leaves)
                    ls[i] = torch.tensor(f2.reshape(tuple(leaf.shape)),
                                         dtype=leaf.dtype, device=leaf.device)
                    return float(fn(rebuild(ls), *rest))
                fd = (at(flat[j] + eps) - at(flat[j] - eps)) / (2 * eps)
                if not np.isclose(fd, g[j], rtol=rtol, atol=atol):
                    raise AssertionError(
                        "gradcheck failed at leaf %d[%d]: fd=%.6g grad=%.6g"
                        % (i, j, fd, g[j]))
    return True


def gradgradcheck(fn: Callable, args, eps: float = 1e-5,
                  rtol: float = 2e-3, atol: float = 1e-5) -> bool:
    """The Hessian-vector product of `fn(params, *rest) -> scalar` along a
    fixed tangent (normal draws of numpy's default_rng(0), leaf by leaf)
    against central differences of its gradient.  Returns True; raises
    AssertionError (numpy's assert_allclose) on a mismatch."""
    params, *rest = args
    leaves, rebuild = _flatten(params)
    rng = np.random.default_rng(0)
    tangent = [torch.tensor(rng.normal(size=tuple(l.shape)), dtype=l.dtype,
                            device=l.device) if _is_float(l) else None
               for l in leaves]
    grads, live = _grads(fn, leaves, rebuild, rest, create_graph=True)
    idx = [i for i, l in enumerate(leaves) if _is_float(l)]
    with torch.enable_grad():
        dot = sum(torch.sum(grads[i] * tangent[i]) for i in idx)
        hvp = torch.autograd.grad(dot, [live[i] for i in idx],
                                  allow_unused=True)

    def shifted(s):
        ls = [l + s * t if t is not None else l
              for l, t in zip(leaves, tangent)]
        return _grads(fn, ls, rebuild, rest)[0]

    gp, gm = shifted(eps), shifted(-eps)
    for k, i in enumerate(idx):
        fd = ((gp[i].detach().double() - gm[i].detach().double())
              / (2 * eps)).cpu().numpy()
        h = (torch.zeros_like(leaves[i]) if hvp[k] is None
             else hvp[k]).detach().cpu().numpy()
        np.testing.assert_allclose(fd, h, rtol=rtol, atol=atol)
    return True
