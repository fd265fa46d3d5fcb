"""Carry learner state across from numpy arrays (for example arrays a JAX
run produced) into the port, and back; and a JAX serving controller's
carry into the port's.

Every array of the MVGP and the learner carries the leading episode axis
of the port's tensors; the CoGP has none.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .models.cogp import CoGPParams
from .models.dynamics import LearnedDynState, LearnedShiftInvariantDynamics
from .models.mvgp import MVGP, MVGPCache, MVGPData, MVGPParams


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def mvgp_from_jax(jgp, fit_inverse: str = "cholk",
                  fit_chol_assembly: str = "", linv_assembly: str = "kernel",
                  fused_fit: bool = True) -> MVGP:
    """The port's MVGP in the configuration of a JAX-package `MVGP` (any
    object with its fields) and the JAX globals that select its kernel
    paths: pass `cholinv.FIT_INVERSE`, `cholinv.FIT_CHOL_ASSEMBLY`,
    `pallas_chol.LINV_ASSEMBLY` and `mvgp.FUSED_FIT`.  `use_pallas`
    becomes `fused_gram`."""
    from .ops.cholinv import check_options
    check_options(fit_inverse, fit_chol_assembly or linv_assembly)
    return MVGP(x_dim=jgp.x_dim, u_dim=jgp.u_dim, rank_A=jgp.rank_A,
                rank_B=jgp.rank_B, jitter=jgp.jitter,
                gamma_prior=jgp.gamma_prior, fit_inverse=fit_inverse,
                fit_chol_assembly=fit_chol_assembly,
                linv_assembly=linv_assembly, fused_gram=bool(jgp.use_pallas),
                fused_fit=bool(fused_fit))


def mvgp_params_from_numpy(arrays: Mapping[str, np.ndarray], device,
                           dtype) -> MVGPParams:
    """MVGPParams from a mapping of its seven field names to arrays."""
    return MVGPParams(*(_t(arrays[f], device, dtype)
                        for f in MVGPParams._fields))


def mvgp_params_to_numpy(params: MVGPParams) -> dict:
    return {f: getattr(params, f).detach().cpu().numpy()
            for f in MVGPParams._fields}


def cogp_params_from_numpy(arrays: Mapping[str, np.ndarray], device,
                           dtype) -> CoGPParams:
    """CoGPParams from a mapping of its six field names to arrays."""
    return CoGPParams(*(_t(arrays[f], device, dtype)
                        for f in CoGPParams._fields))


def cogp_params_to_numpy(params: CoGPParams) -> dict:
    return {f: getattr(params, f).detach().cpu().numpy()
            for f in CoGPParams._fields}


def learned_state_from_numpy(dyn: LearnedShiftInvariantDynamics,
                             params: Mapping[str, np.ndarray], device, dtype,
                             buf: Optional[Mapping[str, np.ndarray]] = None,
                             data: Optional[Mapping[str, np.ndarray]] = None,
                             cache: Optional[Mapping[str, np.ndarray]] = None
                             ) -> LearnedDynState:
    """A learner state with the given parameters, and optionally the
    reservoir `buf`, the fitted snapshot `data` and the posterior `cache`
    (field-name -> array mappings).  What is not given starts empty, as
    `init_state` makes it."""
    p = mvgp_params_from_numpy(params, device, dtype)
    batch = p.raw_outputscale.shape[0]
    base = dyn.init_state(batch, torch.Generator(device=device), device,
                          dtype)._replace(params=p)
    if buf is not None:
        base = base._replace(buf=MVGPData(*(
            _t(buf[f], device, dtype) for f in MVGPData._fields)))
    if data is not None:
        base = base._replace(data=MVGPData(*(
            _t(data[f], device, dtype) for f in MVGPData._fields)))
    if cache is not None:
        base = base._replace(cache=MVGPCache(*(
            _t(cache[f], device, dtype) for f in MVGPCache._fields)))
    return base


def serving_carry_from_numpy(sim, leaves):
    """The port's `CompiledController` carry from a JAX
    `CompiledController.state()` as a list of numpy arrays in JAX's leaf
    order (what `np.load` of its checkpoint gives, arr_0, arr_1, ...):
    x (n,), the seven MVGPParams, buf and data (X, UH, Xdot, mask each),
    the cache (L, alpha, Linv), prev_x, prev_u, have_prev, count_pairs,
    count_res, the PRNG key, then the warm state (x, S, Z) when the
    controller warm-starts.  Every tensor gains the episode axis of 1 and
    lives on the sim's device in its dtype.  The key is dropped: the port
    draws from its generator."""
    lrn = sim.learned_dynamics
    p0 = sim.planner.p0
    device, dtype = p0.device, p0.dtype
    it = iter([np.asarray(a)[None] for a in leaves])
    x = _t(next(it), device, dtype)
    take = lambda fields: {f: next(it) for f in fields}
    params = take(MVGPParams._fields)
    buf, data = take(MVGPData._fields), take(MVGPData._fields)
    cache = take(MVGPCache._fields)
    state = learned_state_from_numpy(lrn, params, device, dtype, buf=buf,
                                     data=data, cache=cache)
    prev_x, prev_u = (_t(next(it), device, dtype) for _ in range(2))
    have_prev = torch.as_tensor(np.array(next(it)), device=device).to(
        torch.bool)
    count_pairs, count_res = (torch.as_tensor(np.array(next(it)),
                                              device=device).to(torch.int32)
                              for _ in range(2))
    next(it)                                             # the PRNG key
    state = state._replace(prev_x=prev_x, prev_u=prev_u, have_prev=have_prev,
                           count_pairs=count_pairs, count_res=count_res)
    if not sim.controller.warm_start:
        return (x, state)
    return (x, state, tuple(_t(next(it), device, dtype) for _ in range(3)))
