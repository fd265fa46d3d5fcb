"""Carry learner state across from numpy arrays (for example arrays a JAX
run produced) into the port, and back.

Every array carries the leading episode axis of the port's tensors.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .models.dynamics import LearnedDynState, LearnedShiftInvariantDynamics
from .models.mvgp import MVGPCache, MVGPData, MVGPParams


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def mvgp_params_from_numpy(arrays: Mapping[str, np.ndarray], device,
                           dtype) -> MVGPParams:
    """MVGPParams from a mapping of its seven field names to arrays."""
    return MVGPParams(*(_t(arrays[f], device, dtype)
                        for f in MVGPParams._fields))


def mvgp_params_to_numpy(params: MVGPParams) -> dict:
    return {f: getattr(params, f).detach().cpu().numpy()
            for f in MVGPParams._fields}


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
