"""Carry state, forests and views from the JAX package into the port.

Each function reads only attributes and numpy-convertible arrays of the
object it is given, so this module imports nothing of ``repro`` or
``jax``; a caller that holds JAX arrays passes them as they are (numpy's
``asarray`` reads them) or as numpy arrays.  The parity tests use these
functions so that both packages compute on the same inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cluster.state import ClusterState, FleetParams
from repro_torch.cluster.view import ClusterView
from repro_torch.core.predictors.forest import RandomForestRegressor

_STATE_DTYPES = {
    "on_active": torch.bool, "on_type": torch.int32,
    "off_active": torch.bool, "off_remaining": torch.int32,
}


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def state_from_numpy(obj, *, device):
    """A JAX ``ClusterState``, ``FleetParams`` or profiles dict -> the
    port's ``ClusterState``, ``FleetParams`` or profiles dict of tensors."""
    if isinstance(obj, dict):
        return {k: _tensor(v, torch.float32, device) for k, v in obj.items()}
    cls = FleetParams if hasattr(obj, "delay_base") else ClusterState
    return cls(**{
        f.name: _tensor(getattr(obj, f.name),
                        _STATE_DTYPES.get(f.name, torch.float32), device)
        for f in dataclasses.fields(cls)
    })


def forest_from_numpy(rf, *, device) -> RandomForestRegressor:
    """A fitted JAX ``RandomForestRegressor`` -> the port's, with the same
    flattened trees."""
    out = RandomForestRegressor(
        n_estimators=rf.n_estimators, max_depth=rf.max_depth,
        min_samples_leaf=rf.min_samples_leaf, feature_frac=rf.feature_frac,
        seed=rf.seed, device=device)
    dtypes = {"feature": torch.int64, "left": torch.int64,
              "right": torch.int64, "threshold": torch.float32,
              "value": torch.float32}
    out.forest = {k: _tensor(rf.forest[k], dt, device)
                  for k, dt in dtypes.items()}
    return out


_VIEW_DTYPES = {"on_active": torch.bool, "on_type": torch.int32}
_VIEW_HOST = ("t", "slot_uids", "node_class", "delay_base", "delay_scale",
              "rho_knee")


def view_from_numpy(view, *, device, fleet=None) -> ClusterView:
    """A JAX ``ClusterView`` -> the port's.  Telemetry becomes tensors
    (float fields float32: the JAX float64 features are float32 values
    widened, except the band masses, which round back to the same float32);
    the uid map and float64 delay params stay numpy.  ``fleet`` is the
    port's ``Fleet`` to attach (the JAX view's fleet is not carried over).
    """
    kw = {}
    for f in dataclasses.fields(ClusterView):
        v = getattr(view, f.name, None)
        if v is None or f.name == "fleet":
            continue
        if f.name in _VIEW_HOST:
            kw[f.name] = (np.array(v) if isinstance(v, np.ndarray)
                          else v)
        else:
            kw[f.name] = _tensor(v, _VIEW_DTYPES.get(f.name, torch.float32),
                                 device)
    return ClusterView(fleet=fleet, **kw)
