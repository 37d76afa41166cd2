"""Carry state, fitted predictors, detectors, forecast fits, views, model
weights and the optimizer's state from the JAX package into the port, and
parameters, gradients and the optimizer's state back into JAX's layout.

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
from repro_torch.control.detector import DetectorConfig, StreamingDetector
from repro_torch.control.forecast import ForecastConfig, ForecastService
from repro_torch.core.predictors import (
    SVR,
    LinearRegression,
    MLPRegressor,
    RandomForestRegressor,
    XGBRegressor,
)
from repro_torch.core.predictors.mlp import MLP
from repro_torch.models.model import Model

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


def fold_from_numpy(fold, *, device) -> tuple:
    """A JAX ``scan_windows`` fold carry (det hist, mu, cusum, steps,
    fc A, b, err, count) -> the port's: tensors, with ``steps`` as the
    host integer the port's window loop counts with."""
    hist, mu, cusum, steps, A, b, err, count = fold
    f32 = [_tensor(a, torch.float32, device) for a in (hist, mu, cusum)]
    return (*f32, int(np.asarray(steps)),
            *[_tensor(a, torch.float32, device) for a in (A, b, err)],
            _tensor(count, torch.int32, device))


_FOREST_DTYPES = {"feature": torch.int64, "left": torch.int64,
                  "right": torch.int64, "threshold": torch.float32,
                  "value": torch.float32}


def _forest(forest, device) -> dict:
    return {k: _tensor(forest[k], dt, device)
            for k, dt in _FOREST_DTYPES.items()}


def forest_from_numpy(rf, *, device) -> RandomForestRegressor:
    """A fitted JAX ``RandomForestRegressor`` -> the port's, with the same
    flattened trees."""
    out = RandomForestRegressor(
        n_estimators=rf.n_estimators, max_depth=rf.max_depth,
        min_samples_leaf=rf.min_samples_leaf, feature_frac=rf.feature_frac,
        seed=rf.seed, device=device)
    out.forest = _forest(rf.forest, device)
    return out


# constructor arguments, then fitted float32 arrays, of the other models
_PREDICTORS = {
    "LinearRegression": (LinearRegression, ("reg",),
                         ("w", "mu", "sigma", "y_mu")),
    "SVR": (SVR, ("n_features", "gamma", "epsilon", "C", "lr", "steps",
                  "seed"),
            ("W", "phase", "w", "b", "mu", "sigma", "y_mu", "y_sigma")),
    "MLPRegressor": (MLPRegressor, ("hidden", "lr", "steps", "batch", "seed"),
                     ("mu", "sigma", "y_mu", "y_sigma")),
    "XGBRegressor": (XGBRegressor, ("n_estimators", "max_depth",
                                    "learning_rate", "reg_lambda",
                                    "subsample", "feature_frac",
                                    "min_samples_leaf", "seed"), ()),
}


def predictor_from_numpy(model, *, device):
    """A fitted JAX ``LinearRegression``, ``SVR``, ``MLPRegressor``,
    ``XGBRegressor`` or ``RandomForestRegressor`` -> the port's, holding
    the same fitted values."""
    name = type(model).__name__
    if name == "RandomForestRegressor":
        return forest_from_numpy(model, device=device)
    cls, args, arrays = _PREDICTORS[name]
    out = cls(**{a: getattr(model, a) for a in args}, device=device)
    for a in arrays:
        setattr(out, a, _tensor(getattr(model, a), torch.float32, device))
    if name == "MLPRegressor":
        out.model = MLP([{k: _tensor(v, torch.float32, device)
                          for k, v in layer.items()}
                         for layer in model.params])
    elif name == "XGBRegressor":
        out.forest = _forest(model.forest, device)
        out.base = float(model.base)
    return out


def detector_from_numpy(det, *, device) -> StreamingDetector:
    """A JAX ``StreamingDetector`` -> the port's, in the same state (its
    accumulators, step count, slot track and last outputs)."""
    out = StreamingDetector(det.n, DetectorConfig(**dataclasses.asdict(det.cfg)),
                            device=device)
    for k in ("hist", "mu", "cusum", "f_cusum"):
        setattr(out, k, _tensor(getattr(det, k), torch.float32, device))
    out.steps = int(np.asarray(det.steps))
    if det.num_slots is not None:
        out.num_slots = det.num_slots
        for k in ("slot_hist", "slot_prev", "slot_score"):
            setattr(out, k, _tensor(getattr(det, k), torch.float32, device))
    for k in ("slot_scores", "last_hot", "last_proactive"):
        v = getattr(det, k)
        setattr(out, k, None if v is None else np.array(v))
    out.last_diag = (None if det.last_diag is None else
                     {k: np.array(v) for k, v in det.last_diag.items()})
    return out


def forecast_service_from_numpy(state: dict, *, device, config=None,
                                horizon: float = 6.0) -> ForecastService:
    """A JAX ``ForecastService.state_dict()`` (numpy fits, cadence) -> a
    port ``ForecastService`` on ``device``, warm-started exactly as JAX's
    ``load_state_dict`` does (the clock of the last observation is not
    carried).  ``config`` is a JAX or port ``ForecastConfig``."""
    cfg = (None if config is None
           else ForecastConfig(**dataclasses.asdict(config)))
    svc = ForecastService(cfg, horizon, device=device)
    svc.load_state_dict(state)
    return svc


_VIEW_DTYPES = {"on_active": torch.bool, "on_type": torch.int32,
                "forecast_runqlat": torch.float64,
                "forecast_rho": torch.float64, "forecast_trusted": torch.bool}
_VIEW_HOST = ("t", "slot_uids", "node_class", "delay_base", "delay_scale",
              "rho_knee")


def view_from_numpy(view, *, device, fleet=None) -> ClusterView:
    """A JAX ``ClusterView`` -> the port's.  Telemetry becomes tensors
    (float fields float32: the JAX float64 features are float32 values
    widened, except the band masses, which round back to the same float32;
    the forecast projection stays float64); the uid map and float64 delay params stay numpy.  ``fleet`` is the
    port's ``Fleet`` to attach (the JAX view's fleet is not carried over).
    """
    kw = {}
    for f in dataclasses.fields(ClusterView):
        if not f.init:
            continue
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


def _fill(module, tree, where: str) -> None:
    """Copy ``tree[name]`` into each of ``module``'s own parameters."""
    own = dict(module.named_parameters(recurse=False))
    if set(own) != set(tree):
        raise ValueError(f"{where}: parameters {sorted(own)} != JAX's "
                         f"{sorted(tree)}")
    for name, p in own.items():
        a = np.asarray(tree[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{where}.{name}: shape {a.shape} != "
                             f"{tuple(p.shape)}")
        p.data.copy_(torch.as_tensor(np.array(a, dtype=np.float32)))


def model_params_from_numpy(cfg, tree, *, device) -> Model:
    """JAX ``models.model.init_params``' pytree -> the port's ``Model``.

    ``tree["groups"][i]`` stacks pattern position i over the ``repeats``
    axis: its entry r becomes layer ``r * len(pattern) + i``, as JAX's scan
    applies it; ``tree["tail"][j]`` follows them.  ``shared``, ``embed``,
    ``lm_head`` and ``final_norm`` map one to one; an ``embed_inputs``
    model has no ``embed`` (nor has JAX's tree), and a tree that has one
    where the model has none, or lacks one the model has, is refused.
    Arrays may be JAX's or numpy's; bfloat16 values pass through float32
    exactly.
    """
    model = Model(cfg, device=device)
    n = len(cfg.pattern)
    for i, group in enumerate(tree["groups"]):
        for r in range(cfg.repeats):
            _fill(model.layers[r * n + i],
                  {k: np.asarray(v)[r] for k, v in group.items()},
                  f"groups[{i}][{r}]")
    for j, layer in enumerate(tree["tail"]):
        _fill(model.layers[cfg.repeats * n + j], layer, f"tail[{j}]")
    if (model.shared is None) != ("shared" not in tree):
        raise ValueError("shared block present in one model only")
    if model.shared is not None:
        _fill(model.shared, tree["shared"], "shared")
    top = {k: v for k, v in tree.items()
           if k in ("embed", "lm_head", "final_norm")}
    _fill(model, top, "model")
    return model


def _jax_path(cfg, name: str) -> tuple:
    """The place of the port's parameter ``name`` in JAX's tree:
    ("groups", i, key, r) for layer r * len(pattern) + i, ("tail", j, key),
    ("shared", key) or (top-level key,)."""
    parts = name.split(".")
    if parts[0] == "layers":
        idx, key = int(parts[1]), parts[2]
        n = len(cfg.pattern)
        if idx < cfg.repeats * n:
            r, i = divmod(idx, n)
            return ("groups", i, key, r)
        return ("tail", idx - cfg.repeats * n, key)
    if parts[0] == "shared":
        return ("shared", parts[1])
    return (parts[0],)


def params_to_numpy(cfg, named) -> dict:
    """The port's parameters, or any name -> tensor dict over them (the
    gradients, the optimizer's ``master``, ``m`` or ``v``), as JAX's
    ``init_params`` tree of float32 numpy arrays: pattern position i's
    leaves stacked over ``repeats`` in ``groups[i]``, then ``tail``,
    ``shared``, ``embed``, ``final_norm``, ``lm_head``.  The inverse of
    ``model_params_from_numpy``'s map."""
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    tree: dict = {"groups": [{} for _ in cfg.pattern],
                  "tail": [{} for _ in cfg.tail]}
    stacks: dict = {}
    for name, t in named.items():
        a = t.detach().float().cpu().numpy()
        path = _jax_path(cfg, name)
        if path[0] == "groups":
            _, i, key, r = path
            stacks.setdefault((i, key), [None] * cfg.repeats)[r] = a
        elif path[0] == "tail":
            tree["tail"][path[1]][path[2]] = a
        elif path[0] == "shared":
            tree.setdefault("shared", {})[path[1]] = a
        else:
            tree[path[0]] = a
    for (i, key), rows in stacks.items():
        tree["groups"][i][key] = np.stack(rows)
    return tree


def _leaf(tree, path) -> np.ndarray:
    """The array at ``_jax_path``'s ``path`` of a JAX parameter tree."""
    if path[0] == "groups":
        _, i, key, r = path
        return np.asarray(tree["groups"][i][key])[r]
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def opt_state_from_numpy(cfg, opt: dict, *, device) -> dict:
    """JAX's AdamW state (``master``, ``m``, ``v`` trees, an int32
    ``step``, and ``comp_err`` with compression) -> the port's: float32
    tensors keyed by the port's parameter names, in the model's order, and
    ``step`` as an int."""
    names = [n for n, _ in Model(cfg, device="meta").named_parameters()]
    out = {}
    for key in ("master", "m", "v", "comp_err"):
        if key in opt:
            out[key] = {n: _tensor(_leaf(opt[key], _jax_path(cfg, n)),
                                   torch.float32, device) for n in names}
    out["step"] = int(np.asarray(opt["step"]))
    return out


def opt_state_to_numpy(cfg, opt: dict) -> dict:
    """The port's AdamW state -> JAX's layout (float32 numpy trees, an
    int32 ``step``)."""
    out = {k: params_to_numpy(cfg, opt[k])
           for k in ("master", "m", "v", "comp_err") if k in opt}
    out["step"] = np.int32(opt["step"])
    return out
