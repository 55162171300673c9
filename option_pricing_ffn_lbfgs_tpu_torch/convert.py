"""Carry state across from the JAX package into the port.

Everything crosses as plain Python or numpy values, so this module needs
neither ``jax`` nor the JAX package:

  * ``to_param_tensor`` / ``to_dhparams``: a 13-vector (array, list, or a
    ``[..., 13]`` batch), a ``{name: value}`` dict, or any NamedTuple with
    the 13 parameter fields (e.g. a JAX ``DHParams``) -> tensor / port
    ``DHParams``;
  * ``config_from_dict``: ``dataclasses.asdict`` of a JAX config
    (``CalibrationConfig``, ``LMConfig``, ...) -> the port's dataclass;
  * ``x0_from_numpy``: JAX starts (``[B, S, 13]`` unconstrained) -> the
    ``x0`` tensor the port's calibrate entry points accept;
  * ``load_pickle``: read a pickle written by the JAX package (a dataset
    of ``CalibrationResult`` records, a surrogate, scalers) without
    importing it: its classes map to the port's twins;
  * ``ffn_state_dict_from_flax`` / ``flax_from_ffn_state_dict``: the
    surrogate's Flax variables <-> a ``SurrogateFFN`` state_dict;
    ``load_surrogate_numpy`` reads the shipped ``ffn_surrogate.pkl``.
"""
from __future__ import annotations

import collections
import dataclasses
import pickle
import typing

import numpy as np
import torch

from .models.double_heston import PARAM_NAMES, DHParams
from .surrogate import scalers as _scalers
from .utils import config as _config
from .utils import results as _results


def to_param_tensor(p, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """``[..., 13]`` tensor of constrained parameters in PARAM_NAMES order."""
    if isinstance(p, dict):
        arr = np.stack([np.asarray(p[k], np.float64) for k in PARAM_NAMES],
                       axis=-1)
    elif hasattr(p, "_fields"):
        arr = np.stack([np.asarray(getattr(p, k), np.float64)
                        for k in PARAM_NAMES], axis=-1)
    else:
        arr = np.asarray(p, np.float64)
    if arr.shape[-1] != 13:
        raise ValueError(f"expected 13 parameters, got shape {arr.shape}")
    return torch.as_tensor(arr, dtype=dtype, device=device)


def to_dhparams(p, dtype=torch.float64, device="cpu") -> DHParams:
    return DHParams.from_vector(to_param_tensor(p, dtype, device))


def config_from_dict(cls, d: dict):
    """Build the port dataclass ``cls`` from ``dataclasses.asdict`` output,
    recursing into nested config fields and turning lists into tuples."""
    hints = typing.get_type_hints(cls, vars(_config))
    kwargs = {}
    for field in dataclasses.fields(cls):
        if field.name not in d:
            continue
        value, hint = d[field.name], hints[field.name]
        if dataclasses.is_dataclass(hint):
            value = config_from_dict(hint, value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[field.name] = value
    return cls(**kwargs)


def x0_from_numpy(x0, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """JAX ``initial_guesses`` output ``[B, S, 13]`` -> port ``x0``."""
    x0 = np.array(x0)   # a copy: arrays handed over from JAX are read-only
    if x0.ndim != 3 or x0.shape[-1] != 13:
        raise ValueError(f"x0 must be [B, S, 13], got {x0.shape}")
    return torch.as_tensor(x0, dtype=dtype, device=device)


# JAX-package classes that cross in pickles -> the port's twins (same
# fields, same pickle layout).
_PORT_CLASSES = {
    ("option_pricing_ffn_lbfgs_tpu.surrogate.scalers", "StandardScaler"):
        _scalers.StandardScaler,
    ("option_pricing_ffn_lbfgs_tpu.utils.results", "CalibrationResult"):
        _results.CalibrationResult,
}
_JAX_PACKAGE = "option_pricing_ffn_lbfgs_tpu"


class _PortUnpickler(pickle.Unpickler):
    """Maps the JAX package's classes to the port's, refuses any other
    class of the JAX package (loading it would import JAX), and maps
    numpy 2's ``numpy._core`` to ``numpy.core`` under an older numpy."""

    def find_class(self, module, name):
        if (module, name) in _PORT_CLASSES:
            return _PORT_CLASSES[module, name]
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            raise pickle.UnpicklingError(
                f"{module}.{name} has no twin in the port")
        if module.startswith("numpy._core") and \
                int(np.__version__.split(".")[0]) < 2:
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def load_pickle(path):
    """Unpickle a file written by either package (only files this project
    wrote: unpickling runs code)."""
    with open(path, "rb") as f:
        return _PortUnpickler(f).load()


def ffn_state_dict_from_flax(variables, dtype=torch.float32
                             ) -> "collections.OrderedDict":
    """Flax ``{"params", "batch_stats"}`` of ``SurrogateFFN`` -> the port's
    ``SurrogateFFN`` state_dict at ``dtype``. Dense ``kernel [in, out]``
    becomes ``weight [out, in]``; BatchNorm ``scale``/``bias`` become
    ``weight``/``bias`` and ``mean``/``var`` ``running_mean``/
    ``running_var``."""
    params, stats = variables["params"], variables["batch_stats"]
    n_hidden = len(stats)
    t = lambda a: torch.as_tensor(np.array(a), dtype=dtype)
    out = collections.OrderedDict()
    for i in range(n_hidden):
        dense, bn, bs = (params[f"Dense_{i}"], params[f"BatchNorm_{i}"],
                         stats[f"BatchNorm_{i}"])
        out[f"dense.{i}.weight"] = t(dense["kernel"]).T.contiguous()
        out[f"dense.{i}.bias"] = t(dense["bias"])
        out[f"norm.{i}.weight"] = t(bn["scale"])
        out[f"norm.{i}.bias"] = t(bn["bias"])
        out[f"norm.{i}.running_mean"] = t(bs["mean"])
        out[f"norm.{i}.running_var"] = t(bs["var"])
        out[f"norm.{i}.num_batches_tracked"] = torch.tensor(0)
    head = params[f"Dense_{n_hidden}"]
    out["head.weight"] = t(head["kernel"]).T.contiguous()
    out["head.bias"] = t(head["bias"])
    return out


def flax_from_ffn_state_dict(state) -> dict:
    """The inverse of ``ffn_state_dict_from_flax``: numpy Flax variables."""
    a = lambda k: state[k].detach().cpu().numpy()
    n_hidden = sum(1 for k in state if k.endswith("running_mean"))
    params, stats = {}, {}
    for i in range(n_hidden):
        params[f"Dense_{i}"] = {"kernel": a(f"dense.{i}.weight").T.copy(),
                                "bias": a(f"dense.{i}.bias")}
        params[f"BatchNorm_{i}"] = {"scale": a(f"norm.{i}.weight"),
                                    "bias": a(f"norm.{i}.bias")}
        stats[f"BatchNorm_{i}"] = {"mean": a(f"norm.{i}.running_mean"),
                                   "var": a(f"norm.{i}.running_var")}
    params[f"Dense_{n_hidden}"] = {"kernel": a("head.weight").T.copy(),
                                   "bias": a("head.bias")}
    return {"params": params, "batch_stats": stats}


def load_surrogate_numpy(path) -> dict:
    """A surrogate pickle (``{"variables", "feature_scaler",
    "target_scaler"}``, as the JAX package's ``save_surrogate`` writes it)
    with numpy variables and the port's scalers."""
    d = load_pickle(path)
    missing = {"variables", "feature_scaler", "target_scaler"} - set(d)
    if missing:
        raise ValueError(f"{path} is not a surrogate pickle: no {missing}")
    return d
