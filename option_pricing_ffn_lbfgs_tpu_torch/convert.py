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
    ``x0`` tensor the port's calibrate entry points accept.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from .models.double_heston import PARAM_NAMES, DHParams
from .utils import config as _config


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
