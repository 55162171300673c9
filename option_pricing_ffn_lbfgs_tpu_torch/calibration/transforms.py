"""Unconstrained <-> constrained parameter transforms (last axis = 13).

exp for the 10 positive parameters, tanh for the two correlations, identity
for the jump mean — the JAX package's ``calibration/transforms.py``.

Index layout:
  0..3  v1_0, kappa1, theta1, sigma1   (exp)
  4     rho1                            (tanh)
  5..8  v2_0, kappa2, theta2, sigma2   (exp)
  9     rho2                            (tanh)
  10    lambda_j                        (exp)
  11    mu_j                            (identity)
  12    sigma_j                         (exp)
"""
from __future__ import annotations

import torch

from ..models.double_heston import DHParams

_EXP_IDX = (0, 1, 2, 3, 5, 6, 7, 8, 10, 12)
_TANH_IDX = (4, 9)
_MASKS = {}   # device -> (exp mask, tanh mask), built once per device


def _masks(x: torch.Tensor):
    if x.device not in _MASKS:
        exp_m = torch.zeros(13, dtype=torch.bool)
        exp_m[list(_EXP_IDX)] = True
        tanh_m = torch.zeros(13, dtype=torch.bool)
        tanh_m[list(_TANH_IDX)] = True
        _MASKS[x.device] = (exp_m.to(x.device), tanh_m.to(x.device))
    return _MASKS[x.device]


def transform(x: torch.Tensor) -> torch.Tensor:
    """Unconstrained R^13 -> model parameter vector."""
    exp_m, tanh_m = _masks(x)
    out = torch.where(exp_m, torch.exp(x), x)
    return torch.where(tanh_m, torch.tanh(x), out)


def dtransform_dx(x: torch.Tensor) -> torch.Tensor:
    """Diagonal of d transform / dx (transform is elementwise)."""
    exp_m, tanh_m = _masks(x)
    t = torch.tanh(x)
    out = torch.where(exp_m, torch.exp(x), torch.ones_like(x))
    return torch.where(tanh_m, 1.0 - t * t, out)


def inverse_transform(p: torch.Tensor) -> torch.Tensor:
    """Model parameter vector -> unconstrained R^13; correlations are
    clipped to [-0.999, 0.999] before arctanh, as the reference does."""
    exp_m, tanh_m = _masks(p)
    one = torch.ones_like(p)
    safe_pos = torch.where(exp_m, p, one)
    safe_rho = torch.clamp(torch.where(tanh_m, p, 0.0 * one), -0.999, 0.999)
    out = torch.where(exp_m, torch.log(safe_pos), p)
    return torch.where(tanh_m, torch.atanh(safe_rho), out)


def transform_to_params(x: torch.Tensor) -> DHParams:
    """Unconstrained vector(s) -> DHParams."""
    return DHParams.from_vector(transform(x))


def params_to_x(params: DHParams) -> torch.Tensor:
    """DHParams -> unconstrained vector(s)."""
    return inverse_transform(params.to_vector())
