"""Greeks of the Double Heston + jump model by automatic differentiation.

Port of the JAX package's ``models/greeks.py``. Every sensitivity is one
``torch.func`` transform of the plain pricer ``price_options`` (no
kernel: K1 carries no tangents, and JAX runs these as XLA with no Pallas
kernel): forward mode (``jacfwd``) for the scalar inputs, a nested
``jacfwd`` for gamma, reverse mode (``grad`` of the sum) for theta, since
each price depends on its own maturity only. The pricer's k = 0 and
``csqrt`` double ``where``s keep every tangent finite.

They run on the caller's device: ``device=None`` means the device of
``strikes`` if it is a tensor, else ``cuda``; a CPU run passes
``device="cpu"`` (or CPU tensors). The dtype is that of ``strikes``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .double_heston import PARAM_NAMES, DHParams, price_options


class Greeks(NamedTuple):
    price: torch.Tensor    # [n]
    delta: torch.Tensor    # dV/dS            [n]
    gamma: torch.Tensor    # d2V/dS2          [n]
    theta: torch.Tensor    # -dV/dtau         [n]
    rho: torch.Tensor      # dV/dr            [n]
    vega1: torch.Tensor    # dV/d sqrt(v1_0)  [n] (factor-1 spot-vol greek)
    vega2: torch.Tensor    # dV/d sqrt(v2_0)  [n]


def _surface(params, spot, rate, strikes, maturities, is_call, device):
    """The inputs as tensors of ``strikes``' dtype on the resolved device."""
    if device is None:
        device = (strikes.device if isinstance(strikes, torch.Tensor)
                  else "cuda")
    strikes = torch.as_tensor(strikes, device=device)
    dt, dev = strikes.dtype, strikes.device
    t = lambda v: torch.as_tensor(v, dtype=dt, device=dev)
    return (DHParams(*(t(v) for v in params)), t(spot), t(rate), strikes,
            t(maturities), torch.as_tensor(is_call, device=dev))


def greeks(params: DHParams, spot, rate, strikes, maturities, is_call,
           n_terms: int = 128, L: float = 10.0, q: float = 0.0,
           device=None) -> Greeks:
    """All standard Greeks of one surface ``[n]``; vega1/vega2 are per unit
    of factor spot-vol (chain rule through v0 = vol^2)."""
    params, spot, rate, strikes, taus, is_call = _surface(
        params, spot, rate, strikes, maturities, is_call, device)

    def p_of(s, r, tau, v1, v2):
        pp = params._replace(v1_0=v1, v2_0=v2)
        return price_options(pp, s, r, strikes, tau, is_call,
                             n_terms=n_terms, L=L, q=q)

    args = (spot, rate, taus, params.v1_0, params.v2_0)
    jac = lambda i: torch.func.jacfwd(p_of, argnums=i)
    price = p_of(*args)
    delta = jac(0)(*args)
    gamma = torch.func.jacfwd(jac(0), argnums=0)(*args)
    g_r, g_v1, g_v2 = jac(1)(*args), jac(3)(*args), jac(4)(*args)
    g_tau = torch.func.grad(
        lambda tau: torch.sum(p_of(spot, rate, tau, args[3], args[4])))(taus)
    return Greeks(price=price, delta=delta, gamma=gamma, theta=-g_tau,
                  rho=g_r, vega1=g_v1 * 2.0 * torch.sqrt(params.v1_0),
                  vega2=g_v2 * 2.0 * torch.sqrt(params.v2_0))


def param_sensitivities(params: DHParams, spot, rate, strikes, maturities,
                        is_call, n_terms: int = 128, L: float = 10.0,
                        q: float = 0.0,
                        device=None) -> Dict[str, torch.Tensor]:
    """Jacobian of every option price with respect to the 13 model
    parameters, one ``jacfwd`` pass: ``{param_name: [n]}``."""
    params, spot, rate, strikes, taus, is_call = _surface(
        params, spot, rate, strikes, maturities, is_call, device)

    def f(v):
        return price_options(DHParams.from_vector(v), spot, rate, strikes,
                             taus, is_call, n_terms=n_terms, L=L, q=q)

    jac = torch.func.jacfwd(f)(params.to_vector())      # [n, 13]
    return {name: jac[:, i] for i, name in enumerate(PARAM_NAMES)}
