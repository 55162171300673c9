"""Double Heston + Merton jump-diffusion model: COS pricing in PyTorch.

Plain-tensor counterpart of ``option_pricing_ffn_lbfgs_tpu/models/
double_heston.py``: the characteristic function is evaluated over a
``[..., n_options, N_terms]`` grid in split real/imag arithmetic, so the
same code runs at float32 or float64 and differentiates with autograd or
``torch.func`` forward mode. It is the plain version of the K1 kernel
(``ops/cos_kernel.py``) and of the pricing inside K2/K3
(``ops/loss_kernel.py``), and the formulas are those of
``csrc/cos_math.cuh`` in the same order of operations.

Reference quirks kept on purpose (so prices match the reference):
  * ``r*tau`` is counted once per variance factor in the c1 cumulant;
  * the truncation range is widened to ``log(K/S0) -/+ 0.1``;
  * the k=0 COS term is half-weighted;
  * the k=0 payoff coefficients take their limit values through a double
    ``where`` so no NaN reaches a derivative.

Batching: parameter fields, ``spot`` and ``rate`` broadcast over any
leading batch shape ``[...]``; strikes/maturities/is_call are
``[..., n_options]``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import complex_math as cm

PARAM_NAMES = (
    "v1_0", "kappa1", "theta1", "sigma1", "rho1",
    "v2_0", "kappa2", "theta2", "sigma2", "rho2",
    "lambda_j", "mu_j", "sigma_j",
)


class DHParams(NamedTuple):
    """The 13 Double Heston + jump parameters; each field a tensor with the
    batch shape (or a scalar). Field order is the reference's."""
    v1_0: torch.Tensor
    kappa1: torch.Tensor
    theta1: torch.Tensor
    sigma1: torch.Tensor
    rho1: torch.Tensor
    v2_0: torch.Tensor
    kappa2: torch.Tensor
    theta2: torch.Tensor
    sigma2: torch.Tensor
    rho2: torch.Tensor
    lambda_j: torch.Tensor
    mu_j: torch.Tensor
    sigma_j: torch.Tensor

    @classmethod
    def from_vector(cls, x: torch.Tensor) -> "DHParams":
        return cls(*(x[..., i] for i in range(13)))

    @classmethod
    def from_dict(cls, d, dtype=torch.float64, device="cpu") -> "DHParams":
        return cls(*(torch.as_tensor(d[k], dtype=dtype, device=device)
                     for k in PARAM_NAMES))

    def to_vector(self) -> torch.Tensor:
        return torch.stack(list(self), dim=-1)

    def to_dict(self):
        return dict(zip(PARAM_NAMES, self))


def _heston_factor_B_and_Aterm(u, tau, kappa, theta, sigma, rho):
    """One Heston factor's (B, A_term): it adds ``A_term + B * v0`` to the
    CF exponent (reference double_heston.py:64-91)."""
    sig2 = sigma * sigma
    xi = (kappa.expand(u.shape), -rho * sigma * u)
    inner_re = kappa * kappa + sig2 * u * u * (1.0 - rho * rho)
    inner_im = sig2 * u - 2.0 * kappa * rho * sigma * u
    d = cm.csqrt((inner_re, inner_im))
    xi_m_d = cm.csub(xi, d)
    xi_p_d = cm.cadd(xi, d)
    g = cm.cdiv(xi_m_d, xi_p_d)
    e = cm.cexp((-d[0] * tau, -d[1] * tau))
    one = (torch.ones_like(u), torch.zeros_like(u))
    ge = cm.cmul(g, e)
    one_m_ge = cm.csub(one, ge)
    B = cm.cmul(cm.cscale(xi_m_d, 1.0 / sig2),
                cm.cdiv(cm.csub(one, e), one_m_ge))
    log_ratio = cm.clog(cm.cdiv(one_m_ge, cm.csub(one, g)))
    inner = cm.csub(cm.cscale(xi_m_d, tau), cm.cscale(log_ratio, 2.0))
    A_term = cm.cscale(inner, kappa * theta / sig2)
    return B, A_term


def char_fn(u, tau, params: DHParams, r, q=0.0):
    """phi(u; tau) of log(S_T/S_0) under Double Heston + Merton jumps, at
    real frequencies ``u``; returns a split-complex pair of ``u.shape``."""
    p = params
    B1, A1 = _heston_factor_B_and_Aterm(u, tau, p.kappa1, p.theta1,
                                        p.sigma1, p.rho1)
    B2, A2 = _heston_factor_B_and_Aterm(u, tau, p.kappa2, p.theta2,
                                        p.sigma2, p.rho2)
    compensator = torch.exp(p.mu_j + 0.5 * p.sigma_j * p.sigma_j) - 1.0
    drift = r - q - p.lambda_j * compensator
    A = (torch.zeros_like(u), drift * u * tau)
    A = cm.cadd(A, A1)
    A = cm.cadd(A, A2)
    expo = cm.cadd(A, cm.cadd(cm.cscale(B1, p.v1_0), cm.cscale(B2, p.v2_0)))
    cf_heston = cm.cexp(expo)
    jamp = torch.exp(-0.5 * p.sigma_j * p.sigma_j * u * u)
    jr = jamp * torch.cos(u * p.mu_j) - 1.0
    ji = jamp * torch.sin(u * p.mu_j)
    cf_jump = cm.cexp((p.lambda_j * tau * jr, p.lambda_j * tau * ji))
    return cm.cmul(cf_heston, cf_jump)


def _factor_cumulants(tau, r, v0, kappa, theta, sigma, rho):
    """Fang–Oosterlee c1/c2 cumulants of one Heston factor (reference
    double_heston.py:101-118, r*tau included per factor)."""
    lm, v_bar, volvol = kappa, theta, sigma
    e1 = torch.exp(-lm * tau)
    c1 = r * tau + (1.0 - e1) * (v_bar - v0) / (2.0 * lm) - v_bar * tau / 2.0
    c2 = (1.0 / (8.0 * lm**3)) * (
        volvol * tau * lm * e1 * (v0 - v_bar) * (8.0 * lm * rho - 4.0 * volvol)
        + lm * rho * volvol * (1.0 - e1) * (16.0 * v_bar - 8.0 * v0)
        + 2.0 * v_bar * lm * tau * (-4.0 * lm * rho * volvol + volvol**2
                                    + 4.0 * lm**2)
        + volvol**2 * ((v_bar - 2.0 * v0) * torch.exp(-2.0 * lm * tau)
                       + v_bar * (6.0 * e1 - 7.0) + 2.0 * v0)
        + 8.0 * lm**2 * (v0 - v_bar) * (1.0 - e1)
    )
    return c1, c2


def truncation_range(params: DHParams, tau, strike, spot, r, L=10.0):
    """COS truncation interval [a, b] per option (reference
    double_heston.py:100-139); broadcast over tau/strike."""
    p = params
    c1_f1, c2_f1 = _factor_cumulants(tau, r, p.v1_0, p.kappa1, p.theta1,
                                     p.sigma1, p.rho1)
    c1_f2, c2_f2 = _factor_cumulants(tau, r, p.v2_0, p.kappa2, p.theta2,
                                     p.sigma2, p.rho2)
    c1_j = p.lambda_j * tau * p.mu_j
    c2_j = p.lambda_j * tau * (p.sigma_j**2 + p.mu_j**2)
    c1 = c1_f1 + c1_f2 + c1_j
    c2 = c2_f1 + c2_f2 + c2_j
    spread = L * torch.sqrt(torch.abs(c2))
    a = c1 - spread
    b = c1 + spread
    log_k = torch.log(strike / spot)
    a = torch.minimum(a, log_k - 0.1)
    b = torch.maximum(b, log_k + 0.1)
    return a, b


def payoff_coefficients(k, a, b, log_k, spot, strike, is_call):
    """COS payoff coefficients V_k over ``[..., n, N]`` (reference
    double_heston.py:141-158, 174-185): calls integrate over [log K, b],
    puts over [a, log K]; the k=0 column uses the chi/psi limits."""
    width = b - a
    u = k * (math.pi / width)
    c = torch.where(is_call, log_k, a)
    d = torch.where(is_call, b, log_k)
    k0 = k == 0
    safe_u = torch.where(k0, torch.ones_like(u), u)
    cos_d = torch.cos(safe_u * (d - a))
    cos_c = torch.cos(safe_u * (c - a))
    sin_d = torch.sin(safe_u * (d - a))
    sin_c = torch.sin(safe_u * (c - a))
    ed, ec = torch.exp(d), torch.exp(c)
    chi_gen = ((cos_d * ed - cos_c * ec + safe_u * (sin_d * ed - sin_c * ec))
               / (1.0 + safe_u * safe_u))
    chi = torch.where(k0, ed - ec, chi_gen)
    psi_gen = (sin_d - sin_c) / safe_u
    psi = torch.where(k0, d - c, psi_gen)
    two_over = 2.0 / width
    v_call = two_over * (spot * chi - strike * psi)
    v_put = two_over * (strike * psi - spot * chi)
    return torch.where(is_call, v_call, v_put)


def price_options(params: DHParams, spot, rate, strikes, maturities, is_call,
                  n_terms: int = 128, L: float = 10.0, q: float = 0.0):
    """Price European options, batched over a leading surface axis.

    Args:
      params: DHParams whose fields have the batch shape ``[...]`` (or are
        scalars).
      spot: ``[...]`` or scalar; rate: scalar.
      strikes, maturities: ``[..., n]`` tensors; is_call: ``[..., n]`` bool.
    Returns:
      ``[..., n]`` prices in the dtype and on the device of ``strikes``.
    """
    strikes = torch.as_tensor(strikes)
    dt, dev = strikes.dtype, strikes.device
    col = lambda v: torch.as_tensor(v, dtype=dt, device=dev)[..., None, None]
    p = DHParams(*(col(v) for v in params))
    spot = col(spot)
    rate = torch.as_tensor(rate, dtype=dt, device=dev)
    strikes = strikes[..., None]                                   # [..,n,1]
    taus = torch.as_tensor(maturities, dtype=dt, device=dev)[..., None]
    is_call = torch.as_tensor(is_call, device=dev)[..., None]
    a, b = truncation_range(p, taus, strikes, spot, rate, L)       # [..,n,1]
    log_k = torch.log(strikes / spot)
    k = torch.arange(n_terms, dtype=dt, device=dev)                # [N]
    u = k * (math.pi / (b - a))                                    # [..,n,N]
    phi_re, phi_im = char_fn(u, taus, p, rate, q)
    v = payoff_coefficients(k, a, b, log_k, spot, strikes, is_call)
    ua = u * a
    terms = (phi_re * torch.cos(ua) + phi_im * torch.sin(ua)) * v
    w = torch.where(k == 0, 0.5, 1.0).to(dt)
    series = torch.sum(terms * w, dim=-1)
    return torch.exp(-rate * taus[..., 0]) * series


def price_single(params: DHParams, spot, strike, tau, rate, is_call=True,
                 n_terms: int = 128, L: float = 10.0, q: float = 0.0):
    """Price one option; returns a 0-d tensor in the dtype (float32 at
    least) and on the device of ``strike``. Goes through
    ``ops/cos_kernel.price_surfaces``, so on a CUDA tensor it launches K1
    and on a CPU tensor it runs the plain pricer."""
    from ..ops.cos_kernel import price_surfaces
    strike = torch.as_tensor(strike)
    dt = torch.promote_types(strike.dtype, torch.float32)
    dev = strike.device
    col = lambda v: torch.as_tensor(v, dtype=dt, device=dev).reshape(1, 1)
    vec = torch.stack([torch.as_tensor(v, dtype=dt, device=dev).reshape(())
                       for v in params])[None]
    out = price_surfaces(vec, col(spot).reshape(1), rate, col(strike),
                         col(tau), torch.tensor([[bool(is_call)]], device=dev),
                         n_terms=n_terms, L=L, q=q)
    return out[0, 0]
