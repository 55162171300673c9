"""Double-float (two-float32) COS pricer: an oracle for the float64 one.

Port of the JAX package's ``models/double_heston_dd.py``, the twin of
``models/double_heston.py`` built from float32 operations alone
(``ops/doublefloat.py``, ``ops/complex_dd.py``): the same formulas, the
same truncation quirks (``r*tau`` once per factor in c1, the range widened
to ``log(K/S0) -/+ 0.1``), the same half weight of the k = 0 term. The
JAX package measured median 9.6e-13 and worst 3.7e-12 relative against
its float64 pricer on 200 generator-range surfaces.

This package does not price the polish with it: the card has native
float64 and the polish's residuals go through K1<double> for either
``residual_impl``. It is the check of K1<double> whose arithmetic is not
float64 (``chip_smoke.py`` phase 17, ``tests/test_torch_doublefloat.py``).

Every number inside is a DD ``(hi, lo)`` of float32 tensors, a complex
value a pair of DDs; inputs and outputs cross the boundary as float64.
Batching: parameter fields and ``spot`` broadcast over a leading batch
shape ``[...]``; strikes, maturities and is_call are ``[..., n]``; the
frequency grid is ``[..., n, N]``. The device is the strikes' device.
"""
from __future__ import annotations

import math

import torch

from ..ops import complex_dd as cz
from ..ops import doublefloat as df
from .double_heston import DHParams


def _dd_params(params: DHParams) -> DHParams:
    """DHParams of float64 tensors -> DHParams of DD pairs."""
    return DHParams(*(df.from_f64(p) for p in params))


def _factor_B_and_Aterm(u_re, tau, kappa, theta, sigma, rho):
    """DD twin of double_heston._heston_factor_B_and_Aterm.

    u_re: DD [..., n, N]; tau: DD [..., n, 1]; params: DD [..., 1, 1].
    Returns (B, A_term) as complex DD pairs.
    """
    sig2 = df.sqr(sigma)
    rho_sig = df.mul(rho, sigma)
    # xi = kappa - i*rho*sigma*u
    xi = (df.add(df.mul_f(u_re, 0.0), kappa),   # broadcast kappa to grid
          df.neg(df.mul(rho_sig, u_re)))
    # inner = kappa^2 + sig2*u^2*(1-rho^2) + i*(sig2*u - 2*kappa*rho*sigma*u)
    u2 = df.sqr(u_re)
    one_m_rho2 = df.sub(df.dd_const(1.0, like=rho), df.sqr(rho))
    inner_re = df.add(df.sqr(kappa), df.mul(df.mul(sig2, u2), one_m_rho2))
    inner_im = df.sub(df.mul(sig2, u_re),
                      df.mul(df.mul_f(df.mul(kappa, rho_sig), 2.0), u_re))
    d = cz.csqrt((inner_re, inner_im))
    xi_m_d = cz.csub(xi, d)
    xi_p_d = cz.cadd(xi, d)
    g = cz.cdiv(xi_m_d, xi_p_d)
    # e = exp(-d * tau)
    e = cz.cexp((df.neg(df.mul(d[0], tau)), df.neg(df.mul(d[1], tau))))
    one = cz.cconst(1.0, 0.0, like=u_re)
    ge = cz.cmul(g, e)
    one_m_ge = cz.csub(one, ge)
    inv_sig2 = df.recip(sig2)
    B = cz.cmul(cz.cscale(xi_m_d, inv_sig2),
                cz.cdiv(cz.csub(one, e), one_m_ge))
    log_ratio = cz.clog(cz.cdiv(one_m_ge, cz.csub(one, g)))
    inner = cz.csub(cz.cscale(xi_m_d, tau), cz.cscale_f(log_ratio, 2.0))
    A_term = cz.cscale(inner, df.mul(df.mul(kappa, theta), inv_sig2))
    return B, A_term


def char_fn_dd(u_re, tau, p: DHParams, r, q):
    """CF of log(S_T/S_0) on the DD grid (twin of double_heston.char_fn).

    u_re: DD [..., n, N]; tau: DD [..., n, 1]; p: DD params; r, q: DD.
    """
    B1, A1 = _factor_B_and_Aterm(u_re, tau, p.kappa1, p.theta1, p.sigma1,
                                 p.rho1)
    B2, A2 = _factor_B_and_Aterm(u_re, tau, p.kappa2, p.theta2, p.sigma2,
                                 p.rho2)
    # drift = r - q - lambda_j*(exp(mu_j + sigma_j^2/2) - 1)
    comp = df.add_f(df.exp(df.add(p.mu_j, df.mul_f(df.sqr(p.sigma_j), 0.5))),
                    -1.0)
    drift = df.sub(df.sub(r, q), df.mul(p.lambda_j, comp))
    A = (df.mul_f(u_re, 0.0), df.mul(df.mul(drift, tau), u_re))
    A = cz.cadd(A, A1)
    A = cz.cadd(A, A2)
    expo = cz.cadd(A, cz.cadd(cz.cscale(B1, p.v1_0), cz.cscale(B2, p.v2_0)))
    cf_heston = cz.cexp(expo)
    # jump CF: exp(lambda*tau*(exp(i*u*mu - sig^2 u^2/2) - 1))
    jamp = df.exp(df.neg(df.mul(df.mul_f(df.sqr(p.sigma_j), 0.5),
                                df.sqr(u_re))))
    umu = df.mul(u_re, p.mu_j)
    s_umu, c_umu = df.sincos(umu)
    jr = df.add_f(df.mul(jamp, c_umu), -1.0)
    ji = df.mul(jamp, s_umu)
    lt = df.mul(p.lambda_j, tau)
    cf_jump = cz.cexp((df.mul(lt, jr), df.mul(lt, ji)))
    return cz.cmul(cf_heston, cf_jump)


def _factor_cumulants_dd(tau, r, v0, kappa, theta, sigma, rho):
    """DD twin of double_heston._factor_cumulants (same r*tau quirk)."""
    one = df.dd_const(1.0, like=tau)
    e1 = df.exp(df.neg(df.mul(kappa, tau)))
    one_m_e1 = df.sub(one, e1)
    # c1 = r*tau + (1-e1)*(theta - v0)/(2 kappa) - theta*tau/2
    c1 = df.add(df.mul(r, tau),
                df.sub(df.div(df.mul(one_m_e1, df.sub(theta, v0)),
                              df.mul_f(kappa, 2.0)),
                       df.mul_f(df.mul(theta, tau), 0.5)))
    k2 = df.sqr(kappa)
    k3 = df.mul(k2, kappa)
    s2 = df.sqr(sigma)
    t1 = df.mul(df.mul(df.mul(df.mul(sigma, tau), kappa), e1),
                df.mul(df.sub(v0, theta),
                       df.sub(df.mul_f(df.mul(kappa, rho), 8.0),
                              df.mul_f(sigma, 4.0))))
    t2 = df.mul(df.mul(df.mul(kappa, rho), sigma),
                df.mul(one_m_e1,
                       df.sub(df.mul_f(theta, 16.0),
                              df.mul_f(v0, 8.0))))
    t3 = df.mul(df.mul_f(df.mul(df.mul(theta, kappa), tau), 2.0),
                df.add(df.sub(s2,
                              df.mul_f(df.mul(df.mul(kappa, rho), sigma),
                                       4.0)),
                       df.mul_f(k2, 4.0)))
    e2 = df.exp(df.mul_f(df.neg(df.mul(kappa, tau)), 2.0))
    t4 = df.mul(s2, df.add(
        df.add(df.mul(df.sub(theta, df.mul_f(v0, 2.0)), e2),
               df.mul(theta, df.add_f(df.mul_f(e1, 6.0), -7.0))),
        df.mul_f(v0, 2.0)))
    t5 = df.mul(df.mul_f(k2, 8.0), df.mul(df.sub(v0, theta), one_m_e1))
    total = df.add(df.add(df.add(t1, t2), df.add(t3, t4)), t5)
    c2 = df.div(total, df.mul_f(k3, 8.0))
    return c1, c2


def truncation_range_dd(p: DHParams, tau, strike, spot, r, L):
    """DD twin of double_heston.truncation_range (per-option [a, b]);
    returns (a, b, log(K/S0))."""
    c1_f1, c2_f1 = _factor_cumulants_dd(tau, r, p.v1_0, p.kappa1, p.theta1,
                                        p.sigma1, p.rho1)
    c1_f2, c2_f2 = _factor_cumulants_dd(tau, r, p.v2_0, p.kappa2, p.theta2,
                                        p.sigma2, p.rho2)
    lt = df.mul(p.lambda_j, tau)
    c1_j = df.mul(lt, p.mu_j)
    c2_j = df.mul(lt, df.add(df.sqr(p.sigma_j), df.sqr(p.mu_j)))
    c1 = df.add(df.add(c1_f1, c1_f2), c1_j)
    c2 = df.add(df.add(c2_f1, c2_f2), c2_j)
    spread = df.mul_f(df.sqrt(df.abs_(c2)), L)
    a = df.sub(c1, spread)
    b = df.add(c1, spread)
    log_k = df.log(df.div(strike, spot))
    a = df.min_(a, df.add_f(log_k, -0.1))
    b = df.max_(b, df.add_f(log_k, 0.1))
    return a, b, log_k


def payoff_coefficients_dd(k, u, a, b, log_k, spot, strike, is_call):
    """DD twin of double_heston.payoff_coefficients.

    k: float32 [N] integer grid; u: DD [..., n, N]; a/b/log_k/strike: DD
    [..., n, 1]; spot: DD [..., 1, 1]; is_call: bool [..., n, 1].
    """
    one = df.dd_const(1.0, like=u)
    c = df.where(is_call, log_k, a)
    d = df.where(is_call, b, log_k)
    is0 = k == 0
    safe_u = df.where(is0, one, u)
    arg_d = df.mul(safe_u, df.sub(d, a))
    arg_c = df.mul(safe_u, df.sub(c, a))
    sin_d, cos_d = df.sincos(arg_d)
    sin_c, cos_c = df.sincos(arg_c)
    ed = df.exp(d)
    ec = df.exp(c)
    num = df.add(df.sub(df.mul(cos_d, ed), df.mul(cos_c, ec)),
                 df.mul(safe_u, df.sub(df.mul(sin_d, ed),
                                       df.mul(sin_c, ec))))
    chi_gen = df.div(num, df.add_f(df.sqr(safe_u), 1.0))
    chi = df.where(is0, df.sub(ed, ec), chi_gen)
    psi_gen = df.div(df.sub(sin_d, sin_c), safe_u)
    psi = df.where(is0, df.sub(d, c), psi_gen)
    width = df.sub(b, a)
    two_over = df.div(df.dd_const(2.0, like=width), width)
    v_call = df.mul(two_over, df.sub(df.mul(spot, chi), df.mul(strike, psi)))
    return df.where(is_call, v_call, df.neg(v_call))


def price_options_dd(params: DHParams, spot, rate, strikes, maturities,
                     is_call, n_terms: int = 128, L: float = 10.0,
                     q: float = 0.0):
    """Price a batch of options in double-float; returns float64
    ``[..., n]`` on the strikes' device.

    The contract of double_heston.price_options at float64 (~1e-12
    relative agreement), computed from float32 operations only. ``params``
    fields, ``spot``, ``rate``, strikes and maturities are float64 (or
    float32) tensors, arrays or numbers.
    """
    dev = torch.as_tensor(strikes).device
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64, device=dev)
    p = DHParams(*(f64(v) for v in params))
    return price_options_dd_core(_dd_params(p), spot, rate, strikes,
                                 maturities, is_call, n_terms, L, q)


def price_options_dd_core(p: DHParams, spot, rate, strikes, maturities,
                          is_call, n_terms: int = 128, L: float = 10.0,
                          q: float = 0.0):
    """Like price_options_dd, but ``p`` holds DD pairs already, each of
    the batch shape ``[...]`` (so a caller can apply the exp/tanh transform
    in DD, without a round trip through float32)."""
    dev = torch.as_tensor(strikes).device
    f64 = lambda v: torch.as_tensor(v, dtype=torch.float64, device=dev)
    p = DHParams(*((h[..., None, None], lo[..., None, None]) for h, lo in p))
    spot_dd = df.from_f64(f64(spot)[..., None, None])
    rate_dd = df.from_f64(f64(rate))
    q_dd = df.from_f64(f64(q))
    strikes_dd = df.from_f64(f64(strikes)[..., None])          # [..., n, 1]
    taus_dd = df.from_f64(f64(maturities)[..., None])
    is_call_b = torch.as_tensor(is_call, device=dev)[..., None]

    a, b, log_k = truncation_range_dd(p, taus_dd, strikes_dd, spot_dd,
                                      rate_dd, L)
    k = torch.arange(n_terms, dtype=df.F32, device=dev)        # [N]
    # u = k * pi / (b - a)
    width = df.sub(b, a)
    pi_over_w = df.div(df.dd_const(math.pi, like=width), width)
    u = df.mul_f(pi_over_w, k)                                 # [..., n, N]
    phi_re, phi_im = char_fn_dd(u, taus_dd, p, rate_dd, q_dd)
    v = payoff_coefficients_dd(k, u, a, b, log_k, spot_dd, strikes_dd,
                               is_call_b)
    # Re(phi * exp(-i u a)) = phi_re cos(ua) + phi_im sin(ua)
    ua = df.mul(u, a)
    s_ua, c_ua = df.sincos(ua)
    terms = df.mul(df.add(df.mul(phi_re, c_ua), df.mul(phi_im, s_ua)), v)
    half = torch.where(k == 0, 0.5, 1.0).to(df.F32)
    terms = df.mul_f(terms, half)
    series = df.sum_(terms, axis=-1)
    disc = df.exp(df.neg(df.mul(rate_dd, (taus_dd[0][..., 0],
                                          taus_dd[1][..., 0]))))
    return df.to_f64(df.mul(disc, series))
