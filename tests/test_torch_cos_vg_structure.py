"""The decomposition the K2/K3 kernel (``csrc/cos_vg.cu``) relies on.

A plain float64 prototype of the kernel's algorithm, written here and not
on any main path, against ``torch.autograd`` of ``price_options``:

  * rows are grouped by maturity (``loss_kernel.maturity_groups``); a row
    whose widening to log(K/S0) -/+ 0.1 binds becomes its own group with
    its own range;
  * each group's cumulant range [a, b] and its 13-wide derivative are
    computed once;
  * d phi / d theta at fixed u and d phi / du are assembled from each
    Heston factor's local derivatives in (kappa, theta, sigma, rho, u),
    from d log phi / d v0_i = B_i, and from the jump/drift factor's
    derivatives in (lambda, mu_J, sigma_J, u);
  * the range enters through u_k = k pi / (b - a), E_k = exp(-i u_k a) and
    the payoff V_k, whose derivatives in a and b complete the chain rule.

Tolerance: 1e-12 of the lane's largest |dP/dtheta| (and 1e-12 relative on
prices). Both sides are float64 sums of the same terms in other orders;
deep in-the-money rows with a binding widening have derivatives near 0
that are differences of O(1) terms, so a per-entry relative bound would
measure the cancellation, not the decomposition.
"""
import math

import numpy as np
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu_torch.models import double_heston as dh
from option_pricing_ffn_lbfgs_tpu_torch.ops.loss_kernel import maturity_groups

F64 = torch.float64
GUESS = np.array([0.04, 2.5, 0.04, 0.3, -0.7, 0.04, 0.8, 0.04, 0.2, -0.5,
                  0.15, -0.04, 0.08])
RATE, SPOT, N_TERMS, L_TRUNC = 0.03, 100.0, 64, 10.0


def _cumulant_range(vec, tau):
    """[a, b] before the per-row widening (truncation_range's c1, c2)."""
    p = dh.DHParams.from_vector(vec)
    c1a, c2a = dh._factor_cumulants(tau, RATE, p.v1_0, p.kappa1, p.theta1,
                                    p.sigma1, p.rho1)
    c1b, c2b = dh._factor_cumulants(tau, RATE, p.v2_0, p.kappa2, p.theta2,
                                    p.sigma2, p.rho2)
    c1 = c1a + c1b + p.lambda_j * tau * p.mu_j
    c2 = c2a + c2b + p.lambda_j * tau * (p.sigma_j**2 + p.mu_j**2)
    spread = L_TRUNC * torch.sqrt(torch.abs(c2))
    return torch.stack([c1 - spread, c1 + spread])


def _jump_exponent(lam, mu, sj, u, tau):
    """The jump factor's exponent plus i drift u tau, as char_fn builds
    them."""
    compensator = torch.exp(mu + 0.5 * sj * sj) - 1.0
    drift = RATE - lam * compensator
    jamp = torch.exp(-0.5 * sj * sj * u * u)
    lt = lam * tau
    return (lt * (jamp * torch.cos(u * mu) - 1.0),
            lt * (jamp * torch.sin(u * mu)) + drift * u * tau)


def _partials(fn, args):
    """Elementwise partial derivatives of fn's outputs in each argument
    (one forward-mode direction per argument: the scalars are parameters,
    the vector u enters elementwise)."""
    out = []
    for i in range(len(args)):
        tangents = tuple(torch.ones_like(a) if j == i else torch.zeros_like(a)
                         for j, a in enumerate(args))
        out.append(torch.func.jvp(fn, tuple(args), tangents)[1])
    return out


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def structured_price_and_grad(vec, strikes, mats, is_call):
    """Prices [n] and dP/dtheta [n, 13] of one lane by the kernel's
    decomposition."""
    n = strikes.shape[0]
    groups = maturity_groups(mats[None])[0]
    log_k = torch.log(strikes / SPOT)
    k = torch.arange(N_TERMS, dtype=F64)
    wk = torch.where(k == 0, 0.5, 1.0).to(F64)
    price = torch.zeros(n, dtype=F64)
    grad = torch.zeros(n, 13, dtype=F64)

    # Effective groups: (a, b, tau, rows, a_on, b_on, da/dtheta, db/dtheta)
    eff, shared = [], {}
    for r in range(n):
        g = int(groups[r])
        tau = mats[r]
        ab = _cumulant_range(vec, tau)
        dab = torch.func.jacfwd(lambda v: _cumulant_range(v, tau))(vec)
        lo, hi = log_k[r] - 0.1, log_k[r] + 0.1
        a_on, b_on = bool(ab[0] < lo), bool(ab[1] > hi)
        if a_on and b_on and g in shared:
            eff[shared[g]][3].append(r)
            continue
        if a_on and b_on:
            shared[g] = len(eff)
        eff.append([ab[0] if a_on else lo, ab[1] if b_on else hi, tau, [r],
                    a_on, b_on, dab])

    p = dh.DHParams.from_vector(vec)
    for a, b, tau, rows, a_on, b_on, dab in eff:
        width = b - a
        u = k * (math.pi / width)
        # d log phi / d theta_j (13 complex) and d log phi / du
        dl = [None] * 13
        du = (torch.zeros_like(u), torch.zeros_like(u))
        for o in (0, 5):
            v0 = vec[o]
            fac = lambda kap, th, sg, rh, uu: [
                x for pair in dh._heston_factor_B_and_Aterm(
                    uu, tau, kap, th, sg, rh) for x in pair]
            args = (vec[o + 1], vec[o + 2], vec[o + 3], vec[o + 4], u)
            B_re, B_im, _, _ = fac(*args)
            dl[o] = (B_re, B_im)                       # d/dv0 = B
            for j, (dBr, dBi, dAr, dAi) in enumerate(_partials(fac, args)):
                part = (dAr + v0 * dBr, dAi + v0 * dBi)
                if j < 4:
                    dl[o + 1 + j] = part
                else:
                    du = (du[0] + part[0], du[1] + part[1])
        jump = lambda lam, mu, sj, uu: _jump_exponent(lam, mu, sj, uu, tau)
        for j, part in enumerate(_partials(jump, (vec[10], vec[11], vec[12],
                                                  u))):
            if j < 3:
                dl[10 + j] = part
            else:
                du = (du[0] + part[0], du[1] + part[1])

        phi = dh.char_fn(u, tau, p, RATE)
        pe = _cmul(phi, (torch.cos(u * a), -torch.sin(u * a)))  # phi E
        q = torch.stack([pe[0] * d[0] - pe[1] * d[1] for d in dl])  # [13, N]
        gu = pe[0] * du[0] - pe[1] * du[1] + a * pe[1]
        F, Fa, Fb = pe[0], gu * u / width + u * pe[1], -gu * u / width

        for r in rows:
            def payoff(aa, bb):
                return dh.payoff_coefficients(k, aa, bb, log_k[r], SPOT,
                                              strikes[r], is_call[r])
            V = payoff(a, b)
            Va, Vb = _partials(payoff, (a, b))
            disc = torch.exp(-RATE * tau)
            price[r] = disc * torch.sum(wk * F * V)
            s_a = torch.sum(wk * (Fa * V + F * Va)) if a_on else 0.0
            s_b = torch.sum(wk * (Fb * V + F * Vb)) if b_on else 0.0
            grad[r] = disc * (torch.sum(wk * q * V, dim=-1)
                              + s_a * dab[0] + s_b * dab[1])
    return price, grad


def _autograd(vec, strikes, mats, is_call):
    def price(v):
        return dh.price_options(dh.DHParams.from_vector(v), SPOT, RATE,
                                strikes, mats, is_call, n_terms=N_TERMS,
                                L=L_TRUNC)
    return price(vec), torch.autograd.functional.jacobian(price, vec)


def _lane(case):
    rng = np.random.default_rng(len(case))
    vec = GUESS * (1.0 + rng.uniform(-0.2, 0.2, 13))
    strikes = np.tile([90.0, 95.0, 100.0, 105.0, 110.0], 3)
    is_call = np.arange(15) % 3 != 0
    if case == "three_maturities":
        mats = np.repeat([0.25, 0.5, 1.0], 5)
    elif case == "all_distinct":
        mats = np.linspace(0.1, 1.5, 15)
    elif case == "one_maturity":
        mats = np.full(15, 0.5)
    else:                   # widening binds: short maturity, small variance
        vec[[0, 2, 5, 7]] *= 0.3
        strikes = np.array([70.0, 80.0, 100.0, 120.0, 130.0] * 3)
        mats = np.repeat([0.02, 0.02, 0.5], 5)
        is_call = np.array([True, True, False, False, False] * 3)
    t = lambda a: torch.tensor(a, dtype=F64)
    return t(vec), t(strikes), t(mats), torch.tensor(is_call)


@pytest.mark.parametrize("case", ["three_maturities", "all_distinct",
                                  "one_maturity", "widening_binds"])
def test_structured_gradient_matches_autograd(case):
    vec, strikes, mats, is_call = _lane(case)
    price, grad = structured_price_and_grad(vec, strikes, mats, is_call)
    ref_p, ref_g = _autograd(vec, strikes, mats, is_call)
    np.testing.assert_allclose(price.numpy(), ref_p.numpy(), rtol=1e-12)
    scale = float(ref_g.abs().max())
    np.testing.assert_allclose(grad.numpy(), ref_g.numpy(), rtol=0,
                               atol=1e-12 * scale)
    if case == "widening_binds":
        # The case must exercise both the split rows and a shared group.
        lo = torch.log(strikes / SPOT) - 0.1
        hi = torch.log(strikes / SPOT) + 0.1
        ab = torch.stack([_cumulant_range(vec, t) for t in mats])
        binds = ~((ab[:, 0] < lo) & (ab[:, 1] > hi))
        assert 0 < int(binds.sum()) < 15
        assert bool((~ab[:, 0].lt(lo)).any()) and bool((~ab[:, 1].gt(hi)).any())


def test_maturity_groups():
    mats = torch.tensor([[0.25, 0.25, 0.5, 0.25, 1.0, 0.5],
                         [1.0, 0.5, 0.25, 0.1, 2.0, 3.0],
                         [0.5] * 6])
    want = [[0, 0, 1, 0, 2, 1], [0, 1, 2, 3, 4, 5], [0] * 6]
    got = maturity_groups(mats)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    assert got.tolist() == want
    # float32 maturities group by exact equality in their own dtype
    m32 = torch.tensor([[0.1, 0.1 + 1e-9, 0.2]], dtype=torch.float32)
    assert maturity_groups(m32).tolist() == [[0, 0, 1]]
    m64 = m32.to(F64) + torch.tensor([[0.0, 1e-12, 0.0]], dtype=F64)
    assert maturity_groups(m64).tolist() == [[0, 1, 2]]
