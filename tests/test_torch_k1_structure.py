"""The grouping the K1 kernel (``csrc/cos_price.cu``) prices by.

A plain float64 prototype of the kernel's algorithm, written here and not
on any main path, one surface at a time:

  * maturity groups are found inside the surface by exact equality of tau,
    each named by its first row;
  * each maturity's cumulant range [a, b] is computed once;
  * each row's widening to log(K/S0) -/+ 0.1 is tested; a row where it
    binds on either side is an effective group of its own with its own
    [a, b], the other rows of a maturity share one group;
  * each effective group's items item_k = Re[phi(u_k) exp(-i u_k a)] are
    computed once;
  * each row sums item_k V_k (k = 0 at half weight) and discounts.

Tolerances: 1e-13 relative against ``price_surfaces_plain`` (both float64,
the same formulas on the same u_k; only the evaluation layout differs) and
1e-11 against the JAX package's ``price_options`` on the XLA path under x64
(libm rounding; Pallas interpret mode's ``arctan2_poly`` is f32-grade, so it
is not the oracle).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.models import double_heston as jdh
from option_pricing_ffn_lbfgs_tpu_torch.models import double_heston as dh
from option_pricing_ffn_lbfgs_tpu_torch.ops import cos_kernel, opcount
from tests.test_torch_cos_vg_structure import GUESS, L_TRUNC, RATE, \
    _cumulant_range

F64 = torch.float64


def grouped_prices(vec, spot, strikes, mats, is_call, n_terms):
    """Prices [n] of one surface as the kernel forms them, with its number
    of maturity groups and of effective groups."""
    n = strikes.shape[0]
    p = dh.DHParams.from_vector(vec)
    log_k = torch.log(strikes / spot)
    first = [next(r2 for r2 in range(r + 1) if bool(mats[r2] == mats[r]))
             for r in range(n)]
    ranges = {f: _cumulant_range(vec, mats[f]) for f in sorted(set(first))}
    eff, shared, row_group = [], {}, []
    for r in range(n):
        ga, gb = ranges[first[r]]
        lo, hi = log_k[r] - 0.1, log_k[r] + 0.1
        a_on, b_on = bool(ga < lo), bool(gb > hi)
        share = a_on and b_on
        if share and first[r] in shared:
            e = shared[first[r]]
        else:
            e = len(eff)
            if share:
                shared[first[r]] = e
            eff.append((ga if a_on else lo, gb if b_on else hi, mats[r]))
        row_group.append(e)
    k = torch.arange(n_terms, dtype=F64)
    items = []
    for a, b, tau in eff:
        u = k * (math.pi / (b - a))
        phi_re, phi_im = dh.char_fn(u, tau, p, RATE)
        items.append(phi_re * torch.cos(u * a) + phi_im * torch.sin(u * a))
    w = torch.where(k == 0, 0.5, 1.0).to(F64)
    prices = []
    for r in range(n):
        a, b, _ = eff[row_group[r]]
        v = dh.payoff_coefficients(k, a, b, log_k[r], spot, strikes[r],
                                   is_call[r])
        series = torch.sum(items[row_group[r]] * v * w)
        prices.append(torch.exp(-RATE * mats[r]) * series)
    return torch.stack(prices), len(ranges), len(eff)


def _surfaces(case, n_lanes=3):
    """Lanes of one layout; calls and puts mixed wherever the case allows."""
    n_opt = {"n_opt_1": 1, "n_opt_7": 7, "n_opt_17": 17}.get(case, 15)
    rng = np.random.default_rng(sum(map(ord, case)))
    params = GUESS * (1.0 + rng.uniform(-0.2, 0.2, (n_lanes, 13)))
    spots = 100.0 + rng.uniform(-3.0, 3.0, n_lanes)
    r = np.arange(n_opt)
    strikes = np.resize([90.0, 95.0, 100.0, 105.0, 110.0], n_opt)
    mats = np.sort(np.resize([0.25, 0.5, 1.0], n_opt))
    is_call = r % 3 != 0
    if case == "one_maturity":
        mats = np.full(n_opt, 0.5)
    elif case == "all_distinct":
        mats = np.linspace(0.1, 2.0, n_opt)
    elif case == "duplicate_strikes":
        strikes = np.resize([100.0, 100.0, 95.0], n_opt)
        mats = np.resize([0.5, 0.25, 0.5, 1.0, 0.25], n_opt)
    elif case == "widening_binds":
        params[:, [0, 2, 5, 7]] *= 0.3
        strikes = np.resize([70.0, 125.0, 100.0, 80.0, 130.0], n_opt)
        mats = np.resize([0.02, 0.02, 0.02, 0.5, 0.5], n_opt)
        is_call = strikes <= 100.0
    tile = lambda a: np.tile(a, (n_lanes, 1))
    return params, spots, tile(strikes), tile(mats), tile(is_call)


def _jax_prices(params, spots, strikes, mats, is_call, n_terms):
    f = jax.jit(jax.vmap(lambda p, s, k, m, c: jdh.price_options(
        jdh.DHParams.from_vector(p), s, RATE, k, m, c, n_terms=n_terms,
        L=L_TRUNC)))
    return np.asarray(f(*(jnp.asarray(a, jnp.float64) for a in
                          (params, spots, strikes, mats)),
                        jnp.asarray(is_call)))


@pytest.mark.parametrize("case,n_terms", [
    ("n_opt_1", 64), ("n_opt_7", 64), ("n_opt_15", 64), ("n_opt_17", 64),
    ("n_opt_15", 128), ("one_maturity", 64), ("all_distinct", 64),
    ("duplicate_strikes", 64), ("widening_binds", 64),
    ("widening_binds", 128)])
def test_grouped_prices_match_plain_and_jax(case, n_terms):
    params, spots, strikes, mats, is_call = _surfaces(case)
    t = lambda a: torch.tensor(a, dtype=F64)
    groups, proto = [], []
    for lane in range(params.shape[0]):
        prices, n_mat, n_eff = grouped_prices(
            t(params[lane]), float(spots[lane]), t(strikes[lane]),
            t(mats[lane]), torch.tensor(is_call[lane]), n_terms)
        proto.append(prices.numpy())
        groups.append((n_mat, n_eff))
    proto = np.stack(proto)
    plain = cos_kernel.price_surfaces_plain(
        t(params), t(spots), RATE, t(strikes), t(mats), torch.tensor(is_call),
        n_terms=n_terms, L=L_TRUNC).numpy()
    np.testing.assert_allclose(proto, plain, rtol=1e-13)
    np.testing.assert_allclose(
        proto, _jax_prices(params, spots, strikes, mats, is_call, n_terms),
        rtol=1e-11)
    # the op count's grouping is the prototype's
    n_mat, n_eff = opcount.effective_groups(t(params), t(spots), t(strikes),
                                            t(mats), RATE, L_TRUNC)
    assert groups == list(zip(n_mat.tolist(), n_eff.tolist()))
    distinct = len(set(mats[0].tolist()))
    assert all(g[0] == distinct for g in groups)
    if case == "widening_binds":
        # rows that bind split off, and some rows still share a group
        assert bool((n_eff > n_mat).any())
        assert all(g[1] < mats.shape[1] for g in groups)
    elif case in ("n_opt_15", "n_opt_17", "one_maturity"):
        assert all(g[1] == g[0] for g in groups)
