"""Work of a kernel call and the least time the card could take for it.

``ITEM_OPS`` holds the operations per item of the kernels' own formula
templates, as ``csrc/op_count.cpp`` counts them: it builds those templates
for the host with a counting scalar (that file says what counts as an
operation: each arithmetic operation and each transcendental counts one,
what the compiler folds counts none). The counts depend on the number of
terms N only, not on the data; ``tests/test_torch_opcount.py`` builds the
counter and holds these constants to it. ``cos_vg_work`` and
``cos_price_work`` multiply them by the items a call's inputs need and
count each input byte read once and each output byte written once:

  * K2/K3: one characteristic-function item per (lane, effective group, k),
    where a lane's effective groups are its maturities plus one group for
    each row whose widening to log(K/S0) -/+ 0.1 binds; one payoff item per
    (row, k); one range per (lane, maturity);
  * K1: the same grouping without derivatives: one range per (surface,
    maturity), one CF item per (surface, effective group, k), one payoff
    term per (row, k) and the row's own set-up.

  * K4/K5 (the L-BFGS trip, ``csrc/lbfgs_trip.cu``): the state fields
    each lane's branch reads and writes, counted from the state the
    launch sees (done lanes read their flag, and K4 copies their x; an
    opening lane reads ``hist_len`` history pairs; K5 writes a history row
    where the lane stored a pair), and the arithmetic as the kernels write
    it, per coordinate and per pair. Both are bound by bytes by two orders
    of magnitude. In the fused mode (the calibration objective) K4 also
    writes params_try with one exp or tanh a coordinate, and K5 reads K2's
    prices and gradient sums, the market prices and params_try in place of
    f_try and g_try, and assembles the loss (four operations a row, the
    Feller terms and the chain rule).
  * K6/K7 (the LM trip, ``csrc/lm_trip.cu``): the same, from the state
    the launch sees (done lanes read their flag, and K6 copies their x; a
    live lane's K6 reads its m x d Jacobian and m residuals; K7 copies
    x_try, r_try and j_try into the state where the step is accepted), and
    the arithmetic as the kernels write it: the m d^2 products and sums of
    J^T J, the factor's columns up to the first bad pivot, the two
    substitutions of a lane whose factor completes. Both are bound by
    bytes. In the fused mode (the LM polish's objective) K6 also writes
    the trial parameters at both precisions, and K7 reads K1's prices, the
    market prices and the parameters in place of r_try, and K3's float32
    rows in place of j_try, and assembles r and J.

``bound_ms`` is the larger of operations over the card's peak rate for
their type and bytes over its memory rate (NVIDIA H100 SXM data sheet:
67 TFLOP/s FP32 and 34 TFLOP/s FP64 outside the tensor cores, 3.35 TB/s).

Measurement only: no calibration path imports this module.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models import double_heston as dh
from .loss_kernel import maturity_groups

PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
MEM_BYTES_PER_S = 3.35e12
# csrc/op_count.cpp's output at the main paths' N (per item; a CF item and
# a payoff item are means over k = 0 .. N-1, k = 0 being cheaper).
ITEM_OPS = {
    64: {"group_range": 425, "cf_item": 1519.109375, "row_setup_call": 13,
         "row_setup_put": 13, "payoff_term_call": 133.375,
         "payoff_term_put": 130.4375, "k1_range": 153,
         "k1_cf_item": 239.765625, "k1_row_setup_call": 14,
         "k1_row_setup_put": 14, "k1_payoff_term_call": 25.71875,
         "k1_payoff_term_put": 25.71875},
    128: {"group_range": 425, "cf_item": 1528.554688, "row_setup_call": 13,
          "row_setup_put": 13, "payoff_term_call": 134.1875,
          "payoff_term_put": 131.21875, "k1_range": 153,
          "k1_cf_item": 240.882812, "k1_row_setup_call": 14,
          "k1_row_setup_put": 14, "k1_payoff_term_call": 25.859375,
          "k1_payoff_term_put": 25.859375},
}


def _cumulant_range(params: torch.Tensor, tau, rate, L):
    """[a, b] of ``truncation_range`` before the per-row widening."""
    p = dh.DHParams.from_vector(params[:, None, :])
    c1a, c2a = dh._factor_cumulants(tau, rate, p.v1_0, p.kappa1, p.theta1,
                                    p.sigma1, p.rho1)
    c1b, c2b = dh._factor_cumulants(tau, rate, p.v2_0, p.kappa2, p.theta2,
                                    p.sigma2, p.rho2)
    c1 = c1a + c1b + p.lambda_j * tau * p.mu_j
    c2 = c2a + c2b + p.lambda_j * tau * (p.sigma_j**2 + p.mu_j**2)
    spread = L * torch.sqrt(torch.abs(c2))
    return c1 - spread, c1 + spread


def effective_groups(params, spots, strikes, maturities, rate=0.03, L=10.0):
    """Per lane: (maturity groups, effective groups) as the K1 and K2/K3
    kernels form them; a row whose widening binds is a group of its own."""
    params, spots, strikes, maturities = (
        torch.as_tensor(t, dtype=torch.float64)
        for t in (params, spots, strikes, maturities))
    groups = maturity_groups(maturities).long()
    n = groups.shape[-1]
    a0, b0 = _cumulant_range(params, maturities, rate, L)
    log_k = torch.log(strikes / spots[:, None])
    shared = (a0 < log_k - 0.1) & (b0 > log_k + 0.1)
    slot = torch.where(shared, groups, torch.full_like(groups, n))
    used = torch.zeros(groups.shape[0], n + 1, dtype=torch.float64,
                       device=groups.device).scatter_(1, slot, 1.0)
    n_eff = used[:, :n].sum(-1) + (~shared).sum(-1)
    return groups.max(-1).values + 1, n_eff.long()


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def cos_vg_work(params, spots, strikes, maturities, is_call, mkt,
                n_terms: int, mode: str, rate=0.03, L=10.0):
    """Operations and bytes of one K2 (``mode="loss"``) or K3
    (``mode="jac"``) launch on these inputs."""
    c = ITEM_OPS[n_terms]
    n_mat, n_eff = effective_groups(params, spots, strikes, maturities,
                                    rate, L)
    calls = int(is_call.sum())
    puts = is_call.numel() - calls
    ops = (int(n_mat.sum()) * c["group_range"]
           + int(n_eff.sum()) * n_terms * c["cf_item"]
           + calls * (c["row_setup_call"] + n_terms * c["payoff_term_call"])
           + puts * (c["row_setup_put"] + n_terms * c["payoff_term_put"]))
    rows, item = strikes.numel(), params.element_size()
    grad = (params.shape[0] if mode == "loss" else rows) * 13 * item
    nbytes = (sum(_size(t) for t in (params, spots, strikes, maturities,
                                     is_call, mkt))
              + rows * 4                      # int32 maturity groups
              + rows * item + grad)           # prices, gradient
    return {"ops": ops, "bytes": nbytes, "effective_groups": int(n_eff.sum())}


def cos_price_work(params, spots, strikes, maturities, is_call, n_terms: int,
                   rate=0.03, L=10.0):
    """Operations and bytes of one K1 launch on these inputs."""
    c = ITEM_OPS[n_terms]
    n_mat, n_eff = effective_groups(params, spots, strikes, maturities,
                                    rate, L)
    calls = int(is_call.sum())
    puts = is_call.numel() - calls
    ops = (int(n_mat.sum()) * c["k1_range"]
           + int(n_eff.sum()) * n_terms * c["k1_cf_item"]
           + calls * (c["k1_row_setup_call"]
                      + n_terms * c["k1_payoff_term_call"])
           + puts * (c["k1_row_setup_put"]
                     + n_terms * c["k1_payoff_term_put"]))
    nbytes = (sum(_size(t) for t in (params, spots, strikes, maturities,
                                     is_call))
              + strikes.numel() * params.element_size())
    return {"ops": ops, "bytes": nbytes, "effective_groups": int(n_eff.sum())}


def lbfgs_open_work(st, fused: bool = False) -> Dict[str, float]:
    """Operations and bytes of one K4 launch on the state ``st``
    (``ops/lbfgs_batched.py::_BState``), before the launch; ``fused``:
    fused K4, which also writes params_try (an exp or tanh a coordinate,
    identity for one)."""
    L, d = st.x.shape
    t = st.x.element_size()
    live = ~st.done
    opening = live & st.starting
    moving = live & ~st.starting
    pairs = int(st.hist_len[opening].clamp(min=0).sum())
    n_open, n_move, n_live = (int(v.sum()) for v in (opening, moving, live))
    nbytes = (L * (1 + 2 * d * t)                 # done, x, x_try
              + n_live * (4 + 4 + 1 + 1)          # head, hist_len, flags
              + n_move * (t + d * t)              # alpha, direction
              + n_open * (2 * t + d * t           # g, gamma, f
                          + 3 * d * t             # direction, g_star, x_star
                          + 9 * t + 4 + 4 + 1)    # opening resets
              + pairs * (2 * d * t + t)           # history rows, rho
              + 4)                                # live count
    ops = pairs * (8 * d + 3) + n_open * (10 * d + 5) + n_move * 2 * d
    if fused:
        nbytes += L * d * t                       # params_try
        ops += L * (d - 1)                        # exp / tanh
    return {"ops": ops, "bytes": nbytes}


def lbfgs_update_work(before, after, n_opt: int = 0) -> Dict[str, float]:
    """Operations and bytes of one K5 launch that took the state
    ``before`` to ``after``; ``n_opt`` > 0: fused K5 on lanes of ``n_opt``
    options, which reads K2's prices and gradient sums, the market prices
    and params_try instead of f_try and g_try, and assembles the loss."""
    L, d = before.x.shape
    t = before.x.element_size()
    live = ~before.done
    n_live = int(live.sum())
    pairs = int((live & ~before.bootstrap
                 & (after.rho_hist != before.rho_hist).any(-1)).sum())
    nbytes = (L * 1 + 4                           # done, live count
              + n_live * (8 + 7 * d * t + 12 * t + 20 + 3   # reads
                          + 4 * d * t + 10 * t + 28 + 5)    # writes
              + pairs * (2 * d * t + t))          # history row, rho
    ops = n_live * (13 * d + 60)
    if n_opt:
        nbytes += n_live * (2 * n_opt + 2 * d - d - 1) * t
        ops += n_live * (4 * n_opt + 1          # rows, the mean
                         + 11                    # Feller value
                         + 12 + 4 + 2 * d)       # its gradient, chain rule
    return {"ops": ops, "bytes": nbytes}


def _cholesky_ops(d: int, columns: int, failed: bool) -> int:
    """Operations of a factor that completes ``columns`` columns (each
    row's inner products, the pivot's square root, the divisions), and of
    the failing column's inner products if ``failed``."""
    ops = sum(2 * j * (d - j) + 1 + (d - j - 1) for j in range(columns))
    return ops + (2 * columns * (d - columns) if failed else 0)


def lm_open_work(st) -> Dict[str, float]:
    """Operations and bytes of one K6 launch on the state ``st``
    (``ops/levenberg_marquardt.py::_State``), before the launch. A live
    lane's factor is counted up to its first pivot that is not positive
    and finite, as the kernel stops there."""
    from .levenberg_marquardt import cholesky, damped_normal_equations
    L, d = st.x.shape
    m = st.r.shape[-1]
    t = st.x.element_size()
    live = ~st.done
    n_live = int(live.sum())
    C, ok = cholesky(damped_normal_equations(st.J[live], st.r[live],
                                             st.lam[live])[0])
    root = torch.diagonal(C, dim1=-2, dim2=-1)
    bad = ~(torch.isfinite(root) & (root > 0))
    first_bad = torch.argmax(bad.to(torch.int8), dim=-1)
    ops = n_live * (2 * m * d * d + 2 * m * d     # J^T J, J^T r
                    + d * (d - 1) + 3 * d         # damping
                    + 6 * d)                      # x + dx, two max |.|
    for c, good in zip(first_bad.tolist(), ok.tolist()):
        ops += (_cholesky_ops(d, d, False) + 2 * d * d if good
                else _cholesky_ops(d, c, True))
    nbytes = (L * (1 + 2 * d * t)                  # done, x, x_try
              + n_live * (m * d * t + m * t + t    # J, r, lam
                          + 2 * t)                 # dx_max, g_max
              + 4)                                 # live count
    return {"ops": ops, "bytes": nbytes}


def lm_update_work(st, r_try) -> Dict[str, float]:
    """Operations and bytes of one K7 launch on the state ``st`` before
    the launch and the trial residuals ``r_try`` (which lanes accept)."""
    from .levenberg_marquardt import trial_cost
    L, d = st.x.shape
    m = st.r.shape[-1]
    t = st.x.element_size()
    live = ~st.done
    n_live = int(live.sum())
    n_acc = int((live & (trial_cost(r_try) < st.cost)).sum())
    nbytes = (L * 1 + 4                            # done, live count
              + n_live * (m * t + d * t + 4 * t + 9    # reads
                          + 2 * t + 10)                # writes
              + n_acc * 2 * (d * t + m * d * t)    # x_try, j_try; x, r, J
              + n_acc * m * t)
    ops = n_live * (2 * m + 2 * d + 18)
    return {"ops": ops, "bytes": nbytes}


def lm_open_fused_work(st) -> Dict[str, float]:
    """Operations and bytes of one fused K6 launch on the state ``st``
    before it: K6's, and every lane's trial parameters at float64 and
    float32 (an exp or tanh a coordinate, identity for one, at each)."""
    w = lm_open_work(st)
    L, d = st.x.shape
    return {"ops": w["ops"] + 2 * L * (d - 1),
            "bytes": w["bytes"] + L * d * (8 + 4)}


def lm_update_fused_work(st, r_try, n_opt: int) -> Dict[str, float]:
    """Operations and bytes of one fused K7 launch on the state ``st``
    before it, whose assembled residuals are ``r_try``: K7's, where a live
    lane reads its ``n_opt`` prices and market prices and its 13
    parameters at both precisions in place of ``r_try``, and an accepting
    lane K3's float32 rows in place of ``j_try``; the assembly's
    operations (four a pricing row, the Feller rows, and on an accepted
    step the Feller Jacobian rows and a chain-rule product an entry)."""
    from .levenberg_marquardt import trial_cost
    w = lm_update_work(st, r_try)
    L, d = st.x.shape
    m = st.r.shape[-1]
    live = ~st.done
    n_live = int(live.sum())
    n_acc = int((live & (trial_cost(r_try) < st.cost)).sum())
    nbytes = (w["bytes"]
              + n_live * (2 * n_opt * 8 + d * (8 + 4) - m * 8)
              + n_acc * (n_opt * d * 4 - m * d * 8))
    ops = (w["ops"] + n_live * (4 * n_opt + 2 * 7)
           + n_acc * (2 * 12 + m * d))
    return {"ops": ops, "bytes": nbytes}


def bound_ms(work: Dict[str, float], dtype: torch.dtype):
    """(milliseconds, "operations" or "bytes"): the least time the card
    could take for ``work``, and which of the two bounds it."""
    t_ops = work["ops"] / PEAK_OPS_PER_S[dtype]
    t_bytes = work["bytes"] / MEM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")
