"""The work that K2/K3 (``cos_vg_kernel``) inputs need, frozen.

One lane evaluation of the COS price and its 13-wide parameter
derivative on a surface of ``n_opt`` rows in ``n_mat`` maturities needs
one truncation range per maturity, one characteristic-function item per
(maturity, k) and one payoff term per (row, k) plus the row's set-up.
The operations of each item (each arithmetic operation and each
transcendental counts one) were counted once at N = 64 and 128 from the
formula templates of the kernels as they stood when this benchmark was
written, and are copied here as literals. They do not follow the kernel
from then on: a redesign that needs fewer operations reads as a higher
share of the same bound, not as a lower bound.

It is a lower bound of the work: rows whose truncation widening binds
need a group of their own, which depends on the iterate and is not
counted. Bytes are each input read once and each output written once
(float32): K2 ("loss") writes a lane's 13 gradient sums, K3 ("jac") every
row's 13 derivatives.
"""
from __future__ import annotations

ITEM_OPS = {
    64: {"group_range": 425, "cf_item": 1519.109375, "row_setup_call": 13,
         "row_setup_put": 13, "payoff_term_call": 133.375,
         "payoff_term_put": 130.4375},
    128: {"group_range": 425, "cf_item": 1528.554688, "row_setup_call": 13,
          "row_setup_put": 13, "payoff_term_call": 134.1875,
          "payoff_term_put": 131.21875},
}


def lane_ops(n_terms: int, n_mat: int = 3, calls: int = 15,
             puts: int = 0) -> float:
    """Operations of one lane evaluation."""
    c = ITEM_OPS[n_terms]
    return (n_mat * c["group_range"] + n_mat * n_terms * c["cf_item"]
            + calls * (c["row_setup_call"] + n_terms * c["payoff_term_call"])
            + puts * (c["row_setup_put"] + n_terms * c["payoff_term_put"]))


def lane_bytes(mode: str, n_opt: int = 15, item: int = 4) -> int:
    """Bytes of one lane: params, spot, strikes, maturities, call flags,
    market prices, int32 maturity groups in; prices and the gradient
    (``loss``) or the rows' derivatives (``jac``) out."""
    grad = 13 if mode == "loss" else n_opt * 13
    return (13 * item + item + 3 * n_opt * item + n_opt + 4 * n_opt
            + n_opt * item + grad * item)


def launch_work(lanes: int, n_terms: int, mode: str, n_mat: int = 3,
                calls: int = 15, puts: int = 0) -> dict:
    """``{"ops", "bytes"}`` of one launch over ``lanes`` lanes."""
    return {"ops": lanes * lane_ops(n_terms, n_mat, calls, puts),
            "bytes": lanes * lane_bytes(mode, calls + puts)}
