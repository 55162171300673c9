"""The work counts behind the kernels' bounds (``ops/opcount.py``).

``effective_groups`` is held against a row-by-row count of the K2/K3
kernel's rule (a row whose widening binds is a group of its own); the
per-item constants ``ITEM_OPS`` must equal what the host-built counter
(``csrc/op_count.cpp``) prints, for any data; and the work of a call must
scale with its items.
"""
import json
import shutil
import subprocess

import numpy as np
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu_torch.models import double_heston as dh
from option_pricing_ffn_lbfgs_tpu_torch.ops import kernel_build, opcount

F64 = torch.float64
GUESS = [0.04, 2.5, 0.04, 0.3, -0.7, 0.04, 0.8, 0.04, 0.2, -0.5, 0.15,
         -0.04, 0.08]


def _lanes():
    """Lane 0: three maturities, no widening binds; lane 1: short maturity,
    small variance, far strikes, so some rows bind; lane 2: all distinct."""
    p = np.tile(GUESS, (3, 1))
    p[1, [0, 2, 5, 7]] *= 0.3
    strikes = np.array([[90.0, 95.0, 100.0, 105.0, 110.0] * 3,
                        [70.0, 80.0, 100.0, 120.0, 130.0] * 3,
                        [90.0, 95.0, 100.0, 105.0, 110.0] * 3])
    mats = np.stack([np.repeat([0.25, 0.5, 1.0], 5),
                     np.repeat([0.02, 0.02, 0.5], 5),
                     np.linspace(0.1, 1.5, 15)])
    t = lambda a: torch.tensor(a, dtype=F64)
    return t(p), t(np.full(3, 100.0)), t(strikes), t(mats)


def _op_count(tmp_path):
    """Build csrc/op_count.cpp with the host C++ compiler."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler for csrc/op_count.cpp")
    binary = tmp_path / "op_count"
    subprocess.run([cxx, "-std=c++17", "-O1", f"-I{kernel_build.CSRC}",
                    "-o", str(binary), str(kernel_build.CSRC / "op_count.cpp")],
                   check=True)
    return binary


def test_effective_groups_match_row_rule():
    params, spots, strikes, mats = _lanes()
    n_mat, n_eff = opcount.effective_groups(params, spots, strikes, mats)
    for lane in range(3):
        shared, own = set(), 0
        for r in range(15):
            # a strike far above the money leaves a unwidened, one near 0
            # leaves b unwidened
            a, b = (dh.truncation_range(
                dh.DHParams.from_vector(params[lane]), mats[lane, r],
                torch.tensor(k, dtype=F64), spots[lane], 0.03)[i]
                for i, k in ((0, 1e300), (1, 1e-300)))
            log_k = torch.log(strikes[lane, r] / spots[lane])
            if bool(a < log_k - 0.1) and bool(b > log_k + 0.1):
                shared.add(float(mats[lane, r]))
            else:
                own += 1
        assert int(n_eff[lane]) == len(shared) + own
        assert int(n_mat[lane]) == len(set(mats[lane].tolist()))
    assert n_eff.tolist()[0] == 3 and n_eff.tolist()[2] == 15
    assert n_eff.tolist()[1] > 3


def test_item_counts_are_consistent(tmp_path):
    """ITEM_OPS is the counter's output at every N it holds, whatever the
    data: a near-the-money row, and a short maturity with a small variance
    and a far strike, where the widening binds."""
    binary = _op_count(tmp_path)
    small = np.array(GUESS) * np.where(np.isin(np.arange(13), [0, 2, 5, 7]),
                                       0.3, 1.0)
    for n_terms, want in opcount.ITEM_OPS.items():
        for params, tau, strike in ((GUESS, 0.5, 100.0), (small, 0.02, 70.0),
                                    (GUESS, 2.0, 130.0)):
            out = json.loads(subprocess.run(
                [str(binary), str(n_terms), str(tau), "100.0", str(strike),
                 "0.03", "0.0", "10.0", *map(repr, map(float, params))],
                check=True, capture_output=True, text=True).stdout)
            assert {k: out[k] for k in want} == pytest.approx(want)
            assert 0 < out["cf_item_special"] < out["cf_item"]
            assert 0 < out["k1_cf_item_special"] < out["k1_cf_item"]
    c64 = opcount.ITEM_OPS[64]
    assert 0 < c64["payoff_term_call"] < c64["cf_item"]
    assert 0 < c64["group_range"] < c64["cf_item"]
    # K1's items are K2/K3's primal parts: the same transcendentals, none
    # of the derivatives
    assert 0 < c64["k1_payoff_term_call"] < c64["k1_cf_item"] < c64["cf_item"]
    assert 0 < c64["k1_range"] < c64["group_range"]


def test_work_scales_with_items():
    params, spots, strikes, mats = _lanes()
    call = torch.ones(3, 15, dtype=torch.bool)
    mkt = torch.ones(3, 15, dtype=F64)
    one = opcount.cos_vg_work(params[:1], spots[:1], strikes[:1], mats[:1],
                              call[:1], mkt[:1], 64, "loss")
    two = opcount.cos_vg_work(params[[0, 0]], spots[[0, 0]],
                              strikes[[0, 0]], mats[[0, 0]], call[:2],
                              mkt[:2], 64, "jac")
    assert two["ops"] == 2 * one["ops"]
    assert two["bytes"] > 2 * one["bytes"]       # K3 writes every row
    k1 = opcount.cos_price_work(params, spots, strikes, mats, call, 64)
    assert k1["ops"] > 0 and k1["bytes"] == 3 * 13 * 8 + 3 * 8 + 45 * 25
    two = opcount.cos_price_work(params[[0, 0]], spots[[0, 0]],
                                 strikes[[0, 0]], mats[[0, 0]], call[:2], 64)
    assert two["ops"] == 2 * opcount.cos_price_work(
        params[:1], spots[:1], strikes[:1], mats[:1], call[:1], 64)["ops"]
    ms, by = opcount.bound_ms(one, torch.float32)
    assert by == "operations" and ms == pytest.approx(
        one["ops"] / 67e12 * 1e3)
    assert opcount.bound_ms({"ops": 0, "bytes": 3.35e9}, F64) == (1.0,
                                                                 "bytes")


@pytest.mark.parametrize("n_terms", [64, 128])
def test_k1_work_counts_shared_items(n_terms):
    """K1's work: a range per (lane, maturity), CF items per (lane,
    effective group, k), a payoff term per (row, k). On the 5 x 3 surface
    with no binding widening that is about 3.6x less than a CF per row."""
    params, spots, strikes, mats = _lanes()
    call = torch.tensor([[True, False, True] * 5] * 3)
    c = opcount.ITEM_OPS[n_terms]
    work = opcount.cos_price_work(params, spots, strikes, mats, call,
                                  n_terms)
    n_mat, n_eff = opcount.effective_groups(params, spots, strikes, mats)
    calls = int(call.sum())
    assert work["effective_groups"] == int(n_eff.sum()) == 3 + 15 + int(
        n_eff[1])
    assert work["ops"] == pytest.approx(
        int(n_mat.sum()) * c["k1_range"]
        + int(n_eff.sum()) * n_terms * c["k1_cf_item"]
        + calls * (c["k1_row_setup_call"] + n_terms * c["k1_payoff_term_call"])
        + (45 - calls) * (c["k1_row_setup_put"]
                          + n_terms * c["k1_payoff_term_put"]))
    lane0 = opcount.cos_price_work(params[:1], spots[:1], strikes[:1],
                                   mats[:1], call[:1], n_terms)["ops"]
    per_row = (c["k1_range"] + c["k1_row_setup_call"]
               + n_terms * (c["k1_cf_item"] + c["k1_payoff_term_call"]))
    assert 3.3 < 15 * per_row / lane0 < 3.8
