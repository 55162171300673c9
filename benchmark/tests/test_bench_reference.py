"""The benchmark's plain reference and its frozen work count."""
import math

import pytest
import torch

from benchmark import gen
from benchmark.reference import cos as ref
from benchmark.workcount import cos_vg, peaks

DEMO = [0.04, 2.0, 0.04, 0.3, -0.5, 0.04, 1.5, 0.04, 0.2, -0.3,
        0.5, -0.05, 0.10]


def test_golden_call_and_put():
    """SURVEY 6.1's demo option, S0 = K = 100, T = 1, r = 0.05, N = 128,
    within the 1e-9 the card's K1<double> is held to."""
    got = ref.price(torch.tensor([DEMO], dtype=torch.float64), [100.0],
                    0.05, [[100.0, 100.0]], [[1.0, 1.0]], [[True, False]])
    assert abs(float(got[0, 0]) - 13.872851144174323) < 1e-9
    assert abs(float(got[0, 1]) - 8.995793594010637) < 1e-9


def test_blocks_do_not_change_prices():
    p = torch.tensor([DEMO] * 5, dtype=torch.float64)
    p[:, 0] *= torch.linspace(0.5, 1.5, 5, dtype=torch.float64)
    args = (p, [100.0] * 5, 0.03, [[90.0, 110.0]] * 5, [[0.25, 1.0]] * 5,
            [[True, True]] * 5)
    assert torch.equal(ref.price(*args, block=2), ref.price(*args))


def test_transform_and_loss():
    x = torch.zeros(2, 13, dtype=torch.float64)
    p = ref.transform(x)
    assert p[0, 0] == 1.0 and p[0, 4] == 0.0 and p[0, 11] == 0.0
    market = torch.tensor([[1.0, 2.0], [1.0, 2.0]], dtype=torch.float64)
    model = torch.tensor([[1.1, 2.0], [-1.0, 2.0]], dtype=torch.float64)
    # sigma = 1, kappa = theta = 1: each factor violates Feller by -1 <= 0
    loss = ref.loss(model, p, market, 1000.0, 1e10)
    assert loss[0] == pytest.approx(0.1 ** 2 / 2)
    assert loss[1] == 1e10             # a non-positive price: the sentinel
    p[0, 3] = 2.0                       # sigma1^2 - 2 kappa1 theta1 = 2
    assert ref.loss(model, p, market)[0] == pytest.approx(0.005 + 2000.0)


# ops/opcount.py::cos_vg_work at the commit the benchmark was written at,
# on GUESS0 lanes of 15 calls (5 strikes x 3 maturities, spot 100), where
# no row's widening binds: (lanes, N) -> ops, K2 bytes, K3 bytes.
OPCOUNT = {(15, 64): (6317685.0, 6345, 17265),
           (1536, 64): (646930944.0, 649728, 1767936),
           (1024, 128): (866380800.196608, 433152, 1178624)}


@pytest.mark.parametrize("lanes,n_terms", sorted(OPCOUNT))
def test_work_reproduces_the_program_count(lanes, n_terms):
    ops, k2_bytes, k3_bytes = OPCOUNT[lanes, n_terms]
    k2 = cos_vg.launch_work(lanes, n_terms, "loss")
    k3 = cos_vg.launch_work(lanes, n_terms, "jac")
    assert k2["ops"] == pytest.approx(ops, rel=1e-12)
    assert k3["ops"] == pytest.approx(ops, rel=1e-12)
    assert (k2["bytes"], k3["bytes"]) == (k2_bytes, k3_bytes)


def test_least_time_is_the_larger_bound():
    kind = "NVIDIA H100 80GB HBM3"
    assert peaks.least_seconds(67e12, 0, kind) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, kind) == pytest.approx(1.0)
    assert peaks.peaks("NVIDIA H100 PCIe")["fp32"] == 51.2e12
    assert peaks.least_seconds(1.0, 1.0, "some other card") is None
    assert math.isfinite(cos_vg.lane_ops(64))


def test_pool_truths_and_order():
    """The pool is the traffic file's, whatever the seed; every pass of
    a seed's order covers it once; noise, where asked for, moves the
    quotes only."""
    traffic = {"kind": "uniform", "pool_seed": 5, "feller_cap": 0.9,
               "ranges": {n: [0.1, 0.2] if n not in ("rho1", "rho2", "mu_j")
                          else [-0.5, -0.4] for n in ref.PARAM_NAMES},
               "spot": 100.0, "rate": 0.03, "rel_strikes": [95.0, 105.0],
               "maturities": [0.5, 1.0], "calls": True, "truth_n_terms": 64,
               "truth_L": 10.0}
    pool = gen.make_pool(traffic, 6, "cpu")
    assert torch.equal(pool.market, pool.truth)
    assert torch.equal(pool.params, gen.make_pool(traffic, 6, "cpu").params)
    sig, kap, the = (pool.params[:, i] for i in ref.FELLER_IDX[0])
    assert bool((sig <= 0.9 * torch.sqrt(2 * kap * the) + 1e-15).all())
    order = gen.batches(2 ** 31 + 3, 6, 2)
    first = [next(order) for _ in range(3)]
    assert sorted(int(i) for b in first for i in b) == list(range(6))
    again = gen.batches(2 ** 31 + 3, 6, 2)
    assert all((next(again) == b).all() for b in first)
    noisy = gen.make_pool({**traffic, "market_noise": 0.02}, 6, "cpu")
    rel = (noisy.market / noisy.truth - 1.0).abs()
    assert torch.equal(noisy.truth, pool.truth)
    assert 0 < float(rel.max()) < 0.2
