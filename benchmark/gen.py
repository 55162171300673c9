"""The one generator of the benchmark's inputs: a traffic file's
parameters -> a pool of surfaces with their noiseless truth prices, and
the order in which a run's calls take batches from it.

A traffic file (``traffic/<name>.json``) gives:

  * ``kind``: ``uniform`` (truths drawn uniformly over ``ranges``, as the
    reference's benchmark draws them) or ``ar1`` (the reference
    generator's AR(1) history: ``p[t] = ar_alpha p[t-1] + (1 - ar_alpha)
    raw[t]`` over uniform ``raw`` draws, the spot a random walk with daily
    return ``N(spot_drift, spot_vol)``);
  * ``ranges``: each parameter's ``[lo, hi]``;
  * ``feller_cap``: null, or the margin m that caps each factor's sigma
    at ``m sqrt(2 kappa theta)`` (every row, after the AR(1) step);
  * the surface: ``spot``, ``rate``, ``rel_strikes`` (% of spot),
    ``maturities`` (maturity-major grid), ``calls``;
  * the truth: ``truth_n_terms`` and ``truth_L`` of the reference pricer,
    and ``market_noise`` (the relative sd of multiplicative noise on the
    market prices; 0 for noiseless quotes);
  * ``pool_seed``: the seed of the pool's draws (and of the starts the
    configuration draws for it). The pool is the same in every run, so
    that every seed calibrates the same set of problems and only the
    order in which the calls take them changes with ``--seed``.

The draws are numpy's (the same pool on any machine); the truths are
priced on the run's device by ``reference/cos.py`` in float64.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from .reference import cos as ref


@dataclasses.dataclass
class Pool:
    """``P`` surfaces on the run's device (float64), and the truth prices
    on the host."""
    params: torch.Tensor     # [P, 13] the truths
    spots: torch.Tensor      # [P]
    strikes: torch.Tensor    # [P, n]
    maturities: torch.Tensor  # [P, n]
    is_call: torch.Tensor    # [P, n] bool
    truth: torch.Tensor      # [P, n] noiseless prices
    market: torch.Tensor     # [P, n] the quotes calibrated to
    rate: float
    truth_host: np.ndarray   # [P, n]
    market_host: np.ndarray  # [P, n]

    @property
    def size(self) -> int:
        return self.params.shape[0]

    def batch(self, idx: np.ndarray) -> dict:
        """The inputs of one call on the surfaces ``idx``."""
        i = torch.as_tensor(idx, device=self.params.device)
        return {"spots": self.spots[i], "strikes": self.strikes[i],
                "maturities": self.maturities[i], "is_call": self.is_call[i],
                "market": self.market[i], "rate": self.rate, "idx": i}


def _cap(params: np.ndarray, margin: float) -> np.ndarray:
    out = params.copy()
    for s, k, t in ref.FELLER_IDX:
        out[..., s] = np.minimum(out[..., s],
                                 margin * np.sqrt(2.0 * out[..., k]
                                                  * out[..., t]))
    return out


def draw_truths(traffic: dict, n: int):
    """``(params [n, 13], spots [n])`` as numpy float64 arrays."""
    rng = np.random.default_rng(traffic["pool_seed"])
    lo, hi = (np.array([traffic["ranges"][k][j] for k in ref.PARAM_NAMES])
              for j in (0, 1))
    raw = rng.uniform(lo, hi, (n, 13))
    cap = traffic.get("feller_cap")
    spot = float(traffic["spot"])
    if traffic["kind"] == "uniform":
        params = raw if cap is None else _cap(raw, cap)
        return params, np.full(n, spot)
    if traffic["kind"] != "ar1":
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    alpha = float(traffic["ar_alpha"])
    params = np.empty_like(raw)
    prev = None
    for t in range(n):
        row = raw[t] if prev is None else alpha * prev + (1 - alpha) * raw[t]
        params[t] = prev = row if cap is None else _cap(row, cap)
    z = rng.standard_normal(n)
    growth = 1.0 + z[1:] * traffic["spot_vol"] + traffic["spot_drift"]
    return params, np.cumprod(np.concatenate([[spot], growth]))


def make_pool(traffic: dict, n: int, device) -> Pool:
    """The pool of ``n`` surfaces of ``traffic``, priced on ``device``."""
    params, spots = draw_truths(traffic, n)
    rel = np.tile(np.asarray(traffic["rel_strikes"], float),
                  len(traffic["maturities"]))
    mats = np.repeat(np.asarray(traffic["maturities"], float),
                     len(traffic["rel_strikes"]))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    strikes = spots[:, None] * rel[None, :] / 100.0
    mats = np.ascontiguousarray(np.broadcast_to(mats, strikes.shape))
    is_call = torch.full(strikes.shape, bool(traffic["calls"]),
                         device=device)
    truth = ref.price(t(params), t(spots), float(traffic["rate"]),
                      t(strikes), t(mats), is_call,
                      n_terms=int(traffic["truth_n_terms"]),
                      L=float(traffic["truth_L"]))
    noise = float(traffic.get("market_noise", 0.0))
    market = truth
    if noise:
        z = np.random.default_rng([traffic["pool_seed"], 1]).standard_normal(
            strikes.shape)
        market = truth * (1.0 + noise * t(z))
    return Pool(params=t(params), spots=t(spots), strikes=t(strikes),
                maturities=t(mats).contiguous(), is_call=is_call, truth=truth,
                market=market.contiguous(), rate=float(traffic["rate"]),
                truth_host=truth.cpu().numpy(),
                market_host=market.cpu().numpy())


def seed_words(seed: int) -> list:
    """``--seed`` as non-negative words for numpy's SeedSequence."""
    seed = int(seed)
    return [seed % 2 ** 64, 1 if seed < 0 else 0]


def batches(seed: int, pool_size: int, batch: int,
            stream: int = 0) -> Iterator[np.ndarray]:
    """Each call's surfaces: every cycle a fresh permutation of the pool
    drawn from ``seed`` (and ``stream``: 0 for the window, 1 for the
    warm-up), cut into ``batch``-sized calls; a last partial batch of a
    cycle is dropped, so every call has ``batch`` surfaces."""
    per_cycle = pool_size // batch
    if per_cycle == 0:
        raise ValueError(f"pool of {pool_size} < batch {batch}")
    cycle = 0
    while True:
        rng = np.random.default_rng([*seed_words(seed), stream, cycle])
        perm = rng.permutation(pool_size)
        for j in range(per_cycle):
            yield perm[j * batch:(j + 1) * batch]
        cycle += 1

