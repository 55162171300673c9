"""Synthetic calibration-data generator.

The JAX package's ``data/synthetic.py``, in three steps with the random
draws split from the arithmetic, so the arithmetic can be held against
JAX fed the same draws:

  1. ``draw``: one call per kind on a ``torch.Generator`` (uniform
     parameter draws ``[n, 13]`` over the ranges, spot-walk normals
     ``[n]``, price-noise normals ``[n, 15]``), on the generator's device;
  2. ``ar1_paths``: the AR(1) parameter persistence (alpha = 0.9), the
     Feller cap and the spot walk. This recurrence is sequential over the
     days, so it runs on the host in numpy at the requested dtype (tens
     of microseconds a day, a fraction of a second for the CLI's 5000
     days), not as ~10 device launches a day;
  3. ``dataset_from_draws``: the whole history priced at once by
     ``ops/cos_kernel.price_surfaces`` on the target device (K1 on a CUDA
     device), then the 2 % multiplicative noise.

Semantics kept from the reference generator: the parameter ranges, the
spot walk with daily return ~ N(0.0003, 0.01), 3 maturities x 5
moneyness-preserved strikes (K = K_rel * spot / 100, maturity-major), the
weekday date labels from 2022-01-03, and the export as reference-compatible
``CalibrationResult`` records.
"""
from __future__ import annotations

import datetime
import pickle
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..convert import load_pickle
from ..models.double_heston import PARAM_NAMES
from ..ops.cos_kernel import price_surfaces
from ..utils.config import GeneratorConfig
from ..utils.results import CalibrationResult

# Empirical market parameter ranges (the reference generator's).
PARAM_RANGES = {
    "v1_0": (0.025, 0.080), "kappa1": (1.5, 4.5), "theta1": (0.025, 0.065),
    "sigma1": (0.20, 0.50), "rho1": (-0.85, -0.40),
    "v2_0": (0.020, 0.070), "kappa2": (0.30, 1.20), "theta2": (0.025, 0.070),
    "sigma2": (0.10, 0.35), "rho2": (-0.70, -0.20),
    "lambda_j": (0.05, 0.25), "mu_j": (-0.08, -0.01), "sigma_j": (0.03, 0.12),
}
RANGE_LO = np.array([PARAM_RANGES[n][0] for n in PARAM_NAMES])
RANGE_HI = np.array([PARAM_RANGES[n][1] for n in PARAM_NAMES])


def enforce_feller(params, margin: float = 0.90):
    """Cap sigma_i at ``margin * sqrt(2 kappa_i theta_i)`` on ``[..., 13]``
    params (an array; a copy is returned).

    The reference's ranges admit draws that violate the Feller condition,
    which the Feller-penalised loss then cannot reach; capping keeps the
    truth inside the model class the loss admits, and margin 0.90 keeps it
    clear of the penalty's kink. Given the ranges, the cap never pushes
    sigma below its own lower bound.
    """
    out = np.array(params)
    for s, k, t in ((3, 1, 2), (8, 6, 7)):
        cap = margin * np.sqrt(2.0 * out[..., k] * out[..., t])
        out[..., s] = np.minimum(out[..., s], cap)
    return out


class SyntheticDataset(NamedTuple):
    """Structure-of-arrays synthetic calibration history (tensors)."""
    params: torch.Tensor         # [n, 13] ground-truth parameters
    spots: torch.Tensor          # [n]
    strikes: torch.Tensor        # [n, 15] absolute strikes
    maturities: torch.Tensor     # [n, 15]
    model_prices: torch.Tensor   # [n, 15] noiseless COS prices
    market_prices: torch.Tensor  # [n, 15] noisy "market" prices
    losses: torch.Tensor         # [n] rel-MSE of model vs market

    @property
    def n_samples(self) -> int:
        return self.params.shape[0]


def trading_dates(n: int, start: str = "2022-01-03") -> List[str]:
    """Weekday date labels."""
    cur = datetime.date.fromisoformat(start)
    out = []
    for _ in range(n):
        while cur.weekday() >= 5:
            cur += datetime.timedelta(days=1)
        out.append(cur.isoformat())
        cur += datetime.timedelta(days=1)
    return out


def _surface_grid(config: GeneratorConfig):
    mats = np.repeat(config.surface.maturities,
                     len(config.surface.rel_strikes))
    rel = np.tile(config.surface.rel_strikes, len(config.surface.maturities))
    return rel, mats


def draw(n: int, generator: torch.Generator, dtype=torch.float64,
         n_opt: int = 15):
    """The generator's random inputs, on ``generator.device``: parameter
    draws uniform over ``PARAM_RANGES`` ``[n, 13]``, spot-walk normals
    ``[n]`` and price-noise normals ``[n, n_opt]``."""
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    lo, hi = (torch.as_tensor(a, dtype=dtype, device=generator.device)
              for a in (RANGE_LO, RANGE_HI))
    raw = torch.maximum(lo, torch.rand((n, 13), **kw) * (hi - lo) + lo)
    return raw, torch.randn((n,), **kw), torch.randn((n, n_opt), **kw)


def ar1_paths(raw, spot_normals, config: GeneratorConfig = GeneratorConfig()):
    """AR(1) parameter paths and the spot walk from the draws.

    ``params[0] = raw[0]`` and ``params[t] = alpha params[t-1] + (1 -
    alpha) raw[t]``, each row Feller-capped when ``config.enforce_feller``;
    ``spot[0] = S0`` and ``spot[t] = spot[t-1] (1 + spot_vol z[t] +
    spot_drift)``. Runs on the host in numpy at the dtype of ``raw``;
    returns ``(params [n, 13], spots [n])`` as tensors on ``raw``'s device
    (the CPU for arrays).
    """
    dev = raw.device if isinstance(raw, torch.Tensor) else torch.device("cpu")
    as_np = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a))
    raw, z = as_np(raw), as_np(spot_normals)
    dt = raw.dtype.type
    alpha = dt(config.ar_alpha)
    keep = dt(1.0) - alpha
    params = np.empty_like(raw)
    prev = None
    for t in range(raw.shape[0]):
        row = raw[t] if prev is None else alpha * prev + keep * raw[t]
        if config.enforce_feller:
            row = enforce_feller(row, dt(config.feller_margin))
        params[t] = prev = row
    growth = dt(1.0) + (z[1:] * dt(config.spot_vol) + dt(config.spot_drift))
    spots = np.cumprod(np.concatenate([[dt(config.surface.spot)], growth]))
    return (torch.from_numpy(params).to(dev),
            torch.from_numpy(spots.astype(raw.dtype)).to(dev))


def dataset_from_draws(raw, spot_normals, noise_normals,
                       config: GeneratorConfig = GeneratorConfig(),
                       dtype=torch.float64, n_terms: int = 128,
                       use_pallas: bool = False,
                       device=None) -> SyntheticDataset:
    """Paths, pricing and noise from given draws (``draw``'s three
    outputs), on ``device`` (default: the device of ``noise_normals`` if it
    is a tensor, else ``cuda``)."""
    if device is None:
        device = (noise_normals.device
                  if isinstance(noise_normals, torch.Tensor) else "cuda")
    dev = torch.device(device)
    noise = torch.as_tensor(noise_normals)
    params, spots = ar1_paths(raw, spot_normals, config)
    params, spots = params.to(dev, dtype), spots.to(dev, dtype)
    rel, mats = (torch.as_tensor(a, dtype=dtype, device=dev)
                 for a in _surface_grid(config))
    strikes = spots[:, None] * rel[None, :] / 100.0
    b_mats = mats.expand(strikes.shape).contiguous()
    is_call = torch.ones(strikes.shape, dtype=torch.bool, device=dev)
    rate = config.surface.rate
    if use_pallas:
        f32 = torch.float32
        model = price_surfaces(params.to(f32), spots.to(f32), rate,
                               strikes.to(f32), b_mats.to(f32), is_call,
                               n_terms=n_terms).to(dtype)
    else:
        model = price_surfaces(params, spots, rate, strikes, b_mats, is_call,
                               n_terms=n_terms)
    market = model * (1.0 + noise.to(dev, dtype) * config.market_noise)
    rel_err = (model - market) / market
    losses = torch.mean(rel_err * rel_err, dim=-1)
    return SyntheticDataset(params=params, spots=spots, strikes=strikes,
                            maturities=b_mats, model_prices=model,
                            market_prices=market, losses=losses)


def generate_dataset(generator: Optional[torch.Generator] = None,
                     config: GeneratorConfig = GeneratorConfig(),
                     dtype=torch.float64, n_terms: int = 128,
                     use_pallas: bool = False,
                     device=None) -> SyntheticDataset:
    """Generate a synthetic history of ``config.n_samples`` surfaces.

    ``generator`` (a seed-0 CPU generator when None) makes the draws on
    its own device; ``device`` (default ``cuda``, whatever the generator's
    device; a CPU run passes ``device="cpu"``) prices them. The prices are
    computed at ``dtype`` by K1 at that dtype; with ``use_pallas`` (the
    JAX package's switch to its float32 Pallas pricer) they are computed
    by K1<float> and cast to ``dtype``. On the CPU the plain pricer runs.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n_opt = config.surface.n_options
    raw, z, noise = draw(config.n_samples, generator, dtype, n_opt)
    return dataset_from_draws(raw, z, noise, config, dtype, n_terms,
                              use_pallas,
                              device if device is not None else "cuda")


def to_calibration_results(ds: SyntheticDataset,
                           config: GeneratorConfig = GeneratorConfig()
                           ) -> List[CalibrationResult]:
    """Reference-compatible ``CalibrationResult`` records (synthetic:
    ``calibration_time`` and ``iterations`` are None)."""
    dates = trading_dates(ds.n_samples, config.start_date)
    params, spots, strikes, mats, model, market, losses = (
        t.detach().cpu().numpy() for t in ds)
    out = []
    for i in range(ds.n_samples):
        opts = [dict(strike=float(k), maturity=float(t), price=float(p),
                     option_type="call")
                for k, t, p in zip(strikes[i], mats[i], market[i])]
        out.append(CalibrationResult(
            date=dates[i], spot=float(spots[i]),
            risk_free=config.surface.rate,
            parameters={n: float(v) for n, v in zip(PARAM_NAMES, params[i])},
            market_prices=market[i], model_prices=model[i],
            market_options=opts, final_loss=float(losses[i]),
            calibration_time=None, success=True, iterations=None,
            message="Synthetic data (not from real calibration)"))
    return out


def save_dataset(ds: SyntheticDataset, path: str,
                 config: GeneratorConfig = GeneratorConfig()) -> None:
    """``.pkl`` -> a pickled list of ``CalibrationResult`` records (the
    reference's format); anything else -> a compressed npz of the
    structure-of-arrays form (``.npz`` appended if missing)."""
    if str(path).endswith(".pkl"):
        with open(path, "wb") as f:
            pickle.dump(to_calibration_results(ds, config), f)
    else:
        np.savez_compressed(path, **{k: v.detach().cpu().numpy()
                                     for k, v in ds._asdict().items()})


def load_dataset(path: str, device="cuda") -> SyntheticDataset:
    """Load a dataset saved by either package's ``save_dataset`` (either
    format) onto ``device`` (default ``cuda``; a CPU run passes
    ``device="cpu"``); the JAX package's pickles load without JAX."""
    to = lambda a: torch.as_tensor(np.asarray(a)).to(device)
    if str(path).endswith(".pkl"):
        recs = load_pickle(path)
        return SyntheticDataset(
            params=to([[r.parameters[n] for n in PARAM_NAMES] for r in recs]),
            spots=to([r.spot for r in recs]),
            strikes=to([[o["strike"] for o in r.market_options]
                        for r in recs]),
            maturities=to([[o["maturity"] for o in r.market_options]
                           for r in recs]),
            model_prices=to([np.asarray(r.model_prices) for r in recs]),
            market_prices=to([np.asarray(r.market_prices) for r in recs]),
            losses=to([r.final_loss for r in recs]))
    path = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    with np.load(path) as z:
        return SyntheticDataset(**{k: to(z[k])
                                   for k in SyntheticDataset._fields})
