"""Whether what the timed path returned is correct: its outputs judged
by the plain float64 reference (``reference/cos.py``) on the benchmark's
own inputs, once the window has closed.

Every call's outputs are kept on the host (float64): the winner's
unconstrained ``x``, its ``params``, ``loss`` and ``model_prices``, and
every start's ``per_start_x`` and ``per_start_loss``. The numbers:

  * ``params_gap``: the largest relative gap between the returned
    parameters and the reference's transform of the returned ``x``;
  * ``price_gap``: the largest relative gap between a returned model
    price and the reference's price at those parameters, at the pricer
    settings the configuration polishes at;
  * ``loss_gap``: the largest relative gap between a returned loss and
    the reference's loss (relative MSE against the surface's own quotes
    plus the Feller penalty) at the reference's parameters: the winner's,
    and every start's where the configuration polishes every start. A
    start that ended with a variance factor's kappa / sigma^2 over
    ``KAPPA_OVER_SIGMA2_MAX`` is left out: there ``xi - d`` cancels in
    the characteristic function and its A and B terms divide by
    sigma^2, so two float64 evaluations of the same formula in another
    order part by up to tens of percent (starts, never winners, ended at
    sigma_2 = 8e-8 and at kappa_2 = 1.7e5; the market ranges reach 450);
  * ``err_median_pct``: the median over every surface of the window of
    its mean relative error against its noiseless truth, in %.

The gaps are taken over a sample of the window's surfaces drawn from the
seed, with the worst-fitted surfaces in it; a surface whose winner came
back non-finite is counted as failed, not judged here. A number is
compared where the cell gives it a limit; ``correct`` holds when every
compared number is at or under its limit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import gen
from .reference import cos as ref

WORST = 16       # the worst-fitted surfaces always in the sample
KAPPA_OVER_SIGMA2_MAX = 1e4


def surface_errors_pct(model: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Each surface's mean relative error against its truth, in %."""
    return np.abs((model - truth) / truth).mean(axis=-1) * 100.0


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest ``|a - b| / |b|`` (0 for no elements)."""
    if a.numel() == 0:
        return 0.0
    return float(((a - b).abs() / (b.abs() + 1e-300)).max())


def numbers(outputs: Dict[str, np.ndarray], idx: np.ndarray,
            pool: gen.Pool, pricer: dict, per_start_polished: bool,
            seed: int, sample: int, detail: dict = None) -> Dict[str, float]:
    """The numbers of a window whose calls returned ``outputs`` (every
    call's rows stacked, float64) for the pool rows ``idx``. ``detail``,
    where given, receives the pool row, start, returned and reference
    loss and ``x`` of the largest loss gap."""
    err = surface_errors_pct(outputs["model_prices"], pool.truth_host[idx])
    finite = (np.isfinite(outputs["loss"])
              & np.isfinite(outputs["model_prices"]).all(-1))
    rows = np.flatnonzero(finite)
    rng = np.random.default_rng([*gen.seed_words(seed), 9])
    pick = rng.choice(rows, size=min(sample, rows.size), replace=False)
    worst = rows[np.argsort(err[rows])[-WORST:]]
    pick = np.union1d(pick, worst)

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    src = idx[pick]
    spots = t(pool.spots.cpu().numpy()[src])
    strikes = t(pool.strikes.cpu().numpy()[src])
    mats = t(pool.maturities.cpu().numpy()[src])
    calls = torch.as_tensor(pool.is_call.cpu().numpy()[src])
    market = t(pool.market_host[src])

    def reprice(x):
        p = ref.transform(t(x))
        model = ref.price(p, spots, pool.rate, strikes, mats, calls,
                          n_terms=pricer["n_terms"], L=pricer["L"])
        value = ref.loss(model, p, market, pricer["feller_weight"],
                         pricer["bad_loss"])
        return p, model, value

    p_ref, model_ref, loss_ref = reprice(outputs["x"][pick])
    out = {
        "params_gap": _rel(t(outputs["params"][pick]), p_ref),
        "price_gap": _rel(t(outputs["model_prices"][pick]), model_ref),
        "err_median_pct": float(np.median(err)),
    }
    gaps = [_rel(t(outputs["loss"][pick]), loss_ref)]
    where = [(t(outputs["loss"][pick]), loss_ref, outputs["x"][pick], None,
              np.arange(pick.size))]
    if per_start_polished:
        xs, ls = outputs["per_start_x"][pick], outputs["per_start_loss"][pick]
        for s in range(xs.shape[1]):
            q = ref.transform(t(xs[:, s]))
            cond = torch.stack([q[:, k] / q[:, sig] ** 2
                                for sig, k, _ in ref.FELLER_IDX], -1)
            ok = (np.isfinite(ls[:, s])
                  & (cond.max(-1).values <= KAPPA_OVER_SIGMA2_MAX).numpy())
            if ok.any():
                keep = np.flatnonzero(ok)
                p = ref.transform(t(xs[keep, s]))
                model = ref.price(p, spots[keep], pool.rate, strikes[keep],
                                  mats[keep], calls[keep],
                                  n_terms=pricer["n_terms"], L=pricer["L"])
                value = ref.loss(model, p, market[keep],
                                 pricer["feller_weight"], pricer["bad_loss"])
                gaps.append(_rel(t(ls[keep, s]), value))
                where.append((t(ls[keep, s]), value, xs[keep, s], s, keep))
    out["loss_gap"] = max(gaps)
    if detail is not None:
        got, want, x, start, rows = where[int(np.argmax(gaps))]
        if got.numel():
            j = int(((got - want).abs() / (want.abs() + 1e-300)).argmax())
            detail.update(row=int(src[rows[j]]), start=start,
                          returned=float(got[j]), reference=float(want[j]),
                          x=np.asarray(x[j]).tolist())
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """``(correct, {name: {"value", "limit"}})`` over the limited
    numbers, in the order of ``limits``."""
    shown = {k: {"value": values[k], "limit": lim}
             for k, lim in limits.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return bool(ok), shown


def stack(outputs: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([o[k] for o in outputs])
            for k in outputs[0]}
