"""Batched multi-start calibration: float32 search + float64 LM polish.

Port of the JAX package's ``calibration/calibrator.py`` main path
(``calibrate_batch_mixed`` with ``search_impl="pallas"``,
``polish_impl="pallas"``): the port has one engine.

  * Search (``calibrate_batch``): every (surface, start) lane runs the
    batched flat L-BFGS in float32 on the K2 value-and-grad kernel; the
    winner is repriced with K1<float>.
  * Polish (``calibrate_batch_mixed``): every start is polished by the
    batched Levenberg–Marquardt, with float64 residuals priced by
    K1<double> and the float32 Jacobian from K3; the winner is picked on
    the polished loss. With at least ``polish_compact_min_lanes`` lanes the
    polish runs a short stage A, then compacted waves that continue only
    the lanes still unconverged and still able to win. With
    ``polish_all_starts=False``, or a Wolfe L-BFGS polish (an
    ``LBFGSConfig`` such as ``POLISH_LBFGS``), only the float32 search
    winner is polished: by the LM as above, or by the batched flat L-BFGS
    on the float64 loss with K2<double> as its value-and-grad, the model
    repriced by K1<double>.

The single-surface API (``calibrate_surface``,
``DoubleHestonJumpCalibrator``) runs the same batched engine on one
surface at the dtype of its market prices: the L-BFGS value-and-grad is
K2 at float32 or K2<double> at float64.

Inputs may be tensors or arrays; ``device`` is where the calibration
runs. ``device=None`` means the device of ``market_prices`` if it is a
tensor, else ``cuda``: a CPU run must ask for ``device="cpu"`` (or pass
CPU tensors), and without a card the default raises. On a CUDA device
every pricing call launches a kernel; on the CPU the kernels' plain
PyTorch versions run.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.double_heston import PARAM_NAMES, DHParams
from ..ops.cos_kernel import bind_price_surfaces, price_surfaces
from ..ops.lbfgs_batched import lbfgs_minimize_batched
from ..ops import levenberg_marquardt as lm
from ..ops.levenberg_marquardt import LMResult, lm_minimize_batched
from ..ops.loss_kernel import (EXP_MASK, FELLER_IDX, TANH_MASK,
                               bind_rows_jacobian, make_batch_value_and_grad,
                               maturity_groups, polish_jacobian_plain,
                               rows_jacobian)
from ..utils import tracing
from ..utils.config import (CalibrationConfig, LBFGSConfig, LMConfig,
                            validate_calibration)
from ..utils.results import CalibrationResult
from .initial_guess import initial_guesses
from .loss import loss_from_prices, residual_rows
from .transforms import inverse_transform, transform


class BatchCalibration(NamedTuple):
    """Output of a batch of multi-start calibrations (leading axis B)."""
    x: torch.Tensor              # winner unconstrained params [B, 13]
    params: torch.Tensor         # winner constrained params [B, 13]
    loss: torch.Tensor           # winner loss [B]
    model_prices: torch.Tensor   # surface repriced at the winner [B, n_opt]
    iterations: torch.Tensor     # winner's iterations [B]
    n_evals: torch.Tensor        # objective evaluations [B]
    converged: torch.Tensor      # winner converged flag [B]
    per_start_loss: torch.Tensor  # every start's final loss [B, S]
    per_start_x: torch.Tensor    # every start's iterate [B, S, 13], always set


# Default polish: LM on the residual vector (the JAX package's POLISH_LM).
POLISH_LM = LMConfig(maxiter=80, ftol=1e-15, gtol=1e-11, cost_target=1e-10)

# The Wolfe L-BFGS polish (the JAX package's POLISH_LBFGS): from the
# search winner down to the float64 floor.
POLISH_LBFGS = LBFGSConfig(maxiter=60, ftol=1e-14, gtol=1e-10)

# (live lanes, padded lanes) of each compacted wave of the most recent
# calibrate_batch_mixed call; empty when the polish ran in one stage.
WAVE_LANES: List[Tuple[int, int]] = []


def _inputs(spots, strikes, maturities, is_call, market_prices, dtype,
            device):
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return (f(spots), f(strikes), f(maturities),
            torch.as_tensor(is_call, dtype=torch.bool, device=device),
            f(market_prices))


def _device_of(market_prices, device) -> torch.device:
    """``device`` if given, else the device of ``market_prices`` if it is
    a tensor, else ``cuda`` (no CPU fallback)."""
    if device is not None:
        return torch.device(device)
    if isinstance(market_prices, torch.Tensor):
        return market_prices.device
    return torch.device("cuda")


def _winner(f: torch.Tensor):
    """Non-finite losses masked to +inf; first argmin per surface."""
    masked = torch.where(torch.isfinite(f), f, torch.full_like(f, math.inf))
    return masked, torch.argmin(masked, dim=-1)


def _take(a: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    return a[torch.arange(a.shape[0], device=a.device), win]


@tracing.entry_point
def calibrate_batch(spots, rate: float, strikes, maturities, is_call,
                    market_prices,
                    generator: Optional[torch.Generator] = None,
                    config: CalibrationConfig = CalibrationConfig(),
                    n_starts: int = 3, x0=None,
                    device=None,
                    dtype: torch.dtype = torch.float32) -> BatchCalibration:
    """Multi-start search over ``[B, n_opt]`` surfaces at ``dtype``
    (float32, the search of ``calibrate_batch_mixed``; or float64).

    All ``B * n_starts`` lanes run one batched L-BFGS whose value-and-grad
    is K2 at ``dtype``; the winner (lowest finite loss) is repriced by K1
    at ``dtype``. ``x0 [B, n_starts, 13]`` (unconstrained) replaces the
    generated starts; otherwise they come from ``initial_guesses`` with
    ``generator`` (a seed-0 CPU generator when None).
    """
    validate_calibration(config)
    dev = _device_of(market_prices, device)
    spots, strikes, maturities, is_call, mkt = _inputs(
        spots, strikes, maturities, is_call, market_prices, dtype, dev)
    b = spots.shape[0]
    with tracing.span("search"):
        if x0 is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            x0 = initial_guesses(n_starts, generator, spots, strikes,
                                 maturities, mkt)
        else:
            x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
            if x0.shape != (b, n_starts, 13):
                raise ValueError(f"x0 must be [{b}, {n_starts}, 13], got "
                                 f"{tuple(x0.shape)}")
        rep = lambda a: torch.repeat_interleave(a, n_starts, dim=0)
        vg = make_batch_value_and_grad(rep(spots), rep(strikes),
                                       rep(maturities), rep(is_call),
                                       rep(mkt), rate, config)
        res = lbfgs_minimize_batched(vg, x0.reshape(b * n_starts, 13),
                                     config.lbfgs)
        shape2 = lambda a: a.reshape(b, n_starts, *a.shape[1:])
        masked, win = _winner(shape2(res.f))
        xs = shape2(res.x)
        x_best = _take(xs, win)
    with tracing.span("reprice"):
        params_vec = transform(x_best)
        pc = config.pricer
        model = price_surfaces(params_vec, spots, rate, strikes, maturities,
                               is_call, n_terms=pc.n_terms, L=pc.trunc_L,
                               q=pc.dividend_yield)
    return BatchCalibration(
        x=x_best, params=params_vec, loss=_take(masked, win),
        model_prices=model,
        iterations=_take(shape2(res.n_iters), win),
        n_evals=_take(shape2(res.n_evals), win),
        converged=(_take(shape2(res.converged), win)
                   & torch.isfinite(_take(masked, win))),
        per_start_loss=shape2(res.f), per_start_x=xs)


# The JAX package's calibrate_batch_fused (the batched engine over every
# (surface, start) lane) is what the port's calibrate_batch is.
calibrate_batch_fused = calibrate_batch


class PolishObjective:
    """The LM polish's objective over flat lanes: float64 residuals from
    K1<double> (``__call__``) and the float32 Jacobian from K3 (``jac``,
    cast up by the engine), with the host assembly of
    ``calibration/loss.py::residual_rows`` and
    ``ops/loss_kernel.py::polish_jacobian_plain``. It unpacks as
    ``(residual_fn, jac_fn)``, whose engine trip is the unfused one around
    that assembly. Passed itself as ``lm_minimize_batched``'s residual
    function, it binds the fused trip (``bind_trip``): it holds the
    problem at float64 and float32, the maturity groups K3 takes and, per
    run, the trip's buffers."""

    def __init__(self, lane_spots, rate, lane_strikes, lane_mats, lane_call,
                 lane_mkt, config: CalibrationConfig):
        f32 = torch.float32
        self.spots, self.strikes, self.mats, self.mkt = (
            t.contiguous() for t in (lane_spots, lane_strikes, lane_mats,
                                     lane_mkt))
        self.call = lane_call.contiguous()
        self.spots32, self.strikes32, self.mats32, self.mkt32 = (
            t.to(f32) for t in (self.spots, self.strikes, self.mats,
                                self.mkt))
        self.groups32 = maturity_groups(self.mats32)   # fixed across trips
        self.rate = rate
        self.config = config

    @property
    def n_rows(self) -> int:
        """Residual rows a lane: n options and the two Feller rows."""
        return self.mkt.shape[-1] + 2

    def _pricer(self):
        pc = self.config.pricer
        return pc.n_terms, pc.trunc_L, pc.dividend_yield

    def prices(self, params64):
        """K1<double> (its plain version on the CPU) at ``params64``."""
        n_terms, L, q = self._pricer()
        return price_surfaces(params64, self.spots, self.rate, self.strikes,
                              self.mats, self.call, n_terms=n_terms, L=L,
                              q=q)

    def rows(self, params32):
        """K3's rows (its plain version on the CPU) at ``params32``."""
        return rows_jacobian(params32, self.spots32, self.rate,
                             self.strikes32, self.mats32, self.call,
                             self.mkt32, *self._pricer(), self.groups32)[1]

    def __call__(self, x):
        params = transform(x)
        return residual_rows(self.prices(params), DHParams.from_vector(params),
                             self.mkt, self.config.feller_weight,
                             self.config.bad_loss)

    def jac(self, x):
        params = transform(x.to(torch.float32))
        return polish_jacobian_plain(self.rows(params), params,
                                     self.config.feller_weight)

    def __iter__(self):
        return iter((self.__call__, self.jac))

    def fused_trial(self, n_lanes: int, device) -> lm.LMFusedTrial:
        """The fused entries' buffers and constants for ``n_lanes`` lanes
        of this objective (``n_lanes`` must be its own)."""
        f32, f64 = torch.float32, torch.float64
        n = self.mkt.shape[-1]
        new = lambda dt, *shape: torch.empty(shape, dtype=dt, device=device)
        return lm.LMFusedTrial(
            params64=new(f64, n_lanes, 13), params32=new(f32, n_lanes, 13),
            price=new(f64, n_lanes, n), jac=new(f32, n_lanes, n, 13),
            mkt=self.mkt, weight=float(self.config.feller_weight),
            bad_loss=float(self.config.bad_loss), exp_mask=EXP_MASK,
            tanh_mask=TANH_MASK, feller=FELLER_IDX)

    def bind_trip(self, st, config: LMConfig, status, plain: bool):
        """The fused LM trip on this objective, bound once for the engine's
        state ``st`` and ``status`` (``levenberg_marquardt._bind_trip``):
        on CUDA tensors (unless ``plain``) fused K6, K1<double> and K3 into
        bound buffers (K3 skipping the lanes that ``st.done`` flags as the
        trip starts: finished lanes, a wave's padding; ``trip(live)``'s
        count of them not done sets its blocks' width), fused K7; else
        ``lm_open_fused_plain``, ``prices``, ``rows`` and
        ``lm_update_fused_plain`` in place. The first trip is
        the bootstrap (K1 at x0). None for no lanes, or where the fused
        kernels do not take the rows (n + 2 > ``MAX_FUSED_ROWS``): the
        engine then takes its unfused trip around ``__call__`` and
        ``jac``. Raises on anything else the kernels do not take."""
        n_lanes = st.x.shape[0]
        if n_lanes == 0 or self.n_rows > lm.MAX_FUSED_ROWS:
            return None
        trial = self.fused_trial(n_lanes, st.x.device)
        lm._check_fused(st, trial)
        lm._check_status(status, st.x.device)
        boot = [True]
        if st.x.device.type == "cuda" and not plain:
            kernels = lm.LMTripKernels(st, config, status,
                                       torch.empty_like(st.x), trial)
            n_terms, L, q = self._pricer()
            k1 = bind_price_surfaces(trial.params64, self.spots, self.rate,
                                     self.strikes, self.mats, self.call,
                                     n_terms, L, q, trial.price)
            k3 = bind_rows_jacobian(
                trial.params32, self.spots32, self.rate, self.strikes32,
                self.mats32, self.call, self.mkt32, n_terms, L, q,
                self.groups32, torch.empty_like(self.mkt32), trial.jac,
                st.done)

            def trip(live=None):
                kernels.open(boot.pop() if boot else False)
                k1()
                k3(live)
                kernels.update()
            return trip

        def trip(live=None):
            x_try, params64, params32 = lm._open_fused_plain_inplace(
                st, config, status, boot.pop() if boot else False)
            lm._update_fused_plain_inplace(
                st, x_try, params64, params32, self.prices(params64),
                self.rows(params32), trial, config, status)
        return trip


def polish_residual_and_jacobian(lane_spots, rate, lane_strikes, lane_mats,
                                 lane_call, lane_mkt,
                                 config: CalibrationConfig) -> PolishObjective:
    """The LM polish's objective over flat lanes (``PolishObjective``):
    float64 residuals from K1<double>, the float32 Jacobian from K3 (cast
    up by the engine); it unpacks as ``(residual_fn, jac_fn)``. Lane
    tensors are float64 ``[L, ...]``."""
    return PolishObjective(lane_spots, rate, lane_strikes, lane_mats,
                           lane_call, lane_mkt, config)


def _polish_lanes_fused(lane_spots, rate, lane_strikes, lane_mats, lane_call,
                        lane_mkt, x0, lam0, config: CalibrationConfig,
                        polish: LMConfig, live: int = None):
    """Batched LM over flat lanes: float64 residuals from K1<double>, the
    float32 Jacobian from K3, on the objective's fused trip (fused K6,
    K1<double>, K3, fused K7 and one read a trip on the card). Lane tensors
    are float64 ``[L, ...]``; with ``live`` the lanes from ``live`` on are
    padding, which starts done (``lm_minimize_batched``)."""
    objective = polish_residual_and_jacobian(
        lane_spots, rate, lane_strikes, lane_mats, lane_call, lane_mkt,
        config)
    res = lm_minimize_batched(objective, x0, polish, jac_fn=objective.jac,
                              lam0=lam0, live=live)
    n_opt = lane_mkt.shape[-1]
    params_vec = transform(res.x)
    model = lane_mkt * (1.0 + res.r[:, :n_opt] * math.sqrt(n_opt))
    return res, params_vec, model


def _polish_starts_fused(spots, rate, strikes, maturities, is_call,
                         market_prices, x0, config: CalibrationConfig,
                         polish: LMConfig):
    """Polish every start: ``x0 [B, S, 13]`` -> per-(surface, start)
    results with leading ``[B, S]`` axes."""
    b, s = x0.shape[:2]
    rep = lambda a: torch.repeat_interleave(a, s, dim=0)
    res, params_vec, model = _polish_lanes_fused(
        rep(spots), rate, rep(strikes), rep(maturities), rep(is_call),
        rep(market_prices), x0.reshape(b * s, 13), None, config, polish)
    shape2 = lambda a: a.reshape(b, s, *a.shape[1:])
    return LMResult(*map(shape2, res)), shape2(params_vec), shape2(model)


def _polish_winners(spots, rate, strikes, maturities, is_call,
                    market_prices, x0, config: CalibrationConfig, polish):
    """Polish one start per surface, ``x0 [B, 13]`` (float64 inputs).

    An ``LMConfig`` polish is ``_polish_lanes_fused`` at
    ``config.polish_n_terms``: K1<double> residuals, the K3 Jacobian. An
    ``LBFGSConfig`` polish is the batched flat L-BFGS on the loss at
    ``config.pricer.n_terms`` with K2<double> as its value-and-grad, the
    model repriced by K1<double> (the JAX package's ``_polish_core``).
    Returns (result, params [B, 13], model prices [B, n_opt]); the result
    has ``x``, ``f``, ``n_iters``, ``n_evals`` and ``converged``."""
    if isinstance(polish, LMConfig):
        return _polish_lanes_fused(spots, rate, strikes, maturities, is_call,
                                   market_prices, x0, None,
                                   _polish_pricer_config(config), polish)
    vg = make_batch_value_and_grad(spots, strikes, maturities, is_call,
                                   market_prices, rate, config)
    res = lbfgs_minimize_batched(vg, x0, polish)
    params_vec = transform(res.x)
    pc = config.pricer
    model = price_surfaces(params_vec, spots, rate, strikes, maturities,
                           is_call, n_terms=pc.n_terms, L=pc.trunc_L,
                           q=pc.dividend_yield)
    return res, params_vec, model


def _polish_pricer_config(config: CalibrationConfig) -> CalibrationConfig:
    """Polish-phase pricer: N = config.polish_n_terms COS terms."""
    return dataclasses.replace(
        config, pricer=dataclasses.replace(config.pricer,
                                           n_terms=config.polish_n_terms))


def _continue_unconverged(spots, rate, strikes, maturities, is_call,
                          market_prices, res: LMResult, params_vec, model,
                          polish_config: CalibrationConfig, polish: LMConfig,
                          maxiter: int):
    """One compacted wave: gather the (surface, start) lanes still
    unconverged and within ``polish_continue_margin`` of their surface's
    best polished loss, pad them to a power-of-two bucket of at least 32
    (at most B * S; the padding, copies of the first lane, starts done and
    is dropped), continue them for ``maxiter`` more LM iterations from
    their damping (clipped to [lambda_init, 1e2]), and scatter the results
    back (iteration and evaluation counts add up). Its span ``polish.wave``
    is left out of the store where no lane is left."""
    polish = dataclasses.replace(polish, maxiter=maxiter)
    b, s = res.x.shape[:2]
    flat = lambda a: a.reshape(b * s, *a.shape[2:])
    with tracing.span("polish.wave") as wave:
        with tracing.span("polish.compact"):
            conv = res.converged.cpu().numpy()
            f = res.f.cpu().numpy()
            with np.errstate(invalid="ignore"):
                best = np.nanmin(np.where(np.isfinite(f), f, np.nan), axis=1,
                                 keepdims=True)
            matter = np.isfinite(f) & (
                f <= best * polish_config.polish_continue_margin)
            idx = np.nonzero((~conv & matter).reshape(-1))[0]
            if idx.size == 0:
                wave.drop()
                return res, params_vec, model
            n_pad = min(max(32, 1 << int(idx.size - 1).bit_length()), b * s)
            pad_idx = np.concatenate(
                [idx, np.full(n_pad - idx.size, idx[0], np.int64)])
            dev = res.x.device
            surf = torch.as_tensor(pad_idx // s, device=dev)
            lanes = torch.as_tensor(pad_idx, device=dev)
            live = torch.as_tensor(idx, device=dev)
            WAVE_LANES.append((int(idx.size), int(n_pad)))
            lam0 = torch.clamp(flat(res.lam)[lanes], polish.lambda_init, 1e2)
            wave_inputs = (spots[surf], rate, strikes[surf], maturities[surf],
                           is_call[surf], market_prices[surf],
                           flat(res.x)[lanes], lam0)
        resB, paramsB, modelB = _polish_lanes_fused(
            *wave_inputs, polish_config, polish, live=int(idx.size))

        def put(whole, part):
            out = flat(whole).clone()
            out[live] = part[:idx.size]
            return out.reshape(whole.shape)

        def add(whole, part):
            out = flat(whole).clone()
            out[live] += part[:idx.size]
            return out.reshape(whole.shape)

        res = res._replace(
            x=put(res.x, resB.x), f=put(res.f, resB.f),
            grad=put(res.grad, resB.grad), r=put(res.r, resB.r),
            n_iters=add(res.n_iters, resB.n_iters),
            n_evals=add(res.n_evals, resB.n_evals),
            converged=put(res.converged, resB.converged),
            lam=put(res.lam, resB.lam))
        return res, put(params_vec, paramsB), put(model, modelB)


@tracing.entry_point
def calibrate_batch_mixed(spots, rate: float, strikes, maturities, is_call,
                          market_prices,
                          generator: Optional[torch.Generator] = None,
                          config: CalibrationConfig = CalibrationConfig(),
                          n_starts: int = 3, polish=POLISH_LM,
                          x0=None, device=None,
                          polish_all_starts: bool = True) -> BatchCalibration:
    """Mixed-precision batch calibration: float32 multi-start search, then
    a float64 polish.

    The search prices at ``config.search_n_terms`` with at most
    ``config.search_maxeval`` evaluations per lane. ``polish`` is an
    ``LMConfig`` (default ``POLISH_LM``) or an ``LBFGSConfig`` (e.g.
    ``POLISH_LBFGS``).

    With an LM polish and ``polish_all_starts`` (the default) every start
    is polished at ``config.polish_n_terms`` and the winner is picked on
    the polished loss: ``iterations`` adds the search winner's iterations
    to the polished winner's, ``n_evals`` adds the polish evaluations of
    all starts, ``converged`` is the polished winner's flag, and
    ``per_start_x`` holds every polished start. ``WAVE_LANES`` records the
    compacted waves.

    Otherwise only the search winner is polished (``_polish_winners``):
    ``loss`` is its polished loss, ``iterations`` and ``n_evals`` add the
    search winner's counts to the polish's, ``per_start_loss`` is the
    search's losses at float64, and ``per_start_x`` the search's iterates
    with the winner's row replaced by its polished ``x``. Either way the
    winner's row of ``per_start_x`` equals ``x``.
    """
    validate_calibration(config, polish)
    dev = _device_of(market_prices, device)
    search_config = dataclasses.replace(
        config,
        pricer=dataclasses.replace(config.pricer,
                                   n_terms=config.search_n_terms),
        lbfgs=dataclasses.replace(config.lbfgs,
                                  maxeval=config.search_maxeval))
    out32 = calibrate_batch(spots, rate, strikes, maturities, is_call,
                            market_prices, generator, search_config,
                            n_starts, x0, dev)

    WAVE_LANES.clear()
    f64 = torch.float64
    spots, strikes, maturities, is_call, mkt = _inputs(
        spots, strikes, maturities, is_call, market_prices, f64, dev)
    b = spots.shape[0]
    if not (polish_all_starts and isinstance(polish, LMConfig)):
        with tracing.span("polish.winner"):
            res, params_vec, model = _polish_winners(
                spots, rate, strikes, maturities, is_call, mkt,
                out32.x.to(f64), config, polish)
        _, win32 = _winner(out32.per_start_loss)
        per_start_x = out32.per_start_x.to(f64, copy=True)
        per_start_x[torch.arange(b, device=dev), win32] = res.x
        return BatchCalibration(
            x=res.x, params=params_vec, loss=res.f, model_prices=model,
            iterations=out32.iterations + res.n_iters,
            n_evals=out32.n_evals + res.n_evals, converged=res.converged,
            per_start_loss=out32.per_start_loss.to(f64),
            per_start_x=per_start_x)

    polish_config = _polish_pricer_config(config)
    compact = b * n_starts >= config.polish_compact_min_lanes
    stage_a = (dataclasses.replace(polish,
                                   maxiter=config.polish_stage_a_maxiter)
               if compact else polish)
    with tracing.span("polish.stage_a"):
        res, params_vec, model = _polish_starts_fused(
            spots, rate, strikes, maturities, is_call, mkt,
            out32.per_start_x.to(f64), polish_config, stage_a)
    if compact:
        for wave_iters in config.polish_wave_budgets:
            res, params_vec, model = _continue_unconverged(
                spots, rate, strikes, maturities, is_call, mkt, res,
                params_vec, model, polish_config, polish, wave_iters)
    masked, win = _winner(res.f)
    return BatchCalibration(
        x=_take(res.x, win), params=_take(params_vec, win),
        loss=_take(masked, win), model_prices=_take(model, win),
        iterations=out32.iterations + _take(res.n_iters, win),
        n_evals=out32.n_evals + res.n_evals.sum(dim=-1, dtype=torch.int32),
        converged=_take(res.converged, win),
        per_start_loss=masked, per_start_x=res.x)


def calibrate_surface(spot, rate: float, strikes, maturities, is_call,
                      market_prices,
                      generator: Optional[torch.Generator] = None,
                      config: CalibrationConfig = CalibrationConfig(),
                      n_starts: int = 3, x0=None,
                      device=None) -> BatchCalibration:
    """One surface ``[n_opt]``, ``n_starts`` L-BFGS solves with
    ``config.lbfgs`` at ``config.pricer.n_terms`` COS terms, at the dtype
    of ``market_prices``: a batch-of-one ``calibrate_batch``, so K2 (float32)
    or K2<double> (float64) is the value-and-grad. ``x0 [n_starts, 13]``
    replaces the generated starts. The result has no batch axis."""
    dev = _device_of(market_prices, device)
    mkt = torch.as_tensor(market_prices)
    one = lambda a: torch.as_tensor(a)[None]
    out = calibrate_batch(
        torch.as_tensor(spot).reshape(1), rate, one(strikes), one(maturities),
        one(is_call), mkt[None], generator, config, n_starts,
        None if x0 is None else one(x0), dev, dtype=mkt.dtype)
    return BatchCalibration(*(a[0] for a in out))


def surface_loss_k1(params: torch.Tensor, spots, rate, strikes, maturities,
                    is_call, market_prices,
                    config: CalibrationConfig) -> torch.Tensor:
    """``[L]`` losses (``loss.py::surface_loss``) at constrained
    ``params [L, 13]``, priced by K1 at the dtype of ``params``."""
    pc = config.pricer
    prices = price_surfaces(params, spots, rate, strikes, maturities, is_call,
                            n_terms=pc.n_terms, L=pc.trunc_L,
                            q=pc.dividend_yield)
    return loss_from_prices(prices, DHParams.from_vector(params),
                            market_prices, config)


def options_to_arrays(market_options: List[Dict], dtype=np.float64):
    """Convert the reference's list-of-dicts market format to arrays."""
    strikes = np.array([o["strike"] for o in market_options], dtype)
    maturities = np.array([o["maturity"] for o in market_options], dtype)
    prices = np.array([o["price"] for o in market_options], dtype)
    is_call = np.array(
        [str(o.get("option_type", "call")).upper()[0] == "C"
         for o in market_options])
    return strikes, maturities, prices, is_call


class DoubleHestonJumpCalibrator:
    """The reference calibrator's class API (spot, risk_free_rate,
    market_options list of {'strike', 'maturity', 'price', 'option_type'}
    dicts; ``.calibrate(maxiter, multi_start)`` returning a
    CalibrationResult), backed by ``calibrate_surface``.

    ``dtype`` is float32 by default (the JAX package's default without x64)
    or float64; ``device`` (default ``cuda``) is where it runs; a CPU run
    passes ``device="cpu"``. ``generator`` draws the
    perturbed starts; every ``calibrate`` call starts from its state at
    construction (a seed-0 CPU generator when None), as the JAX package
    reuses its seed.
    """

    def __init__(self, spot: float, risk_free_rate: float,
                 market_options: List[Dict],
                 config: CalibrationConfig = CalibrationConfig(),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        self.spot = spot
        self.risk_free_rate = risk_free_rate
        self.market_options = market_options
        self.dtype = dtype
        self.config = config
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self._gen_device = generator.device
        self._gen_state = generator.get_state()
        k, m, p, c = options_to_arrays(market_options)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self.strikes, self.maturities, self.market_prices = t(k), t(m), t(p)
        self.is_call = torch.as_tensor(c, device=self.device)
        self.param_names = list(PARAM_NAMES)

    def compute_loss(self, x) -> float:
        """Loss at an unconstrained 13-vector (reference API parity)."""
        params = transform(torch.as_tensor(x, dtype=self.dtype,
                                           device=self.device))[None]
        t = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                      device=self.device)
        return float(surface_loss_k1(
            params, t([self.spot]), self.risk_free_rate, self.strikes[None],
            self.maturities[None], self.is_call[None],
            self.market_prices[None], self.config)[0])

    def transform_params(self, x) -> Dict[str, float]:
        vec = transform(torch.as_tensor(x, dtype=self.dtype))
        return {n: float(v) for n, v in zip(PARAM_NAMES, vec)}

    def inverse_transform_params(self, params: Dict[str, float]) -> np.ndarray:
        vec = torch.tensor([params[n] for n in PARAM_NAMES], dtype=self.dtype)
        return inverse_transform(vec).numpy()

    def calibrate(self, maxiter: int = 300, multi_start: int = 3
                  ) -> CalibrationResult:
        """Run the multi-start calibration; returns the best result. The
        wall time is taken after the device has finished."""
        t0 = time.time()
        cfg = dataclasses.replace(
            self.config,
            lbfgs=dataclasses.replace(self.config.lbfgs, maxiter=maxiter))
        gen = torch.Generator(device=self._gen_device)
        gen.set_state(self._gen_state)
        out = calibrate_surface(
            torch.tensor(self.spot, dtype=self.dtype), self.risk_free_rate,
            self.strikes, self.maturities, self.is_call, self.market_prices,
            gen, cfg, multi_start, device=self.device)
        out = BatchCalibration(*(a.cpu().numpy() for a in out))
        elapsed = time.time() - t0

        success = bool(np.isfinite(out.loss))
        params = {n: float(v) for n, v in zip(PARAM_NAMES, out.params)}
        return CalibrationResult(
            date="", spot=float(self.spot),
            risk_free=float(self.risk_free_rate), parameters=params,
            market_prices=self.market_prices.cpu().numpy(),
            model_prices=out.model_prices,
            market_options=self.market_options,
            final_loss=float(out.loss),
            calibration_time=elapsed,
            success=success,
            iterations=int(out.iterations),
            message=("converged" if bool(out.converged)
                     else "stopped (maxiter or line search)") if success
                    else "All optimization starts failed")
