"""Frozen configuration dataclasses for the PyTorch port (torch-free).

Field names and defaults are those of the JAX package's
``utils/config.py`` so that ``dataclasses.asdict`` of either side can be
compared or converted (``convert.py``). The rationale for each default is
documented there; only the fields whose meaning differs on the port are
commented here.

The port has ONE calibration engine: batched flat L-BFGS whose
value-and-grad is the K2 kernel, then a batched Levenberg–Marquardt polish
of every start whose residuals are priced at float64 by K1 and whose
float32 Jacobian comes from K3, with compacted waves for the convergence
tail (or, with ``polish_all_starts=False`` or an ``LBFGSConfig`` polish,
a polish of the search winner alone). Several fields exist in the JAX
package only to choose between TPU workarounds; on the port each
accepted value selects that one engine, and any other value raises
``ValueError`` (``validate_calibration``):

  * ``CalibrationConfig.search_impl`` in {"vmap", "batched", "pallas"};
  * ``CalibrationConfig.polish_impl`` in {"vmap", "pallas"};
  * ``CalibrationConfig.polish_fused_min_lanes`` (any int >= 0) — the K3
    Jacobian is used at every lane count;
  * ``LMConfig.residual_impl`` in {"dd", "native"} — the double-float
    residual exists in JAX because XLA:TPU emulates float64; the H100 has
    native FP64, so both values price the polish's residuals at float64 on
    K1<double>. The double-float twin is here too
    (``calibration/loss.py::make_residual_fn_dd`` over
    ``models/double_heston_dd.py``), as an oracle for K1<double>, not as
    the polish's route: on the card it is slower and less exact;
  * ``LMConfig.f32_jacobian`` must be True (the K3 Jacobian is float32);
  * ``LBFGSConfig.flat`` picks the engine of ``ops/lbfgs.py::
    lbfgs_minimize`` (one lane); the batched engine of the search and of
    the Wolfe polish walks the same trajectory either way.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PricerConfig:
    """COS pricer settings (defaults mirror the reference)."""
    n_terms: int = 128
    trunc_L: float = 10.0
    dividend_yield: float = 0.0


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    """L-BFGS settings. ``flat`` selects ``lbfgs_minimize``'s engine (the
    flat state machine or the nested oracle, which walk the same
    trajectory); the batched engine ignores it."""
    maxiter: int = 300
    history: int = 10
    ftol: float = 1e-9
    gtol: float = 1e-6
    wolfe_c1: float = 1e-4
    wolfe_c2: float = 0.9
    max_linesearch: int = 20
    max_restarts: int = 2
    flat: bool = True
    maxeval: int = 0


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Batched Levenberg–Marquardt settings (ops/levenberg_marquardt.py)."""
    maxiter: int = 40
    ftol: float = 1e-14
    gtol: float = 1e-10
    xtol: float = 1e-12
    lambda_init: float = 1e-3
    lambda_up: float = 10.0
    lambda_down: float = 0.2
    lambda_min: float = 1e-12
    lambda_max: float = 1e8
    cost_target: float = 0.0
    f32_jacobian: bool = True
    residual_impl: str = "dd"


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Full calibration problem settings."""
    pricer: PricerConfig = PricerConfig()
    lbfgs: LBFGSConfig = LBFGSConfig()
    multi_start: int = 3
    feller_weight: float = 1000.0
    bad_loss: float = 1e10
    search_n_terms: int = 64
    search_maxeval: int = 160
    polish_n_terms: int = 64
    polish_stage_a_maxiter: int = 10
    polish_compact_min_lanes: int = 64
    polish_wave_budgets: Tuple[int, ...] = (16, 24, 48)
    polish_continue_margin: float = 30.0
    search_impl: str = "vmap"
    polish_impl: str = "vmap"
    polish_fused_min_lanes: int = 512


@dataclasses.dataclass(frozen=True)
class SurfaceSpec:
    """Standard benchmark surface: 5 strikes x 3 maturities, all calls."""
    rel_strikes: Tuple[float, ...] = (90.0, 95.0, 100.0, 105.0, 110.0)
    maturities: Tuple[float, ...] = (0.25, 0.5, 1.0)
    spot: float = 100.0
    rate: float = 0.03

    @property
    def n_options(self) -> int:
        return len(self.rel_strikes) * len(self.maturities)


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Synthetic data generator settings (data/synthetic.py). With
    ``enforce_feller`` the generator caps sigma_i at ``feller_margin *
    sqrt(2 kappa_i theta_i)``, so the truths stay recoverable under the
    Feller-penalised loss."""
    n_samples: int = 500
    ar_alpha: float = 0.9
    spot_drift: float = 0.0003
    spot_vol: float = 0.01
    market_noise: float = 0.02
    start_date: str = "2022-01-03"
    surface: SurfaceSpec = SurfaceSpec()
    enforce_feller: bool = True
    feller_margin: float = 0.90


_SEARCH_IMPLS = ("vmap", "batched", "pallas")
_POLISH_IMPLS = ("vmap", "pallas")
_RESIDUAL_IMPLS = ("dd", "native")


def validate_calibration(config: CalibrationConfig, polish=None) -> None:
    """Raise ``ValueError`` for a setting the port's one engine cannot run
    (the polish settings are checked when ``polish`` is given: an
    ``LBFGSConfig`` runs as it is, an ``LMConfig`` as the module docstring
    says)."""
    if config.search_impl not in _SEARCH_IMPLS:
        raise ValueError(f"search_impl must be one of {_SEARCH_IMPLS}, "
                         f"got {config.search_impl!r}")
    if config.polish_impl not in _POLISH_IMPLS:
        raise ValueError(f"polish_impl must be one of {_POLISH_IMPLS}, "
                         f"got {config.polish_impl!r}")
    if config.polish_fused_min_lanes < 0:
        raise ValueError("polish_fused_min_lanes must be >= 0")
    if polish is None or isinstance(polish, LBFGSConfig):
        return
    if not isinstance(polish, LMConfig):
        raise ValueError("polish must be an LMConfig or an LBFGSConfig; "
                         f"got {type(polish).__name__}")
    if polish.residual_impl not in _RESIDUAL_IMPLS:
        raise ValueError(f"residual_impl must be one of {_RESIDUAL_IMPLS}, "
                         f"got {polish.residual_impl!r}")
    if not polish.f32_jacobian:
        raise ValueError("the port's LM Jacobian is the float32 K3 kernel; "
                         "f32_jacobian=False is not supported")
