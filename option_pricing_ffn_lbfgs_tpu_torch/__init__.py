"""PyTorch + CUDA port of the Double Heston + jump calibration framework.

The JAX package ``option_pricing_ffn_lbfgs_tpu`` is the reference; this
package mirrors its module layout and imports ``torch``, never ``jax``.
Its kernels (``csrc/``) are built for the H100 (sm_90a) at first use; on a
CPU tensor every kernel wrapper runs its plain PyTorch version.

The entry points run on the card unless the caller asks for the CPU:
``device=None`` means the device of a tensor input where one was passed,
else ``cuda``; ``DoubleHestonJumpCalibrator`` and ``load_dataset`` default
to ``"cuda"``; ``generate_dataset`` prices on ``cuda``. Without a card
these defaults raise; a CPU run passes ``device="cpu"`` (or CPU tensors).

Quick start::

    from option_pricing_ffn_lbfgs_tpu_torch import (
        DoubleHestonJumpCalibrator, hybrid_calibrate_batch_mixed,
        load_default_model)

    cal = DoubleHestonJumpCalibrator(spot, rate, market_options)  # cuda
    result = cal.calibrate(maxiter=300, multi_start=3)
    surrogate = load_default_model()
    out = hybrid_calibrate_batch_mixed(surrogate, spots, rate, strikes,
                                       maturities, is_call, market_prices)

Training a surrogate (``fit``, ``pretrain_and_finetune``; the whole
two-stage pipeline is ``tools/train_pipeline.py``) runs on ``cuda`` too,
as do the Greeks (``greeks``, ``param_sensitivities``) and the
Black–Scholes functions. The benchmark is ``tools/bench.py``.
``calibrate_sharded`` splits a batch over the ranks of a
``torch.distributed`` mesh (``make_mesh``, ``distributed_init``); the
JAX package's ``__graft_entry__.py`` is ``tools/graft_entry.py``.
"""
from .models.double_heston import (
    DHParams, PARAM_NAMES, char_fn, payoff_coefficients, price_options,
    price_single, truncation_range)
from .ops.cos_kernel import price_surfaces
from .calibration.calibrator import (
    BatchCalibration, DoubleHestonJumpCalibrator, calibrate_batch,
    calibrate_batch_fused, calibrate_batch_mixed, calibrate_surface,
    options_to_arrays)
from .calibration.loss import feller_penalty, make_loss_fn, surface_loss
from .calibration.transforms import (
    inverse_transform, params_to_x, transform, transform_to_params)
from .calibration.initial_guess import initial_guesses
from .models.greeks import Greeks, greeks, param_sensitivities
from .ops.black_scholes import bs_price, bs_vega, implied_vol
from .ops.lbfgs import lbfgs_minimize
from .ops.lbfgs_batched import LBFGSResult, lbfgs_minimize_batched
from .parallel.mesh import distributed_init, make_mesh
from .parallel.sharded import calibrate_sharded
from .utils.config import (
    CalibrationConfig, GeneratorConfig, LBFGSConfig, LMConfig, PricerConfig,
    SurfaceSpec)
from .utils.results import CalibrationResult, write_benchmark_json
from .data.synthetic import (
    SyntheticDataset, generate_dataset, load_dataset, save_dataset,
    to_calibration_results)
from .surrogate.features import extract_features
from .surrogate.ffn import SurrogateFFN, init_ffn
from .surrogate.hybrid import (
    HybridResult, ffn_only_predict, hybrid_calibrate,
    hybrid_calibrate_batch_mixed)
from .surrogate.predict import load_default_model, make_predict_fn
from .surrogate.train import (
    FINETUNE, TrainConfig, TrainedSurrogate, dataset_to_xy, fit,
    load_surrogate, pretrain_and_finetune, save_surrogate)
from .utils.checkpoint import (
    load_batch_calibration, load_surrogate_state, save_batch_calibration,
    save_surrogate_state)

__version__ = "0.1.0"

__all__ = [
    "DHParams", "PARAM_NAMES", "char_fn", "payoff_coefficients",
    "price_options", "price_single", "truncation_range", "price_surfaces",
    "BatchCalibration", "DoubleHestonJumpCalibrator", "calibrate_batch",
    "calibrate_batch_fused", "calibrate_batch_mixed", "calibrate_surface",
    "options_to_arrays",
    "feller_penalty", "make_loss_fn", "surface_loss",
    "inverse_transform", "params_to_x", "transform", "transform_to_params",
    "initial_guesses",
    "Greeks", "greeks", "param_sensitivities",
    "bs_price", "bs_vega", "implied_vol",
    "LBFGSResult", "lbfgs_minimize", "lbfgs_minimize_batched",
    "make_mesh", "distributed_init", "calibrate_sharded",
    "CalibrationConfig", "GeneratorConfig", "LBFGSConfig", "LMConfig",
    "PricerConfig", "SurfaceSpec",
    "CalibrationResult", "write_benchmark_json",
    "SyntheticDataset", "generate_dataset", "load_dataset", "save_dataset",
    "to_calibration_results",
    "extract_features", "SurrogateFFN", "init_ffn",
    "HybridResult", "ffn_only_predict", "hybrid_calibrate",
    "hybrid_calibrate_batch_mixed", "load_default_model", "make_predict_fn",
    "TrainedSurrogate", "load_surrogate", "save_surrogate",
    "FINETUNE", "TrainConfig", "dataset_to_xy", "fit",
    "pretrain_and_finetune",
    "load_batch_calibration", "load_surrogate_state",
    "save_batch_calibration", "save_surrogate_state",
    "__version__",
]
