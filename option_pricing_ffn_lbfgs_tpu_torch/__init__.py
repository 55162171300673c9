"""PyTorch + CUDA port of the Double Heston + jump calibration framework.

The JAX package ``option_pricing_ffn_lbfgs_tpu`` is the reference; this
package mirrors its module layout and imports ``torch``, never ``jax``.
Its kernels (``csrc/``) are built for the H100 (sm_90a) at first use; on a
CPU tensor every kernel wrapper runs its plain PyTorch version.
"""
from .models.double_heston import DHParams, price_options
from .ops.cos_kernel import price_surfaces
from .calibration.calibrator import calibrate_batch, calibrate_batch_mixed

__all__ = ["DHParams", "price_options", "price_surfaces", "calibrate_batch",
           "calibrate_batch_mixed"]
