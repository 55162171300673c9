"""The PyTorch port never imports JAX.

A fresh interpreter imports the port with its whole slice (the package,
its calibrator, its kernel wrappers and ``convert``) and must find
neither ``jax`` nor the JAX package in ``sys.modules``.
"""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import sys
import option_pricing_ffn_lbfgs_tpu_torch
import option_pricing_ffn_lbfgs_tpu_torch.calibration.calibrator
import option_pricing_ffn_lbfgs_tpu_torch.convert
import option_pricing_ffn_lbfgs_tpu_torch.ops.cos_kernel
import option_pricing_ffn_lbfgs_tpu_torch.ops.loss_kernel
import option_pricing_ffn_lbfgs_tpu_torch.utils.timing
assert "torch" in sys.modules
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m.startswith("option_pricing_ffn_lbfgs_tpu.")
             or m == "option_pricing_ffn_lbfgs_tpu")
print(",".join(bad))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"JAX modules imported: {out.stdout}"
