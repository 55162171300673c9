"""The PyTorch port never imports JAX.

A fresh interpreter imports every module of the port (the training
modules included: ``surrogate/train.py``, ``utils/checkpoint.py``,
``utils/logging_util.py``, ``tools/train_pipeline.py``; and the
benchmark's: ``tools/bench.py``, ``tools/error_ablation.py``,
``utils/hostpricer.py``, ``models/greeks.py``, ``ops/black_scholes.py``,
``ops/lbfgs.py``, each called once on the CPU; the sharded calibration's
``parallel/mesh.py`` and ``parallel/sharded.py``, ``calibrate_sharded``
called once on a one-rank CPU group; ``tools/graft_entry.py``,
``tools/dist_check.py`` and the four drivers ``tools/bench_scaling.py``,
``tools/profile_search.py``, ``tools/bench_raw_draws.py`` and
``tools/make_results.py``; ``tools/trip_check.py`` and
``tools/hybrid_soak.py``, the L-BFGS trip's checks; ``tools/lm_trip_check.py``,
the LM trip's, with ``lm_minimize`` called once on the CPU; the
double-float path, ``ops/doublefloat.py``, ``ops/complex_dd.py``,
``models/double_heston_dd.py``, ``transform_to_params_dd``,
``make_residual_fn_dd`` and ``tools/dd_check.py``, each called once on the
CPU, and ``tools/error_ablation.py``'s fixture of JAX's starts read back), loads the shipped
surrogate (``results/models/ffn_surrogate.pkl``) and a dataset pickled by
the JAX package through the port, trains a surrogate for one epoch on the
CPU and round-trips it through the checkpoint functions, and must find
neither ``jax`` nor the JAX package in ``sys.modules``.
"""
import subprocess
import sys
from pathlib import Path

import jax

from option_pricing_ffn_lbfgs_tpu.data.synthetic import (
    generate_dataset, save_dataset)
from option_pricing_ffn_lbfgs_tpu.utils.config import GeneratorConfig

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import pkgutil
import sys
import tempfile
import numpy as np
import option_pricing_ffn_lbfgs_tpu_torch as port
for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    if not mod.name.endswith("__main__"):
        __import__(mod.name)
for name in ("surrogate.train", "utils.checkpoint", "utils.logging_util",
             "tools.train_pipeline", "ops.lbfgs", "ops.black_scholes",
             "models.greeks", "utils.hostpricer", "tools.bench",
             "tools.error_ablation", "parallel.mesh", "parallel.sharded",
             "tools.graft_entry", "tools.dist_check", "tools.bench_scaling",
             "tools.profile_search", "tools.bench_raw_draws",
             "tools.make_results", "tools.trip_check",
             "tools.hybrid_soak", "tools.lm_trip_check", "ops.doublefloat",
             "ops.complex_dd", "models.double_heston_dd", "tools.dd_check"):
    assert port.__name__ + "." + name in sys.modules, name
import torch
from option_pricing_ffn_lbfgs_tpu_torch.tools import bench
(args, prices), = bench.build_problems(1, device="cpu")
assert prices.shape == (5, 15)
params = port.DHParams(*(float(v) for v in bench.truths(0)[0]))
g = port.greeks(params, 100.0, 0.03, bench.STRIKES, bench.MATS,
                np.ones(15, bool), n_terms=16, device="cpu")
assert bool(torch.isfinite(g.gamma).all())
iv = port.implied_vol(prices[0], 100.0, bench.STRIKES, bench.MATS, 0.03,
                      device="cpu")
assert bool(torch.isfinite(iv).all())
r = port.lbfgs_minimize(lambda x: ((x - 1.0) ** 2).sum(),
                        torch.zeros(3, dtype=torch.float64),
                        port.LBFGSConfig(flat=False))
assert bool(r.converged)
from option_pricing_ffn_lbfgs_tpu_torch.ops.levenberg_marquardt import (
    lm_minimize)
r = lm_minimize(lambda x: x - 1.0, torch.zeros(3, dtype=torch.float64))
assert bool(r.converged) and float(r.f) < 1e-20
from option_pricing_ffn_lbfgs_tpu_torch.tools import dd_check, error_ablation
dd = dd_check.run(2, device="cpu", timing=False)
assert dd["all_finite"] and dd["vs_k1_worst"] < 1e-10
from option_pricing_ffn_lbfgs_tpu_torch.calibration.loss import (
    make_residual_fn_dd)
starts = error_ablation.load_jax_starts()["x0"]
assert starts.shape == (6, 5, 3, 13)
r = make_residual_fn_dd(args[0][:1], 0.03, args[1][:1], args[2][:1],
                        args[3][:1], args[4][:1])(
    torch.as_tensor(starts[0, :1, 0], dtype=torch.float64))
assert r.shape == (1, 17) and bool(torch.isfinite(r).all())
model = port.load_default_model()
ds = port.load_dataset(sys.argv[1], device="cpu")
assert ds.n_samples == 2 and model.model.head.out_features == 13
rng = np.random.default_rng(0)
s, hist = port.fit(rng.normal(size=(32, 11)), rng.normal(size=(32, 13)),
                   port.TrainConfig(max_epochs=1, batch_size=8), device="cpu")
with tempfile.TemporaryDirectory() as d:
    port.save_surrogate_state(d, s)
    assert port.load_surrogate_state(d).model.head.out_features == 13
mesh = port.make_mesh(1, device_type="cpu")
out, summary = port.calibrate_sharded(
    mesh, args[0][:2], 0.03, args[1][:2], args[2][:2], args[3][:2],
    args[4][:2], config=port.CalibrationConfig(
        pricer=port.PricerConfig(n_terms=16),
        lbfgs=port.LBFGSConfig(maxiter=2)), n_starts=1)
assert out.loss.shape == (2,) and int(summary.n_total) == 2
assert "torch" in sys.modules
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m.startswith("option_pricing_ffn_lbfgs_tpu.")
             or m == "option_pricing_ffn_lbfgs_tpu")
print(",".join(bad))
"""


def test_port_imports_no_jax(tmp_path):
    path = str(tmp_path / "jax_written.pkl")
    save_dataset(generate_dataset(jax.random.key(0),
                                  GeneratorConfig(n_samples=2), n_terms=16),
                 path)
    out = subprocess.run([sys.executable, "-c", PROBE, path], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"JAX modules imported: {out.stdout}"
