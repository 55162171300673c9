"""Many hybrid calls in a row, counting the L-BFGS error word::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.hybrid_soak \\
        [--calls 250] [--surfaces 512] [--device cuda]

Each call draws fresh noiseless surfaces (``generate_dataset`` seeded by
the call's index) and runs ``hybrid_calibrate_batch_mixed`` on the shipped
surrogate, as a service would. A corrupt circular index of the L-BFGS
history makes the engine raise (``ops/lbfgs_batched.py::read_live``,
the error word that K4/K5 set); this script counts such calls and goes on,
and re-raises any other error. It prints one JSON line: the calls, the
calls whose error word was set and the messages, K4 launches, the mean and
largest wall of a call (host clock after a synchronize) and the device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..data.synthetic import generate_dataset
from ..ops import lbfgs_batched
from ..surrogate.hybrid import hybrid_calibrate_batch_mixed
from ..surrogate.predict import load_default_model
from ..utils.config import GeneratorConfig
from ..utils.timing import synchronize


def soak(calls: int, surfaces: int, device) -> dict:
    dev = torch.device(device)
    surrogate = load_default_model()
    errors, walls = [], []
    k4 = lbfgs_batched.LAUNCHES["lbfgs_open_fused"]
    for i in range(calls):
        ds = generate_dataset(torch.Generator(dev).manual_seed(10_000 + i),
                              GeneratorConfig(n_samples=surfaces),
                              dtype=torch.float64, device=dev)
        call = torch.ones_like(ds.strikes, dtype=torch.bool)
        synchronize(dev)
        t0 = time.perf_counter()
        try:
            hybrid_calibrate_batch_mixed(surrogate, ds.spots, 0.03,
                                         ds.strikes, ds.maturities, call,
                                         ds.model_prices)
        except RuntimeError as e:
            if "head or hist_len" not in str(e):
                raise
            errors.append(f"call {i}: {e}")
        synchronize(dev)
        walls.append(time.perf_counter() - t0)
    return {"calls": calls, "surfaces": surfaces,
            "error_word_set": len(errors), "errors": errors,
            "k4_launches": lbfgs_batched.LAUNCHES["lbfgs_open_fused"] - k4,
            "mean_wall_s": sum(walls) / len(walls), "max_wall_s": max(walls),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=250)
    ap.add_argument("--surfaces", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    out = soak(args.calls, args.surfaces, args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
