"""Command-line entry points: demo / generate / calibrate / benchmark /
train / compare, with the JAX package's flags plus ``--device`` (default
``cuda``)::

  python -m option_pricing_ffn_lbfgs_tpu_torch demo
  python -m option_pricing_ffn_lbfgs_tpu_torch generate  --n-samples 500 --out d.pkl
  python -m option_pricing_ffn_lbfgs_tpu_torch calibrate --data d.pkl --index 0
  python -m option_pricing_ffn_lbfgs_tpu_torch benchmark --n-surfaces 5 --out r.json
  python -m option_pricing_ffn_lbfgs_tpu_torch train --pretrain a.npz --finetune b.pkl --out ffn.pkl
  python -m option_pricing_ffn_lbfgs_tpu_torch compare --n-eval 5 --out-dir DIR

``--f64`` (before the subcommand) computes in float64, as in the JAX
package. ``--device cuda`` without a CUDA card is an error: nothing falls
back to the CPU; ``--device cpu`` runs the kernels' plain versions.
``compare`` without ``--surrogate`` quick-trains one on its dataset, as
the JAX package does. Its ``--out-dir`` defaults to ``compare_results``
(the JAX CLI's default, ``results``, holds the JAX package's committed
record, which a run from the repository's root would overwrite).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .utils.timing import synchronize

COMPARE_OUT_DIR = "compare_results"


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (use --device cpu for the plain "
                         "PyTorch versions)")
    return dev


def _dtype(args) -> torch.dtype:
    return torch.float64 if args.f64 else torch.float32


def cmd_demo(args):
    """Price the reference demo option with and without jumps and check
    put-call parity."""
    from .models.double_heston import DHParams, price_single
    dev, dt = _device(args), _dtype(args)
    base = dict(v1_0=0.04, kappa1=2.0, theta1=0.04, sigma1=0.3, rho1=-0.5,
                v2_0=0.04, kappa2=1.5, theta2=0.04, sigma2=0.2, rho2=-0.3,
                lambda_j=0.5, mu_j=-0.05, sigma_j=0.10)
    nojump = dict(base, lambda_j=0.0, mu_j=0.0, sigma_j=0.0)
    s, k, t, r = 100.0, 100.0, 1.0, 0.05
    strike = torch.tensor(k, dtype=dt, device=dev)
    rows = {}
    for name, p in [("jumps", base), ("no_jumps", nojump)]:
        params = DHParams.from_dict(p, dt, dev)
        rows[name] = {
            "call": float(price_single(params, s, strike, t, r, True)),
            "put": float(price_single(params, s, strike, t, r, False)),
        }
    parity = rows["jumps"]["call"] - rows["jumps"]["put"] - (s - k * np.exp(-r * t))
    print(f"call (jumps):    {rows['jumps']['call']:.6f}")
    print(f"put  (jumps):    {rows['jumps']['put']:.6f}")
    print(f"call (no jumps): {rows['no_jumps']['call']:.6f}")
    print(f"put  (no jumps): {rows['no_jumps']['put']:.6f}")
    print(f"jump premium (call): {rows['jumps']['call'] - rows['no_jumps']['call']:.6f}")
    print(f"put-call parity residual: {parity:.2e}  "
          f"[{'PASS' if abs(parity) < 0.01 else 'FAIL'}]")
    return 0 if abs(parity) < 0.01 else 1


def cmd_generate(args):
    from .data.synthetic import generate_dataset, save_dataset
    from .utils.config import GeneratorConfig
    dev = _device(args)
    cfg = GeneratorConfig(n_samples=args.n_samples)
    t0 = time.time()
    ds = generate_dataset(torch.Generator(dev).manual_seed(args.seed), cfg,
                          dtype=_dtype(args), device=dev)
    synchronize(dev)
    print(f"generated {ds.n_samples} surfaces in {time.time() - t0:.2f}s "
          f"(mean loss {float(ds.losses.mean()):.6f})")
    save_dataset(ds, args.out, cfg)
    print(f"saved to {args.out}")
    return 0


def cmd_calibrate(args):
    from .calibration.calibrator import DoubleHestonJumpCalibrator
    from .data.synthetic import load_dataset
    dev = _device(args)
    ds = load_dataset(args.data, device=dev)
    i = args.index
    opts = [dict(strike=float(k), maturity=float(t), price=float(p),
                 option_type="call")
            for k, t, p in zip(ds.strikes[i].tolist(),
                               ds.maturities[i].tolist(),
                               ds.market_prices[i].tolist())]
    cal = DoubleHestonJumpCalibrator(
        float(ds.spots[i]), args.rate, opts, dtype=_dtype(args),
        generator=torch.Generator().manual_seed(args.seed), device=dev)
    res = cal.calibrate(maxiter=args.maxiter, multi_start=args.multi_start)
    print(json.dumps({
        "final_loss": res.final_loss,
        "mean_rel_error_pct": res.mean_rel_error_pct,
        "iterations": res.iterations,
        "calibration_time_s": res.calibration_time,
        "success": res.success,
        "parameters": res.parameters,
    }, indent=2))
    return 0 if res.success else 1


def cmd_benchmark(args):
    """Multi-surface benchmark emitting the reference results-JSON schema."""
    from .calibration.calibrator import calibrate_batch
    from .data.synthetic import generate_dataset
    from .utils.config import GeneratorConfig
    from .utils.results import write_benchmark_json
    dev, dt = _device(args), _dtype(args)
    ds = generate_dataset(torch.Generator(dev).manual_seed(args.seed),
                          GeneratorConfig(n_samples=args.n_surfaces),
                          dtype=dt, device=dev)
    market = ds.model_prices if args.noiseless else ds.market_prices

    def run():
        out = calibrate_batch(
            ds.spots, args.rate, ds.strikes, ds.maturities,
            torch.ones_like(ds.strikes, dtype=torch.bool), market,
            torch.Generator().manual_seed(args.seed + 1),
            n_starts=args.multi_start, device=dev, dtype=dt)
        synchronize(dev)
        return out
    t0 = time.time()
    run()
    first_s = time.time() - t0
    t0 = time.time()
    out = run()
    steady = time.time() - t0
    model, mkt = out.model_prices.cpu().numpy(), market.cpu().numpy()
    errors = np.abs((model - mkt) / mkt).mean(axis=-1) * 100.0
    per = steady / args.n_surfaces
    payload = write_benchmark_json(
        args.out, errors, [per] * args.n_surfaces,
        out.iterations.cpu().numpy(), out.converged.cpu().numpy(),
        extra={"compile_s": first_s, "batch": args.n_surfaces,
               "dtype": str(out.loss.cpu().numpy().dtype),
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")})
    print(json.dumps(payload["statistics"], indent=2))
    print(f"wrote {args.out}")
    return 0


def cmd_train(args):
    from .data.synthetic import generate_dataset, load_dataset
    from .surrogate.train import (TrainConfig, dataset_to_xy, fit,
                                  pretrain_and_finetune, save_surrogate)
    from .utils.config import GeneratorConfig
    dev = _device(args)
    if args.pretrain:
        pre = load_dataset(args.pretrain, device=dev)
    else:
        print(f"generating {args.n_pretrain} pretraining surfaces...")
        pre = generate_dataset(torch.Generator(dev).manual_seed(1),
                               GeneratorConfig(n_samples=args.n_pretrain),
                               device=dev)
    if args.finetune:
        fine = load_dataset(args.finetune, device=dev)
        surrogate, hist = pretrain_and_finetune(pre, fine,
                                                verbose=args.verbose,
                                                device=dev)
    else:
        fx, fy = dataset_to_xy(pre)
        surrogate, hist = fit(fx, fy, TrainConfig(max_epochs=args.epochs),
                              verbose=args.verbose, device=dev)
        hist = {"pretrain": hist}
    save_surrogate(args.out, surrogate)
    last = {k: v["val_loss"][-1] for k, v in hist.items()}
    print(f"saved surrogate to {args.out}; final val losses: {last}")
    return 0


def cmd_compare(args):
    """Three-method comparison producing the reference results artifacts."""
    from .compare import run_comparison
    from .data.synthetic import generate_dataset, load_dataset
    from .surrogate.train import (TrainConfig, dataset_to_xy, fit,
                                  load_surrogate)
    from .utils.config import GeneratorConfig
    dev = _device(args)
    if args.data:
        ds = load_dataset(args.data, device=dev)
    else:
        ds = generate_dataset(torch.Generator(dev).manual_seed(args.seed),
                              GeneratorConfig(n_samples=max(args.n_eval, 300)),
                              dtype=torch.float64, device=dev)
    if args.surrogate:
        surrogate = load_surrogate(args.surrogate)
    else:
        print("no --surrogate given; quick-training one on the dataset...")
        fx, fy = dataset_to_xy(ds)
        surrogate, _ = fit(fx, fy, TrainConfig(max_epochs=60, patience=20,
                                               batch_size=64), device=dev)
    payload = run_comparison(ds, surrogate, n_eval=args.n_eval,
                             out_dir=args.out_dir, device=dev)
    print(json.dumps({
        "ffn_mean_error_pct": payload["ffn"]["mean_error"],
        "lbfgs_mean_error_pct": payload["lbfgs"]["statistics"]["mean_error"],
        "hybrid_mean_error_pct": payload["hybrid"]["statistics"]["mean_error"],
        "ffn_mean_time_s": payload["ffn"]["mean_time"],
        "lbfgs_mean_time_s": payload["lbfgs"]["statistics"]["mean_time"],
        "hybrid_mean_time_s": payload["hybrid"]["statistics"]["mean_time"],
    }, indent=2))
    print(f"artifacts written to {args.out_dir}")
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="option_pricing_ffn_lbfgs_tpu_torch")
    p.add_argument("--f64", action="store_true",
                   help="compute in float64 (the float64 kernels on a card)")
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="torch device (default cuda; no CPU fallback)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("demo", parents=[dev],
                   help="price the demo option, check parity")

    g = sub.add_parser("generate", parents=[dev],
                       help="generate synthetic calibrations")
    g.add_argument("--n-samples", type=int, default=500)
    g.add_argument("--out", default="lbfgs_calibrations_synthetic.pkl")
    g.add_argument("--seed", type=int, default=0)

    c = sub.add_parser("calibrate", parents=[dev],
                       help="calibrate one surface from a dataset")
    c.add_argument("--data", required=True)
    c.add_argument("--index", type=int, default=0)
    c.add_argument("--rate", type=float, default=0.03)
    c.add_argument("--maxiter", type=int, default=300)
    c.add_argument("--multi-start", type=int, default=3)
    c.add_argument("--seed", type=int, default=0)

    b = sub.add_parser("benchmark", parents=[dev],
                       help="batched calibration benchmark")
    b.add_argument("--n-surfaces", type=int, default=5)
    b.add_argument("--rate", type=float, default=0.03)
    b.add_argument("--multi-start", type=int, default=3)
    b.add_argument("--noiseless", action="store_true", default=True)
    b.add_argument("--noisy", dest="noiseless", action="store_false")
    b.add_argument("--seed", type=int, default=2026)
    b.add_argument("--out", default="benchmark_results.json")

    cp = sub.add_parser("compare", parents=[dev],
                        help="FFN vs L-BFGS vs hybrid comparison")
    cp.add_argument("--data", help="dataset (.pkl/.npz); generated if absent")
    cp.add_argument("--surrogate",
                    help="trained surrogate (.pkl); quick-trained if absent")
    cp.add_argument("--n-eval", type=int, default=5)
    cp.add_argument("--seed", type=int, default=0)
    cp.add_argument("--out-dir", default=COMPARE_OUT_DIR)

    t = sub.add_parser("train", parents=[dev],
                       help="train the FFN surrogate")
    t.add_argument("--pretrain", help="pretraining dataset (.pkl/.npz)")
    t.add_argument("--finetune", help="fine-tuning dataset (.pkl/.npz)")
    t.add_argument("--n-pretrain", type=int, default=5000,
                   help="surfaces to generate if --pretrain absent")
    t.add_argument("--epochs", type=int, default=200)
    t.add_argument("--out", default="ffn_surrogate.pkl")
    t.add_argument("--verbose", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return {"demo": cmd_demo, "generate": cmd_generate,
            "calibrate": cmd_calibrate, "benchmark": cmd_benchmark,
            "train": cmd_train, "compare": cmd_compare}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
