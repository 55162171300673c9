"""This tree's port against another checkout's, in turns on one card.

    python3 -m option_pricing_ffn_lbfgs_tpu_torch.tools.ab_parent PARENT_DIR
        [--kernels]

``PARENT_DIR`` is an unpacked checkout of another commit (``git archive``
into a git-ignored directory). Each side runs in a process of its own with
its tree first on ``sys.path``: it imports its own package, builds its own
kernels into its own ``_build/`` and launches them through its own wrappers,
so nothing here depends on a kernel's C interface. Both trees must have the
public names used below: the entry points, the configs,
``calibrator.POLISH_LM``, the wrappers ``port.price_surfaces`` (K1),
``loss_kernel.rows_value_and_grad`` / ``rows_jacobian`` (K2/K3) and the
``LAUNCHES`` counts. The sides run in turns (parent, this, this, parent);
each run prints

  1. wrapper times (CUDA events, best of two) at the main path's widths and
     at 15 lanes, the kernel's own device time (torch.profiler; at 15 lanes
     the events time the host's launches), and a hash of each wrapper's
     output bytes (equal hashes
     across the two trees: identical bits; otherwise the largest relative
     difference is printed);
  2. the mean pricing error, the wall (CUDA events) and the LM trips (K3
     launches) of ``calibrate_batch_mixed`` on 512 Feller-capped surfaces
     x 3 starts, over 8 (problem, start) seed pairs, and its winners;
  3. the hybrid on four slices of 512 generated surfaces: wall, L-BFGS
     and LM trips, error;
  4. the bench twin (6 sets x 5 surfaces): host wall per surface;
  5. an LM trip of the polish (``calibrator._polish_lanes_fused``: the
     fused trip where the tree has it, else K6, K1<double> and K3 with the
     host assembly, K7) at 1536 lanes (stage A's maxiter 10) and at 32
     lanes (a wave's 16): ms a trip (CUDA events over the whole polish,
     best of three);

and the lines marked ``[ab]`` compare the sides over all their runs. With
``--kernels`` each run stops after part 1.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

RANGES = np.array([(0.025, 0.080), (1.5, 4.5), (0.025, 0.065), (0.20, 0.50),
                   (-0.85, -0.40), (0.020, 0.070), (0.30, 1.20),
                   (0.025, 0.070), (0.10, 0.35), (-0.70, -0.20),
                   (0.05, 0.25), (-0.08, -0.01), (0.03, 0.12)])
STRIKES = np.tile([90.0, 95.0, 100.0, 105.0, 110.0], 3)
MATS = np.repeat([0.25, 0.5, 1.0], 5)
# (label, wrapper, lanes, dtype, N): the polish residual at 512 x 3 and at
# one surface's 15 lanes, the generator's 5000 surfaces, the winner's
# repricing; the search and polish at 512 x 3, the hybrid's refine and
# polish, 15 lanes, 1000 x 3 and 2000 lanes at N = 64 and 128, K2<double>
KERNEL_CASES = (("K1<double>", "price", 1536, "float64", 64),
                ("K1<double>", "price", 15, "float64", 64),
                ("K1<double>", "price", 5000, "float64", 128),
                ("K1<float>", "price", 512, "float32", 64),
                ("K1<float>", "price", 1536, "float32", 64),
                ("K1<float>", "price", 15, "float32", 64),
                ("K2", "loss", 1536, "float32", 64),
                ("K3", "jac", 1536, "float32", 64),
                ("K2", "loss", 1024, "float32", 128),
                ("K3", "jac", 512, "float32", 64),
                ("K2", "loss", 15, "float32", 64),
                ("K3", "jac", 15, "float32", 64),
                ("K2<double>", "loss", 15, "float64", 128),
                ("K2<double>", "loss", 1536, "float64", 128),
                ("K2", "loss", 3000, "float32", 64),
                ("K3", "jac", 3000, "float32", 64),
                ("K2", "loss", 15, "float32", 128),
                ("K3", "jac", 15, "float32", 128),
                ("K2", "loss", 1536, "float32", 128),
                ("K2", "loss", 3000, "float32", 128),
                ("K2", "loss", 264, "float32", 64),
                ("K3", "jac", 264, "float32", 64))


def measure(outputs: str, kernels_only: bool) -> dict:
    """One side's run, in the package found first on ``sys.path``; the
    wrappers' outputs are saved to ``outputs`` (.npz)."""
    import dataclasses
    import time

    import torch

    import option_pricing_ffn_lbfgs_tpu_torch as port
    from option_pricing_ffn_lbfgs_tpu_torch.calibration import calibrator
    from option_pricing_ffn_lbfgs_tpu_torch.ops import loss_kernel
    from option_pricing_ffn_lbfgs_tpu_torch.utils.config import (
        CalibrationConfig, GeneratorConfig)
    from option_pricing_ffn_lbfgs_tpu_torch.utils.timing import (
        CudaTimer, cuda_time_ms)

    dev, f64 = torch.device("cuda"), torch.float64
    out = {"kernels": {}, "device": {}, "hashes": {}, "means": [],
           "walls": [], "lm_trips": [], "hybrid": [], "twin": 0.0,
           "lm_trip_ms": {}}

    def kernel_ms(fn, n=20):
        """Device ms of one launch of the K1/K2/K3 kernel ``fn`` launches
        (one a call), from torch.profiler: the kernel alone, without the
        host's launch time, which sets the event time where the kernel is
        shorter. Averaged over the launches traced; None if none was."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if "cos_price_kernel" in e.key or "cos_vg_kernel" in e.key]
        count = sum(e.count for e in ev)
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)) for e in ev)
        return us / count / 1e3 if count else None

    # 1. wrapper times and output hashes
    rng = np.random.default_rng(0)
    saved = {}
    for label, mode, lanes, dt, n_terms in KERNEL_CASES:
        dt = getattr(torch, dt)
        t = lambda a: torch.tensor(a, dtype=dt, device=dev)
        params = t(rng.uniform(RANGES[:, 0], RANGES[:, 1], (lanes, 13)))
        spots, strikes, mats = (t(100.0 + rng.uniform(-3, 3, lanes)),
                                t(np.tile(STRIKES, (lanes, 1))),
                                t(np.tile(MATS, (lanes, 1))))
        if mode == "price":   # K1: calls and puts, as the generator prices
            call = torch.tensor(np.tile(np.arange(15) % 3 != 0, (lanes, 1)),
                                device=dev)
            fn = lambda: port.price_surfaces(params, spots, 0.03, strikes,
                                             mats, call, n_terms=n_terms)
        else:
            call = torch.ones((lanes, 15), dtype=torch.bool, device=dev)
            # quotes from the plain pricer on the host, so that K2/K3's
            # inputs do not depend on either tree's K1
            mkt = port.price_surfaces(*(a.cpu() for a in (
                params, spots)), 0.03, *(a.cpu() for a in (
                    strikes, mats, call))).to(dev) * 1.2
            # a tree whose wrappers take the rows' maturity groups gets
            # them computed once, as its host assembly does
            kw = ({"groups": loss_kernel.maturity_groups(mats)}
                  if hasattr(loss_kernel, "maturity_groups") else {})
            wrap = (loss_kernel.rows_value_and_grad if mode == "loss"
                    else loss_kernel.rows_jacobian)
            fn = lambda: wrap(params, spots, 0.03, strikes, mats, call, mkt,
                              n_terms, **kw)
        ms = min(cuda_time_ms(fn), cuda_time_ms(fn))
        dev_ms = kernel_ms(fn)
        res = fn()
        res = [r.cpu().numpy() for r in (res if isinstance(res, tuple)
                                         else (res,))]
        key = f"{label} L={lanes} N={n_terms}"
        digest = hashlib.sha256(b"".join(r.tobytes() for r in res))
        out["kernels"][key] = ms
        out["device"][key] = dev_ms
        out["hashes"][key] = digest.hexdigest()[:16]
        for i, r in enumerate(res):
            saved[f"{key} #{i}"] = r
        print(f"[1] {key}: {ms:.4f} ms (kernel alone {dev_ms} ms), "
              f"outputs {out['hashes'][key]}", flush=True)
    if kernels_only:
        np.savez(outputs, **saved)
        return out

    cfg = CalibrationConfig(search_impl="pallas", polish_impl="pallas",
                            polish_fused_min_lanes=1)
    polish = dataclasses.replace(calibrator.POLISH_LM, residual_impl="native")

    def problem_set(n_surf, seed, feller_margin=None):
        """chip_smoke.py's recipe: bench.py's ranges, noiseless float64
        prices, optionally Feller-capped truths."""
        rng = np.random.default_rng(seed)
        true = np.stack([rng.uniform(lo, hi, n_surf) for lo, hi in RANGES],
                        -1)
        if feller_margin is not None:
            for s, k, t in ((3, 1, 2), (8, 6, 7)):
                true[:, s] = np.minimum(true[:, s], feller_margin * np.sqrt(
                    2 * true[:, k] * true[:, t]))
        t = lambda a: torch.tensor(a, dtype=f64, device=dev)
        args = (t(np.full(n_surf, 100.0)), t(np.tile(STRIKES, (n_surf, 1))),
                t(np.tile(MATS, (n_surf, 1))),
                torch.ones((n_surf, 15), dtype=torch.bool, device=dev))
        prices = port.price_surfaces(t(true), args[0], 0.03, *args[1:])
        return (*args, prices), prices.cpu().numpy()

    def calibrate(args, seed):
        return port.calibrate_batch_mixed(
            args[0], 0.03, *args[1:], torch.Generator().manual_seed(seed),
            config=cfg, n_starts=3, polish=polish)

    def err_pct(res, prices):
        return np.abs(res.model_prices.cpu().numpy() / prices - 1).mean(-1) \
            * 100

    # 2. accuracy and wall over 8 seed pairs, after a warm-up at this size
    sets = {p: problem_set(512, 2026 + p, 0.90) for p in (100, 101, 102, 103)}
    calibrate(sets[100][0], 100)
    for pseed, (args, prices) in sets.items():
        for sseed in (100, 7):
            k3 = loss_kernel.LAUNCHES["cos_vg_jac"]
            with CudaTimer() as timer:
                res = calibrate(args, sseed)
            e = err_pct(res, prices)
            out["means"].append(float(e.mean()))
            out["walls"].append(timer.ms)
            out["lm_trips"].append(loss_kernel.LAUNCHES["cos_vg_jac"] - k3)
            saved[f"winners {pseed} {sseed} #0"] = res.x.cpu().numpy()
            saved[f"errors {pseed} {sseed} #0"] = e
            print(f"[2] problem 2026+{pseed} starts {sseed}: mean "
                  f"{e.mean():.5f} %, median {np.median(e):.5f} %, above "
                  f"0.1 %: {int((e > 0.1).sum())}, max {e.max():.4f} %, "
                  f"wall {timer.ms:.2f} ms, LM trips "
                  f"{out['lm_trips'][-1]}", flush=True)

    # 3. the hybrid on four slices of 512 generated surfaces
    ds = port.generate_dataset(torch.Generator(dev).manual_seed(9),
                               GeneratorConfig(n_samples=5000), dtype=f64,
                               n_terms=128, device=dev)
    surrogate = port.load_default_model()
    for lo in (0, 512, 1024, 1536):
        cut = slice(lo, lo + 512)
        h = (ds.spots[cut], 0.03, ds.strikes[cut], ds.maturities[cut],
             torch.ones((512, 15), dtype=torch.bool, device=dev),
             ds.model_prices[cut])
        if lo == 0:            # warm-up at 8 surfaces
            port.hybrid_calibrate_batch_mixed(
                surrogate, *(a[:8] if torch.is_tensor(a) else a for a in h))
        before = loss_kernel.LAUNCHES["cos_vg_loss"]
        k3 = loss_kernel.LAUNCHES["cos_vg_jac"]
        with CudaTimer() as timer:
            res = port.hybrid_calibrate_batch_mixed(surrogate, *h)
        trips = loss_kernel.LAUNCHES["cos_vg_loss"] - before
        lm_trips = loss_kernel.LAUNCHES["cos_vg_jac"] - k3
        e = err_pct(res, h[-1].cpu().numpy())
        out["hybrid"].append({"wall": timer.ms, "trips": trips,
                              "lm_trips": lm_trips, "mean": float(e.mean())})
        print(f"[3] hybrid surfaces {lo}..{lo + 511}: wall {timer.ms:.2f} "
              f"ms, {trips} L-BFGS trips ({timer.ms / trips:.3f} ms a "
              f"trip), {lm_trips} LM trips, mean {e.mean():.5f} %, max "
              f"{e.max():.5f} %", flush=True)

    # 4. the bench twin
    twin = [problem_set(5, 2026 + i) for i in range(6)]
    calibrate(twin[0][0], 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs = [err_pct(calibrate(a, i), p) for i, (a, p) in enumerate(twin)]
    torch.cuda.synchronize()
    out["twin"] = (time.perf_counter() - t0) / 30 * 1e3
    print(f"[4] bench twin: {out['twin']:.2f} ms a surface, mean "
          f"{np.concatenate(errs).mean():.5f} %", flush=True)

    # 5. an LM trip of the polish from the starts of initial_guesses on
    # the first 512-surface set
    from option_pricing_ffn_lbfgs_tpu_torch.calibration.initial_guess import (
        initial_guesses)
    args, _ = sets[100]
    x0 = initial_guesses(3, torch.Generator().manual_seed(5), args[0],
                         args[1], args[2], args[4]).reshape(-1, 13)
    rep = lambda a: torch.repeat_interleave(a, 3, dim=0)
    lanes = [rep(a) for a in args]
    pcfg = calibrator._polish_pricer_config(cfg)
    for n_lanes, maxiter in ((1536, 10), (32, 16)):
        lm_cfg = dataclasses.replace(polish, maxiter=maxiter)
        per_trip = []
        for _ in range(4):                   # the first warms up
            with CudaTimer() as timer:
                res, _, _ = calibrator._polish_lanes_fused(
                    lanes[0][:n_lanes], 0.03,
                    *(a[:n_lanes] for a in lanes[1:5]), x0[:n_lanes], None,
                    pcfg, lm_cfg)
            per_trip.append(timer.ms / int(res.n_evals.max()))
        out["lm_trip_ms"][str(n_lanes)] = min(per_trip[1:])
        print(f"[5] LM polish trip at {n_lanes} lanes: "
              f"{min(per_trip[1:]):.4f} ms ({int(res.n_evals.max())} trips)",
              flush=True)
    np.savez(outputs, **saved)
    return out


def run_side(tree: Path, label: str, outputs: str, flags) -> dict:
    """``measure()`` in a fresh process that imports ``tree``'s package."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tree)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--measure", outputs, *flags], cwd=tree, env=env,
                          capture_output=True, text=True)
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        print(f"{label}: {line}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{label} run failed with exit {proc.returncode}")
    return json.loads(lines[-1])


def _rel(a, b) -> float:
    """Largest |a - b| / |b| over the entries where b is not 0."""
    nz = b != 0
    return float(np.max(np.abs(a[nz] - b[nz]) / np.abs(b[nz]), initial=0.0))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--measure"]:
        print(json.dumps(measure(argv[1], "--kernels" in argv)))
        return
    kernels_only = "--kernels" in argv
    trees = {"parent": Path(argv[0]).resolve(),
             "this": Path(__file__).resolve().parents[2]}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    runs = {"parent": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        files = {"parent": [], "this": []}
        for i, side in enumerate(("parent", "this", "this", "parent")):
            files[side].append(os.path.join(tmp, f"{side}{i}.npz"))
            runs[side].append(run_side(trees[side], side, files[side][-1],
                                       ["--kernels"] if kernels_only else []))
        outs = {s: dict(np.load(f[0])) for s, f in files.items()}
        for key in runs["this"][0]["kernels"]:
            best = {s: min(r["kernels"][key] for r in runs[s]) for s in runs}
            alone = {s: min((r["device"][key] for r in runs[s]
                             if r["device"][key] is not None), default=None)
                     for s in runs}
            hashes = {s: {r["hashes"][key] for r in runs[s]} for s in runs}
            same = len(hashes["parent"] | hashes["this"]) == 1
            diff = "identical bits" if same else "largest relative difference " \
                + ", ".join(f"{_rel(outs['this'][k], outs['parent'][k]):.3e}"
                            for k in outs["this"] if k.startswith(key + " #"))
            print(f"[ab] {key}: parent {best['parent']:.4f} ms, this "
                  f"{best['this']:.4f} ms (kernel alone {alone['parent']} -> "
                  f"{alone['this']} ms); outputs {diff} (hashes parent "
                  f"{sorted(hashes['parent'])}, this {sorted(hashes['this'])})")
    if kernels_only:
        return
    for pseed in (100, 101, 102, 103):
        for sseed in (100, 7):
            key = f"{pseed} {sseed} #0"
            wx = {s: o[f"winners {key}"] for s, o in outs.items()}
            we = {s: o[f"errors {key}"] for s, o in outs.items()}
            print(f"[ab] winners 2026+{pseed} starts {sseed}: "
                  + ("identical bits" if np.array_equal(wx["this"],
                                                        wx["parent"])
                     else f"x largest relative difference "
                     f"{_rel(wx['this'], wx['parent']):.3e}")
                  + f"; per-surface error % largest difference "
                  f"{np.abs(we['this'] - we['parent']).max():.3e}, surfaces "
                  f"whose error moved by more than 1e-4 % "
                  f"{int((np.abs(we['this'] - we['parent']) > 1e-4).sum())}")
    for side, rs in runs.items():
        walls = [w for r in rs for w in r["walls"]]
        means = rs[0]["means"]
        print(f"[ab] {side} 512 x 3: mean of the 8 means "
              f"{np.mean(means):.5f} % (sd {np.std(means, ddof=1):.5f} %), "
              f"runs above 0.03 %: {sum(m > 0.03 for m in means)}; wall "
              f"median {np.median(walls):.2f} ms over {len(walls)} calls "
              f"(min {min(walls):.2f}, max {max(walls):.2f})")
        print(f"[ab] {side} LM trips per 512 x 3 call {rs[0]['lm_trips']}; "
              f"LM polish ms a trip (1536 / 32 lanes) "
              f"{[r['lm_trip_ms'] for r in rs]}")
        print(f"[ab] {side} hybrid: trips per slice "
              f"{[h['trips'] for h in rs[0]['hybrid']]}, LM trips "
              f"{[h['lm_trips'] for h in rs[0]['hybrid']]}, walls "
              f"{[[round(h['wall'], 2) for h in r['hybrid']] for r in rs]} "
              f"ms, mean error {[round(h['mean'], 5) for h in rs[0]['hybrid']]}"
              f" %; bench twin {[round(r['twin'], 2) for r in rs]} ms a "
              f"surface")


if __name__ == "__main__":
    main()
