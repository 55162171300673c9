"""One rank of a multi-process check of the sharded calibration and the
data-parallel FFN step::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.dist_check \\
        RANK WORLD HOST:PORT {cuda,cpu} {tiny,tiny5,smoke512,smoke64} \\
        [--ddp] [--save F]

Start WORLD such processes with ranks 0..WORLD-1 and one free port (rank
0 listens there; ``launch`` does this); WORLD 1 needs no port (pass
any). Each brings its group
up through ``distributed_init`` (gloo when the ranks are on the CPU or
share a card), runs ``calibrate_sharded`` on the named problem once to
warm up (two iterations) and once in full, timed by the host clock after
a synchronize, with the launch counts set to 0 just before it, and with
``--ddp`` one data-parallel Adam step of the FFN in float64 with dropout
off. Every rank
prints one JSON line: the summary, its recomputation on the host from the
gathered winners, a hash of the gathered winners' bytes, the winners'
losses and converged flags, the FFN's parameter checksum, and the
kernels' launch counts in this process. ``--save`` (rank 0) writes the
gathered winners and, with ``--ddp``, the FFN's updated parameters, its
all-reduced gradients (``ffn_grad.<name>``) and its BatchNorm running
statistics after the step (``ffn_stat.<name>``) to an ``.npz`` file.
``ffn_reference`` is the same step's gradients and statistics from one
process with no group on the whole batch, and ``ffn_grad_error`` the
distance between two such sets.

Problems (``build_problem``):
  * ``tiny``: 7 surfaces of 6 options (the JAX dry run's grid, each
    surface's truth and spot moved by a few per cent), float64 truths,
    N = 32, 25 iterations, 2 starts, float64 search; 7 surfaces split
    unevenly, so one rank holds an edge-padding row at 2 ranks;
    ``tiny5`` is its first 5 surfaces (at 4 ranks the last rank holds
    padding only);
  * ``smoke512``: 512 Feller-capped surfaces of 15 options (bench.py's
    ranges, sigma_i <= 0.9 sqrt(2 kappa_i theta_i)), float64 truths from
    the host pricer, the default ``CalibrationConfig``, 3 starts, the
    float32 search; ``smoke64`` is its first 64 surfaces.
The FFN batch: 16 rows of features and targets from a numpy generator
(seed 5), split evenly over the ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..calibration.calibrator import BatchCalibration
from ..ops import cos_kernel, lbfgs_batched, loss_kernel
from ..ops import levenberg_marquardt
from ..parallel.mesh import (distributed_init, free_port, local_device,
                              make_mesh)
from ..parallel.sharded import calibrate_sharded
from ..surrogate.ffn import N_FEATURES, N_PARAMS, init_ffn
from ..utils.config import CalibrationConfig, LBFGSConfig, PricerConfig
from ..utils.hostpricer import price_truth_subprocess
from ..utils.timing import synchronize
from .bench import MATS, RANGES, STRIKES
from .graft_entry import DRY_MATS, DRY_STRIKES, DRY_TRUE, ffn_ddp_step

MODULE = "option_pricing_ffn_lbfgs_tpu_torch.tools.dist_check"
PROBLEMS = ("tiny", "tiny5", "smoke512", "smoke64")
RATE = 0.03
FFN_ROWS, FFN_SEED = 16, 5


class Problem(NamedTuple):
    args: tuple            # spots, strikes, maturities, is_call, prices
    config: CalibrationConfig
    n_starts: int
    seed: int              # the starts' CPU generator seed
    dtype: torch.dtype


def build_problem(name: str, device) -> Problem:
    """The named problem's inputs, float64 tensors on ``device``."""
    dev = torch.device(device)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64,
                               device=dev)
    if name in ("tiny", "tiny5"):
        rng = np.random.default_rng(0)
        spots = 100.0 + rng.uniform(-2, 2, 7)
        true = DRY_TRUE * (1.0 + rng.uniform(-0.05, 0.05, (7, 13)))
        b = 7 if name == "tiny" else 5
        spots, true = spots[:b], true[:b]
        strikes, mats = np.tile(DRY_STRIKES, (b, 1)), np.tile(DRY_MATS, (b, 1))
        config = CalibrationConfig(pricer=PricerConfig(n_terms=32),
                                   lbfgs=LBFGSConfig(maxiter=25))
        n_starts, seed, dtype = 2, 0, torch.float64
    elif name in ("smoke512", "smoke64"):
        rng = np.random.default_rng(2026 + 100)
        true = np.stack([rng.uniform(lo, hi, 512)
                         for lo, hi in RANGES.values()], axis=-1)
        b = 512 if name == "smoke512" else 64
        true = true[:b]
        for s, k, th in ((3, 1, 2), (8, 6, 7)):
            cap = 0.9 * np.sqrt(2 * true[:, k] * true[:, th])
            true[:, s] = np.minimum(true[:, s], cap)
        spots = np.full(b, 100.0)
        strikes = np.tile(STRIKES, (b, 1))
        mats = np.tile(MATS, (b, 1))
        config = CalibrationConfig()
        n_starts, seed, dtype = 3, 100, torch.float32
    else:
        raise ValueError(f"unknown problem {name!r}")
    prices = price_truth_subprocess(true, spots, strikes, mats, RATE,
                                    device=dev)
    is_call = torch.ones(strikes.shape, dtype=torch.bool, device=dev)
    return Problem((t(spots), t(strikes), t(mats), is_call, t(prices)),
                   config, n_starts, seed, dtype)


def winners_hash(out: BatchCalibration) -> str:
    """SHA-256 of every field's bytes, in field order."""
    h = hashlib.sha256()
    for f in BatchCalibration._fields:
        h.update(getattr(out, f).detach().cpu().contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


def host_summary(out: BatchCalibration, market_prices) -> dict:
    """The summary recomputed on the host in float64 from the gathered
    winners and the market prices the search saw."""
    model = out.model_prices.detach().cpu().numpy().astype(np.float64)
    mkt = np.asarray(market_prices, np.float64)
    rel = np.abs(model - mkt) / mkt
    return {"mean_loss": float(out.loss.cpu().numpy().astype(np.float64)
                               .mean()),
            "mean_rel_error": float(rel.mean(axis=-1).mean()),
            "n_converged": int(out.converged.cpu().numpy().sum()),
            "n_total": int(model.shape[0])}


def ffn_batch(rank: int, world: int, device):
    """This rank's rows of the float64 FFN batch."""
    rng = np.random.default_rng(FFN_SEED)
    x = rng.normal(size=(FFN_ROWS, N_FEATURES))
    y = rng.normal(size=(FFN_ROWS, N_PARAMS))
    per = FFN_ROWS // world
    sl = slice(rank * per, (rank + 1) * per)
    t = lambda a: torch.tensor(a[sl], dtype=torch.float64, device=device)
    return t(x), t(y)


def ffn_arrays(model) -> dict:
    """The FFN's gradients and BatchNorm running statistics as numpy
    arrays, keyed ``ffn_grad.<parameter>`` and ``ffn_stat.<buffer>``."""
    out = {f"ffn_grad.{n}": p.grad.detach().cpu().numpy()
           for n, p in model.named_parameters()}
    out.update({f"ffn_stat.{n}": b.detach().cpu().numpy()
                for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))})
    return out


def ffn_reference(device, seed: int = 1) -> dict:
    """``ffn_arrays`` of the DDP step's plain counterpart: one process, no
    process group, float64, dropout off, the mean squared error over the
    whole ``FFN_ROWS``-row batch, one backward."""
    x, y = ffn_batch(0, 1, device)
    model = init_ffn(torch.Generator().manual_seed(seed)).to(device, x.dtype)
    model.dropout = (0.0,) * len(model.dropout)
    model.train()
    torch.mean((model(x) - y) ** 2).backward()
    return ffn_arrays(model)


def ffn_grad_error(got: dict, ref: dict) -> float:
    """Largest distance of ``got``'s gradients and running statistics from
    ``ref``'s, each tensor's against its largest entry in ``ref``, a
    gradient's floored at a thousandth of the largest gradient entry: the
    Dense biases that feed a BatchNorm have an exact gradient of 0, so
    both sides hold rounding noise there (~1e-16 of the largest entry),
    which the floor compares near the scale of the real gradients."""
    g_max = max(float(np.abs(v).max()) for k, v in ref.items()
                if k.startswith("ffn_grad."))
    err = 0.0
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()),
                    1e-3 * g_max if k.startswith("ffn_grad.") else 0.0)
        err = max(err, float(np.abs(got[k] - r).max()) / scale)
    return err


def launch_counts() -> dict:
    return {**cos_kernel.LAUNCHES, **loss_kernel.LAUNCHES,
            **lbfgs_batched.LAUNCHES, **levenberg_marquardt.LAUNCHES}


def main(rank: int, world: int, coordinator: str, device: str,
         problem: str, ddp: bool = False, save=None) -> dict:
    distributed_init(coordinator, world, rank, device_type=device)
    try:
        mesh = make_mesh(world, device_type=device)
        dev = local_device(device)
        prob = build_problem(problem, dev)
        spots, strikes, mats, is_call, prices = prob.args
        run = lambda config: calibrate_sharded(
            mesh, spots, RATE, strikes, mats, is_call, prices,
            torch.Generator().manual_seed(prob.seed), config,
            n_starts=prob.n_starts, device=dev, dtype=prob.dtype)
        # warm-up at the same width, two iterations: library loads, the
        # allocator's first blocks, the groups' first collectives
        run(dataclasses.replace(prob.config, lbfgs=dataclasses.replace(
            prob.config.lbfgs, maxiter=2)))
        for counts in (cos_kernel.LAUNCHES, loss_kernel.LAUNCHES,
                       lbfgs_batched.LAUNCHES, levenberg_marquardt.LAUNCHES):
            for k in counts:
                counts[k] = 0
        synchronize(dev)
        t0 = time.perf_counter()
        out, summary = run(prob.config)
        synchronize(dev)
        wall_s = time.perf_counter() - t0
        line = {
            "rank": rank, "world": world, "backend": dist.get_backend(),
            "problem": problem, "wall_s": wall_s,
            "summary": {"mean_loss": float(summary.mean_loss),
                        "mean_rel_error": float(summary.mean_rel_error),
                        "n_converged": int(summary.n_converged),
                        "n_total": int(summary.n_total)},
            "host_summary": host_summary(
                out, prices.to(prob.dtype).cpu().numpy()),
            "winners_sha256": winners_hash(out),
            "loss": out.loss.cpu().tolist(),
            "converged": out.converged.cpu().tolist(),
        }
        arrays = {f: getattr(out, f).cpu().numpy()
                  for f in BatchCalibration._fields}
        if ddp:
            x, y = ffn_batch(rank, world, dev)
            model, _ = ffn_ddp_step(x, y, seed=1, dropout=(0.0,) * 4)
            flat = torch.cat([p.detach().reshape(-1)
                              for p in model.parameters()]).cpu()
            line["ffn_checksum"] = {"sum": float(flat.sum()),
                                    "abs_sum": float(flat.abs().sum())}
            arrays["ffn_params"] = flat.numpy()
            arrays.update(ffn_arrays(model))
        synchronize(dev)
        line["launches"] = launch_counts()
        if save is not None and rank == 0:
            np.savez(save, **arrays)
        print(json.dumps(line), flush=True)
        return line
    finally:
        dist.destroy_process_group()


def launch(world: int, device: str, problem: str, ddp: bool = False,
           save=None, timeout: float = 300.0, env=None, cwd=None) -> list:
    """Run ``world`` ranks of this module as subprocesses on a free
    loopback port, from ``cwd`` (default: the directory that holds the
    package), each told its local rank and the local world size (all on
    this host); returns each rank's parsed JSON line, in rank order. When a
    rank fails or ``timeout`` seconds pass, every rank still running is
    killed and ``RuntimeError`` carries the ranks' output."""
    port = free_port()
    cwd = cwd if cwd is not None else str(Path(__file__).resolve().parents[2])
    cmd = lambda r: [sys.executable, "-m", MODULE, str(r), str(world),
                     f"127.0.0.1:{port}", device, problem] + (
        ["--ddp"] if ddp else []) + (["--save", save] if save else [])
    with contextlib.ExitStack() as stack:
        files = [(stack.enter_context(tempfile.TemporaryFile("w+")),
                  stack.enter_context(tempfile.TemporaryFile("w+")))
                 for _ in range(world)]
        base = dict(os.environ if env is None else env,
                    LOCAL_WORLD_SIZE=str(world))
        procs = [subprocess.Popen(cmd(r), stdout=out, stderr=err, text=True,
                                  env=dict(base, LOCAL_RANK=str(r)),
                                  cwd=cwd)
                 for r, (out, err) in enumerate(files)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if (any(p.poll() not in (None, 0) for p in procs)
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
    for r, (p, (out, err)) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} failed (exit "
                               f"{p.returncode}):\n{out[-2000:]}\n"
                               f"{err[-4000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in texts]


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("coordinator")
    ap.add_argument("device", choices=("cuda", "cpu"))
    ap.add_argument("problem", choices=PROBLEMS)
    ap.add_argument("--ddp", action="store_true")
    ap.add_argument("--save", default=None)
    a = ap.parse_args(argv)
    main(a.rank, a.world, a.coordinator, a.device, a.problem, a.ddp, a.save)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
