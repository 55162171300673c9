"""Driver entry points: the forward pricer and the multi-rank dry run (the
JAX package's ``__graft_entry__.py``)::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.graft_entry
    torchrun --nproc_per_node=N \\
        -m option_pricing_ffn_lbfgs_tpu_torch.tools.graft_entry

``entry()`` returns the flagship forward step, the Double Heston + jump
COS surface pricer (``price_surfaces``: K1<float> on the card), with its
inputs. ``dryrun_multichip(n)`` builds an n-rank mesh and runs the
framework's full step on tiny shapes: a batch of multi-start L-BFGS
calibrations sharded over the ``surfaces`` axis (``calibrate_sharded``,
with K2 and K1<float> on every rank), held to the JAX dry run's
convergence bar, then one data-parallel train step of the FFN surrogate
(DDP, BatchNorm over the global batch). Under ``torchrun`` n is the world
size (the group comes up through ``env://``); alone it is 1. Both run on
``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..calibration.calibrator import calibrate_batch
from ..ops.cos_kernel import price_surfaces
from ..parallel.mesh import distributed_init, local_device, make_mesh
from ..parallel.sharded import calibrate_sharded
from ..surrogate.ffn import (N_FEATURES, N_PARAMS, init_ffn,
                             use_process_group)
from ..utils.config import CalibrationConfig, LBFGSConfig, PricerConfig

SPOT, RATE = 100.0, 0.03
# The dry run's surface and truth (__graft_entry__.py:50-55).
DRY_STRIKES = np.tile([95.0, 100.0, 105.0], 2)
DRY_MATS = np.repeat([0.5, 1.0], 3)
DRY_TRUE = np.array([0.04, 2.0, 0.04, 0.3, -0.6, 0.04, 0.8, 0.04, 0.2,
                     -0.4, 0.1, -0.04, 0.08])
# Small but convergent: 2 starts x 25 L-BFGS iterations at N = 32.
DRY_CONFIG = CalibrationConfig(pricer=PricerConfig(n_terms=32),
                               lbfgs=LBFGSConfig(maxiter=25))


def entry(device="cuda"):
    """``(fn, (params, strikes, mats))``: ``fn(params, strikes, mats)``
    prices the 15 calls (5 strikes x 3 maturities) of one surface at spot
    100, rate 0.03, N = 128, float32 (__graft_entry__.py:15-32)."""
    dev = torch.device(device)
    f32 = torch.float32
    strikes = torch.tensor(np.tile([90.0, 95.0, 100.0, 105.0, 110.0], 3),
                           dtype=f32, device=dev)
    mats = torch.tensor(np.repeat([0.25, 0.5, 1.0], 5), dtype=f32,
                        device=dev)
    is_call = torch.ones((1, 15), dtype=torch.bool, device=dev)
    spot = torch.full((1,), SPOT, dtype=f32, device=dev)
    params = torch.tensor([0.04, 2.5, 0.04, 0.3, -0.7, 0.04, 0.5, 0.04, 0.2,
                           -0.5, 0.15, -0.04, 0.08], dtype=f32, device=dev)

    def fn(params_vec, strikes, maturities):
        return price_surfaces(params_vec[None], spot, RATE, strikes[None],
                              maturities[None], is_call)[0]

    return fn, (params, strikes, mats)


def ffn_ddp_step(x, y, seed: int = 1, lr: float = 1e-3,
                 dropout: Optional[tuple] = None):
    """One data-parallel Adam step of ``SurrogateFFN`` on this rank's rows
    ``x [b, 11]``, ``y [b, 13]`` (their dtype and device), over the
    default process group: DDP averages the gradients, and every
    BatchNorm normalises with the statistics of the global batch.
    ``init_ffn`` draws the initial weights from a CPU generator seeded
    ``seed`` (the same on every rank); the dropout masks come from a
    generator seeded ``(seed, rank)``; ``dropout`` overrides the model's
    rates. Returns ``(model, loss)``: the updated module (not the DDP
    wrapper) and this rank's loss before the step."""
    from torch.nn.parallel import DistributedDataParallel as DDP
    dev = x.device
    model = init_ffn(torch.Generator().manual_seed(seed)).to(dev, x.dtype)
    if dropout is not None:
        model.dropout = tuple(float(r) for r in dropout)
    use_process_group(model, dist.group.WORLD)
    ddp = DDP(model, device_ids=[dev.index] if dev.type == "cuda" else None)
    opt = torch.optim.Adam(ddp.parameters(), lr=lr)
    rank = dist.get_rank()
    gen = torch.Generator(dev).manual_seed(seed * 1_000_003 + rank)
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = torch.mean((ddp(x, gen) - y) ** 2)
    loss.backward()
    unused = [n for n, p in model.named_parameters() if p.grad is None]
    if unused:
        raise RuntimeError(f"DDP left parameters without a gradient: "
                           f"{unused}")
    opt.step()
    return model, loss.detach()


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """The sharded calibration and the data-parallel FFN step over an
    ``n_devices``-rank mesh (__graft_entry__.py:35-125). Raises
    ``RuntimeError`` when a solve misses the convergence bar."""
    mesh = make_mesh(n_devices, device_type=device_type)
    dev = local_device(device_type)
    f32 = torch.float32
    b = 2 * n_devices
    t = lambda a: torch.tensor(np.asarray(a), dtype=f32, device=dev)
    strikes, mats = t(DRY_STRIKES)[None], t(DRY_MATS)[None]
    is_call = torch.ones((1, 6), dtype=torch.bool, device=dev)
    prices = price_surfaces(t(DRY_TRUE)[None], t([SPOT]), RATE, strikes,
                            mats, is_call, n_terms=32)
    spots = torch.full((b,), SPOT, dtype=f32, device=dev)
    grid = lambda a: a.expand(b, 6).contiguous()
    bs, bm, bc, bp = grid(strikes), grid(mats), grid(is_call), grid(prices)

    out, summary = calibrate_sharded(
        mesh, spots, RATE, bs, bm, bc, bp, torch.Generator().manual_seed(0),
        DRY_CONFIG, n_starts=2, device=dev)
    if out.loss.shape != (b,) or not torch.isfinite(summary.mean_rel_error):
        raise RuntimeError("sharded calibration output malformed")
    # Convergence on every shard: the absolute bar of the unsharded path,
    # and the winners reproduce the surface.
    local = calibrate_batch(spots[:1], RATE, bs[:1], bm[:1], bc[:1], bp[:1],
                            torch.Generator().manual_seed(0), DRY_CONFIG,
                            n_starts=2, device=dev)
    l_loc = float(local.loss[0])
    losses = out.loss.cpu().numpy()
    if not (np.isfinite(l_loc) and l_loc < 1e-4):
        raise RuntimeError(f"unsharded solve failed to converge: {l_loc}")
    if not (np.isfinite(losses).all() and (losses < 1e-4).all()):
        raise RuntimeError(f"sharded solves not converged: {losses}")
    rel = float(((out.model_prices - bp).abs() / bp).max())
    if not rel < 0.02:
        raise RuntimeError(f"sharded winner misprices the surface: {rel}")

    # The FFN's train step, data-parallel over the same ranks: batch split
    # on the surfaces axis, parameters replicated, gradients all-reduced.
    per = 4
    x = torch.ones((per, N_FEATURES), dtype=f32, device=dev)
    y = torch.zeros((per, N_PARAMS), dtype=f32, device=dev)
    _, loss = ffn_ddp_step(x, y, seed=1)
    if not torch.isfinite(loss):
        raise RuntimeError(f"FFN train step loss not finite: {loss}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", 1))
    # Under torchrun: RANK, WORLD_SIZE and the rendezvous come from the
    # environment (coordinator None means env://).
    distributed_init(None, world, int(os.environ.get("RANK", 0)),
                     device_type=args.device)
    try:
        fn, inputs = entry(local_device(args.device))
        print("entry:", fn(*inputs)[:3].cpu().numpy(), flush=True)
        dryrun_multichip(world, device_type=args.device)
        print("dryrun_multichip ok", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
