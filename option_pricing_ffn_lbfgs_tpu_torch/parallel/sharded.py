"""Sharded batch calibration over a ``torch.distributed`` mesh.

The JAX package's ``parallel/sharded.py``: a batch of B surfaces is split
over the mesh's ranks; every rank runs the batched multi-start search
(``calibrate_batch``: K2 value-and-grad, K1<float> winner reprice) on its
contiguous shard with no communication, and only the summary statistics
and the gathered results cross ranks.

Every rank holds the whole batch. The batch is padded with edge rows to a
multiple of the mesh size, and the padding is masked out of the
statistics. The starts are drawn for the whole batch from the one seeded
generator (as ``calibrate_batch`` draws them) or taken from ``x0``, and
each rank slices its rows, so the rank count cannot change a surface's
starts; the lanes of the batched L-BFGS are independent, so it does not
change a surface's winner either.

Collectives: one float64 all-reduce of the packed local sums, one
all-gather of the packed per-surface fields (float32 and int32 values are
exact in float64). NCCL takes CUDA tensors; under gloo both go through
the host (a few kilobytes).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..calibration.calibrator import (BatchCalibration, _device_of, _inputs,
                                      calibrate_batch)
from ..calibration.initial_guess import initial_guesses
from ..utils.config import CalibrationConfig, validate_calibration
from .mesh import for_backend, local_device, pad_to_multiple


class ShardedSummary(NamedTuple):
    """Cross-rank aggregate statistics (all-reduced, float64 sums)."""
    mean_loss: torch.Tensor
    mean_rel_error: torch.Tensor   # mean |model-market|/market over surfaces
    n_converged: torch.Tensor
    n_total: torch.Tensor


def _rank_device(mesh: DeviceMesh, market_prices, device) -> torch.device:
    """``device``, else the device of ``market_prices`` if it is a tensor,
    else the current CUDA device on a ``cuda`` mesh and the CPU on a
    ``cpu`` one."""
    if device is not None or isinstance(market_prices, torch.Tensor):
        return _device_of(market_prices, device)
    return local_device(mesh.device_type)


def _all_gather(group, n: int, t: torch.Tensor) -> torch.Tensor:
    """``[n * rows, ...]``: every rank's ``t`` in rank order."""
    t = for_backend(group, t.contiguous())
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def _pack(out: BatchCalibration) -> torch.Tensor:
    """The per-surface fields as one float64 ``[rows, F]`` tensor."""
    rows = out.loss.shape[0]
    return torch.cat([getattr(out, f).reshape(rows, -1).to(torch.float64)
                      for f in BatchCalibration._fields], dim=1)


def _unpack(packed: torch.Tensor, like: BatchCalibration,
            device) -> BatchCalibration:
    rows, fields, col = packed.shape[0], [], 0
    packed = packed.to(device)
    for f in BatchCalibration._fields:
        t = getattr(like, f)
        width = t[0].numel()
        fields.append(packed[:, col:col + width].to(t.dtype)
                      .reshape(rows, *t.shape[1:]))
        col += width
    return BatchCalibration(*fields)


def calibrate_sharded(mesh: DeviceMesh, spots, rate: float, strikes,
                      maturities, is_call, market_prices,
                      generator: Optional[torch.Generator] = None,
                      config: CalibrationConfig = CalibrationConfig(),
                      n_starts: int = 3, x0=None, device=None,
                      dtype: torch.dtype = torch.float32):
    """Calibrate B surfaces split over ``mesh``'s ranks.

    Every rank passes the whole batch (leading dim B) and gets back
    ``(BatchCalibration with leading axis B, ShardedSummary)``. The
    arguments are ``calibrate_batch``'s: ``x0 [B, n_starts, 13]`` replaces
    the starts drawn from ``generator`` (a seed-0 CPU generator when
    None). ``device`` is this rank's device: default the device of
    ``market_prices`` if it is a tensor, else the current CUDA device on a
    ``cuda`` mesh and the CPU on a ``cpu`` one.
    """
    validate_calibration(config)
    if mesh.ndim != 1:
        raise ValueError("calibrate_sharded takes a 1-D mesh")
    group = mesh.get_group()
    n_dev = mesh.size()
    rank = mesh.get_local_rank()
    dev = _rank_device(mesh, market_prices, device)
    spots, strikes, maturities, is_call, mkt = _inputs(
        spots, strikes, maturities, is_call, market_prices, dtype, dev)
    b = spots.shape[0]
    if b == 0:
        raise ValueError("calibrate_sharded needs at least one surface")
    if x0 is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        x0 = initial_guesses(n_starts, generator, spots, strikes, maturities,
                             mkt)
    else:
        x0 = torch.as_tensor(x0, dtype=dtype, device=dev)
        if x0.shape != (b, n_starts, 13):
            raise ValueError(f"x0 must be [{b}, {n_starts}, 13], got "
                             f"{tuple(x0.shape)}")
    per = pad_to_multiple(b, n_dev) // n_dev
    idx = torch.arange(rank * per, (rank + 1) * per, device=dev)
    valid = idx < b
    rows = torch.clamp(idx, max=b - 1)       # edge padding
    local = calibrate_batch(spots[rows], rate, strikes[rows],
                            maturities[rows], is_call[rows], mkt[rows],
                            config=config, n_starts=n_starts, x0=x0[rows],
                            device=dev, dtype=dtype)

    f64 = torch.float64
    w = valid.to(f64)
    m64 = mkt[rows].to(f64)
    rel = (local.model_prices.to(f64) - m64).abs() / m64
    sums = torch.stack([w.sum(), (local.loss.to(f64) * w).sum(),
                        (rel.mean(dim=-1) * w).sum(),
                        (local.converged.to(f64) * w).sum()])
    sums = for_backend(group, sums)
    dist.all_reduce(sums, group=group)
    sums = sums.to(dev)
    summary = ShardedSummary(mean_loss=sums[1] / sums[0],
                             mean_rel_error=sums[2] / sums[0],
                             n_converged=sums[3].to(torch.int64),
                             n_total=sums[0].to(torch.int64))
    gathered = _all_gather(group, n_dev, _pack(local))[:b]
    return _unpack(gathered, local, dev), summary
