"""Device mesh and process-group bring-up over ``torch.distributed``.

The JAX package's ``parallel/mesh.py``: the scale-out axis is the batch of
surfaces, thousands of independent 13-parameter calibrations split over
ranks, with collectives only where the summary statistics are formed.

The backend follows the layout: NCCL when every rank has a CUDA device of
its own, gloo when the ranks are on the CPU or share a card (NCCL cannot
put two ranks on one device). A failed initialisation fails the run; there
is no fallback from one backend to the other.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..utils.logging_util import get_logger

SURFACE_AXIS = "surfaces"

_log = get_logger("parallel")


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_device(device_type: str) -> torch.device:
    """This rank's device: its current CUDA device for ``"cuda"`` (the
    card ``distributed_init`` or ``make_mesh`` selected), else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def choose_backend(device_type: str, num_processes: int) -> str:
    """``"nccl"`` when each rank on this host has a CUDA device of its own,
    ``"gloo"`` when the ranks are on the CPU or share a card.

    The ranks on this host are ``LOCAL_WORLD_SIZE`` (``torchrun`` sets it;
    a launcher of several ranks on one host sets it too). Without it, a
    world no larger than the host's card count is taken to be this host's
    alone; a larger one raises, since the world alone cannot tell several
    hosts with a card per rank from ranks that share a card."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("device_type 'cuda' needs a CUDA device; a CPU "
                           "run passes device_type='cpu'")
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is None:
        if num_processes > n_cards:
            raise RuntimeError(
                f"{num_processes} ranks and {n_cards} CUDA device(s) on this "
                "host: set LOCAL_WORLD_SIZE to the ranks on this host")
        return "nccl"
    return "nccl" if int(local) <= n_cards else "gloo"


def for_backend(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` where ``group``'s backend takes it: a host copy under gloo
    (not every gloo collective takes CUDA tensors), ``t`` itself under
    NCCL. Differentiable, so an autograd collective's gradient flows back
    to ``t``'s device."""
    return t.cpu() if dist.get_backend(group) == "gloo" else t


def _init_group(init_method: str, world_size: int, rank: int,
                device_type: str) -> None:
    backend = choose_backend(device_type, world_size)
    if device_type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    _log.info("process group: backend %s, rank %d of %d, %s", backend, rank,
              world_size, init_method)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device_type: str = "cuda") -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group``
    with a ``tcp://coordinator`` init method (``coordinator`` is
    ``host:port``; rank 0 listens there), or ``env://`` when
    ``coordinator`` is None (under ``torchrun``, whose agent holds the
    rendezvous).

    A no-op for a single process (``num_processes`` None or 1), as in the
    JAX package: ``make_mesh`` brings up its own one-rank group. The
    backend is ``choose_backend(device_type, num_processes)``, and with
    ``device_type="cuda"`` each rank selects card ``LOCAL_RANK`` (default:
    its rank) modulo the host's card count.
    """
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        raise ValueError("a multi-process run needs process_id")
    init = "env://" if coordinator is None else f"tcp://{coordinator}"
    _init_group(init, num_processes, process_id, device_type)


def make_mesh(n_devices: Optional[int] = None, axis: str = SURFACE_AXIS,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D ``DeviceMesh`` over the first ``n_devices`` ranks of the world
    (default: all), named ``(axis,)``.

    With no process group up and ``n_devices`` None or 1 it brings up a
    one-rank group itself on a free loopback port (NCCL for ``cuda``, gloo
    for ``cpu``): the JAX package's single-process case, which needs no
    initialisation. Every rank of the world must call it.
    """
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {n_devices} ranks needs "
                               "distributed_init first")
        _init_group(f"tcp://127.0.0.1:{free_port()}", 1, 0, device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices {n} outside 1..{world} (the world)")
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


def batch_sharding(mesh: DeviceMesh, axis: str = SURFACE_AXIS):
    """DTensor placements that split the leading (batch) dim over the
    mesh: the JAX package's ``batch_sharding``, kept as its twin. Nothing
    in the port calls it (``calibrate_sharded`` slices rows itself), and
    ``mesh`` and ``axis`` only mirror JAX's signature: a 1-D mesh has one
    placement whatever its name."""
    return [Shard(0)]


def replicated_sharding(mesh: DeviceMesh):
    """DTensor placements that replicate over the mesh: the JAX package's
    ``replicated_sharding``, kept as its twin; nothing in the port calls
    it."""
    return [Replicate()]


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m >= n (shard counts must divide evenly)."""
    return ((n + m - 1) // m) * m
