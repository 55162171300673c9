"""Ground-truth pricing of benchmark surfaces at float64.

The JAX package's ``utils/hostpricer.py`` prices in a CPU-only subprocess,
because touching a CPU backend inside a TPU process slowed every later
TPU dispatch. Nothing of the kind holds for PyTorch on a CUDA card, so
the port keeps the function's name and signature and prices in-process:
on the card through K1<double> (``ops/cos_kernel.py``), or on the CPU
through its plain version when ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.cos_kernel import price_surfaces


def price_truth_subprocess(true, spots, strikes, mats, rate: float = 0.03,
                           device=None) -> np.ndarray:
    """Price ``[B, n_opt]`` all-call surfaces at float64, N = 128, L = 10,
    q = 0.

    Args:
      true: ``[B, 13]`` ground-truth parameter vectors.
      spots: ``[B]`` spot prices.
      strikes, mats: ``[B, n_opt]`` per-surface grids (or broadcastable).
      device: where to price; ``None`` means ``cuda``.
    Returns a ``[B, n_opt]`` float64 numpy array of noiseless prices.
    """
    true = np.asarray(true, np.float64)
    strikes = np.broadcast_to(np.asarray(strikes, np.float64),
                              (true.shape[0], np.shape(strikes)[-1]))
    mats = np.broadcast_to(np.asarray(mats, np.float64), strikes.shape)
    dev = torch.device("cuda" if device is None else device)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64,
                               device=dev)
    prices = price_surfaces(t(true), t(spots), rate, t(strikes), t(mats),
                            torch.ones(strikes.shape, dtype=torch.bool,
                                       device=dev), n_terms=128)
    return prices.cpu().numpy()
