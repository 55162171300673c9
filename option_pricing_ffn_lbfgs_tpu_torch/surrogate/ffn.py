"""FFN surrogate: option-surface features -> 13 model parameters.

The JAX package's ``surrogate/ffn.py`` (Flax) as an ``nn.Module``: Dense
512/256/128/64, each followed by BatchNorm, Dropout (0.3/0.3/0.2/0.2) and
ReLU, then a linear 13-unit head. The outputs are the calibrator's
unconstrained coordinates, so they feed the L-BFGS warm start directly.

BatchNorm matches Flax's: epsilon 1e-5 (both libraries' default) and
momentum 0.01 in torch's convention (Flax's 0.99). In ``eval()`` mode it
uses its running statistics and dropout is off, which is how the JAX
package runs inference (``train=False``). The Dense layers are plain
``nn.Linear`` (cuBLAS on the card), as they were XLA matmuls outside any
Pallas kernel in the JAX package; keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default) for
float32 parity.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .features import N_FEATURES

N_PARAMS = 13
HIDDEN = (512, 256, 128, 64)
DROPOUT = (0.3, 0.3, 0.2, 0.2)
BN_EPSILON = 1e-5   # Flax's BatchNorm default, and torch's


class SurrogateFFN(nn.Module):
    """Dense 512/256/128/64 -> 13, BatchNorm + Dropout + ReLU per block.
    Takes ``[B, 11]`` float32 features."""

    def __init__(self, hidden: Sequence[int] = HIDDEN,
                 dropout: Sequence[float] = DROPOUT,
                 n_features: int = N_FEATURES):
        super().__init__()
        widths = (n_features, *hidden)
        self.dense = nn.ModuleList(nn.Linear(i, o)
                                   for i, o in zip(widths[:-1], widths[1:]))
        self.norm = nn.ModuleList(nn.BatchNorm1d(w, eps=BN_EPSILON,
                                                 momentum=0.01)
                                  for w in hidden)
        self.drop = nn.ModuleList(nn.Dropout(r) for r in dropout)
        self.head = nn.Linear(widths[-1], N_PARAMS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dense, norm, drop in zip(self.dense, self.norm, self.drop):
            x = torch.relu(drop(norm(dense(x))))
        return self.head(x)


def count_params(model: nn.Module) -> int:
    """Trainable parameters (Flax's ``params`` collection: weights, biases,
    BatchNorm scales and offsets; not the running statistics)."""
    return sum(p.numel() for p in model.parameters())
