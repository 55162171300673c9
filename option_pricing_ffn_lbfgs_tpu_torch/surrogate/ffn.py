"""FFN surrogate: option-surface features -> 13 model parameters.

The JAX package's ``surrogate/ffn.py`` (Flax) as an ``nn.Module``: Dense
512/256/128/64, each followed by BatchNorm, Dropout (0.3/0.3/0.2/0.2) and
ReLU, then a linear 13-unit head. The outputs are the calibrator's
unconstrained coordinates, so they feed the L-BFGS warm start directly.

Training follows Flax, not torch's defaults:
  * ``init_ffn``: Dense kernels ``lecun_normal`` (a normal truncated at
    two standard deviations, rescaled so its standard deviation is
    sqrt(1/fan_in)), Dense biases zero, BatchNorm scale 1, offset 0,
    running mean 0, running variance 1;
  * ``BatchNorm1d`` in train mode normalises with the biased batch
    variance E[x^2] - E[x]^2 (Flax's ``use_fast_variance``, clipped at 0)
    and keeps that biased variance in its running average (torch's
    ``nn.BatchNorm1d`` keeps the unbiased one); epsilon 1e-5 (both
    libraries' default), momentum 0.01 in torch's convention (Flax's
    0.99);
  * dropout draws its keep-mask from the ``torch.Generator`` passed to
    ``forward`` (never the global RNG) and scales kept units by 1/(1-p).

In ``eval()`` mode BatchNorm uses its running statistics through torch's
own ``BatchNorm1d`` and dropout is off, which is how the JAX package runs
inference (``train=False``). The Dense layers are plain ``nn.Linear``
(cuBLAS on the card), as they were XLA matmuls outside any Pallas kernel
in the JAX package; keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default) for
float32 parity.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .features import N_FEATURES

N_PARAMS = 13
HIDDEN = (512, 256, 128, 64)
DROPOUT = (0.3, 0.3, 0.2, 0.2)
BN_EPSILON = 1e-5   # Flax's BatchNorm default, and torch's
# Standard deviation of a standard normal truncated to [-2, 2]: Flax's
# variance_scaling divides by it so the truncated draw keeps its variance.
TRUNCATED_STD = 0.87962566103423978


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose train-mode pass is Flax's ``nn.BatchNorm``
    (biased variance in the normalisation and in the running average);
    eval mode is torch's.

    With a ``process_group`` (``use_process_group``) the train-mode
    statistics are those of the global batch, split over the group's
    ranks, as under the JAX package's data-parallel jit: the row count and
    the sums of x and x*x are all-reduced by
    ``torch.distributed.nn.functional.all_reduce``, through which the
    gradient flows (via the host under gloo). Without one it is unchanged,
    bit for bit."""

    process_group = None

    def _global_moments(self, x: torch.Tensor):
        from torch.distributed.nn.functional import all_reduce
        from ..parallel.mesh import for_backend
        n = torch.full((1,), float(x.shape[0]), dtype=x.dtype,
                       device=x.device)
        stats = torch.cat([n, x.sum(0), (x * x).sum(0)])
        stats = all_reduce(for_backend(self.process_group, stats),
                           group=self.process_group).to(x.device)
        c = x.shape[1]
        mean = stats[1:1 + c] / stats[0]
        return mean, stats[1 + c:] / stats[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is None:
            mean = x.mean(0)
            mean_sq = (x * x).mean(0)
        else:
            mean, mean_sq = self._global_moments(x)
        var = torch.clamp_min(mean_sq - mean * mean, 0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum     # Flax's momentum
            self.running_mean.copy_(keep * self.running_mean
                                    + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var
                                   + (1.0 - keep) * var)
            self.num_batches_tracked.add_(1)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def use_process_group(model: nn.Module, group) -> nn.Module:
    """Give every ``BatchNorm1d`` of ``model`` the process group whose
    global batch its train-mode statistics cover (None: the local batch).
    Do not use ``convert_sync_batchnorm``: it replaces these modules, and
    its train mode is not Flax's."""
    for m in model.modules():
        if isinstance(m, BatchNorm1d):
            m.process_group = group
    return model


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``nn.Dropout`` in train mode: keep each unit with
    probability 1 - rate (a uniform draw from ``generator`` below it) and
    scale it by 1/(1 - rate); rate 0 is the identity."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                      device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


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
        self.norm = nn.ModuleList(BatchNorm1d(w, eps=BN_EPSILON,
                                              momentum=0.01)
                                  for w in hidden)
        self.dropout = tuple(float(r) for r in dropout)
        self.head = nn.Linear(widths[-1], N_PARAMS)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` feeds the dropout masks in train mode."""
        for dense, norm, rate in zip(self.dense, self.norm, self.dropout):
            x = norm(dense(x))
            if self.training:
                x = dropout(x, rate, generator)
            x = torch.relu(x)
        return self.head(x)


def init_ffn(generator: torch.Generator, device=None) -> SurrogateFFN:
    """A ``SurrogateFFN`` with Flax's default initialisation, drawn from
    ``generator`` on its own device, then moved to ``device`` (default: the
    generator's device). The global RNG is not touched."""
    with torch.device("meta"):
        model = SurrogateFFN()
    model = model.to_empty(device=generator.device)
    with torch.no_grad():
        for lin in (*model.dense, model.head):
            std = math.sqrt(1.0 / lin.in_features) / TRUNCATED_STD
            nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
            nn.init.zeros_(lin.bias)
        for norm in model.norm:
            norm.reset_parameters()
    return model.to(device) if device is not None else model


def count_params(model: nn.Module) -> int:
    """Trainable parameters (Flax's ``params`` collection: weights, biases,
    BatchNorm scales and offsets; not the running statistics)."""
    return sum(p.numel() for p in model.parameters())
