"""The trained surrogate and its two-stage training (the JAX package's
``surrogate/train.py``).

Stage 1 pretrains on synthetic data (Adam lr=1e-3, batch 256, early stop
patience 15, 85/15 split); stage 2 fine-tunes on L-BFGS calibration results
(lr=1e-5, batch 32, <=50 epochs, patience 10). The loss is the MSE in the
scaled unconstrained-parameter space (log for positive parameters, arctanh
for the correlations).

Line for line the JAX ``fit``: the host's ``np.random.default_rng(seed)``
draws the split and each epoch's minibatch order (so a seed gives the JAX
package's order), the tail minibatch is dropped, a new best needs
``val < best - 1e-7``, and the best epoch's weights are returned (copied
when they are reached: later steps update the module in place). On the
device (default ``cuda``; no CPU fallback) the training rows are moved
once and gathered by each epoch's order there; an epoch runs its Adam
steps with the step losses kept on the device and reads the host once,
for the mean train loss and the val loss (JAX ran an epoch as one jitted
``lax.scan``). Init draws from a CPU generator seeded ``seed``, so it is
the same on every device; dropout draws from a generator on the device
seeded ``seed + 1``.

A surrogate file is the JAX package's pickle: ``{"variables": Flax
variables as numpy arrays, "feature_scaler", "target_scaler"}``, so the
shipped ``results/models/ffn_surrogate.pkl`` loads here without JAX, and a
file the port writes loads in the JAX package.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from ..calibration.transforms import inverse_transform, transform
from ..convert import (ffn_state_dict_from_flax, flax_from_ffn_state_dict,
                       load_surrogate_numpy)
from ..utils.logging_util import get_logger
from .features import N_FEATURES, extract_features
from .ffn import N_PARAMS, SurrogateFFN, init_ffn
from .scalers import StandardScaler


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    batch_size: int = 256
    max_epochs: int = 200
    patience: int = 15
    val_fraction: float = 0.15
    seed: int = 0


FINETUNE = TrainConfig(learning_rate=1e-5, batch_size=32, max_epochs=50,
                       patience=10)


class TrainedSurrogate:
    """An eval-mode ``SurrogateFFN`` and its fitted scalers.

    ``predict_x`` / ``predict_params`` run on the device of the prices
    they are given; the module is copied to each device once.
    """

    def __init__(self, model: SurrogateFFN, feature_scaler: StandardScaler,
                 target_scaler: StandardScaler):
        self.model = model.eval()
        self.feature_scaler = feature_scaler
        self.target_scaler = target_scaler
        self._on_device = {torch.device("cpu"): self.model}

    def module(self, device) -> SurrogateFFN:
        """The eval-mode module on ``device``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._on_device:
            self._on_device[device] = copy.deepcopy(self.model).to(device)
        return self._on_device[device]

    def predict_x(self, market_prices, spot) -> torch.Tensor:
        """Surface(s) ``[..., 15]`` -> unconstrained 13-vector(s)
        ``[..., 13]`` (the L-BFGS warm start), float32. Features are taken
        in the prices' dtype and scaled in the promoted dtype, then the
        forward pass runs in float32, as in the JAX package."""
        prices = torch.as_tensor(market_prices)
        feats = extract_features(prices, spot)
        fs = self.feature_scaler.transform(feats).to(torch.float32)
        lead = fs.shape[:-1]
        with torch.no_grad():
            scaled = self.module(prices.device)(fs.reshape(-1, N_FEATURES))
        return self.target_scaler.inverse_transform(
            scaled.reshape(*lead, N_PARAMS))

    def predict_params(self, market_prices, spot) -> torch.Tensor:
        """Surface(s) -> constrained parameter vector(s)."""
        return transform(self.predict_x(market_prices, spot))


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def dataset_to_xy(ds) -> Tuple[np.ndarray, np.ndarray]:
    """Features from the noisy market prices; targets in unconstrained
    space. Both as numpy arrays in the dataset's dtype."""
    feats = extract_features(ds.market_prices, ds.spots)
    return _numpy(feats), _numpy(inverse_transform(ds.params))


def epoch_fns(model: SurrogateFFN, opt: torch.optim.Optimizer):
    """``(train_epoch, eval_loss)`` for ``model`` and its optimizer (the
    JAX package's ``_epoch_fns``).

    ``train_epoch(xb, yb, generator)`` takes an epoch's minibatches
    ``[n_batches, B, d]``, runs one optimizer step on each in train mode
    (dropout masks from ``generator``) and returns the mean step loss as a
    0-d tensor on the device, without reading it on the host.
    ``eval_loss(x, y)`` is the MSE in eval mode (running statistics, no
    dropout), also a 0-d tensor.
    """
    def train_epoch(xb, yb, generator=None):
        model.train()
        losses = torch.empty(xb.shape[0], dtype=xb.dtype, device=xb.device)
        for i in range(xb.shape[0]):
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((model(xb[i], generator) - yb[i]) ** 2)
            loss.backward()
            opt.step()
            losses[i] = loss.detach()
        return losses.mean()

    def eval_loss(x, y):
        model.eval()
        with torch.no_grad():
            return torch.mean((model(x) - y) ** 2)

    return train_epoch, eval_loss


def fit(features, targets, config: TrainConfig = TrainConfig(),
        init: Optional[TrainedSurrogate] = None, verbose: bool = False,
        device=None) -> Tuple[TrainedSurrogate, dict]:
    """Train (or fine-tune, via ``init``) the surrogate on ``device``
    (default: the device of ``features`` if it is a tensor, else
    ``cuda``).

    Returns (TrainedSurrogate with the best epoch's weights, history dict).
    Scalers are refit on the training rows only when training from
    scratch; fine-tuning keeps ``init``'s scaler objects so the feature and
    target spaces stay consistent.
    """
    if device is None:
        device = (features.device if isinstance(features, torch.Tensor)
                  else "cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit(): no CUDA device is available (pass "
                           "device='cpu' to train on the CPU)")
    features, targets = _numpy(features), _numpy(targets)
    # Rows with NaN/Inf (e.g. failed calibrations fed as fine-tune targets)
    # would poison every minibatch they land in: drop them loudly.
    finite = (np.isfinite(features).all(axis=1)
              & np.isfinite(targets).all(axis=1))
    n_bad = int((~finite).sum())
    if n_bad:
        get_logger("surrogate.train").warning(
            "fit(): dropping %d/%d non-finite training rows", n_bad,
            features.shape[0])
        features, targets = features[finite], targets[finite]
    if features.shape[0] < 2:
        raise ValueError("fit(): fewer than 2 finite training rows")

    rng = np.random.default_rng(config.seed)
    n = features.shape[0]
    perm = rng.permutation(n)
    n_val = max(1, int(n * config.val_fraction))
    val_idx, tr_idx = perm[:n_val], perm[n_val:]

    if init is None:
        fscaler = StandardScaler.fit(features[tr_idx])
        tscaler = StandardScaler.fit(targets[tr_idx])
    else:
        fscaler, tscaler = init.feature_scaler, init.target_scaler

    fx = np.asarray(fscaler.transform(features), np.float32)
    ty = np.asarray(tscaler.transform(targets), np.float32)
    on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    x_tr, y_tr = on_dev(fx[tr_idx]), on_dev(ty[tr_idx])
    x_val, y_val = on_dev(fx[val_idx]), on_dev(ty[val_idx])

    if init is None:
        model = init_ffn(torch.Generator().manual_seed(config.seed), dev)
    else:
        model = copy.deepcopy(init.model).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=config.learning_rate)
    train_epoch, eval_loss = epoch_fns(model, opt)

    n_tr = x_tr.shape[0]
    bsz = min(config.batch_size, n_tr)
    n_batches = n_tr // bsz
    best_val, best_state, since_best = math.inf, None, 0
    hist = {"train_loss": [], "val_loss": []}
    generator = torch.Generator(dev).manual_seed(config.seed + 1)

    for epoch in range(config.max_epochs):
        order = on_dev(rng.permutation(n_tr)[: n_batches * bsz])
        xb = x_tr[order].view(n_batches, bsz, -1)
        yb = y_tr[order].view(n_batches, bsz, -1)
        tr = train_epoch(xb, yb, generator)
        tr_loss, val = torch.stack([tr, eval_loss(x_val, y_val)]).tolist()
        if not (math.isfinite(tr_loss) and math.isfinite(val)):
            # Diverged optimisation or bad data the row filter missed:
            # failing loudly beats returning the init weights as trained.
            raise FloatingPointError(
                f"fit(): non-finite loss at epoch {epoch} "
                f"(train={tr_loss}, val={val})")
        hist["train_loss"].append(tr_loss)
        hist["val_loss"].append(val)
        if verbose:
            print(f"epoch {epoch}: train {tr_loss:.5f} val {val:.5f}")
        if val < best_val - 1e-7:
            best_val, since_best = val, 0
            best_state = {k: v.detach().clone()
                          for k, v in model.state_dict().items()}
        else:
            since_best += 1
            if since_best >= config.patience:
                break

    best = copy.deepcopy(model).cpu()
    best.load_state_dict(best_state)
    return TrainedSurrogate(best, fscaler, tscaler), hist


def pretrain_and_finetune(pretrain_ds, finetune_ds,
                          pre_config: TrainConfig = TrainConfig(),
                          fine_config: TrainConfig = FINETUNE,
                          verbose: bool = False, device=None):
    """The documented two-stage pipeline in one call, on ``device``
    (default: the device of ``pretrain_ds``)."""
    if device is None:
        device = pretrain_ds.market_prices.device
    fx, fy = dataset_to_xy(pretrain_ds)
    stage1, h1 = fit(fx, fy, pre_config, verbose=verbose, device=device)
    gx, gy = dataset_to_xy(finetune_ds)
    stage2, h2 = fit(gx, gy, fine_config, init=stage1, verbose=verbose,
                     device=device)
    return stage2, {"pretrain": h1, "finetune": h2}


def save_surrogate(path, s: TrainedSurrogate) -> None:
    with open(path, "wb") as f:
        pickle.dump({"variables": flax_from_ffn_state_dict(
                        s.model.state_dict()),
                     "feature_scaler": s.feature_scaler,
                     "target_scaler": s.target_scaler}, f)


def load_surrogate(path) -> TrainedSurrogate:
    d = load_surrogate_numpy(path)
    model = SurrogateFFN()
    model.load_state_dict(ffn_state_dict_from_flax(d["variables"]))
    return TrainedSurrogate(model, d["feature_scaler"], d["target_scaler"])
