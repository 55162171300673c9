"""Inference side of the trained surrogate (the JAX package's
``surrogate/train.py``): ``TrainedSurrogate``, ``save_surrogate`` and
``load_surrogate``. Training (``fit``, ``pretrain_and_finetune``) is not
ported yet.

A surrogate file is the JAX package's pickle: ``{"variables": Flax
variables as numpy arrays, "feature_scaler", "target_scaler"}``, so the
shipped ``results/models/ffn_surrogate.pkl`` loads here without JAX, and a
file the port writes loads in the JAX package.
"""
from __future__ import annotations

import copy
import pickle

import torch

from ..calibration.transforms import transform
from ..convert import (ffn_state_dict_from_flax, flax_from_ffn_state_dict,
                       load_surrogate_numpy)
from .features import N_FEATURES, extract_features
from .ffn import N_PARAMS, SurrogateFFN
from .scalers import StandardScaler


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
