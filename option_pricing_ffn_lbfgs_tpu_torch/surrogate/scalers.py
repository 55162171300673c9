"""Standard (z-score) scalers for the FFN's inputs and targets.

The JAX package's ``surrogate/scalers.py``: a NamedTuple of numpy arrays
with the same fields, so its pickles load in either package
(``convert.load_pickle``). ``transform`` and ``inverse_transform`` take
tensors (computed in the promoted dtype of the tensor and the scaler, as
JAX promotes) or arrays.
"""
from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch


class StandardScaler(NamedTuple):
    mean_: np.ndarray
    scale_: np.ndarray

    @classmethod
    def fit(cls, x) -> "StandardScaler":
        x = np.asarray(x)
        scale = x.std(axis=0)
        return cls(mean_=x.mean(axis=0),
                   scale_=np.where(scale > 0, scale, 1.0))

    def _stats(self, x):
        if not isinstance(x, torch.Tensor):
            return np.asarray(x), self.mean_, self.scale_
        mean = torch.from_numpy(np.asarray(self.mean_))
        dt = torch.promote_types(x.dtype, mean.dtype)
        cast = lambda a: torch.as_tensor(np.asarray(a)).to(dt).to(x.device)
        return x.to(dt), cast(self.mean_), cast(self.scale_)

    def transform(self, x):
        x, mean, scale = self._stats(x)
        return (x - mean) / scale

    def inverse_transform(self, x):
        x, mean, scale = self._stats(x)
        return x * scale + mean

    @property
    def n_features_in_(self) -> int:
        return int(self.mean_.shape[-1])


def save_scalers(path, feature_scaler: StandardScaler,
                 target_scaler: StandardScaler) -> None:
    """Pickle layout of the JAX package's ``save_scalers``."""
    with open(path, "wb") as f:
        pickle.dump({"feature_scaler": feature_scaler,
                     "target_scaler": target_scaler}, f)


def load_scalers(path):
    """(feature_scaler, target_scaler) from a scalers pickle written by
    either package."""
    from ..convert import load_pickle
    d = load_pickle(path)
    return d["feature_scaler"], d["target_scaler"]
