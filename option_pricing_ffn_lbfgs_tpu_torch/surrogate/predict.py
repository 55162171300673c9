"""FFN inference: the "real-time screening" fast path.

The JAX package's ``surrogate/predict.py``. There one jitted program held
feature extraction, scaling, the forward pass, inverse scaling and the
constrained transform; here the same steps run eagerly as one batched
float32 pass on the device of the inputs (a handful of kernel launches,
the three matmuls on cuBLAS).
"""
from __future__ import annotations

import os

import torch

from ..calibration.transforms import transform
from .train import TrainedSurrogate, load_surrogate

DEFAULT_MODEL_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "results", "models",
    "ffn_surrogate.pkl")


def load_default_model(path: str = DEFAULT_MODEL_PATH) -> TrainedSurrogate:
    """Load the shipped trained surrogate (results/models/ffn_surrogate.pkl)."""
    return load_surrogate(path)


def make_predict_fn(surrogate: TrainedSurrogate):
    """Bind a TrainedSurrogate -> ``predict(spots, strikes, maturities,
    market_prices) -> (x, params)``, ``[B, 13]`` float32 each.

    strikes/maturities are accepted (and ignored) so the signature matches
    the calibration entry points: the 11 features are defined on the
    standard 5x3 surface layout (features.py).
    """
    f32 = torch.float32

    def predict(spots, strikes, maturities, market_prices):
        del strikes, maturities
        prices = torch.atleast_2d(torch.as_tensor(market_prices).to(f32))
        spots = torch.atleast_1d(torch.as_tensor(spots, dtype=f32,
                                                 device=prices.device))
        x = surrogate.predict_x(prices, spots)
        return x, transform(x)

    return predict
