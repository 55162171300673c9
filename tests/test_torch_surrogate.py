"""The port's surrogate against the JAX package's, with the shipped weights.

Both sides load ``results/models/ffn_surrogate.pkl`` (the port through its
own unpickler, without JAX) and predict on the same surfaces.

Tolerances:
  * features: 1e-12 relative (the same float64 arithmetic);
  * predictions: 1e-5 relative. The forward pass is float32 on both
    sides; XLA and PyTorch sum the 512/256/128/64-wide dot products in
    other orders, which moves an output by a few float32 ulps (measured on
    these 32 surfaces: 8e-8 relative at most).
"""
import pickle

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.data.synthetic import generate_dataset
from option_pricing_ffn_lbfgs_tpu.surrogate import ffn as jffn
from option_pricing_ffn_lbfgs_tpu.surrogate import predict as jpredict
from option_pricing_ffn_lbfgs_tpu.surrogate import scalers as jscalers
from option_pricing_ffn_lbfgs_tpu.surrogate.features import (
    extract_features as jfeatures)
from option_pricing_ffn_lbfgs_tpu.surrogate.train import (
    load_surrogate as jload)
from option_pricing_ffn_lbfgs_tpu.utils.config import GeneratorConfig
from option_pricing_ffn_lbfgs_tpu_torch import convert
from option_pricing_ffn_lbfgs_tpu_torch.surrogate import ffn as tffn
from option_pricing_ffn_lbfgs_tpu_torch.surrogate import predict as tpredict
from option_pricing_ffn_lbfgs_tpu_torch.surrogate import scalers as tscalers
from option_pricing_ffn_lbfgs_tpu_torch.surrogate.features import (
    extract_features as tfeatures)
from option_pricing_ffn_lbfgs_tpu_torch.surrogate.train import (
    load_surrogate as tload, save_surrogate as tsave)

torch.set_num_threads(1)
MODEL = tpredict.DEFAULT_MODEL_PATH
SCALERS = MODEL.replace("models/ffn_surrogate.pkl", "data/scalers.pkl")


@pytest.fixture(scope="module")
def surfaces():
    ds = generate_dataset(jax.random.key(11), GeneratorConfig(n_samples=32),
                          n_terms=64)
    return np.array(ds.market_prices), np.array(ds.spots)


@pytest.fixture(scope="module")
def both():
    return jload(MODEL), tload(MODEL)


def test_features_match(surfaces):
    prices, spots = surfaces
    np.testing.assert_allclose(
        tfeatures(torch.tensor(prices), torch.tensor(spots)).numpy(),
        np.asarray(jfeatures(prices, spots)), rtol=1e-12)
    one = tfeatures(torch.tensor(prices[0]), float(spots[0]))
    assert one.shape == (11,)
    np.testing.assert_allclose(one.numpy(),
                               np.asarray(jfeatures(prices[0], spots[0])),
                               rtol=1e-12)


def test_scalers_round_trip(tmp_path):
    x = np.random.default_rng(0).normal(3.0, 2.0, (64, 11))
    sc = tscalers.StandardScaler.fit(x)
    jsc = jscalers.StandardScaler.fit(x)
    np.testing.assert_array_equal(sc.mean_, jsc.mean_)
    np.testing.assert_array_equal(sc.scale_, jsc.scale_)
    t = torch.tensor(x)
    np.testing.assert_allclose(sc.inverse_transform(sc.transform(t)).numpy(),
                               x, rtol=1e-14)
    np.testing.assert_allclose(sc.transform(t).numpy(),
                               np.asarray(jsc.transform(x)), rtol=1e-14)
    tscalers.save_scalers(tmp_path / "s.pkl", sc, sc)
    f, g = tscalers.load_scalers(tmp_path / "s.pkl")
    np.testing.assert_array_equal(f.mean_, sc.mean_)
    # The shipped JAX-written scalers load through the port without JAX.
    f_t, g_t = tscalers.load_scalers(SCALERS)
    f_j, g_j = jscalers.load_scalers(SCALERS)
    assert isinstance(f_t, tscalers.StandardScaler)
    for a, b in ((f_t, f_j), (g_t, g_j)):
        np.testing.assert_array_equal(a.mean_, b.mean_)
        np.testing.assert_array_equal(a.scale_, b.scale_)


def test_predictions_match(surfaces, both):
    prices, spots = surfaces
    j, t = both
    x_t = t.predict_x(torch.tensor(prices), torch.tensor(spots))
    assert x_t.dtype == torch.float32 and x_t.shape == (32, 13)
    np.testing.assert_allclose(x_t.numpy(),
                               np.asarray(j.predict_x(prices, spots)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        t.predict_params(torch.tensor(prices), torch.tensor(spots)).numpy(),
        np.asarray(j.predict_params(prices, spots)), rtol=1e-5)
    x_fn, p_fn = tpredict.make_predict_fn(t)(spots, None, None, prices)
    xj_fn, pj_fn = jpredict.make_predict_fn(j)(spots, None, None, prices)
    np.testing.assert_allclose(x_fn.numpy(), np.asarray(xj_fn),
                               rtol=1e-5)
    np.testing.assert_allclose(p_fn.numpy(), np.asarray(pj_fn),
                               rtol=1e-5)


def test_state_dict_conversion(both):
    j, t = both
    sd = convert.ffn_state_dict_from_flax(j.variables)
    model = tffn.SurrogateFFN()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sd["dense.0.weight"].shape == (512, 11)
    assert sd["head.weight"].shape == (13, 64)
    assert tffn.count_params(t.model) == jffn.count_params(j.variables)
    # Flax's BatchNorm epsilon is torch's default, 1e-5, on both sides.
    assert tffn.BN_EPSILON == fnn.BatchNorm().epsilon == 1e-5
    assert all(m.eps == tffn.BN_EPSILON for m in t.model.norm)
    back = convert.flax_from_ffn_state_dict(sd)
    assert jax.tree.all(jax.tree.map(np.array_equal, back,
                                     jax.tree.map(np.asarray, j.variables)))


def test_eval_mode_is_deterministic(surfaces, both):
    """Inference uses the running statistics and no dropout: the same
    surface gives the same output alone and inside a batch."""
    prices, spots = surfaces
    _, t = both
    assert not t.model.training
    a = t.predict_x(torch.tensor(prices), torch.tensor(spots))
    b = t.predict_x(torch.tensor(prices), torch.tensor(spots))
    c = t.predict_x(torch.tensor(prices[3]), float(spots[3]))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(c.numpy(), a[3].numpy(), rtol=1e-6)


def test_saved_surrogate_loads_in_jax(tmp_path, surfaces, both):
    prices, spots = surfaces
    j, t = both
    tsave(tmp_path / "s.pkl", t)
    again = jload(tmp_path / "s.pkl")
    np.testing.assert_array_equal(np.asarray(again.predict_x(prices, spots)),
                                  np.asarray(j.predict_x(prices, spots)))
    with open(tmp_path / "s.pkl", "rb") as f:
        assert set(pickle.load(f)) == {"variables", "feature_scaler",
                                       "target_scaler"}
