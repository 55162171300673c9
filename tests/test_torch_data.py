"""The port's data modules against the JAX package's.

The port draws its random inputs from a ``torch.Generator``, which gives
other numbers than JAX's keys, so each parity test reproduces JAX's draws
by JAX's own key splits (``data/synthetic.py``: ``split(key)`` into the
path and noise keys, ``split(key_path, n)`` one key per day, each split
into its parameter and spot keys) and feeds them to the port.

Tolerances (float64):
  * the AR(1) + Feller + spot-walk recurrence: 1e-12 relative (the same
    arithmetic; XLA may contract a multiply-add where numpy rounds twice);
  * prices and market prices: 1e-11 relative (the plain pricer's parity
    with JAX, tests/test_torch_pricer.py);
  * losses: 1e-8 relative. A loss is the mean square of (model - market)
    / market ~ 2e-2, so a 1e-11 price difference moves it by ~1e-9.
"""
import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.data import market as jmarket
from option_pricing_ffn_lbfgs_tpu.data import synthetic as jsyn
from option_pricing_ffn_lbfgs_tpu.utils import config as jcfg
from option_pricing_ffn_lbfgs_tpu_torch.convert import config_from_dict
from option_pricing_ffn_lbfgs_tpu_torch.data import market as tmarket
from option_pricing_ffn_lbfgs_tpu_torch.data import synthetic as tsyn
from option_pricing_ffn_lbfgs_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)
N = 16
F64 = jnp.float64


def _configs(**kw):
    j = jcfg.GeneratorConfig(n_samples=N, **kw)
    return j, config_from_dict(tcfg.GeneratorConfig, dataclasses.asdict(j))


def _jax_draws(key, n, dtype=F64):
    """The raw draws of JAX's generate_dataset for ``key``."""
    key_path, key_noise = jax.random.split(key)
    lo = jnp.asarray(jsyn.RANGE_LO, dtype)
    hi = jnp.asarray(jsyn.RANGE_HI, dtype)

    def day(k):
        k_param, k_spot = jax.random.split(k)
        return (jax.random.uniform(k_param, (13,), dtype, lo, hi),
                jax.random.normal(k_spot, (), dtype))
    raw, z = jax.vmap(day)(jax.random.split(key_path, n))
    noise = jax.random.normal(key_noise, (n, 15), dtype)
    # copies: arrays handed over from JAX are read-only
    return key_path, np.array(raw), np.array(z), np.array(noise)


@pytest.mark.parametrize("feller", [True, False], ids=["capped", "raw"])
def test_ar1_paths_match_sample_paths(feller):
    cfg_j, cfg_t = _configs(enforce_feller=feller)
    key_path, raw, z, _ = _jax_draws(jax.random.key(3), N)
    p_j, s_j = jsyn.sample_paths(key_path, cfg_j, F64)
    p_t, s_t = tsyn.ar1_paths(raw, z, cfg_t)
    assert p_t.dtype == torch.float64 and p_t.shape == (N, 13)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-12)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-12)


def test_pricing_and_noise_match_generate_dataset():
    cfg_j, cfg_t = _configs()
    key = jax.random.key(4)
    _, raw, z, noise = _jax_draws(key, N)
    ds_j = jsyn.generate_dataset(key, cfg_j, F64, n_terms=64)
    ds_t = tsyn.dataset_from_draws(raw, z, noise, cfg_t, torch.float64,
                                   n_terms=64, device="cpu")
    for name in ("params", "spots", "strikes", "maturities"):
        np.testing.assert_allclose(getattr(ds_t, name).numpy(),
                                   np.asarray(getattr(ds_j, name)),
                                   rtol=1e-12, err_msg=name)
    for name in ("model_prices", "market_prices"):
        np.testing.assert_allclose(getattr(ds_t, name).numpy(),
                                   np.asarray(getattr(ds_j, name)),
                                   rtol=1e-11, err_msg=name)
    np.testing.assert_allclose(ds_t.losses.numpy(), np.asarray(ds_j.losses),
                               rtol=1e-8)


def test_generate_dataset_ranges_and_noise():
    """The port's own draws: truths inside the ranges and Feller-capped,
    K1<float> pricing (use_pallas) within 8e-5 of the float64 prices, and
    2 % noise."""
    cfg = tcfg.GeneratorConfig(n_samples=256)
    ds = tsyn.generate_dataset(torch.Generator().manual_seed(0), cfg,
                               n_terms=64, device="cpu")
    p = ds.params.numpy()
    assert np.all(p >= tsyn.RANGE_LO) and np.all(p <= tsyn.RANGE_HI)
    for s, k, t in ((3, 1, 2), (8, 6, 7)):
        assert np.all(p[:, s] <= 0.90 * np.sqrt(2 * p[:, k] * p[:, t])
                      * (1 + 1e-12))
    noise = (ds.market_prices / ds.model_prices - 1.0).numpy() / 0.02
    assert abs(noise.mean()) < 0.1 and abs(noise.std() - 1.0) < 0.1
    f32 = tsyn.generate_dataset(torch.Generator().manual_seed(0), cfg,
                                n_terms=64, use_pallas=True, device="cpu")
    assert f32.model_prices.dtype == torch.float64
    np.testing.assert_allclose(f32.model_prices.numpy(),
                               ds.model_prices.numpy(), rtol=8e-5)


@pytest.mark.parametrize("suffix", [".pkl", ".npz"])
def test_datasets_cross_load(tmp_path, suffix):
    cfg_j, cfg_t = _configs()
    ds_j = jsyn.generate_dataset(jax.random.key(5), cfg_j, F64, n_terms=64)
    jsyn.save_dataset(ds_j, str(tmp_path / f"jax{suffix}"), cfg_j)
    ds_t = tsyn.load_dataset(str(tmp_path / f"jax{suffix}"), device="cpu")
    for name, a in ds_j._asdict().items():
        np.testing.assert_array_equal(getattr(ds_t, name).numpy(),
                                      np.asarray(a), err_msg=name)

    tsyn.save_dataset(ds_t, str(tmp_path / f"port{suffix}"), cfg_t)
    back = jsyn.load_dataset(str(tmp_path / f"port{suffix}"))
    for name, a in ds_j._asdict().items():
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(a), err_msg=name)
    if suffix == ".pkl":
        recs_t = tsyn.to_calibration_results(ds_t, cfg_t)
        recs_j = jsyn.to_calibration_results(ds_j, cfg_j)
        assert [r.date for r in recs_t] == [r.date for r in recs_j]
        assert [r.parameters for r in recs_t] == [r.parameters
                                                  for r in recs_j]
        assert recs_t[0].mean_rel_error_pct == recs_j[0].mean_rel_error_pct


def test_market_round_trip(tmp_path):
    opts = [dict(strike=95.0, maturity=0.25, price=7.5, option_type="call"),
            dict(strike=105.0, maturity=0.5, price=6.25, option_type="put")]
    tmarket.save_option_chain_csv(str(tmp_path / "c.csv"), opts, 100.0, 0.03)
    assert (jmarket.load_option_chain_csv(str(tmp_path / "c.csv"))
            == tmarket.load_option_chain_csv(str(tmp_path / "c.csv"))
            == (opts, 100.0, 0.03))
    (tmp_path / "c.json").write_text(json.dumps(
        {"spot": 100.0, "rate": 0.03, "options": opts}))
    assert (jmarket.load_option_chain_json(str(tmp_path / "c.json"))
            == tmarket.load_option_chain_json(str(tmp_path / "c.json"))
            == (opts, 100.0, 0.03))
    assert tsyn.trading_dates(7, "2022-01-06") == jsyn.trading_dates(
        7, "2022-01-06")
