"""The slice end to end: the port's ``calibrate_batch_mixed`` against JAX's.

Two surfaces priced from the suite's TRUE parameters +/- 5 % (the recipe of
tests/test_mixed_precision.py), 3 starts. Both sides start from JAX's
``initial_guesses`` (the port receives them as ``x0``) and run the slice's
configuration: a float32 batched L-BFGS search with N = 64 and at most 160
evaluations per lane, then a float64 Levenberg-Marquardt polish of every
start (``POLISH_LM``, native float64 residuals, float32 Jacobian). The JAX
oracle runs its XLA engines (``search_impl="batched"``,
``polish_impl="vmap"``); the port runs its one engine, on the CPU through
the kernels' plain versions. Each case runs once with the default
compaction (6 lanes: one-stage polish) and once with
``polish_compact_min_lanes=1`` (stage A plus the compacted waves).

What must agree, and why not more:
  * the starts that reach the global basin (polished loss below 1e-5; the
    others stall in local minima near 5e-4 and 8e-4) are the same on both
    sides, and each side's winner is one of them. Where two starts reach
    the basin, which of them wins depends on where each stopped, so the
    winner index must match only where the basin has a single start;
  * the winners' model prices agree within 2e-4 relative. The float32
    searches round differently on the two sides, so the polishes start
    from different points and stop (at ``cost_target`` 1e-10 or after 80
    iterations) at different places of the model's flat valley, where a
    loss of 1e-9 still moves a price by sqrt(15 * 1e-9) ~ 1e-4 relative.
    Measured: 3.8e-5 without compaction, 1.4e-5 with;
  * both sides' mean pricing errors are below the north-star 0.03 %;
  * the port's ``per_start_x`` holds the winner's iterate at the winner.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.calibration import calibrator as jcal
from option_pricing_ffn_lbfgs_tpu.calibration.initial_guess import (
    initial_guesses)
from option_pricing_ffn_lbfgs_tpu.models.double_heston import (
    DHParams, price_options)
from option_pricing_ffn_lbfgs_tpu.utils.config import CalibrationConfig
import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch.calibration import calibrator as tcal
from option_pricing_ffn_lbfgs_tpu_torch.convert import (
    config_from_dict, x0_from_numpy)
from option_pricing_ffn_lbfgs_tpu_torch.utils import config as tcfg
from tests.conftest import TRUE

torch.set_num_threads(1)
BASIN = 1e-5


@pytest.fixture(scope="module")
def surfaces(surface15):
    strikes, mats, is_call = surface15
    rng = np.random.default_rng(5)
    base = np.array([TRUE[k] for k in DHParams._fields])
    vecs = jnp.asarray(base * (1.0 + rng.uniform(-0.05, 0.05, (2, 13))))
    spots = jnp.full(2, 100.0)
    prices = jax.vmap(lambda s, v: price_options(
        DHParams.from_vector(v), s, 0.03, strikes, mats, is_call))(spots, vecs)
    keys = jax.random.split(jax.random.key(1), 2)
    data = (spots, jnp.broadcast_to(strikes, (2, 15)),
            jnp.broadcast_to(mats, (2, 15)), jnp.broadcast_to(is_call, (2, 15)),
            prices)
    # The starts calibrate_batch_fused draws from these keys (float32).
    f32 = jnp.float32
    x0 = jax.vmap(lambda s, k, m, p, ky: initial_guesses(3, ky, s, k, m, p,
                                                         f32))(
        spots.astype(f32), data[1].astype(f32), data[2].astype(f32),
        prices.astype(f32), keys)
    return data, keys, np.asarray(x0)


@pytest.mark.parametrize("compact_min_lanes", [64, 1],
                         ids=["one_stage", "compacted"])
def test_slice_matches_jax(surfaces, compact_min_lanes):
    data, keys, x0 = surfaces
    cfg_j = CalibrationConfig(search_impl="batched", polish_impl="vmap",
                              polish_compact_min_lanes=compact_min_lanes)
    polish_j = dataclasses.replace(jcal.POLISH_LM, residual_impl="native")
    out_j = jax.tree.map(np.asarray, jcal.calibrate_batch_mixed(
        data[0], 0.03, *data[1:], keys, config=cfg_j, polish=polish_j))

    # The port's slice configuration: kernels engaged at every lane count.
    cfg_t = config_from_dict(tcfg.CalibrationConfig, {
        **dataclasses.asdict(cfg_j), "search_impl": "pallas",
        "polish_impl": "pallas", "polish_fused_min_lanes": 1})
    polish_t = config_from_dict(tcfg.LMConfig, dataclasses.asdict(polish_j))
    spots, strikes, mats, is_call, prices = (np.array(a) for a in data)
    out_t = port.calibrate_batch_mixed(
        spots, 0.03, strikes, mats, is_call, prices, config=cfg_t,
        polish=polish_t, x0=x0_from_numpy(x0), device="cpu")
    if compact_min_lanes == 1:
        assert tcal.WAVE_LANES, "the compacted waves did not run"
    else:
        assert tcal.WAVE_LANES == []

    loss_j, loss_t = out_j.per_start_loss, out_t.per_start_loss.numpy()
    win_j, win_t = loss_j.argmin(-1), loss_t.argmin(-1)
    np.testing.assert_array_equal(loss_t < BASIN, loss_j < BASIN)
    rows = np.arange(2)
    assert np.all(loss_j[rows, win_t] < BASIN)
    assert np.all(loss_t[rows, win_j] < BASIN)
    single = (loss_j < BASIN).sum(-1) == 1
    np.testing.assert_array_equal(win_t[single], win_j[single])

    model_t = out_t.model_prices.numpy()
    np.testing.assert_allclose(model_t, out_j.model_prices, rtol=2e-4)
    for model in (model_t, out_j.model_prices):
        assert np.all(np.isfinite(model)) and model.shape == (2, 15)
        assert np.mean(np.abs(model - prices) / prices) * 100 < 0.03

    np.testing.assert_array_equal(out_t.per_start_x.numpy()[rows, win_t],
                                  out_t.x.numpy())
    assert out_t.x.dtype == torch.float64
