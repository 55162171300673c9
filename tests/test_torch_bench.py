"""The bench twin, the host pricer and the winner-only polishes against the
JAX package's ``bench.py``, ``utils/hostpricer.py`` and calibrator.

On the CPU (the kernels' plain versions), float64:
  * ``tools/bench.build_problems``: its truths are bench.py's numpy draws
    bit for bit (all 6 sets), and its prices, from the in-process host
    pricer, are within 1e-11 relative of JAX's ``price_truth_subprocess``
    (set 0);
  * the two polishes of the float32 search winner, fed the same search
    output ``x`` (the port's float32 search on bench set 0's first two
    surfaces) as JAX's ``_polish_batch_lm`` / ``_polish_batch``:
      - the Wolfe L-BFGS polish (``POLISH_LBFGS``, float64 gradients on
        both sides) over 8 iterations: the same evaluation counts,
        polished losses within 1e-6 relative, model prices within 1e-7
        (over its full 60 iterations the two trajectories part, as
        tests/test_torch_optim.py says libm rounding amplifies);
      - the LM polish (``POLISH_LM``): outcome only, model prices within
        2e-4. Its Jacobian is float32 on both sides (K3's plain version
        here, XLA's jacfwd there) and rounds differently; on these
        surfaces the steps along the model's flat valley move with it from
        the first iterations, and the polishes stop at different places;
  * ``calibrate_batch_mixed(polish_all_starts=False)`` and with
    ``polish=POLISH_LBFGS``: the ``BatchCalibration`` fields have JAX's
    shapes and semantics (``calibrator.py:567-589`` of the JAX package);
  * the ablation's ``--out`` has no default, and its configurations are
    the JAX record's.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench as jbench
from option_pricing_ffn_lbfgs_tpu.calibration import calibrator as jcal
from option_pricing_ffn_lbfgs_tpu.utils import config as jcfg
from option_pricing_ffn_lbfgs_tpu.utils import hostpricer as jhost
from option_pricing_ffn_lbfgs_tpu_torch.calibration import calibrator as tcal
from option_pricing_ffn_lbfgs_tpu_torch.tools import bench as tbench
from option_pricing_ffn_lbfgs_tpu_torch.tools import error_ablation
from option_pricing_ffn_lbfgs_tpu_torch.utils import config as tcfg
from option_pricing_ffn_lbfgs_tpu_torch.utils.hostpricer import (
    price_truth_subprocess)

torch.set_num_threads(1)
RESULTS = Path(__file__).resolve().parent.parent / "results"
F64 = torch.float64


def test_build_problems_match_bench_py(monkeypatch):
    """bench.py's draws are captured where it hands them to the host
    pricer; set 0 is priced by the JAX subprocess, the rest are not
    needed."""
    drawn, priced = [], []
    real = jhost.price_truth_subprocess

    def capture(true, spots, strikes, mats, rate=0.03):
        drawn.append(np.array(true))
        if len(drawn) > 1:
            return np.ones((true.shape[0], 15))
        priced.append(real(true, spots, strikes, mats, rate))
        return priced[-1]

    monkeypatch.setattr(jhost, "price_truth_subprocess", capture)
    jbench.build_problems(jnp.float64, 6)
    sets = tbench.build_problems(6, device="cpu")
    assert len(drawn) == len(sets) == 6
    for i, (args, prices) in enumerate(sets):
        np.testing.assert_array_equal(tbench.truths(i), drawn[i])
        assert args[5] == i and args[4].dtype == F64
        assert args[4].shape == (5, 15) and bool(args[3].all())
        np.testing.assert_array_equal(args[4].numpy(), prices)
    np.testing.assert_allclose(sets[0][1], priced[0], rtol=1e-11)


def test_host_pricer_broadcasts():
    true = tbench.truths(1)[:2]
    flat = price_truth_subprocess(true, [100.0, 100.0], tbench.STRIKES,
                                  tbench.MATS, device="cpu")
    full = price_truth_subprocess(true, np.full(2, 100.0),
                                  np.tile(tbench.STRIKES, (2, 1)),
                                  np.tile(tbench.MATS, (2, 1)), 0.03,
                                  device="cpu")
    assert isinstance(flat, np.ndarray) and flat.dtype == np.float64
    assert flat.shape == (2, 15)
    np.testing.assert_array_equal(flat, full)


@pytest.fixture(scope="module")
def searched():
    """Bench set 0's first two surfaces (float64 CPU tensors), the truth,
    and the port's float32 search winners ``x`` (float64)."""
    args, truth = tbench.build_problems(1, device="cpu")[0]
    data = tuple(a[:2] for a in args[:5])
    cfg = tcfg.CalibrationConfig()
    search = dataclasses.replace(
        cfg, pricer=dataclasses.replace(cfg.pricer,
                                        n_terms=cfg.search_n_terms),
        lbfgs=dataclasses.replace(cfg.lbfgs, maxeval=cfg.search_maxeval))
    out32 = tcal.calibrate_batch(data[0], 0.03, *data[1:],
                                 torch.Generator().manual_seed(0), search, 3)
    return data, truth[:2], out32.x.to(F64), out32.loss.to(F64)


def _polish_both(searched, polish_t, polish_j):
    data, _, x, _ = searched
    res, _, model = tcal._polish_winners(data[0], 0.03, *data[1:], x,
                                         tcal.CalibrationConfig(), polish_t)
    j = [jnp.asarray(a.numpy()) for a in data]
    if isinstance(polish_j, jcfg.LMConfig):
        fn, cfg = jcal._polish_batch_lm, jcal._polish_pricer_config(
            jcfg.CalibrationConfig())
    else:
        fn, cfg = jcal._polish_batch, jcfg.CalibrationConfig()
    res_j, _, model_j = fn(j[0], 0.03, *j[1:], jnp.asarray(x.numpy()), cfg,
                           polish_j)
    return res, model.numpy(), res_j, np.asarray(model_j)


def test_wolfe_polish_matches_jax_short_horizon(searched):
    res, model, res_j, model_j = _polish_both(
        searched, dataclasses.replace(tcal.POLISH_LBFGS, maxiter=8),
        dataclasses.replace(jcal.POLISH_LBFGS, maxiter=8))
    np.testing.assert_array_equal(res.n_evals.numpy(),
                                  np.asarray(res_j.n_evals))
    np.testing.assert_array_equal(res.n_iters.numpy(), [8, 8])
    np.testing.assert_allclose(res.f.numpy(), np.asarray(res_j.f), rtol=1e-6)
    np.testing.assert_allclose(model, model_j, rtol=1e-7)
    assert bool((res.f < searched[3]).all())


def test_lm_polish_matches_jax_outcome(searched):
    res, model, res_j, model_j = _polish_both(
        searched, tcal.POLISH_LM,
        dataclasses.replace(jcal.POLISH_LM, residual_impl="native"))
    truth = searched[1]
    assert model.shape == (2, 15) and np.all(np.isfinite(model))
    np.testing.assert_allclose(model, model_j, rtol=2e-4)
    for m in (model, model_j):
        assert np.abs(m / truth - 1).mean() * 100 < 0.03
    assert bool((res.f < searched[3]).all())
    assert np.all(np.asarray(res_j.f) < searched[3].numpy())


def _small(polish):
    """A short search and polish: the fields' semantics, not accuracy."""
    cfg = tcfg.CalibrationConfig(pricer=tcfg.PricerConfig(n_terms=32),
                                 search_n_terms=32, search_maxeval=20,
                                 polish_n_terms=32)
    return cfg, dataclasses.replace(polish, maxiter=4)


@pytest.mark.parametrize("polish,all_starts", [
    (tcal.POLISH_LM, False), (tcal.POLISH_LBFGS, True)],
    ids=["lm_winner_only", "wolfe"])
def test_winner_only_fields(searched, polish, all_starts):
    data = searched[0]
    cfg, polish = _small(polish)
    x0 = tcal.initial_guesses(3, torch.Generator().manual_seed(5),
                              *(data[i].float() for i in (0, 1, 2, 4)))
    out = tcal.calibrate_batch_mixed(data[0], 0.03, *data[1:], config=cfg,
                                     polish=polish, x0=x0,
                                     polish_all_starts=all_starts)
    search = dataclasses.replace(
        cfg, pricer=dataclasses.replace(cfg.pricer, n_terms=32),
        lbfgs=dataclasses.replace(cfg.lbfgs, maxeval=20))
    out32 = tcal.calibrate_batch(data[0], 0.03, *data[1:], config=search,
                                 x0=x0)
    res, params, model = tcal._polish_winners(
        data[0], 0.03, *data[1:], out32.x.to(F64), cfg, polish)
    shapes = dict(x=(2, 13), params=(2, 13), loss=(2,), model_prices=(2, 15),
                  iterations=(2,), n_evals=(2,), converged=(2,),
                  per_start_loss=(2, 3), per_start_x=(2, 3, 13))
    for name, shape in shapes.items():
        assert tuple(getattr(out, name).shape) == shape, name
    for name in ("x", "params", "loss", "model_prices", "per_start_loss",
                 "per_start_x"):
        assert getattr(out, name).dtype == F64, name
    assert torch.equal(out.x, res.x) and torch.equal(out.loss, res.f)
    assert torch.equal(out.params, params)
    assert torch.equal(out.model_prices, model)
    assert torch.equal(out.converged, res.converged)
    assert torch.equal(out.iterations, out32.iterations + res.n_iters)
    assert torch.equal(out.n_evals, out32.n_evals + res.n_evals)
    assert torch.equal(out.per_start_loss, out32.per_start_loss.to(F64))
    win = out32.per_start_loss.argmin(-1)
    rows = torch.arange(2)
    assert torch.equal(out.per_start_x[rows, win], out.x)
    others = torch.ones(2, 3, dtype=torch.bool)
    others[rows, win] = False
    assert torch.equal(out.per_start_x[others],
                       out32.per_start_x.to(F64)[others])
    assert tcal.WAVE_LANES == []


def test_ablation_out_has_no_default():
    with pytest.raises(SystemExit):
        error_ablation.main([])
    record = json.loads((RESULTS / "error_ablation.json").read_text())
    assert list(error_ablation.CONFIGS) == list(record["configs"])
    base = tcfg.CalibrationConfig()
    assert error_ablation.CONFIGS["polish_winner_only"] == (base, False)
    assert error_ablation.CONFIGS["uncapped_search"][0].search_maxeval == 0
    assert error_ablation.CONFIGS["search_N128"][0].search_n_terms == 128
    assert error_ablation.CONFIGS["polish_N128"][0].polish_n_terms == 128
