"""The port's surrogate training against the JAX package's, on the CPU.

Inputs are made from seeds with numpy and go through both packages.

Tolerances:
  * ``init_ffn``: Flax's ``lecun_normal`` (a normal truncated at +-2
    standard deviations sigma = sqrt(1/fan_in) / 0.8796, so the draw's own
    standard deviation is sqrt(1/fan_in)): over 5 seeds the 512 x 256
    layer's standard deviation within 5 % of sqrt(1/fan_in) and every
    |w| <= 2 sigma, on both sides; zero biases, BatchNorm 1/0/0/1 exactly.
    torch's default init (uniform, std sqrt(1/(3 fan_in))) fails the
    check, which each case asserts too;
  * one train-mode forward and its BatchNorm running statistics, float64
    on both sides: 1e-12 relative (the same arithmetic, summed in other
    orders). torch's ``nn.BatchNorm1d`` keeps the unbiased variance and
    misses the running variance by more than 1e-6, which the test
    asserts;
  * 8 Adam steps at batch 32 through JAX's ``_epoch_fns`` and the port's
    ``epoch_fns``, float64: weights, running statistics, the mean step
    loss and the eval loss to 1e-10 relative (each tensor against its
    largest entry). The Dense biases that feed a BatchNorm are the
    exception: the normalisation removes any constant shift, so their
    gradient is zero in exact arithmetic and Adam turns each side's
    rounding noise into steps of its own sign. They are held to
    |b| <= 1e-10 on both sides (a real Adam step here is ~1e-3), not to
    each other. In float32 that noise is as large as the gradient's
    rounding (~1e-8 against Adam's eps of 1e-8), so those biases move by
    up to 3.2 lr a step on either side and, through the 1 % momentum,
    the running means by up to 2 * 8 * 3.2 lr * 0.01 = 5.1e-4. The other
    float32 tensors and both losses are held to 1e-3 relative (measured:
    weights 2.5e-5 against their largest entry, eval loss 5.9e-5, mean
    step loss equal);
  * ``fit`` with dropout on: the dropout masks come from another RNG than
    JAX's, so the JAX tests' own contracts are held
    (tests/test_surrogate.py::TestTraining): the val loss falls and its
    minimum is below 1, per-parameter MSE below 0.8 (v1_0) and 0.7
    (v2_0), predictions finite and in range;
  * a surrogate trained by the port predicts the same in the JAX package
    (its pickle through the JAX ``load_surrogate``) to 1e-5 relative
    (both float32 forward passes, summed in other orders).
"""
import json
import logging
import os
import pickle
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn.functional as F

from option_pricing_ffn_lbfgs_tpu.surrogate import ffn as jffn
from option_pricing_ffn_lbfgs_tpu.surrogate import train as jtrain
from option_pricing_ffn_lbfgs_tpu.utils import checkpoint as jckpt
import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch import convert
from option_pricing_ffn_lbfgs_tpu_torch.calibration.calibrator import (
    BatchCalibration)
from option_pricing_ffn_lbfgs_tpu_torch.surrogate import ffn as tffn
from option_pricing_ffn_lbfgs_tpu_torch.surrogate import train as ttrain
from option_pricing_ffn_lbfgs_tpu_torch.surrogate.scalers import load_scalers
from option_pricing_ffn_lbfgs_tpu_torch.tools import train_pipeline as tpipe

torch.set_num_threads(1)
RESULTS = Path(__file__).resolve().parent.parent / "results"
NO_DROPOUT = (0.0,) * 4
LR, STEPS, BATCH = 1e-3, 8, 32


def _lecun_ok(w):
    """(std within 5 % of sqrt(1/fan_in), all |w| <= 2 sigma) for a weight
    ``[out, in]``. The std is checked on layers of at least 5000 weights
    (its sampling error there is <= 1.3 %); the 64 x 13 head's 832 weights
    get the bound only."""
    fan_in = w.shape[1]
    target = np.sqrt(1.0 / fan_in)
    sigma = target / tffn.TRUNCATED_STD
    std_ok = w.size < 5000 or abs(w.std() / target - 1.0) < 0.05
    return std_ok, bool(np.abs(w).max() <= 2.0 * sigma * (1 + 1e-6))


@pytest.mark.parametrize("seed", range(5))
def test_init_follows_flax(seed):
    model = tffn.init_ffn(torch.Generator().manual_seed(seed))
    _, jvars = jffn.init_ffn(jax.random.key(seed))
    w = model.dense[1].weight.detach().numpy()
    assert w.shape == (256, 512)
    assert _lecun_ok(w) == (True, True)
    assert _lecun_ok(np.asarray(jvars["params"]["Dense_1"]["kernel"]).T) \
        == (True, True)
    # torch's own init misses the same check.
    assert not _lecun_ok(torch.nn.Linear(512, 256).weight.detach().numpy())[0]
    for lin in (*model.dense, model.head):
        assert _lecun_ok(lin.weight.detach().numpy()) == (True, True)
        assert not lin.bias.any()
    for norm in model.norm:
        assert bool((norm.weight == 1).all() and (norm.bias == 0).all())
        assert bool((norm.running_mean == 0).all()
                    and (norm.running_var == 1).all())
    # Same layout as Flax's variables, drawn without the global RNG.
    sd = convert.ffn_state_dict_from_flax(jvars)
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    state = torch.get_rng_state()
    again = tffn.init_ffn(torch.Generator().manual_seed(seed))
    assert torch.equal(state, torch.get_rng_state())
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), again.state_dict().values()))


def _variables(seed, dtype):
    """Flax variables of a dropout-free ``SurrogateFFN`` with random
    BatchNorm scales, offsets and running statistics, at ``dtype``."""
    _, v = jffn.init_ffn(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
    for i in range(4):
        bn, st = v["params"][f"BatchNorm_{i}"], v["batch_stats"][f"BatchNorm_{i}"]
        n = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, n)
        bn["bias"] = rng.normal(0.0, 0.1, n)
        st["mean"] = rng.normal(0.0, 0.1, n)
        st["var"] = rng.uniform(0.5, 2.0, n)
    return jax.tree.map(lambda a: np.asarray(a, dtype), v)


def _port_model(variables, dtype):
    model = tffn.SurrogateFFN(dropout=NO_DROPOUT).to(dtype)
    model.load_state_dict(convert.ffn_state_dict_from_flax(variables, dtype))
    return model


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_batchnorm_train_forward_matches_flax_f64():
    variables = _variables(1, np.float64)
    x = np.random.default_rng(2).normal(0.0, 1.0, (BATCH, 11))
    jmodel = jffn.SurrogateFFN(dropout=NO_DROPOUT)
    out_j, upd = jmodel.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    model = _port_model(variables, torch.float64).train()
    out_t = model(torch.tensor(x))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-12, atol=1e-12 * np.abs(out_j).max())
    stats = convert.flax_from_ffn_state_dict(model.state_dict())
    for i in range(4):
        for k in ("mean", "var"):
            ref = np.asarray(upd["batch_stats"][f"BatchNorm_{i}"][k])
            np.testing.assert_allclose(
                stats["batch_stats"][f"BatchNorm_{i}"][k], ref, rtol=1e-12,
                atol=1e-12 * np.abs(ref).max())
    # torch's BatchNorm1d keeps the unbiased variance (the batch's share
    # off by B/(B-1)), so it misses the 1e-12 check by far.
    plain = torch.nn.BatchNorm1d(512, momentum=0.01).double().train()
    plain.load_state_dict(_port_model(variables, torch.float64)
                          .norm[0].state_dict())
    with torch.no_grad():
        plain(model.dense[0](torch.tensor(x)))
    ref = np.asarray(upd["batch_stats"]["BatchNorm_0"]["var"])
    assert _max_rel(plain.running_var.numpy(), ref) > 1e-6


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                        (np.float32, 1e-3)],
                         ids=["float64", "float32"])
def test_adam_epoch_matches_jax(dtype, rtol):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    variables = _variables(3, dtype)
    rng = np.random.default_rng(4)
    xb, yb = (rng.normal(0.0, 1.0, (STEPS, BATCH, d)).astype(dtype)
              for d in (11, 13))
    xv, yv = (rng.normal(0.0, 1.0, (40, d)).astype(dtype) for d in (11, 13))

    jmodel = jffn.SurrogateFFN(dropout=NO_DROPOUT)
    tx = optax.adam(LR)
    train_epoch, eval_loss = jtrain._epoch_fns(jmodel, tx)
    jv, _, jloss = train_epoch(variables, tx.init(variables["params"]),
                               jnp.asarray(xb), jnp.asarray(yb),
                               jax.random.key(0))
    jeval = float(eval_loss(jv, jnp.asarray(xv), jnp.asarray(yv)))

    model = _port_model(variables, tdt)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    t_epoch, t_eval = ttrain.epoch_fns(model, opt)
    tloss = t_epoch(torch.tensor(xb), torch.tensor(yb))
    teval = float(t_eval(torch.tensor(xv), torch.tensor(yv)))
    assert tloss.dtype == tdt and tloss.dim() == 0

    assert abs(float(tloss) / float(jloss) - 1) <= rtol
    assert abs(teval / jeval - 1) <= rtol
    got = convert.flax_from_ffn_state_dict(model.state_dict())
    jv = jax.tree.map(np.asarray, jv)
    bias_bound = 1e-10 if dtype == np.float64 else STEPS * 3.2 * LR
    for i in range(5):
        dense = f"Dense_{i}"
        assert _max_rel(got["params"][dense]["kernel"],
                        jv["params"][dense]["kernel"]) <= rtol, dense
        if i == 4:
            assert _max_rel(got["params"][dense]["bias"],
                            jv["params"][dense]["bias"]) <= rtol
            continue
        for b in (got["params"][dense]["bias"], jv["params"][dense]["bias"]):
            assert np.abs(b).max() <= bias_bound, dense
        bn = f"BatchNorm_{i}"
        for k in ("scale", "bias"):
            assert _max_rel(got["params"][bn][k], jv["params"][bn][k]) \
                <= rtol, (bn, k)
        assert _max_rel(got["batch_stats"][bn]["var"],
                        jv["batch_stats"][bn]["var"]) <= rtol, bn
        mean_t, mean_j = (got["batch_stats"][bn]["mean"],
                          jv["batch_stats"][bn]["mean"])
        mean_atol = (0.0 if dtype == np.float64
                     else 2 * STEPS * 3.2 * LR * 0.01)
        assert np.abs(mean_t - mean_j).max() <= \
            rtol * np.abs(mean_j).max() + mean_atol, bn


def test_dropout_draws_from_its_generator():
    model = tffn.init_ffn(torch.Generator().manual_seed(0)).train()
    x = torch.randn(64, 11, generator=torch.Generator().manual_seed(1))
    state = torch.get_rng_state()
    a = model(x, torch.Generator().manual_seed(5))
    b = model(x, torch.Generator().manual_seed(5))
    c = model(x, torch.Generator().manual_seed(6))
    assert torch.equal(state, torch.get_rng_state())
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    ones = torch.ones(1000, 50)
    kept = tffn.dropout(ones, 0.3, torch.Generator().manual_seed(2))
    assert set(torch.unique(kept).tolist()) == {
        0.0, float(np.float32(1.0) / np.float32(0.7))}
    assert abs(float((kept > 0).float().mean()) - 0.7) < 0.01
    assert tffn.dropout(ones, 0.0, None) is ones


def test_eval_forward_is_torch_batchnorm():
    """Eval mode is torch's own BatchNorm: the shipped surrogate's forward
    equals, bit for bit, the same layers written with torch.nn.functional."""
    s = port.load_default_model()
    x = torch.randn(32, 11, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = s.model(x)
        h = x
        for dense, norm in zip(s.model.dense, s.model.norm):
            h = torch.relu(F.batch_norm(
                F.linear(h, dense.weight, dense.bias), norm.running_mean,
                norm.running_var, norm.weight, norm.bias, False, 0.0,
                norm.eps))
        want = F.linear(h, s.model.head.weight, s.model.head.bias)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def small_ds():
    return port.generate_dataset(torch.Generator().manual_seed(1),
                                 port.GeneratorConfig(n_samples=1000),
                                 n_terms=64, device="cpu")


@pytest.fixture(scope="module")
def trained(small_ds):
    fx, fy = port.dataset_to_xy(small_ds)
    return port.fit(fx, fy, port.TrainConfig(max_epochs=120, patience=30,
                                             batch_size=128, seed=0),
                    device="cpu")


def test_fit_learns(trained, small_ds):
    surrogate, hist = trained
    assert hist["val_loss"][-1] < hist["val_loss"][0]
    assert min(hist["val_loss"]) < 1.0        # beats predicting the mean
    fx, fy = port.dataset_to_xy(small_ds)
    fs = surrogate.feature_scaler.transform(fx).astype(np.float32)
    ys = surrogate.target_scaler.transform(fy)
    with torch.no_grad():
        pred = surrogate.model(torch.from_numpy(fs)).numpy()
    per_param_mse = ((pred - ys) ** 2).mean(0)
    assert per_param_mse[0] < 0.8    # v1_0 learned
    assert per_param_mse[5] < 0.7    # v2_0 learned
    assert not surrogate.model.training


def test_fit_prediction_quality(trained, small_ds):
    surrogate, _ = trained
    pred = surrogate.predict_params(small_ds.market_prices[:20],
                                    small_ds.spots[:20]).numpy()
    truth = small_ds.params[:20].numpy()
    assert pred.shape == (20, 13) and np.all(np.isfinite(pred))
    assert np.all(pred[:, [0, 1, 2, 3, 5, 6, 7, 8, 10, 12]] > 0)
    assert np.all(np.abs(pred[:, [4, 9]]) < 1.0)
    assert np.corrcoef(pred[:, 0], truth[:, 0])[0, 1] > 0.2


def test_trained_surrogate_loads_in_jax(trained, small_ds, tmp_path):
    surrogate, _ = trained
    path = tmp_path / "ffn.pkl"
    port.save_surrogate(path, surrogate)
    j = jtrain.load_surrogate(path)
    prices, spots = small_ds.market_prices[:32], small_ds.spots[:32]
    np.testing.assert_allclose(
        np.asarray(j.predict_x(prices.numpy(), spots.numpy())),
        surrogate.predict_x(prices, spots).numpy(), rtol=1e-5, atol=1e-6)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 1.0, (n, 11)), rng.normal(0.0, 1.0, (n, 13))


def test_fit_drops_non_finite_rows(caplog):
    fx, fy = _rows(40, 5)
    fx[3, 2] = np.nan
    fy[7, 0] = np.inf
    with caplog.at_level(logging.WARNING):
        s, hist = port.fit(fx, fy, port.TrainConfig(max_epochs=2,
                                                    batch_size=8),
                           device="cpu")
    assert "dropping 2/40 non-finite training rows" in caplog.text
    assert len(hist["val_loss"]) == 2
    assert np.all(np.isfinite(s.feature_scaler.mean_))


def test_fit_guards():
    fx, fy = _rows(2, 6)
    fx[0, 0] = np.nan
    with pytest.raises(ValueError, match="fewer than 2"):
        port.fit(fx, fy, device="cpu")
    fx, fy = _rows(40, 7)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        port.fit(fx, fy, port.TrainConfig(learning_rate=1e30, max_epochs=3,
                                          batch_size=8), device="cpu")


def test_fit_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fx, fy = _rows(16, 8)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.fit(fx, fy, device=device)


def test_finetune_keeps_scalers(trained, small_ds):
    surrogate, _ = trained
    fx, fy = port.dataset_to_xy(small_ds)
    tuned, hist = port.fit(fx, fy, port.TrainConfig(
        learning_rate=1e-5, batch_size=32, max_epochs=3, patience=10),
        init=surrogate, device="cpu")
    assert tuned.feature_scaler is surrogate.feature_scaler
    assert tuned.target_scaler is surrogate.target_scaler
    assert len(hist["val_loss"]) <= 3
    assert tuned.model is not surrogate.model


def test_fit_returns_the_best_epoch():
    """Noise targets and a large step: the val loss rises after its best
    epoch, and the weights returned are that epoch's."""
    fx, fy = _rows(64, 9)
    cfg = port.TrainConfig(learning_rate=3e-2, batch_size=16, max_epochs=12,
                           patience=12, seed=3)
    s, hist = port.fit(fx, fy, cfg, device="cpu")
    best = int(np.argmin(hist["val_loss"]))
    assert best < len(hist["val_loss"]) - 1
    perm = np.random.default_rng(cfg.seed).permutation(64)
    val = perm[:max(1, int(64 * cfg.val_fraction))]
    x = torch.from_numpy(s.feature_scaler.transform(fx[val])
                         .astype(np.float32))
    y = torch.from_numpy(s.target_scaler.transform(fy[val])
                         .astype(np.float32))
    with torch.no_grad():
        loss = float(torch.mean((s.model(x) - y) ** 2))
    assert loss == pytest.approx(hist["val_loss"][best], rel=1e-6)
    assert loss != pytest.approx(hist["val_loss"][-1], rel=1e-3)


def _calibration(n, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(rng.normal(0.0, 1.0, s))
    return BatchCalibration(
        x=t(n, 13), params=t(n, 13), loss=t(n).abs(), model_prices=t(n, 15),
        iterations=torch.arange(n), n_evals=torch.arange(n) * 3,
        converged=torch.tensor([True, False] * (n // 2)),
        per_start_loss=t(n, 3), per_start_x=t(n, 3, 13))


def test_batch_calibration_checkpoint(tmp_path):
    out = _calibration(4)
    path = str(tmp_path / "calib.npz")
    port.save_batch_calibration(path, out, surface_ids=["a", "b", "c", "d"],
                                metadata={"note": "test"})
    assert json.loads(Path(path + ".meta.json").read_text()) == {
        "note": "test"}
    for back in (port.load_batch_calibration(path),
                 jckpt.load_batch_calibration(path[:-4])):
        assert set(back) == set(out._fields) | {"surface_ids"}
        for k, v in out._asdict().items():
            np.testing.assert_array_equal(back[k], v.numpy())
        assert list(back["surface_ids"]) == ["a", "b", "c", "d"]


def test_surrogate_state_checkpoint(tmp_path, small_ds):
    s = port.load_default_model()
    port.save_surrogate_state(str(tmp_path / "ckpt"), s)
    with np.load(tmp_path / "ckpt" / "scalers.npz") as z:
        assert set(z.files) == {"f_mean", "f_scale", "t_mean", "t_scale"}
    back = port.load_surrogate_state(str(tmp_path / "ckpt"))
    prices, spots = small_ds.market_prices[:16], small_ds.spots[:16]
    assert torch.equal(back.predict_x(prices, spots),
                       s.predict_x(prices, spots))


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def _fake_calibrate(n_bad):
    """calibrate_batch_mixed's stand-in for the pipeline's plumbing test:
    the truths as the calibrations, the first ``n_bad`` not converged."""
    def calibrate(spots, rate, strikes, mats, is_call, market, generator,
                  n_starts, device):
        n = spots.shape[0]
        ds = port.generate_dataset(torch.Generator().manual_seed(43),
                                   port.GeneratorConfig(n_samples=n),
                                   dtype=torch.float32, n_terms=128,
                                   device="cpu")
        params = ds.params.to(torch.float64)
        conv = torch.arange(n) >= n_bad
        return BatchCalibration(
            x=port.inverse_transform(params), params=params,
            loss=torch.full((n,), 1e-4, dtype=torch.float64),
            model_prices=market, iterations=torch.zeros(n, dtype=torch.long),
            n_evals=torch.zeros(n, dtype=torch.long), converged=conv,
            per_start_loss=torch.zeros(n, n_starts, dtype=torch.float64),
            per_start_x=torch.zeros(n, n_starts, 13, dtype=torch.float64))
    return calibrate


def test_pipeline_writes_jax_artefacts(tmp_path, monkeypatch):
    """The pipeline at a tiny size, its calibration replaced by the truths
    (the real calibration runs in the next test and on the card): the
    three artefacts carry the JAX pipeline's keys, and the kept rows are
    the converged ones."""
    monkeypatch.setattr(tpipe, "calibrate_batch_mixed", _fake_calibrate(3))
    res = tpipe.train_pipeline(str(tmp_path), n_pretrain=300, n_finetune=24,
                               min_keep=20, device="cpu")
    assert res.n_kept == 21
    assert set(res.stage_s) == {"generate", "calibrate", "pretrain",
                                "finetune"}
    hist = json.loads((tmp_path / "models" / "training_history.json")
                      .read_text())
    ref = json.loads((RESULTS / "models" / "training_history.json")
                     .read_text())
    assert _keys(hist) == _keys(ref)
    assert hist["provenance"]["device"] == "cpu"
    assert hist["provenance"]["finetune_converged"] == 21
    assert len(hist["finetune"]["val_loss"]) <= port.FINETUNE.max_epochs
    with open(tmp_path / "data" / "scalers.pkl", "rb") as f:
        assert set(pickle.load(f)) == {"feature_scaler", "target_scaler"}
    fs, ts = load_scalers(tmp_path / "data" / "scalers.pkl")
    assert fs.n_features_in_ == 11 and ts.n_features_in_ == 13
    j = jtrain.load_surrogate(tmp_path / "models" / "ffn_surrogate.pkl")
    prices = np.full((2, 15), 5.0) + np.arange(15)
    np.testing.assert_allclose(
        np.asarray(j.predict_x(prices, np.full(2, 100.0))),
        res.surrogate.predict_x(torch.tensor(prices),
                                torch.full((2,), 100.0)).numpy(),
        rtol=1e-5, atol=1e-6)
    calib = jckpt.load_batch_calibration(
        str(tmp_path / "data" / "finetune_calibrations"))
    assert calib["params"].shape == (24, 13)
    assert list(calib["surface_ids"]) == list(range(24))


def test_pipeline_calibrates_and_guards(tmp_path):
    """The real calibration on 4 surfaces on the CPU: it runs, its output
    is saved, and too few usable rows stop the pipeline before training."""
    with pytest.raises(RuntimeError, match="usable finetune calibrations"):
        tpipe.train_pipeline(str(tmp_path), n_pretrain=50, n_finetune=4,
                             min_keep=5, device="cpu")
    calib = port.load_batch_calibration(
        str(tmp_path / "data" / "finetune_calibrations.npz"))
    assert calib["model_prices"].shape == (4, 15)
    assert calib["per_start_x"].shape == (4, 3, 13)
    assert np.all(np.isfinite(calib["model_prices"]))
    meta = json.loads((tmp_path / "data" /
                       "finetune_calibrations.npz.meta.json").read_text())
    assert meta["n_finetune"] == 4 and meta["n_kept"] <= 4
    assert not os.path.exists(tmp_path / "models" / "ffn_surrogate.pkl")
