"""The check that decides ``correct``, driven through the rest of a run on
the CPU at a tiny size (the harness's look for a card skipped): sound
runs of each configuration pass; its control (the program's float32 path
with no float64 polish) and each fault the cells can have fail.

Faults, each planted under the configuration's timed call: a step that
returns its state unchanged (the starts come back as the answer, priced
and scored honestly); half of the batch left out (the first half
calibrated, its rows returned for the second half too); an answer
altered where it is produced (one model price off by 1e-4). The cells
run on one card, so no exchange between cards can be left out."""
import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import option_pricing_ffn_lbfgs_tpu_torch as port
from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["pure-b1000-capped", "hybrid-b1000"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The benchmark with every traffic mix cut to one call of 2
    surfaces, and every cell's own limits."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    for path in (root / "benchmark/traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(batch=2, pool_batches=1, warmup_calls=0)
        path.write_text(json.dumps(traffic))
    return harness.Bench(root)


def run(bench, cell, entry=None):
    return harness.run_cell(bench, cell, 2 ** 31 + 99, 0.0, False,
                            time.perf_counter(), device="cpu", entry=entry)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    """Every gap within the cell's limit. ``err_median_pct``'s limit is
    set for the median over the cell's pool of 16,000 surfaces, which two
    surfaces do not stand for: here it is only required to be finite."""
    result = run(bench, cell)
    checks = dict(result["checks"])
    assert np.isfinite(checks.pop("err_median_pct")["value"])
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    config = bench.config(bench.cell(cell)["config"])
    assert not run(bench, cell, config.control)["correct"]


def unchanged(ctx, batch):
    """The starts returned as the answer: each start priced and scored
    at the polish's settings, the best one the winner."""
    f64 = torch.float64
    cfg = ctx["config"]
    spots, strikes, mats = batch["spots"], batch["strikes"], \
        batch["maturities"]
    calls, market = batch["is_call"], batch["market"]
    x = ctx["starts"][batch["idx"]].to(f64)
    b, s = x.shape[:2]
    rep = lambda a: a.repeat_interleave(s, 0)
    params = port.transform(x.reshape(b * s, 13))
    pricer = port.PricerConfig(n_terms=cfg.polish_n_terms)
    model = port.price_surfaces(params, rep(spots), batch["rate"],
                                rep(strikes), rep(mats), rep(calls),
                                n_terms=pricer.n_terms)
    loss = port.surface_loss(port.DHParams.from_vector(params), rep(spots),
                             batch["rate"], rep(strikes), rep(mats),
                             rep(calls), rep(market),
                             port.CalibrationConfig(pricer=pricer))
    loss = loss.reshape(b, s)
    win = loss.argmin(-1)
    pick = lambda a: a.reshape(b, s, *a.shape[1:])[torch.arange(b), win]
    return {"x": pick(x.reshape(b * s, 13)), "params": pick(params),
            "loss": pick(loss.reshape(-1)), "model_prices": pick(model),
            "per_start_x": x, "per_start_loss": loss}


def half_left_out(calibrate):
    def fault(ctx, batch):
        half = {k: v[:1] if torch.is_tensor(v) else v
                for k, v in batch.items()}
        out = calibrate(ctx, half)
        return {k: v.repeat(2, *[1] * (v.dim() - 1)) if torch.is_tensor(v)
                else v for k, v in out.items()}
    return fault


def altered(calibrate):
    def fault(ctx, batch):
        out = calibrate(ctx, batch)
        out["model_prices"] = out["model_prices"].clone()
        out["model_prices"][0, 0] *= 1.0 + 1e-4
        return out
    return fault


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out",
                                   "altered"])
def test_faults_are_not_correct(bench, fault):
    cell = "pure-b1000-capped"
    config = bench.config(bench.cell(cell)["config"])
    entry = {"unchanged": unchanged,
             "half_left_out": half_left_out(config.calibrate),
             "altered": altered(config.calibrate)}[fault]
    result = run(bench, cell, entry)
    assert not result["correct"], result["checks"]
