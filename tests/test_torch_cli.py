"""The port's command line and method comparison against the JAX package's.

All on the CPU (``--device cpu``: the kernels' plain versions), small:
  * ``demo`` prints the JAX demo's four prices and passes put-call parity
    (tolerances in the test);
  * ``generate`` writes 8 surfaces in both formats, which both packages
    load;
  * ``calibrate`` runs one generated surface at float32 and at ``--f64``;
  * ``run_comparison`` on one surface at N = 64 writes the three artefacts,
    whose JSON keys are those of the JAX package's ``results/*.json``;
  * ``train`` writes a surrogate both packages load; ``compare`` without
    ``--surrogate`` quick-trains one on its dataset, as the JAX CLI does
    (the comparison itself is replaced there: it is the test above);
  * ``--device cuda`` without a card is an error, not a CPU fallback.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu import cli as jcli
from option_pricing_ffn_lbfgs_tpu.data.synthetic import (
    load_dataset as jload_dataset)
from option_pricing_ffn_lbfgs_tpu.surrogate.train import (
    load_surrogate as jload_surrogate)
import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch import cli as tcli
from option_pricing_ffn_lbfgs_tpu_torch import compare as tcompare
from option_pricing_ffn_lbfgs_tpu_torch.compare import run_comparison
from option_pricing_ffn_lbfgs_tpu_torch.surrogate import train as ttrain

torch.set_num_threads(1)
RESULTS = Path(__file__).resolve().parent.parent / "results"
CPU = ["--device", "cpu"]


def _prices(text):
    return [float(v) for v in re.findall(
        r"^(?:call|put)\s.*?:\s+([0-9.]+)$", text, re.M)]


def test_demo_matches_jax(capsys):
    """Float32 demo prices against JAX's float32 demo at 8e-5 relative (the
    repo's float32 pricing bar, tests/test_torch_pricer.py): JAX's own
    float32 call is 1.6e-5 from the float64 price, so the two float32
    results cannot agree to 1e-5. The port's float32 prices are also held
    to 1e-5 of its float64 prices (``--f64 demo``, printed to 6 decimals),
    and the float64 prices of the two sides agree to the printed digits."""
    runs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        for f64 in ([], ["--f64"]):
            extra = CPU if name == "port" else []
            assert main([*f64, "demo", *extra]) == 0
            out = capsys.readouterr().out
            assert "[PASS]" in out
            runs[name, bool(f64)] = _prices(out)
    assert all(len(v) == 4 for v in runs.values())
    np.testing.assert_allclose(runs["port", False], runs["jax", False],
                               rtol=8e-5)
    np.testing.assert_allclose(runs["port", False], runs["port", True],
                               rtol=1e-5)
    np.testing.assert_allclose(runs["port", True], runs["jax", True],
                               rtol=1e-7)


def test_generate_and_calibrate(tmp_path, capsys):
    for suffix in (".pkl", ".npz"):
        path = str(tmp_path / f"d{suffix}")
        assert tcli.main(["generate", "--n-samples", "8", "--out", path,
                          *CPU]) == 0
        ds = port.load_dataset(path, device="cpu")
        assert ds.n_samples == 8 and ds.market_prices.shape == (8, 15)
        assert ds.market_prices.dtype == torch.float32
        assert jload_dataset(path).market_prices.shape == (8, 15)
    capsys.readouterr()
    for f64 in ([], ["--f64"]):
        assert tcli.main([*f64, "calibrate", "--data", str(tmp_path / "d.pkl"),
                          "--maxiter", "10", "--multi-start", "2", *CPU]) == 0
        res = json.loads(capsys.readouterr().out)
        assert res["success"] and np.isfinite(res["final_loss"])
        assert len(res["parameters"]) == 13


def test_cuda_default_without_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["demo"])


@pytest.mark.parametrize("argv", [["train"], ["train", "--device", "cuda"],
                                  ["compare"]])
def test_training_commands_need_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(argv)


def test_train_writes_a_loadable_surrogate(tmp_path, capsys):
    out = str(tmp_path / "x.pkl")
    assert tcli.main(["train", "--n-pretrain", "300", "--epochs", "3",
                      "--out", out, *CPU]) == 0
    assert "saved surrogate" in capsys.readouterr().out
    t = port.load_surrogate(out)
    j = jload_surrogate(out)
    ds = port.generate_dataset(torch.Generator().manual_seed(3),
                               port.GeneratorConfig(n_samples=4), n_terms=64,
                               device="cpu")
    x = t.predict_x(ds.market_prices, ds.spots)
    assert x.shape == (4, 13) and bool(torch.isfinite(x).all())
    np.testing.assert_allclose(
        np.asarray(j.predict_x(ds.market_prices.numpy(), ds.spots.numpy())),
        x.numpy(), rtol=1e-5, atol=1e-6)


def test_compare_quick_trains(tmp_path, monkeypatch, capsys):
    data = str(tmp_path / "d.npz")
    assert tcli.main(["generate", "--n-samples", "40", "--out", data,
                      *CPU]) == 0
    fits, seen = [], {}
    real_fit = ttrain.fit

    def fit(*args, **kwargs):
        fits.append((args[2], kwargs))
        return real_fit(*args, **kwargs)

    def comparison(ds, surrogate, n_eval, out_dir, device):
        seen.update(surrogate=surrogate, n=ds.n_samples, device=device)
        stats = {"mean_error": 0.0, "mean_time": 0.0}
        return {"ffn": stats, "lbfgs": {"statistics": stats},
                "hybrid": {"statistics": stats}}
    monkeypatch.setattr(ttrain, "fit", fit)
    monkeypatch.setattr(tcompare, "run_comparison", comparison)
    assert tcli.main(["compare", "--data", data, "--n-eval", "1",
                      "--out-dir", str(tmp_path), *CPU]) == 0
    assert "quick-training" in capsys.readouterr().out
    (config, kwargs), = fits
    assert config == port.TrainConfig(max_epochs=60, patience=20,
                                      batch_size=64)
    assert kwargs["device"] == torch.device("cpu")
    assert isinstance(seen["surrogate"], port.TrainedSurrogate)
    assert seen["n"] == 40 and seen["device"] == torch.device("cpu")


def test_compare_default_out_dir_is_not_results():
    """``compare``'s default ``--out-dir``, taken from the repository's
    root, must not be ``results/``: run_comparison writes three files that
    results/ holds as the JAX package's record (lbfgs_actual_results.json,
    hybrid_actual_results.json, COMPARISON_TABLE.txt)."""
    args = tcli.build_parser().parse_args(["compare"])
    out = (RESULTS.parent / args.out_dir).resolve()
    assert out != RESULTS.resolve() and RESULTS.resolve() not in out.parents
    assert not (out / "lbfgs_actual_results.json").exists()


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_comparison_artefacts(tmp_path):
    cfg = port.CalibrationConfig(
        pricer=port.PricerConfig(n_terms=64), search_maxeval=40,
        lbfgs=port.LBFGSConfig(maxiter=40))
    ds = port.generate_dataset(torch.Generator().manual_seed(0),
                               port.GeneratorConfig(n_samples=2), n_terms=64,
                               device="cpu")
    payload = run_comparison(ds, port.load_default_model(), n_eval=1,
                             config=cfg, n_starts=2, out_dir=str(tmp_path))
    for name in ("lbfgs_actual_results.json", "hybrid_actual_results.json"):
        ours = json.loads((tmp_path / name).read_text())
        ref = json.loads((RESULTS / name).read_text())
        assert _keys(ours) == _keys(ref), name
        assert len(ours["pricing_errors"]) == 1
    table = (tmp_path / "COMPARISON_TABLE.txt").read_text()
    assert table.splitlines()[:5] == (
        RESULTS / "COMPARISON_TABLE.txt").read_text().splitlines()[:5]
    assert payload["hybrid"]["statistics"]["mean_error"] \
        < payload["ffn"]["mean_error"]
