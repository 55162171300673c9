"""The port's driver entry points and scripts on the CPU.

  * ``tools/graft_entry.py``: ``entry()``'s forward pricer against the JAX
    package's ``__graft_entry__.entry()`` within 1e-4 relative (both
    float32 COS sums at N = 128, in other orders), and
    ``dryrun_multichip(1)`` on a one-rank gloo group (it raises when a
    solve misses the JAX dry run's convergence bar);
  * the twins of ``bench_scaling.py`` and of ``scripts/profile_search.py``,
    ``scripts/bench_raw_draws.py`` and ``scripts/make_results.py``, each
    run once at a tiny size: their JSON keys are those of the JAX drivers'
    lines and of the files in ``results/`` (``profile_search`` adds its six
    wall and busy numbers), and no default output path lies in
    ``<repo>/results``; the profiler window that ``profile_search``
    retakes when it lost records (``utils/timing.py::profile_complete``).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from option_pricing_ffn_lbfgs_tpu_torch.tools import (
    bench_raw_draws, bench_scaling, graft_entry, make_results,
    profile_search)
from option_pricing_ffn_lbfgs_tpu_torch.utils import timing

REPO = Path(__file__).resolve().parent.parent
RESULTS = REPO / "results"


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_entry_matches_jax():
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.dtype == torch.float32 and a.device.type == "cpu"
               for a in args)
    out = fn(*args).numpy()
    j_fn, j_args = jax_graft.entry()
    ref = np.asarray(j_fn(*j_args))
    assert out.shape == ref.shape == (15,)
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_dryrun_multichip_one_rank():
    graft_entry.dryrun_multichip(1, device_type="cpu")


def test_bench_scaling_twin(tmp_path):
    out = tmp_path / "scaling.json"
    rows = bench_scaling.main(["--batches", "2", "--sets", "1", "--starts",
                               "1", "--device", "cpu", "--out", str(out)])
    ref = _json(RESULTS / "scaling.json")
    mine = _json(out)
    assert set(mine) == set(ref)
    assert [(r["batch"], r["mode"]) for r in rows] == [(2, "f32"),
                                                       (2, "mixed")]
    for row in mine["results"]:
        assert set(row) == set(ref["results"][0])
        assert np.isfinite(row["surfaces_per_s"])
        assert row["mean_error_pct"] < 1.0


def test_profile_search_twin(tmp_path):
    out = tmp_path / "profile.json"
    rows = profile_search.main(["--batches", "2", "--k", "2", "--device",
                                "cpu", "--out", str(out)])
    jax_keys = {"batch", "lanes", "eval_ms_per_trip", "bookkeep_ms_per_trip",
                "full_solve_s", "winner_max_evals", "full_ms_per_eval",
                "eval_gflops"}
    added = {"eval_wall_ms_per_trip", "eval_busy_ms_per_trip",
             "bookkeep_wall_ms_per_trip", "bookkeep_busy_ms_per_trip",
             "open_ms_per_trip", "open_wall_ms_per_trip",
             "open_busy_ms_per_trip", "full_wall_ms_per_eval",
             "full_busy_ms_per_eval", "fused_host_ms_per_trip",
             "fused_wall_ms_per_trip", "fused_busy_ms_per_trip",
             "eval_kernels_per_trip", "bookkeep_kernels_per_trip",
             "open_kernels_per_trip", "full_kernels_per_eval",
             "fused_kernels_per_trip", "open_profile_windows",
             "fused_profile_windows"}
    (row,) = rows
    assert set(row) == jax_keys | added
    assert row["lanes"] == 6 and 0 < row["winner_max_evals"] <= 160
    # no device is traced on the CPU
    assert all(row[k] is None for k in added
               if "busy" in k or "kernels" in k or "windows" in k)
    written = _json(out)
    assert set(written) == {"device", "k", "n_terms", "results", "launches"}
    # the CPU runs the plain versions, which launch nothing
    assert written["launches"] and not any(written["launches"].values())


def test_profile_complete_retakes_incomplete_windows():
    calls, verdicts = [], iter([False, True])
    prof, out, n = timing.profile_complete(
        lambda: calls.append(1) or len(calls), lambda p: next(verdicts),
        device="cpu")
    assert (out, n, len(calls)) == (2, 2, 2)
    assert prof.key_averages() is not None
    # never complete: three windows, then the last one is returned
    prof, out, n = timing.profile_complete(lambda: calls.append(1),
                                           lambda p: False, device="cpu")
    assert (out, n, len(calls)) == (None, 3, 5)


def test_bench_raw_draws_twin(tmp_path):
    out = tmp_path / "raw.json"
    bench_raw_draws.main(["--n", "2", "--starts", "1", "--device", "cpu",
                          "--out", str(out)])
    ref, mine = _json(RESULTS / "raw_draws_bench.json"), _json(out)
    assert set(mine) == set(ref)
    assert set(mine["statistics"]) == set(ref["statistics"])
    assert len(mine["per_surface_error_pct"]) == 2
    assert mine["seed"] == 404
    spec = importlib.util.spec_from_file_location(
        "jax_bench_raw_draws", REPO / "scripts" / "bench_raw_draws.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    assert bench_raw_draws.RAW_RANGES == jax_script.RAW_RANGES


def test_make_results_twin(tmp_path):
    make_results.main(["--n-eval", "1", "--device", "cpu", "--out-dir",
                       str(tmp_path)])
    for name in ("lbfgs_actual_results.json", "hybrid_actual_results.json"):
        ref, mine = _json(RESULTS / name), _json(tmp_path / name)
        assert set(mine) == set(ref), name
    assert (tmp_path / "COMPARISON_TABLE.txt").read_text().strip()


@pytest.mark.parametrize("tool", [bench_scaling, profile_search,
                                  bench_raw_draws, make_results])
def test_default_outputs_outside_results(tool):
    """No default output path resolves into <repo>/results (from the repo
    root or from anywhere else)."""
    ap = tool.build_parser()
    for action in ap._actions:
        if action.dest in ("out", "out_dir") and action.default is not None:
            for cwd in (REPO, REPO / "tests"):
                path = (cwd / action.default).resolve()
                assert RESULTS.resolve() not in (path, *path.parents)
    if tool is bench_raw_draws:
        with pytest.raises(SystemExit):
            ap.parse_args([])          # --out is required
    else:
        args = ap.parse_args([])
        assert getattr(args, "out", None) is None or tool is make_results
    assert make_results.OUT_DIR == "compare_results"
