"""A new cell, traffic mix and per-layer metric are each picked up from
a new file alone; and the metric arithmetic on synthetic data."""
import hashlib
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, stats, trace
from benchmark.workcount import cos_vg, peaks

ROOT = Path(__file__).resolve().parents[2]


def _hashes(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    return tmp_path


def test_new_cell_traffic_and_metric_from_new_files(copy):
    before = _hashes(copy)
    traffic = json.loads(
        (copy / "benchmark/traffic/capped-b1000.json").read_text())
    traffic.update(kind="ar1", ar_alpha=0.5, spot_drift=0.0,
                   spot_vol=0.02, batch=2, pool_batches=2, warmup_calls=1,
                   pool_seed=11)
    (copy / "benchmark/traffic/tiny-ar1.json").write_text(
        json.dumps(traffic))
    (copy / "benchmark/workloads/tiny-mixed.json").write_text(json.dumps(
        {"sample": 4, "limits": {"params_gap": 1e-9}}))
    (copy / "benchmark/metrics/calls_made.py").write_text(
        "def read(ctx):\n    return len(ctx.calls)\n")
    manifest = json.loads((copy / "BENCHMARK.json").read_text())
    manifest["workloads"].append(
        {"name": "tiny-mixed", "config": "dh13-mixed",
         "traffic": "tiny-ar1", "chips": 1, "why": "a test"})
    manifest["per_layer"].append(
        {"name": "calls_made", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "entry",
         "moves": "surfaces_per_s", "workloads": ["tiny-mixed"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = _hashes(copy)
    assert {k: after[k] for k in before} == before      # nothing edited

    bench = harness.Bench(copy)
    assert bench.cell("tiny-mixed")["traffic"] == "tiny-ar1"
    assert bench.traffic("tiny-ar1")["ar_alpha"] == 0.5
    assert "calls_made" in [m["name"] for m in bench.per_layer("tiny-mixed")]
    assert bench.reader("calls_made")(SimpleNamespace(calls=[1, 2])) == 2
    # The new cell runs on the new traffic, on the CPU.
    result = harness.run_cell(bench, "tiny-mixed", 2 ** 31 + 7, 0.01,
                              False, time.perf_counter(), device="cpu")
    assert result["attempted"] == 4 and result["correct"]   # one pass
    assert list(result["checks"]) == ["rows_missing", "params_gap"]
    assert set(result["metrics"]) == {"surfaces_per_s", "err_pct_mean",
                                      "setup_s"}
    assert result["metrics"]["err_pct_mean"]["value"] < 0.1


def test_per_layer_metrics_apply_where_listed():
    bench = harness.Bench(ROOT)
    names = lambda cell: {m["name"] for m in bench.per_layer(cell)}
    assert "dispatch.device_ops_per_call" in names("pure-b5-bench")
    assert "dispatch.device_ops_per_call" not in names("pure-b1000-capped")
    assert "polish.wave_fill_pct" not in names("hybrid-b1000")
    assert {m["name"] for m in bench.end_to_end("hybrid-b1000")} == {
        "surfaces_per_s", "err_pct_mean", "setup_s"}


def test_percentile_over_all_calls():
    values = list(range(1, 101))          # 1 .. 100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values[::-1], 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(range(1, 21)), 95) == 19


def test_rate_over_the_window():
    assert stats.rate(3000, 1.5) == 2000
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_idle_share_from_overlapping_intervals():
    ops = [(0.0, 2.0), (1.0, 3.0), (2.5, 4.0), (6.0, 7.0), (9.5, 12.0)]
    assert stats.busy(ops, 0.0, 10.0) == pytest.approx(5.5)
    assert stats.idle_pct(ops, 0.0, 10.0) == pytest.approx(45.0)
    assert stats.gaps(ops, 0.0, 10.0) == [(4.0, 6.0), (7.0, 9.5)]
    assert stats.merge(ops) == [(0.0, 4.0), (6.0, 7.0), (9.5, 12.0)]


def _synthetic_trace():
    """Two calls of 1000 surfaces x 3 lanes: the first with two K2
    launches, a gather, then one K3 (stage A); the second with one K2,
    one K3 of stage A, a gather, then one K3 of a 64-lane wave; copies
    and host work in the gaps."""
    op = lambda a, b, name, kind="kernel": trace.DeviceOp(a, b, name, kind)
    device = [op(0.10, 0.30, "cos_vg_kernel<float>"),
              op(0.30, 0.50, "cos_vg_kernel<float>"),
              op(0.52, 0.55, "index_elementwise_kernel"),
              op(0.60, 0.90, "cos_vg_kernel<float>"),
              op(0.95, 1.00, "Memcpy DtoH", kind="memcpy"),
              op(1.20, 1.40, "cos_vg_kernel<float>"),
              op(1.41, 1.44, "cos_vg_kernel<float>"),
              op(1.45, 1.46, "Memcpy DtoH", kind="memcpy"),
              op(1.47, 1.48, "index_elementwise_kernel"),
              op(1.50, 1.60, "cos_vg_kernel<float>")]
    spans = [(0.0, 1.0, "bench.call"), (0.0, 0.9, "bench.entry"),
             (1.15, 2.0, "bench.call"), (1.15, 1.6, "bench.entry")]
    host = [(0.55, 0.6, "aten::item"), (1.6, 2.0, "cudaStreamSynchronize")]
    return trace.Trace(device=device, host=host, spans=spans,
                       window=(0.0, 2.0))


def test_trace_breakdown_and_attribution():
    tr = _synthetic_trace()
    assert tr.busy_s == pytest.approx(1.13)
    per = trace.per_call(tr, "cos_vg_kernel")
    assert [len(p) for p in per] == [3, 3]
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["cos_vg_kernel<float>",
                                  pytest.approx(1.03)]
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    assert gaps["bench.entry: aten::item"] == pytest.approx(0.05)
    assert gaps["bench.call: cudaStreamSynchronize"] == pytest.approx(0.4)
    assert gaps["between calls: python"] == pytest.approx(0.2)
    assert trace.short_name("void (anonymous namespace)::cos_vg_kernel"
                            "<float>(float const*, int)") == \
        "cos_vg_kernel<float>"


def test_roofline_reader_on_a_synthetic_trace():
    bench = harness.Bench(ROOT)
    tr = _synthetic_trace()
    call = lambda k2, k3, waves: harness.Call(
        0.5, np.arange(1000), {"loss_kernel.cos_vg_loss": k2,
                               "loss_kernel.cos_vg_jac": k3}, waves, True)
    kind = "NVIDIA H100 80GB HBM3"
    ctx = SimpleNamespace(trace=tr, calls=[call(2, 1, []),
                                           call(1, 2, [(40, 64)])],
                          config=SimpleNamespace(
                              KERNEL_TERMS={"loss": 128, "jac": 64},
                              LANES_PER_SURFACE={"loss": 3, "jac": 3}),
                          traffic=bench.traffic("capped-b1000"),
                          device={"kind": kind})
    read = bench.reader("cos_vg_roofline")
    least = lambda lanes, n, mode: peaks.least_seconds(
        *cos_vg.launch_work(lanes, n, mode).values(), kind=kind)
    want = (3 * least(3000, 128, "loss") + 2 * least(3000, 64, "jac")
            + least(64, 64, "jac")) / 1.03
    assert read(ctx) == pytest.approx(100 * want)
    # A call whose traced launches or runs miss the counts is left out,
    # work and time alike.
    ctx.calls[0] = call(3, 1, [])
    want = (least(3000, 128, "loss") + least(3000, 64, "jac")
            + least(64, 64, "jac")) / 0.33
    assert read(ctx) == pytest.approx(100 * want)
    ctx.calls[1] = call(1, 2, [])
    assert read(ctx) is None
