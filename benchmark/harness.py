"""The benchmark's harness: finds a cell's pieces by name and runs it.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under this folder, found by
the name ``BENCHMARK.json`` (at the root of the checkout) gives it:

  * ``configs/<config>.py``: the configuration (``SOURCE``, ``SETTINGS``,
    ``ASSUMED``, ``KERNEL_TERMS``, ``CHECK_PRICER``,
    ``PER_START_POLISHED``) and its calls into the program
    (``prepare(device, pool, seed)``, ``calibrate(ctx, batch)``,
    ``control(ctx, batch)``);
  * ``traffic/<traffic>.json``: the parameters ``gen.py`` makes the
    inputs from, and the calls' shape: ``batch`` (surfaces a call),
    ``pool_batches`` (the pool holds that many batches) and
    ``warmup_calls``;
  * ``workloads/<cell>.json``: the check's ``sample`` (surfaces it
    reprices) and ``limits`` (of its numbers);
  * ``metrics/<metric>.py``: a metric's reader, ``read(ctx)``, which
    returns a number, or None when it finds nothing to read (the metric
    is then left out of the line). End-to-end metrics are read in a run
    with ``--trace 0``, per-layer ones in a run with ``--trace 1``.

A run: the pool of surfaces and their truths, made from the traffic
file on the card by the reference pricer, and the configuration's
starts for each (drawn once from the pool's seed, so that a surface is
the same problem in every run and every call); ``warmup_calls`` calls at the
cell's shape (the first builds or loads the program's kernels); then a
closed loop of one client for ``--seconds`` and on to the end of that
pass over the pool: each call on the next batch of the seed's order of
the pool, the next sent once the last one's outputs are on the host;
then the check, and one result line.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, gen, trace as trace_mod

PROGRAM = "option_pricing_ffn_lbfgs_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "option_pricing_ffn_lbfgs_tpu")
OUTPUT_KEYS = ("x", "params", "loss", "model_prices", "per_start_x",
               "per_start_loss")


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """The benchmark rooted at ``root`` (the folder that holds
    ``BENCHMARK.json`` and ``benchmark/``)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                spec = json.loads(
                    (self.dir / "workloads" / f"{name}.json").read_text())
                return {**spec, **w}
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def config(self, name: str) -> ModuleType:
        return _load_module(self.dir / "configs" / f"{name}.py",
                            f"benchmark_config_{name}")

    @staticmethod
    def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return metric.get("moves", metric["name"]) in reported

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        reported = [m["name"] for m in self.end_to_end(cell)]
        return [m for m in self.manifest["per_layer"]
                if self._applies(m, cell, reported)]

    def reader(self, metric: str) -> Callable:
        return _load_module(self.dir / "metrics" / f"{metric}.py",
                            f"benchmark_metric_{metric}").read


def launch_counters() -> Callable[[], Dict[str, int]]:
    """A reader of every launch counter of the program (``LAUNCHES`` of
    each loaded module), by ``<module>.<key>``; the modules are looked up
    once, so a read costs microseconds."""
    found = [(name.rsplit(".", 1)[-1], module.LAUNCHES)
             for name, module in list(sys.modules.items())
             if name.startswith(PROGRAM + ".") and module is not None
             and isinstance(getattr(module, "LAUNCHES", None), dict)]
    return lambda: {f"{tail}.{k}": int(v) for tail, counts in found
                    for k, v in counts.items()}


def wave_lanes() -> list:
    """The (live, padded) lanes of each compacted wave of the program's
    last calibrate_batch_mixed call."""
    module = sys.modules.get(PROGRAM + ".calibration.calibrator")
    return list(getattr(module, "WAVE_LANES", []) or [])


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def to_host(out: dict) -> Dict[str, np.ndarray]:
    return {k: out[k].detach().to("cpu", torch.float64).numpy()
            for k in OUTPUT_KEYS}


@dataclasses.dataclass
class Call:
    """One timed call: its host seconds, its surfaces, the program's
    launch counts and waves it made."""
    seconds: float
    idx: np.ndarray
    launches: Dict[str, int]
    waves: list
    rows_ok: bool


def pick_device(chips: int, device) -> torch.device:
    """``device`` where given, else the first card, after making sure
    the machine holds the ``chips`` cards the cell asks for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"this cell needs {chips} CUDA device(s); "
                         f"found {found}")
    return torch.device("cuda", 0)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def drive(fn, ctx, pool, batch_size, seed, seconds, dev, stream: int = 0,
          max_calls: Optional[int] = None):
    """The closed loop: calls on the seed's batches until ``seconds`` have
    passed and the last call ended a pass over the pool (or until
    ``max_calls`` were made), so that every surface of the pool was
    calibrated equally often. A call is timed from its start until its
    outputs are on the host. Returns (calls, host outputs, the window's
    seconds)."""
    per_pass = pool.size // batch_size
    order = gen.batches(seed, pool.size, batch_size, stream)
    launch_counts = launch_counters()
    calls, outputs = [], []
    synchronize(dev)
    start = time.perf_counter()
    while True:
        idx = next(order)
        batch = pool.batch(idx)
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.call"):
            with torch.profiler.record_function("bench.entry"):
                out = fn(ctx, batch)
            with torch.profiler.record_function("bench.read"):
                host = to_host(out)
        t1 = time.perf_counter()
        del out
        after = launch_counts()
        rows_ok = all(host[k].shape[0] == idx.size for k in OUTPUT_KEYS)
        calls.append(Call(t1 - t0, idx,
                          {k: after[k] - before.get(k, 0) for k in after},
                          wave_lanes(), rows_ok))
        outputs.append(host)
        if (t1 - start >= seconds and len(calls) % per_pass == 0
                or len(calls) == max_calls):
            return calls, outputs, t1 - start


def device_info(dev: torch.device, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def evaluate(calls: List[Call], outputs, pool, config, cell, seed,
             detail: dict = None):
    """(attempted, failed, each finite surface's error %, the check's
    numbers, rows missing)."""
    good = [i for i, c in enumerate(calls) if c.rows_ok]
    missing = sum(c.idx.size for c in calls if not c.rows_ok)
    attempted = sum(c.idx.size for c in calls)
    if not good:
        return attempted, attempted, np.zeros(0), {}, missing
    stacked = check.stack([outputs[i] for i in good])
    idx = np.concatenate([calls[i].idx for i in good])
    finite = (np.isfinite(stacked["loss"])
              & np.isfinite(stacked["model_prices"]).all(-1))
    failed = missing + int((~finite).sum())
    err = check.surface_errors_pct(stacked["model_prices"][finite],
                                   pool.truth_host[idx[finite]])
    values = check.numbers(stacked, idx, pool, config.CHECK_PRICER,
                           config.PER_START_POLISHED, seed, cell["sample"],
                           detail)
    return attempted, failed, err, values, missing


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             traced: bool, t_start: float, device=None,
             entry: Optional[Callable] = None) -> dict:
    """One run of the cell ``name``; returns the result line's object.
    ``device`` (default: the card) and ``entry`` (default: the
    configuration's ``calibrate``) are for rehearsals and the check's own
    tests."""
    cell = bench.cell(name)
    dev = pick_device(cell["chips"], device)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    pool = gen.make_pool(traffic, traffic["batch"] * traffic["pool_batches"],
                         dev)
    ctx = config.prepare(dev, pool, traffic["pool_seed"])
    fn = entry or config.calibrate
    if traffic["warmup_calls"]:
        drive(fn, ctx, pool, traffic["batch"], seed, float("inf"), dev,
              stream=1, max_calls=traffic["warmup_calls"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    synchronize(dev)
    setup_s = time.perf_counter() - t_start

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        calls, outputs, window_s = drive(fn, ctx, pool, traffic["batch"],
                                         seed, seconds, dev)
    finally:
        if prof is not None:
            synchronize(dev)
            prof.__exit__(None, None, None)
    info = device_info(dev, cell["chips"])
    del ctx
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    attempted, failed, errors, values, missing = evaluate(
        calls, outputs, pool, config, cell, seed)
    values["rows_missing"] = missing
    correct, shown = check.judge(values, {"rows_missing": 0,
                                          **cell["limits"]})
    rctx = SimpleNamespace(calls=calls, window_s=window_s, setup_s=setup_s,
                           calibrated=attempted - failed, errors=errors,
                           cell=cell, traffic=traffic, config=config,
                           device=info, trace=None)
    extra = {}
    if traced:
        rctx.trace = trace_mod.read(prof)
        info["busy_s"] = rctx.trace.busy_s
        info["window_s"] = rctx.trace.window_s
        extra["breakdown"] = trace_mod.breakdown(rctx.trace)
    wanted = bench.per_layer(name) if traced else bench.end_to_end(name)
    metrics = {}
    for m in wanted:
        value = bench.reader(m["name"])(rctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": info, **extra, "checks": shown}
