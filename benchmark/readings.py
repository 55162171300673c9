"""The readings a cell's limits are set from: the check's numbers for the
program and for its control, over many seeds, in one process::

    python3 -m benchmark.readings --workload <cell> --seeds 12 \\
        --calls <n> [--first-seed <s>]

For each seed the program runs ``--calls`` calls of the cell (the seed's
order of the pool, as a run's window takes it), then
the control (the configuration's ``control``: its lower-precision path)
the same calls; each side's outputs are judged as a run judges them. One
JSON line a (seed, side), then the largest program reading and the
smallest control reading of each number. The pool, the kernels and the
warm-up are made once, so the set-up is paid once. Runs on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import gen, harness

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=4_000_000_001)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    dev = harness.pick_device(cell["chips"], args.device)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    pool = gen.make_pool(traffic, traffic["batch"] * traffic["pool_batches"],
                         dev)
    ctx = config.prepare(dev, pool, traffic["pool_seed"])
    for fn in (config.calibrate, config.control):
        harness.drive(fn, ctx, pool, traffic["batch"], 0, float("inf"), dev,
                      stream=1, max_calls=traffic["warmup_calls"])
    worst = {"program": {}, "control": {}}
    for k in range(args.seeds):
        seed = args.first_seed + k
        for side, fn in (("program", config.calibrate),
                         ("control", config.control)):
            t0 = time.perf_counter()
            calls, outputs, _ = harness.drive(
                fn, ctx, pool, traffic["batch"], seed, float("inf"), dev,
                max_calls=args.calls)
            detail = {}
            _, failed, errors, values, missing = harness.evaluate(
                calls, outputs, pool, config, cell, seed, detail)
            line = {"seed": seed, "side": side, "failed": failed,
                    "missing": missing,
                    "err_pct_mean": float(np.mean(errors)) if errors.size
                    else None,
                    "seconds": time.perf_counter() - t0, **values,
                    "loss_gap_at": detail}
            print(json.dumps(line), flush=True)
            pick = max if side == "program" else min
            for name, v in values.items():
                w = worst[side]
                w[name] = v if name not in w else pick(w[name], v)
    print(json.dumps({"largest_program": worst["program"],
                      "smallest_control": worst["control"],
                      "device": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
