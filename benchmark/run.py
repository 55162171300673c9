"""Run one cell of the benchmark and print its result line::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for. With ``--trace 0`` the line's metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` window over the whole measured window. The last lines
on standard error, and the line's last key ``checks``, give each number
the check compared beside its limit. Exits 2 without printing a result
when the machine lacks the card(s), and 3 when the process has loaded
JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness
    bench = harness.Bench(ROOT)
    try:
        result = harness.run_cell(bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace), T_START)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
