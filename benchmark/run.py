"""Run one cell of the benchmark of ``fastsparse_torch`` on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, configurations, traffic mixes and
metrics are named in ``BENCHMARK.json``; each lives in a file of its own
under ``benchmark/`` (see ``benchmark/lib/spec.py``). The first lines
printed (``#``) give the card's name, power limit, clocks and temperature,
the matrix, the layout the program built for it and the kernel launches
of a step. The last line of standard output is the result's JSON; the last
lines of standard error give each compared number beside its limit. With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from torch.profiler sessions
inside the window.

Without a CUDA device, or with fewer cards than the cell asks for, it
exits 3 and prints no result.
"""
from __future__ import annotations

import time

T_ANCHOR = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from lib.card import process_age_s  # noqa: E402

AGE0 = process_age_s()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from lib.spec import load_spec

    spec = load_spec()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3

    from lib import harness

    harness.card_banner()
    result, lines = harness.run_cell(
        spec, args.workload, args.seed, args.seconds, bool(args.trace),
        t_anchor=T_ANCHOR, age0=AGE0,
    )
    harness.card_banner()
    harness.print_result(result, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
