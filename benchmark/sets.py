"""Run a cell several times, each run a fresh process, and print the
spread of each metric.

    python3 benchmark/sets.py --workload <cell> --seeds 11,12,13 --seconds 20 \
        [--trace 0|1] [--out FILE]

Each run is ``benchmark/run.py`` as the checker calls it, one after
another on this machine's card. The result lines go to ``--out`` (JSON
lines, with each run's seed, exit code and wall seconds); the summary gives
per metric the values, the median and the spread: the distance between
the first and third quartiles (``statistics.quantiles(values, n=4)``) as a
share of the median, over all runs and over all but the run farthest from
the median. A bound on an end-to-end metric is set at about five times the
widest spread over two such sets, and at least twice the mean of the two
sets' spreads without their farthest runs.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    """(median, interquartile range over the median)."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q = statistics.quantiles(values, n=4)
    return med, (q[2] - q[0]) / abs(med)


def spread_but_farthest(values):
    """The spread of the runs left when the one farthest from the median
    is left out (how a bound's tightness is judged, set by set)."""
    med = statistics.median(values)
    rest = sorted(values, key=lambda v: abs(v - med))[:-1]
    return spread(rest)[1] if len(rest) > 1 else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="20")
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for seed in args.seeds.split(","):
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", args.workload,
             "--seed", seed, "--seconds", args.seconds, "--trace",
             args.trace], cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t
        lines = r.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        runs.append({"seed": int(seed), "rc": r.returncode, "wall_s": wall,
                     "result": res,
                     "info": [ln for ln in lines if ln.startswith("#")],
                     "stderr_tail": r.stderr[-1500:]})
        short = None if res is None else {
            "correct": res["correct"], "attempted": res["attempted"],
            **{k: v["value"] for k, v in res["metrics"].items()},
            **{k: v["value"] for k, v in res.get("checks", {}).items()}}
        print(json.dumps({"seed": int(seed), "rc": r.returncode,
                          "wall_s": round(wall, 3), "run": short}),
              flush=True)
        if res is None:
            print(r.stderr[-3000:], file=sys.stderr, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for run in runs:
                f.write(json.dumps(dict(run, workload=args.workload)) + "\n")
    ok = [r["result"] for r in runs if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    for n in names:
        vals = [r["metrics"][n]["value"] for r in ok if n in r["metrics"]]
        med, sp = spread(vals)
        print(json.dumps({"metric": n, "median": med, "spread": sp,
                          "spread_but_farthest": spread_but_farthest(vals),
                          "values": vals}), flush=True)
    return 0 if len(ok) == len(runs) and all(r["correct"] for r in ok) else 1


if __name__ == "__main__":
    sys.exit(main())
