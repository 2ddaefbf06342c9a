"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 21,22,23 [--faults solve_short,... --fault-seeds
        31,32,33] [--seconds 3] [--out FILE]

For each of ``--seeds`` it runs the cell as a run does (its matrix and
operands from the seed, the program's operator, a short window at the
cell's own load, the comparison of the kept outputs with the float64
reference) and prints each compared number: the lower readings. For each
of ``--control-seeds`` it runs the same with the program replaced by the
control, the reference computed with TF32 operands (`lib.reference`):
the upper readings. For each of ``--faults`` (`lib.faults`) and each of
``--fault-seeds`` it runs the program with that fault planted under the
timed path: the readings that a number with no upper reading from the
control is held against. A limit lies between the largest lower reading and
the smallest upper one, nearer the lower. The benchmark's own runs never
run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    from lib import faults, harness
    from lib.spec import load_spec

    spec = load_spec()
    harness.card_banner()
    rows = []
    every = {**faults.FAULTS, **faults.SOLVE_FAULTS}
    plan = [(int(s), "program") for s in args.seeds.split(",") if s]
    plan += [(int(s), "control") for s in args.control_seeds.split(",") if s]
    plan += [(int(s), f"fault:{f}") for f in args.faults.split(",") if f
             for s in args.fault_seeds.split(",") if s]
    for seed, side in plan:
        torch.cuda.reset_peak_memory_stats()
        fault = every[side[6:]] if side.startswith("fault:") else None
        result, _ = harness.run_cell(spec, args.workload, seed, args.seconds,
                                     False, control=side == "control",
                                     wrap_step=fault)
        row = {"workload": args.workload, "seed": seed, "side": side,
               "correct": result["correct"],
               "attempted": result["attempted"],
               "checks": {k: v["value"] for k, v in result["checks"].items()},
               "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    for side in dict.fromkeys(r["side"] for r in rows):
        got = [r for r in rows if r["side"] == side]
        for k in got[0]["checks"]:
            v = [r["checks"][k] for r in got]
            print(json.dumps({"side": side, "check": k, "min": min(v),
                              "max": max(v), "n": len(v)}), flush=True)
    harness.card_banner()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
