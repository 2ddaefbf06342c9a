#!/usr/bin/env python3
"""The port's smoke on one NVIDIA GPU: every card test, each main path's
kernel launches, and each kernel's time beside its plain version's.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 chip_smoke.py

1. Runs ``python -m pytest tests/test_torch_cuda.py
   tests/test_torch_cuda_paths.py -q --noconftest`` (the suite's conftest
   imports JAX, which the port never needs); the first test builds the
   fourteen kernels. Any failure ends the smoke with exit code 1. It runs
   in a process of its own: after the card tests, torch.profiler in the
   same process loses the device records of half the timer's items.
2. With every launch counter at 0, runs each main path once through the
   public API on its BASELINE operator (`bench.kernels.main_paths`, the
   operators the card tests build) on a fresh view (a replayed CUDA graph
   runs no wrapper), and prints ``{"launches": {path: {kernel: n}}}``.
   A path other than ``scatter`` (``index_add_``) that launches no
   hand-written kernel fails the smoke.
3. Times every item with `bench.kernels.measure`, prints its rows (one
   JSON line each, as ``bench/kernels.py`` does), then ``{"kernels":
   [...]}``: for each of the fourteen kernels its first item that has a
   library yardstick (else its first item), with ``ms`` (CUDA-event
   minimum), ``plain_ms`` (its plain PyTorch version, timed in this run),
   ``queued_ms``, ``device_ms``, ``bound_ms``, ``library_ms`` (the
   yardstick's device time) and the launches of each path of step 2.

Last it checks that neither JAX nor the JAX package was imported and
prints ``{"ok": true, ...}``. Without a CUDA device it exits 2.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CARD_TESTS = ["tests/test_torch_cuda.py", "tests/test_torch_cuda_paths.py"]
# path: (operator, matrix, products at N=128, or spmm_dd at N)
PATHS = {
    "mono": ("opH", "headline", ("matmat", "matvec", "normal_matmat")),
    "ell": ("opA", "A", ("matmat", "matvec", "normal_matmat")),
    "ell_segmented": ("opB", "B", ("matmat", "matvec")),
    "smem": ("opAsmem", "A", ("matmat", "matvec")),
    "hybrid": ("opE", "E", ("matmat", "matvec", "normal_matmat")),
    "tiles": ("opT", "E", ("matmat", "matvec", "normal_matmat")),
    "tiles_degree": ("opBd", "B", ("matmat", "matvec")),
    "rmat": ("opR", "R", ("matmat", "matvec")),
    "fp64_config1": ("A1", "1", ("spmm_dd", 1)),
    "fp64_config2": ("A2d", "2d", ("spmm_dd", 1)),
    "fp64_unit": ("opBu", "B", ("spmm_dd", 32)),
    "scatter": ("opCsr", "1", ("matvec",)),
}
# the launch counter's name -> the prefix of its items in bench/kernels.py
ITEMS = {"ell_bucket_dd": "dd_unit ", "ell_bucket_dd_valued": "dd_valued "}


def path_launches(ft, get, counters):
    """{path: {kernel: launches}} of one run of each path's products."""
    from fastsparse_torch.ops import ell_ops

    g = torch.Generator("cuda").manual_seed(0)
    out = {}
    for path, (op_key, m_key, calls) in PATHS.items():
        op, m = get(op_key), get(m_key)
        if isinstance(op, ft.SparseOperator):
            op = dataclasses.replace(op)
        for c in counters:
            c.reset_launches()
        ell_ops.USE_SMEM_PATH = path == "smem"
        try:
            if calls[0] == "spmm_dd":
                ft.spmm_dd(op, torch.randn((m.shape[1], calls[1]),
                                           dtype=torch.float64, device="cuda",
                                           generator=g))
            else:
                X = torch.randn((m.shape[1], 128), device="cuda", generator=g,
                                dtype=getattr(torch, str(m.dtype)))
                for name in calls:
                    if name == "matvec":
                        op.matvec(X[:, 0].contiguous())
                    elif name == "normal_matmat":
                        op.normal_matmat(X, reg=0.1)
                    else:
                        op.matmat(X)
            torch.cuda.synchronize()
        finally:
            ell_ops.USE_SMEM_PATH = False
        out[path] = {k: v for c in counters for k, v in c.launches.items()
                     if v}
    return out


def kernel_entries(rows, launches, counters):
    """The ``kernels`` line: each kernel's representative row."""
    by_item = {r["item"]: r for r in rows}
    entries = []
    for c in counters:
        for name in c.launches:
            prefix = ITEMS.get(name, name + " ")
            mine = [r for r in rows if r["item"].startswith(prefix)]
            if not mine:
                continue
            r = next((r for r in mine if "library" in r), mine[0])
            lib = by_item.get(r.get("library"), {})
            entries.append({
                "name": name, "item": r["item"], "ms": r["event_min_ms"],
                "plain_ms": r["plain_ms"], "queued_ms": r["queued_ms"],
                "device_ms": r["device_ms"], "bound_ms": r.get("bound_ms"),
                "library": r.get("library"),
                "library_ms": lib.get("device_ms"),
                "launches": {p: n[name] for p, n in launches.items()
                             if name in n}})
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import fastsparse_torch as ft
    from fastsparse_torch.bench import kernels
    from fastsparse_torch.ops.kernels import assemble, bsr_spmm, bsr_tiles
    from fastsparse_torch.ops.kernels import ell_dd, ell_spmm

    print(kernels.card_line(), flush=True)
    rc = subprocess.run([sys.executable, "-m", "pytest", *CARD_TESTS, "-q",
                         "--noconftest", "-p", "no:cacheprovider"],
                        cwd=ROOT).returncode
    if rc != 0:
        print(f"chip_smoke: card tests failed (pytest exit {rc})",
              file=sys.stderr)
        return 1

    counters = (bsr_spmm, bsr_tiles, ell_spmm, ell_dd, assemble)
    get = kernels.main_paths(ft)
    launches = path_launches(ft, get, counters)
    print(json.dumps({"launches": launches}), flush=True)
    idle = [p for p, n in launches.items() if not n and p != "scatter"]
    if idle:
        print(f"chip_smoke: no hand-written kernel launched on {idle}",
              file=sys.stderr)
        return 1

    rows = kernels.measure(ft, get=get, root=ROOT)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"kernels": kernel_entries(rows, launches, counters)}),
          flush=True)
    if "jax" in sys.modules or any(k == "fastsparse"
                                   or k.startswith("fastsparse.")
                                   for k in sys.modules):
        print("chip_smoke: JAX or the JAX package was imported",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
