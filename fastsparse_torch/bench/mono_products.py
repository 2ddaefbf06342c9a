"""The headline's mono products and their device busy time on one card.

    python3 fastsparse_torch/bench/mono_products.py [--root DIR]

The products are the banded 50,000² 0/1 headline (bandwidth 512, density
0.39, seed 4) through ``operator(m, format="bsr", transpose=True)``:
matmat N=128, matvec (SpMV) and matmat N=32; and ``normal_matmat(X,
reg=0.1)`` on the 12,288² banded matrix (density 0.35) at N=128.
``chip_smoke.py`` drives the same set (`mono_setup`) and reads device time
through the same helpers (`device_us`, `device_busy_ms`).

Run as a script it prints the card's name and power limit, then one JSON
line per product: the event minimum and median in ms (20 calls a batch, 5
batches), all taken before the first profiler session in the process, then
the device busy time per product (the sum of its kernels' device times
under torch.profiler, 5 calls), the idle share ``1 - busy / median`` and
the largest kernels. ``--root`` names the checkout whose
``fastsparse_torch`` is imported (default: the one holding this file), so
that one copy of this script times two trees in turns on one card. Without
a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace


def device_us(e):
    """A profiler row's device time in µs (the attribute's name differs
    between torch versions)."""
    t = getattr(e, "self_device_time_total", None)
    return getattr(e, "self_cuda_time_total", 0.0) if t is None else t


def device_busy_ms(fn, arg, n=5):
    """Device time per call (sum of kernel times) under torch.profiler, and
    the top kernels by device time; (None, []) when the profiler sees no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(arg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(arg)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue  # host ops: their device time is their kernels'
        t = device_us(e)
        if t > 0:
            rows.append((t / 1e3 / n, e.key))
    if not rows:
        return None, []
    rows.sort(reverse=True)
    return sum(t for t, _ in rows), rows[:6]


def mono_setup(ft, banded, device="cuda"):
    """The headline operator ``op`` (matrix ``mb``, X ``Xn``/``X``), the
    entry operator ``op2`` (``m2``, ``X2n``/``X2``) and ``products``: name
    -> (fn, arg) of the four mono products."""
    import numpy as np
    import torch

    mb = banded(50_000, 512, seed=4, density=0.39)
    mb.data[:] = 1.0
    op = ft.operator(mb, format="bsr", transpose=True, device=device)
    m2 = banded(12_288, 512, seed=4, density=0.35)
    m2.data[:] = 1.0
    op2 = ft.operator(m2, format="bsr", transpose=True, device=device)
    Xn = np.random.default_rng(0).standard_normal(
        (mb.shape[1], 128)).astype(np.float32)
    X2n = np.random.default_rng(1).standard_normal(
        (m2.shape[1], 128)).astype(np.float32)
    X = torch.from_numpy(Xn).to(device)
    X2 = torch.from_numpy(X2n).to(device)
    products = {
        "headline matmat N=128": (op.matmat, X),
        "headline SpMV": (op.matvec, X[:, 0].contiguous()),
        "headline matmat N=32": (op.matmat, X[:, :32].contiguous()),
        "normal_matmat N=128 (entry 12288)": (
            lambda Z: op2.normal_matmat(Z, reg=0.1), X2),
    }
    return SimpleNamespace(mb=mb, op=op, Xn=Xn, X=X, m2=m2, op2=op2, X2n=X2n,
                           X2=X2, products=products)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mono_products: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import fastsparse_torch as ft
    from fastsparse_torch.bench.matrices import banded
    from fastsparse_torch.bench.timing import time_cuda

    if Path(ft.__file__).resolve().parents[1] != root:
        print(f"mono_products: imported {ft.__file__}, not {root}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    products = mono_setup(ft, banded).products
    events = {name: time_cuda(fn, arg) for name, (fn, arg) in products.items()}
    for name, (fn, arg) in products.items():
        busy, top = device_busy_ms(fn, arg)
        t = events[name]
        print(json.dumps({
            "root": str(root), "product": name, "event_min_ms": t["min_ms"],
            "event_median_ms": t["median_ms"], "device_busy_ms": busy,
            "idle_share": None if busy is None
            else max(0.0, 1.0 - busy / t["median_ms"]),
            "top": [[ms, key[:80]] for ms, key in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
