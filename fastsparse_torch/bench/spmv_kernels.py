"""The gather kernels and the tile SpMV, and the narrow products they
serve, timed on one card.

    python3 fastsparse_torch/bench/spmv_kernels.py [--root DIR]

Kernels, each through its wrapper at the main path's shapes: ell_bucket
(#9) on config A's largest bucket (BASELINE config 2, 7,808 x 64 valued)
at N = 1, 8, 128, on config B's largest packed whole-row bucket at N = 1
and 128, and in the chunked modes at N=1 (valued and packed on config A
built unsplit, unit with plain columns against a 65,544-row X); ell_sweep
(#10) on config B's first sweep item at N = 1 and 128; ell_bucket_smem
(#11) on config A's 7,808 x 64 bucket at N = 1 and 128; bucket_spmv (#8)
on the ECFP transpose tiling's largest segment (5 launches, as a set and
each alone) and on config B's tile segment (``reorder="degree"``, 1
launch). Products: config A SpMV
(``operator(m)``), config 2 SpMV (``reorder="auto", transpose=False``),
config B SpMV (``format="ell"``), ECFP matvec (``operator(m)``) and config
B ``reorder="degree"`` matvec, each with its error against scipy in
float64.

Run as a script it prints the card's name and power limit, then one JSON
line per item: the CUDA-event minimum and median in ms (20 calls a batch,
5 batches), all taken before the first profiler session in the process;
for a kernel the queued time (`timing.time_queued`: the calls held
behind a spin kernel, so device time and launch gaps alone); then the
device time per call under torch.profiler (for a kernel the named
kernel's records, for a product every kernel's: its device busy time)
and, for a product, the idle share ``1 - busy / median`` and its largest
kernels. ``--root`` names
the checkout whose ``fastsparse_torch`` is imported (default: the one
holding this file), so that one copy of this script times two trees in
turns on one card. Without a CUDA device it exits 2 and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ELL_KEYS = ("ell_narrow_kernel", "ell_bucket_kernel")


def kernel_device_ms(fn, keys, per_call=1, n=5, tries=3):
    """Device ms per call of the kernels named by ``keys`` under
    torch.profiler: the mean over the launch records a session kept times
    ``per_call``, the launches one call makes (the profiler drops whole
    calls' records now and then). A session that kept none is profiled
    again half a second later; None if none did."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastsparse_torch.bench.mono_products import device_us

    fn()
    torch.cuda.synchronize()
    for i in range(tries):
        if i:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [(e.count, device_us(e)) for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and any(k in e.key for k in keys)]
        if rows:
            return (sum(t for _, t in rows) / 1e3
                    / sum(c for c, _ in rows) * per_call)
    return None


def setup(ft):
    """``kernels``: name -> (fn, profiler keys, launches a call);
    ``products``: name -> (fn, x, scipy f64 reference)."""
    import numpy as np
    import torch

    from fastsparse_torch.bench.matrices import ecfp_like, powerlaw
    from fastsparse_torch.ops import bsr_ops as bo
    from fastsparse_torch.ops import ell_ops
    from fastsparse_torch.ops.kernels import bsr_tiles as TT
    from fastsparse_torch.ops.kernels import ell_spmm as EK

    g = np.random.default_rng(7)

    def x_panel(n_real, n_rows, N):
        x = np.zeros((n_rows, N), np.float32)
        x[:n_real] = g.standard_normal((n_real, N))
        return torch.from_numpy(x).cuda()

    mA = powerlaw(20_000, 20_000, 1_000_000, seed=0, dtype=np.float32)
    mB = powerlaw(65_536, 65_536, 4_000_000, seed=0, binary=True)
    mE = ecfp_like(50_000, 20_000, 64, 400, seed=2)
    opA = ft.operator(mA)
    op2 = ft.operator(mA, reorder="auto", transpose=False,
                      dtype=torch.float32)
    opB = ft.operator(mB, format="ell", transpose=False)
    opBd = ft.operator(mB, reorder="degree", transpose=False)
    opE = ft.operator(mE)
    opT = ft.operator(mE, reorder="auto")
    A_unsplit = ft.build_ell(ft.coo_from_scipy(mA, device="cuda"),
                             split_rows=0, device="cuda")
    A_unsplit_bin = ft.build_ell(
        ft.binary_coo_from_scipy(mA, device="cuda"), split_rows=0,
        device="cuda")

    kernels = {}
    ncolA = mA.shape[1]
    XA = x_panel(ncolA, ell_ops._round_up(ncolA + 1, 8), 128)
    big = max(opA.fwd.buckets, key=lambda b: b.cols.numel())
    segB = opB.fwd.segments[0]
    XB = x_panel(segB.shape[1], ell_ops._round_up(segB.shape[1] + 1, 8),
                 128)
    bB = max((b for b in segB.buckets if b.width <= 64),
             key=lambda b: b.cols.numel())
    wide = max((b for b in A_unsplit.buckets if b.width > 64),
               key=lambda b: b.cols.numel())
    wideb = max((b for b in A_unsplit_bin.buckets if b.width > 64),
                key=lambda b: b.cols.numel())
    X_plain = x_panel(ncolA, 65_544, 1)
    lanes = {N: (XA[:, :N].contiguous(), XB[:, :N].contiguous())
             for N in (1, 8)}
    lanes[128] = (XA, XB)

    def bucket(b, x, unit, packed=None):
        return (lambda: EK.ell_bucket_spmm(b.cols, b.vals, x, unit=unit,
                                           packed=packed), ELL_KEYS, 1)

    for N in (1, 8, 128):
        kernels[f"ell_bucket valued_full {tuple(big.cols.shape)} N={N}"] = (
            bucket(big, lanes[N][0], False))
    for N in (1, 128):
        kernels[f"ell_bucket packed_full {tuple(bB.cols.shape)} N={N}"] = (
            bucket(bB, lanes[N][1], True, bB.packed))
    kernels[f"ell_bucket valued_chunked {tuple(wide.cols.shape)} N=1"] = (
        bucket(wide, lanes[1][0], False))
    kernels[f"ell_bucket packed_chunked {tuple(wideb.cols.shape)} N=1"] = (
        bucket(wideb, lanes[1][0], True, wideb.packed))
    kernels[f"ell_bucket unit_chunked {tuple(wideb.cols.shape)} N=1"] = (
        bucket(wideb, X_plain, True))
    item = next(b for b, mode, *_ in ell_ops._seg_layout(segB)
                if mode == "sweep")
    flats, meta = [], []
    for bb, t0, t1, np_ in item:
        pp = ell_ops._slice_chunk(bb, segB, t0, t1, np_)[3]
        flats.append(pp.reshape(-1))
        meta.append((np_, bb.cols.shape[1] // 2))
    flat, meta = torch.cat(flats), tuple(meta)
    for N in (1, 128):
        x = lanes[N][1]
        kernels[f"ell_sweep config B item {len(meta)} parts N={N}"] = (
            lambda x=x: EK.ell_sweep_spmm(flat, x, parts=meta),
            ("ell_sweep_kernel",), 1)
        x = lanes[N][0]
        kernels[f"ell_bucket_smem {tuple(big.cols.shape)} N={N}"] = (
            lambda x=x: EK.ell_bucket_spmm_smem(big.cols, big.vals, x),
            ("ell_smem_kernel",), 1)
    for name, S in (("ecfp bwd", max(opT.bwd.dense.segments,
                                     key=lambda s: s.padded_tiles)),
                    ("config B", opBd.fwd.dense.segments[0])):
        xp = bo._padded_x(x_panel(S.shape[1], S.shape[1], 1),
                          S.n_slabs * S.tile_k, 1).reshape(S.n_slabs,
                                                           S.tile_k)
        parts = [(b.slab_ids[s0:s1], b.tiles[s0:s1])
                 for b, s0, s1, _ in bo._bsr_layout(S)]
        kernels[f"bucket_spmv {name} ({len(parts)} launches: "
                f"{[tuple(t.shape[:3]) for _, t in parts]})"] = (
            lambda parts=parts, xp=xp: [TT.bucket_spmv(sl, t, xp)
                                        for sl, t in parts],
            ("bucket_spmv_kernel",), len(parts))
        for k, (sl, t) in enumerate(parts):
            kernels[f"bucket_spmv {name} launch {k} {tuple(t.shape[:3])}"] = (
                lambda sl=sl, t=t, xp=xp: TT.bucket_spmv(sl, t, xp),
                ("bucket_spmv_kernel",), 1)

    products = {}
    for name, op, m in (("config A SpMV", opA, mA),
                        ("config 2 SpMV (reorder='auto')", op2, mA),
                        ("config B SpMV (format='ell')", opB, mB),
                        ("ECFP matvec", opE, mE),
                        ("config B reorder='degree' matvec", opBd, mB)):
        xn = g.standard_normal(m.shape[1]).astype(np.float32)
        products[name] = (op.matvec, torch.from_numpy(xn).cuda(),
                          m.astype(np.float64) @ xn.astype(np.float64))
    return kernels, products


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("spmv_kernels: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import fastsparse_torch as ft
    from fastsparse_torch.bench.mono_products import device_busy_ms
    from fastsparse_torch.bench.timing import time_cuda, time_queued

    if Path(ft.__file__).resolve().parents[1] != root:
        print(f"spmv_kernels: imported {ft.__file__}, not {root}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels, products = setup(ft)
    events = {name: time_cuda(fn) for name, (fn, *_) in kernels.items()}
    events.update({name: time_cuda(fn, x)
                   for name, (fn, x, _) in products.items()})
    queued = {name: time_queued(fn) for name, (fn, *_) in kernels.items()}

    def row(name, **kw):
        t = events[name]
        return {"root": str(root), "item": name, "event_min_ms": t["min_ms"],
                "event_median_ms": t["median_ms"], **kw}

    for name, (fn, keys, per_call) in kernels.items():
        q = queued[name]
        print(json.dumps(row(
            name, queued_ms=None if q is None else q["min_ms"],
            device_ms=kernel_device_ms(fn, keys, per_call))), flush=True)
    for name, (fn, x, ref) in products.items():
        y = fn(x).double().cpu().numpy()
        rel = float(np.abs(y - ref).max() / np.abs(ref).max())
        busy, top = device_busy_ms(fn, x)
        median = events[name]["median_ms"]
        print(json.dumps(row(
            name, rel=rel, device_busy_ms=busy,
            idle_share=None if busy is None else max(0.0, 1 - busy / median),
            top=[[ms, key[:80]] for ms, key in top])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
