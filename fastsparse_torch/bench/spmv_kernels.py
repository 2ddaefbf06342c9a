"""The gather kernels and the tile SpMV, and the products they serve,
timed on one card.

    python3 fastsparse_torch/bench/spmv_kernels.py [--root DIR]
        [--groups spmv,smem,dd,others]

Group ``spmv``, each kernel through its wrapper at the main path's shapes:
ell_bucket (#9) on config A's largest bucket (BASELINE config 2, 7,808 x
64 valued) at N = 1, 8, 128, on config B's largest packed whole-row
bucket at N = 1 and 128, and in the chunked modes at N=1 (valued and
packed on config A built unsplit, unit with plain columns against a
65,544-row X); ell_sweep (#10) on config B's first sweep item at N = 1
and 128, with its bound; ell_bucket_smem (#11) on config A's 7,808 x 64
bucket at N = 1 and 128; bucket_spmv (#8) on the ECFP transpose
tiling's largest segment (5 launches, as a set and each alone) and on
config B's tile segment (``reorder="degree"``, 1 launch). Products:
config A SpMV (``operator(m)``), config 2 SpMV (``reorder="auto", transpose=False``),
config B SpMV (``format="ell"``), ECFP matvec (``operator(m)``) and config
B ``reorder="degree"`` matvec, each with its error against scipy in
float64.

Group ``smem``: ell_bucket_smem (#11) on config A's four whole buckets
under ``ell_ops.USE_SMEM_PATH`` at N = 1, 8 and 128, and cuSPARSE's
product of the same rows at N=1; the product config A SpMV with the flag
on.

Group ``dd``: ell_bucket_dd_valued (#13) on every bucket of config 2 in
fp64 (``build_ell_dd``, 60 buckets) at N=1 and ell_bucket_dd (#12) on
every bucket of config B's unsplit unit layout (61 buckets) at N=32, and
at N=1 on its largest bucket and its longest rows, each with its bound
(and cuSPARSE's f64 product of those three buckets' rows at N = 1, 32);
the dd launches of one ``spmm_dd`` as a set (the buckets' launches on
their segments' panels, without the merges): #13 on config 2-fp64 (N=1)
and BASELINE config 1 (N=1), #12 on config B unit (N=32); and those
three ``spmm_dd`` products, with their error against scipy.

Group ``others``: colmax (#1) and quant3_planes (#2) on the headline's X
(N=128), colmax also with the L2 flushed between calls (a 128 MB write,
which its event and queued times include; its device time does not),
and ell_sweep (#10) on config B's first sweep item at N=128, each with
its bound.

Run as a script it prints the card's name and power limit, then one JSON
line per item: the CUDA-event minimum and median in ms (20 calls a batch,
5 batches), all taken before the first profiler session in the process;
for a kernel the queued time (`timing.time_queued`: the calls held
behind a spin kernel, so device time and launch gaps alone); then the
device time per call under torch.profiler (for a kernel the named
kernel's records, for a library call and a product every kernel's: its
device busy time) and, for a product, the idle share ``1 - busy /
median`` and its largest kernels. ``--root`` names the checkout whose
``fastsparse_torch`` is imported (default: the one holding this file), so
that one copy of this script times two trees in turns on one card.
Without a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ELL_KEYS = ("ell_narrow_kernel", "ell_bucket_kernel")
GROUPS = ("spmv", "smem", "dd", "others")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12


def kernel_device_ms(fn, keys, per_call=1, n=5, tries=3):
    """Device ms per call of the kernels named by ``keys`` under
    torch.profiler: the mean over the launch records a session kept times
    ``per_call``, the launches one call makes (the profiler drops whole
    calls' records now and then); ``per_call=None``: the records' sum over
    the ``n`` calls (a library call of several kernels). A session that
    kept none is profiled again half a second later; None if none did."""
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
            if per_call is None:
                return sum(t for _, t in rows) / 1e3 / n
            return (sum(t for _, t in rows) / 1e3
                    / sum(c for c, _ in rows) * per_call)
    return None


def bound_ms(nbytes, ops):
    """The least time the card could take: bytes over the memory rate or
    f32 operations over the peak, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def dd_work(cols, lanes, valued):
    """(bytes, f32 operations) of one dd launch: each slot's index (and
    value planes) read once, each gathered X row in both planes, both
    outputs written once; 25 operations a slot and lane (plus 4 a slot for
    the split of vh) valued, 8 unit."""
    import torch

    nb, K = cols.shape
    slots = nb * K
    rows_used = int(torch.unique(cols).numel())
    nbytes = (slots * (12 if valued else 4) + rows_used * lanes * 8
              + nb * lanes * 8)
    ops = slots * lanes * (25 if valued else 8) + (4 * slots if valued else 0)
    return nbytes, ops


def setup(ft, groups=GROUPS):
    """``kernels``: name -> (fn, profiler keys or ("",) for every kernel,
    launches a call or None for a sum, extra fields); ``products``: name
    -> (fn, x, scipy f64 reference)."""
    import numpy as np
    import torch

    from fastsparse_torch.bench.matrices import ecfp_like, powerlaw

    g = np.random.default_rng(7)
    mats = {}

    def mat(key):
        if key not in mats:
            mats[key] = {
                "A": lambda: powerlaw(20_000, 20_000, 1_000_000, seed=0,
                                      dtype=np.float32),
                "B": lambda: powerlaw(65_536, 65_536, 4_000_000, seed=0,
                                      binary=True),
                "E": lambda: ecfp_like(50_000, 20_000, 64, 400, seed=2),
                "2d": lambda: powerlaw(20_000, 20_000, 1_000_000, seed=0,
                                       dtype=np.float64),
                "1": lambda: powerlaw(100_000, 100_000, 5_000_000, seed=0,
                                      alpha=1.0, dtype=np.float64),
            }[key]()
        return mats[key]

    kernels, products = {}, {}
    if "spmv" in groups:
        _spmv_items(ft, g, mat, kernels, products)
    if "smem" in groups:
        _smem_items(ft, g, mat, kernels, products)
    if "dd" in groups:
        _dd_items(ft, g, mat, kernels, products)
    if "others" in groups:
        _other_items(ft, g, mat, kernels)
    return kernels, products


def _x_panel(g, n_real, n_rows, N):
    """An f32 X panel on the card: ``n_real`` random rows, zeros below."""
    import numpy as np
    import torch

    x = np.zeros((n_rows, N), np.float32)
    x[:n_real] = g.standard_normal((n_real, N))
    return torch.from_numpy(x).cuda()


def _spmv_items(ft, g, mat, kernels, products):
    import numpy as np
    import torch

    from fastsparse_torch.ops import bsr_ops as bo
    from fastsparse_torch.ops import ell_ops
    from fastsparse_torch.ops.kernels import bsr_tiles as TT
    from fastsparse_torch.ops.kernels import ell_spmm as EK

    def x_panel(n_real, n_rows, N):
        return _x_panel(g, n_real, n_rows, N)

    mA, mB, mE = mat("A"), mat("B"), mat("E")
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
                                           packed=packed), ELL_KEYS, 1, {})

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
    _sweep_items(segB, {N: lanes[N][1] for N in (1, 128)}, kernels)
    for N in (1, 128):
        x = lanes[N][0]
        kernels[f"ell_bucket_smem {tuple(big.cols.shape)} N={N}"] = (
            lambda x=x: EK.ell_bucket_spmm_smem(big.cols, big.vals, x),
            ("ell_smem",), 1, {})
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
            ("bucket_spmv_kernel",), len(parts), {})
        for k, (sl, t) in enumerate(parts):
            kernels[f"bucket_spmv {name} launch {k} {tuple(t.shape[:3])}"] = (
                lambda sl=sl, t=t, xp=xp: TT.bucket_spmv(sl, t, xp),
                ("bucket_spmv_kernel",), 1, {})

    for name, op, m in (("config A SpMV", opA, mA),
                        ("config 2 SpMV (reorder='auto')", op2, mA),
                        ("config B SpMV (format='ell')", opB, mB),
                        ("ECFP matvec", opE, mE),
                        ("config B reorder='degree' matvec", opBd, mB)):
        xn = g.standard_normal(m.shape[1]).astype(np.float32)
        products[name] = (op.matvec, torch.from_numpy(xn).cuda(),
                          m.astype(np.float64) @ xn.astype(np.float64))


def gather_csr(cols, vals, nx_rows):
    """A sparse CSR of the rows a gather computes: ``(n, nx_rows)``, row r
    holding ``vals[r, k]`` at ``cols[r, k]`` (the cuSPARSE yardstick of
    the same function)."""
    import torch

    n, K = cols.shape
    crow = torch.arange(0, n * K + 1, K, dtype=torch.int64, device=cols.device)
    return torch.sparse_csr_tensor(crow, cols.reshape(-1).long(),
                                   vals.reshape(-1), size=(n, nx_rows))


def _csr_f64(cols, x2):
    """cuSPARSE's f64 product of a unit bucket's rows with the f64 X that
    the panel ``x2`` holds as two planes: a yardstick item."""
    import torch

    k_rows = x2.shape[0] // 2
    A = gather_csr(cols, torch.ones(cols.shape, dtype=torch.float64,
                                    device=cols.device), k_rows)
    X64 = (x2[:k_rows].double() + x2[k_rows:].double()).contiguous()
    return lambda: torch.sparse.mm(A, X64), ("",), None, {}


def _sweep_items(seg, xs, kernels):
    """ell_sweep on a segment's first sweep item, as `ell_ops` launches
    it, for each X panel of ``xs`` (N -> panel), with its bound."""
    import torch

    from fastsparse_torch.ops import ell_ops
    from fastsparse_torch.ops.kernels import ell_spmm as EK

    item = next(b for b, mode, *_ in ell_ops._seg_layout(seg)
                if mode == "sweep")
    flats, meta, cols = [], [], []
    for bb, t0, t1, np_ in item:
        _, cc, _, pp = ell_ops._slice_chunk(bb, seg, t0, t1, np_)
        flats.append(pp.reshape(-1))
        meta.append((np_, bb.cols.shape[1] // 2))
        cols.append(cc.reshape(-1))
    flat, meta, cols = torch.cat(flats), tuple(meta), torch.cat(cols)
    used, rows = int(torch.unique(cols).numel()), sum(n for n, _ in meta)
    for N, x in xs.items():
        kernels[f"ell_sweep config B item {len(meta)} parts N={N}"] = (
            lambda x=x: EK.ell_sweep_spmm(flat, x, parts=meta),
            ("ell_sweep_kernel",), 1,
            {"bound_ms": bound_ms(cols.numel() * 2 + (used + rows) * N * 4,
                                  cols.numel() * N)})


@contextlib.contextmanager
def _smem_path():
    """``ell_ops.USE_SMEM_PATH`` on for the block, reset whatever happens."""
    from fastsparse_torch.ops import ell_ops

    ell_ops.USE_SMEM_PATH = True
    try:
        yield
    finally:
        ell_ops.USE_SMEM_PATH = False


def _smem_items(ft, g, mat, kernels, products):
    """#11 on config A's whole buckets (the layout under the flag)."""
    import numpy as np
    import torch

    from fastsparse_torch.ops import ell_ops
    from fastsparse_torch.ops.kernels import ell_spmm as EK

    mA = mat("A")
    with _smem_path():
        opA = ft.operator(mA)
        whole = [b for b, mode, *_ in ell_ops._seg_layout(opA.fwd)
                 if mode == "smem"]
    ncol = mA.shape[1]
    X = _x_panel(g, ncol, ell_ops._round_up(ncol + 1, 8), 128)
    for b in whole:
        shape = tuple(b.cols.shape)
        for N in (1, 8, 128):
            x = X[:, :N].contiguous()
            kernels[f"ell_bucket_smem A {shape} N={N}"] = (
                lambda b=b, x=x: EK.ell_bucket_spmm_smem(b.cols, b.vals, x),
                ("ell_smem",), 1, {})
        x = X[:, :1].contiguous()
        rows = torch.arange(shape[0], device=x.device).repeat_interleave(
            shape[1])
        A = torch.sparse_coo_tensor(
            torch.stack([rows, b.cols.reshape(-1).long()]),
            b.vals.reshape(-1), (shape[0], x.shape[0])).coalesce().to_sparse_csr()
        kernels[f"cuSPARSE A {shape} N=1"] = (
            lambda A=A, x=x: torch.sparse.mm(A, x), ("",), None, {})

    def flagged(fn):
        def run(v):
            with _smem_path():
                return fn(v)
        return run

    xn = g.standard_normal(mA.shape[1]).astype(np.float32)
    products["config A SpMV [USE_SMEM_PATH]"] = (
        flagged(opA.matvec), torch.from_numpy(xn).cuda(),
        mA.astype(np.float64) @ xn.astype(np.float64))


def _dd_items(ft, g, mat, kernels, products):
    """#13 per bucket of config 2-fp64; the dd launches of one spmm_dd as
    a set (config 2-fp64 and config 1: #13; config B unit: #12)."""
    import numpy as np
    import torch

    from fastsparse_torch.ops.ell_ops import _dd_panel, _segments
    from fastsparse_torch.ops.kernels import ell_dd as DK

    def launches(A, N):
        """[(cols, vh or None, vl or None, x2)] of one product, in the
        order `ell_spmm_dd` launches them, the f64 X, and each launch's
        segment."""
        valued = hasattr(A, "lo")
        tiling = A.hi if valued else A
        X = torch.from_numpy(g.standard_normal((tiling.shape[1], N))).cuda()
        xh = X.float()
        xl = (X - xh.double()).float()
        out, seg_of = [], []
        segs = (zip(_segments(A.hi), _segments(A.lo)) if valued
                else ((s, (None, None)) for s in _segments(A)))
        for si, ((off, seg), (_, seg_lo)) in enumerate(segs):
            x2 = _dd_panel(xh, xl, off, seg.shape[1])
            for i, b in enumerate(seg.buckets):
                out.append((b.cols, b.vals if valued else None,
                            seg_lo.buckets[i].vals if valued else None, x2))
                seg_of.append(si)
        return out, X, seg_of

    def one(name, cols, vh, vl, x2):
        """One launch's item, with its bound."""
        fn = ((lambda: DK.ell_bucket_spmm_dd(cols, x2)) if vh is None else
              (lambda: DK.ell_bucket_spmm_dd_valued(cols, vh, vl, x2)))
        work = dd_work(cols, x2.shape[1], vh is not None)
        kernels[name] = (fn, ("ell_dd",), 1, {"bound_ms": bound_ms(*work)})

    def run_all(items):
        for cols, vh, vl, x2 in items:
            if vh is None:
                DK.ell_bucket_spmm_dd(cols, x2)
            else:
                DK.ell_bucket_spmm_dd_valued(cols, vh, vl, x2)

    m2d, m1, mB = mat("2d"), mat("1"), mat("B")
    A2d = ft.build_ell_dd(m2d)
    A1 = ft.build_ell_dd(m1)
    opBu = ft.operator(mB, format="ell", transpose=False,
                       config=ft.Config(ell_split_rows=0))
    items2, X2, seg_of = launches(A2d, 1)
    for si, (cols, vh, vl, x2) in zip(seg_of, items2):
        one(f"dd_valued config2-fp64 seg{si} {tuple(cols.shape)} N=1",
            cols, vh, vl, x2)
    itemsB, XB, seg_of = launches(opBu.fwd, 32)
    for si, (cols, _, _, x2) in zip(seg_of, itemsB):
        one(f"dd_unit configB seg{si} {tuple(cols.shape)} N=32", cols, None,
            None, x2)
    # at N=1 too: the largest unit bucket and the longest rows; cuSPARSE's
    # f64 product of the same rows beside them
    itemsB1, _, _ = launches(opBu.fwd, 1)
    K_max = max(c.shape[1] for c, *_ in itemsB)
    big = max(range(len(itemsB)), key=lambda i: itemsB[i][0].numel())
    for i, (cols, _, _, x2) in enumerate(itemsB1):
        if i == big or cols.shape[1] == K_max:
            one(f"dd_unit configB seg{seg_of[i]} {tuple(cols.shape)} N=1",
                cols, None, None, x2)
            for N, x in ((1, x2), (32, itemsB[i][3])):
                kernels[f"cuSPARSE f64 configB seg{seg_of[i]} "
                         f"{tuple(cols.shape)} N={N}"] = _csr_f64(cols, x)
    items1, X1, _ = launches(A1, 1)
    for name, (items, X), N, A, m in (
            ("dd_valued config2-fp64", (items2, X2), 1, A2d, m2d),
            ("dd_valued config1", (items1, X1), 1, A1, m1),
            ("dd_unit configB", (itemsB, XB), 32, opBu.fwd, mB)):
        work = [dd_work(c, N, vh is not None) for c, vh, _, _ in items]
        kernels[f"{name} all {len(items)} launches N={N}"] = (
            lambda items=items: run_all(items), ("ell_dd",), len(items),
            {"bound_ms": bound_ms(sum(w[0] for w in work),
                                  sum(w[1] for w in work))})
        ref = m.astype(np.float64) @ X.cpu().numpy()
        products[f"{name.split()[1]} spmm_dd N={N}"] = (
            lambda v, A=A: ft.spmm_dd(A, v), X, ref)


def _other_items(ft, g, mat, kernels):
    """#1 and #2 on the headline's X at N=128 (#1 also behind an L2
    flush), #10 on config B's first sweep item at N=128, each with its
    bound."""
    import torch

    from fastsparse_torch.bench.matrices import banded
    from fastsparse_torch.bench.mono_products import mono_setup
    from fastsparse_torch.ops import ell_ops
    from fastsparse_torch.ops.kernels import bsr_spmm as K

    ms = mono_setup(ft, banded)
    b = ms.op.fwd.buckets[0]
    K_pad = b.n_windows * b.win_slabs * ms.op.fwd.tile_k
    Xp = torch.zeros((K_pad, 128), dtype=torch.float32, device="cuda")
    Xp[: ms.X.shape[0]] = ms.X
    mx = K.colmax(Xp)
    sinv = 1.0 / (torch.where(mx > 0, mx, 1.0) * (1.0 / (127.0 * 65536.0)))
    n = Xp.numel()
    colmax_bound = {"bound_ms": bound_ms(n * 4 + 128 * 4, n)}
    kernels[f"colmax headline {tuple(Xp.shape)}"] = (
        lambda: K.colmax(Xp), ("colmax_kernel",), 1, colmax_bound)
    # 128 MB written between calls: the X the headline left in the 50 MB
    # L2 is gone (event and queued times include the write)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def cold():
        flush.zero_()
        return K.colmax(Xp)

    kernels[f"colmax headline {tuple(Xp.shape)} L2 flushed"] = (
        cold, ("colmax_kernel",), 1, colmax_bound)
    kernels[f"quant3_planes headline {tuple(Xp.shape)}"] = (
        lambda: K.quant3_planes(Xp, sinv, n_block=128), ("quant3",), 1,
        {"bound_ms": bound_ms(n * 7 + 128 * 4, n)})
    segB = ft.operator(mat("B"), format="ell", transpose=False).fwd.segments[0]
    XB = _x_panel(g, segB.shape[1], ell_ops._round_up(segB.shape[1] + 1, 8),
                  128)
    _sweep_items(segB, {128: XB}, kernels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated item groups: " + ", ".join(GROUPS))
    args = ap.parse_args(argv)
    groups = tuple(args.groups.split(","))
    if not set(groups) <= set(GROUPS):
        ap.error(f"--groups: choose from {GROUPS}")
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
    kernels, products = setup(ft, groups)
    events = {name: time_cuda(fn) for name, (fn, *_) in kernels.items()}
    events.update({name: time_cuda(fn, x)
                   for name, (fn, x, _) in products.items()})
    # a set of launches is queued one call a batch (its host time would
    # outlast the spin kernel's hold)
    queued = {name: time_queued(fn, reps=max(1, 20 // (per_call or 1)))
              for name, (fn, _, per_call, _) in kernels.items()}

    def row(name, **kw):
        t = events[name]
        return {"root": str(root), "item": name, "event_min_ms": t["min_ms"],
                "event_median_ms": t["median_ms"], **kw}

    for name, (fn, keys, per_call, extra) in kernels.items():
        q = queued[name]
        print(json.dumps(row(
            name, queued_ms=None if q is None else q["min_ms"],
            device_ms=kernel_device_ms(fn, keys, per_call), **extra)),
            flush=True)
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
