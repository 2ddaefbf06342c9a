"""Every hand-written kernel, and the products it serves, timed on one card.

    python3 fastsparse_torch/bench/kernels.py [--root DIR]
        [--groups mono,tiles,densecols,encode,plan,spmv,table,table64,smem,dd,
                  others]

Each group times its kernels at the main path's shapes, each beside its
bound and, where one PyTorch call computes the same function on the same
rows, beside that call (cuSPARSE, ``vector_norm``, ``torch._int_mm``):

- ``mono``: colmax (#1, also with the L2 flushed between calls), quant3
  (#2), mono_panel (#3: i8w N=128, narrow N=32) and mono_group (#4: halo,
  N=1) on the banded 50,000² headline, cuSPARSE at N = 128, 32, 1; the
  products matmat N = 128 and 32, matvec, and normal_matmat on the
  12,288² entry matrix;
- ``tiles``: panel_spmm (#6) on the ECFP forward class panels at N = 32,
  128, 256, bucket_spmm (#5) on the transpose tiling's largest tile
  segment at N = 32, 128, bucket_spmv (#8) on that segment and on config
  B's tile segment, each as one product's set of launches (#8 also each
  launch alone);
- ``densecols``: #7 on the ECFP forward dense-column block at N = 1, 32,
  128, 256;
- ``encode``: the X encoder (`quant3_encode`: its fill and its two
  launches) at the solve and product cells' shapes: the headline's narrow
  planes at N=32 (the CG solve's), the ECFP forward dense-column rows at
  N = 32 and 256 and R-MAT's hub rows at N=128;
- ``plan``: plan_sum on every plan the main paths apply (config A, config
  B, ECFP with both tilings, R-MAT scale 18) at N = 1, 32, 128;
- ``spmv``: ell_bucket (#9) on config A's largest bucket, config B's
  largest packed one and the chunked widths, ell_sweep (#10) on config
  B's first sweep item; the SpMV products of configs A, 2, B and ECFP;
- ``table``: the narrow products' one launch (`ell_table_spmm`) on the
  250,000² power-law layout of the benchmark's ``powerlaw250k`` at N=1,
  the same layout's per-part ell_bucket launches (#9) as one set, and
  cuSPARSE's CSR matvec on the same matrix; the matvec product;
- ``table64``: the table kernel's f64 mode on BASELINE config 1's layout
  (the benchmark's ``fp64rand100k``: 100,000², 5 f64 segments) at N=1,
  at tiles of 1,024, 2,048 and 4,096 slots (``_TABLE_SLOTS``), its
  plan_sum, cuSPARSE's f64 CSR matvec on the same matrix; the matvec;
- ``smem``: ell_bucket_smem (#11) on config A's whole buckets under
  ``ell_ops.USE_SMEM_PATH`` at N = 1, 8, 128; config A SpMV under it;
- ``dd``: #13 on every bucket of config 2 in fp64, #12 on every bucket of
  config B's unsplit unit layout, each set of one ``spmm_dd`` (config 1
  too), and the three ``spmm_dd`` products;
- ``others``: #1, #2 as in ``mono`` and #10 at N=128 (the kernels nearest
  half their bound, in a short run).

It prints the card's name and power limit, then one JSON line per item:
the CUDA-event minimum and median in ms (5 batches of 20 calls), all
taken before the first profiler session in the process; for a kernel the
queued time (`timing.time_queued`), the event minimum of its plain
PyTorch version on the same card tensors (``plain_ms``, 3 calls; every
wrapper swapped for its ``*_plain`` twin, `sum_plan` for `plain_sum`),
its device time under torch.profiler and the PyTorch call it is held
against (``library``, where one computes the same rows); for a library
call or a product its device busy time, for a product also its error
against scipy in float64 and its idle share. A set of launches is timed
as one call. ``--root`` names the checkout to import (default: this one;
it must hold ``bench/timing.py``'s profiler helpers and
``tests/card_helpers.py``), so that one copy of this script times two
trees in turns. Without a CUDA device it exits 2. Correctness is the card
tests' (``chip_smoke.py`` runs them, then this timer).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ELL_KEYS = ("ell_narrow_kernel", "ell_bucket_kernel")
TILE_KEYS = ("spmv_kernel", "tile_mma_kernel", "_scalar_kernel")
ALL = ("",)  # every kernel a call launches (a library call, a product)
GROUPS = ("mono", "tiles", "densecols", "encode", "plan", "spmv", "table",
          "table64", "smem", "dd", "others")


def main_paths(ft):
    """``get(key)``: a BASELINE matrix or a main path's operator on the
    card, built at its first call and kept."""
    from fastsparse_torch.bench.matrices import banded, ecfp_like, powerlaw, rmat
    from fastsparse_torch.ops import ell_ops

    made = {}

    def banded01(n, density):
        m = banded(n, 512, seed=4, density=density)
        m.data[:] = 1.0
        return m

    recipes = {
        "A": lambda: powerlaw(20_000, 20_000, 1_000_000, seed=0,
                              dtype=np.float32),
        "P": lambda: powerlaw(250_000, 250_000, 12_500_000, seed=0),
        "B": lambda: powerlaw(65_536, 65_536, 4_000_000, seed=0, binary=True),
        "E": lambda: ecfp_like(50_000, 20_000, 64, 400, seed=2),
        "2d": lambda: powerlaw(20_000, 20_000, 1_000_000, seed=0,
                               dtype=np.float64),
        "1": lambda: powerlaw(100_000, 100_000, 5_000_000, seed=0, alpha=1.0,
                              dtype=np.float64),
        "R": lambda: rmat(18, 16, seed=3),
        "headline": lambda: banded01(50_000, 0.39),
        "entry": lambda: banded01(12_288, 0.35),
        "opA": lambda: ft.operator(get("A")),
        "opP": lambda: ft.operator(get("P"), transpose=False),
        "opB": lambda: ft.operator(get("B"), format="ell", transpose=False),
        "opBd": lambda: ft.operator(get("B"), reorder="degree",
                                    transpose=False),
        "opE": lambda: ft.operator(get("E")),
        "opF": lambda: ft.operator(get("E"), reorder="auto", transpose=False),
        "opT": lambda: ft.operator(get("E"), reorder="auto"),
        "opR": lambda: ft.operator(get("R"), reorder="auto", transpose=False),
        "opH": lambda: ft.operator(get("headline"), format="bsr",
                                   transpose=True),
        "opEntry": lambda: ft.operator(get("entry"), format="bsr",
                                       transpose=True),
        "A1": lambda: ft.build_ell_dd(get("1")),
        "A2d": lambda: ft.build_ell_dd(get("2d")),
        "opBu": lambda: ft.operator(get("B"), format="ell", transpose=False,
                                    config=ft.Config(ell_split_rows=0)),
        "opAsmem": lambda: smem_build(),
        "opCsr": lambda: ft.operator(get("1"), format="csr", transpose=False),
        "op1": lambda: ft.operator(get("1"), format="ell", transpose=False),
    }

    def smem_build():
        ell_ops.USE_SMEM_PATH = True
        try:
            return ft.operator(get("A"))
        finally:
            ell_ops.USE_SMEM_PATH = False

    def get(key):
        """A matrix or an operator of the main paths, built once."""
        if key not in made:
            made[key] = recipes[key]()
            torch.cuda.synchronize()
        return made[key]

    return get


def setup(ft, groups=GROUPS, get=None):
    """``kernels``: name -> (fn, profiler keys, launches a call or None
    for a sum, extra fields); ``products``: name -> (fn, x, scipy f64
    reference). Matrices and operators come from ``get`` (`main_paths`),
    built once for all groups."""
    g = np.random.default_rng(7)
    get = get or main_paths(ft)
    kernels, products = {}, {}
    items = {"mono": _mono_items, "tiles": _tile_items,
             "densecols": _densecols_items, "encode": _encode_items,
             "plan": _plan_items,
             "spmv": _spmv_items, "table": _table_items,
             "table64": _table64_items,
             "smem": _smem_items, "dd": _dd_items,
             "others": _other_items}
    for name in groups:
        items[name](ft, g, get, kernels, products)
    return kernels, products


def _x_panel(g, n_real, n_rows, N):
    """An f32 X panel on the card: ``n_real`` random rows, zeros below."""
    x = np.zeros((n_rows, N), np.float32)
    x[:n_real] = g.standard_normal((n_real, N))
    return torch.from_numpy(x).cuda()


def _product(g, m, fn, N, vector=False):
    """(fn, X, scipy f64 reference) of one product at width N."""
    shape = (m.shape[1],) if vector else (m.shape[1], N)
    xn = g.standard_normal(shape).astype(np.float32)
    return (fn, torch.from_numpy(xn).cuda(),
            m.astype(np.float64) @ xn.astype(np.float64))


def gather_csr(cols, vals, nx_rows):
    """A sparse CSR of the rows a gather computes: ``(n, nx_rows)``, row r
    holding ``vals[r, k]`` at ``cols[r, k]`` (the cuSPARSE yardstick of
    the same function)."""
    n, K = cols.shape
    crow = torch.arange(0, n * K + 1, K, dtype=torch.int64, device=cols.device)
    return torch.sparse_csr_tensor(crow, cols.reshape(-1).long(),
                                   vals.reshape(-1), size=(n, nx_rows))


def _library(A, x):
    """cuSPARSE's product ``A @ x`` as an item (every kernel it launches)."""
    return lambda: torch.sparse.mm(A, x), ALL, None, {}


def _pair(kernels, item, library):
    """Name the library item ``library`` (a PyTorch call computing the
    same rows) as kernel item ``item``'s yardstick."""
    kernels[item][3]["library"] = library


def _headline_prep(ft, get, kernels):
    """colmax (#1, also behind an L2 flush) and quant3_planes (#2) on the
    headline's X at N=128, with their bounds; returns (op, X, Xp, s)."""
    from fastsparse_torch.bench.timing import bound
    from fastsparse_torch.ops.kernels import bsr_spmm as K

    op, m = get("opH"), get("headline")
    X = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m.shape[1], 128)).astype(np.float32)).cuda()
    b = op.fwd.buckets[0]
    K_pad = b.n_windows * b.win_slabs * op.fwd.tile_k
    Xp = torch.zeros((K_pad, 128), dtype=torch.float32, device="cuda")
    Xp[: X.shape[0]] = X
    mx = K.colmax(Xp)
    s = torch.where(mx > 0, mx, 1.0) * (1.0 / (127.0 * 65536.0))
    sinv = 1.0 / s
    n = Xp.numel()
    colmax_bound = bound(n * 4 + 128 * 4, n)
    kernels[f"colmax headline {tuple(Xp.shape)}"] = (
        lambda: K.colmax(Xp), ("colmax_kernel",), 1, dict(colmax_bound))
    # 128 MB written between calls: the X the headline left in the 50 MB
    # L2 is gone (event and queued times include the write)
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def cold():
        flush.zero_()
        return K.colmax(Xp)

    kernels[f"colmax headline {tuple(Xp.shape)} L2 flushed"] = (
        cold, ("colmax_kernel",), 1, dict(colmax_bound))
    kernels[f"quant3_planes headline {tuple(Xp.shape)}"] = (
        lambda: K.quant3_planes(Xp, sinv, n_block=128), ("quant3",), 1,
        bound(n * 7 + 128 * 4, n))
    return op, X, Xp, s


def _mono_items(ft, g, get, kernels, products):
    """#1-#4 on the headline's layout and X, the library calls beside
    them, and the four mono products."""
    from fastsparse_torch.bench.timing import INT8_OPS_PER_S, bound
    from fastsparse_torch.ops import bsr_ops
    from fastsparse_torch.ops.kernels import bsr_spmm as K

    op, X, Xp, s = _headline_prep(ft, get, kernels)
    norm = "vector_norm headline (colmax's library call)"
    kernels[norm] = (
        lambda: torch.linalg.vector_norm(Xp, ord=float("inf"), dim=0), ALL,
        None, {})
    _pair(kernels, f"colmax headline {tuple(Xp.shape)}", norm)
    A, mb = op.fwd, get("headline")
    b = A.buckets[0]
    TK = A.tile_k
    K_pad = Xp.shape[0]
    planes = K.quant3_planes(Xp, 1.0 / s, n_block=128)
    out_rows = max(b.out_strips, A.n_strips) * A.tile_m
    panel_kw = dict(tile_m=A.tile_m, tile_k=TK, width=b.width,
                    win_slabs=b.win_slabs, out_rows=out_rows)
    args = (b.window, b.strip_ptr, b.start_rel, b.panels)
    ni, TM, PK = b.panels.shape
    i8w_kw = dict(panel_kw, n_block=128, fold="i8w", scale=s)
    kernels[f"mono_panel i8w headline {ni} items N=128"] = (
        lambda: K.mono_panel_spmm(*args, planes, **i8w_kw),
        ("s8_engine_kernel",), 1,
        bound(b.panels.numel() + planes.numel() + 128 * 4
              + out_rows * 128 * 4 + 3 * 4 * ni, 2 * ni * TM * PK * 3 * 128,
              INT8_OPS_PER_S))
    nq = 32
    nb = bsr_ops._round_up(3 * nq, 32)
    qn, _ = bsr_ops._quant3_narrow(X[:, :nq], K_pad, nq, nb)
    narrow_kw = dict(panel_kw, n_block=nb, fold=False)
    kernels[f"mono_panel narrow headline {ni} items N=32"] = (
        lambda: K.mono_panel_spmm(*args, qn, **narrow_kw),
        ("s8_engine_kernel",), 1,
        bound(b.panels.numel() + qn.numel() + out_rows * nb * 4 + 3 * 4 * ni,
              2 * ni * TM * PK * nb, INT8_OPS_PER_S))
    h = A.narrow
    K_halo = ((h.n_windows - 1) * h.stride + h.win_slabs) * TK
    qh, _ = bsr_ops._quant3_narrow(X[:, :1], K_halo, 8, 32)
    gkw = dict(tile_m=A.tile_m, tile_k=TK, width=h.width, stride=h.stride,
               group=h.group)
    ns, TMh, PKh = h.panels.shape
    kernels[f"mono_group halo headline {ns} strips N=1"] = (
        lambda: K.mono_group_spmm(h.windows, h.start_rel, h.panels, qh,
                                  **gkw),
        ("s8_engine_kernel",), 1,
        bound(h.panels.numel() + qh.numel() + ns * TMh * 32 * 4 + 4 * ns,
              2 * ns * TMh * PKh * 32, INT8_OPS_PER_S))
    m = mb.tocsr()
    A_csr = torch.sparse_csr_tensor(
        torch.as_tensor(m.indptr, dtype=torch.int64),
        torch.as_tensor(m.indices, dtype=torch.int64),
        torch.as_tensor(m.data, dtype=torch.float32), size=m.shape).cuda()
    for N in (128, 32, 1):
        kernels[f"cuSPARSE headline N={N}"] = _library(
            A_csr, X[:, :N].contiguous())
    for item, N in ((f"mono_panel i8w headline {ni} items N=128", 128),
                    (f"mono_panel narrow headline {ni} items N=32", 32),
                    (f"mono_group halo headline {ns} strips N=1", 1)):
        _pair(kernels, item, f"cuSPARSE headline N={N}")

    products["headline matmat N=128"] = _product(g, mb, op.matmat, 128)
    products["headline SpMV"] = _product(g, mb, op.matvec, 1, vector=True)
    products["headline matmat N=32"] = _product(g, mb, op.matmat, 32)
    m2 = get("entry")
    op2 = get("opEntry")
    X2n = g.standard_normal((m2.shape[1], 128)).astype(np.float32)
    m264, X264 = m2.astype(np.float64), X2n.astype(np.float64)
    products["normal_matmat N=128 (entry 12288)"] = (
        lambda Z: op2.normal_matmat(Z, reg=0.1),
        torch.from_numpy(X2n).cuda(), m264.T @ (m264 @ X264) + 0.1 * X264)


def bsr_csr(A):
    """A CUDA CSR (f32) of a BsrMatrix of tile buckets or class panels, or
    of a ColSegmented of them: cuSPARSE's operand for the same product."""
    parts = [(0, A)] if not hasattr(A, "col_offsets") else list(
        zip(A.col_offsets, A.segments))
    rows, cols, vals = [], [], []
    for off, S in parts:
        TM, TK = S.tile_m, S.tile_k
        for b in S.buckets:
            sid = b.strip_ids.long()
            if hasattr(b, "start_slab"):
                i, r, c = b.panels.nonzero(as_tuple=True)
                cols.append(b.start_slab.long()[i] * TK + c + off)
                vals.append(b.panels[i, r, c].float())
            else:
                i, t, r, c = b.tiles.nonzero(as_tuple=True)
                cols.append(b.slab_ids.long()[i, t] * TK + c + off)
                vals.append(b.tiles[i, t, r, c].float())
            rows.append(sid[i] * TM + r)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        size=tuple(A.shape)).coalesce()
    return coo.to_sparse_csr()


def tile_part_csr(slab_ids, tiles, ncols):
    """A CUDA CSR (f32) of one tile-bucket launch's strips alone, ``(ns·TM,
    ncols)``: cuSPARSE's operand for that launch's product."""
    ns, _, TM, TK = tiles.shape
    i, t, r, c = tiles.nonzero(as_tuple=True)
    coo = torch.sparse_coo_tensor(
        torch.stack([i * TM + r, slab_ids.long()[i, t] * TK + c]),
        tiles[i, t, r, c].float(), size=(ns * TM, ncols)).coalesce()
    return coo.to_sparse_csr()


def _tile_items(ft, g, get, kernels, products):
    """#6 on the ECFP forward class panels, #5 on the transpose tiling's
    largest tile segment, #8 on that segment and config B's tile segment,
    each set beside cuSPARSE on the same rows."""
    from fastsparse_torch.bench.timing import BF16_OPS_PER_S, bound
    from fastsparse_torch.ops import bsr_ops as bo
    from fastsparse_torch.ops.kernels import bsr_tiles as TT

    D = get("opF").fwd.dense
    x_rows = D.seg_cols
    K_rows = len(D.segments) * x_rows
    D_csr = bsr_csr(D)
    pan = [(b.start_slab[s0:s1], b.panels[s0:s1], si * x_rows)
           for si, S in enumerate(D.segments)
           for b, s0, s1, _ in bo._bsr_layout(S)]
    pan_bytes = sum(p.numel() for _, p, _ in pan)
    pan_rows = sum(p.shape[0] * p.shape[1] for _, p, _ in pan)
    for N in (32, 128, 256):
        X = _x_panel(g, D.shape[1], D.shape[1], N)
        nq = bo._narrow_nq(N)
        if nq:
            Xg, fold = bo._pack_narrow_planes(X, K_rows, nq), False
        else:
            Xg, fold = bo._padded_x(X, K_rows, bo._round_up(N, 128)), "f32"
        kernels[f"panel_spmm ECFP fwd panels ({len(pan)} launches) N={N}"] = (
            lambda Xg=Xg, fold=fold: [
                TT.panel_spmm(st, pn, Xg, tile_k=128, fold=fold, row_base=rb)
                for st, pn, rb in pan], TILE_KEYS, len(pan),
            dict(bound(pan_bytes + Xg.numel() * Xg.element_size()
                       + pan_rows * Xg.shape[1] * 4, 6 * D.nnz * N,
                       BF16_OPS_PER_S),
                 library=f"cuSPARSE ECFP fwd panels N={N}"))
        kernels[f"cuSPARSE ECFP fwd panels N={N}"] = _library(D_csr, X)

    S = max(get("opT").bwd.dense.segments, key=lambda s: s.padded_tiles)
    S_csr = bsr_csr(S)
    K = S.n_slabs * S.tile_k
    tiles = [(b.slab_ids[s0:s1], b.tiles[s0:s1])
             for b, s0, s1, _ in bo._bsr_layout(S)]
    t_bytes = sum(t.numel() * 2 for _, t in tiles)
    t_rows = sum(t.shape[0] * t.shape[2] for _, t in tiles)
    for N in (32, 128):
        X = _x_panel(g, S.shape[1], S.shape[1], N)
        nq = bo._narrow_nq(N)
        if nq:
            Xp, planes = bo._pack_narrow_planes(X, K, nq), 1
        else:
            Xp, planes = bo._stack_planes(bo._padded_x(X, K, 128), 128,
                                          128), 3
        kernels[f"bucket_spmm ECFP bwd segment ({len(tiles)} launches, "
                f"{S.padded_tiles} padded tiles) N={N}"] = (
            lambda Xp=Xp, planes=planes: [
                TT.bucket_spmm(sl, t, Xp, n_block=128, planes=planes)
                for sl, t in tiles], TILE_KEYS, len(tiles),
            dict(bound(t_bytes + Xp.numel() * 2 + t_rows * 128 * 4,
                       6 * S.nnz * N, BF16_OPS_PER_S),
                 library=f"cuSPARSE ECFP bwd segment N={N}"))
        kernels[f"cuSPARSE ECFP bwd segment N={N}"] = _library(S_csr, X)

    for name, S in (("ECFP bwd", S),
                    ("config B", get("opBd").fwd.dense.segments[0])):
        x = _x_panel(g, S.shape[1], S.shape[1], 1)
        xp = bo._padded_x(x, S.n_slabs * S.tile_k, 1).reshape(S.n_slabs,
                                                             S.tile_k)
        parts = [(b.slab_ids[s0:s1], b.tiles[s0:s1])
                 for b, s0, s1, _ in bo._bsr_layout(S)]
        nbytes = sum(t.numel() * t.element_size() for _, t in parts)
        out = sum(t.shape[0] * t.shape[2] for _, t in parts)
        kernels[f"bucket_spmv {name} ({len(parts)} launches: "
                f"{[tuple(t.shape[:3]) for _, t in parts]})"] = (
            lambda parts=parts, xp=xp: [TT.bucket_spmv(sl, t, xp)
                                        for sl, t in parts],
            ("bucket_spmv_kernel",), len(parts),
            dict(bound(nbytes + xp.numel() * 4 + out * 4, 2 * S.nnz),
                 library=f"cuSPARSE {name} tile segment N=1"))
        kernels[f"cuSPARSE {name} tile segment N=1"] = _library(bsr_csr(S), x)
        for k, (sl, t) in enumerate(parts):
            kernels[f"bucket_spmv {name} launch {k} {tuple(t.shape[:3])}"] = (
                lambda sl=sl, t=t, xp=xp: TT.bucket_spmv(sl, t, xp),
                ("bucket_spmv_kernel",), 1,
                {"library": f"cuSPARSE {name} launch {k} strips N=1"})
            kernels[f"cuSPARSE {name} launch {k} strips N=1"] = _library(
                tile_part_csr(sl, t, S.shape[1]), x)


def _densecols_items(ft, g, get, kernels, products):
    """#7 on the ECFP forward dense-column block, beside torch._int_mm."""
    from fastsparse_torch.bench.timing import INT8_OPS_PER_S, bound
    from fastsparse_torch.ops.kernels import bsr_spmm as K
    from fastsparse_torch.ops.spmm import densecols_planes

    dc = get("opE").fwd.dense_cols
    for N in (1, 32, 128, 256):
        X = _x_panel(g, dc.shape[1], dc.shape[1], N)
        block = dc.block
        q3t, s = densecols_planes(X, dc.col_ids)
        nrow, D = block.shape
        kernels[f"densecols ECFP fwd block {tuple(block.shape)} N={N}"] = (
            lambda q3t=q3t, s=s: K.densecols_spmm(block, q3t, s),
            ("s8_engine_kernel", "densecols_kernel"), 1,
            bound(block.numel() + q3t.numel() + N * 4 + nrow * N * 4,
                  2 * nrow * D * 3 * N, INT8_OPS_PER_S))
        q3p = q3t
        if (3 * N) % 8:  # cuBLASLt's s8 GEMM wants 8-column multiples
            q3p = torch.zeros((-(-3 * N // 8) * 8, D), dtype=torch.int8,
                              device=q3t.device)
            q3p[: 3 * N] = q3t
        q3_cm = q3p.t()  # (D, 3N) column-major: cuBLASLt's B layout
        int_mm = (f"torch._int_mm ECFP fwd block ({q3p.shape[0]} plane "
                  f"columns) N={N}")
        kernels[int_mm] = (
            lambda q3_cm=q3_cm: torch._int_mm(block, q3_cm), ALL, None, {})
        _pair(kernels, f"densecols ECFP fwd block {tuple(block.shape)} N={N}",
              int_mm)


def _encode_items(ft, g, get, kernels, products):
    """`quant3_encode` (a fill, encode_colmax, encode_planes) on the
    headline's X at N=32 in the narrow layout (the forward tiling's K), on
    the ECFP forward dense-column rows at N = 32 and 256 and on R-MAT's hub
    rows at N=128, beside its bound: X's rows read once (and their ids),
    the planes and the scale written once."""
    from fastsparse_torch.bench.timing import bound
    from fastsparse_torch.ops.kernels import bsr_spmm as K

    keys = ("encode_colmax_kernel", "encode_planes_kernel", "FillFunctor")
    A = get("opH").fwd
    b = A.buckets[0]
    K_pad = b.n_windows * b.win_slabs * A.tile_k
    X = _x_panel(g, get("headline").shape[1], get("headline").shape[1], 32)
    kernels[f"quant3_encode headline narrow {tuple(X.shape)} K={K_pad} "
            "N=32"] = (
        lambda X=X: K.quant3_encode(X, k_rows=K_pad, n_pad=32, n_out=96),
        keys, 3, bound(X.numel() * 4 + 96 * K_pad + 32 * 4))
    for name, dc, N in (("ECFP fwd", get("opE").fwd.dense_cols, 32),
                        ("ECFP fwd", get("opE").fwd.dense_cols, 256),
                        ("rmat18 hub", get("opR").fwd.dense_cols, 128)):
        X = _x_panel(g, dc.shape[1], dc.shape[1], N)
        D = dc.col_ids.numel()
        kernels[f"quant3_encode {name} rows D={D} N={N}"] = (
            lambda X=X, dc=dc, D=D, N=N: K.quant3_encode(
                X, dc.col_ids, k_rows=D, n_pad=N, n_out=3 * N), keys, 3,
            bound(D * N * 4 + D * 4 + 3 * N * D + N * 4))


def _plan_items(ft, g, get, kernels, products):
    """plan_sum on each plan the main paths apply at N = 1, 32, 128, with
    -0.0 planted in its parts, beside its bound."""
    from card_helpers import tiling_plans  # tests/, on the path from main

    from fastsparse_torch.bench.timing import bound
    from fastsparse_torch.ops import assemble
    from fastsparse_torch.ops.ell_ops import _lanes

    plans = {**tiling_plans("configA.fwd", get("opA").fwd),
             **tiling_plans("configA.bwd", get("opA").bwd),
             **tiling_plans("configB.fwd", get("opB").fwd),
             **tiling_plans("ecfp.fwd", get("opE").fwd),
             **tiling_plans("ecfp.bwd", get("opE").bwd),
             **{k: v for k, v in tiling_plans("ecfp-auto.bwd",
                                               get("opT").bwd).items()
                if v[1] is not None},
             **tiling_plans("rmat18.fwd", get("opR").fwd)}
    gen = torch.Generator("cuda").manual_seed(29)
    for name, (plan, TM) in plans.items():
        nrow, S = plan.row_ptr.numel() - 1, plan.src.numel()
        live = int((plan.row_ptr[1:] > plan.row_ptr[:-1]).sum())
        for N in (1, 32, 128):
            L = _lanes(N)
            # a cross-segment plan sums its strips' rows (``row_srcs``) or
            # whole strips of TM rows; an ELL plan its part slots
            n, width = ((plan.n_slots * TM, L) if TM and plan.row_srcs else
                        (plan.n_slots, L * (TM or 1)))
            P = torch.randn((n, width), device="cuda", generator=gen)
            P[torch.rand(n, device="cuda", generator=gen) < 0.3] = -0.0
            kernels[f"plan_sum {name} ({nrow} rows, {S} sources, width "
                    f"{width}, {plan.n_levels} levels) N={N}"] = (
                lambda plan=plan, P=P: assemble.sum_plan(plan, P),
                ("plan_sum_kernel",), 1,
                bound((S + nrow) * width * 4 + (S + nrow + 1) * 4,
                      (S - live) * width))


def _spmv_items(ft, g, get, kernels, products):
    """#9 on config A's and config B's buckets, #10, and the SpMV
    products, each kernel beside cuSPARSE on the same rows."""
    from fastsparse_torch.ops import ell_ops
    from fastsparse_torch.ops.kernels import ell_spmm as EK

    mA, mB = get("A"), get("B")
    opA, opB = get("opA"), get("opB")
    A_unsplit = ft.build_ell(ft.coo_from_scipy(mA, device="cuda"),
                             split_rows=0, device="cuda")
    A_unsplit_bin = ft.build_ell(
        ft.binary_coo_from_scipy(mA, device="cuda"), split_rows=0,
        device="cuda")

    ncolA = mA.shape[1]
    XA = _x_panel(g, ncolA, ell_ops._round_up(ncolA + 1, 8), 128)
    big = max(opA.fwd.buckets, key=lambda b: b.cols.numel())
    segB = opB.fwd.segments[0]
    XB = _x_panel(g, segB.shape[1], ell_ops._round_up(segB.shape[1] + 1, 8),
                  128)
    bB = max((b for b in segB.buckets if b.width <= 64),
             key=lambda b: b.cols.numel())
    wide = max((b for b in A_unsplit.buckets if b.width > 64),
               key=lambda b: b.cols.numel())
    wideb = max((b for b in A_unsplit_bin.buckets if b.width > 64),
                key=lambda b: b.cols.numel())
    X_plain = _x_panel(g, ncolA, 65_544, 1)
    lanes = {N: (XA[:, :N].contiguous(), XB[:, :N].contiguous())
             for N in (1, 8)}
    lanes[128] = (XA, XB)

    def bucket(mode, b, x, unit, packed=None):
        """ell_bucket on one bucket, and cuSPARSE on the same rows."""
        name = f"{mode} {tuple(b.cols.shape)} N={x.shape[1]}"
        kernels[f"ell_bucket {name}"] = (
            lambda: EK.ell_bucket_spmm(b.cols, b.vals, x, unit=unit,
                                       packed=packed), ELL_KEYS, 1,
            {"library": f"cuSPARSE {name}"})
        vals = torch.ones_like(b.vals) if unit else b.vals
        kernels[f"cuSPARSE {name}"] = _library(
            gather_csr(b.cols, vals, x.shape[0]), x)

    for N in (1, 8, 128):
        bucket("valued_full", big, lanes[N][0], False)
    for N in (1, 128):
        bucket("packed_full", bB, lanes[N][1], True, bB.packed)
    bucket("valued_chunked", wide, lanes[1][0], False)
    bucket("packed_chunked", wideb, lanes[1][0], True, wideb.packed)
    bucket("unit_chunked", wideb, X_plain, True)
    _sweep_items(segB, {N: lanes[N][1] for N in (1, 128)}, kernels,
                 library=True)

    for name, op, m in (("config A SpMV", opA, mA),
                        ("config 2 SpMV (reorder='auto')",
                         ft.operator(mA, reorder="auto", transpose=False,
                                     dtype=torch.float32), mA),
                        ("config B SpMV (format='ell')", opB, mB),
                        ("ECFP matvec", get("opE"), get("E")),
                        ("config B reorder='degree' matvec", get("opBd"),
                         mB)):
        products[name] = _product(g, m, op.matvec, 1, vector=True)


def _table_items(ft, g, get, kernels, products):
    """`ell_table_spmm` on the ``powerlaw250k`` layout at N=1 (its tile
    table as the matvec builds it), the layout's per-part ell_bucket
    launches as one set, both against the bytes of the product: each slot's
    column and value, each slot-stream row written and X read once;
    cuSPARSE's CSR matvec on the same matrix; the matvec."""
    from fastsparse_torch.bench.timing import bound
    from fastsparse_torch.ops import ell_ops
    from fastsparse_torch.ops.kernels import ell_spmm as EK

    m, op = get("P"), get("opP")
    A = op.fwd
    X = torch.from_numpy(g.standard_normal((m.shape[1], 1)).astype(
        np.float32)).cuda()
    nw = ell_ops._narrow(A, 1, X.device)
    t = nw.table
    xt = torch.zeros((t.x_rows, 1), dtype=torch.float32, device="cuda")
    for off, ncol, x0 in nw.panels:
        xt[x0 : x0 + ncol] = X[off : off + ncol]
    slots = sum(p.n_rows * p.K for p in t.parts)
    work = bound(slots * 8 + t.n_slots * 4 + m.shape[1] * 4)
    table = f"ell_table powerlaw250k {len(t.tiles)} tiles N=1"
    kernels[table] = (lambda: EK.ell_table_spmm(t, xt), ("ell_table",), 1,
                      dict(work))
    chunks = []
    for off, seg in ell_ops._segments(A):
        xs = torch.zeros((ell_ops._round_up(seg.shape[1] + 1, 8), 1),
                         dtype=torch.float32, device="cuda")
        xs[: seg.shape[1]] = X[off : off + seg.shape[1]]
        for b, mode, s0, s1, n_pad in ell_ops._seg_layout(seg):
            _, cc, vv, _ = ell_ops._slice_chunk(b, seg, s0, s1, n_pad)
            chunks.append((cc, vv, xs))
    kernels[f"ell_bucket powerlaw250k {len(chunks)} launches N=1"] = (
        lambda: [EK.ell_bucket_spmm(c, v, xs) for c, v, xs in chunks],
        ELL_KEYS, len(chunks), dict(work))
    A_csr = torch.sparse_csr_tensor(
        torch.as_tensor(m.indptr, dtype=torch.int64),
        torch.as_tensor(m.indices, dtype=torch.int64),
        torch.as_tensor(m.data, dtype=torch.float32), size=m.shape).cuda()
    kernels["cuSPARSE powerlaw250k N=1"] = _library(A_csr, X)
    _pair(kernels, table, "cuSPARSE powerlaw250k N=1")
    products["powerlaw250k SpMV"] = _product(g, m, op.matvec, 1, vector=True)


def _table64_items(ft, g, get, kernels, products):
    """The table kernel's f64 mode on config 1's layout at N=1 (its tile
    table and plan as the matvec builds them), at 1,024-, 2,048- and
    4,096-slot tiles, against the least bytes of the product (8 bytes a
    stored value, x read and y written once in float64); its plan_sum;
    cuSPARSE's f64 CSR matvec on the same matrix; the matvec."""
    from fastsparse_torch.bench.timing import bound
    from fastsparse_torch.ops import assemble, ell_ops
    from fastsparse_torch.ops.kernels import ell_spmm as EK

    f64 = torch.float64
    m, op = get("1"), get("op1")
    A = op.fwd
    X = torch.from_numpy(g.standard_normal((m.shape[1], 1))).cuda()
    nw = ell_ops._narrow(A, 1, X.device, f64)
    xt = torch.zeros((nw.table.x_rows, 1), dtype=f64, device="cuda")
    for off, ncol, x0 in nw.panels:
        xt[x0 : x0 + ncol] = X[off : off + ncol]
    work = bound(8 * m.nnz + 8 * (m.shape[0] + m.shape[1]))
    parts = nw.table.parts
    kept = EK._TABLE_SLOTS
    try:
        for slots in (1024, 2048, 4096):
            EK._TABLE_SLOTS = slots
            t = EK.ell_table(parts, 1, False, nw.table.x_rows, "cuda", f64)
            name = (f"ell_table f64 fp64rand100k {slots}-slot tiles "
                    f"({len(t.tiles)}) N=1")
            kernels[name] = (lambda t=t: EK.ell_table_spmm(t, xt),
                             ("ell_table",), 1, dict(work))
            if slots == kept:
                main = name
    finally:
        EK._TABLE_SLOTS = kept
    out = EK.ell_table_spmm(nw.table, xt)
    kernels["plan_sum f64 fp64rand100k N=1"] = (
        lambda: assemble.sum_plan(nw.plan, out), ("plan_sum",), 1,
        dict(bound(8 * (nw.plan.src.numel() + m.shape[0]) + 4 * (
            nw.plan.src.numel() + m.shape[0]))))
    A_csr = torch.sparse_csr_tensor(
        torch.as_tensor(m.indptr, dtype=torch.int64),
        torch.as_tensor(m.indices, dtype=torch.int64),
        torch.as_tensor(m.data, dtype=f64), size=m.shape).cuda()
    kernels["cuSPARSE f64 fp64rand100k N=1"] = _library(A_csr, X)
    _pair(kernels, main, "cuSPARSE f64 fp64rand100k N=1")
    products["fp64rand100k SpMV (f32 x)"] = _product(g, m, op.matvec, 1,
                                                     vector=True)


def _csr_f64(cols, x2, vals=None):
    """cuSPARSE's f64 product of a bucket's rows (unit values, or
    ``vals``) with the f64 X that the panel ``x2`` holds as two planes: a
    yardstick item."""
    k_rows = x2.shape[0] // 2
    if vals is None:
        vals = torch.ones(cols.shape, dtype=torch.float64, device=cols.device)
    X64 = (x2[:k_rows].double() + x2[k_rows:].double()).contiguous()
    return _library(gather_csr(cols, vals, k_rows), X64)


def _sweep_items(seg, xs, kernels, library=False):
    """ell_sweep on a segment's first sweep item, as `ell_ops` launches
    it, for each X panel of ``xs`` (N -> panel), with its bound; with
    ``library``, cuSPARSE on the same rows at the widest X."""
    from fastsparse_torch.bench.timing import bound
    from fastsparse_torch.ops import ell_ops
    from fastsparse_torch.ops.kernels import ell_spmm as EK

    item = next(b for b, mode, *_ in ell_ops._seg_layout(seg)
                if mode == "sweep")
    flats, meta, cols = [], [], []
    for bb, t0, t1, np_ in item:
        _, cc, _, pp = ell_ops._slice_chunk(bb, seg, t0, t1, np_)
        flats.append(pp.reshape(-1))
        meta.append((np_, bb.cols.shape[1] // 2))
        cols.append(cc)
    flat, meta = torch.cat(flats), tuple(meta)
    flat_cols = torch.cat([c.reshape(-1) for c in cols])
    used, rows = int(torch.unique(flat_cols).numel()), sum(n for n, _ in meta)
    for N, x in xs.items():
        kernels[f"ell_sweep config B item {len(meta)} parts N={N}"] = (
            lambda x=x: EK.ell_sweep_spmm(flat, x, parts=meta),
            ("ell_sweep_kernel",), 1,
            bound(flat_cols.numel() * 2 + (used + rows) * N * 4,
                  flat_cols.numel() * N))
    if library:
        N = max(xs)
        x = xs[N]
        crow = torch.zeros(rows + 1, dtype=torch.int64, device=x.device)
        lens = torch.cat([torch.full((c.shape[0],), c.shape[1],
                                     device=x.device) for c in cols])
        crow[1:] = torch.cumsum(lens, 0)
        S = torch.sparse_csr_tensor(crow, flat_cols.long(),
                                    torch.ones(flat_cols.numel(),
                                               device=x.device),
                                    size=(rows, x.shape[0]))
        kernels[f"cuSPARSE ell_sweep config B item N={N}"] = _library(S, x)
        _pair(kernels, f"ell_sweep config B item {len(meta)} parts N={N}",
              f"cuSPARSE ell_sweep config B item N={N}")


def _smem_items(ft, g, get, kernels, products):
    """#11 on config A's whole buckets (the layout under the flag)."""
    from fastsparse_torch.ops import ell_ops
    from fastsparse_torch.ops.kernels import ell_spmm as EK

    mA, opA = get("A"), get("opAsmem")
    ell_ops.USE_SMEM_PATH = True
    try:
        whole = [b for b, mode, *_ in ell_ops._seg_layout(opA.fwd)
                 if mode == "smem"]
    finally:
        ell_ops.USE_SMEM_PATH = False
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
        kernels[f"cuSPARSE A {shape} N=1"] = _library(
            gather_csr(b.cols, b.vals, x.shape[0]), x)
        _pair(kernels, f"ell_bucket_smem A {shape} N=1",
              f"cuSPARSE A {shape} N=1")

    def flagged(v):
        ell_ops.USE_SMEM_PATH = True
        try:
            return opA.matvec(v)
        finally:
            ell_ops.USE_SMEM_PATH = False

    products["config A SpMV [USE_SMEM_PATH]"] = _product(
        g, mA, flagged, 1, vector=True)


def dd_work(cols, lanes, valued):
    """(bytes, f32 operations) of one dd launch: each slot's index (and
    value planes) read once, each gathered X row in both planes, both
    outputs written once; 25 operations a slot and lane (plus 4 a slot for
    the split of vh) valued, 8 unit."""
    nb, K = cols.shape
    slots = nb * K
    rows_used = int(torch.unique(cols).numel())
    nbytes = (slots * (12 if valued else 4) + rows_used * lanes * 8
              + nb * lanes * 8)
    ops = slots * lanes * (25 if valued else 8) + (4 * slots if valued else 0)
    return nbytes, ops


def _dd_items(ft, g, get, kernels, products):
    """#13 per bucket of config 2-fp64; #12 per bucket of config B unit;
    the dd launches of one spmm_dd as a set (config 2-fp64 and config 1:
    #13; config B unit: #12)."""
    from fastsparse_torch.bench.timing import bound
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
        kernels[name] = (fn, ("ell_dd",), 1, bound(*work))

    def run_all(items):
        for cols, vh, vl, x2 in items:
            if vh is None:
                DK.ell_bucket_spmm_dd(cols, x2)
            else:
                DK.ell_bucket_spmm_dd_valued(cols, vh, vl, x2)

    def named(items):
        """Indices of the bucket with the most slots and of the first with
        the longest rows."""
        K_max = max(c.shape[1] for c, *_ in items)
        big = max(range(len(items)), key=lambda i: items[i][0].numel())
        return big, next(i for i, it in enumerate(items)
                         if it[0].shape[1] == K_max)

    m2d, m1, mB = get("2d"), get("1"), get("B")
    A2d, A1, opBu = get("A2d"), get("A1"), get("opBu")
    items2, X2, seg2 = launches(A2d, 1)
    for si, (cols, vh, vl, x2) in zip(seg2, items2):
        one(f"dd_valued config2-fp64 seg{si} {tuple(cols.shape)} N=1",
            cols, vh, vl, x2)
    # the largest and the longest-row buckets at N=32 too; cuSPARSE's
    # f64 product of the same rows beside them
    items2w, _, _ = launches(A2d, 32)
    for i in sorted(set(named(items2))):
        cols, vh, vl, x2 = items2w[i]
        one(f"dd_valued config2-fp64 seg{seg2[i]} {tuple(cols.shape)} N=32",
            cols, vh, vl, x2)
        for N, x in ((1, items2[i][3]), (32, x2)):
            at = f"config2-fp64 seg{seg2[i]} {tuple(cols.shape)} N={N}"
            kernels[f"cuSPARSE f64 {at}"] = _csr_f64(
                cols, x, vh.double() + vl.double())
            _pair(kernels, f"dd_valued {at}", f"cuSPARSE f64 {at}")
    itemsB, XB, segB = launches(opBu.fwd, 32)
    for si, (cols, _, _, x2) in zip(segB, itemsB):
        one(f"dd_unit configB seg{si} {tuple(cols.shape)} N=32", cols, None,
            None, x2)
    itemsB1, _, _ = launches(opBu.fwd, 1)
    for i in sorted(set(named(itemsB))):
        cols, _, _, x2 = itemsB1[i]
        one(f"dd_unit configB seg{segB[i]} {tuple(cols.shape)} N=1",
            cols, None, None, x2)
        for N, x in ((1, x2), (32, itemsB[i][3])):
            at = f"configB seg{segB[i]} {tuple(cols.shape)} N={N}"
            kernels[f"cuSPARSE f64 {at}"] = _csr_f64(cols, x)
            _pair(kernels, f"dd_unit {at}", f"cuSPARSE f64 {at}")
    items1, X1, _ = launches(A1, 1)
    for name, (items, X), N, A, m in (
            ("dd_valued config2-fp64", (items2, X2), 1, A2d, m2d),
            ("dd_valued config1", (items1, X1), 1, A1, m1),
            ("dd_unit configB", (itemsB, XB), 32, opBu.fwd, mB)):
        work = [dd_work(c, N, vh is not None) for c, vh, _, _ in items]
        kernels[f"{name} all {len(items)} launches N={N}"] = (
            lambda items=items: run_all(items), ("ell_dd",), len(items),
            bound(sum(w[0] for w in work), sum(w[1] for w in work)))
        ref = m.astype(np.float64) @ X.cpu().numpy()
        products[f"{name.split()[1]} spmm_dd N={N}"] = (
            lambda v, A=A: ft.spmm_dd(A, v), X, ref)


def _other_items(ft, g, get, kernels, products):
    """#1 and #2 as in ``mono``; #10 on config B's first sweep item at
    N=128, with its bound (an item another group made is kept as it is)."""
    from fastsparse_torch.ops import ell_ops

    mine = {}
    _headline_prep(ft, get, mine)
    segB = get("opB").fwd.segments[0]
    XB = _x_panel(g, segB.shape[1], ell_ops._round_up(segB.shape[1] + 1, 8),
                  128)
    _sweep_items(segB, {128: XB}, mine)
    kernels.update({k: v for k, v in mine.items() if k not in kernels})


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper swapped for its plain PyTorch version (``f``
    for ``f_plain``; the items call the wrappers through their modules),
    and `sum_plan` for `plain_sum`."""
    from fastsparse_torch.ops import assemble
    from fastsparse_torch.ops.kernels import bsr_spmm, bsr_tiles, ell_dd
    from fastsparse_torch.ops.kernels import ell_spmm

    swaps = [(m, n, getattr(m, n + "_plain"))
             for m in (bsr_spmm, bsr_tiles, ell_dd, ell_spmm) for n in dir(m)
             if not n.startswith("_") and hasattr(m, n + "_plain")]
    swaps.append((assemble, "sum_plan", assemble.plain_sum))
    kept = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in kept:
            setattr(m, n, f)


def measure(ft, groups=GROUPS, get=None, root=""):
    """The JSON rows of every item of ``groups`` (the module docstring
    says what each holds). Event, queued and plain times are taken before
    the first profiler session."""
    from fastsparse_torch.bench.timing import (
        device_busy_ms,
        kernel_device_ms,
        time_cuda,
        time_queued,
    )

    kernels, products = setup(ft, groups, get)
    events = {name: time_cuda(fn) for name, (fn, *_) in kernels.items()}
    events.update({name: time_cuda(fn, x)
                   for name, (fn, x, _) in products.items()})
    # a set of launches is queued one call a batch (its host time would
    # outlast the spin kernel's hold)
    queued = {name: time_queued(fn, reps=max(1, 20 // (per_call or 1)))
              for name, (fn, _, per_call, _) in kernels.items()}
    # the plain versions run many torch ops a call: 3 calls after one
    with plain_versions():
        plain = {name: time_cuda(fn, reps=1, batches=3, warmup=1)["min_ms"]
                 for name, (fn, keys, _, _) in kernels.items()
                 if keys != ALL}

    def row(name, **kw):
        t = events[name]
        return {"root": str(root), "item": name, "event_min_ms": t["min_ms"],
                "event_median_ms": t["median_ms"], **kw}

    rows = []
    for name, (fn, keys, per_call, extra) in kernels.items():
        q = queued[name]
        rows.append(row(
            name, queued_ms=None if q is None else q["min_ms"],
            plain_ms=plain.get(name),
            device_ms=kernel_device_ms(fn, keys, per_call), **extra))
    for name, (fn, x, ref) in products.items():
        y = fn(x).double().cpu().numpy()
        rel = float(np.abs(y - ref).max() / np.abs(ref).max())
        busy, top = device_busy_ms(fn, x)
        median = events[name]["median_ms"]
        rows.append(row(
            name, rel=rel, device_busy_ms=busy,
            idle_share=None if busy is None else max(0.0, 1 - busy / median),
            top=[[ms, key[:80]] for ms, key in top]))
    return rows


def card_line():
    """The card's name and power limit (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated item groups: " + ", ".join(GROUPS))
    args = ap.parse_args(argv)
    groups = tuple(args.groups.split(","))
    if not set(groups) <= set(GROUPS):
        ap.error(f"--groups: choose from {GROUPS}")
    if not torch.cuda.is_available():
        print("kernels: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "tests")]
    import fastsparse_torch as ft

    if Path(ft.__file__).resolve().parents[1] != root:
        print(f"kernels: imported {ft.__file__}, not {root}", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    for r in measure(ft, groups, root=root):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
