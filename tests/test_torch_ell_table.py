"""The narrow products' one launch (`ops.kernels.ell_spmm.ell_table`,
`ell_table_spmm`) on the CPU, the kernel's plain twin standing in for it.

On six small layouts that hold every body the per-part kernels run at X
widths of at most 8 lanes: a valued `EllMatrix` (rows split at 64), a
valued `SegmentedEll` of 4 segments, a binary `SegmentedEll` of 3 (packed
pairs, merged sweeps), and layouts built unsplit (chunked rows past 64
entries, rows wider than a tile's stage): valued, binary on packed pairs
(sweeps off), and binary past 65,536 columns on plain columns:

* the tile table covers every slot of every part once, in the layout's
  order, at the offsets the plan's ``n_slots`` counts, each tile with the
  body `_body_mode` (a sweep: the whole-row packed body) gives its part;
* `ell_table_spmm` is bit-equal to the per-part kernels' outputs
  concatenated (`ell_ops._seg_parts`, their plain versions here) at 1, 2,
  3, 4 and 8 lanes;
* a product through the table path is bit-equal to one through the
  per-part path, with the plan and, on a layout without one, the row
  ``index_add_``.
"""
import numpy as np
import pytest
import torch

import fastsparse_torch as ft
from fastsparse_torch import linops
from fastsparse_torch.bench.matrices import powerlaw
from fastsparse_torch.ops import assemble, ell_ops
from fastsparse_torch.ops.kernels import ell_spmm as ek

torch.set_num_threads(1)
SEG_CAP = 1024


def matrix(case, dtype=np.float32):
    """The case's scipy matrix, its values (valued cases) in ``dtype``."""
    if case == "valued":
        m = powerlaw(3000, 3000, 60_000, seed=1)
    elif case == "segmented":
        m = powerlaw(4096, 4096, 50 * 4096, seed=0)
    elif case == "binary":
        return powerlaw(2000, 60_000, 80_000, seed=2, binary=True)
    else:
        # past 65,536 X rows a binary layout keeps plain columns
        m = powerlaw(3000, 70_000 if case == "binary_wide" else 3000, 90_000,
                     seed=3, binary=case.startswith("binary"))
    return m if case.startswith("binary") else m.astype(dtype)


def operator(monkeypatch, case, device="cpu", dtype=np.float32):
    """``(m, op)`` of the cases `operator` builds (with their plans)."""
    m = matrix(case, dtype)
    if case == "valued":
        return m, ft.operator(m, format="ell", transpose=False, device=device)
    if case == "segmented":
        monkeypatch.setattr(linops, "SEG_COLS", SEG_CAP)
        monkeypatch.setattr(linops._balanced_seg_cols, "__defaults__",
                            (SEG_CAP,))
        return m, ft.operator(m, transpose=False, device=device)
    return m, ft.operator(m, format="ell", transpose=False, device=device)


def layout(monkeypatch, case, device="cpu", dtype=np.float32):
    """The case's ELL layout on ``device`` (valued cases' values in
    ``dtype``)."""
    if case in ("valued", "segmented", "binary"):
        return operator(monkeypatch, case, device, dtype)[1].fwd
    binary = case.startswith("binary")
    if case == "binary_unsplit":
        # each packed chunk on its own body (merged, every one is a
        # sweep's whole-row sub-part)
        monkeypatch.setattr(ell_ops, "USE_SWEEP", False)
    m = matrix(case, dtype)
    coo = (ft.binary_coo_from_scipy if binary
           else ft.coo_from_scipy)(m, device=device)
    return ft.build_ell(coo, split_rows=0, device=device)


CASES = ("valued", "segmented", "binary", "valued_unsplit", "binary_unsplit",
         "binary_wide")


def _segs(A):
    return ell_ops._segments(A)


def _x(A, N, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((A.shape[1], N), generator=g)


def panels(A, X, L):
    """The per-part path's X panels: each segment's columns, zero padded
    to its rows (the sentinel row) and to L lanes."""
    out = []
    for off, seg in _segs(A):
        rows_pad = ell_ops._round_up(max(seg.shape[1] + 1, 8), 8)
        xs = X.new_zeros((rows_pad, L))
        xs[: seg.shape[1], : X.shape[1]] = X[off : off + seg.shape[1]]
        out.append(xs)
    return out


def table_x(nw, X, L):
    """The table path's one X buffer, as `ell_ops._table_product` fills it."""
    x = X.new_zeros((nw.table.x_rows, L))
    for off, ncol, x0 in nw.panels:
        x[x0 : x0 + ncol, : X.shape[1]] = X[off : off + ncol]
    return x


@pytest.mark.parametrize("L", [1, 8])
@pytest.mark.parametrize("case", CASES)
def test_table_covers_the_layouts_slots(monkeypatch, case, L):
    A = layout(monkeypatch, case)
    nw = ell_ops._narrow(A, L, "cpu")
    t = nw.table
    stage = ek._TABLE_SLOTS // L
    tiles = t.tiles
    out_row, x_row = (tiles[:, 2] & 0xFFFFFFFF), tiles[:, 2] >> 32
    n_rows, n_src = tiles[:, 3] & 0xFFFFFFFF, tiles[:, 3] >> 32
    K, KB, flags = tiles[:, 4] & 0xFFFFFFFF, tiles[:, 4] >> 32, tiles[:, 5]
    # in output order, each tile's rows right after the last one's
    assert out_row[0] == 0 and np.array_equal(out_row[1:],
                                              (out_row + n_rows)[:-1])
    starts = np.cumsum([0] + [pt.n_rows for pt in t.parts])
    tp = np.searchsorted(starts, out_row, side="right") - 1  # tile's part
    # the parts: `_seg_layout`'s items (a sweep's sub-parts) in order
    want, x0 = [], 0
    for off, seg in _segs(A):
        rows_pad = ell_ops._round_up(max(seg.shape[1] + 1, 8), 8)
        for b, mode, s0, s1, n_pad in ell_ops._seg_layout(seg):
            subs = b if mode == "sweep" else ((b, s0, s1, n_pad),)
            for bb, t0, t1, np_ in subs:
                k = bb.cols.shape[1]
                body = ((k, True, True) if mode == "sweep"
                        else ek._body_mode(k, rows_pad, seg.unit_vals))
                want.append((bb, t0, t1 - t0, np_, k, body, x0))
        x0 += rows_pad
    assert t.x_rows == x0 and len(t.parts) == len(want)
    row = 0
    for p, (pt, (bb, t0, n, np_, k, body, x0)) in enumerate(zip(t.parts,
                                                                 want)):
        assert (pt.row0, pt.n_src, pt.n_rows, pt.K, pt.x_row0) == (
            t0, n, np_, k, x0)
        assert (pt.KB, pt.full) == body[:2] and pt.packed <= body[2]
        kept = bb.packed if pt.packed else bb.cols
        assert pt.idx.data_ptr() == kept.data_ptr()
        sel = np.nonzero(tp == p)[0]
        # the part's rows, real rows first, at its offsets
        assert out_row[sel[0]] == row == starts[p]
        assert n_rows[sel].sum() == np_ and n_src[sel].sum() == n
        r0 = out_row[sel] - row
        assert np.array_equal(n_src[sel], np.clip(n - r0, 0, n_rows[sel]))
        kw = k // 2 if pt.packed else k
        assert np.array_equal(tiles[sel, 0], (t0 + r0) * kw * 4)
        if not t.unit:
            assert np.array_equal(tiles[sel, 1], (t0 + r0) * k * 4)
        assert np.all(x_row[sel] == x0) and np.all(K[sel] == k)
        assert np.all(KB[sel] == body[0])
        assert np.all((flags[sel] & 1 > 0) == body[1])
        assert np.all((flags[sel] & 2 > 0) == pt.packed)
        staged = flags[sel] & 4 > 0
        assert np.all(staged == (k <= stage))
        assert np.all(n_rows[sel][staged] * k <= stage)
        row += np_
    assert t.n_slots == row
    if A.plan is not None:
        assert A.plan.n_slots == t.n_slots
    if case == "valued_unsplit" and L == 8:
        assert not np.all(flags & 4)  # rows past the stage, walked
    packed = flags & 2 > 0
    assert t.unit == case.startswith("binary")
    assert np.all(packed) if case in ("binary", "binary_unsplit") else (
        not np.any(packed))
    if case.endswith("unsplit") or case == "binary_wide":
        assert np.any(~flags & 1)  # chunked rows


@pytest.mark.parametrize("N", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_table_twin_equals_the_per_part_outputs(monkeypatch, case, N):
    A = layout(monkeypatch, case)
    L = ell_ops._lanes(N)
    X = _x(A, N, seed=N)
    rids, parts = [], []
    for (off, seg), xs in zip(_segs(A), panels(A, X, L)):
        ell_ops._seg_parts(seg, xs, rids, parts)
    want = torch.cat(parts)
    nw = ell_ops._narrow(A, L, "cpu")
    got = ek.ell_table_spmm(nw.table, table_x(nw, X, L))
    assert got.shape == want.shape == (nw.table.n_slots, L)
    assert torch.equal(got, want)
    assert torch.equal(ell_ops._slot_rows(nw), torch.cat(rids).long())


@pytest.mark.parametrize("N", [1, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_table_product_equals_the_per_part_product(monkeypatch, case, N):
    A = layout(monkeypatch, case)
    assert (A.plan is None) == (case in ("valued_unsplit", "binary_unsplit",
                                         "binary_wide"))
    if A.plan is not None:
        assert A.plan.layout_key == assemble.layout_key()
    X = _x(A, N, seed=10 + N)
    got = ell_ops.ell_spmm(A, X)
    monkeypatch.setattr(ell_ops, "TABLE_MAX_LANES", 0)  # one launch a part
    want = ell_ops.ell_spmm(A, X)
    assert got.shape == (A.shape[0], N) and torch.equal(got, want)
