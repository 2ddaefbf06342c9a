"""BASELINE config 2, the f32 power-law SpMV, through `operator(m)` on the
CPU (the kernels' plain versions), at small sizes of the benchmark's
``powerlaw250k`` configuration: the same generator (alpha 1.6, 50 nonzeros
a row, standard-normal f32 values), format auto, no reorder, no dual
tiling (``transpose=False``, as the cell builds it).

* ``one``: 8,192², one `EllMatrix` (below ``SEG_COLS``; at 2,048² the
  tiles near the hubs are full enough for `format="bsr"`);
* ``segmented``: 4,096² with the column-segment cap lowered to 1,024, so
  that the layout is the 250,000² one's in kind: a `SegmentedEll` of 4
  segments whose parts one cross-segment assembly plan sums.

On each, ``matvec`` and ``matmat`` at N = 1 and 8 against the benchmark's
plain float64 reference (`benchmark/lib/reference.py`, loaded by path) at
BASELINE's fp32 bar, rel < 1e-6; and the ``ell_launch`` counter of an
eager call: 1 at X widths of at most 8 lanes (every part in one launch,
`ell_ops._table_product`), the parts the layout holds at N = 16.
"""
import numpy as np
import pytest
import torch

import fastsparse_torch as ft
from fastsparse_torch import linops, tracing
from fastsparse_torch.bench.matrices import powerlaw
from fastsparse_torch.formats.ell import EllMatrix, SegmentedEll
from fastsparse_torch.ops import ell_ops
import rmat_layout

torch.set_num_threads(1)
REF = rmat_layout.bench_lib("reference")
TOL = 1e-6  # BASELINE's fp32 rtol
PER_ROW = 50
SEG_CAP = 1024
INSTANCES = {"one": 8192, "segmented": 4096}


def _built(monkeypatch, case):
    n = INSTANCES[case]
    if case == "segmented":
        # the ELL's segment width is `_balanced_seg_cols`'s default cap,
        # bound to SEG_COLS when the module loaded
        monkeypatch.setattr(linops, "SEG_COLS", SEG_CAP)
        monkeypatch.setattr(linops._balanced_seg_cols, "__defaults__",
                            (SEG_CAP,))
    m = powerlaw(n, n, PER_ROW * n, seed=0, alpha=1.6)
    return m, ft.operator(m, transpose=False, device="cpu")


def _segments(A):
    return A.segments if isinstance(A, SegmentedEll) else [A]


@pytest.mark.parametrize("case", sorted(INSTANCES))
def test_layout_is_the_cells_kind(monkeypatch, case):
    m, op = _built(monkeypatch, case)
    A = op.fwd
    assert m.dtype == np.float32 and not np.all(m.data == 1.0)
    assert op.bwd is None and op.col_perm is None and op.row_perm is None
    if case == "one":
        assert type(A) is EllMatrix
        return
    assert type(A) is SegmentedEll and len(A.segments) == 4
    assert A.seg_cols == SEG_CAP
    assert A.plan is not None and all(s.plan is None for s in A.segments)
    assert all(not s.unit_vals for s in A.segments)


@pytest.mark.parametrize("name,N", [("matvec", 1), ("matmat", 1),
                                    ("matmat", 8)])
@pytest.mark.parametrize("case", sorted(INSTANCES))
def test_products_match_float64_reference(monkeypatch, case, name, N):
    m, op = _built(monkeypatch, case)
    g = torch.Generator().manual_seed(2**31 + 7)
    shape = (m.shape[1],) if name == "matvec" else (m.shape[1], N)
    x = torch.randn(shape, generator=g)
    y = getattr(op, name)(x)
    want = getattr(REF.Reference(m, "cpu"), name)(x)
    assert y.dtype == torch.float32 and tuple(y.shape) == tuple(want.shape)
    rel = REF.rel_gap(y, want)
    assert rel < TOL, rel


@pytest.mark.parametrize("name,N", [("matvec", 1), ("matmat", 8),
                                    ("matmat", 16)])
@pytest.mark.parametrize("case", sorted(INSTANCES))
def test_ell_launch_counts_the_layouts_parts(monkeypatch, case, name, N):
    m, op = _built(monkeypatch, case)
    parts = sum(len(list(ell_ops._seg_layout(s))) for s in _segments(op.fwd))
    assert parts > 1
    if N <= 8:
        parts = 1  # one launch over the layout's tile table
    x = torch.randn((m.shape[1],) if name == "matvec" else (m.shape[1], N))
    with tracing.recording() as rec:
        getattr(op, name)(x)
    assert rec.counts["ell_launch"] == parts
    (ell,) = [s for s in rec.spans if s.name == "ell_ops"]
    assert ell.counts["ell_launch"] == parts
    with tracing.recording() as rec:
        getattr(op, name)(x)
    assert rec.counts["ell_launch"] == parts  # every eager call alike
