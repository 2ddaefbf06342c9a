"""BASELINE config 1, the fp64 SpMV (100,000², ~50 nonzeros a row drawn
uniformly, rtol 1e-10), through `operator(m)` on the CPU, at 4,096²
twins of the benchmark's ``fp64rand100k`` configuration: the suite's
`powerlaw` generator at alpha 1.0, float64 values, ``format="ell"``.

* ``one``: one `EllMatrix` (below ``SEG_COLS``);
* ``segmented``: the column-segment cap lowered to 1,024 in both
  packages, so the layout is the 100,000² one's in kind: a `SegmentedEll`
  of 4 unsplit f64 segments, with no assembly plan at build.

On each, ``matvec`` and ``matmat`` at N = 1, 3, 8 and 16, for a float64
and a float32 operand, within 1e-13 (rel) of a plain float64 reference
(`f64_reference`: gather, scale, ``index_add_`` from the scipy triples)
and of the JAX package's operator; on the CPU they run the reference's
per-bucket scan (span ``ell_scan``, one ``ell_scan`` a bucket, no
``ell_launch``). The card's path, the table kernel's f64 mode, is run
here by its plain twin (`ell_ops.ell_spmm` called directly): its product
at N <= 8 within 1e-13 of the reference, its tile table at f64 (values
at 8 bytes, the f64 stage), and its plan over the segments' parts.
"""
import numpy as np
import pytest
import torch

import fastsparse_torch as ft
from fastsparse_torch import linops, tracing
from fastsparse_torch.bench.matrices import powerlaw
from fastsparse_torch.formats.ell import EllMatrix, SegmentedEll
from fastsparse_torch.ops import ell_ops
from fastsparse_torch.ops.kernels import ell_spmm as ek

import f64_reference as ref

torch.set_num_threads(1)
TOL = 1e-13
N_SIDE = 4096
PER_ROW = 50
SEG_CAP = 1024
CASES = ("one", "segmented")


def _shrink(monkeypatch, reference=False):
    """The column-segment cap at SEG_CAP in the port (and the reference)."""
    mods = [linops]
    if reference:
        from fastsparse import linops as jlinops
        mods.append(jlinops)
    for mod in mods:
        monkeypatch.setattr(mod, "SEG_COLS", SEG_CAP)
        monkeypatch.setattr(mod._balanced_seg_cols, "__defaults__",
                            (SEG_CAP,))


def _matrix():
    return powerlaw(N_SIDE, N_SIDE, PER_ROW * N_SIDE, seed=0, alpha=1.0,
                    dtype=np.float64)


def _built(monkeypatch, case, reference=False):
    if case == "segmented":
        _shrink(monkeypatch, reference)
    m = _matrix()
    return m, ft.operator(m, format="ell", transpose=False, device="cpu")


def _operand(m, name, N, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (m.shape[1],) if name == "matvec" else (m.shape[1], N)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _segments(A):
    return A.segments if isinstance(A, SegmentedEll) else [A]


@pytest.mark.parametrize("case", CASES)
def test_layout_is_the_cells_kind(monkeypatch, case):
    m, op = _built(monkeypatch, case)
    A = op.fwd
    assert m.dtype == np.float64 and op.bwd is None
    assert A.dtype == torch.float64 and A.plan is None
    assert all(s.split_rows == 0 and not s.unit_vals for s in _segments(A))
    if case == "one":
        assert type(A) is EllMatrix
    else:
        assert type(A) is SegmentedEll and len(A.segments) == 4
    # rows drawn uniformly: 50 a row on average, none past twice that
    lens = np.diff(m.indptr)
    assert 40 < lens.mean() < 60 and lens.max() < 2 * PER_ROW


PRODUCTS = [("matvec", 1)] + [("matmat", n) for n in (1, 3, 8, 16)]


@pytest.mark.parametrize("xdtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,N", PRODUCTS)
@pytest.mark.parametrize("case", CASES)
def test_products_match_plain_reference_and_jax(monkeypatch, case, name, N,
                                                xdtype):
    import jax.numpy as jnp

    import fastsparse as fs

    m, op = _built(monkeypatch, case, reference=True)
    x = _operand(m, name, N, xdtype, seed=2**31 + N)
    with tracing.recording() as rec:
        y = getattr(op, name)(x)
    assert y.dtype == torch.float64 and tuple(y.shape) == (
        (m.shape[0],) if name == "matvec" else (m.shape[0], N))
    want = ref.matmat(m, x)
    assert ref.rel(y, want) < TOL
    op_j = fs.operator(m, format="ell", transpose=False)
    y_j = np.array(getattr(op_j, name)(jnp.asarray(x.double().numpy())))
    assert ref.rel(y, torch.from_numpy(y_j)) < TOL
    # the CPU keeps the reference's scan: one ell_scan a bucket
    buckets = sum(len(s.buckets) for s in _segments(op.fwd))
    assert rec.counts.get("ell_scan") == buckets
    assert "ell_launch" not in rec.counts
    assert [s.attrs for s in rec.spans if s.name == "ell_scan"] == [
        {"dtype": "float64"}]


@pytest.mark.parametrize("N", [1, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_table_path_f64_matches_reference(monkeypatch, case, N):
    """The card's path, its kernel's plain twin here: one f64 tile table
    over every part, the slot stream summed by the plan built with it."""
    m, op = _built(monkeypatch, case)
    A = op.fwd
    assert not ell_ops.gather_engine_supported(
        torch.float64, A, torch.zeros((1, N), dtype=torch.float64))
    X = _operand(m, "matmat", N, torch.float64, seed=7 + N)
    with tracing.recording() as rec:
        Y = ell_ops.ell_spmm(A, X)
    assert Y.dtype == torch.float64 and Y.shape == (m.shape[0], N)
    assert ref.rel(Y, ref.matmat(m, X)) < TOL
    assert rec.counts["ell_launch"] == 1 and "ell_scan" not in rec.counts
    (span,) = [s for s in rec.spans if s.name == "ell_ops"]
    assert span.attrs == {"dtype": "float64"}
    # an f32 operand widens exactly into the f64 buffer
    Y32 = ell_ops.ell_spmm(A, X.float())
    assert torch.equal(Y32, ell_ops.ell_spmm(A, X.float().double()))
    nw = ell_ops._narrow(A, ell_ops._lanes(N), "cpu", torch.float64)
    assert nw.plan is not None and nw.plan.n_slots == nw.table.n_slots
    if case == "segmented":  # a row's parts, one a segment
        assert max(nw.plan.widths) == len(A.segments)


@pytest.mark.parametrize("L", [1, 8])
@pytest.mark.parametrize("case", CASES)
def test_f64_table_tiles(monkeypatch, case, L):
    m, op = _built(monkeypatch, case)
    A = op.fwd
    t = ell_ops._narrow(A, L, "cpu", torch.float64).table
    assert t.dtype == torch.float64 and not t.unit
    stage = ek._TABLE_SLOTS // L
    out_row = t.tiles[:, 2] & 0xFFFFFFFF
    n_rows = t.tiles[:, 3] & 0xFFFFFFFF
    K = t.tiles[:, 4] & 0xFFFFFFFF
    staged = t.tiles[:, 5] & 4 > 0
    assert np.all(staged == (K <= stage))
    assert np.all(n_rows[staged] * K[staged] <= stage)
    starts = np.cumsum([0] + [pt.n_rows for pt in t.parts])
    tp = np.searchsorted(starts, out_row, side="right") - 1
    for p, pt in enumerate(t.parts):
        sel = np.nonzero(tp == p)[0]
        r0 = pt.row0 + out_row[sel] - starts[p]
        assert pt.vals.dtype == torch.float64
        assert np.array_equal(t.tiles[sel, 1], r0 * pt.K * 8)
        assert np.array_equal(t.tiles[sel, 0], r0 * pt.K * 4)
    with pytest.raises(TypeError, match="values in a"):
        ek.ell_table(t.parts, L, False, t.x_rows, "cpu", torch.float32)


def test_f32_operand_on_a_binary_layout_takes_f64():
    """0/1 values under a float64 X: a unit layout (f32 values of 1), its
    product in float64 on the twin and on the CPU's scan alike."""
    m = powerlaw(3000, 3000, 60_000, seed=3, binary=True)
    op = ft.operator(m, format="ell", transpose=False, device="cpu")
    X = _operand(m, "matmat", 4, torch.float64, seed=11)
    want = ref.matmat(m, X)
    Y = ell_ops.ell_spmm(op.fwd, X)
    assert Y.dtype == torch.float64 and ref.rel(Y, want) < TOL
    assert ref.rel(op.matmat(X), want) < TOL
