"""The assembly plans' row-ordered schedule (`ops.assemble.plan_schedule`),
which the card's plan kernel (`kernels.assemble.plan_sum`) walks, on the
CPU: a plain numpy walk of each plan's schedule equals the torch ops the
kernel replaces there bit for bit (-0.0 included), on the ECFP hybrid's
plans, the small R-MAT layout's segmented-ELL plan and its row-granular
cross-segment plan (``row_srcs``), a segmented ELL of a power-law graph,
and the cross-segment plan's strip form (no ``row_srcs``). A plan loaded
through `interop` derives the same schedule as the built one.
"""
import numpy as np
import pytest
import torch

import fastsparse_torch as ft
from fastsparse_torch import interop
from fastsparse_torch.bench import model as tmodel
from fastsparse_torch.bench.matrices import ecfp_like, powerlaw
from fastsparse_torch.ops import assemble, bsr_ops

import rmat_layout

torch.set_num_threads(1)


def _walk(plan, parts):
    """Y (rows, L) of the schedule in numpy: slot by slot in order, one
    float32 add each; an empty row +0.0, a short ``row_srcs`` row + 0.0."""
    ptr = plan.row_ptr.numpy().astype(np.int64)
    src = plan.src.numpy().astype(np.int64)
    P = parts.numpy()
    cnt = np.diff(ptr)
    Y = np.zeros((len(cnt), P.shape[1]), np.float32)
    for j in range(int(cnt.max(initial=0))):
        rows = np.nonzero(cnt > j)[0]
        v = P[src[ptr[rows] + j]]
        Y[rows] = v if j == 0 else Y[rows] + v
    pad = np.nonzero((cnt > 0) & (cnt < plan.n_levels))[0]
    Y[pad] = Y[pad] + np.float32(0.0)
    return torch.from_numpy(Y)


def _parts(n, L, seed):
    """f32 (n, L) with -0.0 planted: whole rows, and single entries."""
    g = np.random.default_rng(seed)
    P = g.standard_normal((n, L)).astype(np.float32)
    P[g.random(n) < 0.3] = -0.0
    P[g.random((n, L)) < 0.1] = -0.0
    return torch.from_numpy(P)


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _check_classes(plan, L):
    parts = _parts(plan.n_slots, L, seed=L)
    want = assemble._apply_plan(plan, parts)
    got = _walk(plan, parts)
    assert _bits_equal(got, want)
    assert (want.view(torch.int32) == np.int32(-2**31)).any()  # -0.0 kept


def _check_colseg(plan, TM, Npad):
    """The cross-segment walk (`bsr_ops._colseg_sum`, CPU) against the
    schedule's, over random strip panels."""
    pcat = _parts(plan.n_slots * TM, Npad, seed=Npad).view(-1, TM, Npad)
    parts_all = list(pcat.split(max(plan.n_slots // 3, 1)))
    want = bsr_ops._colseg_sum(plan, parts_all, pcat, TM, Npad)
    rows = pcat.view(-1, Npad) if plan.row_srcs else pcat.view(-1, TM * Npad)
    got = _walk(plan, rows).view(-1, Npad)
    assert _bits_equal(got, want)


@pytest.fixture
def small_dense_cols(monkeypatch):
    monkeypatch.setattr(tmodel, "DENSE_COL_MIN_D", 4)
    monkeypatch.setattr(tmodel, "DENSE_COL_CELL_S", 2e-10)
    monkeypatch.setattr(tmodel, "DENSE_COL_MIN_ROWS", 64)


@pytest.fixture(scope="module")
def rmat_op():
    with pytest.MonkeyPatch.context() as mp:
        rmat_layout.shrink(mp)
        m = rmat_layout.matrix()
        yield ft.operator(m, reorder="auto", transpose=False, device="cpu")


@pytest.mark.parametrize("L", [1, 3, 8, 32])
@pytest.mark.parametrize("side", ["fwd", "bwd"])
def test_ecfp_plan_schedule_equals_apply_plan(small_dense_cols, side, L):
    op = ft.operator(ecfp_like(800, 2000, 24, 20, seed=2), device="cpu")
    plan = getattr(op, side).sparse.plan
    assert plan is not None and plan.n_levels == 0
    _check_classes(plan, L)


@pytest.mark.parametrize("L", [1, 128])
def test_rmat_ell_plan_schedule_equals_apply_plan(rmat_op, L):
    plan = rmat_op.fwd.sparse.plan
    assert type(rmat_op.fwd.sparse).__name__ == "SegmentedEll"
    assert max(plan.widths) > 2 and (plan.row_ptr.diff() == 0).any()
    _check_classes(plan, L)


@pytest.mark.parametrize("Npad", [8, 128])
def test_rmat_colseg_row_srcs_schedule_equals_walk(rmat_op, Npad):
    A = rmat_op.fwd.dense
    plan = A.plan
    assert type(A).__name__ == "ColSegmented" and plan.row_srcs
    cnt = plan.row_ptr.diff()
    assert plan.n_levels == len(plan.row_srcs) > 1
    # rows whose sources are all sentinels, and rows a sentinel follows
    assert (cnt == 0).any() and ((cnt > 0) & (cnt < plan.n_levels)).any()
    _check_colseg(plan, A.segments[0].tile_m, Npad)


def test_segmented_ell_plan_schedule_equals_apply_plan():
    m = powerlaw(2000, 60_000, 80_000, seed=2, binary=True)
    op = ft.operator(m, format="ell", device="cpu")
    assert type(op.fwd).__name__ == "SegmentedEll"
    _check_classes(op.fwd.plan, 16)


def test_colseg_strip_schedule_equals_walk(monkeypatch):
    """Without ``row_srcs`` (`_row_positions` past int32) the plan sums
    whole ``(TM, Npad)`` strips by its classes."""
    monkeypatch.setattr(assemble, "_row_positions", lambda *a: None)
    rmat_layout.shrink(monkeypatch)
    op = ft.operator(rmat_layout.matrix(), reorder="auto", transpose=False,
                     device="cpu")
    A = op.fwd.dense
    assert not A.plan.row_srcs and A.plan.n_levels == 0
    assert len(A.plan.row_ptr) == A.segments[0].n_strips + 1
    _check_colseg(A.plan, A.segments[0].tile_m, 8)


def test_loaded_plan_derives_the_same_schedule(rmat_op):
    d = interop.reference_arrays(rmat_op)
    loaded = interop.operator_from_reference_arrays(d, device="cpu")
    for built, got in ((rmat_op.fwd.sparse.plan, loaded.fwd.sparse.plan),
                       (rmat_op.fwd.dense.plan, loaded.fwd.dense.plan)):
        assert got.n_levels == built.n_levels
        assert torch.equal(got.row_ptr, built.row_ptr)
        assert torch.equal(got.src, built.src)


def test_schedule_of_a_small_plan():
    """Two classes and an empty row, and a row-granular plan whose rows
    end at their first sentinel (5)."""
    row_ptr, src, n_levels = assemble.plan_schedule(
        [np.array([[4], [0]]), np.array([[1, 3]])], np.array([1, 3, 2, 0]))
    assert row_ptr.tolist() == [0, 1, 1, 3, 4] and n_levels == 0
    assert src.tolist() == [0, 1, 3, 4]
    row_ptr, src, n_levels = assemble.plan_schedule(
        (), None, [np.array([2, 5, 0]), np.array([3, 5, 5])], zero_row=5)
    assert row_ptr.tolist() == [0, 2, 2, 3] and n_levels == 2
    assert src.tolist() == [2, 3, 0]
    with pytest.raises(ValueError, match="after a sentinel"):
        assemble.plan_schedule((), None, [np.array([5]), np.array([1])],
                               zero_row=5)



def test_sum_plan_runs_the_torch_ops_off_the_card(rmat_op):
    """`sum_plan` on CPU rows is `plain_sum`, bit for bit, on both plan
    forms, and `apply_plan` is `sum_plan` under its span."""
    TM = rmat_op.fwd.dense.segments[0].tile_m
    assert rmat_op.fwd.dense.plan.row_srcs
    for plan in (rmat_op.fwd.sparse.plan, rmat_op.fwd.dense.plan):
        n = plan.n_slots * TM if plan.row_srcs else plan.n_slots
        rows = _parts(n, 8, seed=5)
        want = assemble.plain_sum(plan, rows)
        assert _bits_equal(assemble.sum_plan(plan, rows), want)
        assert _bits_equal(_walk(plan, rows), want)
    plan = rmat_op.fwd.sparse.plan
    rows = _parts(plan.n_slots, 4, seed=6)
    assert _bits_equal(assemble.apply_plan(plan, rows),
                       assemble._apply_plan(plan, rows))


def test_a_plan_is_built_with_its_schedule():
    """The schedule is a required part of a plan, and a row-granular plan
    needs the strip height that places its zero row."""
    with pytest.raises(TypeError):
        assemble.AssemblyPlan(classes=(), rowpos=torch.zeros(0),
                              widths=(), n_slots=0, layout_key=())
    plan = assemble.make_plan((), np.array([0, 0]), (), 2, (), "cpu",
                              [np.array([1, 8]), np.array([8, 8])], tile_m=4)
    assert plan.row_ptr.tolist() == [0, 1, 1] and plan.src.tolist() == [1]
    assert plan.n_levels == 2
    with pytest.raises(TypeError):
        assemble.make_plan((), np.array([0]), (), 2, (), "cpu",
                           [np.array([1])])
