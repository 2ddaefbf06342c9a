"""`fastsparse_torch.tracing`: spans and counters inside the port (CPU,
the kernels' plain versions).

* Off, `span` hands out one shared no-op and reads no clock; a recording
  restores that default when it ends, also when its block raises.
* On, spans nest with the right parents and roots, self time is the
  duration less the children, and a span closes when its body raises.
* Each span's ``ops`` equals the device operations its own code issues,
  checked against the aten ops PyTorch dispatches inside it (with the
  kernels' plain versions, which stand in for one launch on the card,
  left out), over the mono, tile, panel, ELL, hybrid, dense-column,
  permutation-boundary and CG paths, and over the R-MAT graph's layout,
  which holds all of them but mono; an ``assemble`` span's equals what
  its plan's widths imply; ``encode_kernel`` (the X encoder's launches)
  reads nothing on the CPU.
* ``cg.sync`` spans, and the ``syncs`` counter, count the solve's
  read-backs: one an iteration, and one more when the tolerance stops it.
"""
import collections
import importlib
import pkgutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import fastsparse_torch as ft
from fastsparse_torch import tracing
from fastsparse_torch.bench import model as tmodel
from fastsparse_torch.bench.matrices import ecfp_like

import rmat_layout

torch.set_num_threads(1)


def _clock(monkeypatch, start=1000, step=10):
    """perf_counter_ns as a counter: each read adds ``step``."""
    t = [start]

    def now():
        t[0] += step
        return t[0]
    monkeypatch.setattr(tracing.time, "perf_counter_ns", now)


def test_off_span_is_shared_and_reads_no_clock(monkeypatch):
    def boom():
        raise AssertionError("the clock was read with tracing off")
    monkeypatch.setattr(tracing.time, "perf_counter_ns", boom)
    a, b = tracing.span("product", op="matmat", N=4), tracing.span("x")
    assert a is b
    with a as got:
        tracing.count(3)
        tracing.count(1, "syncs")
    assert got is None
    with pytest.raises(AssertionError, match="clock was read"):
        with tracing.recording():
            with tracing.span("product"):
                pass


def test_spans_nest_with_parents_roots_and_self_time(monkeypatch):
    _clock(monkeypatch)
    with tracing.recording() as rec:
        with tracing.span("product", op="matmat", N=8) as p:
            tracing.count(2)
            with tracing.span("hybrid") as h:
                tracing.count()
                with tracing.span("ell_ops") as e:
                    tracing.count(4)
                with tracing.span("assemble") as a:
                    tracing.count(6)
        with tracing.span("cg.solve") as c:
            tracing.count(1, "syncs")
        tracing.count(5)  # outside any span: the totals only
    assert rec.spans == [p, h, e, a, c]
    assert [s.parent for s in rec.spans] == [None, p, h, h, None]
    assert [s.root for s in rec.spans] == [p, p, p, p, c]
    assert p.attrs == {"op": "matmat", "N": 8}
    for s in rec.spans:
        kids = [k for k in rec.spans if k.parent is s]
        assert s.self_ns == (s.t1 - s.t0) - sum(k.t1 - k.t0 for k in kids)
        assert s.t0 < s.t1
    assert h.self_ns > 0 and e.self_ns == e.t1 - e.t0
    assert [s.counts for s in rec.spans] == [
        {"ops": 2}, {"ops": 1}, {"ops": 4}, {"ops": 6}, {"syncs": 1}]
    assert rec.counts == {"ops": 18, "syncs": 1}


def test_span_closes_when_its_body_raises(monkeypatch):
    _clock(monkeypatch)
    with tracing.recording() as rec:
        with pytest.raises(ValueError):
            with tracing.span("product") as p:
                with tracing.span("bsr_ops"):
                    raise ValueError("refused shape")
        with tracing.span("product") as q:
            pass
    inner = rec.spans[1]
    assert inner.t1 is not None and p.t1 is not None
    assert inner.parent is p and q.parent is None and q.root is q


def test_recording_restores_the_default():
    off = tracing.span("x")
    with pytest.raises(RuntimeError, match="boom"):
        with tracing.recording():
            assert tracing.span("x") is not off
            raise RuntimeError("boom")
    assert tracing.span("x") is off
    with tracing.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.recording():
                pass
    assert tracing.span("x") is off


# ------------------------------------------------ ops against the dispatcher
_NO_DEVICE_WORK = {"empty.memory_format", "empty_strided.default",
                   "new_empty.default", "empty_like.default",
                   "lift_fresh.default", "alias.default",
                   "promote_types.default"}


def _device_ops(func, args) -> int:
    """Device operations one aten op runs on the card: none for a view or
    an allocation; ``constant_pad_nd`` a fill and a copy (one copy when no
    pad is positive); ``is_nonzero`` (``bool(t)``) the copy back;
    ``scalar_tensor`` (a Python scalar of a ``where``) a fill on the card.
    A column reduction of a tall operand also clears its semaphores on the
    card (a memset), by torch's heuristics: not counted here or there."""
    name = str(func).split("aten.")[-1]
    ret = func._schema.returns
    if ret and ret[0].alias_info is not None and not ret[0].alias_info.is_write:
        return 0
    if name in _NO_DEVICE_WORK:
        return 0
    if name.startswith("constant_pad_nd"):
        return 2 if any(p > 0 for p in args[1]) else 1
    return 1


class _Dispatched(TorchDispatchMode):
    """Device ops of the aten ops dispatched, by the innermost open span."""

    def __init__(self):
        super().__init__()
        self.by_span = collections.Counter()
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            stack = tracing._active._stack
            self.by_span[stack[-1] if stack else None] += _device_ops(func,
                                                                      args)
        return out


def _dispatched(monkeypatch, fn):
    """Run ``fn`` under a recording and the dispatch counter, the kernels'
    plain versions uncounted (on the card each is one launch, which the
    wrapper counts there). Returns (recording, counter)."""
    d = _Dispatched()
    pkg = importlib.import_module("fastsparse_torch.ops.kernels")
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name in [k for k in vars(mod) if k.endswith("_plain")]:
            def paused(*a, _f=getattr(mod, name), **kw):
                d.paused += 1
                try:
                    return _f(*a, **kw)
                finally:
                    d.paused -= 1
            monkeypatch.setattr(mod, name, paused)
    with tracing.recording() as rec, d:
        fn()
    return rec, d


def _binary(r, c, shape):
    m = sp.coo_matrix((np.ones(len(r), np.float32), (r, c)), shape=shape)
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()


def _banded():
    g = np.random.default_rng(3)
    r = g.integers(0, 600, 36000)
    c = np.clip(r * 900 // 600 + g.integers(0, 200, r.size), 0, 899)
    return _binary(r, c, (600, 900))


def _scattered():
    g = np.random.default_rng(0)
    return _binary(g.integers(0, 400, 400), g.integers(0, 6400, 400),
                   (400, 6400))


def _clustered():
    g = np.random.default_rng(11)
    rp, cp = g.permutation(1200), g.permutation(4000)
    rs = [rp[b * 48:(b + 1) * 48][g.integers(0, 48, 2500)] for b in range(4)]
    cs = [cp[b * 150:(b + 1) * 150][g.integers(0, 150, 2500)]
          for b in range(4)]
    rs.append(g.integers(0, 1200, 2000))
    cs.append(g.integers(0, 4000, 2000))
    return _binary(np.concatenate(rs), np.concatenate(cs), (1200, 4000))


def _powerlaw():
    g = np.random.default_rng(7)
    deg = np.minimum((g.pareto(1.2, 3000) * 4 + 1).astype(int), 600)
    r = np.repeat(np.arange(3000), deg)
    c = g.integers(0, 2500, r.size)
    m = sp.coo_matrix((g.standard_normal(r.size).astype(np.float32), (r, c)),
                      shape=(3000, 2500))
    m.sum_duplicates()
    return m.tocsr()


@pytest.fixture
def small_dense_cols(monkeypatch):
    monkeypatch.setattr(tmodel, "DENSE_COL_MIN_D", 4)
    monkeypatch.setattr(tmodel, "DENSE_COL_CELL_S", 2e-11)
    monkeypatch.setattr(tmodel, "DENSE_COL_MIN_ROWS", 64)


CASES = {
    "mono": (_banded, {"format": "bsr"}),
    "tiles": (_scattered, {"format": "bsr"}),
    "ell": (_powerlaw, {"format": "ell"}),
    "hybrid_densecols": (lambda: ecfp_like(800, 2000, 24, 20, seed=2), {}),
    "tilepack_boundary": (_clustered, {"reorder": "tilepack"}),
    "degree_boundary": (_powerlaw, {"reorder": "degree", "format": "ell"}),
    # every part kind of the scale-18 Graph 500 layout (`rmat_layout`)
    "rmat_auto": (rmat_layout.matrix, {"reorder": "auto"}),
}
SHRINK = {"rmat_auto": rmat_layout.shrink}


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_ops_equal_dispatched_ops(monkeypatch, small_dense_cols, case):
    make, kw = CASES[case]
    SHRINK.get(case, lambda mp: None)(monkeypatch)
    m = make()
    op = ft.operator(m, device="cpu", **kw)
    g = torch.Generator().manual_seed(5)
    nrow, ncol = m.shape
    XY = [(torch.randn((ncol, N), generator=g), torch.randn((nrow, N),
                                                             generator=g))
          for N in (1, 8, 32, 130)]
    x, y = XY[0][0][:, 0].contiguous(), XY[0][1][:, 0].contiguous()
    B = XY[1][0][:, :4].contiguous()
    dinv = ft.normal_jacobi(m, reg=1.0, device="cpu")

    def calls():
        for X, Y in XY:
            op.matmat(X)
            op.rmatmat(Y)
            op.normal_matmat(X, reg=0.5)
        op.matvec(x)
        op.rmatvec(y)
        op.normal_matvec(x, reg=0.5)
        op.gram_matvec(y, reg=0.5)
        ft.cg_normal(op, B, reg=1.0, tol=0.0, maxiter=3)
        ft.cg_normal(op, B, reg=1.0, tol=1e-3, maxiter=50, precond=dinv)

    rec, d = _dispatched(monkeypatch, calls)
    names = {s.name for s in rec.spans}
    assert {"product", "cg.solve", "cg.iter", "cg.sync"} <= names
    for s in rec.spans:
        assert s.counts.get("ops", 0) == d.by_span[s], (
            s.name, s.attrs, s.parent and s.parent.name)
    assert d.by_span[None] == 0
    # the X encoder counts its kernel on the card only
    assert "encode_kernel" not in rec.counts
    if case == "hybrid_densecols":
        assert {"hybrid", "ell_ops", "assemble", "densecols"} <= names
    if case.endswith("boundary"):
        assert "boundary" in names
    if case == "rmat_auto":
        assert {"boundary", "hybrid", "densecols", "bsr_ops", "ell_ops",
                "assemble"} <= names


def test_assemble_ops_follow_the_plan(small_dense_cols):
    """Each ``assemble`` span issues the plan's gathers and adds
    (`benchmark/lib/layout.plan_ops`, the row-order gather among them),
    an index cast per class and one for the row order, the zero row and
    the concatenation."""
    plan_ops = rmat_layout.LAYOUT.plan_ops
    m = ecfp_like(800, 2000, 24, 20, seed=2)
    op = ft.operator(m, device="cpu")
    # the tilings' ELL parts with a plan, in the order normal_matmat runs
    plans = [t.sparse.plan for t in (op.fwd, op.bwd)
             if t.sparse is not None and t.sparse.plan is not None]
    assert plans
    X = torch.randn((m.shape[1], 16))
    with tracing.recording() as rec:
        op.normal_matmat(X, reg=1.0)
    spans = [s for s in rec.spans if s.name == "assemble"]
    assert len(spans) == len(plans)
    for s, plan in zip(spans, plans):
        gathers, adds = plan_ops(plan)
        assert s.counts["ops"] == gathers + adds + len(plan.widths) + 1 + 2
        assert s.parent.name == "ell_ops"
        assert s.root.attrs == {"op": "normal_matmat", "N": 16}


@pytest.mark.parametrize("tol,stops_on_tol", [(0.0, False), (1e-1, True)])
def test_cg_sync_spans_count_read_backs(tol, stops_on_tol):
    m = _banded()
    op = ft.operator(m, format="bsr", device="cpu")
    b = torch.randn((m.shape[1], 4), generator=torch.Generator().manual_seed(2))
    with tracing.recording() as rec:
        res = ft.cg_normal(op, b, reg=5.0, tol=tol, maxiter=25)
    assert (res.iters < 25) == stops_on_tol
    syncs = [s for s in rec.spans if s.name == "cg.sync"]
    iters = [s for s in rec.spans if s.name == "cg.iter"]
    assert len(iters) == res.iters
    assert len(syncs) == res.iters + stops_on_tol
    assert rec.counts["syncs"] == len(syncs)
    solve = rec.spans[0]
    assert solve.name == "cg.solve" and solve.parent is None
    assert all(s.parent is solve and s.root is solve for s in syncs + iters)


@pytest.mark.parametrize("segmented", [False, True])
def test_ell_scan_spans_count_their_ops_and_buckets(monkeypatch, segmented):
    """The reference's per-bucket ELL scan (f64 on the CPU, SpMV and SpMM,
    f32 and f64 operands): one ``ell_scan`` span a product, its ``ops``
    the aten ops it dispatches, and one ``ell_scan`` a bucket scanned."""
    from fastsparse_torch import linops
    from fastsparse_torch.bench.matrices import powerlaw

    if segmented:
        monkeypatch.setattr(linops, "SEG_COLS", 512)
        monkeypatch.setattr(linops._balanced_seg_cols, "__defaults__",
                            (512,))
    m = powerlaw(1500, 1500, 30_000, seed=4, alpha=1.0, dtype=np.float64)
    op = ft.operator(m, format="ell", transpose=False, device="cpu")
    segs = getattr(op.fwd, "segments", (op.fwd,))
    assert len(segs) == (3 if segmented else 1)
    buckets = sum(len(s.buckets) for s in segs)
    g = torch.Generator().manual_seed(6)
    operands = [torch.randn((m.shape[1],) + s, generator=g, dtype=dt)
                for s in ((), (5,)) for dt in (torch.float64, torch.float32)]

    def calls():
        for x in operands:
            (op.matvec if x.ndim == 1 else op.matmat)(x)

    rec, d = _dispatched(monkeypatch, calls)
    scans = [s for s in rec.spans if s.name == "ell_scan"]
    assert len(scans) == len(operands)
    for s in rec.spans:
        assert s.counts.get("ops", 0) == d.by_span[s], (s.name, s.attrs)
    for s in scans:
        assert s.attrs == {"dtype": "float64"}
        assert s.parent.name == "product" and s.counts["ell_scan"] == buckets
    assert d.by_span[None] == 0 and "ell_launch" not in rec.counts
