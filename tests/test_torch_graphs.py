"""`fastsparse_torch.graphs`: the operator's cache of products replayed as
CUDA graphs, on the CPU.

CPU operands never engage the cache: the first three tests hold that. The
others open the cache's own seams (`ProductGraphs.engages`, which admits
CPU operands here, and `ProductGraphs.capture`, which here runs the
product where the card would record it) to check, without a card:

* the key: the product, the operand's shape, dtype and device, the
  stream, the tiling the product starts from and ``reg``; a key seen once
  runs eagerly, the second call captures, later calls replay, and each
  result is a tensor of its own;
* only the outermost product of a nest is looked up or captured;
* a capture that raises marks its key eager for good and counts
  ``graph_refused``.

The card's tests (`tests/test_torch_cuda.py`) hold real replays bit-equal
to the eager path.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fastsparse_torch as ft
from fastsparse_torch import graphs, tracing
from fastsparse_torch.bench import model as tmodel
from fastsparse_torch.bench.matrices import ecfp_like

torch.set_num_threads(1)


@pytest.fixture
def small_dense_cols(monkeypatch):
    monkeypatch.setattr(tmodel, "DENSE_COL_MIN_D", 4)
    monkeypatch.setattr(tmodel, "DENSE_COL_CELL_S", 2e-11)
    monkeypatch.setattr(tmodel, "DENSE_COL_MIN_ROWS", 64)


def _banded():
    g = np.random.default_rng(3)
    r = g.integers(0, 600, 36000)
    c = np.clip(r * 900 // 600 + g.integers(0, 200, r.size), 0, 899)
    m = sp.coo_matrix((np.ones(r.size, np.float32), (r, c)), shape=(600, 900))
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()


MATRICES = {
    "mono": (_banded, {"format": "bsr"}),
    "hybrid": (lambda: ecfp_like(800, 2000, 24, 20, seed=2), {}),
}


def _op(case):
    make, kw = MATRICES[case]
    m = make()
    return m, ft.operator(m, device="cpu", **kw)


def _eager_twin(op):
    """The same tilings with a cache that never engages: the eager path."""
    twin = dataclasses.replace(op)
    twin.graphs.engages = lambda X, reg=None: False
    return twin


def _randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


class _FakeGraph:
    """Stands in for a captured graph: a replay runs the product on the
    static input again, untraced, as the card runs the recorded work."""

    def __init__(self, body, x):
        self.body, self.x = body, x
        self.y = None

    def replay(self):
        rec, tracing._active = tracing._active, None
        try:
            self.y.copy_(self.body(self.x))
        finally:
            tracing._active = rec


@pytest.fixture
def engaged(monkeypatch):
    """The cache engaged on CPU operands; returns the list of captures
    made, as ``(operand shape, product's result shape)``."""
    captured = []

    def capture(X, body):
        x = torch.empty_like(X).zero_()
        fake = _FakeGraph(body, x)
        y = body(x)  # spans and counts as a capture records them
        fake.y = y
        captured.append((tuple(X.shape), tuple(y.shape)))
        return graphs._Graph(fake, x, y)

    monkeypatch.setattr(graphs.ProductGraphs, "engages",
                        staticmethod(lambda X, reg=None: torch.is_tensor(X)))
    monkeypatch.setattr(graphs.ProductGraphs, "capture",
                        staticmethod(capture))
    return captured


@pytest.mark.parametrize("case", sorted(MATRICES))
def test_cpu_operands_never_capture(small_dense_cols, case):
    m, op = _op(case)
    X, Y = _randn(m.shape[1], 8), _randn(m.shape[0], 8, seed=1)
    assert not graphs.ProductGraphs.engages(X)
    assert not graphs.ProductGraphs.engages(X.numpy())
    with tracing.recording() as rec:
        for _ in range(3):
            op.matmat(X)
            op.rmatmat(Y)
            op.normal_matmat(X, reg=0.5)
            op.T.matmat(Y)
    for k in ("replays", "captures", "graph_refused"):
        assert k not in rec.counts
    assert "replay" not in {s.name for s in rec.spans}
    assert not op.graphs.graphs and not op.graphs.seen
    assert not op.graphs.refused


def test_dd_operands_on_cpu_never_capture():
    g = np.random.default_rng(4)
    r, c = g.integers(0, 300, 2000), g.integers(0, 200, 2000)
    m = sp.coo_matrix((np.ones(r.size), (r, c)), shape=(300, 200)).tocsr()
    m.data[:] = 1.0
    op = ft.operator(m, format="ell", device="cpu",
                     config=ft.Config(ell_split_rows=0))
    X = torch.randn((200, 3), dtype=torch.float64)
    with tracing.recording() as rec:
        ys = [ft.spmm_dd(op, X) for _ in range(3)]
    assert all(torch.equal(y, ys[0]) for y in ys)
    assert "replays" not in rec.counts and not op.graphs.seen


def test_key_fields_and_when_a_key_captures(small_dense_cols, engaged):
    m, op = _op("hybrid")
    ncol, nrow = m.shape[1], m.shape[0]
    X8, X16 = _randn(ncol, 8), _randn(ncol, 16, seed=2)
    Y8 = _randn(nrow, 8, seed=3)
    twin = _eager_twin(op)
    want = twin.matmat(X8)

    y1 = op.matmat(X8)  # seen once: eager
    key = ("matmat", torch.Size((ncol, 8)), torch.float32,
           torch.device("cpu"), None, id(op.fwd), None)
    assert op.graphs.seen == {key} and not op.graphs.graphs
    y2 = op.matmat(X8)  # the second call captures, then replays it
    assert list(op.graphs.graphs) == [key]
    y3 = op.matmat(X8)  # replayed
    for y in (y1, y2, y3):
        assert torch.equal(y, want)
    ptrs = {y.untyped_storage().data_ptr() for y in (y2, y3)}
    assert len(ptrs) == 2
    assert y3.untyped_storage().data_ptr() != \
        op.graphs.graphs[key].y.untyped_storage().data_ptr()

    # each field of the key parts keys: N, the product, the tiling it
    # starts from, reg
    op.matmat(X16)
    op.rmatmat(Y8)
    op.T.matmat(Y8)
    op.normal_matmat(X8, reg=0.5)
    op.normal_matmat(X8, reg=1.0)
    assert len(engaged) == 1 and len(op.graphs.seen) == 6
    op.T.matmat(Y8)
    op.normal_matmat(X8, reg=0.5)
    assert len(engaged) == 3
    keys = set(op.graphs.graphs)
    assert {(k[0], k[5], k[6]) for k in keys} == {
        ("matmat", id(op.fwd), None), ("matmat", id(op.bwd), None),
        ("normal_matmat", id(op.fwd), 0.5)}
    # the transpose shares the cache, its own products keyed apart
    assert op.T.graphs is op.graphs
    assert torch.equal(op.T.matmat(Y8), twin.rmatmat(Y8))
    assert torch.equal(op.normal_matmat(X8, reg=0.5),
                       twin.normal_matmat(X8, reg=0.5))
    # an operand changed in place between calls is seen
    X8.mul_(-2.0)
    assert torch.equal(op.matmat(X8), twin.matmat(X8))


@pytest.mark.parametrize("case", sorted(MATRICES))
def test_only_the_outermost_product_is_captured(small_dense_cols, engaged,
                                                monkeypatch, case):
    m, op = _op(case)
    X = _randn(m.shape[1], 4)
    want = _eager_twin(op).normal_matmat(X, reg=0.5)
    looked_up = []
    call = graphs.ProductGraphs._call

    def spy(self, op_, name, *a):
        looked_up.append(name)
        return call(self, op_, name, *a)
    monkeypatch.setattr(graphs.ProductGraphs, "_call", spy)
    recs = []
    for _ in range(3):
        with tracing.recording() as rec:
            got = op.normal_matmat(X, reg=0.5)
        assert torch.equal(got, want)
        recs.append(rec)
    assert looked_up == ["normal_matmat"] * 3
    assert [k[0] for k in op.graphs.graphs] == ["normal_matmat"]
    assert [k[0] for k in op.graphs.seen] == ["normal_matmat"]
    assert engaged == [(tuple(X.shape), tuple(want.shape))]

    eager, captured, replayed = recs
    n_eager = eager.counts["ops"]
    assert captured.counts["captures"] == 1
    assert captured.counts["ops"] == n_eager + 3  # copy-in, launch, clone
    # the gather launches the product runs, counted again by the replay
    launched = {k: eager.counts[k] for k in graphs.REPLAYED
                if k in eager.counts}
    assert (case == "hybrid") == bool(launched)
    assert {k: captured.counts[k] for k in launched} == launched
    # a replay: the product's span holds one replay span and nothing else
    prod, rep = replayed.spans
    assert prod.name == "product" and prod.attrs == {"op": "normal_matmat",
                                                     "N": 4}
    assert rep.name == "replay" and rep.parent is prod
    assert rep.attrs == {"op": "normal_matmat", "N": 4}
    assert rep.counts == {"ops": 3, "replays": 1, **launched}
    assert prod.counts == {}
    assert replayed.counts == {"ops": 3, "replays": 1, **launched}


def test_a_capture_that_raises_marks_the_key_eager(small_dense_cols,
                                                   engaged, monkeypatch):
    m, op = _op("hybrid")
    tried = []

    def refuse(X, body):
        tried.append(tuple(X.shape))
        raise RuntimeError("operation not permitted when stream is capturing")
    monkeypatch.setattr(graphs.ProductGraphs, "capture",
                        staticmethod(refuse))
    X = _randn(m.shape[0], 8)
    want = _eager_twin(op).rmatmat(X)
    with tracing.recording() as rec:
        got = [op.rmatmat(X) for _ in range(4)]
    assert all(torch.equal(y, want) for y in got)
    assert tried == [tuple(X.shape)]
    assert rec.counts["graph_refused"] == 1
    assert "replays" not in rec.counts and "captures" not in rec.counts
    assert len(op.graphs.refused) == 1 and not op.graphs.graphs


@pytest.mark.parametrize("N", [8, 16])
def test_a_replay_counts_the_gather_launches_of_its_capture(
        small_dense_cols, engaged, monkeypatch, N):
    """A capture made with tracing off keeps what its product counted of
    `graphs.REPLAYED` (the gather launches: 1 at X widths of at most 8
    lanes, every part in one launch; one a part at N = 16), and each
    traced replay counts it again inside its ``replay`` span, with ``ops``
    still 3; eager, captured and replayed results are bit-equal."""
    from fastsparse_torch.ops import ell_ops

    # a small chunk budget, so that the ELL part holds several parts
    monkeypatch.setattr(ell_ops, "_SMEM_IDX_BUDGET_UNIT", 256)
    m, op = _op("hybrid")
    X = _randn(m.shape[1], N)
    with tracing.recording() as eager:
        y0 = op.matmat(X)
    launched = eager.counts["ell_launch"]
    A = op.fwd.sparse
    parts = sum(len(list(ell_ops._seg_layout(s)))
                for s in getattr(A, "segments", [A]))
    assert parts > 1 and launched == (1 if N <= 8 else parts)
    ys = [op.matmat(X)]  # the capture, untraced
    assert len(engaged) == 1
    (g,) = op.graphs.graphs.values()
    assert g.counts == {"ell_launch": launched}
    for _ in range(2):
        with tracing.recording() as rec:
            ys.append(op.matmat(X))
        prod, rep = rec.spans
        assert rep.name == "replay" and rep.parent is prod
        assert rep.counts == {"ops": 3, "replays": 1,
                              "ell_launch": launched}
    assert all(torch.equal(y, y0) for y in ys)
