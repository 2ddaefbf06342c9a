"""The Graph 500 R-MAT graph through `operator(m, reorder="auto")`, on the
CPU (the kernels' plain versions): a small instance (`rmat_layout`) whose
layout holds every part kind of the benchmark's scale-18 one, built by the
port and by the JAX reference with the same constants.

* the port's layout equals the reference's array for array (the cluster
  permutations, the dense-column block, the ColSegmented tiles and their
  strip plans, the segmented ELL and its assembly plan, via `interop`);
* each part kind is present;
* the products against the reference's on the same X, and against the
  benchmark's plain float64 reference (`benchmark/lib/reference.py`), at
  the configuration's bar, rel <= 1e-6 (BASELINE's fp32 rtol).

Without the dual tiling (``transpose=False``, as the benchmark's cell
builds it) the forward products; with it, the transpose products too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastsparse as fs
import fastsparse_torch as ft
from fastsparse_torch import interop
import rmat_layout

torch.set_num_threads(1)
REF = rmat_layout.bench_lib("reference")
TOL = 1e-6


@pytest.fixture(scope="module")
def built():
    """(matrix, {transpose: (reference operator, port operator)})."""
    with pytest.MonkeyPatch.context() as mp:
        rmat_layout.shrink(mp, reference=True)
        m = rmat_layout.matrix()
        yield m, {tr: (fs.operator(m, reorder="auto", transpose=tr),
                       ft.operator(m, reorder="auto", transpose=tr,
                                   device="cpu"))
                  for tr in (False, True)}


def _assert_same(d_ref, d_port):
    assert set(d_ref) == set(d_port), set(d_ref) ^ set(d_port)
    for k, v in d_ref.items():
        w = d_port[k]
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and v.shape == w.shape, k
            assert np.array_equal(v, w), k
        else:
            assert v == w, k


@pytest.mark.parametrize("transpose", [False, True])
def test_layout_matches_reference(built, transpose):
    _, ops = built
    op_j, op_t = ops[transpose]
    d_ref = interop.reference_arrays(op_j)
    _assert_same(d_ref, interop.reference_arrays(op_t))
    assert d_ref["fwd.dense.kind"] == "colseg"
    assert d_ref["col_perm"] is not None


@pytest.mark.parametrize("transpose", [False, True])
def test_layout_holds_every_part_kind(built, transpose):
    m, ops = built
    op = ops[transpose][1]
    tilings = (op.fwd, op.bwd) if transpose else (op.fwd,)
    for t in tilings:
        assert type(t).__name__ == "HybridMatrix"
        p = rmat_layout.parts(t)
        assert p["dense_cols"] > 0, p
        assert p["tile_segments"] >= 2, p
        assert p["tile_buckets"] + p["panel_buckets"] > 0, p
        assert p["ell_segments"] >= 2, p
        assert p["plan_adds"] > 0, p
    # both tile kernels (#5 bucket_spmm, #6 panel_spmm) in the forward one
    p = rmat_layout.parts(op.fwd)
    assert p["tile_buckets"] > 0 and p["panel_buckets"] > 0, p
    for perm, n in ((op.row_perm, m.shape[0]), (op.col_perm, m.shape[1])):
        assert perm is not None
        assert not torch.equal(perm.long(), torch.arange(n))


PRODUCTS = [(tr, name, N)
            for tr in (False, True)
            for name, N in [("matvec", 1), ("rmatvec", 1), ("matmat", 1),
                            ("rmatmat", 1), ("matmat", 32), ("rmatmat", 32),
                            ("matmat", 128), ("rmatmat", 128)]
            if tr or not name.startswith("r")]


@pytest.mark.parametrize("transpose,name,N", PRODUCTS)
def test_products_match_float64_reference(built, transpose, name, N):
    """Against the JAX reference's product on the same layout and X, and
    against the plain float64 reference."""
    m, ops = built
    op_j, op_t = ops[transpose]
    rows = m.shape[0] if name.startswith("r") else m.shape[1]
    shape = (rows,) if name.endswith("vec") else (rows, N)
    x = np.random.default_rng(N).standard_normal(shape).astype(np.float32)
    got = getattr(op_t, name)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    ref_j = torch.from_numpy(np.array(getattr(op_j, name)(jnp.asarray(x))))
    assert REF.rel_gap(got, ref_j) <= TOL
    want = getattr(REF.Reference(m, "cpu"), name)(torch.from_numpy(x))
    assert REF.rel_gap(got, want) <= TOL
