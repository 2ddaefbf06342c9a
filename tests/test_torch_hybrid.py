"""Port parity, the hybrid path: `fastsparse_torch` against the JAX
reference on the same numpy-seeded inputs (CPU tensors, so the kernels'
plain versions; the reference's Pallas kernels in interpret mode).

The dense-column constants are shrunk in both packages (as the reference's
own hybrid tests do), so small matrices extract a `DenseCols` block.

* `build_hybrid` layouts equal the reference's array for array (the block,
  ``col_ids``, counts, threshold, the ELL part and its plan);
* `densecols_spmm_plain` bit-exact against `densecols_spmm_pallas`
  (interpret mode) at N=128 and `dense_cols_spmm` bit-exact against the
  reference's XLA branch at N=1 and 32;
* hybrid products and the operator's (matvec, rmatmat, normal_matmat)
  bit-exact against the reference on the same layout (via `interop`), and
  within 1e-6 of scipy in float64;
* the orderings and the permutation elision equal the reference's;
* a Macau inner step (rmatmat + cg_normal) on a hybrid operator;
* a split that yields dense tiles builds the reference's layout, and
  raises `NotImplementedError` where the dense tiles would be bitmask
  tiles (slice 3b).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fastsparse as fs
from fastsparse.bench import model as jmodel
from fastsparse.formats import hybrid as jhyb
from fastsparse.ops import assemble as jasm
from fastsparse.ops import bsr_ops as jk_ops
from fastsparse.ops import spmm as jspmm
from fastsparse.ops.pallas import bsr_spmm as jk
from fastsparse.reorder import cluster as jcl
import fastsparse_torch as ft
from fastsparse_torch import interop
from fastsparse_torch.bench import model as tmodel
from fastsparse_torch.bench.matrices import ecfp_like
from fastsparse_torch.formats import hybrid as thyb
from fastsparse_torch.ops import assemble as tasm
from fastsparse_torch.ops import spmm as tspmm
from fastsparse_torch.ops.kernels import bsr_spmm as tk
from fastsparse_torch.reorder import cluster as tcl

torch.set_num_threads(1)
TOL = 1e-6


def _rel(y, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(y, np.float64) - ref).max() / (
        np.abs(ref).max() + 1e-30
    )


@pytest.fixture(autouse=True)
def small_dense_cols(monkeypatch):
    """Dense-column extraction at test scale in both packages (the
    production constants target matrices of 16k rows and more)."""
    for mod in (jmodel, tmodel):
        monkeypatch.setattr(mod, "DENSE_COL_MIN_D", 4)
        monkeypatch.setattr(mod, "DENSE_COL_CELL_S", 2e-11)
        monkeypatch.setattr(mod, "DENSE_COL_MIN_ROWS", 64)


def _ecfp():
    return ecfp_like(800, 2000, 24, 20, seed=2)


def _hot(binary=True):
    """A few very dense columns over a scattered tail."""
    g = np.random.default_rng(60)
    r = np.r_[g.integers(0, 700, 5000), g.integers(0, 700, 3000)]
    c = np.r_[g.integers(0, 12, 5000), g.integers(12, 900, 3000)]
    v = np.ones(r.size, np.float32) if binary else g.standard_normal(
        r.size).astype(np.float32)
    m = sp.coo_matrix((v, (r, c)), shape=(700, 900))
    m.sum_duplicates()
    if binary:
        m.data[:] = 1.0
    return m.tocsr()


def _coos(m):
    binary = bool((m.data == 1.0).all())
    if binary:
        return (fs.binary_coo_from_scipy(m.tocoo()),
                ft.binary_coo_from_scipy(m, device="cpu"))
    return (fs.coo_from_scipy(m, dtype=np.float32),
            ft.coo_from_scipy(m, device="cpu"))


def _arrays(A):
    return interop.reference_arrays(
        types.SimpleNamespace(fwd=A, bwd=None, shape=A.shape))


def _assert_same(d_ref, d_port):
    assert set(d_ref) == set(d_port)
    for k, v in d_ref.items():
        w = d_port[k]
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and v.shape == w.shape, k
            assert np.array_equal(v, w), k
        else:
            assert v == w, k


# (matrix, build_hybrid kwargs)
LAYOUTS = {
    "ecfp": (_ecfp, {}),
    "hot_binary": (_hot, {}),
    "hot_binary_segmented": (_hot, {"seg_cols": 256}),
    "hot_valued": (lambda: _hot(False), {"threshold": 10_000}),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_build_hybrid_layout_matches_reference(case):
    make, kw = LAYOUTS[case]
    m = make()
    cj, ct = _coos(m)
    Hj = jasm.attach_plan(jhyb.build_hybrid(cj, **kw))
    Ht = tasm.attach_plan(thyb.build_hybrid(ct, device="cpu", **kw))
    d_ref, d_port = _arrays(Hj), _arrays(Ht)
    _assert_same(d_ref, d_port)
    assert d_port["fwd.has_dense_cols"] == (case != "hot_valued")
    if case == "hot_binary_segmented":
        assert d_port["fwd.sparse.kind"] == "ell-seg"
    assert Ht.nnz == m.nnz and Ht.dense is None
    assert np.array_equal(Ht.todense().numpy(), m.toarray())
    assert thyb.dense_tile_fraction(ct) == jhyb.dense_tile_fraction(cj)


def _planes(g, D, N):
    q3 = g.integers(-128, 128, (D, 3 * N)).astype(np.int8)
    q3[:, :N] = g.integers(-127, 128, (D, N))  # the top plane's range
    s = (g.random((1, N)) * 1e-5 + 1e-7).astype(np.float32)
    return q3, s


def test_densecols_plain_vs_pallas():
    """The Pallas kernel (interpret mode) against the plain version at
    N=128 on a block of 512 x 256 random 0/1 cells: bit-exact."""
    g = np.random.default_rng(3)
    N = 128
    block = (g.random((512, 256)) < 0.4).astype(np.int8)
    q3, s = _planes(g, 256, N)
    ref = np.asarray(jk.densecols_spmm_pallas(
        jnp.asarray(block), jnp.asarray(q3),
        jnp.asarray(np.broadcast_to(s, (8, N)))))
    args = (torch.from_numpy(block), torch.from_numpy(q3.T.copy()),
            torch.from_numpy(s))
    tk.reset_launches()
    got = tk.densecols_spmm(*args).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    assert tk.launches["densecols"] == 0  # the plain version never counts


@pytest.mark.parametrize("N", [1, 32, 128])
def test_dense_cols_spmm_vs_reference(N):
    """`dense_cols_spmm` through both packages on one DenseCols block:
    the X encoding and the fold, bit-exact (N=1 and 32 take the
    reference's XLA branch, N=128 its Pallas kernel)."""
    m = _hot()
    cj, ct = _coos(m)
    dj = jhyb.build_hybrid(cj).dense_cols
    dt = thyb.build_hybrid(ct, device="cpu").dense_cols
    X = np.random.default_rng(N).standard_normal(
        (m.shape[1], N)).astype(np.float32)
    ref = np.asarray(jspmm.dense_cols_spmm(dj, jnp.asarray(X)))
    got = tspmm.dense_cols_spmm(dt, torch.from_numpy(X)).numpy()
    assert got.shape == ref.shape == (m.shape[0], N)
    assert np.array_equal(got, ref)
    exact = dt.todense().double().numpy() @ X.astype(np.float64)
    assert _rel(got, exact) <= TOL


def test_densecols_planes_layout():
    """`densecols_planes` writes the reference's ``[q0|q1|q2]`` planes
    transposed to k-contiguous rows, with its scale; `dense_cols_spmm`
    over them matches float64 on a hand-made block, and refuses a
    non-f32 X (the reference's bf16 branches are not ported)."""
    g = np.random.default_rng(61)
    Xs = g.standard_normal((8, 4)).astype(np.float32)
    q0, q1, q2, s_ref = jk_ops._quant3_carry(jnp.asarray(Xs))
    q3_ref = np.concatenate([np.asarray(q, np.int8) for q in (q0, q1, q2)], 1)
    q3t, s = tspmm.densecols_planes(torch.from_numpy(Xs),
                                    torch.arange(8, dtype=torch.int32))
    assert q3t.dtype == torch.int8 and q3t.is_contiguous()
    assert np.array_equal(q3t.numpy(), q3_ref.T)
    assert np.array_equal(s.numpy(), np.asarray(s_ref))
    blk = (g.random((64, 8)) < 0.3).astype(np.int8)
    dc = thyb.DenseCols(col_ids=torch.arange(8, dtype=torch.int32),
                        block=torch.from_numpy(blk), shape=(64, 100),
                        nnz=int(blk.sum()))
    X = g.standard_normal((100, 4)).astype(np.float32)
    ref = blk.astype(np.float64) @ X[:8].astype(np.float64)
    assert _rel(tspmm.dense_cols_spmm(dc, torch.from_numpy(X)).numpy(),
                ref) <= TOL
    with pytest.raises(NotImplementedError, match="f32"):
        tspmm.dense_cols_spmm(dc, torch.from_numpy(X.astype(np.float64)))


@pytest.mark.parametrize("N", [1, 4, 32, 128])
def test_densecols_planes_gather(N):
    """`densecols_planes(X, col_ids)` gathers the rows inside the encode:
    its planes and scale equal the reference's ``_quant3_carry`` of
    ``X[col_ids]`` (the gather `dense_cols_spmm` did before the encode),
    with ids out of order, repeated and zero-padded to a multiple of
    128, as `build_hybrid` pads them."""
    g = np.random.default_rng(N + 62)
    X = g.standard_normal((300, N)).astype(np.float32)
    X[7] = 0.0
    ids = np.zeros(256, np.int32)
    ids[:200] = g.integers(0, 300, 200)
    q0, q1, q2, s_ref = jk_ops._quant3_carry(jnp.asarray(X[ids]))
    q3_ref = np.concatenate([np.asarray(q, np.int8) for q in (q0, q1, q2)], 1)
    q3t, s = tspmm.densecols_planes(torch.from_numpy(X), torch.from_numpy(ids))
    assert q3t.shape == (3 * N, 256) and q3t.is_contiguous()
    assert np.array_equal(q3t.numpy(), q3_ref.T)
    assert np.array_equal(s.numpy(), np.asarray(s_ref))


@pytest.fixture(scope="module")
def ecfp_ops():
    """(scipy matrix, JAX operator, port operator on the reference's
    layout) for format="auto" -> hybrid with both tilings."""
    mp = pytest.MonkeyPatch()
    for mod in (jmodel, tmodel):
        mp.setattr(mod, "DENSE_COL_MIN_D", 4)
        mp.setattr(mod, "DENSE_COL_CELL_S", 2e-11)
        mp.setattr(mod, "DENSE_COL_MIN_ROWS", 64)
    try:
        m = _ecfp()
        op_j = fs.operator(m)
        op_t = ft.operator(m, device="cpu")
    finally:
        mp.undo()
    d_ref = interop.reference_arrays(op_j)
    _assert_same(d_ref, interop.reference_arrays(op_t))
    assert d_ref["fwd.kind"] == d_ref["bwd.kind"] == "hybrid"
    assert d_ref["fwd.has_dense_cols"] and d_ref["bwd.has_dense_cols"]
    return m, op_j, interop.operator_from_reference_arrays(d_ref, "cpu")


def test_hybrid_products_vs_reference(ecfp_ops):
    """matmat (N=16), rmatmat (N=16), normal_matmat and matvec on the
    reference's layout: bit-exact against the reference (its matvec taken
    as the one-column matmat, the path it runs on its accelerator), and
    within 1e-6 of scipy in float64."""
    m, op_j, op_i = ecfp_ops
    g = np.random.default_rng(16)
    X = g.standard_normal((m.shape[1], 16)).astype(np.float32)
    Z = g.standard_normal((m.shape[0], 16)).astype(np.float32)
    md = m.astype(np.float64)
    Xt, Zt = torch.from_numpy(X), torch.from_numpy(Z)

    y = op_i.matmat(Xt).numpy()
    assert np.array_equal(y, np.asarray(op_j.matmat(jnp.asarray(X))))
    assert _rel(y, md @ X) <= TOL
    z = op_i.rmatmat(Zt).numpy()
    assert np.array_equal(z, np.asarray(op_j.rmatmat(jnp.asarray(Z))))
    assert _rel(z, md.T @ Z) <= TOL
    n = op_i.normal_matmat(Xt, reg=0.5).numpy()
    ref_n = np.asarray(op_j.normal_matmat(jnp.asarray(X), reg=0.5))
    assert np.array_equal(n, ref_n)
    assert _rel(n, md.T @ (md @ X) + 0.5 * X) <= TOL
    v = op_i.matvec(Xt[:, 0].contiguous()).numpy()
    assert np.array_equal(v, np.asarray(op_j.matmat(jnp.asarray(X[:, :1])))[:, 0])
    assert np.array_equal(ft.spmv(op_i.fwd, Xt[:, 0].contiguous()).numpy(), v)


@pytest.mark.parametrize("N", [1, 3, 40])
def test_hybrid_port_operator_vs_scipy(ecfp_ops, N):
    """The port's own operator (same layout) at other lane paddings."""
    m, _, op_i = ecfp_ops
    op_t = ft.operator(m, device="cpu")
    X = np.random.default_rng(N).standard_normal(
        (m.shape[1], N)).astype(np.float32)
    y = op_t.matmat(torch.from_numpy(X)).numpy()
    assert y.shape == (m.shape[0], N) and y.dtype == np.float32
    assert np.array_equal(op_i.matmat(torch.from_numpy(X)).numpy(), y)
    assert _rel(y, m @ X.astype(np.float64)) <= TOL
    z = op_t.rmatvec(torch.from_numpy(X[: m.shape[0], 0].copy())).numpy()
    assert _rel(z, m.T @ X[: m.shape[0], 0].astype(np.float64)) <= TOL


def test_macau_step_on_hybrid():
    """rhs = Aᵀ R, then (AᵀA + reg·I) V = rhs by cg_normal at N=8; the
    residual recomputed in float64 falls below the tolerance."""
    m = _ecfp()
    op = ft.operator(m, device="cpu")
    assert type(op.fwd).__name__ == "HybridMatrix"
    assert op.fwd.dense_cols is not None
    R = np.random.default_rng(21).standard_normal(
        (m.shape[0], 8)).astype(np.float32)
    rhs = op.rmatmat(torch.from_numpy(R))
    sol = ft.cg_normal(op, rhs, reg=2.0, tol=1e-5, maxiter=300)
    assert sol.iters < 300
    md = m.astype(np.float64)
    V = sol.x.numpy().astype(np.float64)
    b = md.T @ R.astype(np.float64)
    res = np.linalg.norm(b - (md.T @ (md @ V) + 2.0 * V), axis=0)
    assert (res / np.linalg.norm(b, axis=0)).max() < 1e-4


def _wide_hot():
    """12,000 x 30,000, valued: 200 hot columns spread over both column
    segments, so a degree ordering pays for its input gather."""
    g = np.random.default_rng(5)
    nrow, ncol = 12_000, 30_000
    hot = np.linspace(0, ncol - 1, 200).astype(np.int64)
    r = np.r_[np.repeat(np.arange(nrow), 4), g.integers(0, nrow, 8000)]
    c = np.r_[hot[g.integers(0, 200, 4 * nrow)], g.integers(0, ncol, 8000)]
    m = sp.coo_matrix((g.standard_normal(r.size).astype(np.float32), (r, c)),
                      shape=(nrow, ncol))
    m.sum_duplicates()
    return m.tocsr()


@pytest.mark.parametrize("name", ["degree", "minhash", "tilepack",
                                  "tilepack_degree", "hilbert", "best"])
def test_orderings_match_reference(name):
    m = _ecfp()
    cj, ct = _coos(m)
    fj, ft_ = {
        "degree": (jcl.degree_perms, tcl.degree_perms),
        "minhash": (jcl.minhash_perms, tcl.minhash_perms),
        "tilepack": (jcl.tilepack_perms, tcl.tilepack_perms),
        "tilepack_degree": (
            lambda c: jcl.tilepack_perms(c, base="degree"),
            lambda c: tcl.tilepack_perms(c, base="degree")),
        "hilbert": (jcl.hilbert_perms, tcl.hilbert_perms),
        "best": (jcl.best_perms, tcl.best_perms),
    }[name]
    pj, pt = fj(cj), ft_(ct)
    if name == "best":
        assert pj[0] is not None  # a real ordering wins on this matrix
    for a, b in zip(pj, pt):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a), b.numpy())
    pc = tcl.permute_coo(ct, *pt)
    rinv = tcl.invert_perm(pt[0]).numpy()
    cinv = tcl.invert_perm(pt[1]).numpy()
    assert np.array_equal(pc.todense().numpy(),
                          m.toarray()[np.ix_(pt[0].numpy(), pt[1].numpy())])
    assert np.array_equal(rinv[pt[0].numpy()], np.arange(m.shape[0]))
    assert np.array_equal(cinv[pt[1].numpy()], np.arange(m.shape[1]))


def _banded():
    g = np.random.default_rng(0)
    r = g.integers(0, 2000, 180_000)
    c = np.clip(r + g.integers(0, 300, r.size), 0, 1999)
    m = sp.coo_matrix((np.ones(r.size, np.float32), (r, c)), shape=(2000, 2000))
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()


@pytest.mark.parametrize("case", ["ecfp_degree_elided", "ecfp_degree_dual",
                                  "wide_degree_colperm_kept",
                                  "banded_bsr_hilbert"])
def test_reorder_operator_matches_reference(case):
    """operator(m, reorder=...): the permutations the reference keeps
    after its elision, the remapped layout, and products through the
    boundary against scipy."""
    m, kw = {
        "ecfp_degree_elided": (_ecfp, dict(reorder="degree",
                                           transpose=False)),
        "ecfp_degree_dual": (_ecfp, dict(reorder="degree", format="ell")),
        "wide_degree_colperm_kept": (_wide_hot, dict(reorder="degree",
                                                     transpose=False)),
        "banded_bsr_hilbert": (_banded, dict(reorder="hilbert",
                                             format="bsr")),
    }[case]
    m = m()
    op_j = fs.operator(m, **kw)
    op_t = ft.operator(m, device="cpu", **kw)
    d_ref, d_port = (interop.reference_arrays(op_j),
                     interop.reference_arrays(op_t))
    _assert_same(d_ref, d_port)
    kept = (d_port["row_perm"] is not None, d_port["col_perm"] is not None)
    assert kept == {"ecfp_degree_elided": (False, False),
                    "ecfp_degree_dual": (True, True),
                    "wide_degree_colperm_kept": (False, True),
                    "banded_bsr_hilbert": (True, True)}[case]
    X = np.random.default_rng(8).standard_normal(
        (m.shape[1], 4)).astype(np.float32)
    md = m.astype(np.float64)
    assert _rel(op_t.matmat(torch.from_numpy(X)).numpy(), md @ X) <= TOL
    if op_t.bwd is not None:
        Z = np.random.default_rng(9).standard_normal(
            (m.shape[0], 4)).astype(np.float32)
        z = op_t.rmatmat(torch.from_numpy(Z)).numpy()
        assert _rel(z, md.T @ Z) <= TOL
        assert np.array_equal(op_t.T.matmat(torch.from_numpy(Z)).numpy(), z)
        # the normal and gram chains through the boundary (two mono
        # launches with the inner permutation pair cancelled, for BSR)
        n = op_t.normal_matmat(torch.from_numpy(X), reg=0.5).numpy()
        assert _rel(n, md.T @ (md @ X) + 0.5 * X) <= TOL
        gm = op_t.gram_matvec(torch.from_numpy(Z[:, 0].copy()), reg=0.5)
        assert _rel(gm.numpy(), md @ (md.T @ Z[:, 0]) + 0.5 * Z[:, 0]) <= TOL


def _blocky():
    """Binary: a dense 64 x 512 corner over scattered entries."""
    g = np.random.default_rng(0)
    r = np.r_[g.integers(0, 64, 16000), g.integers(0, 3000, 30000)]
    c = np.r_[g.integers(0, 512, 16000), g.integers(0, 3000, 30000)]
    m = sp.coo_matrix((np.ones(r.size, np.float32), (r, c)),
                      shape=(3000, 3000))
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()


def test_dense_tiles_raise(monkeypatch):
    """Dense tiles build as the reference's; as bitmask tiles (slice 3b)
    they raise."""
    for mod in (jmodel, tmodel):  # no dense columns: the corner stays tiles
        monkeypatch.setattr(mod, "DENSE_COL_MIN_ROWS", 16384)
    m = _blocky()
    cj, ct = _coos(m)
    Hj = jasm.attach_plan(jhyb.build_hybrid(cj))
    Ht = tasm.attach_plan(thyb.build_hybrid(ct, device="cpu"))
    assert Hj.dense is not None and Ht.dense is not None
    _assert_same(_arrays(Hj), _arrays(Ht))
    X = np.random.default_rng(2).standard_normal((3000, 8)).astype(np.float32)
    assert _rel(ft.spmm(Ht, torch.from_numpy(X)).numpy(),
                m @ X.astype(np.float64)) <= TOL
    with pytest.raises(NotImplementedError, match="slice 3"):
        thyb.build_hybrid(ct, config=ft.Config(binary_tiles="bitmask"),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="slice 3"):
        ft.operator(m, format="hybrid", device="cpu",
                    config=ft.Config(binary_tiles="bitmask"))
