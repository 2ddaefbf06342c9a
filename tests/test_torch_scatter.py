"""Port parity, the scatter engines and the on-device orderings:
`fastsparse_torch` against the JAX reference on the same numpy-seeded
inputs (CPU tensors).

* Morton and Hilbert keys, `sort_coo` in every ordering and
  `transpose_coo` are equal to the reference's, padding included;
* `spmv`, `spmv_t`, `spmm`, `spmm_t` over COO, BinaryCOO, CSR, BinaryCSR,
  EllMatrix and SegmentedEll, and `ata_x`, `ata_X`, `aat_x`, are within
  1e-6 (f32) / 1e-10 (f64) of scipy in float64 and of the reference
  (max|d|/max|ref|: the scatter adds in another order than XLA's);
* ``format="coo"``/``"csr"`` operators hold the reference's arrays (the
  power-of-two padding included) and their products, normal and gram
  products within the bars; transposes without the dual tiling run the
  scatter engine on ELL and raise `TypeError` on the tiled formats;
* an f64 operand on a BSR layout runs the COO engine, as in the
  reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fastsparse as fs
from fastsparse.config import Config as JConfig
import fastsparse_torch as ft
from fastsparse_torch import interop

torch.set_num_threads(1)
TOL = {np.float32: 1e-6, np.float64: 1e-10}


def _rel(y, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(y, np.float64) - ref).max() / (
        np.abs(ref).max() + 1e-30)


def _matrix(binary, dtype=np.float64, seed=0, shape=(300, 260), n=2400):
    """A matrix with duplicate-free entries in scrambled order, as
    (scipy CSR, rows, cols, vals)."""
    g = np.random.default_rng(seed)
    m = sp.coo_matrix((g.standard_normal(n), (g.integers(0, shape[0], n),
                                             g.integers(0, shape[1], n))),
                      shape=shape)
    m.sum_duplicates()
    if binary:
        m.data[:] = 1.0
    m = m.astype(dtype)
    perm = g.permutation(m.nnz)
    return m.tocsr(), m.row[perm], m.col[perm], m.data[perm]


def _coo_pair(binary, dtype=np.float64, pad=64, **kw):
    """The same scrambled COO in both packages, padded by ``pad``."""
    m, r, c, v = _matrix(binary, dtype, **kw)
    if binary:
        cj = fs.BinaryCOO.from_arrays(r, c, m.shape)
        ct = ft.BinaryCOO.from_arrays(r, c, m.shape, device="cpu")
    else:
        cj = fs.COO.from_arrays(r, c, v, m.shape)
        ct = ft.COO.from_arrays(r, c, v, m.shape, device="cpu")
    return m, cj.pad_to(cj.nnz_cap + pad), ct.pad_to(ct.nnz_cap + pad)


def _same_coo(cj, ct):
    for k in ("rows", "cols") + (("vals",) if hasattr(cj, "vals") else ()):
        a, b = np.asarray(getattr(cj, k)), getattr(ct, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert (cj.shape, cj.n_valid) == (ct.shape, ct.n_valid)


def test_keys_match_reference():
    from fastsparse.reorder import hilbert as jh

    g = np.random.default_rng(1)
    r = g.integers(0, 2**31, 4000).astype(np.int32)
    c = g.integers(0, 2**31, 4000).astype(np.int32)
    rt, ct = torch.from_numpy(r), torch.from_numpy(c)
    r16, c16 = r & 0xFFFF, c & 0xFFFF

    def eq(a, b):
        assert np.array_equal(np.asarray(a).astype(np.int64),
                              np.asarray(b).astype(np.int64))

    eq(fs.morton_key(r16, c16), ft.morton_key(torch.from_numpy(r16),
                                              torch.from_numpy(c16)))
    for a, b in zip(fs.morton_key64(r, c), ft.morton_key64(rt, ct)):
        eq(a, b)
    for a, b, h in zip(fs.hilbert_key64(r, c), ft.hilbert_key64(rt, ct),
                       ft.hilbert_key64(r, c)):  # tensors, and arrays
        eq(a, b)
        eq(a, h)
    eq(fs.hilbert_key(r16, c16), ft.hilbert_key(torch.from_numpy(r16),
                                                torch.from_numpy(c16)))
    # the inverse, and a round trip over a whole 2^9 x 2^9 grid
    d = torch.arange(2**18)
    yr, xr = jh.hilbert_d2xy(jnp.asarray(d.numpy(), jnp.uint32), order=9)
    yt, xt = ft.hilbert_d2xy(d, order=9)
    eq(yr, yt)
    eq(xr, xt)
    assert torch.equal(ft.hilbert_key(yt, xt, order=9), d)
    assert ft.ORDERINGS == fs.ORDERINGS


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("order", ["hilbert", "morton", "row", "col"])
def test_sort_coo_matches_reference(order, binary):
    _, cj, ct = _coo_pair(binary)
    sj, st = fs.sort_coo(cj, order), ft.sort_coo(ct, order)
    _same_coo(sj, st)
    assert st.row_sorted is False
    # padding stays at the tail; live entries are a permutation
    assert not st.rows[st.n_valid:].any() and not st.cols[st.n_valid:].any()


@pytest.mark.parametrize("binary", [False, True])
def test_transpose_coo_matches_reference(binary):
    m, cj, ct = _coo_pair(binary)
    tj, tt = fs.transpose_coo(cj), ft.transpose_coo(ct)
    _same_coo(tj, tt)
    assert tt.shape == m.shape[::-1]
    assert np.array_equal(tt.todense().numpy(), m.T.toarray())


def _tilings(fmt, binary, dtype):
    """(scipy, reference tiling, port tiling) of one format."""
    m, cj, ct = _coo_pair(binary, dtype)
    if fmt == "coo":
        return m, cj, ct
    if fmt == "csr":
        return m, fs.to_csr(cj), ft.to_csr(ct)
    if fmt == "ell":
        return m, fs.build_ell(cj), ft.build_ell(ct, device="cpu")
    return m, fs.build_ell_segmented(cj, seg_cols=128), \
        ft.build_ell_segmented(ct, seg_cols=128, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("fmt", ["coo", "csr", "ell", "ell-seg"])
def test_products_vs_scipy_and_reference(fmt, binary, dtype):
    m, Aj, At = _tilings(fmt, binary, dtype)
    assert type(At).__name__ == type(Aj).__name__
    md, tol = m.astype(np.float64), TOL[dtype]
    g = np.random.default_rng(2)
    x = g.standard_normal(m.shape[1]).astype(dtype)
    y = g.standard_normal(m.shape[0]).astype(dtype)
    X = g.standard_normal((m.shape[1], 5)).astype(dtype)
    Y = g.standard_normal((m.shape[0], 5)).astype(dtype)
    prods = {"spmv": (x, md @ x), "spmv_t": (y, md.T @ y),
             "spmm": (X, md @ X), "spmm_t": (Y, md.T @ Y)}
    for name, (v, ref) in prods.items():
        got = getattr(ft, name)(At, torch.from_numpy(v))
        assert got.dtype == torch.from_numpy(v).dtype, name
        assert got.shape == ref.shape, name
        assert _rel(got.numpy(), ref) <= tol, name
        # the reference's ELL forward products are the gather engine's,
        # held in tests/test_torch_ell.py; its scatter engines are here
        if fmt in ("coo", "csr") or name.endswith("_t"):
            want = np.asarray(getattr(fs, name)(Aj, jnp.asarray(v)))
            assert _rel(got.numpy(), want) <= tol, name


@pytest.mark.parametrize("with_At", [False, True])
def test_normal_products_vs_scipy_and_reference(with_At):
    m, cj, ct = _coo_pair(False)
    atj = fs.transpose_coo(cj) if with_At else None
    att = ft.transpose_coo(ct) if with_At else None
    md = m.toarray()
    g = np.random.default_rng(4)
    x = g.standard_normal(m.shape[1])
    y = g.standard_normal(m.shape[0])
    X = g.standard_normal((m.shape[1], 3))
    cases = (
        ("ata_x", x, md.T @ (md @ x) + 0.5 * x),
        ("ata_X", X, md.T @ (md @ X) + 0.5 * X),
        ("aat_x", y, md @ (md.T @ y) + 0.5 * y),
    )
    for name, v, ref in cases:
        got = getattr(ft, name)(ct, torch.from_numpy(v), At=att, reg=0.5)
        want = getattr(fs, name)(cj, jnp.asarray(v), At=atj, reg=0.5)
        assert _rel(got.numpy(), ref) <= 1e-10, name
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-10, name
    # reg = 0 adds nothing
    got = ft.ata_x(ct, torch.from_numpy(x), At=att)
    assert _rel(got.numpy(), md.T @ (md @ x)) <= 1e-10


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_scatter_operator_vs_reference(fmt, binary, transpose):
    m = _matrix(binary, np.float32, seed=5)[0]
    op_j = fs.operator(m, format=fmt, transpose=transpose)
    op_t = ft.operator(m, format=fmt, transpose=transpose, device="cpu")
    d_ref, d_port = (interop.reference_arrays(op_j),
                     interop.reference_arrays(op_t))
    assert set(d_ref) == set(d_port)
    for k, v in d_ref.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == d_port[k].dtype and np.array_equal(
                v, d_port[k]), k
        else:
            assert v == d_port[k], k
    assert op_t.fwd.nnz_cap == 1 << (m.nnz - 1).bit_length()  # pow2 pad
    op_i = interop.operator_from_reference_arrays(d_ref, device="cpu")
    md = m.astype(np.float64)
    g = np.random.default_rng(6)
    x = g.standard_normal(m.shape[1]).astype(np.float32)
    y = g.standard_normal(m.shape[0]).astype(np.float32)
    X = g.standard_normal((m.shape[1], 4)).astype(np.float32)
    Y = g.standard_normal((m.shape[0], 4)).astype(np.float32)
    cases = (
        ("matvec", x, md @ x), ("rmatvec", y, md.T @ y),
        ("matmat", X, md @ X), ("rmatmat", Y, md.T @ Y),
        ("normal_matvec", x, md.T @ (md @ x) + 0.25 * x),
        ("normal_matmat", X, md.T @ (md @ X) + 0.25 * X),
        ("gram_matvec", y, md @ (md.T @ y) + 0.25 * y),
    )
    for name, v, ref in cases:
        kw = {"reg": 0.25} if name.startswith(("normal", "gram")) else {}
        got = getattr(op_t, name)(torch.from_numpy(v), **kw).numpy()
        want = np.asarray(getattr(op_j, name)(jnp.asarray(v), **kw))
        assert _rel(got, ref) <= 1e-6, name
        assert _rel(got, want) <= 1e-6, name
        assert _rel(getattr(op_i, name)(torch.from_numpy(v), **kw).numpy(),
                    ref) <= 1e-6, name


def test_scatter_operator_f64_dtype():
    """``dtype=`` on a COO operator: the values take it, products run in
    it at the fp64 bar."""
    m = _matrix(False, np.float32, seed=7)[0]
    op = ft.operator(m, format="csr", dtype=torch.float64, transpose=False,
                     device="cpu")
    assert op.fwd.vals.dtype == torch.float64
    x = np.random.default_rng(8).standard_normal(m.shape[1])
    md = m.astype(np.float64)
    assert _rel(op.matvec(torch.from_numpy(x)).numpy(), md @ x) <= 1e-10
    y = np.random.default_rng(9).standard_normal(m.shape[0])
    assert _rel(op.rmatvec(torch.from_numpy(y)).numpy(), md.T @ y) <= 1e-10


def test_transposes_without_dual_tiling():
    """ELL: `spmv_t`/`spmm_t` as the reference runs them; tiled formats
    raise the reference's `TypeError`."""
    m = _matrix(False, np.float32, seed=10, shape=(400, 300), n=3000)[0]
    op_j = fs.operator(m, format="ell", transpose=False)
    op_t = ft.operator(m, format="ell", transpose=False, device="cpu")
    md = m.astype(np.float64)
    g = np.random.default_rng(11)
    y = g.standard_normal(m.shape[0]).astype(np.float32)
    Y = g.standard_normal((m.shape[0], 6)).astype(np.float32)
    for name, v, ref in (("rmatvec", y, md.T @ y), ("rmatmat", Y, md.T @ Y)):
        got = getattr(op_t, name)(torch.from_numpy(v)).numpy()
        assert _rel(got, ref) <= 1e-6, name
        assert _rel(got, np.asarray(getattr(op_j, name)(
            jnp.asarray(v)))) <= 1e-6, name
    got = op_t.normal_matvec(torch.from_numpy(g.standard_normal(
        m.shape[1]).astype(np.float32)))
    assert got.shape == (m.shape[1],)
    # a tiled forward layout has no transpose-scatter path
    mb = _banded_binary()
    zj, zt = jnp.zeros(mb.shape[0], jnp.float32), torch.zeros(mb.shape[0])
    op_j = fs.operator(mb, format="hybrid", transpose=False)
    with pytest.raises(TypeError):
        op_j.rmatvec(zj)
    for fmt in ("hybrid", "bsr"):
        op = ft.operator(mb, format=fmt, transpose=False, device="cpu")
        with pytest.raises(TypeError):
            op.rmatvec(zt)
        with pytest.raises(TypeError):
            ft.spmm_t(op.fwd, zt[:, None])


def _banded_binary(n=600, bw=200, seed=3):
    g = np.random.default_rng(seed)
    r = g.integers(0, n, n * bw // 4)
    c = np.clip(r + g.integers(0, bw, r.size), 0, n - 1)
    m = sp.coo_matrix((np.ones(r.size, np.float32), (r, c)), shape=(n, n))
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()


@pytest.mark.parametrize("layout", ["mono", "tiles"])
def test_f64_operand_on_bsr(layout):
    """An f64 operand on a BSR layout runs the COO engine over the
    layout's entries, as in the reference; a bf16 operand still raises."""
    m = _banded_binary()
    cfg = {} if layout == "mono" else {"bsr_mono": "off", "bsr_panels": "off",
                                       "tile_m": 8}
    op = ft.operator(m, format="bsr", config=ft.Config(**cfg), device="cpu")
    op_j = fs.operator(m, format="bsr", config=JConfig(**cfg))
    assert op.fwd.is_mono == (layout == "mono")
    assert layout == "mono" or not op.fwd.is_panel  # tile buckets
    g = np.random.default_rng(12)
    X = g.standard_normal((m.shape[1], 3))
    md = m.astype(np.float64)
    Y = op.matmat(torch.from_numpy(X))
    assert Y.dtype == torch.float64
    assert _rel(Y.numpy(), md @ X) <= 1e-10
    assert _rel(Y.numpy(), np.asarray(op_j.matmat(jnp.asarray(X)))) <= 1e-10
    y = op.matvec(torch.from_numpy(X[:, 0]))
    assert _rel(y.numpy(), md @ X[:, 0]) <= 1e-10
    z = op.normal_matvec(torch.from_numpy(X[:, 0]), reg=0.5)
    assert _rel(z.numpy(), md.T @ (md @ X[:, 0]) + 0.5 * X[:, 0]) <= 1e-10
    with pytest.raises(NotImplementedError):
        op.matmat(torch.from_numpy(X).bfloat16())
