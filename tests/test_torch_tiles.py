"""Port parity, the tile layouts: `fastsparse_torch` against the JAX
reference on the same numpy-seeded inputs (CPU tensors, so the kernels'
plain versions; the reference's Pallas kernels in interpret mode).

* tile-bucket and class-panel layouts (``strip_ids``, ``slab_ids``,
  ``start_slab``, tiles, panels), `ColSegmented` offsets and the strip and
  cross-segment plans equal the reference's, a chunked bucket included
  (``_SMEM_IDX_BUDGET`` shrunk in both packages);
* each plain kernel version (`bucket_spmm` in both bodies, `panel_spmm`
  fold "f32", narrow and windowed, `bucket_spmv`) within 1e-6 of the
  Pallas kernel on the same arrays;
* `spmm`/`spmv` of hybrids with dense tiles, of ``format="bsr"`` scattered
  matrices (0/1 and f32) and of column-segmented layouts, the segment-mode
  disagreement that reaches `bucket_spmv` and an empty segment included,
  within 1e-6 of the reference and of scipy in float64;
* layouts carried across by `interop` give the reference's products;
* the two operator repairs: a failed tile_m=256 build is not hidden, and
  the 0/1 rebuild at the tighter column cap follows the reference's "all
  pieces are panels" rule.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fastsparse as fs
from fastsparse import linops as jlinops
from fastsparse.bench import model as jmodel
from fastsparse.config import Config as JConfig
from fastsparse.formats import bsr as jbsr
from fastsparse.formats import hybrid as jhyb
from fastsparse.formats import segmented as jseg
from fastsparse.ops import assemble as jasm
from fastsparse.ops import bsr_ops as jbo
from fastsparse.ops.pallas import bsr_spmm as jk
import fastsparse_torch as ft
from fastsparse_torch import interop
from fastsparse_torch import linops as tlinops
from fastsparse_torch.bench import model as tmodel
from fastsparse_torch.formats import bsr as tbsr
from fastsparse_torch.formats import hybrid as thyb
from fastsparse_torch.formats import segmented as tseg
from fastsparse_torch.ops import assemble as tasm
from fastsparse_torch.ops import bsr_ops as tbo
from fastsparse_torch.ops.kernels import bsr_tiles as tt

torch.set_num_threads(1)
TOL = 1e-6


def _rel(y, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(y, np.float64) - ref).max() / (
        np.abs(ref).max() + 1e-30
    )


def _coo(rows, cols, shape, vals=None):
    if vals is None:
        m = sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                          shape=shape)
        m.sum_duplicates()
        m.data[:] = 1.0
    else:
        m = sp.coo_matrix((vals.astype(np.float32), (rows, cols)),
                          shape=shape)
        m.sum_duplicates()
    return m.tocsr()


def _scattered(binary=True, seed=0, shape=(400, 6400), nnz=400):
    g = np.random.default_rng(seed)
    r, c = g.integers(0, shape[0], nnz), g.integers(0, shape[1], nnz)
    return _coo(r, c, shape, None if binary else g.standard_normal(nnz))


def _banded(seed=0, n=600, ncol=900, bw=200, density=0.3):
    g = np.random.default_rng(seed)
    r = g.integers(0, n, int(n * bw * density))
    c = np.clip((r * ncol // n) + g.integers(0, bw, r.size), 0, ncol - 1)
    return _coo(r, c, (n, ncol))


def _blocky(seed=0, n=600, ncol=2000):
    """0/1: dense blocks along the diagonal over a scattered tail."""
    g = np.random.default_rng(seed)
    rb = g.integers(0, n, 12000)
    cb = np.clip(rb * ncol // n + g.integers(0, 300, rb.size), 0, ncol - 1)
    rs, cs = g.integers(0, n, 6000), g.integers(0, ncol, 6000)
    return _coo(np.r_[rb, rs], np.r_[cb, cs], (n, ncol))


def _coos(m):
    if bool((m.data == 1.0).all()):
        return (fs.binary_coo_from_scipy(m.tocoo()),
                ft.binary_coo_from_scipy(m, device="cpu"))
    return (fs.coo_from_scipy(m, dtype=np.float32),
            ft.coo_from_scipy(m, device="cpu"))


def _arrays(A):
    return interop.reference_arrays(
        types.SimpleNamespace(fwd=A, bwd=None, shape=A.shape))


def _assert_same(d_ref, d_port):
    assert set(d_ref) == set(d_port), set(d_ref) ^ set(d_port)
    for k, v in d_ref.items():
        w = d_port[k]
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and v.shape == w.shape, k
            assert np.array_equal(v, w), k
        else:
            assert v == w, k


def _check_products(Aj, At, m, Ns=(8, 130), ref_spmv=False):
    """spmm over the port's layout at each N (the narrow and the wide X
    encodings) and spmv within 1e-6 of scipy in float64; the widest spmm
    (and, with ``ref_spmv``, spmv) also within 1e-6 of the reference on its
    layout (the narrow and SpMV bodies are held against the Pallas kernels
    below)."""
    md = m.astype(np.float64)
    for N in Ns:
        X = np.random.default_rng(N).standard_normal(
            (m.shape[1], N)).astype(np.float32)
        yt = ft.spmm(At, torch.from_numpy(X)).numpy()
        assert yt.shape == (m.shape[0], N) and yt.dtype == np.float32
        assert _rel(yt, md @ X) <= TOL, N
    assert _rel(yt, np.asarray(fs.spmm(Aj, jnp.asarray(X)))) <= TOL
    x = np.random.default_rng(5).standard_normal(m.shape[1]).astype(np.float32)
    yt = ft.spmv(At, torch.from_numpy(x)).numpy()
    assert _rel(yt, md @ x) <= TOL
    if ref_spmv:
        assert _rel(yt, np.asarray(fs.spmv(Aj, jnp.asarray(x)))) <= TOL


# (matrix, build_bsr kwargs for both packages)
LAYOUTS = {
    "tiles_binary": (_scattered, {}),
    "tiles_valued": (lambda: _scattered(False), {}),
    "panels_int8": (_banded, {"mono": "off"}),
    "panels_bf16": (_banded, {"mono": "off", "binary_tiles": "bf16"}),
    "tiles_forced": (_banded, {"panels": False}),
    "panels_forced": (lambda: _scattered(shape=(200, 640), nnz=2000),
                      {"panels": True, "mono": "off"}),
    "tiles_tm32": (_scattered, {"tile_m": 32, "panels": False}),
}


def _build_both(m, kw):
    cfg = dict(bsr_mono=kw.get("mono", "auto"),
               binary_tiles=kw.get("binary_tiles", "int8"),
               tile_m=kw.get("tile_m"))
    cj, ct = _coos(m)
    panels = kw.get("panels")
    Aj = jasm.attach_plan(jbsr.build_bsr(cj, config=JConfig(**cfg),
                                         panels=panels))
    At = tasm.attach_plan(tbsr.build_bsr(ct, config=ft.Config(**cfg),
                                         panels=panels, device="cpu"))
    return Aj, At


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_bsr_layout_matches_reference(case):
    make, kw = LAYOUTS[case]
    m = make()
    Aj, At = _build_both(m, kw)
    d_ref, d_port = _arrays(Aj), _arrays(At)
    _assert_same(d_ref, d_port)
    assert d_port["fwd.kind"] == "bsr" and not At.is_mono
    assert At.is_panel == case.startswith("panels")
    assert np.array_equal(At.todense().float().numpy(), m.toarray())
    _check_products(Aj, At, m)


def test_chunked_bucket_layout_and_products(monkeypatch):
    """A bucket cut into several parts (the index budget shrunk in both
    packages): the parts, the strip plan and the products agree."""
    monkeypatch.setattr(jbo, "_SMEM_IDX_BUDGET", 24)
    monkeypatch.setattr(tbo, "_SMEM_IDX_BUDGET", 24)
    m = _scattered(shape=(1200, 3000), nnz=400)
    Aj, At = _build_both(m, {"panels": False})
    parts_j = [(s0, s1, n) for _, s0, s1, n in jbo._bsr_layout(Aj)]
    parts_t = [(s0, s1, n) for _, s0, s1, n in tbo._bsr_layout(At)]
    assert parts_t == parts_j and len(parts_t) > len(At.buckets)
    assert any(n > s1 - s0 for s0, s1, n in parts_t)  # a padded part
    _assert_same(_arrays(Aj), _arrays(At))
    _check_products(Aj, At, m)


def _segmented(m, seg_cols, **cfg):
    cj, ct = _coos(m)
    Aj = jasm.attach_plan(jseg.build_bsr_segmented(
        cj, config=JConfig(**cfg), seg_cols=seg_cols))
    At = tasm.attach_plan(tseg.build_bsr_segmented(
        ct, config=ft.Config(**cfg), seg_cols=seg_cols, device="cpu"))
    return Aj, At


def _mixed_segments():
    """0/1, 400 x 6144 in three 2048-column segments: scattered (tile
    buckets), banded (class panels) and empty."""
    g = np.random.default_rng(9)
    r1, c1 = g.integers(0, 400, 300), g.integers(0, 2048, 300)
    r2 = g.integers(0, 400, 6000)
    c2 = 2048 + r2 * 1800 // 400 + g.integers(0, 100, r2.size)
    return _coo(np.r_[r1, r2], np.r_[c1, c2], (400, 6144))


def test_colseg_layout_and_mode_disagreement(monkeypatch):
    """A ColSegmented of a tile-bucket, a panel and an empty segment (the
    shape of the config B dense part): offsets, segments and the
    cross-segment plan equal the reference's. At N=128 the segment modes
    agree and the plan assembles Y; at N=1 (SpMV) they disagree and both
    packages sum the segments' own SpMVs, the tile segment through
    `bucket_spmv`."""
    m = _mixed_segments()
    Aj, At = _segmented(m, 2048, bsr_mono="off")
    d_ref, d_port = _arrays(Aj), _arrays(At)
    _assert_same(d_ref, d_port)
    assert d_port["fwd.col_offsets"] == (0, 2048, 4096)
    assert d_port["fwd.seg0.kind"] == "bsr" and "fwd.seg0.b0.tiles" in d_port
    assert "fwd.seg1.b0.panels" in d_port and d_port["fwd.seg2.kind"] == "empty"
    assert d_port["fwd.plan.n_row_srcs"] >= 1
    modes = {tbo._seg_mode(s, 1, torch.float32, "highest")
             for s in At.segments}
    assert len(modes) == 2  # SpMV: the empty f32 segment disagrees
    calls = []
    real = tbo.bucket_spmv

    def spy(*a):
        calls.append(a[1].shape)
        return real(*a)

    monkeypatch.setattr(tbo, "bucket_spmv", spy)
    _check_products(Aj, At, m, Ns=(8, 128), ref_spmv=True)
    assert calls  # the SpMV reached the tile-bucket SpMV kernel's wrapper
    assert tbo.colseg_spmm(At, torch.zeros((6144, 1))) is None


def test_colseg_global_panels_window():
    """Uniform panel segments share ONE globally padded X, each launch
    windowed at its segment's rows (N = 8 narrow, N = 130 fold "f32")."""
    m = _banded(3, 400, 1024, 150)
    Aj, At = _segmented(m, 512, bsr_mono="off")
    _assert_same(_arrays(Aj), _arrays(At))
    assert all(s.is_panel for s in At.segments)
    X = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1024, 130)).astype(np.float32))
    parts = tbo._colseg_panel_parts_global(At, X, 130, 256, 0)
    assert parts is not None
    assert sum(p.shape[0] for p in parts) == At.plan.n_slots
    _check_products(Aj, At, m)


# ------------------------------------------------ plain kernels vs Pallas
def _tile_inputs(g, ns=16, T=4, TM=8, TK=128, K_slabs=12, dtype=np.float32,
                 density=0.3):
    slab = g.integers(0, K_slabs, (ns, T)).astype(np.int32)
    tiles = (g.random((ns, T, TM, TK)) < density).astype(np.float32)
    if dtype == np.float32:
        tiles *= g.standard_normal(tiles.shape).astype(np.float32)
    return slab, tiles


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t_bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("body", ["planes_n", "narrow", "expand"])
def test_bucket_spmm_plain_vs_pallas(body):
    g = np.random.default_rng(1)
    TK, K = 128, 12 * 128
    slab, tiles = _tile_inputs(g, dtype=None if body != "expand" else np.float32)
    if body == "planes_n":
        X = g.standard_normal((K, 256)).astype(np.float32)
        xj = jbo._stack_planes(jnp.asarray(X), 128, 256)
        xt = tbo._stack_planes(torch.from_numpy(X), 128, 256)
        assert np.array_equal(np.asarray(xj, np.float32), xt.float().numpy())
        tj, ttt, nb, planes = _bf16(tiles), _t_bf16(tiles), 128, 3
    elif body == "narrow":
        X = g.standard_normal((K, 24)).astype(np.float32)
        xj = jbo._pack_narrow_planes(jnp.asarray(X), K, 24)
        xt = tbo._pack_narrow_planes(torch.from_numpy(X), K, 24)
        assert np.array_equal(np.asarray(xj, np.float32), xt.float().numpy())
        tj, ttt, nb, planes = _bf16(tiles), _t_bf16(tiles), 128, 1
    else:
        X = g.standard_normal((K, 128)).astype(np.float32)
        xj, xt = jnp.asarray(X), torch.from_numpy(X)
        tj, ttt, nb, planes = jnp.asarray(tiles), torch.from_numpy(tiles), 128, 1
    ref = np.asarray(jk.bucket_spmm(
        jnp.asarray(slab), tj, xj, tile_m=8, tile_k=TK, binary=False,
        n_block=nb, strategy="resident", precision="highest",
        binary_path=body if body != "narrow" else "none"))
    tt.reset_launches()
    got = tt.bucket_spmm(torch.from_numpy(slab), ttt, xt, n_block=nb,
                         planes=planes).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert _rel(got, ref) <= TOL
    assert tt.launches["bucket_spmm"] == 0  # the plain version never counts


@pytest.mark.parametrize("mode", ["f32", "narrow", "windowed", "valued"])
def test_panel_spmm_plain_vs_pallas(mode):
    g = np.random.default_rng(2)
    ns, TM, W, TK = 16, 8, 3, 128
    PK = W * TK
    K = 10 * TK
    start = g.integers(0, 10 - W + 1, ns).astype(np.int32)
    pan = (g.random((ns, TM, PK)) < 0.3).astype(np.int8)
    kw = dict(tile_m=TM, tile_k=TK, width=W, binary=False, n_block=128)
    if mode == "valued":
        pv = (pan * g.standard_normal(pan.shape)).astype(np.float32)
        X = g.standard_normal((K, 128)).astype(np.float32)
        ref = jk.panel_spmm(jnp.asarray(start), jnp.asarray(pv),
                            jnp.asarray(X), fold=False, **kw)
        got = tt.panel_spmm(torch.from_numpy(start), torch.from_numpy(pv),
                            torch.from_numpy(X), tile_k=TK, fold=False)
    elif mode == "narrow":
        X = g.standard_normal((K, 16)).astype(np.float32)
        xj = jbo._pack_narrow_planes(jnp.asarray(X), K, 16)
        xt = tbo._pack_narrow_planes(torch.from_numpy(X), K, 16)
        ref = jk.panel_spmm(jnp.asarray(start), jnp.asarray(pan), xj,
                            fold=False, **kw)
        got = tt.panel_spmm(torch.from_numpy(start), torch.from_numpy(pan),
                            xt, tile_k=TK, fold=False)
    else:
        X = g.standard_normal((2 * K if mode == "windowed" else K, 256)
                              ).astype(np.float32)
        wkw = {}
        row_base = 0
        if mode == "windowed":
            wkw = dict(x_rows=K, seg=jnp.asarray([1], jnp.int32))
            row_base = K
        ref = jk.panel_spmm(jnp.asarray(start), jnp.asarray(pan),
                            jnp.asarray(X), fold="f32", **kw, **wkw)
        got = tt.panel_spmm(torch.from_numpy(start), torch.from_numpy(pan),
                            torch.from_numpy(X), tile_k=TK, fold="f32",
                            row_base=row_base)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL


def test_bucket_spmv_plain_vs_pallas():
    g = np.random.default_rng(3)
    slab, tiles = _tile_inputs(g, ns=16, T=4, dtype=None)
    x = g.standard_normal((12, 128)).astype(np.float32)
    ref = np.asarray(jk.bucket_spmv(jnp.asarray(slab), _bf16(tiles),
                                    jnp.asarray(x), tile_m=8, tile_k=128,
                                    binary=False))
    got = tt.bucket_spmv(torch.from_numpy(slab), _t_bf16(tiles),
                         torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (16, 8)
    assert _rel(got, ref) <= TOL


def test_split_planes_match_reference():
    """The mantissa-mask split and the narrow packing, bit for bit."""
    X = np.random.default_rng(4).standard_normal((64, 20)).astype(np.float32)
    X[3, 4] = 0.0
    X[5, 6] = 1e-30
    pj = jbo._split_bf16_planes(jnp.asarray(X))
    pt = tbo._split_bf16_planes(torch.from_numpy(X))
    for a, b in zip(pj, pt):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    assert np.array_equal(
        np.asarray(jbo._pack_narrow_planes(jnp.asarray(X), 80, 24), np.float32),
        tbo._pack_narrow_planes(torch.from_numpy(X), 80, 24).float().numpy())


# ---------------------------------------------------- hybrids and operators
@pytest.fixture
def no_dense_cols(monkeypatch):
    for mod in (jmodel, tmodel):  # the blocks stay dense tiles
        monkeypatch.setattr(mod, "DENSE_COL_MIN_ROWS", 16384)


@pytest.mark.parametrize("case", ["pinned", "auto_tm", "segmented"])
def test_hybrid_with_dense_tiles(no_dense_cols, monkeypatch, case):
    """build_hybrid with dense tiles in both packages (threshold pinned,
    the best-tile-height rule with tile_m=None, and a column-segmented
    dense part with the caps shrunk in both): equal layouts and plans, and
    products within 1e-6."""
    m = _blocky()
    kw = {"threshold": 6}
    cfg_j, cfg_t = JConfig(tile_m=8), ft.Config(tile_m=8)
    if case == "auto_tm":
        cfg_j, cfg_t = JConfig(), ft.Config()
    if case == "segmented":
        # mono off: the reference's attach_plan raises on a mono segment
        # (its fault; the port's repair is test_colseg_mono_segment...)
        cfg_j = JConfig(tile_m=8, bsr_mono="off")
        cfg_t = ft.Config(tile_m=8, bsr_mono="off")
        for mod in (jlinops, tlinops):
            monkeypatch.setattr(mod, "BSR_SEG_COLS_BINARY3", 768)
    cj, ct = _coos(m)
    Hj = jasm.attach_plan(jhyb.build_hybrid(cj, config=cfg_j, **kw))
    Ht = tasm.attach_plan(thyb.build_hybrid(ct, config=cfg_t, device="cpu",
                                            **kw))
    d_ref, d_port = _arrays(Hj), _arrays(Ht)
    _assert_same(d_ref, d_port)
    assert Ht.dense is not None and Ht.dense_nnz > 0
    if case == "segmented":
        assert d_port["fwd.dense.kind"] == "colseg"
    if case == "auto_tm":
        assert Ht.dense.tile_m == tmodel.best_tile_m(
            *np.nonzero(Ht.dense.todense().numpy()), m.shape)
    assert np.array_equal(Ht.todense().numpy(), m.toarray())
    _check_products(Hj, Ht, m)


@pytest.mark.parametrize("case", ["binary", "valued"])
def test_operator_bsr_scattered(case):
    """operator(m, format="bsr") on scattered structure: tile buckets (bf16
    for 0/1, f32 for valued) in both tilings, equal to the reference's
    layout; products, the transpose and the normal equations against
    scipy; the layout carried by interop gives the reference's products."""
    m = _scattered(case == "binary", seed=3, shape=(1600, 1600), nnz=600)
    kw = dict(format="bsr")
    op_j = fs.operator(m, **kw)
    op_t = ft.operator(m, device="cpu", **kw)
    d_ref = interop.reference_arrays(op_j)
    _assert_same(d_ref, interop.reference_arrays(op_t))
    assert d_ref["fwd.kind"] == d_ref["bwd.kind"] == "bsr"
    assert "fwd.b0.tiles" in d_ref and "bwd.b0.tiles" in d_ref
    assert op_t.fwd.dtype == (torch.bfloat16 if case == "binary"
                              else torch.float32)
    op_i = interop.operator_from_reference_arrays(d_ref, "cpu")
    md = m.astype(np.float64)
    g = np.random.default_rng(7)
    X = g.standard_normal((m.shape[1], 12)).astype(np.float32)
    Z = g.standard_normal((m.shape[0], 12)).astype(np.float32)
    for op in (op_t, op_i):
        y = op.matmat(torch.from_numpy(X)).numpy()
        assert _rel(y, np.asarray(op_j.matmat(jnp.asarray(X)))) <= TOL
        assert _rel(y, md @ X) <= TOL
        z = op.rmatmat(torch.from_numpy(Z)).numpy()
        assert _rel(z, md.T @ Z) <= TOL
        v = op.matvec(torch.from_numpy(X[:, 0].copy())).numpy()
        assert _rel(v, np.asarray(op_j.matvec(jnp.asarray(X[:, 0])))) <= TOL
        n = op.normal_matmat(torch.from_numpy(X), reg=0.5).numpy()
        assert _rel(n, md.T @ (md @ X) + 0.5 * X) <= TOL


def _clustered():
    """0/1 scaffold-like blocks scattered over rows and columns (so a
    clustering order gathers them into dense tiles), plus noise."""
    g = np.random.default_rng(11)
    nrow, ncol = 1200, 4000
    rp, cp = g.permutation(nrow), g.permutation(ncol)
    rs, cs = [], []
    for b in range(4):
        rr = rp[b * 48 : (b + 1) * 48]
        cc = cp[b * 150 : (b + 1) * 150]
        k = 2500
        rs.append(rr[g.integers(0, rr.size, k)])
        cs.append(cc[g.integers(0, cc.size, k)])
    rs.append(g.integers(0, nrow, 2000))
    cs.append(g.integers(0, ncol, 2000))
    return _coo(np.concatenate(rs), np.concatenate(cs), (nrow, ncol))


@pytest.mark.parametrize("transpose", [False, True])
def test_operator_tilepack_hybrid(no_dense_cols, transpose):
    """operator(m, reorder="tilepack") on clustered 0/1 structure: a hybrid
    with dense tiles in each tiling, equal to the reference's (permutations
    kept), and products through the boundary within 1e-6; with both
    tilings, a Macau step (rhs = Aᵀ R, cg_normal) whose residual falls."""
    m = _clustered()
    kw = dict(reorder="tilepack", transpose=transpose)
    op_j = fs.operator(m, **kw)
    op_t = ft.operator(m, device="cpu", **kw)
    d_ref = interop.reference_arrays(op_j)
    _assert_same(d_ref, interop.reference_arrays(op_t))
    assert d_ref["fwd.kind"] == "hybrid" and d_ref["fwd.has_dense"]
    assert d_ref["row_perm"] is not None
    md = m.astype(np.float64)
    X = np.random.default_rng(3).standard_normal(
        (m.shape[1], 24)).astype(np.float32)
    y = op_t.matmat(torch.from_numpy(X)).numpy()
    assert _rel(y, np.asarray(op_j.matmat(jnp.asarray(X)))) <= TOL
    assert _rel(y, md @ X) <= TOL
    v = op_t.matvec(torch.from_numpy(X[:, 0].copy())).numpy()
    assert _rel(v, md @ X[:, 0]) <= TOL
    if not transpose:
        return
    assert d_ref["bwd.has_dense"]
    R = np.random.default_rng(4).standard_normal(
        (m.shape[0], 4)).astype(np.float32)
    rhs = op_t.rmatmat(torch.from_numpy(R))
    assert _rel(rhs.numpy(), md.T @ R) <= TOL
    sol = ft.cg_normal(op_t, rhs, reg=5.0, tol=1e-5, maxiter=200)
    V = sol.x.numpy().astype(np.float64)
    b = md.T @ R.astype(np.float64)
    res = np.linalg.norm(b - (md.T @ (md @ V) + 5.0 * V), axis=0)
    assert (res / np.linalg.norm(b, axis=0)).max() < 1e-4


# --------------------------------------------------------------- repairs
def test_colseg_mono_segment_sums_segments(no_dense_cols, monkeypatch):
    """A hybrid whose dense tiles pass the 0/1 column cap while each
    segment picks mono (`_blocky`, ``BSR_SEG_COLS_BINARY3`` shrunk to 768
    in both packages, ``bsr_mono="auto"``): the reference's attach_plan
    raises on it; the port attaches no cross-segment plan and sums the
    segments' own products, within 1e-6 of scipy and of the sum of the
    reference's per-segment products."""
    for mod in (jlinops, tlinops):
        monkeypatch.setattr(mod, "BSR_SEG_COLS_BINARY3", 768)
    m = _blocky()
    cj, ct = _coos(m)
    Hj = jhyb.build_hybrid(cj, config=JConfig(tile_m=8), threshold=6)
    with pytest.raises(AttributeError, match="slab_ids"):
        jasm.attach_plan(Hj)
    Ht = tasm.attach_plan(thyb.build_hybrid(ct, config=ft.Config(tile_m=8),
                                            device="cpu", threshold=6))
    Dj, Dt = Hj.dense, Ht.dense
    assert type(Dt).__name__ == "ColSegmented" and Dt.plan is None
    assert len(Dt.segments) == len(Dj.segments) > 1
    assert all(s.is_mono for s in Dt.segments)
    assert Dt.col_offsets == Dj.col_offsets and Ht.dense_nnz == Hj.dense_nnz
    md = m.astype(np.float64)
    for N in (130, 8):  # the reference's sum below at N = 8
        X = np.random.default_rng(N).standard_normal(
            (m.shape[1], N)).astype(np.float32)
        assert _rel(ft.spmm(Ht, torch.from_numpy(X)).numpy(), md @ X) <= TOL
    yd = ft.spmm(Dt, torch.from_numpy(X)).numpy()
    ref = sum(np.asarray(fs.spmm(s, jnp.asarray(X[off : off + s.shape[1]])))
              for off, s in zip(Dj.col_offsets, Dj.segments))
    assert _rel(yd, ref) <= TOL
    assert _rel(yd, Dt.todense().double().numpy() @ X) <= TOL
    x = X[:, 0].copy()
    assert _rel(ft.spmv(Ht, torch.from_numpy(x)).numpy(), md @ x) <= TOL


def test_failed_tile_m_256_build_is_not_hidden(monkeypatch):
    """The tile_m=256 retry of operator(format="bsr") keeps the taller
    build only when it is mono (the reference's is_mono test); a build
    that fails raises instead of passing for "not mono"."""
    m = _banded(2, 1500, 1500, 250, density=0.35)
    op = ft.operator(m, format="bsr", transpose=False, device="cpu")
    assert op.fwd.is_mono and op.fwd.tile_m == 256  # the retry was taken
    real = tlinops._compile_bsr

    def failing(coo, config, dtype, device):
        if config.tile_m == 256:
            raise NotImplementedError("a failed build")
        return real(coo, config, dtype, device)

    monkeypatch.setattr(tlinops, "_compile_bsr", failing)
    with pytest.raises(NotImplementedError, match="a failed build"):
        ft.operator(m, format="bsr", transpose=False, device="cpu")


def test_binary3_rebuild_keeps_wide_panels():
    """A 0/1 matrix 20,000 columns wide (past BSR_SEG_COLS_BINARY3, within
    the f32 cap) whose one piece is a class-panel layout is NOT rebuilt
    at the tighter cap: the reference's rule is "some piece is not a
    panel layout", not "the build is not mono"."""
    g = np.random.default_rng(12)
    n, ncol = 256, 20_000
    r = g.integers(0, n, 8000)
    c = np.clip(r * (ncol - 400) // n + g.integers(0, 300, r.size), 0,
                ncol - 1)
    m = _coo(r, c, (n, ncol))
    kw = dict(format="bsr", transpose=False)
    op_j = fs.operator(m, config=JConfig(bsr_mono="off", tile_m=8), **kw)
    op_t = ft.operator(m, config=ft.Config(bsr_mono="off", tile_m=8),
                       device="cpu", **kw)
    d_ref = interop.reference_arrays(op_j)
    _assert_same(d_ref, interop.reference_arrays(op_t))
    assert isinstance(op_t.fwd, ft.BsrMatrix) and op_t.fwd.is_panel
    X = np.random.default_rng(1).standard_normal((ncol, 4)).astype(np.float32)
    assert _rel(op_t.matmat(torch.from_numpy(X)).numpy(),
                m.astype(np.float64) @ X) <= TOL


def test_unported_tile_modes_raise():
    m = _scattered()
    _, ct = _coos(m)
    with pytest.raises(NotImplementedError, match="slice 3b"):
        tbsr.build_bsr(ct, config=ft.Config(binary_tiles="bitmask"),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="slice 3b"):
        tbsr.build_bsr(ct, binary=True, device="cpu")
    A = tasm.attach_plan(tbsr.build_bsr(ct, device="cpu"))
    X = torch.zeros((m.shape[1], 4))
    with pytest.raises(NotImplementedError, match="slice 3b"):
        tt.bucket_spmm(A.buckets[0].slab_ids, A.buckets[0].tiles,
                       torch.zeros((768, 256)), n_block=128, planes=2)
    # ported since: an f64 operand runs the COO engine, as in the reference
    Xd = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m.shape[1], 4)))
    ref = m.astype(np.float64) @ Xd.numpy()
    Y = ft.spmm(A, Xd)
    assert Y.dtype == torch.float64
    assert np.abs(Y.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    with pytest.raises(NotImplementedError):
        ft.spmm(A, X.bfloat16())
    b = tbsr.build_bsr(ct, panels=True, device="cpu").buckets[0]
    with pytest.raises(NotImplementedError, match="slice 3b"):
        tt.panel_spmm(b.start_slab, b.panels, torch.zeros((768, 384),
                      dtype=torch.bfloat16), tile_k=128, fold=True)
