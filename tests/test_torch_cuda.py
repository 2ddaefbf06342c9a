"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device). This file imports no JAX, so it also runs where
only the port is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Each kernel is held against its plain PyTorch version on the same card
tensors (colmax, quant3, densecols, mono_panel, mono_group, every ELL
gather body, the one-launch-per-bucket gather and both double-word gathers
bit-exact; the s8 tensor-core engine and the old bodies each on the shapes
they serve, told apart by kernel name; the tile-layout kernels at
max|d|/max|ref| <= 1e-6, the tile kernels
at tile_k up to 2048 and on strips of up to 70 tiles, each tile mode on
the body it belongs to), and operator products against scipy in float64
(the fp64-class products at 1e-10). The scatter engines (``index_add_``:
atomics in no fixed order) are held to 1e-6 (f32) and 1e-10 (f64), and
`sort_coo` on the card to its CPU result.
"""
import ctypes
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fastsparse_torch as ft
from fastsparse_torch.bench import model as tmodel
from fastsparse_torch.formats import bsr as tbsr
from fastsparse_torch.ops import bsr_ops
from fastsparse_torch.ops.kernels import bsr_spmm as tk
from fastsparse_torch.ops.kernels import bsr_tiles as tt
from fastsparse_torch.ops.kernels import ell_spmm as ek

import rmat_layout
from card_helpers import kernel_names, neg_zero_parts, same_bits, tiling_plans

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _banded(seed, nrow, ncol, bw, density=0.3):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, nrow, int(nrow * bw * density))
    c = np.clip(
        (r * (ncol / nrow)).astype(int) + rng.integers(0, bw, r.size),
        0, ncol - 1,
    )
    m = sp.coo_matrix((np.ones(r.size, np.float32), (r, c)),
                      shape=(nrow, ncol))
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()


@pytest.fixture
def card_op(card, monkeypatch):
    monkeypatch.setattr(tbsr, "MONO_WIN_SLABS", 8)
    monkeypatch.setattr(tbsr, "HALO_STRIDE", 16)
    m = _banded(1, 2000, 4000, 300)
    op = ft.operator(m, format="bsr", transpose=True, device=card)
    assert op.fwd.is_mono and op.fwd.narrow is not None
    return m, op


def _rel(a, b):
    d = (a.double() - b.double()).abs().max().item()
    return d / (b.double().abs().max().item() + 1e-30)


def test_kernels_match_plain_on_card(card_op):
    m, op = card_op
    A = op.fwd
    b = A.buckets[0]
    K_pad = b.n_windows * b.win_slabs * A.tile_k
    X = torch.randn((K_pad, 256), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    X[::13, 3] = 0.5  # exact .5 ties at sinv = 1 (set below)
    tk.reset_launches()
    mk = tk.colmax(X)
    assert torch.equal(mk, tk.colmax_plain(X))
    s = torch.where(mk > 0, mk, 1.0) * (1.0 / (127.0 * 65536.0))
    sinv = 1.0 / s
    sinv[0, 3] = 1.0
    planes = tk.quant3_planes(X, sinv, n_block=128)
    assert torch.equal(planes, tk.quant3_planes_plain(X, sinv, n_block=128))
    kw = dict(tile_m=A.tile_m, tile_k=A.tile_k, width=b.width,
              win_slabs=b.win_slabs,
              out_rows=max(b.out_strips, A.n_strips) * A.tile_m)
    args = (b.window, b.strip_ptr, b.start_rel, b.panels)
    yk = tk.mono_panel_spmm(*args, planes, n_block=128, fold="i8w",
                            scale=s, **kw)
    yp = tk.mono_panel_spmm_plain(*args, planes, n_block=128, fold="i8w",
                                  scale=s, **kw)
    assert torch.equal(yk, yp)
    for N in (9, 40):
        nq = bsr_ops._narrow_nq(N)
        nb = bsr_ops._round_up(3 * nq, 32)
        qn, _ = bsr_ops._quant3_narrow(X[:, :N], K_pad, nq, nb)
        yk = tk.mono_panel_spmm(*args, qn, n_block=nb, fold=False, **kw)
        yp = tk.mono_panel_spmm_plain(*args, qn, n_block=nb, fold=False, **kw)
        assert torch.equal(yk, yp)
    h = A.narrow
    K_h = ((h.n_windows - 1) * h.stride + h.win_slabs) * A.tile_k
    qh, _ = bsr_ops._quant3_narrow(X[:, :1], K_h, 8, 32)
    gkw = dict(tile_m=A.tile_m, tile_k=A.tile_k, width=h.width,
               stride=h.stride, group=h.group)
    assert tuple(qh.shape) == (32, K_h)  # K-major
    yk = tk.mono_group_spmm(h.windows, h.start_rel, h.panels, qh, **gkw)
    yp = tk.mono_group_spmm_plain(h.windows, h.start_rel, h.panels, qh, **gkw)
    torch.cuda.synchronize()
    assert torch.equal(yk, yp)
    assert tk.launches == {"colmax": 1, "quant3_planes": 1, "mono_panel": 3,
                           "mono_group": 1, "densecols": 0}


@pytest.mark.parametrize("K", [1001, 1002, 1024])
def test_quant3_kmajor_any_k_on_card(card, K):
    """quant3's K-major planes bit-equal to the plain version when K keeps
    the plane rows word-aligned (word stores) and when it does not (byte
    stores), with a ragged last k block."""
    X = torch.randn((K, 384), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(K))
    sinv = 1.0 / (X.abs().amax(dim=0, keepdim=True) / (127.0 * 65536.0))
    got = tk.quant3_planes(X, sinv, n_block=128)
    assert got.shape == (3 * 384, K)
    assert torch.equal(got, tk.quant3_planes_plain(X, sinv, n_block=128))


@pytest.mark.parametrize("N", [1, 16, 128, 130])
def test_operator_on_card_vs_scipy(card_op, N):
    m, op = card_op
    md = m.astype(np.float64)
    X = np.random.default_rng(N).standard_normal((m.shape[1], N)).astype(
        np.float32
    )
    Xc = torch.from_numpy(X).cuda()
    Y = op.matmat(Xc)
    assert Y.is_cuda
    ref = md @ X.astype(np.float64)
    assert np.abs(Y.cpu().numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    Z = op.normal_matmat(Xc, reg=0.5).cpu().numpy()
    ref = md.T @ (md @ X) + 0.5 * X
    assert np.abs(Z - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("N", [16, 128])
@pytest.mark.parametrize("tile_m", [64, 256])
def test_mono_operator_tile_m_on_card(card, monkeypatch, tile_m, N):
    """tile_m=256 (two 128-row CTAs a strip) and 64 (one warpgroup) mono
    layouts whose strips hold 1, 2 and 3 items (and more): mono_panel on
    the s8 engine bit for bit against its plain version, both modes, and
    the products against scipy."""
    monkeypatch.setattr(tbsr, "MONO_WIN_SLABS", 6)
    m = _banded(3, 2048, 3000, 700)
    op = ft.operator(m, format="bsr", transpose=True, device=card,
                     config=ft.Config(tile_m=tile_m))
    assert op.fwd.tile_m == tile_m and op.fwd.is_mono and op.bwd.is_mono
    md = m.astype(np.float64)
    X = np.random.default_rng(N).standard_normal((m.shape[1], N)).astype(
        np.float32)
    Xc = torch.from_numpy(X).cuda()
    for A in (op.fwd, op.bwd):
        b = A.buckets[0]
        per_strip = set((b.strip_ptr[1:] - b.strip_ptr[:-1]).tolist())
        assert {1, 2, 3} <= per_strip
        assert b.panels.shape[2] % 128 == 0
        Xr = Xc if A is op.fwd else torch.from_numpy(
            np.random.default_rng(N + 1).standard_normal(
                (m.shape[0], N)).astype(np.float32)).cuda()
        (planes, scale), NB, _, fold, _ = bsr_ops._prep_mono_x(
            A, Xr, N, "highest")
        kw = dict(tile_m=A.tile_m, tile_k=A.tile_k, width=b.width,
                  win_slabs=b.win_slabs, n_block=NB, fold=fold,
                  out_rows=max(b.out_strips, A.n_strips) * A.tile_m,
                  scale=scale if fold else None)
        args = (b.window, b.strip_ptr, b.start_rel, b.panels, planes)
        names = kernel_names(lambda: tk.mono_panel_spmm(*args, **kw))
        assert "s8_engine_kernel" in names and "mono_kernel" not in names
        assert torch.equal(tk.mono_panel_spmm(*args, **kw),
                           tk.mono_panel_spmm_plain(*args, **kw))
    Y = op.matmat(Xc).cpu().numpy()
    ref = md @ X.astype(np.float64)
    assert np.abs(Y - ref).max() <= 1e-6 * np.abs(ref).max()
    Z = op.normal_matmat(Xc, reg=0.5).cpu().numpy()
    ref = md.T @ (md @ X) + 0.5 * X
    assert np.abs(Z - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("N", [1, 16, 128])
def test_operator_tile_m8_on_card(card, monkeypatch, N):
    """tile_m=8 strips are shorter than the kernels' 32-row block: the
    rows past the strip must be masked on load and store."""
    monkeypatch.setattr(tbsr, "MONO_WIN_SLABS", 8)
    m = _banded(2, 700, 1500, 200)
    op = ft.operator(m, format="bsr", transpose=True, device=card,
                     config=ft.Config(tile_m=8))
    assert op.fwd.tile_m == 8 and op.fwd.is_mono and op.bwd.is_mono
    md = m.astype(np.float64)
    X = np.random.default_rng(N).standard_normal((m.shape[1], N)).astype(
        np.float32
    )
    Y = op.matmat(torch.from_numpy(X).cuda()).cpu().numpy()
    ref = md @ X.astype(np.float64)
    assert np.abs(Y - ref).max() <= 1e-6 * np.abs(ref).max()
    Z = op.normal_matmat(torch.from_numpy(X).cuda(), reg=0.5).cpu().numpy()
    ref = md.T @ (md @ X) + 0.5 * X
    assert np.abs(Z - ref).max() <= 1e-6 * np.abs(ref).max()


# (K, unit, packed): every body of the bucket kernel. K <= 64 is the
# whole-row body; past it the chunked bodies, with chunk lengths 13 (valued
# 130), 15 (unit 135) and 50 (packed 200: 25 pairs), none a multiple of 4.
ELL_MODES = {
    "valued_full": (48, False, False),
    "unit_full": (7, True, False),
    "packed_full": (64, True, True),
    "valued_chunked": (130, False, False),
    "unit_chunked": (135, True, False),
    "packed_chunked": (200, True, True),
}


def _ell_inputs(K, lanes, seed, nb=40, ncol=3000):
    g = np.random.default_rng(seed)
    rows_pad = -(-(ncol + 1) // 8) * 8
    cols = g.integers(0, ncol, (nb, K)).astype(np.int32)
    cols[-3:, K // 2 :] = ncol  # sentinel padding slots (a zero X row)
    vals = g.standard_normal((nb, K)).astype(np.float32)
    x = g.standard_normal((rows_pad, lanes)).astype(np.float32)
    x[ncol:] = 0.0
    return (torch.from_numpy(cols).cuda(), torch.from_numpy(vals).cuda(),
            torch.from_numpy(x).cuda())


@pytest.mark.parametrize("lanes", [1, 2, 3, 4, 6, 8, 128, 260])
@pytest.mark.parametrize("mode", sorted(ELL_MODES))
def test_ell_bucket_kernel_matches_plain(card, mode, lanes):
    K, unit, packed = ELL_MODES[mode]
    cols, vals, x = _ell_inputs(K, lanes, seed=K + lanes)
    pk = ek._pack_pairs(cols).reshape(cols.shape[0], K // 2) if packed else None
    assert ek._body_mode(K, x.shape[0], unit)[2] == packed
    ek.reset_launches()
    yk = ek.ell_bucket_spmm(cols, vals, x, unit=unit, packed=pk)
    torch.cuda.synchronize()
    assert ek.launches["ell_bucket"] == 1
    yp = ek.ell_bucket_spmm_plain(cols, vals, x, unit=unit, packed=pk)
    assert yk.shape == (cols.shape[0], lanes) and torch.equal(yk, yp)


# (K, unit, packed, nb): a single slot (three of a row's four accumulator
# threads hold no entry), and 72 rows (not a multiple of the narrow
# body's 32, 16 or 4 rows a CTA)
NARROW_EDGES = {
    "valued_k1": (1, False, False, 40),
    "unit_k1": (1, True, False, 40),
    "packed_k2": (2, True, True, 40),
    "valued_72_rows": (48, False, False, 72),
    "packed_chunked_72_rows": (200, True, True, 72),
}


@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(NARROW_EDGES))
def test_ell_bucket_narrow_edges(card, case, lanes):
    K, unit, packed, nb = NARROW_EDGES[case]
    cols, vals, x = _ell_inputs(K, lanes, seed=K + nb + lanes, nb=nb)
    pk = ek._pack_pairs(cols).reshape(nb, K // 2) if packed else None
    assert ek._body_mode(K, x.shape[0], unit)[2] == packed
    yk = ek.ell_bucket_spmm(cols, vals, x, unit=unit, packed=pk)
    torch.cuda.synchronize()
    yp = ek.ell_bucket_spmm_plain(cols, vals, x, unit=unit, packed=pk)
    assert yk.shape == (nb, lanes) and torch.equal(yk, yp)


def test_ell_bucket_picks_body(card):
    """At most 8 X lanes run the narrow body (four threads a row), 16 and
    128 lanes the lane-split body; each mode bit-exact on each."""
    for mode, (K, unit, packed) in sorted(ELL_MODES.items()):
        for lanes in (1, 2, 4, 8, 16, 128):
            cols, vals, x = _ell_inputs(K, lanes, seed=lanes)
            pk = (ek._pack_pairs(cols).reshape(cols.shape[0], K // 2)
                  if packed else None)
            names = kernel_names(lambda: ek.ell_bucket_spmm(
                cols, vals, x, unit=unit, packed=pk))
            want, other = ("ell_narrow_kernel", "ell_bucket_kernel")[
                :: 1 if lanes <= 8 else -1]
            assert want in names and other not in names, (mode, lanes, names)
            assert torch.equal(
                ek.ell_bucket_spmm(cols, vals, x, unit=unit, packed=pk),
                ek.ell_bucket_spmm_plain(cols, vals, x, unit=unit, packed=pk))


@pytest.mark.parametrize("lanes", [1, 128])
def test_ell_sweep_kernel_matches_plain(card, lanes):
    parts = ((16, 2), (8, 5), (24, 32), (8, 1))
    g = np.random.default_rng(lanes)
    ncol = 20_000
    words = []
    for n_rows, K2 in parts:
        c = g.integers(0, ncol + 1, (n_rows, 2 * K2)).astype(np.int32)
        words.append(ek._pack_pairs(torch.from_numpy(c)))
    flat = torch.cat(words).cuda()
    x = torch.from_numpy(
        g.standard_normal((ncol + 8, lanes)).astype(np.float32)).cuda()
    x[ncol:] = 0.0
    ek.reset_launches()
    yk = ek.ell_sweep_spmm(flat, x, parts=parts)
    torch.cuda.synchronize()
    assert ek.launches["ell_sweep"] == 1
    assert torch.equal(yk, ek.ell_sweep_spmm_plain(flat, x, parts=parts))


@pytest.mark.parametrize("fmt", ["auto", "ell"])
def test_ell_operator_on_card_vs_scipy(card, fmt):
    """auto lands on ELL for a valued power-law; format="ell" on a binary
    matrix past SEG_COLS builds three column segments (sweeps and chunks).
    Products through the card's kernels against scipy in float64."""
    if fmt == "auto":
        m = ft.bench.matrices.powerlaw(3000, 3000, 60_000, seed=1)
    else:
        m = ft.bench.matrices.powerlaw(2000, 60_000, 80_000, seed=2,
                                       binary=True)
    op = ft.operator(m, format=fmt, device=card)
    assert type(op.fwd).__name__ == ("EllMatrix" if fmt == "auto"
                                     else "SegmentedEll")
    md = m.astype(np.float64)
    ek.reset_launches()
    for N in (1, 16, 128):
        X = np.random.default_rng(N).standard_normal(
            (m.shape[1], N)).astype(np.float32)
        Y = op.matmat(torch.from_numpy(X).cuda()).cpu().numpy()
        ref = md @ X.astype(np.float64)
        assert np.abs(Y - ref).max() <= 1e-6 * np.abs(ref).max()
    y = np.random.default_rng(0).standard_normal(m.shape[0]).astype(np.float32)
    z = op.rmatvec(torch.from_numpy(y).cuda()).cpu().numpy()
    ref = md.T @ y.astype(np.float64)
    assert np.abs(z - ref).max() <= 1e-6 * np.abs(ref).max()
    # the valued layout runs bucket chunks, the binary one packed sweeps
    assert ek.launches["ell_bucket" if fmt == "auto" else "ell_sweep"] > 0


# (K, unit) of the one-launch gather #11: chunks of 12, 10 and 16 entries,
# and the SMEM_BLOCK_K caps (valued 4096, unit 8192); rows of 24 and 72
# bytes (8-byte copies at N <= 8) and of 36 bytes (4-byte copies), and
# 90 entries in two slices of 8-byte copies
SMEM_WIDTHS = [(12, False), (12, True), (40, False), (40, True),
               (64, False), (64, True), (4096, False), (8192, True),
               (6, False), (6, True), (18, False), (18, True), (9, True),
               (90, False)]


@pytest.mark.parametrize("N", [1, 2, 8, 33, 128])
@pytest.mark.parametrize("K,unit", SMEM_WIDTHS)
def test_ell_smem_kernel_matches_plain(card, K, unit, N):
    # 2,056 rows: not a multiple of the 256 (N = 33, 128) or the 32, 16 or
    # 4 (N <= 8) rows a block takes; 33 lanes take the one-lane path
    nb = 2056 if K <= 64 else 40
    cols, vals, x = _ell_inputs(K, N, seed=K + N, nb=nb)
    ek.reset_launches()
    yk = ek.ell_bucket_spmm_smem(cols, vals, x, unit=unit)
    torch.cuda.synchronize()
    assert ek.launches["ell_bucket_smem"] == 1
    yp = ek.ell_bucket_spmm_smem_plain(cols, vals, x, unit=unit)
    assert yk.shape == (nb, N) and torch.equal(yk, yp)


def test_ell_smem_operator_on_card_vs_scipy(card, monkeypatch):
    """USE_SMEM_PATH on: an operator built under the flag (its plan keyed
    by it) launches #11 for every bucket past the budget."""
    from fastsparse_torch.ops import ell_ops

    monkeypatch.setattr(ell_ops, "USE_SMEM_PATH", True)
    monkeypatch.setattr(ell_ops, "_SMEM_IDX_BUDGET_VALUED", 4096)
    m = ft.bench.matrices.powerlaw(3000, 3000, 60_000, seed=1)
    op = ft.operator(m, format="ell", device=card)
    assert "smem" in {mo for _, mo, *_ in ell_ops._seg_layout(op.fwd)}
    md = m.astype(np.float64)
    ek.reset_launches()
    for N in (1, 16, 128):
        X = np.random.default_rng(N).standard_normal(
            (m.shape[1], N)).astype(np.float32)
        Y = op.matmat(torch.from_numpy(X).cuda()).cpu().numpy()
        ref = md @ X.astype(np.float64)
        assert np.abs(Y - ref).max() <= 1e-6 * np.abs(ref).max()
    assert ek.launches["ell_bucket_smem"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("binary", [False, True])
def test_scatter_products_on_card_vs_scipy(card, binary, dtype):
    """spmv/spmv_t/spmm/spmm_t over a padded COO, its CSR and an ELL on
    CUDA tensors; `sort_coo` on the card equals its CPU result."""
    m = ft.bench.matrices.powerlaw(3000, 2500, 40_000, seed=3,
                                   binary=binary)
    m = m.astype(np.float32 if dtype == torch.float32 else np.float64)
    mk = ft.binary_coo_from_scipy if binary else ft.coo_from_scipy
    coo = mk(m, device=card).pad_to(1 << 16)
    tol = 1e-6 if dtype == torch.float32 else 1e-10
    md = m.astype(np.float64)
    g = np.random.default_rng(4)
    x, y = g.standard_normal(m.shape[1]), g.standard_normal(m.shape[0])
    X, Y = (g.standard_normal((m.shape[1], 16)),
            g.standard_normal((m.shape[0], 16)))
    cases = {"spmv": (x, md @ x), "spmv_t": (y, md.T @ y),
             "spmm": (X, md @ X), "spmm_t": (Y, md.T @ Y)}
    ell = ft.build_ell(coo, device=card)
    for A in (coo, ft.to_csr(coo), ell):
        for name, (v, ref) in cases.items():
            if A is ell and not name.endswith("_t"):
                continue  # the gather engine's products are held above
            got = getattr(ft, name)(A, torch.from_numpy(v).to(card, dtype))
            assert got.is_cuda and got.dtype == dtype, name
            got = got.cpu().numpy()
            assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), name
    cpu = mk(m, device="cpu").pad_to(1 << 16)
    for order in ("hilbert", "row"):
        a, b = ft.sort_coo(coo, order), ft.sort_coo(cpu, order)
        assert torch.equal(a.rows.cpu(), b.rows)
        assert torch.equal(a.cols.cpu(), b.cols)


@pytest.mark.parametrize("N", [1, 3, 32, 128, 256])
@pytest.mark.parametrize("nrow,D", [(1000, 333), (2065, 512), (700, 5376)])
def test_densecols_kernel_matches_plain(card, nrow, D, N):
    """Both bodies on a ragged block: the mma.sync tiles (N<=8, and every N
    at D=333: byte loads), the s8 engine (N >= 9 at D=512 and at the ECFP
    block's D=5376, a ring that wraps many times); rows past a CTA's tile,
    D past a 128-byte chunk, lanes past a column block; bit-exact."""
    g = np.random.default_rng(nrow + D + N)
    block = torch.from_numpy((g.random((nrow, D)) < 0.3).astype(np.int8))
    q3t = g.integers(-128, 128, (3 * N, D)).astype(np.int8)
    q3t[:N] = g.integers(-127, 128, (N, D))  # the top plane's range
    s = (g.random((1, N)) * 1e-5 + 1e-7).astype(np.float32)
    args = (block.cuda(), torch.from_numpy(q3t).cuda(),
            torch.from_numpy(s).cuda())
    tk.reset_launches()
    yk = tk.densecols_spmm(*args)
    torch.cuda.synchronize()
    assert tk.launches["densecols"] == 1
    assert yk.shape == (nrow, N) and torch.equal(yk, tk.densecols_spmm_plain(*args))


def test_hybrid_operator_on_card_vs_scipy(card, monkeypatch):
    """format="auto" -> hybrid (dense columns + ELL, both tilings) on a
    fingerprint matrix, with the dense-column constants shrunk to its
    size; products through the card's kernels against scipy in float64."""
    monkeypatch.setattr(tmodel, "DENSE_COL_MIN_D", 4)
    monkeypatch.setattr(tmodel, "DENSE_COL_CELL_S", 2e-11)
    monkeypatch.setattr(tmodel, "DENSE_COL_MIN_ROWS", 64)
    m = ft.bench.matrices.ecfp_like(800, 2000, 24, 20, seed=2)
    op = ft.operator(m, device=card)
    assert type(op.fwd).__name__ == "HybridMatrix"
    assert op.fwd.dense_cols is not None and op.bwd.dense_cols is not None
    md = m.astype(np.float64)
    tk.reset_launches()
    for N in (1, 16, 128):
        X = np.random.default_rng(N).standard_normal(
            (m.shape[1], N)).astype(np.float32)
        Y = op.matmat(torch.from_numpy(X).cuda()).cpu().numpy()
        ref = md @ X.astype(np.float64)
        assert np.abs(Y - ref).max() <= 1e-6 * np.abs(ref).max()
    y = np.random.default_rng(0).standard_normal(m.shape[0]).astype(np.float32)
    z = op.rmatvec(torch.from_numpy(y).cuda()).cpu().numpy()
    ref = md.T @ y.astype(np.float64)
    assert np.abs(z - ref).max() <= 1e-6 * np.abs(ref).max()
    assert tk.launches["densecols"] == 4


def test_reorder_boundary_on_card(card):
    """operator(..., reorder="degree") with the dual tiling keeps both
    permutations: operands are gathered at the boundary on the card."""
    m = ft.bench.matrices.ecfp_like(800, 2000, 24, 20, seed=2)
    op = ft.operator(m, format="ell", reorder="degree", device=card)
    assert op.row_perm is not None and op.col_perm.is_cuda
    md = m.astype(np.float64)
    g = np.random.default_rng(3)
    X = g.standard_normal((m.shape[1], 16)).astype(np.float32)
    Z = g.standard_normal((m.shape[0], 16)).astype(np.float32)
    for got, ref in (
        (op.matmat(torch.from_numpy(X).cuda()), md @ X),
        (op.rmatmat(torch.from_numpy(Z).cuda()), md.T @ Z),
        (op.normal_matmat(torch.from_numpy(X).cuda(), reg=0.5),
         md.T @ (md @ X) + 0.5 * X),
    ):
        got = got.cpu().numpy()
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# ------------------------------------------------------ tile-layout kernels
# (tile dtype, x dtype, planes) of every bucket_spmm mode
BUCKET_MODES = {
    "planes_n": (torch.bfloat16, torch.bfloat16, 3),
    "narrow": (torch.bfloat16, torch.bfloat16, 1),
    "f32": (torch.float32, torch.float32, 1),
    "bf16_f32": (torch.bfloat16, torch.float32, 1),
}


def _tile_bucket(g, ns, T, TM, TK=128, n_slabs=20, dtype=torch.bfloat16,
                 n_pad=2):
    """A ragged bucket: random 0/1 (or f32) tiles with about half their
    columns empty (the tensor-core body skips those), the last ``n_pad``
    slots all-zero padding at slab 0, as `build_bsr` pads."""
    slab = g.integers(0, n_slabs, (ns, T)).astype(np.int32)
    tiles = (g.random((ns, T, TM, TK)) < 0.3).astype(np.float32)
    tiles *= g.random((ns, T, 1, TK)) < 0.5
    if dtype == torch.float32:
        tiles *= g.standard_normal(tiles.shape).astype(np.float32)
    slab[-n_pad:] = 0
    tiles[-n_pad:] = 0.0
    return (torch.from_numpy(slab).cuda(),
            torch.from_numpy(tiles).to(dtype).cuda())


# (ns, T, Npad): a ragged bucket two column blocks wide; a strip of 70
# tiles (the summation length); a bucket of three strips (the CTA's warps
# split each strip's tile loop)
BUCKET_SHAPES = {"ragged": (13, 3, 256), "long": (2, 70, 128),
                 "few": (3, 5, 128)}


@pytest.mark.parametrize("shape", sorted(BUCKET_SHAPES))
@pytest.mark.parametrize("TM", [8, 20])
@pytest.mark.parametrize("mode", sorted(BUCKET_MODES))
def test_bucket_spmm_kernel_matches_plain(card, mode, TM, shape):
    tdt, xdt, planes = BUCKET_MODES[mode]
    ns, T, Npad = BUCKET_SHAPES[shape]
    n_pad = 2 if ns > 4 else 1
    g = np.random.default_rng(TM + T)
    slab, tiles = _tile_bucket(g, ns=ns, T=T, TM=TM, dtype=tdt, n_pad=n_pad)
    nb = 128
    x = torch.from_numpy(g.standard_normal(
        (20 * 128, planes * Npad)).astype(np.float32)).to(xdt).cuda()
    tt.reset_launches()
    yk = tt.bucket_spmm(slab, tiles, x, n_block=nb, planes=planes)
    torch.cuda.synchronize()
    assert tt.launches["bucket_spmm"] == 1
    yp = tt.bucket_spmm_plain(slab, tiles, x, n_block=nb, planes=planes)
    assert yk.shape == (ns * TM, Npad) and _rel(yk, yp) <= 1e-6
    pad = yk[-n_pad * TM:]
    assert torch.equal(pad, torch.zeros_like(pad))


# (panel dtype, x dtype, fold)
PANEL_MODES = {
    "f32_int8": (torch.int8, torch.float32, "f32"),
    "f32_bf16": (torch.bfloat16, torch.float32, "f32"),
    "narrow_int8": (torch.int8, torch.bfloat16, False),
    "narrow_bf16": (torch.bfloat16, torch.bfloat16, False),
    "valued": (torch.float32, torch.float32, False),
}


@pytest.mark.parametrize("TM", [8, 20])
@pytest.mark.parametrize("row_base", [0, 1280])
@pytest.mark.parametrize("mode", sorted(PANEL_MODES))
def test_panel_spmm_kernel_matches_plain(card, mode, row_base, TM):
    """Windowed X (``row_base``); fold "f32" at 256 f32 lanes (two column
    blocks) for TM 8 and 384 for TM 20; the last panel all zero."""
    pdt, xdt, fold = PANEL_MODES[mode]
    g = np.random.default_rng(7 + TM)
    ns, W = 11, 3
    start = torch.from_numpy(
        g.integers(0, 10 - W + 1, ns).astype(np.int32)).cuda()
    pan = (g.random((ns, TM, W * 128)) < 0.3).astype(np.float32)
    pan *= g.random((ns, 1, W * 128)) < 0.5
    pan[-1] = 0.0
    if pdt == torch.float32:
        pan *= g.standard_normal(pan.shape).astype(np.float32)
    pan = torch.from_numpy(pan).to(pdt).cuda()
    lanes = (256 if TM == 8 else 384) if fold == "f32" else 128
    x = torch.from_numpy(g.standard_normal(
        (2560, lanes)).astype(np.float32)).to(xdt).cuda()
    kw = dict(tile_k=128, fold=fold, row_base=row_base)
    tt.reset_launches()
    yk = tt.panel_spmm(start, pan, x, **kw)
    torch.cuda.synchronize()
    assert tt.launches["panel_spmm"] == 1
    yp = tt.panel_spmm_plain(start, pan, x, **kw)
    assert yk.shape == (ns * TM, lanes) and _rel(yk, yp) <= 1e-6
    assert torch.equal(yk[-TM:], torch.zeros_like(yk[-TM:]))


def _mono_items(gen, n_strips, TM, W, TK=128, win_slabs=8, extra=12):
    """A mono item list shaped like the headline's (one item a strip,
    ``extra`` strips with a second one), 0/1 int8 panels of TM x W·TK made
    on the card; returns the four arrays, the kwargs and the X rows."""
    g = np.random.default_rng(n_strips + TM)
    counts = np.ones(n_strips, np.int64)
    counts[g.choice(n_strips, extra, replace=False)] += 1
    strip_of = np.repeat(np.arange(n_strips), counts)
    rows_win = win_slabs * TK
    n_windows = -(-n_strips * TM // rows_win)
    window = np.minimum(strip_of * TM // rows_win, n_windows - 1)
    start_rel = g.integers(0, win_slabs - W + 1, strip_of.size)
    strip_ptr = np.searchsorted(strip_of, np.arange(n_strips + 1))
    panels = (torch.rand((strip_of.size, TM, W * TK), device="cuda",
                         generator=gen) < 0.39).to(torch.int8)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()

    kw = dict(tile_m=TM, tile_k=TK, width=W, win_slabs=win_slabs,
              out_rows=n_strips * TM)
    return ((i32(window), i32(strip_ptr), i32(start_rel), panels), kw,
            n_windows * rows_win)


def test_s8_engine_picks_body(card):
    """densecols on the ECFP forward block's shape (50,176 x 5,376) at
    N = 32, 128, 256 (the mma.sync body at N = 1 and 8) and mono_panel on
    the headline's (208 items of 256 x 768, 196 strips; i8w N=128 and
    narrow N=32) run the s8 engine;
    densecols at N <= 8 or D = 333 and mono_panel at tile_m = 8 the old
    bodies. Each bit-exact against its plain version."""
    gen = torch.Generator("cuda").manual_seed(5)

    def i8(shape, lo=-128):
        return torch.randint(lo, 128, shape, device="cuda", generator=gen,
                             dtype=torch.int8)

    for (nrow, D), N, want in (((50_176, 5_376), 32, "s8_engine_kernel"),
                               ((50_176, 5_376), 128, "s8_engine_kernel"),
                               ((50_176, 5_376), 256, "s8_engine_kernel"),
                               ((50_176, 5_376), 8, "densecols_kernel"),
                               ((50_176, 5_376), 1, "densecols_kernel"),
                               ((2_000, 333), 128, "densecols_kernel")):
        block = (torch.rand((nrow, D), device="cuda", generator=gen)
                 < 0.3).to(torch.int8)
        q3t = i8((3 * N, D))
        s = torch.rand((1, N), device="cuda", generator=gen) * 1e-5 + 1e-7
        names = kernel_names(lambda: tk.densecols_spmm(block, q3t, s))
        other = ({"s8_engine_kernel", "densecols_kernel"} - {want}).pop()
        assert want in names and other not in names, (nrow, D, N, names)
        assert torch.equal(tk.densecols_spmm(block, q3t, s),
                           tk.densecols_spmm_plain(block, q3t, s))
        del block, q3t
    for TM, W, n_strips, want in ((256, 6, 196, "s8_engine_kernel"),
                                  (8, 6, 300, "mono_kernel")):
        args, kw, K_rows = _mono_items(gen, n_strips, TM, W)
        s = torch.rand((1, 128), device="cuda", generator=gen) * 1e-5 + 1e-7
        for x, mode in ((i8((384, K_rows)), dict(n_block=128, fold="i8w",
                                                 scale=s)),
                        (i8((96, K_rows)), dict(n_block=96, fold=False))):
            names = kernel_names(
                lambda: tk.mono_panel_spmm(*args, x, **kw, **mode))
            other = ({"s8_engine_kernel", "mono_kernel"} - {want}).pop()
            assert want in names and other not in names, (TM, mode, names)
            assert torch.equal(tk.mono_panel_spmm(*args, x, **kw, **mode),
                               tk.mono_panel_spmm_plain(*args, x, **kw,
                                                        **mode))


def _halo_items(gen, ns, TM, G=4, W=6, TK=128, stride=10, win_slabs=16):
    """A halo item list: ``ns`` strips (a multiple of G), one item each,
    G strips sharing a window; windows ``stride`` slabs apart and
    ``win_slabs`` long, so they overlap and items placed past ``stride -
    W`` slabs into their window straddle the next window's start. 0/1 int8
    panels of TM x W·TK made on the card; returns the three arrays, the
    kwargs and the X rows."""
    g = np.random.default_rng(ns + TM)
    ng = ns // G
    n_windows = max(ng // 2, 1)
    windows = np.sort(g.integers(0, n_windows, ng))
    start_rel = g.integers(0, win_slabs - W + 1, ns)
    start_rel[::3] = win_slabs - W  # the last slot: straddles
    panels = (torch.rand((ns, TM, W * TK), device="cuda", generator=gen)
              < 0.39).to(torch.int8)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).cuda()

    kw = dict(tile_m=TM, tile_k=TK, width=W, stride=stride, group=G)
    return ((i32(windows), i32(start_rel), panels), kw,
            ((n_windows - 1) * stride + win_slabs) * TK)


@pytest.mark.parametrize("N", [1, 2, 8, 16])
@pytest.mark.parametrize("TM,ns,want", [(256, 200, "s8_engine_kernel"),
                                        (64, 52, "s8_engine_kernel"),
                                        (32, 60, "mono_kernel"),
                                        (8, 120, "mono_kernel")])
def test_s8_engine_picks_body_halo(card, TM, ns, want, N):
    """mono_group (the halo layout) on the s8 engine at TM 256 (the
    headline's 200 strips) and 64, on the dp4a body at TM 32 and 8, told
    apart by kernel name; K-major narrow planes of N = 1, 2, 8 (nq 8: 32
    lanes) and 16 (64 lanes) from `_quant3_narrow`; windows that overlap
    and items that straddle into the next window. Bit-exact against the
    plain version."""
    gen = torch.Generator("cuda").manual_seed(TM + N)
    args, kw, K_rows = _halo_items(gen, ns, TM)
    nq = bsr_ops._narrow_nq(N)
    nb = bsr_ops._round_up(3 * nq, 32)
    X = torch.randn((K_rows, N), device="cuda", generator=gen)
    x, _ = bsr_ops._quant3_narrow(X, K_rows, nq, nb)
    assert tuple(x.shape) == (nb, K_rows)
    names = kernel_names(lambda: tk.mono_group_spmm(*args, x, **kw))
    other = ({"s8_engine_kernel", "mono_kernel"} - {want}).pop()
    assert want in names and other not in names, (TM, N, names)
    y = tk.mono_group_spmm(*args, x, **kw)
    assert y.shape == (ns * TM, nb)
    assert torch.equal(y, tk.mono_group_spmm_plain(*args, x, **kw))


def test_s8_engine_route_by_alignment(card):
    """The launcher routes by shape and alignment before it launches: a
    q3t off the 16-byte alignment TMA needs takes the mma.sync body (and
    matches), an aligned one the engine, whose ring fits the card."""
    from fastsparse_torch.ops.kernels._build import load_library

    stages = ctypes.c_int(0)
    smem = load_library().fs_s8_engine_smem(64, 3, 2, ctypes.byref(stages))
    assert smem <= 232_448 and 2 <= stages.value <= 6
    block = torch.ones((300, 512), dtype=torch.int8, device="cuda")
    buf = torch.randint(-128, 128, (3 * 16 * 512 + 1,), dtype=torch.int8,
                        device="cuda")
    s = torch.ones((1, 16), device="cuda")
    for q3t, want in ((buf[1:].view(48, 512), "densecols_kernel"),
                      (buf[:-1].view(48, 512), "s8_engine_kernel")):
        names = kernel_names(lambda: tk.densecols_spmm(block, q3t, s))
        assert want in names, names
        assert torch.equal(tk.densecols_spmm(block, q3t, s),
                           tk.densecols_spmm_plain(block, q3t, s))


def test_tile_kernels_pick_one_body(card):
    """Each exact-bf16 mode runs the tensor-core body and each f32-valued
    mode the scalar body, and each matches its plain version."""
    g = np.random.default_rng(11)
    for mode, (tdt, xdt, planes) in BUCKET_MODES.items():
        slab, tiles = _tile_bucket(g, ns=9, T=4, TM=8, dtype=tdt)
        x = torch.from_numpy(g.standard_normal(
            (20 * 128, planes * 128)).astype(np.float32)).to(xdt).cuda()
        kw = dict(n_block=128, planes=planes)
        names = kernel_names(lambda: tt.bucket_spmm(slab, tiles, x, **kw))
        want = "tile_mma_kernel" if xdt == torch.bfloat16 else "bucket_scalar"
        assert want in names and ("scalar" in names) == (
            want == "bucket_scalar"), (mode, names)
        assert _rel(tt.bucket_spmm(slab, tiles, x, **kw),
                    tt.bucket_spmm_plain(slab, tiles, x, **kw)) <= 1e-6
    start = torch.from_numpy(g.integers(0, 8, 9).astype(np.int32)).cuda()
    for mode, (pdt, xdt, fold) in PANEL_MODES.items():
        pan = (g.random((9, 8, 256)) < 0.3).astype(np.float32)
        if pdt == torch.float32:
            pan *= g.standard_normal(pan.shape).astype(np.float32)
        pan = torch.from_numpy(pan).to(pdt).cuda()
        x = torch.from_numpy(g.standard_normal(
            (1280, 128)).astype(np.float32)).to(xdt).cuda()
        kw = dict(tile_k=128, fold=fold)
        names = kernel_names(lambda: tt.panel_spmm(start, pan, x, **kw))
        want = "tile_mma_kernel" if pdt != torch.float32 else "panel_scalar"
        assert want in names and ("scalar" in names) == (
            want == "panel_scalar"), (mode, names)
        assert _rel(tt.panel_spmm(start, pan, x, **kw),
                    tt.panel_spmm_plain(start, pan, x, **kw)) <= 1e-6


@pytest.mark.parametrize("TK", [128, 512])
@pytest.mark.parametrize("T", [1, 5, 16])
@pytest.mark.parametrize("TM", [8, 20, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bucket_spmv_kernel_matches_plain(card, dtype, TM, T, TK):
    """Strips of 1 to 16 tiles (1, 2 or 4 tiles a batch; a strip split
    over 2 or 4 warps), TM not a multiple of 8 and past a warp's rows,
    tile_k 128 and 512, bf16 and f32 tiles."""
    g = np.random.default_rng(TM + T + TK)
    slab, tiles = _tile_bucket(g, ns=21, T=T, TM=TM, TK=TK, dtype=dtype)
    x = torch.from_numpy(g.standard_normal((20, TK)).astype(np.float32)).cuda()
    tt.reset_launches()
    yk = tt.bucket_spmv(slab, tiles, x)
    torch.cuda.synchronize()
    assert tt.launches["bucket_spmv"] == 1
    assert yk.shape == (21, TM) and _rel(yk, tt.bucket_spmv_plain(
        slab, tiles, x)) <= 1e-6


def test_tile_kernels_raise_rather_than_fall_back(card):
    g = np.random.default_rng(0)
    slab, tiles = _tile_bucket(g, ns=9, T=2, TM=8)
    x = torch.zeros((20 * 128, 256), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a strided X: no copy, no plain path
        tt.bucket_spmm(slab, tiles, x[:, ::2], n_block=128, planes=1)
    with pytest.raises(ValueError):  # X on the host, tiles on the card
        tt.bucket_spmm(slab, tiles, x.cpu(), n_block=128, planes=1)
    tt.reset_launches()
    with pytest.raises(NotImplementedError):  # no such body
        tt.bucket_spmm(slab, tiles, x[:, :128].contiguous().float(),
                       n_block=128, planes=3)
    with pytest.raises(NotImplementedError):  # plane blocks of 32 lanes
        tt.bucket_spmm(slab, tiles, x[:, :96].contiguous(), n_block=32,
                       planes=3)
    assert tt.launches["bucket_spmm"] == 0


def test_tile_operators_on_card_vs_scipy(card):
    """Tile buckets through operator(m, format="bsr") and a column-
    segmented layout whose SpMV segments disagree (the bucket_spmv path),
    on the card, against scipy in float64; each tile kernel launches."""
    g = np.random.default_rng(5)
    r, c = g.integers(0, 1600, 600), g.integers(0, 1600, 600)
    m = sp.coo_matrix((np.ones(600, np.float32), (r, c)), shape=(1600, 1600))
    m.sum_duplicates()
    m.data[:] = 1.0
    op = ft.operator(m.tocsr(), format="bsr", device=card)
    assert not op.fwd.is_panel and op.fwd.strip_plan is not None
    r1, c1 = g.integers(0, 400, 300), g.integers(0, 2048, 300)
    r2 = g.integers(0, 400, 6000)
    c2 = 2048 + r2 * 1800 // 400 + g.integers(0, 100, r2.size)
    mb = sp.coo_matrix((np.ones(6300, np.float32), (np.r_[r1, r2],
                        np.r_[c1, c2])), shape=(400, 6144))
    mb.sum_duplicates()
    mb.data[:] = 1.0
    from fastsparse_torch.formats.segmented import build_bsr_segmented
    from fastsparse_torch.ops.assemble import attach_plan

    cs = attach_plan(build_bsr_segmented(
        ft.binary_coo_from_scipy(mb, device=card),
        config=ft.Config(bsr_mono="off"), seg_cols=2048, device=card))
    tt.reset_launches()
    for A, mat in ((op.fwd, m), (cs, mb)):
        md = mat.astype(np.float64)
        for N in (8, 130):
            X = g.standard_normal((mat.shape[1], N)).astype(np.float32)
            Y = ft.spmm(A, torch.from_numpy(X).cuda()).cpu().numpy()
            assert _rel(torch.from_numpy(Y), torch.from_numpy(md @ X)) <= 1e-6
        x = g.standard_normal(mat.shape[1]).astype(np.float32)
        y = ft.spmv(A, torch.from_numpy(x).cuda()).cpu()
        assert _rel(y, torch.from_numpy(md @ x)) <= 1e-6
    assert all(v > 0 for v in tt.launches.values()), tt.launches


# ------------------------------------------------------ tile_k past 256
def _scattered01(g, nrow, ncol, nnz):
    r, c = g.integers(0, nrow, nnz), g.integers(0, ncol, nnz)
    m = sp.coo_matrix((np.ones(nnz, np.float32), (r, c)), shape=(nrow, ncol))
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()


@pytest.mark.parametrize("kind", ["bucket_planes", "bucket_narrow",
                                  "bucket_f32x", "panel_f32",
                                  "panel_narrow"])
@pytest.mark.parametrize("tile_k", [512, 2048])
def test_tile_kernels_any_tile_k(card, tile_k, kind):
    """bucket_spmm (tile buckets) and panel_spmm (class panels, forced by
    build_bsr's ``panels=``) at tile_k 512 and 2048 in each tensor-core
    mode and in the scalar body's bf16 tiles × f32 X (its K-chunk loop),
    against their plain versions on the built layout's arrays."""
    panels = kind.startswith("panel")
    g = np.random.default_rng(tile_k)
    m = _scattered01(g, 64, 4 * tile_k, 3000)
    A = tbsr.build_bsr(ft.binary_coo_from_scipy(m, device=card),
                       config=ft.Config(tile_m=8, tile_k=tile_k,
                                        bsr_mono="off"),
                       panels=panels, device=card)
    assert A.is_panel == panels and A.tile_k == tile_k and A.buckets
    K = A.n_slabs * tile_k
    X = torch.from_numpy(g.standard_normal((K, 128)).astype(np.float32)).cuda()
    if kind == "bucket_planes":
        X, kw = bsr_ops._stack_planes(X, 128, 128), dict(n_block=128, planes=3)
    elif kind == "panel_f32":
        kw = dict(tile_k=tile_k, fold="f32")
    elif kind == "bucket_f32x":
        kw = dict(n_block=128, planes=1)
    else:
        X = bsr_ops._pack_narrow_planes(X[:, :32], K, 32)
        kw = (dict(tile_k=tile_k, fold=False) if panels
              else dict(n_block=128, planes=1))
    tt.reset_launches()
    for b in A.buckets:
        if panels:
            yk = tt.panel_spmm(b.start_slab, b.panels, X, **kw)
            yp = tt.panel_spmm_plain(b.start_slab, b.panels, X, **kw)
        else:
            yk = tt.bucket_spmm(b.slab_ids, b.tiles, X, **kw)
            yp = tt.bucket_spmm_plain(b.slab_ids, b.tiles, X, **kw)
        torch.cuda.synchronize()
        assert yk.shape == yp.shape and _rel(yk, yp) <= 1e-6
    name = "panel_spmm" if panels else "bucket_spmm"
    assert tt.launches[name] == len(A.buckets)


def test_operator_tile_k_512_on_card_vs_scipy(card):
    g = np.random.default_rng(21)
    m = _scattered01(g, 1600, 1600, 600)
    op = ft.operator(m, format="bsr", config=ft.Config(tile_m=8, tile_k=512),
                     device=card)
    assert op.fwd.tile_k == 512 and not op.fwd.is_mono
    md = m.astype(np.float64)
    tt.reset_launches()
    for N in (8, 130):
        X = g.standard_normal((1600, N)).astype(np.float32)
        Y = op.matmat(torch.from_numpy(X).cuda()).cpu()
        assert _rel(Y, torch.from_numpy(md @ X)) <= 1e-6
        Z = op.rmatmat(torch.from_numpy(X).cuda()).cpu()
        assert _rel(Z, torch.from_numpy(md.T @ X)) <= 1e-6
    x = g.standard_normal(1600).astype(np.float32)
    assert _rel(op.matvec(torch.from_numpy(x).cuda()).cpu(),
                torch.from_numpy(md @ x)) <= 1e-6
    assert sum(tt.launches.values()) > 0


# ------------------------------------------------- fp64-class gather (dd)
def _dd_bucket(g, valued, nb=40, K=24, k_rows=48, n_pad=5):
    """A bucket whose last ``n_pad`` rows are padding (the sentinel column
    ``k_rows - 8`` for unit values, column 0 with zero values otherwise),
    values and X spanning 10^±6."""
    sentinel = k_rows - 8
    cols = g.integers(0, sentinel, (nb, K)).astype(np.int32)
    cols[-n_pad:] = 0 if valued else sentinel
    v = g.standard_normal((nb, K)) * 10.0 ** g.integers(-6, 6, (nb, K))
    v[-n_pad:] = 0.0
    vh = v.astype(np.float32)
    vl = (v - vh).astype(np.float32)
    return cols, vh, vl, sentinel


def _dd_x2(g, k_rows, N, sentinel):
    X = g.standard_normal((sentinel, N)) * 10.0 ** g.integers(-6, 6, (sentinel, N))
    x2 = np.zeros((2 * k_rows, N), np.float32)
    x2[:sentinel] = X.astype(np.float32)
    x2[k_rows : k_rows + sentinel] = (X - x2[:sentinel]).astype(np.float32)
    return x2


@pytest.mark.parametrize("N", [1, 2, 8, 32, 33])
@pytest.mark.parametrize("nb,K", [(40, 24), (8, 2048), (16, 384), (24, 6),
                                  (2056, 24), (8, 81)])
@pytest.mark.parametrize("valued", [False, True])
def test_dd_kernels_match_plain(card, valued, nb, K, N):
    """ell_bucket_spmm_dd (#12) and ell_bucket_spmm_dd_valued (#13)
    against their plain versions, bit for bit in hi and lo, on short rows
    and on long ones (the split kernel then takes several slices, or a
    block a row; 81 slots copy 4 bytes at a time). Both forms run the
    rows kernel (one thread a chain) on the 24 rows of 6 slots and on the
    2,056 rows at N = 33 (unit values from N = 32, where that grid holds
    half a block an SM), the split kernel on the others (unit values in
    blocks of 8 lanes at N >= 9); N = 32 is a whole warp of lanes a row."""
    from fastsparse_torch.ops.kernels import ell_dd as dk

    g = np.random.default_rng(N + 100 * valued + K)
    cols, vh, vl, sentinel = _dd_bucket(g, valued, nb=nb, K=K)
    x2 = torch.from_numpy(_dd_x2(g, 48, N, sentinel)).cuda()
    cols, vh, vl = (torch.from_numpy(a).cuda() for a in (cols, vh, vl))
    dk.reset_launches()
    if valued:
        yk = dk.ell_bucket_spmm_dd_valued(cols, vh, vl, x2)
        yp = dk.ell_bucket_spmm_dd_valued_plain(cols, vh, vl, x2)
        name = "ell_bucket_dd_valued"
    else:
        yk = dk.ell_bucket_spmm_dd(cols, x2)
        yp = dk.ell_bucket_spmm_dd_plain(cols, x2)
        name = "ell_bucket_dd"
    torch.cuda.synchronize()
    assert dk.launches[name] == 1
    for k, p in zip(yk, yp):
        assert k.shape == (nb, N) and torch.equal(k, p)
    assert not yk[0][-5:].any() and not yk[1][-5:].any()


def test_dd_kernels_raise_rather_than_fall_back(card):
    from fastsparse_torch.ops.kernels import ell_dd as dk

    g = np.random.default_rng(3)
    cols, vh, vl, sentinel = _dd_bucket(g, True)
    x2 = torch.from_numpy(_dd_x2(g, 48, 4, sentinel))
    cols_c = torch.from_numpy(cols).cuda()
    dk.reset_launches()
    with pytest.raises(ValueError):  # indices on the card, X on the host
        dk.ell_bucket_spmm_dd(cols_c, x2)
    with pytest.raises(ValueError):  # a strided X
        dk.ell_bucket_spmm_dd(cols_c, x2.cuda()[:, ::2])
    with pytest.raises(ValueError):  # values on the host
        dk.ell_bucket_spmm_dd_valued(cols_c, torch.from_numpy(vh),
                                     torch.from_numpy(vl), x2.cuda())
    assert sum(dk.launches.values()) == 0


def test_spmm_dd_on_card_vs_scipy(card):
    """spmm_dd through both kernels on the card: a segmented DdEll and a
    unit ``format="ell"`` operator built unsplit, within 1e-10 of scipy
    per column; and an f64 ``format="ell"`` operator's products."""
    from fastsparse_torch.ops.kernels import ell_dd as dk

    g = np.random.default_rng(9)
    mv = sp.random(300, 500, density=0.04, format="csr", random_state=9)
    mv.data[:] = g.standard_normal(mv.nnz) * 10.0 ** g.integers(-6, 6, mv.nnz)
    mb = _scattered01(g, 300, 500, 6000).astype(np.float64)
    X = g.standard_normal((500, 5)) * 10.0 ** g.integers(-6, 6, (500, 5))
    dk.reset_launches()
    Av = ft.build_ell_dd(mv, seg_cols=128, device=card)
    opb = ft.operator(mb, format="ell", transpose=False,
                      config=ft.Config(ell_split_rows=0), device=card)
    for A, m in ((Av, mv), (opb, mb)):
        Y = ft.spmm_dd(A, torch.from_numpy(X).cuda())
        assert Y.is_cuda and Y.dtype == torch.float64
        ref = m @ X
        scale = np.abs(ref).max(axis=0, keepdims=True) + 1e-300
        assert np.max(np.abs(Y.cpu().numpy() - ref) / scale) < 1e-10
    assert all(v > 0 for v in dk.launches.values()), dk.launches
    op64 = ft.operator(mv, format="ell", transpose=True, device=card)
    x = g.standard_normal(500)
    for got, ref in ((op64.matvec(torch.from_numpy(x).cuda()), mv @ x),
                     (op64.rmatvec(torch.from_numpy(x[:300]).cuda()),
                      mv.T @ x[:300])):
        assert got.dtype == torch.float64
        assert _rel(got.cpu(), torch.from_numpy(ref)) < 1e-10


# ------------------------------------------------------ assembly-plan kernel
PLAN_CASES = ["ecfp", "rmat", "rmat_strips", "segmented_ell"]


def _plan_case(card, monkeypatch, case):
    """[((plan, TM), card plan)]: a layout built on the CPU and carried to
    the card through `interop` (whose loader derives the schedule anew)."""
    from fastsparse_torch import interop
    from fastsparse_torch.ops import assemble

    kw = {}
    if case == "ecfp":
        monkeypatch.setattr(tmodel, "DENSE_COL_MIN_D", 4)
        monkeypatch.setattr(tmodel, "DENSE_COL_CELL_S", 2e-10)
        monkeypatch.setattr(tmodel, "DENSE_COL_MIN_ROWS", 64)
        m = ft.bench.matrices.ecfp_like(800, 2000, 24, 20, seed=2)
    elif case.startswith("rmat"):
        rmat_layout.shrink(monkeypatch)
        if case == "rmat_strips":  # no row_srcs: the plan sums strips
            monkeypatch.setattr(assemble, "_row_positions", lambda *a: None)
        m = rmat_layout.matrix()
        kw = {"reorder": "auto", "transpose": False}
    else:
        m = ft.bench.matrices.powerlaw(2000, 60_000, 80_000, seed=2,
                                       binary=True)
        kw = {"format": "ell"}
    op = ft.operator(m, device="cpu", **kw)
    on_card = interop.operator_from_reference_arrays(
        interop.reference_arrays(op), device=card)
    pairs = []
    for side in ("fwd", "bwd"):
        pairs += [(p, q) for p, (q, _) in zip(
            tiling_plans("", getattr(op, side)).values(),
            tiling_plans("", getattr(on_card, side)).values())]
    return pairs


@pytest.mark.parametrize("N", [1, 4, 32, 128, 256])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_kernel_matches_plain(card, monkeypatch, case, N):
    """The plan kernel against the torch ops it replaces (on the CPU, and
    on the card for class plans), bit for bit with -0.0 planted: ELL plans
    through `apply_plan`, cross-segment plans through the colseg walk
    (row by row over ``row_srcs``, or strip by strip)."""
    from fastsparse_torch.ops import assemble, ell_ops
    from fastsparse_torch.ops.kernels import assemble as ak

    pairs = _plan_case(card, monkeypatch, case)
    assert pairs
    if case.startswith("rmat"):
        assert {TM is None for (_, TM), _ in pairs} == {True, False}
        assert any(bool(p.row_srcs) == (case == "rmat")
                   for (p, TM), _ in pairs if TM)
    g = np.random.default_rng(N)
    ak.reset_launches()
    for (plan, TM), cplan in pairs:
        if TM is None:
            P = neg_zero_parts(g, plan.n_slots, ell_ops._lanes(N))
            want = assemble._apply_plan(plan, P)
            assert same_bits(assemble._apply_plan(cplan, P.to(card)), want)
            got = assemble.apply_plan(cplan, P.to(card))
        else:
            P = neg_zero_parts(g, plan.n_slots * TM, N).view(-1, TM, N)
            parts = list(P.split(max(plan.n_slots // 3, 1)))
            want = bsr_ops._colseg_sum(plan, parts, P, TM, N)
            got = bsr_ops._colseg_sum(cplan, [p.to(card) for p in parts],
                                      P.to(card), TM, N)
        torch.cuda.synchronize()
        assert same_bits(got, want), (case, N, TM)
    assert ak.launches["plan_sum"] == len(pairs)


def _walk_schedule(ptr, src, P, n_levels):
    rows = []
    for r in range(len(ptr) - 1):
        acc = torch.zeros(P.shape[1])
        for j in range(ptr[r], ptr[r + 1]):
            acc = P[src[j]].clone() if j == ptr[r] else acc + P[src[j]]
        if 0 < ptr[r + 1] - ptr[r] < n_levels:
            acc = acc + 0.0
        rows.append(acc)
    return torch.stack(rows)


@pytest.mark.parametrize("L", [1, 3, 4, 12, 128, 260])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_kernel_schedule_by_hand(card, aligned, L):
    """Rows of 0 to 30 sources (past the loads a thread keeps in flight),
    with and without the sentinel's + 0.0, on 16-byte-aligned parts and
    on parts 4 bytes off (the scalar lanes)."""
    from fastsparse_torch.ops.kernels import assemble as ak

    g = np.random.default_rng(L)
    n, counts = 40, [0, 1, 2, 3, 8, 9, 17, 30, 0, 1, 5]
    src = np.concatenate([g.integers(0, n, c) for c in counts])
    ptr = np.concatenate([[0], np.cumsum(counts)])
    P = neg_zero_parts(g, n, L)
    buf = torch.empty(n * L + 1, device=card)
    Pc = (buf[: n * L] if aligned else buf[1:]).view(n, L)
    Pc.copy_(P)
    ptr_c = torch.as_tensor(ptr, dtype=torch.int32, device=card)
    src_c = torch.as_tensor(src, dtype=torch.int32, device=card)
    for n_levels in (0, 10):
        got = ak.plan_sum(ptr_c, src_c, Pc, n_levels)
        torch.cuda.synchronize()
        assert same_bits(got, _walk_schedule(ptr, src, P, n_levels))


@pytest.mark.parametrize("case", ["rmat", "hybrid"])
def test_eager_call_counts_one_plan_kernel_per_application(card, monkeypatch,
                                                           case):
    """A recorded eager call launches the plan kernel once per plan it
    applies (counter ``plan_kernel``), and each ``assemble`` span issues
    that one launch and nothing else."""
    from fastsparse_torch import tracing
    from fastsparse_torch.ops.kernels import assemble as ak

    op, calls = _graph_case(card, monkeypatch, case)
    name, X, kw = calls[2] if case == "hybrid" else calls[0]
    applied = len(tiling_plans("", op.fwd)) + (
        len(tiling_plans("", op.bwd)) if name == "normal_matmat" else 0)
    assert applied == 2
    twin = _eager_twin(op)
    ak.reset_launches()
    with tracing.recording() as rec:
        getattr(twin, name)(X, **kw)
    torch.cuda.synchronize()
    assert rec.counts["plan_kernel"] == ak.launches["plan_sum"] == applied
    spans = [s for s in rec.spans if s.name == "assemble"]
    assert spans
    for s in spans:
        assert s.counts == {"ops": 1, "plan_kernel": 1}


# ------------------------------------------------- products replayed as graphs
def _eager_twin(op):
    """The same tilings with a cache that never engages: the eager path."""
    import dataclasses

    twin = dataclasses.replace(op)
    twin.graphs.engages = lambda X, reg=None: False
    return twin


def _graph_case(card, monkeypatch, case):
    """(operator, [(product, operand, keywords)]) of a small instance of
    each path a graph replays."""
    g = torch.Generator("cuda").manual_seed(3)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, device=card, generator=g, dtype=dtype)

    if case == "mono":
        monkeypatch.setattr(tbsr, "MONO_WIN_SLABS", 8)
        monkeypatch.setattr(tbsr, "HALO_STRIDE", 16)
        m = _banded(1, 2000, 4000, 300)
        op = ft.operator(m, format="bsr", transpose=True, device=card)
        X = rand(m.shape[1], 16)
        assert op._mono_chainable(X)
        return op, [("matmat", X, {}), ("normal_matmat", X, {"reg": 0.5})]
    if case == "hybrid":
        # dense columns in the forward tiling, plans in both
        monkeypatch.setattr(tmodel, "DENSE_COL_MIN_D", 4)
        monkeypatch.setattr(tmodel, "DENSE_COL_CELL_S", 2e-10)
        monkeypatch.setattr(tmodel, "DENSE_COL_MIN_ROWS", 64)
        m = ft.bench.matrices.ecfp_like(800, 2000, 24, 20, seed=2)
        op = ft.operator(m, device=card)
        assert op.fwd.dense_cols is not None
        assert op.fwd.sparse.plan is not None and op.bwd.sparse.plan is not None
        return op, [("matmat", rand(m.shape[1], 32), {}),
                    ("rmatmat", rand(m.shape[0], 32), {}),
                    ("normal_matmat", rand(m.shape[1], 32), {"reg": 50.0})]
    if case == "rmat":
        # the Graph 500 layout: the boundary gathers, dense columns,
        # column-segmented tiles and a segmented ELL with its plan's adds
        rmat_layout.shrink(monkeypatch)
        m = rmat_layout.matrix()
        op = ft.operator(m, reorder="auto", transpose=False, device=card)
        p = rmat_layout.parts(op.fwd)
        assert p["dense_cols"] and p["tile_segments"] and p["plan_adds"], p
        assert p["ell_segments"] >= 2 and op.col_perm is not None, p
        return op, [("matmat", rand(m.shape[1], 128), {}),
                    ("matvec", rand(m.shape[1]), {})]
    if case == "segmented_ell":
        m = ft.bench.matrices.powerlaw(2000, 60_000, 80_000, seed=2,
                                       binary=True)
        op = ft.operator(m, format="ell", device=card)
        assert type(op.fwd).__name__ == "SegmentedEll"
        return op, [("matmat", rand(m.shape[1], 16), {}),
                    ("rmatvec", rand(m.shape[0]), {})]
    assert case == "spmm_dd"
    mb = _scattered01(np.random.default_rng(9), 300, 500, 6000)
    op = ft.operator(mb.astype(np.float64), format="ell", transpose=False,
                     config=ft.Config(ell_split_rows=0), device=card)
    return op, [("spmm_dd", rand(500, 5, dtype=torch.float64), {})]


def _product(op, name):
    return (lambda X, **kw: ft.spmm_dd(op, X)) if name == "spmm_dd" else \
        getattr(op, name)


GRAPH_CASES = ["mono", "hybrid", "segmented_ell", "spmm_dd", "rmat"]


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_replay_bit_equal_to_eager(card, monkeypatch, case):
    """Each product called three times (eager, captured, replayed) gives
    the eager path's result bit for bit, each call a tensor of its own;
    an operand changed in place between calls is seen."""
    from fastsparse_torch import graphs, tracing

    op, calls = _graph_case(card, monkeypatch, case)
    twin = _eager_twin(op)
    for name, X, kw in calls:
        want = _product(twin, name)(X, **kw)
        outs = []
        with tracing.recording() as rec:
            for _ in range(3):
                outs.append(_product(op, name)(X, **kw))
        torch.cuda.synchronize()
        assert rec.counts.get("captures") == 1, (name, rec.counts)
        assert rec.counts.get("replays") == 1, (name, rec.counts)
        assert "graph_refused" not in rec.counts
        for y in outs:
            assert torch.equal(y, want), name
        (key, g), = [(k, v) for k, v in op.graphs.graphs.items()
                     if k[0] == name]
        ptrs = {y.untyped_storage().data_ptr() for y in outs}
        assert len(ptrs) == 3 and g.y.untyped_storage().data_ptr() not in ptrs
        X.mul_(-0.5)
        assert torch.equal(_product(op, name)(X, **kw),
                           _product(twin, name)(X, **kw)), name
        assert isinstance(g, graphs._Graph)
    assert not op.graphs.refused


def test_replay_launches_the_eager_kernels(card, monkeypatch):
    """A replayed normal_matmat of the hybrid runs the eager path's
    kernels, as many of each, seen by the profiler inside the graph."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    op, calls = _graph_case(card, monkeypatch, "hybrid")
    twin = _eager_twin(op)
    _, X, kw = calls[2]

    def kernels(fn):
        # the most of each name over a few sessions: the profiler drops
        # records now and then, in spells
        most, sessions = collections.Counter(), []
        # a pause and an empty session first: it takes the records an
        # earlier session delivers late
        time.sleep(0.3)
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        for i in range(4):
            if i:
                time.sleep(0.3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # once the process has run many sessions, the profiler
                # drops a session's first one or two device records: let
                # them be spin launches, a name not counted
                for _ in range(4):
                    torch.cuda._sleep(1_000)
                fn(X, **kw)
                torch.cuda.synchronize()
            sessions.append(collections.Counter(
                e.name() for e in prof.profiler.kineto_results.events()
                if str(e.device_type()).endswith("CUDA")
                and not e.name().lower().startswith("memcpy")
                and "spin_kernel" not in e.name()))
            most |= sessions[-1]
        return most, sessions

    for _ in range(3):
        op.normal_matmat(X, **kw)
    twin.normal_matmat(X, **kw)
    torch.cuda.synchronize()
    assert op.graphs.graphs
    (replayed, rs), (eager, es) = (kernels(op.normal_matmat),
                                   kernels(twin.normal_matmat))
    # on a mismatch, each session's count of the names that differ
    differ = (replayed - eager) + (eager - replayed)
    assert replayed == eager, "; ".join(
        f"{k[:90]}: replayed sessions {[c[k] for c in rs]}, eager "
        f"sessions {[c[k] for c in es]}" for k in differ)
    assert any("densecols" in k or "s8_engine" in k for k in eager)
    assert any("ell_" in k for k in eager)
    # the two plans (forward and transpose tilings), one launch each
    assert sum(v for k, v in eager.items() if "plan_sum_kernel" in k) == 2


def test_cg_normal_replayed_equals_eager(card, monkeypatch):
    """cg_normal(reg=50, tol=0, maxiter=30) on the ECFP-like instance:
    the same iterations and a bit-equal x with the products replayed."""
    op, calls = _graph_case(card, monkeypatch, "hybrid")
    twin = _eager_twin(op)
    _, R, _ = calls[1]
    b = twin.rmatmat(R)
    want = ft.cg_normal(twin, b, reg=50.0, tol=0.0, maxiter=30)
    got = ft.cg_normal(op, b, reg=50.0, tol=0.0, maxiter=30)
    assert got.iters == want.iters == 30
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.resnorm, want.resnorm)
    assert len(op.graphs.graphs) == 1


def test_replay_span_counts(card, monkeypatch):
    """Under a recording, a replayed product's ``replay`` span counts the
    copy-in, the graph launch and the clone, and one ``replays``."""
    from fastsparse_torch import tracing

    op, calls = _graph_case(card, monkeypatch, "mono")
    name, X, kw = calls[1]
    for _ in range(2):
        op.normal_matmat(X, **kw)
    with tracing.recording() as rec:
        op.normal_matmat(X, **kw)
    prod, rep = rec.spans
    assert (prod.name, rep.name, rep.parent) == ("product", "replay", prod)
    assert rep.attrs == {"op": "normal_matmat", "N": X.shape[1]}
    assert rep.counts == {"ops": 3, "replays": 1}
    assert rec.counts == {"ops": 3, "replays": 1}


def test_capture_that_reads_the_device_stays_eager(card, monkeypatch):
    """A product that reads device data on the host cannot be captured:
    the capture raises, the key runs eagerly from then on, counted once,
    and the card, the current stream and the other keys work on."""
    from fastsparse_torch import tracing

    op, calls = _graph_case(card, monkeypatch, "mono")
    _, X, _ = calls[0]
    stream = torch.cuda.current_stream()

    def reads_back(X):
        return X * float(X.abs().max())

    want = reads_back(X)
    with tracing.recording() as rec:
        got = [op.graphs.run(op, "reads_back", X, reads_back)
               for _ in range(4)]
    assert all(torch.equal(y, want) for y in got)
    assert rec.counts["graph_refused"] == 1
    assert len(op.graphs.refused) == 1 and not op.graphs.graphs
    assert torch.cuda.current_stream() == stream
    assert not torch.cuda.is_current_stream_capturing()
    twin = _eager_twin(op)
    for _ in range(3):
        Y = op.matmat(X)
    assert torch.equal(Y, twin.matmat(X)) and len(op.graphs.graphs) == 1
