"""Port parity, the ELL gather engine: `fastsparse_torch` against the JAX
reference on the same numpy-seeded inputs (CPU tensors, so the kernels'
plain versions; the reference's Pallas kernels in interpret mode).

* layouts (bucket ``row_ids``, ``cols``, ``vals``, ``packed``, ``n_real``)
  and assembly plans (``classes``, ``rowpos``, ``widths``, ``n_slots``)
  are equal, split and unsplit, binary and valued, segmented, and with the
  chunking budgets shrunk in both packages;
* the plain kernels against the Pallas kernels: unit bodies and the sweep
  bit-exact; valued bodies at max|d|/max|ref| <= 1e-6, because XLA:CPU
  contracts the interpret-mode multiply-add (the port rounds the product
  first, as the CUDA kernel does);
* `ell_spmm`, `spmv` and the operator's products within 1e-6 of the
  reference and of scipy in float64;
* with ``USE_SMEM_PATH`` on in both packages (budgets shrunk so small
  buckets take it): layouts with whole-bucket "smem" items among chunks
  and sweeps, and their plans, equal the reference's; the plain
  `ell_bucket_spmm_smem` against the Pallas kernel (unit bit-exact,
  valued within 1e-6, as the bodies above); products within 1e-6;
* ``format="auto"`` makes the reference's choice (bsr, ell, hybrid; a
  hybrid with dense tiles builds as the reference's does).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fastsparse as fs
import fastsparse.ops.assemble as jasm
import fastsparse.ops.ell_ops as jeo
from fastsparse.bench import model as jmodel
from fastsparse.formats import convert as jconv
from fastsparse.formats import ell as jell
from fastsparse.ops.pallas import ell_spmm as jk
import fastsparse_torch as ft
from fastsparse_torch import interop
from fastsparse_torch.bench import model as tmodel
from fastsparse_torch.formats import convert as tconv
from fastsparse_torch.formats import ell as tell
from fastsparse_torch.ops import assemble as tasm
from fastsparse_torch.ops import ell_ops as teo
from fastsparse_torch.ops.kernels import ell_spmm as tk

torch.set_num_threads(1)
TOL = 1e-6


def _rel(y, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(y, np.float64) - ref).max() / (
        np.abs(ref).max() + 1e-30
    )


def _small(binary):
    m = sp.random(1200, 900, density=0.005, random_state=2, format="csr",
                  dtype=np.float32)
    if binary:
        m.data[:] = 1.0
    return m


def _heavy(binary):
    """Heavy-tailed rows: eight rows of 200 entries among short ones."""
    rng = np.random.default_rng(50)
    rows = np.concatenate([np.repeat(np.arange(8), 200),
                           rng.integers(0, 300, 4000)])
    cols = rng.integers(0, 280, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    m = sp.coo_matrix((vals, (rows, cols)), shape=(300, 280))
    m.sum_duplicates()
    if binary:
        m.data[:] = 1.0
    return m.tocsr()


def _coos(m, binary):
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


@pytest.fixture
def tiny_budgets(monkeypatch):
    """Chunk every bucket (and split the sweeps) in both packages."""
    for mod in (jeo, teo):
        monkeypatch.setattr(mod, "_SMEM_IDX_BUDGET_UNIT", 64)
        monkeypatch.setattr(mod, "_SMEM_IDX_BUDGET_VALUED", 64)
        monkeypatch.setattr(mod, "SMEM_BLOCK_K_UNIT", 0)
        monkeypatch.setattr(mod, "SMEM_BLOCK_K_VALUED", 0)


# (matrix, binary, split_rows, seg_cols)
LAYOUTS = {
    "random_valued": (_small, False, 64, 0),
    "random_binary": (_small, True, 64, 0),
    "heavy_valued_split": (_heavy, False, 64, 0),
    "heavy_binary_split": (_heavy, True, 64, 0),
    "heavy_binary_unsplit": (_heavy, True, 0, 0),
    "heavy_valued_unsplit_seg": (_heavy, False, 0, 128),
    "heavy_binary_split_seg": (_heavy, True, 64, 128),
}


def _build_pair(case):
    make, binary, split, seg = LAYOUTS[case]
    m = make(binary)
    cj, ct = _coos(m, binary)
    if seg:
        Aj = jell.build_ell_segmented(cj, seg_cols=seg, split_rows=split)
        At = tell.build_ell_segmented(ct, seg_cols=seg, split_rows=split,
                                      device="cpu")
    else:
        Aj = jell.build_ell(cj, split_rows=split)
        At = tell.build_ell(ct, split_rows=split, device="cpu")
    return m, Aj, At


@pytest.mark.parametrize("budgets", ["default", "tiny"])
@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layout_and_plan_match_reference(case, budgets, request):
    if budgets == "tiny":
        request.getfixturevalue("tiny_budgets")
    m, Aj, At = _build_pair(case)
    d_ref = _arrays(jasm.attach_plan(Aj))
    d_port = _arrays(tasm.attach_plan(At))
    _assert_same(d_ref, d_port)
    segs = At.segments if hasattr(At, "segments") else (At,)
    if LAYOUTS[case][2] and case.startswith("heavy"):
        assert max(s.split_rows for s in segs) == 64
        assert max(b.width for s in segs for b in s.buckets) <= 64
    items = [mo for s in segs for _, mo, *_ in teo._seg_layout(s)]
    modes = set(items)
    if budgets == "tiny":  # buckets really were cut into chunks
        assert len(items) > sum(len(s.buckets) for s in segs)
    if LAYOUTS[case][1] and budgets == "default":
        assert "sweep" in modes, modes
    # the port's own structure and products, at the shrunken budgets too
    assert np.array_equal(At.todense().numpy(), m.toarray())
    X = np.random.default_rng(3).standard_normal(
        (m.shape[1], 5)).astype(np.float32)
    Y = teo.ell_spmm(tasm.attach_plan(At), torch.from_numpy(X)).numpy()
    assert _rel(Y, m @ X.astype(np.float64)) <= TOL


def test_plan_guard_falls_back_to_scatter(monkeypatch):
    m, _, At = _build_pair("heavy_binary_split")
    Ap = tasm.attach_plan(At)
    assert Ap.plan.layout_key == tasm.layout_key()
    X = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (m.shape[1], 8)).astype(np.float32))
    Y0 = teo.ell_spmm(Ap, X)
    monkeypatch.setattr(teo, "_SMEM_IDX_BUDGET_UNIT", 64)
    assert Ap.plan.layout_key != tasm.layout_key()
    Y1 = teo.ell_spmm(Ap, X)  # stale plan: row scatter instead
    assert _rel(Y1.numpy(), Y0.numpy()) <= TOL
    assert _rel(Y1.numpy(), m @ X.numpy().astype(np.float64)) <= TOL


# (K, unit, packed): every body of the bucket kernel, each with a row or
# chunk length that is not a multiple of 4. Past K = 64 the chunks are 13
# (valued 130), 15 (unit 135) and 38 (packed 76: 19 pairs) entries.
KERNEL_MODES = {
    "valued_full": (22, False, False),
    "unit_full": (7, True, False),
    "packed_full": (22, True, True),
    "valued_chunked": (130, False, False),
    "unit_chunked": (135, True, False),
    "packed_chunked": (76, True, True),
}


@pytest.mark.parametrize("lanes", [1, 3, 8, 128])
@pytest.mark.parametrize("mode", sorted(KERNEL_MODES))
def test_bucket_kernel_plain_vs_pallas(mode, lanes):
    """The port's plain version on X of ``lanes`` lanes (the narrow body's
    widths on the card at N <= 8) against the Pallas kernel on the same X
    zero-padded to its 128-lane block, first ``lanes`` columns."""
    K, unit, packed = KERNEL_MODES[mode]
    g = np.random.default_rng(K)
    nb, ncol = 8, 700
    cols = g.integers(0, ncol, (nb, K)).astype(np.int32)
    cols[-2:, K // 2:] = ncol  # sentinel slots
    vals = g.standard_normal((nb, K)).astype(np.float32)
    x = np.zeros((ncol + 4, 128), np.float32)
    x[:ncol, :lanes] = g.standard_normal((ncol, 128))[:, :lanes]
    ct = torch.from_numpy(cols)
    pk = tk._pack_pairs(ct).reshape(nb, K // 2) if packed else None
    assert tk._body_mode(K, x.shape[0], unit)[2] == packed
    ref = np.asarray(jk.ell_bucket_spmm(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x), n_block=128,
        unit=unit, packed=None if pk is None else jnp.asarray(pk.numpy()),
    ))[:, :lanes]
    got = tk.ell_bucket_spmm(ct, torch.from_numpy(vals),
                             torch.from_numpy(x[:, :lanes].copy()),
                             unit=unit, packed=pk).numpy()
    assert got.shape == ref.shape
    if unit:
        assert np.array_equal(got, ref)
    else:
        assert _rel(got, ref) <= TOL
    if packed:  # the port's build-time pairs are the reference's
        assert np.array_equal(
            pk.numpy().reshape(-1),
            np.asarray(jk._pack_pairs(jnp.asarray(cols))))


def test_sweep_kernel_plain_vs_pallas():
    parts = ((16, 2), (8, 5), (24, 9), (8, 1))
    g = np.random.default_rng(7)
    ncol = 900
    words = [tk._pack_pairs(torch.from_numpy(
        g.integers(0, ncol + 1, (n, 2 * k2)).astype(np.int32)))
        for n, k2 in parts]
    flat = torch.cat(words)
    x = np.zeros((ncol + 4, 128), np.float32)
    x[:ncol] = g.standard_normal((ncol, 128))
    ref = np.asarray(jk.ell_sweep_spmm(
        jnp.asarray(flat.numpy()), jnp.asarray(x), n_block=128, parts=parts))
    got = tk.ell_sweep_spmm(flat, torch.from_numpy(x), parts=parts).numpy()
    assert np.array_equal(got, ref)
    tk.reset_launches()
    tk.ell_sweep_spmm(flat, torch.from_numpy(x), parts=parts)
    assert not any(tk.launches.values())  # plain: no count


@pytest.fixture(scope="module", params=["valued", "binary"])
def ell_ops(request):
    """(scipy matrix, JAX operator, port operator, port operator on the
    reference's own layout) for format="ell" with both tilings."""
    m = _small(request.param == "binary")
    op_j = fs.operator(m, format="ell", transpose=True)
    op_t = ft.operator(m, format="ell", transpose=True, device="cpu")
    op_i = interop.operator_from_reference_arrays(
        interop.reference_arrays(op_j), device="cpu")
    _assert_same(interop.reference_arrays(op_j),
                 interop.reference_arrays(op_t))
    return m, op_j, op_t, op_i


def test_ell_products_vs_reference(ell_ops):
    """matmat through both packages' gather kernels (the reference's in
    interpret mode, one compile per bucket shape: one N, one tiling)."""
    m, op_j, op_t, _ = ell_ops
    X = np.random.default_rng(16).standard_normal(
        (m.shape[1], 16)).astype(np.float32)
    yt = op_t.matmat(torch.from_numpy(X)).numpy()
    assert _rel(yt, np.asarray(op_j.matmat(jnp.asarray(X)))) <= TOL


@pytest.mark.parametrize("N", [1, 6, 130])
def test_ell_products_vs_scipy(ell_ops, N):
    """Every lane padding (N < 4 kept, else rounded up to 4), on the port's
    own layout and on the reference's, against scipy in float64."""
    m, _, op_t, op_i = ell_ops
    X = np.random.default_rng(N).standard_normal(
        (m.shape[1], N)).astype(np.float32)
    yt = op_t.matmat(torch.from_numpy(X)).numpy()
    assert yt.shape == (m.shape[0], N) and yt.dtype == np.float32
    assert np.array_equal(op_i.matmat(torch.from_numpy(X)).numpy(), yt)
    assert _rel(yt, m @ X.astype(np.float64)) <= TOL
    Z = np.random.default_rng(N + 1).standard_normal(
        (m.shape[0], N)).astype(np.float32)
    zt = op_t.rmatmat(torch.from_numpy(Z)).numpy()
    assert _rel(zt, m.T @ Z.astype(np.float64)) <= TOL


def test_ell_spmv_and_normal_vs_reference(ell_ops):
    m, op_j, op_t, _ = ell_ops
    rng = np.random.default_rng(9)
    x = rng.standard_normal(m.shape[1]).astype(np.float32)
    y = rng.standard_normal(m.shape[0]).astype(np.float32)
    md = m.astype(np.float64)
    got = ft.spmv(op_t.fwd, torch.from_numpy(x)).numpy()
    assert _rel(got, np.asarray(fs.spmv(op_j.fwd, jnp.asarray(x)))) <= TOL
    assert _rel(op_t.matvec(torch.from_numpy(x)).numpy(), got) == 0
    got = op_t.rmatvec(torch.from_numpy(y)).numpy()
    assert _rel(got, md.T @ y) <= TOL
    got = op_t.normal_matvec(torch.from_numpy(x), reg=0.5).numpy()
    assert _rel(got, md.T @ (md @ x) + 0.5 * x) <= TOL


def test_segmented_operator_vs_reference():
    """format="ell" past SEG_COLS: balanced column segments, a sweep per
    segment, the cross-segment plan; products against the reference."""
    m = sp.random(200, 30_000, density=2e-4, random_state=11, format="csr",
                  dtype=np.float32)
    m.data[:] = 1.0
    op_j = fs.operator(m, format="ell", transpose=False)
    op_t = ft.operator(m, format="ell", transpose=False, device="cpu")
    _assert_same(interop.reference_arrays(op_j),
                 interop.reference_arrays(op_t))
    assert type(op_t.fwd).__name__ == "SegmentedEll"
    assert len(op_t.fwd.segments) == 2 and op_t.fwd.seg_cols == 15104
    X = np.random.default_rng(12).standard_normal(
        (m.shape[1], 8)).astype(np.float32)
    yt = op_t.matmat(torch.from_numpy(X)).numpy()
    assert _rel(yt, np.asarray(op_j.matmat(jnp.asarray(X)))) <= TOL
    assert _rel(yt, m @ X.astype(np.float64)) <= TOL
    # no dual tiling: the scatter engine (spmv_t), as in the reference
    y = np.random.default_rng(13).standard_normal(200).astype(np.float32)
    zt = op_t.rmatvec(torch.from_numpy(y)).numpy()
    assert _rel(zt, np.asarray(op_j.rmatvec(jnp.asarray(y)))) <= TOL
    assert _rel(zt, m.T @ y.astype(np.float64)) <= TOL


def _blocky(seed):
    """Binary: a dense 64 x 512 corner over scattered entries."""
    g = np.random.default_rng(seed)
    r = np.r_[g.integers(0, 64, 16000), g.integers(0, 3000, 30000)]
    c = np.r_[g.integers(0, 512, 16000), g.integers(0, 3000, 30000)]
    m = sp.coo_matrix((np.ones(r.size, np.float32), (r, c)),
                      shape=(3000, 3000))
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()


def _banded(seed, n, bw, density=0.3):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, int(n * bw * density))
    c = np.clip(r + rng.integers(0, bw, r.size), 0, n - 1)
    m = sp.coo_matrix((np.ones(r.size, np.float32), (r, c)), shape=(n, n))
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()


@pytest.mark.parametrize("case", ["banded", "powerlaw_valued",
                                  "blocky_binary"])
def test_auto_format_matches_reference(case):
    m = {
        "banded": lambda: _banded(0, 2000, 300),
        "powerlaw_valued": lambda: ft.bench.matrices.powerlaw(
            1500, 1500, 20_000, seed=1),
        "blocky_binary": lambda: _blocky(0),
    }[case]()
    op_j = fs.operator(m, transpose=False)
    want = {"banded": "BsrMatrix", "powerlaw_valued": "EllMatrix",
            "blocky_binary": "HybridMatrix"}[case]
    assert type(op_j.fwd).__name__ == want
    op_t = ft.operator(m, transpose=False, device="cpu")
    assert type(op_t.fwd).__name__ == want
    if want == "HybridMatrix":  # the blocks compile into dense tiles
        assert op_t.fwd.dense is not None and op_j.fwd.dense is not None
    X = np.random.default_rng(5).standard_normal(
        (m.shape[1], 4)).astype(np.float32)
    yt = op_t.matmat(torch.from_numpy(X)).numpy()
    assert _rel(yt, m @ X.astype(np.float64)) <= TOL


def test_unported_ell_options_raise(monkeypatch):
    m = _small(False)
    with pytest.raises(NotImplementedError, match="slice 3"):
        ft.operator(m, device="cpu", tune=True)
    # ported since: the scatter formats, the reference's arrays and products
    x = np.random.default_rng(1).standard_normal(m.shape[1]).astype(
        np.float32)
    for fmt in ("coo", "csr"):
        op_j = fs.operator(m, format=fmt, transpose=False)
        op = ft.operator(m, format=fmt, transpose=False, device="cpu")
        _assert_same(interop.reference_arrays(op_j),
                     interop.reference_arrays(op))
        assert type(op.fwd).__name__ == fmt.upper()
        y = op.matvec(torch.from_numpy(x)).numpy()
        assert _rel(y, np.asarray(op_j.matvec(jnp.asarray(x)))) <= TOL
        assert _rel(y, m @ x.astype(np.float64)) <= TOL
    # ported since: forced column segments and reordering
    op = ft.operator(m, format="ell-seg", reorder="degree", device="cpu")
    assert type(op.fwd).__name__ == "SegmentedEll"
    assert op.row_perm is not None and op.col_perm is not None
    X = np.random.default_rng(2).standard_normal((m.shape[1], 3)).astype(
        np.float32)
    assert _rel(op.matmat(torch.from_numpy(X)).numpy(),
                m @ X.astype(np.float64)) <= TOL
    # ported since: f64 values (auto -> an unsplit ELL, torch ops)
    op64 = ft.operator(m.astype(np.float64), device="cpu")
    assert type(op64.fwd).__name__ == "EllMatrix"
    assert op64.fwd.split_rows == 0 and op64.fwd.dtype == torch.float64
    X64 = X.astype(np.float64)
    y64 = op64.matmat(torch.from_numpy(X64))
    assert y64.dtype == torch.float64
    assert _rel(y64.numpy(), m.astype(np.float64) @ X64) <= 1e-10
    op = ft.operator(m, device="cpu")
    monkeypatch.setattr(teo, "USE_SMEM_PATH", True)
    monkeypatch.setattr(teo, "_SMEM_IDX_BUDGET_VALUED", 64)
    # ported since: the SMEM-blocked kernel (the stale plan: a row scatter)
    assert "smem" in {mo for _, mo, *_ in teo._seg_layout(op.fwd)}
    Y = teo.ell_spmm(op.fwd, torch.ones((m.shape[1], 2))).numpy()
    assert _rel(Y, m @ np.ones((m.shape[1], 2))) <= TOL


def test_csr_and_model_match_reference():
    m = _small(False)
    m2 = m.copy()
    m2.data[:] = 1.0
    for mat, binary in ((m, False), (m2, True)):
        cj, ct = _coos(mat, binary)
        for fj, ft_ in ((jconv.to_csr, tconv.to_csr),
                        (jconv.to_csr_host, tconv.to_csr_host)):
            a, b = fj(cj), ft_(ct)
            for k in ("row_ptr", "rows", "cols") + (() if binary else
                                                     ("vals",)):
                assert np.array_equal(np.asarray(getattr(a, k)),
                                      getattr(b, k).numpy()), k
        ref = (fs.BinaryCSR if binary else fs.CSR).from_scipy(mat)
        got = (ft.BinaryCSR if binary else ft.CSR).from_scipy(mat,
                                                              device="cpu")
        assert np.array_equal(np.asarray(ref.row_ptr), got.row_ptr.numpy())
        assert np.array_equal(got.to_coo().todense().numpy(), mat.toarray())
    rng = np.random.default_rng(3)
    for cnt in (rng.integers(1, 80, 500), rng.integers(1, 3, 500),
                np.zeros(0, np.int64)):
        assert (tmodel.auto_threshold_from_counts(cnt)
                == jmodel.auto_threshold_from_counts(cnt))
    coldeg = rng.integers(0, 50, 4000)
    for nrow in (1000, 20_000, 200_000):
        assert np.array_equal(tmodel.dense_col_select(coldeg, nrow),
                              jmodel.dense_col_select(coldeg, nrow))


# ---------------------------------------------- the SMEM-blocked kernel (#11)
def _mixed(binary):
    """Rows of 6, 12, 32, 40 and 64 entries (unsplit widths 6/12/32/40/64),
    so the shrunken budgets give whole-bucket items beside chunks and
    sweeps."""
    g = np.random.default_rng(21)
    counts = np.repeat([6, 12, 32, 40, 64], [8, 32, 30, 24, 16])
    g.shuffle(counts)
    ncol = 500
    rows = np.repeat(np.arange(counts.size), counts)
    cols = np.concatenate([g.choice(ncol, k, replace=False) for k in counts])
    vals = g.standard_normal(rows.size).astype(np.float32)
    if binary:
        vals[:] = 1.0
    return sp.csr_matrix((vals, (rows, cols)), shape=(counts.size, ncol))


@pytest.fixture
def smem_on(monkeypatch):
    """The flag on in both packages; a bucket past 256 index entries (512
    over packed pairs) and at most 48 wide runs whole."""
    for mod in (jeo, teo):
        monkeypatch.setattr(mod, "USE_SMEM_PATH", True)
        monkeypatch.setattr(mod, "_SMEM_IDX_BUDGET_UNIT", 256)
        monkeypatch.setattr(mod, "_SMEM_IDX_BUDGET_VALUED", 256)
        monkeypatch.setattr(mod, "SMEM_BLOCK_K_UNIT", 48)
        monkeypatch.setattr(mod, "SMEM_BLOCK_K_VALUED", 48)


def _items(seg, eo):
    out = []
    for b, mode, s0, s1, n_pad in eo._seg_layout(seg):
        subs = b if mode == "sweep" else ((b, s0, s1, n_pad),)
        out.append((mode, tuple((tuple(bb.cols.shape), t0, t1, np_)
                                for bb, t0, t1, np_ in subs)))
    return out


@pytest.mark.parametrize("binary", [False, True])
def test_smem_layout_plan_and_products_match_reference(smem_on, binary):
    m = _mixed(binary)
    cj, ct = _coos(m, binary)
    Aj = jasm.attach_plan(jell.build_ell(cj))
    At = tasm.attach_plan(tell.build_ell(ct, device="cpu"))
    _assert_same(_arrays(Aj), _arrays(At))  # the plan is keyed by the flag
    items = _items(At, teo)
    assert items == _items(Aj, jeo)
    modes = [mo for mo, _ in items]
    assert modes.count("smem") >= 2 and "chunk" in modes
    assert ("sweep" in modes) == binary
    X = np.random.default_rng(22).standard_normal(
        (m.shape[1], 8)).astype(np.float32)
    yt = teo.ell_spmm(At, torch.from_numpy(X)).numpy()
    assert _rel(yt, np.asarray(jeo.ell_spmm(Aj, jnp.asarray(X)))) <= TOL
    assert _rel(yt, m @ X.astype(np.float64)) <= TOL
    # through the operator (its plan built under the flag)
    op = ft.operator(m, format="ell", transpose=False, device="cpu")
    assert op.fwd.plan.layout_key == tasm.layout_key()
    assert "smem" in {mo for _, mo, *_ in teo._seg_layout(op.fwd)}
    op_j = fs.operator(m, format="ell", transpose=False)
    Y = op.matmat(torch.from_numpy(X)).numpy()
    assert _rel(Y, np.asarray(op_j.matmat(jnp.asarray(X)))) <= TOL
    assert _rel(Y, m @ X.astype(np.float64)) <= TOL
    y = op.matvec(torch.from_numpy(X[:, 0])).numpy()
    assert _rel(y, m @ X[:, 0].astype(np.float64)) <= TOL


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("K", [12, 32, 40, 64])
def test_smem_kernel_plain_vs_pallas(K, unit):
    """The plain version of #11 against the Pallas kernel in interpret
    mode: chunks of _pick_kb(K) entries (12, 16, 10 and 16)."""
    g = np.random.default_rng(100 + K)
    nb, ncol = 16, 700
    cols = g.integers(0, ncol, (nb, K)).astype(np.int32)
    cols[-3:, K // 3:] = ncol  # sentinel slots
    vals = g.standard_normal((nb, K)).astype(np.float32)
    x = np.zeros((ncol + 4, 128), np.float32)
    x[:ncol] = g.standard_normal((ncol, 128))
    ref = np.asarray(jk.ell_bucket_spmm_smem(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x), n_block=128,
        unit=unit))
    tk.reset_launches()
    got = tk.ell_bucket_spmm_smem(torch.from_numpy(cols),
                                  torch.from_numpy(vals), torch.from_numpy(x),
                                  unit=unit).numpy()
    assert tk.launches["ell_bucket_smem"] == 0  # plain: no count
    assert got.shape == ref.shape
    if unit:
        assert np.array_equal(got, ref)
    else:  # XLA:CPU contracts the interpret-mode multiply-add (see top)
        assert _rel(got, ref) <= TOL
