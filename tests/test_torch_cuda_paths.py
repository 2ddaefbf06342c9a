"""The port's main paths on the card at BASELINE sizes (marker ``cuda``;
each test skips without a CUDA device). The full-size operators are built
once per module, never at import: the banded 50,000² headline and the
12,288² entry matrix (mono), BASELINE config 2 ("config A") and the
65,536² 0/1 power-law ("config B") through the ELL gather, also under
``USE_SMEM_PATH``, the ECFP Macau matrix through ``operator(m)``,
``reorder="auto"`` and ``reorder="degree"``, the R-MAT graph at scale 18,
BASELINE config 2 at the benchmark's 250,000² (``powerlaw250k``), and
BASELINE config 1 and config 2 in fp64. On them: each kernel against
its plain version on the layouts the paths build, the tile layouts
against the reference's, each path's products through the public API
against scipy in float64 with the kernels it must launch, and the plan
kernel on every plan the paths apply. It imports no JAX:

    python -m pytest tests/test_torch_cuda.py tests/test_torch_cuda_paths.py -q --noconftest
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fastsparse_torch as ft
from fastsparse_torch.bench.matrices import banded, ecfp_like, powerlaw, rmat
from fastsparse_torch.ops import assemble, bsr_ops, ell_ops
from fastsparse_torch.ops.kernels import assemble as ak
from fastsparse_torch.ops.kernels import bsr_spmm as tk
from fastsparse_torch.ops.kernels import bsr_tiles as tt
from fastsparse_torch.ops.kernels import ell_dd as dk
from fastsparse_torch.ops.kernels import ell_spmm as ek

from card_helpers import kernel_names, neg_zero_parts, same_bits, tiling_plans
import rmat_layout

pytestmark = pytest.mark.cuda

REL = 1e-6  # BASELINE's fp32 bar
REL_B = 1e-5  # config B's products: 0/1 hub rows of thousands of terms
DD = 1e-10  # BASELINE's fp64 bar


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _eager(op):
    """``op`` with a graph cache of its own: each of its products runs
    eagerly at its first call, through the wrappers that count launches
    (a replayed CUDA graph runs the same kernels without them)."""
    return dataclasses.replace(op)


def _cuda(a):
    return torch.from_numpy(a).cuda()


def _rel(y, ref):
    """max|y - ref| / max|ref| in float64 (``ref``: a numpy array)."""
    y = y.double().cpu().numpy()
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def _held(name, out, ref, tol, dtype=torch.float32, strict=True):
    """An output of the right shape, dtype and device, finite, within
    ``tol`` of the float64 reference (``< tol``, or ``<=`` unless
    ``strict``)."""
    assert (tuple(out.shape) == ref.shape and out.dtype == dtype
            and out.is_cuda), (name, tuple(out.shape), out.dtype)
    assert bool(torch.isfinite(out).all()), name
    rel = _rel(out, ref)
    assert rel < tol if strict else rel <= tol, (name, rel)


def _same(name, kern, plain):
    """A kernel's output equal to its plain version's, bit for bit."""
    assert kern.shape == plain.shape and kern.dtype == plain.dtype, (
        name, tuple(kern.shape), kern.dtype, tuple(plain.shape), plain.dtype)
    assert torch.equal(kern, plain), name


def _body(name, fn, want, other=()):
    """``fn`` runs the kernel body named ``want`` and none of ``other``
    (by kernel name: `card_helpers.kernel_names`)."""
    names = kernel_names(fn)
    others = (other,) if isinstance(other, str) else other
    assert want in names and not any(o in names for o in others), (
        name, want, names[:300])


def _close(name, kern, plain):
    """A tile kernel's output within 1e-6 of its plain version's."""
    assert kern.shape == plain.shape and kern.dtype == plain.dtype, name
    d = (kern.double() - plain.double()).abs().max().item()
    assert d <= REL * (plain.double().abs().max().item() + 1e-30), (name, d)


# ------------------------------------------------------------- operators
@pytest.fixture(scope="module")
def headline():
    _card()
    mb = banded(50_000, 512, seed=4, density=0.39)
    mb.data[:] = 1.0
    m2 = banded(12_288, 512, seed=4, density=0.35)
    m2.data[:] = 1.0
    return SimpleNamespace(
        mb=mb, op=ft.operator(mb, format="bsr", transpose=True),
        m2=m2, op2=ft.operator(m2, format="bsr", transpose=True))


@pytest.fixture(scope="module")
def config_a():
    _card()
    m = powerlaw(20_000, 20_000, 1_000_000, seed=0, dtype=np.float32)
    return SimpleNamespace(m=m, op=ft.operator(m))


@pytest.fixture(scope="module")
def config_b():
    _card()
    m = powerlaw(65_536, 65_536, 4_000_000, seed=0, binary=True)
    return SimpleNamespace(m=m, op=ft.operator(m, format="ell",
                                               transpose=False))


@pytest.fixture(scope="module")
def ecfp():
    _card()
    m = ecfp_like(50_000, 20_000, 64, 400, seed=2)
    return SimpleNamespace(m=m, op=ft.operator(m))


@pytest.fixture(scope="module")
def tiles(ecfp, config_b):
    """BASELINE config 3 as called (``reorder="auto", transpose=False``),
    with both tilings, and config B as ``bench.py:315`` calls it."""
    return SimpleNamespace(
        opF=ft.operator(ecfp.m, reorder="auto", transpose=False),
        opT=ft.operator(ecfp.m, reorder="auto"),
        opB=ft.operator(config_b.m, reorder="degree", transpose=False))


@pytest.fixture(scope="module")
def rmat18():
    _card()
    m = rmat(18, 16, seed=3)
    return SimpleNamespace(m=m, op=ft.operator(m, reorder="auto",
                                               transpose=False))


@pytest.fixture(scope="module")
def powerlaw250k():
    """The benchmark's ``powerlaw250k`` at its source seed, as its cell
    builds it (``operator(m)``, no dual tiling)."""
    _card()
    m = powerlaw(250_000, 250_000, 12_500_000, seed=0, alpha=1.6)
    return SimpleNamespace(m=m, op=ft.operator(m, transpose=False))


@pytest.fixture(scope="module")
def fp64(config_b):
    _card()
    m1 = powerlaw(100_000, 100_000, 5_000_000, seed=0, alpha=1.0,
                  dtype=np.float64)
    m2d = powerlaw(20_000, 20_000, 1_000_000, seed=0, dtype=np.float64)
    return SimpleNamespace(
        m1=m1, op1=ft.operator(m1, format="ell", transpose=True),
        A1=ft.build_ell_dd(m1), m2d=m2d, A2d=ft.build_ell_dd(m2d),
        opBu=ft.operator(config_b.m, format="ell", transpose=False,
                         config=ft.Config(ell_split_rows=0)))


# ------------------------------------------------------------- mono path
def test_headline_layout(headline):
    from fastsparse_torch.linops import _auto_format

    op, op2 = headline.op, headline.op2
    assert op.fwd.is_mono and op.bwd.is_mono
    assert op.fwd.narrow is not None  # the halo layout
    assert _auto_format(ft.binary_coo_from_scipy(headline.mb, device="cuda"),
                        ft.DEFAULT, None) == "bsr"
    assert op2.fwd.is_mono and op2.bwd.is_mono


def test_mono_kernels_on_headline_layout(headline):
    """colmax, quant3 (K-major planes), mono_panel (i8w N=128, narrow
    N=32) and mono_group (the halo layout, N=1) on the headline's layout
    and X, each bit-exact against its plain version."""
    A = headline.op.fwd
    b, TK = A.buckets[0], A.tile_k
    K_pad = b.n_windows * b.win_slabs * TK
    X = _cuda(np.random.default_rng(0).standard_normal(
        (headline.mb.shape[1], 128)).astype(np.float32))
    Xp = torch.zeros((K_pad, 128), dtype=torch.float32, device="cuda")
    Xp[: X.shape[0]] = X
    mx = tk.colmax(Xp)
    _same("colmax", mx, tk.colmax_plain(Xp))
    s = torch.where(mx > 0, mx, 1.0) * (1.0 / (127.0 * 65536.0))
    sinv = 1.0 / s
    planes = tk.quant3_planes(Xp, sinv, n_block=128)
    _same("quant3_planes", planes,
          tk.quant3_planes_plain(Xp, sinv, n_block=128))
    panel_kw = dict(tile_m=A.tile_m, tile_k=TK, width=b.width,
                    win_slabs=b.win_slabs,
                    out_rows=max(b.out_strips, A.n_strips) * A.tile_m)
    args = (b.window, b.strip_ptr, b.start_rel, b.panels)
    kw = dict(panel_kw, n_block=128, fold="i8w", scale=s)
    _same("mono_panel[i8w,N=128]", tk.mono_panel_spmm(*args, planes, **kw),
          tk.mono_panel_spmm_plain(*args, planes, **kw))
    nb = bsr_ops._round_up(3 * 32, 32)
    qn, _ = bsr_ops._quant3_narrow(X[:, :32], K_pad, 32, nb)
    kw = dict(panel_kw, n_block=nb, fold=False)
    _same("mono_panel[narrow,N=32]", tk.mono_panel_spmm(*args, qn, **kw),
          tk.mono_panel_spmm_plain(*args, qn, **kw))
    h = A.narrow
    K_halo = ((h.n_windows - 1) * h.stride + h.win_slabs) * TK
    qh, _ = bsr_ops._quant3_narrow(X[:, :1], K_halo, 8, 32)
    assert tuple(qh.shape) == (32, K_halo)  # K-major
    gargs = (h.windows, h.start_rel, h.panels, qh)
    gkw = dict(tile_m=A.tile_m, tile_k=TK, width=h.width, stride=h.stride,
               group=h.group)
    _same("mono_group[halo,N=1]", tk.mono_group_spmm(*gargs, **gkw),
          tk.mono_group_spmm_plain(*gargs, **gkw))


def _encode_same(name, got, x, rows, k_rows, n_pad, n_out):
    """An entry point's planes and scale equal `quant3_encode_plain`'s
    (today's torch ops) on the same card tensors, bit for bit."""
    planes, s = got
    want, s_want = tk.quant3_encode_plain(x, rows, k_rows=k_rows,
                                          n_pad=n_pad, n_out=n_out)
    _same(name, planes, want)
    assert same_bits(s, s_want), name


@pytest.mark.parametrize("N", [1, 8, 16, 32, 40])
def test_narrow_encode_on_headline(headline, N):
    """`_quant3_narrow` on the card at the headline chain's K: the forward
    tiling's on X, the transpose's on the forward product's folded output
    (the chain's second operand, a view ``(rows, nq)[:, :N]``), and at N=1
    the halo layout's K; each bit-equal to its torch ops."""
    A, At = headline.op.fwd, headline.op.bwd
    X = _cuda(np.random.default_rng(N).standard_normal(
        (headline.mb.shape[1], N)).astype(np.float32))
    nq = bsr_ops._narrow_nq(N)
    nb = bsr_ops._round_up(3 * nq, 32)

    def k_pad(T):
        b = T.buckets[0]
        return b.n_windows * b.win_slabs * T.tile_k

    K1, K2 = k_pad(A), k_pad(At)
    _encode_same(f"fwd N={N}", bsr_ops._quant3_narrow(X, K1, nq, nb), X,
                 None, K1, nq, nb)
    Y1, nq1, _, s1 = bsr_ops._mono_raw(A, X, "highest")
    tmp = bsr_ops._fold_narrow_q(Y1, nq1, s1)[:, :N]
    assert N == nq or not tmp.is_contiguous()
    _encode_same(f"bwd N={N}", bsr_ops._quant3_narrow(tmp, K2, nq, nb), tmp,
                 None, K2, nq, nb)
    if N == 1:
        h = A.narrow
        K_h = ((h.n_windows - 1) * h.stride + h.win_slabs) * A.tile_k
        _encode_same("halo N=1", bsr_ops._quant3_narrow(X, K_h, 8, 32), X,
                     None, K_h, 8, 32)


def test_narrow_chain_runs_the_encode_kernels(headline):
    """A captured narrow `mono_chain` (N=32, the CG solve's product) holds
    the two encode kernels for each of its products and none of the old
    prep's torch ops: no concatenation and no column reduction."""
    X = _cuda(np.random.default_rng(5).standard_normal(
        (headline.mb.shape[1], 32)).astype(np.float32))
    names = kernel_names(lambda: bsr_ops.mono_chain(
        headline.op.fwd, headline.op.bwd, X)).split()
    assert sum("encode_colmax_kernel" in n for n in names) == 2, names
    assert sum("encode_planes_kernel" in n for n in names) == 2, names
    assert not any("CatArrayBatchedCopy" in n or "reduce_kernel" in n
                   for n in names), names


def test_mono_paths_vs_scipy(headline):
    """matmat N=128 and matvec on the headline, normal_matmat(X, reg=0.1)
    on the entry matrix at N=128 and cg_normal(reg=50, maxiter=20) at
    N=32, through the public API; every mono kernel launches."""
    mb, m2 = headline.mb, headline.m2
    Xn = np.random.default_rng(0).standard_normal(
        (mb.shape[1], 128)).astype(np.float32)
    X2n = np.random.default_rng(1).standard_normal(
        (m2.shape[1], 128)).astype(np.float32)
    Bn = np.random.default_rng(2).standard_normal(
        (mb.shape[1], 32)).astype(np.float32)
    X, X2, B = _cuda(Xn), _cuda(X2n), _cuda(Bn)
    tk.reset_launches()
    op = _eager(headline.op)
    Y = op.matmat(X)
    y = op.matvec(X[:, 0].contiguous())
    Y2 = _eager(headline.op2).normal_matmat(X2, reg=0.1)
    sol = ft.cg_normal(op, B, reg=50.0, maxiter=20)
    torch.cuda.synchronize()
    mb64, m264, X264 = (mb.astype(np.float64), m2.astype(np.float64),
                        X2n.astype(np.float64))
    _held("matmat", Y, mb64 @ Xn.astype(np.float64), REL)
    _held("matvec", y, mb64 @ Xn[:, 0].astype(np.float64), REL)
    _held("normal_matmat", Y2, m264.T @ (m264 @ X264) + 0.1 * X264, REL)
    assert (tuple(sol.x.shape) == (mb.shape[1], 32)
            and sol.x.dtype == torch.float32 and sol.x.is_cuda)
    assert bool(torch.isfinite(sol.x).all())
    xs = sol.x.cpu().numpy().astype(np.float64)
    Bd = Bn.astype(np.float64)
    r_true = np.linalg.norm(Bd - (mb64.T @ (mb64 @ xs) + 50.0 * xs), axis=0)
    assert np.all(r_true < np.linalg.norm(Bd, axis=0))
    r_rep = sol.resnorm.cpu().numpy().astype(np.float64)
    assert np.abs(r_true - r_rep).max() / r_true.max() < 1e-3
    for name in ("colmax", "quant3_planes", "mono_panel", "mono_group"):
        assert tk.launches[name] > 0, name


# ---------------------------------------------------------- ELL gather
def _x_panel(X, rows_pad):
    """X padded to ``rows_pad`` rows with zeros (the sentinel row)."""
    Xp = torch.zeros((rows_pad, X.shape[1]), dtype=torch.float32,
                     device=X.device)
    Xp[: X.shape[0]] = X
    return Xp


@pytest.mark.parametrize("mode", ["valued_full", "packed_full",
                                  "valued_chunked", "packed_chunked",
                                  "unit_chunked", "sweep"])
def test_ell_kernels_on_main_path_buckets(config_a, config_b, mode):
    """Each mode of the two gather kernels, bit-exact against its plain
    version on the buckets the main paths build: config A's largest,
    config B's largest packed whole-row one, the chunked widths of
    config A built unsplit (plain columns against an X past 65,536
    rows), at N = 128, 1 and 8; ell_sweep on config B's first sweep item
    at N = 128 and 1. Each runs the body its width picks: ell_bucket the
    narrow one at N <= 8, the lane-split one at N=128."""
    g = np.random.default_rng(7)
    mA = config_a.m
    XA = _cuda(g.standard_normal((mA.shape[1], 128)).astype(np.float32))
    XpA = _x_panel(XA, ell_ops._round_up(mA.shape[1] + 1, 8))
    segB = config_b.op.fwd.segments[0]
    XpB = _x_panel(_cuda(g.standard_normal((segB.shape[1], 128)).astype(
        np.float32)), ell_ops._round_up(segB.shape[1] + 1, 8))
    if mode == "sweep":
        item = next(b for b, m, *_ in ell_ops._seg_layout(segB)
                    if m == "sweep")
        flats, meta = [], []
        for bb, t0, t1, np_ in item:
            flats.append(ell_ops._slice_chunk(bb, segB, t0, t1, np_)[3]
                         .reshape(-1))
            meta.append((np_, bb.cols.shape[1] // 2))
        flat, parts = torch.cat(flats), tuple(meta)
        for N in (128, 1):
            x = XpB if N == 128 else XpB[:, :N].contiguous()
            _body(f"ell_sweep[N={N}]",
                  lambda: ek.ell_sweep_spmm(flat, x, parts=parts),
                  "ell_sweep_kernel", "ell_narrow_kernel")
            _same(f"ell_sweep[N={N}]", ek.ell_sweep_spmm(flat, x, parts=parts),
                  ek.ell_sweep_spmm_plain(flat, x, parts=parts))
        return
    if mode == "valued_full":
        b = max(config_a.op.fwd.buckets, key=lambda b: b.cols.numel())
        x128, unit, packed = XpA, False, None
    elif mode == "packed_full":
        b = max((b for b in segB.buckets if b.width <= 64),
                key=lambda b: b.cols.numel())
        x128, unit, packed = XpB, True, b.packed
    else:
        coo = (ft.coo_from_scipy if mode == "valued_chunked"
               else ft.binary_coo_from_scipy)(mA, device="cuda")
        A = ft.build_ell(coo, split_rows=0, device="cuda")
        b = max((b for b in A.buckets if b.width > 64),
                key=lambda b: b.cols.numel())
        unit = mode != "valued_chunked"
        packed = b.packed if mode == "packed_chunked" else None
        # plain columns: an X panel past 65,536 rows cannot use 16-bit pairs
        x128 = _x_panel(XA, 65_544) if mode == "unit_chunked" else XpA
    for N in (128, 1, 8):
        x = x128 if N == 128 else x128[:, :N].contiguous()
        kw = dict(unit=unit, packed=packed)
        _body(f"ell_bucket[{mode},N={N}]",
              lambda: ek.ell_bucket_spmm(b.cols, b.vals, x, **kw),
              *("ell_narrow_kernel", "ell_bucket_kernel")[
                  :: 1 if N <= 8 else -1])
        _same(f"ell_bucket[{mode},N={N}]",
              ek.ell_bucket_spmm(b.cols, b.vals, x, **kw),
              ek.ell_bucket_spmm_plain(b.cols, b.vals, x, **kw))


def test_ell_paths_vs_scipy(config_a, config_b):
    """Config A through ``operator(m)`` (auto -> ELL, both tilings):
    matvec, rmatvec, matmat N=128 within 1e-6; config B through
    ``format="ell"``: matmat N=128 within 1e-5. Both gather kernels
    launch, and the plan kernel once per plan a product applies."""
    mA, opA, mB, opB = config_a.m, config_a.op, config_b.m, config_b.op
    assert type(opA.fwd).__name__ == "EllMatrix" and opA.fwd.split_rows == 64
    assert type(opB.fwd).__name__ == "SegmentedEll"
    assert len(opB.fwd.segments) == 3
    g = np.random.default_rng(11)
    XAn = g.standard_normal((mA.shape[1], 128)).astype(np.float32)
    yAn = g.standard_normal(mA.shape[0]).astype(np.float32)
    XBn = g.standard_normal((mB.shape[1], 128)).astype(np.float32)
    XA, yA, XB = _cuda(XAn), _cuda(yAn), _cuda(XBn)
    for c in (tk, ek, ak):
        c.reset_launches()
    eA, eB = _eager(opA), _eager(opB)
    ya = eA.matvec(XA[:, 0].contiguous())
    za = eA.rmatvec(yA)
    Ya = eA.matmat(XA)
    Yb = eB.matmat(XB)
    torch.cuda.synchronize()
    applied = sum(len(tiling_plans("", t))
                  for t in (opA.fwd, opA.bwd, opA.fwd, opB.fwd))
    assert applied > 0 and ak.launches["plan_sum"] == applied
    mA64, mB64 = mA.astype(np.float64), mB.astype(np.float64)
    _held("A.matvec", ya, mA64 @ XAn[:, 0].astype(np.float64), REL)
    _held("A.rmatvec", za, mA64.T @ yAn.astype(np.float64), REL)
    _held("A.matmat", Ya, mA64 @ XAn.astype(np.float64), REL)
    _held("B.matmat", Yb, mB64 @ XBn.astype(np.float64), REL_B)
    assert ek.launches["ell_bucket"] > 0 and ek.launches["ell_sweep"] > 0


def _ell_segments(A):
    return A.segments if hasattr(A, "segments") else [A]


def _whole_buckets(A):
    """(segment, bucket) of every whole-bucket item of an ELL tiling
    (under the flag as it stands)."""
    return [(seg, b) for seg in _ell_segments(A)
            for b, mode, *_ in ell_ops._seg_layout(seg) if mode == "smem"]


def _layout_launches(A):
    """Kernel launches of one product over an ELL tiling, by kernel, from
    the layout the dispatch walks (under the flag as it stands)."""
    kernel = {"chunk": "ell_bucket", "sweep": "ell_sweep",
              "smem": "ell_bucket_smem"}
    out = {}
    for seg in _ell_segments(A):
        for _, mode, *_ in ell_ops._seg_layout(seg):
            out[kernel[mode]] = out.get(kernel[mode], 0) + 1
    return out


def _part_rows(A):
    """The rows of the parts one product over an ELL tiling gathers."""
    return sum(np_ for seg in _ell_segments(A)
               for b, mode, s0, s1, n_pad in ell_ops._seg_layout(seg)
               for _, _, _, np_ in (b if mode == "sweep"
                                    else ((b, s0, s1, n_pad),)))


@pytest.fixture(scope="module")
def smem(config_a, config_b):
    """Config A and config B built again under ``USE_SMEM_PATH`` (their
    plans are keyed by the flag), with each forward product's launches."""
    ell_ops.USE_SMEM_PATH = True
    try:
        opA = ft.operator(config_a.m)
        opB = ft.operator(config_b.m, format="ell", transpose=False)
        return SimpleNamespace(
            opA=opA, opB=opB, perA=_layout_launches(opA.fwd),
            perB=_layout_launches(opB.fwd),
            itemsA=_whole_buckets(opA.fwd), itemsB=_whole_buckets(opB.fwd))
    finally:
        ell_ops.USE_SMEM_PATH = False


def test_smem_kernel_on_main_path_buckets(smem):
    """ell_bucket_smem bit-exact against its plain version on config A's
    widest valued whole bucket at N = 1, 8 (the narrow body) and 128, its
    width-40 bucket at N=128, and config B's width-32 and width-12 unit
    whole buckets at N=128, each on the body its width picks."""
    g = np.random.default_rng(37)

    def widest(items, K=None):
        pick = [(s, b) for s, b in items if K is None or b.width == K]
        assert pick, f"no whole bucket of width {K}"
        return max(pick, key=lambda sb: (sb[1].width, sb[1].cols.shape[0]))

    segA, bA = widest(smem.itemsA)
    for seg, b, N in ((segA, bA, 128), (segA, bA, 1), (segA, bA, 8),
                      (*widest(smem.itemsA, 40), 128),
                      (*widest(smem.itemsB, 32), 128),
                      (*widest(smem.itemsB, 12), 128)):
        x = _x_panel(_cuda(g.standard_normal((seg.shape[1], N)).astype(
            np.float32)), ell_ops._round_up(seg.shape[1] + 1, 8))
        unit = seg.unit_vals
        _body(f"ell_bucket_smem[{tuple(b.cols.shape)},N={N}]",
              lambda: ek.ell_bucket_spmm_smem(b.cols, b.vals, x, unit=unit),
              *(("ell_smem_narrow_kernel",
                 ("ell_smem_kernel", "ell_narrow_kernel")) if N <= 8 else
                ("ell_smem_kernel", "ell_smem_narrow_kernel")))
        _same(f"ell_bucket_smem[{tuple(b.cols.shape)},N={N}]",
              ek.ell_bucket_spmm_smem(b.cols, b.vals, x, unit=unit),
              ek.ell_bucket_spmm_smem_plain(b.cols, b.vals, x, unit=unit))


def test_smem_paths_vs_scipy(smem, config_a, config_b, monkeypatch):
    """Under the flag: the flag's plans are the ones used, each product
    launches what its layout gives (ell_bucket_smem among them), and A's
    SpMV and matmat N=128 are within 1e-6, B's matmat N=128 within 1e-5
    of scipy."""
    monkeypatch.setattr(ell_ops, "USE_SMEM_PATH", True)
    assert smem.perA.get("ell_bucket_smem", 0) > 0
    assert smem.perB.get("ell_bucket_smem", 0) > 0
    for op in (smem.opA, smem.opB):
        plan = op.fwd.plan
        assert (plan is not None and plan.layout_key == assemble.layout_key()
                and plan.n_slots == _part_rows(op.fwd))
    mA, mB = config_a.m, config_b.m
    g = np.random.default_rng(39)
    XAn = g.standard_normal((mA.shape[1], 128)).astype(np.float32)
    XBn = g.standard_normal((mB.shape[1], 128)).astype(np.float32)
    XA, XB = _cuda(XAn), _cuda(XBn)
    ek.reset_launches()
    eA, eB = _eager(smem.opA), _eager(smem.opB)
    ya = eA.matvec(XA[:, 0].contiguous())
    Ya = eA.matmat(XA)
    Yb = eB.matmat(XB)
    torch.cuda.synchronize()
    counts = dict(ek.launches)
    want = {k: 2 * smem.perA.get(k, 0) + smem.perB.get(k, 0) for k in counts}
    assert counts == want
    assert counts["ell_bucket_smem"] > 0
    mA64, mB64 = mA.astype(np.float64), mB.astype(np.float64)
    _held("A.matvec", ya, mA64 @ XAn[:, 0].astype(np.float64), REL)
    _held("A.matmat", Ya, mA64 @ XAn.astype(np.float64), REL)
    _held("B.matmat", Yb, mB64 @ XBn.astype(np.float64), REL_B)


# ---------------------------------------------------------------- hybrid
@pytest.mark.parametrize("N", [1, 32, 128, 256])
def test_densecols_on_ecfp_block(ecfp, N):
    """densecols bit-exact against its plain version on the ECFP forward
    tiling's dense-column block (50,176 x 5,376), on the planes
    `dense_cols_spmm` makes from a random X."""
    from fastsparse_torch.ops.spmm import densecols_planes

    dc = ecfp.op.fwd.dense_cols
    X = _cuda(np.random.default_rng(N).standard_normal(
        (dc.shape[1], N)).astype(np.float32))
    args = (dc.block, *densecols_planes(X, dc.col_ids))
    _same(f"densecols[N={N}]", tk.densecols_spmm(*args),
          tk.densecols_spmm_plain(*args))


@pytest.mark.parametrize("path,N", [
    ("ecfp.fwd", 1), ("ecfp.fwd", 32), ("ecfp.fwd", 128), ("ecfp.fwd", 256),
    ("ecfp.bwd", 1), ("ecfp.bwd", 32), ("ecfp.bwd", 128), ("ecfp.bwd", 256),
    ("rmat18.fwd", 128)])
def test_densecols_encode_on_main_paths(request, path, N):
    """`densecols_planes` on the card with the main paths' column ids (the
    ECFP tilings' dense-column blocks, 5,376 and 13,440 ids; R-MAT's 1,024
    hub ids): the row gather inside the encode, bit-equal to its torch
    ops."""
    fixture, tiling = path.split(".")
    op = request.getfixturevalue(fixture).op
    dc = getattr(op, tiling).dense_cols
    X = _cuda(np.random.default_rng(N).standard_normal(
        (dc.shape[1], N)).astype(np.float32))
    from fastsparse_torch.ops.spmm import densecols_planes

    D = dc.col_ids.numel()
    _encode_same(f"{path} N={N}", densecols_planes(X, dc.col_ids), X,
                 dc.col_ids, D, N, 3 * N)


def test_densecols_call_runs_the_encode_kernels(ecfp):
    """A captured `dense_cols_spmm` (the ECFP forward block at N=32) is
    the encoder's fill and two launches and the densecols kernel: no
    index cast, gather, reduction, cast or concatenation of the old
    prep."""
    from fastsparse_torch.ops.spmm import dense_cols_spmm

    dc = ecfp.op.fwd.dense_cols
    X = _cuda(np.random.default_rng(3).standard_normal(
        (dc.shape[1], 32)).astype(np.float32))
    names = kernel_names(lambda: dense_cols_spmm(dc, X)).split()
    mine = ("encode_colmax_kernel", "encode_planes_kernel",
            "s8_engine_kernel")
    for k in mine:
        assert sum(k in n for n in names) == 1, (k, names)
    others = [n for n in names if not any(k in n for k in mine)]
    assert len(others) <= 1 and all("FillFunctor" in n for n in others), (
        others)


def _cg_residuals(m64, rhs, sol, reg):
    """The true residual of each column in float64, the initial one and
    the solver's reported one."""
    xs = sol.x.cpu().numpy().astype(np.float64)
    b = rhs.cpu().numpy().astype(np.float64)
    r_true = np.linalg.norm(b - (m64.T @ (m64 @ xs) + reg * xs), axis=0)
    return r_true, np.linalg.norm(b, axis=0), sol.resnorm.cpu().numpy()


def test_ecfp_hybrid_paths_vs_scipy(ecfp):
    """``operator(m)`` on the ECFP matrix: a hybrid of dense columns and
    ELL on the card in both tilings; matmat N = 32, 128, 256, matvec,
    rmatmat N=32 within 1e-6 of scipy; the Macau inner step (``rhs =
    op.rmatmat(R)``, ``cg_normal(reg=50, maxiter=30)``) takes the true
    residual below 3e-3 of the initial one and reports it to 1e-3.
    densecols, both gather kernels and the plan kernel launch."""
    mE, opE = ecfp.m, ecfp.op
    for H in (opE.fwd, opE.bwd):
        assert type(H).__name__ == "HybridMatrix" and H.dense is None
        assert H.dense_cols is not None and H.dense_cols.block.is_cuda
    g = np.random.default_rng(13)
    Xn = {N: g.standard_normal((mE.shape[1], N)).astype(np.float32)
          for N in (32, 128, 256)}
    xn = Xn[32][:, 0].copy()
    Rn = g.standard_normal((mE.shape[0], 32)).astype(np.float32)
    for c in (tk, ek, ak):
        c.reset_launches()
    op = _eager(opE)
    Y = {N: op.matmat(_cuda(v)) for N, v in Xn.items()}
    y = op.matvec(_cuda(xn))
    rhs = op.rmatmat(_cuda(Rn))
    sol = ft.cg_normal(op, rhs, reg=50.0, maxiter=30)
    torch.cuda.synchronize()
    mE64 = mE.astype(np.float64)
    for N, v in Xn.items():
        _held(f"matmat N={N}", Y[N], mE64 @ v.astype(np.float64), REL)
    _held("matvec", y, mE64 @ xn.astype(np.float64), REL)
    _held("rmatmat N=32", rhs, mE64.T @ Rn.astype(np.float64), REL)
    r_true, r0, r_rep = _cg_residuals(mE64, rhs, sol, 50.0)
    # 30 iterations take the true residual to about 1.0e-3 of the initial
    # one on this matrix (H100 runs); the bar leaves 3x of that
    assert np.all(r_true < 3e-3 * r0)
    assert np.abs(r_true - r_rep).max() / r_true.max() < 1e-3
    for name, c in (("densecols", tk), ("ell_bucket", ek), ("ell_sweep", ek),
                    ("plan_sum", ak)):
        assert c.launches[name] > 0, name


def test_reordered_paths_vs_scipy(config_a, ecfp):
    """BASELINE config 2 as the reference's bench suite calls it
    (``reorder="auto", transpose=False``: an ELL behind its
    permutations) and the ECFP matrix with ``reorder="degree",
    transpose=False`` (a hybrid without dense tiles), against scipy."""
    mA, mE = config_a.m, ecfp.m
    op2 = ft.operator(mA, reorder="auto", transpose=False,
                      dtype=torch.float32)
    assert type(op2.fwd).__name__ == "EllMatrix"
    opD = ft.operator(mE, reorder="degree", transpose=False)
    assert type(opD.fwd).__name__ == "HybridMatrix" and opD.fwd.dense is None
    g = np.random.default_rng(13)
    x2n = g.standard_normal(mA.shape[1]).astype(np.float32)
    X2n = g.standard_normal((mA.shape[1], 128)).astype(np.float32)
    XEn = g.standard_normal((mE.shape[1], 128)).astype(np.float32)
    mA64, mE64 = mA.astype(np.float64), mE.astype(np.float64)
    _held("config2.matvec", op2.matvec(_cuda(x2n)),
          mA64 @ x2n.astype(np.float64), REL)
    _held("config2.matmat N=128", op2.matmat(_cuda(X2n)),
          mA64 @ X2n.astype(np.float64), REL)
    _held("ecfp-degree.matmat N=128", opD.matmat(_cuda(XEn)),
          mE64 @ XEn.astype(np.float64), REL)


# ----------------------------------------------------------------- tiles
def _tile_hybrid(H, threshold, dc_shape, offsets, segs, nnz, sparse):
    """A HybridMatrix with dense tiles against the reference's layout:
    ``segs`` holds per segment (kind, dtype, (ns, width or T) list or
    padded-tile count), or None for an empty segment."""
    D = H.dense
    assert H.threshold == threshold
    assert tuple(H.dense_cols.block.shape) == dc_shape
    assert type(D).__name__ == "ColSegmented" and D.col_offsets == offsets
    assert H.dense_nnz == nnz and type(H.sparse).__name__ == sparse
    for S, want in zip(D.segments, segs):
        if want is None:
            assert not S.buckets
            continue
        kind, dtype, spec = want
        assert (S.buckets and not S.is_mono and S.is_panel == (kind == "panels")
                and str(S.dtype) == dtype and S.tile_m == 8)
        got = ([(b.ns, b.width) for b in S.buckets] if kind == "panels"
               else S.padded_tiles if isinstance(spec, int)
               else [(b.ns, b.ntiles) for b in S.buckets])
        assert got == spec


def test_tile_layouts_match_reference(tiles):
    """The ECFP matrix through ``reorder="auto"`` (forward tiling alone
    and both tilings) and config B through ``reorder="degree"``: segment
    offsets, bucket kinds and dtypes, thresholds and padded tiles as the
    reference builds them."""
    opF, opT, opB = tiles.opF, tiles.opT, tiles.opB
    assert opF.row_perm is not None and opF.col_perm is not None
    fwd = (41, (50_176, 5_376), (0, 10_112),
           [("panels", "torch.int8", [(3040, 1), (448, 2), (8, 3)]),
            ("panels", "torch.int8", [(2648, 1), (128, 2)])],
           738_877, "EllMatrix")
    for H in (opF.fwd, opT.fwd):
        assert type(H).__name__ == "HybridMatrix"
        _tile_hybrid(H, *fwd)
    _tile_hybrid(opT.bwd, 40, (20_224, 13_440), (0, 12_544, 25_088, 37_632),
                 [("tiles", "torch.bfloat16", n)
                  for n in (320, 5_504, 5_760, 4_736)],
                 1_019_177, "SegmentedEll")
    assert opB.row_perm is None and opB.col_perm is None  # elided
    _tile_hybrid(opB.fwd, opB.fwd.threshold, (65_536, 2_560),
                 (0, 16_384, 32_768, 49_152),
                 [("tiles", "torch.bfloat16", [(8, 32)]),
                  ("panels", "torch.int8", [(8, 1)]), None, None],
                 opB.fwd.dense_nnz, "SegmentedEll")


def _tile_sets(tiles, kernel, N, g):
    """(kernel outputs, plain outputs) of one product's launches of a tile
    kernel on the main path's segments."""
    bo = bsr_ops
    if kernel == "panel_spmm":  # the ECFP forward class panels
        D = tiles.opF.fwd.dense
        K_rows = len(D.segments) * D.seg_cols
        X = _cuda(g.standard_normal((D.shape[1], N)).astype(np.float32))
        nq = bo._narrow_nq(N)
        Xg, fold = ((bo._pack_narrow_planes(X, K_rows, nq), False) if nq else
                    (bo._padded_x(X, K_rows, bo._round_up(N, 128)), "f32"))
        calls = [(b.start_slab[s0:s1], b.panels[s0:s1], si * D.seg_cols)
                 for si, S in enumerate(D.segments)
                 for b, s0, s1, _ in bo._bsr_layout(S)]
        return tuple([f(st, pn, Xg, tile_k=128, fold=fold, row_base=rb)
                      for st, pn, rb in calls]
                     for f in (tt.panel_spmm, tt.panel_spmm_plain))
    if kernel == "bucket_spmv_configB":
        S = tiles.opB.fwd.dense.segments[0]
    else:  # the ECFP transpose tiling's largest tile segment
        S = max(tiles.opT.bwd.dense.segments, key=lambda s: s.padded_tiles)
    K = S.n_slabs * S.tile_k
    parts = [(b.slab_ids[s0:s1], b.tiles[s0:s1])
             for b, s0, s1, _ in bo._bsr_layout(S)]
    if kernel.startswith("bucket_spmv"):
        x = _cuda(g.standard_normal((S.shape[1], 1)).astype(np.float32))
        xp = bo._padded_x(x, K, 1).reshape(S.n_slabs, S.tile_k)
        return tuple([f(sl, t, xp) for sl, t in parts]
                     for f in (tt.bucket_spmv, tt.bucket_spmv_plain))
    X = _cuda(g.standard_normal((S.shape[1], N)).astype(np.float32))
    nq = bo._narrow_nq(N)
    Xp, planes = ((bo._pack_narrow_planes(X, K, nq), 1) if nq else
                  (bo._stack_planes(bo._padded_x(X, K, 128), 128, 128), 3))
    return tuple([f(sl, t, Xp, n_block=128, planes=planes) for sl, t in parts]
                 for f in (tt.bucket_spmm, tt.bucket_spmm_plain))


@pytest.mark.parametrize("kernel,N", [
    ("panel_spmm", 32), ("panel_spmm", 128), ("panel_spmm", 256),
    ("bucket_spmm", 32), ("bucket_spmm", 128),
    ("bucket_spmv_ecfp", 1), ("bucket_spmv_configB", 1)])
def test_tile_kernels_on_main_path_segments(tiles, kernel, N):
    """panel_spmm on the ECFP forward class panels (windowed global X:
    narrow at N=32, fold "f32" at 128 and 256), bucket_spmm on the
    transpose tiling's largest segment (narrow N=32, planes N=128),
    bucket_spmv on that segment and on config B's tile segment: each
    product's launches within 1e-6 of their plain versions'."""
    kern, plain = _tile_sets(tiles, kernel, N, np.random.default_rng(17))
    torch.cuda.synchronize()
    _close(f"{kernel}[N={N}]", torch.cat(kern), torch.cat(plain))


def test_tile_paths_vs_scipy(ecfp, config_b, tiles):
    """BASELINE config 3 as called: matmat N = 32, 128, 256 and matvec
    within 1e-6; the Macau step on its two tilings (rmatmat within 1e-6,
    the true residual below 3e-3 of the initial); config B through
    ``reorder="degree"``: matmat N=128 and matvec within 1e-5. The three
    tile kernels and the plan kernel launch."""
    mE, mB = ecfp.m, config_b.m
    g = np.random.default_rng(19)
    Xn = {N: g.standard_normal((mE.shape[1], N)).astype(np.float32)
          for N in (32, 128, 256)}
    xn = Xn[32][:, 0].copy()
    Rn = g.standard_normal((mE.shape[0], 32)).astype(np.float32)
    XBn = g.standard_normal((mB.shape[1], 128)).astype(np.float32)
    xBn = XBn[:, 0].copy()
    for c in (tk, ek, tt, ak):
        c.reset_launches()
    eF, eT, eB = _eager(tiles.opF), _eager(tiles.opT), _eager(tiles.opB)
    Y = {N: eF.matmat(_cuda(v)) for N, v in Xn.items()}
    y = eF.matvec(_cuda(xn))
    rhs = eT.rmatmat(_cuda(Rn))
    sol = ft.cg_normal(eT, rhs, reg=50.0, maxiter=30)
    YB = eB.matmat(_cuda(XBn))
    yB = eB.matvec(_cuda(xBn))
    torch.cuda.synchronize()
    mE64, mB64 = mE.astype(np.float64), mB.astype(np.float64)
    for N, v in Xn.items():
        _held(f"ecfp-auto.matmat N={N}", Y[N], mE64 @ v.astype(np.float64),
              REL)
    _held("ecfp-auto.matvec", y, mE64 @ xn.astype(np.float64), REL)
    _held("ecfp-auto2.rmatmat N=32", rhs, mE64.T @ Rn.astype(np.float64), REL)
    _held("configB-degree.matmat", YB, mB64 @ XBn.astype(np.float64), REL_B)
    _held("configB-degree.matvec", yB, mB64 @ xBn.astype(np.float64), REL_B)
    r_true, r0, _ = _cg_residuals(mE64, rhs, sol, 50.0)
    assert np.all(r_true < 3e-3 * r0)
    for name in ("bucket_spmm", "panel_spmm", "bucket_spmv"):
        assert tt.launches[name] > 0, name
    assert ak.launches["plan_sum"] > 0


# ----------------------------------------------------------------- R-MAT
def test_rmat_path_vs_scipy(rmat18):
    """The R-MAT graph at scale 18 through ``reorder="auto"``: a hybrid
    whose tile segments are summed by a cross-segment row plan beside an
    ELL plan; matmat N=128 within 1e-6 of scipy, one plan kernel launch
    per plan."""
    m, op = rmat18.m, rmat18.op
    plans = tiling_plans("rmat18.fwd", op.fwd)
    assert any(TM and p.row_srcs for p, TM in plans.values())
    assert any(TM is None for p, TM in plans.values())
    Xn = np.random.default_rng(23).standard_normal(
        (m.shape[1], 128)).astype(np.float32)
    ak.reset_launches()
    Y = _eager(op).matmat(_cuda(Xn))
    torch.cuda.synchronize()
    _held("rmat18.matmat", Y, m.astype(np.float64) @ Xn.astype(np.float64),
          REL)
    assert ak.launches["plan_sum"] == len(plans)


# ------------------------------------------------- BASELINE config 2, 250k²
def _ell_parts(A):
    return sum(_layout_launches(A).values())


def test_powerlaw250k_matvec_vs_reference(powerlaw250k):
    """matvec of the 250,000² power-law instance: a SegmentedEll of 11
    segments and one cross-segment plan; within 1e-6 of the benchmark's
    float64 reference (`benchmark/lib/reference.py`) on the card, every
    layout part in one launch of ``ell_table_kernel`` (counted once as
    ``ell_launch``; one launch a part before the tile table), and one plan
    kernel launch."""
    from fastsparse_torch import tracing

    m, op = powerlaw250k.m, powerlaw250k.op
    A = op.fwd
    assert m.nnz == 12_497_053
    assert type(A).__name__ == "SegmentedEll" and len(A.segments) == 11
    assert A.plan is not None and op.col_perm is None
    x = torch.randn(m.shape[1], generator=torch.Generator().manual_seed(
        2**31 + 3)).cuda()
    for c in (ek, ak):
        c.reset_launches()
    with tracing.recording() as rec:
        y = _eager(op).matvec(x)
    torch.cuda.synchronize()
    ref = rmat_layout.bench_lib("reference")
    want = ref.Reference(m, "cuda").matvec(x)
    assert y.dtype == torch.float32 and y.shape == want.shape
    rel = ref.rel_gap(y, want)
    assert rel < REL, rel
    assert _ell_parts(A) > 200
    assert {k: v for k, v in ek.launches.items() if v} == {"ell_table": 1}
    assert rec.counts["ell_launch"] == 1
    assert ak.launches["plan_sum"] == 1
    names = kernel_names(lambda: _eager(op).matvec(x))
    assert "ell_table_kernel" in names and "ell_narrow_kernel" not in names


def test_powerlaw250k_table_equals_per_part_launches(powerlaw250k):
    """The one launch at the cell's shape (N = 1) bit-equal to the
    layout's per-part ``ell_bucket`` launches concatenated, and the matvec
    through it, with the plan applied, bit-equal to the per-part path's."""
    op = powerlaw250k.op
    A = op.fwd
    x = torch.randn(powerlaw250k.m.shape[1], generator=torch.Generator(
        ).manual_seed(2**31 + 5)).cuda()
    X = x[:, None]
    rids, parts = [], []
    for off, seg in zip(A.col_offsets, A.segments):
        xs = _x_panel(X[off : off + seg.shape[1]],
                      ell_ops._round_up(seg.shape[1] + 1, 8))
        ell_ops._seg_parts(seg, xs, rids, parts)
    want = torch.cat(parts)
    nw = ell_ops._narrow(A, 1, x.device)
    xt = torch.zeros((nw.table.x_rows, 1), device="cuda")
    for off, ncol, x0 in nw.panels:
        xt[x0 : x0 + ncol] = X[off : off + ncol]
    got = ek.ell_table_spmm(nw.table, xt)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (A.plan.n_slots, 1)
    assert torch.equal(got, want)
    y = _eager(op).matvec(x)
    old = ell_ops.TABLE_MAX_LANES
    ell_ops.TABLE_MAX_LANES = 0  # one launch a part
    try:
        y_parts = _eager(op).matvec(x)
    finally:
        ell_ops.TABLE_MAX_LANES = old
    assert torch.equal(y, y_parts)


def test_powerlaw250k_replay_counts_and_bits(powerlaw250k):
    """The cell's matvec called three times on a fresh cache: eager,
    captured, replayed, each bit-equal to the eager one; the replay counts
    the capture's ``ell_launch`` (1: the table's one launch; the layout's
    parts before it) and 3 ``ops``."""
    from fastsparse_torch import tracing

    m, op = powerlaw250k.m, _eager(powerlaw250k.op)
    x = torch.randn(m.shape[1], generator=torch.Generator().manual_seed(
        2**31 + 4)).cuda()
    recs, outs = [], []
    for _ in range(3):
        with tracing.recording() as rec:
            outs.append(op.matvec(x))
        torch.cuda.synchronize()
        recs.append(rec)
    eager, captured, replayed = recs
    assert captured.counts["captures"] == 1
    assert replayed.counts["replays"] == 1
    for y in outs[1:]:
        assert torch.equal(y, outs[0])
    assert (eager.counts["ell_launch"] == captured.counts["ell_launch"]
            == replayed.counts["ell_launch"] == 1)
    (g,) = op.graphs.graphs.values()
    assert g.counts == {"ell_launch": 1}
    (rep,) = [s for s in replayed.spans if s.name == "replay"]
    assert rep.counts == {"ops": 3, "replays": 1, "ell_launch": 1}


# ---------------------------------------------------------------- plans
def _main_path_plans(request, path):
    """``{label: (plan, strip height or None)}`` of the plans a main path
    applies."""
    if path == "configA":
        op = request.getfixturevalue("config_a").op
        return {**tiling_plans("fwd", op.fwd), **tiling_plans("bwd", op.bwd)}
    if path == "configB":
        return tiling_plans("fwd", request.getfixturevalue("config_b").op.fwd)
    if path == "ecfp":
        op = request.getfixturevalue("ecfp").op
        return {**tiling_plans("fwd", op.fwd), **tiling_plans("bwd", op.bwd)}
    if path == "ecfp_tiles":  # the transpose tiles' cross-segment plan
        bwd = request.getfixturevalue("tiles").opT.bwd
        return {k: v for k, v in tiling_plans("bwd", bwd).items()
                if v[1] is not None}
    return tiling_plans("fwd", request.getfixturevalue("rmat18").op.fwd)


@pytest.mark.parametrize("path", ["configA", "configB", "ecfp", "ecfp_tiles",
                                  "rmat18"])
def test_plan_kernel_on_main_path_plans(request, path):
    """The plan kernel (``sum_plan`` on the card) bit for bit against the
    torch ops the CPU runs (`plain_sum`), -0.0 planted, at N = 1, 32 and
    128 on every plan the path's products apply."""
    plans = _main_path_plans(request, path)
    assert plans
    g = np.random.default_rng(29)
    for name, (plan, TM) in plans.items():
        for N in (1, 32, 128):
            L = ell_ops._lanes(N)
            # a cross-segment plan sums its strips' rows (``row_srcs``) or
            # whole strips of TM rows; an ELL plan its part slots
            n, width = ((plan.n_slots * TM, L) if TM and plan.row_srcs else
                        (plan.n_slots, L * (TM or 1)))
            P = neg_zero_parts(g, n, width).cuda()
            assert same_bits(assemble.sum_plan(plan, P),
                             assemble.plain_sum(plan, P)), (path, name, N)


# ------------------------------------------------------------------ fp64
def _dd_bucket(A, valued, key):
    """(offset, segment, bucket, lo bucket or None) of the bucket with the
    largest ``key`` in a DdEll (valued) or a unit ELL tiling."""
    if valued:
        items = [(off, sh, b, bl) for (off, sh), (_, sl) in
                 zip(ell_ops._segments(A.hi), ell_ops._segments(A.lo))
                 for b, bl in zip(sh.buckets, sl.buckets)]
    else:
        items = [(off, seg, b, None) for off, seg in ell_ops._segments(A)
                 for b in seg.buckets]
    return max(items, key=lambda it: key(it[2]))


_DD = ("ell_dd_rows_kernel", "ell_dd_split_kernel")


def _largest(b):
    return b.cols.numel()


def _longest(b):
    return b.cols.shape[::-1]


@pytest.mark.parametrize("case", ["config1", "config2_fp64", "configB_unit"])
def test_dd_kernels_on_main_path_buckets(fp64, case):
    """The two double-word gathers bit-equal to their plain versions in hi
    and lo: ell_bucket_dd_valued on the largest bucket of config 1's
    `build_ell_dd` (N=1) and of config 2 in fp64 and on its longest-row
    bucket (N = 1 and 32); ell_bucket_dd on config B's largest unsplit unit
    bucket and its longest-row one (N = 1 and 32). The body, where the
    shape fixes it: a thread a chain (rows kernel) on rows of at most 8
    slots and on the largest buckets at N=32, the split kernel on the few
    rows of 2,048 slots."""
    g = np.random.default_rng(29)
    rows, split = _DD
    picks = {"config1": (fp64.A1, True, [(_largest, 1, rows)]),
             "config2_fp64": (fp64.A2d, True,
                              [(_largest, 1, None), (_largest, 32, rows),
                               (_longest, 1, split), (_longest, 32, split)]),
             "configB_unit": (fp64.opBu.fwd, False,
                              [(_largest, 1, None), (_largest, 32, rows),
                               (_longest, 1, split), (_longest, 32, split)])}
    A, valued, runs = picks[case]
    for key, N, body in runs:
        off, seg, b, bl = _dd_bucket(A, valued, key)
        X = _cuda(g.standard_normal((off + seg.shape[1], N)))
        xh = X.float()
        x2 = ell_ops._dd_panel(xh, (X - xh.double()).float(), off,
                               seg.shape[1])
        kern, plain, args = (
            (dk.ell_bucket_spmm_dd_valued, dk.ell_bucket_spmm_dd_valued_plain,
             (b.cols, b.vals, bl.vals, x2)) if valued else
            (dk.ell_bucket_spmm_dd, dk.ell_bucket_spmm_dd_plain, (b.cols, x2)))
        if body:
            _body(f"{case} {tuple(b.cols.shape)} N={N}", lambda: kern(*args),
                  body, [k for k in _DD if k != body])
        yk, yp = kern(*args), plain(*args)
        torch.cuda.synchronize()
        for part, k, p in zip(("hi", "lo"), yk, yp):
            assert k.dtype == torch.float32, (case, part)
            _same(f"{case} {tuple(b.cols.shape)} N={N} {part}", k, p)


def test_fp64_layouts(fp64):
    op1, A1, opBu = fp64.op1, fp64.A1, fp64.opBu
    assert (type(op1.fwd).__name__ == "SegmentedEll"
            and op1.fwd.dtype == torch.float64
            and all(s.split_rows == 0 for s in op1.fwd.segments))
    assert len(A1.hi.segments) == 13
    assert (len(opBu.fwd.segments) == 3 and opBu.fwd.segments[0].unit_vals
            and all(s.split_rows == 0 for s in opBu.fwd.segments))


def test_fp64_paths_vs_scipy(fp64, config_b):
    """BASELINE config 1 both ways the reference's suite runs it (the f64
    operator's matvec, ``spmm_dd(build_ell_dd(m1))``), config 2 in fp64
    through ``spmm_dd`` at N=1 and the unit ``spmm_dd`` on config B at
    N=32, each within 1e-10 of scipy; both dd kernels launch."""
    m1, m2d, mB = fp64.m1, fp64.m2d, config_b.m
    x1n = np.random.default_rng(1).standard_normal(m1.shape[1])
    g = np.random.default_rng(31)
    x2n = g.standard_normal((m2d.shape[1], 1))
    XBn = g.standard_normal((mB.shape[1], 32))
    x1, x2, XB = _cuda(x1n), _cuda(x2n), _cuda(XBn)
    for c in (tk, ek, tt, dk):
        c.reset_launches()
    y1 = _eager(fp64.op1).matvec(x1)
    y1dd = ft.spmm_dd(fp64.A1, x1[:, None])
    y2dd = ft.spmm_dd(fp64.A2d, x2)
    YB = ft.spmm_dd(_eager(fp64.opBu), XB)
    torch.cuda.synchronize()
    f64 = dict(dtype=torch.float64, strict=False)
    _held("config1.operator.matvec", y1, m1 @ x1n, DD, **f64)
    _held("config1.spmm_dd", y1dd[:, 0], m1 @ x1n, DD, **f64)
    _held("config2-fp64.spmm_dd", y2dd, m2d @ x2n, DD, **f64)
    _held("configB-unit.spmm_dd N=32", YB, mB.astype(np.float64) @ XBn, DD,
          **f64)
    assert dk.launches["ell_bucket_dd"] > 0
    assert dk.launches["ell_bucket_dd_valued"] > 0


def test_fp64_config1_on_the_table_kernel(fp64):
    """BASELINE config 1's operator, the benchmark's ``fp64rand100k``
    layout (5 unsplit f64 segments, 55 buckets, 5,643,400 slots): matvec
    for an f64 and an f32 x and matmat at N = 8 run one launch of the
    table kernel's f64 mode and one ``plan_sum``, count one ``ell_launch``
    and no ``ell_scan``, and agree within 1e-13 with the plain float64
    reference and with the per-bucket scan they replace (the table path
    off); two eager calls give the same bits, and so does a replay."""
    import f64_reference as ref
    from fastsparse_torch import tracing

    m1, op = fp64.m1, fp64.op1
    A = op.fwd
    assert m1.nnz == 4_998_767 and len(A.segments) == 5
    assert sum(len(s.buckets) for s in A.segments) == 55
    assert sum(b.cols.numel() for s in A.segments for b in s.buckets) == (
        5_643_400)
    g = np.random.default_rng(2**31 + 9)
    x64 = _cuda(g.standard_normal(m1.shape[1]))
    cases = [("matvec", x64), ("matvec", x64.float()),
             ("matmat", _cuda(g.standard_normal((m1.shape[1], 8))))]
    for name, x in cases:
        for c in (ek, ak):
            c.reset_launches()
        with tracing.recording() as rec:
            y = getattr(_eager(op), name)(x)
            y2 = getattr(_eager(op), name)(x)
        torch.cuda.synchronize()
        assert y.dtype == torch.float64 and torch.equal(y, y2), name
        assert {k: v for k, v in ek.launches.items() if v} == {
            "ell_table": 2}
        assert ak.launches["plan_sum"] == 2
        assert rec.counts["ell_launch"] == 2 and "ell_scan" not in rec.counts
        want = ref.matmat(m1, x)
        assert ref.rel(y, want) < 1e-13, (name, x.dtype)
        old = ell_ops.TABLE_MAX_LANES
        ell_ops.TABLE_MAX_LANES = 0  # the scan
        try:
            with tracing.recording() as rec:
                y_scan = getattr(_eager(op), name)(x)
        finally:
            ell_ops.TABLE_MAX_LANES = old
        assert rec.counts["ell_scan"] == 55 and "ell_launch" not in rec.counts
        assert ref.rel(y, y_scan) < 1e-13
    names = kernel_names(lambda: _eager(op).matvec(x64))
    assert "ell_table_kernelId" in names and "plan_sum_kernelId" in names
    fresh = _eager(op)
    outs = [fresh.matvec(x64) for _ in range(3)]
    (gr,) = fresh.graphs.graphs.values()
    assert gr.counts == {"ell_launch": 1}
    for y in outs[1:]:
        assert torch.equal(y, outs[0])


def test_scatter_paths_vs_scipy(fp64, config_a):
    """The ``index_add_`` engines: BASELINE config 1 as ``format="csr"``
    (f64, 1e-10), config 2 as a Hilbert-sorted COO in f32 (1e-6) and f64
    (1e-10), config A's COO rmatvec and matmat N=128, the ELL's transpose
    by scatter and ``ata_X(reg=50)`` at N=32 (1e-6)."""
    m1, m2d, mA = fp64.m1, fp64.m2d, config_a.m
    op1 = ft.operator(m1, format="csr", transpose=False)
    cA = ft.sort_coo(ft.coo_from_scipy(mA, device="cuda"), "hilbert")
    c2d = ft.sort_coo(ft.coo_from_scipy(m2d, device="cuda"), "hilbert")
    opC = ft.operator(mA, format="coo")
    opE = ft.operator(mA, transpose=False)
    cooA = ft.coo_from_scipy(mA, device="cuda")
    assert (type(op1.fwd).__name__ == "CSR" and op1.fwd.dtype == torch.float64
            and op1.fwd.n_valid == m1.nnz)
    assert type(opC.fwd).__name__ == "COO"
    assert type(opE.fwd).__name__ == "EllMatrix" and opE.bwd is None
    g = np.random.default_rng(41)
    x1n = g.standard_normal(m1.shape[1])
    xAn = g.standard_normal(mA.shape[1]).astype(np.float32)
    x2n = g.standard_normal(m2d.shape[1])
    yAn = g.standard_normal(mA.shape[0]).astype(np.float32)
    XAn = g.standard_normal((mA.shape[1], 128)).astype(np.float32)
    X32n = XAn[:, :32].copy()
    mA64, X3264 = mA.astype(np.float64), X32n.astype(np.float64)
    f64 = dict(dtype=torch.float64, strict=False)
    f32 = dict(strict=False)
    _held("config1.csr.matvec", op1.matvec(_cuda(x1n)), m1 @ x1n, DD, **f64)
    _held("config2.hilbert-coo.spmv", ft.spmv(cA, _cuda(xAn)),
          mA64 @ xAn.astype(np.float64), REL, **f32)
    _held("config2-fp64.hilbert-coo.spmv", ft.spmv(c2d, _cuda(x2n)),
          m2d @ x2n, DD, **f64)
    _held("A.coo.rmatvec", opC.rmatvec(_cuda(yAn)),
          mA64.T @ yAn.astype(np.float64), REL, **f32)
    _held("A.coo.matmat N=128", opC.matmat(_cuda(XAn)),
          mA64 @ XAn.astype(np.float64), REL, **f32)
    _held("A.ell.rmatvec (scatter)", opE.rmatvec(_cuda(yAn)),
          mA64.T @ yAn.astype(np.float64), REL, **f32)
    _held("A.ata_X N=32", ft.ata_X(cooA, _cuda(X32n), reg=50.0),
          mA64.T @ (mA64 @ X3264) + 50.0 * X3264, REL, **f32)
