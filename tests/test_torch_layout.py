"""Port parity, layout: `fastsparse_torch` builds exactly the reference's
mono layout (items, windows, panels, halo layout, tile height) for the
same matrix and Config, refuses the layouts it does not port, and keeps
the reference's matrix generators and tile-height model.

Windows shrink to 8 slabs in BOTH packages (as tests/test_mono.py does for
the reference), so strips straddle windows at test size.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fastsparse as fs
import fastsparse_torch as ft
from fastsparse.config import Config as JConfig
from fastsparse.formats import bsr as jbsr
from fastsparse_torch import interop
from fastsparse_torch.formats import bsr as tbsr

torch.set_num_threads(1)


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


def _wide_row(seed):
    """Rows 128..383 empty; row 0 spans 16 slabs (past the 12-slab width
    cap), so the halo layout declines while forced mono still builds."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate(
        [np.zeros(2048, np.int64), rng.integers(384, 512, 4000)]
    )
    cols = np.concatenate(
        [rng.integers(0, 2048, 2048), rng.integers(0, 400, 4000)]
    )
    m = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                      shape=(512, 2048))
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()


@pytest.fixture
def small_windows(monkeypatch):
    for mod in (jbsr, tbsr):
        monkeypatch.setattr(mod, "MONO_WIN_SLABS", 8)
        monkeypatch.setattr(mod, "HALO_STRIDE", 16)


def _assert_same_layout(d_ref, d_port):
    assert set(d_ref) == set(d_port)
    for k, v in d_ref.items():
        w = d_port[k]
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and v.shape == w.shape, k
            assert np.array_equal(v, w), k
        else:
            assert v == w, k


LAYOUT_CASES = {
    # straddling windows, chain padding, halo layout with several windows
    "banded_dual": (lambda: _banded(0, 2000, 5000, 300), {}, True),
    # auto tile height goes 128 -> 256 at the real 80-slab windows
    "banded_tm256": (
        lambda: ft.bench.matrices.banded(8192, 512, seed=4, density=0.39),
        {}, False,
    ),
    # forced mono, empty strips, one row wider than the width cap: the
    # halo layout declines
    "halo_declines": (
        lambda: _wide_row(3), {"bsr_mono": "force", "tile_m": 8}, False
    ),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_matches_reference(case, small_windows, monkeypatch):
    make, cfg, transpose = LAYOUT_CASES[case]
    if case == "banded_tm256":  # real window geometry
        monkeypatch.setattr(jbsr, "MONO_WIN_SLABS", 80)
        monkeypatch.setattr(tbsr, "MONO_WIN_SLABS", 80)
    m = make()
    m.data[:] = 1.0
    op_j = fs.operator(m, format="bsr", transpose=transpose,
                       config=JConfig(**cfg))
    op_t = ft.operator(m, format="bsr", transpose=transpose,
                       config=ft.Config(**cfg), device="cpu")
    d_ref = interop.reference_arrays(op_j)
    _assert_same_layout(d_ref, interop.reference_arrays(op_t))
    assert d_ref["fwd.kind"] == "mono"
    if case == "banded_dual":
        assert d_ref["fwd.has_narrow"] and d_ref["fwd.narrow.n_windows"] > 1
        assert d_ref["fwd.n_windows"] > 1
    if case == "banded_tm256":
        assert d_ref["fwd.tile_m"] == 256
    if case == "halo_declines":
        assert not d_ref["fwd.has_narrow"]
    # the port's own structure round-trips exactly
    D = op_t.fwd.todense().numpy().astype(np.float64)
    assert np.abs(D - m.toarray()).max() == 0


def test_layout_interop_roundtrip(small_windows):
    """Arrays carried over from the reference rebuild the same layout."""
    m = _banded(4, 1500, 3500, 260)
    d = interop.reference_arrays(fs.operator(m, format="bsr"))
    op = interop.operator_from_reference_arrays(d, device="cpu")
    _assert_same_layout(d, interop.reference_arrays(op))
    b = op.fwd.buckets[0]
    sid = b.strip_ids.numpy()
    ptr = b.strip_ptr.numpy()
    # strip_ptr[s] is strip s's first item; every strip owns >= 1 item
    assert (np.diff(ptr) >= 1).all() and ptr[-1] == sid.size
    assert (sid[ptr[:-1]] == np.arange(ptr.size - 1)).all()


def test_layout_not_mono_raises():
    """With mono off the reference compiles class panels, and the port
    builds the same layout; as bitmask panels (slice 3b) it raises
    instead of building something else."""
    m = _banded(5, 1500, 3000, 250)
    op_j = fs.operator(m, format="bsr", transpose=False,
                       config=JConfig(bsr_mono="off"))
    assert not op_j.fwd.is_mono and op_j.fwd.is_panel
    op_t = ft.operator(m, format="bsr", transpose=False,
                       config=ft.Config(bsr_mono="off"), device="cpu")
    _assert_same_layout(interop.reference_arrays(op_j),
                        interop.reference_arrays(op_t))
    with pytest.raises(NotImplementedError):
        ft.operator(m, format="bsr", transpose=False, device="cpu",
                    config=ft.Config(bsr_mono="off", binary_tiles="bitmask"))


def test_layout_empty_matrix():
    m = sp.csr_matrix((64, 300), dtype=np.float32)
    op_j = fs.operator(m, format="bsr", transpose=True)
    op_t = ft.operator(m, format="bsr", transpose=True, device="cpu")
    d_ref = interop.reference_arrays(op_j)
    assert d_ref["fwd.kind"] == "empty"
    _assert_same_layout(d_ref, interop.reference_arrays(op_t))
    X = torch.ones((300, 5))
    assert torch.equal(op_t.matmat(X), torch.zeros((64, 5)))
    assert torch.equal(op_t.rmatvec(torch.ones(64)), torch.zeros(300))
    assert torch.equal(op_t.fwd.todense(), torch.zeros((64, 300)))


def test_unported_options_raise():
    m = _banded(6, 600, 900, 100)
    X = torch.ones((900, 4))
    with pytest.raises(NotImplementedError):
        ft.operator(m, format="hybrid", device="cpu",
                    config=ft.Config(binary_tiles="bitmask"))
    with pytest.raises(NotImplementedError):
        ft.operator(m, format="bsr", device="cpu",
                    config=ft.Config(bsr_mono_grouped=True))
    with pytest.raises(NotImplementedError):
        ft.operator(m, format="bsr", device="cpu",
                    config=ft.Config(binary_tiles="bitmask"))
    op = ft.operator(m, format="bsr", device="cpu")
    # ported since: an f64 operand runs the COO engine, as in the reference
    Y = op.matmat(X.double())
    assert Y.dtype == torch.float64
    ref = m.astype(np.float64) @ X.double().numpy()
    assert np.abs(Y.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    with pytest.raises(NotImplementedError):
        op.matmat(X.bfloat16())
    # valued matrices build f32 panels, whose products are not ported
    mv = m.copy()
    mv.data = np.random.default_rng(0).standard_normal(mv.nnz)
    opv = ft.operator(mv, format="bsr", device="cpu")
    assert opv.fwd.is_mono and opv.fwd.dtype == torch.float64
    with pytest.raises(NotImplementedError):
        opv.matmat(X)


def test_config_fields_match_reference():
    assert [f.name for f in dataclasses.fields(ft.Config)] == [
        f.name for f in dataclasses.fields(JConfig)
    ]
    assert dataclasses.asdict(ft.Config()) == dataclasses.asdict(JConfig())
    assert ft.Config().resolve().tile_m == JConfig().resolve().tile_m == 8


@pytest.mark.parametrize("gen", ["banded", "powerlaw", "rmat", "ecfp_like"])
def test_matrix_generators_match_reference(gen):
    from fastsparse.bench import matrices as jm
    from fastsparse_torch.bench import matrices as tm

    args = {
        "banded": ((700, 64), {"seed": 3, "density": 0.4}),
        "powerlaw": ((500, 400, 3000), {"seed": 2}),
        "rmat": ((9,), {"seed": 1}),
        "ecfp_like": ((120, 256), {"seed": 4, "n_scaffolds": 10}),
    }[gen]
    a = getattr(jm, gen)(*args[0], **args[1])
    b = getattr(tm, gen)(*args[0], **args[1])
    assert a.shape == b.shape and a.dtype == b.dtype
    assert (a != b).nnz == 0 and np.array_equal(a.indices, b.indices)


def test_best_tile_m_matches_reference():
    from fastsparse.bench.model import best_tile_m as jbest
    from fastsparse_torch.bench.model import best_tile_m as tbest

    for m in (_banded(7, 3000, 3000, 200), _wide_row(8),
              sp.random(800, 800, density=0.01, format="coo",
                        random_state=np.random.default_rng(9))):
        m = m.tocoo()
        assert tbest(m.row, m.col, m.shape) == jbest(m.row, m.col, m.shape)


def test_coo_roundtrip():
    m = _banded(10, 300, 500, 40).tocoo()
    c = ft.binary_coo_from_scipy(m, device="cpu")
    assert c.row_sorted and c.nnz == m.nnz
    assert np.array_equal(c.to_scipy().toarray(), m.toarray())
    assert np.array_equal(c.todense().numpy(), m.toarray())
    v = ft.coo_from_scipy(m.astype(np.float64) * 2.0, device="cpu")
    assert torch.equal(v.todense(), torch.as_tensor(m.toarray() * 2.0))
