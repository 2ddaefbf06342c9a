"""Port parity, kernels: the plain PyTorch versions of the four mono-path
kernels (what the wrappers run on CPU tensors, and the on-card oracle of
the CUDA kernels) against the reference Pallas kernels, run as the JAX
suite runs them on the CPU (interpret mode).

colmax and quant3 must be bit-exact (the port writes the planes that the
mono kernels read K-major: the reference's transposed, bit for bit);
mono_panel and mono_group are held bit for bit (exact integer dots, the
reference's fold and order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fastsparse as fs
from fastsparse.formats import bsr as jbsr
from fastsparse.ops import bsr_ops as jops
from fastsparse.ops.pallas import bsr_spmm as jk
from fastsparse_torch import interop
from fastsparse_torch.formats import bsr as tbsr
from fastsparse_torch.ops import bsr_ops as tops
from fastsparse_torch.ops.kernels import bsr_spmm as tk

torch.set_num_threads(1)


def _adversarial_x(K=256, N=256, seed=0):
    """f32 (K, N) columns: zeros, exact .5 ties (with sinv = 1), negatives,
    ±colmax hits, a huge dynamic range and plain normals."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((K, N)).astype(np.float32)
    X[:, 0] = 0.0
    X[:, 1] = (rng.integers(-300, 300, K) + 0.5).astype(np.float32)
    X[:, 2] = -np.abs(X[:, 2]) * 1e3
    X[::7, 3] = 4.0
    X[1::7, 3] = -4.0
    X[:, 4] = np.linspace(-1e6, 1e6, K, dtype=np.float32)
    X[:, 5] = rng.standard_normal(K).astype(np.float32) * 1e-6
    X[0, 5] = 1e8
    X[:, 130] = (rng.integers(-(2**22), 2**22, K) + 0.5).astype(np.float32)
    return X


def _sinv(X):
    m = np.abs(X).max(axis=0, keepdims=True)
    s = np.where(m > 0, m, 1.0).astype(np.float32) * np.float32(
        1.0 / (127.0 * 65536.0)
    )
    sinv = (np.float32(1.0) / s).astype(np.float32)
    # unit / power-of-two reciprocals keep the .5 ties exact
    sinv[0, 1] = 1.0
    sinv[0, 130] = 1.0
    sinv[0, 3] = 2.0 ** -3
    return sinv


def test_colmax_plain_bit_exact():
    X = _adversarial_x()
    ref = np.asarray(jk.colmax_pallas(jnp.asarray(X)))
    got = tk.colmax(torch.from_numpy(X)).numpy()
    assert got.shape == (1, X.shape[1])
    assert np.array_equal(ref, np.repeat(got, 8, axis=0))


@pytest.mark.parametrize("n_block", [128, 256])
def test_quant3_plain_bit_exact(n_block):
    X = _adversarial_x()
    sinv = _sinv(X)
    ref = np.asarray(jk.quant3_planes_pallas(
        jnp.asarray(X), jnp.asarray(np.repeat(sinv, 8, axis=0)),
        n_block=n_block,
    ))
    got = tk.quant3_planes(torch.from_numpy(X), torch.from_numpy(sinv),
                           n_block=n_block).numpy()
    assert got.dtype == np.int8 and np.array_equal(ref.T, got)
    # the .5 ties really were ties and rounded half to even
    assert (np.abs(X[:, 1] * sinv[0, 1]) % 1 == 0.5).all()


def test_quant3_prep_bit_exact():
    """The full wide prep (colmax, scale, reciprocal, quant3) and the
    narrow torch-op prep against the reference's, both transposed: the
    port writes every plane K-major."""
    X = _adversarial_x()
    ref_p, ref_s = jops._quant3_planes(jnp.asarray(X), 128, 256)
    got_p, got_s = tops._quant3_planes(torch.from_numpy(X), 128, 256)
    assert np.array_equal(np.asarray(ref_p).T, got_p.numpy())
    assert np.array_equal(np.asarray(ref_s), got_s.numpy())
    for N, K in ((1, 300), (5, 256), (16, 200), (40, 256)):
        nq = tops._narrow_nq(N)
        nb = tops._round_up(3 * nq, 32)
        ref_p, ref_s = jops._quant3_narrow(jnp.asarray(X[:, :N]), K, nq, nb)
        got_p, got_s = tops._quant3_narrow(torch.from_numpy(X[:, :N]), K, nq,
                                           nb)
        assert got_p.is_contiguous()
        assert np.array_equal(np.asarray(ref_p).T, got_p.numpy()), N
        assert np.array_equal(np.asarray(ref_s), got_s.numpy()), N


@pytest.mark.parametrize("N,K,layout", [
    (1, 300, "narrow"), (5, 256, "narrow"), (32, 301, "narrow"),
    (40, 256, "narrow"), (1, 300, "densecols"), (32, 301, "densecols"),
    (130, 256, "densecols")])
def test_quant3_encode_rows_bit_exact(N, K, layout):
    """`quant3_encode` with a row index (its plain version, the CPU path
    of both entry points) against the reference's encoding of the
    gathered rows: ``_quant3_narrow`` in the narrow layout (zero rows past
    the index) and ``_quant3_carry`` in the dense-column one, transposed;
    the index repeats rows, runs out of order and ends in zero ids, as a
    dense-column block's does."""
    X = _adversarial_x(K=400, N=256, seed=K + N)[:, :N]
    rows = np.random.default_rng(N).integers(0, X.shape[0], K)
    rows[-5:] = 0
    Xg = X[rows]
    ids = torch.from_numpy(rows.astype(np.int32))
    if layout == "narrow":
        nq = tops._narrow_nq(N)
        nb = tops._round_up(3 * nq, 32)
        ref_p, ref_s = jops._quant3_narrow(jnp.asarray(Xg), K, nq, nb)
        ref_p = np.asarray(ref_p).T
        kw = dict(k_rows=K, n_pad=nq, n_out=nb)
    else:
        q0, q1, q2, ref_s = jops._quant3_carry(jnp.asarray(Xg))
        ref_p = np.concatenate([np.asarray(q, np.int8) for q in (q0, q1, q2)],
                               1).T
        kw = dict(k_rows=K, n_pad=N, n_out=3 * N)
    got_p, got_s = tk.quant3_encode(torch.from_numpy(X), ids, **kw)
    assert got_p.dtype == torch.int8 and got_p.is_contiguous()
    assert np.array_equal(ref_p, got_p.numpy())
    assert np.array_equal(np.asarray(ref_s), got_s.numpy())


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


@pytest.fixture(scope="module")
def shared():
    """One reference operator (8-slab windows, 16-slab halo stride) and
    the port operator rebuilt from its arrays."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbsr, tbsr):
            mp.setattr(mod, "MONO_WIN_SLABS", 8)
            mp.setattr(mod, "HALO_STRIDE", 16)
        m = _banded(1, 2000, 4000, 300)
        op_j = fs.operator(m, format="bsr", transpose=False)
        op_t = interop.operator_from_reference_arrays(
            interop.reference_arrays(op_j), device="cpu"
        )
    assert op_j.fwd.is_mono and op_j.fwd.narrow is not None
    assert op_j.fwd.narrow.n_windows > 1
    X = np.random.default_rng(2).standard_normal((4000, 130)).astype(
        np.float32
    )
    return op_j, op_t, X


def _rel(y, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(y, np.float64) - ref).max() / (
        np.abs(ref).max() + 1e-30
    )


def test_mono_panel_i8w_plain_vs_pallas(shared):
    op_j, op_t, X = shared
    Aj, At = op_j.fwd, op_t.fwd
    bj, bt = Aj.buckets[0], At.buckets[0]
    K_pad = bt.n_windows * bt.win_slabs * At.tile_k
    Xp = torch.zeros((K_pad, 256))
    Xp[: X.shape[0], : X.shape[1]] = torch.from_numpy(X)
    planes, scale = tops._quant3_planes(Xp, 128, 256)
    out_rows = max(bt.out_strips, At.n_strips) * At.tile_m
    ref = jk.mono_panel_spmm(
        bj.window, bj.strip_ids, bj.start_rel, bj.first, bj.panels,
        jnp.asarray(planes.numpy().T), tile_m=Aj.tile_m, tile_k=Aj.tile_k,
        width=bj.width, win_slabs=bj.win_slabs, binary=False, n_block=128,
        fold="i8w", out_rows=out_rows, scale=jnp.asarray(scale.numpy()),
    )
    got = tk.mono_panel_spmm(
        bt.window, bt.strip_ptr, bt.start_rel, bt.panels, planes,
        tile_m=At.tile_m, tile_k=At.tile_k, width=bt.width,
        win_slabs=bt.win_slabs, n_block=128, fold="i8w", out_rows=out_rows,
        scale=scale,
    )
    assert got.shape == ref.shape
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("N", [8, 40])
def test_mono_panel_narrow_plain_vs_pallas(shared, N):
    op_j, op_t, X = shared
    Aj, At = op_j.fwd, op_t.fwd
    bj, bt = Aj.buckets[0], At.buckets[0]
    K_pad = bt.n_windows * bt.win_slabs * At.tile_k
    nq = tops._narrow_nq(N)
    nb = tops._round_up(3 * nq, 32)
    planes, _ = tops._quant3_narrow(torch.from_numpy(X[:, :N]), K_pad, nq, nb)
    out_rows = max(bt.out_strips, At.n_strips) * At.tile_m
    ref = jk.mono_panel_spmm(
        bj.window, bj.strip_ids, bj.start_rel, bj.first, bj.panels,
        jnp.asarray(planes.numpy().T), tile_m=Aj.tile_m, tile_k=Aj.tile_k,
        width=bj.width, win_slabs=bj.win_slabs, binary=False, n_block=nb,
        fold=False, out_rows=out_rows,
    )
    got = tk.mono_panel_spmm(
        bt.window, bt.strip_ptr, bt.start_rel, bt.panels, planes,
        tile_m=At.tile_m, tile_k=At.tile_k, width=bt.width,
        win_slabs=bt.win_slabs, n_block=nb, fold=False, out_rows=out_rows,
    )
    assert got.shape == ref.shape
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_mono_group_plain_vs_pallas(shared):
    """The port addresses the un-halo'd K-major planes through the
    overlapping windows; the reference reads the halo'd lane-major copy
    `_halo_impl` builds (the planes transposed). Both convert exact s32
    dots to f32 once (|d| <= PK·127·127, far below 2^24): bit-equal."""
    op_j, op_t, X = shared
    hj, ht = op_j.fwd.narrow, op_t.fwd.narrow
    TK = op_t.fwd.tile_k
    K_pad = ((ht.n_windows - 1) * ht.stride + ht.win_slabs) * TK
    planes, _ = tops._quant3_narrow(torch.from_numpy(X[:, :1]), K_pad, 8, 32)
    assert tuple(planes.shape) == (32, K_pad)
    pj = np.asarray(planes.numpy()).T
    win_rows = ht.win_slabs * TK
    halo = np.concatenate([
        pj[w * ht.stride * TK : w * ht.stride * TK + win_rows]
        for w in range(ht.n_windows)
    ])
    ref = jk.mono_group_spmm(
        hj.windows, hj.start_rel, hj.panels, jnp.asarray(halo),
        tile_m=op_j.fwd.tile_m, tile_k=TK, width=hj.width,
        win_slabs=hj.win_slabs, binary=False, n_block=32, fold=False,
        group=hj.group,
    )
    got = tk.mono_group_spmm(
        ht.windows, ht.start_rel, ht.panels, planes, tile_m=op_t.fwd.tile_m,
        tile_k=TK, width=ht.width, stride=ht.stride, group=ht.group,
    )
    assert got.shape == ref.shape
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_wrappers_refuse_unported_modes(shared):
    _, op_t, _ = shared
    b = op_t.fwd.buckets[0]
    x = torch.zeros((384, b.n_windows * b.win_slabs * 128), dtype=torch.int8)
    kw = dict(tile_m=op_t.fwd.tile_m, tile_k=128, width=b.width,
              win_slabs=b.win_slabs, n_block=128,
              out_rows=b.out_strips * op_t.fwd.tile_m)
    for fold in ("i8", "f32", True):
        with pytest.raises(NotImplementedError):
            tk.mono_panel_spmm(b.window, b.strip_ptr, b.start_rel, b.panels,
                               x, fold=fold, **kw)
    with pytest.raises(TypeError):
        tk.colmax(torch.zeros((8, 8), dtype=torch.float64))
    # the plain versions never count as launches
    tk.reset_launches()
    tk.colmax(torch.zeros((8, 8)))
    assert all(v == 0 for v in tk.launches.values())


def test_build_key_tracks_sources(tmp_path, monkeypatch):
    """The kernel library is keyed on a hash of the sources, so an edited
    source builds a new library instead of loading a stale one."""
    from fastsparse_torch.ops.kernels import _build

    src = tmp_path / "k.cu"
    src.write_text("int a;")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._library_path()
    assert first == _build._library_path()
    src.write_text("int b;")
    assert _build._library_path() != first
    assert first.parent == _build.BUILD_DIR
