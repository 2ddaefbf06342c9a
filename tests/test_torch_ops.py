"""Port parity, products: `fastsparse_torch` operators (CPU tensors, so
the kernels' plain versions) against the JAX reference operator on the
identical layout and against scipy in float64, at max|d|/max|ref| <= 1e-6:
matmat over every dispatch width (halo N <= 8, narrow 9..40, wide "i8w"
with one and two lane blocks), matvec, rmatvec, the normal and gram
chains and cg_normal. Also checks that the port imports without JAX.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fastsparse as fs
import fastsparse_torch as ft
from fastsparse.formats import bsr as jbsr
from fastsparse_torch import interop
from fastsparse_torch.formats import bsr as tbsr

torch.set_num_threads(1)
TOL = 1e-6


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


def _rel(y, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(y, np.float64) - ref).max() / (
        np.abs(ref).max() + 1e-30
    )


@pytest.fixture(scope="module")
def ops():
    """(scipy matrix, JAX operator, port operator built by the port,
    port operator rebuilt from the reference's arrays), 8-slab windows."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbsr, tbsr):
            mp.setattr(mod, "MONO_WIN_SLABS", 8)
            mp.setattr(mod, "HALO_STRIDE", 16)
        m = _banded(5, 1800, 4000, 280)
        op_j = fs.operator(m, format="bsr", transpose=True)
        op_t = ft.operator(m, format="bsr", transpose=True, device="cpu")
        op_i = interop.operator_from_reference_arrays(
            interop.reference_arrays(op_j), device="cpu"
        )
    for op in (op_j, op_t):
        assert op.fwd.is_mono and op.bwd.is_mono and op.fwd.narrow is not None
    return m, op_j, op_t, op_i


@pytest.mark.parametrize("N", [1, 8, 16, 32, 128, 130])
def test_matmat_vs_reference_and_scipy(ops, N):
    m, op_j, op_t, op_i = ops
    X = np.random.default_rng(N).standard_normal((m.shape[1], N)).astype(
        np.float32
    )
    ref = m @ X.astype(np.float64)
    yj = np.asarray(op_j.matmat(jnp.asarray(X)))
    yt = op_t.matmat(torch.from_numpy(X)).numpy()
    yi = op_i.matmat(torch.from_numpy(X)).numpy()
    assert yt.shape == (m.shape[0], N) and yt.dtype == np.float32
    assert _rel(yt, yj) <= TOL and _rel(yi, yj) <= TOL
    assert _rel(yt, ref) <= TOL and _rel(yj, ref) <= TOL


def test_matvec_rmatvec(ops):
    m, op_j, op_t, _ = ops
    rng = np.random.default_rng(3)
    x = rng.standard_normal(m.shape[1]).astype(np.float32)
    y = rng.standard_normal(m.shape[0]).astype(np.float32)
    got = op_t.matvec(torch.from_numpy(x)).numpy()
    assert _rel(got, np.asarray(op_j.matvec(jnp.asarray(x)))) <= TOL
    assert _rel(got, m @ x.astype(np.float64)) <= TOL
    got = op_t.rmatvec(torch.from_numpy(y)).numpy()
    assert _rel(got, np.asarray(op_j.rmatvec(jnp.asarray(y)))) <= TOL
    assert _rel(got, m.T @ y.astype(np.float64)) <= TOL
    Yt = rng.standard_normal((m.shape[0], 130)).astype(np.float32)
    got = op_t.rmatmat(torch.from_numpy(Yt)).numpy()
    assert _rel(got, m.T @ Yt.astype(np.float64)) <= TOL
    got = (op_t @ torch.from_numpy(x)).numpy()
    assert _rel(got, m @ x.astype(np.float64)) <= TOL


@pytest.mark.parametrize("N", [1, 16, 128])
def test_normal_and_gram_chains(ops, N):
    m, op_j, op_t, _ = ops
    md = m.astype(np.float64)
    rng = np.random.default_rng(10 + N)
    X = rng.standard_normal((m.shape[1], N)).astype(np.float32)
    Xt = torch.from_numpy(X)
    assert op_t._mono_chainable(Xt)
    if N == 1:
        got = op_t.normal_matvec(Xt[:, 0], reg=0.5).numpy()
        ref_j = np.asarray(op_j.normal_matvec(jnp.asarray(X[:, 0]), reg=0.5))
        ref = md.T @ (md @ X[:, 0]) + 0.5 * X[:, 0]
        g = rng.standard_normal(m.shape[0]).astype(np.float32)
        got_g = op_t.gram_matvec(torch.from_numpy(g), reg=0.25).numpy()
        assert _rel(got_g, np.asarray(
            op_j.gram_matvec(jnp.asarray(g), reg=0.25))) <= TOL
        assert _rel(got_g, md @ (md.T @ g) + 0.25 * g) <= TOL
    else:
        got = op_t.normal_matmat(Xt, reg=0.5).numpy()
        ref_j = np.asarray(op_j.normal_matmat(jnp.asarray(X), reg=0.5))
        ref = md.T @ (md @ X) + 0.5 * X
    assert _rel(got, ref_j) <= TOL
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("nrhs", [0, 8])
def test_cg_normal(ops, nrhs):
    """Same iterations as the reference (maxiter binds); solutions agree
    at the f32 bar and the true residual matches the reported one."""
    m, op_j, op_t, _ = ops
    md = m.astype(np.float64)
    shape = (m.shape[1],) if nrhs == 0 else (m.shape[1], nrhs)
    b = np.random.default_rng(20 + nrhs).standard_normal(shape).astype(
        np.float32
    )
    reg = 2000.0
    pre = ft.normal_jacobi(m, reg=reg, device="cpu")
    assert np.array_equal(pre.numpy(), np.asarray(fs.normal_jacobi(m, reg=reg)))
    for precond in (None, pre):
        got = ft.cg_normal(op_t, torch.from_numpy(b), reg=reg, maxiter=6,
                           precond=precond)
        ref = fs.cg_normal(op_j, jnp.asarray(b), reg=reg, maxiter=6,
                           precond=None if precond is None else
                           jnp.asarray(precond.numpy()))
        assert got.iters == int(ref.iters) == 6
        assert _rel(got.x.numpy(), np.asarray(ref.x)) <= TOL
        xs = got.x.numpy().astype(np.float64)
        r_true = np.linalg.norm(b - (md.T @ (md @ xs) + reg * xs), axis=0)
        assert np.all(r_true < np.linalg.norm(b, axis=0))
        assert np.allclose(got.resnorm.numpy(), r_true, rtol=1e-3)
    # plain CG on an explicit SPD matvec
    M = torch.from_numpy((md.T @ md).toarray() + reg * np.eye(m.shape[1]))
    sol = ft.cg(lambda v: M @ v, torch.from_numpy(b.astype(np.float64)),
                maxiter=50, tol=1e-12)
    assert np.allclose((M @ sol.x).numpy(), b, atol=1e-8 * np.abs(b).max())


def test_port_imports_without_jax():
    """The port imports torch and never jax or the JAX package."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, scipy.sparse as sp, torch
        import fastsparse_torch as ft
        m = sp.random(300, 500, density=0.05, format="csr",
                      random_state=np.random.default_rng(0))
        m.data[:] = 1.0
        op = ft.operator(m, format="bsr", transpose=True, device="cpu")
        X = np.random.default_rng(1).standard_normal((500, 3))
        Y = op.matmat(torch.tensor(X, dtype=torch.float32)).numpy()
        ref = m @ X
        assert np.abs(Y - ref).max() <= 1e-6 * np.abs(ref).max()
        bad = [k for k in sys.modules
               if k == "fastsparse" or k.startswith("fastsparse.")]
        assert not bad, bad
        print("ok")
    """)
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
