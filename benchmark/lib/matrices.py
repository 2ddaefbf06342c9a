"""Synthetic matrix generators of the benchmark's configurations.

Copied from ``fastsparse_torch/bench/matrices.py`` (itself identical to the
JAX reference's ``fastsparse/bench/matrices.py``), so that the yardstick
does not change when the program's copy does: the same seed gives the same
scipy matrix. `banded` (the mono headline), `powerlaw` and `rmat`
(scale-free structure), `ecfp_like` (chemical fingerprints, the
Macau/SMURFF side information).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["powerlaw", "rmat", "banded", "ecfp_like"]


def powerlaw(nrow, ncol, nnz, seed=0, alpha=1.6, binary=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    r = (nrow * (rng.random(nnz) ** alpha)).astype(np.int64) % nrow
    c = (ncol * (rng.random(nnz) ** alpha)).astype(np.int64) % ncol
    v = np.ones(nnz, dtype) if binary else rng.standard_normal(nnz).astype(dtype)
    m = sp.coo_matrix((v, (r, c)), shape=(nrow, ncol))
    m.sum_duplicates()
    if binary:
        m.data[:] = 1.0
    return m.tocsr()


def rmat(scale, edge_factor=16, seed=0, a=0.57, b=0.19, c=0.19, binary=True,
         dtype=np.float32):
    """R-MAT/Kronecker graph (Graph500 parameters): 2^scale vertices,
    power-law degrees plus hierarchical community structure."""
    n = 1 << scale
    nnz = n * edge_factor
    rng = np.random.default_rng(seed)
    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    for lvl in range(scale):
        u = rng.random(nnz)
        # quadrant probabilities (a, b, c, d)
        go_right = (u >= a) & (u < a + b) | (u >= a + b + c)
        go_down = u >= a + b
        rows |= go_down.astype(np.int64) << lvl
        cols |= go_right.astype(np.int64) << lvl
    v = np.ones(nnz, dtype) if binary else rng.standard_normal(nnz).astype(dtype)
    m = sp.coo_matrix((v, (rows, cols)), shape=(n, n))
    m.sum_duplicates()
    if binary:
        m.data[:] = 1.0
    return m.tocsr()


def banded(n, bandwidth, seed=0, density=0.5, dtype=np.float32):
    """Random entries within a diagonal band — the clustered/blocked
    regime where tiled BSR approaches its bandwidth bound."""
    rng = np.random.default_rng(seed)
    nnz = int(n * bandwidth * density)
    r = rng.integers(0, n, nnz)
    off = rng.integers(-bandwidth // 2, bandwidth // 2 + 1, nnz)
    c = np.clip(r + off, 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(nnz).astype(dtype), (r, c)), shape=(n, n))
    m.sum_duplicates()
    return m.tocsr()


def ecfp_like(n_compounds, n_features, bits_per_compound=64, n_scaffolds=200,
              seed=0):
    """Synthetic chemical-fingerprint matrix (the Macau/SMURFF workload,
    SURVEY.md §1.1): compounds inherit most bits from a shared scaffold
    (community structure) plus private random bits."""
    rng = np.random.default_rng(seed)
    scaff_bits = [
        rng.integers(0, n_features, bits_per_compound)
        for _ in range(n_scaffolds)
    ]
    rows, cols = [], []
    share = int(bits_per_compound * 0.7)
    for i in range(n_compounds):
        s = scaff_bits[rng.integers(0, n_scaffolds)]
        own = rng.integers(0, n_features, bits_per_compound - share)
        bits = np.concatenate([rng.choice(s, share, replace=False), own])
        rows.append(np.full(bits.size, i))
        cols.append(bits)
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    m = sp.coo_matrix(
        (np.ones(r.size, np.float32), (r, c)), shape=(n_compounds, n_features)
    )
    m.sum_duplicates()
    m.data[:] = 1.0
    return m.tocsr()
