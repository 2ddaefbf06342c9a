"""COO sparse matrices (valued and binary) as dataclasses of torch tensors.

Counterpart of ``fastsparse/formats/coo.py``. ``n_valid`` is the live entry
count; entries past it are padding (row = col = 0, value 0), as in the
reference, trailing (`pad_to`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["COO", "BinaryCOO", "coo_from_scipy", "binary_coo_from_scipy"]


def _index_tensor(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)


def _extra(cur: int, nnz_cap: int) -> int:
    if nnz_cap < cur:
        raise ValueError(f"cannot shrink capacity {cur} -> {nnz_cap}")
    return nnz_cap - cur


@dataclasses.dataclass(frozen=True)
class COO:
    """Valued COO matrix: entry ``k`` is ``(rows[k], cols[k]) = vals[k]``."""

    rows: torch.Tensor  # int32[nnz_cap]
    cols: torch.Tensor  # int32[nnz_cap]
    vals: torch.Tensor  # dtype[nnz_cap]
    shape: tuple
    n_valid: int
    # True = valid entries ascending by row, padding trailing
    row_sorted: bool = False

    @property
    def nnz(self) -> int:
        return self.n_valid

    @property
    def nnz_cap(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    @classmethod
    def from_arrays(cls, rows, cols, vals, shape, n_valid: Optional[int] = None,
                    row_sorted: bool = False, device="cuda"):
        rows = _index_tensor(rows, device)
        cols = _index_tensor(cols, device)
        vals = torch.as_tensor(np.asarray(vals), device=device)
        if n_valid is None:
            n_valid = int(rows.shape[0])
        return cls(rows=rows, cols=cols, vals=vals, shape=tuple(shape),
                   n_valid=n_valid, row_sorted=row_sorted)

    def pad_to(self, nnz_cap: int) -> "COO":
        """Grow capacity to ``nnz_cap`` with no-op padding entries (row =
        col = 0, value 0), trailing."""
        extra = _extra(self.nnz_cap, nnz_cap)
        if not extra:
            return self
        zi = self.rows.new_zeros(extra)
        return dataclasses.replace(
            self, rows=torch.cat([self.rows, zi]),
            cols=torch.cat([self.cols, zi]),
            vals=torch.cat([self.vals, self.vals.new_zeros(extra)]))

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.nnz_cap, device=self.rows.device) < self.n_valid

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.vals.device)
        vals = torch.where(self.valid_mask(), self.vals, 0)
        out.index_put_((self.rows.long(), self.cols.long()), vals,
                       accumulate=True)
        return out

    def to_scipy(self):
        import scipy.sparse as sp

        n = self.n_valid
        return sp.coo_matrix(
            (self.vals[:n].cpu().numpy(),
             (self.rows[:n].cpu().numpy(), self.cols[:n].cpu().numpy())),
            shape=self.shape,
        )


@dataclasses.dataclass(frozen=True)
class BinaryCOO:
    """Binary COO matrix (all values implicitly 1): the Macau/SMURFF
    side-information workload. Entry ``k`` is live iff ``k < n_valid``."""

    rows: torch.Tensor  # int32[nnz_cap]
    cols: torch.Tensor  # int32[nnz_cap]
    shape: tuple
    n_valid: int
    row_sorted: bool = False

    @property
    def nnz(self) -> int:
        return self.n_valid

    @property
    def nnz_cap(self) -> int:
        return int(self.rows.shape[0])

    @classmethod
    def from_arrays(cls, rows, cols, shape, n_valid: Optional[int] = None,
                    row_sorted: bool = False, device="cuda"):
        rows = _index_tensor(rows, device)
        cols = _index_tensor(cols, device)
        if n_valid is None:
            n_valid = int(rows.shape[0])
        return cls(rows=rows, cols=cols, shape=tuple(shape), n_valid=n_valid,
                   row_sorted=row_sorted)

    def pad_to(self, nnz_cap: int) -> "BinaryCOO":
        """Grow capacity to ``nnz_cap`` with padding entries (0, 0), which
        `valid_mask` excludes: every consumer masks them."""
        extra = _extra(self.nnz_cap, nnz_cap)
        if not extra:
            return self
        zi = self.rows.new_zeros(extra)
        return dataclasses.replace(self, rows=torch.cat([self.rows, zi]),
                                   cols=torch.cat([self.cols, zi]))

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.nnz_cap, device=self.rows.device) < self.n_valid

    def with_values(self, dtype=torch.float32) -> COO:
        """Materialize as a valued COO with unit values (padding -> 0)."""
        return COO(rows=self.rows, cols=self.cols,
                   vals=self.valid_mask().to(dtype), shape=self.shape,
                   n_valid=self.n_valid)

    def todense(self, dtype=torch.float32) -> torch.Tensor:
        return self.with_values(dtype).todense()

    def to_scipy(self):
        import scipy.sparse as sp

        n = self.n_valid
        return sp.coo_matrix(
            (np.ones(n, np.float64),
             (self.rows[:n].cpu().numpy(), self.cols[:n].cpu().numpy())),
            shape=self.shape,
        )


def _row_sorted(row) -> bool:
    return bool(np.all(np.diff(row) >= 0)) if row.size else True


def coo_from_scipy(mat, dtype=None, device="cuda") -> COO:
    """Build a :class:`COO` from any scipy.sparse matrix."""
    m = mat.tocoo()
    vals = m.data if dtype is None else m.data.astype(dtype)
    return COO.from_arrays(m.row, m.col, vals, m.shape,
                           row_sorted=_row_sorted(m.row), device=device)


def binary_coo_from_scipy(mat, device="cuda") -> BinaryCOO:
    m = mat.tocoo()
    return BinaryCOO.from_arrays(m.row, m.col, m.shape,
                                 row_sorted=_row_sorted(m.row), device=device)
