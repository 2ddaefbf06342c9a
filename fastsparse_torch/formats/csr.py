"""CSR sparse matrices (valued and binary) as dataclasses of torch tensors.

Counterpart of ``fastsparse/formats/csr.py``. CSR is a storage and
interchange format here, as in the reference: the kernels run on the
bucketed layouts built from it. ``rows`` caches the COO expansion of
``row_ptr``. Padding entries (``k >= n_valid``) sit at the tail and belong
to no row (``row_ptr[nrow] == n_valid``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coo import COO, BinaryCOO

__all__ = ["CSR", "BinaryCSR", "csr_from_scipy", "binary_csr_from_scipy"]


def _scipy_arrays(mat):
    m = mat.tocsr()
    m.sum_duplicates()
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int32), np.diff(m.indptr))
    return m, rows


def _i32(a, device):
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Valued CSR: row-sorted entries (columns ascending within a row when
    built by `convert.to_csr`)."""

    row_ptr: torch.Tensor  # int32[nrow + 1]
    cols: torch.Tensor  # int32[nnz_cap]
    vals: torch.Tensor  # dtype[nnz_cap]
    rows: torch.Tensor  # int32[nnz_cap], cached COO expansion
    shape: tuple
    n_valid: int

    @property
    def nnz(self) -> int:
        return self.n_valid

    @property
    def nnz_cap(self) -> int:
        return int(self.cols.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.nnz_cap, device=self.cols.device) < self.n_valid

    def to_coo(self) -> COO:
        return COO(rows=self.rows, cols=self.cols, vals=self.vals,
                   shape=self.shape, n_valid=self.n_valid, row_sorted=True)

    def todense(self) -> torch.Tensor:
        return self.to_coo().todense()

    def to_scipy(self):
        return self.to_coo().to_scipy().tocsr()

    @classmethod
    def from_scipy(cls, mat, dtype=None, device="cuda") -> "CSR":
        m, rows = _scipy_arrays(mat)
        vals = m.data if dtype is None else m.data.astype(dtype)
        return cls(
            row_ptr=_i32(m.indptr, device), cols=_i32(m.indices, device),
            vals=torch.as_tensor(vals, device=device), rows=_i32(rows, device),
            shape=tuple(m.shape), n_valid=int(m.nnz),
        )


@dataclasses.dataclass(frozen=True)
class BinaryCSR:
    """Binary CSR (values implicitly 1): indices only."""

    row_ptr: torch.Tensor  # int32[nrow + 1]
    cols: torch.Tensor  # int32[nnz_cap]
    rows: torch.Tensor  # int32[nnz_cap]
    shape: tuple
    n_valid: int

    @property
    def nnz(self) -> int:
        return self.n_valid

    @property
    def nnz_cap(self) -> int:
        return int(self.cols.shape[0])

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.nnz_cap, device=self.cols.device) < self.n_valid

    def to_coo(self) -> BinaryCOO:
        return BinaryCOO(rows=self.rows, cols=self.cols, shape=self.shape,
                         n_valid=self.n_valid, row_sorted=True)

    def with_values(self, dtype=torch.float32) -> CSR:
        return CSR(row_ptr=self.row_ptr, cols=self.cols,
                   vals=self.valid_mask().to(dtype), rows=self.rows,
                   shape=self.shape, n_valid=self.n_valid)

    def todense(self, dtype=torch.float32) -> torch.Tensor:
        return self.to_coo().todense(dtype)

    def to_scipy(self):
        return self.to_coo().to_scipy().tocsr()

    @classmethod
    def from_scipy(cls, mat, device="cuda") -> "BinaryCSR":
        m, rows = _scipy_arrays(mat)
        return cls(
            row_ptr=_i32(m.indptr, device), cols=_i32(m.indices, device),
            rows=_i32(rows, device), shape=tuple(m.shape), n_valid=int(m.nnz),
        )


def csr_from_scipy(mat, dtype=None, device="cuda") -> CSR:
    return CSR.from_scipy(mat, dtype=dtype, device=device)


def binary_csr_from_scipy(mat, device="cuda") -> BinaryCSR:
    return BinaryCSR.from_scipy(mat, device=device)
