"""A plain float64 reference of ``A @ X`` for the f64 products' tests:
from a scipy matrix's (row, column, value) triples, a gather of X's rows,
a scale by the values and an ``index_add_`` into the output, in float64
PyTorch on any device. It uses nothing of either package: no JAX and no
kernel or layout of the port."""
import torch

__all__ = ["matmat", "rel"]


def matmat(m, X):
    """``m @ X`` in float64 on X's device; ``X`` (ncol,) or (ncol, N), of
    any float dtype (widened to float64 first)."""
    coo = m.tocoo()
    dev = X.device
    rows = torch.as_tensor(coo.row, device=dev).long()
    cols = torch.as_tensor(coo.col, device=dev).long()
    vals = torch.as_tensor(coo.data, device=dev).to(torch.float64)
    X = X.to(torch.float64)
    part = X[cols] * (vals if X.ndim == 1 else vals[:, None])
    Y = torch.zeros((m.shape[0],) + tuple(X.shape[1:]), dtype=torch.float64,
                    device=dev)
    return Y.index_add_(0, rows, part)


def rel(y, ref) -> float:
    """max|y - ref| / max|ref| in float64."""
    d = (y.to(torch.float64) - ref).abs().max()
    return float(d / ref.abs().max())
