"""The two fp64-class ELL gather kernels: CUDA wrappers and their plain
PyTorch twins.

Counterparts of ``ell_bucket_spmm_dd`` (#12, unit values) and
``ell_bucket_spmm_dd_valued`` (#13, ``DdEll`` value planes) in
``fastsparse/ops/pallas/ell_spmm.py``. On a CUDA tensor each public
function launches the hand-written sm_90a kernel from ``csrc/ell_dd.cu``
(built at first use, `_build.load_library`) and adds one to its entry in
`launches`; a build or launch failure raises. On a CPU tensor it runs the
``*_plain`` version: the same per-slot double-word arithmetic in eager
torch ops on f32 tensors, vectorised over rows and lanes with a Python
loop over the K slots, which is also the on-card oracle. The plain
versions use only ``+``, ``-`` and ``*`` (no fused op), so they are strict
f32 on every device and bit-equal to the kernels.

Both take ``x2``, the f64 operand as one f32 panel of ``2·k_rows`` rows:
its hi plane in rows ``[0, k_rows)`` and its lo plane in rows
``[k_rows, 2·k_rows)``; every column must be below ``k_rows``. They return
``(hi, lo)``, f32 ``(nb, x2.shape[1])`` each. Interface difference from the
reference kernels: no ``n_block``; one launch covers all of ``x2``'s lanes
and the outputs have the same lane count.
"""
from __future__ import annotations

import torch

from .bsr_spmm import _check, _launch, _library_for, _ptr

__all__ = [
    "launches",
    "reset_launches",
    "ell_bucket_spmm_dd",
    "ell_bucket_spmm_dd_plain",
    "ell_bucket_spmm_dd_valued",
    "ell_bucket_spmm_dd_valued_plain",
]

# kernel launches per wrapper (CUDA path only; the plain versions never count)
launches = {"ell_bucket_dd": 0, "ell_bucket_dd_valued": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _split4097(a):
    """Dekker's split: (hi, lo) with hi + lo == a, 12 bits each."""
    c = a * 4097.0
    hi = c - (c - a)
    return hi, a - hi


def _dd_rows(cols, vh, vl, x2):
    """(hi, lo) per row: one TwoSum chain over the slots in order (unit
    values when ``vh`` is None), as `_body_unit_dd` / `_body_dd_valued`."""
    nb, K = cols.shape
    k_rows = x2.shape[0] // 2
    idx = cols.long()
    hi = torch.zeros((nb, x2.shape[1]), dtype=torch.float32, device=x2.device)
    lo = torch.zeros_like(hi)
    for k in range(K):
        c = idx[:, k]
        xh, xl = x2[c], x2[k_rows + c]
        if vh is None:
            s = hi + xh
            bb = s - hi
            err = (hi - (s - bb)) + (xh - bb)
            hi = s
            lo = lo + (err + xl)
            continue
        v_h, v_l = vh[:, k, None], vl[:, k, None]
        vhh, vhl = _split4097(v_h)
        xhh, xhl = _split4097(xh)
        p1 = v_h * xh
        perr = vhl * xhl + (vhl * xhh + (vhh * xhl + (vhh * xhh - p1)))
        cross = v_h * xl + v_l * xh
        s = hi + p1
        bb = s - hi
        e = (hi - (s - bb)) + (p1 - bb)
        hi = s
        lo = lo + (e + (perr + cross))
    return hi, lo


def _check_x2(name, cols, x2):
    _check(f"{name}.cols", cols, torch.int32, 2, x2.device)
    _check(f"{name}.x2", x2, torch.float32, 2)
    if x2.shape[0] % 2:
        raise ValueError(f"{name}: x2 must stack two planes of equal height")


def ell_bucket_spmm_dd_plain(cols, x2):
    return _dd_rows(cols, None, None, x2)


def ell_bucket_spmm_dd(cols, x2):
    """One unit-values bucket's double-word product: ``(hi, lo)``.

    Replaces ``ell_spmm.py:ell_bucket_spmm_dd``. ``cols`` int32 ``(nb,
    K)`` with padding at a sentinel column whose rows of ``x2`` are zero in
    both planes."""
    _check_x2("ell_bucket_dd", cols, x2)
    lib = _library_for(x2)
    if lib is None:
        return ell_bucket_spmm_dd_plain(cols, x2)
    return _launch_dd("ell_bucket_dd", lib, cols, None, None, x2)


def ell_bucket_spmm_dd_valued_plain(cols, vh, vl, x2):
    return _dd_rows(cols, vh, vl, x2)


def ell_bucket_spmm_dd_valued(cols, vh, vl, x2):
    """One valued bucket's double-word product: ``(hi, lo)``.

    Replaces ``ell_spmm.py:ell_bucket_spmm_dd_valued``. ``vh``/``vl`` f32
    ``(nb, K)``: the value planes of a `formats.ell.DdEll` (padding 0)."""
    _check_x2("ell_bucket_dd_valued", cols, x2)
    for name, v in (("vh", vh), ("vl", vl)):
        _check(f"ell_bucket_dd_valued.{name}", v, torch.float32, 2, x2.device)
        if v.shape != cols.shape:
            raise ValueError(f"ell_bucket_dd_valued: {name} and cols disagree")
    lib = _library_for(x2)
    if lib is None:
        return ell_bucket_spmm_dd_valued_plain(cols, vh, vl, x2)
    return _launch_dd("ell_bucket_dd_valued", lib, cols, vh, vl, x2)


def _launch_dd(name, lib, cols, vh, vl, x2):
    nb, K = cols.shape
    hi = torch.empty((nb, x2.shape[1]), dtype=torch.float32, device=x2.device)
    lo = torch.empty_like(hi)
    _launch(name, lib.fs_ell_dd, _ptr(cols), _ptr(vh), _ptr(vl), _ptr(x2),
            _ptr(hi), _ptr(lo), nb, K, x2.shape[0] // 2, x2.shape[1],
            int(vh is not None), counts=launches)
    return hi, lo
