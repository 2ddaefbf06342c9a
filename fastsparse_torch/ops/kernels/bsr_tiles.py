"""The three tile-layout kernels: CUDA wrappers and their plain PyTorch
twins.

Each public function is the counterpart of one Pallas TPU kernel in
``fastsparse/ops/pallas/bsr_spmm.py``: `bucket_spmm` (tile buckets),
`panel_spmm` (class panels) and `bucket_spmv` (tile-bucket SpMV). On a
CUDA tensor it launches the hand-written sm_90a kernel from
``csrc/bsr_tiles.cu`` (built at first use, `_build.load_library`) and adds
one to its entry in `launches`; a build or launch failure raises. On a CPU
tensor it runs the ``*_plain`` version: the same plane arithmetic in eager
torch ops (dots in float64, each plane's dot rounded to f32, the planes
summed in the kernels' order), which is also the on-card oracle.

`bucket_spmm` and `panel_spmm` have two bodies on the card, and each mode
goes to exactly one of them:

* the tensor-core body (bf16 ``mma.sync``, live tile columns only) takes
  the exact-bf16 modes: bucket ``planes=3`` and ``planes=1`` with bf16 X,
  panel ``fold="f32"`` (int8 or bf16 panels, f32 X split in the kernel)
  and the narrow panels (int8 or bf16 panels, bf16 X). Its launcher
  (``launch_mma`` in ``csrc/bsr_tiles.cu``) holds its shape rules and
  refuses other shapes before any launch, which raises
  `NotImplementedError`;
* the scalar f32 body takes the f32-valued modes: f32 tiles or panels × f32
  X and bf16 tiles × f32 X.

The kernels sum in another order than the TPU's MXU and the plain
versions; their bar against the plain versions is max|d|/max|ref| <= 1e-6.

Interface differences from the reference kernels: the wrappers take one
bucket part's arrays as they are (the reference's chunk padding is added
to the output by the caller, `bsr_ops._pad_part`), `panel_spmm` takes the
first X row of its window (``row_base``) in place of ``x_rows``/``seg``,
and `bucket_spmv` returns f32 ``(ns, TM)`` for f32 ``x`` as the
reference does.
"""
from __future__ import annotations

import torch

from ... import tracing
from .bsr_spmm import _check, _launch, _library_for, _ptr

__all__ = [
    "launches",
    "reset_launches",
    "bucket_spmm",
    "bucket_spmm_plain",
    "panel_spmm",
    "panel_spmm_plain",
    "bucket_spmv",
    "bucket_spmv_plain",
]

# kernel launches per wrapper (CUDA path only; the plain versions never count)
launches = {"bucket_spmm": 0, "panel_spmm": 0, "bucket_spmv": 0}

# f64 working set per chunk of the plain versions
_PLAIN_CHUNK_BYTES = 256 * 2**20
_DTYPE_CODE = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
# (tile, x dtype, planes) and (panel, x dtype, fold) modes with a body
_BUCKET_MODES = frozenset({(torch.bfloat16, torch.bfloat16, 3),
                           (torch.bfloat16, torch.bfloat16, 1),
                           (torch.float32, torch.float32, 1),
                           (torch.bfloat16, torch.float32, 1)})
_PANEL_MODES = frozenset({(torch.int8, torch.float32, "f32"),
                          (torch.bfloat16, torch.float32, "f32"),
                          (torch.int8, torch.bfloat16, False),
                          (torch.bfloat16, torch.bfloat16, False),
                          (torch.float32, torch.float32, False)})


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _steps(per_item):
    """Strip slots per chunk of a plain version (``per_item`` f64 values
    each)."""
    return max(1, _PLAIN_CHUNK_BYTES // max(8 * per_item, 1))


def _split_rn(x):
    """f32 -> three bf16 planes by round-to-nearest casts (the fold "f32"
    split of the reference's panel body): x0 = bf16(x), x1 = bf16(x - x0),
    x2 = bf16(x - x0 - x1)."""
    x0 = x.to(torch.bfloat16)
    r1 = x - x0.to(torch.float32)
    x1 = r1.to(torch.bfloat16)
    x2 = (r1 - x1.to(torch.float32)).to(torch.bfloat16)
    return x0, x1, x2


def _fold3(d, n_block):
    """Fold ``[p0_j | p1_j | p2_j]`` lane blocks: (p0 + p1) + p2 per j."""
    lead = d.shape[:-1]
    d = d.reshape(*lead, -1, 3, n_block)
    return ((d[..., 0, :] + d[..., 1, :]) + d[..., 2, :]).reshape(*lead, -1)


# ------------------------------------------------------------ bucket_spmm
def bucket_spmm_plain(slab_ids, tiles, x, *, n_block, planes):
    ns, T, TM, TK = tiles.shape
    xc = x.shape[1]
    out = torch.empty((ns, TM, xc // planes), dtype=torch.float32,
                      device=x.device)
    ar = torch.arange(TK, device=x.device)
    step = _steps(T * TK * xc + TM * T * TK + TM * xc)
    for a in range(0, ns, step):
        b = min(a + step, ns)
        rows = (slab_ids[a:b].long()[:, :, None] * TK + ar).reshape(b - a, -1)
        xs = x[rows].to(torch.float64)  # (n, T·TK, xc)
        A = tiles[a:b].permute(0, 2, 1, 3).reshape(b - a, TM, T * TK)
        d = torch.bmm(A.to(torch.float64), xs).to(torch.float32)
        out[a:b] = _fold3(d, n_block) if planes == 3 else d
    return out.reshape(ns * TM, -1)


def bucket_spmm(slab_ids, tiles, x, *, n_block, planes):
    """One tile bucket's ``Y = A_b @ X``: f32 ``(ns·TM, Npad)``.

    Replaces ``bsr_spmm.py:bucket_spmm`` in its resident bodies:

    * ``planes=3`` (`_spmm_resident_body_wide`, "planes_n"): bf16 tiles
      and bf16 ``x`` ``(K, 3·Npad)`` holding the three mantissa-split X
      planes per ``n_block``-wide block, ``[x0_j | x1_j | x2_j]``. Each
      plane's sum over all the strip's tiles is kept apart and the three
      are added after the tile loop, (p0 + p1) + p2. Tensor-core body.
    * ``planes=1`` (`_spmm_resident_body`): ``Σ_t tile_t @ x[slab_t]``,
      bf16 tiles × bf16 narrow planes (tensor-core body), or f32 tiles (or
      bf16 ones promoted) × f32 ``x`` (scalar body).

    Strip slot ``i``'s tile ``t`` reads ``x`` rows ``slab_ids[i, t]·TK``
    on. Every product of bf16 operands is exact in f32."""
    dev = x.device
    _check("bucket_spmm.slab_ids", slab_ids, torch.int32, 2, dev)
    if not isinstance(tiles, torch.Tensor) or tiles.ndim != 4:
        raise TypeError("bucket_spmm.tiles: expected (ns, T, TM, TK) tiles")
    ns, T, TM, TK = tiles.shape
    xc = x.shape[1]
    if (tiles.dtype, x.dtype, planes) not in _BUCKET_MODES:
        raise NotImplementedError(
            f"bucket_spmm over {tiles.dtype} tiles, {x.dtype} X, "
            f"planes={planes}: the bitmask and planes_k bodies are slice 3b"
        )
    if tuple(slab_ids.shape) != (ns, T) or tiles.device != dev:
        raise ValueError("bucket_spmm: slab_ids/tiles disagree")
    if xc % (planes * n_block):
        raise ValueError("bucket_spmm: x lanes must be whole plane blocks")
    lib = _library_for(x)
    if lib is None:
        return bucket_spmm_plain(slab_ids, tiles, x, n_block=n_block,
                                 planes=planes)
    _check("bucket_spmm.tiles", tiles, tiles.dtype, 4, dev)
    _check("bucket_spmm.x", x, x.dtype, 2, dev)
    Npad = xc // planes
    out = torch.empty((ns * TM, Npad), dtype=torch.float32, device=dev)
    if ns and T:
        _launch("bucket_spmm", lib.fs_bucket_spmm, _ptr(slab_ids),
                _ptr(tiles), _ptr(x), _ptr(out), ns, T, TM, TK, xc, Npad,
                n_block, planes, _DTYPE_CODE[tiles.dtype],
                _DTYPE_CODE[x.dtype], counts=launches)
    elif ns:
        tracing.count()
        out.zero_()
    return out


# ------------------------------------------------------------- panel_spmm
def panel_spmm_plain(start_slab, panels, x, *, tile_k, fold, row_base=0):
    ns, TM, PK = panels.shape
    xc = x.shape[1]
    out = torch.empty((ns, TM, xc), dtype=torch.float32, device=x.device)
    ar = torch.arange(PK, device=x.device)
    step = _steps(PK * xc * (3 if fold else 1) + TM * PK + TM * xc)
    for a in range(0, ns, step):
        b = min(a + step, ns)
        rows = row_base + start_slab[a:b].long()[:, None] * tile_k + ar
        xs = x[rows]  # (n, PK, xc)
        A = panels[a:b].to(torch.float64)
        if fold == "f32":
            d0, d1, d2 = (torch.bmm(A, p.to(torch.float64)).to(torch.float32)
                          for p in _split_rn(xs))
            out[a:b] = (d0 + d1) + d2
        else:
            out[a:b] = torch.bmm(A, xs.to(torch.float64)).to(torch.float32)
    return out.reshape(ns * TM, xc)


def panel_spmm(start_slab, panels, x, *, tile_k, fold, row_base=0):
    """One panel bucket's ``Y = A_b @ X``: f32 ``(ns·TM, Npad)``.

    Replaces ``bsr_spmm.py:panel_spmm`` (`_panel_body`): strip slot ``i``'s
    ``(TM, PK)`` panel times ``x`` rows ``row_base + start_slab[i]·tile_k``
    on (``row_base`` windows a global X: the column-segmented callers).
    Modes:

    * ``fold="f32"``: int8 (or bf16) panels, f32 ``x``; each X value is
      split in-kernel into three bf16 planes by round-to-nearest casts, and
      the three dots are added (d0 + d1) + d2. Tensor-core body.
    * ``fold=False``: int8/bf16 panels × bf16 narrow planes (tensor-core
      body), or f32 panels × f32 ``x`` (scalar body): one dot.

    The pre-split fold (``fold=True``) and bitmask panels are slice 3b."""
    dev = x.device
    _check("panel_spmm.start_slab", start_slab, torch.int32, 1, dev)
    if not isinstance(panels, torch.Tensor) or panels.ndim != 3:
        raise TypeError("panel_spmm.panels: expected (ns, TM, PK) panels")
    ns, TM, PK = panels.shape
    if (panels.dtype, x.dtype, fold) not in _PANEL_MODES:
        raise NotImplementedError(
            f"panel_spmm over {panels.dtype} panels, {x.dtype} X, "
            f"fold={fold!r}: the pre-split fold and bitmask panels are "
            "slice 3b"
        )
    if start_slab.numel() != ns or PK % tile_k or panels.device != dev:
        raise ValueError("panel_spmm: start_slab/panels disagree")
    lib = _library_for(x)
    if lib is None:
        return panel_spmm_plain(start_slab, panels, x, tile_k=tile_k,
                                fold=fold, row_base=row_base)
    _check("panel_spmm.panels", panels, panels.dtype, 3, dev)
    _check("panel_spmm.x", x, x.dtype, 2, dev)
    xc = x.shape[1]
    out = torch.empty((ns * TM, xc), dtype=torch.float32, device=dev)
    if ns:
        _launch("panel_spmm", lib.fs_panel_spmm, _ptr(start_slab),
                _ptr(panels), _ptr(x), _ptr(out), ns, TM, tile_k, PK, xc,
                int(row_base), _DTYPE_CODE[panels.dtype],
                _DTYPE_CODE[x.dtype], int(fold == "f32"), counts=launches)
    return out


# ------------------------------------------------------------ bucket_spmv
def bucket_spmv_plain(slab_ids, tiles, x):
    ns, T, TM, TK = tiles.shape
    out = torch.empty((ns, TM), dtype=torch.float32, device=x.device)
    step = _steps(T * TM * TK + T * TK)
    for a in range(0, ns, step):
        b = min(a + step, ns)
        xs = x[slab_ids[a:b].long()].to(torch.float64)  # (n, T, TK)
        prod = tiles[a:b].to(torch.float64) * xs[:, :, None, :]
        out[a:b] = prod.sum(dim=(1, 3)).to(torch.float32)
    return out


def bucket_spmv(slab_ids, tiles, x):
    """One tile bucket's ``y_b = A_b @ x``: f32 ``(ns, TM)``.

    Replaces ``bsr_spmm.py:bucket_spmv`` (`_spmv_body`):
    ``y[i, r] = Σ_t Σ_c tiles[i, t, r, c] · x[slab_ids[i, t], c]`` with
    bf16 (0/1) or f32 tiles and f32 ``x`` ``(n_slabs, TK)``; the products
    are f32. The kernel reads 16-byte chunks: it takes TK a multiple of 32
    (as `build_bsr` makes it) and 16-byte aligned tiles and ``x``, and
    raises `NotImplementedError` on anything else."""
    dev = x.device
    _check("bucket_spmv.slab_ids", slab_ids, torch.int32, 2, dev)
    _check("bucket_spmv.x", x, torch.float32, 2, dev)
    if not isinstance(tiles, torch.Tensor) or tiles.ndim != 4:
        raise TypeError("bucket_spmv.tiles: expected (ns, T, TM, TK) tiles")
    if tiles.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"bucket_spmv over {tiles.dtype} tiles: bitmask tiles are "
            "slice 3b"
        )
    ns, T, TM, TK = tiles.shape
    if tuple(slab_ids.shape) != (ns, T) or x.shape[1] != TK:
        raise ValueError("bucket_spmv: slab_ids/tiles/x disagree")
    lib = _library_for(x)
    if lib is None:
        return bucket_spmv_plain(slab_ids, tiles, x)
    _check("bucket_spmv.tiles", tiles, tiles.dtype, 4, dev)
    if not T:
        tracing.count()
        return torch.zeros((ns, TM), dtype=torch.float32, device=dev)
    out = torch.empty((ns, TM), dtype=torch.float32, device=dev)
    if ns:  # the kernel writes every row
        _launch("bucket_spmv", lib.fs_bucket_spmv, _ptr(slab_ids),
                _ptr(tiles), _ptr(x), _ptr(out), ns, T, TM, TK,
                _DTYPE_CODE[tiles.dtype], counts=launches)
    return out
