"""The four mono-path kernels, the dense-column kernel and the X encoder:
CUDA wrappers and their plain PyTorch twins.

Each public function here but `quant3_encode` is the counterpart of one
Pallas TPU kernel in ``fastsparse/ops/pallas/bsr_spmm.py``; `quant3_encode`
replaces the XLA ops around two of them (the narrow mono planes and the
dense-column planes). On a CUDA tensor it launches the
hand-written sm_90a kernel from ``csrc/bsr_spmm.cu`` (``densecols_spmm``:
``csrc/densecols_spmm.cu``; built at first use,
`_build.load_library`) and adds one to its entry in `launches`; a build or
launch failure raises. On a CPU tensor it runs the ``*_plain`` version: the
same arithmetic in eager torch ops, which is also the on-card oracle.

Interface differences from the reference kernels:

* `colmax` returns ``(1, Npad)``; the Pallas kernel returns ``(8, Npad)``
  with eight equal rows (a TPU sublane tile).
* `quant3_planes` writes its planes K-major, ``(nj·3·NB, K)``: the
  transpose of the reference's ``(K, nj·3·NB)``, and `mono_panel_spmm`
  and `mono_group_spmm` take X planes in that layout (the narrow planes
  too, transposed by the X prep): s8 ``wgmma`` reads B only K-major.
* `mono_panel_spmm` takes ``strip_ptr`` (item range of each output strip,
  derived from the ascending ``strip_ids``) in place of ``strip_ids`` and
  ``first``: a strip's first item is the one at ``strip_ptr[s]``. The TPU
  grid runs in order and sets/accumulates by ``first``; CUDA blocks run
  concurrently, so each block owns a strip and walks its items in order.
* `mono_group_spmm` reads the un-halo'd X planes: strip ``s`` starts at
  slab ``windows[s // group]·stride + start_rel[s]``. The reference reads
  a halo'd copy with the overlapping windows laid out back to back
  (``bsr_ops._halo_impl``); the addressed values are the same.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import tracing

__all__ = [
    "launches",
    "reset_launches",
    "colmax",
    "colmax_plain",
    "quant3_planes",
    "quant3_planes_plain",
    "quant3_encode",
    "quant3_encode_plain",
    "mono_panel_spmm",
    "mono_panel_spmm_plain",
    "mono_group_spmm",
    "mono_group_spmm_plain",
    "densecols_spmm",
    "densecols_spmm_plain",
]

# kernel launches per wrapper (CUDA path only; the plain versions never count)
launches = {"colmax": 0, "quant3_planes": 0, "mono_panel": 0, "mono_group": 0,
            "densecols": 0, "encode_colmax": 0, "encode_planes": 0}

# x ≈ (q0·2^16 + q1·2^8 + q2)·s with s = colmax/(127·2^16)
S_UNIT = 1.0 / (127.0 * 65536.0)

# f64 working set per chunk of the plain mono versions (exact integer dots
# through a float64 matmul: every partial sum of int8 products stays far
# below 2^53)
_PLAIN_CHUNK_BYTES = 256 * 2**20


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, t, dtype, ndim, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.ndim != ndim:
        raise TypeError(
            f"{name}: expected {dtype} with {ndim} dims, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.is_cuda and not t.is_contiguous():
        raise ValueError(f"{name}: CUDA kernels take contiguous tensors")


def _launch(name, fn, *args, counts=launches):
    """Call one C launcher on the current stream; raise on a refused
    launch (a refused launch never runs, and a synchronize would not
    report it). Counts the launch in ``counts[name]``. The stream handle
    is read raw (``current_stream().cuda_stream`` without the Stream
    object): a few µs of host time per launch that the tile kernels' short
    launches feel. While tracing is on, the launch is also one device op
    of the innermost open span. A launcher returns, before any launch, -1
    for a shape its body does not take (`NotImplementedError`), and the s8
    engine -2 for a TMA map `cuTensorMapEncodeTiled` refused and -3 for a
    ring the card's shared memory cannot hold (`RuntimeError`)."""
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    rc = fn(*args, stream)
    if rc == -1:
        raise NotImplementedError(
            f"{name}: the kernel's body does not take this shape (see its "
            "launcher's shape rules)")
    if rc == -2:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled refused a map")
    if rc == -3:
        raise RuntimeError(f"{name}: the TMA ring does not fit shared memory")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    counts[name] += 1
    tracing.count()


def _library_for(t):
    if t.is_cuda:
        from ._build import load_library

        return load_library()
    if t.device.type != "cpu":
        raise NotImplementedError(f"no kernel for device {t.device}")
    return None


# ----------------------------------------------------------------- colmax
def colmax_plain(x):
    return x.abs().amax(dim=0, keepdim=True)


def colmax(x):
    """Per-column max|x| of f32 ``(K, Npad)`` -> f32 ``(1, Npad)``.

    Replaces ``bsr_spmm.py:colmax_pallas``. Exact by nature (a max)."""
    _check("colmax.x", x, torch.float32, 2)
    lib = _library_for(x)
    if lib is None:
        return colmax_plain(x)
    K, N = x.shape
    out = torch.zeros((1, N), dtype=torch.float32, device=x.device)
    tracing.count()
    _launch("colmax", lib.fs_colmax, _ptr(x), K, N, _ptr(out))
    return out


# ----------------------------------------------------------------- quant3
def quant3_planes_plain(x, sinv, *, n_block: int):
    K, Npad = x.shape
    nj = Npad // n_block
    i = torch.round(x * sinv).to(torch.int32)
    q2 = ((i + 128) & 255) - 128
    i1 = (i - q2) >> 8
    q1 = ((i1 + 128) & 255) - 128
    q0 = (i1 - q1) >> 8
    planes = torch.stack(
        [q.reshape(K, nj, n_block) for q in (q0, q1, q2)], dim=2
    )
    return planes.reshape(K, nj * 3 * n_block).to(torch.int8).t().contiguous()


def quant3_planes(x, sinv, *, n_block: int):
    """f32 ``(K, Npad)`` and per-column ``1/scale`` f32 ``(1, Npad)`` ->
    int8 ``(nj·3·NB, K)`` radix-256 planes, K-major: row
    ``j·3·NB + p·NB + c`` is plane ``p`` of column ``j·NB + c`` (the
    reference's lanes ``[q0_j | q1_j | q2_j]`` per ``n_block``-wide block
    ``j``, transposed).

    Replaces ``bsr_spmm.py:quant3_planes_pallas``: ``i = round(x·sinv)``
    (half to even), ``q2 = ((i+128)&255)-128``, ``i1 = (i-q2)>>8``, and the
    same carry again for q1 and q0. Bit-exact with the reference's planes
    transposed."""
    _check("quant3.x", x, torch.float32, 2)
    _check("quant3.sinv", sinv, torch.float32, 2, x.device)
    K, Npad = x.shape
    if Npad % n_block or tuple(sinv.shape) != (1, Npad):
        raise ValueError(
            f"quant3: Npad={Npad} must be a multiple of n_block={n_block} "
            f"and sinv (1, Npad), got {tuple(sinv.shape)}"
        )
    lib = _library_for(x)
    if lib is None:
        return quant3_planes_plain(x, sinv, n_block=n_block)
    out = torch.empty((3 * Npad, K), dtype=torch.int8, device=x.device)
    _launch(
        "quant3_planes", lib.fs_quant3, _ptr(x), _ptr(sinv), K, Npad,
        n_block, _ptr(out),
    )
    return out


# ----------------------------------------------------------------- encode
def quant3_encode_plain(x, rows=None, *, k_rows: int, n_pad: int, n_out: int):
    if rows is not None:
        x = x[rows.long()]
    elif x.shape[0] > k_rows:
        x = x[:k_rows]
    ncol, N = x.shape
    x = F.pad(x, (0, n_pad - N, 0, k_rows - ncol))
    m = x.abs().amax(dim=0, keepdim=True)
    s = torch.where(m > 0, m, 1.0) * S_UNIT
    i = torch.round(x * (1.0 / s)).to(torch.int32)
    q2 = ((i + 128) & 255) - 128
    i1 = (i - q2) >> 8
    q1 = ((i1 + 128) & 255) - 128
    q0 = (i1 - q1) >> 8
    qs = [q.to(torch.int8) for q in (q0, q1, q2)]
    if n_out > 3 * n_pad:
        qs.append(x.new_zeros((k_rows, n_out - 3 * n_pad), dtype=torch.int8))
    return torch.cat([q.t() for q in qs]), s


def quant3_encode(x, rows=None, *, k_rows: int, n_pad: int, n_out: int):
    """Radix-256 int8 planes of X's rows with their per-column scale:
    int8 ``(n_out, k_rows)`` K-major (row ``p·n_pad + c`` is plane ``p``
    of column ``c``, rows ``3·n_pad`` to ``n_out`` zero) and f32 ``(1,
    n_pad)`` ``s``. Row ``k`` of the encoded operand is ``x[rows[k]]``
    (``rows`` int32 ``(k_rows,)``), or ``x[k]`` without ``rows`` (zero
    past ``x``'s rows, which past ``k_rows`` are not read); its columns
    past ``x``'s up to ``n_pad`` are zero. ``s = where(m > 0, m, 1) ·
    S_UNIT`` from the column max ``m`` of ``|x|``, ``i = round(x · (1 /
    s))`` (half to even) and the radix carries, as
    `quant3_planes` (the reference's ``bsr_ops._quant3_carry``).

    Replaces the reference's XLA ops of the narrow mono planes
    (``bsr_ops._quant3_narrow``: ``n_pad = nq``, ``n_out = nb``) and of the
    dense-column planes (``n_pad = N``, ``n_out = 3N``, ``rows`` the
    column ids). On the card: a zero fill and two launches,
    ``encode_colmax`` and ``encode_planes``, reading ``x`` in place
    through its strides; bit-equal to the plain version, the torch ops the
    CPU runs (the gather, the pad, the carry, the casts and the
    concatenation)."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
            or x.ndim != 2:
        raise TypeError("quant3_encode.x: expected a 2-D float32 tensor")
    N = x.shape[1]
    if n_pad < N or n_out < 3 * n_pad:
        raise ValueError(
            f"quant3_encode: n_pad={n_pad} under N={N} or n_out={n_out} "
            f"under 3·n_pad")
    if rows is not None:
        _check("quant3_encode.rows", rows, torch.int32, 1, x.device)
        if rows.numel() != k_rows:
            raise ValueError("quant3_encode: rows must hold k_rows ids")
    lib = _library_for(x)
    if lib is None:
        return quant3_encode_plain(x, rows, k_rows=k_rows, n_pad=n_pad,
                                   n_out=n_out)
    dev = x.device
    k_x = k_rows if rows is not None else min(x.shape[0], k_rows)
    ld, cs = x.stride()
    mbits = torch.zeros((n_pad,), dtype=torch.int32, device=dev)
    tracing.count()
    out = torch.empty((n_out, k_rows), dtype=torch.int8, device=dev)
    s = torch.empty((1, n_pad), dtype=torch.float32, device=dev)
    _launch("encode_colmax", lib.fs_encode_colmax, _ptr(x), _ptr(rows), k_x,
            N, ld, cs, _ptr(mbits))
    _launch("encode_planes", lib.fs_encode_planes, _ptr(x), _ptr(rows),
            _ptr(mbits), k_x, N, ld, cs, k_rows, n_pad, n_out, _ptr(out),
            _ptr(s))
    tracing.count(1, "encode_kernel")
    return out, s


# ------------------------------------------------------------------ mono
def _item_dots(panels, x, row0):
    """Exact s32 dots ``panels[i] @ x[row0[i] : row0[i]+PK]`` as f32
    ``(ni, TM, lanes)`` (int32 -> f32 round to nearest, as the kernels)."""
    ni, TM, PK = panels.shape
    lanes = x.shape[1]
    out = torch.empty((ni, TM, lanes), dtype=torch.float32, device=x.device)
    per_item = 8 * (PK * lanes + TM * PK + TM * lanes)
    step = max(1, _PLAIN_CHUNK_BYTES // max(per_item, 1))
    ar = torch.arange(PK, device=x.device)
    for a in range(0, ni, step):
        b = min(a + step, ni)
        xs = x[row0[a:b, None] + ar[None, :]].to(torch.float64)
        d = torch.bmm(panels[a:b].to(torch.float64), xs)
        out[a:b] = d.to(torch.float32)
    return out


def _fold_i8w(d3, scale, n_block):
    """``((d0·65536 + d1·256) + d2)·s`` over ``[q0_j|q1_j|q2_j]`` lanes."""
    n, TM, L = d3.shape
    nj = L // (3 * n_block)
    d = d3.reshape(n, TM, nj, 3, n_block)
    y = (d[:, :, :, 0] * 65536.0 + d[:, :, :, 1] * 256.0) + d[:, :, :, 2]
    return y.reshape(n, TM, nj * n_block) * scale.reshape(1, 1, -1)


def mono_panel_spmm_plain(
    window, strip_ptr, start_rel, panels, x, *, tile_m, tile_k, width,
    win_slabs, n_block, fold, out_rows, scale=None,
):
    TM = tile_m
    n_strips = out_rows // TM
    counts = strip_ptr[1:] - strip_ptr[:-1]
    strip_of = torch.repeat_interleave(
        torch.arange(n_strips, device=x.device), counts.long()
    )
    row0 = (window.long() * win_slabs + start_rel.long()) * tile_k
    d = _item_dots(panels, x.t(), row0)
    if fold == "i8w":
        d = _fold_i8w(d, scale, n_block)
    n_out = d.shape[2]
    y = torch.zeros((n_strips, TM, n_out), dtype=torch.float32, device=x.device)
    # set on each strip's first item, then add the later items in order
    pos = torch.arange(d.shape[0], device=x.device) - strip_ptr.long()[strip_of]
    for k in range(int(counts.max()) if counts.numel() else 0):
        sel = pos == k
        if k == 0:
            y[strip_of[sel]] = d[sel]
        else:
            y[strip_of[sel]] += d[sel]
    return y.reshape(out_rows, n_out)


def mono_panel_spmm(
    window, strip_ptr, start_rel, panels, x, *, tile_m, tile_k, width,
    win_slabs, n_block, fold, out_rows, scale=None,
):
    """``Y = A @ X`` for a MonoPanelBucket: f32 ``(out_rows, n_out)``.

    Replaces ``bsr_spmm.py:mono_panel_spmm`` in its two int8 modes:

    * ``fold="i8w"``: ``x`` int8 ``(nj·3·NB, K)`` K-major radix planes (as
      `quant3_planes` writes them) and ``scale`` f32 ``(1, Npad)``; one s32
      dot per item over all 3·NB lanes of a block, folded
      ``((d0·65536 + d1·256) + d2)·s``.
    * ``fold=False``: narrow int8 ``x`` ``(nb, K)``, K-major; the raw s32
      dot as f32 (the radix fold runs outside, `bsr_ops._fold_narrow_q`).

    Item ``i`` reads X rows from ``(window[i]·win_slabs + start_rel[i])·TK``
    for ``width·TK`` rows; strip ``s`` owns items
    ``[strip_ptr[s], strip_ptr[s+1])`` and sums them in that order. On the
    card, TM >= 64 with ``width·tile_k`` a multiple of 128 runs the s8
    tensor-core engine (TMA ring + ``wgmma``; narrow lanes of 32, 64, 96 or
    128, K a multiple of 16 rows, 16-byte aligned operands), other shapes
    the dp4a body; both are bit-exact with the plain version."""
    if fold not in ("i8w", False):
        raise NotImplementedError(
            f"mono_panel_spmm fold={fold!r}: only 'i8w' and the narrow int8 "
            "mode are ported (the other folds are slice 3b)"
        )
    dev = x.device
    for nm, t in (("window", window), ("strip_ptr", strip_ptr),
                  ("start_rel", start_rel)):
        _check(f"mono_panel.{nm}", t, torch.int32, 1, dev)
    _check("mono_panel.panels", panels, torch.int8, 3, dev)
    _check("mono_panel.x", x, torch.int8, 2, dev)
    ni, TM, PK = panels.shape
    if TM != tile_m or PK != width * tile_k or out_rows % TM:
        raise ValueError("mono_panel: panels/out_rows disagree with tile sizes")
    if strip_ptr.numel() != out_rows // TM + 1 or window.numel() != ni:
        raise ValueError("mono_panel: item arrays disagree with panels")
    L, K_rows = x.shape  # K-major planes
    if K_rows % (win_slabs * tile_k):
        raise ValueError("mono_panel: x must hold whole X windows of rows")
    if fold == "i8w":
        _check("mono_panel.scale", scale, torch.float32, 2, dev)
        Npad = L // 3
        if L != 3 * Npad or Npad % n_block or scale.numel() != Npad:
            raise ValueError("mono_panel: i8w planes/scale disagree")
    lib = _library_for(x)
    if lib is None:
        return mono_panel_spmm_plain(
            window, strip_ptr, start_rel, panels, x, tile_m=tile_m,
            tile_k=tile_k, width=width, win_slabs=win_slabs,
            n_block=n_block, fold=fold, out_rows=out_rows, scale=scale,
        )
    if PK % 64 or (fold == "i8w" and n_block % 64) or tile_k % 4:
        raise NotImplementedError(
            "mono_panel CUDA kernel needs width·tile_k and n_block "
            "multiples of 64 and tile_k a multiple of 4"
        )
    if panels.data_ptr() % 4 or x.data_ptr() % 4:
        raise ValueError("mono_panel: panels and x must be 4-byte aligned")
    n_out = L // 3 if fold == "i8w" else L
    out = torch.empty((out_rows, n_out), dtype=torch.float32, device=dev)
    _launch(
        "mono_panel", lib.fs_mono_panel, _ptr(window), _ptr(strip_ptr),
        _ptr(start_rel), _ptr(panels), _ptr(x), _ptr(scale), _ptr(out),
        ni, out_rows // TM, TM, tile_k, PK, win_slabs, L, K_rows, n_out,
        n_block, 1 if fold == "i8w" else 0,
    )
    return out


def mono_group_spmm_plain(
    windows, start_rel, panels, x, *, tile_m, tile_k, width, stride, group,
):
    ns = panels.shape[0]
    s = torch.arange(ns, device=x.device)
    row0 = (windows.long()[s // group] * stride + start_rel.long()) * tile_k
    return _item_dots(panels, x.t(), row0).reshape(ns * tile_m, x.shape[0])


def mono_group_spmm(
    windows, start_rel, panels, x, *, tile_m, tile_k, width, stride, group,
):
    """``Y = A @ X`` for the narrow halo layout (a MonoGroupBucket with
    one item per strip): f32 ``(ns·TM, nb)`` raw s32 dots of int8 panels
    against narrow int8 planes ``x`` ``(nb, K)``, K-major (as
    `bsr_ops._quant3_narrow` writes them).

    Replaces ``bsr_spmm.py:mono_group_spmm`` in its halo narrow mode
    (fold=False, int8). ``group`` is only an index grouping here: strip
    ``s`` reads X rows from ``(windows[s // group]·stride +
    start_rel[s])·TK`` of the un-halo'd planes; every output row is
    written once. On the card, TM a multiple of 64 with ``width·tile_k`` a
    multiple of 128 runs the s8 tensor-core engine (TMA ring + ``wgmma``
    m64n{nb}k32; nb of 32, 64, 96 or 128 lanes, K a multiple of 16 rows,
    16-byte aligned operands), other shapes (TM 8, 32) the dp4a body; both
    are bit-exact with the plain version."""
    dev = x.device
    _check("mono_group.windows", windows, torch.int32, 1, dev)
    _check("mono_group.start_rel", start_rel, torch.int32, 1, dev)
    _check("mono_group.panels", panels, torch.int8, 3, dev)
    _check("mono_group.x", x, torch.int8, 2, dev)
    ns, TM, PK = panels.shape
    if TM != tile_m or PK != width * tile_k or ns % group:
        raise ValueError("mono_group: panels disagree with tile sizes/group")
    if start_rel.numel() != ns or windows.numel() != ns // group:
        raise ValueError("mono_group: index arrays disagree with panels")
    nb, K_rows = x.shape  # K-major planes
    if K_rows % tile_k or K_rows < PK:
        raise ValueError(
            f"mono_group: x must be K-major (nb, K) planes of whole X slabs, "
            f"got {tuple(x.shape)} for tile_k={tile_k}, width={width}"
        )
    lib = _library_for(x)
    if lib is None:
        return mono_group_spmm_plain(
            windows, start_rel, panels, x, tile_m=tile_m, tile_k=tile_k,
            width=width, stride=stride, group=group,
        )
    if PK % 64 or tile_k % 4:
        raise NotImplementedError(
            "mono_group CUDA kernel needs width·tile_k a multiple of 64 and "
            "tile_k a multiple of 4"
        )
    if panels.data_ptr() % 4 or x.data_ptr() % 4:
        raise ValueError("mono_group: panels and x must be 4-byte aligned")
    out = torch.empty((ns * TM, nb), dtype=torch.float32, device=dev)
    _launch(
        "mono_group", lib.fs_mono_group, _ptr(windows), _ptr(start_rel),
        _ptr(panels), _ptr(x), _ptr(out), ns, TM, tile_k, PK, stride, group,
        nb, K_rows,
    )
    return out


# ------------------------------------------------------------- densecols
def densecols_spmm_plain(block, q3t, s):
    nrow, D = block.shape
    N = q3t.shape[0] // 3
    qd = q3t.t().to(torch.float64)
    out = torch.empty((nrow, N), dtype=torch.float32, device=block.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (8 * max(D + 3 * N, 1)))
    for a in range(0, nrow, step):
        b = min(a + step, nrow)
        # exact integer dots: float64 holds every partial sum of int8 products
        d = (block[a:b].to(torch.float64) @ qd).to(torch.float32)
        out[a:b] = (
            (d[:, :N] * 65536.0 + d[:, N : 2 * N] * 256.0) + d[:, 2 * N :]
        ) * s
    return out


def densecols_spmm(block, q3t, s):
    """``Y = block @ X_sel`` for a `DenseCols` block: f32 ``(nrow, N)``.

    Replaces ``bsr_spmm.py:densecols_spmm_pallas``. ``block`` int8
    ``(nrow, D)`` 0/1 cells; ``q3t`` int8 ``(3N, D)``, the radix-256 planes
    of the selected X rows as k-contiguous rows (row ``p·N + n`` is plane
    ``p`` of column ``n``: the transpose of the reference's ``[q0|q1|q2]``,
    as `ops.spmm.densecols_planes` builds it); ``s`` f32 ``(1, N)`` scale.
    Three exact s32 dots per output, folded ``((d0·65536 + d1·256) + d2)·s``
    (bit-exact with the reference). Differences from the Pallas kernel: any
    ``nrow``, ``D`` and ``N`` (it wants 128-multiples and a row count its
    row panel divides), the transposed planes, and ``s`` is ``(1, N)``, not
    eight equal rows. On the card, N >= 9 with ``D % 16 == 0`` and 16-byte
    aligned operands runs the s8 tensor-core engine (TMA ring +
    ``wgmma``), N <= 8 and ragged D the ``mma.sync`` body."""
    dev = block.device
    _check("densecols.block", block, torch.int8, 2)
    _check("densecols.q3t", q3t, torch.int8, 2, dev)
    _check("densecols.s", s, torch.float32, 2, dev)
    nrow, D = block.shape
    N = q3t.shape[0] // 3
    if q3t.shape[1] != D or q3t.shape[0] != 3 * N or tuple(s.shape) != (1, N):
        raise ValueError(
            f"densecols: block {tuple(block.shape)}, q3t {tuple(q3t.shape)} "
            f"and s {tuple(s.shape)} disagree"
        )
    lib = _library_for(block)
    if lib is None:
        return densecols_spmm_plain(block, q3t, s)
    out = torch.empty((nrow, N), dtype=torch.float32, device=dev)
    vec = int(D % 16 == 0 and block.data_ptr() % 16 == 0
              and q3t.data_ptr() % 16 == 0)
    _launch("densecols", lib.fs_densecols, _ptr(block), _ptr(q3t), _ptr(s),
            _ptr(out), nrow, D, N, vec)
    return out
