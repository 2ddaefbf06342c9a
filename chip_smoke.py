#!/usr/bin/env python3
"""Drive the port's main paths once on one NVIDIA GPU and check them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the fourteen CUDA kernels from the sources in
``fastsparse_torch/ops/kernels/csrc/`` (one nvcc per source, in parallel)
and then runs the phases below, phase 11 right after phase 4 (it reuses
config A's and config B's operators), phases 13 and 14 after phase 8 and
phase 12 after phase 10:

1. mono kernel phase: calls each mono-path kernel's wrapper on the card at
   the shapes the headline product gives it (banded 50,000 x 50,000,
   bandwidth 512, density 0.39, 0/1 values, N=128; SpMV; N=32) and holds it
   against its plain PyTorch version on the same tensors, exactly:
   colmax, quant3 (K-major planes), mono_panel (i8w N=128, narrow N=32)
   and mono_group (the halo layout, K-major narrow planes, N=1). Both must
   run the s8 tensor-core engine (by kernel name, torch.profiler);
   cuSPARSE's product is timed at N=128, N=32 and N=1, and its device
   time beside mono_panel's at N=128 and mono_group's at N=1; colmax's
   device time beside ``torch.linalg.vector_norm``'s.
   Before this phase, and before any torch.profiler session, the four
   mono products of phase 2 are timed by CUDA events; then the kernel
   bodies are checked by name (phase 5's densecols bodies, and the ELL
   bodies: ell_bucket runs the narrow body at N = 1 and 8 and the
   lane-split body at N = 128 in every mode, ell_sweep its own kernel,
   ell_bucket_smem its narrow body (``ell_smem_narrow_kernel``) at N = 1
   and 8 and ``ell_smem_kernel`` at N = 128; the dd gathers, one pair of
   kernels for both value forms, run the split kernel
   (``ell_dd_split_kernel``) on config 2-fp64's longest-row shape (8 x
   2,048, N=1) and on config B's longest unit rows (16 x 2,048, N = 1
   and 32), the kernel of one thread a chain (``ell_dd_rows_kernel``) on
   config 2-fp64's largest bucket (5,048 x 32, N=32) and on config B's
   largest unit bucket (18,864 x 32, N=32); each bit-exact, on random
   buckets of the main path's shapes).
2. mono main-path phase: with every launch count set to 0, ``operator(m,
   format="bsr", transpose=True, device="cuda")`` products through the
   public API: matmat at N=128 and matvec on the headline matrix,
   normal_matmat(X, reg=0.1) on the 12,288 x 12,288 banded matrix (density
   0.35) at N=128, and cg_normal(op, B, reg=50, maxiter=20) at N=32. Each
   product within max|d|/max|ref| < 1e-6 of scipy in float64; the CG
   residual, recomputed in float64, must fall below the initial one and
   agree with the reported one to 1e-3. Every mono kernel must launch.
   Then matmat N=128, SpMV, matmat N=32 and normal_matmat timed by CUDA
   events and by device busy time (torch.profiler), with the top kernels.
3. ELL kernel phase: each mode of the two gather kernels against its
   plain version, bit-exact, at the main path's shapes, ell_bucket's at
   N = 128, 1 and 8 (the narrow body at N <= 8): valued whole-row on
   config A's largest bucket, packed unit whole-row on a config B bucket,
   valued and unit chunked (packed pairs, and plain columns against an X
   past 65,536 rows) on an unsplit build of config A; ell_sweep on one of
   config B's sweep items at N=128. For every ell_bucket mode at N=1 and
   the sweep, device time beside cuSPARSE's device time on the same
   operands (torch.profiler, and queued CUDA events); for each mode the
   share of its bound in its event and device time.
4. ELL main-path phase: with the counts set to 0, config A
   (``powerlaw(20_000, 20_000, 1_000_000, seed=0)``, f32, BASELINE config 2)
   through ``operator(m, device="cuda")`` (auto -> ELL, transpose=True):
   matvec, rmatvec and matmat N=128, each within 1e-6 of scipy f64; config
   B (``powerlaw(65_536, 65_536, 4_000_000, seed=0, binary=True)``) through
   ``operator(m, format="ell", transpose=False, device="cuda")``: matmat
   N=128 within 1e-5. Both gather kernels must launch. Then per-product
   times, launches per product, the byte bound, and the device's busy and
   idle share from torch.profiler.
5. densecols kernel phase: the ECFP Macau matrix
   (``ecfp_like(50_000, 20_000, 64, 400, seed=2)``) through ``operator(m)``
   (format="auto" -> hybrid: a dense-column block beside the gather
   engine, both tilings); the densecols kernel against its plain version
   on the forward block at N = 1, 32, 128, 256, bit-exact;
   ``torch._int_mm`` timed beside it (at N=1 on planes zero-padded to 8
   columns), and at N=128 on the device clock too. Which body runs is
   checked by kernel name before phase 1 (the s8 engine at N >= 32, the
   mma.sync body at N=1, on a block of the same shape and density,
   bit-exact too).
6. hybrid main-path phase: with the counts set to 0, ECFP matmat at N =
   32, 128, 256, matvec and rmatmat N=32, each within 1e-6 of scipy f64;
   the Macau inner step (``rhs = op.rmatmat(R)``, ``cg_normal(op, rhs,
   reg=50, maxiter=30)`` at N=32, its residual recomputed in float64);
   BASELINE config 2 as the reference's bench suite calls it
   (``reorder="auto", transpose=False``) and the ECFP matrix with
   ``reorder="degree", transpose=False``, both against scipy f64.
   densecols and both gather kernels must launch. Then per-product times,
   launches per product, device busy time and idle share.
7. tile kernel phase: the ECFP matrix as BASELINE config 3 is called
   (``operator(m, reorder="auto", transpose=False)``; and with both
   tilings, ``operator(m, reorder="auto")``) and config B as
   ``bench.py:315`` calls it (``operator(mB, transpose=False,
   reorder="degree")``), each layout checked against the reference's
   (segment offsets, bucket kinds and dtypes, thresholds, padded tiles).
   panel_spmm against its plain version on the ECFP forward segments
   (windowed global X: narrow at N=32, fold "f32" at N=128 and 256),
   bucket_spmm on the transpose tiling's largest segment (narrow N=32,
   planes N=128), bucket_spmv on that segment and on config B's tile
   segment, each at max|d|/max|ref| <= 1e-6, timed beside its plain
   version, its bound and cuSPARSE's product of the same segment (on the
   device clock too, for all three), and each bucket_spmv launch alone on
   the device clock beside cuSPARSE's product of that bucket alone; first a
   line with the card's L2 read rate (a ~10 MB L2-resident buffer read by
   torch.sum and a GEMV, by device time) and one with the host cost of
   reading the stream handle (the public Stream object against the raw
   handle the launchers read). For #5 and #6 each set is also timed with
   its outputs concatenated (the span the first tile-kernel runs timed),
   cuSPARSE is timed on the device clock too, and a diagnostic line gives
   the ratios on each clock and the X bytes the tensor-core body requests
   (the live columns' rows; every column's beside them; worked out from
   the tiles, not counted by the card) over its device time. Then a
   ``tile_k=512`` tile-BSR product (a scattered 0/1 matrix through
   ``operator(m, format="bsr", config=Config(tile_m=8, tile_k=512))``)
   on the card against the same layout's product by the plain versions
   and against scipy, each within 1e-6.
8. tile main-path phase: with the counts set to 0, the ECFP forward
   operator's matmat N = 32, 128, 256 and matvec within 1e-6 of scipy
   f64; the Macau step (``rmatmat`` + ``cg_normal(reg=50, maxiter=30)``,
   N=32) on the two-tiling operator, its true residual below 3e-3 of the
   initial; config B matmat N=128 and matvec within 1e-5. bucket_spmm,
   panel_spmm and bucket_spmv must each launch. Then per-product times,
   launches, device busy time and idle share.
9. dd kernel phase: the two double-word gathers against their plain
   versions, bit-equal in hi and lo: ell_bucket_dd_valued on the largest
   bucket of BASELINE config 1's `build_ell_dd` (N=1) and of config 2 in
   fp64 (N=1 and N=32) and on config 2-fp64's longest-row bucket (8 x
   2,048, N=1 and N=32), ell_bucket_dd on config B's largest unsplit unit
   bucket and on its longest-row one (16 x 2,048) (N=1 and N=32); each
   timed beside its plain version, its bound and cuSPARSE's f64 product
   of the same rows; at N=32 (config 2-fp64's largest, config B's two)
   and on config 2-fp64's longest-row bucket at N=1 also by device time
   against cuSPARSE's device time.
10. fp64 main-path phase: with the counts set to 0, BASELINE config 1
   (``powerlaw(100_000, 100_000, 5_000_000, seed=0, alpha=1.0)``, f64)
   both ways the reference's suite runs it, ``operator(m1, format="ell",
   transpose=True).matvec(x)`` (the torch f64 engine) and
   ``spmm_dd(build_ell_dd(m1), x[:, None])`` (13 segments); config 2 in
   fp64 through ``spmm_dd(build_ell_dd(m))`` at N=1; and the unit form,
   ``spmm_dd(operator(mB, format="ell", transpose=False,
   config=Config(ell_split_rows=0)), X)`` at N=32 (3 segments). Each
   within max|d|/max|ref| 1e-10 of scipy f64; both dd kernels must
   launch. Then the five longest dd launches of config 2-fp64's product
   and of config B's unit one (torch.profiler, each with its bucket's
   segment and shape; also in the kernels JSON line under
   ell_bucket_dd_valued's and ell_bucket_dd's ``longest_launches``), host
   build seconds, per-product times, launches, device busy time and idle
   share.
11. SMEM-blocked gather phase: config A (``operator(mA)``) and config B
   (``operator(mB, format="ell", transpose=False)``) built again with
   ``ell_ops.USE_SMEM_PATH = True`` (their plans are keyed by the flag;
   the flag is set inside try/finally and always reset).
   ell_bucket_smem against its plain version, bit-exact, on config A's
   widest valued whole bucket at N=1 (the narrow body) and 128 and its
   width-40 bucket at N=128, and on config B's width-32 and width-12 unit
   whole buckets at N=128, each timed beside its bound and cuSPARSE's
   product of the same rows (config A's widest at N = 1 and 128 on the
   device clock too).
   Then, with the counts set to 0, A's SpMV and matmat N=128 and B's
   matmat N=128 under the flag: launches per product equal to the layout's
   items (ell_bucket, ell_sweep, ell_bucket_smem; the smem kernel must
   launch), the plans used, rel < 1e-6 (A) and 1e-5 (B) vs scipy f64; the
   same products' times, busy time and idle share with the flag off and
   on.
12. scatter phase (``index_add_`` engines, no kernel of the port):
   BASELINE config 1 as named, ``operator(m1, format="csr",
   transpose=False).matvec(x)`` in f64 (rel <= 1e-10); config 2 as named,
   ``spmv(sort_coo(coo_from_scipy(mA), "hilbert"), x)`` in f32 (< 1e-6)
   and on the config 2 matrix in f64 (<= 1e-10); ``operator(mA,
   format="coo")`` rmatvec and matmat N=128, ``operator(mA,
   transpose=False).rmatvec`` (the ELL scatter) and ``ata_X(coo_A, X,
   reg=50)`` at N=32 without the transpose tiling (< 1e-6). Host build
   seconds, per-product times, device busy time and idle share.
13. R-MAT main-path phase: the Graph 500 R-MAT graph at scale 18
   (``rmat(18, 16, seed=3)``) through ``operator(m, reorder="auto",
   transpose=False)``: a hybrid whose tile segments are summed by a
   cross-segment plan (``row_srcs``) and whose segmented ELL has a plan
   of many classes. With the counts set to 0, matmat N=128 within 1e-6
   of scipy f64, one plan kernel launch per plan; then its time, device
   busy time and idle share.
14. plan kernel phase: the assembly-plan kernel (``plan_sum``) against
   its plain version (`ops.assemble.plain_sum`, the torch ops the CPU
   runs) on the same card tensors, bit for bit with -0.0 planted, at N =
   1, 32 and 128 on the plans the main paths apply: config A's two ELL
   plans and config B's segmented one (phase 4), the ECFP hybrid's two
   (phase 6), the cross-segment plan of the ECFP two-tiling operator's
   transpose tiles (phase 8) and R-MAT's two (phase 13). Each timed
   beside its plain version and the least time of its bytes (the
   sources it reads and the rows it writes), and on the device clock.
   In phases 4, 6, 8 and 13 the plan kernel must launch (in 4 and 13
   once per plan a product applies).

Every kernel is timed with CUDA events (min of batches) beside its plain
version, the least time the card could take for the same work (bytes over
3.35 TB/s or operations over the type's peak, whichever is larger) and,
where one PyTorch call computes the same function, that call's time. It
prints the card's name and power limit, the ptxas report (registers,
spills) of the s8 engine's bodies, the ELL narrow bodies (ell_bucket's
and ell_bucket_smem's), the dd kernels and bucket_spmv,
the engine's dynamic shared memory, a JSON line
of per-kernel results and, last, ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero; without a CUDA device, or without the
``fastsparse_torch`` package beside it, it exits non-zero and prints no
result. It imports nothing of JAX.
"""
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

CSRC = "fastsparse_torch/ops/kernels/csrc/"
SOURCES = {
    "colmax": CSRC + "bsr_spmm.cu",
    "quant3_planes": CSRC + "bsr_spmm.cu",
    "mono_panel": CSRC + "bsr_spmm.cu",
    "mono_group": CSRC + "bsr_spmm.cu",
    "ell_bucket": CSRC + "ell_spmm.cu",
    "ell_sweep": CSRC + "ell_spmm.cu",
    "densecols": CSRC + "densecols_spmm.cu",
    "bucket_spmm": CSRC + "bsr_tiles.cu",
    "panel_spmm": CSRC + "bsr_tiles.cu",
    "bucket_spmv": CSRC + "bsr_tiles.cu",
    "ell_bucket_dd": CSRC + "ell_dd.cu",
    "ell_bucket_dd_valued": CSRC + "ell_dd.cu",
    "ell_bucket_smem": CSRC + "ell_spmm.cu",
    "plan_sum": CSRC + "assemble.cu",
}
REPLACES = {
    "colmax": "fastsparse/ops/pallas/bsr_spmm.py:619",
    "quant3_planes": "fastsparse/ops/pallas/bsr_spmm.py:665",
    "mono_panel": "fastsparse/ops/pallas/bsr_spmm.py:833",
    "mono_group": "fastsparse/ops/pallas/bsr_spmm.py:1026",
    "ell_bucket": "fastsparse/ops/pallas/ell_spmm.py:600",
    "ell_sweep": "fastsparse/ops/pallas/ell_spmm.py:362",
    "densecols": "fastsparse/ops/pallas/bsr_spmm.py:571",
    "bucket_spmm": "fastsparse/ops/pallas/bsr_spmm.py:234",
    "panel_spmm": "fastsparse/ops/pallas/bsr_spmm.py:446",
    "bucket_spmv": "fastsparse/ops/pallas/bsr_spmm.py:1156",
    "ell_bucket_dd": "fastsparse/ops/pallas/ell_spmm.py:551",
    "ell_bucket_dd_valued": "fastsparse/ops/pallas/ell_spmm.py:501",
    "ell_bucket_smem": "fastsparse/ops/pallas/ell_spmm.py:455",
    # no Pallas kernel: the reference leaves the plan's gathers to XLA
    "plan_sum": "fastsparse/ops/assemble.py:370",
}
MONO_KERNELS = ("colmax", "quant3_planes", "mono_panel", "mono_group")
REL_TOL = 1e-6
DD_TOL = 1e-10  # BASELINE's fp64 bar
# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def eager_first(op):
    """``op`` with a graph cache of its own: each of its products runs
    eagerly at its first call, through the wrappers that count launches
    (a replayed CUDA graph runs the same kernels without them)."""
    import dataclasses

    return dataclasses.replace(op)


def rel_err(y, ref):
    """max|y - ref| / max|ref| in float64 (ref: numpy array)."""
    import numpy as np

    y = np.asarray(y, np.float64)
    return float(np.abs(y - ref).max() / (np.abs(ref).max() + 1e-30))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, ops, ops_per_s):
    """Least time the card could take: bytes over the memory rate or
    operations over the type's peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def compare(name, kern, plain, exact, args, kwargs, time_cuda, quick=False,
            timed=None):
    """A kernel against its plain version on the same card tensors, both
    timed with CUDA events (``timed``: the (kernel, plain) callables to
    time in their place); returns (result dict, kernel output)."""
    import torch

    yk = kern(*args, **kwargs)
    torch.cuda.synchronize()
    yp = plain(*args, **kwargs)
    torch.cuda.synchronize()
    check(yk.shape == yp.shape and yk.dtype == yp.dtype,
          f"{name}: shape/dtype {tuple(yk.shape)} {yk.dtype} vs plain "
          f"{tuple(yp.shape)} {yp.dtype}")
    d = (yk.double() - yp.double()).abs().max().item()
    ref_max = yp.double().abs().max().item()
    rel = d / (ref_max + 1e-30)
    if exact:
        check(torch.equal(yk, yp), f"{name}: not bit-exact (max|d|={d})")
    else:
        check(rel <= REL_TOL, f"{name}: rel {rel} > {REL_TOL}")
    tkern, tplain = timed or (lambda: kern(*args, **kwargs),
                              lambda: plain(*args, **kwargs))
    tk = time_cuda(tkern)
    # the plain versions loop in Python over entries: fewer repetitions
    slow = dict(reps=2, batches=3, warmup=1) if quick else {}
    tp = time_cuda(tplain, **slow)
    print(f"kernel {name}: max_abs_err={d!r} rel={rel!r} "
          f"ms={tk['min_ms']!r} plain_ms={tp['min_ms']!r}", flush=True)
    return {"max_abs_err": d, "rel": rel, "ms": tk["min_ms"],
            "plain_ms": tp["min_ms"]}, yk


def kernel_names(fn, tries=3):
    """Names of the CUDA kernels ``fn()`` launches (torch.profiler, host and
    device activities, as `device_busy_ms` traces; the profiler now and
    then gives launch calls without device records, in spells of a few
    sessions: then it profiles again, half a second later)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for i in range(tries):
        if i:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):  # records of a lone launch can be lost
                fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if names:
            return " ".join(names)
    return ""


def check_body(name, fn, want, other):
    """``fn`` must run the kernel named ``want`` and not ``other`` (a name
    or a tuple of names)."""
    names = kernel_names(fn)
    others = (other,) if isinstance(other, str) else other
    check(want in names and not any(o in names for o in others),
          f"{name}: expected body {want}, profiler saw: {names[:300]}")
    print(f"  {name}: body {want}", flush=True)


def engine_report(lib, ptxas_report):
    """ptxas's registers and spills of each s8 engine body, the ELL narrow
    bodies, the dd kernels and bucket_spmv, and the dynamic shared memory
    the engine's launch asks for."""
    import ctypes

    for kern, lines in ptxas_report("s8_engine_kernel").items():
        tmpl = kern.split("s8_engine_kernel", 1)[1].split("EEEv", 1)[0]
        src = "densecols_spmm.cu" if "densecols" in kern else "bsr_spmm.cu"
        print(f"ptxas s8_engine_kernel{tmpl} ({src}): {' | '.join(lines)}",
              flush=True)
    for pat, src in (("ell_narrow_kernel", "ell_spmm.cu"),
                     ("ell_smem_narrow_kernel", "ell_spmm.cu"),
                     ("ell_dd_", "ell_dd.cu"),
                     ("bucket_spmv_kernel", "bsr_tiles.cu")):
        for kern, lines in ptxas_report(pat).items():
            tmpl = kern.split(pat, 1)[1].split("EEEv", 1)[0]
            print(f"ptxas {pat}{tmpl} ({src}): {' | '.join(lines)}",
                  flush=True)
    for bn, planes, nwg in ((64, 3, 2), (64, 3, 1), (128, 1, 2), (96, 1, 2),
                            (64, 1, 2), (32, 1, 2), (32, 1, 1)):
        st = ctypes.c_int(0)
        smem = lib.fs_s8_engine_smem(bn, planes, nwg, ctypes.byref(st))
        print(f"s8 engine B {planes}x{bn} rows, {nwg} consumer warpgroups: "
              f"{st.value} stages, {smem} B dynamic shared memory",
              flush=True)


def engine_body_phase(K):
    """Before the other phases (the profiler has dropped device records
    late in a run): densecols on a 0/1 block of the ECFP forward block's
    shape and density (50,176 x 5,376, 0.57 %) runs the s8 engine at N =
    32, 128, 256 and the mma.sync body at N=1, each bit-exact."""
    import torch

    gen = torch.Generator("cuda").manual_seed(3)
    block = (torch.rand((50_176, 5_376), device="cuda", generator=gen)
             < 0.0057).to(torch.int8)
    for N in (1, 32, 128, 256):
        q3t = torch.randint(-128, 128, (3 * N, 5_376), device="cuda",
                            generator=gen, dtype=torch.int8)
        s = torch.rand((1, N), device="cuda", generator=gen) * 1e-5 + 1e-7
        bodies = ("s8_engine_kernel", "densecols_kernel")
        check_body(f"densecols[N={N}]",
                   lambda: K.densecols_spmm(block, q3t, s),
                   *(bodies if N >= 9 else bodies[::-1]))
        check(torch.equal(K.densecols_spmm(block, q3t, s),
                          K.densecols_spmm_plain(block, q3t, s)),
              f"densecols[N={N}] on the ECFP-shaped block: not bit-exact")


def ell_body_phase(EK, DK):
    """Early too (for the same reason as `engine_body_phase`): on random
    buckets of the main path's shapes, ell_bucket runs the narrow body at
    N = 1 and 8 and the lane-split body at N = 128 in every mode; ell_sweep
    runs its own kernel at N = 1 and 128; ell_bucket_smem its narrow body
    at N = 1 and 8 and its lane-split body at N = 128; the dd gathers
    the split kernel on few long rows and the rows kernel on many rows, in
    either value form (config 2-fp64's and config B's longest-row and
    largest shapes). Each bit-exact against its plain version."""
    import torch

    gen = torch.Generator("cuda").manual_seed(11)
    ncol, rows_pad = 20_000, 20_008

    def x_of(N):
        x = torch.randn((rows_pad, N), device="cuda", generator=gen)
        x[ncol:] = 0.0
        return x

    def cols_of(nb, K):
        return torch.randint(0, ncol + 1, (nb, K), device="cuda",
                             generator=gen, dtype=torch.int32)

    xs = {N: x_of(N) for N in (1, 8, 128)}
    bodies = ("ell_narrow_kernel", "ell_bucket_kernel")
    # config A's largest bucket, config B's packed one, the chunked widths
    # (K = 81: odd, so unit takes plain columns)
    for mode, nb, K, unit in (("valued_full", 7_808, 64, False),
                              ("packed_full", 19_176, 32, True),
                              ("valued_chunked", 1_360, 80, False),
                              ("packed_chunked", 1_360, 80, True),
                              ("unit_chunked", 1_360, 81, True)):
        cols = cols_of(nb, K)
        vals = torch.randn((nb, K), device="cuda", generator=gen)
        for N, x in xs.items():
            check_body(f"ell_bucket[{mode},N={N}]",
                       lambda: EK.ell_bucket_spmm(cols, vals, x, unit=unit),
                       *(bodies if N <= 8 else bodies[::-1]))
            check(torch.equal(
                EK.ell_bucket_spmm(cols, vals, x, unit=unit),
                EK.ell_bucket_spmm_plain(cols, vals, x, unit=unit)),
                f"ell_bucket[{mode},N={N}]: not bit-exact")
    parts = ((16, 2), (8, 5), (24, 32), (8, 1))
    flat = torch.cat([EK._pack_pairs(cols_of(n, 2 * k2)) for n, k2 in parts])
    cols, vals = cols_of(7_808, 64), torch.randn((7_808, 64), device="cuda",
                                                 generator=gen)
    for N in (1, 128):
        x = xs[N]
        check_body(f"ell_sweep[N={N}]",
                   lambda: EK.ell_sweep_spmm(flat, x, parts=parts),
                   "ell_sweep_kernel", "ell_narrow_kernel")
    for N, x in xs.items():
        check_body(f"ell_bucket_smem[N={N}]",
                   lambda: EK.ell_bucket_spmm_smem(cols, vals, x),
                   *(("ell_smem_narrow_kernel",
                      ("ell_smem_kernel", "ell_narrow_kernel")) if N <= 8
                     else ("ell_smem_kernel", "ell_smem_narrow_kernel")))
        check(torch.equal(EK.ell_bucket_spmm_smem(cols, vals, x),
                          EK.ell_bucket_spmm_smem_plain(cols, vals, x)),
              f"ell_bucket_smem[N={N}]: not bit-exact")
    # dd: (rows, slots, lanes) of config 2-fp64's and config B's
    # longest-row buckets (few long rows: the split kernel) and largest
    # buckets (many rows: every thread a chain)
    k_rows = 20_008
    dd_bodies = ("ell_dd_split_kernel", "ell_dd_rows_kernel")
    for valued, nb, K, N, want in (
            (True, 8, 2048, 1, "ell_dd_split_kernel"),
            (True, 5048, 32, 32, "ell_dd_rows_kernel"),
            (False, 16, 2048, 1, "ell_dd_split_kernel"),
            (False, 16, 2048, 32, "ell_dd_split_kernel"),
            (False, 18_864, 32, 32, "ell_dd_rows_kernel")):
        c = torch.randint(0, ncol, (nb, K), device="cuda", generator=gen,
                          dtype=torch.int32)
        x2 = torch.randn((2 * k_rows, N), device="cuda", generator=gen)
        x2[k_rows:] *= 1e-8
        if valued:
            vh = torch.randn((nb, K), device="cuda", generator=gen)
            vl = vh * 1e-8

            def kern():
                return DK.ell_bucket_spmm_dd_valued(c, vh, vl, x2)

            def plain():
                return DK.ell_bucket_spmm_dd_valued_plain(c, vh, vl, x2)
        else:
            def kern():
                return DK.ell_bucket_spmm_dd(c, x2)

            def plain():
                return DK.ell_bucket_spmm_dd_plain(c, x2)
        name = (f"ell_bucket_dd{'_valued' if valued else ''}"
                f"[{nb}x{K},N={N}]")
        check_body(name, kern, want,
                   tuple(k for k in dd_bodies if k != want))
        check(all(torch.equal(k, p) for k, p in zip(kern(), plain())),
              f"{name}: not bit-exact")


def library_ms(fn, time_cuda):
    """Time of one PyTorch call computing the same function (a yardstick
    only: the port never calls it)."""
    return time_cuda(fn)["min_ms"]


def device_pair(name, kern, library, keys, n=5, tries=5,
                lib_name="cuSPARSE"):
    """A kernel's device time per call beside one PyTorch call's on the
    same operands, each from ``n`` calls under torch.profiler; prints both
    and their ratio. ``kern`` launches one kernel a call (its name holds
    one of ``keys``): its time is the mean over the launch records a
    session kept (`kernel_device_ms`). The library's is the sum of its
    kernels over ``n`` calls, taken from a session whose most frequent
    kernel has a count that is a multiple of ``n``, or over the calls a
    session kept when all its kernels have one count (the profiler drops
    whole calls' records now and then, in spells; a library may add
    helper kernels on some calls only). A session without such records
    is profiled again half a second later, up to ``tries`` times; what
    the sessions saw is printed when none qualifies. Event times of
    back-to-back short launches can read the wrapper's host pace; these
    cannot. Beside them, each side's queued event time (`time_queued`:
    the calls held behind a spin kernel, so device time and launch gaps
    alone), which needs no profiler record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastsparse_torch.bench.mono_products import device_us
    from fastsparse_torch.bench.spmv_kernels import kernel_device_ms
    from fastsparse_torch.bench.timing import time_queued

    def busy(f):
        f()
        torch.cuda.synchronize()
        seen = []
        for i in range(tries):
            if i:
                time.sleep(0.5)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    f()
                torch.cuda.synchronize()
            rows = [(e.count, device_us(e)) for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA")]
            seen.append([c for c, _ in rows])
            if rows and max(c for c, _ in rows) % n == 0:
                return sum(t for _, t in rows) / 1e3 / n
            counts = {c for c, _ in rows}
            if len(counts) == 1:  # whole calls lost: per call kept
                return sum(t for _, t in rows) / 1e3 / counts.pop()
        print(f"  {name}: no qualifying profiler session (record counts "
              f"per session {seen})", flush=True)
        return None

    def queued(f):
        t = time_queued(f)
        return None if t is None else t["min_ms"]

    dk = kernel_device_ms(kern, keys, n=n, tries=tries)
    dl = busy(library)
    qk, ql = queued(kern), queued(library)
    ratio = dk / dl if dk and dl else None
    qratio = qk / ql if qk and ql else None
    print(f"  {name}: device_ms={dk!r} {lib_name} device_ms={dl!r} "
          f"kernel/{lib_name}={ratio!r}; queued_ms={qk!r} {lib_name} "
          f"queued_ms={ql!r} kernel/{lib_name}={qratio!r}", flush=True)
    return {"device_ms": dk, "library_device_ms": dl, "queued_ms": qk,
            "library_queued_ms": ql}


def mono_kernel_phase(op, mb, X, K, time_cuda):
    """Each mono kernel against its plain version on the same card tensors."""
    import torch

    from fastsparse_torch.ops import bsr_ops

    res = {}
    A = op.fwd
    b = A.buckets[0]
    TK = A.tile_k
    K_pad = b.n_windows * b.win_slabs * TK
    Xp = torch.zeros((K_pad, 128), dtype=torch.float32, device="cuda")
    Xp[: X.shape[0]] = X
    m = mb.tocsr()
    A_csr = torch.sparse_csr_tensor(
        torch.as_tensor(m.indptr, dtype=torch.int64),
        torch.as_tensor(m.indices, dtype=torch.int64),
        torch.as_tensor(m.data, dtype=torch.float32), size=m.shape,
    ).cuda()

    # colmax + quant3 on the headline X (K_pad x 128)
    res["colmax"], mx = compare("colmax", K.colmax, K.colmax_plain, True,
                                (Xp,), {}, time_cuda)
    res["colmax"].update(bound(Xp.numel() * 4 + 128 * 4, Xp.numel(),
                               F32_OPS_PER_S))
    res["colmax"]["library_ms"] = library_ms(
        lambda: torch.linalg.vector_norm(Xp, ord=float("inf"), dim=0),
        time_cuda)
    res["colmax"].update(device_pair(
        "colmax", lambda: K.colmax(Xp),
        lambda: torch.linalg.vector_norm(Xp, ord=float("inf"), dim=0),
        ("colmax_kernel",), lib_name="vector_norm"))
    s = torch.where(mx > 0, mx, 1.0) * (1.0 / (127.0 * 65536.0))
    sinv = 1.0 / s
    res["quant3_planes"], planes = compare(
        "quant3_planes", K.quant3_planes, K.quant3_planes_plain, True,
        (Xp, sinv), {"n_block": 128}, time_cuda,
    )
    res["quant3_planes"].update(bound(Xp.numel() * 7 + 128 * 4, Xp.numel(),
                                      F32_OPS_PER_S))
    res["quant3_planes"]["library_ms"] = None  # no one PyTorch call does it
    out_rows = max(b.out_strips, A.n_strips) * A.tile_m
    panel_kw = dict(tile_m=A.tile_m, tile_k=TK, width=b.width,
                    win_slabs=b.win_slabs, out_rows=out_rows)
    args = (b.window, b.strip_ptr, b.start_rel, b.panels)
    i8w_kw = dict(panel_kw, n_block=128, fold="i8w", scale=s)
    check_body("mono_panel[i8w,N=128]",
               lambda: K.mono_panel_spmm(*args, planes, **i8w_kw),
               "s8_engine_kernel", "mono_kernel")
    res["mono_panel"], _ = compare(
        "mono_panel[i8w,N=128]", K.mono_panel_spmm, K.mono_panel_spmm_plain,
        True, args + (planes,), i8w_kw, time_cuda,
    )
    ni, TM, PK = b.panels.shape
    res["mono_panel"].update(bound(
        b.panels.numel() + planes.numel() + 128 * 4 + out_rows * 128 * 4
        + 3 * 4 * ni, 2 * ni * TM * PK * 3 * 128, INT8_OPS_PER_S))
    # the f32 product the kernel serves, through cuSPARSE
    res["mono_panel"]["library_ms"] = library_ms(
        lambda: torch.sparse.mm(A_csr, X), time_cuda)
    print(f"  mono_panel i8w N=128: bound_ms={res['mono_panel']['bound_ms']!r}"
          f" ({res['mono_panel']['bound_by']}) cuSPARSE "
          f"{res['mono_panel']['library_ms']!r}", flush=True)
    res["mono_panel"].update(device_pair(
        "mono_panel[i8w,N=128]",
        lambda: K.mono_panel_spmm(*args, planes, **i8w_kw),
        lambda: torch.sparse.mm(A_csr, X), ("s8_engine_kernel",)))
    # narrow per-item mode at N=32 (the CG operand width)
    nq = 32
    nb = bsr_ops._round_up(3 * nq, 32)
    qn, _ = bsr_ops._quant3_narrow(X[:, :nq], K_pad, nq, nb)
    narrow_kw = dict(panel_kw, n_block=nb, fold=False)
    check_body("mono_panel[narrow,N=32]",
               lambda: K.mono_panel_spmm(*args, qn, **narrow_kw),
               "s8_engine_kernel", "mono_kernel")
    narrow, _ = compare(
        "mono_panel[narrow,N=32]", K.mono_panel_spmm,
        K.mono_panel_spmm_plain, True, args + (qn,), narrow_kw, time_cuda,
    )
    narrow.update(bound(
        b.panels.numel() + qn.numel() + out_rows * nb * 4 + 3 * 4 * ni,
        2 * ni * TM * PK * nb, INT8_OPS_PER_S))
    X32 = X[:, :nq].contiguous()
    narrow["library_ms"] = library_ms(lambda: torch.sparse.mm(A_csr, X32),
                                      time_cuda)
    print(f"  mono_panel narrow N=32: bound_ms={narrow['bound_ms']!r} "
          f"({narrow['bound_by']}) cuSPARSE {narrow['library_ms']!r}",
          flush=True)
    res["mono_panel"].update({f"narrow_{k}": v for k, v in narrow.items()})
    # halo engine at SpMV width (nq=8): K-major planes, the s8 engine
    h = A.narrow
    K_halo = ((h.n_windows - 1) * h.stride + h.win_slabs) * TK
    qh, _ = bsr_ops._quant3_narrow(X[:, :1], K_halo, 8, 32)
    check(tuple(qh.shape) == (32, K_halo), f"halo planes {tuple(qh.shape)}")
    gargs = (h.windows, h.start_rel, h.panels, qh)
    gkw = dict(tile_m=A.tile_m, tile_k=TK, width=h.width, stride=h.stride,
               group=h.group)
    ns, TMh, PKh = h.panels.shape
    print(f"  halo layout: {ns} strips x {TMh} rows x {PKh} k, group "
          f"{h.group}, stride {h.stride}, {h.n_windows} windows of "
          f"{h.win_slabs} slabs; X planes {tuple(qh.shape)}", flush=True)
    check_body("mono_group[halo,N=1]",
               lambda: K.mono_group_spmm(*gargs, **gkw),
               "s8_engine_kernel", "mono_kernel")
    res["mono_group"], _ = compare(
        "mono_group[halo,N=1]", K.mono_group_spmm, K.mono_group_spmm_plain,
        True, gargs, gkw, time_cuda,
    )
    res["mono_group"].update(bound(
        h.panels.numel() + qh.numel() + ns * TMh * 32 * 4 + 4 * ns,
        2 * ns * TMh * PKh * 32, INT8_OPS_PER_S))
    x1 = X[:, :1].contiguous()
    res["mono_group"]["library_ms"] = library_ms(
        lambda: torch.sparse.mm(A_csr, x1), time_cuda)
    print(f"  mono_group halo N=1: bound_ms={res['mono_group']['bound_ms']!r}"
          f" ({res['mono_group']['bound_by']}) cuSPARSE "
          f"{res['mono_group']['library_ms']!r}", flush=True)
    res["mono_group"].update(device_pair(
        "mono_group[halo,N=1]", lambda: K.mono_group_spmm(*gargs, **gkw),
        lambda: torch.sparse.mm(A_csr, x1), ("s8_engine_kernel",)))
    return res


def x_panel(X, rows_pad):
    """X padded to ``rows_pad`` rows with zeros (the sentinel row)."""
    import torch

    Xp = torch.zeros((rows_pad, X.shape[1]), dtype=torch.float32,
                     device=X.device)
    Xp[: X.shape[0]] = X
    return Xp


def ell_gather_bound(cols, vals_bytes_per_slot, idx_bytes_per_slot, x, unit):
    """Bytes: the slots' indices (and values) once, each X row the bucket
    references once, each output row once; operations: a multiply-add (or
    add) per slot and lane."""
    import torch

    n, K = cols.shape
    L = x.shape[1]
    rows_used = int(torch.unique(cols[cols < x.shape[0]]).numel())
    nbytes = (n * K * (idx_bytes_per_slot + vals_bytes_per_slot)
              + rows_used * L * 4 + n * L * 4)
    return bound(nbytes, n * K * L * (1 if unit else 2), F32_OPS_PER_S)


def ell_kernel_phase(EK, opA, A_unsplit, A_unsplit_bin, opB, time_cuda):
    """Every mode of the two gather kernels against its plain version at
    the main path's shapes (bit-exact)."""
    import numpy as np
    import torch

    from fastsparse_torch.bench.spmv_kernels import gather_csr
    from fastsparse_torch.ops import ell_ops

    g = np.random.default_rng(7)
    ncolA = opA.shape[1]
    XA = torch.from_numpy(
        g.standard_normal((ncolA, 128)).astype(np.float32)).cuda()
    XpA = x_panel(XA, ell_ops._round_up(ncolA + 1, 8))
    modes = {}

    def run(mode, cols, vals, x, unit, packed, quick=False):
        r, _ = compare(f"ell_bucket[{mode}]", EK.ell_bucket_spmm,
                       EK.ell_bucket_spmm_plain, True, (cols, vals, x),
                       dict(unit=unit, packed=packed), time_cuda, quick)
        use_packed = EK._body_mode(cols.shape[1], x.shape[0], unit)[2]
        r.update(ell_gather_bound(cols, 0 if unit else 4,
                                  2 if use_packed else 4, x, unit))
        lib_vals = torch.ones_like(vals) if unit else vals
        Acsr = gather_csr(cols, lib_vals, x.shape[0])
        r["library_ms"] = library_ms(lambda: torch.sparse.mm(Acsr, x),
                                     time_cuda)
        if x.shape[1] == 1:
            r.update(device_pair(
                f"ell_bucket[{mode}]",
                lambda: EK.ell_bucket_spmm(cols, vals, x, unit=unit,
                                           packed=packed),
                lambda: torch.sparse.mm(Acsr, x),
                ("ell_narrow_kernel", "ell_bucket_kernel")))
        dev = r.get("device_ms")
        print(f"  ell_bucket[{mode}] {tuple(cols.shape)}: bound_ms="
              f"{r['bound_ms']!r} ({r['bound_by']}), of event ms "
              f"{r['bound_ms'] / r['ms']!r}, of device ms "
              f"{None if not dev else r['bound_ms'] / dev!r}; cuSPARSE "
              f"{r['library_ms']!r}", flush=True)
        r["shape"] = list(cols.shape)
        modes[mode] = r

    def run_widths(mode, cols, vals, x128, unit, packed, quick=False):
        """One mode at N=128 (the lane-split body) and at N = 1 and 8 (the
        narrow body)."""
        for N in (128, 1, 8):
            x = x128 if N == 128 else x128[:, :N].contiguous()
            run(f"{mode},N={N}", cols, vals, x, unit, packed, quick)

    big = max(opA.fwd.buckets, key=lambda b: b.cols.numel())
    print(f"config A largest bucket {tuple(big.cols.shape)}", flush=True)
    run_widths("valued_full", big.cols, big.vals, XpA, False, None)
    segB = opB.fwd.segments[0]
    rows_padB = ell_ops._round_up(segB.shape[1] + 1, 8)
    XB = torch.from_numpy(
        g.standard_normal((segB.shape[1], 128)).astype(np.float32)).cuda()
    XpB = x_panel(XB, rows_padB)
    bB = max((b for b in segB.buckets if b.width <= 64),
             key=lambda b: b.cols.numel())
    run_widths("packed_full", bB.cols, bB.vals, XpB, True, bB.packed)
    wide = max((b for b in A_unsplit.buckets if b.width > 64),
               key=lambda b: b.cols.numel())
    run_widths("valued_chunked", wide.cols, wide.vals, XpA, False, None,
               quick=True)
    wideb = max((b for b in A_unsplit_bin.buckets if b.width > 64),
                key=lambda b: b.cols.numel())
    run_widths("packed_chunked", wideb.cols, wideb.vals, XpA, True,
               wideb.packed, quick=True)
    # plain columns: an X panel past 65,536 rows cannot use 16-bit pairs
    run_widths("unit_chunked", wideb.cols, wideb.vals, x_panel(XA, 65_544),
               True, None, quick=True)

    # sweep: config B segment 0's first sweep item, built as _seg_parts does
    item = next(b for b, mode, *_ in ell_ops._seg_layout(segB)
                if mode == "sweep")
    flats, meta, cols_l = [], [], []
    for bb, t0, t1, np_ in item:
        _, cc, _, pp = ell_ops._slice_chunk(bb, segB, t0, t1, np_)
        flats.append(pp.reshape(-1))
        meta.append((np_, bb.cols.shape[1] // 2))
        cols_l.append(cc)
    flat = torch.cat(flats)
    sweep, _ = compare("ell_sweep[N=128]", EK.ell_sweep_spmm,
                       EK.ell_sweep_spmm_plain, True, (flat, XpB),
                       dict(parts=tuple(meta)), time_cuda)
    n_slots = sum(c.numel() for c in cols_l)
    used = int(torch.unique(torch.cat([c.reshape(-1) for c in cols_l])).numel())
    n_rows = sum(c.shape[0] for c in cols_l)
    sweep.update(bound(n_slots * 2 + used * 128 * 4 + n_rows * 128 * 4,
                       n_slots * 128, F32_OPS_PER_S))
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device="cuda")
    lens = torch.cat([torch.full((c.shape[0],), c.shape[1], device="cuda")
                      for c in cols_l])
    crow[1:] = torch.cumsum(lens, 0)
    Scsr = torch.sparse_csr_tensor(
        crow, torch.cat([c.reshape(-1) for c in cols_l]).long(),
        torch.ones(n_slots, device="cuda"), size=(n_rows, rows_padB))
    sweep["library_ms"] = library_ms(lambda: torch.sparse.mm(Scsr, XpB),
                                     time_cuda)
    sweep.update(device_pair(
        "ell_sweep[N=128]",
        lambda: EK.ell_sweep_spmm(flat, XpB, parts=tuple(meta)),
        lambda: torch.sparse.mm(Scsr, XpB), ("ell_sweep_kernel",)))
    sweep["parts"] = [list(p) for p in meta]
    bucket = dict(modes["valued_full,N=128"])
    bucket["max_abs_err"] = max(r["max_abs_err"] for r in modes.values())
    bucket["modes"] = modes
    return {"ell_bucket": bucket, "ell_sweep": sweep}


def ell_layout_stats(A):
    """(padded slots, index+value bytes, part rows, launches) of one
    product over an ELL tiling, from the layout the dispatch walks."""
    from fastsparse_torch.ops import ell_ops

    segs = A.segments if hasattr(A, "segments") else [A]
    slots = nbytes = rows = launches = 0
    for seg in segs:
        for b, mode, s0, s1, n_pad in ell_ops._seg_layout(seg):
            subs = b if mode == "sweep" else ((b, s0, s1, n_pad),)
            launches += 1
            for bb, t0, t1, np_ in subs:
                K = bb.cols.shape[1]
                slots += np_ * K
                rows += np_
                per = 2 if bb.packed is not None and seg.unit_vals else (
                    4 if seg.unit_vals else 8)
                nbytes += np_ * K * per
    return slots, nbytes, rows, launches


def plan_ops(plan):
    """An assembly plan's size: multiplicity classes, the widest, and the
    row gathers and adds `apply_plan` issues (one torch op each)."""
    return (f"{len(plan.widths)} classes, widest {max(plan.widths)}, "
            f"{sum(plan.widths)} gathers + {sum(plan.widths) - len(plan.widths)}"
            f" adds")


def time_products(products, time_cuda, counters, notes=None):
    """Event min/median, launches per product, device busy time and idle
    share (torch.profiler) and the top kernels, per product; ``notes`` adds
    a text to a product's line."""
    import torch

    from fastsparse_torch.bench.mono_products import device_busy_ms

    for name, (fn, arg) in products.items():
        for c in counters:
            c.reset_launches()
        fn(arg)
        torch.cuda.synchronize()
        per = {k: v for c in counters for k, v in c.launches.items() if v}
        t = time_cuda(fn, arg)
        try:
            busy, top = device_busy_ms(fn, arg)
        except Exception as exc:  # the sandbox's profiler is untried
            print(f"profiler: not measured ({exc!r})", flush=True)
            busy, top = None, []
        idle = None if busy is None else max(0.0, 1.0 - busy / t["median_ms"])
        note = (notes or {}).get(name, "")
        print(f"ms/product {name}: min={t['min_ms']!r} "
              f"median={t['median_ms']!r} launches/product={per} {note} "
              f"device_busy_ms={busy!r} idle_share={idle!r}", flush=True)
        for tt, key in top:
            print(f"  device {tt!r} ms  {key[:90]}", flush=True)


def ell_main_phase(ft, K, EK, opA, mA, opB, mB, time_cuda):
    """Config A and config B products through the public API, counted."""
    import numpy as np
    import torch

    g = np.random.default_rng(11)
    XAn = g.standard_normal((mA.shape[1], 128)).astype(np.float32)
    xAn = XAn[:, 0].copy()
    yAn = g.standard_normal(mA.shape[0]).astype(np.float32)
    XBn = g.standard_normal((mB.shape[1], 128)).astype(np.float32)
    XA, xA = torch.from_numpy(XAn).cuda(), torch.from_numpy(xAn).cuda()
    yA, XB = torch.from_numpy(yAn).cuda(), torch.from_numpy(XBn).cuda()
    torch.cuda.synchronize()

    from fastsparse_torch.ops.kernels import assemble as AK

    for c in (K, EK, AK):
        c.reset_launches()
    eA, eB = eager_first(opA), eager_first(opB)
    ya = eA.matvec(xA)
    za = eA.rmatvec(yA)
    Ya = eA.matmat(XA)
    Yb = eB.matmat(XB)
    torch.cuda.synchronize()
    counts = dict(K.launches, **EK.launches, **AK.launches)
    print(f"ELL main-path launches: {counts}", flush=True)
    applied = sum(len(tiling_plans("", t))
                  for t in (opA.fwd, opA.bwd, opA.fwd, opB.fwd))
    check(applied > 0 and counts["plan_sum"] == applied,
          f"ELL path: {counts['plan_sum']} plan kernel launches for "
          f"{applied} plan applications")
    for name, out, shape in (("A.matvec", ya, (mA.shape[0],)),
                             ("A.rmatvec", za, (mA.shape[1],)),
                             ("A.matmat", Ya, (mA.shape[0], 128)),
                             ("B.matmat", Yb, (mB.shape[0], 128))):
        check(tuple(out.shape) == shape and out.dtype == torch.float32
              and out.is_cuda, f"{name}: {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite values")
    mA64, mB64 = mA.astype(np.float64), mB.astype(np.float64)
    rels = {
        "A.matvec": rel_err(ya.cpu().numpy(), mA64 @ xAn.astype(np.float64)),
        "A.rmatvec": rel_err(za.cpu().numpy(), mA64.T @ yAn.astype(np.float64)),
        "A.matmat": rel_err(Ya.cpu().numpy(), mA64 @ XAn.astype(np.float64)),
        "B.matmat": rel_err(Yb.cpu().numpy(), mB64 @ XBn.astype(np.float64)),
    }
    print(f"ELL rel vs scipy f64: {rels}", flush=True)
    for name, r in rels.items():
        check(r < (1e-5 if name.startswith("B") else REL_TOL),
              f"{name} rel {r}")
    for name in ("ell_bucket", "ell_sweep"):
        check(counts[name] > 0, f"kernel {name} never launched on the ELL path")

    products = {
        "A.matvec": (opA.matvec, xA, opA.fwd, 1, mA.shape),
        "A.rmatvec": (opA.rmatvec, yA, opA.bwd, 1, mA.shape[::-1]),
        "A.matmat": (opA.matmat, XA, opA.fwd, 128, mA.shape),
        "B.matmat": (opB.matmat, XB, opB.fwd, 128, mB.shape),
    }
    notes = {}
    for name, (_, _, tiling, N, shape) in products.items():
        slots, idx_bytes, part_rows, _ = ell_layout_stats(tiling)
        L = 1 if N == 1 else N
        b = bound(idx_bytes + shape[1] * N * 4 + part_rows * L * 4
                  + shape[0] * N * 4, slots * N * 2, F32_OPS_PER_S)
        notes[name] = (f"N={N} padded_slots={slots} part_rows={part_rows} "
                       f"bound_ms={b['bound_ms']!r} ({b['bound_by']})")
    time_products({k: v[:2] for k, v in products.items()}, time_cuda, (EK,),
                  notes)
    return counts


def hybrid_layout(name, H):
    """One line describing a HybridMatrix tiling."""
    dc, sp_ = H.dense_cols, H.sparse
    segs = sp_.segments if hasattr(sp_, "segments") else [sp_]
    return (f"{name}: dense={H.dense} threshold={H.threshold} sparse="
            f"{type(sp_).__name__} ({sum(len(s.buckets) for s in segs)} "
            f"buckets, {sp_.nnz} nnz, padded slots {sp_.padded_nnz}, plan: "
            f"{plan_ops(sp_.plan)}) dense_cols block "
            f"{tuple(dc.block.shape)} ({dc.n_cols} columns, {dc.nnz} nnz)")


def densecols_inputs(dc, N, seed):
    """The densecols kernel's operands as `dense_cols_spmm` makes them
    from a random f32 X: (block, q3t, s)."""
    import numpy as np
    import torch

    from fastsparse_torch.ops.spmm import densecols_planes

    g = np.random.default_rng(seed)
    X = torch.from_numpy(g.standard_normal(
        (dc.shape[1], N)).astype(np.float32)).cuda()
    return (dc.block, *densecols_planes(X[dc.col_ids.long()]))


def densecols_kernel_phase(K, opE, time_cuda):
    """The densecols kernel against its plain version on the ECFP forward
    block at N = 1, 32, 128, 256 (bit-exact), each timed beside its bound
    and cuBLASLt's s8 GEMM of the same operands without the fold."""
    import torch

    dc = opE.fwd.dense_cols
    modes = {}
    for N in (1, 32, 128, 256):
        block, q3t, s = densecols_inputs(dc, N, seed=N)
        r, _ = compare(f"densecols[N={N}]", K.densecols_spmm,
                       K.densecols_spmm_plain, True, (block, q3t, s), {},
                       time_cuda)
        nrow, D = block.shape
        r.update(bound(block.numel() + q3t.numel() + N * 4 + nrow * N * 4,
                       2 * nrow * D * 3 * N, INT8_OPS_PER_S))
        q3p = q3t
        if (3 * N) % 8:  # cuBLASLt's s8 GEMM wants 8-column multiples
            q3p = torch.zeros((-(-3 * N // 8) * 8, q3t.shape[1]),
                              dtype=torch.int8, device=q3t.device)
            q3p[: 3 * N] = q3t
        q3_cm = q3p.t()  # (D, 3N) column-major: cuBLASLt's B layout
        r["library_ms"] = library_ms(lambda: torch._int_mm(block, q3_cm),
                                     time_cuda)
        r["library"] = (f"torch._int_mm (s8 GEMM, no fold, {q3p.shape[0]} "
                        "plane columns)")
        r["shape"] = [nrow, D, N]
        print(f"  densecols N={N}: bound_ms={r['bound_ms']!r} "
              f"({r['bound_by']}) library_ms={r['library_ms']!r}", flush=True)
        if N == 128:
            r.update(device_pair(
                f"densecols[N={N}]", lambda: K.densecols_spmm(block, q3t, s),
                lambda: torch._int_mm(block, q3_cm), ("s8_engine_kernel",),
                lib_name="torch._int_mm"))
        modes[f"N={N}"] = r
    row = dict(modes["N=128"])
    row["max_abs_err"] = max(r["max_abs_err"] for r in modes.values())
    row["modes"] = modes
    return {"densecols": row}


def hybrid_main_phase(ft, K, EK, opE, mE, time_cuda):
    """The ECFP Macau matrix through the hybrid operator (format="auto"),
    the Macau inner step, BASELINE config 2 as bench_suite calls it and the
    ECFP reorder="degree" call, counted and checked against scipy f64."""
    import numpy as np
    import torch

    g = np.random.default_rng(13)
    nE, fE = mE.shape
    Xn = {N: g.standard_normal((fE, N)).astype(np.float32)
          for N in (32, 128, 256)}
    xn = Xn[32][:, 0].copy()
    Rn = g.standard_normal((nE, 32)).astype(np.float32)
    X = {N: torch.from_numpy(v).cuda() for N, v in Xn.items()}
    x, R = torch.from_numpy(xn).cuda(), torch.from_numpy(Rn).cuda()

    t0 = time.perf_counter()
    m2 = ft.bench.matrices.powerlaw(20_000, 20_000, 1_000_000, seed=0,
                                    dtype=np.float32)
    op2 = ft.operator(m2, reorder="auto", transpose=False,
                      dtype=torch.float32)
    torch.cuda.synchronize()
    print(f"config 2 (reorder='auto', transpose=False) build "
          f"{time.perf_counter() - t0!r} s: {type(op2.fwd).__name__}, "
          f"{len(op2.fwd.buckets)} buckets, perms kept: row "
          f"{op2.row_perm is not None} col {op2.col_perm is not None}",
          flush=True)
    check(type(op2.fwd).__name__ == "EllMatrix", "config 2: not ELL")
    t0 = time.perf_counter()
    opD = ft.operator(mE, reorder="degree", transpose=False)
    torch.cuda.synchronize()
    print(f"ecfp reorder='degree', transpose=False build "
          f"{time.perf_counter() - t0!r} s, perms kept: row "
          f"{opD.row_perm is not None} col {opD.col_perm is not None}",
          flush=True)
    print(hybrid_layout("  fwd", opD.fwd), flush=True)
    check(type(opD.fwd).__name__ == "HybridMatrix" and opD.fwd.dense is None,
          "ecfp degree: not a hybrid without dense tiles")
    x2n = g.standard_normal(20_000).astype(np.float32)
    X2n = g.standard_normal((20_000, 128)).astype(np.float32)
    x2, X2 = torch.from_numpy(x2n).cuda(), torch.from_numpy(X2n).cuda()
    torch.cuda.synchronize()

    from fastsparse_torch.ops.kernels import assemble as AK

    reg = 50.0
    for c in (K, EK, AK):
        c.reset_launches()
    eE = eager_first(opE)
    Y = {N: eE.matmat(v) for N, v in X.items()}
    y = eE.matvec(x)
    rhs = eE.rmatmat(R)  # the Macau inner step's right-hand side
    sol = ft.cg_normal(eE, rhs, reg=reg, maxiter=30)
    y2 = eager_first(op2).matvec(x2)
    Y2 = eager_first(op2).matmat(X2)
    YD = eager_first(opD).matmat(X[128])
    torch.cuda.synchronize()
    counts = dict(K.launches, **EK.launches, **AK.launches)
    print(f"hybrid main-path launches: {counts}", flush=True)

    mE64, m264 = mE.astype(np.float64), m2.astype(np.float64)
    outs = {f"ecfp.matmat N={N}": (Y[N], mE64 @ Xn[N].astype(np.float64))
            for N in Y}
    outs["ecfp.matvec"] = (y, mE64 @ xn.astype(np.float64))
    outs["ecfp.rmatmat N=32"] = (rhs, mE64.T @ Rn.astype(np.float64))
    outs["config2.matvec"] = (y2, m264 @ x2n.astype(np.float64))
    outs["config2.matmat N=128"] = (Y2, m264 @ X2n.astype(np.float64))
    outs["ecfp-degree.matmat N=128"] = (YD, mE64 @ Xn[128].astype(np.float64))
    rels = {}
    for name, (out, ref) in outs.items():
        check(tuple(out.shape) == ref.shape and out.dtype == torch.float32
              and out.is_cuda, f"{name}: {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite values")
        rels[name] = rel_err(out.cpu().numpy(), ref)
    print(f"hybrid rel vs scipy f64: {rels}", flush=True)
    for name, r in rels.items():
        check(r < REL_TOL, f"{name} rel {r}")
    xs = sol.x.cpu().numpy().astype(np.float64)
    b = rhs.cpu().numpy().astype(np.float64)
    r_true = np.linalg.norm(b - (mE64.T @ (mE64 @ xs) + reg * xs), axis=0)
    r0 = np.linalg.norm(b, axis=0)
    r_rep = sol.resnorm.cpu().numpy().astype(np.float64)
    cg_agree = float(np.abs(r_true - r_rep).max() / r_true.max())
    print(f"Macau step cg_normal(reg={reg}) N=32: iters={sol.iters} "
          f"resnorm/initial max={float((r_true / r0).max())!r} "
          f"true-vs-reported={cg_agree!r}", flush=True)
    # 30 iterations take the true residual to about 1.0e-3 of the initial
    # one on this matrix (H100 runs); the bar leaves 3x of that
    check(bool(np.all(r_true < 3e-3 * r0)), "cg_normal: residual did not fall")
    check(cg_agree < 1e-3, f"cg_normal: true vs reported residual {cg_agree}")
    for name in ("densecols", "ell_bucket", "ell_sweep", "plan_sum"):
        check(counts[name] > 0, f"kernel {name} never launched on the hybrid path")

    products = {f"ecfp.matmat N={N}": (opE.matmat, v) for N, v in X.items()}
    products["ecfp.matvec"] = (opE.matvec, x)
    products["ecfp.rmatmat N=32"] = (opE.rmatmat, R)
    products["ecfp.normal_matmat N=32"] = (
        lambda V: opE.normal_matmat(V, reg=reg), rhs)
    products["config2.matvec"] = (op2.matvec, x2)
    products["ecfp-degree.matmat N=128"] = (opD.matmat, X[128])
    time_products(products, time_cuda, (K, EK, AK))
    return counts


def bsr_csr(A):
    """A CUDA CSR (f32) of a BsrMatrix of tile buckets or class panels, or
    of a ColSegmented of them: cuSPARSE's operand for the same product."""
    import torch

    parts = [(0, A)] if not hasattr(A, "col_offsets") else list(
        zip(A.col_offsets, A.segments))
    rows, cols, vals = [], [], []
    for off, S in parts:
        TM, TK = S.tile_m, S.tile_k
        for b in S.buckets:
            sid = b.strip_ids.long()
            if hasattr(b, "start_slab"):
                i, r, c = b.panels.nonzero(as_tuple=True)
                cols.append(b.start_slab.long()[i] * TK + c + off)
                vals.append(b.panels[i, r, c].float())
            else:
                i, t, r, c = b.tiles.nonzero(as_tuple=True)
                cols.append(b.slab_ids.long()[i, t] * TK + c + off)
                vals.append(b.tiles[i, t, r, c].float())
            rows.append(sid[i] * TM + r)
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        size=tuple(A.shape)).coalesce()
    return coo.to_sparse_csr()


def tile_part_csr(slab_ids, tiles, ncols):
    """A CUDA CSR (f32) of one tile-bucket launch's strips alone, ``(ns·TM,
    ncols)``: cuSPARSE's operand for that launch's product."""
    import torch

    ns, _, TM, TK = tiles.shape
    i, t, r, c = tiles.nonzero(as_tuple=True)
    coo = torch.sparse_coo_tensor(
        torch.stack([i * TM + r, slab_ids.long()[i, t] * TK + c]),
        tiles[i, t, r, c].float(), size=(ns * TM, ncols)).coalesce()
    return coo.to_sparse_csr()


def bsr_desc(S):
    """One BsrMatrix segment as text: kind, dtype, tile height, buckets."""
    if not S.buckets:
        return "empty"
    if S.is_mono:
        return "mono"
    if S.is_panel:
        return (f"panels {S.dtype} tm={S.tile_m} ["
                + ", ".join(f"{b.ns} w{b.width}" for b in S.buckets) + "]")
    return (f"tiles {S.dtype} tm={S.tile_m} padded_tiles={S.padded_tiles} ["
            + ", ".join(f"{b.ns}x{b.ntiles}" for b in S.buckets) + "]")


def check_tile_hybrid(name, H, threshold, dc_shape, offsets, segs, nnz,
                      sparse):
    """A HybridMatrix with dense tiles against the reference's layout:
    ``segs`` holds per segment (kind, dtype, (ns, width or T) list or
    padded-tile count)."""
    D = H.dense
    print(f"{name}: threshold={H.threshold} dense_cols "
          f"{tuple(H.dense_cols.block.shape)} dense {type(D).__name__} "
          f"offsets {D.col_offsets} nnz {H.dense_nnz} sparse "
          f"{type(H.sparse).__name__}", flush=True)
    for off, S in zip(D.col_offsets, D.segments):
        print(f"  segment {off}: {bsr_desc(S)}", flush=True)
    check(H.threshold == threshold, f"{name}: threshold {H.threshold}")
    check(tuple(H.dense_cols.block.shape) == dc_shape,
          f"{name}: dense_cols {tuple(H.dense_cols.block.shape)}")
    check(type(D).__name__ == "ColSegmented" and D.col_offsets == offsets,
          f"{name}: dense part {type(D).__name__}")
    check(H.dense_nnz == nnz and type(H.sparse).__name__ == sparse,
          f"{name}: dense nnz {H.dense_nnz}, sparse {type(H.sparse).__name__}")
    for S, want in zip(D.segments, segs):
        if want is None:
            check(not S.buckets, f"{name}: a segment is not empty")
            continue
        kind, dtype, spec = want
        check(S.buckets and not S.is_mono and S.is_panel == (kind == "panels")
              and str(S.dtype) == dtype and S.tile_m == 8,
              f"{name}: segment {bsr_desc(S)}")
        got = ([(b.ns, b.width) for b in S.buckets] if kind == "panels"
               else S.padded_tiles if isinstance(spec, int)
               else [(b.ns, b.ntiles) for b in S.buckets])
        check(got == spec, f"{name}: segment {got} != {spec}")


def tile_builds(ft, mE, mB):
    """The three operators of the tile phases, their layouts checked."""
    import torch

    ops = {}
    for key, m, kw in (("F", mE, dict(reorder="auto", transpose=False)),
                       ("T", mE, dict(reorder="auto")),
                       ("B", mB, dict(reorder="degree", transpose=False))):
        t0 = time.perf_counter()
        ops[key] = ft.operator(m, **kw)
        torch.cuda.synchronize()
        op = ops[key]
        print(f"operator {key} {kw} build {time.perf_counter() - t0!r} s, "
              f"perms kept: row {op.row_perm is not None} col "
              f"{op.col_perm is not None}", flush=True)
    opF, opT, opB = ops["F"], ops["T"], ops["B"]
    check(opF.row_perm is not None and opF.col_perm is not None,
          "ecfp reorder='auto': perms not kept")
    fwd = ("HybridMatrix", 41, (50_176, 5_376), (0, 10_112),
           [("panels", "torch.int8", [(3040, 1), (448, 2), (8, 3)]),
            ("panels", "torch.int8", [(2648, 1), (128, 2)])],
           738_877, "EllMatrix")
    for name, H in (("ecfp fwd", opF.fwd), ("ecfp fwd (two tilings)",
                                            opT.fwd)):
        check(type(H).__name__ == fwd[0], f"{name}: {type(H).__name__}")
        check_tile_hybrid(name, H, *fwd[1:])
    check_tile_hybrid(
        "ecfp bwd", opT.bwd, 40, (20_224, 13_440), (0, 12_544, 25_088, 37_632),
        [("tiles", "torch.bfloat16", n) for n in (320, 5_504, 5_760, 4_736)],
        1_019_177, "SegmentedEll")
    check(opB.row_perm is None and opB.col_perm is None,
          "config B reorder='degree': perms not elided")
    check_tile_hybrid(
        "config B fwd", opB.fwd, opB.fwd.threshold, (65_536, 2_560),
        (0, 16_384, 32_768, 49_152),
        [("tiles", "torch.bfloat16", [(8, 32)]),
         ("panels", "torch.int8", [(8, 1)]), None, None],
        opB.fwd.dense_nnz, "SegmentedEll")
    return opF, opT, opB


def l2_read_rate():
    """The card's L2 read rate in TB/s: a ~10 MB buffer, resident in L2,
    read by torch.sum and by a cuBLAS GEMV; bytes over each one's device
    time (torch.profiler), the faster of the two."""
    import torch

    from fastsparse_torch.bench.mono_products import device_busy_ms

    buf = torch.randn(2560, 1024, device="cuda")
    v = torch.randn(1024, device="cuda")
    nbytes = buf.numel() * buf.element_size()
    rates = {}
    for name, fn in (("sum", lambda _: buf.sum()),
                     ("gemv", lambda _: torch.mv(buf, v))):
        busy, _ = device_busy_ms(fn, None, n=50)
        rates[name] = None if not busy else nbytes / (busy * 1e-3) / 1e12
    best = max((r for r in rates.values() if r), default=None)
    print(f"L2 read rate: {best!r} TB/s (reads of a {nbytes} B L2-resident "
          f"buffer by device time: {rates})", flush=True)
    return best


def live_x_rows(blocks, row_chunk=8, col_chunk=128):
    """X rows the tensor-core body reads for tiles or panels ``blocks``
    (..., TM, KW): per 8-row chunk and 128-column chunk, the columns
    nonzero in some row (a chunk's dropped columns are zero in all)."""
    import torch.nn.functional as F

    TM, KW = blocks.shape[-2:]
    b = (blocks != 0).reshape(-1, TM, KW)
    b = F.pad(b, (0, -KW % col_chunk, 0, -TM % row_chunk))
    b = b.reshape(b.shape[0], -1, row_chunk, b.shape[2] // col_chunk,
                  col_chunk)
    return int(b.any(dim=2).sum())


def stream_handle_us(n=20_000):
    """Host µs per read of the current stream's handle: through the public
    Stream object, and raw as the kernel launchers read it."""
    import torch

    dev = torch.cuda.current_device()
    out = {}
    for name, fn in (
            ("public", lambda: torch.cuda.current_stream().cuda_stream),
            ("raw", lambda: torch._C._cuda_getCurrentRawStream(dev))):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
    print(f"stream handle host us per read: public {out['public']!r}, raw "
          f"{out['raw']!r}", flush=True)
    return out


def tile_set_diag(name, r, n_launch, stream_us, live_rows, all_rows,
                  row_bytes):
    """A diagnostic line for a #5/#6 set: its ratio to cuSPARSE by event
    time, by event time with the concatenation (PR 5's span), that plus
    the public stream reads PR 5's launches made (host µs per read from
    `stream_handle_us` times the launches), and by device time against
    cuSPARSE's device time; and the X bytes the tensor-core body requests
    (worked out from the tiles: not L2 traffic, which no counter read
    here) over its device time."""
    lib, lib_dev, dev = r["library_ms"], r["library_device_ms"], r["device_ms"]
    trim_ms = n_launch * (stream_us["public"] - stream_us["raw"]) * 1e-3
    x_bytes = live_rows * row_bytes
    rate = None if not dev else x_bytes / (dev * 1e-3) / 1e12
    print(f"  {name}: event ms {r['ms']!r}, with cat {r['ms_with_cat']!r}; "
          f"vs cuSPARSE: event {r['ms'] / lib!r}x, event with cat "
          f"{r['ms_with_cat'] / lib!r}x, with cat and public stream reads "
          f"{(r['ms_with_cat'] + trim_ms) / lib!r}x, device "
          f"{None if not (dev and lib_dev) else dev / lib_dev!r}x "
          f"(cuSPARSE device_ms {lib_dev!r}); X bytes requested {x_bytes} "
          f"(all columns {all_rows * row_bytes}) over device time "
          f"{rate!r} TB/s", flush=True)


def tile_kernel_phase(TT, opF, opT, opB, time_cuda):
    """The three tile kernels against their plain versions at the main
    path's shapes, each timed beside its bound and cuSPARSE; for #5 and #6
    also on the device clock against cuSPARSE's, with the X bytes they
    request beside the card's L2 read rate."""
    import numpy as np
    import torch

    from fastsparse_torch.bench.mono_products import device_busy_ms
    from fastsparse_torch.bench.spmv_kernels import kernel_device_ms
    from fastsparse_torch.ops import bsr_ops as bo

    g = np.random.default_rng(17)
    l2_read_rate()
    stream_us = stream_handle_us()
    res = {}

    def run_set(name, fn, plain_fn, calls, library=None):
        """One product's launches of a kernel against the plain version
        (their outputs concatenated to compare, not while timed); beside
        the event time (which includes the wrappers' host work), the
        device time of the launches under torch.profiler (the mean over
        the launch records kept, times the launches; `kernel_device_ms`).
        With ``library`` (a
        callable): cuSPARSE's event and device times, and the set timed
        with and without the concatenation in three alternating rounds
        (the host's pace drifts between calls), each the least of its
        rounds."""
        kern = lambda *_: [fn(*c) for c in calls]  # noqa: E731
        plain = lambda: [plain_fn(*c) for c in calls]  # noqa: E731
        cat = lambda: torch.cat(kern())  # noqa: E731
        r = compare(name, cat, lambda: torch.cat(plain()), False, (), {},
                    time_cuda, True, timed=(kern, plain))[0]

        def busy_of(f):
            for _ in range(3):
                busy, _ = device_busy_ms(f, None)
                if busy is not None:
                    return busy
            return None

        r["device_ms"] = kernel_device_ms(
            kern, ("spmv_kernel", "tile_mma_kernel", "_scalar_kernel"),
            per_call=len(calls))
        if library is not None:
            r["library_ms"] = library_ms(library, time_cuda)
            r["library_device_ms"] = busy_of(lambda _: library())
            with_cat = []
            for _ in range(3):
                r["ms"] = min(r["ms"], time_cuda(kern)["min_ms"])
                with_cat.append(time_cuda(cat)["min_ms"])
            r["ms_with_cat"] = min(with_cat)
        return r

    # panel_spmm on the ECFP forward segments: one global X, windowed
    D = opF.fwd.dense
    x_rows = D.seg_cols
    K_rows = len(D.segments) * x_rows
    D_csr = bsr_csr(D)
    pan = [(b.start_slab[s0:s1], b.panels[s0:s1], si * x_rows)
           for si, S in enumerate(D.segments)
           for b, s0, s1, _ in bo._bsr_layout(S)]
    pan_bytes = sum(p.numel() for _, p, _ in pan)
    pan_rows = sum(p.shape[0] * p.shape[1] for _, p, _ in pan)
    pan_live = sum(live_x_rows(p) for _, p, _ in pan)
    pan_all = sum(p.shape[0] * -(-p.shape[1] // 8) * p.shape[2]
                  for _, p, _ in pan)
    modes = {}
    for N in (32, 128, 256):
        X = torch.from_numpy(g.standard_normal(
            (D.shape[1], N)).astype(np.float32)).cuda()
        nq = bo._narrow_nq(N)
        if nq:
            Xg, fold = bo._pack_narrow_planes(X, K_rows, nq), False
        else:
            Xg, fold = bo._padded_x(X, K_rows, bo._round_up(N, 128)), "f32"

        def fn(st, pn, rb, plain=False):
            f = TT.panel_spmm_plain if plain else TT.panel_spmm
            return f(st, pn, Xg, tile_k=128, fold=fold, row_base=rb)

        r = run_set(f"panel_spmm[N={N}]", fn,
                    lambda *c: fn(*c, plain=True), pan,
                    library=lambda: torch.sparse.mm(D_csr, X))
        r.update(bound(pan_bytes + Xg.numel() * Xg.element_size()
                       + pan_rows * Xg.shape[1] * 4, 6 * D.nnz * N,
                       BF16_OPS_PER_S))
        r["shape"] = [len(pan), pan_rows, N]
        print(f"  panel_spmm N={N}: {len(pan)} launches, device_ms="
              f"{r['device_ms']!r} bound_ms={r['bound_ms']!r} "
              f"({r['bound_by']}) cuSPARSE {r['library_ms']!r}", flush=True)
        tile_set_diag(f"panel_spmm N={N}", r, len(pan), stream_us, pan_live,
                      pan_all, Xg.shape[1] * Xg.element_size())
        modes[f"N={N}"] = r
    row = dict(modes["N=128"])
    row["max_abs_err"] = max(v["max_abs_err"] for v in modes.values())
    row["modes"] = modes
    res["panel_spmm"] = row

    # bucket_spmm on the ECFP transpose tiling's largest segment
    S = max(opT.bwd.dense.segments, key=lambda s: s.padded_tiles)
    S_csr = bsr_csr(S)
    K = S.n_slabs * S.tile_k
    tiles = [(b.slab_ids[s0:s1], b.tiles[s0:s1])
             for b, s0, s1, _ in bo._bsr_layout(S)]
    t_bytes = sum(t.numel() * 2 for _, t in tiles)
    t_rows = sum(t.shape[0] * t.shape[2] for _, t in tiles)
    t_live = sum(live_x_rows(t) for _, t in tiles)
    t_all = sum(t.shape[0] * t.shape[1] * -(-t.shape[2] // 8) * t.shape[3]
                for _, t in tiles)
    modes = {}
    for N in (32, 128):
        X = torch.from_numpy(g.standard_normal(
            (S.shape[1], N)).astype(np.float32)).cuda()
        nq = bo._narrow_nq(N)
        if nq:
            Xp, planes = bo._pack_narrow_planes(X, K, nq), 1
        else:
            Xp, planes = bo._stack_planes(bo._padded_x(X, K, 128), 128,
                                          128), 3
        r = run_set(
            f"bucket_spmm[N={N}]",
            lambda sl, t: TT.bucket_spmm(sl, t, Xp, n_block=128,
                                         planes=planes),
            lambda sl, t: TT.bucket_spmm_plain(sl, t, Xp, n_block=128,
                                               planes=planes), tiles,
            library=lambda: torch.sparse.mm(S_csr, X))
        r.update(bound(t_bytes + Xp.numel() * 2 + t_rows * 128 * 4,
                       6 * S.nnz * N, BF16_OPS_PER_S))
        r["shape"] = [len(tiles), S.padded_tiles, N]
        print(f"  bucket_spmm N={N}: {len(tiles)} launches over "
              f"{S.padded_tiles} padded tiles "
              f"({[tuple(t.shape[:2]) for _, t in tiles]}), device_ms="
              f"{r['device_ms']!r} bound_ms={r['bound_ms']!r} "
              f"({r['bound_by']}) cuSPARSE {r['library_ms']!r}", flush=True)
        tile_set_diag(f"bucket_spmm N={N}", r, len(tiles), stream_us, t_live,
                      t_all, Xp.shape[1] * 2)
        modes[f"N={N}"] = r
    row = dict(modes["N=128"])
    row["max_abs_err"] = max(v["max_abs_err"] for v in modes.values())
    row["modes"] = modes
    res["bucket_spmm"] = row

    # bucket_spmv on that segment and on config B's tile segment
    modes = {}
    for name, S in (("ecfp bwd", S), ("config B", opB.fwd.dense.segments[0])):
        S_csr = bsr_csr(S)
        x = torch.from_numpy(g.standard_normal(
            S.shape[1]).astype(np.float32)).cuda()
        xp = bo._padded_x(x[:, None], S.n_slabs * S.tile_k, 1).reshape(
            S.n_slabs, S.tile_k)
        parts = [(b.slab_ids[s0:s1], b.tiles[s0:s1], xp)
                 for b, s0, s1, _ in bo._bsr_layout(S)]
        x1 = x[:, None].contiguous()
        r = run_set(f"bucket_spmv[{name}]", TT.bucket_spmv,
                    TT.bucket_spmv_plain, parts,
                    library=lambda: torch.sparse.mm(S_csr, x1))
        nb = sum(t.numel() * t.element_size() for _, t, _ in parts)
        out = sum(t.shape[0] * t.shape[2] for _, t, _ in parts)
        r.update(bound(nb + xp.numel() * 4 + out * 4, 2 * S.nnz,
                       F32_OPS_PER_S))
        r["shape"] = [len(parts), S.padded_tiles]
        dev, lib_dev = r["device_ms"], r["library_device_ms"]
        print(f"  bucket_spmv {name}: {len(parts)} launches, device_ms="
              f"{dev!r} bound_ms={r['bound_ms']!r} ({r['bound_by']}) "
              f"cuSPARSE {r['library_ms']!r}, device_ms {lib_dev!r}; device "
              f"ratio {None if not (dev and lib_dev) else dev / lib_dev!r}x",
              flush=True)
        # each launch alone, beside cuSPARSE on that bucket's CSR alone
        per = []
        for k, (sl, t, xq) in enumerate(parts):
            csr = tile_part_csr(sl, t, S.shape[1])
            per.append(device_pair(
                f"bucket_spmv[{name} launch {k}: {tuple(t.shape[:3])}]",
                lambda: TT.bucket_spmv(sl, t, xq),
                lambda: torch.sparse.mm(csr, x1), ("bucket_spmv_kernel",)))
        r["launch_device_ms"] = [p["device_ms"] for p in per]
        r["bucket_library_device_ms"] = [p["library_device_ms"] for p in per]
        r["launch_queued_ms"] = [p["queued_ms"] for p in per]
        r["bucket_library_queued_ms"] = [p["library_queued_ms"] for p in per]
        print(f"  bucket_spmv {name} per launch: device_ms "
              f"{r['launch_device_ms']!r}, cuSPARSE per bucket device_ms "
              f"{r['bucket_library_device_ms']!r}; queued "
              f"{r['launch_queued_ms']!r}, cuSPARSE "
              f"{r['bucket_library_queued_ms']!r}", flush=True)
        modes[name] = r
    row = dict(modes["ecfp bwd"])
    row["max_abs_err"] = max(v["max_abs_err"] for v in modes.values())
    row["modes"] = modes
    res["bucket_spmv"] = row
    return res


def tile_k_check(ft):
    """A tile_k=512 tile-bucket product on the card against the same
    layout's product by the plain versions (built on the CPU) and against
    scipy."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    g = np.random.default_rng(23)
    n, nnz = 2048, 8_000
    m = sp.coo_matrix((np.ones(nnz, np.float32), (g.integers(0, n, nnz),
                       g.integers(0, n, nnz))), shape=(n, n))
    m.sum_duplicates()
    m.data[:] = 1.0
    m = m.tocsr()
    # mono and class panels off: tile buckets, bucket_spmm's layout
    cfg = ft.Config(tile_m=8, tile_k=512, bsr_mono="off", bsr_panels="off")
    ops = {dev: ft.operator(m, format="bsr", transpose=False, config=cfg,
                            device=dev) for dev in ("cuda", "cpu")}
    A = ops["cuda"].fwd
    check(A.tile_k == 512 and not A.is_mono and not A.is_panel,
          f"tile_k=512: layout {bsr_desc(A)}")
    Xn = g.standard_normal((n, 128)).astype(np.float32)
    yk = ops["cuda"].matmat(torch.from_numpy(Xn).cuda()).cpu()
    yp = ops["cpu"].matmat(torch.from_numpy(Xn))
    rel_p = rel_err(yk.numpy(), yp.double().numpy())
    rel_s = rel_err(yk.numpy(), m.astype(np.float64) @ Xn.astype(np.float64))
    print(f"tile_k=512 ({bsr_desc(A)}) matmat N=128: rel vs plain "
          f"{rel_p!r}, vs scipy {rel_s!r}", flush=True)
    check(rel_p <= REL_TOL and rel_s <= REL_TOL, "tile_k=512 product")


def tile_main_phase(ft, K, EK, TT, opF, opT, opB, mE, mB, time_cuda):
    """BASELINE config 3 as called, the Macau step on its two tilings and
    config B as bench.py calls it, counted and checked against scipy."""
    import numpy as np
    import torch

    g = np.random.default_rng(19)
    nE, fE = mE.shape
    Xn = {N: g.standard_normal((fE, N)).astype(np.float32)
          for N in (32, 128, 256)}
    xn = Xn[32][:, 0].copy()
    Rn = g.standard_normal((nE, 32)).astype(np.float32)
    XBn = g.standard_normal((mB.shape[1], 128)).astype(np.float32)
    xBn = XBn[:, 0].copy()
    X = {N: torch.from_numpy(v).cuda() for N, v in Xn.items()}
    x, R = torch.from_numpy(xn).cuda(), torch.from_numpy(Rn).cuda()
    XB, xB = torch.from_numpy(XBn).cuda(), torch.from_numpy(xBn).cuda()
    torch.cuda.synchronize()

    from fastsparse_torch.ops.kernels import assemble as AK

    reg = 50.0
    for c in (K, EK, TT, AK):
        c.reset_launches()
    eF, eT, eB = eager_first(opF), eager_first(opT), eager_first(opB)
    Y = {N: eF.matmat(v) for N, v in X.items()}
    y = eF.matvec(x)
    rhs = eT.rmatmat(R)
    sol = ft.cg_normal(eT, rhs, reg=reg, maxiter=30)
    YB = eB.matmat(XB)
    yB = eB.matvec(xB)
    torch.cuda.synchronize()
    counts = dict(K.launches, **EK.launches, **TT.launches, **AK.launches)
    print(f"tile main-path launches: {counts}", flush=True)

    mE64, mB64 = mE.astype(np.float64), mB.astype(np.float64)
    outs = {f"ecfp-auto.matmat N={N}": (Y[N], mE64 @ Xn[N].astype(np.float64),
                                        REL_TOL) for N in Y}
    outs["ecfp-auto.matvec"] = (y, mE64 @ xn.astype(np.float64), REL_TOL)
    outs["ecfp-auto2.rmatmat N=32"] = (rhs, mE64.T @ Rn.astype(np.float64),
                                       REL_TOL)
    outs["configB-degree.matmat N=128"] = (YB, mB64 @ XBn.astype(np.float64),
                                           1e-5)
    outs["configB-degree.matvec"] = (yB, mB64 @ xBn.astype(np.float64), 1e-5)
    rels = {}
    for name, (out, ref, tol) in outs.items():
        check(tuple(out.shape) == ref.shape and out.dtype == torch.float32
              and out.is_cuda, f"{name}: {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite values")
        rels[name] = rel_err(out.cpu().numpy(), ref)
        check(rels[name] < tol, f"{name} rel {rels[name]}")
    print(f"tile rel vs scipy f64: {rels}", flush=True)
    xs = sol.x.cpu().numpy().astype(np.float64)
    b = rhs.cpu().numpy().astype(np.float64)
    r_true = np.linalg.norm(b - (mE64.T @ (mE64 @ xs) + reg * xs), axis=0)
    r0 = np.linalg.norm(b, axis=0)
    print(f"Macau step on operator(m, reorder='auto') N=32: iters="
          f"{sol.iters} resnorm/initial max={float((r_true / r0).max())!r}",
          flush=True)
    check(bool(np.all(r_true < 3e-3 * r0)), "cg_normal: residual did not fall")
    for name in ("bucket_spmm", "panel_spmm", "bucket_spmv", "plan_sum"):
        check(counts[name] > 0, f"kernel {name} never launched on the tile path")

    products = {f"ecfp-auto.matmat N={N}": (opF.matmat, v)
                for N, v in X.items()}
    products["ecfp-auto.matvec"] = (opF.matvec, x)
    products["ecfp-auto2.rmatmat N=32"] = (opT.rmatmat, R)
    products["ecfp-auto2.normal_matmat N=32"] = (
        lambda V: opT.normal_matmat(V, reg=reg), rhs)
    products["configB-degree.matmat N=128"] = (opB.matmat, XB)
    products["configB-degree.matvec"] = (opB.matvec, xB)
    time_products(products, time_cuda, (K, EK, TT, AK))
    return counts


def tiling_plans(name, t):
    """``{label: (plan, strip height or None)}`` of a tiling's parts that
    carry an assembly plan (a ColSegmented's plan sums strips of its
    segments' tile height)."""
    if t is None:
        return {}
    if type(t).__name__ == "HybridMatrix":
        return {**tiling_plans(name + ".sparse", t.sparse),
                **tiling_plans(name + ".dense", t.dense)}
    plan = getattr(t, "plan", None)
    if plan is None:
        return {}
    if type(t).__name__ == "ColSegmented":
        return {name + ".colseg": (plan, t.segments[0].tile_m)}
    return {name: (plan, None)}


def rmat_main_phase(ft, K, EK, TT, AK, time_cuda):
    """The R-MAT graph at scale 18 through ``reorder="auto"``: its layout,
    matmat N=128 counted and checked against scipy f64, timed; returns its
    forward tiling's plans and the launch counts."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    m = ft.bench.matrices.rmat(18, 16, seed=3)
    gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = ft.operator(m, reorder="auto", transpose=False)
    torch.cuda.synchronize()
    plans = tiling_plans("rmat18.fwd", op.fwd)
    print(f"rmat18 nnz={m.nnz} (generated in {gen!r} s) operator build "
          f"{time.perf_counter() - t0!r} s: {type(op.fwd).__name__}, plans "
          + ", ".join(f"{k}: {len(p.widths)} classes, {len(p.row_srcs)} "
                      f"row levels, {p.src.numel()} sources"
                      for k, (p, _) in plans.items()), flush=True)
    check(any(TM and p.row_srcs for p, TM in plans.values())
          and any(TM is None for p, TM in plans.values()),
          "rmat18: no cross-segment row plan beside an ELL plan")
    Xn = np.random.default_rng(23).standard_normal(
        (m.shape[1], 128)).astype(np.float32)
    X = torch.from_numpy(Xn).cuda()
    for c in (K, EK, TT, AK):
        c.reset_launches()
    Y = eager_first(op).matmat(X)
    torch.cuda.synchronize()
    counts = dict(K.launches, **EK.launches, **TT.launches, **AK.launches)
    print(f"rmat18 main-path launches: {counts}", flush=True)
    check(tuple(Y.shape) == (m.shape[0], 128) and Y.dtype == torch.float32
          and bool(torch.isfinite(Y).all()), f"rmat18.matmat: {Y.shape}")
    rel = rel_err(Y.cpu().numpy(),
                  m.astype(np.float64) @ Xn.astype(np.float64))
    print(f"rmat18.matmat N=128 rel vs scipy f64: {rel!r}", flush=True)
    check(rel < REL_TOL, f"rmat18.matmat rel {rel}")
    check(counts["plan_sum"] == len(plans),
          f"rmat18: {counts['plan_sum']} plan kernel launches for "
          f"{len(plans)} plans")
    time_products({"rmat18.matmat N=128": (op.matmat, X)}, time_cuda,
                  (K, EK, TT, AK))
    return plans, counts


def plan_kernel_phase(plans, time_cuda):
    """The plan kernel against its plain version on the same card tensors
    (bit for bit, -0.0 planted) at N = 1, 32, 128 on each plan, timed
    beside the least time of its bytes; the result row is R-MAT's ELL
    plan at N=128, every plan and N under ``modes``."""
    import torch

    from fastsparse_torch.bench.spmv_kernels import kernel_device_ms
    from fastsparse_torch.ops import assemble
    from fastsparse_torch.ops.ell_ops import _lanes

    g = torch.Generator("cuda").manual_seed(29)
    modes = {}
    for name, (plan, TM) in plans.items():
        nrow, S = plan.row_ptr.numel() - 1, plan.src.numel()
        live = int((plan.row_ptr[1:] > plan.row_ptr[:-1]).sum())
        for N in (1, 32, 128):
            L = _lanes(N)
            # a cross-segment plan sums its strips' rows (``row_srcs``) or
            # whole strips of TM rows; an ELL plan its part slots
            n, width = ((plan.n_slots * TM, L) if TM and plan.row_srcs else
                        (plan.n_slots, L * (TM or 1)))
            P = torch.randn((n, width), device="cuda", generator=g)
            P[torch.rand(n, device="cuda", generator=g) < 0.3] = -0.0
            P[torch.rand((n, width), device="cuda", generator=g) < 0.1] = -0.0
            label = f"plan_sum[{name} N={N}]"
            r, yk = compare(label, assemble.sum_plan, assemble.plain_sum,
                            True, (plan, P), {}, time_cuda, quick=True)
            yp = assemble.plain_sum(plan, P)
            torch.cuda.synchronize()
            check(torch.equal(yk.view(torch.int32), yp.view(torch.int32)),
                  f"{label}: not bit-equal (signed zeros)")
            nbytes = (S + nrow) * width * 4 + (S + nrow + 1) * 4
            r.update(bound(nbytes, (S - live) * width, F32_OPS_PER_S))
            r["device_ms"] = kernel_device_ms(
                lambda: assemble.sum_plan(plan, P), ("plan_sum_kernel",))
            r["shape"] = [nrow, S, width, plan.n_levels]
            print(f"  {label}: rows={nrow} sources={S} width={width} "
                  f"levels={plan.n_levels} bound_ms={r['bound_ms']!r} "
                  f"({r['bound_by']}) device_ms={r['device_ms']!r}",
                  flush=True)
            modes[f"{name} N={N}"] = r
            del P, yk, yp
    row = dict(modes["rmat18.fwd.sparse N=128"])
    row["max_abs_err"] = max(r["max_abs_err"] for r in modes.values())
    row["library_ms"] = None  # no one PyTorch call sums a plan
    row["modes"] = modes
    return {"plan_sum": row}


def largest_dd_bucket(A, valued, key=lambda b: b.cols.numel()):
    """(offset, segment, bucket, lo bucket or None) of the bucket with the
    most slots (or the largest ``key``) in a DdEll (valued) or a unit ELL
    tiling."""
    from fastsparse_torch.ops.ell_ops import _segments

    if valued:
        items = [(off, sh, b, bl)
                 for (off, sh), (_, sl) in zip(_segments(A.hi), _segments(A.lo))
                 for b, bl in zip(sh.buckets, sl.buckets)]
    else:
        items = [(off, seg, b, None) for off, seg in _segments(A)
                 for b in seg.buckets]
    return max(items, key=lambda it: key(it[2]))


def dd_kernel_run(DK, name, cols, vh, vl, x2, time_cuda, device=False):
    """One dd kernel against its plain version on the same card tensors
    (bit-equal in hi and lo), timed beside it, its bound and cuSPARSE's
    f64 product of the same rows (``device``: also both device times)."""
    import torch

    from fastsparse_torch.bench.spmv_kernels import dd_work, gather_csr

    valued = vh is not None
    if valued:
        def kern():
            return DK.ell_bucket_spmm_dd_valued(cols, vh, vl, x2)

        def plain():
            return DK.ell_bucket_spmm_dd_valued_plain(cols, vh, vl, x2)
    else:
        def kern():
            return DK.ell_bucket_spmm_dd(cols, x2)

        def plain():
            return DK.ell_bucket_spmm_dd_plain(cols, x2)
    yk = kern()
    torch.cuda.synchronize()
    yp = plain()
    torch.cuda.synchronize()
    for part, k, p in zip(("hi", "lo"), yk, yp):
        check(k.shape == p.shape and k.dtype == p.dtype == torch.float32,
              f"{name}: {part} {tuple(k.shape)} {k.dtype}")
        check(torch.equal(k, p), f"{name}: {part} not bit-equal to plain "
              f"(max|d|={(k.double() - p.double()).abs().max().item()!r})")
    d = max((k.double() - p.double()).abs().max().item()
            for k, p in zip(yk, yp))
    tk = time_cuda(kern)
    tp = time_cuda(plain, reps=2, batches=3, warmup=1)
    nb, K = cols.shape
    k_rows, L = x2.shape[0] // 2, x2.shape[1]
    r = {"max_abs_err": d, "ms": tk["min_ms"], "plain_ms": tp["min_ms"],
         "shape": [nb, K, L]}
    r.update(bound(*dd_work(cols, L, valued), F32_OPS_PER_S))
    vals = (vh.double() + vl.double()) if valued else torch.ones(
        (nb, K), dtype=torch.float64, device=cols.device)
    Acsr = gather_csr(cols, vals, k_rows)
    X64 = (x2[:k_rows].double() + x2[k_rows:].double()).contiguous()
    r["library_ms"] = library_ms(lambda: torch.sparse.mm(Acsr, X64),
                                 time_cuda)
    print(f"kernel {name}: bit-equal, ms={r['ms']!r} plain_ms="
          f"{r['plain_ms']!r} bound_ms={r['bound_ms']!r} ({r['bound_by']}) "
          f"cuSPARSE f64 {r['library_ms']!r}", flush=True)
    if device:
        r.update(device_pair(name, kern, lambda: torch.sparse.mm(Acsr, X64),
                             ("ell_dd_split_kernel", "ell_dd_rows_kernel")))
    return r


def dd_kernel_phase(DK, A1, A2d, opBu, time_cuda):
    """Each dd kernel against its plain version at the main path's shapes:
    #13 on config 1's and config 2-fp64's largest DdEll bucket and on
    config 2-fp64's longest-row bucket, #12 on config B's largest unsplit
    unit bucket and on its longest-row one."""
    import numpy as np
    import torch

    from fastsparse_torch.ops.ell_ops import _dd_panel

    g = np.random.default_rng(29)

    def panel(off, seg, N):
        X = torch.from_numpy(g.standard_normal(
            (off + seg.shape[1], N))).cuda()
        xh = X.float()
        return _dd_panel(xh, (X - xh.double()).float(), off, seg.shape[1])

    modes = {}
    for cname, A, Ns in (("config 1", A1, (1,)), ("config 2-fp64", A2d,
                                                  (1, 32))):
        off, seg, b, bl = largest_dd_bucket(A, True)
        print(f"{cname} largest DdEll bucket {tuple(b.cols.shape)} "
              f"(segment at column {off})", flush=True)
        for N in Ns:
            modes[f"{cname},N={N}"] = dd_kernel_run(
                DK, f"ell_bucket_dd_valued[{cname},N={N}]", b.cols, b.vals,
                bl.vals, panel(off, seg, N), time_cuda,
                device=(cname, N) == ("config 2-fp64", 32))
    off, seg, b, bl = largest_dd_bucket(A2d, True,
                                        key=lambda b: b.cols.shape[::-1])
    print(f"config 2-fp64 longest-row DdEll bucket {tuple(b.cols.shape)} "
          f"(segment at column {off})", flush=True)
    for N in (1, 32):
        modes[f"config 2-fp64 longest,N={N}"] = dd_kernel_run(
            DK, f"ell_bucket_dd_valued[config 2-fp64 longest,N={N}]",
            b.cols, b.vals, bl.vals, panel(off, seg, N), time_cuda,
            device=N == 1)
    valued = dict(modes["config 1,N=1"])
    valued["max_abs_err"] = max(r["max_abs_err"] for r in modes.values())
    valued["modes"] = modes
    modes = {}
    for what, key in (("largest", lambda b: b.cols.numel()),
                      ("longest", lambda b: b.cols.shape[::-1])):
        off, seg, b, _ = largest_dd_bucket(opBu.fwd, False, key=key)
        print(f"config B {what} unit bucket {tuple(b.cols.shape)} (segment "
              f"at column {off})", flush=True)
        tag = "" if what == "largest" else f"{what},"
        for N in (1, 32):
            modes[f"{tag}N={N}"] = dd_kernel_run(
                DK, f"ell_bucket_dd[config B {what},N={N}]", b.cols, None,
                None, panel(off, seg, N), time_cuda, device=N == 32)
    unit = dict(modes["N=32"])
    unit["max_abs_err"] = max(r["max_abs_err"] for r in modes.values())
    unit["modes"] = modes
    return {"ell_bucket_dd": unit, "ell_bucket_dd_valued": valued}


def fp64_builds(ft, mB):
    """The fp64 path's matrices and layouts, each build timed on the host:
    BASELINE config 1 (operator and DdEll), config 2 in fp64 (DdEll) and
    config B's unit ELL operator, unsplit."""
    import numpy as np
    import torch

    from fastsparse_torch.bench.matrices import powerlaw

    out, secs = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0

    timed("m1", lambda: powerlaw(100_000, 100_000, 5_000_000, seed=0,
                                 alpha=1.0, dtype=np.float64))
    m1 = out["m1"]
    timed("op1", lambda: ft.operator(m1, format="ell", transpose=True,
                                     device="cuda"))
    timed("A1", lambda: ft.build_ell_dd(m1, device="cuda"))
    timed("m2d", lambda: powerlaw(20_000, 20_000, 1_000_000, seed=0,
                                  dtype=np.float64))
    timed("A2d", lambda: ft.build_ell_dd(out["m2d"], device="cuda"))
    timed("opBu", lambda: ft.operator(
        mB, format="ell", transpose=False,
        config=ft.Config(ell_split_rows=0), device="cuda"))
    print("fp64 host build s: " + ", ".join(
        f"{k}={v!r}" for k, v in secs.items()), flush=True)
    op1, A1, A2d, opBu = out["op1"], out["A1"], out["A2d"], out["opBu"]
    check(type(op1.fwd).__name__ == "SegmentedEll"
          and op1.fwd.dtype == torch.float64
          and all(s.split_rows == 0 for s in op1.fwd.segments),
          "config 1: operator(format='ell') is not an unsplit f64 ELL")
    check(len(A1.hi.segments) == 13, "config 1: DdEll is not 13 segments")
    check(len(opBu.fwd.segments) == 3 and opBu.fwd.segments[0].unit_vals
          and all(s.split_rows == 0 for s in opBu.fwd.segments),
          "config B: not 3 unsplit unit segments")
    print(f"config 1 nnz={m1.nnz}: operator segments "
          f"{[s.shape[1] for s in op1.fwd.segments]}, DdEll 13 segments "
          f"{sum(len(s.buckets) for s in A1.hi.segments)} buckets, padded "
          f"slots {A1.hi.padded_nnz}; config 2-fp64 nnz={out['m2d'].nnz}: "
          f"DdEll {len(A2d.hi.segments)} segments; config B unit "
          f"{sum(len(s.buckets) for s in opBu.fwd.segments)} buckets",
          flush=True)
    return m1, out["m2d"], op1, A1, A2d, opBu


def longest_dd_launches(fn, arg, tiling, name, top=5):
    """The longest dd kernel launches of one product under torch.profiler,
    each with its bucket's (segment, rows, slots): launches run in the
    order `ell_spmm_dd` walks the buckets. Returns ``{"launches",
    "device_us", "longest": [[us, segment, rows, slots], ...]}``, or None
    when the profiler's records do not match the buckets."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fastsparse_torch.ops.ell_ops import _segments

    shapes = [(si, *b.cols.shape) for si, (_, seg) in
              enumerate(_segments(tiling)) for b in seg.buckets]
    fn(arg)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(arg)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if "ell_dd" in e.name),
                     key=lambda e: e.time_range.start)
        us = [e.time_range.elapsed_us() for e in evs]
    except Exception as exc:  # the sandbox's profiler is untried
        print(f"{name} launches: not measured ({exc!r})", flush=True)
        return None
    if len(us) != len(shapes):
        print(f"{name} launches: {len(us)} kernel events for "
              f"{len(shapes)} buckets, not matched", flush=True)
        return None
    order = sorted(range(len(us)), key=lambda i: -us[i])[:top]
    print(f"{name}: {len(us)} dd launches, {sum(us)!r} us in all; longest "
          + ", ".join(f"{us[i]!r} us (segment {shapes[i][0]}, "
                      f"{shapes[i][1]} rows x {shapes[i][2]} slots)"
                      for i in order), flush=True)
    return {"launches": len(us), "device_us": sum(us),
            "longest": [[us[i], *shapes[i]] for i in order]}


def fp64_main_phase(ft, counters, DK, m1, m2d, mB, op1, A1, A2d, opBu,
                    time_cuda):
    """BASELINE config 1 both ways, config 2 in fp64 and the unit spmm_dd
    through the public API, counted and held to scipy f64 at 1e-10."""
    import numpy as np
    import torch

    x1n = np.random.default_rng(1).standard_normal(100_000)
    g = np.random.default_rng(31)
    x2n = g.standard_normal((20_000, 1))
    XBn = g.standard_normal((mB.shape[1], 32))
    x1 = torch.from_numpy(x1n).cuda()
    x2 = torch.from_numpy(x2n).cuda()
    XB = torch.from_numpy(XBn).cuda()
    torch.cuda.synchronize()

    for c in counters:
        c.reset_launches()
    y1 = eager_first(op1).matvec(x1)
    y1dd = ft.spmm_dd(A1, x1[:, None])
    y2dd = ft.spmm_dd(A2d, x2)
    YB = ft.spmm_dd(eager_first(opBu), XB)
    torch.cuda.synchronize()
    counts = {k: v for c in counters for k, v in c.launches.items()}
    print(f"fp64 main-path launches: {counts}", flush=True)
    outs = {"config1.operator.matvec": (y1, m1 @ x1n),
            "config1.spmm_dd": (y1dd[:, 0], m1 @ x1n),
            "config2-fp64.spmm_dd": (y2dd, m2d @ x2n),
            "configB-unit.spmm_dd N=32": (YB, mB.astype(np.float64) @ XBn)}
    rels = {}
    for name, (out, ref) in outs.items():
        check(tuple(out.shape) == ref.shape and out.dtype == torch.float64
              and out.is_cuda, f"{name}: {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite values")
        rels[name] = rel_err(out.cpu().numpy(), ref)
    print(f"fp64 rel vs scipy f64: {rels}", flush=True)
    for name, r in rels.items():
        check(r <= DD_TOL, f"{name} rel {r}")
    for name in ("ell_bucket_dd", "ell_bucket_dd_valued"):
        check(counts[name] > 0, f"kernel {name} never launched on the fp64 path")

    longest = {
        "ell_bucket_dd_valued": longest_dd_launches(
            lambda v: ft.spmm_dd(A2d, v), x2, A2d.hi, "config2-fp64.spmm_dd"),
        "ell_bucket_dd": longest_dd_launches(
            lambda v: ft.spmm_dd(opBu, v), XB, opBu.fwd,
            "configB-unit.spmm_dd N=32")}
    products = {
        "config1.operator.matvec": (op1.matvec, x1),
        "config1.spmm_dd": (lambda v: ft.spmm_dd(A1, v), x1[:, None]),
        "config2-fp64.spmm_dd": (lambda v: ft.spmm_dd(A2d, v), x2),
        "configB-unit.spmm_dd N=32": (lambda v: ft.spmm_dd(opBu, v), XB),
    }
    time_products(products, time_cuda, counters)
    return counts, longest


@contextlib.contextmanager
def smem_path():
    """``ell_ops.USE_SMEM_PATH`` on for the block, reset whatever happens."""
    from fastsparse_torch.ops import ell_ops

    ell_ops.USE_SMEM_PATH = True
    try:
        yield
    finally:
        ell_ops.USE_SMEM_PATH = False


def layout_launches(A):
    """Kernel launches of one product over an ELL tiling, by kernel, from
    the layout the dispatch walks (under the flag as it stands)."""
    from fastsparse_torch.ops import ell_ops

    kernel = {"chunk": "ell_bucket", "sweep": "ell_sweep",
              "smem": "ell_bucket_smem"}
    out = {}
    for seg in (A.segments if hasattr(A, "segments") else [A]):
        for _, mode, *_ in ell_ops._seg_layout(seg):
            out[kernel[mode]] = out.get(kernel[mode], 0) + 1
    return out


def smem_builds(ft, mA, mB):
    """Config A's and config B's ELL operators built under the flag."""
    import torch

    with smem_path():
        t0 = time.perf_counter()
        opA = ft.operator(mA, device="cuda")
        opB = ft.operator(mB, format="ell", transpose=False, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        perA, perB = layout_launches(opA.fwd), layout_launches(opB.fwd)
    print(f"USE_SMEM_PATH builds (A both tilings, B forward) {secs!r} s; "
          f"launches per product A {perA} (transpose {layout_launches(opA.bwd)})"
          f", B {perB}", flush=True)
    check(perA.get("ell_bucket_smem", 0) > 0 and
          perB.get("ell_bucket_smem", 0) > 0, "no whole-bucket item")
    return opA, opB, perA, perB


def smem_buckets(A):
    """(segment, bucket) of every whole-bucket item of a tiling."""
    from fastsparse_torch.ops import ell_ops

    with smem_path():
        return [(seg, b)
                for seg in (A.segments if hasattr(A, "segments") else [A])
                for b, mode, *_ in ell_ops._seg_layout(seg) if mode == "smem"]


def smem_kernel_phase(EK, opA_s, opB_s, time_cuda):
    """ell_bucket_smem against its plain version on config A's and config
    B's whole buckets (bit-exact), timed beside its bound and cuSPARSE."""
    import numpy as np
    import torch

    from fastsparse_torch.bench.spmv_kernels import gather_csr
    from fastsparse_torch.ops import ell_ops

    g = np.random.default_rng(37)
    itemsA, itemsB = smem_buckets(opA_s.fwd), smem_buckets(opB_s.fwd)
    print("whole buckets: A " + ", ".join(
        f"{tuple(b.cols.shape)}" for _, b in itemsA) + "; B " + ", ".join(
        f"{tuple(b.cols.shape)}" for _, b in itemsB), flush=True)

    def widest(items, K=None):
        pick = [(s, b) for s, b in items if K is None or b.width == K]
        check(bool(pick), f"no whole bucket of width {K}")
        return max(pick, key=lambda sb: (sb[1].width, sb[1].cols.shape[0]))

    def panel(seg, N):
        X = torch.from_numpy(g.standard_normal(
            (seg.shape[1], N)).astype(np.float32)).cuda()
        return x_panel(X, ell_ops._round_up(seg.shape[1] + 1, 8))

    modes = {}
    segA, bA = widest(itemsA)
    cases = [("A", segA, bA, 128), ("A", segA, bA, 1),
             ("A", *widest(itemsA, 40), 128),
             ("B", *widest(itemsB, 32), 128), ("B", *widest(itemsB, 12), 128)]
    for cname, seg, b, N in cases:
        unit = seg.unit_vals
        x = panel(seg, N)
        nb, K = b.cols.shape
        name = f"{cname} {nb}x{K} {'unit' if unit else 'valued'},N={N}"
        r, _ = compare(f"ell_bucket_smem[{name}]", EK.ell_bucket_spmm_smem,
                       EK.ell_bucket_spmm_smem_plain, True,
                       (b.cols, b.vals, x), dict(unit=unit), time_cuda,
                       quick=True)
        r.update(ell_gather_bound(b.cols, 0 if unit else 4, 4, x, unit))
        Acsr = gather_csr(b.cols, torch.ones_like(b.vals) if unit else b.vals,
                          x.shape[0])
        r["library_ms"] = library_ms(lambda: torch.sparse.mm(Acsr, x),
                                     time_cuda)
        r["shape"] = [nb, K, N]
        print(f"  bound_ms={r['bound_ms']!r} ({r['bound_by']}) "
              f"cuSPARSE {r['library_ms']!r}", flush=True)
        if b is bA:
            r.update(device_pair(
                f"ell_bucket_smem[{name}]",
                lambda: EK.ell_bucket_spmm_smem(b.cols, b.vals, x, unit=unit),
                lambda: torch.sparse.mm(Acsr, x), ("ell_smem",)))
        modes[name] = r
    row = dict(next(iter(modes.values())))
    row["max_abs_err"] = max(r["max_abs_err"] for r in modes.values())
    row["modes"] = modes
    return {"ell_bucket_smem": row}


def smem_main_phase(EK, opA, opB, opA_s, opB_s, perA, perB, mA, mB,
                    time_cuda):
    """Config A and B products under the flag through the public API,
    counted, checked and timed beside the same products with it off."""
    import numpy as np
    import torch

    from fastsparse_torch.ops import assemble

    g = np.random.default_rng(39)
    XAn = g.standard_normal((mA.shape[1], 128)).astype(np.float32)
    xAn = XAn[:, 0].copy()
    XBn = g.standard_normal((mB.shape[1], 128)).astype(np.float32)
    XA, xA = torch.from_numpy(XAn).cuda(), torch.from_numpy(xAn).cuda()
    XB = torch.from_numpy(XBn).cuda()
    torch.cuda.synchronize()
    with smem_path():
        for name, op in (("A", opA_s), ("B", opB_s)):
            plan = op.fwd.plan
            _, _, rows, _ = ell_layout_stats(op.fwd)
            check(plan is not None and plan.layout_key == assemble.layout_key()
                  and plan.n_slots == rows,
                  f"config {name}: the flag's plan is not the one used")
        EK.reset_launches()
        eA, eB = eager_first(opA_s), eager_first(opB_s)
        ya = eA.matvec(xA)
        Ya = eA.matmat(XA)
        Yb = eB.matmat(XB)
        torch.cuda.synchronize()
        counts = dict(EK.launches)
        print(f"USE_SMEM_PATH main-path launches: {counts}", flush=True)
        want = {k: 2 * perA.get(k, 0) + perB.get(k, 0) for k in counts}
        check(counts == want, f"launches {counts}, the layouts give {want}")
        check(counts["ell_bucket_smem"] > 0,
              "kernel ell_bucket_smem never launched on its path")
        mA64, mB64 = mA.astype(np.float64), mB.astype(np.float64)
        outs = {"A.matvec": (ya, mA64 @ xAn.astype(np.float64)),
                "A.matmat": (Ya, mA64 @ XAn.astype(np.float64)),
                "B.matmat": (Yb, mB64 @ XBn.astype(np.float64))}
        rels = {}
        for name, (out, ref) in outs.items():
            check(tuple(out.shape) == ref.shape and out.dtype == torch.float32
                  and out.is_cuda, f"{name}: {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out).all()), f"{name}: non-finite")
            rels[name] = rel_err(out.cpu().numpy(), ref)
        print(f"USE_SMEM_PATH rel vs scipy f64: {rels}", flush=True)
        for name, r in rels.items():
            check(r < (1e-5 if name.startswith("B") else REL_TOL),
                  f"flag on: {name} rel {r}")
        time_products({"A.matvec [flag on]": (opA_s.matvec, xA),
                       "A.matmat N=128 [flag on]": (opA_s.matmat, XA),
                       "B.matmat N=128 [flag on]": (opB_s.matmat, XB)},
                      time_cuda, (EK,))
    time_products({"A.matvec [flag off]": (opA.matvec, xA),
                   "A.matmat N=128 [flag off]": (opA.matmat, XA),
                   "B.matmat N=128 [flag off]": (opB.matmat, XB)},
                  time_cuda, (EK,))
    return counts


def scatter_phase(ft, counters, m1, m2d, mA, time_cuda):
    """BASELINE configs 1 and 2 as their own words name them, and the
    scatter engines on config A, through the public API, against scipy."""
    import numpy as np
    import torch

    out, secs = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0

    timed("op1_csr", lambda: ft.operator(m1, format="csr", transpose=False,
                                         device="cuda"))
    timed("cA_hilbert", lambda: ft.sort_coo(
        ft.coo_from_scipy(mA, device="cuda"), "hilbert"))
    timed("c2d_hilbert", lambda: ft.sort_coo(
        ft.coo_from_scipy(m2d, device="cuda"), "hilbert"))
    timed("opA_coo", lambda: ft.operator(mA, format="coo", device="cuda"))
    timed("opA_ell_fwd", lambda: ft.operator(mA, transpose=False,
                                             device="cuda"))
    cooA = ft.coo_from_scipy(mA, device="cuda")
    print("scatter host build s: " + ", ".join(
        f"{k}={v!r}" for k, v in secs.items()), flush=True)
    op1, cA, c2d = out["op1_csr"], out["cA_hilbert"], out["c2d_hilbert"]
    opC, opE = out["opA_coo"], out["opA_ell_fwd"]
    check(type(op1.fwd).__name__ == "CSR" and op1.fwd.dtype == torch.float64
          and op1.fwd.n_valid == m1.nnz, "config 1: not an f64 CSR")
    check(type(opC.fwd).__name__ == "COO" and type(opE.fwd).__name__ ==
          "EllMatrix" and opE.bwd is None, "config A: unexpected tilings")
    print(f"config 1 CSR capacity {op1.fwd.nnz_cap} ({m1.nnz} live); "
          f"config 2 Hilbert COO {cA.nnz_cap} entries, first rows "
          f"{cA.rows[:4].tolist()}", flush=True)

    g = np.random.default_rng(41)
    x1n = g.standard_normal(m1.shape[1])
    xAn = g.standard_normal(mA.shape[1]).astype(np.float32)
    x2n = g.standard_normal(m2d.shape[1])
    yAn = g.standard_normal(mA.shape[0]).astype(np.float32)
    XAn = g.standard_normal((mA.shape[1], 128)).astype(np.float32)
    X32n = XAn[:, :32].copy()
    x1, xA, x2, yA, XA, X32 = (torch.from_numpy(v).cuda() for v in
                               (x1n, xAn, x2n, yAn, XAn, X32n))
    torch.cuda.synchronize()
    reg = 50.0
    for c in counters:
        c.reset_launches()
    res = {
        "config1.csr.matvec": op1.matvec(x1),
        "config2.hilbert-coo.spmv": ft.spmv(cA, xA),
        "config2-fp64.hilbert-coo.spmv": ft.spmv(c2d, x2),
        "A.coo.rmatvec": opC.rmatvec(yA),
        "A.coo.matmat N=128": opC.matmat(XA),
        "A.ell.rmatvec (scatter)": opE.rmatvec(yA),
        "A.ata_X N=32": ft.ata_X(cooA, X32, reg=reg),
    }
    torch.cuda.synchronize()
    counts = {k: v for c in counters for k, v in c.launches.items() if v}
    print(f"scatter phase kernel launches: {counts}", flush=True)
    mA64 = mA.astype(np.float64)
    X3264 = X32n.astype(np.float64)
    refs = {
        "config1.csr.matvec": (m1 @ x1n, torch.float64, DD_TOL),
        "config2.hilbert-coo.spmv": (mA64 @ xAn.astype(np.float64),
                                     torch.float32, REL_TOL),
        "config2-fp64.hilbert-coo.spmv": (m2d @ x2n, torch.float64, DD_TOL),
        "A.coo.rmatvec": (mA64.T @ yAn.astype(np.float64), torch.float32,
                          REL_TOL),
        "A.coo.matmat N=128": (mA64 @ XAn.astype(np.float64), torch.float32,
                               REL_TOL),
        "A.ell.rmatvec (scatter)": (mA64.T @ yAn.astype(np.float64),
                                    torch.float32, REL_TOL),
        "A.ata_X N=32": (mA64.T @ (mA64 @ X3264) + reg * X3264,
                         torch.float32, REL_TOL),
    }
    rels = {}
    for name, (ref, dt, tol) in refs.items():
        y = res[name]
        check(tuple(y.shape) == ref.shape and y.dtype == dt and y.is_cuda,
              f"{name}: {tuple(y.shape)} {y.dtype}")
        check(bool(torch.isfinite(y).all()), f"{name}: non-finite values")
        rels[name] = rel_err(y.cpu().numpy(), ref)
        check(rels[name] <= tol, f"{name} rel {rels[name]} > {tol}")
    print(f"scatter rel vs scipy f64: {rels}", flush=True)
    products = {
        "config1.csr.matvec": (op1.matvec, x1),
        "config2.hilbert-coo.spmv": (lambda v: ft.spmv(cA, v), xA),
        "config2-fp64.hilbert-coo.spmv": (lambda v: ft.spmv(c2d, v), x2),
        "A.coo.rmatvec": (opC.rmatvec, yA),
        "A.coo.matmat N=128": (opC.matmat, XA),
        "A.ell.rmatvec (scatter)": (opE.rmatvec, yA),
        "A.ata_X N=32": (lambda V: ft.ata_X(cooA, V, reg=reg), X32),
    }
    time_products(products, time_cuda, counters)
    t = time_cuda(lambda: ft.sort_coo(cooA, "hilbert"))
    print(f"ms sort_coo(config A, 'hilbert') on the card: min={t['min_ms']!r} "
          f"median={t['median_ms']!r}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "fastsparse_torch" / "__init__.py").is_file():
        print("chip_smoke: run from a checkout holding fastsparse_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import numpy as np

    import fastsparse_torch as ft
    from fastsparse_torch.bench.matrices import banded, ecfp_like, powerlaw
    from fastsparse_torch.bench.mono_products import mono_setup
    from fastsparse_torch.bench.timing import time_cuda
    from fastsparse_torch.ops.kernels import assemble as AK
    from fastsparse_torch.ops.kernels import bsr_spmm as K
    from fastsparse_torch.ops.kernels import bsr_tiles as TT
    from fastsparse_torch.ops.kernels import ell_dd as DK
    from fastsparse_torch.ops.kernels import ell_spmm as EK
    from fastsparse_torch.ops.kernels._build import (
        build_seconds,
        load_library,
        ptxas_report,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    lib = load_library()
    print(f"kernel build: {build_seconds()!r} s (load {time.perf_counter() - t0!r} s)",
          flush=True)
    engine_report(lib, ptxas_report)

    # headline operator (bench.py's matrix), dual tilings on the card, and
    # the entry operator: the mono products' set
    t0 = time.perf_counter()
    mono = mono_setup(ft, banded)
    mb, op, Xn, X = mono.mb, mono.op, mono.Xn, mono.X
    m2, op2, X2n, X2 = mono.m2, mono.op2, mono.X2n, mono.X2
    mono_products = mono.products
    fb = op.fwd.buckets[0]
    print(f"headline nnz={mb.nnz} build (with the entry operator) "
          f"{time.perf_counter() - t0:.1f} s: "
          f"tile_m={op.fwd.tile_m} W={fb.width} win={fb.win_slabs} "
          f"items={fb.ns} narrow={op.fwd.narrow is not None}", flush=True)
    check(op.fwd.is_mono and op.bwd.is_mono, "headline tilings not mono")
    check(op.fwd.narrow is not None, "headline has no halo layout")
    from fastsparse_torch.linops import _auto_format

    check(_auto_format(ft.binary_coo_from_scipy(mb, device="cuda"),
                       ft.DEFAULT, None) == "bsr",
          "format='auto' leaves the tile path on the headline")
    check(op2.fwd.is_mono and op2.bwd.is_mono, "entry tilings not mono")
    xn = Xn[:, 0].copy()
    x = X[:, 0].contiguous()
    Bn = np.random.default_rng(2).standard_normal((mb.shape[1], 32)).astype(
        np.float32
    )
    B = torch.from_numpy(Bn).cuda()
    torch.cuda.synchronize()
    # the mono products on the event clock before any torch.profiler
    # session in this process (time_products times them again after)
    for name, (fn, arg) in mono_products.items():
        t = time_cuda(fn, arg)
        print(f"ms/product {name} (before any profiler session): "
              f"min={t['min_ms']!r} median={t['median_ms']!r}", flush=True)

    engine_body_phase(K)
    ell_body_phase(EK, DK)
    kres = mono_kernel_phase(op, mb, X, K, time_cuda)

    # ---- mono main path through the public API
    K.reset_launches()
    EK.reset_launches()
    eM = eager_first(op)
    Y = eM.matmat(X)
    y = eM.matvec(x)
    Y2 = eager_first(op2).normal_matmat(X2, reg=0.1)
    sol = ft.cg_normal(eM, B, reg=50.0, maxiter=20)
    torch.cuda.synchronize()
    counts = {k: K.launches[k] for k in MONO_KERNELS}
    print(f"mono main-path launches: {dict(K.launches)}", flush=True)

    for name, out, shape in (("matmat", Y, (mb.shape[0], 128)),
                             ("matvec", y, (mb.shape[0],)),
                             ("normal_matmat", Y2, (m2.shape[1], 128)),
                             ("cg_normal", sol.x, (mb.shape[1], 32))):
        check(tuple(out.shape) == shape and out.dtype == torch.float32
              and out.is_cuda, f"{name}: {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite values")
    mb64 = mb.astype(np.float64)
    rel_mm = rel_err(Y.cpu().numpy(), mb64 @ Xn.astype(np.float64))
    rel_mv = rel_err(y.cpu().numpy(), mb64 @ xn.astype(np.float64))
    m264 = m2.astype(np.float64)
    X264 = X2n.astype(np.float64)
    rel_nm = rel_err(Y2.cpu().numpy(), m264.T @ (m264 @ X264) + 0.1 * X264)
    xs = sol.x.cpu().numpy().astype(np.float64)
    Bd = Bn.astype(np.float64)
    r_true = np.linalg.norm(Bd - (mb64.T @ (mb64 @ xs) + 50.0 * xs), axis=0)
    r0 = np.linalg.norm(Bd, axis=0)
    r_rep = sol.resnorm.cpu().numpy().astype(np.float64)
    cg_agree = float(np.abs(r_true - r_rep).max() / r_true.max())
    print(f"matmat N=128 rel={rel_mm!r}  matvec rel={rel_mv!r}  "
          f"normal_matmat rel={rel_nm!r}", flush=True)
    print(f"cg_normal iters={sol.iters} resnorm/initial max="
          f"{float((r_true / r0).max())!r} true-vs-reported={cg_agree!r}",
          flush=True)
    check(rel_mm < REL_TOL, f"matmat rel {rel_mm}")
    check(rel_mv < REL_TOL, f"matvec rel {rel_mv}")
    check(rel_nm < REL_TOL, f"normal_matmat rel {rel_nm}")
    check(bool(np.all(r_true < r0)), "cg_normal: residual did not fall")
    check(cg_agree < 1e-3, f"cg_normal: true vs reported residual {cg_agree}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} never launched on the main path")

    # ---- per-product times (after the counted run)
    t_mm = time_cuda(op.matmat, X)
    print(f"ms/product matmat N=128 (headline): min={t_mm['min_ms']!r} "
          f"median={t_mm['median_ms']!r}  Gnnz/s={mb.nnz / t_mm['min_ms'] / 1e6!r}",
          flush=True)
    time_products(mono_products, time_cuda, (K,))
    del op2, X2, Y2, B, sol, mono_products, mono

    # ---- the ELL gather engine: config A (BASELINE config 2), config B
    t0 = time.perf_counter()
    mA = powerlaw(20_000, 20_000, 1_000_000, seed=0, dtype=np.float32)
    opA = ft.operator(mA, device="cuda")
    torch.cuda.synchronize()
    build_A = time.perf_counter() - t0
    check(type(opA.fwd).__name__ == "EllMatrix" and opA.fwd.split_rows == 64,
          f"config A: format='auto' built {type(opA.fwd).__name__}")
    print(f"config A nnz={mA.nnz} operator build {build_A!r} s: "
          f"{len(opA.fwd.buckets)} buckets, widths "
          f"{[b.width for b in opA.fwd.buckets]}, padded slots "
          f"{opA.fwd.padded_nnz}, plan: {plan_ops(opA.fwd.plan)}",
          flush=True)
    t0 = time.perf_counter()
    mB = powerlaw(65_536, 65_536, 4_000_000, seed=0, binary=True)
    opB = ft.operator(mB, format="ell", transpose=False, device="cuda")
    torch.cuda.synchronize()
    build_B = time.perf_counter() - t0
    check(type(opB.fwd).__name__ == "SegmentedEll"
          and len(opB.fwd.segments) == 3, "config B: not 3 ELL segments")
    print(f"config B nnz={mB.nnz} operator build {build_B!r} s: segments of "
          f"{[s.shape[1] for s in opB.fwd.segments]} columns, "
          f"{[s.nnz for s in opB.fwd.segments]} nnz, padded slots "
          f"{opB.fwd.padded_nnz}, plan: {plan_ops(opB.fwd.plan)}",
          flush=True)
    cooA = ft.coo_from_scipy(mA, device="cuda")
    A_unsplit = ft.build_ell(cooA, split_rows=0, device="cuda")
    A_unsplit_bin = ft.build_ell(ft.binary_coo_from_scipy(mA, device="cuda"),
                                 split_rows=0, device="cuda")
    print(f"config A unsplit widths {[b.width for b in A_unsplit.buckets]}",
          flush=True)

    kres.update(ell_kernel_phase(EK, opA, A_unsplit, A_unsplit_bin, opB,
                                 time_cuda))
    del A_unsplit, A_unsplit_bin, cooA
    ell_counts = ell_main_phase(ft, K, EK, opA, mA, opB, mB, time_cuda)
    counts.update({k: ell_counts[k] for k in ("ell_bucket", "ell_sweep",
                                               "plan_sum")})
    # the plans the main paths apply, for the plan kernel phase
    plans = {**tiling_plans("configA.fwd", opA.fwd),
             **tiling_plans("configA.bwd", opA.bwd),
             **tiling_plans("configB.fwd", opB.fwd)}

    # ---- phase 11: the SMEM-blocked gather (USE_SMEM_PATH) on A and B
    opA_s, opB_s, perA, perB = smem_builds(ft, mA, mB)
    kres.update(smem_kernel_phase(EK, opA_s, opB_s, time_cuda))
    smem_counts = smem_main_phase(EK, opA, opB, opA_s, opB_s, perA, perB,
                                  mA, mB, time_cuda)
    counts["ell_bucket_smem"] = smem_counts["ell_bucket_smem"]
    del opA, opB, opA_s, opB_s

    # ---- the hybrid path: the ECFP Macau side-information matrix
    t0 = time.perf_counter()
    mE = ecfp_like(50_000, 20_000, 64, 400, seed=2)
    gen_E = time.perf_counter() - t0
    t0 = time.perf_counter()
    opE = ft.operator(mE)  # format="auto", transpose=True, on the card
    torch.cuda.synchronize()
    build_E = time.perf_counter() - t0
    print(f"ecfp nnz={mE.nnz} (generated in {gen_E!r} s) operator build "
          f"{build_E!r} s", flush=True)
    for name, H in (("  fwd", opE.fwd), ("  bwd", opE.bwd)):
        check(type(H).__name__ == "HybridMatrix" and H.dense is None
              and H.dense_cols is not None and H.dense_cols.block.is_cuda,
              f"ecfp: format='auto' built {type(H).__name__}")
        print(hybrid_layout(name, H), flush=True)
    kres.update(densecols_kernel_phase(K, opE, time_cuda))
    hyb_counts = hybrid_main_phase(ft, K, EK, opE, mE, time_cuda)
    counts["densecols"] = hyb_counts["densecols"]
    counts["plan_sum"] += hyb_counts["plan_sum"]
    plans.update({**tiling_plans("ecfp.fwd", opE.fwd),
                  **tiling_plans("ecfp.bwd", opE.bwd)})
    del opE

    # ---- the tile layouts: BASELINE config 3 and config B as called
    opF, opT, opB = tile_builds(ft, mE, mB)
    kres.update(tile_kernel_phase(TT, opF, opT, opB, time_cuda))
    tile_k_check(ft)
    tile_counts = tile_main_phase(ft, K, EK, TT, opF, opT, opB, mE, mB,
                                  time_cuda)
    counts.update({k: tile_counts[k]
                   for k in ("bucket_spmm", "panel_spmm", "bucket_spmv")})
    counts["plan_sum"] += tile_counts["plan_sum"]
    plans.update({k: v for k, v in tiling_plans("ecfp-auto2.bwd",
                                                opT.bwd).items()
                  if v[1] is not None})
    del opF, opT, opB

    # ---- the R-MAT graph, and the plan kernel on every plan above
    rmat_plans, rmat_counts = rmat_main_phase(ft, K, EK, TT, AK, time_cuda)
    counts["plan_sum"] += rmat_counts["plan_sum"]
    plans.update(rmat_plans)
    kres.update(plan_kernel_phase(plans, time_cuda))
    del plans, rmat_plans

    # ---- fp64: BASELINE config 1, config 2 in fp64, the unit dd form
    m1, m2d, op1, A1, A2d, opBu = fp64_builds(ft, mB)
    kres.update(dd_kernel_phase(DK, A1, A2d, opBu, time_cuda))
    dd_counts, longest = fp64_main_phase(ft, (K, EK, TT, DK), DK, m1, m2d,
                                         mB, op1, A1, A2d, opBu, time_cuda)
    for name, rec in longest.items():
        kres[name]["longest_launches"] = rec
    counts.update({k: dd_counts[k]
                   for k in ("ell_bucket_dd", "ell_bucket_dd_valued")})
    del op1, A1, A2d, opBu

    # ---- phase 12: the scatter engines, BASELINE configs 1 and 2 as named
    scatter_phase(ft, (K, EK, TT, DK), m1, m2d, mA, time_cuda)

    check("jax" not in sys.modules, "jax was imported")
    check(not any(k == "fastsparse" or k.startswith("fastsparse.")
                  for k in sys.modules), "the JAX package was imported")
    kernels = []
    for name in SOURCES:
        r = kres[name]
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": counts[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        entry.update({k: v for k, v in r.items()
                      if k.startswith("narrow_") or k in (
                          "modes", "parts", "device_ms", "library_device_ms",
                          "longest_launches")})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
