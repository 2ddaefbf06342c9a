"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use by ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with `ctypes` (no PyTorch
headers, so a build takes seconds, not minutes, and needs no ``ninja``). The library lands in ``fastsparse_torch/_build/`` under a name
keyed on a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded. A failed build raises. ptxas reports
each kernel's registers, spills and static shared memory (``-Xptxas -v``);
`ptxas_report` returns what this process's build printed.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_seconds", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false", "-Xptxas=-v",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the launchers in csrc/*.cu (every pointer and the stream
# as c_void_p: a bare Python int would be cut to 32 bits)
_SIGNATURES = {
    "fs_colmax": (_P, _I, _I, _P, _P),
    "fs_quant3": (_P, _P, _I, _I, _I, _P, _P),
    "fs_encode_colmax": (_P, _P, _I, _I, _L, _L, _P, _P),
    "fs_encode_planes": (_P, _P, _P, _I, _I, _L, _L, _I, _I, _I, _P, _P, _P),
    "fs_mono_panel": (_P,) * 7 + (_I,) * 11 + (_P,),
    "fs_mono_group": (_P, _P, _P, _P, _P) + (_I,) * 8 + (_P,),
    "fs_ell_bucket": (_P, _P, _P, _P) + (_I,) * 7 + (_P,),
    "fs_ell_sweep": (_P,) * 6 + (_I, _I, _P),
    "fs_ell_smem": (_P,) * 4 + (_I,) * 5 + (_P,),
    "fs_ell_table": (_P, _I, _P, _P) + (_I,) * 6 + (_P,),
    "fs_densecols": (_P,) * 4 + (_I,) * 4 + (_P,),
    "fs_s8_engine_smem": (_I, _I, _I, _P),
    "fs_bucket_spmm": (_P,) * 4 + (_I,) * 10 + (_P,),
    "fs_panel_spmm": (_P,) * 4 + (_I,) * 9 + (_P,),
    "fs_bucket_spmv": (_P,) * 4 + (_I,) * 5 + (_P,),
    "fs_ell_dd": (_P,) * 6 + (_I,) * 5 + (_P,),
    "fs_plan_sum": (_P,) * 4 + (_I,) * 4 + (_P,),
}

_build_seconds = 0.0
_ptxas = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    if home:
        cands.append(str(Path(home) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfastsparse_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raise on failure."""
    global _build_seconds, _ptxas
    out = _library_path()
    if not out.exists():
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        nvcc = _nvcc()
        objs, procs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = tmp.with_name(f"{tmp.stem}.{src.stem}.o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        results = [(p, *p.communicate()) for p in procs]
        for p, so, se in results:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{so}\n{se}")
        _ptxas = {obj.stem.rsplit(".", 1)[-1]: se
                  for obj, (_, _, se) in zip(objs, results)}
        _run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        for obj in objs:
            obj.unlink()
        os.replace(tmp, out)
        _build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def build_seconds() -> float:
    """Seconds the nvcc build took in this process (0 if it was cached)."""
    return _build_seconds


def ptxas_report(pattern: str = ""):
    """``{kernel: ptxas lines}`` from this process's build (empty if the
    library was cached) for the kernels whose mangled name holds
    ``pattern``: registers, spills, stack and static shared memory."""
    out = {}
    for text in _ptxas.values():
        name = None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "'" in line else line
                continue
            if name and pattern in name and (
                    "Used" in line or "spill" in line or "smem" in line):
                out.setdefault(name, []).append(line.strip())
    return out
