"""Helpers shared by the card test files (`test_torch_cuda.py`,
`test_torch_cuda_paths.py`) and the card tools (`chip_smoke.py`,
`fastsparse_torch/bench/kernels.py`). Nothing here touches a card at
import."""
import ctypes

import numpy as np
import torch


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


def kernel_names(fn):
    """Names of the CUDA kernels one call of ``fn`` launches: the kernel
    nodes of a CUDA graph captured from that call, named by the driver
    (``cuFuncGetName``; C++ names come mangled, so match substrings).
    No profiler: torch.profiler drops device records, more often the
    longer a process has run."""
    fn()  # the first call builds and loads what the capture needs
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    try:
        return " ".join(_graph_kernel_names(g.raw_cuda_graph()))
    finally:
        g.reset()


def _graph_kernel_names(graph):
    """``cuFuncGetName`` of every kernel node of a ``CUgraph``."""
    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def ok(rc, what):
        if rc:
            raise RuntimeError(f"{what}: CUresult {rc}")

    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(vp(graph), None, ctypes.byref(n)),
       "cuGraphGetNodes")
    nodes = (vp * n.value)()
    ok(cu.cuGraphGetNodes(vp(graph), nodes, ctypes.byref(n)),
       "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at 0, kern at 56 (64-bit)
        params = (ctypes.c_byte * 128)()
        ok(cu.cuGraphKernelNodeGetParams_v2(vp(node), params),
           "cuGraphKernelNodeGetParams")
        func = vp.from_buffer(params, 0).value
        if not func:
            kern, fptr = vp.from_buffer(params, 56).value, vp()
            ok(cu.cuKernelGetFunction(ctypes.byref(fptr), vp(kern)),
               "cuKernelGetFunction")
            func = fptr.value
        name = ctypes.c_char_p()
        ok(cu.cuFuncGetName(ctypes.byref(name), vp(func)), "cuFuncGetName")
        names.append(name.value.decode())
    return names


def neg_zero_parts(g, n, L):
    """f32 (n, L) on the CPU with -0.0 planted: whole rows, single entries."""
    P = g.standard_normal((n, L)).astype(np.float32)
    P[g.random(n) < 0.3] = -0.0
    P[g.random((n, L)) < 0.1] = -0.0
    return torch.from_numpy(P)


def same_bits(a, b):
    """Equal shapes and bit patterns (signed zeros told apart)."""
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))
