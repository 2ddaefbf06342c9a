"""Repeated products replayed as CUDA graphs.

A `SparseOperator` walks layouts fixed when it was built, so each call of
a product with the same operand shape issues the same device operations,
in the same order, with the same shapes: a Macau step's ``normal_matmat``
at N=32 is about 250 of them, each one shorter on the card than it takes
Python and torch to enqueue. `ProductGraphs` is an operator's cache of
captured products. For each key (the product, the operand's shape, dtype
and device, the current stream, the tiling it starts from and ``reg``):

* the first call runs eagerly, as every call on the CPU does;
* the second captures the whole product under one CUDA graph and replays
  it;
* every later call copies the operand into the graph's static input,
  replays the graph (one ``cudaGraphLaunch`` on the current stream) and
  returns a clone of its static output, so no result aliases another or
  the graph's memory.

Every kernel and torch op of the product still runs, in the same order,
on the same data: the graph only takes away the host's enqueue of each.
Only the outermost product of a nest is captured or looked up, so a
``normal_matmat`` is one graph over both tilings and the boundary gathers.
A capture that raises (a path that reads device data on the host) marks
its key eager for the cache's lifetime. Operands the graph cannot serve
as they are run eagerly too: CPU tensors, non-contiguous ones, operands
on another device than the current one, operands that need a gradient,
a ``reg`` that is not a number, and calls made while the current stream
is already capturing.

Tracing: a replay is a span ``replay`` (attrs ``op``, ``N``) inside the
product's span, with three ``ops`` (the copy-in, the graph launch, the
clone) and one ``replays``; a capture counts one ``captures`` and its own
three ops in the product's span, a capture that raised one
``graph_refused``. A graph keeps what its capture counted of `REPLAYED`
(traced or not), and each replay counts that again in its span: the
work it runs, where ``ops`` counts only the host's enqueues. As the
tracing, the cache expects an operator's calls from one thread.
"""
from __future__ import annotations

import torch

from . import tracing

__all__ = ["ProductGraphs", "REPLAYED"]

# counters of the device work a product runs, counted again on a replay
REPLAYED = ("ell_launch", "ell_scan")


class _Graph:
    """A captured product: the graph, its static input and output, and
    ``counts``, its capture's counts of `REPLAYED`."""

    __slots__ = ("graph", "x", "y", "counts")

    def __init__(self, graph, x, y):
        self.graph, self.x, self.y = graph, x, y
        self.counts = {}

    def __call__(self, X):
        self.x.copy_(X)
        self.graph.replay()
        return self.y.clone()


class ProductGraphs:
    """One operator's captured products, shared with its transpose
    (`SparseOperator.T`); freed, with their memory pools, with the last
    operator that holds it."""

    def __init__(self):
        self.graphs = {}  # key -> _Graph
        self.seen = set()  # keys run once, eagerly
        self.refused = set()  # keys whose capture raised
        self.busy = False  # an outermost product is under way

    @staticmethod
    def engages(X, reg=None) -> bool:
        """Whether a graph can serve this operand (and ``reg``)."""
        return (
            isinstance(X, torch.Tensor)
            and X.is_cuda
            and X.is_contiguous()
            and not (X.requires_grad and torch.is_grad_enabled())
            and (reg is None or isinstance(reg, (int, float)))
            and X.device.index == torch.cuda.current_device()
            and not torch.cuda.is_current_stream_capturing()
        )

    @staticmethod
    def capture(X, body) -> _Graph:
        """Capture ``body`` over a static input shaped as ``X`` on a side
        stream. The input is left unwritten: a capture runs nothing."""
        x = torch.empty_like(X)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        side = torch.cuda.Stream(device=X.device)
        # other threads' CUDA calls (a profiler's) must not end the capture
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                y = body(x)
            finally:
                graph.capture_end()
        return _Graph(graph, x, y)

    def run(self, op, name: str, X, body, reg=None):
        """``body(X)``, the product ``name`` of operator ``op`` on ``X``:
        eagerly, captured or replayed, as the module describes. ``reg``:
        the ``reg·X`` term's scalar where the product adds one."""
        if self.busy:
            return body(X)
        self.busy = True
        try:
            if not self.engages(X, reg):
                return body(X)
            return self._call(op, name, X, body, reg)
        finally:
            self.busy = False

    def _call(self, op, name, X, body, reg):
        stream = (torch._C._cuda_getCurrentRawStream(X.device.index)
                  if X.is_cuda else None)
        # id(op.fwd) tells op from op.T: both share this cache and each
        # holds both tilings, so the id is unique while the cache lives
        key = (name, X.shape, X.dtype, X.device, stream, id(op.fwd), reg)
        g = self.graphs.get(key)
        if g is not None:
            with tracing.span("replay", op=name,
                              N=X.shape[1] if X.ndim > 1 else 1):
                tracing.count(3)
                tracing.count(1, "replays")
                for k, n in g.counts.items():
                    tracing.count(n, k)
                return g(X)
        if key in self.refused or key not in self.seen:
            Y = body(X)
            self.seen.add(key)
            return Y
        try:
            with tracing.counting() as made:
                g = self.capture(X, body)
        except RuntimeError:  # torch's CUDA errors among them
            self.refused.add(key)
            tracing.count(1, "graph_refused")
            return body(X)
        g.counts = {k: made[k] for k in REPLAYED if made.get(k)}
        self.graphs[key] = g
        tracing.count(3)
        tracing.count(1, "captures")
        return g(X)
