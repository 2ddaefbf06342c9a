"""Spans and counters inside the port, kept in memory, off by default.

An operator turns them on around the calls to trace::

    from fastsparse_torch import tracing

    with tracing.recording() as rec:
        y = op.matmat(X)
        torch.cuda.synchronize()
    for s in rec.spans:
        print(s.name, s.attrs, s.t1 - s.t0, s.self_ns, s.counts)
    print(rec.counts)  # {"ops": ..., "syncs": ...}

A span marks one layer boundary, not one launch: ``product`` (a
`SparseOperator` call), ``boundary`` (its permutation gathers),
``hybrid``, ``bsr_ops``, ``ell_ops`` (attr ``dtype``, the product's:
``float32``, or ``float64`` on the table kernel's f64 mode),
``ell_scan`` (the reference's per-bucket ELL scan as torch ops, attr
``dtype``), ``assemble``, ``densecols``,
``cg.solve``/``cg.iter``/``cg.sync`` and ``build``/``build.*``. Each
records its name, ``t0``/``t1`` from `time.perf_counter_ns`, its parent
span and so its root (the outermost span it ran under: one call of the
program), and the counts made while it was the innermost open span:

* ``ops``: device operations enqueued, each kernel launch of
  ``ops/kernels`` and each torch op the span's own code issues;
* ``syncs``: host waits on the device inside the program;
* ``ell_launch``: gather-engine launches that `ops.ell_ops.ell_spmm`
  dispatches: one for a whole product at X widths of at most 8 lanes
  (``ell_table``), else one for each part (``ell_bucket``,
  ``ell_sweep``, ``ell_bucket_smem``); the plain versions on the CPU
  count alike. A captured product keeps its total, and each replay
  counts it again (`graphs.ProductGraphs`);
* ``ell_scan``: buckets the per-bucket torch-op scan runs (``ell_scan``
  spans: ELL products the gather engine does not take, f64 past its
  table path or on the CPU), counted again on a replay as ``ell_launch``.

A span's times are those of the host enqueueing the work, not of the
device running it: tracing adds no synchronise, no read-back and no device
operation. Off (no recording open), `span` returns one shared no-op
context manager and reads no clock, and `count` returns at once. One
recording is open at a time, and spans are taken on the thread that
calls the program (the port issues its work from one thread).
"""
from __future__ import annotations

import contextlib
import time

__all__ = ["Recording", "Span", "count", "counting", "recording", "span"]

_active = None  # the open Recording, or None


class Span:
    """One span: ``name``, ``attrs``, ``t0``/``t1`` (perf_counter ns),
    ``parent`` (a span, or None at the top), ``counts`` made while it was
    innermost; ``root`` and, once the recording has ended, ``self_ns``."""

    __slots__ = ("name", "attrs", "t0", "t1", "parent", "counts", "child_ns",
                 "_rec")

    @property
    def root(self) -> "Span":
        """The outermost span this one ran under (itself at the top)."""
        s = self
        while s.parent is not None:
            s = s.parent
        return s

    @property
    def self_ns(self) -> int:
        """Duration less the time of the direct children."""
        return self.t1 - self.t0 - self.child_ns

    def __enter__(self):
        rec = self._rec
        stack = rec._stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        rec.spans.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, typ, value, tb):
        self.t1 = time.perf_counter_ns()
        self._rec._stack.pop()
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.attrs}, "
                f"{self.t1 - self.t0 if self.t1 else None} ns, {self.counts})")


class Recording:
    """What one `recording` holds: ``spans`` in the order they opened, and
    ``counts``, each counter's total over the spans and outside them."""

    def __init__(self):
        self.spans = []
        self._loose = {}  # counts made outside any span
        self._stack = []

    @property
    def counts(self) -> dict:
        out = dict(self._loose)
        for s in self.spans:
            for k, v in s.counts.items():
                out[k] = out.get(k, 0) + v
        return out


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager that records span ``name`` (with ``attrs``) while
    a recording is open; the shared no-op otherwise."""
    rec = _active
    if rec is None:
        return _OFF
    s = Span()
    s.name, s.attrs, s.counts, s.t1, s._rec = name, attrs, {}, None, rec
    return s


def count(n: int = 1, key: str = "ops") -> None:
    """Add ``n`` to counter ``key`` of the innermost open span (of the
    recording, outside any span); nothing while no recording is open."""
    rec = _active
    if rec is None:
        return
    c = rec._stack[-1].counts if rec._stack else rec._loose
    c[key] = c.get(key, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counts until the block ends; yields the
    `Recording`. Tracing is off again afterwards, also when the block
    raises."""
    global _active
    if _active is not None:
        raise RuntimeError("a tracing recording is already open")
    rec = Recording()
    _active = rec
    try:
        yield rec
    finally:
        _active = None
        for s in rec.spans:  # the children's time, for self_ns
            s.child_ns = 0
        for s in rec.spans:
            if s.parent is not None and s.t1 is not None:
                s.parent.child_ns += s.t1 - s.t0


@contextlib.contextmanager
def counting():
    """Yields a dict that holds, once the block ends, the counts made
    inside it, whether or not a recording is open: the open recording's
    counts before and after, else those of a recording of its own."""
    made = {}
    if _active is None:
        with recording() as rec:
            yield made
        made.update(rec.counts)
        return
    before = _active.counts
    yield made
    for k, v in _active.counts.items():
        if v != before.get(k, 0):
            made[k] = v - before.get(k, 0)
