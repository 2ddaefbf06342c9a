"""CPU self-test of the ``device_ops.product`` reader (not tier-1; run
with ``python -m pytest benchmark/tests -q``): it gives the traced
window's device records a step, as `lib.trace` reduces the profiler
sessions, and nothing where no session was kept."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

from lib import spec as spec_mod, trace  # noqa: E402


def _read(ctx):
    return spec_mod.load_reader(spec_mod.load_spec(), "per_layer",
                                "device_ops.product")(ctx)


def _session(n_steps, kernels_a_step, lost=0):
    """A session of ``n_steps`` steps, each ``kernels_a_step`` device
    records and a synchronise; ``lost`` records dropped at the end."""
    dev, runtime = [], []
    t = 0.0
    for _ in range(n_steps):
        runtime.append((t, t + 1.0, "cudaGraphLaunch"))
        for k in range(kernels_a_step):
            dev.append((t + 2 + k, t + 2.5 + k, f"kernel_{k}"))
        end = t + 3 + kernels_a_step
        runtime.append((t + 1.5, end, "cudaDeviceSynchronize"))
        t = end + 1
    return dev[:len(dev) - lost], runtime, n_steps


def test_reads_records_a_step_of_the_complete_sessions():
    sessions = [_session(4, 14), _session(3, 14, lost=2), _session(5, 14)]
    ctx = SimpleNamespace(trace=trace.reduce_sessions(sessions))
    assert ctx.trace["sessions_kept"] == 2
    assert _read(ctx) == 14 == ctx.trace["records_per_step"]


@pytest.mark.parametrize("kernels", [1, 56, 1000])
def test_counts_every_kernel_node(kernels):
    ctx = SimpleNamespace(trace=trace.reduce_sessions([_session(2, kernels)]))
    assert _read(ctx) == kernels


def test_nothing_to_read():
    assert _read(SimpleNamespace(trace=None)) is None
    assert _read(SimpleNamespace(
        trace=trace.reduce_sessions([([], [(0.0, 1.0, "cudaLaunch")], 3)]))) \
        is None
    assert _read(SimpleNamespace(trace={"steps": 0,
                                        "records_per_step": 0})) is None


def test_entry_lists_the_product_cells():
    d = spec_mod.load_spec().data
    (e,) = [m for m in d["per_layer"] if m["name"] == "device_ops.product"]
    assert e["source"] == "device_trace" and e["moves"] == "gflop_per_s"
    calls = {w["name"] for w in d["workloads"]
             if spec_mod.load_spec().cell(w["name"]).traffic["unit"] == "call"}
    assert set(e["workloads"]) == calls
