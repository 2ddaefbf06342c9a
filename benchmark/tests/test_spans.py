"""CPU self-test of `lib.spans`, the readers of the program's own spans
and counters (run with ``python -m pytest benchmark/tests -q``).

It checks that the clock fit recovers a known offset from synthetic
synchronise stamps, with the profiler's own records at either end; that
idle attribution names each piece of an idle stretch by the innermost
span and uncovered time ``outside``; that traced runs of small twins of
the cells report every new metric of their cell, with ``ops_issued``
equal on two runs of one seed; and that every file the benchmark held
before these readers is byte for byte what it was, and
``BENCHMARK.json`` only gained entries.
"""
from __future__ import annotations

import json
import random
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from lib import harness, spans  # noqa: E402
import test_harness  # noqa: E402

# the benchmark as accepted before the program had spans
BASE = "8bce1bb2de9b8b7593c614df30e30f2972ac2939"
NEW = {"ops_issued.product", "ops_issued.step", "host_ms.bsr_ops.product",
       "host_ms.ell_ops.product", "host_ms.ell_ops.step",
       "host_ms.assemble.product", "host_ms.assemble.step",
       "host_ms.normal.step", "sync_wait_ms.step"}


def test_clock_fit_recovers_a_known_offset():
    rng = random.Random(4)
    offset = 1_760_000_000_123_456_789 - 5_000_000_000
    stamps, recs = [], [(10, 20, "cudaDeviceSynchronize")]  # the profiler's
    t = 5_000_000_000
    for _ in range(40):
        t += rng.randrange(50_000, 2_000_000)
        a = t
        s = a + 1_500 + rng.randrange(0, 400)  # entry, then the call
        e = s + rng.randrange(2_000, 90_000)  # the wait on the device
        b = e + 1_500 + rng.randrange(0, 400)
        stamps.append((a, b))
        recs.append((s + offset, e + offset, "cudaDeviceSynchronize"))
        t = b
    recs.append((recs[-1][1] + 10_000, recs[-1][1] + 20_000,
                 "cudaDeviceSynchronize"))
    got, spread = spans.fit_offset(stamps, recs)
    assert abs(got - offset) < 400 and spread < 400
    assert spans.fit_offset(stamps, recs[:10]) is None


def _span(name, t0, t1):
    return SimpleNamespace(name=name, t0=t0, t1=t1)


def test_idle_goes_to_the_innermost_span_and_outside():
    """A product (0-100) holds an assemble span (40-70); the step ends in
    a synchronise (100-130) outside both. Device work at 10-20 and
    60-110, so idle 0-10, 20-60 and 110-130."""
    tl = spans.innermost_timeline([_span("product", 0, 100),
                                   _span("assemble", 40, 70)])
    assert tl == [(0, "product"), (40, "assemble"), (70, "product"),
                  (100, "outside")]
    runtime = [(0, 5, "cudaLaunchKernel"), (50, 55, "cudaLaunchKernel"),
               (100, 130, "cudaDeviceSynchronize")]
    dev = [(10, 20, "k1"), (60, 110, "k2")]
    got, idle, busy, wall = spans.idle_by_span(dev, runtime, tl)
    ns = 1e-9
    assert wall == pytest.approx(130 * ns) and busy == pytest.approx(60 * ns)
    assert idle == pytest.approx(70 * ns)
    # pieces split where the innermost span changes, each named with the
    # runtime call at its midpoint
    assert got == pytest.approx({
        "product/cudaLaunchKernel": 10 * ns,  # 0-10
        "product/host": 20 * ns,  # 20-40
        "assemble/cudaLaunchKernel": 20 * ns,  # 40-60
        "outside/sync": 20 * ns,  # 110-130
    })


def _counted(name, t0, t1, ops=0):
    return SimpleNamespace(name=name, t0=t0, t1=t1, counts={"ops": ops})


def test_session_reduction_on_a_synthetic_step(capsys):
    """One step on the host clock (perf_counter ns from 1,000): a product
    with an assemble span, a synchronise stamped around it; the profiler's
    clock runs 10**9 ns ahead. A session that lost a device record beyond
    the margin is left out."""
    off = 10**9
    spans_ = [_counted("product", 1000, 1100, 1),
              _counted("assemble", 1040, 1070, 2)]
    stamps = [(1100, 1130, False)]
    runtime = [(t + off, e + off, n) for t, e, n in [
        (1000, 1005, "cudaLaunchKernel"), (1050, 1055, "cudaLaunchKernel"),
        (1057, 1058, "cudaMemsetAsync"),
        (1102, 1128, "cudaDeviceSynchronize")]]
    dev = [(1010 + off, 1020 + off, "k1"), (1060 + off, 1110 + off, "k2"),
           (1062 + off, 1063 + off, "memset")]
    lossy = (dev[:2], runtime, spans_, stamps, 1)
    out = spans.reduce_sessions([(dev, runtime, spans_, stamps, 1), lossy],
                                {"records_per_step": 3}, {"ops_per_step": 3})
    said = capsys.readouterr().out
    assert "1 of 2 sessions kept" in said
    assert "kernel launches inside a span: 2 of 2" in said
    assert "'assemble': [2.0, 2.0]" in said and "'product': [1.0, 1.0]" in said
    top = dict(out["idle_by_span"])
    assert set(top) == {"product/cudaLaunchKernel", "product/host",
                        "assemble/cudaLaunchKernel", "outside/sync"}
    assert top["outside/sync"] == pytest.approx(18e-9)  # 1110-1128
    assert out["outside_share"] == pytest.approx(18 / 68)
    assert out["clock_spread_us"] == [0.0]


@pytest.fixture
def small_dense_cols(monkeypatch):
    from fastsparse_torch.bench import model

    monkeypatch.setattr(model, "DENSE_COL_MIN_D", 4)
    monkeypatch.setattr(model, "DENSE_COL_CELL_S", 2e-11)
    monkeypatch.setattr(model, "DENSE_COL_MIN_ROWS", 64)


@pytest.mark.parametrize("name", test_harness.CELLS)
def test_tiny_traced_runs_report_the_new_metrics(tmp_path, monkeypatch,
                                                 small_dense_cols, name):
    """The ECFP twin is sparse enough for the hybrid (dense columns, ELL
    parts and their plans), as the real cell is."""
    monkeypatch.setitem(test_harness.TINY_ARGS, "ecfp50k", {
        "n_compounds": 2000, "n_features": 6000, "bits_per_compound": 24,
        "n_scaffolds": 20})
    s, _, _ = test_harness.tiny_spec(tmp_path)
    want = {e["name"] for e in s.cell("tiny_" + name).per_layer} & NEW
    assert want
    ops = []
    for _ in range(2):
        result, _ = harness.run_cell(s, "tiny_" + name, 2**31 + 9, 0.3,
                                         True, device="cpu")
        assert want <= set(result["metrics"]), want - set(result["metrics"])
        ops.append({k: v["value"] for k, v in result["metrics"].items()
                    if k.startswith("ops_issued")})
    assert ops[0] == ops[1] and all(v > 0 for v in ops[0].values())


def _git(*args):
    if shutil.which("git") is None or not (ROOT / ".git").exists():
        pytest.skip("no git checkout")
    r = subprocess.run(["git", *args], cwd=ROOT, capture_output=True)
    if r.returncode:
        pytest.skip(f"git {args[0]} failed: the base commit is not here")
    return r.stdout


def test_accepted_benchmark_files_are_unchanged():
    names = _git("ls-tree", "-r", "--name-only", BASE, "benchmark").decode()
    for name in names.split():
        assert (ROOT / name).read_bytes() == _git("show", f"{BASE}:{name}"), name
    old = json.loads(_git("show", f"{BASE}:BENCHMARK.json"))
    new = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, value in old.items():
        if isinstance(value, list):
            assert new[key][: len(value)] == value, key
        else:
            assert new[key] == value, key
