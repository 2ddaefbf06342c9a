"""CPU self-test of the cells ``rmat18.spmm128`` and ``banded50k.cg32``
(not tier-1; run with ``python -m pytest benchmark/tests -q``; that each
resolves to its files is `test_harness.test_every_cell_resolves`): a twin
at a small size, added as new files and new entries in a copy of the
benchmark (`test_harness.tiny_spec`), runs on the program's plain
versions, untraced and traced, while the control and the planted faults
read not correct. The solve faults are judged at the full size only
(`test_small_cg32_twin_runs`).
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH / "tests"))

from lib import faults, harness  # noqa: E402

import test_harness  # noqa: E402

CELLS = ("rmat18.spmm128", "banded50k.cg32")


@pytest.fixture
def small(tmp_path):
    """`test_harness.tiny_spec`'s copy of the benchmark, each cell beside
    its twin ``tiny_<cell>`` (``rmat18``'s at scale 11: `conftest`)."""
    return test_harness.tiny_spec(tmp_path)[0]


def _run(s, name, seed, trace_on=False, **kw):
    return harness.run_cell(s, "tiny_" + name, seed, 0.3, trace_on,
                            device="cpu", **kw)


def test_small_rmat_twin_runs_correct(small):
    s = small
    for trace_on in (False, True):
        result, lines = _run(s, "rmat18.spmm128", 2**31 + 5, trace_on)
        assert result["correct"], (result, lines)
        assert result["failed"] == 0 and result["attempted"] > 0
        if not trace_on:
            want = s.cell("tiny_rmat18.spmm128").end_to_end
            assert set(result["metrics"]) == {e["name"] for e in want}
    assert "jax" not in sys.modules and "fastsparse" not in sys.modules


def test_small_cg32_twin_runs(small):
    """The twin's solve is held to the cell's ``resgap`` and ``iters``
    limits, not to ``resratio``'s: that limit is set from the full-size
    solve, where a float32 CG tracks the float64 one over its 30
    iterations (1.4e-6 to 2.3e-6 on the card), while a band of 2,048 to
    8,192 rows reaches float32's floor within them and the float64 solve
    goes on (2.6e-4 to 4.2 on the CPU)."""
    s = small
    for trace_on in (False, True):
        result, lines = _run(s, "banded50k.cg32", 2**31 + 5, trace_on)
        c = result["checks"]
        assert set(c) == {"resgap.cg_normal", "iters.cg_normal",
                          "resratio.cg_normal"}
        for k in ("resgap.cg_normal", "iters.cg_normal"):
            assert c[k]["value"] <= c[k]["limit"], lines
        assert result["attempted"] > 0
        if not trace_on:
            want = s.cell("tiny_banded50k.cg32").end_to_end
            assert set(result["metrics"]) == {e["name"] for e in want}
        else:
            assert "build_s" in result["metrics"]


def test_small_twin_control_reads_not_correct(small):
    s = small
    result, lines = _run(s, "rmat18.spmm128", 9, control=True)
    assert result["correct"] is False, lines
    result, lines = _run(s, "banded50k.cg32", 9, control=True)
    c = result["checks"]["resgap.cg_normal"]
    assert c["value"] > c["limit"], lines


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_small_twin_fault_reads_not_correct(small, name, fault):
    s = small
    result, lines = _run(s, name, 7, wrap_step=faults.FAULTS[fault])
    assert result["correct"] is False, lines
    assert result["failed"] > 0
    if name == "banded50k.cg32":
        c = result["checks"]["resgap.cg_normal"]
        assert c["value"] > c["limit"], lines
