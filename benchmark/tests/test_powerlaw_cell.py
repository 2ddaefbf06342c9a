"""CPU self-test of the cell ``powerlaw250k.spmv`` (not tier-1; run with
``python -m pytest benchmark/tests -q``; that it resolves to its files is
`test_harness.test_every_cell_resolves`): a twin at 4,096² (`conftest`),
added as new files and new entries in a copy of the benchmark
(`test_harness.tiny_spec`), runs correct on the program's plain versions,
untraced and traced, while the TF32 control and each planted fault read
not correct.
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

CELL = "tiny_powerlaw250k.spmv"


@pytest.fixture
def small(tmp_path):
    """`test_harness.tiny_spec`'s copy of the benchmark, each cell beside
    its twin ``tiny_<cell>``."""
    return test_harness.tiny_spec(tmp_path)[0]


def _parts(m, cell):
    """The gather launches of one matvec over the twin's layout."""
    import fastsparse_torch as ft
    from fastsparse_torch.ops import ell_ops

    op = ft.operator(m, transpose=False, device="cpu",
                     **cell.config["operator"])
    segs = getattr(op.fwd, "segments", [op.fwd])
    return sum(len(list(ell_ops._seg_layout(s))) for s in segs)


def test_small_powerlaw_twin_runs_correct(small):
    from lib import problem

    s = small
    cell = s.cell(CELL)
    for trace_on in (False, True):
        result, lines = harness.run_cell(s, CELL, 2**31 + 5, 0.3, trace_on,
                                         device="cpu")
        assert result["correct"], (result, lines)
        assert result["failed"] == 0 and result["attempted"] > 0
        assert set(result["checks"]) == {"rel.matvec"}
        if not trace_on:
            assert set(result["metrics"]) == {e["name"]
                                              for e in cell.end_to_end}
            continue
        # no device on the CPU: the host metrics and the program's counters
        got = result["metrics"]
        assert "build_s" in got and "roofline_share.valued" not in got
        m = problem.make_matrix(cell.config, 2**31 + 5)
        assert got["ell_launch.product"]["value"] == _parts(m, cell) > 1
    assert "jax" not in sys.modules and "fastsparse" not in sys.modules


def test_small_powerlaw_control_reads_not_correct(small):
    result, lines = harness.run_cell(small, CELL, 9, 0.2, False,
                                     device="cpu", control=True)
    assert result["correct"] is False, lines
    c = result["checks"]["rel.matvec"]
    assert c["value"] > c["limit"], lines


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_small_powerlaw_fault_reads_not_correct(small, fault):
    result, lines = harness.run_cell(small, CELL, 7, 0.2, False,
                                     device="cpu",
                                     wrap_step=faults.FAULTS[fault])
    assert result["correct"] is False, lines
    assert result["failed"] > 0


def test_valued_least_bytes_at_source_shape():
    """4 bytes a stored value, x read and y written once in float32: at
    the instance's 12,497,053 nonzeros, 51.99 MB, 15.52 us at 3.35 TB/s."""
    from lib import roofline, roofline_valued

    cell = test_harness._spec().cell("powerlaw250k.spmv")
    nnz, n = cell.config["at_source_seed"]["nnz"], 250_000
    (st,) = cell.traffic["step"]
    assert roofline_valued.op_bytes(st, nnz, n, n, 1) == 4 * nnz + 4 * 2 * n
    t = roofline_valued.least_s(cell.traffic, nnz, n, n)
    assert t == pytest.approx(51_988_212 / roofline.HBM_BYTES_PER_S)
    assert roofline_valued.op_bytes(
        {"op": "cg_normal", "maxiter": 30}, 10, 3, 5, 2) == 30 * (
            4 * 10 + 4 * 2 * (5 + 5))
