"""CPU self-test of the cell ``fp64rand100k.spmv`` (not tier-1; run with
``python -m pytest benchmark/tests -q``): a twin at 4,096², ~50 nonzeros
a row, float64 (the same generator and arguments, `TWIN_ARGS`), added as
new files and new entries in a copy of the benchmark
(`test_harness.tiny_spec`), runs correct on the program's CPU path (the
reference's per-bucket scan), untraced and traced, while the TF32
control and each planted fault read not correct; and the least bytes of
the f64 roofline at the source's shape.

`test_harness.tiny_spec` gives every configuration of ``BENCHMARK.json`` a
twin from its ``TINY_ARGS`` table; importing this file enters this
configuration's twin there, for every test of the directory.
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

CELL = "tiny_fp64rand100k.spmv"
TWIN_ARGS = {"nrow": 4096, "ncol": 4096, "nnz": 204_800, "alpha": 1.0,
             "dtype": "float64"}
test_harness.TINY_ARGS.setdefault("fp64rand100k", TWIN_ARGS)


@pytest.fixture
def small(tmp_path):
    """`test_harness.tiny_spec`'s copy of the benchmark, each cell beside
    its twin ``tiny_<cell>``."""
    return test_harness.tiny_spec(tmp_path)[0]


def test_twin_is_the_cells_kind(small):
    from lib import problem

    cell = small.cell(CELL)
    m = problem.make_matrix(cell.config, 2**31 + 5)
    assert m.dtype.name == "float64" and m.shape == (4096, 4096)
    assert 40 < m.nnz / m.shape[0] < 60
    assert small.cell("fp64rand100k.spmv").limits == {"rel.matvec": 1e-10}


def test_small_fp64_twin_runs_correct(small):
    cell = small.cell(CELL)
    for trace_on in (False, True):
        result, lines = harness.run_cell(small, CELL, 2**31 + 5, 0.3,
                                         trace_on, device="cpu")
        assert result["correct"], (result, lines)
        assert result["failed"] == 0 and result["attempted"] > 0
        assert set(result["checks"]) == {"rel.matvec"}
        assert result["checks"]["rel.matvec"]["value"] < 1e-14
        if not trace_on:
            assert set(result["metrics"]) == {e["name"]
                                              for e in cell.end_to_end}
            continue
        # no device on the CPU: the host metrics and the program's
        # counters; the CPU keeps the scan, one bucket-scan a bucket
        got = result["metrics"]
        assert "build_s" in got and "roofline_share.f64" not in got
        assert got["ell_launch.product"]["value"] == 0
        assert got["ell_scan.product"]["value"] > 0
    assert "jax" not in sys.modules and "fastsparse" not in sys.modules


def test_small_fp64_control_reads_not_correct(small):
    result, lines = harness.run_cell(small, CELL, 9, 0.2, False,
                                     device="cpu", control=True)
    assert result["correct"] is False, lines
    c = result["checks"]["rel.matvec"]
    assert c["value"] > 1e3 * c["limit"], lines


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_small_fp64_fault_reads_not_correct(small, fault):
    result, lines = harness.run_cell(small, CELL, 7, 0.2, False,
                                     device="cpu",
                                     wrap_step=faults.FAULTS[fault])
    assert result["correct"] is False, lines
    assert result["failed"] > 0


def test_f64_least_bytes_at_source_shape():
    """8 bytes a stored value, x read and y written once in float64: at
    the instance's 4,998,767 nonzeros, 41,590,136 B, 12.41 us at
    3.35 TB/s; a kernel record is found by its f64 name only."""
    from lib import roofline, roofline_f64

    cell = test_harness._spec().cell("fp64rand100k.spmv")
    nnz, n = cell.config["at_source_seed"]["nnz"], 100_000
    (st,) = cell.traffic["step"]
    assert roofline_f64.op_bytes(st, nnz, n, n, 1) == 41_590_136
    t = roofline_f64.least_s(cell.traffic, nnz, n, n)
    assert t == pytest.approx(41_590_136 / roofline.HBM_BYTES_PER_S)
    assert t * 1e6 == pytest.approx(12.41, abs=0.01)
    traced = {"device_ops": [
        ["void (anonymous namespace)::ell_table_kernel<double, 1, false>(",
         2e-3],
        ["void (anonymous namespace)::ell_table_kernel<float, 1, false>(",
         5e-3],
        ["_ZN12_GLOBAL__N_116ell_table_kernelIdLi1ELb0EEEvPKNS_7EllTileE",
         1e-3],
        ["void (anonymous namespace)::plan_sum_kernel<double>(", 4e-3]]}
    assert roofline_f64.kernel_s(traced) == pytest.approx(3e-3)
    assert roofline_f64.kernel_s({"device_ops": traced["device_ops"][1:2]}
                                 ) is None
    assert roofline_f64.op_bytes({"op": "normal_matvec"}, 10, 3, 5, 2) == (
        2 * 8 * 10 + 8 * 2 * (5 + 5))
