"""CPU self-test of the benchmark harness (not part of the repo's tier-1
suite; run it with ``python -m pytest benchmark/tests -q``).

It checks that every cell of ``BENCHMARK.json`` resolves to its
configuration, traffic, limits and metric files; the least bytes of the
cells from their shapes; that rates and the 95th percentile are taken
over every sample of the window; that ``run.py`` exits nonzero and prints
no result without a CUDA device; that a cell added as new files and new
entries runs; and that the comparison calls the control and a broken
timed path wrong, once for each fault a cell can have, and a solve that
stops early, leaves x where it started or leaves columns unsolved while it
reports the work it was asked for. The runs here drive the program's
plain versions on the CPU at small sizes, in a copy of the benchmark with
small configurations added beside the real ones.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))

from lib import faults, harness, metrics, roofline, spec as spec_mod, trace  # noqa: E402
from lib.window import Window  # noqa: E402

CELLS = ("banded50k.spmm128", "ecfp50k.macau32", "ecfp50k.spmm256")
TINY_ARGS = {
    "banded50k": {"n": 2048, "bandwidth": 256, "density": 0.39},
    "ecfp50k": {"n_compounds": 3000, "n_features": 1500,
                "bits_per_compound": 64, "n_scaffolds": 40},
}


def _spec():
    return spec_mod.load_spec()


def test_every_cell_resolves():
    s = _spec()
    names = s.cell_names()
    assert set(CELLS) <= set(names)
    for name in names:
        cell = s.cell(name)
        assert set(harness.check_names(cell.traffic)) == set(cell.limits)
        assert {e["name"] for e in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for e in cell.end_to_end:
            assert callable(spec_mod.load_reader(s, "end_to_end", e["name"]))
        for e in cell.per_layer:
            assert callable(spec_mod.load_reader(s, "per_layer", e["name"]))


def test_benchmark_json_shape():
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in d["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    e2e = {m["name"] for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert m["moves"] in e2e
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_harness_imports_no_reference():
    banned = ("import jax", "from jax", "fastsparse.", "import fastsparse\n",
              "fastsparse_torch.bench", "from fastsparse ")
    for p in BENCH.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        for b in banned:
            assert b not in text, f"{p} names {b!r}"


def _least_bytes(name):
    s = _spec()
    cell = s.cell(name)
    shapes = {"banded50k": (50_000, 50_000, 8_250_913),
              "ecfp50k": (50_000, 20_000, 3_194_536)}
    nrow, ncol, nnz = shapes[cell.config["name"]]
    w = int(cell.traffic["operand"]["width"])
    return sum(roofline.op_bytes(st, nnz, nrow, ncol, w)
               for st in cell.traffic["step"])


@pytest.mark.parametrize("name,least_ms", [
    ("banded50k.spmm128", 0.0156),
    ("ecfp50k.spmm256", 0.0215),
    ("ecfp50k.macau32", 0.052),
])
def test_least_bytes_at_source_shapes(name, least_ms):
    t = _least_bytes(name) / roofline.HBM_BYTES_PER_S * 1e3
    assert abs(t - least_ms) / least_ms < 0.01, t


def test_least_bytes_exact():
    nnz = 8_250_913
    assert _least_bytes("banded50k.spmm128") == (
        nnz // 8 + 4 * 128 * (50_000 + 50_000))
    n2 = 3_194_536
    one = n2 // 8 + 4 * 32 * (20_000 + 20_000)
    assert _least_bytes("ecfp50k.macau32") == (
        n2 // 8 + 4 * 32 * (50_000 + 20_000) + 30 * one)


def test_operation_bound_below_byte_bound():
    for name in CELLS:
        cell = _spec().cell(name)
        nnz = 8_250_913 if name.startswith("banded") else 3_194_536
        w = int(cell.traffic["operand"]["width"])
        ops = sum(roofline.op_flops(st, nnz, w) for st in cell.traffic["step"])
        assert ops / roofline.INT8_OPS_PER_S < (
            _least_bytes(name) / roofline.HBM_BYTES_PER_S)


def _ctx(step_s, window_s, flops=1e9):
    from types import SimpleNamespace

    w = Window(steps=len(step_s), window_s=window_s, step_s=list(step_s),
               host_s=[t / 2 for t in step_s],
               profiled=[False] * len(step_s))
    work = SimpleNamespace(flops_per_step=flops, bytes_per_step=0,
                           least_s_per_step=1e-5)
    return SimpleNamespace(window=w, trace=None, work=work, setup_s=1.0,
                           build_s=0.5)


def test_rates_and_p95_over_every_sample():
    s = _spec()
    step_s = [0.001] * 94 + [0.002] * 5 + [0.5]
    ctx = _ctx(step_s, window_s=sum(step_s))
    gflops = spec_mod.load_reader(s, "end_to_end", "gflop_per_s")(ctx)
    assert gflops == pytest.approx(100 * 1e9 / sum(step_s) / 1e9)
    p95 = spec_mod.load_reader(s, "end_to_end", "call_p95_ms")(ctx)
    assert p95 == pytest.approx(2.0)  # rank 95 of 100
    step = spec_mod.load_reader(s, "end_to_end", "step_ms")(ctx)
    assert step == pytest.approx(sum(step_s) / 100 * 1e3)
    host = spec_mod.load_reader(s, "per_layer", "host_ms.product")(ctx)
    assert host == pytest.approx(sum(step_s) / 2 / 100 * 1e3)
    assert metrics.p95(list(range(1, 21))) == 19


def test_trace_reduction_keeps_complete_sessions():
    runtime = [(0.0, 5.0, "cudaLaunchKernel"), (50.0, 55.0, "cudaLaunchKernel"),
               (100.0, 110.0, "cudaDeviceSynchronize")]
    full = [(10.0, 30.0, "k1"), (25.0, 40.0, "k2"), (60.0, 105.0, "k3")]
    lossy = full[:2]
    out = trace.reduce_sessions([(full, runtime, 1), (lossy, runtime, 1),
                                 (full, runtime, 1)])
    assert out["sessions_kept"] == 2 and out["records_per_step"] == 3
    assert out["busy_s"] == pytest.approx(2 * 75e-6)
    assert out["window_s"] == pytest.approx(2 * 110e-6)
    assert trace.reduce_sessions([([], runtime, 1)]) is None
    assert trace.reduce_sessions([(full, [], 1)]) is None


def test_trace_reduction_names_gaps_by_runtime_calls():
    """Each idle stretch is named by the CUDA runtime call that holds its
    midpoint, "sync" for a synchronise, "host" where none does."""
    runtime = [(0.0, 5.0, "cudaLaunchKernel"), (50.0, 55.0, "cudaLaunchKernel"),
               (70.0, 110.0, "cudaDeviceSynchronize")]
    dev = [(10.0, 30.0, "k1"), (60.0, 100.0, "k2")]
    out = trace.reduce_sessions([(dev, runtime, 1)])
    assert out["window_s"] == pytest.approx(110e-6)
    assert out["busy_s"] == pytest.approx(60e-6)
    gaps = dict(out["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)  # 0-10
    assert gaps["host"] == pytest.approx(30e-6)  # 30-60
    assert gaps["sync"] == pytest.approx(10e-6)  # 100-110


def test_run_exits_without_cuda_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 17), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_run_exits_in_a_bare_checkout(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def tiny_spec(tmp_path):
    """A copy of the benchmark with each real cell's twin at a small size,
    added as new files and new entries only."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in list(d["configs"]):
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["args"] = TINY_ARGS[c["name"]]
        name = "tiny_" + c["name"]
        cfg["name"] = name
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        d["configs"].append(dict(c, name=name,
                                 file=f"benchmark/configs/{name}.json"))
    for w in list(d["workloads"]):
        name = "tiny_" + w["name"]
        d["workloads"].append(dict(w, name=name, config="tiny_" + w["config"]))
        shutil.copy(bench / "limits" / f"{w['name']}.json",
                    bench / "limits" / f"{name}.json")
        for m in d["end_to_end"] + d["per_layer"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))
    return spec_mod.load_spec(tmp_path / "BENCHMARK.json", bench), d, bench


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_runs_correct(tmp_path, name):
    s, _, _ = tiny_spec(tmp_path)
    for trace_on in (False, True):
        result, lines = harness.run_cell(s, "tiny_" + name, 2**31 + 5, 0.3,
                                         trace_on, device="cpu")
        assert result["correct"], (result, lines)
        assert list(result)[-1] == "checks"
        assert result["failed"] == 0 and result["attempted"] > 0
        want = s.cell("tiny_" + name).end_to_end
        if not trace_on:
            assert set(result["metrics"]) == {e["name"] for e in want}
        else:
            # no device on the CPU: only the host metrics read anything
            assert "build_s" in result["metrics"]
    assert "jax" not in sys.modules and "fastsparse" not in sys.modules


def test_added_cell_needs_only_new_files(tmp_path):
    s, d, bench = tiny_spec(tmp_path)
    (bench / "traffic" / "rmm64.json").write_text(json.dumps({
        "operand": {"of": "rows", "width": 64, "buffers": 2},
        "step": [{"op": "rmatmat"}], "unit": "call"}))
    (bench / "limits" / "tiny_ecfp50k.rmm64.json").write_text(
        json.dumps({"rel.rmatmat": 1e-6}))
    (bench / "layer_metrics" / "steps.window.py").write_text(
        "def read(ctx):\n    return ctx.window.steps\n")
    d = copy.deepcopy(d)
    d["workloads"].append({"name": "tiny_ecfp50k.rmm64",
                           "config": "tiny_ecfp50k", "traffic": "rmm64",
                           "chips": 1, "why": "added"})
    for m in d["end_to_end"]:
        if m["name"] == "gflop_per_s":
            m["workloads"].append("tiny_ecfp50k.rmm64")
    d["per_layer"].append({"name": "steps.window", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "gflop_per_s",
                           "workloads": ["tiny_ecfp50k.rmm64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))
    s = spec_mod.load_spec(tmp_path / "BENCHMARK.json", bench)
    r0, _ = harness.run_cell(s, "tiny_ecfp50k.rmm64", 11, 0.3, False,
                             device="cpu")
    assert r0["correct"] and set(r0["metrics"]) == {"gflop_per_s",
                                                     "setup_s"}
    r1, _ = harness.run_cell(s, "tiny_ecfp50k.rmm64", 11, 0.3, True,
                             device="cpu")
    assert r1["metrics"]["steps.window"]["value"] == r1["attempted"]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_not_correct(tmp_path, name):
    """The control, the reference with TF32 operands in the program's
    place, fails one of the cell's numbers."""
    s, _, _ = tiny_spec(tmp_path)
    result, lines = harness.run_cell(s, "tiny_" + name, 9, 0.2, False,
                                     device="cpu", control=True)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_reads_not_correct(tmp_path, name, fault):
    s, _, _ = tiny_spec(tmp_path)
    result, lines = harness.run_cell(s, "tiny_" + name, 7, 0.2, False,
                                     device="cpu",
                                     wrap_step=faults.FAULTS[fault])
    assert result["correct"] is False, lines
    assert result["failed"] > 0


@pytest.mark.parametrize("fault", sorted(faults.SOLVE_FAULTS))
def test_solve_fault_reads_not_correct(tmp_path, fault):
    """Each solve fault reports the iterations asked for and a true
    residual norm, so only ``resratio`` can catch it, and does."""
    s, _, _ = tiny_spec(tmp_path)
    name = "tiny_ecfp50k.macau32"
    result, lines = harness.run_cell(s, name, 7, 0.2, False, device="cpu",
                                     wrap_step=faults.SOLVE_FAULTS[fault])
    assert result["correct"] is False, lines
    assert result["failed"] > 0
    c = result["checks"]
    assert c["resratio.cg_normal"]["value"] > c["resratio.cg_normal"]["limit"]
    for k in ("rel.rmatmat", "resgap.cg_normal", "iters.cg_normal"):
        assert c[k]["value"] <= c[k]["limit"], (k, lines)
