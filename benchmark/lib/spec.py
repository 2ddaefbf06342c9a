"""The benchmark's data: `BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric lives in a file of its own, found by name:

* ``configs[i].file``: the configuration (matrix generator, structure
  parameters, operator arguments, stated precision);
* ``benchmark/traffic/<traffic>.json``: the traffic mix, read by the one
  generator in `lib.traffic`;
* ``benchmark/limits/<cell>.json``: each compared number's limit;
* ``benchmark/end_to_end/<metric>.py`` and
  ``benchmark/layer_metrics/<metric>.py``: a reader per metric, with a
  ``read(ctx)`` that returns the number or None.

A new cell, mix or metric is new files and new entries; no file here
changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ["Spec", "Cell", "load_spec", "load_reader"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: tuple  # metric entries this cell reports
    per_layer: tuple


@dataclasses.dataclass(frozen=True)
class Spec:
    data: dict
    root: Path
    bench_dir: Path

    def cell_names(self):
        return [w["name"] for w in self.data["workloads"]]

    def metrics_for(self, kind: str, cell: str) -> tuple:
        """The entries of ``kind`` ("end_to_end" or "per_layer") that
        ``cell`` reports: those listing it under ``workloads``, and those
        without the key when the end-to-end metric they move (or they
        themselves) is reported there."""
        e2e = [m for m in self.data["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if kind == "end_to_end":
            return tuple(e2e)
        names = {m["name"] for m in e2e}
        return tuple(m for m in self.data["per_layer"]
                     if (cell in m["workloads"] if "workloads" in m
                         else m["moves"] in names))

    def cell(self, name: str) -> Cell:
        ws = [w for w in self.data["workloads"] if w["name"] == name]
        if not ws:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = ws[0]
        cfg_entry = [c for c in self.data["configs"]
                     if c["name"] == w["config"]][0]
        config = _read_json(self.root / cfg_entry["file"])
        traffic = _read_json(self.bench_dir / "traffic"
                             / f"{w['traffic']}.json")
        limits = _read_json(self.bench_dir / "limits" / f"{name}.json")
        return Cell(
            name=name, config=config, traffic=traffic, limits=limits,
            chips=int(w["chips"]),
            end_to_end=self.metrics_for("end_to_end", name),
            per_layer=self.metrics_for("per_layer", name),
        )


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(bench_json: Path | None = None,
              bench_dir: Path | None = None) -> Spec:
    """The spec at ``bench_json`` (default: the checkout's
    ``BENCHMARK.json``), with data files under ``bench_dir`` (default:
    this ``benchmark/`` directory)."""
    bench_json = Path(bench_json or ROOT / "BENCHMARK.json")
    return Spec(data=_read_json(bench_json), root=bench_json.parent,
                bench_dir=Path(bench_dir or BENCH_DIR))


def load_reader(spec: Spec, kind: str, name: str):
    """The ``read`` function of metric ``name``: ``kind`` is
    "end_to_end" or "per_layer"."""
    sub = "end_to_end" if kind == "end_to_end" else "layer_metrics"
    path = spec.bench_dir / sub / f"{name}.py"
    mod_name = "bm_" + sub + "_" + name.replace(".", "_").replace("-", "_")
    loader = importlib.util.spec_from_file_location(mod_name, path)
    if loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod.read
