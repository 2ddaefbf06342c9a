"""A small Graph 500 R-MAT graph that `operator(m, reorder="auto")` builds
into every part kind of the scale-18 instance's layout (the benchmark's
``rmat18`` configuration): a dense hub-column block, column-segmented
0/1 tiles (tile buckets, and at this size class panels too), a segmented
ELL with an assembly plan that adds, behind row and column permutations.

At scale 13 (8,192 vertices) the default constants build none of the
column segments and no dense block, so `shrink` lowers them: the
dense-column cut to about 100 nonzeros a column (988 hub columns at
scale 18 sit past ~524), the ELL and the tiles' column segments to 1,024
columns (24,064 and 16,384 at scale 18). It lowers them in the port, and
with ``reference`` in the JAX reference too, so that both packages build
the same layout (the reference is imported only then: the card has no
JAX).
"""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

from fastsparse_torch import linops
from fastsparse_torch.bench import model as tmodel
from fastsparse_torch.bench.matrices import rmat

SCALE = 13
ROOT = Path(__file__).resolve().parents[1]


def shrink(monkeypatch, reference=False):
    models, builders = [tmodel], [linops]
    if reference:
        from fastsparse import linops as jlinops
        from fastsparse.bench import model as jmodel
        models.append(jmodel)
        builders.append(jlinops)
    for mod in models:
        monkeypatch.setattr(mod, "DENSE_COL_MIN_D", 4)
        monkeypatch.setattr(mod, "DENSE_COL_CELL_S", 3e-11)
        monkeypatch.setattr(mod, "DENSE_COL_MIN_ROWS", 64)
    for mod in builders:
        monkeypatch.setattr(mod, "SEG_COLS", 1024)
        monkeypatch.setattr(mod, "BSR_SEG_COLS_BINARY3", 1024)


def matrix():
    """The Graph 500 initiator (0.57, 0.19, 0.19), edge factor 16, 0/1."""
    return rmat(SCALE, 16, seed=3)


def bench_lib(name):
    """``benchmark/lib/<name>.py``, loaded by path (it imports torch only)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_lib_{name}", ROOT / "benchmark" / "lib" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LAYOUT = bench_lib("layout")


def parts(tiling) -> dict:
    """Counts of the part kinds of one hybrid tiling."""
    c = LAYOUT.layout_counts(SimpleNamespace(fwd=tiling))["fwd"]
    segs = tiling.sparse.segments if tiling.sparse is not None else ()
    return {
        "dense_cols": c.get("dense_cols_D", 0),
        "tile_segments": (len(tiling.dense.segments)
                          if type(tiling.dense).__name__ == "ColSegmented"
                          else 0),
        "tile_buckets": c.get("BsrBucket", 0),
        "panel_buckets": c.get("PanelBucket", 0),
        "ell_segments": len(segs),
        "plan_adds": c.get("plan_adds", 0),
    }
