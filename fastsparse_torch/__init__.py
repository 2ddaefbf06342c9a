"""fastsparse_torch — the PyTorch/CUDA port of fastsparse.

A second package beside the JAX reference ``fastsparse``: the same
formats, layouts and products in PyTorch, with every kernel of the ported
path written by hand in CUDA C++ for NVIDIA Hopper (sm_90a). It imports
torch and never jax. Ported so far: the mono int8-panel BSR main path
(`operator(m, format="bsr")`, its products, the normal-equation chain and
the CG solvers), the f32 ELL gather engine (`operator(m, format="ell")`,
with the one-launch-per-bucket kernel behind ``ell_ops.USE_SMEM_PATH``),
the tile-bucket and class-panel BSR layouts and their column-segmented
containers, the hybrid format (dense tiles and a dense-column block beside
the gather engine), ``format="auto"`` where it lands on any of these, the
``reorder=`` orderings, f64 ELL operators, the fp64-class double-word
products (`build_ell_dd`, `spmm_dd`), and the scatter engines:
``format="coo"``/``"csr"``, `spmv_t`/`spmm_t`, the normal-equation
products `ata_x`/`ata_X`/`aat_x`, transposes without the dual tiling, f64
operands on BSR layouts, and the on-device orderings (`sort_coo`,
`transpose_coo`, Morton and Hilbert keys). Entry points build on the card
(``device="cuda"``) unless the caller asks for another device.
"""
from .config import Config, DEFAULT, LANES
from .formats.coo import COO, BinaryCOO, coo_from_scipy, binary_coo_from_scipy
from .formats.csr import CSR, BinaryCSR, csr_from_scipy, binary_csr_from_scipy
from .formats.convert import to_coo, to_csr, to_csr_host, transpose_coo
from .formats.bsr import (
    BsrBucket, BsrMatrix, MonoGroupBucket, MonoPanelBucket, PanelBucket,
    build_bsr,
)
from .formats.segmented import ColSegmented, build_bsr_segmented
from .formats.ell import (
    DdEll, EllBucket, EllMatrix, SegmentedEll, build_ell, build_ell_dd,
    build_ell_segmented,
)
from .formats.hybrid import (
    DenseCols, HybridMatrix, build_hybrid, dense_tile_fraction,
)
from .linops import SparseOperator, operator
from .reorder.sort import sort_coo, ORDERINGS
from .reorder.morton import morton_key, morton_key64
from .reorder.hilbert import hilbert_key, hilbert_key64, hilbert_d2xy
from .ops.spmm import spmm, spmm_t, spmm_dd
from .ops.spmv import spmv, spmv_t
from .ops.ata import ata_x, ata_X, aat_x
from .solvers.cg import CGResult, cg, cg_normal, normal_jacobi
from . import bench
from . import interop

__all__ = [
    "Config", "DEFAULT", "LANES",
    "COO", "BinaryCOO", "coo_from_scipy", "binary_coo_from_scipy", "to_coo",
    "CSR", "BinaryCSR", "csr_from_scipy", "binary_csr_from_scipy", "to_csr",
    "to_csr_host", "transpose_coo",
    "sort_coo", "ORDERINGS", "morton_key", "morton_key64", "hilbert_key",
    "hilbert_key64", "hilbert_d2xy",
    "BsrBucket", "BsrMatrix", "MonoGroupBucket", "MonoPanelBucket",
    "PanelBucket", "build_bsr", "ColSegmented", "build_bsr_segmented",
    "DdEll", "EllBucket", "EllMatrix", "SegmentedEll", "build_ell",
    "build_ell_dd", "build_ell_segmented",
    "DenseCols", "HybridMatrix", "build_hybrid", "dense_tile_fraction",
    "SparseOperator", "operator", "spmm", "spmm_t", "spmm_dd", "spmv",
    "spmv_t", "ata_x", "ata_X", "aat_x",
    "CGResult", "cg", "cg_normal", "normal_jacobi",
    "bench", "interop",
]
