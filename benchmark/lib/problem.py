"""A configuration's matrix and operands, from the run's seed.

The configuration file names a generator of `lib.matrices` and its
structure parameters, and ``seed_draws``, what the run's ``--seed`` draws:

* ``"matrix"``: the whole matrix (the banded headline, whose layout is the
  same at every seed);
* ``"column_order"``: the published instance (``at_source_seed``) with
  its columns in an order drawn from the seed. A seed that drew a new
  fingerprint matrix would change the work, not only the data: the
  transpose tiling's plan then issues 36 to 55 adds, and the Macau step
  took 141-142 ms at 55 against 101-128 at 36 (two sets, same seeds). A
  column order keeps every bucket, dense column, segment and plan class.

A ``torch.Generator`` on the device, seeded alike, draws the operand
buffers in one call. The same seed gives the same inputs.
"""
from __future__ import annotations

from . import matrices

__all__ = ["seed_value", "make_matrix", "make_operands"]


def seed_value(seed: int) -> int:
    """The seed as both numpy and torch take it (0 <= s < 2**63)."""
    return int(seed) % (1 << 63)


def make_matrix(config: dict, seed: int):
    """The configuration's scipy CSR matrix for ``seed``."""
    import numpy as np

    gen = getattr(matrices, config["generator"])
    draws = config["seed_draws"]
    if draws == "matrix":
        m = gen(**config["args"], seed=seed_value(seed))
    elif draws == "column_order":
        m = gen(**config["args"], seed=config["at_source_seed"]["seed"])
        order = np.random.default_rng(seed_value(seed)).permutation(m.shape[1])
        m = m[:, order].tocsr()
    else:
        raise ValueError(f"seed_draws {draws!r}")
    if config.get("values") == "ones":
        m.data[:] = 1.0
    return m


def make_operands(traffic: dict, shape, seed: int, device):
    """The traffic's operand buffers (float32, standard normal)."""
    import torch

    from .traffic import operand_shape

    n = int(traffic["operand"]["buffers"])
    g = torch.Generator(device=device)
    g.manual_seed(seed_value(seed))
    x = torch.randn((n,) + operand_shape(traffic, shape), generator=g,
                    device=device, dtype=torch.float32)
    return list(x.unbind(0))
