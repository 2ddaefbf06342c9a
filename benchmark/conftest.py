"""Shared set-up of the benchmark's CPU self-tests, for every test under
``benchmark/``.

`tests/test_harness.tiny_spec` gives every configuration a small twin from
its ``TINY_ARGS`` table; the twin of ``powerlaw250k`` (BASELINE config 2's
power-law matrix) is the same generator at 4,096², 50 nonzeros a row,
added here for every test.
"""
import sys

import pytest

POWERLAW250K_TINY = {"nrow": 4096, "ncol": 4096, "nnz": 204800,
                     "alpha": 1.6}


@pytest.fixture(autouse=True)
def powerlaw250k_tiny_twin(monkeypatch):
    harness_tests = sys.modules.get("test_harness")
    if harness_tests is not None:
        monkeypatch.setitem(harness_tests.TINY_ARGS, "powerlaw250k",
                            POWERLAW250K_TINY)
