"""Shared set-up of the benchmark's CPU self-tests.

`test_harness.tiny_spec` gives every configuration a small twin from its
``TINY_ARGS`` table; the twin of ``rmat18`` (the Graph 500 R-MAT graph)
is the same generator at scale 11, added here for every test.
"""
import sys

import pytest

RMAT18_TINY = {"scale": 11, "edge_factor": 16, "a": 0.57, "b": 0.19,
               "c": 0.19}


@pytest.fixture(autouse=True)
def rmat18_tiny_twin(monkeypatch):
    harness_tests = sys.modules.get("test_harness")
    if harness_tests is not None:
        monkeypatch.setitem(harness_tests.TINY_ARGS, "rmat18", RMAT18_TINY)
