"""Shared helpers of the benchmark's tests: the repository on sys.path and
a cell cut to a size the CPU counts in about a second."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

TINY = {"genome_length": 20000, "read_count": 3000}


def tiny_spec(cell: str, **sizes) -> dict:
    """The cell's spec with its configuration cut to `sizes` (default
    TINY); the repeat element, if any, keeps its share and length."""
    spec = run.load_cell(run.load_bench(), cell)
    spec["config"] = dict(spec["config"], **(sizes or TINY))
    return spec
