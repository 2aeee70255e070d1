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


def two_bank_spec(**sizes) -> dict:
    """A made-up cell of DSK's -histo2D form: the tiny genome as the
    assembly, bank 0, before its reads, with human.table's flags and
    `-histo2D 1`.  The genome's repeat (30 copies of a 200-bp element,
    under 2% apart) puts k-mers 10 times and more in the assembly, so the
    .histo2D's last column is filled."""
    spec = tiny_spec("human.table", **sizes)
    cfg = spec["config"]
    spec["config"] = dict(
        cfg, name="tiny-histo2d", assembly_bank=True,
        repeat={"element_length": 200, "share": 0.3,
                "divergence_max": 0.02},
        flags=[*cfg["flags"], "-histo2D", "1"])
    spec["cell"] = dict(spec["cell"], name="tiny.histo2d",
                        config="tiny-histo2d")
    return spec


def spec_of(cell: str) -> dict:
    """tiny_spec of a cell of BENCHMARK.json, or the made-up
    `tiny.histo2d` cell."""
    return two_bank_spec() if cell == "tiny.histo2d" else tiny_spec(cell)
