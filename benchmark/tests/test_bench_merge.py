"""The reader merge.s_per_gbase of the cell human.histo2d, on made-up
run records and a made-up trace: the span `count.merge` per Gbase, and no
reading where no run holds the span."""

import pytest

from bench_tiny import ROOT  # noqa: F401  (the repository on sys.path)
from test_bench_spans import JOBS, KERNELS, children, make_run, make_trace

from benchmark import program_spans, run

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def ctx(tmp_path, monkeypatch):
    def runs(spans):
        return [make_run(j0, spans, children(j0)) for j0, _ in JOBS]

    ctx = {"jobs": [], "trace": make_trace(tmp_path, JOBS, KERNELS),
           "bases": 2e9, "window_s": 1e-3, "k": 27, "W": 2,
           "device_kind": H100}
    ctx["set_spans"] = lambda spans: monkeypatch.setattr(
        program_spans, "_program_runs", lambda: runs(spans))
    return ctx


def test_merge_reader_reads_the_merge_span(ctx):
    read = run.load_reader("merge.s_per_gbase")
    ctx["set_spans"]({"stream": 4.0, "gather.group": 1.5,
                      "count.merge": 0.75})
    # two runs of 0.75 s over 2 Gbase
    assert read(ctx) == pytest.approx(2 * 0.75 / 2)


def test_merge_reader_reads_nothing_without_its_span(ctx):
    read = run.load_reader("merge.s_per_gbase")
    # a program older than the span, or counts of one pass
    ctx["set_spans"]({"stream": 4.0, "gather.group": 1.5,
                      "finish.histo2d": 0.25})
    assert read(ctx) is None
    ctx["set_spans"]({"count.merge": 1.0})
    ctx["trace"] = None
    assert read(ctx) is None
