"""The cell human.histo2d: its two readers (bank.host_s_per_gbase,
kernel.extract_bank_roofline) on made-up run records and a made-up trace,
with no reading where they find nothing to read; a tiny CPU run of the
cell and of the cell with the banks swapped in the fold; and, on the
card, a short window of the cell and the control at the cell's own size."""

import json
import subprocess
import sys
import time

import pytest

from bench_tiny import ROOT, tiny_spec
from test_bench_spans import JOBS, KERNELS, children, make_run, make_trace

from benchmark import program_spans, roofline, run
import dsk_tpu_torch.dist.engine as engine_mod

CELL = "human.histo2d"
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


def test_bank_host_reader_sums_the_two_spans(ctx):
    read = run.load_reader("bank.host_s_per_gbase")
    ctx["set_spans"]({"stream": 4.0, "gather.group": 1.5,
                      "finish.histo2d": 0.25})
    # two runs of (1.5 + 0.25) s over 2 Gbase
    assert read(ctx) == pytest.approx(2 * 1.75 / 2)
    ctx["set_spans"]({"stream": 4.0, "gather.group": 1.5})
    assert read(ctx) == pytest.approx(2 * 1.5 / 2)


def test_bank_host_reader_reads_nothing_without_its_spans(ctx):
    read = run.load_reader("bank.host_s_per_gbase")
    # a program older than the spans, or a count of one bank
    ctx["set_spans"]({"stream": 4.0, "gather": 1.0, "finish.histo": 0.1})
    assert read(ctx) is None
    ctx["set_spans"]({"gather.group": 1.0})
    ctx["trace"] = None
    assert read(ctx) is None


def _extract_trace(tmp_path, dur_us):
    from benchmark import tracing

    kernel = "void (anonymous namespace)::wire_extract_kernel<2, true, true>"
    events = [
        {"ph": "X", "name": "bench.window", "cat": "user_annotation",
         "ts": 0, "dur": 1000},
        {"ph": "X", "name": "bench.stream", "cat": "user_annotation",
         "ts": 10, "dur": 900},
        {"ph": "X", "name": kernel, "cat": "kernel", "ts": 50,
         "dur": dur_us, "args": {"correlation": 1}},
        {"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
         "ts": 20, "dur": 1, "args": {"correlation": 1}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.Trace(str(path))


def test_extract_bank_roofline_counts_the_bank_word(tmp_path):
    read = run.load_reader("kernel.extract_bank_roofline")
    jobs = [{"bases": 400_000, "windows": 300_000}] * 2
    ctx = {"jobs": jobs, "trace": _extract_trace(tmp_path, 500),
           "bases": 800_000, "k": 27, "W": 2, "device_kind": H100}
    # 2 bits a base in, 3 words (the k-mer's 2 and its bank) a window out
    need = 2 * (400_000 // 4 + 300_000 * 12)
    want = 100.0 * need / 3.35e12 / 500e-6
    assert read(ctx) == pytest.approx(want)
    assert roofline.extract_bytes(400_000, 300_000, 3) == need // 2
    # the one-bank reader counts 2 words a window: it reads lower
    assert run.load_reader("kernel.extract_roofline")(ctx) < want


def test_extract_bank_roofline_reads_nothing_without_its_kernel(tmp_path):
    read = run.load_reader("kernel.extract_bank_roofline")
    ctx = {"jobs": [{"bases": 4, "windows": 1}], "trace": None, "bases": 4,
           "k": 27, "W": 2, "device_kind": H100}
    assert read(ctx) is None
    ctx["trace"] = make_trace(tmp_path, JOBS, KERNELS)  # no extraction
    assert read(ctx) is None
    ctx["trace"] = _extract_trace(tmp_path, 500)
    ctx["device_kind"] = "cpu"
    assert read(ctx) is None


def _run_tiny(spec):
    return run.run_cell(spec, 2**35 + 23, 0.3, False, device="cpu",
                        t_start=time.perf_counter())


def test_tiny_cpu_run_of_the_cell_is_correct():
    spec = tiny_spec(CELL)
    assert spec["config"]["assembly_bank"] is True
    assert spec["config"]["flags"][-2:] == ["-histo2D", "1"]
    res = _run_tiny(spec)
    assert res["correct"] is True and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_tiny_cpu_run_with_the_banks_swapped_is_not_correct(monkeypatch):
    orig = engine_mod._group_by_kmer

    def swapped(*a, **kw):
        kmers, counts, banks = orig(*a, **kw)
        return kmers, counts, banks[:, ::-1].copy()

    monkeypatch.setattr(engine_mod, "_group_by_kmer", swapped)
    res = _run_tiny(tiny_spec(CELL))
    assert res["correct"] is False
    assert res["checks"]["jobs_off"]["value"] > 0
    assert res["checks"]["table_rows_off"]["value"] > 0


def _card():
    import torch

    return torch.cuda.is_available()


@pytest.mark.cuda
def test_a_short_window_of_the_cell_on_the_card_is_correct():
    if not _card():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELL, "--seed", "2419000091", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_control_fails_at_the_cells_own_size_on_the_card():
    if not _card():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "benchmark/control.py",
                        "--workload", CELL, "--seeds", "7"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert all(got["control"][key] > 0 for key in
               ("jobs_off", "table_rows_off", "solid_rows_off"))
    assert all(v == 0 for v in got["exact"].values())
