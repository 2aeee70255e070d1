"""The harness: BENCHMARK.json within the contract's limits, every
configuration, cell and per-layer metric found by name from files of its
own, whole CPU runs of every cell and of a made-up two-bank -histo2D cell
at a tiny size, the cells that came before gzip and several banks run as
they ran, and no module of JAX or of the JAX package in a run's process."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from bench_tiny import ROOT, spec_of, tiny_spec, two_bank_spec

from benchmark import generate, reference, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return run.load_bench()


def test_benchmark_json_within_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(
        names)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(r) for r in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        # every reduced key is a key of the file, with its reason there
        assert set(c["reduced"]) == set(cfg["reduced"])
    assert len(json.dumps(bench)) < 64 << 10


def test_every_cell_and_metric_is_found_by_name(bench):
    for w in bench["workloads"]:
        spec = run.load_cell(bench, w["name"])
        assert spec["config"]["name"] == w["config"]
        assert spec["traffic"]["flags"]
        assert {m["name"] for m in spec["end_to_end"]} == {
            m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert callable(run.load_reader(m["name"]))


def test_a_new_cell_and_metric_need_only_new_files(tmp_path, bench):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "benchmark/configs/ecoli-srr001665-k21.json")
                     .read_text())
    (root / "benchmark/configs/new-config.json").write_text(
        json.dumps(dict(cfg, name="new-config")))
    (root / "benchmark/traffic/new.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "flags": ["-spill", "on"]}))
    (root / "benchmark/metrics/new.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append(dict(new["configs"][0], name="new-config",
                               file="benchmark/configs/new-config.json"))
    new["workloads"].append({"name": "new.cell", "config": "new-config",
                             "traffic": "new", "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "new.metric", "unit": "%",
                             "better": "lower", "source": "program_span",
                             "layer": "x", "moves": "count_mbases_s",
                             "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    spec = run.load_cell(run.load_bench(str(root)), "new.cell", str(root))
    assert spec["config"]["name"] == "new-config"
    assert spec["traffic"]["flags"] == ["-spill", "on"]
    assert [m["name"] for m in spec["per_layer"]] == ["new.metric"]
    assert run.load_reader("new.metric", str(root))({}) == 42.0
    assert "new.metric" not in {m["name"] for m in run.load_cell(
        run.load_bench(str(root)), "ecoli.table", str(root))["per_layer"]}


@pytest.mark.parametrize("cell", ["ecoli.table", "human.table",
                                  "ecoli.table.gz", "tiny.histo2d"])
def test_tiny_cpu_run_is_correct(cell):
    res = run.run_cell(spec_of(cell), 2**35 + 1, 0.5, False,
                       device="cpu", t_start=time.perf_counter())
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"count_mbases_s", "peak_dev_gib",
                                   "setup_s"}
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())


# what the harness ran for these cells before gzip and several banks:
# the command line of a job, and a sha256 of the reference's answer to the
# tiny cell at seed 2**33 + 5 (values, counts, histogram, solid values and
# counts as little-endian int64, then the .histo bytes)
BEFORE = {
    "ecoli.table": (
        ["-kmer-size", "21", "-abundance-min", "2", "-max-memory", "20000",
         "-nb-cores", "4"],
        "0e867e2cc100ba82acfdc470df0f4a439a254a85dafafa9fc04d776791e1c458"),
    "human.table": (
        ["-kmer-size", "27", "-abundance-min", "3", "-max-memory", "20000",
         "-nb-cores", "4"],
        "b8b15a62f1e79054fc8e281c0b7c96f0008ef5d4d44752d4c42422d13ca54def"),
}


@pytest.mark.parametrize("cell", sorted(BEFORE))
def test_the_first_cells_run_and_are_judged_as_before(tmp_path, cell):
    flags, answer_sha = BEFORE[cell]
    spec = tiny_spec(cell)
    out = generate.write_cell_inputs(2**33 + 5, spec["config"],
                                     spec["traffic"], str(tmp_path))
    fastq = str(tmp_path / "reads.fastq")
    assert out["files"] == [fastq]
    argv = run.job_argv(spec["config"], spec["traffic"], out["files"],
                        "/w", "cuda")
    assert argv == [*flags, "-spill", "off", "-storage-type", "none",
                    "-histo", "1", "-file", fastq, "-out-dir", "/w",
                    "-out", "/w/job", "-device", "cuda", "-verbose", "0"]
    params = run.job_params(spec["config"], spec["traffic"], out["files"],
                            "/w", "cuda")
    assert (params.file, params.histo, params.histo2d,
            params.solidity_kind) == (fastq, True, False, "sum")
    ref = reference.reference_answer(
        out["banks"], params.kmer_size, params.histo_max,
        params.abundance_min, params.abundance_max)
    h = hashlib.sha256()
    for key in ("values", "counts", "histogram", "solid_values",
                "solid_counts"):
        h.update(ref[key].astype("<i8").tobytes())
    h.update(ref["histo"])
    assert h.hexdigest() == answer_sha
    assert "histo2d" not in ref
    assert reference.LIMITS == {"jobs_failed": 0, "jobs_off": 0,
                                "table_rows_off": 0, "solid_rows_off": 0}


@pytest.mark.parametrize("flags", [["-solidity-kind", "min"],
                                   ["-solidity-custom", "1,0"]])
def test_a_solidity_rule_other_than_sum_is_refused(flags):
    spec = two_bank_spec()
    config = dict(spec["config"], flags=[*spec["config"]["flags"], *flags])
    with pytest.raises(ValueError, match="solidity-kind sum"):
        run.job_params(config, spec["traffic"], ["a.fa", "r.fq"], "/w",
                       "cpu")
    with pytest.raises(ValueError, match="solidity-kind sum"):
        run.run_cell(dict(spec, config=config), 1, 0.1, False,
                     device="cpu", t_start=time.perf_counter())


def test_tiny_cpu_traced_run_reads_the_host_metrics():
    res = run.run_cell(tiny_spec("ecoli.table"), 3, 0.5, True,
                       device="cpu", t_start=time.perf_counter())
    assert res["correct"] is True
    # the CPU has no device trace: only the metrics from RunOutput.info
    assert set(res["metrics"]) == {"run.other_share", "feed.gen_share",
                                   "gather.s_per_gbase",
                                   "device.idle_share"}
    assert 0 < res["metrics"]["run.other_share"]["value"] < 100
    assert res["device"]["window_s"] > 0
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "ecoli.table", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "ecoli.table", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


_PROBE = """
import sys, time
sys.path.insert(0, {tests!r})
from bench_tiny import tiny_spec
from benchmark import run
res = run.run_cell(tiny_spec("human.table"), 5, 0.3, True, device="cpu",
                   t_start=time.perf_counter())
import json
print(json.dumps([res["correct"], sorted({{m.split(".")[0]
                                          for m in sys.modules}})]))
"""


def test_a_run_loads_no_jax_and_nothing_of_the_jax_package():
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "-c", _PROBE.format(tests=tests)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    ok, tops = json.loads(r.stdout.strip().splitlines()[-1])
    assert ok is True
    tops = set(tops)
    assert "dsk_tpu_torch" in tops and "benchmark" in tops
    assert not tops & set(run.FORBIDDEN)


def _card():
    import torch

    return torch.cuda.is_available()


@pytest.mark.cuda
def test_cells_on_the_card_are_correct():
    if not _card():
        pytest.skip("needs a CUDA device")
    for cell in ("ecoli.table", "human.table", "ecoli.table.gz"):
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            cell, "--seed", "2", "--seconds", "1"],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        res = json.loads(r.stdout.strip().splitlines()[-1])
        assert res["correct"] is True
        assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_two_bank_histo2d_run_on_the_card_is_correct():
    # no cell of BENCHMARK.json has two banks yet: this drives the bank
    # plane, the per-bank fold and the .histo2D writer through the harness
    if not _card():
        pytest.skip("needs a CUDA device")
    res = run.run_cell(two_bank_spec(), 2**35 + 7, 1.0, False,
                       device="cuda", t_start=time.perf_counter())
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"


def test_trace_reduction_union_layers_and_idle_spans(tmp_path):
    from benchmark import tracing

    def ev(name, cat, ts, dur, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    def launched(name, cat, ts, dur, corr, at):
        # a device event and the host call that launched it at `at`
        return [ev(name, cat, ts, dur, corr),
                ev("cudaLaunchKernel", "cuda_runtime", at, 1, corr)]

    sort = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel"
    events = [
        ev("bench.window", "user_annotation", 0, 120),
        ev("bench.job", "user_annotation", 0, 90),
        ev("bench.plan", "user_annotation", 0, 40),
        ev("bench.stream", "user_annotation", 40, 35),
        ev("bench.gather", "user_annotation", 66, 6),
        # overlapping kernels count once in the busy time
        *launched("void (anonymous namespace)::wire_extract_kernel<2, true>",
                  "kernel", 50, 10, 1, 41),
        *launched(sort, "kernel", 55, 10, 2, 42),
        *launched("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 45, 2, 3,
                  43),
        # a torch kernel launched by the gather, not the flush
        *launched("void at::native::reduce_kernel<512, 1>", "kernel", 68, 1,
                  4, 67),
        *launched("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 70, 2, 5,
                  69),
        # a torch kernel launched outside the stream, and one whose launch
        # the trace does not hold: neither is the flush's
        *launched(sort, "kernel", 30, 3, 6, 29),
        ev(sort, "kernel", 80, 4, 7),
        *launched("Memset (Device)", "gpu_memset", 95, 10, 8, 44),
        ev("aten::sort", "cpu_op", 10, 5),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = tracing.Trace(str(path))
    assert tr.window_s == pytest.approx(120e-6)
    assert tr.busy_s == pytest.approx((3 + 2 + 15 + 1 + 2 + 4 + 10) * 1e-6)
    assert tr.device_s("kernels.extract") == pytest.approx(10e-6)
    assert tr.device_s("flush") == pytest.approx(10e-6)
    assert tr.device_s("feed.h2d") == pytest.approx(2e-6)
    assert tr.device_s("gather.kernels") == pytest.approx(1e-6)
    assert tr.device_s("gather.d2h") == pytest.approx(2e-6)
    assert tr.device_s("other") == pytest.approx((3 + 4 + 10) * 1e-6)
    # gaps 0-30 and 33-45 (midpoints in plan, inside job), 47-50
    # (stream), 65-68 and 69-70 (gather), 72-80 and 84-95 (job alone),
    # 105-120 (outside every span but the window)
    assert dict(tr.idle_by_span()) == pytest.approx(
        {"plan": 42e-6, "stream": 3e-6, "gather": 4e-6, "job": 19e-6,
         "harness": 15e-6})
    assert tr.device_ops()[0][1] == pytest.approx(17e-6)
