"""-histo2D over an assembly and its reads through the port's `execute`,
on the CPU, against the benchmark's plain reference.

The configuration is the benchmark's `na18507-slice-k27-histo2d` (the
cell human.histo2d): `benchmark/generate.py` draws its slice and reads
from a seed at a tiny size and writes the slice as an assembly FASTA,
bank 0, ahead of the reads; the job is `execute` with the configuration's
and the `table` traffic's flags, as the `dsk` CLI's parser makes them,
and `-device cpu`.  `benchmark/reference.py` (plain PyTorch) counts the
same codes bank by bank.  Every comparison is exact: the .histo2D and
.histo bytes, the solid count, and every (k-mer, count in each bank) row,
in one pass and in a forced two-pass plan.

The per-bank path's spans and counters are checked in the same runs:
`gather.group` under `gather`, `finish.histo2d`, and the counters
bank.pairs (the table's (k-mer, bank) rows), bank.kmers (the distinct
k-mers) and bank.nb_banks; a one-bank run records none of them.  The
two-pass run also holds `count.merge`, the host merge of the passes'
tables, and its counters: count.merge_packed once (k = 27 packs into 64
bits) and count.merge_rows the merged table's rows.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from benchmark import generate, reference
from benchmark import run as bench_run
from dsk_tpu_torch.engine import run as port_run
from dsk_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "benchmark", "configs",
                      "na18507-slice-k27-histo2d.json")
TRAFFIC = os.path.join(ROOT, "benchmark", "traffic", "table.json")
# 200 kbp keeps the configuration's repeat at ~71 copies of the 300-bp
# element, ~17 of them intact over one of its 27-mers on average (a copy
# diverges by up to 15%), so the .histo2D's column 10 (ten and more
# copies in the assembly) fills; 6,000 reads (3x) keep a job near a
# second
SIZES = {"genome_length": 200_000, "read_count": 6_000}
SEED = 2**35 + 19
BANK_SPANS = ("gather.group", "finish.histo2d")
BANK_COUNTERS = ("bank.pairs", "bank.kmers", "bank.nb_banks")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    with open(CONFIG) as f:
        cfg = dict(json.load(f), **SIZES)
    with open(TRAFFIC) as f:
        traffic = json.load(f)
    work = str(tmp_path_factory.mktemp("histo2d"))
    out = generate.write_cell_inputs(SEED, cfg, traffic, work)
    params = bench_run.job_params(cfg, traffic, out["files"], work, "cpu")
    ref = reference.reference_answer(
        out["banks"], params.kmer_size, params.histo_max,
        params.abundance_min, params.abundance_max)
    return params, ref


@pytest.fixture(scope="module")
def runs(drawn):
    """The job in one pass and in a plan forced to two, each with its
    .histo and .histo2D bytes and its run's record."""
    params, _ = drawn
    real_plan = port_run.plan_resources
    got = {}
    for n_passes in (1, 2):

        def plan(*a, _n=n_passes, **kw):
            p = real_plan(*a, **kw)
            p.n_passes = _n
            return p

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_run, "plan_resources", plan)
            out = port_run.execute(params)
        got[n_passes] = (out, _read(out.histo_path),
                         _read(out.histo2d_path), spans.runs()[-1])
    return got


def test_the_drawn_assembly_fills_the_last_column(drawn):
    params, ref = drawn
    rows = [line.split() for line in ref["histo2d"].decode().splitlines()]
    assert len(rows) == params.histo_max + 1
    assert sum(int(r[11]) for r in rows) > 0  # column 10: >= 10 copies
    assert sum(int(r[1]) for r in rows) > 0  # column 0: error k-mers


@pytest.mark.parametrize("n_passes", [1, 2])
def test_histo2d_matches_the_plain_reference(drawn, runs, n_passes):
    params, ref = drawn
    out, histo, histo2d, _ = runs[n_passes]
    assert out.info["config"]["nb_passes"] == n_passes
    assert histo2d == ref["histo2d"]
    assert histo == ref["histo"]
    assert out.n_solid == ref["solid_values"].size > 0
    values, counts, solid_values, solid_counts = reference.program_table(
        out.result, params.abundance_min, params.abundance_max)
    assert counts.shape == ref["counts"].shape == (ref["values"].size, 2)
    assert reference.rows_off(values, counts, ref["values"],
                              ref["counts"]) == 0
    assert reference.rows_off(solid_values, solid_counts,
                              ref["solid_values"], ref["solid_counts"]) == 0


@pytest.mark.parametrize("n_passes", [1, 2])
def test_per_bank_spans_and_counters(runs, n_passes):
    out, _, _, record = runs[n_passes]
    trace = out.info["trace"]
    assert set(BANK_SPANS) <= set(trace["spans"])
    counters = trace["counters"]
    assert counters["bank.nb_banks"] == 2
    # every live (k-mer, bank) row of the passes' tables: a nonzero entry
    # of the bank matrix
    assert counters["bank.pairs"] == int((out.result.bank_counts > 0).sum())
    assert counters["bank.kmers"] == out.result.n_distinct
    parents = {parent for name, *_, parent, _tid, _depth
               in record["intervals"] if name == "gather.group"}
    assert parents == {"gather"}
    # the passes' tables merged on the host: a span of its own, and at
    # k = 27 by the packed key, once, over every distinct k-mer
    assert ("count.merge" in trace["spans"]) == (n_passes > 1)
    assert "count.merge_lexsort" not in counters
    if n_passes > 1:
        assert counters["count.merge_packed"] == 1
        assert counters["count.merge_rows"] == out.result.n_distinct
    else:
        assert "count.merge_packed" not in counters
        assert "count.merge_rows" not in counters


def test_one_bank_run_records_no_bank_spans(drawn):
    params, _ = drawn
    reads = params.file.split(",")[1]
    out = port_run.execute(dataclasses.replace(params, file=reads,
                                               histo2d=False))
    trace = out.info["trace"]
    assert out.result.bank_counts is None
    assert not set(BANK_SPANS) & set(trace["spans"])
    assert not set(BANK_COUNTERS) & set(trace["counters"])
    assert np.asarray(out.result.histogram)[1:].sum() == out.result.n_distinct
