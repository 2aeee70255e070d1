"""`correct` comes out false where it should: the control (the reference
with 32-bit keys in the program's place) fails the comparison, and a run
of the harness with the timed path broken underneath reads not correct,
once for each fault a one-card count can have:

* a step that returns its state unchanged (the group step);
* half of each batch left out, and the counts of the rest doubled to
  stand for the whole (the mean over the rest);
* an answer altered where it is produced (one count of the gathered
  table).

The exchange between chips has no fault here: both cells run on one
card, and a one-card count exchanges nothing."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

from bench_tiny import ROOT, tiny_spec

from benchmark import control, run
import dsk_tpu_torch.dist.engine as engine_mod


def test_control_fails_and_the_exact_reference_passes():
    # ~3.3M distinct k-mers: enough for 32-bit keys to collide
    spec = tiny_spec("ecoli.table", genome_length=2000000,
                     read_count=400000)
    got = control.readings(spec, 2**34 + 3, device="cpu")
    assert got["control"]["table_rows_off"] > 0
    assert got["control"]["jobs_off"] > 0
    assert all(v == 0 for v in got["exact"].values())


def _run(spec):
    return run.run_cell(spec, 11, 0.3, False, device="cpu",
                        t_start=time.perf_counter())


def _unchanged_step(self, words, meta, bids, tab_p, tab_c, tover, pass_id):
    return tab_p, tab_c, tover


def _half_batches(orig):
    def batches(*a, **kw):
        for b in orig(*a, **kw):
            codes = b.codes.copy()
            codes[b.n_rows // 2:b.n_rows] = 0xFF
            yield dataclasses.replace(b, codes=codes)
    return batches


def _scaled(orig, factor=2, add=0):
    def live(*a, **kw):
        kmers, counts = orig(*a, **kw)
        counts = counts * factor
        if add:
            counts = counts.copy()
            counts[0] += add
        return kmers, counts
    return live


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch",
                                   "altered_answer"])
@pytest.mark.parametrize("cell", ["ecoli.table", "human.table"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    spec = tiny_spec(cell)
    assert _run(spec)["correct"] is True
    if fault == "unchanged_step":
        monkeypatch.setattr(engine_mod.DistCountEngine, "_step",
                            _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(engine_mod, "batch_iterator",
                            _half_batches(engine_mod.batch_iterator))
        monkeypatch.setattr(engine_mod, "_live_prefix",
                            _scaled(engine_mod._live_prefix))
    else:
        monkeypatch.setattr(engine_mod, "_live_prefix",
                            _scaled(engine_mod._live_prefix, 1, 1))
    res = _run(spec)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ecoli.table", "human.table"])
def test_control_fails_at_the_cells_own_size_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "benchmark/control.py",
                        "--workload", cell, "--seeds", "7"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["control"]["table_rows_off"] > 0
    assert all(v == 0 for v in got["exact"].values())
