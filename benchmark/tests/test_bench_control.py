"""`correct` comes out false where it should: the control (the reference
with 32-bit keys in the program's place) fails the comparison, and a run
of the harness with the timed path broken underneath reads not correct,
once for each fault a one-card count can have:

* a step that returns its state unchanged (the group step);
* half of each batch left out, and the counts of the rest doubled to
  stand for the whole (the mean over the rest);
* an answer altered where it is produced (one count of the gathered
  table).

Over two banks (the made-up `-histo2D` cell: the assembly, then the
reads) three more: the banks swapped in the per-bank fold, the assembly's
column of the .histo2D capped at 9, and the assembly bank left out of the
count.

The exchange between chips has no fault here: every cell runs on one
card, and a one-card count exchanges nothing."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

import numpy as np

from bench_tiny import ROOT, spec_of, tiny_spec, two_bank_spec

from benchmark import control, reference, run
import dsk_tpu_torch.dist.engine as engine_mod
import dsk_tpu_torch.engine.processors as processors_mod


def test_control_fails_and_the_exact_reference_passes():
    # ~3.3M distinct k-mers: enough for 32-bit keys to collide
    spec = tiny_spec("ecoli.table", genome_length=2000000,
                     read_count=400000)
    got = control.readings(spec, 2**34 + 3, device="cpu")
    assert got["control"]["table_rows_off"] > 0
    assert got["control"]["jobs_off"] > 0
    assert all(v == 0 for v in got["exact"].values())


def test_control_fails_over_two_banks_on_the_histo2d_too(tmp_path):
    # ~2.1M distinct k-mers over the assembly and its reads
    spec = two_bank_spec(genome_length=2000000, read_count=150000)
    got = control.readings(spec, 2**34 + 5, device="cpu")
    assert got["control"]["table_rows_off"] > 0
    assert got["control"]["jobs_off"] > 0
    assert all(v == 0 for v in got["exact"].values())
    # the folded table's .histo2D alone already differs
    from benchmark import generate

    banks = generate.write_cell_inputs(2**34 + 5, spec["config"],
                                       spec["traffic"], str(tmp_path))["banks"]
    ref = reference.reference_answer(banks, 27, 10000, 3, 2**31 - 1)
    fv, fc = reference.fingerprint_fold(ref["values"], ref["counts"])
    assert fc.shape == (fv.size, 2)
    assert reference.answer(fv, fc, 10000, 3, 2**31 - 1)["histo2d"] \
        != ref["histo2d"]


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
@pytest.mark.parametrize("cell", ["ecoli.table", "human.table",
                                  "ecoli.table.gz", "tiny.histo2d"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    spec = spec_of(cell)
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


def _banks_swapped(orig):
    def group(*a, **kw):
        kmers, counts, banks = orig(*a, **kw)
        return kmers, counts, banks[:, ::-1].copy()
    return group


def _assembly_capped(orig, cap=9):
    def matrix(bank_counts, *a, **kw):
        capped = bank_counts.copy()
        capped[:, 0] = np.minimum(capped[:, 0], cap)
        return orig(capped, *a, **kw)
    return matrix


def _bank_dropped(orig, bank=0):
    def batches(*a, **kw):
        for b in orig(*a, **kw):
            codes = b.codes.copy()
            codes[:b.n_rows][b.bank_ids[:b.n_rows] == bank] = 0xFF
            yield dataclasses.replace(b, codes=codes)
    return batches


@pytest.mark.parametrize("fault", ["banks_swapped", "assembly_capped_at_9",
                                   "assembly_dropped"])
def test_a_broken_bank_is_not_correct(monkeypatch, fault):
    spec = two_bank_spec()
    assert _run(spec)["correct"] is True
    if fault == "banks_swapped":
        monkeypatch.setattr(engine_mod, "_group_by_kmer",
                            _banks_swapped(engine_mod._group_by_kmer))
    elif fault == "assembly_capped_at_9":
        monkeypatch.setattr(processors_mod, "histo2d_matrix",
                            _assembly_capped(processors_mod.histo2d_matrix))
    else:
        monkeypatch.setattr(engine_mod, "batch_iterator",
                            _bank_dropped(engine_mod.batch_iterator))
    res = _run(spec)
    assert res["correct"] is False
    assert res["checks"]["jobs_off"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ecoli.table", "human.table",
                                  "ecoli.table.gz"])
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
