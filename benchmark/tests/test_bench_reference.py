"""The plain reference: DSK's golden histograms from its own reader, and
its canonical k-mers against a per-window count in plain Python."""

import os
from collections import Counter

import numpy as np
import pytest
import torch

from bench_tiny import ROOT

from benchmark import reference

DATA = os.path.join(ROOT, "tests", "data")


def _histo_of(path: str, k: int) -> bytes:
    codes = reference.encode(reference.read_sequences(path))
    _, counts = reference.count(codes, k)
    return reference.histo_text(reference.histogram(counts, 10000))


@pytest.mark.parametrize("fasta, k, histo", [
    ("read50x_ref10K_e001.fasta.gz", 27, "k27.histo"),
    ("readN.fasta", 20, "readN.histo"),
])
def test_golden_histograms(fasta, k, histo):
    with open(os.path.join(DATA, histo), "rb") as f:
        want = f.read()
    assert _histo_of(os.path.join(DATA, fasta), k) == want


def _plain_count(seqs: list[bytes], k: int) -> Counter:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    order = {"A": 0, "C": 1, "T": 2, "G": 3}
    out = Counter()
    for s in seqs:
        s = s.decode().upper()
        for i in range(len(s) - k + 1):
            w = s[i:i + k]
            if any(ch not in order for ch in w):
                continue
            r = "".join(comp[ch] for ch in reversed(w))
            vals = [sum(order[ch] << (2 * (k - 1 - j))
                        for j, ch in enumerate(x)) for x in (w, r)]
            out[min(vals)] += 1
    return out


@pytest.mark.parametrize("k", [1, 5, 16, 21, 27, 31])
def test_canonical_counts_against_plain_python(k):
    rng = np.random.default_rng(k)
    seqs = [rng.choice(list(b"ACGTacgtN"), size=n,
                       p=[.24] * 4 + [0.0075] * 4 + [.01]
                       ).astype(np.uint8).tobytes()
            for n in rng.integers(0, 90, size=60)]
    codes = reference.encode(seqs)
    values, counts = reference.count(codes, k, block_rows=7)
    want = _plain_count(seqs, k)
    assert dict(zip(values.tolist(), counts.tolist())) == dict(want)
    assert np.all(np.diff(values) > 0)


def test_k_above_31_is_refused():
    with pytest.raises(ValueError):
        reference.canonical_values(torch.zeros((1, 40), dtype=torch.uint8),
                                   32)


def test_words_to_values_and_rows_off():
    words = np.array([[0, 5], [1, 0], [0x3FF, 0xFFFFFFFF]], np.uint32)
    assert reference.words_to_values(words).tolist() == [
        5, 1 << 32, (0x3FF << 32) | 0xFFFFFFFF]
    v, c = np.array([1, 2, 3]), np.array([4, 5, 6])
    assert reference.rows_off(v, c, v, c) == 0
    assert reference.rows_off(v[::-1], c[::-1], v, c) == 0
    assert reference.rows_off(v, c + [0, 1, 0], v, c) == 2
    assert reference.rows_off(v[:2], c[:2], v, c) == 1
    assert reference.rows_off(np.array([1, 1, 2, 3]), np.array([4, 4, 5, 6]),
                              v, c) == 1


def test_judge_reads_zero_on_the_answer_and_more_off_it():
    v = np.array([3, 8, 9, 40], np.int64)
    c = np.array([1, 2, 7, 3], np.int64)
    ref = reference.answer(v, c, 10000, 2, 2**31 - 1)
    job = {"histo": ref["histo"], "histogram": ref["histogram"],
           "n_solid": 3, "n_distinct": 4}
    table = (v, c, ref["solid_values"], ref["solid_counts"])
    ok = reference.judge(ref, [job, job], [table], 0)
    assert all(ch["value"] == 0 == ch["limit"] for ch in ok.values())
    bad_job = dict(job, n_solid=2)
    c2 = c.copy()
    c2[1] = 1
    bad = reference.judge(ref, [job, bad_job],
                          [(v, c2, v[2:], c[2:]), table], 1)
    assert bad["jobs_off"]["value"] == 1
    assert bad["table_rows_off"]["value"] == 2
    assert bad["solid_rows_off"]["value"] == 1
    assert bad["jobs_failed"]["value"] == 1


def test_fingerprint_fold_merges_keys_that_share_a_hash():
    v = np.arange(0, 5000, dtype=np.int64) * 7919
    c = np.ones(v.size, np.int64)
    fv, fc = reference.fingerprint_fold(v, c)
    assert fc.sum() == c.sum() and np.all(np.diff(fv) > 0)
    # 32-bit keys: 5000 values collide rarely, but the fold is a
    # partition of them, each part's smallest value kept
    assert set(fv.tolist()) <= set(v.tolist())


def test_banks_summed_give_the_golden_histogram():
    # DSK counts c1..c4 as four banks to k27.histo, the histogram of the
    # count summed over them
    banks = [reference.encode(reference.read_sequences(
        os.path.join(DATA, f"c{i}.fasta.gz"))) for i in range(1, 5)]
    ref = reference.reference_answer(banks, 27, 10000, 1, 2**31 - 1)
    with open(os.path.join(DATA, "k27.histo"), "rb") as f:
        assert ref["histo"] == f.read()
    assert ref["counts"].shape == (ref["values"].size, 4)
    assert ref["counts"].sum() == sum(
        reference.count(b, 27)[1].sum() for b in banks)


def _random_bank(rng, n):
    return [rng.choice(list(b"ACGTN"), size=m, p=[.245] * 4 + [.02]
                       ).astype(np.uint8).tobytes()
            for m in rng.integers(0, 120, size=n)]


@pytest.mark.parametrize("k", [5, 21])
def test_per_bank_counts_and_histo2d_against_plain_python(k):
    rng = np.random.default_rng(100 + k)
    # the assembly: a short genome twelve times over, so that its column
    # 10 fills; the reads: pieces of it and random ones
    genome = rng.choice(list(b"ACGT"), size=60).astype(np.uint8).tobytes()
    asm = [genome * 12, genome[::-1]]
    reads = _random_bank(rng, 40) + [genome[i:i + 30] for i in range(25)]
    values, counts = reference.count_banks(
        [reference.encode(asm), reference.encode(reads)], k)
    plain = [_plain_count(asm, k), _plain_count(reads, k)]
    assert np.all(np.diff(values) > 0)
    assert set(values.tolist()) == set(plain[0]) | set(plain[1])
    for b in range(2):
        assert {v: int(c) for v, c in zip(values.tolist(), counts[:, b])
                if c} == dict(plain[b])
    histo_max = 8
    m = reference.histo2d(counts, histo_max)
    want = np.zeros((histo_max + 2, 11), np.int64)
    for v in set(plain[0]) | set(plain[1]):
        want[min(plain[1][v], histo_max + 1), min(plain[0][v], 10)] += 1
    assert np.array_equal(m, want) and want[:, 10].sum() > 0
    lines = reference.histo2d_text(m).decode().splitlines()
    assert len(lines) == histo_max + 1
    for r, ln in enumerate(lines, start=1):
        assert ln.split() == [str(r)] + [str(x) for x in want[r]]
    # the .histo and the solid k-mers read the count summed over banks
    a = reference.answer(values, counts, histo_max, 3, 2**31 - 1)
    total = counts.sum(axis=1)
    assert np.array_equal(a["histogram"],
                          reference.histogram(total, histo_max))
    assert np.array_equal(a["solid_values"], values[total >= 3])
    assert np.array_equal(a["solid_counts"], total[total >= 3])


def test_rows_off_and_judge_over_bank_rows():
    v = np.array([1, 2, 3])
    c = np.array([[0, 4], [1, 5], [2, 0]])
    assert reference.rows_off(v, c, v, c) == 0
    assert reference.rows_off(v, c[:, ::-1], v, c) == 6
    c2 = c.copy()
    c2[1, 0] = 0
    assert reference.rows_off(v, c2, v, c) == 2
    # a table of totals against one of bank rows matches no row
    assert reference.rows_off(v, c.sum(axis=1), v, c) == 6
    assert reference.rows_off(v[:0], c[:0], v, c) == 3
    ref = reference.answer(v, c, 10, 1, 2**31 - 1)
    job = {"histo": ref["histo"], "histogram": ref["histogram"],
           "histo2d": ref["histo2d"], "n_solid": 3, "n_distinct": 3}
    table = (v, c, ref["solid_values"], ref["solid_counts"])
    ok = reference.judge(ref, [job], [table], 0)
    assert all(ch["value"] == 0 for ch in ok.values())
    for off in (dict(job, histo2d=None),
                dict(job, histo2d=ref["histo2d"].replace(b"1 ", b"2 ", 1))):
        bad = reference.judge(ref, [job, off], [table], 0)
        assert bad["jobs_off"]["value"] == 1


def test_fingerprint_fold_sums_each_bank():
    v = np.arange(0, 5000, dtype=np.int64) * 7919
    c = np.stack([np.ones(v.size, np.int64), np.arange(v.size)], axis=1)
    fv, fc = reference.fingerprint_fold(v, c)
    assert fc.shape == (fv.size, 2)
    assert np.array_equal(fc.sum(axis=0), c.sum(axis=0))
    # a k-mer that keeps its key alone keeps its row
    alone = np.isin(v, fv)
    same = np.isin(fv, v[alone]) & (fc[:, 0] == 1)
    rows = dict(zip(v.tolist(), map(tuple, c.tolist())))
    assert all(rows[x] == tuple(r) for x, r in zip(fv[same].tolist(),
                                                   fc[same].tolist()))
