"""The read generator: deterministic per seed, and the coverage, error
rate, strand balance and repeat share that a configuration states."""

import os

import numpy as np
import pytest

from bench_tiny import tiny_spec

from benchmark import generate, reference


@pytest.fixture(scope="module")
def ecoli_cfg():
    return tiny_spec("ecoli.table", genome_length=200000,
                     read_count=300000)["config"]


def _write(tmp_path, seed, cfg, name="r.fastq"):
    path = os.path.join(tmp_path, name)
    out = generate.write_inputs(seed, cfg, path)
    return path, out


def test_same_seed_same_bytes_other_seed_other(tmp_path, ecoli_cfg):
    p1, a = _write(tmp_path, 2**33 + 5, ecoli_cfg, "a.fastq")
    p2, b = _write(tmp_path, 2**33 + 5, ecoli_cfg, "b.fastq")
    p3, c = _write(tmp_path, 2**33 + 6, ecoli_cfg, "c.fastq")
    assert open(p1, "rb").read() == open(p2, "rb").read()
    assert np.array_equal(a["codes"], b["codes"])
    assert not np.array_equal(a["codes"], c["codes"])
    assert os.path.getsize(p1) == os.path.getsize(p3)


def test_sizes_coverage_errors_strands(tmp_path, ecoli_cfg):
    _, out = _write(tmp_path, 7, ecoli_cfg)
    n, rl = ecoli_cfg["read_count"], ecoli_cfg["read_length"]
    assert out["codes"].shape == (n, rl)
    assert out["n_bases"] == n * rl
    # the coverage the configuration states: bases over genome length
    assert out["n_bases"] / ecoli_cfg["genome_length"] == pytest.approx(
        n * rl / ecoli_cfg["genome_length"])
    rate = ecoli_cfg["substitution_rate"]
    sd = np.sqrt(out["n_bases"] * rate * (1 - rate))
    assert abs(out["n_substitutions"] - out["n_bases"] * rate) < 5 * sd
    assert abs(out["n_reverse"] - n / 2) < 5 * np.sqrt(n / 4)
    assert out["codes"].max() <= 3


def test_substitutions_are_bernoulli_per_base():
    rng = np.random.default_rng(3)
    codes = np.zeros((4000, 100), np.uint8)
    subs = generate.substitute(rng, codes, 0.01)
    assert subs == int((codes != 0).sum())
    assert set(np.unique(codes)) <= {0, 1, 2, 3}
    # changed bases are spread over every position of a read
    per_pos = (codes != 0).sum(axis=0)
    assert per_pos.min() > 0 and abs(per_pos.mean() - 40) < 5


def test_reads_come_from_the_genome_both_strands():
    cfg = {"genome_length": 5000, "read_count": 2000, "read_length": 36,
           "substitution_rate": 0.0}
    rng = np.random.default_rng(11)
    genome = generate.make_genome(rng, cfg)
    reads, rev, subs = next(generate.make_reads(rng, genome, cfg))
    assert subs == 0
    text = generate.LETTERS[genome].tobytes()
    for r, is_rev in zip(reads[:200], rev[:200]):
        fwd = r if not is_rev else (r[::-1] ^ 2)
        assert generate.LETTERS[fwd].tobytes() in text


def test_repeat_share_and_copies():
    cfg = {"genome_length": 300000,
           "repeat": {"element_length": 300, "share": 0.106,
                      "divergence_max": 0.0}}
    g = generate.make_genome(np.random.default_rng(5), cfg)
    # the element is the generator's second draw, after the genome's bases
    rng = np.random.default_rng(5)
    rng.integers(0, 4, size=300000, dtype=np.uint8)
    element = rng.integers(0, 4, size=300, dtype=np.uint8)
    text = generate.LETTERS[g].tobytes()
    # with no divergence every copy is the element or its reverse
    # complement, in either orientation
    fwd = text.count(generate.LETTERS[element].tobytes())
    rev = text.count(generate.LETTERS[element[::-1] ^ 2].tobytes())
    assert fwd + rev == round(0.106 * 300000 / 300)
    assert fwd > 30 and rev > 30
    assert abs((fwd + rev) * 300 / 300000 - 0.106) < 0.001


def test_repeat_copies_diverge_up_to_the_stated_rate():
    cfg = {"genome_length": 300000,
           "repeat": {"element_length": 300, "share": 0.106,
                      "divergence_max": 0.15}}
    g = generate.make_genome(np.random.default_rng(5), cfg)
    plain = generate.make_genome(np.random.default_rng(5), dict(
        cfg, repeat=dict(cfg["repeat"], divergence_max=0.0)))
    # the same draws place the copies; only their substitutions differ
    diff = (g != plain)[:106 * 2830].reshape(106, 2830).sum(axis=1)
    assert diff.max() <= 0.15 * 300 + 5 * np.sqrt(0.15 * 300)
    assert 0.06 * 300 < diff.mean() < 0.09 * 300


def test_fastq_round_trips_through_the_reference_reader(tmp_path,
                                                         ecoli_cfg):
    cfg = dict(ecoli_cfg, read_count=1000)
    path, out = _write(tmp_path, 9, cfg)
    seqs = reference.read_sequences(path)
    assert len(seqs) == 1000
    assert np.array_equal(reference.encode(seqs), out["codes"])
    with open(path, "rb") as f:
        head = f.read(200).split(b"\n")
    assert head[0] == b"@r000" and head[2] == b"+"
    assert head[3] == b"I" * cfg["read_length"]
