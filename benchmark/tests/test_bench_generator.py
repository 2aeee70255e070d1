"""The read generator: deterministic per seed, and the coverage, error
rate, strand balance and repeat share that a configuration states; the
plain FASTQ of the cells that had it before gzip and several banks, byte
for byte; the gzip form and the assembly bank."""

import gzip
import hashlib
import os
import zlib

import numpy as np
import pytest

from bench_tiny import tiny_spec, two_bank_spec

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


# sha256 of the tiny cells' FASTQ at seed 2**33 + 5, written by the
# generator before it had the gzip and assembly forms
PLAIN_FASTQ_SHA256 = {
    "ecoli.table":
        "691b64fe4e1c79848d7fa95661193525f455e8a4b9f1b875acdd25ba11a3fe37",
    "human.table":
        "c153eb0a9984ea0f5acbd919f1c748fccc92b229a898de6433420beb5354aff0",
}


@pytest.mark.parametrize("cell", sorted(PLAIN_FASTQ_SHA256))
def test_plain_fastq_bytes_are_as_before(tmp_path, cell):
    spec = tiny_spec(cell)
    out = generate.write_cell_inputs(2**33 + 5, spec["config"],
                                     spec["traffic"], str(tmp_path))
    assert [os.path.basename(p) for p in out["files"]] == ["reads.fastq"]
    with open(out["files"][0], "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == PLAIN_FASTQ_SHA256[cell]
    assert out["fastq_bytes"] == len(data)
    assert len(out["banks"]) == 1 and out["banks"][0] is out["codes"]


def test_gzip_form_is_one_member_of_the_same_reads(tmp_path):
    spec = tiny_spec("ecoli.table.gz", genome_length=20000, read_count=5000)
    assert spec["traffic"]["gzip_level"] == 6
    got = []
    for name in ("a", "b"):
        os.makedirs(tmp_path / name)
        got.append(generate.write_cell_inputs(
            2**33 + 5, spec["config"], spec["traffic"], str(tmp_path / name)))
    paths = [g["files"][0] for g in got]
    assert [os.path.basename(p) for p in paths] == ["reads.fastq.gz"] * 2
    raw = [open(p, "rb").read() for p in paths]
    # the bytes depend on the seed alone: no time, a fixed name
    assert raw[0] == raw[1]
    assert raw[0][:4] == b"\x1f\x8b\x08\x08" and raw[0][4:8] == bytes(4)
    assert raw[0][10:22] == b"reads.fastq\x00"
    # one member, at level 6: nothing follows the first member's end
    d = zlib.decompressobj(wbits=31)
    plain = d.decompress(raw[0])
    assert d.eof and d.unused_data == b""
    # the reads of ecoli.table at the same sizes, byte for byte
    sizes = {"genome_length": 20000, "read_count": 5000}
    os.makedirs(tmp_path / "plain")
    fq = generate.write_cell_inputs(
        2**33 + 5, tiny_spec("ecoli.table", **sizes)["config"],
        tiny_spec("ecoli.table")["traffic"], str(tmp_path / "plain"))
    assert open(fq["files"][0], "rb").read() == plain
    assert got[0]["fastq_bytes"] == len(plain) > len(raw[0])
    assert gzip.decompress(raw[0]) == plain
    # pigz's stream at level 6 between the header and the trailer: the
    # blocks deflated one after another, each primed with the 32 KiB
    # before it, come out as the pool wrote them
    B, W = generate.GZIP_BLOCK, generate.GZIP_WINDOW
    assert len(plain) > 2 * B
    starts = range(0, len(plain), B)
    body = b"".join(generate.deflate_block(
        plain[lo:lo + B], plain[max(lo - W, 0):lo], 6, lo + B >= len(plain))
        for lo in starts)
    assert raw[0][22:-8] == body
    assert zlib.decompressobj(-zlib.MAX_WBITS).decompress(
        generate.deflate_block(plain[:B], b"", 6, True)) == plain[:B]


def test_the_assembly_bank_draws_nothing(tmp_path):
    spec = two_bank_spec()
    cfg = spec["config"]
    plain = dict(cfg)
    del plain["assembly_bank"]
    (tmp_path / "one").mkdir()
    (tmp_path / "two").mkdir()
    one = generate.write_cell_inputs(7, plain, spec["traffic"],
                                     str(tmp_path / "one"))
    two = generate.write_cell_inputs(7, cfg, spec["traffic"],
                                     str(tmp_path / "two"))
    assert [os.path.basename(p) for p in two["files"]] == [
        "assembly.fasta", "reads.fastq"]
    # the reads of a seed are the same with the assembly written first
    assert open(one["files"][0], "rb").read() == \
        open(two["files"][1], "rb").read()
    assert np.array_equal(two["banks"][1], one["banks"][0])
    # the assembly is the genome the reads were drawn from, one record
    genome = two["banks"][0]
    assert genome.shape == (1, cfg["genome_length"])
    rng = np.random.default_rng(7)
    assert np.array_equal(genome[0], generate.make_genome(rng, cfg))
    with open(two["files"][0], "rb") as f:
        lines = f.read().split(b"\n")
    assert lines[0] == b">assembly" and lines[-1] == b""
    assert {len(ln) for ln in lines[1:-2]} == {80}
    assert 0 < len(lines[-2]) <= 80
    seqs = reference.read_sequences(two["files"][0])
    assert np.array_equal(reference.encode(seqs), genome)


@pytest.mark.parametrize("n", [1, 79, 80, 81, 160])
def test_fasta_record_wraps_at_the_line_width(n):
    codes = np.arange(n, dtype=np.uint8) % 4
    rec = generate.fasta_record(codes, "g", 80)
    lines = rec.split(b"\n")
    assert lines[0] == b">g" and lines[-1] == b""
    assert b"".join(lines[1:]) == generate.LETTERS[codes].tobytes()
    assert all(0 < len(ln) <= 80 for ln in lines[1:-1])
