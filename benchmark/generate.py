"""Read generator and FASTQ writer of the benchmark (a frozen copy: the
program under test never supplies its inputs).

The pattern is bench.py's `make_error_batches`: reads sampled from a
random genome, with substitutions.  Everything is drawn from one
`numpy.random.Generator` seeded by `--seed`, in a fixed order and in
fixed chunks, so one seed gives the same genome, reads and file bytes on
any machine.

Codes are A=0, C=1, T=2, G=3 (DSK's A<C<T<G order); a base's complement
is `code ^ 2`.  A configuration file gives:

  genome_length       bases of the genome (uniform random)
  repeat              optional {"element_length", "share", "divergence_max"}:
                      copies of one random element, `share` of the genome,
                      one in each of equal slots, each copy in a random
                      orientation and with substitutions at its own rate
                      drawn uniformly from [0, divergence_max)
  read_count          reads
  read_length         bases a read (every read has this length)
  substitution_rate   each base of a read is replaced by one of the other
                      three with this probability (uniform)
  quality             the one Phred character of every quality line
  assembly_bank       optional, true: the genome is written as one FASTA
                      record, 80 bases a line, and given as bank 0 before
                      the reads (DSK's -histo2D input)

Reads start uniformly over the genome and come from either strand with
probability 1/2.  A traffic mix with `gzip_level` has the reads written as
one gzip member at that level (mtime 0, a fixed name) the way pigz writes
one: 128-KiB blocks deflated apart on all cores, each primed with the 32
KiB before it and ended by a sync flush, so one seed gives the same
compressed bytes on one zlib, whatever the number of cores.  Writing the
genome or compressing draws nothing, so a seed's reads are the same in
every form.
"""

from __future__ import annotations

import contextlib
import os
import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

LETTERS = np.frombuffer(b"ACTG", dtype=np.uint8)
FASTA_LINE = 80  # bases a line of the assembly's FASTA record
CHUNK_READS = 1 << 18  # reads drawn and written together


def make_genome(rng: np.random.Generator, cfg: dict) -> np.ndarray:
    """The genome's codes, (genome_length,) uint8."""
    n = int(cfg["genome_length"])
    genome = rng.integers(0, 4, size=n, dtype=np.uint8)
    rep = cfg.get("repeat")
    if rep:
        el = int(rep["element_length"])
        copies = int(round(float(rep["share"]) * n / el))
        element = rng.integers(0, 4, size=el, dtype=np.uint8)
        slot = n // copies
        starts = (np.arange(copies, dtype=np.int64) * slot
                  + rng.integers(0, slot - el + 1, size=copies))
        div = rng.uniform(0.0, float(rep["divergence_max"]), size=copies)
        body = np.broadcast_to(element, (copies, el)).copy()
        hit = rng.random((copies, el)) < div[:, None]
        shift = rng.integers(1, 4, size=(copies, el), dtype=np.uint8)
        body = np.where(hit, (body + shift) % 4, body).astype(np.uint8)
        rev = rng.integers(0, 2, size=copies).astype(bool)
        body[rev] = body[rev, ::-1] ^ 2
        genome[starts[:, None] + np.arange(el)] = body
    return genome


def substitute(rng: np.random.Generator, codes: np.ndarray,
               rate: float) -> int:
    """Replace each code of `codes` (flat view, in place) by one of the
    other three with probability `rate`; return the substitutions made.
    Positions come from geometric gaps, which is a Bernoulli draw a base."""
    flat = codes.reshape(-1)
    if rate <= 0:
        return 0
    pos_parts = []
    last = -1
    while True:
        want = int((flat.size - last) * rate * 1.1) + 64
        pos = last + np.cumsum(rng.geometric(rate, size=want))
        if pos[-1] >= flat.size:
            pos_parts.append(pos[pos < flat.size])
            break
        pos_parts.append(pos)
        last = int(pos[-1])
    pos = np.concatenate(pos_parts)
    shift = rng.integers(1, 4, size=pos.size, dtype=np.uint8)
    flat[pos] = (flat[pos] + shift) % 4
    return int(pos.size)


def make_reads(rng: np.random.Generator, genome: np.ndarray, cfg: dict):
    """Yield (codes (n, read_length) uint8, strands (n,) bool, subs) for
    successive chunks of CHUNK_READS reads."""
    count, rl = int(cfg["read_count"]), int(cfg["read_length"])
    rate = float(cfg["substitution_rate"])
    span = np.arange(rl, dtype=np.int64)
    for lo in range(0, count, CHUNK_READS):
        n = min(CHUNK_READS, count - lo)
        start = rng.integers(0, genome.size - rl + 1, size=n)
        rev = rng.integers(0, 2, size=n).astype(bool)
        reads = genome[start[:, None] + span]
        reads[rev] = reads[rev, ::-1] ^ 2
        subs = substitute(rng, reads, rate)
        yield reads, rev, subs


def fastq_records(codes: np.ndarray, first_id: int, id_width: int,
                  quality: str) -> np.ndarray:
    """(n, record bytes) uint8: '@r<id>\\n<bases>\\n+\\n<quality>\\n', the id
    zero-padded to id_width digits, so every record has one length."""
    n, rl = codes.shape
    head = 2 + id_width + 1
    rec = np.empty((n, head + rl + 3 + rl + 1), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1] = ord("r")
    ids = np.arange(first_id, first_id + n, dtype=np.int64)
    pow10 = 10 ** np.arange(id_width - 1, -1, -1, dtype=np.int64)
    rec[:, 2:2 + id_width] = (ids[:, None] // pow10) % 10 + ord("0")
    rec[:, head - 1] = ord("\n")
    rec[:, head:head + rl] = LETTERS[codes]
    rec[:, head + rl:head + rl + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, head + rl + 3:head + 2 * rl + 3] = ord(quality)
    rec[:, -1] = ord("\n")
    return rec


GZIP_BLOCK = 128 << 10  # pigz's block
GZIP_WINDOW = 32 << 10  # deflate's window: the dictionary of a block


def deflate_block(block: bytes, prior: bytes, level: int,
                  last: bool) -> bytes:
    """Raw deflate of one block, primed with the input before it; a sync
    flush ends it, so the next block's output follows on a byte, and the
    last block finishes the stream."""
    kw = {"zdict": prior} if prior else {}
    c = zlib.compressobj(level, zlib.DEFLATED, -zlib.MAX_WBITS, **kw)
    return c.compress(block) + c.flush(
        zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


class GzipBlocks:
    """A writer of one gzip member (mtime 0, the name `name`) whose
    blocks of GZIP_BLOCK input bytes are deflated on `pool` and written
    in order."""

    def __init__(self, raw, name: str, level: int, pool):
        self.raw, self.level, self.pool = raw, level, pool
        self.rest, self.prior = b"", b""
        self.crc = self.size = 0
        self.pending: deque = deque()
        raw.write(b"\x1f\x8b\x08\x08" + bytes(4) + b"\x00\xff"
                  + name.encode() + b"\x00")

    def _submit(self, block: bytes, last: bool) -> None:
        self.pending.append(self.pool.submit(
            deflate_block, block, self.prior, self.level, last))
        self.prior = (self.prior + block)[-GZIP_WINDOW:]

    def _drain(self, wait: bool) -> None:
        while self.pending and (wait or self.pending[0].done()):
            self.raw.write(self.pending.popleft().result())

    def write(self, data: bytes) -> None:
        self.crc = zlib.crc32(data, self.crc)
        self.size += len(data)
        data = self.rest + data
        # a block's bounds are multiples of GZIP_BLOCK of the whole
        # input; at least one byte stays back for the last block
        n = (len(data) - 1) // GZIP_BLOCK * GZIP_BLOCK
        for lo in range(0, n, GZIP_BLOCK):
            self._submit(data[lo:lo + GZIP_BLOCK], False)
        self.rest = data[n:]
        self._drain(False)

    def close(self) -> None:
        self._submit(self.rest, True)
        self._drain(True)
        self.raw.write(struct.pack("<II", self.crc & 0xFFFFFFFF,
                                   self.size & 0xFFFFFFFF))


def fasta_record(codes: np.ndarray, name: str,
                 line_width: int = FASTA_LINE) -> bytes:
    """'>name\n' and the bases of `codes`, line_width a line."""
    text = LETTERS[codes]
    n_full = text.size // line_width
    body = np.empty((n_full, line_width + 1), np.uint8)
    body[:, :line_width] = text[:n_full * line_width].reshape(
        n_full, line_width)
    body[:, -1] = ord("\n")
    tail = text[n_full * line_width:].tobytes()
    return (b">" + name.encode() + b"\n" + body.tobytes()
            + (tail + b"\n" if tail else b""))


@contextlib.contextmanager
def _synced(path: str):
    # on disk before the window: its writeback is set-up's, not a job's
    with open(path, "wb") as f:
        yield f
        f.flush()
        os.fsync(f.fileno())


def write_inputs(seed: int, cfg: dict, path: str,
                 gzip_level: int | None = None,
                 assembly: str | None = None) -> dict:
    """Draw the genome and reads of `cfg` from `seed`, write the reads to
    `path` as FASTQ (one gzip member at `gzip_level` if it is given) and,
    if `assembly` is given, the genome to that path as one FASTA record.
    Returns the reads' codes (n, read_length) uint8, the genome's codes,
    and counts of what was drawn and written."""
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, cfg)
    if assembly is not None:
        with _synced(assembly) as f:
            f.write(fasta_record(genome, "assembly"))
    count = int(cfg["read_count"])
    id_width = len(str(max(count - 1, 0)))
    parts, n_rev, n_sub, plain = [], 0, 0, 0
    with contextlib.ExitStack() as stack:
        out = raw = stack.enter_context(_synced(path))
        if gzip_level is not None:
            pool = stack.enter_context(
                ThreadPoolExecutor(os.cpu_count() or 1))
            out = GzipBlocks(raw, os.path.basename(path).removesuffix(".gz"),
                             int(gzip_level), pool)
        done = 0
        for reads, rev, subs in make_reads(rng, genome, cfg):
            rec = fastq_records(reads, done, id_width,
                                cfg.get("quality", "I"))
            out.write(rec.tobytes())
            plain += rec.size
            parts.append(reads)
            n_rev += int(rev.sum())
            n_sub += subs
            done += reads.shape[0]
        if out is not raw:
            out.close()
    codes = np.concatenate(parts) if parts else np.empty((0, 0), np.uint8)
    return {"codes": codes, "genome": genome, "n_reads": count,
            "n_bases": int(codes.size), "n_reverse": n_rev,
            "n_substitutions": n_sub, "fastq_bytes": plain}


def write_cell_inputs(seed: int, cfg: dict, traffic: dict,
                      work: str) -> dict:
    """A cell's input files under `work`, drawn from `seed`: the reads as
    reads.fastq, or reads.fastq.gz where the traffic gives `gzip_level`;
    with the configuration's `assembly_bank`, the genome as
    assembly.fasta, bank 0.  Returns write_inputs' counts with `files`,
    the -file list in bank order, and `banks`, each bank's codes."""
    level = traffic.get("gzip_level")
    reads = os.path.join(
        work, "reads.fastq" if level is None else "reads.fastq.gz")
    asm = (os.path.join(work, "assembly.fasta")
           if cfg.get("assembly_bank") else None)
    out = write_inputs(seed, cfg, reads, gzip_level=level, assembly=asm)
    genome = out.pop("genome")
    out["files"] = [reads] if asm is None else [asm, reads]
    out["banks"] = ([out["codes"]] if asm is None
                    else [genome[None, :], out["codes"]])
    return out
