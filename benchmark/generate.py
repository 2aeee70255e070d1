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

Reads start uniformly over the genome and come from either strand with
probability 1/2.
"""

from __future__ import annotations

import os

import numpy as np

LETTERS = np.frombuffer(b"ACTG", dtype=np.uint8)
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


def write_inputs(seed: int, cfg: dict, path: str) -> dict:
    """Draw the genome and reads of `cfg` from `seed`, write the reads to
    `path` as FASTQ, and return the reads' codes (n, read_length) uint8
    with counts of what was drawn."""
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, cfg)
    count = int(cfg["read_count"])
    id_width = len(str(max(count - 1, 0)))
    parts, n_rev, n_sub = [], 0, 0
    with open(path, "wb") as f:
        done = 0
        for reads, rev, subs in make_reads(rng, genome, cfg):
            f.write(fastq_records(reads, done, id_width,
                                  cfg.get("quality", "I")).tobytes())
            parts.append(reads)
            n_rev += int(rev.sum())
            n_sub += subs
            done += reads.shape[0]
        # on disk before the window: its writeback is set-up's, not a job's
        f.flush()
        os.fsync(f.fileno())
    codes = np.concatenate(parts) if parts else np.empty((0, 0), np.uint8)
    return {"codes": codes, "n_reads": count,
            "n_bases": int(codes.size), "n_reverse": n_rev,
            "n_substitutions": n_sub}
