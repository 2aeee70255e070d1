"""The plain reference count and the comparison that decides `correct`.

Plain PyTorch and numpy, independent of the program under test: its own
reader of FASTA/FASTQ files, its own 2-bit codec (A=0 < C=1 < T=2 < G=3,
a complement is `code ^ 2`), canonical k-mers as min(forward, reverse
complement) of the 2k-bit values, and a unique-with-counts over every
valid window.  A window is valid when its k bases are all A, C, G or T
(either case); any other byte splits a read, as in DSK.  k is at most
31, so a k-mer's value fits an int64.

Over several banks (DSK's -histo2D input: the assembly as bank 0, then
the reads) each k-mer has a count in every bank.  The .histo, the
histogram and the solid k-mers (-solidity-kind sum, the only rule judged)
read the count summed over all banks, the assembly's too; the .histo2D
matrix has the reads' summed count in its rows (1..histo_max + 1, the last
holding every count above histo_max) and the assembly's count, capped at
10, in its 11 columns.

The control (`fingerprint_fold`) is this reference with its keys held in
32 bits: each canonical k-mer is replaced by a 32-bit multiplicative hash,
k-mers that share one merge, and the smallest of them carries the summed
count (in every bank).  It is the precision step below the exact 2k-bit
key that would tempt a change to the table, and it has to fail the
comparison.
"""

from __future__ import annotations

import gzip

import numpy as np
import torch

INVALID = 255
_LUT = np.full(256, INVALID, dtype=np.uint8)
for _i, _ch in enumerate(b"ACTG"):
    _LUT[_ch] = _i
    _LUT[ord(chr(_ch).lower())] = _i

# 2^64 / golden ratio, as a signed int64 (the multiplication wraps)
_FIB = 0x9E3779B97F4A7C15 - (1 << 64)


def read_sequences(path: str) -> list[bytes]:
    """The sequences of a FASTA (multi-line) or FASTQ file, plain or gzip."""
    with open(path, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
    with (gzip.open(path, "rb") if gz else open(path, "rb")) as f:
        lines = [ln.rstrip(b"\r") for ln in f.read().split(b"\n")]
    if lines[0].startswith(b"@"):
        body = [ln for ln in lines if ln]
        return [body[i + 1] for i in range(0, len(body) - 3, 4)]
    seqs: list[bytes] = []
    cur: list[bytes] | None = None
    for ln in lines:
        if ln.startswith(b">"):
            if cur is not None:
                seqs.append(b"".join(cur))
            cur = []
        elif ln and cur is not None:
            cur.append(ln)
    if cur is not None:
        seqs.append(b"".join(cur))
    return seqs


def encode(seqs: list[bytes]) -> np.ndarray:
    """(n, longest) uint8 codes, padded with INVALID."""
    width = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), width), INVALID, np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = _LUT[np.frombuffer(s, np.uint8)]
    return out


def canonical_values(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The canonical 2k-bit values (int64) of the valid windows of
    (n, L) uint8 codes, row by row."""
    if not 1 <= k <= 31:
        raise ValueError(f"the reference takes k in 1..31, not {k}")
    n, width = codes.shape
    nw = width - k + 1
    if nw <= 0 or n == 0:
        return torch.empty(0, dtype=torch.int64, device=codes.device)
    c = codes.to(torch.int64)
    bad = torch.zeros((n, width + 1), dtype=torch.int32, device=codes.device)
    bad[:, 1:] = torch.cumsum((codes > 3).to(torch.int32), dim=1)
    valid = (bad[:, k:] - bad[:, :nw]) == 0
    c = c & 3
    fwd = torch.zeros((n, nw), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        col = c[:, j:j + nw]
        fwd = (fwd << 2) | col
        rev = rev | ((col ^ 2) << (2 * j))
    return torch.minimum(fwd, rev)[valid]


def count(codes: np.ndarray, k: int, device="cpu",
          block_rows: int = 1 << 19) -> tuple[np.ndarray, np.ndarray]:
    """(values int64, counts int64) of every distinct canonical k-mer of
    the reads' codes, values ascending; the windows are built block by
    block of rows on `device`."""
    parts = []
    for lo in range(0, codes.shape[0], block_rows):
        block = torch.from_numpy(np.ascontiguousarray(
            codes[lo:lo + block_rows])).to(device)
        parts.append(canonical_values(block, k))
    vals = torch.cat(parts) if parts else torch.empty(0, dtype=torch.int64)
    del parts
    uniq, cnt = torch.unique(vals, sorted=True, return_counts=True)
    return uniq.cpu().numpy(), cnt.cpu().numpy().astype(np.int64)


def count_banks(banks: list[np.ndarray], k: int, device="cpu"
                ) -> tuple[np.ndarray, np.ndarray]:
    """(values int64, counts) over several banks' codes: the distinct
    canonical k-mers of all of them, ascending, with an (n, banks) int64
    count in each bank."""
    per = [count(codes, k, device) for codes in banks]
    values = np.unique(np.concatenate([v for v, _ in per]))
    counts = np.zeros((values.size, len(banks)), np.int64)
    for b, (v, c) in enumerate(per):
        counts[np.searchsorted(values, v), b] = c
    return values, counts


def fingerprint_fold(values: np.ndarray, counts: np.ndarray, device="cpu"
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The control: k-mers keyed by a 32-bit hash of their value; k-mers
    sharing a key merge into the smallest of them with the summed count
    (of each bank, where counts is (n, banks)).  Returns (values, counts)
    ascending by value."""
    v = torch.from_numpy(values).to(device)
    c = torch.from_numpy(counts).to(device)
    key = ((v * _FIB) >> 32) & 0xFFFFFFFF
    keys, inv = torch.unique(key, return_inverse=True)
    rep = torch.full((keys.numel(),), torch.iinfo(torch.int64).max,
                     dtype=torch.int64, device=device)
    rep = rep.scatter_reduce(0, inv, v, reduce="amin")
    tot = torch.zeros((keys.numel(), *c.shape[1:]), dtype=torch.int64,
                      device=device)
    tot = tot.index_add(0, inv, c)
    order = torch.argsort(rep)
    return rep[order].cpu().numpy(), tot[order].cpu().numpy()


def histogram(counts: np.ndarray, histo_max: int) -> np.ndarray:
    """Distinct k-mers by abundance, index 1..histo_max (the last bin
    holds every abundance at or above it); index 0 is 0."""
    h = np.bincount(np.clip(counts, 1, histo_max), minlength=histo_max + 1)
    h = h.astype(np.int64)
    h[0] = 0
    return h


def histo_text(hist: np.ndarray) -> bytes:
    """DSK's .histo file: '<abundance>\\t<k-mers>' for abundance 1..max."""
    return "".join(f"{a}\t{int(hist[a])}\n"
                   for a in range(1, hist.shape[0])).encode()


def histo2d(counts: np.ndarray, histo_max: int) -> np.ndarray:
    """The -histo2D matrix of (n, banks) counts, bank 0 the assembly:
    (histo_max + 2, 11), [r, a] the k-mers whose reads' summed count is r
    (every count above histo_max in row histo_max + 1) and whose
    assembly count is a (every count above 10 in column 10)."""
    reads = np.minimum(counts[:, 1:].sum(axis=1), histo_max + 1)
    asm = np.minimum(counts[:, 0], 10)
    cells = np.bincount(reads * 11 + asm, minlength=(histo_max + 2) * 11)
    return cells.astype(np.int64).reshape(histo_max + 2, 11)


def histo2d_text(matrix: np.ndarray) -> bytes:
    """DSK's .histo2D file: '<r> <11 counts>' for r = 1..histo_max + 1."""
    return "".join(f"{r} " + " ".join(str(int(x)) for x in matrix[r]) + "\n"
                   for r in range(1, matrix.shape[0])).encode()


def words_to_values(kmers: np.ndarray) -> np.ndarray:
    """The program's (n, W) uint32 k-mer words, word 0 most significant
    and the value right-aligned, as int64 values."""
    kmers = np.asarray(kmers)
    out = np.zeros(kmers.shape[0], np.int64)
    for w in range(kmers.shape[1]):
        out = (out << 32) | kmers[:, w].astype(np.int64)
    return out


def rows_off(va: np.ndarray, ca: np.ndarray, vb: np.ndarray,
             cb: np.ndarray) -> int:
    """How many (k-mer, count) rows lie on one side only: 0 when both
    tables hold the same k-mers with the same counts.  A count is a
    number, or a row of a count a bank: a row matches only where every
    bank's count does."""
    va, vb = np.asarray(va, np.int64), np.asarray(vb, np.int64)
    ca = np.asarray(ca, np.int64).reshape(va.size, -1) if va.size else \
        np.zeros((0, 1), np.int64)
    cb = np.asarray(cb, np.int64).reshape(vb.size, -1) if vb.size else \
        np.zeros((0, 1), np.int64)
    if va.shape == vb.shape and ca.shape == cb.shape \
            and np.array_equal(va, vb) and np.array_equal(ca, cb):
        return 0
    _, ia, ib = np.intersect1d(va, vb, return_indices=True)
    same = (int((ca[ia] == cb[ib]).all(axis=1).sum())
            if ca.shape[1] == cb.shape[1] else 0)
    return int(va.size + vb.size - 2 * same)


# every comparison is exact: a limit of 0 rows, jobs or failures
LIMITS = {"jobs_failed": 0, "jobs_off": 0, "table_rows_off": 0,
          "solid_rows_off": 0}


def answer(values: np.ndarray, counts: np.ndarray, histo_max: int,
           abundance_min: int, abundance_max: int) -> dict:
    """What a count of (values, counts) has to report: the table, its
    solid k-mers, the histogram and the .histo file's bytes; where counts
    is (n, banks), the .histo2D matrix and bytes too, and the rest by the
    count summed over the banks."""
    total = counts.sum(axis=1) if counts.ndim == 2 else counts
    hist = histogram(total, histo_max)
    solid = (total >= abundance_min) & (total <= abundance_max)
    out = {"values": values, "counts": counts, "histogram": hist,
           "histo": histo_text(hist), "solid_values": values[solid],
           "solid_counts": total[solid]}
    if counts.ndim == 2:
        out["histo2d"] = histo2d_text(histo2d(counts, histo_max))
    return out


def reference_answer(banks: list[np.ndarray], k: int, histo_max: int,
                     abundance_min: int, abundance_max: int,
                     device="cpu") -> dict:
    """The answer for the banks' codes: one bank's counts as numbers,
    several banks' as rows of a count a bank."""
    if len(banks) == 1:
        values, counts = count(banks[0], k, device)
    else:
        values, counts = count_banks(banks, k, device)
    return answer(values, counts, histo_max, abundance_min, abundance_max)


def program_table(result, abundance_min: int, abundance_max: int):
    """(values, counts, solid values, solid counts) of the program's
    CountResult: its table (a count a bank where it counted per bank),
    and its solid k-mers as its own filter returns them."""
    solid_kmers, solid_counts = result.solid(abundance_min, abundance_max)
    counts = (result.counts if result.bank_counts is None
              else result.bank_counts)
    return (words_to_values(result.kmers), counts,
            words_to_values(solid_kmers), solid_counts)


def judge(ref: dict, jobs: list[dict], tables: list, failed: int) -> dict:
    """The numbers compared, each with its limit.  jobs: every finished
    job's 'histo' bytes, 'histogram', 'n_solid' and 'n_distinct', and its
    'histo2d' bytes where the reference has a .histo2D; tables: (values,
    counts, solid values, solid counts) of the judged jobs."""
    jobs_off = sum(
        j["histo"] != ref["histo"]
        or not np.array_equal(j["histogram"], ref["histogram"])
        or j["n_solid"] != ref["solid_values"].size
        or j["n_distinct"] != ref["values"].size
        or ("histo2d" in ref and j.get("histo2d") != ref["histo2d"])
        for j in jobs)
    rows = solid_rows = 0
    for v, c, sv, sc in tables:
        rows = max(rows, rows_off(v, c, ref["values"], ref["counts"]))
        solid_rows = max(solid_rows, rows_off(
            sv, sc, ref["solid_values"], ref["solid_counts"]))
    got = {"jobs_failed": failed, "jobs_off": int(jobs_off),
           "table_rows_off": rows, "solid_rows_off": solid_rows}
    return {name: {"value": got[name], "limit": LIMITS[name]}
            for name in LIMITS}
