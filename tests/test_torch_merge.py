"""The port's merge of a multi-pass count's tables (dist/engine.py
`merge_pass_tables`) against dsk_tpu's `merge_pass_results`.

The passes' k-mer sets are disjoint, as the passes' hash split makes
them.  For k <= 32 the port merges by one stable argsort of the words
packed into a uint64, for wider k-mers by the reference's lexsort; both
must give the reference's result byte for byte: the k-mers, the counts,
the per-bank counts, the summed histogram and the info (n_passes, no
partition_sizes, the resume flags OR-ed over the passes).  The cases
cover each word count (k = 15 one word; 21, 27 and 32 two, k = 32 with
the top bit of the key set; 33 and 63 the fallback), 1 to 5 passes, one
bank and two, and passes that are sorted, empty, or sorted only within
each partition (a spilled pass's rows, partition after partition).  The
run's counters say which way each merge went and how many rows it took.
"""

import numpy as np
import pytest

from dsk_tpu.engine.counter import CountResult as RefResult
from dsk_tpu.engine.counter import merge_pass_results as ref_merge
from dsk_tpu_torch.dist.engine import merge_pass_tables
from dsk_tpu_torch.engine.counter import CountResult
from dsk_tpu_torch.kmer import codec
from dsk_tpu_torch.utils import spans

N_ROWS = 3000
N_BINS = 11
N_PARTITIONS = 4


def _distinct_kmers(rng, k: int, n: int) -> np.ndarray:
    """n distinct k-mers as (n, W) uint32 rows, word 0 the highest, in
    lexicographic order; at k = 32 the top bit is set in about half."""
    W = codec.words_per_kmer(k)
    top_bits = 2 * k - 32 * (W - 1)
    rows = rng.integers(0, 2**32, size=(2 * n, W), dtype=np.uint32)
    rows[:, 0] &= np.uint32((1 << top_bits) - 1)
    rows = np.unique(rows, axis=0)
    return rows[np.sort(rng.permutation(rows.shape[0])[:n])]


def _passes(rng, k: int, n_passes: int, nb_banks: int, layout: str):
    """Each pass's (kmers, counts, bank_counts or None, histogram, info)."""
    kmers = _distinct_kmers(rng, k, N_ROWS)
    owner = rng.integers(0, n_passes, size=kmers.shape[0])
    if layout == "empty_pass":
        owner[owner == n_passes - 1] = 0 if n_passes > 1 else -1
    out = []
    for p in range(n_passes):
        km = kmers[owner == p]
        if layout == "partition_major":
            part = rng.integers(0, N_PARTITIONS, size=km.shape[0])
            km = np.concatenate([km[part == q] for q in range(N_PARTITIONS)])
        n = km.shape[0]
        bank = None
        if nb_banks > 1:
            bank = rng.integers(0, 50, size=(n, nb_banks)).astype(np.int64)
            counts = bank.sum(axis=1).astype(np.int32)
        else:
            counts = rng.integers(1, 1000, size=n).astype(np.int32)
        hist = rng.integers(0, 100, size=N_BINS + 1).astype(np.int64)
        info = {"n_bases": 1000 * (p + 1), "t_stream": 0.5 * p,
                "partition_sizes": [n], "spill_resumed": p == n_passes - 1,
                "fill_resumed": False}
        out.append((km, counts, bank, hist, info))
    return out


def _results(cls, k, passes):
    return [cls(k=k, kmers=km.copy(), counts=c.copy(), histogram=h.copy(),
                bank_counts=None if b is None else b.copy(), info=dict(i))
            for km, c, b, h, i in passes]


def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("layout", ["sorted", "partition_major",
                                    "empty_pass"])
@pytest.mark.parametrize("nb_banks", [1, 2])
@pytest.mark.parametrize("n_passes", [1, 2, 3, 5])
@pytest.mark.parametrize("k", [15, 21, 27, 32, 33, 63])
def test_merge_equals_the_reference(k, n_passes, nb_banks, layout):
    rng = np.random.default_rng([k, n_passes, nb_banks, len(layout)])
    passes = _passes(rng, k, n_passes, nb_banks, layout)
    ref = ref_merge(_results(RefResult, k, passes))
    with spans.run("t", publish=False) as run:
        got = merge_pass_tables(_results(CountResult, k, passes))
    counters = run.summary()["counters"]

    n = sum(p[0].shape[0] for p in passes)
    if layout == "empty_pass" and n_passes > 1:
        assert passes[-1][0].shape[0] == 0
    if k == 32 and n:
        assert (ref.kmers[:, 0] >= 2**31).any()
    assert got.k == ref.k == k
    assert ref.n_distinct == n
    assert _same_bytes(got.kmers, ref.kmers)
    assert _same_bytes(got.counts, ref.counts)
    assert _same_bytes(got.histogram, ref.histogram)
    if nb_banks > 1:
        assert _same_bytes(got.bank_counts, ref.bank_counts)
    else:
        assert got.bank_counts is None and ref.bank_counts is None
    assert got.info == ref.info
    assert got.info["n_passes"] == n_passes
    assert "partition_sizes" not in got.info
    assert got.info["spill_resumed"] is True
    assert got.info["fill_resumed"] is False

    packed = codec.words_per_kmer(k) <= 2
    assert counters.get("count.merge_packed") == (1 if packed else None)
    assert counters.get("count.merge_lexsort") == (None if packed else 1)
    assert counters["count.merge_rows"] == n
