"""Spill mode across ranks in the port, on the CPU, tolerance 0.

Each rank fills its own host-suffixed partition files in one shared
directory (dist/spill.py SpillStore), the ranks agree once a fill group
and once at the fill's end, and rank r counts the partitions pid % n ==
r from every rank's files, one a round, handing each to rank 0's sink
through gather_to_root.

- Real processes: 2 and 4 gloo ranks (tests/torch_multigpu_worker.py)
  against dsk_tpu's n-chip spill engine on the conftest's CPU mesh: each
  rank's table against dsk_tpu's k-mers of its partitions (hash % P % n
  == r), the histograms, and merge_host_results against the one-device
  port in spill and in table mode.
- Simulated ranks (tests/torch_loopback.py, threads): forced splits with
  rank-strided split ids and one partition a rank in each gather, per
  bank with a sink and in collect mode, a rank with no input, two passes,
  count_stream_spilled, one rank's fill outlasting the collectives'
  timeout, spill directories that are not shared, execute's spill
  directory, a SpillDiskOverflow on one rank raised on every rank, a
  failure in one rank's count phase (the merge, or the reader thread)
  raised on every rank, and fill-only resume across ranks.
"""

import os
import pathlib
import re

import numpy as np
import pytest
import torch

from dsk_tpu_torch.dist import engine as port_engine
from dsk_tpu_torch.dist.engine import DistCountEngine
from dsk_tpu_torch.dist.multihost import (
    PeerFailed,
    merge_host_results,
    shard_bank,
)
from dsk_tpu_torch.dist.spill import (
    SpillCheckpoint,
    SpillDiskOverflow,
    SpillStore,
    kmer_hash_planes_np,
)
from dsk_tpu_torch.engine import processors
from dsk_tpu_torch.io.bank import open_bank
from tests.test_torch_multigpu_gloo import (  # noqa: F401 (fixture)
    GEOM,
    assert_all_ok,
    plain_k27,
    rank_results,
    spawn,
)
from tests.torch_loopback import Loopback

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).resolve().parent / "data"
K = 27
K27 = str(DATA / "read50x_ref10K_e001.fasta.gz")
C14 = ",".join(str(DATA / f"c{i}.fasta.gz") for i in range(1, 5))
P = 8
SPILL = dict(GEOM, spill_partitions=P, spill_chunk_rows=1 << 14)
# 4 partitions of ~23.5K distinct k-mers over a 4,096-slot table: splits
SPLIT = dict(GEOM, table_cap=1 << 12, spill_partitions=4,
             spill_chunk_rows=1 << 12)
CPU = torch.device("cpu")


def owners(kmers: np.ndarray, n: int, parts: int = P) -> np.ndarray:
    """The rank that counts each k-mer: its partition hash % P % n (split
    children keep their parent's owner)."""
    words = [np.ascontiguousarray(kmers[:, w]) for w in range(kmers.shape[1])]
    return kmer_hash_planes_np(words) % np.uint32(parts) % np.uint32(n)


def sort_table(kmers, counts, bank_counts=None):
    order = np.lexsort(kmers.T[::-1])
    return (kmers[order], counts[order],
            None if bank_counts is None else bank_counts[order])


def assert_tables_equal(got, want):
    for a, b in zip(sort_table(*got), sort_table(*want)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def one_device():
    """The one-device port's spill and table counts of the k27 fixture."""
    spill = DistCountEngine(K, device="cpu", **SPILL).count(K27)
    table = DistCountEngine(K, device="cpu", **dict(GEOM, table_cap=1 << 17)
                            ).count(K27)
    return spill, table


def ref_spill(uri: str, n: int, **kw):
    """dsk_tpu's n-chip spill engine (tests/test_spill.py's) on the
    conftest's CPU mesh."""
    from tests.test_spill import _spill_engine

    return _spill_engine(n, spill_partitions=P, **kw).count(uri)


# -- real processes over gloo ------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_spill_ranks_equal_the_n_chip_engine(tmp_path, plain_k27, one_device,
                                             n):
    done = spawn(tmp_path, n, file=plain_k27, k=K, engine=SPILL)
    assert_all_ok(done)
    res = rank_results(tmp_path, n)
    ref = ref_spill(plain_k27, n)
    own = owners(ref.kmers, n)
    for r in range(n):
        assert_tables_equal((res[r].kmers, res[r].counts),
                            (ref.kmers[own == r], ref.counts[own == r]))
        np.testing.assert_array_equal(res[r].histogram, ref.histogram)
        info = res[r].info
        assert info["spill"] and info["n_chips"] == info["n_hosts"] == n
        assert info["partition_ids"] and all(
            p % n == r for p in info["partition_ids"])
        assert info["n_bases_local"] > 0
        assert info["n_bases"] == one_device[0].info["n_bases"]
    # the spill directory under cache_dir is gone
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith("dsk_tpu_torch_spill_")]
    merged = merge_host_results(res)
    for one in one_device:
        assert_tables_equal((merged.kmers, merged.counts),
                            (one.kmers, one.counts))
        np.testing.assert_array_equal(merged.histogram, one.histogram)


# -- simulated ranks ---------------------------------------------------------

def run_ranks(n, fn, timeout_s=120):
    """fn(ranks) on n simulated ranks; returns each rank's result."""
    return Loopback(n, CPU, timeout_s=timeout_s).run(fn)


def rank_engine(ranks, **geom):
    return DistCountEngine(K, device="cpu", ranks=ranks, **geom)


def share(uri, ranks):
    return shard_bank(open_bank(uri), ranks.rank, ranks.world_size)


class Sink:
    """A pass sink that keeps what it receives."""

    def __init__(self):
        self.parts = []

    def __call__(self, pass_id, pid, *arrays):
        self.parts.append((pass_id, pid) + tuple(np.copy(a) for a in arrays))


def counting_gathers(ranks, calls):
    """Wrap ranks.gather_to_root to record (rank, partitions handed in)."""
    gather = ranks.gather_to_root

    def wrapped(parts):
        parts = list(parts)
        calls.append((ranks.rank, len(parts), [p[0] for p in parts]))
        return gather(iter(parts))

    ranks.gather_to_root = wrapped


def test_splits_rank_strided_ids_and_one_partition_a_round(tmp_path,
                                                           one_device):
    n = 2
    sink = Sink()
    calls = []

    def rank(ranks):
        counting_gathers(ranks, calls)
        eng = rank_engine(ranks, spill_dir=str(tmp_path), **SPLIT)
        return eng.count(share(str(DATA / "c1.fasta.gz") + "," + str(
            DATA / "c2.fasta.gz"), ranks), pass_sink=sink if ranks.rank == 0
            else _never)

    res = run_ranks(n, rank)
    splits = [r.info["spill_splits"] for r in res]
    assert sum(splits) > 0
    ids = [r.info["partition_ids"] for r in res]
    for r in range(n):
        for pid in ids[r]:
            # pids < P belong to pid % n; split children are rank-strided
            assert (pid % n if pid < 4 else (pid - 4) % n) == r
    flat = [p for r in ids for p in r]
    assert len(flat) == len(set(flat))
    assert sorted(p for _, p, *_ in sink.parts) == sorted(flat)
    # every gather carried exactly one partition a rank, in rounds
    assert {c[1] for c in calls} == {1}
    rounds = [sum(1 for c in calls if c[0] == r) for r in range(n)]
    assert rounds[0] == rounds[1] >= max(len(x) for x in ids)
    kk = np.concatenate([p[2] for p in sink.parts])
    cc = np.concatenate([p[3] for p in sink.parts])
    one = DistCountEngine(K, device="cpu", **dict(GEOM, table_cap=1 << 17)
                          ).count(str(DATA / "c1.fasta.gz") + ","
                                  + str(DATA / "c2.fasta.gz"))
    assert_tables_equal((kk, cc), (one.kmers, one.counts))
    for r in res:
        np.testing.assert_array_equal(r.histogram, one.histogram)
        assert r.kmers.shape[0] == 0  # the sink took the table
        assert sorted(r.info["partition_sizes"]) == sorted(flat)
    assert not os.listdir(tmp_path)


def _never(*_args):
    raise AssertionError("a sink ran on a rank other than 0")


@pytest.mark.parametrize("mode", ["sink", "collect"])
def test_per_bank_equals_one_device(mode):
    n = 2
    sink = Sink()
    geom = dict(SPILL, per_bank=True, table_cap=1 << 13)

    def rank(ranks):
        eng = rank_engine(ranks, **geom)
        kw = {}
        if mode == "sink":
            kw["pass_sink_per_bank"] = sink if ranks.rank == 0 else _never
        return eng.count(share(C14, ranks), per_bank=True, **kw)

    res = run_ranks(n, rank)
    one = DistCountEngine(K, device="cpu", **geom).count(C14, per_bank=True)
    if mode == "sink":
        kk, tot, bmat = (np.concatenate([p[i] for p in sink.parts])
                         for i in (2, 3, 4))
    else:
        # each rank holds its own partitions, grouped per k-mer
        for r in range(n):
            assert (owners(res[r].kmers, n) == r).all()
        kk, tot, bmat = (np.concatenate(x) for x in zip(
            *((r.kmers, r.counts, r.bank_counts) for r in res)))
    assert_tables_equal((kk, tot, bmat),
                        (one.kmers, one.counts, one.bank_counts))
    for r in res:
        np.testing.assert_array_equal(r.histogram, one.histogram)
    np.testing.assert_array_equal(
        processors.histo2d_matrix(bmat, 10000),
        processors.histo2d_matrix(one.bank_counts, 10000))


def test_rank_without_input_counts_its_partitions(tmp_path, one_device):
    # one gzip member: rank 1 reads nothing, writes no bucket file, and
    # still counts its partitions from rank 0's files
    def rank(ranks):
        eng = rank_engine(ranks, spill_dir=str(tmp_path), **SPILL)
        return eng.count(share(K27, ranks))

    res = run_ranks(2, rank)
    assert res[1].info["n_bases_local"] == 0
    assert res[1].info["spill_rows"] == 0
    assert res[1].info["partition_ids"]
    assert res[0].info["n_bases"] == res[1].info["n_bases"] == 500000
    merged = merge_host_results(res)
    assert_tables_equal((merged.kmers, merged.counts),
                        (one_device[0].kmers, one_device[0].counts))
    assert not os.listdir(tmp_path)


def test_two_passes_equal_one_device(tmp_path, one_device):
    geom = dict(SPILL, n_passes=2)

    def rank(ranks):
        # one cache directory: it holds the shared spill directory, and
        # each rank's batch cache under its own name
        return rank_engine(ranks, **geom).count(
            share(K27, ranks),
            cache_dir=str(tmp_path))

    res = run_ranks(2, rank)
    assert all(r.info["n_passes"] == 2 for r in res)
    merged = merge_host_results(res)
    assert_tables_equal((merged.kmers, merged.counts),
                        (one_device[1].kmers, one_device[1].counts))
    np.testing.assert_array_equal(merged.histogram, one_device[1].histogram)


def test_count_stream_spilled_across_ranks(tmp_path):
    from dsk_tpu_torch.io.batch import batch_iterator

    batches = list(batch_iterator(open_bank(K27), K, GEOM["batch_rows"],
                                  GEOM["row_len"]))
    sink = Sink()

    def rank(ranks):
        eng = rank_engine(ranks, spill_dir=str(tmp_path), **SPILL)
        return eng.count_stream_spilled(
            iter(batches[ranks.rank::3]),
            pass_sink=sink if ranks.rank == 0 else _never)

    res = run_ranks(3, rank)
    one = DistCountEngine(K, device="cpu", **SPILL).count_stream_spilled(
        iter(batches))
    kk = np.concatenate([p[2] for p in sink.parts])
    cc = np.concatenate([p[3] for p in sink.parts])
    assert_tables_equal((kk, cc), (one.kmers, one.counts))
    assert all(r.info["n_distinct_device"] == one.kmers.shape[0]
               for r in res)
    assert not os.listdir(tmp_path)


def test_long_fill_on_one_rank_outlasts_the_timeout(tmp_path):
    """Rank 0 fills for over twice the ranks' 3 s timeout (0.35 s a
    batch over the fixture's batches but one) while rank 1 has one batch:
    the fill meets once a group, so no rank waits for another's whole
    fill, and the count equals one device's."""
    import time

    from dsk_tpu_torch.io.batch import batch_iterator

    batches = list(batch_iterator(open_bank(K27), K, GEOM["batch_rows"],
                                  GEOM["row_len"]))
    assert (len(batches) - 1) * 0.35 > 2 * 3

    def slow(bs):
        for b in bs:
            time.sleep(0.35)
            yield b

    def rank(ranks):
        eng = rank_engine(ranks, spill_dir=str(tmp_path), **SPILL)
        mine = slow(batches[1:]) if ranks.rank == 0 else iter(batches[:1])
        return eng.count_stream_spilled(mine)

    res = Loopback(2, CPU, timeout_s=3, run_timeout_s=120).run(rank)
    one = DistCountEngine(K, device="cpu", **SPILL).count_stream_spilled(
        iter(batches))
    merged = merge_host_results(res)
    assert_tables_equal((merged.kmers, merged.counts),
                        (one.kmers, one.counts))
    assert res[0].info["t_stream"] > 3
    assert not os.listdir(tmp_path)


def test_spill_directory_not_shared_raises_on_every_rank(tmp_path):
    """Each rank's spill directory is its own, as on hosts without a
    shared filesystem: no rank sees every rank's rows, so every rank
    raises instead of counting its own host's rows."""
    def rank(ranks):
        own = tmp_path / f"rank{ranks.rank}"
        eng = rank_engine(ranks, spill_dir=str(own), **SPILL)
        try:
            eng.count(share(C14, ranks))
        except Exception as e:
            return e, os.listdir(own)

    out = run_ranks(2, rank)
    for e, left in out:
        assert isinstance(e, RuntimeError), e
        assert "must be one shared directory" in str(e)
        assert left == []


def test_execute_spills_under_the_output_directory(tmp_path, monkeypatch):
    """Across ranks without -out-tmp, execute puts the partition files
    under the output's directory, which the ranks share, and not under
    each host's temp directory."""
    from dsk_tpu_torch.engine import run

    roots = []
    init = SpillStore.__init__

    def record(self, root, *args, **kw):
        roots.append(root)
        init(self, root, *args, **kw)

    monkeypatch.setattr(SpillStore, "__init__", record)
    out = tmp_path / "out"
    out.mkdir()
    common = dict(file=str(DATA / "readN.fasta"), kmer_size=21, spill="on",
                  spill_partitions=4, device="cpu", histo=True, verbose=0,
                  storage_type="none", nb_cores=1, checkpoint=False)
    outs = run_ranks(2, lambda ranks: run.execute(
        run.RunParams(out=str(out / "two"), **common), ranks))
    assert all(o.result.info["spill"] for o in outs)
    assert len(roots) == 2
    assert all(pathlib.Path(r).parent.parent == out for r in roots), roots
    assert sorted(os.listdir(out)) == ["two.histo"]


def test_disk_overflow_on_one_rank_raises_on_every_rank(tmp_path):
    # rank 0 reads the whole gzip input and overflows a 1 MB store; rank
    # 1 spills nothing, and raises the same valve at the fill agreement
    def rank(ranks):
        eng = rank_engine(ranks, **SPILL)
        try:
            eng.count(share(K27, ranks), cache_dir=str(tmp_path),
                      max_disk_mb=2)
        except Exception as e:
            return e

    errs = run_ranks(2, rank)
    assert all(isinstance(e, SpillDiskOverflow) for e in errs), errs
    assert "would exceed -max-disk" in str(errs[0])
    assert "another rank" in str(errs[1])
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith("dsk_tpu_torch_spill_")]


def pinned_plan(monkeypatch, **fields):
    """engine/run.py's plan with `fields` set over the planner's."""
    from dsk_tpu_torch.engine import run

    plan_resources = run.plan_resources

    def planned(*args, **kw):
        plan = plan_resources(*args, **kw)
        for name, value in fields.items():
            setattr(plan, name, value)
        return plan

    monkeypatch.setattr(run, "plan_resources", planned)


def test_execute_disk_overflow_retry_keeps_the_output(tmp_path, monkeypatch):
    """execute on 4 simulated ranks, -spill on, -max-disk 3 (a 2 MB spill
    budget for all ranks together), the plan pinned to one pass in
    one-batch groups: rank 0 (the whole gzip input) spills 2.7 MB, every
    rank raises SpillDiskOverflow and doubles the passes until the spill
    fits, and the output is the normal one."""
    pytest.importorskip("h5py")
    from dsk_tpu_torch.engine import run

    pinned_plan(monkeypatch, buf_batches=1, n_passes=1)
    common = dict(file=K27, kmer_size=K, abundance_min=1, histo=True,
                  device="cpu", verbose=0, nb_cores=1, batch_rows=256,
                  row_len=128, spill="on", max_disk=3,
                  out_tmp=str(tmp_path / "tmp"))
    outs = run_ranks(4, lambda ranks: run.execute(
        run.RunParams(out=str(tmp_path / "two"), **common), ranks))
    passes = {o.info["config"]["nb_passes"] for o in outs}
    assert len(passes) == 1 and passes.pop() > 1
    assert outs[0].result.info["spill"]
    assert ((tmp_path / "two.histo").read_bytes()
            == (DATA / "k27.histo").read_bytes())
    one = run.execute(run.RunParams(out=str(tmp_path / "one"),
                                    **dict(common, max_disk=0)))
    assert one.info["config"]["nb_passes"] == 1
    assert (sorted_dump(str(tmp_path / "two.h5"), tmp_path / "two.txt")
            == sorted_dump(one.h5_path, tmp_path / "one.txt"))
    assert os.listdir(tmp_path / "tmp") == []


def test_whole_budget_on_one_rank_runs_one_pass(tmp_path, monkeypatch):
    """-max-disk is one budget for all ranks: with the whole (gzip) input
    on rank 0 of 2, a -max-disk whose spill share (6 MB) the whole spill
    (3.9 MB) fits but half of it (each rank's share before) does not, the
    count runs in the plan's one pass, as dsk_tpu's, with no
    SpillDiskOverflow, and its output is the normal one."""
    pytest.importorskip("h5py")
    from dsk_tpu_torch.engine import run

    pinned_plan(monkeypatch, buf_batches=1)
    common = dict(file=K27, kmer_size=K, abundance_min=1, histo=True,
                  device="cpu", verbose=1, nb_cores=1, batch_rows=64,
                  row_len=128, spill="on", max_disk=8,
                  out_tmp=str(tmp_path / "tmp"))
    outs = run_ranks(2, lambda ranks: run.execute(
        run.RunParams(out=str(tmp_path / "two"), **common), ranks))
    assert [o.info["config"]["nb_passes"] for o in outs] == [1, 1]
    info = [o.result.info for o in outs]
    assert info[0]["n_bases_local"] == info[0]["n_bases"]  # all on rank 0
    assert (6 << 20) // 2 < info[0]["spill_rows"] * 12 <= 6 << 20
    assert ((tmp_path / "two.histo").read_bytes()
            == (DATA / "k27.histo").read_bytes())
    one = run.execute(run.RunParams(out=str(tmp_path / "one"),
                                    **dict(common, verbose=0)))
    assert (sorted_dump(str(tmp_path / "two.h5"), tmp_path / "two.txt")
            == sorted_dump(one.h5_path, tmp_path / "one.txt"))


def test_spill_sum_over_budget_raises_on_every_rank_at_one_group(
        tmp_path, plain_k27):
    """Each of 2 ranks spills ~1.03 MB of the byte-split input, under the
    2 MB budget of -max-disk 3 alone, but their sum passes it: the fill's
    agreement raises SpillDiskOverflow on both ranks at the same group
    (or at the fill's end), and the files then hold at most the budget
    plus, on each rank, the records of its last two groups (the
    agreements lag the writer thread by one group, and one more is in
    flight)."""
    budget = (3 * 3 // 4) << 20
    groups = {0: [], 1: []}
    held = {}
    delete = port_engine._delete_spill

    def spy_delete(spill):
        held[spill.host] = spill.bytes_written
        delete(spill)

    def rank(ranks):
        eng = rank_engine(ranks, **SPILL)
        drain = eng._drain_spill_group

        def spy_drain(rec, bounds, ready, spill, acc, sub):
            before = spill.bytes_written
            drain(rec, bounds, ready, spill, acc, sub)
            groups[ranks.rank].append(spill.bytes_written - before)

        eng._drain_spill_group = spy_drain
        try:
            eng.count(share(plain_k27, ranks), cache_dir=str(tmp_path),
                      max_disk_mb=3)
        except Exception as e:
            return e

    import unittest.mock

    with unittest.mock.patch.object(port_engine, "_delete_spill",
                                    spy_delete):
        errs = run_ranks(2, rank)
    assert all(isinstance(e, SpillDiskOverflow) for e in errs), errs
    assert str(errs[0]) == str(errs[1])
    # one agreement: a group's, or the fill's end where the writer thread
    # had not appended the last group's records at its agreement yet
    assert re.search(r"for all ranks together\) at (fill group \d+|the "
                     r"fill's end);", str(errs[0])), errs[0]
    assert all(0 < held[r] <= budget for r in (0, 1))  # no store alone
    total = held[0] + held[1]
    assert budget < total <= budget + sum(sum(g[-2:]) for g in
                                          groups.values())


def test_execute_spill_sum_over_budget_retry_ends_equal(tmp_path,
                                                        monkeypatch,
                                                        plain_k27):
    """The same through execute on 2 ranks (the plan pinned to one pass in
    one-batch groups): every rank raises, the passes double, and the
    output equals one device's."""
    pytest.importorskip("h5py")
    from dsk_tpu_torch.engine import run

    pinned_plan(monkeypatch, buf_batches=1, n_passes=1)
    common = dict(file=plain_k27, kmer_size=K, abundance_min=1, histo=True,
                  device="cpu", verbose=0, nb_cores=1, batch_rows=256,
                  row_len=128, spill="on", max_disk=3,
                  out_tmp=str(tmp_path / "tmp"))
    outs = run_ranks(2, lambda ranks: run.execute(
        run.RunParams(out=str(tmp_path / "two"), **common), ranks))
    assert [o.info["config"]["nb_passes"] for o in outs] == [2, 2]
    assert all(o.result.info["n_bases_local"] < o.result.info["n_bases"]
               for o in outs)
    assert ((tmp_path / "two.histo").read_bytes()
            == (DATA / "k27.histo").read_bytes())
    one = run.execute(run.RunParams(out=str(tmp_path / "one"),
                                    **dict(common, max_disk=0)))
    assert (sorted_dump(str(tmp_path / "two.h5"), tmp_path / "two.txt")
            == sorted_dump(one.h5_path, tmp_path / "one.txt"))


@pytest.fixture
def failing_rank(monkeypatch, request):
    """Make rank 1's count phase fail: its merge (the fold) or its reader
    thread (a bucket-file read)."""
    if request.param == "read":
        read = SpillStore.read_chunk_all

        def bad_read(self, *args):
            if self.host == 1:
                raise OSError("injected read failure")
            return read(self, *args)

        monkeypatch.setattr(SpillStore, "read_chunk_all", bad_read)
        return lambda eng: None

    def break_fold(eng):
        if eng.ranks.rank == 1:
            def bad_fold(*_args):
                raise RuntimeError("injected fold failure")

            eng._fold_records = bad_fold

    return break_fold


@pytest.mark.parametrize("failing_rank", ["fold", "read"], indirect=True)
def test_count_phase_failure_on_one_rank_raises_on_every_rank(
        tmp_path, failing_rank):
    """ADVICE r5 (c): a failure in one rank's count phase is raised on
    every rank (its own error, PeerFailed on the others), at once and
    with no partial result: the sink receives nothing."""
    import time

    sink = Sink()

    def rank(ranks):
        eng = rank_engine(ranks, spill_dir=str(tmp_path), **SPILL)
        failing_rank(eng)
        t0 = time.perf_counter()
        try:
            eng.count(share(K27, ranks),
                      pass_sink=sink if ranks.rank == 0 else _never)
        except Exception as e:
            return e, time.perf_counter() - t0
        return None, time.perf_counter() - t0

    out = run_ranks(2, rank, timeout_s=30)
    (e0, t0), (e1, t1) = out
    assert isinstance(e0, PeerFailed), e0
    assert "injected" in str(e1)
    assert max(t0, t1) < 30
    assert sink.parts == []
    assert not os.listdir(tmp_path)


def test_fill_only_resume_across_ranks(tmp_path, monkeypatch, one_device):
    root = str(tmp_path / "ckpt")

    def rank(ranks, fail=False):
        eng = rank_engine(ranks, **SPILL)
        if fail and ranks.rank == 1:
            def bad_fold(*_args):
                raise RuntimeError("crash after the fill")

            eng._fold_records = bad_fold
        ckpt = SpillCheckpoint(root, "fp ranks=2")
        try:
            return eng.count(share(K27, ranks), spill_ckpt=ckpt)
        except Exception as e:
            return e

    first = run_ranks(2, lambda r: rank(r, fail=True))
    assert all(isinstance(e, Exception) for e in first)
    # both fills are durable: their manifests and bucket files stay
    assert {f for f in os.listdir(root) if f.startswith("fill_")} == {
        "fill_p0.json", "fill_p0_h001.json"}

    def no_input(*_args, **_kw):
        raise AssertionError("the resumed run read its input")

    monkeypatch.setattr(port_engine, "batch_iterator", no_input)
    res = run_ranks(2, rank)
    assert all(r.info.get("fill_resumed") for r in res)
    merged = merge_host_results(res)
    assert_tables_equal((merged.kmers, merged.counts),
                        (one_device[0].kmers, one_device[0].counts))
    assert os.listdir(root) == []  # manifests and pass0 are gone


# -- the CLI under torchrun --------------------------------------------------

RUN_TIMEOUT_S = 300


def torchrun(tmp_path, name: str, n: int, *args):
    """The port's dsk CLI under torchrun with n CPU ranks; returns the
    output prefix and the ranks' log."""
    import subprocess
    import sys

    out = str(tmp_path / name)
    repo = str(DATA.parent.parent)
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "dsk_tpu_torch.cli.dsk",
         "-device", "cpu", "-out", out, "-nb-cores", "1", *args],
        capture_output=True, env=env, cwd=repo, timeout=RUN_TIMEOUT_S)
    assert r.returncode == 0, r.stderr.decode()[-4000:]
    return out, r.stdout.decode() + r.stderr.decode()


def sorted_dump(h5_path: str, txt) -> bytes:
    from dsk_tpu_torch.cli import dsk2ascii

    assert dsk2ascii.main(["-file", h5_path, "-out", str(txt), "-verbose",
                           "0", "-sorted"]) == 0
    return pathlib.Path(txt).read_bytes()


@pytest.fixture
def dsk_tpu_run():
    """dsk_tpu's execute on one CPU device (engine="simple": the sorted
    dump, the .histo and the .histo2D do not depend on the engine)."""
    pytest.importorskip("h5py")

    def run(tmp_path, name, file, **kw):
        from dsk_tpu.engine.run import RunParams, execute

        return execute(RunParams(file=file, kmer_size=K, engine="simple",
                                 out=str(tmp_path / name), verbose=0, **kw))

    return run


def test_cli_spill_on_four_ranks_equals_the_fixture_and_dsk_tpu(
        tmp_path, dsk_tpu_run):
    spill_tmp = tmp_path / "spill_tmp"
    spill_tmp.mkdir()
    out, log = torchrun(tmp_path, "port", 4, "-file", K27, "-kmer-size",
                        "27", "-abundance-min", "1", "-histo", "1",
                        "-spill", "on", "-spill-partitions", "8",
                        "-out-tmp", str(spill_tmp))
    assert "4 ranks" in log and "spill over 8 partitions" in log
    assert (pathlib.Path(out + ".histo").read_bytes()
            == (DATA / "k27.histo").read_bytes())
    ref = dsk_tpu_run(tmp_path, "ref", K27, abundance_min=1, histo=True)
    got = sorted_dump(out + ".h5", tmp_path / "port.txt")
    assert got == sorted_dump(ref.h5_path, tmp_path / "ref.txt")
    assert got.count(b"\n") == 93948
    assert os.listdir(spill_tmp) == []  # spill files and checkpoint gone


def test_cli_spill_per_bank_four_ranks_equals_dsk_tpu(tmp_path, dsk_tpu_run):
    out, _ = torchrun(tmp_path, "port", 4, "-file", C14, "-kmer-size", "27",
                      "-solidity-kind", "min", "-histo2D", "1", "-histo",
                      "1", "-spill", "on", "-spill-partitions", "8")
    ref = dsk_tpu_run(tmp_path, "ref", C14, solidity_kind="min",
                      histo2d=True, histo=True)
    for suffix in (".histo", ".histo2D"):
        assert (pathlib.Path(out + suffix).read_bytes()
                == pathlib.Path(ref.params.out + suffix).read_bytes()), suffix
    assert (sorted_dump(out + ".h5", tmp_path / "port.txt")
            == sorted_dump(ref.h5_path, tmp_path / "ref.txt"))


def test_cli_spill_auto_four_ranks_picks_spill(tmp_path):
    pytest.importorskip("h5py")
    spill_tmp = tmp_path / "spill_tmp"
    spill_tmp.mkdir()
    out, log = torchrun(tmp_path, "auto", 4, "-file", K27, "-kmer-size",
                        "27", "-abundance-min", "1", "-histo", "1",
                        "-max-memory", "1", "-max-disk", "64", "-out-tmp",
                        str(spill_tmp), "-verbose", "1")
    assert "4 ranks, spill over" in log, log[-2000:]
    assert (pathlib.Path(out + ".histo").read_bytes()
            == (DATA / "k27.histo").read_bytes())
    assert os.listdir(spill_tmp) == []


def test_planner_charges_no_route_bytes_to_spill_groups():
    from dsk_tpu_torch.engine import planner

    bank = str(DATA / "readN.fasta")

    def plan(n, spill):
        return planner.plan_resources(
            bank, 21, max_memory_mb=8000 * n, n_chips=n, device="cpu",
            batch_rows=4096, row_len=1024, spill=spill, max_disk_mb=1000)

    one, four = plan(1, "on"), plan(4, "on")
    assert one.spill and four.spill
    # the spill fill routes nothing: a rank's group is one device's group
    assert four.buf_batches == one.buf_batches
    assert plan(4, "off").buf_batches < plan(1, "off").buf_batches
