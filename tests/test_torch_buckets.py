"""Key-space buckets of the flush (flush_buckets > 1) in the port against
dsk_tpu on the CPU; tolerance 0 throughout (keys and counts are
integers).

- The table, through state_to_jax, equals dsk_tpu's `_last_state` on a
  one-device mesh bit for bit, its bucket-major layout included, at S in
  {2, 8, 32} with bucketize_at "flush" and "route", per bank over two
  passes, and after a resume from a mid-stream dsk_tpu table; the
  geometry (S, table_cap, the bucket widths) is dsk_tpu's.
- A bucket overflow (rows past a bucket's width: RoutingOverflow, in both
  variants, with the same row count as dsk_tpu's message; one past the
  compacted heads too) and a bucket's table overflow that one flat table
  would not raise (TableOverflow, the same message) raise dsk_tpu's type
  at the same input; execute's retries end in the normal output.
- Across 2 and 4 simulated ranks (tests/torch_loopback.py) on the hash
  and the superkmer routes, every rank's table equals dsk_tpu's n-chip
  engine's chip-r table, layout included; execute -flush-buckets 8 runs
  on 2 ranks by either route to the fixture's .histo.
- Through execute and the CLI with -flush-buckets 8 on k27 and c1..c4:
  the dsk2ascii dumps in store order (bucket-major), the .histo and the
  .histo2D are byte-identical to dsk_tpu's.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dsk_tpu import oracle
from dsk_tpu.dist.engine import AXIS, default_mesh
from dsk_tpu.dist.engine import DistCountEngine as JaxEngine
from dsk_tpu.dist.engine import RoutingOverflow as JaxRoutingOverflow
from dsk_tpu.dist.engine import TableOverflow as JaxTableOverflow
from dsk_tpu.io.bank import open_bank
from dsk_tpu.io.batch import Batch, batch_iterator
from dsk_tpu_torch.dist.engine import (
    DistCountEngine,
    RoutingOverflow,
    TableOverflow,
    state_from_jax,
    state_to_jax,
)
from dsk_tpu_torch.dist.spill import kmer_hash_planes_np
from dsk_tpu_torch.engine import run as port_run
from tests.test_torch_multigpu_route import (
    dryrun_batches,
    ref_partitions,
    routed_pass,
)
from tests.test_torch_spill import one_chip_ref  # noqa: F401 (fixture)
from tests.test_torch_superkmer import M, sk_pass

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"
K27 = str(DATA / "read50x_ref10K_e001.fasta.gz")
C14 = ",".join(str(DATA / f"c{i}.fasta.gz") for i in range(1, 5))
K = 27
GEOM = dict(batch_rows=64, row_len=128, buf_batches=4)
OVER = re.compile(r"routing overflow: (\d+) ")


def mesh1():
    return Mesh(np.array(jax.devices()[:1]), (AXIS,))


@pytest.fixture(scope="module")
def k27_batches():
    """The first 40 batches of the k27 fixture (~60K distinct k-mers)."""
    return list(batch_iterator(open_bank(K27), K, GEOM["batch_rows"],
                               GEOM["row_len"]))[:40]


def jax_table(eng):
    return tuple(np.asarray(a) for a in eng._last_state)


def assert_tables_equal(port_eng, jax_eng):
    """Whole tables, sentinel slots included, then the gathered rows."""
    got = state_to_jax(*port_eng._last_state)
    want = jax_table(jax_eng)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    (_, rows, counts), = port_eng.iter_partitions()
    (_, jrows, jcounts), = jax_eng.iter_partitions()
    np.testing.assert_array_equal(rows, np.asarray(jrows, np.uint32))
    np.testing.assert_array_equal(counts, np.asarray(jcounts))


def assert_bucket_major(planes, counts, S: int, W: int):
    """Bucket b of the (WK, cap) table holds its live rows first, each
    with b as the top log2 S bits of its hash, ascending, then dead rows."""
    cap = counts.shape[0]
    capb = cap // S
    for b in range(S):
        c = counts[b * capb:(b + 1) * capb]
        p = planes[:, b * capb:(b + 1) * capb]
        n = int((c > 0).sum())
        assert (c[:n] > 0).all() and (c[n:] == 0).all()
        assert (p[:, n:] == 0xFFFFFFFF).all()
        live = p[:, :n]
        h = kmer_hash_planes_np([live[w] for w in range(W)])
        assert (h >> np.uint32(32 - (S.bit_length() - 1)) == b).all()
        keys = [tuple(r) for r in live.T]
        assert keys == sorted(set(keys))


@pytest.mark.parametrize("where", ["flush", "route"])
@pytest.mark.parametrize("S", [2, 8, 32])
def test_table_equals_dsk_tpu_bit_for_bit(k27_batches, S, where):
    geom = dict(GEOM, table_cap=(1 << 16) + 1000, flush_buckets=S,
                bucketize_at=where)
    je = JaxEngine(K, mesh=mesh1(), **geom)
    te = DistCountEngine(K, device="cpu", **geom)
    # dsk_tpu's geometry: S, table_cap rounded to a multiple of S, widths
    assert (te.plan.S, te.plan.table_cap) == (je.plan.S, je.plan.table_cap)
    assert te.plan.S == S and te.plan.table_cap % S == 0
    assert te.bucketize_at == je.bucketize_at == where
    if where == "flush":
        assert te.plan.flush_cols == je.plan.flush_cols > 0
        assert te.plan.flush_cols % 128 == 0
    else:
        assert te.plan.bucket_cols == je.plan.bucket_cols > 0
    want = je.count_stream(iter(k27_batches), finalize=False)
    got = te.count_stream(iter(k27_batches), finalize=False)
    np.testing.assert_array_equal(got.histogram, want.histogram)
    assert_tables_equal(te, je)
    assert_bucket_major(*state_to_jax(*te._last_state), S, te.W)


def test_planner_table_caps_need_no_rounding():
    """The planner's table_cap grid ({2^n, 3 * 2^(n-1)}, n >= 16) divides
    by every S the engine picks (a power of two <= cap / 256), so the
    engine's rounding to a multiple of S keeps the planner's table, at
    any -flush-buckets."""
    from dsk_tpu_torch.engine.planner import _round_capacity

    caps = sorted({_round_capacity(x) for x in range(1 << 16, 1 << 27,
                                                      1 << 19)})
    assert len(caps) > 10
    for cap in caps:
        for fb in (2, 3, 8, 32, 1000, 1 << 20):
            eng = DistCountEngine(K, device="cpu", table_cap=cap,
                                  flush_buckets=fb)
            assert eng.plan.table_cap == cap
            assert 1 < eng.plan.S <= fb and cap % eng.plan.S == 0


@pytest.mark.parametrize("where", ["flush", "route"])
def test_per_bank_two_passes_equal_dsk_tpu(where):
    files = ",".join(str(DATA / f"c{i}.fasta.gz") for i in (1, 2))
    batches = list(batch_iterator(open_bank(files), K, 64, 128))[:24]
    geom = dict(GEOM, table_cap=1 << 16, flush_buckets=16,
                bucketize_at=where, per_bank=True, n_passes=2)
    je = JaxEngine(K, mesh=mesh1(), **geom)
    te = DistCountEngine(K, device="cpu", **geom)
    assert te.plan.S == 16
    for p in range(2):
        je.count_stream(iter(batches), nb_banks=2, pass_id=p, finalize=False)
        te.count_stream(iter(batches), nb_banks=2, pass_id=p, finalize=False)
        assert_tables_equal(te, je)
        got = te.gather_tables_per_bank(*te._last_state, 2)
        want = je.gather_tables_per_bank(*je._last_state, 2)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_across_packages_mid_stream(k27_batches):
    """Half the groups at S=8 in one package, the table carried across
    (state_from_jax, state_to_jax), the rest in the other: the whole
    stream's table of dsk_tpu, either way."""
    geom = dict(GEOM, table_cap=1 << 16, flush_buckets=8)
    G = GEOM["buf_batches"]
    cut = (len(k27_batches) // G // 2) * G
    head, tail = k27_batches[:cut], k27_batches[cut:]
    want_eng = JaxEngine(K, mesh=mesh1(), **geom)
    want = want_eng.count_stream(iter(k27_batches), finalize=False)

    je = JaxEngine(K, mesh=mesh1(), **geom)
    half = je.count_stream(iter(head), finalize=False)
    te = DistCountEngine(K, device="cpu", **geom)
    got = te.count_stream(iter(tail), finalize=False, resume_state=(
        state_from_jax(*jax_table(je), "cpu", groups=cut // G,
                       n_bases=half.info["n_bases"],
                       n_reads=half.info["n_reads"])))
    np.testing.assert_array_equal(got.histogram, want.histogram)
    assert got.info["n_bases"] == want.info["n_bases"]
    assert_tables_equal(te, want_eng)

    te2 = DistCountEngine(K, device="cpu", **geom)
    te2.count_stream(iter(head), finalize=False)
    je2 = JaxEngine(K, mesh=mesh1(), **geom)
    back = je2.count_stream(iter(tail), finalize=False, resume_state={
        "state": tuple(jnp.asarray(a) for a in state_to_jax(
            *te2._last_state)) + (jnp.zeros((1,), jnp.int32),
                                  jnp.zeros((1,), jnp.int32)),
        "groups": cut // G, "n_bases": 0, "n_reads": 0})
    np.testing.assert_array_equal(back.histogram, want.histogram)
    assert_tables_equal(te, je2)


# -- overflows ------------------------------------------------------------

def gc_skewed(batches, k: int = K):
    """Half of every batch's rows a GC repeat: one canonical k-mer (CGCG..,
    in the middle of the key space), so one bucket takes more than a
    fifth of a group's rows."""
    out = []
    for b in batches:
        c = b.codes.copy()
        c[: c.shape[0] // 2] = np.resize(np.array([3, 1], np.uint8),
                                         c.shape[1])
        out.append(Batch(codes=c, bank_ids=b.bank_ids, n_rows=b.n_rows,
                         n_bases=b.n_bases, n_reads=b.n_reads))
    return out


def raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return e.value


@pytest.mark.parametrize("table_cap", [1 << 16, 2048],
                         ids=["heads", "past_the_heads"])
@pytest.mark.parametrize("where", ["flush", "route"])
def test_bucket_overflow_raises_like_dsk_tpu(k27_batches, where, table_cap):
    """RoutingOverflow, first, at the same check and with the same row
    count.  At table_cap 2048 a group holds more distinct k-mers than the
    table: the "flush" count finds the skewed k-mer past the compacted
    heads (in the sorted tail), and the table overflows too.  The
    messages differ in the capacity they name: dsk_tpu names its send
    capacity, which is 0 on one device; the port names the bucket's
    width."""
    batches = gc_skewed(k27_batches)
    geom = dict(GEOM, table_cap=table_cap, flush_buckets=8,
                bucketize_at=where)
    je = raised(lambda: JaxEngine(K, mesh=mesh1(), **geom).count_stream(
        iter(batches)))
    te = raised(lambda: DistCountEngine(K, device="cpu", **geom)
                .count_stream(iter(batches)))
    assert isinstance(je, JaxRoutingOverflow), je
    assert isinstance(te, RoutingOverflow), te
    assert OVER.match(str(te))[1] == OVER.match(str(je))[1]
    plan = DistCountEngine(K, device="cpu", **geom).plan
    width = plan.flush_cols if where == "flush" else plan.bucket_cols
    assert f"the capacity {width} of a key-space bucket" in str(te)


def bucket_sizes(batches):
    """The k-mers of `batches` in each of 8 buckets."""
    res = DistCountEngine(K, device="cpu", **GEOM,
                          table_cap=1 << 16).count_stream(iter(batches))
    h = kmer_hash_planes_np([res.kmers[:, w] for w in range(2)])
    return np.bincount(h >> np.uint32(29), minlength=8)


def test_bucket_table_overflow_raises_like_dsk_tpu(k27_batches):
    """One bucket's slots short of its k-mers: a TableOverflow at S=8 with
    a table that holds every distinct k-mer flat (S=1 raises nothing)."""
    sizes = bucket_sizes(k27_batches)
    cap = 8 * (int(sizes.max()) - 1)
    assert cap >= sizes.sum()
    geom = dict(GEOM, table_cap=cap, flush_buckets=8)
    je = raised(lambda: JaxEngine(K, mesh=mesh1(), **geom).count_stream(
        iter(k27_batches)))
    te = raised(lambda: DistCountEngine(K, device="cpu", **geom)
                .count_stream(iter(k27_batches)))
    assert isinstance(je, JaxTableOverflow), je
    assert isinstance(te, TableOverflow), te
    assert str(te) == str(je)
    flat = DistCountEngine(K, device="cpu", **dict(geom, flush_buckets=1))
    assert flat.count_stream(iter(k27_batches)).n_distinct == sizes.sum()


def write_fasta(batches, path) -> str:
    with open(path, "w") as f:
        for i, b in enumerate(batches):
            for j, row in enumerate(b.codes[: b.n_rows]):
                f.write(f">r{i}_{j}\n" + "".join("ACTG"[c] if c < 4 else "N"
                                               for c in row) + "\n")
    return str(path)


@pytest.mark.parametrize("case", ["bucket", "table"])
def test_execute_retry_ends_in_the_output(tmp_path, monkeypatch,
                                          k27_batches, case, capsys):
    """execute with -flush-buckets 8 (the plan pinned to one pass, 4-batch
    groups and the table size): a bucket overflow retries with twice the
    send_slack (wider buckets), a bucket's table overflow with twice the
    passes; both end in the oracle's count."""
    batches = k27_batches[:24]
    if case == "bucket":
        batches, cap = gc_skewed(batches), 1 << 16
    else:
        cap = 8 * (int(bucket_sizes(batches).max()) - 1)
    fa = write_fasta(batches, tmp_path / "in.fa")
    plan_resources = port_run.plan_resources

    def planned(*args, **kw):
        plan = plan_resources(*args, **kw)
        plan.n_passes, plan.table_cap, plan.buf_batches = 1, cap, 4
        return plan

    monkeypatch.setattr(port_run, "plan_resources", planned)
    out = port_run.execute(port_run.RunParams(
        file=fa, kmer_size=K, abundance_min=1, device="cpu", verbose=1,
        nb_cores=1, batch_rows=64, row_len=128, storage_type="none",
        flush_buckets=8, spill="off", out=str(tmp_path / "o")))
    log = "".join(capsys.readouterr())
    if case == "bucket":
        assert "retrying with send_slack=5.0" in log
        assert out.info["config"]["nb_passes"] == 1
    else:
        assert "table overflow, retrying with n_passes=2" in log
        assert out.info["config"]["nb_passes"] >= 2
    assert dict(out.result.items()) == oracle.count_bank(fa, K)


# -- across ranks ---------------------------------------------------------

@pytest.mark.parametrize("route", ["hash", "superkmer"])
@pytest.mark.parametrize("n", [2, 4])
def test_rank_tables_equal_the_n_chip_engine(n, route):
    """Every rank's table equals dsk_tpu's chip-r table at S=8, layout
    included: both own a k-mer by its hash (or its minimizer), and lay
    each rank's table out by the top bits of the k-mer's hash."""
    row_len = 48
    geom = dict(batch_rows=4 * n, row_len=row_len, table_cap=1 << 11,
                buf_batches=2, flush_buckets=8)
    batches = dryrun_batches(n, row_len)
    sk = dict(routing="superkmer", minimizer_size=M) if route != "hash" \
        else {}
    ref = JaxEngine(21, mesh=default_mesh(n), **sk, **geom)
    assert ref.plan.S == 8
    res, parts = ref_partitions(ref, batches, 0)
    tab_p, tab_c = jax_table(ref)
    cap = ref.plan.table_cap

    def states(ranks):
        from dsk_tpu_torch.dist.engine import DistCountEngine as E

        e = E(21, device="cpu", wire="bitmap", ranks=ranks, **sk, **geom)
        assert e.plan.S == 8 and e.routing == route
        out = e.count_stream(iter(batches[ranks.rank::n]), finalize=False)
        return state_to_jax(*e._last_state), out

    from tests.torch_loopback import Loopback

    for r, ((p, c), out) in enumerate(Loopback(n, "cpu").run(states)):
        np.testing.assert_array_equal(p, tab_p[:, r * cap:(r + 1) * cap])
        np.testing.assert_array_equal(c, tab_c[r * cap:(r + 1) * cap])
        np.testing.assert_array_equal(out.histogram, res.histogram)
    assert sum(q[1].shape[0] for q in parts) > 400
    # the partitions as the sink takes them: bucket-major, as dsk_tpu's
    got = (routed_pass(n, 21, batches, geom) if route == "hash"
           else sk_pass(n, 21, batches, geom)[0])
    for r, (rp, _) in enumerate(got):
        np.testing.assert_array_equal(rp[0][1],
                                      np.asarray(parts[r][1], np.uint32))


@pytest.mark.parametrize("route", ["hash", "superkmer"])
def test_execute_across_ranks_with_flush_buckets(tmp_path, route):
    """execute -flush-buckets 8 on 2 simulated ranks, by hash and by
    superkmer (-minimizer-type 1): the .histo is the fixture's and the
    ranks' tables together are the oracle's count."""
    from tests.torch_loopback import Loopback

    kw = dict(minimizer_type=1) if route == "superkmer" else {}

    def rank(ranks):
        return port_run.execute(port_run.RunParams(
            file=K27, kmer_size=K, abundance_min=1, histo=True, verbose=0,
            device="cpu", nb_cores=1, batch_rows=256, row_len=128,
            storage_type="none", flush_buckets=8, spill="off",
            out=str(tmp_path / "r"), **kw), ranks)

    outs = Loopback(2, "cpu", timeout_s=120).run(rank)
    assert ((tmp_path / "r.histo").read_bytes()
            == (DATA / "k27.histo").read_bytes())
    got = {}
    for o in outs:
        got.update(o.result.items())
    assert got == oracle.count_bank(K27, K)


# -- the CLI and execute against dsk_tpu's files --------------------------

@pytest.mark.parametrize("which", ["k27", "c1_c4"])
def test_dumps_byte_identical_to_dsk_tpu(tmp_path, one_chip_ref, which):
    """-flush-buckets 8 through the port's CLI (its main, in process) and
    dsk_tpu's execute: the dsk2ascii dump in store order (bucket-major
    partitions), the .histo and, over c1..c4, the .histo2D."""
    pytest.importorskip("h5py")
    from dsk_tpu.cli import dsk2ascii as ref_dsk2ascii
    from dsk_tpu.engine.run import RunParams as RefParams
    from dsk_tpu.engine.run import execute as ref_execute
    from dsk_tpu_torch.cli import dsk as port_cli
    from dsk_tpu_torch.cli import dsk2ascii

    per_bank = which == "c1_c4"
    file = C14 if per_bank else K27
    extra = dict(histo2d=True, solidity_kind="min") if per_bank else {}
    ref = ref_execute(RefParams(
        file=file, kmer_size=K, abundance_min=1, histo=True, verbose=0,
        batch_rows=256, row_len=128, max_memory=1000, flush_buckets=8,
        engine="dist", out=str(tmp_path / "ref"), **extra))
    args = ["-file", file, "-kmer-size", str(K), "-abundance-min", "1",
            "-histo", "1", "-verbose", "0", "-device", "cpu", "-nb-cores",
            "1", "-max-memory", "1000", "-flush-buckets", "8",
            "-out", str(tmp_path / "port")]
    if per_bank:
        args += ["-histo2D", "1", "-solidity-kind", "min"]
    assert port_cli.main(args) == 0
    suffixes = (".histo", ".histo2D") if per_bank else (".histo",)
    for s in suffixes:
        assert ((tmp_path / f"port{s}").read_bytes()
                == (tmp_path / f"ref{s}").read_bytes()), s
    if not per_bank:
        assert ((tmp_path / "port.histo").read_bytes()
                == (DATA / "k27.histo").read_bytes())
    assert ref_dsk2ascii.main(["-file", ref.h5_path, "-out",
                               str(tmp_path / "ref.txt"), "-verbose",
                               "0"]) == 0
    assert dsk2ascii.main(["-file", str(tmp_path / "port.h5"), "-out",
                           str(tmp_path / "port.txt"), "-verbose", "0"]) == 0
    a = (tmp_path / "port.txt").read_bytes()
    assert a == (tmp_path / "ref.txt").read_bytes()
    assert len(a) > 100_000
