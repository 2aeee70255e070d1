"""End-to-end counting run: bank -> count -> processors -> output store.

The port of dsk_tpu/engine/run.py `execute` for the one-device table
engine (dsk_tpu_torch/dist/engine.py): plan, count with the automatic
re-plan valves (TableOverflow / CountVolumeOverflow -> more passes,
WireOverflow -> bitmap wire), stream each pass's solid k-mers into the
HDF5 store, and write the .histo file.  Per-pass checkpoints let a
multi-pass run resume.  Over several banks, -solidity-kind other than sum,
-solidity-custom and -histo2D count per bank: the engine's table holds
(k-mer, bank) pairs and its pass sink receives them grouped per k-mer,
with the per-bank matrix that the solidity rule and the .histo2D matrix
read.

Spill mode (-spill on, or auto when the planner finds it cheaper than
more passes) counts through the engine's host partition store; a
`<prefix>.spillckpt` directory keeps its fill and count marks, so a run
killed mid-count resumes with -resume without reading the input again.
A spill past -max-disk doubles the passes; across ranks -max-disk is
the budget of all ranks' spill files together.  One repair against the
reference: a spill fill manifest is reused only under -resume (or the
run's own work-preserving retry); any other run clears the directory
first, and the checkpoint fingerprint covers the input's size and mtime.

Across GPUs (execute(params, ranks): one process per GPU, as the CLI
under torchrun starts it, dist/multihost.py) every rank runs execute with
the same parameters: rank 0 plans and broadcasts the plan, each rank
counts its shard_bank share in the routed table mode (rank r owns output
partition r), and -send-slack sizes the route capacity; a RoutingOverflow
(a rank's rows for one owner, or the rows of one key-space bucket of a
-flush-buckets flush, on any world size) retries with twice the slack
and keeps the counted work as the WireOverflow retry does.  Every valve is raised on every rank at once, so
every rank takes the same retry.  Rank 0 decides checkpoint reuse and
broadcasts it, gathers each rank's partition in turn, and alone writes the
.h5 store, the .histo and the .histo2D; every rank returns the same
summary.

Minimizers (-minimizer-type 1 or -repartition-type 1, with
-minimizer-size): across ranks the count routes superkmer records by a
minimizer -> rank table that rank 0 samples from the bank and broadcasts
(frequency-balanced with -minimizer-type 1, round-robin otherwise); on
any world size the run info records the repartition statistics
(info["repartition"]), reusing the routing's sample.  -trace-dir writes a
torch.profiler trace of the whole call (CUDA activity on a CUDA device),
the program's spans in it as `dsk.<name>` ranges, into the directory; a
profiler that cannot start leaves the run untraced and says so in the
progress log.

Spill across ranks (-spill on, or auto, with more than one rank): every
rank fills its partition files under one directory that every rank sees
(-out-tmp, else the output's directory: across hosts a shared
filesystem), the ranks count the partitions they own, and rank 0's sink
receives every partition.  The spill checkpoint keeps the fill only:
rank 0 opens (and without -resume clears) `<prefix>.spillckpt`, the
other ranks open it after it, and rank 0 removes it once every rank is
done with it.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from dsk_tpu_torch.io.bank import open_bank
from dsk_tpu_torch.store import text as store_text
from dsk_tpu_torch.store.hdf5 import OutputStore
from dsk_tpu_torch.utils import spans
from dsk_tpu_torch.utils.timeinfo import Progress
from dsk_tpu_torch.engine import processors
from dsk_tpu_torch.engine.counter import CountResult
from dsk_tpu_torch.engine.planner import plan_resources


@dataclass
class RunParams:
    """The engine-owned config schema; field names mirror the dsk CLI.
    A copy of dsk_tpu's RunParams plus `device` and `storage_type`."""

    file: str
    kmer_size: int = 31
    abundance_min: int = 2
    abundance_max: int = 2**31 - 1
    solidity_kind: str = "sum"
    solidity_custom: str | None = None
    out: str | None = None
    out_dir: str = "."
    out_tmp: str | None = None
    max_memory: int = 5000   # MB, device table budget (planner input)
    max_disk: int = 0        # MB, 0 = auto
    histo_max: int = 10000
    histo: bool = False
    histo2d: bool = False
    nb_cores: int = 0        # 0 = auto (host pipeline workers)
    verbose: int = 1
    batch_rows: int = 0      # 0 = auto (planner)
    row_len: int = 0         # 0 = auto
    resume: bool = False     # reuse <prefix>.ckpt.h5 pass checkpoints
    checkpoint: bool = True  # per-pass checkpoints on multi-pass runs
    engine: str = "auto"     # auto | dist: the port has one engine
    solid_kmers_out: str | None = None
    out_compress: bool = False
    minimizer_size: int = 10
    minimizer_type: int = 0
    repartition_type: int = 0
    send_slack: float = 2.5  # route capacity across ranks (doubles on
                             # RoutingOverflow); unused on one device
    max_retries: int = 3
    flush_buckets: int = 1
    wire: str | None = None  # None = auto (exc; bitmap after WireOverflow)
    trace_dir: str | None = None
    spill: str = "auto"      # host partition spill (dist/spill.py):
                             # auto = planner decides from measured
                             # wire/re-read cost | on | off
    spill_partitions: int = 0  # override the planner's partition count
    device: str = "cuda"     # cuda | cpu: no silent fallback
    storage_type: str = "hdf5"  # hdf5 | none (no .h5 store is written)

    def out_prefix(self) -> str:
        if self.out:
            base = self.out
        else:
            name = os.path.basename(self.file.split(",")[0])
            for ext in (".gz", ".fasta", ".fa", ".fastq", ".fq", ".fna"):
                if name.endswith(ext):
                    name = name[: -len(ext)]
            base = os.path.join(self.out_dir, name)
        return base[:-3] if base.endswith(".h5") else base

    def custom_vector(self, nb_banks: int) -> np.ndarray | None:
        if not self.solidity_custom:
            return None
        vec = np.array(
            [int(x) for x in self.solidity_custom.replace(",", " ").split()],
            dtype=np.int64,
        )
        if vec.shape[0] != nb_banks:
            raise ValueError(
                f"-solidity-custom has {vec.shape[0]} entries for {nb_banks} banks"
            )
        return vec


def _check_supported(params: RunParams, world_size: int = 1) -> None:
    if params.spill not in ("auto", "on", "off"):
        raise ValueError(f"unknown -spill mode {params.spill!r}")
    if params.engine not in ("auto", "dist"):
        raise ValueError(
            f"-engine {params.engine}: the port has one engine (dist)"
        )
    if params.storage_type not in ("hdf5", "none"):
        raise ValueError(f"unknown storage type {params.storage_type!r}")


def _open_spill_checkpoint(params: RunParams, prefix: str, n_passes: int,
                           reuse: bool, world: int = 1):
    """The mid-pass spill checkpoint at <out-tmp or the output's
    directory>/<prefix name>.spillckpt (it holds the bucket files, so it
    lives on the spill disk).  reuse=False (no -resume) clears what an
    earlier run left there first: its fill manifest may describe another
    input, and an unrequested resume would count stale buckets.  Across
    ranks the fingerprint holds the world size: another world's manifests
    describe other shares of the input."""
    from dsk_tpu_torch.dist.spill import SpillCheckpoint
    from dsk_tpu_torch.engine.checkpoint import _fingerprint

    base = params.out_tmp or os.path.dirname(os.path.abspath(prefix))
    root = os.path.join(base, os.path.basename(prefix) + ".spillckpt")
    if not reuse and os.path.isdir(root):
        SpillCheckpoint(root, "").remove()
    fingerprint = _fingerprint(params, n_passes)
    if world > 1:
        fingerprint += f" ranks={world}"
    return SpillCheckpoint(root, fingerprint)


def _preserve_retry_work(engine, n_passes, ckpt, store, h5_path):
    """Work-preserving prep shared by the retry valves whose knob keeps
    the pass hash and the table geometry (WireOverflow -> bitmap,
    RoutingOverflow -> more slack): counted work survives the rebuild.
    Returns (resume_snapshot, auto_resume, store, preserved message)."""
    snap = engine._retry_snapshot
    if snap is not None and n_passes <= 1:
        return snap, False, store, f" (resuming from group {snap['groups']})"
    if n_passes > 1 and ckpt is not None:
        return None, True, store, " (completed passes kept via checkpoint)"
    return None, False, _drop_partial_store(store, h5_path, ckpt), ""


def _drop_partial_store(store, h5_path: str | None, ckpt) -> None:
    """Discard a partially written store (and its checkpoint) before a
    retry that changes pass semantics."""
    if store is not None:
        try:
            store.close()
        except Exception:
            pass
        if h5_path and os.path.exists(h5_path):
            os.unlink(h5_path)
    if ckpt is not None:
        ckpt.remove()
    return None


@contextlib.contextmanager
def _device_trace(trace_dir: str | None, device, rank: int, progress):
    """-trace-dir: a torch.profiler trace of the body (host activity, and
    CUDA activity on a CUDA device) written into trace_dir as
    dsk_count_rank<r>.<time>.pt.trace.json (chrome trace format; the
    profiler's tensorboard handler).  A profiler that cannot start, or a
    trace that cannot be written, leaves the run going and is logged."""
    prof = None
    if trace_dir:
        try:
            from torch.profiler import (
                ProfilerActivity,
                profile,
                tensorboard_trace_handler,
            )

            acts = [ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(trace_dir, exist_ok=True)
            prof = profile(activities=acts,
                           on_trace_ready=tensorboard_trace_handler(
                               trace_dir, f"dsk_count_rank{rank}"))
            prof.__enter__()
        except Exception as e:
            progress.log(f"[dsk_tpu_torch] -trace-dir: the profiler did not "
                         f"start ({type(e).__name__}: {e}); counting without "
                         f"a trace")
            prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                progress.log(f"[dsk_tpu_torch] device trace -> {trace_dir}")
            except Exception as e:
                progress.log(f"[dsk_tpu_torch] -trace-dir: the trace was not "
                             f"written ({type(e).__name__}: {e})")


def _repartition_stats(freq: np.ndarray, table: np.ndarray,
                       minimizer_size: int) -> dict:
    """The run info's repartition statistics (the reference's): each
    partition's sampled minimizer load under the table."""
    loads = np.zeros(table.max() + 1, dtype=np.int64)
    np.add.at(loads, table, freq)
    return {
        "minimizer_size": minimizer_size,
        "nb_minimizers_seen": int((freq > 0).sum()),
        "partition_loads": [int(x) for x in loads],
    }


@dataclass
class RunOutput:
    params: RunParams
    result: CountResult
    h5_path: str | None
    n_solid: int
    histo_path: str | None = None
    histo2d_path: str | None = None
    info: dict = field(default_factory=dict)


# the TimeInfo phases of the run info's "time", each a span of the run
PHASES = ("configure", "repartition", "count", "write")


def _phase_times(run: spans.Run) -> dict:
    """The phases' seconds so far, as TimeInfo.as_properties gives them."""
    totals, _ = run.totals_ns()
    return {p: f"{totals[p][0] / 1e9:.3f}" for p in PHASES if p in totals}


def execute(params: RunParams, ranks=None) -> RunOutput:
    """Run a full count: the dsk tool in library form.  ranks (a
    dist/multihost.py Ranks) runs this process as one rank of a routed
    count across GPUs, on ranks.device; every rank calls execute with
    the same params.

    The call is one run of utils/spans.py: info["trace"] holds its spans'
    and counters' totals, info["time"] the TimeInfo phases taken from
    them.  -trace-dir profiles the whole call, and info["flush"] then
    holds each flush piece's device milliseconds."""
    world = ranks.world_size if ranks is not None else 1
    root = ranks is None or ranks.rank == 0
    device = params.device
    if ranks is not None:
        if torch.device(params.device).type != ranks.device.type:
            raise ValueError(
                f"-device {params.device} but the ranks run on "
                f"{ranks.device}")
        device = str(ranks.device)
    progress = Progress(params.verbose if root else 0)
    with _device_trace(params.trace_dir, device,
                       ranks.rank if ranks is not None else 0, progress):
        with spans.run() as run:
            out = _execute(params, ranks, world, root, device, progress)
        out.info["trace"] = run.summary()
    return out


def _execute(params: RunParams, ranks, world: int, root: bool, device,
             progress) -> RunOutput:
    from dsk_tpu_torch.utils.hostmem import tune_malloc

    from dsk_tpu_torch.dist.engine import (
        CountVolumeOverflow,
        DistCountEngine,
        RoutingOverflow,
        TableOverflow,
        _RouteLog,
    )
    from dsk_tpu_torch.dist.multihost import shard_bank
    from dsk_tpu_torch.dist.spill import SpillDiskOverflow
    from dsk_tpu_torch.io.packed import WireOverflow

    tune_malloc()
    bank = open_bank(params.file)
    k = params.kmer_size
    _check_supported(params, world)
    # per-bank counting: the table holds (k-mer, bank) pairs
    need_per_bank = bank.nb_banks > 1 and (
        params.histo2d
        or params.solidity_kind != "sum"
        or params.solidity_custom is not None
    )
    if need_per_bank:
        spans.count("bank.nb_banks", bank.nb_banks)

    # minimizer/superkmer routing (-minimizer-type 1 / -repartition-type
    # 1): across ranks the engine routes packed superkmer records by a
    # minimizer -> rank table instead of per-k-mer hashes
    minimizers = params.minimizer_type == 1 or params.repartition_type == 1
    routing = "superkmer" if minimizers and world > 1 else "hash"

    with spans.span("configure"):
        from dsk_tpu_torch.utils import sysinfo

        limits = sysinfo.auto_limits(params.out_tmp, device=device)
        max_memory = params.max_memory
        if max_memory <= 0:
            # -max-memory is the budget of all ranks together
            max_memory = limits["max_memory_mb"] * world
        plan = None
        if root:
            plan = plan_resources(
                bank,
                k,
                max_memory_mb=max_memory,
                n_chips=world,
                batch_rows=params.batch_rows,
                row_len=params.row_len,
                device=device,
                per_bank=need_per_bank,
                spill=params.spill,
                max_disk_mb=params.max_disk,
                send_slack=params.send_slack,
                routing=routing,
                minimizer_size=params.minimizer_size,
            )
        if ranks is not None:
            plan = ranks.broadcast(plan)
    repartition = None
    sampled_freq = None
    if routing == "superkmer":
        from dsk_tpu_torch.kmer import minimizer as mz

        with spans.span("repartition"):
            # rank 0 samples the whole bank; every rank routes by its table
            if root:
                sampled_freq = mz.sample_minimizer_frequencies(
                    bank, k, params.minimizer_size, device=device)
                repartition = mz.build_repartition(
                    sampled_freq, world,
                    frequency_aware=params.minimizer_type == 1)
            sampled_freq, repartition = ranks.broadcast(
                (sampled_freq, repartition))
        progress.log(
            f"[dsk_tpu_torch] superkmer routing: m={params.minimizer_size}, "
            f"frequency-balanced repartition over {world} ranks", 2
        )
    # each rank counts its share of the input
    count_bank = shard_bank(bank, ranks.rank, world) if world > 1 else bank
    progress.log(
        f"[dsk_tpu_torch] counting k={k} over {bank.nb_banks} bank(s): "
        f"{params.file} (~{plan.est_bases} bases, {plan.n_passes} pass(es), "
        f"~{plan.est_distinct} distinct kmers expected, "
        f"device={device}"
        + (f", {world} ranks" if world > 1 else "")
        + (f", spill over {params.spill_partitions or plan.n_partitions} "
           f"partitions" if plan.spill else "") + ")"
    )
    prefix_early = params.out_prefix()
    # across ranks the partition files need one directory that every rank
    # sees: -out-tmp, else the output's (a host's temp directory is its own)
    spill_dir = params.out_tmp
    if spill_dir is None and world > 1:
        spill_dir = os.path.dirname(os.path.abspath(prefix_early))

    def batch_progress(n_batches, n_bases, n_reads):
        progress.log(
            f"[dsk_tpu_torch] loop through reads: {n_reads} reads, "
            f"{n_bases} bases ({n_batches} batches)", 2
        )

    n_workers = params.nb_cores
    if n_workers <= 0:
        n_workers = min(int(limits.get("nb_cores", 1)), 8)

    stream_out = params.storage_type == "hdf5"
    h5_path = (
        params.solid_kmers_out or (prefix_early + ".h5")
        if stream_out else None
    )
    n_passes = plan.n_passes
    wire = params.wire
    send_slack = params.send_slack
    compact_segments = None  # auto; a TableOverflow retry goes monolithic
    resume_snapshot = None
    auto_resume = False
    store = None
    n_solid_stream = 0
    # the per-bank sink folds each pass's histo2D contribution in (the
    # matrix is additive over k-mers); reset whenever the store restarts
    histo2d_mat = np.zeros((params.histo_max + 2, 11), np.int64)
    # a pass checkpoint keeps neither the done passes' histo2D
    # contributions nor their non-solid k-mers: recount instead
    can_resume_passes = not (need_per_bank and params.histo2d)
    attempt = 0
    kind = params.solidity_kind if params.solidity_custom is None else "custom"
    custom_vec = params.custom_vector(bank.nb_banks) if need_per_bank else None
    sckpt_reuse = params.resume
    flush_ms = None
    while True:
        spill_parts = 0
        if plan.spill:
            spill_parts = params.spill_partitions or plan.n_partitions
        with spans.span("engine.build"):
            engine = DistCountEngine(
                k,
                device=device,
                batch_rows=plan.batch_rows,
                row_len=plan.row_len,
                table_cap=plan.table_cap,
                buf_batches=plan.buf_batches,
                nb_bins=params.histo_max,
                n_passes=n_passes,
                per_bank=need_per_bank,
                flush_buckets=params.flush_buckets,
                wire=wire,
                spill_partitions=spill_parts,
                spill_dir=spill_dir,
                ranks=ranks,
                send_slack=send_slack,
                compact_segments=compact_segments,
                routing=routing,
                minimizer_size=params.minimizer_size,
                repartition=repartition,
            )
        if params.trace_dir:
            # the flush pieces' CUDA events, read after the stream's last
            # overflow check has waited for them
            engine.flush_log = _RouteLog(engine.device,
                                         _RouteLog.FLUSH_PIECES)
        ckpt = None
        done_passes = None
        on_pass = None
        # mid-pass spill checkpoint: the fill's bucket files are durable,
        # so a crashed spill run resumes from the last counted partition
        # without reading the input again.  Its fingerprint covers
        # n_passes, so a pass-doubling retry invalidates it.
        sckpt = None
        if engine.spill and params.checkpoint:
            # across ranks rank 0 opens (and may clear) the directory
            # before the other ranks open it
            if root:
                sckpt = _open_spill_checkpoint(
                    params, prefix_early, n_passes,
                    reuse=sckpt_reuse or auto_resume, world=world,
                )
            if world > 1:
                ranks.broadcast(None)
                if not root:
                    sckpt = _open_spill_checkpoint(
                        params, prefix_early, n_passes, reuse=True,
                        world=world)
            sckpt_reuse = True  # this run's own retries keep its fills
        if n_passes > 1 and params.checkpoint and root:
            from dsk_tpu_torch.engine.checkpoint import PassCheckpoint

            ckpt = PassCheckpoint(prefix_early + ".ckpt.h5", params, n_passes)
            if (params.resume or auto_resume) and can_resume_passes:
                done_passes = ckpt.load()
                if done_passes:
                    progress.log(
                        f"[dsk_tpu_torch] resuming: passes "
                        f"{sorted(done_passes)} loaded from checkpoint"
                    )

        pass_sink = None
        if stream_out and root:
            os.makedirs(
                os.path.dirname(os.path.abspath(h5_path)), exist_ok=True
            )
            # mid-pass spill resume: the latest count mark's store sizes
            # are cumulative (done passes' rows are a prefix), so aligning
            # the store to them keeps the crashed pass's counted
            # partitions, which the engine's restored work queue skips.
            # Only sound when every earlier pass is loaded from the pass
            # checkpoint; else the engine recounts them on top.
            spill_aligned = False
            if (store is None and sckpt is not None and params.resume
                    and os.path.exists(h5_path)):
                latest = sckpt.latest_count()
                mark_pass, extra = latest if latest else (None, None)
                covered = mark_pass == 0 or (
                    mark_pass is not None
                    and done_passes is not None
                    and all(q in done_passes for q in range(mark_pass))
                )
                if covered and extra is not None and "store_pids" in extra:
                    store = OutputStore(h5_path, "a")
                    store._compress = params.out_compress
                    store.truncate_partitions({
                        int(a): int(b) for a, b in zip(
                            extra["store_pids"], extra["store_sizes"])
                    })
                    n_solid_stream = int(extra["n_solid"])
                    if "histo2d" in extra:
                        histo2d_mat[:] = extra["histo2d"]
                    spill_aligned = True
            # a resumed run reopens the store and drops writes past the
            # last completed pass (recorded in its checkpoint)
            if store is None and done_passes and os.path.exists(h5_path):
                sizes = done_passes[max(done_passes)].info.get("store_sizes")
                if sizes is not None:
                    store = OutputStore(h5_path, "a")
                    store._compress = params.out_compress
                    store.truncate_partitions(
                        {int(a): int(b) for a, b in sizes.items()}
                    )
                    n_solid_stream = sum(int(v) for v in sizes.values())
                else:
                    done_passes = None
            elif store is None and done_passes:
                done_passes = None  # no store on disk: nothing to resume
            if not spill_aligned and sckpt is not None and store is not None:
                # the store sits at a pass boundary, which may lie below a
                # mid-pass mark's sizes: drop the marks (fills stay valid)
                sckpt.clear_counts()
            if store is None:
                store = OutputStore.create(
                    h5_path, k, compress=params.out_compress
                )
                n_solid_stream = 0
                histo2d_mat[:] = 0  # store restarted: drop partial sums
                if sckpt is not None:
                    sckpt.clear_counts()  # marks refer to dropped rows

            if need_per_bank:

                def pass_sink(pass_id, pid, kk, cc, bmat):
                    nonlocal n_solid_stream
                    m = processors.solidity_mask(
                        cc, kind, params.abundance_min, params.abundance_max,
                        bank_counts=bmat, custom=custom_vec,
                    )
                    store.append_solid_partition(pid, kk[m], cc[m])
                    n_solid_stream += int(m.sum())
                    if params.histo2d and bmat.shape[0]:
                        with spans.span("finish.histo2d"):
                            histo2d_mat[:] += processors.histo2d_matrix(
                                bmat, params.histo_max
                            )
            else:

                def pass_sink(pass_id, pid, kk, cc):
                    nonlocal n_solid_stream
                    m = processors.solidity_mask(
                        cc, kind, params.abundance_min, params.abundance_max
                    )
                    store.append_solid_partition(pid, kk[m], cc[m])
                    n_solid_stream += int(m.sum())

            if sckpt is not None:
                # each count mark snapshots the store so that a resume
                # can truncate writes past the mark

                def _spill_extra():
                    store._f.flush()
                    szs = store.partition_sizes()
                    extra = {
                        "n_solid": n_solid_stream,
                        "store_pids": np.array(sorted(szs), np.int64),
                        "store_sizes": np.array(
                            [szs[i] for i in sorted(szs)], np.int64
                        ),
                    }
                    if need_per_bank and params.histo2d:
                        extra["histo2d"] = histo2d_mat.copy()
                    return extra

                sckpt.collect_extra = _spill_extra
        elif stream_out:
            # the engine hands every rank's partitions to rank 0's sink:
            # the other ranks' sink is never called

            def pass_sink(*_args):
                raise RuntimeError("the sink runs on rank 0 only")

        if ranks is not None:
            # rank 0 decided what the store and the checkpoint keep
            done_passes = ranks.broadcast(done_passes)

        if ckpt is not None:

            def on_pass(p, res, _c=ckpt, _n=n_passes):
                if stream_out:
                    store._f.flush()
                    res.info["store_sizes"] = {
                        str(pk): pv
                        for pk, pv in store.partition_sizes().items()
                    }
                _c.save_pass(p, res)
                nd = res.info.get("n_distinct_device", res.n_distinct)
                progress.log(f"[dsk_tpu_torch] pass {p + 1}/{_n} done "
                             f"({nd} distinct kmers), checkpointed")

        try:
            sink = (
                {"pass_sink_per_bank" if need_per_bank else "pass_sink":
                 pass_sink}
                if pass_sink is not None else {}
            )
            if sckpt is not None:
                sink["spill_ckpt"] = sckpt
            with spans.span("count"):
                result = engine.count(
                    count_bank,
                    per_bank=need_per_bank,
                    n_passes=n_passes,
                    cache_dir=params.out_tmp,
                    done_passes=done_passes,
                    on_pass=on_pass,
                    progress_cb=batch_progress,
                    n_workers=n_workers,
                    max_disk_mb=params.max_disk,
                    resume_state=resume_snapshot,
                    **sink,
                )
            if engine.flush_log is not None:
                engine.flush_log.settle()
                flush_ms = {p: round(sum(v), 3)
                            for p, v in engine.flush_log.ms.items() if v}
            break
        except WireOverflow as e:
            spans.count("run.retries.wire")
            attempt += 1
            if params.wire == "exc":
                raise WireOverflow(
                    f"{e} — input needs the bitmap wire format but "
                    f"-wire exc was pinned; drop the pin or pass "
                    f"-wire bitmap"
                ) from e
            if attempt > params.max_retries:
                raise
            # the wire format changes neither the pass hash nor the table
            # geometry: counted work survives the rebuild
            wire = "bitmap"
            resume_snapshot, auto_resume, store, preserved = (
                _preserve_retry_work(engine, n_passes, ckpt, store, h5_path))
            progress.log(
                f"[dsk_tpu_torch] {e}; retrying with wire=bitmap" + preserved
            )
        except RoutingOverflow as e:
            # raised on every rank at the same group; more slack keeps the
            # pass hash and the tables, so counted work survives too
            spans.count("run.retries.route")
            attempt += 1
            if attempt > params.max_retries:
                raise
            send_slack *= 2.0
            resume_snapshot, auto_resume, store, preserved = (
                _preserve_retry_work(engine, n_passes, ckpt, store, h5_path))
            progress.log(
                f"[dsk_tpu_torch] {e}; retrying with send_slack="
                f"{send_slack}" + preserved
            )
        except (TableOverflow, SpillDiskOverflow) as e:
            # twice the passes halve the per-pass distinct count, the
            # per-pass volume (CountVolumeOverflow) and the per-pass spill
            # (SpillDiskOverflow: the reference's n_iters = ceil(v*b/D),
            # doc/paper.tex:66); the pass hash changes, so counted work
            # is dropped.  A plain TableOverflow may be heads lost to a
            # two-stage segment's slack, which more passes need not cure:
            # the retry also compacts monolithically, as the reference's
            what = (
                "spill disk" if isinstance(e, SpillDiskOverflow)
                else "volume" if isinstance(e, CountVolumeOverflow)
                else "table"
            )
            spans.count("run.retries." + what.replace(" ", "_"))
            attempt += 1
            store = _drop_partial_store(store, h5_path, ckpt)
            resume_snapshot = None
            auto_resume = False
            if attempt > params.max_retries:
                raise
            n_passes *= 2
            plan.n_passes = n_passes
            monolithic = what == "table"
            if monolithic:
                compact_segments = 0
            progress.log(
                f"[dsk_tpu_torch] {e}; {what} overflow, retrying with "
                f"n_passes={n_passes}"
                + (", monolithic compaction" if monolithic else "")
            )
    if ckpt is not None:
        ckpt.remove()
    if sckpt is not None:
        if world > 1:
            ranks.broadcast(None)  # every rank is done with the directory
        if root:
            sckpt.remove()

    if stream_out:
        n_solid = n_solid_stream
        if ranks is not None:
            n_solid = ranks.broadcast(n_solid)  # rank 0's sink counted
        n_distinct = int(result.histogram[1:].sum())
    else:
        with spans.span("finish.solidity"):
            custom = params.custom_vector(bank.nb_banks)
            solid_mask = processors.solidity_mask(
                result.counts,
                params.solidity_kind if custom is None else "custom",
                params.abundance_min,
                params.abundance_max,
                bank_counts=result.bank_counts,
                custom=custom,
            )
            # each rank's result holds its own partition
            n_solid, n_distinct = (int(solid_mask.sum()), result.n_distinct)
            if ranks is not None:
                n_solid, n_distinct = (
                    int(x) for x in ranks.host_sum([n_solid, n_distinct]))
    progress.log(
        f"[dsk_tpu_torch] {n_distinct} distinct kmers, {n_solid} solid "
        f"(abundance in [{params.abundance_min}, {params.abundance_max}])"
    )

    repartition_stats = None
    if minimizers:
        # minimizer repartition statistics in the run info; when superkmer
        # routing ran, its sampled table is reused
        from dsk_tpu_torch.kmer import minimizer as mz

        with spans.span("repartition"):
            if root:
                freq = (sampled_freq if sampled_freq is not None
                        else mz.sample_minimizer_frequencies(
                            bank, k, params.minimizer_size, device=device))
                table = (repartition if repartition is not None
                         else mz.build_repartition(
                             freq, max(result.info.get("n_chips", 1), 1),
                             frequency_aware=params.minimizer_type == 1))
                repartition_stats = _repartition_stats(
                    freq, table, params.minimizer_size)
            if ranks is not None:
                repartition_stats = ranks.broadcast(repartition_stats)

    prefix = params.out_prefix()
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    with spans.span("write"):
        info = {
            "kmer_size": k,
            "abundance_min": params.abundance_min,
            "abundance_max": params.abundance_max,
            "solidity_kind": params.solidity_kind,
            "input": params.file,
            "nb_banks": bank.nb_banks,
            "nb_distinct_kmers": n_distinct,
            "nb_solid_kmers": n_solid,
            "config": plan.as_properties(),
            "system": limits,
            **result.info,
        }
        if repartition_stats:
            info["repartition"] = repartition_stats
        if flush_ms is not None:
            info["flush"] = flush_ms
        if stream_out and root:
            store.write_histogram(result.histogram)
    info["time"] = _phase_times(spans.current())
    if stream_out and root:
        with spans.span("store.close"):
            # the store keeps the run's record as it is now
            info["trace"] = spans.current().summary()
            store.set_run_info(info)
            store.close()

    histo_path = None
    if params.histo:
        histo_path = prefix + ".histo"
        if root:
            with spans.span("finish.histo"), open(histo_path, "w") as f:
                store_text.write_histo(result.histogram, f)
        progress.log(f"[dsk_tpu_torch] histogram -> {histo_path}")

    histo2d_path = None
    if params.histo2d:
        with spans.span("finish.histo2d"):
            if stream_out and need_per_bank:
                mat = histo2d_mat  # accumulated by the per-bank sink
            elif result.bank_counts is None:
                raise ValueError(
                    "-histo2D needs >= 2 input banks (assembly first, then "
                    "reads)"
                )
            else:
                mat = processors.histo2d_matrix(
                    result.bank_counts, params.histo_max
                )
                if ranks is not None:
                    mat = ranks.host_sum(mat)  # additive over k-mers
            histo2d_path = prefix + ".histo2D"
            if root:
                with open(histo2d_path, "w") as f:
                    store_text.write_histo2d(mat, f)
        progress.log(f"[dsk_tpu_torch] histo2D matrix -> {histo2d_path}")

    if h5_path is not None:
        progress.log(f"[dsk_tpu_torch] output -> {h5_path}")
    return RunOutput(
        params=params,
        result=result,
        h5_path=h5_path,
        n_solid=n_solid,
        histo_path=histo_path,
        histo2d_path=histo2d_path,
        info=info,
    )
