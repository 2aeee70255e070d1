"""Smoke test of the PyTorch/CUDA port (dsk_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each (any failure exits non-zero and prints no result):
  1. device   CUDA is required; print the card's name and power limit
              (nvidia-smi) and whether h5py and the native reader exist.
  2. build    build the CUDA kernel libraries from dsk_tpu_torch/csrc,
              one nvcc per source, all started together.
  3. kernels  each kernel against its plain PyTorch version on the card,
              bit for bit, at the test shapes and the real shape; time
              both at the real shape.  The codes-input extraction kernel
              (extract_canonical_planes) on 25 cases and 48 of short rows
              (L from k to k + 40 and L = 62, row counts no multiple of
              the rows a block takes), timed at a 2048 x 1024 batch (k=31
              and 63) and at the superkmer owner's former (1,569,659, 62)
              codes; the fused wire
              kernel (extract_wire_planes) on both wires x k in {1, 15,
              16, 17, 31, 32, 33, 63, 64, 65, 127} x n_passes 1 and 3
              with every pass_id, rows with dead tails, dead rows, exactly
              E invalid bases and invalid bases on both sides of its tile
              boundary, L = 300, a short group whose later buffer columns
              must stay untouched, and whole 32 x 2048 x 1024 groups at
              k=31 (both wires) and k=63, timed per group.
  4. golden   dsk counts of the tests/data fixtures through
              dsk_tpu_torch.engine.run.execute on CUDA: k27.histo (single
              gz and the c1-c4 list), readN.histo, short.parse_results,
              byte for byte, and a 3-pass count whose .histo equals the
              fixture and whose table equals a 1-pass count's.  Without
              h5py the store is skipped (storage_type="none") and the
              short.parse_results lines are formatted here from the
              returned table.
  5. real     a 134-Mbase stream (k=31, 64 batches of 2048 x 1024 bases
              from a 1-Mbase genome, numpy seed 0; 32-batch flush groups,
              table_cap 1,572,864) through the engine's count_stream;
              histogram and sorted table against a numpy count made here.
              The stream must launch the fused kernel once per flush group
              and the codes-input kernel never.  Then the same batches as
              a 3-pass count (count_stream(pass_id=p), p = 0..2): the
              merged pass tables and histograms against the same count.
  6. sortstage  both bitonic-stage probe kernels (kmer/sortstage.py:
              `bitonic_stages`, register-resident stage groups, and
              `bitonic_stages_smem`, the first port) against the plain
              version, bit for bit: 1 and 2 tiles of full-range words, a
              ties case, keys >= 2^31, torch.uint32 words and 256 tiles;
              then the probe's path at 256 tiles (16.8M elements): the two
              kernels timed in turns (smem, reg, reg, smem; mean of 50
              launches each), the plain version timed 3 times, torch.sort
              of the same keys as a yardstick, the max active clusters of
              each kernel and the bound's parts.

  7. per-bank  per-bank counting (the bank plane, WK = W + 1), after
              a check that phases 3-6 launched no bank-plane kernel:
              (a) the fused kernel with bank ids against its plain version,
              bit for bit: both wires x k in {15, 31, 32, 33, 63, 127} x
              n_passes 1 and 3 with every pass_id, banks that change inside
              a batch, dead rows; whole 32 x 2048 x 1024 groups at k=31 and
              63, the per-bank and the W-plane kernels timed in turns;
              (b) c1..c4 at k=27 through execute on CUDA with every
              solidity kind (sum, min, max, one, all, custom 1,0,1,0):
              .histo == k27.histo, bank_counts and the solid k-mers ==
              the port's oracle (dsk_tpu_torch/oracle.py); -histo2D on
              c1,c2 == histo2d_matrix of the oracle's vectors;
              (c) a genome against its reads: a 4,194,304-base random
              genome (numpy seed 0) as bank 0 in 1024-base rows that
              overlap by k-1, and 134,217,728 bases of 1024-base reads
              sampled from it as banks 1-3, in 2048-row batches (a batch
              holds the end of one bank and the start of the next), 32-batch
              groups, k=31, table_cap 33,554,432: the device table, the
              sink's grouped output (bank_counts, totals, histogram) and
              the histo2D matrix against a numpy count of (k-mer, bank)
              pairs; one fused launch with bank ids a group and no
              codes-input launch; Mbases/s, t_sub, the host grouping and
              sink times; the flush split (fill, sort, compaction, fold;
              CUDA events) at WK=3 against W=2 on the same groups, in
              turns; the peak device bytes per buffer row of an 8-batch
              flush at WK=3 and W=2 against the planner's charge; then the
              same batches as a 3-pass count, each pass finalized, merged
              against the same numpy count.
  8. spill    host partition spill (the engine's fill/count loop):
              (a) through execute on CUDA: read50x_ref10K_e001 at k=27 with
              -spill on -spill-partitions 4 (.histo == k27.histo, table ==
              the table mode's); one partition over the planner's least
              table (-max-memory 1), which must split (spill_splits > 0),
              same checks; -spill auto over a 1 MB budget, which must pick
              spill from the wire rates it measures, with -out-tmp and
              -max-disk (left empty); c1..c4 with -spill on,
              -solidity-kind min and -histo2D against the port's oracle;
              (b) an error-rich stream, bench.py's make_error_batches recipe
              in numpy (64 batches of 2048 x 1024 bases sampled from the
              1-Mbase genome, numpy seed 0, 1% substitutions), k=31,
              32-batch groups, 16 partitions, table_cap 4,194,304, through
              count_stream_spilled: table and histogram against a numpy
              count, one fused launch a flush group and no codes-input
              launch; in turns with the same batches counted in table mode
              with the 2 passes its ~36M distinct k-mers need; the fill's
              rate and t_sub, spill_rows and spill_mb, the drain's MB/s,
              the count phase's time and per-partition merge time, splits;
              (c) the planner's wire rates measured on the card and the
              plan plan_resources(spill="auto") picks for (b)'s input.
  9. routed   counting across GPUs, the hash-routed table mode
              (dist/engine.py `_route_step`, dist/multihost.py):
              (a) 4 simulated ranks on the one card at real size: phase
              5's 64 batches, then 8(b)'s error-rich stream, dealt
              round-robin to 4 ranks; each rank is a thread running its
              own routed engine's count_stream in 8-batch groups (bitmap
              wire, table_cap 393,216 and 12,582,912 a rank), so the
              engine's `_route_step` runs as it does across GPUs: the fused
              kernel fills a group, the step dedups it, hashes its
              distinct rows to their owners, exchanges the counts, agrees
              the capacity, sorts by owner, builds the int32 records,
              exchanges them and folds what it received.  The collectives
              are tests/torch_loopback.py's (threads that meet at a
              barrier, do all_to_all_single's slicing and take turns on
              the card).  Every rank's table against the numpy count of
              phases 5 and 8(b) restricted to kmer_hash % 4 == r, every
              rank's all-reduced histogram against theirs; one fused
              launch a rank-group; the step's own CUDA-event times of
              each piece a rank runs alone (dedup, owners, owner sort,
              records, fold) and the rows a rank sends the others, per
              group and rank;
              (b) a one-rank NCCL process group from a TCPStore on
              localhost: execute through the routed path on the k27
              fixture (.histo == k27.histo) and c1..c4 with every solidity
              kind and -histo2D against the oracle (-storage-type none),
              phase 5's batches through the routed engine against phase
              5's count, and the times of NCCL all_to_all_single (a
              group's records, the counts) and all_reduce (the
              histogram).
  10. superkmer  minimizers and superkmer routing (kmer/minimizer.py,
              dist/engine.py `_route_step_sk`): (a) every ported minimizer
              function on the card against the same on the CPU, bit for
              bit, on 76 cases (k in {15, 21, 31, 63} x m in {8, 10, 16} x
              max_span in {1, 32, 127} on random rows, rows of k + 2
              bases, rows with no valid base; a 2048 x 1024 batch) and
              unpack_records_to_rows, timed at the batch; (b) phase 9(a)'s
              4 simulated ranks and streams routing by superkmer (m=10,
              max_span 32, a frequency-aware minimizer -> rank table
              sampled from the stream's first batch): the sender unpacks
              the group's bitmap wire, builds the records, exchanges them;
              the owner scans the received spans for its offsets and runs
              the records-input extraction kernel (extract_record_planes),
              which writes the live windows compacted, then flushes them.
              The rank tables
              against numpy's count restricted to the k-mers whose
              minimizer (the port's plain functions on the card) the table
              maps to r, so they are disjoint and their union is the
              count; the histograms against numpy's; one records-input
              launch a rank-group and no fused or codes-input launch; each
              piece's CUDA-event time per group and rank, the records and
              bytes a rank sends the others beside 9(a)'s hash route; one
              rank-group through `_route_step_sk` with its peers mirrored:
              the sender's and the whole step's peak device bytes against
              the planner's charges, and the records-input kernel on the
              records the step received against its plain version, bit
              for bit (one pass, every pass of 3 with its count pass, the
              bank plane), both timed, with its bound there, in turns with the
              composition it replaced (torch unpack to (R, SKL) codes, the
              codes-input kernel, mask compaction), whose two parts are
              also timed alone; (c) execute on CUDA with
              -minimizer-type 1 and -trace-dir on the k27 fixture
              (-storage-type none): .histo == k27.histo, the repartition
              run info == the port's CPU run's, a trace that names the
              fused kernel.
  11. spill-ranks  spill mode across ranks (dist/engine.py
              `_count_spilled` / `count_stream_spilled` with ranks):
              (a) 8(b)'s error-rich stream dealt round-robin to 4
              simulated ranks (phase 9(a)'s loopback), each rank's own
              engine's count_stream_spilled in 32-batch groups, 16
              partitions, table_cap 4,194,304, every rank's files in one
              directory: each rank's counted partitions against 8(b)'s
              numpy count restricted to kmer_hash % 16 % 4 == r, every
              histogram against numpy's; one fused launch a rank-group,
              no codes-input or records-input launch; in turns with 8(b)'s
              one-rank spill (one, ranks, ranks, one), each rank's fill
              and count times, the fill's agreements' and the rounds'
              wait, its partitions, spilled rows and MB; then once at
              table_cap 524,288, where partitions must split, with a sink
              on rank 0 that every partition reaches through the rounds'
              gathers: the sink's table against numpy's, and the directory
              must be left empty; (b) a one-rank NCCL process group
              through execute with -spill on on the k27 fixture
              (-storage-type none): .histo == k27.histo.
  12. buckets  key-space buckets of the flush (flush_buckets > 1) and
              -max-disk as one budget for all ranks: (a) phase 5's stream
              at S=8 (capb 196,608) with bucketize_at "flush" and
              "route", in turns with S=1 (S=1, flush, route, route,
              flush, S=1): every table against numpy's count, checked
              slot by slot (each bucket's live rows first, each of its
              bucket by the top 3 bits of its hash, ascending) and as the
              sink gathers it (bucket-major); 2 fused launches a stream,
              no codes-input launch; the flush's pieces (the rows each
              bucket takes, sort, compaction, fold, relayout) from the
              engine's own flush_log (CUDA events); the peak device bytes
              a buffer row of an 8-batch flush of each, against the
              planner's charge; (b) 9(a)'s 4 simulated ranks on phase 5's
              stream, hash route, S=8: every rank's table against numpy's
              share, bucket-major; (c) execute -flush-buckets 8
              -storage-type none on the k27 fixture: .histo == k27.histo;
              (d) 8(b)'s error-rich stream written as one FASTA, the whole
              of it on rank 0 of 4 simulated ranks (the others an empty
              bank), count(max_disk_mb=600): rank 0 spills more than a
              quarter of the 450 MB spill budget and less than all of it,
              in one pass (a SpillDiskOverflow fails the phase); every
              rank's partitions against numpy's.

Each phase that drives a path sets the launch counts to 0 just before it
and reads them just after; launches made to compare a kernel with its
plain version are not counted.  The codes-input extraction kernel runs
on no main path (phases 4, 5, 7, 8, 9, 10, 11 and 12 require 0 launches
of it);
its entry in the JSON line carries its launches in 10(b)'s path runs
(0, the path it left), the launches that time it in phase 3 under
"entry_path_launches", and its times and bound at the real batch shape,
and at the owner's former shape under "at_owner_shape".  The
records-input kernel runs on the superkmer path only; its entry carries
its launches in phase 10(b), its max |kernel - plain| and its time, plain
time and bound on the records of `step_peaks`.
Bounds in the kernels' JSON line: the larger of the bytes each input is
read and each output written once over 3.35 TB/s (NVIDIA's data sheet, 700
W part)
and the integer operations over the card's rates for them, from the
maximum SM clock (nvidia-smi clocks.max.sm): Hopper runs 32-bit integer
compare, logic, shift and add on 64 lanes a clock per SM (16 per SM
partition), and issues one warp instruction a clock per partition (128
lanes a clock per SM); a select may also issue on the FP32 pipe (FSEL),
so selects are held only by the issue rate.  The operations floor is the
larger of the ALU operations over the ALU rate and all of them over the
issue rate (`ops_ms`).  Phase 1 prints both rates beside the 67 T/s the
data sheet gives for FP32 (an FMA counted as two operations).  Times are
CUDA events around a run of launches, except the `ms` of the codes-input
and records-input kernels: their device time a launch, with the launches
queued behind a spinning kernel (`device_ms`), since a run of launches of
a 20-microsecond kernel times the host's enqueue.

Then it prints the kernels' JSON line, the card line, and last
{"ok": true, "device": {...}}.  It imports only dsk_tpu_torch: nothing of
JAX and nothing of the JAX package directly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
# bench.py's main geometry: k, batch rows x bases, batches, flush group,
# table capacity, genome size
K_REAL, ROWS, ROW_LEN, N_BATCHES = 31, 2048, 1024, 64
G_REAL, CAP_REAL, GENOME = 32, 1_572_864, 1 << 20
DEVICE = "cuda"
SS_TILES = 256  # the probe's size: 256 tiles of 65,536 elements
WIRE_KS = (1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127)
WIRE_PASSES = ((1, 0), (3, 0), (3, 1), (3, 2))
WIRE_E = 16      # exc wire slots (io/packed.py EXC_E)
WTILE = 1024     # windows per block of the fused kernel (csrc/extract.cu)
GUARD = 0x12345678  # buffer columns past a group: must survive the kernel
HBM_BYTES_PER_S = 3.35e12
FP32_PEAK_OPS_PER_S = 67e12  # the data sheet's published peak, not a bound
ALU_LANES_PER_SM = 64        # 32-bit integer ALU lanes a clock per SM (4 x 16)
ISSUE_LANES_PER_SM = 128     # one warp instruction a clock per partition
SMEM_BYTES_PER_CLOCK = 128   # shared memory per SM
SENTINEL = 0xFFFFFFFF        # a dead row's word (kmer/layout.py)
M_SK, SPAN_SK = 10, 32  # 10: minimizer size, windows a record at most
OWNER_RECORDS = 1_569_659  # 10(b): the records a rank-group's owner takes


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


SPIN_CYCLES = 200_000_000  # device_ms: ~0.1 s of a spinning kernel


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls queued behind a spinning
    kernel (torch.cuda._sleep): the host enqueues every launch while the
    card spins, so the CUDA events around them time the launches back to
    back, without the gaps that a run of short kernels also times when the
    host enqueues slower than the card runs them.  Raises if the card ran
    dry before the last launch was queued."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if torch.cuda.current_stream().query():
        raise AssertionError("device_ms: the card finished the spin before "
                             "the launches were queued")
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"sms": sms, "clock_max_mhz": clock_mhz,
             "alu_ops_per_s": sms * ALU_LANES_PER_SM * clock_mhz * 1e6,
             "issue_ops_per_s": sms * ISSUE_LANES_PER_SM * clock_mhz * 1e6,
             "smem_bytes_per_s": sms * SMEM_BYTES_PER_CLOCK * clock_mhz * 1e6}
    try:
        import h5py  # noqa: F401

        has_h5py = True
    except ImportError:
        has_h5py = False
    from dsk_tpu_torch.io import native_reader_available

    log(f"[1 device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | h5py {'yes' if has_h5py else 'MISSING'} "
        f"| native reader {'yes' if native_reader_available() else 'MISSING'}"
        f" | {sms} SMs, max SM clock {clock_mhz:.0f} MHz: integer ALU "
        f"{rates['alu_ops_per_s'] / 1e12:.2f} T/s, issue "
        f"{rates['issue_ops_per_s'] / 1e12:.2f} T/s (the data sheet's FP32 "
        f"peak {FP32_PEAK_OPS_PER_S / 1e12:.0f} T/s)")
    return card, has_h5py, rates


def phase_build():
    from dsk_tpu_torch.kmer import cuda_kernels as ck
    from dsk_tpu_torch.utils.build import BUILD_LOGS

    t0 = time.perf_counter()
    ck.build()
    regs = [line.split("info    : ")[-1] for log_ in BUILD_LOGS.values()
            for line in log_.splitlines() if "registers" in line]
    log(f"[2 build] "
        + ", ".join(os.path.relpath(ck.library_path(s), ROOT)
                    for s in ck.SOURCES)
        + f" in {time.perf_counter() - t0:.2f} s (nvcc "
        f"{' '.join(ck.ARCH_FLAGS)}; ptxas: {'; '.join(regs)})")


def kernel_cases(rng):
    """The cases of tests/test_torch_device.py plus the real batch shape,
    then short rows, as the superkmer owner's: L from k to k + 40 and L =
    62, in row counts that are no multiple of the rows a block takes."""
    def rand(B, L, bad=0.0):
        b = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
        if bad:
            b[rng.random((B, L)) < bad] = 4
        return b

    cases = [(k, rand(8, 256)) for k in (15, 16, 21, 27, 31, 32, 33, 63, 64, 65)]
    cases += [(k, rand(8, 256, 0.05)) for k in (21, 31, 33, 63)]
    cases += [(31, rand(4, L, 0.02)) for L in (128, 256, 1024)]
    special = np.concatenate([
        np.full((1, 128), 3, np.uint8),                      # G-run
        np.tile(np.array([0, 2], np.uint8), 64)[None, :],    # ATAT...
    ])
    cases += [(k, special) for k in (16, 32, 64)]
    cases += [(127, rand(4, 256, 0.01)), (127, special), (31, rand(3, 64))]
    cases += [(k, rand(ROWS, ROW_LEN)) for k in (31, 63)]
    n_old = len(cases)
    cases += [(K_REAL, rand(1001, L, 0.01)) for L in range(K_REAL,
                                                         K_REAL + 41)]
    cases += [(k, rand(3001, 62, 0.01)) for k in (15, 16, 17, 31, 33)]
    cases += [(127, rand(517, 127, 0.002)), (63, rand(299, 100, 0.01))]
    return cases, n_old


def owner_codes(rng, R: int = OWNER_RECORDS, k: int = K_REAL,
                max_span: int = SPAN_SK):
    """(R, max_span + k - 1) codes shaped as the superkmer owner's were
    before the records-input kernel: every base of a record's span valid,
    PAD past base span + k - 1, spans 1..max_span with a mean near the
    10.4 windows a record of phase 10(b)."""
    span = np.minimum(rng.geometric(1 / 10.4, R), max_span)
    b = rng.integers(0, 4, size=(R, max_span + k - 1)).astype(np.uint8)
    b[np.arange(max_span + k - 1)[None, :] >= span[:, None] + k - 1] = 0xFF
    return b


def phase_kernels(rates: dict):
    import torch

    from dsk_tpu_torch.kmer import cuda_kernels as ck

    rng = np.random.default_rng(1)
    cases, n_old = kernel_cases(rng)
    max_err = 0
    for k, b in cases:
        x = torch.from_numpy(b).cuda()
        p1, v1 = ck.extract_canonical_planes(x, k)
        p2, v2 = ck.extract_canonical_planes_torch(x, k)
        torch.cuda.synchronize()
        err = int((p1 - p2).abs().max().item()) if p1.numel() else 0
        max_err = max(max_err, err, int((v1 != v2).sum().item()))
        if err or not torch.equal(v1, v2):
            raise AssertionError(f"kernel != plain at k={k}, shape {b.shape}")
    times = {}
    # no main path runs it: the launches that time it, counted from here,
    # go to the JSON line as "entry_path_launches"
    ck.extract_canonical_planes.launches = 0
    for k in (31, 63):
        x = torch.from_numpy(rng.integers(0, 4, size=(ROWS, ROW_LEN))
                             .astype(np.uint8)).cuda()
        cuda_ms(lambda: ck.extract_canonical_planes(x, k), 50)  # warm-up
        times[k] = (
            device_ms(lambda: ck.extract_canonical_planes(x, k), 50),
            cuda_ms(lambda: ck.extract_canonical_planes_torch(x, k), 5),
            cuda_ms(lambda: ck.extract_canonical_planes(x, k), 50),
        )
    x = torch.from_numpy(owner_codes(rng)).cuda()
    p1, v1 = ck.extract_canonical_planes(x, K_REAL)
    p2, v2 = ck.extract_canonical_planes_torch(x, K_REAL)
    if not (torch.equal(p1, p2) and torch.equal(v1, v2)):
        raise AssertionError(f"kernel != plain at the owner's shape "
                             f"{tuple(x.shape)}")
    del p1, v1, p2, v2
    owner = {"ms": device_ms(lambda: ck.extract_canonical_planes(
                 x, K_REAL), 20),
             "event_ms": cuda_ms(lambda: ck.extract_canonical_planes(
                 x, K_REAL), 20),
             "plain_ms": cuda_ms(
                 lambda: ck.extract_canonical_planes_torch(x, K_REAL), 3),
             "shape": tuple(x.shape)}
    owner["bound_ms"], owner["bound_by"] = extract_bound(rates, *x.shape)
    del x
    torch.cuda.empty_cache()
    launches = ck.extract_canonical_planes.launches
    bound, by = extract_bound(rates)
    log(f"[3 kernels] extract_canonical_planes == plain on {len(cases)} "
        f"cases ({n_old} of earlier slices, {len(cases) - n_old} of short "
        f"rows; max |diff| {max_err}); at ({ROWS}, {ROW_LEN}): "
        + ", ".join(f"k={k} kernel {a:.4f} ms (a stream of launches "
                    f"{c:.4f} ms each) / plain {b:.4f} ms"
                    for k, (a, b, c) in times.items())
        + f"; k={K_REAL} bound {bound:.4f} ms by {by} ({bound / times[31][0]:.3f} "
        f"of it); at the superkmer owner's {owner['shape']}: kernel "
        f"{owner['ms']:.4f} ms (a stream {owner['event_ms']:.4f} ms) / plain "
        f"{owner['plain_ms']:.4f} ms, bound "
        f"{owner['bound_ms']:.4f} ms by {owner['bound_by']} "
        f"({owner['bound_ms'] / owner['ms']:.3f} of it); launches to time it "
        f"{launches} (kernels: device time a launch, "
        f"`device_ms`; streams and plain: CUDA events; {card_line()})")
    return max_err, times, launches, owner


def wire_rows(rng, B: int, L: int, dense: bool) -> np.ndarray:
    """(B, L) codes cycling through the fused kernel's row kinds: clean,
    a dead tail (live < L), all invalid (live 0), exactly WIRE_E invalid
    bases, and invalid bases on both sides of the kernel's tile boundary
    (window WTILE).  `dense` adds 30% N's (the bitmap wire's input)."""
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    for r in range(B):
        kind = r % 5
        if kind == 1:
            codes[r, rng.integers(1, L):] = 4
        elif kind == 2:
            codes[r] = 4
        elif kind == 3:
            codes[r, rng.choice(L - 1, size=WIRE_E, replace=False)] = 4
        elif kind == 4:
            at = WTILE if L > WTILE + 8 else L // 2
            codes[r, [at - 5, at - 1, at + 2, at + 6]] = 4
    if dense:
        codes[rng.random((B, L)) < 0.3] = 4
    return codes


def wire_group(batches, wire: str):
    """Pack (B, L) code batches to one flush group on the card, as the
    engine's feeder ships it: (words int32, meta int16 or int32)."""
    import torch

    from dsk_tpu_torch.io.packed import pack_codes, pack_codes_exc

    packed = [pack_codes_exc(b, WIRE_E) if wire == "exc" else pack_codes(b)
              for b in batches]
    words = np.stack([w for w, _ in packed]).view(np.int32)
    meta = np.stack([m for _, m in packed])
    meta = meta.view(np.int16 if wire == "exc" else np.int32)
    return torch.from_numpy(words).cuda(), torch.from_numpy(meta).cuda()


def wire_cases(rng):
    """(name, codes batches, wire, k, n_passes, pass_id, guard columns)."""
    cases = []
    for wire in ("exc", "bitmap"):
        dense = wire == "bitmap"
        for k in WIRE_KS:
            rows = [wire_rows(rng, 10, 300, dense) for _ in range(3)]
            cases += [(f"{wire} k={k} L=300 pass {p}/{n}", rows, wire, k, n,
                       p, 7) for n, p in WIRE_PASSES]
        for k in (1, 31, 127):
            rows = [wire_rows(rng, 5, WTILE + 276, dense)]
            cases.append((f"{wire} k={k} across the tile", rows, wire, k, 3,
                          1, 7))
        L, k, B = WTILE + 276, 31, 5
        m = B * (L - k + 1)
        rows = [wire_rows(rng, B, L, dense) for _ in range(2)]
        cases.append((f"{wire} short group 2 of 4", rows, wire, k, 1, 0,
                      2 * m))
    return cases


def real_group(rng, wire: str):
    """A whole flush group at the real shape: G_REAL batches of ROWS x
    ROW_LEN random bases, 0.1% N's (the bitmap wire's group 30%)."""
    rate = 0.3 if wire == "bitmap" else 0.001
    out = []
    for _ in range(G_REAL):
        b = rng.integers(0, 4, size=(ROWS, ROW_LEN)).astype(np.uint8)
        b[rng.random((ROWS, ROW_LEN)) < rate] = 4
        out.append(b)
    return out


def phase_wire_kernel(rates: dict):
    """The fused kernel against its plain version on every case, bit for
    bit, with the buffer's later columns untouched; timed per group at the
    real shape."""
    import torch

    from dsk_tpu_torch.kmer import cuda_kernels as ck
    from dsk_tpu_torch.kmer.codec import words_per_kmer

    rng = np.random.default_rng(3)
    cases = wire_cases(rng)
    for k in (31, 63):
        cases.append((f"exc k={k} real group", real_group(rng, "exc"), "exc",
                      k, 1, 0, 7))
    cases.append(("bitmap k=31 real group", real_group(rng, "bitmap"),
                  "bitmap", 31, 1, 0, 7))
    max_err = 0
    times = {}
    for name, rows, wire, k, n_passes, pass_id, extra in cases:
        words, meta = wire_group(rows, wire)
        n, B, L = len(rows), rows[0].shape[0], rows[0].shape[1]
        cols = n * B * (L - k + 1)
        got, want = (torch.full((words_per_kmer(k), cols + extra), GUARD,
                                dtype=torch.int64, device="cuda")
                     for _ in range(2))
        before = ck.extract_wire_planes.launches
        ck.extract_wire_planes(words, meta, wire, k, L, got, n_passes,
                               pass_id)
        ck.extract_wire_planes_torch(words, meta, wire, k, L, want, n_passes,
                                     pass_id)
        torch.cuda.synchronize()
        if ck.extract_wire_planes.launches != before + 1:
            raise AssertionError(f"wire kernel {name}: not one launch")
        err = int((got - want).abs().max().item())
        max_err = max(max_err, err)
        if err or not bool((got[:, cols:] == GUARD).all().item()):
            raise AssertionError(f"wire kernel != plain: {name}")
        if name.startswith("exc") and name.endswith("real group"):
            times[k] = (
                cuda_ms(lambda: ck.extract_wire_planes(
                    words, meta, wire, k, L, got), 20),
                cuda_ms(lambda: ck.extract_wire_planes_torch(
                    words, meta, wire, k, L, want), 2),
            )
        del got, want, words, meta
        torch.cuda.empty_cache()
    log(f"[3 kernels] extract_wire_planes == plain on {len(cases)} cases, "
        f"later buffer columns untouched (max |diff| {max_err}); per "
        f"{G_REAL}-batch group of ({ROWS}, {ROW_LEN}), exc wire: "
        + ", ".join(f"k={k} kernel {a:.4f} ms ({a / G_REAL:.5f} ms a batch, "
                    f"bound {wire_extract_bound(k, rates)[0]:.4f} ms) / "
                    f"plain "
                    f"{b:.4f} ms" for k, (a, b) in times.items()))
    return max_err, times


def _histo_equal(path: str, fixture: str, what: str) -> None:
    with open(path, "rb") as f, open(os.path.join(DATA, fixture), "rb") as g:
        if f.read() != g.read():
            raise AssertionError(f"{what}: .histo differs from {fixture}")


_LETTERS = np.frombuffer(b"ACTG", np.uint8)  # 2-bit codes A<C<T<G


def count_lines(kmers: np.ndarray, counts: np.ndarray, k: int) -> bytes:
    """'<KMER> <count>' lines of an (n, W) uint32 word table, in its
    order: word 0 holds the top k - 16(W-1) bases, the others 16 each."""
    W = kmers.shape[1]
    cols = []
    for w in range(W):
        nb = k - 16 * (W - 1) if w == 0 else 16
        for i in range(nb):
            cols.append((kmers[:, w] >> np.uint32(2 * (nb - 1 - i))) & 3)
    letters = _LETTERS[np.stack(cols, axis=1)]
    return b"".join(row.tobytes() + b" %d\n" % c
                    for row, c in zip(letters, counts))


def _same_table(a, b, what: str) -> None:
    if not (np.array_equal(a.kmers, b.kmers)
            and np.array_equal(a.counts, b.counts)):
        raise AssertionError(f"{what}: count tables differ")


def phase_golden(tmp: str, has_h5py: bool) -> list[str]:
    from dsk_tpu_torch.dist.engine import DistCountEngine
    from dsk_tpu_torch.engine.run import RunParams, execute

    storage = "hdf5" if has_h5py else "none"
    k27 = os.path.join(DATA, "read50x_ref10K_e001.fasta.gz")
    c14 = ",".join(os.path.join(DATA, f"c{i}.fasta.gz") for i in range(1, 5))
    done = []

    def run(name, file, k, **kw):
        return execute(RunParams(
            file=file, kmer_size=k, out=os.path.join(tmp, name),
            verbose=0, device=DEVICE, storage_type=storage, **kw,
        ))

    for name, file in (("k27", k27), ("c1-c4", c14)):
        out = run(name, file, 27, abundance_min=1, histo=True)
        _histo_equal(out.histo_path, "k27.histo", name)
        done.append(f"{name} k27.histo")
    out = run("readN", os.path.join(DATA, "readN.fasta"), 20, histo=True)
    _histo_equal(out.histo_path, "readN.histo", "readN")
    done.append("readN.histo")
    out = run("short", os.path.join(DATA, "shortread.fasta"), 15,
              abundance_min=1)
    if has_h5py:
        from dsk_tpu_torch.cli import dsk2ascii

        dump = os.path.join(tmp, "short.txt")
        if dsk2ascii.main(["-file", out.h5_path, "-out", dump,
                           "-verbose", "0"]) != 0:
            raise AssertionError("dsk2ascii failed on the port's store")
        with open(dump, "rb") as f:
            got = f.read()
    else:
        got = count_lines(*out.result.solid(1), 15)
    with open(os.path.join(DATA, "short.parse_results"), "rb") as f:
        if got != f.read():
            raise AssertionError("short.parse_results differs")
    done.append("short.parse_results")
    geom = dict(device=DEVICE, batch_rows=512, row_len=128, buf_batches=4,
                table_cap=1 << 16)
    one = DistCountEngine(27, n_passes=1, **dict(geom, table_cap=1 << 18)
                          ).count(k27)
    three = DistCountEngine(27, n_passes=3, **geom).count(k27, cache_dir=tmp)
    hist_path = os.path.join(tmp, "k27p3.histo")
    with open(hist_path, "w") as f:
        for a in range(1, three.histogram.shape[0]):
            f.write(f"{a}\t{int(three.histogram[a])}\n")
    _histo_equal(hist_path, "k27.histo", "3-pass k27")
    _same_table(three, one, "3-pass vs 1-pass k27")
    done.append("3-pass k27 .histo, table == 1-pass table")
    return done


def make_batches():
    """bench.py's main geometry: reads sampled from a random genome."""
    from dsk_tpu_torch.io import Batch

    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=GENOME, dtype=np.uint8)
    out = []
    for _ in range(N_BATCHES):
        starts = rng.integers(0, GENOME - ROW_LEN, size=ROWS)
        codes = genome[starts[:, None] + np.arange(ROW_LEN)[None, :]]
        out.append(Batch(codes=codes, bank_ids=np.zeros(ROWS, np.int32),
                         n_rows=ROWS, n_bases=int(codes.size), n_reads=ROWS))
    return out


def numpy_reference(batches):
    """Host count of the canonical k-mers (k <= 32) of every batch row:
    the 2-bit forward and reverse-complement values of each window
    (complement is code ^ 2 under A<C<T<G), their min, np.unique.
    Returns (values uint64, counts, n_valid)."""
    k, nw = K_REAL, ROW_LEN - K_REAL + 1
    vals = []
    for b in batches:
        codes = b.codes[: b.n_rows]
        c = codes.astype(np.uint64) & np.uint64(3)
        fwd = np.zeros((codes.shape[0], nw), np.uint64)
        rc = np.zeros_like(fwd)
        ok = np.ones(fwd.shape, bool)
        for j in range(k):
            cj = c[:, j: j + nw]
            fwd <<= np.uint64(2)
            fwd |= cj
            rc |= (cj ^ np.uint64(2)) << np.uint64(2 * j)
            ok &= codes[:, j: j + nw] < 4
        vals.append(np.minimum(fwd, rc)[ok])
    vals = np.concatenate(vals)
    uniq, counts = np.unique(vals, return_counts=True)
    return uniq, counts, int(vals.shape[0])


def phase_real():
    from dsk_tpu_torch.dist.engine import DistCountEngine
    from dsk_tpu_torch.engine.counter import merge_pass_results
    from dsk_tpu_torch.kmer import cuda_kernels as ck

    batches = make_batches()
    eng = DistCountEngine(K_REAL, device=DEVICE, batch_rows=ROWS,
                          row_len=ROW_LEN, buf_batches=G_REAL,
                          table_cap=CAP_REAL)
    eng.count_stream(iter(batches[:G_REAL]))  # warm-up: first-call costs
    ck.extract_wire_planes.launches = 0
    ck.extract_canonical_planes.launches = 0
    t0 = time.perf_counter()
    res = eng.count_stream(iter(batches))  # ends in a host read: drained
    wall = time.perf_counter() - t0
    launches = ck.extract_wire_planes.launches
    groups = -(-N_BATCHES // G_REAL)
    if launches != groups or ck.extract_canonical_planes.launches:
        raise AssertionError(
            f"the main path launched the fused kernel {launches} times "
            f"(want {groups}, one a flush group) and the codes-input "
            f"kernel {ck.extract_canonical_planes.launches} times (want 0)")
    n_bases = res.info["n_bases"]
    uniq, counts, n_valid = numpy_reference(batches)
    got = (res.kmers[:, 0].astype(np.uint64) << np.uint64(32)) | res.kmers[
        :, 1
    ].astype(np.uint64)
    if not (np.array_equal(got, uniq) and np.array_equal(res.counts, counts)):
        raise AssertionError("real-size table differs from the numpy count")
    hist = np.bincount(np.clip(counts, 1, 10000), minlength=10001)
    hist[0] = 0
    if not np.array_equal(res.histogram, hist):
        raise AssertionError("real-size histogram differs")
    a = np.arange(hist.shape[0])
    if int((a * res.histogram).sum()) != n_valid:
        raise AssertionError("sum(a * h[a]) != number of valid windows")
    rate = n_bases / wall / 1e6
    log(f"[5 real] {n_bases} bases, {uniq.shape[0]} distinct, table and "
        f"histogram == numpy; {rate:.2f} Mbases/s ({wall:.3f} s, "
        f"t_sub {res.info['t_sub']}); fused extract launches {launches}, "
        f"codes-input 0")

    # the same batches as a 3-pass count: the fused pass filter at width
    del eng, res
    eng3 = DistCountEngine(K_REAL, device=DEVICE, batch_rows=ROWS,
                           row_len=ROW_LEN, buf_batches=G_REAL,
                           table_cap=CAP_REAL, n_passes=3)
    ck.extract_wire_planes.launches = 0
    t0 = time.perf_counter()
    parts = [eng3.count_stream(iter(batches), pass_id=p) for p in range(3)]
    wall3 = time.perf_counter() - t0
    launches3 = ck.extract_wire_planes.launches
    merged = merge_pass_results(parts)
    got3 = (merged.kmers[:, 0].astype(np.uint64) << np.uint64(32)) | (
        merged.kmers[:, 1].astype(np.uint64))
    if not (np.array_equal(got3, uniq)
            and np.array_equal(merged.counts, counts)
            and np.array_equal(merged.histogram, hist)):
        raise AssertionError("3-pass count differs from the numpy count")
    if launches3 != 3 * groups:
        raise AssertionError(f"3-pass count: {launches3} fused launches")
    log(f"[5 real] 3-pass count of the same batches == numpy (pass tables "
        f"{', '.join(str(p.kmers.shape[0]) for p in parts)} distinct; "
        f"{3 * n_bases / wall3 / 1e6:.2f} Mbases/s streamed); fused "
        f"extract launches {launches3}")
    return launches, rate, (uniq, counts)


def extract_bound(rates: dict, B: int = ROWS, L: int = ROW_LEN,
                  k: int = K_REAL):
    """(ms, what) at a (B, L) shape, by default the real batch's (phase
    3 also takes the superkmer owner's (R, SKL)): the codes read once, the
    int64 planes and valid flags written once; the least operations the
    function needs from a code a byte, ~4W + 11 ALU operations and W
    selects a window (a rolling build of the W forward and the W
    reverse-complement words: a funnel shift a word and 3 to insert the
    base, each; the validity: test the code, track the last invalid base,
    test the window against it; 2 a word for the compare; 2 for the
    address).  The kernel packs its codes to 2-bit words first and builds
    each window from those, not from its k byte codes."""
    W, nw = (2 * k + 31) // 32, L - k + 1
    windows = B * nw
    nbytes = B * L + windows * (8 * W + 1)
    return _bound(nbytes, windows * (4 * W + 11), windows * W, rates)


def record_extract_bound(rates: dict, R: int, n_live: int, k: int = K_REAL,
                         max_span: int = SPAN_SK, bank: bool = False):
    """(ms, what) for the records-input kernel at R received records that
    hold n_live live windows: the (R, RW + 1) int32 records and the
    blocks' int64 first columns read once, the (WK, n_live) int64 planes
    written once; ~3W + 7 ALU operations and WK selects a live window (W
    funnel shifts, one pair reversal of ~5, 2 a word for the compare, 2
    for the address; the canonical pick and the bank plane)."""
    W = (2 * k + 31) // 32
    rw = (max_span + k - 1 + 30) // 16
    blocks = -(-R // 256)
    nbytes = R * (rw + 1) * 4 + blocks * 8 + n_live * 8 * (W + bank)
    return _bound(nbytes, n_live * (3 * W + 7), n_live * (W + bank), rates)


def wire_extract_bound(k: int, rates: dict, bank: bool = False):
    """(ms, what) for one flush group at the real shape, exc wire: the
    code words and exc meta read once, the int64 planes written once;
    ~20W + 6 ceil(k/32) + 10 integer operations a window, W of them
    selects (per word two funnel shifts, a pair reversal, the xor,
    compare, select and address; the validity test 32 bits at a time).
    bank: the per-bank variant, which also reads a row's int32 bank id
    and writes the bank plane, one more int64 and one more select a
    window."""
    W, nw = (2 * k + 31) // 32, ROW_LEN - k + 1
    rows, windows = G_REAL * ROWS, G_REAL * ROWS * nw
    nw_p = -(-ROW_LEN // 32) * 2
    WK = W + bank
    nbytes = (rows * (4 * nw_p + 2 * (1 + WIRE_E) + 4 * bank)
              + windows * 8 * WK)
    alu = windows * (19 * W + 6 * (-(-k // 32)) + 10)
    return _bound(nbytes, alu, windows * WK, rates)


# integer operations a pair of a stage: a two-word unsigned less-than and a
# two-word less-or-equal (two 32-bit compares each, the second chained on
# the first) on the ALU, and six selects; the direction is uniform over a
# stage
SORT_ALU_PER_PAIR, SORT_SEL_PER_PAIR = 2 + 2, 6


def sortstage_bound(n: int, nstages: int, rates: dict):
    """(ms, what, parts) for the probe over n elements: 12 B read and 12 B
    written an element; a pair of a stage takes SORT_ALU_PER_PAIR ALU
    operations and SORT_SEL_PER_PAIR selects (`ops_ms`).  parts adds the
    shared-memory floors of the two kernels' designs (24 B an element a
    round trip: one a stage for the first port, one a group of up to three
    stages for the register-resident kernel, 27 groups for 80 stages) and
    the register-resident kernel's distributed-shared-memory bytes (12 B
    an element a group on bits {10, 13, 15})."""
    pairs = n * nstages // 2
    alu, sel = pairs * SORT_ALU_PER_PAIR, pairs * SORT_SEL_PER_PAIR
    ms, by = _bound(24 * n, alu, sel, rates)
    cycles, tail = divmod(nstages, 6)
    groups = 2 * cycles + (tail > 0)
    parts = {
        "alu_ms": alu / rates["alu_ops_per_s"] * 1e3,
        "issue_ms": (alu + sel) / rates["issue_ops_per_s"] * 1e3,
        "device_memory_ms": 24 * n / HBM_BYTES_PER_S * 1e3,
        "smem_floor_reg_ms": 24 * n * groups / rates["smem_bytes_per_s"]
        * 1e3,
        "smem_floor_smem_ms": 24 * n * nstages / rates["smem_bytes_per_s"]
        * 1e3,
        "dsmem_bytes": 12 * n * cycles,
        "ops_at_fp32_peak_ms": (alu + sel) / FP32_PEAK_OPS_PER_S * 1e3,
    }
    return ms, by, parts


def ops_ms(alu_ops: int, sel_ops: int, rates: dict) -> float:
    """The operations floor in ms: the ALU operations over the ALU rate,
    or all of them over the issue rate (a select may issue on the FP32
    pipe), whichever is larger."""
    return max(alu_ops / rates["alu_ops_per_s"],
               (alu_ops + sel_ops) / rates["issue_ops_per_s"]) * 1e3


def _bound(nbytes: int, alu_ops: int, sel_ops: int, rates: dict):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ms(alu_ops, sel_ops, rates)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_sortstage(rates: dict):
    import torch

    from dsk_tpu_torch.kmer import cuda_kernels as ck
    from dsk_tpu_torch.kmer import sortstage as ss

    rng = np.random.default_rng(6)

    def words(tiles, lo=0, hi=1 << 32):
        return rng.integers(lo, hi, size=(tiles * ss.R, ss.LANES),
                            dtype=np.uint64).astype(np.uint32)

    def ties(tiles):
        shape = (tiles * ss.R, ss.LANES)
        return [rng.integers(0, 4, size=shape).astype(np.uint32),
                rng.integers(0, 4, size=shape).astype(np.uint32),
                np.arange(shape[0] * shape[1], dtype=np.uint32)
                .reshape(shape)]

    cases = [
        ("1 tile", [words(1) for _ in range(3)], torch.int32),
        ("2 tiles", [words(2) for _ in range(3)], torch.int32),
        ("ties, 2 tiles", ties(2), torch.int32),
        ("keys >= 2^31, 2 tiles",
         [words(2, 1 << 31) for _ in range(2)] + [words(2)], torch.int32),
        ("uint32 words, 1 tile", [words(1) for _ in range(3)], torch.uint32),
        (f"{SS_TILES} tiles", [words(SS_TILES) for _ in range(3)],
         torch.int32),
    ]
    kernels = {"bitonic_stages": ss.bitonic_stages,
               "bitonic_stages_smem": ss.bitonic_stages_smem}
    max_err = dict.fromkeys(kernels, 0)
    for name, arrs, dtype in cases:
        x = [torch.from_numpy(a.view(np.int32)).cuda().view(dtype)
             for a in arrs]
        want = ss.bitonic_stages_torch(*x)
        for kname, fn in kernels.items():
            got = fn(*x)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if g.dtype != dtype or g.shape != w.shape:
                    raise AssertionError(f"{kname} {name}: dtype or shape")
                diff = ss.widen_words(g) - ss.widen_words(w)
                err = int(diff.abs().max().item())
                max_err[kname] = max(max_err[kname], err)
                if err:
                    raise AssertionError(f"{kname} != plain: {name}")
    big = x  # the last case: SS_TILES tiles, int32 words

    # the probe's path: launches counted from here; the two kernels timed
    # in turns (first port, redesign, redesign, first port)
    for fn in kernels.values():
        fn.launches = 0
    ck.extract_canonical_planes.launches = 0
    ck.extract_wire_planes.launches = 0
    turns = {k: [] for k in kernels}
    for kname in ("bitonic_stages_smem", "bitonic_stages", "bitonic_stages",
                  "bitonic_stages_smem"):
        turns[kname].append(cuda_ms(lambda: kernels[kname](*big), 50))
    launches = {k: fn.launches for k, fn in kernels.items()}
    if min(launches.values()) <= 0:
        raise AssertionError(f"the probe's path missed a kernel: {launches}")
    if ck.extract_canonical_planes.launches or ck.extract_wire_planes.launches:
        raise AssertionError("the probe's path launched an extract kernel")
    plain_ms = cuda_ms(lambda: ss.bitonic_stages_torch(*big), 3)
    key = (ss.widen_words(big[0]) << 32) | ss.widen_words(big[1])
    pay = big[2].reshape(-1)

    def flat_sort():
        v, i = torch.sort(key.reshape(-1))
        return v, pay[i]

    sort_ms = cuda_ms(flat_sort, 5)
    clusters = {k: ss.max_active_clusters(kind) for k, kind in
                (("bitonic_stages", "reg"), ("bitonic_stages_smem", "smem"))}
    n = big[0].numel()
    bound, by, parts = sortstage_bound(n, ss.NSTAGES, rates)
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    log(f"[6 sortstage] bitonic_stages and bitonic_stages_smem == plain on "
        f"{len(cases)} cases ({'; '.join(c[0] for c in cases)}; max |diff| "
        f"{max(max_err.values())}); {SS_TILES} tiles = {n} elements x "
        f"{ss.NSTAGES} stages, in turns smem/reg/reg/smem, mean of 50: "
        + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms "
                    f"({ms[k] * 1e6 / n / ss.NSTAGES:.5f} ns/elem/stage, "
                    f"{bound / ms[k]:.3f} of the bound, max active clusters "
                    f"{clusters[k]}, launches {launches[k]})"
                    for k, v in turns.items())
        + f"; plain {plain_ms:.4f} ms; bound {bound:.4f} ms by {by} "
        f"(operations: {SORT_ALU_PER_PAIR} ALU a pair over the ALU rate "
        f"{parts['alu_ms']:.4f} ms, {SORT_ALU_PER_PAIR + SORT_SEL_PER_PAIR} "
        f"a pair over the issue rate {parts['issue_ms']:.4f} ms; device "
        f"memory "
        f"{parts['device_memory_ms']:.4f} ms; shared-memory floors "
        f"{parts['smem_floor_reg_ms']:.4f} ms for the redesign, "
        f"{parts['smem_floor_smem_ms']:.4f} ms for the first port; "
        f"distributed shared memory {parts['dsmem_bytes'] / 1e9:.3f} GB; "
        f"the operations at the FP32 peak {parts['ops_at_fp32_peak_ms']:.4f}"
        f" ms); yardstick (a flat sort, not the same function): torch.sort "
        f"of the {n} int64 keys + payload gather {sort_ms:.4f} ms")
    return {"kernels": {k: {"launches": launches[k],
                            "max_abs_err": max_err[k], "ms": ms[k]}
                        for k in kernels},
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


# -- phase 7: per-bank counting ---------------------------------------------

BANK_KS = (15, 31, 32, 33, 63, 127)
PB_GENOME = 1 << 22          # 7(c): the genome, bank 0
PB_READ_BASES = 1 << 27      # 7(c): reads, banks 1-3 (~32x coverage)
PB_CAP = 33_554_432          # 7(c): table slots for ~16.8M (k-mer, bank) pairs
PB_BANKS = 4


def bank_ids(rng, n: int, B: int) -> np.ndarray:
    """(n, B) int32 bank ids 1..4 that change inside a batch (dead rows
    carry non-zero ids too)."""
    return (np.sort(rng.integers(0, 4, size=(n, B)), axis=1) + 1).astype(
        np.int32)


def phase_bank_kernel(rates: dict):
    """7(a): the fused kernel with bank ids against its plain version, bit
    for bit, on both wires, k in BANK_KS, every pass of 1 and 3, rows
    whose bank changes inside a batch and dead rows; then whole groups at
    the real shape (k=31, 63), the per-bank kernel and the W-plane kernel
    timed in turns beside the plain version."""
    import torch

    from dsk_tpu_torch.kmer import cuda_kernels as ck
    from dsk_tpu_torch.kmer.codec import words_per_kmer

    rng = np.random.default_rng(7)
    cases = []
    for wire in ("exc", "bitmap"):
        for k in BANK_KS:
            rows = [wire_rows(rng, 10, 300, wire == "bitmap")
                    for _ in range(3)]
            cases += [(f"{wire} k={k} pass {p}/{n}", rows, wire, k, n, p)
                      for n, p in WIRE_PASSES]
    for k in (31, 63):
        cases.append((f"exc k={k} real group", real_group(rng, "exc"), "exc",
                      k, 1, 0))
    max_err = 0
    times = {}
    for name, rows, wire, k, n_passes, pass_id in cases:
        words, meta = wire_group(rows, wire)
        n, B, L = len(rows), rows[0].shape[0], rows[0].shape[1]
        bids = torch.from_numpy(bank_ids(rng, n, B)).cuda()
        cols = n * B * (L - k + 1)
        W = words_per_kmer(k)
        got, want = (torch.full((W + 1, cols + 7), GUARD, dtype=torch.int64,
                                device="cuda") for _ in range(2))
        before = ck.extract_wire_planes.bank_launches
        ck.extract_wire_planes(words, meta, wire, k, L, got, n_passes,
                               pass_id, bids)
        ck.extract_wire_planes_torch(words, meta, wire, k, L, want, n_passes,
                                     pass_id, bids)
        torch.cuda.synchronize()
        if ck.extract_wire_planes.bank_launches != before + 1:
            raise AssertionError(f"bank kernel {name}: not one launch")
        err = int((got - want).abs().max().item())
        max_err = max(max_err, err)
        if err or not bool((got[:, cols:] == GUARD).all().item()):
            raise AssertionError(f"bank kernel != plain: {name}")
        dead = got[W, :cols] == SENTINEL
        if not bool((got[:W, :cols][:, dead] == SENTINEL).all().item()):
            raise AssertionError(f"bank kernel {name}: a dead window lives")
        if name.endswith("real group"):
            plain_w = torch.empty((W, cols), dtype=torch.int64, device="cuda")
            turns = {"bank": [], "w": []}
            for which in ("bank", "w", "w", "bank"):
                turns[which].append(cuda_ms(
                    (lambda: ck.extract_wire_planes(
                        words, meta, wire, k, L, got, 1, 0, bids))
                    if which == "bank" else
                    (lambda: ck.extract_wire_planes(
                        words, meta, wire, k, L, plain_w)), 20))
            plain = cuda_ms(lambda: ck.extract_wire_planes_torch(
                words, meta, wire, k, L, want, 1, 0, bids), 2)
            times[k] = (sum(turns["bank"]) / 2, sum(turns["w"]) / 2, plain,
                        turns)
            del plain_w
        del got, want, words, meta, bids
        torch.cuda.empty_cache()
    log(f"[7 per-bank] (a) extract_wire_planes with bank ids == plain on "
        f"{len(cases)} cases, dead windows all-sentinel in every plane, "
        f"later columns untouched (max |diff| {max_err}); per "
        f"{G_REAL}-batch group of ({ROWS}, {ROW_LEN}), exc wire, in turns "
        f"bank/W/W/bank, mean of 20: "
        + ", ".join(
            f"k={k} bank plane {b:.4f} ms ({' / '.join(f'{t:.4f}' for t in tt['bank'])}), "
            f"W planes {w:.4f} ms ({' / '.join(f'{t:.4f}' for t in tt['w'])}), "
            f"plain {p:.4f} ms, bound {wire_extract_bound(k, rates, True)[0]:.4f}"
            f" ms (W planes {wire_extract_bound(k, rates)[0]:.4f} ms), "
            f"{wire_extract_bound(k, rates, True)[0] / b:.3f} of the bound"
            for k, (b, w, p, tt) in times.items()))
    return max_err, times



def phase_bank_golden(tmp: str, has_h5py: bool, ranks=None) -> list[str]:
    """7(b): per-bank runs of tests/data/c1..c4 at k=27 through execute on
    CUDA against the port's oracle; 9(b) with `ranks`, through the routed
    path."""
    from dsk_tpu_torch import oracle
    from dsk_tpu_torch.engine import processors
    from dsk_tpu_torch.engine.run import RunParams, execute
    from dsk_tpu_torch.kmer.codec import words_to_value
    from dsk_tpu_torch.store import text as store_text

    storage = "hdf5" if has_h5py else "none"
    files = [os.path.join(DATA, f"c{i}.fasta.gz") for i in range(1, 5)]
    c14, c12 = ",".join(files), ",".join(files[:2])
    k = 27
    pb = oracle.count_bank_per_bank(c14, k)
    values = np.array(sorted(pb), dtype=object)
    bmat = np.stack([pb[v] for v in values])
    totals = bmat.sum(axis=1)
    done = []

    def run(name, file, **kw):
        return execute(RunParams(
            file=file, kmer_size=k, out=os.path.join(tmp, name), verbose=0,
            device=DEVICE, storage_type=storage, **kw), ranks)

    def solid_values(out, kind, custom):
        if has_h5py:
            from dsk_tpu_torch.store.hdf5 import OutputStore

            st = OutputStore(out.h5_path)
            try:
                return sorted(v for v, _ in st.iter_items())
            finally:
                st.close()
        res = out.result
        if res.bank_counts is not None:
            got = {int(v): tuple(b) for v, b in zip(
                (words_to_value(r) for r in res.kmers), res.bank_counts)}
            want = {int(v): tuple(b) for v, b in zip(values, bmat)}
            if got != want:
                raise AssertionError(f"{kind}: bank_counts != oracle")
        kk, _ = res.solid(2, kind=kind if custom is None else "custom",
                          custom=custom)
        return sorted(words_to_value(r) for r in kk)

    kinds = [("sum", None), ("min", None), ("max", None), ("one", None),
             ("all", None), ("custom", "1,0,1,0")]
    for kind, custom in kinds:
        kw = (dict(solidity_custom=custom) if custom
              else dict(solidity_kind=kind))
        out = run(f"pb_{kind}", c14, abundance_min=2, histo=True, **kw)
        _histo_equal(out.histo_path, "k27.histo", f"per-bank {kind}")
        vec = None if custom is None else np.array(
            [int(x) for x in custom.split(",")])
        m = processors.solidity_mask(totals, kind, 2, 2**31 - 1,
                                     bank_counts=bmat, custom=vec)
        want = sorted(int(v) for v in values[m])
        got = solid_values(out, kind, vec)
        if got != want or out.n_solid != len(want):
            raise AssertionError(f"solidity {kind}: {out.n_solid} solid, "
                                 f"oracle {len(want)}")
        done.append(f"{kind} ({len(want)} solid)")
    out = run("pb_h2", c12, abundance_min=1, histo2d=True)
    pb12 = oracle.count_bank_per_bank(c12, k)
    mat = processors.histo2d_matrix(np.stack(list(pb12.values())), 10000)
    want_path = os.path.join(tmp, "oracle.histo2D")
    with open(want_path, "w") as f:
        store_text.write_histo2d(mat, f)
    with open(out.histo2d_path, "rb") as f, open(want_path, "rb") as g:
        if f.read() != g.read():
            raise AssertionError("c1,c2 .histo2D differs from the oracle's")
    done.append("c1,c2 .histo2D")
    return done


def make_bank_batches():
    """7(c): bank 0 a 4,194,304-base random genome (numpy seed 0) as
    1024-base rows overlapping by k-1; banks 1-3 134,217,728 bases of
    1024-base reads sampled from it; all rows in 2048-row batches, so a
    batch holds the end of one bank and the start of the next."""
    from dsk_tpu_torch.io import Batch
    from dsk_tpu_torch.io.batch import PAD

    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=PB_GENOME, dtype=np.uint8)
    step = ROW_LEN - (K_REAL - 1)
    starts = np.arange(0, PB_GENOME - (K_REAL - 1), step)
    idx = starts[:, None] + np.arange(ROW_LEN)[None, :]
    g_rows = np.where(idx < PB_GENOME, genome[np.minimum(idx, PB_GENOME - 1)],
                      PAD).astype(np.uint8)
    n_reads = PB_READ_BASES // ROW_LEN
    r_starts = rng.integers(0, PB_GENOME - ROW_LEN, size=n_reads)
    r_rows = genome[r_starts[:, None] + np.arange(ROW_LEN)[None, :]]
    codes = np.concatenate([g_rows, r_rows])
    bids = np.concatenate([
        np.zeros(g_rows.shape[0], np.int32),
        1 + (np.arange(n_reads) * 3 // n_reads).astype(np.int32)])
    out = []
    for a in range(0, codes.shape[0], ROWS):
        c = codes[a: a + ROWS]
        b = bids[a: a + ROWS]
        n = c.shape[0]
        if n < ROWS:
            c = np.concatenate([c, np.full((ROWS - n, ROW_LEN), PAD,
                                           np.uint8)])
            b = np.concatenate([b, np.zeros(ROWS - n, np.int32)])
        out.append(Batch(codes=c, bank_ids=b, n_rows=n,
                         n_bases=int((c[:n] < 4).sum()), n_reads=n))
    return out


def numpy_pairs(batches):
    """Host count of (canonical k-mer, bank) pairs, k = 31: the 62-bit
    canonical value shifted by 2 and or-ed with the 2-bit bank id, one
    uint64 a window, np.unique.  Returns (pairs, counts)."""
    k, nw = K_REAL, ROW_LEN - K_REAL + 1
    vals = []
    for b in batches:
        codes = b.codes[: b.n_rows]
        c = codes.astype(np.uint64) & np.uint64(3)
        fwd = np.zeros((codes.shape[0], nw), np.uint64)
        rc = np.zeros_like(fwd)
        ok = np.ones(fwd.shape, bool)
        for j in range(k):
            cj = c[:, j: j + nw]
            fwd <<= np.uint64(2)
            fwd |= cj
            rc |= (cj ^ np.uint64(2)) << np.uint64(2 * j)
            ok &= codes[:, j: j + nw] < 4
        pair = (np.minimum(fwd, rc) << np.uint64(2)) | b.bank_ids[
            : b.n_rows, None].astype(np.uint64)
        vals.append(pair[ok])
    return np.unique(np.concatenate(vals), return_counts=True)


def expected_per_bank(pairs, counts):
    """(k-mer values uint64, totals, (n, 4) bank matrix, histogram) from the
    numpy pair count."""
    kmer = pairs >> np.uint64(2)
    bank = (pairs & np.uint64(3)).astype(np.int64)
    uniq, seg = np.unique(kmer, return_inverse=True)
    mat = np.zeros((uniq.shape[0], PB_BANKS), np.int64)
    mat[seg, bank] = counts  # one row per (k-mer, bank) pair
    totals = mat.sum(axis=1)
    hist = np.bincount(np.clip(totals, 1, 10000), minlength=10001)
    hist[0] = 0
    return uniq, totals, mat, hist


def kmer_values(kmers: np.ndarray) -> np.ndarray:
    return (kmers[:, 0].astype(np.uint64) << np.uint64(32)) | kmers[
        :, 1].astype(np.uint64)


def flush_split(eng, staged):
    """Device time of each piece of the stream's flush groups (the wire
    already on the card), CUDA events as scripts/torch_profile_stream.py
    takes them: fill (the fused kernel), sort, compaction, fold; ms."""
    import torch

    from dsk_tpu_torch.kmer.device import (
        compact_heads_unit,
        sum_by_key_planes_capped,
    )
    from dsk_tpu_torch.kmer.layout import sort_planes

    tab_p, tab_c, _ = eng._init_state()
    cap = eng.plan.table_cap
    marks = []

    def timed(piece, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        marks.append((piece, a, b))
        return out

    torch.cuda.synchronize()
    for words, meta, bids in staged:
        n_rows = timed("fill", lambda: eng.fill_group(
            words, meta, 0, bids if eng.per_bank else None))
        skeys, _ = timed("sort", lambda: sort_planes(
            eng._buffer()[:, :n_rows]))
        buniq, bcounts, _, _ = timed("compact",
                                     lambda: compact_heads_unit(skeys, cap))

        def fold():
            planes = torch.cat([buniq, tab_p], dim=1)
            weights = torch.cat([bcounts, tab_c.to(torch.int64)])
            return sum_by_key_planes_capped(planes, weights, cap)
        uniq, cnt, _, _, _ = timed("fold", fold)
        tab_p, tab_c = uniq, cnt.to(torch.int32)
        del skeys, buniq, bcounts
    torch.cuda.synchronize()
    ms = dict.fromkeys(("fill", "sort", "compact", "fold"), 0.0)
    for piece, a, b in marks:
        ms[piece] += a.elapsed_time(b)
    return ms


def flush_peak_bytes(per_bank: bool, staged, **kw) -> dict:
    """Peak device bytes of one flush of 8 batches (CAP_REAL table) over
    its buffer rows, with the buffer's own words, the measure that
    scripts/torch_profile_stream.py takes for the planner's
    flush_row_bytes; beside the planner's charge.  kw: more engine
    arguments (phase 12's key-space buckets)."""
    import torch

    from dsk_tpu_torch.dist.engine import DistCountEngine
    from dsk_tpu_torch.engine import planner

    eng = DistCountEngine(K_REAL, device=DEVICE, batch_rows=ROWS,
                          row_len=ROW_LEN, buf_batches=8, table_cap=CAP_REAL,
                          per_bank=per_bank, **kw)
    tab_p, tab_c, tover = eng._init_state()
    words, meta, bids = staged[0]
    n_rows = eng.fill_group(words[:8], meta[:8], 0,
                            bids[:8] if per_bank else None)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = eng._flush(n_rows, tab_p, tab_c, tover)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    row = (peak - base) / n_rows + eng.WK * 8
    charge = planner.flush_row_bytes(eng.WK)
    del out, eng, tab_p, tab_c
    torch.cuda.empty_cache()
    return {"width": "WK=3" if per_bank else "W=2", "bytes_per_row": row,
            "charge": charge}


def phase_bank_real():
    """7(c): the genome-against-its-reads stream, per bank, 1 and 3
    passes, against the numpy count of (k-mer, bank) pairs."""
    import torch

    from dsk_tpu_torch.dist.engine import (
        DistCountEngine,
        _PerBankSink,
        _live_prefix,
    )
    from dsk_tpu_torch.engine import processors
    from dsk_tpu_torch.engine.counter import _group_by_kmer, merge_pass_results
    from dsk_tpu_torch.kmer import cuda_kernels as ck

    t0 = time.perf_counter()
    batches = make_bank_batches()
    pairs, pair_counts = numpy_pairs(batches)
    want_k, want_tot, want_mat, want_hist = expected_per_bank(pairs,
                                                              pair_counts)
    t_ref = time.perf_counter() - t0
    n_batches = len(batches)
    groups = -(-n_batches // G_REAL)
    geom = dict(device=DEVICE, batch_rows=ROWS, row_len=ROW_LEN,
                buf_batches=G_REAL, table_cap=PB_CAP)
    eng = DistCountEngine(K_REAL, per_bank=True, **geom)
    eng.count_stream(iter(batches[:1]), nb_banks=PB_BANKS)  # warm-up
    for c in ("launches", "bank_launches"):
        setattr(ck.extract_wire_planes, c, 0)
    ck.extract_canonical_planes.launches = 0
    t0 = time.perf_counter()
    res = eng.count_stream(iter(batches), nb_banks=PB_BANKS, finalize=False)
    wall = time.perf_counter() - t0
    launches = (ck.extract_wire_planes.launches,
                ck.extract_wire_planes.bank_launches,
                ck.extract_canonical_planes.launches)
    if launches != (groups, groups, 0):
        raise AssertionError(
            f"per-bank stream: (fused, with bank ids, codes-input) launches "
            f"{launches}, want ({groups}, {groups}, 0)")
    n_bases = res.info["n_bases"]
    # the device table itself: (k-mer, bank) rows and counts
    tab_p, tab_c = eng._last_state
    rows, cc = _live_prefix(tab_p, tab_c)
    got_pairs = (kmer_values(rows[:, :2]) << np.uint64(2)) | rows[
        :, 2].astype(np.uint64)
    if not (np.array_equal(got_pairs, pairs)
            and np.array_equal(cc, pair_counts)):
        raise AssertionError("per-bank table != numpy (k-mer, bank) count")
    g0 = time.perf_counter()
    _group_by_kmer(rows, cc, eng.W, PB_BANKS)
    t_group = time.perf_counter() - g0
    del rows, cc, tab_p, tab_c
    sunk = []
    sink = _PerBankSink(lambda *a: sunk.append(a))
    sink.nb_banks = PB_BANKS
    s0 = time.perf_counter()
    eng._emit_pass(sink, 0)
    t_emit = time.perf_counter() - s0
    (_, _, kk, tot, bmat), = sunk
    if not (np.array_equal(kmer_values(kk), want_k)
            and np.array_equal(tot, want_tot)
            and np.array_equal(bmat, want_mat)
            and np.array_equal(sink.hist, want_hist)):
        raise AssertionError("per-bank sink output != numpy")
    if not np.array_equal(processors.histo2d_matrix(bmat, 10000),
                          processors.histo2d_matrix(want_mat, 10000)):
        raise AssertionError("histo2D matrix != numpy's")
    n_pairs = pairs.shape[0]
    del sunk, kk, tot, bmat
    rate = n_bases / wall / 1e6
    log(f"[7 per-bank] (c) {n_batches} batches ({n_bases} bases: a "
        f"{PB_GENOME}-base genome as bank 0, reads as banks 1-3), k={K_REAL}, "
        f"WK=3, table_cap {PB_CAP}: {n_pairs} (k-mer, bank) pairs, "
        f"{want_k.shape[0]} k-mers; table, bank_counts, totals, histogram "
        f"and histo2D == numpy (numpy count {t_ref:.1f} s)")
    log(f"[7 per-bank] (c) {rate:.2f} Mbases/s ({wall:.3f} s); t_sub "
        f"{res.info['t_sub']}; fused launches {launches[0]} (with bank ids "
        f"{launches[1]}), codes-input {launches[2]}")
    log(f"[7 per-bank] (c) host: _group_by_kmer {t_group:.3f} s over "
        f"{n_pairs} pairs; sink path (live-prefix copy, grouping, "
        f"histogram, sink) {t_emit:.3f} s")

    # the flush split at WK=3 against W=2, the same groups on the card
    staged = []
    for a in range(0, n_batches, G_REAL):
        words, meta = wire_group([b.codes for b in batches[a: a + G_REAL]],
                                 "exc")
        bids = torch.from_numpy(np.stack(
            [b.bank_ids for b in batches[a: a + G_REAL]])).cuda()
        staged.append((words, meta, bids))
    eng_w = DistCountEngine(K_REAL, **geom)
    split = {}
    for name, e in (("WK=3", eng), ("W=2", eng_w), ("W=2", eng_w),
                    ("WK=3", eng)):
        ms = flush_split(e, staged)
        split.setdefault(name, []).append(ms)
    del eng_w
    torch.cuda.empty_cache()
    peaks = [flush_peak_bytes(pb, staged) for pb in (True, False)]
    log(f"[7 per-bank] (c) flush split, device ms over the stream's "
        f"{groups} groups, in turns WK=3/W=2/W=2/WK=3: "
        + "; ".join(f"{name}: " + ", ".join(
            f"{p} {' / '.join(f'{m[p]:.3f}' for m in runs)}"
            for p in ("fill", "sort", "compact", "fold"))
            for name, runs in split.items())
        + "; peak device bytes per buffer row of an 8-batch flush "
        + ", ".join(f"{p['width']} {p['bytes_per_row']:.1f} B (planner "
                    f"charge {p['charge']} B)" for p in peaks))
    for p in peaks:
        if p["bytes_per_row"] > p["charge"]:
            raise AssertionError(
                f"a flush row at {p['width']} takes {p['bytes_per_row']:.1f} "
                f"B, over the planner's {p['charge']} B")
    del staged

    # the same batches as a 3-pass count, each pass finalized
    eng3 = DistCountEngine(K_REAL, per_bank=True, n_passes=3, **geom)
    del eng
    torch.cuda.empty_cache()
    for c in ("launches", "bank_launches"):
        setattr(ck.extract_wire_planes, c, 0)
    t0 = time.perf_counter()
    parts = [eng3.count_stream(iter(batches), nb_banks=PB_BANKS, pass_id=p)
             for p in range(3)]
    wall3 = time.perf_counter() - t0
    launches3 = (ck.extract_wire_planes.launches,
                 ck.extract_wire_planes.bank_launches)
    merged = merge_pass_results(parts)
    if not (np.array_equal(kmer_values(merged.kmers), want_k)
            and np.array_equal(merged.counts, want_tot)
            and np.array_equal(merged.bank_counts, want_mat)
            and np.array_equal(merged.histogram, want_hist)):
        raise AssertionError("3-pass per-bank count != numpy")
    if launches3 != (3 * groups, 3 * groups):
        raise AssertionError(f"3-pass per-bank: launches {launches3}")
    log(f"[7 per-bank] (c) 3-pass count of the same batches, each pass "
        f"finalized with bank_counts, merged == numpy (pass tables "
        f"{', '.join(str(p.kmers.shape[0]) for p in parts)} k-mers; "
        f"{3 * n_bases / wall3 / 1e6:.2f} Mbases/s streamed); fused "
        f"launches {launches3[0]} (with bank ids {launches3[1]})")
    return launches[1], rate


# -- phase 8: spill mode ------------------------------------------------------

SP_PARTS = 16          # 8(b): host partitions
SP_CAP = 4_194_304     # 8(b): the count phase's table slots
SP_ERR = 0.01          # 8(b): per-base substitution rate


def _store_items(out, has_h5py):
    """The solid k-mers of a run, sorted: from its store, or from the
    returned table when no store was written."""
    if has_h5py:
        from dsk_tpu_torch.store.hdf5 import OutputStore

        st = OutputStore(out.h5_path)
        try:
            return sorted(st.iter_items())
        finally:
            st.close()
    from dsk_tpu_torch.kmer.codec import words_to_value

    kk, cc = out.result.solid(out.params.abundance_min)
    return sorted((words_to_value(r), int(c)) for r, c in zip(kk, cc))


def phase_spill_golden(tmp: str, has_h5py: bool) -> list[str]:
    """8(a): spill runs of the fixtures through execute on CUDA."""
    from dsk_tpu_torch import oracle
    from dsk_tpu_torch.engine import processors
    from dsk_tpu_torch.engine.run import RunParams, execute
    from dsk_tpu_torch.store import text as store_text

    storage = "hdf5" if has_h5py else "none"
    k27 = os.path.join(DATA, "read50x_ref10K_e001.fasta.gz")
    files = [os.path.join(DATA, f"c{i}.fasta.gz") for i in range(1, 5)]
    done = []

    def run(name, file, **kw):
        return execute(RunParams(
            file=file, kmer_size=27, out=os.path.join(tmp, name), verbose=0,
            device=DEVICE, storage_type=storage, **kw))

    table = run("sp_off", k27, abundance_min=1, histo=True, spill="off")
    want = _store_items(table, has_h5py)
    on = run("sp_on", k27, abundance_min=1, histo=True, spill="on",
             spill_partitions=4)
    if not on.result.info.get("spill"):
        raise AssertionError("-spill on did not count in spill mode")
    _histo_equal(on.histo_path, "k27.histo", "-spill on k27")
    if _store_items(on, has_h5py) != want:
        raise AssertionError("-spill on table != the table mode's")
    done.append("k27 -spill on -spill-partitions 4 .histo == k27.histo, "
                "table == table mode's")
    # one partition over a 65,536-slot table (the planner's least) must
    # split: the fixture holds 93,948 distinct k-mers
    sp = run("sp_split", k27, abundance_min=1, histo=True, spill="on",
             spill_partitions=1, max_memory=1)
    splits = sp.result.info["spill_splits"]
    if splits < 1:
        raise AssertionError("the small-table spill run did not split")
    _histo_equal(sp.histo_path, "k27.histo", "-spill on with splits")
    if _store_items(sp, has_h5py) != want:
        raise AssertionError("spill with splits: table != table mode's")
    done.append(f"k27 one partition, table_cap "
                f"{sp.info['config']['table_cap']}: spill_splits {splits}, "
                f".histo and table equal")
    # -spill auto over a 1 MB table budget: the planner weighs the wire
    # rates it measures on the card against 8 table passes; the spill
    # files go under -out-tmp within -max-disk, and leave nothing there
    out_tmp = os.path.join(tmp, "spill_tmp")
    os.makedirs(out_tmp, exist_ok=True)
    auto = run("sp_auto", k27, abundance_min=1, histo=True, spill="auto",
               max_memory=1, max_disk=64, out_tmp=out_tmp)
    if not auto.result.info.get("spill"):
        raise AssertionError(f"-spill auto kept the table mode: "
                             f"{auto.info['config']}")
    _histo_equal(auto.histo_path, "k27.histo", "-spill auto")
    if _store_items(auto, has_h5py) != want:
        raise AssertionError("-spill auto: table != table mode's")
    if os.listdir(out_tmp):
        raise AssertionError(f"-out-tmp not emptied: {os.listdir(out_tmp)}")
    done.append(f"k27 -spill auto -max-memory 1 -max-disk 64 -out-tmp: "
                f"spill over {auto.info['config']['nb_partitions']} "
                f"partition(s), .histo and table equal, -out-tmp emptied")
    # per bank: c1..c4, -solidity-kind min, -histo2D
    c14 = ",".join(files)
    pb = oracle.count_bank_per_bank(c14, 27)
    values = np.array(sorted(pb), dtype=object)
    bmat = np.stack([pb[v] for v in values])
    out = run("sp_pb", c14, abundance_min=2, histo=True, histo2d=True,
              solidity_kind="min", spill="on", spill_partitions=4)
    if not out.result.info.get("spill"):
        raise AssertionError("per-bank -spill on did not spill")
    _histo_equal(out.histo_path, "k27.histo", "per-bank -spill on")
    m = processors.solidity_mask(bmat.sum(axis=1), "min", 2, 2**31 - 1,
                                 bank_counts=bmat)
    if has_h5py:
        got = [v for v, _ in _store_items(out, True)]
    else:
        from dsk_tpu_torch.kmer.codec import words_to_value

        res = out.result
        got = sorted(words_to_value(r) for r in res.solid(2, kind="min")[0])
        rows = {words_to_value(r): tuple(int(x) for x in b)
                for r, b in zip(res.kmers, res.bank_counts)}
        if rows != {v: tuple(int(x) for x in b)
                    for v, b in zip(values, bmat)}:
            raise AssertionError("per-bank spill bank_counts != oracle")
    if got != sorted(int(v) for v in values[m]):
        raise AssertionError("per-bank spill: solid k-mers (min) != oracle")
    want_path = os.path.join(tmp, "oracle14.histo2D")
    with open(want_path, "w") as f:
        store_text.write_histo2d(processors.histo2d_matrix(bmat, 10000), f)
    with open(out.histo2d_path, "rb") as f, open(want_path, "rb") as g:
        if f.read() != g.read():
            raise AssertionError("per-bank spill .histo2D != the oracle's")
    done.append(f"c1..c4 -solidity-kind min -histo2D ({int(m.sum())} solid)"
                f" == oracle")
    return done


def make_error_batches():
    """8(b): bench.py's make_error_batches recipe in numpy: 2048 reads of
    1024 bases a batch sampled from the 1-Mbase random genome (numpy seed
    0), each base substituted (+1..3 mod 4) with probability SP_ERR."""
    from dsk_tpu_torch.io import Batch

    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=GENOME, dtype=np.uint8)
    out = []
    for _ in range(N_BATCHES):
        starts = rng.integers(0, GENOME - ROW_LEN, size=ROWS)
        codes = genome[starts[:, None] + np.arange(ROW_LEN)[None, :]]
        hit = rng.random(codes.shape) < SP_ERR
        codes = np.where(
            hit, (codes + rng.integers(1, 4, codes.shape, dtype=np.uint8)) % 4,
            codes).astype(np.uint8)
        out.append(Batch(codes=codes, bank_ids=np.zeros(ROWS, np.int32),
                         n_rows=ROWS, n_bases=int(codes.size), n_reads=ROWS))
    return out


def write_fasta(batches, path: str) -> None:
    """The batches' rows as FASTA reads (the planner samples a bank)."""
    with open(path, "wb") as f:
        for i, b in enumerate(batches):
            letters = _LETTERS[b.codes[: b.n_rows]]
            f.write(b"".join(b">r%d_%d\n" % (i, j) + row.tobytes() + b"\n"
                             for j, row in enumerate(letters)))


def phase_spill_real(tmp: str) -> dict:
    """8(b) and (c): the error-rich stream counted in spill mode and, in
    turns, in table mode with 2 passes; both against a numpy count; the
    planner's inputs and choice on the card."""
    import torch

    from dsk_tpu_torch.dist.engine import DistCountEngine
    from dsk_tpu_torch.engine import planner
    from dsk_tpu_torch.engine.counter import merge_pass_results
    from dsk_tpu_torch.kmer import cuda_kernels as ck
    from dsk_tpu_torch.utils import sysinfo

    t0 = time.perf_counter()
    batches = make_error_batches()
    uniq, counts, n_valid = numpy_reference(batches)
    hist = np.bincount(np.clip(counts, 1, 10000), minlength=10001)
    hist[0] = 0
    t_ref = time.perf_counter() - t0
    n_distinct = int(uniq.shape[0])
    groups = -(-N_BATCHES // G_REAL)
    geom = dict(device=DEVICE, batch_rows=ROWS, row_len=ROW_LEN,
                buf_batches=G_REAL)
    eng = DistCountEngine(K_REAL, table_cap=SP_CAP,
                          spill_partitions=SP_PARTS, spill_dir=tmp, **geom)
    # the table mode's passes: the table ceiling at the planner's fill
    n_passes = -(-n_distinct // int(planner.MAX_TABLE_SLOTS
                                    * planner.TABLE_FILL_TARGET))
    cap2 = planner._round_capacity(
        int(-(-n_distinct // n_passes) / planner.TABLE_FILL_TARGET) + 1)
    eng2 = DistCountEngine(K_REAL, table_cap=cap2, n_passes=n_passes,
                           **geom)
    eng.count_stream_spilled(iter(batches[:1]))  # warm-up: first-call costs
    eng2.count_stream(iter(batches[:1]), pass_id=0)

    def check(res, what):
        if res.kmers.shape[0] != n_distinct:
            raise AssertionError(f"{what}: {res.kmers.shape[0]} distinct, "
                                 f"numpy {n_distinct}")
        vals = kmer_values(res.kmers)
        order = np.argsort(vals, kind="stable")
        if not (np.array_equal(vals[order], uniq)
                and np.array_equal(res.counts[order], counts)):
            raise AssertionError(f"{what}: table != the numpy count")
        if not np.array_equal(res.histogram, hist):
            raise AssertionError(f"{what}: histogram != the numpy count's")

    runs = {"spill": [], "table": []}
    for mode in ("spill", "table", "table", "spill"):
        torch.cuda.synchronize()
        ck.extract_wire_planes.launches = 0
        ck.extract_canonical_planes.launches = 0
        w0 = time.perf_counter()
        if mode == "spill":
            res = eng.count_stream_spilled(iter(batches))
        else:
            parts = [eng2.count_stream(iter(batches), pass_id=p)
                     for p in range(n_passes)]
        wall = time.perf_counter() - w0
        launches = (ck.extract_wire_planes.launches,
                    ck.extract_canonical_planes.launches)
        if mode == "table":
            res = merge_pass_results(parts)
            del parts
        want = (groups if mode == "spill" else n_passes * groups, 0)
        if launches != want:
            raise AssertionError(
                f"{mode}: (fused, codes-input) launches {launches}, want "
                f"{want}")
        check(res, f"{mode} count")
        runs[mode].append((wall, res.info))
        del res
    info = runs["spill"][0][1]
    n_bases = info["n_bases"]
    sub, csub = info["t_sub"], info["t_count_sub"]
    n_merged = info["spill_merged_partitions"]
    log(f"[8 spill] (b) {N_BATCHES} batches of {ROWS} x {ROW_LEN} bases, "
        f"{SP_ERR:.0%} substitutions: {n_bases} bases, {n_valid} windows, "
        f"{n_distinct} distinct (numpy count {t_ref:.1f} s); k={K_REAL}, "
        f"{G_REAL}-batch groups, {SP_PARTS} partitions, table_cap {SP_CAP}: "
        f"spill table and histogram == numpy in both runs; fused launches "
        f"{groups} (one a group), codes-input 0")
    for i, (wall, inf) in enumerate(runs["spill"]):
        s = inf["t_sub"]
        log(f"[8 spill] (b) spill run {i + 1}: wall {wall:.3f} s; fill "
            f"{inf['n_bases'] / inf['t_stream'] / 1e6:.2f} Mbases/s "
            f"({inf['t_stream']:.3f} s, t_sub {s}); spill_rows "
            f"{inf['spill_rows']}, spill_mb {inf['spill_mb']}; drain D2H "
            f"{inf['d2h_mb_per_s']} MB/s ({s['t_d2h']:.3f} s), append "
            f"{inf['spill_mb'] / max(s['t_append'], 1e-9):.1f} MB/s "
            f"({s['t_append']:.3f} s); count phase {inf['t_count_phase']:.3f}"
            f" s (read {inf['t_count_sub']['t_read']:.3f}, merge "
            f"{inf['t_count_sub']['t_merge']:.3f}, emit "
            f"{inf['t_count_sub']['t_emit']:.3f}), per-partition merge "
            f"{inf['t_count_sub']['t_merge'] / inf['spill_merged_partitions'] * 1e3:.1f}"
            f" ms; spill_splits {inf['spill_splits']}")
    log(f"[8 spill] (b) in turns spill/table/table/spill: spill "
        f"{' / '.join(f'{w:.3f}' for w, _ in runs['spill'])} s, table mode "
        f"({n_passes} passes, table_cap {cap2}) "
        f"{' / '.join(f'{w:.3f}' for w, _ in runs['table'])} s")
    del eng, eng2
    torch.cuda.empty_cache()

    # (c): the planner's inputs on the card and its choice for this input
    d2h, h2d = planner._wire_rates(DEVICE)
    fasta = os.path.join(tmp, "spill_real.fasta")
    write_fasta(batches, fasta)
    del batches
    mem = sysinfo.device_memory_mb(DEVICE)
    p0 = time.perf_counter()
    plan = planner.plan_resources(fasta, K_REAL, max_memory_mb=mem,
                                  device=DEVICE, spill="auto")
    t_plan = time.perf_counter() - p0
    log(f"[8 spill] (c) _wire_rates on the card: D2H {d2h:.1f} MB/s, H2D "
        f"{h2d:.1f} MB/s (1 MB pinned copies, CUDA events); "
        f"plan_resources(spill='auto', max_memory_mb={mem}) for this input "
        f"({t_plan:.1f} s): est_distinct {plan.est_distinct}, spill "
        f"{plan.spill}, n_passes {plan.n_passes}, n_partitions "
        f"{plan.n_partitions}, table_cap {plan.table_cap}, buf_batches "
        f"{plan.buf_batches}")
    os.unlink(fasta)
    return {"launches": groups, "spill_s": [w for w, _ in runs["spill"]],
            "table_s": [w for w, _ in runs["table"]], "fill": sub,
            "count": csub, "merged": n_merged, "numpy": (uniq, counts)}


# -- phase 9: counting across GPUs (hash-routed table mode) ------------------

N_SIM = 4            # 9(a): simulated ranks on the one card
G_SIM = 8            # 9(a): batches a rank's flush group
CAP_ERR_SIM = 12_582_912  # 9(a): a rank's table for 8(b)'s stream
# 9(a): the route step's pieces that run on one rank alone (its "counts"
# and "exchange" spans also hold the other ranks' turns on the card)
LOCAL_PIECES = ("dedup", "owners", "owner_sort", "records", "fold")


def _loopback():
    """tests/torch_loopback.py (simulated ranks: threads whose collectives
    meet at a barrier and take turns on the device), loaded from the
    checkout by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_loopback", os.path.join(ROOT, "tests", "torch_loopback.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def route_sim(batches, cap: int, **kw):
    """9(a): the batches dealt round-robin to N_SIM simulated ranks on the
    card, each counting its share through its own routed engine's
    count_stream (G_SIM-batch groups, bitmap wire, table_cap `cap`): the
    fused kernel fills a group, `_route_step` dedups, routes through the
    loopback's collectives and folds.  kw: more engine arguments (phase
    12's key-space buckets).  Returns per rank (result, route log) and
    the wall time."""
    from dsk_tpu_torch.dist.engine import DistCountEngine, _resolve_device

    loop = _loopback().Loopback(N_SIM, _resolve_device(DEVICE))

    def rank(ranks):
        eng = DistCountEngine(K_REAL, device=DEVICE, ranks=ranks,
                              batch_rows=ROWS, row_len=ROW_LEN,
                              buf_batches=G_SIM, table_cap=cap, **kw)
        res = eng.count_stream(iter(batches[ranks.rank::N_SIM]))
        return res, eng.route_log

    t0 = time.perf_counter()
    out = loop.run(rank)
    return out, time.perf_counter() - t0


def check_rank_tables(results, uniq, counts, hist_want, what: str,
                      parts: int = 0, buckets: int = 1):
    """Each rank's table against the numpy count restricted to
    kmer_hash % n == r (k <= 32: two words a k-mer), and its histogram
    (summed over the ranks by the engine) against numpy's.  parts > 0: the
    spill's owners, kmer_hash % parts % n == r (split children keep their
    owner), whose tables come in partition order and are sorted here.
    buckets > 1: the tables come bucket-major (`bucket_order` checks the
    order) and are sorted here."""
    from dsk_tpu_torch.dist.spill import kmer_hash_planes_np

    n = len(results)
    owner = kmer_hash_planes_np([
        (uniq >> np.uint64(32)).astype(np.uint32),
        (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
    owner = (owner % parts if parts else owner) % n
    for r, res in enumerate(results):
        mask = owner == r
        vals, cnt = kmer_values(res.kmers), res.counts
        if buckets > 1:
            bucket_order(res.kmers, buckets, f"{what}, rank {r}")
        if parts or buckets > 1:
            order = np.argsort(vals, kind="stable")
            vals, cnt = vals[order], cnt[order]
        if not (np.array_equal(vals, uniq[mask])
                and np.array_equal(cnt, counts[mask])):
            raise AssertionError(
                f"{what}: rank {r}'s table != numpy's k-mers of owner {r}")
        if not np.array_equal(res.histogram, hist_want):
            raise AssertionError(f"{what}: rank {r}'s histogram != numpy's")


def phase_route_sim(real_numpy, err_numpy) -> dict:
    """9(a): 4 simulated ranks on the one card at real size, phase 5's
    stream and 8(b)'s error-rich stream, through the engine's routed
    count_stream."""
    import torch

    from dsk_tpu_torch.kmer import codec
    from dsk_tpu_torch.kmer import cuda_kernels as ck

    out = {"launches": 0}
    card = card_line()
    for name, make, (uniq, counts), cap in (
            ("134-Mbase stream", make_batches, real_numpy, CAP_REAL // 4),
            ("error-rich stream", make_error_batches, err_numpy,
             CAP_ERR_SIM)):
        batches = make()
        hist_want = np.bincount(np.clip(counts, 1, 10000), minlength=10001)
        hist_want[0] = 0
        route_sim(batches[: N_SIM * G_SIM], cap)  # warm-up: first calls
        torch.cuda.synchronize()
        ck.extract_wire_planes.launches = 0
        ck.extract_canonical_planes.launches = 0
        ranks_out, wall = route_sim(batches, cap)
        launches = (ck.extract_wire_planes.launches,
                    ck.extract_canonical_planes.launches)
        results = [res for res, _ in ranks_out]
        logs = [lg for _, lg in ranks_out]
        groups = sum(len(lg.sent_rows) for lg in logs)
        if launches != (groups, 0) or groups != N_SIM * max(
                -(-len(batches[r::N_SIM]) // G_SIM) for r in range(N_SIM)):
            raise AssertionError(f"9(a) {name}: (fused, codes-input) "
                                 f"launches {launches}, rank-groups {groups}")
        check_rank_tables(results, uniq, counts, hist_want, name)
        sizes = [int(res.kmers.shape[0]) for res in results]
        ms = {p: [x for lg in logs for x in lg.ms[p]] for p in LOCAL_PIECES}
        route_ms = [sum(ms[p][i] for p in LOCAL_PIECES)
                    for i in range(groups)]
        sent = [x for lg in logs for x in lg.sent_rows]
        mean = {p: float(np.mean(v)) for p, v in ms.items()}
        rec_bytes = 4 * (codec.words_per_kmer(K_REAL) + 1)  # int32 words
        log(f"[9 routed] (a) {name}, {N_SIM} simulated ranks on the card "
            f"(threads, each its own engine's count_stream; the "
            f"collectives meet in tests/torch_loopback.py), {G_SIM}-batch "
            f"groups ({G_SIM * ROWS * (ROW_LEN - K_REAL + 1)} rows), "
            f"table_cap {cap} a rank: every rank's table == numpy's k-mers "
            f"of its owner, every rank's histogram == numpy; rank tables "
            f"{sizes}; fused launches {launches[0]} (one a rank-group), "
            f"codes-input 0; wall {wall:.3f} s for {groups // N_SIM} "
            f"groups of the {N_SIM} ranks in turns ({card})")
        log(f"[9 routed] (a) {name}, `_route_step` per rank-group, mean ms "
            f"(CUDA events; {card}): "
            + ", ".join(f"{p} {mean[p]:.3f}" for p in LOCAL_PIECES)
            + f"; route step (dedup + owners + owner sort + records + fold) "
            f"{np.mean(route_ms):.3f} ms (min {min(route_ms):.3f}, max "
            f"{max(route_ms):.3f}); sent to other ranks "
            f"{np.mean(sent) * rec_bytes / 2**20:.1f} MiB a rank-group "
            f"({int(np.mean(sent))} records of {rec_bytes} B); per group "
            f"and rank: " + "; ".join(
                f"g{g} r{r} " + " ".join(f"{lg.ms[p][g]:.3f}"
                                         for p in LOCAL_PIECES)
                + f" sent {lg.sent_rows[g]}"
                for g in range(len(logs[0].sent_rows))
                for r, lg in enumerate(logs)))
        out["launches"] += launches[0]
        out[name] = {"route_ms": float(np.mean(route_ms)), "pieces": mean,
                     "sent_mib": float(np.mean(sent)) * rec_bytes / 2**20,
                     "sent_rows": int(np.mean(sent))}
        del ranks_out, results, logs, batches
        torch.cuda.empty_cache()
    return out


def phase_nccl(tmp: str, real_numpy) -> dict:
    """9(b): a one-rank NCCL process group on the card from a TCPStore on
    localhost: execute through the routed path on the fixtures
    (-storage-type none), phase 5's batches through the routed engine,
    and the times of the collectives it launches."""
    import datetime

    import torch
    import torch.distributed as dist

    from dsk_tpu_torch.dist import multihost
    from dsk_tpu_torch.dist.engine import DistCountEngine
    from dsk_tpu_torch.engine.run import RunParams, execute
    from dsk_tpu_torch.kmer import cuda_kernels as ck

    # port 0: the OS picks a free port as the store binds it
    store = dist.TCPStore("127.0.0.1", 0, 1, True,
                          timeout=datetime.timedelta(seconds=120))
    ranks = multihost.initialize(DEVICE, rank=0, world_size=1, store=store,
                                 timeout_s=120)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, want nccl")
        ck.extract_wire_planes.launches = 0
        ck.extract_wire_planes.bank_launches = 0
        out = execute(RunParams(
            file=os.path.join(DATA, "read50x_ref10K_e001.fasta.gz"),
            kmer_size=27, abundance_min=1, histo=True, verbose=0,
            out=os.path.join(tmp, "k27_routed"), device=DEVICE,
            storage_type="none"), ranks)
        _histo_equal(out.histo_path, "k27.histo", "routed k27")
        if out.result.info.get("send_slack") is None:
            raise AssertionError("execute did not count through the routed "
                                 "engine")
        done = ["k27.histo"] + phase_bank_golden(tmp, False, ranks=ranks)
        gold = (ck.extract_wire_planes.launches,
                ck.extract_wire_planes.bank_launches)
        if gold[0] <= 0 or gold[1] <= 0:
            raise AssertionError(f"9(b) execute: (fused, with bank ids) "
                                 f"launches {gold}")
        log(f"[9 routed] (b) one-rank NCCL group (TCPStore on localhost): "
            f"execute through the routed path == the fixtures and the "
            f"oracle: {', '.join(done)}; fused launches {gold[0]} (with bank "
            f"ids {gold[1]})")

        uniq, counts = real_numpy
        batches = make_batches()
        eng = DistCountEngine(K_REAL, device=DEVICE, ranks=ranks,
                              batch_rows=ROWS, row_len=ROW_LEN,
                              buf_batches=G_REAL, table_cap=CAP_REAL)
        eng.count_stream(iter(batches[:G_REAL]))  # warm-up
        ck.extract_wire_planes.launches = 0
        ck.extract_canonical_planes.launches = 0
        t0 = time.perf_counter()
        res = eng.count_stream(iter(batches))
        wall = time.perf_counter() - t0
        stream_launches = ck.extract_wire_planes.launches
        if (stream_launches != -(-N_BATCHES // G_REAL)
                or ck.extract_canonical_planes.launches):
            raise AssertionError(f"9(b) stream: {stream_launches} fused "
                                 f"launches")
        if not (np.array_equal(kmer_values(res.kmers), uniq)
                and np.array_equal(res.counts, counts)):
            raise AssertionError("9(b) routed stream != phase 5's count")
        rate = res.info["n_bases"] / wall / 1e6
        del eng, res

        # the collectives at a group's size: the records of phase 5's
        # distinct k-mers, the (n,) counts, the histogram
        n_rec = int(uniq.shape[0])
        rec = torch.randint(0, 2**31 - 1, (n_rec, 3), dtype=torch.int32,
                            device=DEVICE)
        counts_t = torch.tensor([n_rec], dtype=torch.int64, device=DEVICE)
        hist_t = torch.ones(10001, dtype=torch.int64, device=DEVICE)
        got = ranks.all_to_all(rec, [n_rec], [n_rec])
        if not torch.equal(got, rec):
            raise AssertionError("one-rank all_to_all_single changed rows")

        def timed(fn, iters=20):
            fn()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / iters

        t_a2a = timed(lambda: ranks.all_to_all(rec, [n_rec], [n_rec]))
        t_cnt = timed(lambda: ranks.all_to_all_counts(counts_t))
        t_red = timed(lambda: ranks.all_reduce(hist_t))
        log(f"[9 routed] (b) phase 5's batches through the routed engine on "
            f"NCCL: table and histogram == phase 5's numpy count; "
            f"{rate:.2f} Mbases/s ({wall:.3f} s); fused launches "
            f"{stream_launches}; NCCL, one rank, mean of 20 (CUDA events; "
            f"{card_line()}): "
            f"all_to_all_single of {n_rec} x 12 B records {t_a2a:.4f} ms "
            f"({n_rec * 12 / t_a2a / 1e6:.1f} GB/s), of the (1,) counts "
            f"{t_cnt:.4f} ms, all_reduce of the 10001-bin histogram "
            f"{t_red:.4f} ms")
        return {"launches": stream_launches + gold[0] - gold[1],
                "bank_launches": gold[1], "rate": rate,
                "a2a_ms": t_a2a, "allreduce_ms": t_red}
    finally:
        multihost.shutdown()


# -- phase 10: superkmer routing and minimizers -------------------------------

# 10(b): the superkmer step's pieces that run on one rank alone (its
# "counts" and "exchange" spans also hold the other ranks' turns)
SK_PIECES = ("unpack", "records", "owners", "owner_sort", "payload",
             "unpack_rx", "extract", "flush")


def minimizer_cases(rng):
    """10(a): tests/test_torch_minimizer.py's shapes (random rows with N's,
    rows barely longer than k, rows with no valid base) and the real batch
    shape, as (k, codes)."""
    cases = []
    for k in (15, 21, 31, 63):
        b = rng.integers(0, 4, (32, 128)).astype(np.uint8)
        b[rng.random(b.shape) < 0.03] = 0xFF
        cases += [(k, b), (k, rng.integers(0, 4, (16, k + 2)).astype(
            np.uint8))]
    dead = np.full((4, 96), 0xFF, np.uint8)
    dead[2] = rng.integers(0, 4, 96)
    cases.append((31, dead))
    big = rng.integers(0, 4, (ROWS, ROW_LEN)).astype(np.uint8)
    big[rng.random(big.shape) < 0.001] = 4
    return cases, big


def _minimizer_outputs(mz, x, k: int, m: int, span: int) -> list:
    """Every ported function's outputs on the codes x."""
    out = list(mz.mmer_codes(x, m)) + list(mz.window_minimizers(x, k, m))
    out += list(mz.superkmer_segments(out[2], out[3]))
    out += list(mz.superkmer_records(x, k, m, span))
    return out + [mz.pack_rows_2bit(x)]


def phase_minimizers() -> dict:
    """10(a): the minimizer functions on the card against the same
    functions on the CPU, bit for bit, and their times at the real batch
    shape."""
    import torch

    from dsk_tpu_torch.kmer import minimizer as mz

    rng = np.random.default_rng(10)
    cases, big = minimizer_cases(rng)
    runs = [(k, b, m, span) for k, b in cases for m in (8, 10, 16)
            for span in (1, 32, 127) if m <= k]
    runs.append((K_REAL, big, M_SK, SPAN_SK))
    for k, b, m, span in runs:
        x = torch.from_numpy(b)
        cpu = _minimizer_outputs(mz, x, k, m, span)
        gpu = _minimizer_outputs(mz, x.cuda(), k, m, span)
        for i, (a, g) in enumerate(zip(cpu, gpu)):
            if a.dtype != g.dtype or not torch.equal(a, g.cpu()):
                raise AssertionError(f"10(a) output {i} differs on the card "
                                     f"at k={k}, m={m}, span={span}, shape "
                                     f"{b.shape}")
    words = torch.from_numpy(rng.integers(0, 2**32, (4096, 6),
                                          dtype=np.int64))
    off = torch.from_numpy(rng.integers(0, 16, 4096))
    if not torch.equal(mz.unpack_records_to_rows(words, off, 62),
                       mz.unpack_records_to_rows(words.cuda(), off.cuda(),
                                                 62).cpu()):
        raise AssertionError("10(a) unpack_records_to_rows differs")
    x = torch.from_numpy(big).cuda()
    mins, valid = mz.window_minimizers(x, K_REAL, M_SK)
    times = {
        "mmer_codes": cuda_ms(lambda: mz.mmer_codes(x, M_SK), 10),
        "window_minimizers": cuda_ms(
            lambda: mz.window_minimizers(x, K_REAL, M_SK), 10),
        "superkmer_segments": cuda_ms(
            lambda: mz.superkmer_segments(mins, valid), 10),
        "superkmer_records": cuda_ms(
            lambda: mz.superkmer_records(x, K_REAL, M_SK, SPAN_SK), 10),
        "pack_rows_2bit": cuda_ms(lambda: mz.pack_rows_2bit(x), 10),
    }
    log(f"[10 superkmer] (a) the minimizer functions on the card == on the "
        f"CPU, bit for bit, on {len(runs)} cases (k in 15, 21, 31, 63 x m "
        f"in 8, 10, 16 x max_span 1, 32, 127; random rows, rows of k + 2 "
        f"bases, rows with no valid base; a {ROWS} x {ROW_LEN} batch) and "
        f"unpack_records_to_rows; at ({ROWS}, {ROW_LEN}), k={K_REAL}, "
        f"m={M_SK}, max_span {SPAN_SK}, mean of 10 (CUDA events; "
        f"{card_line()}): " + ", ".join(f"{n} {t:.4f} ms"
                                        for n, t in times.items()))
    return times


def sampled_table(batches, n: int) -> np.ndarray:
    """10(b): a frequency-aware minimizer -> rank table from the window
    minimizers of the stream's first batch (2 Mbases, the reference
    samples 1), counted on the card."""
    import torch

    from dsk_tpu_torch.kmer import minimizer as mz

    mins, valid = mz.window_minimizers(
        torch.from_numpy(batches[0].codes).cuda(), K_REAL, M_SK)
    freq = torch.bincount(mins[valid], minlength=4**M_SK).cpu().numpy()
    return mz.build_repartition(freq, n, frequency_aware=True)


def kmer_owners(uniq: np.ndarray, table: np.ndarray) -> np.ndarray:
    """The rank each k-mer (k = K_REAL, uint64 values) belongs on:
    table[its minimizer], the minimizer computed on the card with the
    port's plain functions, 2M k-mers at a time."""
    import torch

    from dsk_tpu_torch.kmer import minimizer as mz

    shifts = torch.arange(2 * (K_REAL - 1), -1, -2, device=DEVICE)
    tab = torch.from_numpy(table.astype(np.int64)).to(DEVICE)
    out = []
    for i in range(0, uniq.shape[0], 1 << 21):
        v = torch.from_numpy(uniq[i: i + (1 << 21)].astype(np.int64)).to(
            DEVICE)
        codes = ((v[:, None] >> shifts[None, :]) & 3).to(torch.uint8)
        mins, valid = mz.window_minimizers(codes, K_REAL, M_SK)
        if not bool(valid.all()):
            raise AssertionError("a numpy k-mer has no valid minimizer")
        out.append(tab[mins[:, 0]].cpu().numpy())
    return np.concatenate(out)


def route_sim_sk(batches, cap: int, table: np.ndarray):
    """10(b): route_sim with superkmer routing by `table`."""
    from dsk_tpu_torch.dist.engine import DistCountEngine, _resolve_device

    loop = _loopback().Loopback(N_SIM, _resolve_device(DEVICE))

    def rank(ranks):
        eng = DistCountEngine(K_REAL, device=DEVICE, ranks=ranks,
                              batch_rows=ROWS, row_len=ROW_LEN,
                              buf_batches=G_SIM, table_cap=cap,
                              routing="superkmer", minimizer_size=M_SK,
                              max_span=SPAN_SK, repartition=table)
        if eng.routing != "superkmer":
            raise AssertionError("10(b): the engine did not route by "
                                 "superkmer")
        res = eng.count_stream(iter(batches[ranks.rank::N_SIM]))
        return res, eng.route_log

    t0 = time.perf_counter()
    out = loop.run(rank)
    return out, time.perf_counter() - t0


def plane_diff(got, want, what: str) -> int:
    """max |got - want| of two int64 plane tensors of one shape (0 when
    empty); raises if the shapes differ."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: kernel shape {tuple(got.shape)} != "
                             f"plain {tuple(want.shape)}")
    return int((got - want).abs().max().item()) if got.numel() else 0


def step_peaks(batches, table: np.ndarray, rates: dict) -> dict:
    """10(b): one rank-group through the engine's own `_route_step_sk` on
    the card, its N_SIM - 1 peers mirrored (each sends this rank what
    this rank sends it, so the owner side receives as many records as
    the group made, what a rank receives a group when the table balances
    the load): the peak device bytes of the sender (wire unpack to
    payload) and of the whole step, beside the planner's charges; and the
    records-input kernel on the records the step received, against its
    plain version, bit for bit, both timed, with its bound there, in turns
    with the composition it replaced (`extract_record_planes_torch` with
    the codes-input kernel as its extraction, whose unpack and
    codes-input kernel are also timed alone)."""
    import torch

    from dsk_tpu_torch.dist import engine as dist_engine
    from dsk_tpu_torch.dist.multihost import Ranks
    from dsk_tpu_torch.engine import planner
    from dsk_tpu_torch.kmer import cuda_kernels as ck

    peaks = {}

    class Mirror(Ranks):
        """Ranks whose peers mirror this rank; its exchange reads the
        sender's peak and restarts the count for the owner side."""

        def all_reduce(self, t):
            return t

        def all_to_all_counts(self, send_counts):
            return send_counts.clone()

        def all_to_all(self, send, send_splits, recv_splits):
            torch.cuda.synchronize()
            peaks["send"] = torch.cuda.max_memory_allocated()
            return send.clone()

    eng = dist_engine.DistCountEngine(
        K_REAL, device=DEVICE, batch_rows=ROWS, row_len=ROW_LEN,
        buf_batches=G_SIM, table_cap=CAP_REAL // 4, routing="superkmer",
        minimizer_size=M_SK, max_span=SPAN_SK, repartition=table,
        ranks=Mirror(0, N_SIM, dist_engine._resolve_device(DEVICE)))
    words, meta = wire_group([b.codes for b in batches[:G_SIM]], "bitmap")
    state = eng._init_state()
    table_bytes = sum(t.numel() * t.element_size() for t in state)
    seen = []
    real_extract = dist_engine.extract_record_planes

    def capture(recv, *args):  # the owner's records, kept on the host
        seen.append(recv.cpu())
        return real_extract(recv, *args)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dist_engine.extract_record_planes = capture
    try:
        eng._route_step_sk((words, meta, None), *state, 0)
    finally:
        dist_engine.extract_record_planes = real_extract
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - base
    send_peak = peaks["send"] - base
    buf_rows = G_SIM * ROWS * (ROW_LEN - K_REAL + 1)
    WK = 2
    sk_row = planner.superkmer_row_bytes(WK, K_REAL, N_SIM, 2.5, M_SK,
                                         SPAN_SK)
    charge = (planner.device_bytes(WK, CAP_REAL // 4, buf_rows)
              + buf_rows * sk_row)
    if send_peak > buf_rows * planner.SK_SEND_ROW_BYTES:
        raise AssertionError(
            f"10(b) the sender's peak {send_peak / buf_rows:.1f} B a buffer "
            f"row > SK_SEND_ROW_BYTES {planner.SK_SEND_ROW_BYTES}")
    if table_bytes + step_peak > charge:
        raise AssertionError(
            f"10(b) the step's peak {table_bytes + step_peak} B (table "
            f"included) > the planner's charge {charge} B")
    del state, words, meta
    rx = seen[0].to(DEVICE)
    R = rx.shape[0]

    def before():  # the composition the records-input kernel replaced
        return ck.extract_record_planes_torch(
            rx, K_REAL, SPAN_SK, extract=ck.extract_canonical_planes)

    err, n_live = 0, None
    # one pass as the step ran it, then the count pass (n_passes > 1) and
    # the bank plane on the same records
    for n_passes, pass_id, bank in ((1, 0, False), (3, 0, False),
                                    (3, 1, True), (3, 2, False),
                                    (1, 0, True)):
        args = (rx, K_REAL, SPAN_SK, n_passes, pass_id, bank)
        got = ck.extract_record_planes(*args)
        want = ck.extract_record_planes_torch(*args)
        what = (f"10(b) records-input kernel vs plain on the step's {R} "
                f"records at pass {pass_id} of {n_passes}, bank plane {bank}")
        d = plane_diff(got, want, what)
        if d:
            raise AssertionError(f"{what}: max |diff| {d}")
        err = max(err, d)
        if n_live is None:
            n_live = got.shape[1]
            if not torch.equal(before(), want):
                raise AssertionError("10(b) the replaced owner composition "
                                     "!= the records-input kernel's plain "
                                     "version")
        del got, want
    offsets = ck.record_offsets(rx, K_REAL, SPAN_SK)
    t = {"kernel": [], "before": []}
    for turn in ("kernel", "before", "before", "kernel"):
        if turn == "kernel":
            t[turn].append(cuda_ms(lambda: ck.extract_record_planes(
                rx, K_REAL, SPAN_SK, offsets=offsets), 20))
        else:
            t[turn].append(cuda_ms(before, 5))
    dev_ms = device_ms(lambda: ck.extract_record_planes(
        rx, K_REAL, SPAN_SK, offsets=offsets), 20)
    offsets_ms = cuda_ms(lambda: ck.record_offsets(rx, K_REAL, SPAN_SK), 20)
    unpack_ms = cuda_ms(lambda: ck.record_codes(rx, K_REAL, SPAN_SK), 5)
    codes = ck.record_codes(rx, K_REAL, SPAN_SK)[0]
    codes_ms = cuda_ms(lambda: ck.extract_canonical_planes(codes, K_REAL), 20)
    del codes
    plain_ms = cuda_ms(lambda: ck.extract_record_planes_torch(
        rx, K_REAL, SPAN_SK), 3)
    bound, by = record_extract_bound(rates, R, n_live)
    log(f"[10 superkmer] (b) one rank-group through `_route_step_sk`, its "
        f"peers mirrored ({G_SIM} batches, {buf_rows} windows): {R} records "
        f"({buf_rows / R:.2f} windows a record), {n_live} live windows at "
        f"the owner; peak device bytes above the table and the wire: the "
        f"sender (unpack to payload) {send_peak / buf_rows:.1f} B a buffer "
        f"row against SK_SEND_ROW_BYTES {planner.SK_SEND_ROW_BYTES}, the "
        f"whole step {step_peak / buf_rows:.1f} B a buffer row; with the "
        f"table ({table_bytes} B, {CAP_REAL // 4} slots) "
        f"{table_bytes + step_peak} B against the planner's charge {charge} B "
        f"(device_bytes + {sk_row} B a buffer row); records-input kernel == "
        f"plain on the step's records ({R}, {rx.shape[1]}), bit for bit "
        f"(max |diff| {err}), and at every pass of 3 and with the bank "
        f"plane: "
        f"kernel {dev_ms:.4f} ms (device time a launch, `device_ms`; "
        f"in turns, CUDA events {' / '.join(f'{x:.4f}' for x in t['kernel'])}"
        f" ms), bound {bound:.4f} ms by {by} ({bound / dev_ms:.3f} of it), plain "
        f"{plain_ms:.4f} ms; its offsets (scan and host read) "
        f"{offsets_ms:.4f} ms; before, in turns with the kernel (torch "
        f"unpack, codes-input kernel, mask compaction): "
        f"{' / '.join(f'{x:.4f}' for x in t['before'])} ms, its unpack "
        f"alone {unpack_ms:.4f} ms, its codes-input kernel alone "
        f"{codes_ms:.4f} ms (CUDA events, mean of 20 / 5; {card_line()})")
    del rx, offsets
    torch.cuda.empty_cache()
    return {"ms": dev_ms, "event_ms": t["kernel"], "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by, "max_abs_err": err, "shape": (R, n_live),
            "offsets_ms": offsets_ms, "before_ms": t["before"],
            "unpack_ms": unpack_ms, "codes_ms": codes_ms,
            "send_row_bytes": send_peak / buf_rows,
            "step_row_bytes": step_peak / buf_rows}


def phase_superkmer(real_numpy, err_numpy, routed: dict, rates: dict) -> dict:
    """10(b): 4 simulated ranks on the one card at real size routing by
    superkmer: phase 5's stream and 8(b)'s error-rich stream, through the
    engine's routed count_stream, against numpy and beside phase 9(a)'s
    hash route on the same batches."""
    import torch

    from dsk_tpu_torch.kmer import cuda_kernels as ck

    out = {"launches": 0, "codes_launches": 0}
    card = card_line()
    for name, make, (uniq, counts), cap in (
            ("134-Mbase stream", make_batches, real_numpy, CAP_REAL // 4),
            ("error-rich stream", make_error_batches, err_numpy,
             CAP_ERR_SIM)):
        batches = make()
        table = sampled_table(batches, N_SIM)
        if name == "134-Mbase stream":
            out["kernel"] = step_peaks(batches, table, rates)
        hist_want = np.bincount(np.clip(counts, 1, 10000), minlength=10001)
        hist_want[0] = 0
        route_sim_sk(batches[: N_SIM * G_SIM], cap, table)  # warm-up
        torch.cuda.synchronize()
        ck.extract_wire_planes.launches = 0
        ck.extract_canonical_planes.launches = 0
        ck.extract_record_planes.launches = 0
        ck.extract_record_planes.count_launches = 0
        ranks_out, wall = route_sim_sk(batches, cap, table)
        launches = (ck.extract_wire_planes.launches,
                    ck.extract_canonical_planes.launches,
                    ck.extract_record_planes.launches,
                    ck.extract_record_planes.count_launches)
        results = [res for res, _ in ranks_out]
        logs = [lg for _, lg in ranks_out]
        groups = sum(len(lg.sent_rows) for lg in logs)
        # every rank-group receives records here: one records-input launch
        # each (one pass: no count pass), and neither the fused nor the
        # codes-input kernel runs on this path
        if launches != (0, 0, groups, 0) or groups != N_SIM * max(
                -(-len(batches[r::N_SIM]) // G_SIM) for r in range(N_SIM)):
            raise AssertionError(f"10(b) {name}: (fused, codes-input, "
                                 f"records-input, its count pass) launches "
                                 f"{launches}, rank-groups {groups}")
        owner = kmer_owners(uniq, table)
        for r, res in enumerate(results):
            mask = owner == r
            if not (np.array_equal(kmer_values(res.kmers), uniq[mask])
                    and np.array_equal(res.counts, counts[mask])):
                raise AssertionError(
                    f"10(b) {name}: rank {r}'s table != numpy's k-mers "
                    f"whose minimizer the table maps to {r}")
            if not np.array_equal(res.histogram, hist_want):
                raise AssertionError(f"10(b) {name}: rank {r}'s histogram "
                                     f"!= numpy's")
        sizes = [int(res.kmers.shape[0]) for res in results]
        ms = {p: [x for lg in logs for x in lg.ms[p]] for p in SK_PIECES}
        step_ms = [sum(ms[p][i] for p in SK_PIECES) for i in range(groups)]
        sent = [x for lg in logs for x in lg.sent_rows]
        rec_bytes = logs[0].record_bytes
        mean = {p: float(np.mean(v)) for p, v in ms.items()}
        sent_mib = float(np.mean(sent)) * rec_bytes / 2**20
        hashed = routed[name]
        log(f"[10 superkmer] (b) {name}, {N_SIM} simulated ranks on the "
            f"card, superkmer routing (m={M_SK}, max_span {SPAN_SK}, a "
            f"frequency-aware table sampled from the first batch), "
            f"{G_SIM}-batch groups, table_cap {cap} a rank: the rank tables "
            f"are disjoint, their union == numpy's count, every k-mer on the "
            f"rank its minimizer maps to, every histogram == numpy; rank "
            f"tables {sizes}; records-input launches {launches[2]} (one a "
            f"rank-group), fused 0, codes-input 0; wall {wall:.3f} s "
            f"({card})")
        log(f"[10 superkmer] (b) {name}, `_route_step_sk` per rank-group, "
            f"mean ms (CUDA events; {card}): "
            + ", ".join(f"{p} {mean[p]:.3f}" for p in SK_PIECES)
            + f"; step (the pieces a rank runs alone) {np.mean(step_ms):.3f}"
            f" ms (min {min(step_ms):.3f}, max {max(step_ms):.3f}) against "
            f"the hash route's {hashed['route_ms']:.3f} ms (9(a)); sent to "
            f"other ranks {sent_mib:.1f} MiB a rank-group "
            f"({int(np.mean(sent))} records of {rec_bytes} B) against the "
            f"hash route's {hashed['sent_mib']:.1f} MiB ("
            f"{hashed['sent_rows']} records of 12 B): "
            f"{sent_mib / hashed['sent_mib']:.2f}x; per group and rank: "
            + "; ".join(
                f"g{g} r{r} " + " ".join(f"{lg.ms[p][g]:.3f}"
                                         for p in SK_PIECES)
                + f" sent {lg.sent_rows[g]}"
                for g in range(len(logs[0].sent_rows))
                for r, lg in enumerate(logs)))
        out["launches"] += launches[2]
        out["codes_launches"] += launches[1]
        out[name] = {"step_ms": float(np.mean(step_ms)), "pieces": mean,
                     "sent_mib": sent_mib}
        del ranks_out, results, logs, batches
        torch.cuda.empty_cache()
    return out


def phase_superkmer_execute(tmp: str) -> None:
    """10(c): execute on the card with -minimizer-type 1 on the k27
    fixture (-storage-type none) and -trace-dir: .histo == k27.histo,
    info["repartition"] == the port's CPU run of the same, a trace that
    names the fused kernel."""
    from dsk_tpu_torch.engine.run import RunParams, execute
    from dsk_tpu_torch.kmer import cuda_kernels as ck

    common = dict(file=os.path.join(DATA, "read50x_ref10K_e001.fasta.gz"),
                  kmer_size=27, abundance_min=1, histo=True, verbose=0,
                  minimizer_type=1, storage_type="none")
    traces = os.path.join(tmp, "traces")
    ck.extract_wire_planes.launches = 0
    ck.extract_canonical_planes.launches = 0
    ck.extract_record_planes.launches = 0
    out = execute(RunParams(out=os.path.join(tmp, "mz"), device=DEVICE,
                            trace_dir=traces, **common))
    launches = (ck.extract_wire_planes.launches,
                ck.extract_canonical_planes.launches,
                ck.extract_record_planes.launches)
    _histo_equal(out.histo_path, "k27.histo", "-minimizer-type 1")
    cpu = execute(RunParams(out=os.path.join(tmp, "mz_cpu"), device="cpu",
                            **common))
    if out.info.get("repartition") != cpu.info["repartition"]:
        raise AssertionError(f"10(c) repartition {out.info.get('repartition')}"
                             f" != the CPU run's {cpu.info['repartition']}")
    if launches[0] <= 0 or launches[1] or launches[2]:
        raise AssertionError(f"10(c) (fused, codes-input, records-input) "
                             f"launches {launches}")
    files = sorted(f for f in os.listdir(traces) if f.endswith(".json"))
    named = [f for f in files
             if "wire_extract" in open(os.path.join(traces, f)).read()]
    if not named:
        raise AssertionError(f"10(c) no trace in {files} names the fused "
                             f"kernel")
    rep = out.info["repartition"]
    log(f"[10 superkmer] (c) execute on the card with -minimizer-type 1: "
        f".histo == k27.histo, info['repartition'] == the CPU run's "
        f"(minimizer_size {rep['minimizer_size']}, "
        f"{rep['nb_minimizers_seen']} minimizers seen, loads "
        f"{rep['partition_loads']}); fused launches {launches[0]}; "
        f"-trace-dir wrote {named[0]} "
        f"({os.path.getsize(os.path.join(traces, named[0]))} bytes), which "
        f"names the fused kernel")


# -- phase 11: spill across ranks --------------------------------------------


def spill_sim(batches, cap: int, tmp: str, sink=None):
    """11(a): the batches dealt round-robin to N_SIM simulated ranks on the
    card, each counting its share through its own engine's
    count_stream_spilled (G_REAL-batch groups, SP_PARTS partitions,
    table_cap `cap`, every rank's partition files in one directory under
    tmp): the fused kernel fills a group, `_spill_step` dedups and
    partitions it, the writer thread appends its records; the ranks agree
    once a group and once at the fill's end, then each rank counts the
    partitions it owns, a round at a time.  sink: rank 0's pass sink, fed
    every rank's partitions by the rounds' gathers (else each rank's
    result holds its own).  Returns the ranks' results and the wall
    time."""
    from dsk_tpu_torch.dist.engine import DistCountEngine, _resolve_device

    loop = _loopback().Loopback(N_SIM, _resolve_device(DEVICE))

    def not_root(*_args):
        raise AssertionError("11(a): a sink ran on a rank other than 0")

    def rank(ranks):
        eng = DistCountEngine(K_REAL, device=DEVICE, ranks=ranks,
                              batch_rows=ROWS, row_len=ROW_LEN,
                              buf_batches=G_REAL, table_cap=cap,
                              spill_partitions=SP_PARTS, spill_dir=tmp)
        kw = {}
        if sink is not None:
            kw["pass_sink"] = sink if ranks.rank == 0 else not_root
        return eng.count_stream_spilled(iter(batches[ranks.rank::N_SIM]),
                                        **kw)

    t0 = time.perf_counter()
    out = loop.run(rank)
    return out, time.perf_counter() - t0


def _spill_rank_line(infos) -> str:
    """Each rank's fill and count times, the fill's per-group agreements'
    and the count rounds' wait, and the spilled rows."""
    return "; ".join(
        f"r{r} fill {i['t_stream']:.3f} s (agree "
        f"{i['t_sub']['t_agree']:.3f}), count {i['t_count_phase']:.3f} s "
        f"(wait {i['t_count_sub']['t_wait']:.3f}, read "
        f"{i['t_count_sub']['t_read']:.3f}, merge "
        f"{i['t_count_sub']['t_merge']:.3f}, emit "
        f"{i['t_count_sub']['t_emit']:.3f}), partitions "
        f"{len(i['partition_sizes'])}, splits {i['spill_splits']}, spill_rows "
        f"{i['spill_rows']}, spill_mb {i['spill_mb']}"
        for r, i in enumerate(infos))


def phase_spill_ranks(tmp: str, err_numpy) -> dict:
    """11(a): 8(b)'s error-rich stream in spill mode on N_SIM simulated
    ranks, in turns with 8(b)'s one-rank spill, then once at SP_CAP // 8,
    where partitions must split, with a sink on rank 0 that every
    partition reaches through the rounds' gathers."""
    import torch

    from dsk_tpu_torch.dist.engine import DistCountEngine
    from dsk_tpu_torch.kmer import cuda_kernels as ck

    uniq, counts = err_numpy
    hist_want = np.bincount(np.clip(counts, 1, 10000), minlength=10001)
    hist_want[0] = 0
    batches = make_error_batches()
    groups = sum(-(-len(batches[r::N_SIM]) // G_REAL) for r in range(N_SIM))
    one = DistCountEngine(K_REAL, device=DEVICE, batch_rows=ROWS,
                          row_len=ROW_LEN, buf_batches=G_REAL,
                          table_cap=SP_CAP, spill_partitions=SP_PARTS,
                          spill_dir=tmp)
    spill_sim(batches[:N_SIM], SP_CAP, tmp)  # warm-up: first calls
    one.count_stream_spilled(iter(batches[:1]))
    card = card_line()
    runs = {"one": [], "ranks": []}
    path_launches = 0

    def reset():
        torch.cuda.synchronize()
        ck.extract_wire_planes.launches = 0
        ck.extract_canonical_planes.launches = 0
        ck.extract_record_planes.launches = 0

    def launches():
        return (ck.extract_wire_planes.launches,
                ck.extract_canonical_planes.launches,
                ck.extract_record_planes.launches)

    for mode in ("one", "ranks", "ranks", "one"):
        reset()
        if mode == "one":
            w0 = time.perf_counter()
            res = one.count_stream_spilled(iter(batches))
            wall = time.perf_counter() - w0
            got, want = launches(), (-(-N_BATCHES // G_REAL), 0, 0)
            if (res.kmers.shape[0] != uniq.shape[0]
                    or not np.array_equal(res.histogram, hist_want)):
                raise AssertionError("11(a) one-rank spill != numpy")
            infos = [res.info]
            del res
        else:
            results, wall = spill_sim(batches, SP_CAP, tmp)
            got, want = launches(), (groups, 0, 0)
            check_rank_tables(results, uniq, counts, hist_want,
                              "11(a) spill across ranks", parts=SP_PARTS)
            path_launches += got[0]
            infos = [r.info for r in results]
            del results
        if got != want:
            raise AssertionError(f"11(a) {mode}: (fused, codes-input, "
                                 f"records-input) launches {got}, want "
                                 f"{want}")
        runs[mode].append((wall, infos))
    reset()
    sunk = []

    def sink(_pass_id, pid, kk, cc):
        sunk.append((pid, kmer_values(kk), np.array(cc)))

    results, wall_split = spill_sim(batches, SP_CAP // 8, tmp, sink)
    got = launches()
    split_infos = [r.info for r in results]
    pids = sorted(p for p, _, _ in sunk)
    vals = np.concatenate([v for _, v, _ in sunk])
    cnt = np.concatenate([c for _, _, c in sunk])
    order = np.argsort(vals, kind="stable")
    if (not np.array_equal(vals[order], uniq)
            or not np.array_equal(cnt[order], counts)
            or len(set(pids)) != len(pids)
            or pids != sorted(p for i in split_infos
                              for p in i["partition_ids"])
            or any(r.kmers.shape[0]
                   or not np.array_equal(r.histogram, hist_want)
                   for r in results)):
        raise AssertionError("11(a) spill across ranks with splits: rank "
                             "0's sink != numpy's table")
    del results, sunk, vals, cnt, order
    splits = sum(i["spill_splits"] for i in split_infos)
    if got != (groups, 0, 0) or splits < 1:
        raise AssertionError(f"11(a) at table_cap {SP_CAP // 8}: launches "
                             f"{got}, spill_splits {splits}")
    path_launches += got[0]
    if os.listdir(tmp):
        raise AssertionError(f"11(a) spill files left: {os.listdir(tmp)}")
    rows = [sum(i["spill_rows"] for i in infos) for _, infos in runs["ranks"]]
    log(f"[11 spill ranks] (a) 8(b)'s error-rich stream ({uniq.shape[0]} "
        f"distinct) dealt round-robin to {N_SIM} simulated ranks on the card "
        f"(threads, each its own engine's count_stream_spilled, "
        f"{G_REAL}-batch groups, {SP_PARTS} partitions in one directory, "
        f"table_cap {SP_CAP}; collectives in tests/torch_loopback.py): every "
        f"rank's partitions == numpy's k-mers of hash % {SP_PARTS} % {N_SIM} "
        f"== r, every histogram == numpy's, in both runs; fused launches "
        f"{groups} a run (one a rank-group), codes-input 0, records-input 0; "
        f"spilled rows over the ranks {rows[0]} (one rank, 8(b)'s: "
        f"{runs['one'][0][1][0]['spill_rows']}); at table_cap "
        f"{SP_CAP // 8} with a sink on rank 0: spill_splits {splits}, "
        f"{len(pids)} partitions gathered to rank 0's sink, its table == "
        f"numpy's ({card})")
    for i, (wall, infos) in enumerate(runs["ranks"]):
        log(f"[11 spill ranks] (a) {N_SIM} ranks, run {i + 1}: wall "
            f"{wall:.3f} s; {_spill_rank_line(infos)}")
    for i, (wall, infos) in enumerate(runs["one"]):
        log(f"[11 spill ranks] (a) one rank (8(b)), run {i + 1}: wall "
            f"{wall:.3f} s; {_spill_rank_line(infos)}")
    log(f"[11 spill ranks] (a) in turns one/{N_SIM} ranks/{N_SIM} ranks/one: "
        f"one rank {' / '.join(f'{w:.3f}' for w, _ in runs['one'])} s, "
        f"{N_SIM} simulated ranks "
        f"{' / '.join(f'{w:.3f}' for w, _ in runs['ranks'])} s; at table_cap "
        f"{SP_CAP // 8} {wall_split:.3f} s: {_spill_rank_line(split_infos)}")
    return {"launches": path_launches,
            "one_s": [w for w, _ in runs["one"]],
            "ranks_s": [w for w, _ in runs["ranks"]], "rows": rows}


def phase_spill_nccl(tmp: str) -> int:
    """11(b): a one-rank NCCL process group through execute with -spill on
    on the k27 fixture (-storage-type none): .histo == k27.histo.
    Returns the fused launches."""
    import datetime

    import torch.distributed as dist

    from dsk_tpu_torch.dist import multihost
    from dsk_tpu_torch.engine.run import RunParams, execute
    from dsk_tpu_torch.kmer import cuda_kernels as ck

    store = dist.TCPStore("127.0.0.1", 0, 1, True,
                          timeout=datetime.timedelta(seconds=120))
    ranks = multihost.initialize(DEVICE, rank=0, world_size=1, store=store,
                                 timeout_s=120)
    try:
        ck.extract_wire_planes.launches = 0
        ck.extract_canonical_planes.launches = 0
        out = execute(RunParams(
            file=os.path.join(DATA, "read50x_ref10K_e001.fasta.gz"),
            kmer_size=27, abundance_min=1, histo=True, verbose=0,
            out=os.path.join(tmp, "k27_spill_ranks"), device=DEVICE,
            storage_type="none", spill="on", spill_partitions=4), ranks)
        launches = (ck.extract_wire_planes.launches,
                    ck.extract_canonical_planes.launches)
        _histo_equal(out.histo_path, "k27.histo", "11(b) -spill on, NCCL")
        if not out.result.info.get("spill") or launches[0] <= 0 or launches[1]:
            raise AssertionError(f"11(b) spill {out.result.info.get('spill')}"
                                 f", (fused, codes-input) launches "
                                 f"{launches}")
        log(f"[11 spill ranks] (b) one-rank NCCL group (backend "
            f"{dist.get_backend()}): execute -spill on -spill-partitions 4 "
            f"on the k27 fixture: .histo == k27.histo; fused launches "
            f"{launches[0]}")
        return launches[0]
    finally:
        multihost.shutdown()


# -- phase 12: key-space buckets of the flush; -max-disk across ranks --------

S_REAL = 8          # 12: key-space buckets, capb = CAP_REAL // 8 = 196,608
MAXD_RANKS = 600    # 12(d): -max-disk, MB: a spill budget of 450 MB


def bucket_of(kmers: np.ndarray, S: int) -> np.ndarray:
    """Each (n, 2) uint32 row's bucket: the top log2 S bits of its hash."""
    from dsk_tpu_torch.dist.spill import kmer_hash_planes_np

    h = kmer_hash_planes_np([np.ascontiguousarray(kmers[:, 0]),
                             np.ascontiguousarray(kmers[:, 1])])
    return h >> np.uint32(32 - (S.bit_length() - 1))


def bucket_order(kmers: np.ndarray, S: int, what: str) -> np.ndarray:
    """Rows gathered from a bucket-major table: their buckets never
    decrease and the rows ascend within each bucket.  Returns the rows a
    bucket."""
    b = bucket_of(kmers, S)
    vals = kmer_values(kmers)
    db = np.diff(b.astype(np.int64))
    if (db < 0).any() or ((db == 0) & (np.diff(vals) <= 0)).any():
        raise AssertionError(f"{what}: the rows are not bucket-major, "
                             f"ascending within each bucket")
    return np.bincount(b, minlength=S)


def bucket_table(tab_p, tab_c, S: int, what: str) -> np.ndarray:
    """A whole (2, cap) bucket-major table on the card: bucket b's slots
    [b * capb, (b + 1) * capb) hold its live rows first, each of bucket b,
    ascending, then dead rows.  Returns the rows a bucket."""
    from dsk_tpu_torch.dist.engine import state_to_jax

    planes, counts = state_to_jax(tab_p, tab_c)
    capb = counts.shape[0] // S
    live = (counts > 0).reshape(S, capb)
    n_b = live.sum(1)
    if (live != (np.arange(capb)[None, :] < n_b[:, None])).any():
        raise AssertionError(f"{what}: a bucket's live rows are not its "
                             f"first slots")
    keep = live.reshape(-1)
    rows = planes[:, keep].T
    if (np.repeat(np.arange(S), n_b) != bucket_of(rows, S)).any():
        raise AssertionError(f"{what}: a row sits in another bucket than "
                             f"its hash's")
    if not np.array_equal(bucket_order(rows, S, what), n_b):
        raise AssertionError(f"{what}: bucket sizes differ")
    if (planes[:, ~keep] != SENTINEL).any():
        raise AssertionError(f"{what}: a dead slot holds a key")
    return n_b


def phase_buckets_real(real_numpy) -> dict:
    """12(a): phase 5's stream with S_REAL key-space buckets,
    bucketize_at "flush" and "route", in turns with the flat flush (S=1);
    each table against numpy and checked bucket-major slot by slot; the
    flush's pieces (CUDA events, the engine's own flush_log); the peak
    device bytes a buffer row of one 8-batch flush of each."""
    import torch

    from dsk_tpu_torch.dist.engine import DistCountEngine, _RouteLog
    from dsk_tpu_torch.kmer import cuda_kernels as ck

    uniq, counts = real_numpy
    hist_want = np.bincount(np.clip(counts, 1, 10000), minlength=10001)
    hist_want[0] = 0
    batches = make_batches()
    geom = dict(device=DEVICE, batch_rows=ROWS, row_len=ROW_LEN,
                buf_batches=G_REAL, table_cap=CAP_REAL)
    variants = {"S=1": {}, "flush": dict(flush_buckets=S_REAL),
                "route": dict(flush_buckets=S_REAL, bucketize_at="route")}
    engines = {name: DistCountEngine(K_REAL, **geom, **kw)
               for name, kw in variants.items()}
    for name, eng in engines.items():
        if eng.plan.S != (1 if name == "S=1" else S_REAL):
            raise AssertionError(f"12(a) {name}: S {eng.plan.S}")
        eng.count_stream(iter(batches[:G_REAL]))  # warm-up: first calls
    groups = -(-N_BATCHES // G_REAL)
    runs = {name: [] for name in variants}
    path_launches = 0
    sizes = None
    for name in ("S=1", "flush", "route", "route", "flush", "S=1"):
        eng = engines[name]
        eng.flush_log = _RouteLog(eng.device, _RouteLog.FLUSH_PIECES)
        torch.cuda.synchronize()
        ck.extract_wire_planes.launches = 0
        ck.extract_canonical_planes.launches = 0
        t0 = time.perf_counter()
        res = eng.count_stream(iter(batches), finalize=False)  # drained
        wall = time.perf_counter() - t0
        launches = (ck.extract_wire_planes.launches,
                    ck.extract_canonical_planes.launches)
        torch.cuda.synchronize()
        eng.flush_log.settle()
        if launches != (groups, 0):
            raise AssertionError(f"12(a) {name}: (fused, codes-input) "
                                 f"launches {launches}, want ({groups}, 0)")
        if name != "S=1":
            path_launches += launches[0]
            sizes = bucket_table(*eng._last_state, S_REAL, f"12(a) {name}")
        (_, kmers, cnt), = eng.iter_partitions()
        if name != "S=1" and not np.array_equal(
                bucket_order(kmers, S_REAL, f"12(a) {name}"), sizes):
            raise AssertionError(f"12(a) {name}: gathered buckets differ")
        order = np.argsort(kmer_values(kmers), kind="stable")
        if not (np.array_equal(kmer_values(kmers)[order], uniq)
                and np.array_equal(cnt[order], counts)
                and np.array_equal(res.histogram, hist_want)):
            raise AssertionError(f"12(a) {name}: table != numpy's count")
        runs[name].append((wall, {p: sum(v) for p, v in
                                  eng.flush_log.ms.items()}))
        eng.flush_log = None
        eng._last_state = None
        del res, kmers, cnt, order
    del engines
    torch.cuda.empty_cache()
    staged = [wire_group([b.codes for b in batches[:8]], "exc") + (None,)]
    peaks = {name: flush_peak_bytes(False, staged, **kw)
             for name, kw in variants.items()}
    card = card_line()
    log(f"[12 buckets] (a) phase 5's stream ({uniq.shape[0]} distinct), "
        f"table_cap {CAP_REAL}, S={S_REAL} (capb {CAP_REAL // S_REAL}, "
        f"rows a bucket {sizes.tolist()}), bucketize_at flush and route, in "
        f"turns with S=1: every table == numpy's count, every bucket's "
        f"rows its hash's top 3 bits, first in its slots, ascending; fused "
        f"launches {groups} a stream, codes-input 0 ({card})")
    n_bases = N_BATCHES * ROWS * ROW_LEN
    for name, rr in runs.items():
        log(f"[12 buckets] (a) {name}: wall "
            f"{' / '.join(f'{w:.3f}' for w, _ in rr)} s "
            f"({' / '.join(f'{n_bases / w / 1e6:.2f}' for w, _ in rr)}"
            f" Mbases/s); flush pieces over the stream's {groups} flushes, "
            f"ms (CUDA events): " + ", ".join(
                f"{p} {' / '.join(f'{m[p]:.3f}' for _, m in rr)}"
                for p in _RouteLog.FLUSH_PIECES)
            + f"; flush total "
            f"{' / '.join(f'{sum(m.values()):.3f}' for _, m in rr)}")
    log("[12 buckets] (a) peak device bytes a buffer row of one 8-batch "
        "flush (W=2), against the planner's charge: " + "; ".join(
            f"{name} {pk['bytes_per_row']:.1f} B (charge {pk['charge']})"
            for name, pk in peaks.items()))
    for name, pk in peaks.items():
        if pk["bytes_per_row"] > pk["charge"]:
            raise AssertionError(f"12(a) {name}: the flush's peak "
                                 f"{pk['bytes_per_row']:.1f} B a row passes "
                                 f"the planner's {pk['charge']}")
    return {"launches": path_launches,
            "ms": {name: [m for _, m in rr] for name, rr in runs.items()},
            "wall": {name: [w for w, _ in rr] for name, rr in runs.items()},
            "peaks": peaks}


def phase_buckets_ranks(real_numpy, err_numpy, tmp: str) -> dict:
    """12(b) 9(a)'s 4 simulated ranks at S_REAL, hash route, the pieces of
    the route step's fold timed; (c) execute
    with -flush-buckets 8 on k27; (d) 11(a)'s spill with the whole input
    on rank 0 under a -max-disk the whole spill fits: one pass."""
    import torch

    from dsk_tpu_torch.dist.engine import (
        DistCountEngine,
        _resolve_device,
        _RouteLog,
    )
    from dsk_tpu_torch.engine.run import RunParams, execute
    from dsk_tpu_torch.io.bank import Bank, open_bank
    from dsk_tpu_torch.kmer import cuda_kernels as ck

    card = card_line()
    uniq, counts = real_numpy
    hist_want = np.bincount(np.clip(counts, 1, 10000), minlength=10001)
    hist_want[0] = 0
    batches = make_batches()
    cap = CAP_REAL // 4

    def loop():  # a Loopback meets its ranks for one run
        return _loopback().Loopback(N_SIM, _resolve_device(DEVICE))

    def routed(ranks, batches):
        """A rank of 9(a)'s routed count at S_REAL, its fold's pieces
        timed by the engine's flush_log."""
        eng = DistCountEngine(K_REAL, device=DEVICE, ranks=ranks,
                              batch_rows=ROWS, row_len=ROW_LEN,
                              buf_batches=G_SIM, table_cap=cap,
                              flush_buckets=S_REAL)
        eng.flush_log = _RouteLog(eng.device, _RouteLog.FLUSH_PIECES)
        res = eng.count_stream(iter(batches[ranks.rank::N_SIM]))
        torch.cuda.synchronize()
        eng.flush_log.settle()
        return res, eng.route_log, eng.flush_log

    loop().run(lambda ranks: routed(ranks, batches[: N_SIM * G_SIM]))
    torch.cuda.synchronize()
    ck.extract_wire_planes.launches = 0
    ck.extract_canonical_planes.launches = 0
    t0 = time.perf_counter()
    ranks_out = loop().run(lambda ranks: routed(ranks, batches))
    wall = time.perf_counter() - t0
    launches = [ck.extract_wire_planes.launches,
                ck.extract_canonical_planes.launches]
    rank_groups = sum(len(lg.sent_rows) for _, lg, _ in ranks_out)
    if launches != [rank_groups, 0]:
        raise AssertionError(f"12(b): (fused, codes-input) launches "
                             f"{launches}, rank-groups {rank_groups}")
    check_rank_tables([res for res, _, _ in ranks_out], uniq, counts,
                      hist_want, "12(b) hash route at S=8", buckets=S_REAL)
    fold = [x for _, lg, _ in ranks_out for x in lg.ms["fold"]]
    pieces = {p: float(np.mean([x for *_, fl in ranks_out for x in fl.ms[p]]))
              for p in ("bucket_rows", "fold", "relayout")}
    log(f"[12 buckets] (b) 9(a)'s {N_SIM} simulated ranks, phase 5's "
        f"stream, table_cap {cap} a rank at S={S_REAL}: every rank's table "
        f"== numpy's k-mers of its owner, bucket-major, every histogram == "
        f"numpy's; fused launches {launches[0]} (one a rank-group); wall "
        f"{wall:.3f} s; the route step's fold with the bucket layout "
        f"{np.mean(fold):.3f} ms a rank-group (mean of {len(fold)}; 9(a)'s "
        f"flat fold beside it), its pieces (flush_log, CUDA events, mean "
        f"ms): " + ", ".join(f"{p} {v:.3f}" for p, v in pieces.items())
        + f" ({card})")
    path = launches[0]
    del ranks_out, batches
    torch.cuda.empty_cache()

    ck.extract_wire_planes.launches = 0
    ck.extract_canonical_planes.launches = 0
    out = execute(RunParams(
        file=os.path.join(DATA, "read50x_ref10K_e001.fasta.gz"),
        kmer_size=27, abundance_min=1, histo=True, verbose=0, device=DEVICE,
        out=os.path.join(tmp, "k27_buckets"), storage_type="none",
        flush_buckets=8))
    _histo_equal(out.histo_path, "k27.histo", "12(c) -flush-buckets 8")
    c_launches = ck.extract_wire_planes.launches
    if c_launches <= 0 or ck.extract_canonical_planes.launches:
        raise AssertionError(f"12(c): fused launches {c_launches}, "
                             f"codes-input "
                             f"{ck.extract_canonical_planes.launches}")
    log(f"[12 buckets] (c) execute -flush-buckets 8 -storage-type none on "
        f"the k27 fixture: .histo == k27.histo; fused launches {c_launches}")
    path += c_launches

    uniq_e, counts_e = err_numpy
    hist_e = np.bincount(np.clip(counts_e, 1, 10000), minlength=10001)
    hist_e[0] = 0
    fasta = os.path.join(tmp, "err.fa")
    write_fasta(make_error_batches(), fasta)

    def rank(ranks):
        eng = DistCountEngine(K_REAL, device=DEVICE, ranks=ranks,
                              batch_rows=ROWS, row_len=ROW_LEN,
                              buf_batches=G_REAL, table_cap=SP_CAP,
                              spill_partitions=SP_PARTS, spill_dir=tmp)
        bank = (open_bank(fasta) if ranks.rank == 0
                else Bank(uri=fasta, files=[], units=[], nb_banks_total=1))
        return eng.count(bank, cache_dir=tmp, max_disk_mb=MAXD_RANKS)

    torch.cuda.synchronize()
    ck.extract_wire_planes.launches = 0
    ck.extract_canonical_planes.launches = 0
    t0 = time.perf_counter()
    results = loop().run(rank)
    wall = time.perf_counter() - t0
    d_launches = ck.extract_wire_planes.launches
    if ck.extract_canonical_planes.launches:
        raise AssertionError("12(d): a codes-input launch")
    check_rank_tables(results, uniq_e, counts_e, hist_e,
                      "12(d) spill, the whole input on rank 0",
                      parts=SP_PARTS)
    # one pass: the engine's, and no SpillDiskOverflow raised
    spilled = [r.info["spill_rows"] * 4 * 3 for r in results]  # 3 words
    budget = (MAXD_RANKS * 3 // 4) << 20
    if not (budget // N_SIM < spilled[0] <= budget and not any(spilled[1:])
            and d_launches == -(-N_BATCHES // G_REAL)):
        raise AssertionError(f"12(d): spilled bytes {spilled} against a "
                             f"{budget} B budget, fused launches "
                             f"{d_launches}")
    if os.path.exists(fasta):
        os.unlink(fasta)
    log(f"[12 buckets] (d) 8(b)'s error-rich stream as one FASTA, the whole "
        f"of it on rank 0 of {N_SIM} simulated ranks, count(max_disk_mb="
        f"{MAXD_RANKS}): rank 0 spilled {spilled[0]} B, over a quarter of "
        f"the {budget} B spill budget (each rank's share before) and under "
        f"the whole: one pass, no SpillDiskOverflow, every rank's partitions "
        f"== numpy's; fused launches {d_launches}; wall {wall:.3f} s "
        f"({card})")
    path += d_launches
    return {"launches": path}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    phase = "device"
    try:
        card, has_h5py, rates = phase_device()
        phase = "build"
        phase_build()
        phase = "kernels"
        max_err, times, codes_launches, codes_owner = phase_kernels(rates)
        wire_err, wire_times = phase_wire_kernel(rates)
        from dsk_tpu_torch.kmer import cuda_kernels as ck

        phase = "golden"
        with tempfile.TemporaryDirectory(prefix="dsk_torch_smoke_") as tmp:
            ck.extract_wire_planes.launches = 0
            ck.extract_canonical_planes.launches = 0
            done = phase_golden(tmp, has_h5py)
            golden_launches = ck.extract_wire_planes.launches
            golden_codes = ck.extract_canonical_planes.launches
        if golden_launches <= 0 or golden_codes:
            raise AssertionError(
                f"golden runs: {golden_launches} fused launches, "
                f"{golden_codes} codes-input launches")
        log(f"[4 golden] byte-identical: {', '.join(done)}; fused extract "
            f"launches {golden_launches}"
            + ("" if has_h5py else "; h5py missing on this machine: the "
               "HDF5 store was not exercised here (the CPU tests pin it)"))
        phase = "real"
        launches, rate, real_numpy = phase_real()
        phase = "sortstage"
        stage = phase_sortstage(rates)
        phase = "per-bank"
        if ck.extract_wire_planes.bank_launches:
            raise AssertionError(
                f"single-bank phases launched the bank-plane kernel "
                f"{ck.extract_wire_planes.bank_launches} times")
        bank_err, bank_times = phase_bank_kernel(rates)
        with tempfile.TemporaryDirectory(prefix="dsk_torch_smoke_") as tmp:
            ck.extract_wire_planes.launches = 0
            ck.extract_wire_planes.bank_launches = 0
            ck.extract_canonical_planes.launches = 0
            done = phase_bank_golden(tmp, has_h5py)
            gold = (ck.extract_wire_planes.bank_launches,
                    ck.extract_canonical_planes.launches)
        if gold[0] <= 0 or gold[1]:
            raise AssertionError(
                f"per-bank golden runs: {gold[0]} fused launches with bank "
                f"ids, {gold[1]} codes-input launches")
        log(f"[7 per-bank] (b) c1..c4 k=27 through execute on CUDA == the "
            f"oracle's per-bank count, .histo == k27.histo: "
            f"{', '.join(done)}; fused launches with bank ids {gold[0]}"
            + ("" if has_h5py else "; h5py missing on this machine: the "
               "HDF5 store was not exercised here (the CPU tests pin it)"))
        bank_launches, bank_rate = phase_bank_real()
        phase = "spill"
        with tempfile.TemporaryDirectory(prefix="dsk_torch_smoke_") as tmp:
            ck.extract_wire_planes.launches = 0
            ck.extract_wire_planes.bank_launches = 0
            ck.extract_canonical_planes.launches = 0
            done = phase_spill_golden(tmp, has_h5py)
            sp_gold = (ck.extract_wire_planes.launches,
                       ck.extract_wire_planes.bank_launches,
                       ck.extract_canonical_planes.launches)
        if sp_gold[0] <= 0 or sp_gold[1] <= 0 or sp_gold[2]:
            raise AssertionError(
                f"spill golden runs: (fused, with bank ids, codes-input) "
                f"launches {sp_gold}")
        log(f"[8 spill] (a) through execute on CUDA: {'; '.join(done)}; "
            f"fused launches {sp_gold[0]} (with bank ids {sp_gold[1]}), "
            f"codes-input 0"
            + ("" if has_h5py else "; h5py missing on this machine: tables "
               "compared as returned (-storage-type none)"))
        with tempfile.TemporaryDirectory(prefix="dsk_torch_smoke_") as tmp:
            spill = phase_spill_real(tmp)
        phase = "routed"
        err_numpy = spill.pop("numpy")
        routed = phase_route_sim(real_numpy, err_numpy)
        with tempfile.TemporaryDirectory(prefix="dsk_torch_smoke_") as tmp:
            nccl = phase_nccl(tmp, real_numpy)
        phase = "superkmer"
        mz_times = phase_minimizers()
        sk = phase_superkmer(real_numpy, err_numpy, routed, rates)
        with tempfile.TemporaryDirectory(prefix="dsk_torch_smoke_") as tmp:
            phase_superkmer_execute(tmp)
        phase = "spill-ranks"
        with tempfile.TemporaryDirectory(prefix="dsk_torch_smoke_") as tmp:
            sp_ranks = phase_spill_ranks(tmp, err_numpy)
        with tempfile.TemporaryDirectory(prefix="dsk_torch_smoke_") as tmp:
            sp_nccl = phase_spill_nccl(tmp)
        phase = "buckets"
        buckets = phase_buckets_real(real_numpy)
        with tempfile.TemporaryDirectory(prefix="dsk_torch_smoke_") as tmp:
            buckets_ranks = phase_buckets_ranks(real_numpy, err_numpy, tmp)
        del real_numpy, err_numpy
    except Exception as e:  # any phase failing fails the smoke
        print(f"chip_smoke: phase {phase} FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    wire_ms, wire_plain_ms = wire_times[K_REAL]
    owner = sk["kernel"]  # the records-input kernel at the owner's path
    wi_bound, wi_by = wire_extract_bound(K_REAL, rates)
    bk_bound, bk_by = wire_extract_bound(K_REAL, rates, bank=True)
    codes_bound, codes_by = extract_bound(rates)
    bank_ms, _, bank_plain_ms, _ = bank_times[K_REAL]
    print(json.dumps({"kernels": [{
        "name": "extract_wire_planes",
        "route": "cuda",
        "source": "dsk_tpu_torch/csrc/extract.cu",
        "replaces": "dsk_tpu/kmer/pallas_kernels.py:30",
        "launches": (launches + spill["launches"] + routed["launches"]
                     + nccl["launches"] + sp_ranks["launches"] + sp_nccl
                     + buckets["launches"] + buckets_ranks["launches"]),
        "max_abs_err": wire_err,
        "ms": wire_ms,
        "plain_ms": wire_plain_ms,
        "bound_ms": wi_bound,
        "bound_by": wi_by,
        "library_ms": None,
    }, {
        "name": "extract_wire_planes (bank plane)",
        "route": "cuda",
        "source": "dsk_tpu_torch/csrc/extract.cu",
        "replaces": "dsk_tpu/kmer/pallas_kernels.py:30",
        "launches": bank_launches + sp_gold[1] + nccl["bank_launches"],
        "max_abs_err": bank_err,
        "ms": bank_ms,
        "plain_ms": bank_plain_ms,
        "bound_ms": bk_bound,
        "bound_by": bk_by,
        "library_ms": None,
    }, {
        "name": "extract_record_planes",
        "route": "cuda",
        "source": "dsk_tpu_torch/csrc/extract.cu",
        "replaces": "dsk_tpu/kmer/pallas_kernels.py:30",
        "launches": sk["launches"],
        "max_abs_err": owner["max_abs_err"],
        "ms": owner["ms"],
        "plain_ms": owner["plain_ms"],
        "bound_ms": owner["bound_ms"],
        "bound_by": owner["bound_by"],
        "library_ms": None,
    }, {
        "name": "extract_canonical_planes",
        "route": "cuda",
        "source": "dsk_tpu_torch/csrc/extract.cu",
        "replaces": "dsk_tpu/kmer/pallas_kernels.py:30",
        "launches": sk["codes_launches"],
        "entry_path_launches": codes_launches,
        "max_abs_err": max_err,
        "ms": times[K_REAL][0],
        "plain_ms": times[K_REAL][1],
        "bound_ms": codes_bound,
        "bound_by": codes_by,
        "library_ms": None,
        "at_owner_shape": codes_owner,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "dsk_tpu_torch/csrc/sortstage.cu",
        "replaces": "scripts/measure_pallas_sortstage.py:47",
        "launches": k["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": stage["plain_ms"],
        "bound_ms": stage["bound_ms"],
        "bound_by": stage["bound_by"],
        "library_ms": None,
    } for name, k in stage["kernels"].items()]}))
    reg, smem = (stage["kernels"][k]["ms"]
                 for k in ("bitonic_stages", "bitonic_stages_smem"))
    print(f"{card} | real-size stream {rate:.2f} Mbases/s; fused extract "
          f"{wire_ms:.4f} ms vs plain {wire_plain_ms:.4f} ms vs bound "
          f"{wi_bound:.4f} ms per {G_REAL}-batch group, at "
          f"({ROWS}, {ROW_LEN}) k={K_REAL}; records-input extract "
          f"{owner['ms']:.4f} ms vs plain {owner['plain_ms']:.4f} ms vs "
          f"bound {owner['bound_ms']:.4f} ms at the superkmer owner's "
          f"(records, live windows) {owner['shape']}, before "
          f"{' / '.join(f'{x:.4f}' for x in owner['before_ms'])} ms; "
          f"codes-input extract {times[K_REAL][0]:.4f} ms vs bound "
          f"{codes_bound:.4f} ms a ({ROWS}, {ROW_LEN}) batch, "
          f"{codes_owner['ms']:.4f} ms vs bound "
          f"{codes_owner['bound_ms']:.4f} ms at {codes_owner['shape']}; "
          f"sortstage {reg:.4f} ms (first "
          f"port {smem:.4f} ms) vs plain {stage['plain_ms']:.4f} ms vs bound "
          f"{stage['bound_ms']:.4f} ms at {SS_TILES} tiles; per-bank stream "
          f"{bank_rate:.2f} Mbases/s, fused extract with the bank plane "
          f"{bank_ms:.4f} ms vs plain {bank_plain_ms:.4f} ms vs bound "
          f"{bk_bound:.4f} ms per group; spill count of the error-rich "
          f"stream {' / '.join(f'{s:.3f}' for s in spill['spill_s'])} s vs "
          f"table mode {' / '.join(f'{s:.3f}' for s in spill['table_s'])} s "
          f"in turns; routed group step at {N_SIM} simulated ranks "
          f"{routed['134-Mbase stream']['route_ms']:.3f} ms (134-Mbase "
          f"stream) and {routed['error-rich stream']['route_ms']:.3f} ms "
          f"(error-rich) a rank-group of {G_SIM} batches; superkmer "
          f"routed step {sk['134-Mbase stream']['step_ms']:.3f} ms and "
          f"{sk['error-rich stream']['step_ms']:.3f} ms, sending "
          f"{sk['134-Mbase stream']['sent_mib']:.1f} and "
          f"{sk['error-rich stream']['sent_mib']:.1f} MiB a rank-group "
          f"(hash route {routed['134-Mbase stream']['sent_mib']:.1f} and "
          f"{routed['error-rich stream']['sent_mib']:.1f}); superkmer_records"
          f" {mz_times['superkmer_records']:.4f} ms a batch; spill across "
          f"{N_SIM} simulated ranks "
          f"{' / '.join(f'{s:.3f}' for s in sp_ranks['ranks_s'])} s vs one "
          f"rank {' / '.join(f'{s:.3f}' for s in sp_ranks['one_s'])} s in "
          f"turns, {sp_ranks['rows'][0]} rows spilled; flush of the "
          f"134-Mbase stream at S={S_REAL} "
          + "; ".join(f"{name} " + " / ".join(
              f"{sum(m.values()):.3f}" for m in ms) + " ms"
              for name, ms in buckets["ms"].items()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
