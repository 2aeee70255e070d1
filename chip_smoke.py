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
              (extract_canonical_planes) on 25 cases; the fused wire
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
  6. sortstage  the bitonic-stage probe's kernel (kmer/sortstage.py)
              against its plain version, bit for bit: 1 and 2 tiles of
              full-range words, a ties case, keys >= 2^31, torch.uint32
              words and 256 tiles; then the probe's path at 256 tiles
              (16.8M elements), 50 timed launches, the plain version
              timed 3 times and torch.sort of the same keys as a yardstick.

Each phase that drives a path sets the launch counts to 0 just before it
and reads them just after; launches made to compare a kernel with its
plain version are not counted.  The codes-input extraction kernel is off
the main path (phases 4 and 5 require 0 launches of it); its launches in
the JSON line are those of its own entry point, timed in phase 3.  Bounds
in the kernels' JSON line: the larger of the bytes each input is read and
each output written once over 3.35 TB/s and the operations over 67 T/s
(the H100's non-tensor 32-bit peak); both from NVIDIA's data sheet for
the 700 W part.

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
OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


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


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    try:
        import h5py  # noqa: F401

        has_h5py = True
    except ImportError:
        has_h5py = False
    from dsk_tpu_torch.io import native_reader_available

    log(f"[1 device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | h5py {'yes' if has_h5py else 'MISSING'} "
        f"| native reader {'yes' if native_reader_available() else 'MISSING'}")
    return card, has_h5py


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
    """The cases of tests/test_torch_device.py plus the real batch shape."""
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
    return cases


def phase_kernels():
    import torch

    from dsk_tpu_torch.kmer import cuda_kernels as ck

    rng = np.random.default_rng(1)
    cases = kernel_cases(rng)
    max_err = 0
    for k, b in cases:
        x = torch.from_numpy(b).cuda()
        p1, v1 = ck.extract_canonical_planes(x, k)
        p2, v2 = ck.extract_canonical_planes_torch(x, k)
        torch.cuda.synchronize()
        err = int((p1 - p2).abs().max().item())
        max_err = max(max_err, err, int((v1 != v2).sum().item()))
        if err or not torch.equal(v1, v2):
            raise AssertionError(f"kernel != plain at k={k}, shape {b.shape}")
    times = {}
    # its own entry point's path (the main path no longer runs it):
    # launches counted from here
    ck.extract_canonical_planes.launches = 0
    for k in (31, 63):
        x = torch.from_numpy(rng.integers(0, 4, size=(ROWS, ROW_LEN))
                             .astype(np.uint8)).cuda()
        times[k] = (
            cuda_ms(lambda: ck.extract_canonical_planes(x, k), 50),
            cuda_ms(lambda: ck.extract_canonical_planes_torch(x, k), 5),
        )
    launches = ck.extract_canonical_planes.launches
    log(f"[3 kernels] extract_canonical_planes == plain on {len(cases)} "
        f"cases (max |diff| {max_err}); at ({ROWS}, {ROW_LEN}): "
        + ", ".join(f"k={k} kernel {a:.4f} ms / plain {b:.4f} ms"
                    for k, (a, b) in times.items())
        + f"; launches on its own entry path {launches}")
    return max_err, times, launches


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


def phase_wire_kernel():
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
                    f"bound {wire_extract_bound(k)[0]:.4f} ms) / plain "
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
    return launches, rate


def extract_bound():
    """(ms, what) at the real batch shape: the codes read once, the
    int64 planes and valid flags written once; ~7k + 4W integer
    operations a window (the forward and reverse-complement builds, the
    validity scan, the word compare and select)."""
    W, nw = 2, ROW_LEN - K_REAL + 1
    windows = ROWS * nw
    nbytes = ROWS * ROW_LEN + windows * (8 * W + 1)
    ops = windows * (7 * K_REAL + 4 * W)
    return _bound(nbytes, ops)


def wire_extract_bound(k: int):
    """(ms, what) for one flush group at the real shape, exc wire: the
    code words and exc meta read once, the int64 planes written once;
    ~20W + 6 ceil(k/32) + 10 integer operations a window (per word two
    funnel shifts, a pair reversal, the xor, compare, select and address;
    the validity test 32 bits at a time)."""
    W, nw = (2 * k + 31) // 32, ROW_LEN - k + 1
    rows, windows = G_REAL * ROWS, G_REAL * ROWS * nw
    nw_p = -(-ROW_LEN // 32) * 2
    nbytes = rows * (4 * nw_p + 2 * (1 + WIRE_E)) + windows * 8 * W
    ops = windows * (20 * W + 6 * (-(-k // 32)) + 10)
    return _bound(nbytes, ops)


def sortstage_bound(n: int, nstages: int):
    """(ms, what) for the probe over n elements: 12 B read and 12 B
    written an element; ~12 integer operations an element a stage (the
    two-word unsigned compare, the keep masks, three selects)."""
    return _bound(24 * n, 12 * n * nstages)


def _bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_sortstage():
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
    max_err = 0
    for name, arrs, dtype in cases:
        x = [torch.from_numpy(a.view(np.int32)).cuda().view(dtype)
             for a in arrs]
        got = ss.bitonic_stages(*x)
        want = ss.bitonic_stages_torch(*x)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.dtype != dtype or g.shape != w.shape:
                raise AssertionError(f"sortstage {name}: dtype or shape")
            diff = ss.widen_words(g) - ss.widen_words(w)
            err = int(diff.abs().max().item())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"sortstage kernel != plain: {name}")
    big = x  # the last case: SS_TILES tiles, int32 words

    # the probe's path: launches counted from here
    ss.bitonic_stages.launches = 0
    ck.extract_canonical_planes.launches = 0
    ck.extract_wire_planes.launches = 0
    ms = cuda_ms(lambda: ss.bitonic_stages(*big), 50)
    launches = ss.bitonic_stages.launches
    if launches <= 0:
        raise AssertionError("the probe's path launched no sortstage kernel")
    if ck.extract_canonical_planes.launches or ck.extract_wire_planes.launches:
        raise AssertionError("the probe's path launched an extract kernel")
    plain_ms = cuda_ms(lambda: ss.bitonic_stages_torch(*big), 3)
    key = (ss.widen_words(big[0]) << 32) | ss.widen_words(big[1])
    pay = big[2].reshape(-1)

    def flat_sort():
        v, i = torch.sort(key.reshape(-1))
        return v, pay[i]

    sort_ms = cuda_ms(flat_sort, 5)
    n = big[0].numel()
    log(f"[6 sortstage] bitonic_stages == plain on {len(cases)} cases "
        f"({'; '.join(c[0] for c in cases)}; max |diff| {max_err}); "
        f"{SS_TILES} tiles = {n} elements x {ss.NSTAGES} stages: kernel "
        f"{ms:.4f} ms ({ms * 1e6 / n / ss.NSTAGES:.5f} ns/elem/stage) / "
        f"plain {plain_ms:.4f} ms; yardstick (a flat sort, not the same "
        f"function): torch.sort of the {n} int64 keys + payload gather "
        f"{sort_ms:.4f} ms; sortstage launches {launches}")
    return {"launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "n": n, "nstages": ss.NSTAGES}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    phase = "device"
    try:
        card, has_h5py = phase_device()
        phase = "build"
        phase_build()
        phase = "kernels"
        max_err, times, codes_launches = phase_kernels()
        wire_err, wire_times = phase_wire_kernel()
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
        launches, rate = phase_real()
        phase = "sortstage"
        stage = phase_sortstage()
    except Exception as e:  # any phase failing fails the smoke
        print(f"chip_smoke: phase {phase} FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    kernel_ms, plain_ms = times[K_REAL]
    wire_ms, wire_plain_ms = wire_times[K_REAL]
    ex_bound, ex_by = extract_bound()
    wi_bound, wi_by = wire_extract_bound(K_REAL)
    ss_bound, ss_by = sortstage_bound(stage["n"], stage["nstages"])
    print(json.dumps({"kernels": [{
        "name": "extract_wire_planes",
        "route": "cuda",
        "source": "dsk_tpu_torch/csrc/extract.cu",
        "replaces": "dsk_tpu/kmer/pallas_kernels.py:30",
        "launches": launches,
        "max_abs_err": wire_err,
        "ms": wire_ms,
        "plain_ms": wire_plain_ms,
        "bound_ms": wi_bound,
        "bound_by": wi_by,
        "library_ms": None,
    }, {
        "name": "extract_canonical_planes",
        "route": "cuda",
        "source": "dsk_tpu_torch/csrc/extract.cu",
        "replaces": "dsk_tpu/kmer/pallas_kernels.py:30",
        "launches": codes_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": ex_bound,
        "bound_by": ex_by,
        "library_ms": None,
    }, {
        "name": "bitonic_stages",
        "route": "cuda",
        "source": "dsk_tpu_torch/csrc/sortstage.cu",
        "replaces": "scripts/measure_pallas_sortstage.py:47",
        "launches": stage["launches"],
        "max_abs_err": stage["max_abs_err"],
        "ms": stage["ms"],
        "plain_ms": stage["plain_ms"],
        "bound_ms": ss_bound,
        "bound_by": ss_by,
        "library_ms": None,
    }]}))
    print(f"{card} | real-size stream {rate:.2f} Mbases/s; fused extract "
          f"{wire_ms:.4f} ms vs plain {wire_plain_ms:.4f} ms vs bound "
          f"{wi_bound:.4f} ms per {G_REAL}-batch group, codes-input extract "
          f"{kernel_ms:.4f} ms vs plain {plain_ms:.4f} ms a batch, at "
          f"({ROWS}, {ROW_LEN}) k={K_REAL}; sortstage {stage['ms']:.4f} ms "
          f"vs plain {stage['plain_ms']:.4f} ms at {SS_TILES} tiles")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
