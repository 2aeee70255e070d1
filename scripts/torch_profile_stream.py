"""Where the time and the memory of the port's count stream go, on one GPU.

Run from the root of a checkout:  python3 scripts/torch_profile_stream.py

At chip_smoke.py's real-size geometry (k=31; 64 batches of 2048 x 1024
bases read from a 1-Mbase random genome, numpy seed 0; 32-batch flush
groups; table_cap 1,572,864) it measures:

  * host: the exc wire packer (pack_codes_exc) on one thread;
  * device only: both flush groups with the wire already on the card, each
    piece of dsk_tpu_torch.dist.engine's _step and _flush timed with CUDA
    events, --reps times, in turns for two group steps:
      - "fused", the engine's: one fused-kernel launch a group
        (fill_group -> kmer/cuda_kernels.py extract_wire_planes);
      - "before", the composition it replaced, kept here as the yardstick:
        per batch the torch wire unpack (io/packed.py), the codes-input
        extraction kernel (extract_canonical_planes) and the append;
    then the flush (sort, compaction, table fold), the same for both;
  * the device memory a group step takes above the buffer, both ways;
  * the stream end to end (count_stream, warm) and the device's busy
    share of it: fused device-only time over stream wall;
  * the peak device memory of one flush at k=31, 63 and 127 (8-batch
    groups), against the planner's model (engine/planner.py
    device_bytes).

Prints one line per measurement, and with --out writes them all as JSON.
Needs CUDA; builds the extraction kernels at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dsk_tpu_torch.dist.engine import WRAP_SHIFT, DistCountEngine  # noqa: E402
from dsk_tpu_torch.engine import planner  # noqa: E402
from dsk_tpu_torch.io import Batch  # noqa: E402
from dsk_tpu_torch.io.packed import (  # noqa: E402
    EXC_E,
    pack_codes_exc,
    unpack_codes_exc,
)
from dsk_tpu_torch.kmer.cuda_kernels import (  # noqa: E402
    extract_canonical_planes,
)
from dsk_tpu_torch.kmer.device import (  # noqa: E402
    compact_heads_unit,
    sum_by_key_planes_capped,
)
from dsk_tpu_torch.kmer.layout import planes_to_numpy, sort_planes  # noqa: E402

K, ROWS, ROW_LEN, N_BATCHES = 31, 2048, 1024, 64
G, CAP, GENOME = 32, 1_572_864, 1 << 20
STEP_PIECES = {"fused": ("group_step",),
               "before": ("unpack", "extract", "append")}
FLUSH_PIECES = ("flush_sort", "flush_compact", "flush_fold")


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def make_batches(n_batches: int) -> list[Batch]:
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=GENOME, dtype=np.uint8)
    out = []
    for _ in range(n_batches):
        starts = rng.integers(0, GENOME - ROW_LEN, size=ROWS)
        codes = genome[starts[:, None] + np.arange(ROW_LEN)[None, :]]
        out.append(Batch(codes=codes, bank_ids=np.zeros(ROWS, np.int32),
                         n_rows=ROWS, n_bases=int(codes.size), n_reads=ROWS))
    return out


def host_pack(batches):
    """Pack every batch to the exc wire on this thread: (groups, seconds),
    each group (words (G, rows, nw) uint32, meta (G, rows, 1+E) uint16)."""
    t0 = time.perf_counter()
    packed = [pack_codes_exc(b.codes, EXC_E) for b in batches]
    dt = time.perf_counter() - t0
    groups = []
    for g in range(0, len(packed), G):
        part = packed[g: g + G]
        groups.append((np.stack([w for w, _ in part]),
                       np.stack([m for _, m in part])))
    return groups, dt


def step_before(eng: DistCountEngine, words, meta, timed) -> int:
    """The group step the fused kernel replaced: per batch, unpack the
    wire with torch ops, extract with the codes-input kernel, append
    (one pass: no filter).  Returns the rows filled."""
    m = eng.plan.m
    for g in range(words.shape[0]):
        codes = timed("unpack", lambda: unpack_codes_exc(
            words[g], meta[g], eng.row_len))
        planes, _ = timed("extract",
                          lambda: extract_canonical_planes(codes, eng.k))

        def append():
            eng._buffer()[:, g * m:(g + 1) * m] = planes.reshape(eng.W, m)
        timed("append", append)
    return words.shape[0] * m


def group_step(eng, mode, words, meta, timed) -> int:
    if mode == "fused":
        return timed("group_step", lambda: eng.fill_group(words, meta, 0))
    return step_before(eng, words, meta, timed)


def device_only(eng: DistCountEngine, wire, mode: str):
    """One pass over the staged groups, each piece between CUDA events.
    Returns (ms per piece, wall ms, final (tab_p, tab_c, tover))."""
    tab_p, tab_c, tover = eng._init_state()
    marks = []  # (piece, start event, end event)

    def timed(piece, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        marks.append((piece, a, b))
        return out

    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for words, meta in wire:
        n_rows = group_step(eng, mode, words, meta, timed)
        cap = eng.plan.table_cap
        skeys, _ = timed("flush_sort",
                         lambda: sort_planes(eng._buffer()[:, :n_rows]))
        buniq, bcounts, bn_uniq, n_lost = timed(
            "flush_compact", lambda: compact_heads_unit(skeys, cap))

        def fold():
            planes = torch.cat([buniq, tab_p], dim=1)
            weights = torch.cat([bcounts, tab_c.to(torch.int64)])
            return sum_by_key_planes_capped(planes, weights, cap)
        uniq, counts, n_uniq, _, wrapped = timed("flush_fold", fold)
        over = ((n_uniq > cap) | (bn_uniq > cap) | (n_lost > 0)).to(torch.int64)
        tover = tover + over + (wrapped << WRAP_SHIFT)
        tab_p, tab_c = uniq, counts.to(torch.int32)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - w0) * 1e3
    ms = {p: 0.0 for p in STEP_PIECES[mode] + FLUSH_PIECES}
    for piece, a, b in marks:
        ms[piece] += a.elapsed_time(b)
    return ms, wall, (tab_p, tab_c, tover)


def step_peak(eng: DistCountEngine, words, meta, mode: str) -> int:
    """Device bytes one group step allocates above what it started with
    (the buffer already allocated)."""
    eng._buffer()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    group_step(eng, mode, words, meta, lambda piece, fn: fn())
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def flush_peak(k: int, group) -> dict:
    """Peak device bytes of one flush of 8 batches at k, against the
    planner's model of the same table and buffer."""
    eng = DistCountEngine(k, device="cuda", batch_rows=ROWS, row_len=ROW_LEN,
                          buf_batches=8, table_cap=CAP)
    tab_p, tab_c, tover = eng._init_state()
    words, meta = group
    n_rows = eng.fill_group(torch.from_numpy(words[:8].view(np.int32)).cuda(),
                            torch.from_numpy(meta[:8].view(np.int16)).cuda(),
                            0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = eng._flush(n_rows, tab_p, tab_c, tover)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    buf_bytes = eng._buffer().nbytes
    table_bytes = tab_p.nbytes + tab_c.nbytes
    model = planner.device_bytes(eng.W, CAP, n_rows)
    row = {
        "k": k, "W": eng.W, "flush_rows": n_rows,
        "buffer_bytes": buf_bytes, "table_bytes": table_bytes,
        "other_bytes_before": base - buf_bytes - table_bytes,
        "peak_bytes": peak,
        "flush_scratch_bytes_per_row": (peak - base) / n_rows,
        "model_bytes": model,
        "model_flush_row_bytes": planner.flush_row_bytes(eng.W),
        "measured_flush_bytes_per_row": (peak - base) / n_rows
        + eng.W * planner.KEY_WORD_BYTES,
        "model_covers_peak": model >= peak - (base - buf_bytes - table_bytes),
    }
    del out, eng, tab_p, tab_c
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", help="write the measurements as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_stream: CUDA is required", file=sys.stderr)
        return 1
    card = card_line()
    rec = {"card": card, "torch": torch.__version__}
    print(card, flush=True)
    batches = make_batches(N_BATCHES)
    n_bases = sum(b.n_bases for b in batches)

    groups, t_pack = host_pack(batches)
    rec["host_pack"] = {"s": t_pack, "mbases_s": n_bases / t_pack / 1e6}
    print(f"host pack_codes_exc: {t_pack:.3f} s for {n_bases} bases = "
          f"{n_bases / t_pack / 1e6:.1f} Mbases/s (one thread)", flush=True)

    eng = DistCountEngine(K, device="cuda", batch_rows=ROWS, row_len=ROW_LEN,
                          buf_batches=G, table_cap=CAP)
    wire = [
        (torch.from_numpy(w.view(np.int32)).cuda(),
         torch.from_numpy(mt.view(np.int16)).cuda())
        for w, mt in groups
    ]
    rec["device_only"] = []
    states = {}
    for rep in range(args.reps + 1):  # rep 0 pays first-call costs
        for mode in (("fused", "before") if rep % 2 else ("before", "fused")):
            ms, wall, states[mode] = device_only(eng, wire, mode)
            if rep == 0:
                continue
            row = {"rep": rep, "mode": mode, "wall_ms": wall,
                   "mbases_s": n_bases / wall / 1e3,
                   "step_ms": sum(ms[p] for p in STEP_PIECES[mode]),
                   **{f"{p}_ms": v for p, v in ms.items()}}
            rec["device_only"].append(row)
            print(f"device-only rep {rep} {mode}: {wall:.2f} ms "
                  f"({n_bases / wall / 1e3:.1f} Mbases/s); group step "
                  f"{row['step_ms']:.3f} ms; "
                  + ", ".join(f"{p} {v:.3f} ms" for p, v in ms.items()),
                  flush=True)
    state = states["fused"]
    for a, b in zip(state, states["before"]):
        if not torch.equal(a, b):
            raise AssertionError("fused and before group steps disagree")
    if int(state[2].item()):
        raise AssertionError("device-only pass overflowed the table")
    rec["step_peak_bytes"] = {
        mode: step_peak(eng, *wire[0], mode) for mode in ("fused", "before")}
    print("group step device memory above the buffer: "
          + ", ".join(f"{mode} {v / 2**20:.1f} MiB"
                      for mode, v in rec["step_peak_bytes"].items()),
          flush=True)
    del wire

    eng.count_stream(iter(batches[:G]))  # warm-up
    rec["stream"] = []
    for rep in range(args.reps):
        t0 = time.perf_counter()
        res = eng.count_stream(iter(batches))
        wall = time.perf_counter() - t0
        want_p, want_c = state[0], state[1]
        n_live = int((want_c > 0).sum().item())
        if not (np.array_equal(res.counts, want_c[:n_live].cpu().numpy())
                and np.array_equal(res.kmers,
                                   planes_to_numpy(want_p[:, :n_live]).T)):
            raise AssertionError("stream table differs from device-only")
        dev_ms = float(np.mean([r["wall_ms"] for r in rec["device_only"]
                                if r["mode"] == "fused"]))
        row = {"rep": rep, "wall_s": wall, "mbases_s": n_bases / wall / 1e6,
               "busy_share": dev_ms / 1e3 / wall, "t_sub": res.info["t_sub"]}
        rec["stream"].append(row)
        print(f"stream rep {rep}: {n_bases / wall / 1e6:.2f} Mbases/s "
              f"({wall:.3f} s); device busy share {row['busy_share']:.3f}; "
              f"t_sub {res.info['t_sub']}", flush=True)
    del eng, res, state
    torch.cuda.empty_cache()

    rec["flush_memory"] = []
    for k in (31, 63, 127):
        row = flush_peak(k, groups[0])
        rec["flush_memory"].append(row)
        print(f"flush memory k={k} (W={row['W']}): {row['flush_rows']} rows, "
              f"peak {row['peak_bytes'] / 2**30:.3f} GiB; measured "
              f"{row['measured_flush_bytes_per_row']:.1f} B/row vs model "
              f"{row['model_flush_row_bytes']} B/row; model covers peak: "
              f"{row['model_covers_peak']}", flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
