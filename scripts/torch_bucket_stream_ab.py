"""The count stream's wall with key-space buckets of the flush, in turns.

Run from the root of a checkout:  python3 scripts/torch_bucket_stream_ab.py

At chip_smoke.py's real-size geometry (k=31; 64 batches of 2048 x 1024
bases read from a 1-Mbase random genome, numpy seed 0; 32-batch flush
groups; table_cap 1,572,864) it times count_stream (warm, finalize=False,
ending in the overflow check's host read) --rounds times for each of:

  * "S=1": the flat flush;
  * "flush": S=8, bucketize_at="flush", as the engine runs it: a host
    read a flush (`_host_flag`) says whether the compacted heads were
    complete, taken at the next flush or at the overflow check;
  * "flush, no read": the same with that read answered False on the host
    at once (right for this stream, whose groups never hold more distinct
    k-mers than the table), to see what the read costs;
  * "route": S=8, bucketize_at="route";

in turns (each round runs them in order, the next round in reverse), and
prints each variant's walls, t_gen (the host packer), and the host's
wait in the flag read.  With --out it writes them as JSON.  Needs CUDA.
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

from dsk_tpu_torch.dist import engine as port_engine  # noqa: E402
from dsk_tpu_torch.dist.engine import DistCountEngine  # noqa: E402
from dsk_tpu_torch.io import Batch  # noqa: E402

K, ROWS, ROW_LEN, N_BATCHES, G, CAP, GENOME = (
    31, 2048, 1024, 64, 32, 1_572_864, 1 << 20)
VARIANTS = {
    "S=1": {},
    "flush": dict(flush_buckets=8),
    "flush, no read": dict(flush_buckets=8),
    "route": dict(flush_buckets=8, bucketize_at="route"),
}


def make_batches():
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=GENOME, dtype=np.uint8)
    out = []
    for _ in range(N_BATCHES):
        starts = rng.integers(0, GENOME - ROW_LEN, size=ROWS)
        codes = genome[starts[:, None] + np.arange(ROW_LEN)[None, :]]
        out.append(Batch(codes=codes, bank_ids=np.zeros(ROWS, np.int32),
                         n_rows=ROWS, n_bases=int(codes.size), n_reads=ROWS))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    batches = make_batches()
    engines = {name: DistCountEngine(K, device="cuda", batch_rows=ROWS,
                                     row_len=ROW_LEN, buf_batches=G,
                                     table_cap=CAP, **kw)
               for name, kw in VARIANTS.items()}
    host_flag = port_engine._host_flag
    waited = [0.0]

    def timed_flag(flag):
        read = host_flag(flag)

        def timed_read():
            t0 = time.perf_counter()
            out = read()
            waited[0] += time.perf_counter() - t0
            return out
        return timed_read

    def run(name):
        port_engine._host_flag = (
            (lambda flag: (lambda: False)) if name == "flush, no read"
            else timed_flag)
        waited[0] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engines[name].count_stream(iter(batches), finalize=False)
        wall = time.perf_counter() - t0
        engines[name]._last_state = None
        return wall, res.info["t_sub"]["t_gen"], waited[0]

    for name in VARIANTS:  # warm-up: first calls
        run(name)
    out = {name: [] for name in VARIANTS}
    order = list(VARIANTS)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            out[name].append(run(name))
    port_engine._host_flag = host_flag
    for name, runs in out.items():
        print(f"{name}: wall {' / '.join(f'{w:.3f}' for w, _, _ in runs)} s;"
              f" t_gen {' / '.join(f'{g:.3f}' for _, g, _ in runs)} s; flag "
              f"read wait {' / '.join(f'{x * 1e3:.2f}' for *_, x in runs)} "
              f"ms ({card})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": out}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
