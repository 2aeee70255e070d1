"""The control of `correct`: the plain reference with its keys held in 32
bits (reference.fingerprint_fold; over several banks, k-mers that share a
key merge their counts in every bank), put in the program's place at a
cell's own size and judged as the benchmark judges the program.  Each seed's
readings have to exceed a limit somewhere; the exact reference, judged
the same way, reads 0 everywhere.  The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

Prints one JSON line a seed: the cell, the seed, the control's readings
and the exact reference's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import generate, reference, run  # noqa: E402


def readings(spec: dict, seed: int, device: str = "cuda") -> dict:
    """The control's and the exact reference's readings on one seed."""
    with tempfile.TemporaryDirectory(prefix="dskbench-") as work:
        inputs = generate.write_cell_inputs(seed, spec["config"],
                                            spec["traffic"], work)
        params = run.job_params(spec["config"], spec["traffic"],
                                inputs["files"], work, device)
    lims = (params.histo_max, params.abundance_min, params.abundance_max)
    ref = reference.reference_answer(inputs["banks"], params.kmer_size,
                                     *lims, device=device)
    out = {}
    folded = reference.fingerprint_fold(ref["values"], ref["counts"], device)
    for name, (v, c) in (("control", folded),
                         ("exact", (ref["values"], ref["counts"]))):
        a = reference.answer(v, c, *lims)
        job = {"histo": a["histo"], "histogram": a["histogram"],
               "histo2d": a.get("histo2d"),
               "n_solid": int(a["solid_values"].size),
               "n_distinct": int(v.size)}
        table = (v, c, a["solid_values"], a["solid_counts"])
        checks = reference.judge(ref, [job], [table], 0)
        out[name] = {key: ch["value"] for key, ch in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = run.load_cell(run.load_bench(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(spec, seed, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
