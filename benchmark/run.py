"""The benchmark of dsk_tpu_torch: whole `dsk` counts, back to back.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (a file of sizes under
benchmark/configs/) and a traffic mix (benchmark/traffic/<name>.json).
Set-up draws the configuration's reads from the seed and writes them as
one FASTQ file under TMPDIR (gzip, where the traffic gives a
`gzip_level`; after the genome as an assembly FASTA, bank 0, where the
configuration has an `assembly_bank`), then runs one whole job to build
and warm every kernel.  The window is a closed loop of one client: jobs
run back to back, each `dsk_tpu_torch.engine.run.execute` on those files
with the arguments the `dsk` CLI's parser makes of the configuration's
and the traffic's flags.  Every job that starts within --seconds
finishes; the window ends with the last one.

End-to-end metrics (--trace 0): the input bases of the window's jobs
over its length, the device's peak allocated memory in it, and the
set-up time.  With --trace 1 a torch.profiler trace covers the window,
and each per-layer metric of the cell is read by its own reader,
benchmark/metrics/<metric name>.py.

After the window (its memory peak read, the program's state freed) the
plain reference (benchmark/reference.py) counts the same reads, and
every job's histogram, .histo bytes (and .histo2D bytes), distinct and
solid counts, and the whole table (a count a bank, over several banks)
and solid k-mers of the warm job and of a sample of the window's jobs
drawn from the seed, are compared with it.  The numbers
compared and their limits are the last lines on standard error and the
last key of the result, the JSON object on the last line of standard
output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# kernel caches of the libraries the program uses, at fixed paths in the
# checkout (the program's own nvcc and g++ builds go to
# dsk_tpu_torch/_build/, also in the checkout)
CACHE_DIR = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "dsk_tpu")
# the window's jobs whose whole tables are compared, drawn from the seed
JUDGED_TABLES = 4

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import generate, reference  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell `name` with its configuration, traffic mix and metrics,
    each found by its name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def here(m):
        return name in m.get("workloads", [name])

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if here(m)],
            "per_layer": [m for m in bench["per_layer"] if here(m)]}


def load_reader(metric: str, root: str = ROOT):
    """The `read(ctx)` of benchmark/metrics/<metric>.py."""
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def job_argv(config: dict, traffic: dict, files: list[str], out_dir: str,
             device: str) -> list[str]:
    """The `dsk` command line of a job on `files`, one bank each."""
    return [*config["flags"], *traffic["flags"], "-file", ",".join(files),
            "-out-dir", out_dir, "-out", os.path.join(out_dir, "job"),
            "-device", device, "-verbose", "0"]


def job_params(config: dict, traffic: dict, files: list[str], out_dir: str,
               device: str):
    """RunParams from the `dsk` CLI's parser, field by field as its main()
    builds them.  A cell whose flags ask for a solidity rule other than
    -solidity-kind sum is refused: the reference judges that one only."""
    from dsk_tpu_torch.cli.dsk import build_parser
    from dsk_tpu_torch.engine.run import RunParams

    args = build_parser().parse_args(
        job_argv(config, traffic, files, out_dir, device))
    if args.solidity_kind != "sum" or args.solidity_custom is not None:
        raise ValueError(
            "the benchmark's reference judges -solidity-kind sum only; "
            f"the cell asks for {args.solidity_kind!r}"
            + (f" with -solidity-custom {args.solidity_custom!r}"
               if args.solidity_custom is not None else ""))
    kw = {}
    for f in dataclasses.fields(RunParams):
        if f.name == "checkpoint":
            kw[f.name] = not args.no_checkpoint
        elif hasattr(args, f.name):
            v = getattr(args, f.name)
            kw[f.name] = bool(v) if isinstance(f.default, bool) else v
    return RunParams(**kw)


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run of a cell: set-up, the window, the reference and the
    comparison.  Returns the result object (without printing it)."""
    import numpy as np
    import torch

    from dsk_tpu_torch.engine.run import execute

    t_start = T_START if t_start is None else t_start
    config, traffic = spec["config"], spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    work = tempfile.mkdtemp(prefix="dskbench-")
    try:
        t_gen = time.perf_counter()
        reads = generate.write_cell_inputs(seed, config, traffic, work)
        t_gen = time.perf_counter() - t_gen
        banks = reads.pop("banks")
        files = reads["files"]
        file_bytes = sum(os.path.getsize(p) for p in files)
        params = job_params(config, traffic, files, work, device)
        k = params.kmer_size
        # every bank a job reads counts, the assembly's too
        n_bases = sum(int(b.size) for b in banks)
        n_windows = sum(b.shape[0] * max(b.shape[1] - k + 1, 0)
                        for b in banks)

        def take(path):
            if path is None:
                return None
            with open(path, "rb") as f:
                data = f.read()
            os.remove(path)
            return data

        def one_job():
            out = execute(params)
            return out, take(out.histo_path), take(out.histo2d_path)

        def summary(out, histo, histo2d, wall):
            info = out.info
            counters = (info.get("trace") or {}).get("counters") or {}
            return {"wall_s": wall, "bases": n_bases,
                    "retries": {key: n for key, n in counters.items()
                                if key.startswith("run.retries.")},
                    "windows": n_windows, "histo": histo,
                    "histo2d": histo2d,
                    "histogram": np.asarray(out.result.histogram).copy(),
                    "n_solid": int(out.n_solid),
                    "n_distinct": int(info["nb_distinct_kmers"]),
                    "info": {key: info.get(key) for key in (
                        "t_stream", "t_sub", "t_gather", "t_hist",
                        "n_bases", "config", "system")}}

        def written(j):
            return len(j["histo"]) + len(j["histo2d"] or b"")

        j0 = time.perf_counter()
        warm, *warm_files = one_job()
        warm_job = summary(warm, *warm_files, time.perf_counter() - j0)
        judged = [warm.result]
        del warm
        plan = warm_job["info"]["config"] or {}
        level = traffic.get("gzip_level")
        form = ("" if level is None else f" as {os.path.getsize(files[-1])}"
                f" B of gzip (level {level})")
        asm = (f"; the assembly, bank 0: {os.path.getsize(files[0])} B of "
               f"FASTA ({banks[0].size} bases)" if len(files) > 1 else "")
        log(f"set-up: wrote {reads['fastq_bytes']} B of FASTQ{form} "
            f"({reads['n_reads']} reads, {reads['n_bases']} bases){asm}; "
            f"a job reads {n_bases} bases and writes {written(warm_job)} "
            f"B of .histo{' and .histo2D' if params.histo2d else ''}; "
            f"{warm_job['n_distinct']} "
            f"distinct; plan n_passes="
            f"{plan.get('nb_passes')} table_cap={plan.get('table_cap')} "
            f"est_distinct={plan.get('est_distinct_kmers')} buf_batches="
            f"{plan.get('buf_batches')} nb_cores="
            f"{(warm_job['info']['system'] or {}).get('nb_cores')} "
            f"retries={warm_job['retries']}; "
            f"reads drawn and written in {t_gen:.3f} s, the warm job "
            f"{warm_job['wall_s']:.3f} s, {j0 - t_start:.3f} s before it")

        # the warm job's garbage goes before the window, not in it
        gc.collect()

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        pick = random.Random(seed)
        keep: list = []
        jobs: list[dict] = []
        errors: list[str] = []
        job_span = contextlib.nullcontext
        with contextlib.ExitStack() as stack:
            if trace:
                from torch.profiler import (ProfilerActivity, profile,
                                            record_function)

                from benchmark import tracing

                acts = [ProfilerActivity.CPU]
                if cuda:
                    acts.append(ProfilerActivity.CUDA)
                stack.enter_context(tracing.spans())
                prof = stack.enter_context(profile(activities=acts))
                stack.enter_context(record_function("bench.window"))
                job_span = functools.partial(record_function, "bench.job")
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            t_end = t0
            while not jobs or t_end - t0 < seconds:
                j0 = time.perf_counter()
                try:
                    with job_span():
                        out, *out_files = one_job()
                except Exception as e:  # a failed job is counted, not fatal
                    t_end = time.perf_counter()
                    errors.append(f"{type(e).__name__}: {e}")
                    jobs.append({"failed": True, "wall_s": t_end - j0})
                    continue
                t_end = time.perf_counter()
                jobs.append(summary(out, *out_files, t_end - j0))
                # a uniform sample of the window's tables, drawn from the
                # seed
                if len(keep) < JUDGED_TABLES:
                    keep.append(out.result)
                else:
                    slot = pick.randrange(len(jobs))
                    if slot < JUDGED_TABLES:
                        keep[slot] = out.result
                del out
        window_s = t_end - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        trace_obj = None
        trace_bytes = 0
        if trace:
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            trace_bytes = os.path.getsize(path)
            del prof
            trace_obj = tracing.Trace(path)
            os.remove(path)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        done = [j for j in jobs if not j.get("failed")]
        failed = len(jobs) - len(done)
        bases = sum(j["bases"] for j in done)
        log(f"window: {len(jobs)} jobs ({failed} failed) in {window_s:.3f} "
            f"s; wrote {file_bytes + trace_bytes + sum(written(j) for j in done) + written(warm_job)} B "
            f"in all")
        log("jobs: wall " + " ".join(f"{j['wall_s']:.3f}" for j in done)
            + " s; stream " + " ".join(f"{j['info']['t_stream']}"
                                     for j in done) + " s")
        retried = [j["retries"] for j in done if j["retries"]]
        log(f"jobs that retried: {len(retried)} of {len(done)}"
            + (f" ({retried[0]} the first)" if retried else ""))
        for e in errors[:3]:
            log(f"job failed: {e}")

        name = torch.cuda.get_device_name(0) if cuda else "cpu"
        device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                       "count": int(spec["cell"].get("chips", 1)),
                       "memory_peak_bytes": int(peak)}
        if trace:
            metrics = {}
            ctx = {"jobs": done, "trace": trace_obj, "bases": bases,
                   "window_s": window_s, "k": k,
                   "W": (2 * k + 31) // 32, "device_kind": name}
            for m in spec["per_layer"]:
                value = load_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info["busy_s"] = trace_obj.busy_s
            device_info["window_s"] = trace_obj.window_s
            breakdown = {"device_ops": trace_obj.device_ops(),
                         "idle_gaps": trace_obj.idle_by_span()}
        else:
            values = {"count_mbases_s": bases / window_s / 1e6,
                      "peak_dev_gib": peak / (1 << 30),
                      "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in spec["end_to_end"]}
            breakdown = None

        # the reference, after the window and its memory peak
        t_ref = time.perf_counter()
        ref = reference.reference_answer(
            banks, k, params.histo_max, params.abundance_min,
            params.abundance_max, device=device)
        tables = [reference.program_table(r, params.abundance_min,
                                          params.abundance_max)
                  for r in judged + keep]
        checks = reference.judge(ref, [warm_job] + done, tables, failed)
        log(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s; "
            f"the run's set-up {setup_s:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    spec = load_cell(load_bench(), args.workload)
    if not os.path.isdir(os.path.join(ROOT, "dsk_tpu_torch")):
        log("benchmark: the checkout holds no dsk_tpu_torch package")
        return 2
    import torch

    chips = int(spec["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"benchmark: needs {chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        log(f"benchmark: modules {bad} were loaded in this process")
        return 3
    for key, c in result["checks"].items():
        log(f"check {key} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
