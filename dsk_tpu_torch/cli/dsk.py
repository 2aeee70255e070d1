"""`dsk` CLI of the port: count canonical k-mers into an HDF5 store.

The flags of dsk_tpu/cli/dsk.py, plus `-device {cuda,cpu}` (default
cuda; a run on a machine without CUDA fails rather than falling back to
the CPU) and `-storage-type none` (write no .h5 store, e.g. where h5py is
not installed).  Run as `python -m dsk_tpu_torch.cli.dsk`.

Across GPUs, one process per GPU:
`torchrun --nproc-per-node N -m dsk_tpu_torch.cli.dsk ...` (or
`python -m torch.distributed.run ...`) makes each process one rank of a
routed count (dist/multihost.py): `-device cuda` means cuda:$LOCAL_RANK
over NCCL, and more local ranks than GPUs raise; `-device cpu` runs the
ranks on the CPU over gloo.  Nothing switches from NCCL to gloo or from
the GPU to the CPU on its own.  Without torchrun's environment the CLI
counts on one device.  Spill mode across ranks (`-spill on`, or auto)
keeps every rank's partition files under `-out-tmp` (else the output's
directory), which must then be one directory that every rank sees:
across hosts, a shared filesystem.
"""

from __future__ import annotations

import argparse
import os
import sys

from dsk_tpu_torch.engine.run import RunParams, execute


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dsk",
        description="k-mer counter on PyTorch/CUDA (dsk-compatible CLI)",
        prefix_chars="-",
        add_help=False,
    )
    p.add_argument("-help", "--help", action="help")
    p.add_argument("-version", action="version", version="dsk_tpu_torch 0.1.0")
    req = p.add_argument_group("required")
    req.add_argument("-file", required=True,
                     help="input file(s): fasta/fastq(.gz), comma list, or album file")
    req.add_argument("-kmer-size", dest="kmer_size", type=int, default=31,
                     help="size of a kmer (default 31)")
    opt = p.add_argument_group("options")
    opt.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                     help="device to count on (default cuda)")
    opt.add_argument("-abundance-min", dest="abundance_min", type=int, default=2,
                     help="min abundance threshold for solid kmers (default 2)")
    opt.add_argument("-abundance-max", dest="abundance_max", type=int,
                     default=2**31 - 1, help="max abundance threshold")
    opt.add_argument("-solidity-kind", dest="solidity_kind", default="sum",
                     choices=["sum", "min", "max", "one", "all", "custom"],
                     help="way to compute kmer solidity over multiple banks")
    opt.add_argument("-solidity-custom", dest="solidity_custom", default=None,
                     help="0/1 list over banks: kmers solid in exactly that subset")
    opt.add_argument("-out", default=None, help="output file prefix")
    opt.add_argument("-out-dir", dest="out_dir", default=".",
                     help="output directory")
    opt.add_argument("-out-tmp", dest="out_tmp", default=None,
                     help="directory for temporary (spill) files; "
                          "across hosts a shared filesystem")
    opt.add_argument("-max-memory", dest="max_memory", type=int, default=5000,
                     help="max memory in MBytes (device table budget)")
    opt.add_argument("-max-disk", dest="max_disk", type=int, default=0,
                     help="max temporary disk space in MBytes (0 = auto); "
                          "in spill mode the spill files of all ranks "
                          "together take at most 3/4 of it, and each "
                          "rank's multi-pass batch cache of its own input "
                          "at most 1/4")
    opt.add_argument("-histo-max", dest="histo_max", type=int, default=10000,
                     help="max abundance bin in the histogram (default 10000)")
    opt.add_argument("-histo", type=int, default=0,
                     help="output the abundance histogram as a .histo text file")
    opt.add_argument("-histo2D", dest="histo2d", type=int, default=0,
                     help="output the 2D assembly-vs-reads abundance matrix "
                          "(assembly must be the FIRST input file)")
    opt.add_argument("-nb-cores", dest="nb_cores", type=int, default=0,
                     help="number of host pipeline cores (0 = all)")
    opt.add_argument("-solid-kmers-out", dest="solid_kmers_out", default=None,
                     help="explicit output file for the solid-kmer store")
    opt.add_argument("-out-compress", dest="out_compress", type=int, default=0,
                     help="gzip-compress the output store datasets")
    opt.add_argument("-storage-type", dest="storage_type", default="hdf5",
                     choices=["hdf5", "none"],
                     help="output container format (none: no .h5 store)")
    opt.add_argument("-minimizer-size", dest="minimizer_size", type=int,
                     default=10, help="m-mer size for minimizer statistics")
    opt.add_argument("-minimizer-type", dest="minimizer_type", type=int,
                     default=0, choices=[0, 1],
                     help="1: frequency-balanced minimizer repartition "
                          "(across ranks: superkmer routing by it; the "
                          "statistics go to the run info)")
    opt.add_argument("-repartition-type", dest="repartition_type", type=int,
                     default=0, choices=[0, 1],
                     help="1: compute a minimizer repartition table "
                          "(stored in run info; across ranks: superkmer "
                          "routing by it)")
    opt.add_argument("-send-slack", dest="send_slack", type=float,
                     default=2.5,
                     help="route capacity across ranks, as a multiple of "
                          "a rank's even share (doubles on overflow; "
                          "unused on one device)")
    opt.add_argument("-max-retries", dest="max_retries", type=int, default=3,
                     help="auto re-plan attempts on capacity overflow")
    opt.add_argument("-flush-buckets", dest="flush_buckets", type=int,
                     default=1,
                     help=">1: S key-space buckets of the table, at most "
                          "this many (a power of two); the store's "
                          "partitions are then written bucket by bucket "
                          "(1 = flat flush)")
    opt.add_argument("-trace-dir", dest="trace_dir", default=None,
                     help="write a torch.profiler trace of the count "
                          "phase (CUDA activity included on a GPU) to "
                          "this directory")
    opt.add_argument("-verbose", type=int, default=1, help="verbosity level")
    opt.add_argument("-engine", default="auto", choices=["auto", "dist"],
                     help="counting engine (the port has one: dist)")
    opt.add_argument("-resume", action="store_true",
                     help="resume a multi-pass run from <out>.ckpt.h5")
    opt.add_argument("-no-checkpoint", dest="no_checkpoint",
                     action="store_true",
                     help="disable per-pass checkpointing")
    opt.add_argument("-wire", default=None, choices=["exc", "bitmap"],
                     help="H2D wire format (default auto: sparse exc, "
                          "bitmap on N-dense fallback)")
    opt.add_argument("-spill", default="auto",
                     choices=["auto", "on", "off"],
                     help="host partition spill (DSK's disk fill/count "
                          "split): auto = planner decides from measured "
                          "wire/re-read cost")
    opt.add_argument("-spill-partitions", dest="spill_partitions",
                     type=int, default=0,
                     help="override the planner's spill partition count")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    params = RunParams(
        file=args.file,
        kmer_size=args.kmer_size,
        abundance_min=args.abundance_min,
        abundance_max=args.abundance_max,
        solidity_kind=args.solidity_kind,
        solidity_custom=args.solidity_custom,
        out=args.out,
        out_dir=args.out_dir,
        out_tmp=args.out_tmp,
        max_memory=args.max_memory,
        max_disk=args.max_disk,
        histo_max=args.histo_max,
        histo=bool(args.histo),
        histo2d=bool(args.histo2d),
        nb_cores=args.nb_cores,
        verbose=args.verbose,
        resume=args.resume,
        checkpoint=not args.no_checkpoint,
        engine=args.engine,
        solid_kmers_out=args.solid_kmers_out,
        out_compress=bool(args.out_compress),
        minimizer_size=args.minimizer_size,
        minimizer_type=args.minimizer_type,
        repartition_type=args.repartition_type,
        send_slack=args.send_slack,
        max_retries=args.max_retries,
        flush_buckets=args.flush_buckets,
        wire=args.wire,
        trace_dir=args.trace_dir,
        spill=args.spill,
        spill_partitions=args.spill_partitions,
        device=args.device,
        storage_type=args.storage_type,
    )
    ranks = None
    try:
        if _under_torchrun():
            from dsk_tpu_torch.dist import multihost

            ranks = multihost.initialize(device=args.device)
            params.device = str(ranks.device)
        execute(params, ranks)
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(f"dsk: error: {e}", file=sys.stderr)
        return 1
    finally:
        if ranks is not None:
            multihost.shutdown()
    return 0


def _under_torchrun() -> bool:
    """torchrun (torch.distributed.run) started this process as a rank."""
    return "TORCHELASTIC_RUN_ID" in os.environ or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ
        and "LOCAL_RANK" in os.environ)


if __name__ == "__main__":
    sys.exit(main())
