"""bank.host_s_per_gbase (s/Gbase): the host's per-bank work, the
program's spans `gather.group` (dist/engine.py: the table's live (k-mer,
bank) rows grouped per k-mer by engine/counter.py `_group_by_kmer`, and
the histogram of the totals) and `finish.histo2d` (engine/run.py: the
.histo2D matrix and its write), summed over the traced window's runs,
per Gbase of input.  None where no run holds either span (a program
older than them, or a count of one bank)."""

from benchmark import program_spans

SPANS = ("gather.group", "finish.histo2d")


def read(ctx):
    w = program_spans.window(ctx)
    if w is None or ctx["bases"] <= 0:
        return None
    if not any(name in r["spans"] for r in w.runs for name in SPANS):
        return None
    return sum(w.seconds(name) for name in SPANS) / (ctx["bases"] / 1e9)
