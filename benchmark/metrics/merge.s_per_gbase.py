"""merge.s_per_gbase (s/Gbase): the host merge of a multi-pass count's
tables, the program's span `count.merge` (dist/engine.py: the passes'
disjoint tables joined into one sorted table), summed over the traced
window's runs, per Gbase of input.  None where no run holds the span (a
program older than it, or counts of one pass)."""

from benchmark import program_spans

SPAN = "count.merge"


def read(ctx):
    w = program_spans.window(ctx)
    if w is None or ctx["bases"] <= 0:
        return None
    if not any(SPAN in r["spans"] for r in w.runs):
        return None
    return w.seconds(SPAN) / (ctx["bases"] / 1e9)
