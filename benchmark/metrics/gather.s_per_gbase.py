"""gather.s_per_gbase (s/Gbase): the table's gather to the host
(t_gather: _live_prefix) and its histogram (t_hist: hist_shard), per
Gbase of input, summed over the jobs."""


def read(ctx):
    parts = [j["info"].get(key) for j in ctx["jobs"]
             for key in ("t_gather", "t_hist")]
    if not parts or any(v is None for v in parts) or ctx["bases"] <= 0:
        return None
    return sum(parts) / (ctx["bases"] / 1e9)
