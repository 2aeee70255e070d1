"""feed.gen_share (%): the prefetch thread's read-and-pack time
(t_sub["t_gen"]: the reader and the wire packer, dist/engine.py
_feed_groups) over the stream's time, summed over the jobs."""


def read(ctx):
    gen = [(j["info"].get("t_sub") or {}).get("t_gen") for j in ctx["jobs"]]
    stream = [j["info"].get("t_stream") for j in ctx["jobs"]]
    if not gen or any(v is None for v in gen + stream) or sum(stream) <= 0:
        return None
    return 100.0 * sum(gen) / sum(stream)
