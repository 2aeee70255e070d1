"""run.other_share (%): the share of the jobs' wall time outside the
stream, the gather and the histogram: planning and sampling, engine
set-up, the solidity filter and the .histo writer (engine/run.py
execute).  From RunOutput.info and the harness's clock around each job."""


def read(ctx):
    jobs = ctx["jobs"]
    wall = sum(j["wall_s"] for j in jobs)
    inside = [j["info"].get(key) for j in jobs
              for key in ("t_stream", "t_gather", "t_hist")]
    if not jobs or wall <= 0 or any(v is None for v in inside):
        return None
    return 100.0 * (1.0 - sum(inside) / wall)
