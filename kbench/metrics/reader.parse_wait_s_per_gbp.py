"""reader.parse_wait_s_per_gbp: seconds the job's thread spends on the native
parse pool, handing it chunks and waiting for parsed pieces (the port's span
reader.wait in io/reader.py's _pooled; the parse itself with one worker), for
a gigabase of input."""

from kbench.jobtrace import per_gbp, span_s, window_jobs

SPANS = {}


def read(ctx):
    jobs = window_jobs(ctx)
    if jobs is None:
        return None
    return per_gbp(ctx, span_s(jobs, ["reader.wait"], "main_s"))
