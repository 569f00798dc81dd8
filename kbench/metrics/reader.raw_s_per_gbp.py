"""reader.raw_s_per_gbp: seconds the job's thread spends in the reader's
file reads and gzip inflate (the port's span reader.raw: each readinto of a
chunk, io/reader.py's _read_into) for a gigabase of input."""

from kbench.jobtrace import per_gbp, span_s, window_jobs

SPANS = {}


def read(ctx):
    jobs = window_jobs(ctx)
    if jobs is None:
        return None
    return per_gbp(ctx, span_s(jobs, ["reader.raw"], "main_s"))
