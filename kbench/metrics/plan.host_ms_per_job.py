"""plan.host_ms_per_job: host milliseconds a job spends planning (the port's
span plan in tools/fastk.py: the input's size estimate and the worst-case
plan, and _measure_dedup's read, pack, upload and dedup of the first
slice)."""

from kbench.jobtrace import per_job, span_s, window_jobs

SPANS = {}


def read(ctx):
    jobs = window_jobs(ctx)
    if jobs is None:
        return None
    value = per_job(ctx, span_s(jobs, ["plan"]))
    return None if value is None else 1000.0 * value
