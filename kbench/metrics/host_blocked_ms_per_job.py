"""host_blocked_ms_per_job: milliseconds a job's host spends blocked for the
card (the port's wait.<site> spans, which add up to its host_blocked_s)."""

from kbench.jobtrace import per_job, window_jobs

SPANS = {}


def read(ctx):
    jobs = window_jobs(ctx)
    if jobs is None:
        return None
    return 1000.0 * per_job(ctx, sum(j["host_blocked_s"] for j in jobs))
