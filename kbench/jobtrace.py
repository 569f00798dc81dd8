"""The port's own records of its jobs, for the per-layer metrics whose
source is ``program_span``: ``fastk_tpu_torch.trace`` keeps, for each job
run under a recording profiler, its spans' seconds (``host_s`` summed over
threads, ``main_s`` on the job's thread), its counters and the seconds the
host waited for the card (``host_blocked_s``). A traced run's warm-up job
comes first, so the window's jobs are the last ``ctx.jobs`` records.

A port without that module, or with fewer records than the window's jobs,
gives None: the metric is left out of the result line.
"""


def window_jobs(ctx):
    """The window's job records, oldest first, or None."""
    try:
        from fastk_tpu_torch import trace
    except ImportError:
        return None
    if ctx.jobs <= 0:
        return None
    jobs = trace.jobs()
    if len(jobs) < ctx.jobs:
        return None
    return jobs[-ctx.jobs:]


def span_s(jobs, names, key="host_s"):
    """The seconds (`key` of each record's span) of the spans `names`,
    summed over `jobs`; None where no job recorded any of them."""
    found, total = False, 0.0
    for job in jobs:
        for name in names:
            s = job["spans"].get(name)
            if s is not None:
                found = True
                total += s[key]
    return total if found else None


def per_gbp(ctx, seconds):
    """`seconds` over the window's gigabases of input, or None."""
    if seconds is None or ctx.bases <= 0:
        return None
    return seconds / (ctx.bases / 1e9)


def per_job(ctx, seconds):
    """`seconds` over the window's jobs, or None."""
    if seconds is None or ctx.jobs <= 0:
        return None
    return seconds / ctx.jobs
