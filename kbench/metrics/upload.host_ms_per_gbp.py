"""upload.host_ms_per_gbp: host milliseconds of the uploads (the port's span
upload in ops/pack.py's upload_int32: the pin by copy and the non-blocking
host-to-device copy) for a gigabase of input."""

from kbench.jobtrace import per_gbp, span_s, window_jobs

SPANS = {}


def read(ctx):
    jobs = window_jobs(ctx)
    if jobs is None:
        return None
    value = per_gbp(ctx, span_s(jobs, ["upload"]))
    return None if value is None else 1000.0 * value
