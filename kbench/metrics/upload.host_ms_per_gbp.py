"""upload.host_ms_per_gbp: host milliseconds of the uploads (the port's span
upload in convert.py: device_codes, a slice's codes in a pageable
non-blocking host-to-device copy, and upload_int32, a pin by copy and a
non-blocking copy) for a gigabase of input."""

from kbench.jobtrace import per_gbp, span_s, window_jobs

SPANS = {}


def read(ctx):
    jobs = window_jobs(ctx)
    if jobs is None:
        return None
    value = per_gbp(ctx, span_s(jobs, ["upload"]))
    return None if value is None else 1000.0 * value
