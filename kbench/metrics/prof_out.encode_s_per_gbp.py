"""prof_out.encode_s_per_gbp: host seconds of the profile encoder (the
port's span prof_out.encode around encode_profiles_bulk in pipeline/count.py's
_ProfSink) for a gigabase of input."""

from kbench.jobtrace import per_gbp, span_s, window_jobs

SPANS = {}


def read(ctx):
    jobs = window_jobs(ctx)
    if jobs is None:
        return None
    return per_gbp(ctx, span_s(jobs, ["prof_out.encode"]))
