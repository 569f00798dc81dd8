"""table_out.host_s_per_gbp: host seconds of the -t table's way out for a
gigabase of input: the port's spans table_out (pipeline/count.py's
_table_entries: the filter on the card and the fetch) and ktab_write (the
.ktab write)."""

from kbench.jobtrace import per_gbp, span_s, window_jobs

SPANS = {}


def read(ctx):
    jobs = window_jobs(ctx)
    if jobs is None:
        return None
    return per_gbp(ctx, span_s(jobs, ["table_out", "ktab_write"]))
