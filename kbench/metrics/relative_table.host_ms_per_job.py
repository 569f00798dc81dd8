"""relative_table.host_ms_per_job: host milliseconds a job spends loading the
-p:<table> it profiles against (read_ktab, as tools/fastk.py calls it)."""

SPANS = {"relative_table": "fastk_tpu_torch.tools.fastk:read_ktab"}


def read(ctx):
    s = ctx.spans.get("relative_table")
    if not s or not s.calls or ctx.jobs <= 0:
        return None
    return 1000.0 * s.host_s / ctx.jobs
